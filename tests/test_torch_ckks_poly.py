"""The port's models/ckks/poly.py against fhe_study_tpu.models.ckks.poly.

Keys and ciphertexts are drawn by the port (one secret key over 9 primes;
hybrid relinearization keys at every level 2..9, which serve both the
single-prime scale at L = 8 and the double-prime one at L = 9: a key at
level L depends on the first L primes only) and carried into the JAX
package as its u32 keys and u64 residues; the three chained squarings
run on the reference test's own keys and input, carried the other way.
The JAX functions run under jax.jit.  Integer outputs are held bit for bit (tolerance 0), the constant
encodings too, and the port's decoded results against numpy at the
reference tests' tolerances (tests/test_ckks_poly.py, test_ckks_poly2.py).
"""

from fractions import Fraction

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_study_tpu.models import hybrid_ks as JH
from fhe_study_tpu.models.ckks import ckks_rns as JC
from fhe_study_tpu.models.ckks import poly as JP
from fhe_study_tpu.utils import prng as jprng

from fhe_study_tpu_torch.models.ckks import ckks_rns as C
from fhe_study_tpu_torch.models.ckks import poly as P
from fhe_study_tpu_torch.utils import interop, prng

N = 32
CPU = torch.device("cpu")
P8 = C.Param(n=N, L=8, delta=2.0 ** 28)
P9 = C.Param(n=N, L=9, delta=C.delta2(C.Param(n=N, L=9, delta=1.0)))
J8 = JC.Param(n=N, L=8, delta=P8.delta)
J9 = JC.Param(n=N, L=9, delta=P9.delta)
COEFFS = [1.0, -2.0, 0.0, 0.5]            # bit-equality: both branches of
COEFFS_2 = [0.5, 1.0, -0.25]              # powers, and one double product
COEFFS7 = [1.0, -2.0, 0.0, 0.5, 0.0, 0.0, 0.0, -0.25]
COEFFS2 = [0.5, 1.0, 0.0, -0.25]
CONST, CONST2 = 0.75 - 0.25j, -0.5


def to_jax_ct(ct):
    return JC.CT(*(jnp.asarray(interop.to_numpy(c).astype(np.uint64))
                   for c in ct))


def same(got, want):
    got = (got,) if isinstance(got, torch.Tensor) else tuple(got)
    want = tuple(want) if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(interop.to_numpy(g).astype(np.uint64),
                                      np.asarray(w).astype(np.uint64))


def decoded(param, sk, ct):
    rr, ri = C.decode(param, C.decrypt_to_coeffs(param, sk, ct))
    return rr.numpy() + 1j * ri.numpy()


@pytest.fixture(scope="module")
def ref():
    gen = prng.Gen(11)
    sk, pk = C.new_key(gen, P9, CPU)
    rlks = P.rlk_keys_all_levels(gen, P9, sk)
    jrlks = {L: JH.HybridKSK(b=jnp.asarray(interop.to_numpy(k.b)),
                             a=jnp.asarray(interop.to_numpy(k.a)))
             for L, k in rlks.items()}
    rng = np.random.default_rng(12)
    z = rng.uniform(-1, 1, N // 2)
    z2 = rng.uniform(-1, 1, N // 2) + 1j * rng.uniform(-1, 1, N // 2)
    p8, pk8 = C.Param(n=N, L=8, delta=P8.delta), C.PublicKey(pk.b[:8],
                                                               pk.a[:8])
    ct = C.encrypt(gen, p8, pk8, C.encode(
        p8, torch.from_numpy(z), torch.zeros(N // 2, dtype=torch.float64)))
    ct2 = C.encrypt(gen, P9, pk, C.encode(P9, torch.from_numpy(z2.real),
                                          torch.from_numpy(z2.imag)))
    single, double, consts = _jax_polys(jrlks, ct, ct2)
    return dict(sk=sk, rlks=rlks, jrlks=jrlks, z=z, z2=z2, ct=ct, ct2=ct2,
                single=single, double=double, consts=consts)


def _jax_polys(jrlks, ct, ct2):
    """The reference's poly_eval on ct (L = 8) and poly_eval2 on ct2 (L = 9)
    under one jax.jit, each with the powers that it computes (JP.powers:
    mul_ct or mul_ct2 products) returned beside its output, and its
    add_pt_const on each."""
    seen = []
    powers = JP.powers

    def recording(*args, **kw):
        seen.append(powers(*args, **kw))
        return seen[-1]

    def run(x0, x1, y0, y1):
        outs = []
        for fn, jparam, coeffs, c in ((JP.poly_eval, J8, COEFFS, (x0, x1)),
                                      (JP.poly_eval2, J9, COEFFS_2, (y0, y1))):
            out, _ = fn(jrlks, JC.CT(*c), jparam, coeffs)
            outs.append(({k: tuple(v[0]) for k, v in seen[-1].items()
                          if k > 1}, tuple(out)))
        # add_pt_const at both scales: the float encode of a complex
        # constant and the exact one
        outs.append((tuple(JP.add_pt_const(J8, JC.CT(x0, x1), CONST)),
                     tuple(JP.add_pt_const(J9, JC.CT(y0, y1), CONST2))))
        return outs

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JP, "powers", recording)
        return jax.jit(run)(*to_jax_ct(ct), *to_jax_ct(ct2))


def test_rlks_cross_to_the_port_and_back(ref):
    back = interop.rlks_to_port(ref["jrlks"], CPU)
    assert sorted(back) == list(range(2, 10))
    for L, k in back.items():
        assert tuple(k.b.shape) == (L, L + 2, N)
        assert torch.equal(k.b, ref["rlks"][L].b)
        assert torch.equal(k.a, ref["rlks"][L].a)


def test_level_drop_and_constants_match_jax(ref):
    ct = ref["ct"]
    d, p5 = P.level_drop(P8, ct, 5)
    jd, jp5 = JP.level_drop(J8, to_jax_ct(ct), 5)
    same(d, tuple(jd))
    assert (p5.L, p5.delta, p5.qs) == (jp5.L, jp5.delta, jp5.qs)
    with pytest.raises(ValueError, match="cannot drop"):
        P.level_drop(P8, ct, 9)
    for c, scale in ((-0.3, P9.qs[-1] * P9.qs[-2]),
                     (2.5, Fraction(2.0 ** 70))):
        same(P._encode_const_exact(P9, c, scale, CPU),
             JP._encode_const_exact(J9, c, scale))
    same(P.add_pt_const(P8, ct, CONST), ref["consts"][0])
    same(P.add_pt_const(P9, ref["ct2"], CONST2), ref["consts"][1])
    with pytest.raises(ValueError, match="real-only"):
        P.add_pt_const(P9, ref["ct2"], 0.5j)


def test_mul_ct_and_powers_match_jax(ref):
    """powers (both branches: k = 2 squares, k = 3 multiplies two powers)
    and mul_ct == the products that the reference's poly_eval forms."""
    powers, _ = ref["single"]
    assert sorted(powers) == [2, 3]
    pw = P.powers(ref["rlks"], ref["ct"], P8, {3})
    for k in (2, 3):
        same(pw[k][0], powers[k])
    x2, p2 = P.mul_ct(ref["rlks"], ref["ct"], P8, ref["ct"], P8)
    same(x2, powers[2])
    assert (p2.L, p2.delta) == (pw[2][1].L, pw[2][1].delta) == (
        7, P8.delta * P8.delta / P8.qs[-1])
    with pytest.raises(ValueError, match="non-constant"):
        P.poly_eval(ref["rlks"], ref["ct"], P8, [1.0])


def test_poly_eval_matches_jax(ref):
    out, pout = P.poly_eval(ref["rlks"], ref["ct"], P8, COEFFS)
    same(out, ref["single"][1])
    assert pout.L == 5
    want = sum(c * ref["z"] ** k for k, c in enumerate(COEFFS))
    np.testing.assert_allclose(decoded(pout, ref["sk"], out), want,
                               atol=5e-3)


def test_mul_ct2_and_poly_eval2_match_jax(ref):
    powers, want = ref["double"]
    sq, psq = P.mul_ct2(ref["rlks"], ref["ct2"], P9, ref["ct2"], P9)
    same(sq, powers[2])
    assert psq.L == 7
    out, pout = P.poly_eval2(ref["rlks"], ref["ct2"], P9, COEFFS_2)
    same(out, want)
    assert pout.delta == P9.delta and pout.L == 5
    out, pout = P.poly_eval2(ref["rlks"], ref["ct2"], P9, COEFFS2)
    assert pout.delta == P9.delta and pout.L == 3
    z = ref["z2"]
    np.testing.assert_allclose(decoded(pout, ref["sk"], out),
                               0.5 + z - 0.25 * z ** 3, atol=1e-12)


def _reference_chain():
    """tests/test_ckks_poly.py::test_mul_hybrid_chain's own keys and input
    (its _setup at seed 0) and its three chained squarings, under one
    jax.jit."""
    z = np.random.default_rng(1).uniform(-1, 1, N // 2)

    def run(key, zz):
        ks = jprng.split(key, 3)
        jsk, jpk = JC.new_key(ks[0], J8)
        jct = JC.encrypt(ks[1], J8, jpk, JC.encode(J8, zz,
                                                   jnp.zeros(N // 2)))
        # the chain's levels 8, 7, 6; each key is the reference test's
        # (fold_in of its level)
        jrlks = JP.rlk_keys_all_levels(ks[2], J8, jsk, min_L=6)
        x, px = jct, J8
        for _ in range(3):
            x, px = JP.mul_ct(jrlks, x, px, x, px)
        return jsk, jct, jrlks, tuple(x)

    return z, *jax.jit(run)(jax.random.PRNGKey(0), jnp.asarray(z))


def test_degree7_and_chains_decode_to_numpy(ref):
    """The reference tests' own checks on the port: the degree-7
    polynomial (5e-3) and a mul_ct2 chain at the double-prime scale
    (1e-12) on the port's draws, and three chained squarings (3e-3) on the
    reference test's own keys and input, carried across and held bit for
    bit against the reference's chain."""
    rlks, sk, z = ref["rlks"], ref["sk"], ref["z"]
    out, pout = P.poly_eval(rlks, ref["ct"], P8, COEFFS7)
    got = decoded(pout, sk, out)
    np.testing.assert_allclose(got.real, sum(c * z ** k for k, c in
                                             enumerate(COEFFS7)), atol=5e-3)
    np.testing.assert_allclose(got.imag, 0, atol=5e-3)
    z8, jsk, jct, jrlks, want = _reference_chain()
    crlks = interop.rlks_to_port(jrlks, CPU)
    x, px = interop.to_port(jct, CPU), P8
    for _ in range(3):
        x, px = P.mul_ct(crlks, x, px, x, px)
    same(x, want)
    got = decoded(px, interop.to_port(jsk, CPU), x)
    np.testing.assert_allclose(got.real, z8 ** 8, atol=3e-3)
    np.testing.assert_allclose(got.imag, 0, atol=3e-3)
    y2, p2 = P.mul_ct2(rlks, ref["ct2"], P9, ref["ct2"], P9)
    y3, p3 = P.mul_ct2(rlks, y2, p2, ref["ct2"], P9)
    assert p3.L == 5 and 0.5 < p3.delta / P9.delta < 2.0
    np.testing.assert_allclose(decoded(p3, sk, y3), ref["z2"] ** 3,
                               atol=1e-12)
