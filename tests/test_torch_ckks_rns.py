"""The port's RNS-CKKS against fhe_study_tpu.models.ckks.ckks_rns.

The JAX side runs its XLA path on the CPU under jax.jit; its keys and
ciphertexts cross into the port through utils/interop.py, and the port's
deterministic cores (``*_with``) are fed the JAX samplers' draws in the
reference's layout.  Integer functions are held bit for bit (tolerance 0);
float functions to the tolerance written in each test.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_study_tpu.models.ckks import ckks_rns as J
from fhe_study_tpu.models.ckks import encoder_device as JD
from fhe_study_tpu.utils import prng as jprng

from fhe_study_tpu_torch.models.ckks import Encoder
from fhe_study_tpu_torch.models.ckks import ckks_rns as C
from fhe_study_tpu_torch.models.ckks import encoder_device as D
from fhe_study_tpu_torch.utils import interop, prng

N, L, B, K = 256, 4, 2, 2
DELTA = 2.0 ** 28
JP = J.Param(n=N, L=L, delta=DELTA)
P = C.Param(n=N, L=L, delta=DELTA)
CPU = torch.device("cpu")


def i64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def f64(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def port(obj):
    return interop.to_port(obj, CPU)


def same(got, want):
    """A port tensor (or tuple of them) == reference array(s)."""
    got = (got,) if isinstance(got, torch.Tensor) else tuple(got)
    want = tuple(want) if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(interop.to_numpy(g).astype(np.uint64),
                                      np.asarray(w).astype(np.uint64))


def slots(seed, scale=1.0, batch=B):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-scale, scale, (batch, N // 2)),
            rng.uniform(-scale, scale, (batch, N // 2)))


@pytest.fixture(scope="module")
def ref():
    ks = jprng.split(jax.random.PRNGKey(9), 8)
    sk, pk = jax.jit(lambda k: J.new_key(k, JP))(ks[0])
    hrlk = J.hybrid_rlk(ks[1], JP, sk)
    rlk = jax.jit(lambda k, s: J.rlk_key(k, JP, J.SecretKey(*s)))(ks[2], sk)
    z = [slots(10 + i) for i in range(2)]
    enc = jax.jit(lambda zr, zi: J.encode(JP, zr, zi))
    m = [enc(*zi) for zi in z]
    crypt = jax.jit(lambda k, m: J.encrypt(k, JP, pk, m, batch=(B,)))
    c = [crypt(ks[3 + i], m[i]) for i in range(2)]
    return dict(ks=ks, sk=sk, pk=pk, hrlk=hrlk, rlk=rlk, z=z, m=m, c=c)


def test_param_checks():
    assert C.Param(n=N, L=L, delta=DELTA).qs == JP.qs
    with pytest.raises(ValueError, match="power of two"):
        C.Param(n=96, L=2, delta=1.0)
    with pytest.raises(ValueError, match="delta > 0"):
        C.Param(n=64, L=2, delta=0.0)


def test_new_key_core_matches_jax(ref):
    k_s, k_a, k_e = jprng.split(ref["ks"][0], 3)
    s = jprng.ternary(k_s, (N,))
    a = jnp.stack([jprng.uniform_mod(jax.random.fold_in(k_a, i), (N,), q)
                   for i, q in enumerate(JP.qs)])
    e = jprng.gaussian_int(k_e, (N,), J.ERR_SIGMA)
    sk, pk = C.new_key_with(P, i64(s), interop.to_tensor(a, CPU), i64(e))
    same(sk, tuple(ref["sk"]))
    same(pk, tuple(ref["pk"]))


@pytest.mark.parametrize("h", [None, 16])
def test_new_key_draws_a_working_key(h):
    gen = prng.Gen(1)
    sk, pk = C.new_key(gen, P, CPU, h=h)
    s = C.hybrid_ks._centered_coeffs(P, sk.s_evals)
    assert set(s.unique().tolist()) <= {-1, 0, 1}
    if h is not None:
        assert int((s != 0).sum()) == h
    zr, zi = slots(2)
    c = C.encrypt(gen, P, pk, C.encode(P, f64(zr), f64(zi)), batch=(B,))
    rr, ri = C.decode(P, C.decrypt_to_coeffs(P, sk, c))
    # fresh-encryption noise over delta = 2^28: far below 1e-4
    np.testing.assert_allclose(rr.numpy(), zr, atol=1e-4)
    np.testing.assert_allclose(ri.numpy(), zi, atol=1e-4)


def test_sparse_ternary_has_exactly_h_nonzeros():
    gen = prng.Gen(3)
    s = prng.sparse_ternary(gen, (5, 3, 128), 16, CPU)
    assert s.dtype == torch.int64 and tuple(s.shape) == (5, 3, 128)
    assert set(s.unique().tolist()) == {-1, 0, 1}
    assert torch.equal((s != 0).sum(-1), torch.full((5, 3), 16))
    assert 0.3 < float((s == 1).sum()) / (5 * 3 * 16) < 0.7
    with pytest.raises(ValueError, match="Hamming weight"):
        prng.sparse_ternary(gen, (8,), 9, CPU)


def test_encode_matches_jax(ref):
    """The FFT is ported stage for stage: at most 1 unit in at most 1e-4 of
    the coefficients (observed: none differ)."""
    for (zr, zi), want in zip(ref["z"], ref["m"]):
        got = interop.to_numpy(C.encode(P, f64(zr), f64(zi))).astype(np.int64)
        want = np.asarray(want).astype(np.int64)
        diff = np.abs(got - want)
        diff = np.minimum(diff, np.asarray(JP.qs)[:, None, None] - diff)
        assert diff.max() <= 1 and (diff != 0).mean() <= 1e-4


def test_device_encoder_matches_jax_and_host_encoder():
    zr, zi = slots(4, scale=8.0)
    got = D.encode(f64(zr), f64(zi), N, DELTA).numpy()
    want = np.asarray(jax.jit(lambda a, b: JD.encode(a, b, N, DELTA))(zr, zi))
    assert np.abs(got - want).max() <= 1
    assert (got != want).mean() <= 1e-4
    host = Encoder(N, DELTA)
    # numpy's complex FFT sums in another order: off by one unit at most
    assert np.abs(got - host.encode(zr + 1j * zi)).max() <= 1
    rr, ri = D.decode(i64(want), N, DELTA)
    jr, ji = jax.jit(lambda p: JD.decode(p, N, DELTA))(want)
    np.testing.assert_allclose(rr.numpy(), np.asarray(jr), atol=1e-9)
    np.testing.assert_allclose(ri.numpy(), np.asarray(ji), atol=1e-9)
    back = host.decode(want)
    np.testing.assert_allclose(rr.numpy() + 1j * ri.numpy(), back, atol=1e-9)
    # rounding to integers costs at most n/2 / delta per slot
    np.testing.assert_allclose(back, zr + 1j * zi, atol=1e-6)


def test_encrypt_core_matches_jax(ref):
    for i in range(2):
        k_u, k_e0, k_e1 = jprng.split(ref["ks"][3 + i], 3)
        u = jprng.ternary(k_u, (B, N))
        e0, e1 = (jprng.gaussian_int(k, (B, N), J.ERR_SIGMA)
                  for k in (k_e0, k_e1))
        got = C.encrypt_with(P, port(ref["pk"]),
                             interop.to_tensor(ref["m"][i], CPU), i64(u),
                             i64(e0), i64(e1))
        assert isinstance(got, C.CT)
        same(got, tuple(ref["c"][i]))


@pytest.mark.parametrize("op", ["add", "sub", "mul_pt", "rescale"])
def test_linear_ops_match_jax(ref, op):
    c1, c2 = ref["c"]
    if op in ("add", "sub"):
        got = getattr(C, op)(P, port(c1), port(c2))
        want = jax.jit(lambda x, y: getattr(J, op)(JP, J.CT(*x), J.CT(*y)))(
            c1, c2)
    elif op == "mul_pt":
        m = ref["m"][1]
        got = C.mul_pt(P, port(c1), interop.to_tensor(m, CPU))
        want = jax.jit(lambda x, m: J.mul_pt(JP, J.CT(*x), m))(c1, m)
    else:
        got, p2 = C.rescale(P, port(c1))
        want, jp2 = J.rescale(JP, c1)
        assert (p2.L, p2.delta) == (jp2.L, jp2.delta) and p2.qs == jp2.qs
    same(got, tuple(want))


def test_hybrid_rlk_core_matches_jax(ref):
    from fhe_study_tpu.models import hybrid_ks as JH
    both = JP.qs + JH.ks_ext_primes(JP, K)
    k_a, k_e = jprng.split(ref["ks"][1], 2)
    a = jnp.transpose(jprng.uniform_mod_multi(k_a, (L, N), both), (1, 0, 2))
    e = jprng.gaussian_int(k_e, (L, N), J.ERR_SIGMA)
    got = C.hybrid_rlk_with(P, port(ref["sk"]), interop.to_tensor(a, CPU),
                            i64(e), K=K)
    assert tuple(got.b.shape) == (L, L + K, N) and got.b.is_contiguous()
    same(got, tuple(ref["hrlk"]))
    with pytest.raises(ValueError, match="L=4"):
        C.hybrid_rlk_with(P, port(ref["sk"]),
                          interop.to_tensor(a[:, :L], CPU), i64(e), K=K)


def test_rlk_key_core_matches_jax(ref):
    k_a, k_e = jprng.split(ref["ks"][2], 2)
    a = jnp.swapaxes(jprng.uniform_mod_multi(k_a, (L, N), JP.qs), 0, 1)
    e = jprng.gaussian_int(k_e, (L, N), J.ERR_SIGMA)
    got = C.rlk_key_with(P, port(ref["sk"]), interop.to_tensor(a, CPU),
                         i64(e))
    same(got, tuple(ref["rlk"]))


@pytest.mark.parametrize("which", ["mul_hybrid", "mul"])
def test_multiply_matches_jax(ref, which):
    c1, c2 = ref["c"]
    if which == "mul_hybrid":
        want, jp2 = jax.jit(lambda k, x, y: J.mul_hybrid(
            JP, type(ref["hrlk"])(*k), J.CT(*x), J.CT(*y))[0])(
                ref["hrlk"], c1, c2), J.Param(
                    n=N, L=L - 1, delta=DELTA * DELTA / JP.qs[-1])
        got, p2 = C.mul_hybrid(P, port(ref["hrlk"]), port(c1), port(c2))
    else:
        want = jax.jit(lambda k, x, y: J.mul(
            JP, type(ref["rlk"])(*k), J.CT(*x), J.CT(*y))[0])(
                ref["rlk"], c1, c2)
        jp2 = J.mul(JP, ref["rlk"], c1, c2)[1]
        got, p2 = C.mul(P, port(ref["rlk"]), port(c1), port(c2))
    assert (p2.n, p2.L, p2.delta) == (jp2.n, jp2.L, jp2.delta)
    assert isinstance(got, C.CT) and got.c0.shape[0] == L - 1
    same(got, tuple(want))


def test_decrypt_and_decode_match_jax(ref):
    """The 2-limb branch is integer arithmetic below 2^60: exact.  decode
    repeats the reference's FFT stage for stage: atol 1e-9."""
    c = ref["c"][0]
    want = np.asarray(jax.jit(lambda s, x: J.decrypt_to_coeffs(
        JP, J.SecretKey(*s), J.CT(*x)))(ref["sk"], c))
    got = C.decrypt_to_coeffs(P, port(ref["sk"]), port(c))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    jr, ji = jax.jit(lambda p: J.decode(JP, p))(want)
    rr, ri = C.decode(P, got)
    np.testing.assert_allclose(rr.numpy(), np.asarray(jr), atol=1e-9)
    np.testing.assert_allclose(ri.numpy(), np.asarray(ji), atol=1e-9)
    np.testing.assert_allclose(rr.numpy(), ref["z"][0][0], atol=1e-4)
    with pytest.raises(ValueError, match="crt_limbs"):
        C.decrypt_to_coeffs(P, port(ref["sk"]), port(c), crt_limbs=4)


@pytest.fixture(scope="module")
def ref2():
    """The double-prime scale: L = 7, delta = q_6 * q_5."""
    L7 = 7
    jp = J.Param(n=N, L=L7, delta=J.delta2(J.Param(n=N, L=L7, delta=1.0)))
    ks = jprng.split(jax.random.PRNGKey(5), 5)
    sk, pk = jax.jit(lambda k: J.new_key(k, jp))(ks[0])
    hrlk = J.hybrid_rlk(ks[1], jp, sk)
    z = [slots(20 + i) for i in range(2)]
    enc = jax.jit(lambda zr, zi: J.encode(jp, zr, zi))
    crypt = jax.jit(lambda k, m: J.encrypt(k, jp, pk, m, batch=(B,)))
    c = [crypt(ks[2 + i], enc(*z[i])) for i in range(2)]
    return dict(jp=jp, sk=sk, hrlk=hrlk, z=z, c=c)


def test_mul_hybrid2_matches_jax(ref2):
    jp = ref2["jp"]
    p = C.Param(n=N, L=jp.L, delta=C.delta2(C.Param(n=N, L=jp.L, delta=1.0)))
    assert p.delta == jp.delta > 2.0 ** 58
    assert C.delta2(p.qs, 5) == J.delta2(jp.qs, 5)
    c1, c2 = ref2["c"]
    want = jax.jit(lambda k, x, y: J.mul_hybrid2(
        jp, type(ref2["hrlk"])(*k), J.CT(*x), J.CT(*y))[0])(
            ref2["hrlk"], c1, c2)
    got, p2 = C.mul_hybrid2(p, port(ref2["hrlk"]), port(c1), port(c2))
    jp2 = J.rescale2(J.Param(n=N, L=jp.L, delta=jp.delta * jp.delta), c1)[1]
    assert (p2.L, p2.delta) == (jp2.L, jp2.delta) == (5, p2.delta)
    same(got, tuple(want))
    # the 3-limb Garner branch sums three float64 terms in the reference's
    # order: 2^-50 relative
    sk = ref2["sk"]
    wantc = np.asarray(jax.jit(lambda s, x: J.decrypt_to_coeffs(
        jp2, J.SecretKey(*s), J.CT(*x)))(sk, want))
    gotc = C.decrypt_to_coeffs(p2, port(sk), got).numpy()
    np.testing.assert_allclose(gotc, wantc, rtol=2.0 ** -50, atol=0)
    rr, ri = C.decode(p2, torch.from_numpy(gotc))
    z = [a + 1j * b for a, b in ref2["z"]]
    # ~2^-40 of slot precision survives the multiply at this scale
    np.testing.assert_allclose(rr.numpy() + 1j * ri.numpy(), z[0] * z[1],
                               atol=1e-9)


def test_slice_keygen_to_decode():
    """The slice as a whole on the port's own draws: (z1 + z2) * z1 through
    add and mul_hybrid, and z1 * z2 through the gadget mul, to the reference
    tests' tolerances (1e-2 for the hybrid multiply at delta = 2^28, 3e-2
    for the gadget one at delta = 2^25)."""
    gen = prng.Gen(11)
    (z1r, z1i), (z2r, z2i) = slots(30), slots(31)
    z1, z2 = z1r + 1j * z1i, z2r + 1j * z2i
    sk, pk = C.new_key(gen, P, CPU)
    hrlk = C.hybrid_rlk(gen, P, sk)
    c1 = C.encrypt(gen, P, pk, C.encode(P, f64(z1r), f64(z1i)), batch=(B,))
    c2 = C.encrypt(gen, P, pk, C.encode(P, f64(z2r), f64(z2i)), batch=(B,))
    out, p2 = C.mul_hybrid(P, hrlk, c1, C.add(P, c1, c2))
    rr, ri = C.decode(p2, C.decrypt_to_coeffs(p2, sk, out))
    np.testing.assert_allclose(rr.numpy() + 1j * ri.numpy(), (z1 + z2) * z1,
                               atol=1e-2)
    p25 = C.Param(n=N, L=3, delta=2.0 ** 25)
    sk, pk = C.new_key(gen, p25, CPU)
    rlk = C.rlk_key(gen, p25, sk)
    c1 = C.encrypt(gen, p25, pk, C.encode(p25, f64(z1r), f64(z1i)),
                   batch=(B,))
    c2 = C.encrypt(gen, p25, pk, C.encode(p25, f64(z2r), f64(z2i)),
                   batch=(B,))
    out, p2 = C.mul(p25, rlk, c1, c2)
    rr, ri = C.decode(p2, C.decrypt_to_coeffs(p2, sk, out))
    np.testing.assert_allclose(rr.numpy() + 1j * ri.numpy(), z1 * z2,
                               atol=3e-2)
