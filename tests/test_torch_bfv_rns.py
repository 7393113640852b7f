"""The port's RNS-BFV slice against fhe_study_tpu.models.bfv_rns, bit for bit.

Keys and ciphertexts come from the JAX package (its XLA path on the CPU,
under jax.jit to keep compile time down) and cross into the port through
utils/interop.py; the port's deterministic cores (``*_with``) are fed the
exact draws of the JAX samplers.  The last test is a
round trip on the port's own samplers, decrypt-verified against a numpy
negacyclic product.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_study_tpu.models import bfv_rns as J
from fhe_study_tpu.models import hybrid_ks as JH
from fhe_study_tpu.utils import prng as jprng

from fhe_study_tpu_torch.models import bfv_rns as R
from fhe_study_tpu_torch.utils import interop, prng

N, T, B = 256, 256, 2
JP = J.RnsParam(n=N, t=T, L=3, M=4)
P = R.RnsParam(n=N, t=T, L=3, M=4)
CPU = torch.device("cpu")


def i64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def same(got, want):
    """A port tensor (or NamedTuple of them) == reference array(s)."""
    got = (got,) if isinstance(got, torch.Tensor) else tuple(got)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(interop.to_numpy(g).astype(np.uint64),
                                      np.asarray(w).astype(np.uint64))


def negacyclic(a, b, t):
    """m1 * m2 mod (X^n + 1, t) for [B, n] integer arrays."""
    n = a.shape[-1]
    lin = np.stack([np.convolve(x, y) for x, y in zip(a, b)])
    lin = np.concatenate([lin, np.zeros(lin.shape[:-1] + (1,), lin.dtype)],
                         -1)
    return (lin[:, :n] - lin[:, n:]) % t


@pytest.fixture(scope="module")
def ref():
    ks = jprng.split(jax.random.PRNGKey(3), 6)
    sk, pk = jax.jit(lambda k: J.new_key(k, JP))(ks[0])
    hk = J.hybrid_rlk1(ks[1], JP, sk)
    m = [jprng.uniform_mod(ks[2 + i], (B, N), T) for i in range(2)]
    enc = jax.jit(lambda k, m: J.encrypt(k, JP, pk, m, batch=(B,)))
    c = [enc(ks[4 + i], m[i]) for i in range(2)]
    return dict(ks=ks, sk=sk, pk=pk, hk=hk, m=m, c=c)


_to_evals = jax.jit(lambda c: J.to_evals(JP, J.CT(*c)))
_from_evals = jax.jit(lambda ce: J.from_evals(JP, J.CTE(*ce)))
_mul_e = jax.jit(lambda h, x, y: J.mul_e(JP, J.HRLK(*h), J.CTE(*x),
                                         J.CTE(*y)))
_decrypt = jax.jit(lambda sk, c: J.decrypt(JP, J.SecretKey(*sk),
                                           J.CT(*c)))
_relin = jax.jit(lambda h, c0, c1, c2: J.relinearize_hybrid(
    JP, J.HRLK(*h), c0, c1, c2))


def test_new_key_core_matches_jax(ref):
    k_s, k_a, k_e = jprng.split(ref["ks"][0], 3)
    s = jprng.binary(k_s, (N,))
    a = jprng.uniform_mod_multi(k_a, (N,), JP.qs)
    e = jprng.gaussian_int(k_e, (N,), J.ERR_SIGMA)
    sk, pk = R.new_key_with(P, i64(s), interop.to_tensor(a, CPU), i64(e))
    same(sk, tuple(ref["sk"]))
    same(pk, tuple(ref["pk"]))


def test_hybrid_rlk1_core_matches_jax(ref):
    sk = interop.to_port(ref["sk"], CPU)
    k_a, k_e = jprng.split(ref["ks"][1], 2)
    both = JP.qs + JH.ks_ext_primes(JP, 2)
    a = jprng.uniform_mod_multi(k_a, (N,), both)
    e = jprng.gaussian_int(k_e, (N,), J.ERR_SIGMA)
    hk = R.hybrid_rlk1_with(P, sk, interop.to_tensor(a, CPU), i64(e))
    same(hk, tuple(ref["hk"]))


def test_encrypt_core_matches_jax(ref):
    pk = interop.to_port(ref["pk"], CPU)
    k_u, k_e0, k_e1 = jprng.split(ref["ks"][4], 3)
    u = jprng.ternary(k_u, (B, N))
    e0, e1 = (jprng.gaussian_int(k, (B, N), J.ERR_SIGMA) for k in (k_e0, k_e1))
    c = R.encrypt_with(P, pk, i64(ref["m"][0]), i64(u), i64(e0), i64(e1))
    same(c, tuple(ref["c"][0]))


def test_decrypt_matches_jax(ref):
    sk = interop.to_port(ref["sk"], CPU)
    for m, c in zip(ref["m"], ref["c"]):
        got = R.decrypt(P, sk, interop.to_port(c, CPU))
        np.testing.assert_array_equal(got.numpy(), np.asarray(m))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(_decrypt(ref["sk"], c)))


def test_to_evals_and_from_evals_match_jax(ref):
    c = ref["c"][0]
    ce = R.to_evals(P, interop.to_port(c, CPU))
    jce = J.CTE(*_to_evals(c))
    same(ce, tuple(jce))
    same(R.from_evals(P, interop.to_port(jce, CPU)), tuple(_from_evals(jce)))


def test_relinearize_hybrid_matches_jax(ref):
    rng = np.random.default_rng(4)
    cs = [np.stack([rng.integers(0, q, (B, N)) for q in JP.qs]
                   ).astype(np.uint32) for _ in range(3)]
    hk = interop.to_port(ref["hk"], CPU)
    got = R.relinearize_hybrid(P, hk, *(interop.to_tensor(x, CPU)
                                        for x in cs))
    want = _relin(ref["hk"], *(jnp.asarray(x) for x in cs))
    same(got, tuple(want))


def test_mul_e_matches_jax(ref):
    """The slice: mul_e with the 1-row hybrid relin key, on the JAX
    package's keys and ciphertexts, equals the reference bit for bit."""
    jx, jy = (J.CTE(*_to_evals(c)) for c in ref["c"])
    want = _mul_e(ref["hk"], jx, jy)
    x, y = (interop.to_port(c, CPU) for c in (jx, jy))
    got = R.mul_e(P, interop.to_port(ref["hk"], CPU), x, y)
    same(got, tuple(want))
    rec = R.decrypt(P, interop.to_port(ref["sk"], CPU), R.from_evals(P, got))
    m1, m2 = (np.asarray(m).astype(np.int64) for m in ref["m"])
    np.testing.assert_array_equal(rec.numpy(), negacyclic(m1, m2, T))


def test_mul_e_rejects_a_gadget_key(ref):
    x = R.to_evals(P, interop.to_port(ref["c"][0], CPU))
    with pytest.raises(TypeError, match="HRLK"):
        R.mul_e(P, tuple(interop.to_port(ref["hk"], CPU)), x, x)


def test_round_trip_on_port_samplers():
    """keygen -> encrypt -> to_evals -> mul_e -> from_evals -> decrypt on the
    port's own samplers at the main path's basis sizes (L=4, M=5, K=2)."""
    param = R.RnsParam(n=N, t=T, L=4, M=5)
    gen = prng.Gen(11)
    sk, pk = R.new_key(gen, param, CPU)
    hk = R.hybrid_rlk1(gen, param, sk)
    assert tuple(hk.b.shape) == (param.L + 2, N)
    m1, m2 = (prng.uniform_mod(gen, (B, N), T, CPU) for _ in range(2))
    c1, c2 = (R.encrypt(gen, param, pk, m, batch=(B,)) for m in (m1, m2))
    assert torch.equal(R.decrypt(param, sk, c1), m1)
    ce = R.mul_e(param, hk, R.to_evals(param, c1), R.to_evals(param, c2))
    assert all(v.dtype == torch.int32 for v in ce)
    rec = R.decrypt(param, sk, R.from_evals(param, ce))
    np.testing.assert_array_equal(rec.numpy(),
                                  negacyclic(m1.numpy(), m2.numpy(), T))
