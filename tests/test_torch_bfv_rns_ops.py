"""The rest of the port's RNS-BFV against fhe_study_tpu.models.bfv_rns, bit
for bit: gadget relin and key-switching keys, the linear operations, the
coefficient-domain multiply with either relin key, the gadget branch of
``mul_e``, key switching, the modulus drop and the noise budget.

Keys and ciphertexts come from the JAX package (its XLA path on the CPU,
under jax.jit) and cross into the port through utils/interop.py; the
deterministic cores (``*_with``) are fed the JAX samplers' draws in the
reference's layout.  Tolerance 0, except the float noise budget (1e-9).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_study_tpu.models import bfv_rns as J
from fhe_study_tpu.utils import prng as jprng

from fhe_study_tpu_torch.models import bfv_rns as R
from fhe_study_tpu_torch.utils import interop

N, T, B, L, M = 256, 256, 2, 4, 5
JP = J.RnsParam(n=N, t=T, L=L, M=M)
P = R.RnsParam(n=N, t=T, L=L, M=M)
CPU = torch.device("cpu")


def i64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


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


@pytest.fixture(scope="module")
def ref():
    ks = jprng.split(jax.random.PRNGKey(5), 10)
    new_key = jax.jit(lambda k: J.new_key(k, JP))
    sk, pk = new_key(ks[0])
    sk2, _ = new_key(ks[1])
    rlk = jax.jit(lambda k, s: J.rlk_key(k, JP, J.SecretKey(*s)))(ks[2], sk)
    ksk = jax.jit(lambda k, s, s2: J.ksk_key(
        k, JP, J.SecretKey(*s), J.SecretKey(*s2)))(ks[3], sk, sk2)
    hk = J.hybrid_rlk1(ks[4], JP, sk)
    m = [jprng.uniform_mod(ks[5 + i], (B, N), T) for i in range(2)]
    enc = jax.jit(lambda k, m: J.encrypt(k, JP, pk, m, batch=(B,)))
    c = [enc(ks[7 + i], m[i]) for i in range(2)]
    return dict(ks=ks, sk=sk, sk2=sk2, pk=pk, rlk=rlk, ksk=ksk, hk=hk, m=m,
                c=c)


_to_evals = jax.jit(lambda c: J.to_evals(JP, J.CT(*c)))
_from_evals = jax.jit(lambda ce: J.from_evals(JP, J.CTE(*ce)))
_mul = {"RLK": jax.jit(lambda k, x, y: J.mul(JP, J.RLK(*k), J.CT(*x),
                                             J.CT(*y))),
        "HRLK": jax.jit(lambda k, x, y: J.mul(JP, J.HRLK(*k), J.CT(*x),
                                              J.CT(*y)))}


def test_rlk_key_core_matches_jax(ref):
    k_a, k_e = jprng.split(ref["ks"][2], 2)
    a = jnp.swapaxes(jprng.uniform_mod_multi(k_a, (L, N), JP.qs), 0, 1)
    e = jprng.gaussian_int(k_e, (L, N), J.ERR_SIGMA)
    rlk = R.rlk_key_with(P, port(ref["sk"]), interop.to_tensor(a, CPU),
                         i64(e))
    assert isinstance(rlk, R.RLK) and tuple(rlk.b.shape) == (L, L, N)
    same(rlk, tuple(ref["rlk"]))


def test_ksk_key_core_matches_jax(ref):
    k_a, k_e = jprng.split(ref["ks"][3], 2)
    a = np.stack([np.stack([np.asarray(jprng.uniform_mod(
        jax.random.fold_in(k_a, i * L + j), (N,), q))
        for j, q in enumerate(JP.qs)]) for i in range(L)])
    e = np.stack([np.asarray(jprng.gaussian_int(
        jax.random.fold_in(k_e, i), (N,), J.ERR_SIGMA)) for i in range(L)])
    ksk = R.ksk_key_with(P, port(ref["sk"]), port(ref["sk2"]),
                         interop.to_tensor(a, CPU), i64(e))
    same(ksk, tuple(ref["ksk"]))


def test_gadget_key_rejects_other_layouts(ref):
    a = torch.zeros((L, L - 1, N), dtype=torch.int32)
    with pytest.raises(ValueError, match="L=4"):
        R.rlk_key_with(P, port(ref["sk"]), a, torch.zeros((L, N)).long())


@pytest.mark.parametrize("op", ["add", "add_pt", "mul_pt"])
def test_linear_ops_match_jax(ref, op):
    c1, c2 = ref["c"]
    m2 = ref["m"][1]
    if op == "add":
        got = R.add(P, port(c1), port(c2))
        want = jax.jit(lambda x, y: J.add(JP, J.CT(*x), J.CT(*y)))(c1, c2)
    else:
        got = getattr(R, op)(P, port(c1), i64(m2))
        want = jax.jit(lambda x, m: getattr(J, op)(JP, J.CT(*x), m))(c1, m2)
    assert all(v.dtype == torch.int32 for v in got)
    same(got, tuple(want))


def test_tensor_matches_jax(ref):
    c1, c2 = ref["c"]
    got = R._tensor(P, port(c1), port(c2))
    want = jax.jit(lambda x, y: J._tensor(JP, J.CT(*x), J.CT(*y)))(c1, c2)
    same(got, tuple(want))


def test_relinearize_matches_jax(ref):
    rng = np.random.default_rng(6)
    cs = [np.stack([rng.integers(0, q, (B, N)) for q in JP.qs]
                   ).astype(np.uint32) for _ in range(3)]
    got = R.relinearize(P, port(ref["rlk"]),
                        *(interop.to_tensor(x, CPU) for x in cs))
    want = jax.jit(lambda k, c0, c1, c2: J.relinearize(
        JP, J.RLK(*k), c0, c1, c2))(ref["rlk"], *(jnp.asarray(x) for x in cs))
    same(got, tuple(want))
    with pytest.raises(ValueError, match="limbs"):
        R.relinearize(P, port(ref["rlk"]),
                      *(interop.to_tensor(x[:3], CPU) for x in cs))


@pytest.mark.parametrize("kind", ["RLK", "HRLK"])
def test_mul_matches_jax(ref, kind):
    key = ref["rlk"] if kind == "RLK" else ref["hk"]
    c1, c2 = ref["c"]
    got = R.mul(P, port(key), port(c1), port(c2))
    same(got, tuple(_mul[kind](key, c1, c2)))
    assert isinstance(got, R.CT) and got.c0.dtype == torch.int32


def test_eval_linear_ops_match_jax(ref):
    """add_e, pt_to_evals, mul_pt_e: the step of the linear pipeline."""
    c1, c2 = ref["c"]
    m2 = ref["m"][1]
    jx, jy = (J.CTE(*_to_evals(c)) for c in (c1, c2))
    x, y = port(jx), port(jy)
    jem = jax.jit(lambda m: J.pt_to_evals(JP, m))(m2)
    em = R.pt_to_evals(P, i64(m2))
    same(em, tuple(jem))
    jsum = jax.jit(lambda a, b: J.add_e(JP, J.CTE(*a), J.CTE(*b)))(jx, jy)
    got_sum = R.add_e(P, x, y)
    same(got_sum, tuple(jsum))
    jprod = jax.jit(lambda a, e: J.mul_pt_e(JP, J.CTE(*a), e))(jsum, jem)
    got = R.mul_pt_e(P, got_sum, em)
    assert isinstance(got, R.CTE) and all(v.dtype == torch.int32 for v in got)
    same(got, tuple(jprod))


def test_gadget_mul_e_matches_jax(ref):
    jx, jy = (J.CTE(*_to_evals(c)) for c in ref["c"])
    want = jax.jit(lambda k, x, y: J.mul_e(JP, J.RLK(*k), J.CTE(*x),
                                           J.CTE(*y)))(ref["rlk"], jx, jy)
    got = R.mul_e(P, port(ref["rlk"]), port(jx), port(jy))
    same(got, tuple(want))
    # the reference's claim, on the port: mul_e == mul on the Q components
    ct = R.mul(P, port(ref["rlk"]), *(port(c) for c in ref["c"]))
    back = R.from_evals(P, got)
    assert torch.equal(back.c0, ct.c0) and torch.equal(back.c1, ct.c1)


def test_key_switch_matches_jax(ref):
    c = ref["c"][0]
    got = R.key_switch(P, port(ref["ksk"]), port(c))
    want = jax.jit(lambda k, x: J.key_switch(JP, J.RLK(*k), J.CT(*x)))(
        ref["ksk"], c)
    same(got, tuple(want))
    rec = R.decrypt(P, port(ref["sk2"]), got)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(ref["m"][0]))


def test_mod_switch_drop_matches_jax(ref):
    c = _mul["RLK"](ref["rlk"], *ref["c"])
    got = R.mod_switch_drop(P, port(c))
    want = jax.jit(lambda x: J.mod_switch_drop(JP, J.CT(*x)))(c)
    assert tuple(got.c0.shape) == (L - 1, B, N)
    same(got, tuple(want))


def test_noise_budget_bits_matches_jax(ref):
    budget = jax.jit(lambda s, x, m: J.noise_budget_bits(
        JP, J.SecretKey(*s), J.CT(*x), m))
    sk = port(ref["sk"])
    fresh, m1 = ref["c"][0], ref["m"][0]
    prod = _mul["RLK"](ref["rlk"], *ref["c"])
    m12 = R.decrypt(P, sk, port(prod))
    for c, m in ((fresh, i64(m1)), (prod, m12)):
        got = R.noise_budget_bits(P, sk, port(c), m)
        want = np.asarray(budget(ref["sk"], c, jnp.asarray(m.numpy())))
        assert got.dtype == torch.float64 and tuple(got.shape) == (B,)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
    assert float(R.noise_budget_bits(P, sk, port(prod), m12).min()) > 0
