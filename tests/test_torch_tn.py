"""The port's torus ring, single-prime NTT and integer helpers against the
JAX package, bit for bit.

Torus words are u64 in the JAX package and int64 of the same bits in the
port; every input straddles 2^63 (0, 1, 2^63 - 1, 2^63, 2^64 - 1, random), so
a shift, compare, remainder or float conversion that treated the words as
signed would show.  The JAX side runs on the CPU, its Pallas kernel in
interpret mode.  Tolerance 0 everywhere: all of it is integer arithmetic, and
``mul_div_round`` is one correctly rounded float64 expression.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_study_tpu.arith import tn as jtn
from fhe_study_tpu.arith.params import RingParam as JRingParam
from fhe_study_tpu.arith.ring import TorusRing as JTorusRing
from fhe_study_tpu.ops import modops as jmodops
from fhe_study_tpu.ops import ntt as jntt
from fhe_study_tpu.ops import ntt_pallas

from fhe_study_tpu_torch.arith import tn
from fhe_study_tpu_torch.arith.params import TORUS_Q, RingParam
from fhe_study_tpu_torch.arith.ring import RqRing, TorusRing, ring_for
from fhe_study_tpu_torch.ops import modops, ntt
from fhe_study_tpu_torch.utils import interop, prng

EDGES = [0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1, (1 << 63) + 1,
         (1 << 32) - 1, 1 << 32]


def torus(seed, shape):
    """Random u64 words whose first entries are the edge values."""
    x = np.random.default_rng(seed).integers(0, 1 << 64, shape,
                                             dtype=np.uint64)
    x.flat[:len(EDGES)] = EDGES
    return x


CPU = torch.device("cpu")


def tt(a):
    return interop.bits_to_tensor(np.asarray(a, np.uint64), CPU)


def same(got, want):
    np.testing.assert_array_equal(interop.bits_to_numpy(got),
                                  np.asarray(want).astype(np.uint64))


def test_i64_folds_constants_above_2_63():
    assert tn.i64((1 << 64) - 1) == -1 and tn.i64(1 << 63) == -(1 << 63)
    assert tn.i64((1 << 63) - 1) == (1 << 63) - 1 and tn.i64(1 << 64) == 0
    assert torch.tensor(tn.i64(TORUS_Q // 8)).dtype == torch.int64


@pytest.mark.parametrize("op", ["add", "sub", "neg", "scalar_mul_int",
                                "scalar_mul_array"])
def test_wrapping_ops(op):
    a, b = torus(1, (3, 16)), torus(2, (3, 16))
    if op == "neg":
        same(tn.neg(tt(a)), jtn.neg(jnp.asarray(a)))
    elif op == "scalar_mul_int":
        s = (1 << 64) - 12345
        same(tn.scalar_mul(tt(a), s), jtn.scalar_mul(jnp.asarray(a), s))
    elif op == "scalar_mul_array":
        same(tn.scalar_mul(tt(a), tt(b)), jtn.scalar_mul(jnp.asarray(a), b))
    else:
        same(getattr(tn, op)(tt(a), tt(b)),
             getattr(jtn, op)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("length", [16, 17, 31, 32, 40, 70])
def test_reduce_negacyclic_and_from_u64(length):
    c = torus(3, (2, length))
    same(tn.reduce_negacyclic(tt(c), 16), jtn.reduce_negacyclic(
        jnp.asarray(c), 16))
    same(tn.from_u64(c, 16, CPU), jtn.from_u64(c, 16))
    signed = c.view(np.int64)
    same(tn.from_i64(signed, 16, CPU), jtn.from_i64(signed, 16))


def test_naive_mul():
    a, b = torus(4, (2, 3, 16)), torus(5, (3, 16))
    same(tn.naive_mul(tt(a), tt(b)),
         jtn.naive_mul(jnp.asarray(a), jnp.asarray(b)))
    # and against the O(n^2) definition in Python integers
    x, y = [int(v) for v in a[0, 0]], [int(v) for v in b[0]]
    want = [0] * 16
    for i in range(16):
        for j in range(16):
            sign = -1 if i + j >= 16 else 1
            want[(i + j) % 16] += sign * x[i] * y[j]
    got = interop.bits_to_numpy(tn.naive_mul(tt(a), tt(b)))[0, 0]
    assert [int(v) for v in got] == [v % (1 << 64) for v in want]


@pytest.mark.parametrize("n", [64, 128])
def test_mul_crt_and_mul(n):
    a, b = torus(6, (2, n)), torus(7, (2, n))
    want = jax.jit(jtn.mul_crt)(a, b)
    same(tn.mul_crt(tt(a), tt(b)), want)
    same(tn.mul(tt(a), tt(b)), want)
    same(tn.mul_crt(tt(a), tt(b)), jax.jit(jtn.naive_mul)(a, b))


def test_mul_below_64_is_the_schoolbook():
    a, b = torus(8, (2, 16)), torus(9, (2, 16))
    same(tn.mul(tt(a), tt(b)), jtn.mul(jnp.asarray(a), jnp.asarray(b)))


def test_split_limbs_on_words_above_2_63():
    a = torus(10, (3, 16))
    same(tn._split_limbs(tt(a)), jtn._split_limbs(jnp.asarray(a)))


@pytest.mark.parametrize("h", ["per_batch", "scalar", "static"])
def test_left_rotate(h):
    n = 128
    a = torus(11, (4, 2, n))
    if h == "per_batch":                       # every h of [0, 2n) occurs
        hs = np.arange(2 * n).reshape(64, 4, 1)
        a = torus(11, (64, 4, 2, n))
        same(tn.left_rotate(tt(a), torch.from_numpy(hs), n),
             jtn.left_rotate(jnp.asarray(a), jnp.asarray(hs), n))
    elif h == "scalar":
        for v in (0, 1, n - 1, n, n + 1, 2 * n - 1):
            same(tn.left_rotate(tt(a), torch.tensor(v), n),
                 jtn.left_rotate(jnp.asarray(a), jnp.asarray(v), n))
    else:
        same(tn.left_rotate(tt(a), 2 * n + 5, n),
             jtn.left_rotate(jnp.asarray(a), 2 * n + 5, n))


@pytest.mark.parametrize("q2", [2, 256, 2048, 1 << 32, 1 << 62, 1 << 63])
def test_mod_switches(q2):
    a = torus(12, (5, 64))
    a[1, :4] = [(1 << 64) - (1 << 52), (1 << 64) - (1 << 52) - 1,
                (1 << 63) - (1 << 52), (1 << 63) + (1 << 52)]
    same(tn.mod_switch(tt(a), q2), jtn.mod_switch(jnp.asarray(a), q2))
    same(tn.mod_switch_round(tt(a), q2),
         jtn.mod_switch_round(jnp.asarray(a), q2))
    if q2 < (1 << 31):
        same(tn.mod_switch_to_rq(tt(a), q2),
             jtn.mod_switch_to_rq(jnp.asarray(a), q2))


def test_mod_switch_refuses_other_moduli():
    with pytest.raises(ValueError, match="power of two"):
        tn.mod_switch(tt(torus(1, (4,))), 12)


@pytest.mark.parametrize("num,den", [(8, TORUS_Q), (128, TORUS_Q),
                                     (4096, TORUS_Q), (3, 7), (1, 1 << 40)])
def test_mul_div_round(num, den):
    """Random words, the band above 2^63 where ``x.double() + 2^64`` would
    round twice (float64 spacing 2^10 below 2^63, 2^11 above), and exact
    ties of the final rounding."""
    band = np.array([(1 << 63) + 1024 * k + d for k in range(1, 40, 2)
                     for d in (-1, 0, 1)], np.uint64)
    ties = np.array([(2 * k + 1) << (63 - 4) for k in range(16)], np.uint64)
    near = np.array([(1 << 64) - 1 - k for k in range(0, 3000, 7)], np.uint64)
    for x in (torus(13, (4000,)), band, ties, near):
        same(tn.mul_div_round(tt(x), num, den),
             jtn.mul_div_round(jnp.asarray(x), num, den))


def test_u64_to_f64_is_the_unsigned_conversion():
    x = np.concatenate([torus(14, (4000,)),
                        np.array([(1 << 63) + 1024 * k + 1
                                  for k in range(1, 400, 2)], np.uint64)])
    np.testing.assert_array_equal(tn.u64_to_f64(tt(x)).numpy(),
                                  x.astype(np.float64))
    assert float(TORUS_Q) == 2.0 ** 64


@pytest.mark.parametrize("kind,args", [
    ("decompose_base2", (64,)), ("decompose_base2", (8,)),
    ("decompose_base2_reference", (8,)), ("decompose_base_pow2", (8, 3)),
    ("decompose_base_pow2", (12, 2)), ("decompose_base_pow2", (16, 4)),
    ("decompose_base_pow2", (4, 8)), ("decompose", (2, 64)),
    ("decompose", (256, 3)), ("decompose", (4096, 2)), ("decompose", (16, 8)),
])
def test_decompositions(kind, args):
    a = torus(15, (3, 32))
    same(getattr(tn, kind)(tt(a), *args),
         getattr(jtn, kind)(jnp.asarray(a), *args))


def test_decompose_recomposes_the_top_bits():
    a = torus(16, (64,))
    d = tn.decompose(tt(a), 4096, 2)
    back = d[0] * tn.i64(1 << 52) + d[1] * (1 << 40)
    same(back, a & np.uint64(~((1 << 40) - 1) & ((1 << 64) - 1)))


def test_decompose_refuses_a_base_that_is_no_power_of_two():
    with pytest.raises(ValueError, match="beta"):
        tn.decompose(tt(torus(1, (4,))), 12, 2)
    with pytest.raises(ValueError, match="64"):
        tn.decompose_base_pow2(tt(torus(1, (4,))), 16, 5)


# -- the single-prime transform ------------------------------------------------

PRIMES = ntt.CRT_PRIMES[:2] + ntt.CRT_PRIMES_TFHE


def test_crt_primes_are_the_reference_s():
    assert ntt.CRT_PRIMES == jntt.CRT_PRIMES
    assert ntt.CRT_PRIMES_TFHE == jntt.CRT_PRIMES_TFHE
    assert all(p > 1 << 30 for p in ntt.CRT_PRIMES[:2])


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("q", PRIMES)
def test_ntt_and_intt_match_reference_and_pallas(q, n):
    rng = np.random.default_rng(q % 1000 + n)
    x = rng.integers(0, q, (3, 2, n)).astype(np.uint64)
    x[0, 0, :3] = [0, 1, q - 1]
    xj = jnp.asarray(x)
    fwd = ntt.ntt(torch.from_numpy(x.astype(np.int64)), q)
    assert fwd.dtype == torch.int64
    same(fwd, jax.jit(lambda v: jntt.ntt(v, q))(xj))
    same(fwd, ntt_pallas.ntt_u32(xj, q, interpret=True))
    inv = ntt.intt(torch.from_numpy(x.astype(np.int64)), q)
    same(inv, jax.jit(lambda v: jntt.intt(v, q))(xj))
    same(inv, ntt_pallas.ntt_u32(xj, q, inverse=True, interpret=True))
    same(ntt.intt(fwd, q), x)


@pytest.mark.parametrize("q", PRIMES[:1] + PRIMES[2:3])
def test_negacyclic_mul(q):
    rng = np.random.default_rng(3)
    a, b = (rng.integers(0, q, (2, 128)).astype(np.uint64) for _ in range(2))
    same(ntt.negacyclic_mul(torch.from_numpy(a.astype(np.int64)),
                            torch.from_numpy(b.astype(np.int64)), q),
         jax.jit(lambda u, v: jntt.negacyclic_mul(u, v, q))(a, b))


def test_ntt_of_degree_one_and_below_the_kernel_range():
    x = torch.tensor([[5], [7]])
    assert ntt.ntt(x, 17) is x and ntt.intt(x, 17) is x
    q = ntt.CRT_PRIMES_TFHE[0]
    a = np.random.default_rng(0).integers(0, q, (2, 16)).astype(np.uint64)
    same(ntt.ntt(torch.from_numpy(a.astype(np.int64)), q),
         jax.jit(lambda v: jntt.ntt(v, q))(a))


def test_crt_lift_centered():
    p1, p2 = ntt.CRT_PRIMES[:2]
    vals = [0, 1, -1, p1 * p2 // 2, -(p1 * p2 // 2), 123456789012345,
            -98765432109876]
    r1 = torch.tensor([v % p1 for v in vals])
    r2 = torch.tensor([v % p2 for v in vals])
    assert ntt.crt_lift_centered(r1, r2, p1, p2).tolist() == vals


# -- modops and the samplers ---------------------------------------------------

@pytest.mark.parametrize("q", [8, 257, 1000, (1 << 31) - 1])
def test_modops_match_reference(q):
    a, b = (np.random.default_rng(s).integers(0, q, (50,)).astype(np.uint64)
            for s in (1, 2))
    a[:2], b[:2] = [0, q - 1], [0, q - 1]
    ta, tb = (torch.from_numpy(v.astype(np.int64)) for v in (a, b))
    same(modops.addmod(ta, tb, q), jmodops.addmod(jnp.asarray(a),
                                                  jnp.asarray(b), q))
    same(modops.negmod(ta, q), jmodops.negmod(jnp.asarray(a), q))
    w = torus(17, (200,))
    same(modops.coerce_u64(tt(w), q), jmodops.coerce_u64(jnp.asarray(w), q))


def test_modops_refuse_a_wide_modulus():
    with pytest.raises(ValueError, match="2\\^63"):
        modops.coerce_u64(torch.zeros(2, dtype=torch.int64), 1 << 63)


def test_torus_samplers():
    gen = prng.Gen(0)
    u = prng.uniform_u64(gen, (64, 1024), "cpu")
    assert u.dtype == torch.int64
    bits = interop.bits_to_numpy(u)
    assert (bits >> np.uint64(63)).mean() == pytest.approx(0.5, abs=0.01)
    assert ((bits >> np.uint64(31)) & np.uint64(1)).mean() == pytest.approx(
        0.5, abs=0.01)
    assert (bits & np.uint64(1)).mean() == pytest.approx(0.5, abs=0.01)
    g = prng.gaussian_torus(gen, (64, 1024), 3.2, "cpu")
    assert g.dtype == torch.int64 and int(g.min()) < 0 < int(g.max())
    assert float(g.double().std()) == pytest.approx(3.2, abs=0.05)


# -- the torus ring ------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 16, 128])
def test_torus_ring_contract_and_mul(n):
    ring, jring = TorusRing(n), JTorusRing(n)
    x, y = torus(18, (2, 3, n)), torus(19, (3, n))
    same(ring.contract(tt(x), tt(y)), jax.jit(jring.contract)(x, y))
    same(ring.mul(tt(x), tt(y)), jax.jit(jring.mul)(x, y))
    assert tuple(ring.zeros((2,), CPU).shape) == (2, n)
    assert ring.param == RingParam(TORUS_Q, n)
    assert jring.param == JRingParam(TORUS_Q, n)


def test_torus_ring_elementwise_and_gadget():
    ring, jring = TorusRing(16), JTorusRing(16)
    a, b = torus(20, (3, 16)), torus(21, (3, 16))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    same(ring.add(tt(a), tt(b)), jring.add(ja, jb))
    same(ring.sub(tt(a), tt(b)), jring.sub(ja, jb))
    same(ring.neg(tt(a)), jring.neg(ja))
    s = (1 << 64) - 3
    same(ring.scalar_mul_u64(tt(a), s), jring.scalar_mul_u64(ja, s))
    same(ring.decompose(tt(a), 256, 3), jring.decompose(ja, 256, 3))
    same(ring.mod_switch(tt(a), 512), jring.mod_switch(ja, 512))
    same(ring.mul_div_round(tt(a), 8, TORUS_Q),
         jring.mul_div_round(ja, 8, TORUS_Q))
    same(ring.decode_scale(tt(a), 8), jring.decode_scale(ja, 8))
    same(ring.from_u64(torus(22, (40,)), CPU),
         jring.from_u64(torus(22, (40,))))


def test_ring_for():
    assert ring_for(RingParam(TORUS_Q, 64)) == TorusRing(64)
    assert ring_for(RingParam(97, 64)) == RqRing(97, 64)
    with pytest.raises(ValueError):
        RingParam(1, 64)
