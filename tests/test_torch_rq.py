"""The port's Z_q layer against the JAX package, bit for bit: ``modops``
below and above 2^31 and 2^32 (the Montgomery path up to 2^63), ``mul128``
at the limb edges, ``invmod`` of composite moduli, ``rq``, ``rn``,
``RqRing``, the single-prime NTT on both sides of the reference's kernel
gate, ``ntt_cyclic`` / ``intt_cyclic``, ``polymul_i64_crt`` and
``negacyclic_conv_crt_u64``; the reference's SageMath golden vectors and
golden strings (tests/test_rings.py, test_ntt.py, test_modops.py), exact;
and the port's K9 gate against the reference's ``_pallas_ok`` rule over a
grid of (q, n), with the dispatch that follows it.

Values are u64 in the JAX package and int64 of the same bits in the port.
The JAX side runs jitted on the CPU.  Tolerance 0: all of it is integer
arithmetic or one correctly rounded float64 expression.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_study_tpu.arith import rn as jrn
from fhe_study_tpu.arith import rq as jrq
from fhe_study_tpu.arith.params import RingParam as JRingParam
from fhe_study_tpu.arith.ring import ring_for as jring_for
from fhe_study_tpu.ops import modops as jmodops
from fhe_study_tpu.ops import ntt as jntt

from fhe_study_tpu_torch.arith import rn, rq
from fhe_study_tpu_torch.arith.params import RingParam
from fhe_study_tpu_torch.arith.ring import RqRing, ring_for
from fhe_study_tpu_torch.ops import _cuda, modops, ntt, ntt_cuda
from fhe_study_tpu_torch.utils import interop

CPU = torch.device("cpu")
Q = 2 ** 16 + 1
# moduli on every path of mulmod: int64-exact, below 2^32, Montgomery (the
# BFV p*q, a 40-bit NTT prime, and odd moduli at 2^62 and just under 2^63)
WIDE_P = 1099511922689              # a 41-bit prime, 1 mod 2^15
MODULI = [257, (1 << 31) - 1, (1 << 31) + 11, 4294967291, 65537 ** 3,
          WIDE_P, (1 << 62) + 1, (1 << 63) - 25]


def tt(a):
    return interop.bits_to_tensor(np.asarray(a, np.uint64), CPU)


def same(got, want):
    np.testing.assert_array_equal(interop.bits_to_numpy(got),
                                  np.asarray(want).astype(np.uint64))


def residues(seed, q, shape):
    x = np.random.default_rng(seed).integers(0, q, shape, dtype=np.uint64)
    x.flat[:3] = [0, 1, q - 1]
    return x


# -- modops -------------------------------------------------------------------

@pytest.mark.parametrize("q", MODULI)
def test_modops_match_reference(q):
    a, b = residues(1, q, (64,)), residues(2, q, (64,))
    b[:3] = [q - 1, q - 1, q - 1]
    w = np.random.default_rng(3).integers(0, 1 << 64, (64,), dtype=np.uint64)
    w[:4] = [0, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
    s = np.random.default_rng(4).integers(-(1 << 62), 1 << 62, (64,))
    ja, jb = jnp.asarray(a), jnp.asarray(b)

    @jax.jit
    def ref(ja, jb, jw, js):
        return (jmodops.addmod(ja, jb, q), jmodops.submod(ja, jb, q),
                jmodops.negmod(ja, q), jmodops.mulmod(ja, jb, q),
                jmodops.coerce_u64(jw, q), jmodops.coerce_i64(js, q))

    want = ref(ja, jb, jnp.asarray(w), jnp.asarray(s))
    ta, tb = tt(a), tt(b)
    got = (modops.addmod(ta, tb, q), modops.submod(ta, tb, q),
           modops.negmod(ta, q), modops.mulmod(ta, tb, q),
           modops.coerce_u64(tt(w), q),
           modops.coerce_i64(torch.from_numpy(s), q))
    # the reference's coerce_i64 adds q to a residue in int64, which wraps
    # for q > 2^62; the port's is exact there (checked below)
    for i, (g, x) in enumerate(zip(got, want)):
        if i != 5 or q <= 1 << 62:
            same(g, x)
    # and against Python integers
    assert interop.bits_to_numpy(got[3]).tolist() == [
        int(x) * int(y) % q for x, y in zip(a, b)]
    assert got[5].tolist() == [int(x) % q for x in s]
    assert interop.bits_to_numpy(modops.powmod(ta, q - 2, q)).tolist() == [
        pow(int(x), q - 2, q) for x in a]


def test_mul128_at_the_limb_edges():
    edges = [0, 1, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63,
             (1 << 64) - 1]
    a = np.array([x for x in edges for _ in edges], np.uint64)
    b = np.array(edges * len(edges), np.uint64)
    r = np.random.default_rng(5).integers(0, 1 << 64, (2, 64),
                                          dtype=np.uint64)
    a, b = np.concatenate([a, r[0]]), np.concatenate([b, r[1]])
    hi, lo = modops.mul128(tt(a), tt(b))
    full = [int(x) * int(y) for x, y in zip(a, b)]
    assert interop.bits_to_numpy(hi).tolist() == [f >> 64 for f in full]
    assert interop.bits_to_numpy(lo).tolist() == [f % (1 << 64) for f in full]
    jhi, jlo = jax.jit(jmodops.mul128)(jnp.asarray(a), jnp.asarray(b))
    same(hi, jhi)
    same(lo, jlo)


def test_scalar_golden_vectors():
    """tests/test_modops.py: exp, neg, inv (reference zq.rs tests)."""
    q = 1021
    assert modops.powmod(torch.tensor(3), 3, q).item() == 27
    assert modops.powmod(torch.tensor(1000), 3, q).item() == 949
    a = modops.coerce_f64(torch.tensor(101.0), q)
    b = modops.coerce_f64(torch.tensor(-1.0), q)
    assert modops.negmod(a, q).item() == modops.mulmod(a, b, q).item()
    for q in (7, 41, 257, 1021, 65537):
        v = torch.tensor([1, 2, 3, q - 1, q // 2])
        assert modops.mulmod(v, modops.invmod_prime(v, q), q).tolist() == \
            [1] * 5
        assert modops.divmod_prime(torch.ones(5, dtype=torch.long), v,
                                   q).tolist() == [pow(int(x), -1, q)
                                                   for x in v]


@pytest.mark.parametrize("q", [15, 21, 3 ** 5 * 7 * 11, 2 ** 16, 12,
                               2 ** 20 * 9, 65537, (1 << 31) - 1,
                               6700417 * 641, 65537 ** 3])
def test_invmod_of_any_modulus(q):
    """The reference's egcd semantics: any modulus, any coprime input."""
    rng = np.random.default_rng(0)
    vs = [v for v in (1, 2, 3, 5, q - 1, q // 2, 7, 11, 97)
          if 0 < v < q and np.gcd(v, q) == 1]
    vs += [int(v) for v in rng.integers(1, q, 16) if np.gcd(int(v), q) == 1]
    want = [pow(v, -1, q) for v in vs]
    assert modops.invmod(torch.tensor(vs), q).tolist() == want
    assert modops.divmod_any(torch.ones(len(vs), dtype=torch.long),
                             torch.tensor(vs), q).tolist() == want
    if q < 1 << 31:
        same(modops.invmod(torch.tensor(vs), q),
             jax.jit(lambda a: jmodops.invmod(a, q))(
                 jnp.asarray(np.array(vs, np.uint64))))


def test_decompose_golden_and_against_reference():
    """tests/test_modops.py's round trips and saturation cases, then both
    gadgets against the JAX package on random words."""
    d = modops.decompose(torch.tensor(9), 16, 2, 4)
    assert modops.recompose(d, 16, 2, 4).item() == 9
    q, beta, l = 5 ** 3, 5, 3
    xs = torch.from_numpy(np.random.default_rng(0).integers(0, q, 1000))
    d = modops.decompose(xs, q, beta, l)
    assert tuple(d.shape) == (l, 1000)
    assert torch.equal(modops.recompose(d, q, beta, l), xs)
    for q, beta, l, x, back in ((2 ** 4 + 1, 2, 4, 16, 15),
                                (5 ** 3 + 1, 5, 3, 125, 124),
                                (2 ** 16 + 1, 2, 16, 2 ** 16, 2 ** 16 - 1)):
        d = modops.decompose(torch.tensor(x), q, beta, l)
        assert modops.recompose(d, q, beta, l).item() == back
    for q, beta, l in ((Q, 2, 16), (Q, 4, 8), (65537 ** 3, 1 << 12, 4)):
        v = residues(6, q, (3, 32))
        want = jax.jit(lambda a: jmodops.decompose(a, q, beta, l))(
            jnp.asarray(v))
        got = modops.decompose(tt(v), q, beta, l)
        same(got, want)
        same(modops.recompose(got, q, beta, l),
             jmodops.recompose(want, q, beta, l))


@pytest.mark.parametrize("q, q2", [(Q, 2 ** 8 + 1), (65537 ** 3, Q),
                                   ((1 << 62) + 1, 65537 ** 3)])
def test_mod_switch_and_mul_div_round(q, q2):
    v = residues(7, q, (97,))
    jv = jnp.asarray(v)
    same(modops.mod_switch(tt(v), q, q2), jmodops.mod_switch(jv, q, q2))
    same(modops.mul_div_round(tt(v), 4, q, q2),
         jmodops.mul_div_round(jv, 4, q, q2))
    f = np.random.default_rng(8).normal(0, 1e6, 97)
    same(modops.coerce_f64(torch.from_numpy(f), q2),
         jmodops.coerce_f64(jnp.asarray(f), q2))


def test_modops_refuse_moduli_outside_the_int64_forms():
    for q in (1, 1 << 63):
        with pytest.raises(ValueError, match="2\\^63"):
            modops.addmod(torch.zeros(2, dtype=torch.long),
                          torch.zeros(2, dtype=torch.long), q)
    with pytest.raises(ValueError, match="odd"):
        modops.mulmod(torch.zeros(2, dtype=torch.long), 1, 1 << 40)


# -- rq and rn ----------------------------------------------------------------

def test_rq_golden_strings_and_decompose():
    """tests/test_rings.py (reference ring_nq.rs:626-730)."""
    q, n = 7, 3

    def p(c, q=q, n=n):
        return rq.from_u64(c, q, n, CPU)

    assert rq.to_string(p([0, 1, 2, 3, 4, 5]), q, n) == \
        "4*x^2 + 4*x + 4 mod Z_7/(X^3+1)"
    assert rq.to_string(p([0, 1, q + 2, 3, 4, 5]), q, n) == \
        "4*x^2 + 4*x + 4 mod Z_7/(X^3+1)"
    assert rq.to_string(p([0, 1, 2, 3, 4, 5], 7, 4), 7, 4) == \
        "3*x^3 + 2*x^2 + 3*x + 3 mod Z_7/(X^4+1)"
    assert rq.to_string(p([0, 0, 0, 0, 4, 5]), q, n) == \
        "2*x^2 + 3*x mod Z_7/(X^3+1)"
    assert rq.to_string(p([5, 4, 5, 2, 1, 0]), q, n) == \
        "5*x^2 + 3*x + 3 mod Z_7/(X^3+1)"
    a, b = p([0, 1, 2, 3, 4, 5]), p([5, 4, 3, 2, 1, 0])
    assert rq.to_string(rq.add(a, b, q), q, n) == "0 mod Z_7/(X^3+1)"
    assert rq.to_string(rq.sub(a, b, q), q, n) == \
        "x^2 + x + 1 mod Z_7/(X^3+1)"
    d = rq.decompose(rq.from_u64([7, 14, 3, 6], 16, 4, CPU), 16, 4, 2)
    assert d[0].tolist() == [1, 3, 0, 1] and d[1].tolist() == [3, 2, 3, 2]


def test_rq_mul_sage_vectors_and_python_ints():
    """tests/test_ntt.py (reference ring_nq.rs:667-704, SageMath), then a
    batch at n = 64 (below the kernel gate) and n = 128 (inside it) against
    a schoolbook product in Python integers."""
    a = rq.from_u64([1, 2, 3, 4], Q, 4, CPU)
    assert rq.mul(a, a, Q).tolist() == [65513, 65517, 65531, 20]
    a = rq.from_u64([0, 0, 0, 2], Q, 4, CPU)
    assert rq.mul(a, a, Q).tolist() == [0, 0, 65533, 0]
    rng = np.random.default_rng(3)
    for n in (64, 128):
        x, y = (rng.integers(0, Q, (2, n)) for _ in range(2))
        got = rq.mul(torch.from_numpy(x), torch.from_numpy(y), Q).tolist()
        for bi in range(2):
            c = [0] * (2 * n)
            for i in range(n):
                for j in range(n):
                    c[i + j] += int(x[bi, i]) * int(y[bi, j])
            assert got[bi] == [(c[k] - c[k + n]) % Q for k in range(n)]


@pytest.mark.parametrize("q", [Q, 65537 ** 3])
def test_rq_functions_match_reference(q):
    n = 16
    c = np.random.default_rng(9).integers(0, 1 << 64, (2, 3 * n + 5),
                                          dtype=np.uint64)
    ci = np.random.default_rng(10).integers(-(1 << 40), 1 << 40, (2, 40))
    a = residues(11, q, (2, n))
    f = np.random.default_rng(13).normal(0, 1e9, (2, 2 * n))
    s = np.uint64((1 << 64) - 3)

    @jax.jit
    def ref(c, ci, f, a):
        return (jrq.from_u64(c, q, n), jrq.from_i64(ci, q, n),
                jrq.from_f64(f, q, n), jrq.scalar_mul_u64(a, s, q),
                jrq.scalar_mul_f64(a, 0.37, q), jrq.remodule(a, q, 97),
                jrq.mod_switch(a, q, 257), jrq.div_round(a, 1000, q),
                jrq.coeffs_mod(a, 7), jrq.infinity_norm(a, q),
                jrq.to_centered_i64(a, q).astype(jnp.uint64))

    ta = tt(a)
    got = (rq.from_u64(tt(c), q, n, CPU),
           rq.from_i64(torch.from_numpy(ci), q, n, CPU),
           rq.from_f64(torch.from_numpy(f), q, n, CPU),
           rq.scalar_mul_u64(ta, int(s), q), rq.scalar_mul_f64(ta, 0.37, q),
           rq.remodule(ta, q, 97), rq.mod_switch(ta, q, 257),
           rq.div_round(ta, 1000, q), rq.coeffs_mod(ta, 7),
           rq.infinity_norm(ta, q), rq.to_centered_i64(ta, q))
    for g, w in zip(got, ref(*map(jnp.asarray, (c, ci, f, a)))):
        same(g, w)
    same(rq.from_evals(rq.to_evals(ta, Q), Q), a) if q == Q else None


def test_rq_matrix_ops_match_reference():
    A, Bm, v = (residues(s, Q, shp) for s, shp in ((0, (3, 4)), (1, (4, 5)),
                                                   (2, (4,))))
    same(rq.matrix_vec_product(tt(A), tt(v), Q),
         jrq.matrix_vec_product(jnp.asarray(A), jnp.asarray(v), Q))
    same(rq.matrix_mul(tt(A), tt(Bm), Q),
         jrq.matrix_mul(jnp.asarray(A), jnp.asarray(Bm), Q))
    same(rq.matrix_transpose(tt(A)), A.T)


def test_rn_golden_vectors_and_reference():
    """tests/test_rings.py (reference ring_n.rs:453-483, SageMath)."""
    a = torch.tensor([Q - 1, Q - 1])
    assert rn.naive_poly_mul(a, a).tolist() == [0, 8589934592]
    b = torch.tensor([1, Q - 1])
    assert rn.naive_poly_mul(b, b).tolist() == [-4294967295, 131072]
    assert rn.mod_centered_q(torch.tensor([12, -13, 6, -6, 5]), 11).tolist() \
        == [1, -2, -5, -6, 5]
    x, y = (np.random.default_rng(s).integers(-(1 << 30), 1 << 30, (3, 32))
            for s in (14, 15))

    @jax.jit
    def ref(x, y):
        return (jrn.naive_mul(x, y), jrn.mul(x, y), jrn.mod_centered_q(x, Q),
                jrn.infinity_norm(x).astype(jnp.int64),
                jrn.mul_div_round_to_rq(x, 3, Q, Q, 16).astype(jnp.int64),
                jrn.to_rq(x, Q, 16).astype(jnp.int64))

    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got = (rn.naive_mul(tx, ty), rn.mul(tx, ty), rn.mod_centered_q(tx, Q),
           rn.infinity_norm(tx), rn.mul_div_round_to_rq(tx, 3, Q, Q, 16),
           rn.to_rq(tx, Q, 16))
    for g, w in zip(got, ref(jnp.asarray(x), jnp.asarray(y))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("q, n", [(Q, 1), (Q, 128), (65537 ** 3, 1),
                                  (WIDE_P, 8)])
def test_rq_ring_matches_reference(q, n):
    ring, jring = ring_for(RingParam(q, n)), jring_for(JRingParam(q, n))
    assert ring == RqRing(q, n)
    x, y = residues(16, q, (2, 5, n)), residues(17, q, (2, 5, n))

    @jax.jit
    def ref(x, y):
        return (jring.contract(x, y), jring.mul(x, y),
                jring.scalar_mul_u64(x, 12345), jring.decompose(x, 4, 8),
                jring.mod_switch(x, 257), jring.decode_scale(x, 4),
                jring.add(x, y), jring.sub(x, y), jring.neg(x))

    tx, ty = tt(x), tt(y)
    got = (ring.contract(tx, ty), ring.mul(tx, ty),
           ring.scalar_mul_u64(tx, 12345), ring.decompose(tx, 4, 8),
           ring.mod_switch(tx, 257), ring.decode_scale(tx, 4),
           ring.add(tx, ty), ring.sub(tx, ty), ring.neg(tx))
    for g, w in zip(got, ref(jnp.asarray(x), jnp.asarray(y))):
        same(g, w)


# -- the single-prime NTT, cyclic NTT and CRT products ------------------------

@pytest.mark.parametrize("q, n", [(Q, 4), (Q, 64), (Q, 128), (2013265921, 256),
                                  (WIDE_P, 128)])
def test_ntt_matches_reference(q, n):
    """Below n = 128 and above 2^31 (the reference's XLA loop, here the
    wide plain transform) and inside the gate (its kernel, here K9's plain
    version)."""
    a, b = residues(18, q, (3, n)), residues(19, q, (3, n))
    e = ntt.ntt(tt(a), q)
    same(ntt.intt(e, q), a)
    if q >= 1 << 31:          # RqRing.mul holds the wide product (n = 8)
        same(e, jax.jit(lambda x: jntt.ntt(x, q))(jnp.asarray(a)))
        return
    want = jax.jit(lambda x, y: (jntt.ntt(x, q),
                                 jntt.negacyclic_mul(x, y, q)))(
        jnp.asarray(a), jnp.asarray(b))
    same(e, want[0])
    same(ntt.negacyclic_mul(tt(a), tt(b), q), want[1])


@pytest.mark.parametrize("q, n, w", [(Q, 16, None), (2013265921, 64, None),
                                     (Q, 8, pow(3, (Q - 1) // 8, Q)),
                                     (WIDE_P, 32, None)])
def test_cyclic_ntt_matches_reference(q, n, w):
    a = residues(20, q, (2, n))
    e = ntt.ntt_cyclic(tt(a), q, w)
    same(e, jax.jit(lambda x: jntt.ntt_cyclic(x, q, w))(jnp.asarray(a)))
    same(ntt.intt_cyclic(e, q, w), a)
    plan, jplan = ntt.get_cyclic_plan(q, n, w), jntt.get_cyclic_plan(q, n, w)
    assert (plan.w, plan.n_inv) == (jplan.w, jplan.n_inv)


def test_crt_products_exact_and_match_reference():
    """tests/test_ntt.py's CRT product against Python integers at n = 128
    (inside the kernel gate), then both products against the JAX package
    near their ranges' edges."""
    rng = np.random.default_rng(5)
    n = 128
    a, b = (rng.integers(-(2 ** 20), 2 ** 20, size=(n,)) for _ in range(2))
    got = ntt.polymul_i64_crt(torch.from_numpy(a), torch.from_numpy(b))
    c = [0] * (2 * n)
    for i in range(n):
        for j in range(n):
            c[i + j] += int(a[i]) * int(b[j])
    assert got.tolist() == [c[k] - c[k + n] for k in range(n)]
    a, b = (rng.integers(-(2 ** 26), 2 ** 26, size=(2, 256)) for _ in range(2))
    np.testing.assert_array_equal(
        ntt.polymul_i64_crt(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax.jit(jntt.polymul_i64_crt)(jnp.asarray(a),
                                                 jnp.asarray(b))))
    a, b = (rng.integers(0, 2 ** 26, size=(2, 128), dtype=np.uint64)
            for _ in range(2))
    same(ntt.negacyclic_conv_crt_u64(tt(a), tt(b)),
         jax.jit(jntt.negacyclic_conv_crt_u64)(jnp.asarray(a),
                                               jnp.asarray(b)))


GATE_Q = [Q, 2013265921, 1811939329, (1 << 31) - 1, 1 << 31, WIDE_P]
GATE_N = [1, 2, 64, 128, 256, 384, 1024, 1 << 14, 1 << 15]


def test_k9_gate_is_the_reference_rule(monkeypatch):
    """ntt.k9_gate(q, n) == the reference's _pallas_ok(q, n) on a TPU
    backend, over a grid of (q, n) on both sides of 2^31 and 128."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jntt, "_USE_PALLAS", True)
    for q in GATE_Q:
        for n in GATE_N:
            assert ntt.k9_gate(q, n) == jntt._pallas_ok(q, n), (q, n)


@pytest.mark.parametrize("q", [Q, 1811939329, WIDE_P])
@pytest.mark.parametrize("n", [2, 64, 128, 1024])
def test_dispatch_follows_the_gate(monkeypatch, q, n):
    """With the tensors taken for CUDA ones, the transforms reach K9's
    wrapper exactly inside the gate, and the plain transform everywhere
    else; the results are the plain transform's either way."""
    calls = []

    def fake_kernel(x, q, inverse=False):
        calls.append((tuple(x.shape), q, inverse))
        return ntt_cuda.ntt_plain(x, q, inverse=inverse)

    monkeypatch.setattr(_cuda, "on_cuda", lambda *t: True)
    monkeypatch.setattr(ntt_cuda, "ntt_kernel", fake_kernel)
    a = residues(21, q, (2, n))
    e = ntt.ntt(tt(a), q)
    same(ntt.intt(e, q), a)
    assert calls == ([((2, n), q, False), ((2, n), q, True)]
                     if ntt.k9_gate(q, n) else [])


def test_k9_range_on_the_card():
    """K9's wrapper takes n = 2^7 .. 2^26, the range of K1, whose body it
    runs (the shared dispatch's, TRANSFORM_LOGN: past 2^15 across
    blocks)."""
    assert _cuda.log2_degree(128, _cuda.NTT) == 7
    assert _cuda.log2_degree(1 << 15, _cuda.NTT) == 15
    assert _cuda.log2_degree(1 << 26, _cuda.NTT) == 26
    for n in (64, 1 << 27):
        with pytest.raises(ValueError, match="ntt takes n = 2\\^7 .. 2\\^26"):
            _cuda.log2_degree(n, _cuda.NTT)
    assert _cuda.NTT.logn == _cuda.NTT_MULTI.logn == _cuda.TRANSFORM_LOGN
    with pytest.raises(ValueError, match="ntt_multi takes n = 2\\^7"):
        _cuda.log2_degree(64, _cuda.NTT_MULTI)
    with pytest.raises(ValueError, match="CUDA"):
        ntt_cuda.ntt_kernel(torch.zeros(2, 128, dtype=torch.long), Q)
