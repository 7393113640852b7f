"""The port past ring degree 2^15, where one polynomial no longer fits a
block: K1 and K9 across blocks up to n = 2^26 and K10's grid layout up to
2^22 (csrc/ntt_chunks.cuh, csrc/blind_rotate_grid_cuda.cu), on the CPU.

  * the chunked schedule written out in torch — the top passes (2^K words a
    virtual thread, stage bits from log n - 1 down to log c, the roots
    below 2^s read at word root << log c of the chunk table), then each
    chunk's chain of c words (tests/test_torch_radix_plan.py::_emulate) on
    its row of the generalised table, and the inverse the other way with
    the final multiplier in its last top pass — equals the plain stage loop
    forward and inverse, at n = 2^10 with c = 2^7 (s = 3), at n = 2^16 and
    2^17 with the kernels' c = 2^15, and with c = n / 2 on the two-block
    split's own tables (``_split_index``);
  * the grid layout of K10 written out so (its top forward passes from the
    rotated accumulator, the chunk chains, the contraction in the chunk
    chains' first inverse pass, the top inverse passes, the last with n^-1,
    the CRT and the limb adds) equals ``blind_rotate_plain``;
  * the numpy root tables of ``NttPlan`` equal the Python loop's at
    2^7 .. 2^16 for every prime of CRT_PRIMES and CRT_PRIMES_TFHE;
  * against the JAX package at N = 2^16, bit for bit (its XLA path under
    ``jax.jit``): ``ntt`` / ``intt`` under CRT_PRIMES[:2] and the TFHE pair,
    ``ntt_multi`` / ``intt_multi`` over the pair, ``tn.mul_crt``,
    ``tggsw.precompute_evals`` on a 2-step key, and ``blind_rotation``
    (the fused entry, which runs ``blind_rotate_plain`` on the CPU) over 3
    steps at K = 1, beta = 2^6, l = 5, B = 2 — the reference's gate at
    2^16 with the widest top-bits gadget that decodes — against the
    reference's step-by-step chain.

Inputs are numpy draws from fixed seeds; tolerance 0 throughout.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_study_tpu.arith import tn as jtn
from fhe_study_tpu.arith.params import RingParam as JRingParam
from fhe_study_tpu.arith.params import TORUS_Q
from fhe_study_tpu.models.gfhe import glwe as JG
from fhe_study_tpu.models.tfhe import bootstrap as jboot
from fhe_study_tpu.models.tfhe import tggsw as jtggsw
from fhe_study_tpu.models.tfhe import tlwe as jtlwe
from fhe_study_tpu.ops import blind_rotate_pallas as brp
from fhe_study_tpu.ops import ntt as jntt

from fhe_study_tpu_torch.arith import tn
from fhe_study_tpu_torch.arith.params import RingParam
from fhe_study_tpu_torch.models.gfhe import glwe as G
from fhe_study_tpu_torch.models.tfhe import bootstrap, tggsw, tglwe, tlwe
from fhe_study_tpu_torch.ops import _cuda, ntt
from fhe_study_tpu_torch.ops import blind_rotate_cuda as brc
from fhe_study_tpu_torch.ops import ntt_cuda as nc
from fhe_study_tpu_torch.utils import interop, prng
from chunk_emulation import _chunked, _chunks, _table, _top_pass
from test_torch_blind_rotate_dm import _lift
from test_torch_blind_rotate_plan import _inputs

CPU = torch.device("cpu")
N = 1 << 16
P0, P1 = ntt.CRT_PRIMES_TFHE


# -- the chunked schedule, written out (tests/chunk_emulation.py) -------------

@pytest.mark.parametrize("logn,logc", [(10, 7), (16, 15), (17, 15),
                                       (9, 8)])
def test_chunked_schedule_equals_the_stage_loop(logn, logc):
    n = 1 << logn
    rng = np.random.default_rng(100 + logn)
    for q in (P0, ntt.CRT_PRIMES[0]):
        x = torch.from_numpy(rng.integers(0, q, n))
        fin = int(rng.integers(1, q))
        want = nc.ntt_multi_plain(x[None], (q,), fin=(fin,)).long()[0]
        assert torch.equal(_chunked(x, q, logn, logc, False, fin), want)
        assert torch.equal(_chunked(x, q, logn, logc, False),
                           ntt._stage_loop(x, q, False))
        want = nc.ntt_multi_plain(x[None], (q,), inverse=True,
                                  fin=(fin,)).long()[0]
        assert torch.equal(_chunked(x, q, logn, logc, True, fin), want)
        assert torch.equal(
            _chunked(x, q, logn, logc, True, pow(n, -1, q)),
            ntt._stage_loop(x, q, True))


def _split_index_of_two_halves(n: int) -> np.ndarray:
    """The two-block split's tables as they were written before the chunk
    index (row r at word m + i: root (2 + r) m + i; word 0 root 1)."""
    h = n // 2
    idx = np.ones((2, h), np.int64)
    m = 1
    while m < h:
        for r in (0, 1):
            idx[r, m:2 * m] = (2 + r) * m + np.arange(m)
        m *= 2
    return idx


def test_chunk_index_generalises_the_split():
    """At s = 1 the chunk index is the split's, word for word; at any s each
    root index 2^s .. n - 1 lies in exactly one chunk word past word 0, and
    word 0 of row r >= 1 holds root r, where the top passes read it."""
    for logn in range(8, 17):
        n = 1 << logn
        assert np.array_equal(nc._chunk_index(n, n // 2),
                              _split_index_of_two_halves(n))
        assert np.array_equal(nc._split_index(n), nc._chunk_index(n, n // 2))
    for logn, logc in ((10, 7), (17, 15), (12, 8)):
        n, c = 1 << logn, 1 << logc
        idx = nc._chunk_index(n, c)
        s = logn - logc
        assert idx.shape == (1 << s, c)
        assert sorted(idx[:, 1:].ravel().tolist()) == list(range(1 << s, n))
        assert idx[1:, 0].tolist() == list(range(1, 1 << s))
    qs = ntt.CRT_PRIMES_TFHE
    tw = nc._chunk_twiddles(qs, 1 << 10, 1 << 7, True, CPU)
    full = nc._twiddles(qs, 1 << 10, True, CPU)
    assert tw.shape == (2, 2, 8, 128)
    assert torch.equal(tw, full[:, :, torch.from_numpy(
        nc._chunk_index(1 << 10, 1 << 7))])
    assert nc._chunk_tables(qs, 1 << 15, True, CPU) is nc._twiddles(
        qs, 1 << 15, True, CPU)
    assert nc._chunk_tables(qs, 1 << 16, True, CPU).shape == (2, 2, 2, 1 << 15)


@pytest.mark.parametrize("logn", range(16, 27))
def test_chunk_plan_runs_every_top_stage_once(logn):
    """The top passes run bits log n - 1 .. 15 in order, at most 4 a pass
    (one pass to 2^19, two to 2^23, three to 2^26), each of whole blocks of
    256 virtual threads; a chunk's chain is the one-buffer plan at 2^15."""
    plan = nc._chunk_plan(logn)
    bits = [lo + u for lo, K in plan.top for u in range(K - 1, -1, -1)]
    assert bits == list(range(logn - 1, nc.CHUNK_LOGN - 1, -1))
    assert all(1 <= K <= nc.TOP_BITS for _, K in plan.top)
    assert len(plan.top) == -(-(logn - 15) // 4)
    assert plan.chunks == 1 << (logn - 15)
    assert plan.chain == nc._radix_plan(15)
    assert nc._transform_plan(logn) == (nc.WIDE_THREADS, 4 << 15)
    for _, K in plan.top:
        assert (1 << (logn - K)) % nc.TOP_THREADS == 0
    with pytest.raises(ValueError, match="a block holds"):
        nc._chunk_plan(15)


# -- K10's grid layout, written out -------------------------------------------

def _grid_layout(shifts, acc0, ev1, ev2, n: int, w: int, logc: int):
    """The grid layout's step, unit by unit: the forward's top passes of
    each digit polynomial (the first from the rotated accumulator), its
    chunk chains, the contraction in each column chunk's first inverse pass
    and the chain, the top inverse passes, the last one per component with
    both limb columns under both primes, n^-1, the CRT lift and the limb
    adds."""
    steps, B = shifts.shape
    C, l = acc0.shape[1], ev1.shape[2]
    F, cols = C * l, 2 * C
    logn = n.bit_length() - 1
    c = 1 << logc
    plan = nc._chunk_plan(logn, logc)
    fwd = [_table(q, n, logc, False) for q in (P0, P1)]
    inv = [_table(q, n, logc, True) for q in (P0, P1)]
    acc = acc0.clone()
    ev = torch.stack([ev1, ev2]).long()
    for j in range(steps):
        dig = torch.empty((B, 2, F, n), dtype=torch.int64)
        col = torch.empty((B, 2, cols, n), dtype=torch.int64)
        for b in range(B):
            h = int(shifts[j, b]) % (2 * n)
            for p, q in enumerate((P0, P1)):
                for f in range(F):
                    cc, i = divmod(f, l)
                    row = acc[b, cc]

                    def digits(addr, row=row, h=h, i=i):
                        src = addr + h
                        r = row[src % n]
                        r = torch.where((src // n) % 2 == 1, -r, r)
                        return tn.shr(r - row[addr], 64 - w * (i + 1)) & \
                            ((1 << w) - 1)

                    x = None
                    for t, (lo, K) in enumerate(plan.top):
                        x = _top_pass(x, q, logn, lo, K, fwd[p], logc, False,
                                      first=digits if t == 0 else None)
                    dig[b, p, f] = _chunks(x, q, logc, False, fwd[p])
                for o in range(cols):
                    key = ev[p, j].reshape(F, cols, n)[:, o]

                    def contract(r, addr, rows=dig[b, p], key=key, q=q):
                        at = r * c + addr
                        return (rows[:, at] * key[:, at] % q).sum(0) % q

                    y = _chunks(None, q, logc, True, inv[p], first=contract)
                    for lo, K in reversed(plan.top[1:]):
                        y = _top_pass(y, q, logn, lo, K, inv[p], logc, True)
                    col[b, p, o] = y
            lo, K = plan.top[0]
            for cc in range(C):
                total = torch.zeros(n, dtype=torch.int64)
                for limb in (0, 1):
                    r0, r1 = (_top_pass(col[b, p, 2 * cc + limb], q, logn,
                                        lo, K, inv[p], logc, True,
                                        pow(n, -1, q))
                              for p, q in enumerate((P0, P1)))
                    total = total + _lift(r0, r1) * (1 << (32 * limb))
                acc[b, cc] = acc[b, cc] + total
    return acc


@pytest.mark.parametrize("logn,logc,C,l,w", [(9, 7, 2, 2, 12),
                                           (9, 8, 3, 1, 20)])
def test_grid_layout_schedule_equals_plain(logn, logc, C, l, w):
    n = 1 << logn
    rng = np.random.default_rng(3000 * logn + 10 * C + l)
    shifts, acc0, ev1, ev1s, ev2, ev2s = _inputs(rng, 2, 2, C, l, n)
    want = brc.blind_rotate_plain(shifts, acc0, ev1, ev1s, ev2, ev2s, n, w)
    assert torch.equal(_grid_layout(shifts, acc0, ev1, ev2, n, w, logc),
                       want)


def test_grid_plan_at_n_2_16():
    """Past 2^15 the grid layout at the chunk's block shape (at 2^16 where
    the caller names it, the plan's rule being the split there): per step
    and ciphertext the forward's top pass over the 2F digit polynomials, 2F
    2^s chunk blocks forward, 2 2C 2^s inverse, the last top pass over the
    C components; a scratch of the digit evaluations and of the words
    between passes."""
    assert brc._plan(2, 5, N).layout == "split"
    plan = brc._plan(2, 5, N, layout="grid")
    assert plan.layout == "grid" and not plan.staged and plan.cluster == 1
    assert (plan.threads, plan.smem_bytes) == (nc.WIDE_THREADS, 4 << 15)
    assert plan.blocks == (2 * 10 * N // 512, 2 * 10 * 2, 2 * 4 * 2,
                           2 * N // 512)
    assert plan.scratch_bytes == 2 * 4 * N * (10 + 10)
    assert brc._plan(2, 1, 1 << 20).scratch_bytes == \
        2 * 4 * (1 << 20) * (2 + 4)
    assert len(brc._plan(2, 1, 1 << 20).blocks) == 2 + 2 + 1 + 1
    with pytest.raises(ValueError, match="layout"):
        brc._plan(2, 5, N, layout="device")


# -- the root tables ---------------------------------------------------------

def _loop_tables(q: int, n: int):
    """NttPlan's tables as the loop over n built them."""
    w = ntt._primitive_root_of_unity(q, 2 * n)
    w_inv = pow(w, q - 2, q)
    pw, pw_inv = [1] * n, [1] * n
    for k in range(1, n):
        pw[k] = pw[k - 1] * w % q
        pw_inv[k] = pw_inv[k - 1] * w_inv % q
    rev = ntt._bit_reverse_perm(n.bit_length() - 1)
    return np.array(pw, np.uint64)[rev], np.array(pw_inv, np.uint64)[rev]


@pytest.mark.parametrize("q", ntt.CRT_PRIMES + ntt.CRT_PRIMES_TFHE)
def test_vectorised_plan_equals_the_loop(q):
    for logn in range(7, 17):
        n = 1 << logn
        plan = ntt.NttPlan(q, n)
        roots, roots_inv = _loop_tables(q, n)
        assert plan.roots.dtype == np.uint64
        assert np.array_equal(plan.roots, roots), (q, n)
        assert np.array_equal(plan.roots_inv, roots_inv), (q, n)
    # the object-array path of a modulus past 2^32 (Python-integer products)
    wide = 1099511922689
    assert np.array_equal(ntt.NttPlan(wide, 1 << 10).roots,
                          _loop_tables(wide, 1 << 10)[0])


# -- against the JAX package at N = 2^16 --------------------------------------

# XLA's backend optimisation off for the references whose optimised
# compile outlasts their run (integer programs: exact at any level)
JAX_FAST = {"xla_backend_optimization_level": 0}


def _jitted(f, *args):
    """f(*args) under ``jax.jit``, compiled with JAX_FAST."""
    return jax.jit(f).lower(*args).compile(JAX_FAST)(*args)


def _u64(seed, shape, q):
    return np.random.default_rng(seed).integers(0, q, shape).astype(np.uint64)


def _same(got, want):
    np.testing.assert_array_equal(interop.bits_to_numpy(got),
                                  np.asarray(want).astype(np.uint64))


NTT_QS = ntt.CRT_PRIMES[:2] + ntt.CRT_PRIMES_TFHE


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's transforms under each prime of NTT_QS (both
    ways), ``ntt_multi`` / ``intt_multi`` over the TFHE pair and
    ``tn.mul_crt``, on the operands of the tests below, under one
    ``jax.jit``: one compile for the module (``_jitted``)."""
    pq = ntt.CRT_PRIMES_TFHE
    xs = [_u64(q % 1000, (1, N), q) for q in NTT_QS]
    xm = np.stack([_u64(7 + i, (1, N), p) for i, p in enumerate(pq)]
                  ).astype(np.uint32)
    rng = np.random.default_rng(16)
    a, b = (rng.integers(0, 1 << 64, (1, N), dtype=np.uint64)
            for _ in range(2))

    def refs(xs, xm, a, b):
        return ([(jntt.ntt(x, q), jntt.intt(x, q))
                 for x, q in zip(xs, NTT_QS)],
                (jntt.ntt_multi(xm, pq), jntt.intt_multi(xm, pq)),
                jtn.mul_crt(a, b))

    want = _jitted(refs, [jnp.asarray(x) for x in xs], jnp.asarray(xm),
                   jnp.asarray(a), jnp.asarray(b))
    return (xs, xm, a, b), want


@pytest.mark.parametrize("i", range(len(NTT_QS)))
def test_ntt_and_intt_match_jax(i, jax_refs):
    (xs, _, _, _), want = jax_refs
    q = NTT_QS[i]
    t = torch.from_numpy(xs[i].astype(np.int64))
    _same(ntt.ntt(t, q), want[0][i][0])
    _same(ntt.intt(t, q), want[0][i][1])


def test_ntt_multi_matches_jax(jax_refs):
    (_, xm, _, _), want = jax_refs
    pq = ntt.CRT_PRIMES_TFHE
    t = torch.from_numpy(xm.astype(np.int64)).int()
    for got, w in zip((ntt.ntt_multi(t, pq), ntt.intt_multi(t, pq)),
                      want[1]):
        np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                      np.asarray(w))


def test_mul_crt_matches_jax(jax_refs):
    (_, _, a, b), want = jax_refs
    got = tn.mul_crt(interop.bits_to_tensor(a, CPU),
                     interop.bits_to_tensor(b, CPU))
    _same(got, want[2])


# the reference's gate at N = 2^16 with the widest top-bits gadget that
# decodes: (K + 1) l N beta = 2 * 5 * 2^16 * 2^6 < 2^26, w l = 30
K, T, BETA, L, STEPS, B = 1, 64, 1 << 6, 5, 3, 2


@pytest.fixture(scope="module")
def short_key():
    """A short bootstrapping key of STEPS steps and its evaluations, from
    a secret key drawn as ``tglwe.new_key`` draws it (its public key, which
    nothing here reads, left out)."""
    P = G.Param(G.ERR_SIGMA, RingParam(TORUS_Q, N), K, T)
    gen = prng.Gen(20)
    s_flat, _ = tlwe.new_key(gen, P.lwe(), CPU)
    s = tglwe.sk_to_tglwe(s_flat, K, N)
    sbtk = bootstrap.new_short_bootstrapping_key(
        gen, P, s, n_lwe=STEPS, beta=BETA, l=L, beta_ks=16, l_ks=8)
    return P, sbtk, bootstrap.precompute_short_btk_evals(P, sbtk)


def _jx(t):
    return jnp.asarray(interop.bits_to_numpy(t))


def test_precompute_evals_matches_jax(short_key):
    """On the first 2 steps' keys (the port's evaluations of the 3-step
    key, cut to them); and the port's on the 2-step key in slices of one
    step (the slicing that keeps the card's temporaries small) equal to
    them."""
    P, sbtk, evals = short_key
    g = tggsw.TGGSW(a=sbtk.btk_a[:2], b=sbtk.btk_b[:2])
    JP = JG.Param(JG.ERR_SIGMA, JRingParam(TORUS_Q, N), K, T)
    want = _jitted(lambda a, b: jtggsw.precompute_evals(
        JP, jtggsw.TGGSW(a=a, b=b)), _jx(g.a), _jx(g.b))
    got = tggsw.TGGSWEvals(*(e[:2] for e in evals))
    for f in got._fields:
        np.testing.assert_array_equal(
            getattr(got, f).numpy().astype(np.uint32),
            np.asarray(getattr(want, f)))
    per_key = g.a[:1].numel() + g.b[:1].numel()
    old = tggsw.EVALS_SLICE_WORDS
    try:
        tggsw.EVALS_SLICE_WORDS = per_key
        sliced = tggsw.precompute_evals(P, g)
    finally:
        tggsw.EVALS_SLICE_WORDS = old
    assert all(torch.equal(x, y) for x, y in zip(sliced, got))


def test_blind_rotation_at_n_2_16_matches_the_jax_chain(short_key):
    """The gate at 2^16 admits the shape in both packages; on the card it
    takes the split layout.  The fused entry (blind_rotate_plain on the CPU)
    equals the port's step-by-step chain (launching nothing here) and the
    JAX package's, jitted."""
    P, sbtk, evals = short_key
    JP = JG.Param(JG.ERR_SIGMA, JRingParam(TORUS_Q, N), K, T)
    assert brc.supported(P, BETA, L) and brp.supported(JP, BETA, L)
    assert brc._plan(K + 1, L, N).layout == "split"
    param = SimpleNamespace(ring=SimpleNamespace(n=N), k=K)
    assert brc.supported(param, BETA, L)
    rng = np.random.default_rng(21)
    i64 = np.iinfo(np.int64)
    a, b = (torch.from_numpy(rng.integers(i64.min, i64.max, shape,
                                          dtype=np.int64))
            for shape in ((B, STEPS), (B,)))
    table = bootstrap.compute_lookup_table_standard(P, CPU)
    got = bootstrap.blind_rotation(P, sbtk, table, tlwe.TLWE(a, b), BETA, L,
                                   btk_evals=evals)
    before = _cuda.launches()
    step = bootstrap.blind_rotation(P, sbtk, table, tlwe.TLWE(a, b), BETA, L,
                                    btk_evals=evals, fused=False)
    assert torch.equal(got.a, step.a) and torch.equal(got.b, step.b)
    assert _cuda.launches() == before
    jkey = jboot.ShortBootstrappingKey(*(_jx(t) for t in sbtk))
    jev = jtggsw.TGGSWEvals(**{f: _jx(getattr(evals, f))
                               for f in evals._fields})
    want = jax.jit(lambda k, t, c, e: jboot.blind_rotation(
        JP, k, t, c, beta=BETA, l=L, btk_evals=e, fused=False))(
            jkey, jboot.compute_lookup_table_standard(JP),
            jtlwe.TLWE(_jx(a), _jx(b)), jev)
    _same(got.a, want.a)
    _same(got.b, want.b)
