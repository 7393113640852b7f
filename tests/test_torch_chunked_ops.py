"""K2 tensor_eval4, K3 ks_contract, K5 ext_ntt and K12 ntt_smem_ceiling past
one block's polynomial (n = 2^16 .. 2^26 on the card: the chunked schedule
of csrc/ntt_chunks.cuh, each kernel's own step folded into its first pass),
on the CPU.

  * each kernel's chunked schedule written out in torch
    (tests/chunk_emulation.py) — K2's products and K3's R-term
    contraction formed in the chunk chains' first inverse pass from the
    operands' words at the kernels' addresses (strided operand rows, rows
    one word off), then the inverse top passes with the final multiplier
    in the last; K5's extension formed in the first forward top pass, from
    the source rows (its direct form) or from the lift's rows (its staged
    form), then the other top passes and the chunk chains; K12's ``reps``
    chunked forwards one after another — equals the plain version bit for
    bit at (n, c) = (2^10, 2^7) and (2^16, 2^15);
  * each wrapper at n = 2^16 makes one C call with the chunk tables, the
    chunk's block shape and its scratch, counted under its "chunked" layout
    (the C call recorded instead of made, tests/test_torch_lift.py's fake
    card);
  * against the JAX package at n = 2^16, B = 1 (its XLA path under one
    ``jax.jit``), over two 30-bit primes with 2^17-th roots: the port's
    ``tensor_eval4``, ``ks_contract_multi`` and ``ext_ntt``.

Inputs are numpy draws from fixed seeds; tolerance 0 throughout.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_study_tpu.ops import ntt as jntt

from fhe_study_tpu_torch.ops import _cuda, alu_bench, ext_cuda, ntt
from fhe_study_tpu_torch.ops import ntt_cuda as nc
from fhe_study_tpu_torch.ops.primes import ntt_primes
from chunk_emulation import _chunked
from test_torch_lift import _fake_card
from test_torch_radix_plan import _mont

N = 1 << 16
QS = ntt_primes(2, 30, 1 << 17)               # 2^17-th roots: n = 2^16
SRC = ntt_primes(4, 30, 1 << 16, skip=8)      # any primes apart from QS
# (log n, log c) of the emulations: three top passes at c = 2^7, and the
# kernels' own chunk of 2^15 words
SHAPES = ((10, 7), (16, 15))


def _primes(logn: int) -> tuple:
    return ntt_primes(2, 30, 2 << logn)


def _storage(rng, q: int, shape, offset: int):
    """Residues mod q of ``shape`` in a flat int64 buffer that starts
    ``offset`` words in (a row one word off the 16-byte alignment), and the
    view of them."""
    buf = torch.from_numpy(rng.integers(0, q, offset + int(np.prod(shape))))
    return buf, buf[offset:].view(shape)


@pytest.mark.parametrize("logn,logc", SHAPES)
def test_k2_chunked_schedule_equals_plain(logn, logc):
    """Operands of two polynomials as strided rows of stacked pairs, one
    word off: the block of (product k, polynomial b) reads x0 .. y1 at
    their row starts plus the chunk's words, forms k's product there, runs
    the chain; the top passes, the last times n^-1 2^32 scale."""
    n, B = 1 << logn, 2
    q = _primes(logn)[0]
    rng = np.random.default_rng(10 + logn)
    scale = int(rng.integers(1, q))
    fin = nc._tensor_fin((q,), n, (scale,))[0]
    # x0, x1 the two halves of a [B, 2, n] pair; y1, y0 those of another
    bufs = [_storage(rng, q, (B, 2, n), 1) for _ in range(2)]
    views = [bufs[0][1][:, 0], bufs[0][1][:, 1], bufs[1][1][:, 1],
             bufs[1][1][:, 0]]
    rows = [(bufs[0][0], 1), (bufs[0][0], 1 + n), (bufs[1][0], 1 + n),
            (bufs[1][0], 1)]                     # (buffer, row start)
    want = nc.tensor_eval4_plain(*(v[None].int() for v in views), (q,),
                                 scale=(scale,))[0]
    for b in range(B):
        def word(o, at, b=b):
            buf, start = rows[o]
            return buf[start + b * 2 * n + at]

        for k in range(3):
            def first(r, addr, k=k):
                at = r * (1 << logc) + addr
                if k == 1:
                    return (_mont(word(0, at), word(3, at), q)
                            + _mont(word(1, at), word(2, at), q)) % q
                return _mont(word(k // 2, at), word(2 + k // 2, at), q)

            got = _chunked(None, q, logn, logc, True, fin, first=first)
            assert torch.equal(got, want[b, k].long())


@pytest.mark.parametrize("logn,logc", SHAPES)
def test_k3_chunked_schedule_equals_plain(logn, logc):
    """R = 1 and 3 digit rows over two primes, two polynomials, the digit
    rows one word off: the block of (prime, polynomial, half) sums the R
    Montgomery products of its digit and key chunks in the first pass."""
    n, B = 1 << logn, 2
    qs = _primes(logn)
    rng = np.random.default_rng(20 + logn)
    for R in (1, 3):
        edm = torch.stack([torch.stack([torch.from_numpy(
            rng.integers(0, q, (B, n))) for q in qs]) for _ in range(R)])
        buf = torch.cat([torch.zeros(1, dtype=torch.int64), edm.reshape(-1)])
        keys = [torch.stack([torch.stack([torch.from_numpy(
            rng.integers(0, q, n)) for q in qs]) for _ in range(R)])
            for _ in range(2)]
        want = nc.ks_contract_plain(edm.int(), keys[0].int(), keys[1].int(),
                                    qs)
        for h in (0, 1):
            for p, q in enumerate(qs):
                for b in range(B):
                    def first(r, addr, p=p, q=q, b=b, h=h):
                        at = r * (1 << logc) + addr
                        acc = torch.zeros_like(addr)
                        for i in range(R):
                            row = 1 + ((i * len(qs) + p) * B + b) * n
                            acc = (acc + _mont(buf[row + at],
                                               keys[h][i, p, at], q)) % q
                        return acc

                    got = _chunked(None, q, logn, logc, True,
                                   pow(n, -1, q), first=first)
                    assert torch.equal(got, want[h][p, b].long())


@pytest.mark.parametrize("logn,logc", SHAPES)
def test_k5_chunked_schedule_equals_plain(logn, logc):
    """From 2 and 4 source primes (the direct form: each word converted
    from the source rows at its address) and from 3 (the staged form: from
    the lift's rows), two polynomials, to two destination primes."""
    n, B = 1 << logn, 2
    dst = _primes(logn)
    rng = np.random.default_rng(30 + logn)
    for ls in (2, 4, 3):
        src = SRC[:ls]
        x = torch.stack([torch.from_numpy(rng.integers(0, s, (B, n)))
                         for s in src]).int()
        want = nc.ext_ntt_plain(x, src, dst)
        ys, alpha = ext_cuda.lift_plain(x, src)
        for p, q in enumerate(dst):
            for b in range(B):
                if ls in nc.EXT_NTT_DIRECT:
                    def first(el, b=b, q=q):
                        return ext_cuda.base_extend_fused_plain(
                            x[:, b, el.reshape(-1)], src, (q,))[0].long(
                            ).reshape(el.shape)
                else:
                    def first(el, b=b, q=q):
                        return ext_cuda.base_extend_sum_plain(
                            ys[:, b, el.reshape(-1)],
                            alpha[b, el.reshape(-1)], src, (q,))[0].long(
                            ).reshape(el.shape)
                got = _chunked(None, q, logn, logc, False, first=first)
                assert torch.equal(got, want[p, b].long())


@pytest.mark.parametrize("logn,logc", SHAPES)
def test_k12_chunked_reps_equal_plain(logn, logc):
    """``reps`` chunked forwards, each from the last one's output."""
    n = 1 << logn
    q = _primes(logn)[1]
    x = torch.from_numpy(np.random.default_rng(40 + logn).integers(0, q, n))
    for reps in (0, 1, 3):
        got = x
        for _ in range(reps):
            got = _chunked(got, q, logn, logc, False)
        want = alu_bench.ntt_smem_ceiling_plain(x[None].int(), q, reps)[0]
        assert torch.equal(got, want.long())


def test_wrappers_queue_the_chunked_schedule_at_n_2_16():
    """On CPU tensors up to the C call (recorded, not made): one call of
    each wrapper with its argument list, the chunk tables [L, 2, 2^15] of
    its direction, the chunk's block shape (512 threads, 128 KB), K5's and
    K12's 32-bit scratch (K5's lift too from 3 sources), and one launch
    under the layout past one block (K12's named: its rule at 2^16 is the
    split)."""
    kernels = (_cuda.TENSOR_EVAL4, _cuda.KS_CONTRACT, _cuda.EXT_NTT,
               _cuda.NTT_SMEM_CEILING)
    B, qs = 3, QS
    ops = [torch.zeros((2, B, N), dtype=torch.int32) for _ in range(4)]
    edm = torch.zeros((1, 2, B, N), dtype=torch.int32)
    key = torch.zeros((1, 2, N), dtype=torch.int32)
    calls = {}
    _cuda.reset_launches()
    with _fake_card(calls, kernels):
        nc.tensor_eval4_kernel(*ops, qs, scale=(3, 5))
        nc.ks_contract_kernel(edm, key, key, qs)
        for ls in (2, 3):
            nc.ext_ntt_kernel(torch.zeros((ls, B, N), dtype=torch.int32),
                              SRC[:ls], qs)
        alu_bench.ntt_smem_ceiling_kernel(ops[0][0], qs[0], 2, "chunked")
    shape = (nc.WIDE_THREADS, 4 << nc.CHUNK_LOGN)
    for k in kernels:
        for args in calls[k.name]:
            assert len(args) == len(k.argtypes)          # the stream last
            # K12's split flag follows its shape
            at = -4 if k is _cuda.NTT_SMEM_CEILING else -3
            assert tuple(args[at:at + 2]) == shape
        assert _cuda.chunked_launches(k) == k.launches == len(calls[k.name])
    assert _cuda.EXT_NTT.by_layout == {"direct": 0, "staged": 0,
                                       "chunked direct": 1,
                                       "chunked staged": 1}
    inv = nc._chunk_twiddles(qs, N, 1 << 15, True, torch.device("cpu"))
    fwd = nc._chunk_twiddles(qs, N, 1 << 15, False, torch.device("cpu"))
    assert inv.shape == (2, 2, 2, 1 << 15)
    (k2,), (k3,) = calls["tensor_eval4"], calls["ks_contract"]
    assert (k2[13], k2[14]) == (inv[0].data_ptr(), inv[1].data_ptr())
    assert (k3[4], k3[5]) == (inv[0].data_ptr(), inv[1].data_ptr())
    direct, staged = calls["ext_ntt"]
    assert direct[1] is None and staged[1] is not None   # the lift
    assert direct[2] is not None and staged[2] is not None   # the scratch
    assert (direct[5], direct[6]) == (fwd[0].data_ptr(), fwd[1].data_ptr())
    (k12,) = calls["ntt_smem_ceiling"]
    assert k12[2] is not None and k12[6:10] == (qs[0], B, 16, 2)
    assert k12[-2] == 0
    _cuda.reset_launches()


def _res(seed, primes, shape):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, p, shape) for p in primes]
                    ).astype(np.uint32)


@pytest.fixture(scope="module")
def jax_refs():
    """The three JAX functions at n = 2^16 on the operands below, under one
    ``jax.jit``."""
    ops = [_res(10 + i, QS, (1, N)) for i in range(4)]
    edm = _res(20, QS, (1, N))[None]                 # [R=1, Lp, B, n]
    kb, ka = (_res(21 + i, QS, (N,))[None] for i in range(2))
    x = _res(30, SRC[:2], (1, 2, N))
    sc = (256, 256)

    def refs(ops, edm, kb, ka, x):
        return (jntt.tensor_eval4(*ops, QS, scale=sc),
                jntt.ks_contract_multi(edm, kb, ka, QS),
                jntt.ext_ntt(x, SRC[:2], QS))

    want = jax.jit(refs)([jnp.asarray(o) for o in ops], jnp.asarray(edm),
                         jnp.asarray(kb), jnp.asarray(ka), jnp.asarray(x))
    return (ops, edm, kb, ka, x, sc), want


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = tuple(want) if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))


def _tt(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def test_tensor_eval4_matches_jax(jax_refs):
    (ops, _, _, _, _, sc), want = jax_refs
    _same(ntt.tensor_eval4(*(_tt(o) for o in ops), QS, scale=sc), want[0])


def test_ks_contract_matches_jax(jax_refs):
    (_, edm, kb, ka, _, _), want = jax_refs
    _same(ntt.ks_contract_multi(_tt(edm), _tt(kb), _tt(ka), QS), want[1])


def test_ext_ntt_matches_jax(jax_refs):
    (_, _, _, _, x, _), want = jax_refs
    _same(ntt.ext_ntt(_tt(x), SRC[:2], QS), want[2])
