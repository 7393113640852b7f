"""The transform kernels of the main path — ``csrc/ntt_cuda.cu``, with K1
and K9, K3, K5, K6, K7 and K8 in ``csrc/ntt_multi_cuda.cu``,
``ks_contract_cuda.cu``, ``ext_ntt_cuda.cu``, ``tensor_mul4_cuda.cu``,
``ks_fused_cuda.cu`` and ``ks_fused_eval_cuda.cu`` — with their host tables,
launch wrappers and plain PyTorch versions; the counterpart of
fhe_study_tpu/ops/ntt_pallas.py.

  K1 ntt_multi     <- ntt_pallas.ntt_multi_u32
  K2 tensor_eval4  <- ntt_pallas.tensor_eval4_u32
  K3 ks_contract   <- ntt_pallas.ks_contract_u32
  K5 ext_ntt       <- ntt_pallas.ext_ntt_u32
  K6 tensor_mul4   <- ntt_pallas.tensor_mul4_u32
     tensor_mul    <- ntt_pallas.tensor_mul_u32 (K6's kernel on row strides)
  K7 ks_fused      <- ntt_pallas.ks_fused_u32
  K8 ks_fused_eval <- ntt_pallas.ks_fused_eval_u32
  K9 ntt           <- ntt_pallas.ntt_u32 (one prime, int64 words in and out)

Past n = 2^15 each runs the chunked schedule of ``csrc/ntt_chunks.cuh``
from a unit of its own (``*_chunks_cuda.cu``, ``forward_chunks_cuda.cu``).

Host tables per prime set: the [L, n] bit-reversed roots (forward) or
inverse roots with their Shoup companions floor(w * 2^32 / q), and one row of
(q, -q^-1 mod 2^32, fin, fin's Shoup companion) per prime, where ``fin`` is
the final multiplier folded into the kernel's last pass.

ops/ntt.py dispatches to them by device.  The plain versions compute
exactly in int64 with the reshape stage loop of the reference's XLA path;
they run the CPU tests and, on the card, only the comparisons of
chip_smoke.py and the card-marked tests.
"""

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from . import _cuda, ext_cuda
from . import ntt as ntt_mod
from .modops32 import qvec

R32 = 1 << 32


# -- host tables ----------------------------------------------------------

@lru_cache(maxsize=None)
def _twiddles_host(qs: tuple, n: int, inverse: bool) -> np.ndarray:
    """[2, L, n] uint32: roots (or inverse roots) and Shoup companions."""
    w = np.stack([ntt_mod.get_plan(q, n).roots_inv if inverse
                  else ntt_mod.get_plan(q, n).roots for q in qs])
    sh = (w << np.uint64(32)) // np.array(qs, np.uint64)[:, None]
    return np.stack([w, sh]).astype(np.uint32)


@lru_cache(maxsize=None)
def _prime_rows_host(qs: tuple, fin: tuple | None) -> np.ndarray:
    rows = []
    for i, q in enumerate(qs):
        f = 0 if fin is None else int(fin[i]) % q
        rows.append((q, (-pow(q, -1, R32)) % R32, f, (f << 32) // q))
    return np.array(rows, np.uint64).astype(np.uint32)


def _u32_tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


@lru_cache(maxsize=None)
def _twiddles(qs: tuple, n: int, inverse: bool, device) -> torch.Tensor:
    return _u32_tensor(_twiddles_host(qs, n, inverse), device)


@lru_cache(maxsize=None)
def _chunk_index(n: int, c: int) -> np.ndarray:
    """[n/c, c]: the root-table index that row r of a chunk table holds at
    each word (csrc/ntt_chunks.cuh; the two-block split of
    csrc/radix_chain.cuh at c = n/2).  Chunk r of the 2^s = n/c holds the
    elements r c + i and runs the chain of c words; its stage of m groups
    takes root (2^s + r) m + (i >> (j + 1)) of the global stage of 2^s m
    groups, which the row puts at m + (i >> (j + 1)), where the chain of c
    words reads it.  Word 0 of row r >= 1 holds root r, which the top
    stages read there (row 0's, unread, root 1: at s = 1 both rows hold
    the top stage's root 1 at word 0, as the split's tables always have)."""
    chunks = n // c
    r = np.arange(chunks, dtype=np.int64)[:, None]
    idx = np.empty((chunks, c), np.int64)
    idx[:, 0] = np.maximum(r[:, 0], 1)
    m = 1
    while m < c:
        idx[:, m:2 * m] = (chunks + r) * m + np.arange(m)
        m *= 2
    return idx


def _split_index(n: int) -> np.ndarray:
    """[2, n/2]: the tables of K6-K8's two-block split at n = 2^15
    (csrc/radix_chain.cuh's Split): the chunk index of two halves."""
    return _chunk_index(n, n // 2)


@lru_cache(maxsize=None)
def _chunk_twiddles(qs: tuple, n: int, c: int, inverse: bool,
                    device) -> torch.Tensor:
    """[2, L, n/c, c]: the root (or inverse root) tables and their Shoup
    companions rearranged for the chunks of c words, row (prime, r)."""
    host = _twiddles_host(qs, n, inverse)[:, :, _chunk_index(n, c)]
    return _u32_tensor(host, device)


def _split_twiddles(qs: tuple, n: int, inverse: bool,
                    device) -> torch.Tensor:
    """[2, L, 2, n/2]: the chunk tables of the two blocks of a split."""
    return _chunk_twiddles(qs, n, n // 2, inverse, device)


def _chain_twiddles(qs: tuple, n: int, inverse: bool, device) -> torch.Tensor:
    """The tables a three-buffer kernel (K6, K7, K8) reads at n: split at
    n = 2^WIDE_LOGN, the chunk tables past it (``_chunk_tables``), as they
    are below."""
    if n == 1 << WIDE_LOGN:
        return _split_twiddles(qs, n, inverse, device)
    return _chunk_tables(qs, n, inverse, device)


@lru_cache(maxsize=None)
def _prime_rows(qs: tuple, fin: tuple | None, device) -> torch.Tensor:
    return _u32_tensor(_prime_rows_host(qs, fin), device)


@lru_cache(maxsize=None)
def _roots_plain(qs: tuple, n: int, inverse: bool, device) -> torch.Tensor:
    return torch.from_numpy(
        _twiddles_host(qs, n, inverse)[0].astype(np.int64)).to(device)


def _default_fin(qs: tuple, n: int, inverse: bool, fin):
    """An inverse transform without an explicit fin multiplies by n^-1."""
    if fin is None and inverse:
        return tuple(pow(n, -1, q) for q in qs)
    return None if fin is None else tuple(int(f) % q for f, q in zip(fin, qs))


def _tensor_fin(dst: tuple, n: int, scale: tuple | None) -> tuple:
    """n^-1 * 2^32 * scale: the kernel's products are Montgomery products
    (a factor 2^-32 each), so 2^32 comes back with the scale."""
    return tuple(pow(n, -1, q) * (R32 % q) % q
                 * (1 if scale is None else int(scale[j])) % q
                 for j, q in enumerate(dst))


# -- the register-resident chains of K1-K3, K5-K9 and K12 -------------------

RADIX_BITS = 4          # kRadixBits of csrc/radix_chain.cuh: 16 words a thread
RADIX_THREADS = 256     # kRadixThreads: the most threads a block runs ...
WIDE_LOGN = 15          # ... below n = 2^kWideLogN; there the one-buffer
WIDE_THREADS = 512      # kernels run kWideThreads (OneBuffer)
MUL4_THREADS = 512      # kMul4Threads of csrc/tensor_mul4.cuh (K6) and
                        # kKsThreads of csrc/ks_fused.cuh (K7, K8) ...
MUL4_BUFFERS = 3        # ... which hold three polynomials in shared memory
                        # (at n = 2^WIDE_LOGN one half in each block of a
                        # two-block cluster)
# the degrees at which one block (K6-K8: a two-block cluster) holds a
# polynomial, where every chain kernel runs its one-block schedule; past
# them the chunked one (_chunk_plan)
BLOCK_LOGNS = range(7, WIDE_LOGN + 1)


class RadixPass(NamedTuple):
    c: int              # the pass holds bits [c, c + RADIX_BITS) in registers
    stages: tuple       # the stages it runs, as u (stage bit c + u), in order


class RadixPlan(NamedTuple):
    logn: int
    threads: int        # a block
    groups: int         # virtual threads a thread plays one after the other
    smem_bytes: int     # the polynomials, swizzled, in shared memory
    forward: tuple      # RadixPass per pass: stage bits log n - 1 .. 0
    inverse: tuple      # RadixPass per pass: stage bits 0 .. log n - 1


@lru_cache(maxsize=None)
def _radix_plan(logn: int, max_threads: int | None = None,
                buffers: int = 1) -> RadixPlan:
    """The pass structure of csrc/radix_chain.cuh's RadixShape<logn,
    max_threads> for a kernel that holds ``buffers`` polynomials in shared
    memory (max_threads None: the one-buffer kernels' block shape,
    OneBuffer<logn>): the forward chain's passes at c = log n - 4,
    log n - 8, .., then c = 0 over the bits left; the inverse chain's at
    c = 0, 4, .., then c = log n - 4 over the bits left.  The wrappers hand
    the kernels ``threads`` and ``smem_bytes``, which the kernels check
    against their own."""
    if max_threads is None:
        max_threads = WIDE_THREADS if logn >= WIDE_LOGN else RADIX_THREADS
    r = RADIX_BITS
    fwd, inv = [], []
    for p in range(-(-logn // r)):
        c = max(logn - r * (p + 1), 0)
        fwd.append(RadixPass(c, tuple(range(logn - r * p - 1 - c, -1, -1))))
        c = min(r * p, logn - r)
        inv.append(RadixPass(c, tuple(range(r * p - c, r))))
    vthreads = 1 << (logn - r)
    threads = min(vthreads, max_threads)
    return RadixPlan(logn, threads, vthreads // threads, buffers * 4 << logn,
                     tuple(fwd), tuple(inv))


# -- the transform past one block (K1-K3, K5-K9 and K12 at n = 2^16 .. 2^26,
# K10's grid layout; csrc/ntt_chunks.cuh) ----------------------------------

CHUNK_LOGN = WIDE_LOGN  # kChunkLogN: a chunk of 2^15 words, one block's chain
TOP_BITS = 4            # kTopBits: the stages a top pass runs at most
TOP_THREADS = 256       # kTopThreads


class ChunkPlan(NamedTuple):
    logn: int
    chunks: int         # 2^s chunks of 2^CHUNK_LOGN words a polynomial
    top: tuple          # (lo, stages) of each top pass, forward order: bits
                        # lo .. lo + stages - 1, from log n - 1 down to
                        # CHUNK_LOGN; the inverse runs them reversed
    chain: RadixPlan    # a chunk's chain (its threads and shared memory)


@lru_cache(maxsize=None)
def _chunk_plan(logn: int, logc: int = CHUNK_LOGN) -> ChunkPlan:
    """The schedule of a transform of 2^logn > 2^logc words across blocks
    (csrc/ntt_chunks.cuh's top_lo / top_bits, where logc = CHUNK_LOGN; the
    CPU tests also emulate smaller chunks): top passes of up to TOP_BITS
    stages each through device memory, then one block a chunk on the
    one-buffer chain of 2^logc words."""
    if logn <= logc:
        raise ValueError(f"log n = {logn}: a block holds the polynomial")
    top, hi = [], logn - 1
    while hi >= logc:
        lo = max(hi - TOP_BITS + 1, logc)
        top.append((lo, hi - lo + 1))
        hi = lo - 1
    return ChunkPlan(logn, 1 << (logn - logc), tuple(top), _radix_plan(logc))


def _chunk_tables(qs: tuple, n: int, inverse: bool, device) -> torch.Tensor:
    """The tables a transform at n reads: the chunk tables past a block,
    the [2, L, n] tables below."""
    if n > 1 << CHUNK_LOGN:
        return _chunk_twiddles(qs, n, 1 << CHUNK_LOGN, inverse, device)
    return _twiddles(qs, n, inverse, device)


def drop_tables() -> None:
    """Forget the cached root tables of every prime and degree (host and
    device): at n = 2^26 a direction's tables hold 0.5 GB on each."""
    for f in (ntt_mod.get_plan, ntt_mod._stage_roots, _twiddles_host,
              _twiddles, _chunk_index, _chunk_twiddles, _roots_plain):
        f.cache_clear()


def _mul4_plan(logn: int, side: bool = False) -> RadixPlan:
    """The plan a block of K6, K7 or K8 runs at n = 2^logn: the chains of
    its n words below 2^WIDE_LOGN; there, one block of a split (a cluster
    of two), those of its half, and with ``side`` (K6) the words of x0's
    transform that its threads keep beside the buffers for every group of
    virtual threads but the first (kMul4Side); past it a chunk's chain on
    the chunked schedule (``_chunk_plan``: one buffer, K2's and the
    transforms' block shape)."""
    if logn > WIDE_LOGN:
        return _chunk_plan(logn).chain
    if logn != WIDE_LOGN:
        return _radix_plan(logn, MUL4_THREADS, MUL4_BUFFERS)
    plan = _radix_plan(logn - 1, MUL4_THREADS, MUL4_BUFFERS)
    if side:
        extra = 4 * (plan.groups - 1) * plan.threads << RADIX_BITS
        plan = plan._replace(smem_bytes=plan.smem_bytes + extra)
    return plan


# -- the conversion of K5 and K6 from a source basis -------------------------

# The source counts whose instance converts each word inside the kernel
# (ext_coeff<LS> of csrc/modarith.cuh, the y_i in registers): K5's (the
# BFV Q basis's and the linear path's) and K6's (the BFV P basis from Q).
# Every other count is staged: the lift (csrc/ext.cuh's ext_lift_kernel)
# forms each operand's y_i and alpha once per polynomial into a scratch, and
# the kernel forms each destination prime's sums from those rows.
EXT_NTT_DIRECT = (2, 4)
MUL4_DIRECT = (4,)


class LiftPlan(NamedTuple):
    staged: bool
    shape: tuple        # the lift's scratch, int32 [operands, Ls + 1, B, n]
                        # (rows 0 .. Ls - 1 the y_i, row Ls alpha); () direct
    bytes: int


def lift_plan(kernel, ls: int, batch: int, n: int) -> LiftPlan:
    """The layout in which K5 (``_cuda.EXT_NTT``, one operand) or K6
    (``_cuda.TENSOR_MUL4``, four) converts ``batch`` polynomials of n words
    from ``ls`` source primes, and the scratch its wrapper allocates for the
    staged layout."""
    operands, direct = {_cuda.EXT_NTT: (1, EXT_NTT_DIRECT),
                        _cuda.TENSOR_MUL4: (4, MUL4_DIRECT)}[kernel]
    if ls in direct:
        return LiftPlan(False, (), 0)
    shape = (operands, ls + 1, batch, n)
    return LiftPlan(True, shape, 4 * operands * (ls + 1) * batch * n)


def _lift_scratch(plan: LiftPlan, device):
    """(layout name, the scratch tensor or None) of a LiftPlan."""
    if not plan.staged:
        return "direct", None
    return "staged", torch.empty(plan.shape, dtype=torch.int32, device=device)


# -- plain versions ---------------------------------------------------------

def _chain_plain(x, qs: tuple, inverse: bool):
    """The reference's reshape stage loop on int64 [L, B..., n]."""
    L, n = x.shape[0], x.shape[-1]
    batch = tuple(x.shape[1:-1])
    roots = _roots_plain(tuple(qs), n, inverse, x.device)
    qv = qvec(qs, x.ndim + 1, x.device)
    bshape = (L,) + (1,) * len(batch)
    r = x
    if not inverse:
        t, m = n // 2, 1
        while m < n:
            r = r.reshape((L,) + batch + (m, 2, t))
            u = r[..., 0, :]
            s = roots[:, m:2 * m].reshape(bshape + (m, 1))
            v = r[..., 1, :] * s % qv
            r = torch.stack([(u + v) % qv, (u - v) % qv], dim=-2)
            t, m = t // 2, m * 2
    else:
        t, m = 1, n // 2
        while m > 0:
            r = r.reshape((L,) + batch + (m, 2, t))
            u, v = r[..., 0, :], r[..., 1, :]
            s = roots[:, m:2 * m].reshape(bshape + (m, 1))
            r = torch.stack([(u + v) % qv, (u - v) % qv * s % qv], dim=-2)
            t, m = t * 2, m // 2
    return r.reshape(x.shape)


def ntt_multi_plain(x, qs: tuple, inverse: bool = False, fin=None):
    fin = _default_fin(tuple(qs), x.shape[-1], inverse, fin)
    r = _chain_plain(x.long(), qs, inverse)
    if fin is not None:
        r = r * qvec(fin, x.ndim, x.device) % qvec(qs, x.ndim, x.device)
    return r.int()


def ntt_plain(x, q: int, inverse: bool = False):
    """Single-prime transform of int64 [..., n] values in [0, q); the
    inverse times n^-1.  Returns int64."""
    r = _chain_plain(x.long()[None], (q,), inverse)[0]
    if inverse:
        r = r * pow(x.shape[-1], -1, q) % q
    return r


def tensor_eval4_plain(x0, x1, y0, y1, dst: tuple, scale=None):
    qv = qvec(dst, x0.ndim, x0.device)
    a0, a1, b0, b1 = (v.long() for v in (x0, x1, y0, y1))
    prods = torch.stack([a0 * b0 % qv, (a0 * b1 + a1 * b0) % qv,
                         a1 * b1 % qv], dim=-2)
    fin = tuple(pow(x0.shape[-1], -1, q)
                * (1 if scale is None else int(scale[j])) % q
                for j, q in enumerate(dst))
    return ntt_multi_plain(prods, dst, inverse=True, fin=fin)


def _key_mid(k, ndim: int):
    """Align [R, Lp, n] key rows against [R, Lp, batch.., n] digits."""
    if k.ndim == 3:
        return k.reshape(k.shape[:2] + (1,) * (ndim - 3) + k.shape[-1:])
    return k


def ks_contract_plain(edm, kb, ka, primes: tuple):
    qv = qvec(primes, edm.ndim - 1, edm.device)[None]
    rinv = qvec([pow(R32, -1, q) for q in primes], edm.ndim - 1,
                edm.device)[None]
    d = edm.long()
    outs = []
    for k in (kb, ka):
        p = d * _key_mid(k, edm.ndim).long() % qv * rinv % qv
        outs.append(ntt_multi_plain(p.sum(0) % qv[0], primes, inverse=True))
    return outs[0], outs[1]


def ext_ntt_plain(x, src: tuple, dst: tuple):
    return ntt_multi_plain(ext_cuda.base_extend_fused_plain(x, src, dst), dst)


def tensor_mul4_plain(x0, x1, y0, y1, dst: tuple, scale=None, src=None):
    four = torch.stack([x0, x1, y0, y1], dim=-2)
    if src is not None:
        four = ext_cuda.base_extend_fused_plain(four, src, dst)
    e = ntt_multi_plain(four, dst)
    return tensor_eval4_plain(*(e[..., i, :] for i in range(4)), dst,
                              scale=scale)


def tensor_mul_plain(x4, qs: tuple, scale=None):
    return tensor_mul4_plain(*(x4[..., i, :] for i in range(4)), qs,
                             scale=scale)


def digit_reps(primes: tuple, src_primes: tuple) -> int:
    """Conditional subtractions that bring a limb residue below any prime
    of ``primes`` (the reference's count)."""
    return (max(src_primes) - 1) // min(primes) + 1


def _ks_acc_plain(c_limbs, kb, ka, primes: tuple, src_primes: tuple):
    """sum_r NTT([c_r] mod p_j) * k[r, j] for both key halves, int64
    eval-domain [Lp, batch.., n]."""
    R, Lp = c_limbs.shape[0], len(primes)
    qv = qvec(primes, c_limbs.ndim, c_limbs.device)         # [Lp, 1.., 1]
    d = c_limbs.long()[:, None].expand((R, Lp) + tuple(c_limbs.shape[1:]))
    for _ in range(digit_reps(primes, src_primes)):
        d = torch.where(d >= qv[None], d - qv[None], d)
    ed = ntt_multi_plain(d.transpose(0, 1), primes).transpose(0, 1).long()
    return tuple((ed * _key_mid(k, ed.ndim).long() % qv[None]).sum(0) % qv
                 for k in (kb, ka))


def ks_fused_plain(c_limbs, kb, ka, primes: tuple, src_primes: tuple):
    return tuple(ntt_multi_plain(acc, primes, inverse=True) for acc in
                 _ks_acc_plain(c_limbs, kb, ka, primes, src_primes))


def ks_fused_eval_plain(c_limbs, kb, ka, primes: tuple, src_primes: tuple,
                        adds):
    qv = qvec(primes, c_limbs.ndim, c_limbs.device)
    es = [((acc + ntt_multi_plain(add, primes).long()) % qv).int()
          for acc, add in zip(_ks_acc_plain(c_limbs, kb, ka, primes,
                                            src_primes), adds)]
    return (es[0], es[1], ntt_multi_plain(es[0], primes, inverse=True),
            ntt_multi_plain(es[1], primes, inverse=True))


# -- kernel wrappers --------------------------------------------------------

def _transform_plan(logn: int) -> tuple:
    """(threads, shared-memory bytes) a transform kernel's blocks run at
    2^logn: the one-buffer plan, past a block a chunk's."""
    plan = (_chunk_plan(logn).chain if logn > CHUNK_LOGN
            else _radix_plan(logn))
    return plan.threads, plan.smem_bytes


def _chunk_scratch(logn: int, words: int, device):
    """The 32-bit scratch of a transform past a block (its top passes'
    words), None below."""
    if logn <= CHUNK_LOGN:
        return None
    return torch.empty(words, dtype=torch.int32, device=device)


def _layout(logn: int, below: str = "block") -> str:
    """The layout a kernel of two schedules counts a launch at 2^logn
    under: ``below`` up to a block's polynomial, "chunked" past it (K2, K3,
    K5-K8 and K12; K5's and K6's "chunked direct" and "chunked staged")."""
    if logn <= CHUNK_LOGN:
        return below
    return _cuda.CHUNKED if below == "block" else f"{_cuda.CHUNKED} {below}"


def ntt_multi_kernel(x, qs: tuple, inverse: bool = False, fin=None):
    """K1: one block per (prime, polynomial), on the register-resident
    chain (``_radix_plan``); past n = 2^15 across blocks (``_chunk_plan``:
    top passes through a scratch, then one block a chunk).  The inverse
    reads its rows as uint4 when x is 16-byte aligned and word by word
    otherwise."""
    dev = x.device
    _cuda.check(x, "x", dev)
    L, n = x.shape[0], x.shape[-1]
    logn = _cuda.log2_degree(n, _cuda.NTT_MULTI)
    if L != len(qs):
        raise ValueError(f"x has {L} rows for {len(qs)} primes")
    qs = tuple(qs)
    fin = _default_fin(qs, n, inverse, fin)
    out = torch.empty_like(x)
    B = x.numel() // (L * n)
    if B == 0:
        return out
    tw = _chunk_tables(qs, n, inverse, dev)
    cons = _prime_rows(qs, fin, dev)
    tmp = _chunk_scratch(logn, x.numel(), dev)
    _cuda.NTT_MULTI.launch(dev, x.data_ptr(), out.data_ptr(),
                           None if tmp is None else tmp.data_ptr(),
                           tw[0].data_ptr(), tw[1].data_ptr(),
                           cons.data_ptr(), L, B, logn, int(inverse),
                           int(fin is not None), int(_cuda.aligned(x)),
                           *_transform_plan(logn))
    return out


def ntt_kernel(x, q: int, inverse: bool = False):
    """K9: K1's kernel on int64 words, one block per polynomial of the flat
    batch (``_radix_plan``; past n = 2^15 across blocks, ``_chunk_plan``);
    x int64 [..., n], n = 2^7 .. 2^26, with values in [0, q), q < 2^31,
    read as 16-byte vectors by the inverse when x is 16-byte aligned and
    word by word otherwise.  Returns int64 of the same shape."""
    dev = x.device
    _cuda.check(x, "x", dev, dtype=torch.int64)
    if not 1 < q < (1 << 31):
        raise ValueError(f"modulus {q}: the kernel needs q < 2^31")
    n = x.shape[-1]
    logn = _cuda.log2_degree(n, _cuda.NTT)
    out = torch.empty_like(x)
    B = x.numel() // n
    if B == 0:
        return out
    tw = _chunk_tables((q,), n, inverse, dev)
    cons = _prime_rows((q,), _default_fin((q,), n, inverse, None), dev)
    tmp = _chunk_scratch(logn, x.numel(), dev)
    _cuda.NTT.launch(dev, x.data_ptr(), out.data_ptr(),
                     None if tmp is None else tmp.data_ptr(),
                     tw[0].data_ptr(), tw[1].data_ptr(), cons.data_ptr(), B,
                     logn, int(inverse), int(_cuda.aligned(x)),
                     *_transform_plan(logn))
    return out


def _row_views(names, tensors, rows: int, device) -> list:
    """Operands [rows, B.., n] of one shape, possibly strided views with a
    contiguous last axis, each as a [rows, B, n] view (no copy)."""
    shape = tensors[0].shape
    views = []
    for name, v in zip(names, tensors):
        _cuda.check(v, name, device, rows=True)
        if v.shape != shape or v.shape[0] != rows:
            raise ValueError(f"{name} has shape {tuple(v.shape)}; need "
                             f"{tuple(shape)} with {rows} rows")
        views.append(v.view(rows, -1, shape[-1]))
    return views


_OPERANDS = ("x0", "x1", "y0", "y1")


def _row_strides(views) -> list:
    return [s for v in views for s in (v.stride(0), v.stride(1))]


def tensor_eval4_kernel(x0, x1, y0, y1, dst: tuple, scale=None):
    """K2: one block per (prime, polynomial, product), on the
    register-resident inverse chain (``_radix_plan``); past n = 2^15 one
    block a chunk of it, its product formed in the chain's first pass, then
    the inverse top passes in place in the output (``_chunk_plan``).
    Operands may be strided views ([Ld, B.., n] with a contiguous last
    axis)."""
    dev = x0.device
    Ld, n = len(dst), x0.shape[-1]
    logn = _cuda.log2_degree(n, _cuda.TENSOR_EVAL4)
    views = _row_views(_OPERANDS, (x0, x1, y0, y1), Ld, dev)
    B = views[0].shape[1]
    out = torch.empty((Ld,) + tuple(x0.shape[1:-1]) + (3, n),
                      dtype=torch.int32, device=dev)
    if B == 0:
        return out
    dst = tuple(dst)
    tw = _chunk_tables(dst, n, True, dev)
    cons = _prime_rows(dst, _tensor_fin(dst, n, scale), dev)
    _cuda.TENSOR_EVAL4.launch(dev, *(v.data_ptr() for v in views),
                              *_row_strides(views),
                              out.data_ptr(), tw[0].data_ptr(),
                              tw[1].data_ptr(), cons.data_ptr(), Ld, B, logn,
                              *_transform_plan(logn), layout=_layout(logn))
    return out


def ks_contract_kernel(edm, kb, ka, primes: tuple):
    """K3: one block per (prime, polynomial, key half), the contraction in
    the first pass of the register-resident inverse chain (``_radix_plan``);
    past n = 2^15 one block a chunk of it, then the inverse top passes in
    place in the output (``_chunk_plan``).  The rows are read as uint4 when
    edm, kb and ka are 16-byte aligned and word by word otherwise."""
    dev = edm.device
    R, Lp, n = edm.shape[0], edm.shape[1], edm.shape[-1]
    logn = _cuda.log2_degree(n, _cuda.KS_CONTRACT)
    _cuda.check(edm, "edm", dev)
    for name, k in (("kb", kb), ("ka", ka)):
        _cuda.check(k, name, dev)
        if tuple(k.shape) != (R, Lp, n):
            raise ValueError(f"{name} has shape {tuple(k.shape)}, expected "
                             f"{(R, Lp, n)}")
    if Lp != len(primes):
        raise ValueError(f"edm has {Lp} prime rows for {len(primes)} primes")
    primes = tuple(primes)
    out = torch.empty((2,) + tuple(edm.shape[1:]), dtype=torch.int32,
                      device=dev)
    B = edm.numel() // (R * Lp * n)
    if B > 0:
        tw = _chunk_tables(primes, n, True, dev)
        cons = _prime_rows(primes, _default_fin(primes, n, True, None), dev)
        vec = all(_cuda.aligned(t) for t in (edm, kb, ka))
        _cuda.KS_CONTRACT.launch(dev, edm.data_ptr(), kb.data_ptr(),
                                 ka.data_ptr(), out.data_ptr(),
                                 tw[0].data_ptr(), tw[1].data_ptr(),
                                 cons.data_ptr(), R, Lp, B, logn, int(vec),
                                 *_transform_plan(logn),
                                 layout=_layout(logn))
    return out[0], out[1]


def ext_ntt_kernel(x, src: tuple, dst: tuple):
    """K5: one block per (dst prime, polynomial), on the register-resident
    forward chain (``_radix_plan``); past n = 2^15 the extension in the
    first forward top pass into a 32-bit scratch, the other top passes,
    then one block a chunk (``_chunk_plan``).  Any source basis of 1 .. 31
    primes, direct or staged (``lift_plan``: the lift into a scratch first,
    in the same C call)."""
    dev = x.device
    _cuda.check(x, "x", dev)
    ext_cuda._check_src(src)
    Ls, Ld, n = len(src), len(dst), x.shape[-1]
    logn = _cuda.log2_degree(n, _cuda.EXT_NTT)
    if x.shape[0] != Ls:
        raise ValueError(f"x has {x.shape[0]} rows for {Ls} primes")
    out = torch.empty((Ld,) + tuple(x.shape[1:]), dtype=torch.int32,
                      device=dev)
    B = x.numel() // (Ls * n)
    if B == 0:
        return out
    src, dst = tuple(src), tuple(dst)
    tab = ext_cuda.kernel_table(src, dst, None, dev)
    tw = _chunk_tables(dst, n, False, dev)
    cons = _prime_rows(dst, None, dev)
    layout, lift = _lift_scratch(lift_plan(_cuda.EXT_NTT, Ls, B, n), dev)
    tmp = _chunk_scratch(logn, out.numel(), dev)
    _cuda.EXT_NTT.launch(dev, x.data_ptr(),
                         None if lift is None else lift.data_ptr(),
                         None if tmp is None else tmp.data_ptr(),
                         out.data_ptr(), tab.data_ptr(), tw[0].data_ptr(),
                         tw[1].data_ptr(), cons.data_ptr(), Ls, Ld, B, logn,
                         *_transform_plan(logn),
                         layout=_layout(logn, layout))
    return out


def _tensor_mul4_launch(kernel, x0, x1, y0, y1, dst: tuple, scale, src):
    logn = _cuda.log2_degree(x0.shape[-1], kernel)
    dev = x0.device
    dst = tuple(dst)
    Ld, n = len(dst), x0.shape[-1]
    if src is not None:
        src = tuple(src)
        ext_cuda._check_src(src)
    views = _row_views(_OPERANDS, (x0, x1, y0, y1),
                       Ld if src is None else len(src), dev)
    B = views[0].shape[1]
    out = torch.empty((Ld,) + tuple(x0.shape[1:-1]) + (3, n),
                      dtype=torch.int32, device=dev)
    if B == 0:
        return out
    tab = None if src is None else ext_cuda.kernel_table(src, dst, None, dev)
    tw, twinv = (_chain_twiddles(dst, n, inv, dev) for inv in (False, True))
    cons = _prime_rows(dst, _tensor_fin(dst, n, scale), dev)
    plan = _mul4_plan(logn, side=True)
    form, lift = ("direct", None) if src is None else _lift_scratch(
        lift_plan(kernel, len(src), B, n), dev)
    tmp = _chunk_scratch(logn, 4 * Ld * B * n, dev)
    kernel.launch(dev, *(v.data_ptr() for v in views), *_row_strides(views),
                  None if lift is None else lift.data_ptr(),
                  None if tmp is None else tmp.data_ptr(), out.data_ptr(),
                  None if tab is None else tab.data_ptr(),
                  tw[0].data_ptr(), tw[1].data_ptr(), twinv[0].data_ptr(),
                  twinv[1].data_ptr(), cons.data_ptr(),
                  0 if src is None else len(src), Ld, B, logn, plan.threads,
                  plan.smem_bytes,
                  layout=_layout(logn, form if kernel is _cuda.TENSOR_MUL4
                                 else "block"))
    return out


def tensor_mul4_kernel(x0, x1, y0, y1, dst: tuple, scale=None, src=None):
    """K6: one block per (dst prime, polynomial), seven transforms on the
    register-resident chain (``_mul4_plan``: MUL4_THREADS threads and three
    buffers; at n = 2^15 a cluster of two blocks, one half each); past
    n = 2^15 the four forwards on the chunked schedule through an eval
    scratch of 4 Ld B n words, then K2's chunked products and inverses
    (``_chunk_plan``).  Operands [Ld, B.., n], or [Ls, B.., n] over ``src``
    with the extension src -> dst run in the kernel, direct or staged
    (``lift_plan``); they may be strided views."""
    return _tensor_mul4_launch(_cuda.TENSOR_MUL4, x0, x1, y0, y1, dst, scale,
                               src)


def tensor_mul_kernel(x4, qs: tuple, scale=None):
    """The stacked form [L, B.., 4, n]: K6's kernels on the four row
    views."""
    if x4.ndim < 3 or x4.shape[-2] != 4:
        raise ValueError(f"x4 has shape {tuple(x4.shape)}; need [L, .., 4, n]")
    return _tensor_mul4_launch(_cuda.TENSOR_MUL,
                               *(x4[..., i, :] for i in range(4)), qs, scale,
                               None)


def _ks_operands(c_limbs, kb, ka, primes: tuple):
    """Checks shared by K7 and K8; returns the [R, B, n] view of c_limbs."""
    dev = c_limbs.device
    R, n = c_limbs.shape[0], c_limbs.shape[-1]
    (c,) = _row_views(("c_limbs",), (c_limbs,), R, dev)
    for name, k in (("kb", kb), ("ka", ka)):
        _cuda.check(k, name, dev)
        if tuple(k.shape) != (R, len(primes), n):
            raise ValueError(f"{name} has shape {tuple(k.shape)}, expected "
                             f"{(R, len(primes), n)}")
    return c


def ks_fused_kernel(c_limbs, kb, ka, primes: tuple, src_primes: tuple):
    """K7: one block per (prime, polynomial), R + 2 transforms on the
    register-resident chain (``_mul4_plan``: MUL4_THREADS threads and three
    buffers; at n = 2^15 a cluster of two blocks, one half each); past
    n = 2^15 the digit rows' forwards one after another on the chunked
    schedule through a scratch of Lp B n words, each adding its products
    into the two sums in the output, then their inverses in place.  c_limbs
    [R, B.., n] may be a strided view; kb/ka [R, Lp, n] are read as uint4
    when both are 16-byte aligned."""
    logn = _cuda.log2_degree(c_limbs.shape[-1], _cuda.KS_FUSED)
    dev = c_limbs.device
    primes = tuple(primes)
    Lp, n = len(primes), c_limbs.shape[-1]
    c = _ks_operands(c_limbs, kb, ka, primes)
    R, B = c.shape[0], c.shape[1]
    out = torch.empty((2, Lp) + tuple(c_limbs.shape[1:]), dtype=torch.int32,
                      device=dev)
    if B > 0:
        tw, twinv = (_chain_twiddles(primes, n, inv, dev)
                     for inv in (False, True))
        cons = _prime_rows(primes, _tensor_fin(primes, n, None), dev)
        plan = _mul4_plan(logn)
        tmp = _chunk_scratch(logn, Lp * B * n, dev)
        _cuda.KS_FUSED.launch(dev, c.data_ptr(), c.stride(0), c.stride(1),
                              kb.data_ptr(), ka.data_ptr(), out.data_ptr(),
                              None if tmp is None else tmp.data_ptr(),
                              tw[0].data_ptr(), tw[1].data_ptr(),
                              twinv[0].data_ptr(), twinv[1].data_ptr(),
                              cons.data_ptr(), R, Lp, B, logn,
                              digit_reps(primes, src_primes), plan.threads,
                              plan.smem_bytes, layout=_layout(logn))
    return out[0], out[1]


def ks_fused_eval_kernel(c_limbs, kb, ka, primes: tuple, src_primes: tuple,
                         adds):
    """K8: K7's kernel with the two ``adds`` transformed in it too (R + 4
    transforms a block); past n = 2^15 K7's chunked schedule, then each
    add's forward forming e_h in the output and the inverses of e0 and e1
    into its last two rows.  c_limbs [R, B.., n] and the two ``adds``
    [Lp, B.., n] may be strided views.  Returns (e0, e1, r0, r1), each
    [Lp, B.., n]."""
    logn = _cuda.log2_degree(c_limbs.shape[-1], _cuda.KS_FUSED_EVAL)
    dev = c_limbs.device
    primes = tuple(primes)
    Lp, n = len(primes), c_limbs.shape[-1]
    c = _ks_operands(c_limbs, kb, ka, primes)
    R, B = c.shape[0], c.shape[1]
    a0, a1 = _row_views(("adds[0]", "adds[1]"), adds, Lp, dev)
    if tuple(adds[0].shape[1:]) != tuple(c_limbs.shape[1:]):
        raise ValueError(f"adds have shape {tuple(adds[0].shape)} against "
                         f"c_limbs {tuple(c_limbs.shape)}")
    out = torch.empty((4, Lp) + tuple(c_limbs.shape[1:]), dtype=torch.int32,
                      device=dev)
    if B > 0:
        tw, twinv = (_chain_twiddles(primes, n, inv, dev)
                     for inv in (False, True))
        cons = _prime_rows(primes, _default_fin(primes, n, True, None), dev)
        lift = _prime_rows(primes, tuple(R32 % q for q in primes), dev)
        plan = _mul4_plan(logn)
        tmp = _chunk_scratch(logn, Lp * B * n, dev)
        _cuda.KS_FUSED_EVAL.launch(
            dev, c.data_ptr(), c.stride(0), c.stride(1), kb.data_ptr(),
            ka.data_ptr(), a0.data_ptr(), a0.stride(0), a0.stride(1),
            a1.data_ptr(), a1.stride(0), a1.stride(1), out.data_ptr(),
            None if tmp is None else tmp.data_ptr(), tw[0].data_ptr(),
            tw[1].data_ptr(), twinv[0].data_ptr(), twinv[1].data_ptr(),
            cons.data_ptr(), lift.data_ptr(), R, Lp, B, logn,
            digit_reps(primes, src_primes), plan.threads, plan.smem_bytes,
            layout=_layout(logn))
    return out[0], out[1], out[2], out[3]
