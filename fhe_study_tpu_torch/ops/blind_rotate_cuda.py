"""The whole TFHE blind rotation as one kernel —
``csrc/blind_rotate_cuda.cu`` with ``blind_rotate_dm_cuda.cu``,
``blind_rotate_split_cuda.cu``, ``blind_rotate_quarter_cuda.cu`` and
``blind_rotate_grid_cuda.cu`` — with its
launch wrapper and plain PyTorch version; the counterpart of
fhe_study_tpu/ops/blind_rotate_pallas.py.

  K10 blind_rotate <- blind_rotate_pallas.blind_rotate_fused

    acc <- acc + BSK_j ⊠ (acc · X^{-h_j} - acc)      for every step j

``blind_rotate_fused`` dispatches by the device of its tensors: CUDA
tensors launch the kernel (one call for the whole chain), CPU tensors
walk the chain step by step in int64 torch (``blind_rotate_plain``, which
also is what the kernel is held against on the card).  The kernel has five
layouts, picked by ``_plan`` from (C, l, n) alone: two-block clusters that
keep a ciphertext's working set in shared memory where it fits, the
working set in device memory (two launches a step) elsewhere up to
n = 2^15; where one polynomial no longer fits a block, at n = 2^16 each
polynomial split over the shared memory of a cluster's blocks (``split``:
two launches a step, the top stage through distributed shared memory),
at n = 2^17 in four quarters (``quarter``: two launches a step, the two
top stages through distributed shared memory), and past it the
transforms across blocks (``grid``: top passes through device memory and
one block a chunk of 2^15 words, csrc/ntt_chunks.cuh), up to the
reference's n = 2^22.
"""

from functools import lru_cache
from typing import NamedTuple

import torch

from ..arith import tn
from . import _cuda, ntt_cuda
from . import ntt as ntt_mod
from .modops32 import qvec

# dynamic shared memory one block may use on sm_90
_SMEM_LIMIT = 232448
BR_THREADS = 256        # kBrThreads of csrc/blind_rotate_cuda.cu
BR_CLUSTER = 2          # kBrCluster: one block per CRT prime
_BARRIER_BYTES = 32     # kBrBarrierBytes: the mbarriers of the key copies
                        # and of the peer's columns
# the ring degrees (log2 n) of the cluster layout's instances (kBrMaxLogN):
# its working set fits a block up to 2^12 (at C = 1; C = 2 stops at 2^11)
BR_CLUSTER_LOGN = (7, 12)
# the layout argument of fhe_blind_rotate (csrc/blind_rotate_cuda.cu)
LAYOUT_CODE = {"cluster": 0, "device": 1, "grid": 2, _cuda.SPLIT: 3,
               _cuda.QUARTER: 4}
# the split layout's ring degree (two halves of a chunk's 2^15 words) and
# its inverse launch's cluster: two primes times two halves
SPLIT_LOGN = ntt_cuda.CHUNK_LOGN + 1
SPLIT_CLUSTER = 4
# the quarter layout's (four quarters of 2^15 words): two primes times four
# quarters
QUARTER_LOGN = ntt_cuda.CHUNK_LOGN + 2
QUARTER_CLUSTER = 8


class BlindRotatePlan(NamedTuple):
    logn: int
    threads: int        # a block
    cluster: int        # blocks a cluster, one per CRT prime ("split":
                        # one per prime and half; "quarter": per prime
                        # and quarter)
    staged: bool        # the step's key planes copied into shared memory
    smem_bytes: int     # a block's dynamic shared memory
    forward_polys: int  # C*l digit polynomials ...
    inverse_polys: int  # ... and 2C contracted columns
    radix: ntt_cuda.RadixPlan   # the pass structure of one polynomial
    layout: str = "cluster"     # "cluster": the working set in shared memory;
                                # "device": in device memory; "split" (n =
                                # 2^16): that, each polynomial over a
                                # cluster's blocks; "quarter" (n = 2^17): in
                                # quarters; "grid": each transform across
                                # blocks (n > 2^15)
    blocks: tuple = (2,)        # blocks a ciphertext, of each launch of a
                                # chain ("cluster") or of a step ("device",
                                # "split", "quarter": the forward launch,
                                # then the inverse one; "grid": the top forward
                                # passes, the chunk chains forward, the
                                # contraction's chunk chains inverse, the top
                                # inverse passes)
    scratch_bytes: int = 0      # device memory a ciphertext: the digit
                                # evaluations of a step, both primes ("grid":
                                # also their top passes' words, which the
                                # 2C columns' inverse passes reuse)


def _smem(C: int, l: int, n: int, staged: bool) -> int:
    """br_smem_bytes: the mbarriers, the 64-bit accumulator, the digit
    evaluations of the block's prime, its 2C columns, two exchange buffers
    for the peer's 2C columns and, staged, the step's two key planes of the
    prime."""
    return (_BARRIER_BYTES + 8 * C * n + 4 * C * l * n + 3 * 4 * 2 * C * n
            + (2 * 4 * C * l * 2 * C * n if staged else 0))


@lru_cache(maxsize=None)
def _plan(C: int, l: int, n: int, aligned: bool = True,
          layout: str | None = None) -> BlindRotatePlan:
    """The kernel's launch at (C, l, n), its layout fixed by the shape: the
    two-block clusters of csrc/blind_rotate_cuda.cu where a ciphertext's
    working set fits one block's shared memory (``_smem``), with the key
    planes staged by bulk copies where they fit beside it and the planes
    are 16-byte aligned, read from device memory otherwise; elsewhere the
    working set in device memory (csrc/blind_rotate_dm_cuda.cu): a forward
    block per (digit polynomial, prime) and a cluster of two inverse blocks
    per column, each on one polynomial at the one-buffer shape, with a
    scratch of the step's digit evaluations.  The wrapper hands the kernel
    ``threads``, ``smem_bytes``, ``staged`` and the layout, which it checks
    against its own.  ``layout`` names one to measure it where the rule
    takes another (the device-memory layout runs at any shape up to 2^15,
    the grid layout at 2^16 and 2^17 too).  At 2^16 the split layout
    (csrc/blind_rotate_split_cuda.cu): a forward block per (digit
    polynomial, prime, half), a cluster of four inverse blocks per column
    (two primes, two halves), each on a half's one-buffer shape, and the
    device-memory layout's scratch; nothing between passes.  At 2^17 the
    quarter layout (csrc/blind_rotate_quarter_cuda.cu): a forward cluster
    of four blocks per (digit polynomial, prime) and an inverse cluster of
    eight per column (two primes, four quarters), each block on a
    quarter's one-buffer shape, and the same scratch.  Elsewhere past 2^15 the
    grid layout (csrc/blind_rotate_grid_cuda.cu): each step's transforms
    across blocks (ntt_cuda._chunk_plan), the forward's top passes forming
    the digits, the contraction in the chunk chains' first inverse pass,
    the CRT and the add in the last top inverse pass; a scratch of the
    digit evaluations and of the words between passes."""
    logn = n.bit_length() - 1
    if logn > ntt_cuda.CHUNK_LOGN:
        layout = layout or {SPLIT_LOGN: _cuda.SPLIT,
                            QUARTER_LOGN: _cuda.QUARTER}.get(logn, "grid")
        parts = {(_cuda.SPLIT, SPLIT_LOGN): SPLIT_CLUSTER,
                 (_cuda.QUARTER, QUARTER_LOGN): QUARTER_CLUSTER}.get(
                     (layout, logn))
        if parts:
            # blocks of a chunk's one-buffer shape, parts / 2 a polynomial
            chunk = ntt_cuda._radix_plan(ntt_cuda.CHUNK_LOGN)
            F = C * l
            return BlindRotatePlan(
                logn, chunk.threads, parts, False, chunk.smem_bytes, F,
                2 * C, chunk, layout, (parts // 2 * 2 * F, parts * 2 * C),
                2 * 4 * F * n)
        if layout != "grid":
            raise ValueError(f"layout {layout!r} at C={C}, l={l}, n={n}")
        cp = ntt_cuda._chunk_plan(logn)
        F, cols = C * l, 2 * C
        top = tuple(2 * F * n // (ntt_cuda.TOP_THREADS << k)
                    for _, k in cp.top)
        inv_top = tuple(2 * cols * n // (ntt_cuda.TOP_THREADS << k)
                        for _, k in cp.top[1:][::-1])
        last = C * n // (ntt_cuda.TOP_THREADS << cp.top[0][1])
        return BlindRotatePlan(
            logn, cp.chain.threads, 1, False, cp.chain.smem_bytes, F, cols,
            cp.chain, "grid",
            top + (2 * F * cp.chunks, 2 * cols * cp.chunks) + inv_top
            + (last,), 2 * 4 * n * (F + max(F, cols)))
    fits = _smem(C, l, n, False) <= _SMEM_LIMIT
    if layout not in (None, "cluster", "device") or (
            layout == "cluster" and not fits):
        raise ValueError(f"layout {layout!r} at C={C}, l={l}, n={n}")
    if fits and layout != "device":
        assert logn <= BR_CLUSTER_LOGN[1]
        staged = aligned and _smem(C, l, n, True) <= _SMEM_LIMIT
        return BlindRotatePlan(logn, BR_THREADS, BR_CLUSTER, staged,
                               _smem(C, l, n, staged), C * l, 2 * C,
                               ntt_cuda._radix_plan(logn, BR_THREADS))
    radix = ntt_cuda._radix_plan(logn)
    return BlindRotatePlan(logn, radix.threads, BR_CLUSTER, False,
                           radix.smem_bytes, C * l, 2 * C, radix, "device",
                           (2 * C * l, 2 * 2 * C), 2 * 4 * C * l * n)


def supported(param, beta: int, l: int) -> bool:
    """Static conditions under which the fused chain applies: the
    reference's, letter for letter at every ring degree it takes (2^7 ..
    2^22, where the CRT pair's 2n-th roots end: the kernel's own range) and
    digits of at least one bit."""
    n = param.ring.n
    p1, p2 = ntt_mod.CRT_PRIMES_TFHE
    w = beta.bit_length() - 1
    return (n & (n - 1) == 0
            and n.bit_length() - 1 in _cuda.BLIND_ROTATE.degrees
            and beta == (1 << w) and 1 <= w and w * l <= 64
            and beta <= min(p1, p2)
            and (param.k + 1) * l * n * beta < (1 << 26)
            # a primitive 2n-th root under both primes
            and all((p - 1) % (2 * n) == 0 for p in (p1, p2)))


def _check_shapes(shifts, acc0, ev1, ev1s, ev2, ev2s, n: int, w: int):
    steps, B = shifts.shape
    C = acc0.shape[1]
    l = ev1.shape[2]
    if tuple(acc0.shape) != (B, C, n):
        raise ValueError(f"acc0 has shape {tuple(acc0.shape)}, expected "
                         f"{(B, C, n)}")
    for name, e in (("ev1", ev1), ("ev1s", ev1s), ("ev2", ev2),
                    ("ev2s", ev2s)):
        if tuple(e.shape) != (steps, C, l, C, 2, n):
            raise ValueError(f"{name} has shape {tuple(e.shape)}, expected "
                             f"{(steps, C, l, C, 2, n)}")
    if not (1 <= w and w * l <= 64 and (1 << w) <= min(
            ntt_mod.CRT_PRIMES_TFHE)):
        raise ValueError(f"digit width w={w} with l={l} levels")
    return steps, B, C, l


def blind_rotate_plain(shifts, acc0, ev1, ev1s, ev2, ev2s, n: int, w: int):
    """The chain step by step in int64 torch; the kernel's signature.  The
    Shoup planes are not needed: (digit * key) mod p is exact in int64."""
    steps, B, C, l = _check_shapes(shifts, acc0, ev1, ev1s, ev2, ev2s, n, w)
    pq = ntt_mod.CRT_PRIMES_TFHE
    qv = qvec(pq, 5, acc0.device)                  # against [2, B, C, 2, n]
    acc = acc0
    for j in range(steps):
        rot = tn.left_rotate(acc, shifts[j][:, None], n)
        d = tn.decompose_base_pow2(rot - acc, w, l)             # [l, B, C, n]
        d = torch.movedim(d, 0, 2)                              # [B, C, l, n]
        ed = ntt_cuda.ntt_multi_plain(torch.stack([d, d]).int(), pq).long()
        ev = torch.stack([ev1[j], ev2[j]]).long()[:, None]  # [2,1,r,l,c,2,n]
        prod = ed[:, :, :, :, None, None, :] * ev % qv[:, :, :, None, None]
        s = prod.sum((2, 3)) % qv                               # [2,B,c,2,n]
        r = ntt_cuda.ntt_multi_plain(s.int(), pq, inverse=True).long()
        gk = ntt_mod.crt_lift_centered(r[0], r[1], *pq)         # [B,c,2,n]
        acc = acc + gk[..., 0, :] + gk[..., 1, :] * (1 << 32)
    return acc


def blind_rotate_kernel(shifts, acc0, ev1, ev1s, ev2, ev2s, n: int, w: int,
                        layout: str | None = None):
    """K10: the whole chain in one call, in the layout of ``_plan``: one
    cluster of two blocks per ciphertext (one CRT prime each) for the whole
    chain, or two launches a step over a working set in device memory (at
    2^16 on clusters of four, the polynomials split; at 2^17 on clusters of
    eight, in quarters), or past 2^17 four.
    shifts int32 [steps, B] in [0, 2n); acc0 int64 [B, C, n]; ev1, ev1s,
    ev2, ev2s int32 [steps, C, l, C, 2, n].  Returns int64 [B, C, n].
    ``layout`` forces a layout, for measurement (``_plan``).  Past n = 2^15
    (the split, quarter and grid layouts) the tables are the chunk tables
    of ntt_cuda."""
    dev = acc0.device
    _cuda.check(shifts, "shifts", dev)
    _cuda.check(acc0, "acc0", dev, dtype=torch.int64)
    for name, e in (("ev1", ev1), ("ev1s", ev1s), ("ev2", ev2),
                    ("ev2s", ev2s)):
        _cuda.check(e, name, dev)
    steps, B, C, l = _check_shapes(shifts, acc0, ev1, ev1s, ev2, ev2s, n, w)
    logn = _cuda.log2_degree(n, _cuda.BLIND_ROTATE)
    plan = _plan(C, l, n, all(_cuda.aligned(e) for e in (ev1, ev1s, ev2,
                                                          ev2s)), layout)
    out = torch.empty_like(acc0)
    if B == 0:
        return out
    if steps == 0:
        return out.copy_(acc0)
    scratch = (torch.empty(B * plan.scratch_bytes // 4, dtype=torch.int32,
                           device=dev) if plan.scratch_bytes else None)
    p1, p2 = pq = ntt_mod.CRT_PRIMES_TFHE
    tw = ntt_cuda._chunk_tables(pq, n, False, dev)
    twinv = ntt_cuda._chunk_tables(pq, n, True, dev)
    # the split, quarter and device-memory layouts' Montgomery contraction
    # leaves a factor 2^-32, which their final multiplier takes back
    r = ntt_cuda.R32 if plan.layout in (_cuda.SPLIT, _cuda.QUARTER,
                                        "device") else 1
    cons = ntt_cuda._prime_rows(
        (p1, p2, p2), (pow(n, -1, p1) * r % p1, pow(n, -1, p2) * r % p2,
                       pow(p1, -1, p2)), dev)
    _cuda.BLIND_ROTATE.launch(
        dev, shifts.data_ptr(), acc0.data_ptr(), ev1.data_ptr(),
        ev1s.data_ptr(), ev2.data_ptr(), ev2s.data_ptr(), out.data_ptr(),
        tw[0].data_ptr(), tw[1].data_ptr(), twinv[0].data_ptr(),
        twinv[1].data_ptr(), cons.data_ptr(),
        scratch.data_ptr() if scratch is not None else None, steps, B, C, l,
        w, logn, plan.threads, plan.smem_bytes, int(plan.staged),
        LAYOUT_CODE[plan.layout], layout=plan.layout)
    return out


def split_clusters(device) -> int:
    """The split layout's inverse clusters of four that the card runs at
    once (cudaOccupancyMaxActiveClusters; the SMs of a GPC that four does
    not divide stay idle in that launch)."""
    return _cuda.max_clusters("fhe_blind_rotate_split_clusters", device)


def quarter_clusters(device) -> int:
    """The quarter layout's inverse clusters of eight that the card runs at
    once (cudaOccupancyMaxActiveClusters; the SMs of a GPC that eight does
    not divide stay idle in that launch)."""
    return _cuda.max_clusters("fhe_blind_rotate_quarter_clusters", device)


def blind_rotate_fused(shifts, acc0, ev1, ev1s, ev2, ev2s, n: int, w: int):
    """Run the full CMux chain: shifts [steps, B] int32 step-j rotation
    amounts (2N - a'_j) mod 2N, acc0 [B, C, N] int64 initial accumulator,
    ev1/ev2 [steps, C, l, C, 2, N] int32 eval-domain key with Shoup planes
    ev1s/ev2s (tggsw.precompute_evals), w = log2(beta).  Returns
    [B, C, N] int64."""
    fn = (blind_rotate_kernel
          if _cuda.on_cuda(shifts, acc0, ev1, ev1s, ev2, ev2s)
          else blind_rotate_plain)
    return fn(shifts, acc0, ev1, ev1s, ev2, ev2s, n, w)
