"""The pass plan of the register-resident chains that K1 (ntt_multi), K2
(tensor_eval4) and K5 (ext_ntt) run on the card (csrc/radix_chain.cuh,
mirrored by ops/ntt_cuda.py::_radix_plan), checked on the CPU at every ring
degree the kernels take: every stage is run once and in order, a block fits
the H100, a torch emulation of the plan's element, twiddle and shared-memory
maps equals the plain transform bit for bit in both directions, K1's own
maps (its first pass from a row in device memory, the forward's uint4
read-out and the inverse's stores, each with fin) equal ntt_multi_plain,
and every warp's shared-memory access hits 32 distinct banks.  Also the
parser of ptxas's register report that chip_smoke.py reads.  Tolerance 0
throughout.
"""

import numpy as np
import pytest
import torch

from fhe_study_tpu_torch.ops import _cuda
from fhe_study_tpu_torch.ops import ntt_cuda as nc
from fhe_study_tpu_torch.ops.primes import ntt_primes

LOGNS = range(_cuda.MIN_LOG_N, _cuda.MAX_LOG_N + 1)
PRIMES = ntt_primes(3, 30, 1 << 15)           # 2n-th roots up to n = 2^14


# The kernel's index maps (csrc/radix_chain.cuh), written out in torch.

def _swizzle(a):
    """Shared-memory word of element a: bits 0..4 XORed with h ^ (h << 1),
    h = bits 5..8 (radix_swizzle)."""
    h = (a >> 5) & 15
    return a ^ ((h ^ (h << 1)) & 31)


def _elements(logn: int, c: int) -> torch.Tensor:
    """[n / 16, 16]: the elements virtual thread v holds in a pass at c,
    base(v, c) | (k << c), v's bits spread over the bits outside [c, c + 4)
    in ascending order (radix_base)."""
    v = torch.arange(1 << (logn - nc.RADIX_BITS))
    base = (v & ((1 << c) - 1)) | ((v >> c) << (c + nc.RADIX_BITS))
    return base[:, None] | (torch.arange(16) << c)[None]


def _twiddle_index(logn: int, c: int, u: int, el) -> torch.Tensor:
    """The root-table index of the twiddle of each pair (k, k | 2^u) of stage
    u in a pass at c as the kernel reads it: 2^(3 - u) side by side from
    (n >> (c + u + 1)) + ((base >> (c + 4)) << (3 - u)), pair k taking the
    (k >> (u + 1))-th (radix_pass)."""
    k = torch.arange(16)
    k = k[(k >> u) & 1 == 0]
    hb = el[:, 0] >> (c + nc.RADIX_BITS)
    first = ((1 << logn) >> (c + u + 1)) + (hb << (3 - u))
    return first[:, None] + (k >> (u + 1))[None]


def _stage_bits(passes) -> list:
    return [p.c + u for p in passes for u in p.stages]


@pytest.mark.parametrize("logn", LOGNS)
def test_plan_runs_every_stage_once_in_order(logn):
    plan = nc._radix_plan(logn)
    assert _stage_bits(plan.forward) == list(range(logn - 1, -1, -1))
    assert _stage_bits(plan.inverse) == list(range(logn))
    for p in plan.forward + plan.inverse:
        assert 0 <= p.c and p.c + nc.RADIX_BITS <= logn
        assert p.stages and all(0 <= u < nc.RADIX_BITS for u in p.stages)
    assert len(plan.forward) == len(plan.inverse) == -(-logn // 4)


@pytest.mark.parametrize("logn", LOGNS)
def test_plan_fits_a_block(logn):
    plan = nc._radix_plan(logn)
    assert plan.threads * plan.groups << nc.RADIX_BITS == 1 << logn
    # 1024 threads and 227 KB of shared memory a block on the H100
    assert plan.threads <= 1024 and plan.smem_bytes <= 232448
    assert plan.smem_bytes == 4 << logn
    # three blocks of 64 KB fit an SM at n = 2^14, at 256 threads of up to
    # 85 registers
    assert plan.threads <= nc.RADIX_THREADS
    assert 3 * (plan.smem_bytes + 1024) <= 233472 and 3 * plan.threads <= 2048


def _run_pass(regs, el, ps, roots, q: int, logn: int, inverse: bool):
    """The stages of one pass on the [n/16, 16] registers of every virtual
    thread (el: the elements they hold), in place."""
    n = 1 << logn
    for u in ps.stages:
        j = ps.c + u
        k = torch.arange(16)
        lo = k[(k >> u) & 1 == 0]
        hi = lo | (1 << u)
        ti = _twiddle_index(logn, ps.c, u, el)
        # the kernel's contiguous, aligned read equals the chain's index
        assert torch.equal(ti, (n >> (j + 1)) + (el[:, lo] >> (j + 1)))
        assert bool((ti[:, 0] % (8 >> u) == 0).all())
        w = roots[ti]
        a, b = regs[:, lo], regs[:, hi]
        if inverse:
            regs[:, lo], regs[:, hi] = (a + b) % q, (a - b) % q * w % q
        else:
            v = b * w % q
            regs[:, lo], regs[:, hi] = (a + v) % q, (a - v) % q


def _lanes_consecutive(addr) -> bool:
    """[virtual threads, 16] word addresses: for each of the 16 accesses the
    lanes of every warp (16 at n = 2^8, where a block is half a warp) touch
    consecutive words (coalesced)."""
    warps = addr.reshape(-1, min(32, addr.shape[0]), 16)
    return bool((warps[:, 1:] - warps[:, :-1] == 1).all())


def _emulate(x, q: int, logn: int, inverse: bool, fin: int = 1):
    """The kernels' data flow on one row x of device memory: each pass runs
    its stages on [n/16, 16] registers, passes exchange through a swizzled
    shared-memory buffer.  The forward's first pass reads word
    base + (j << c0) of the row, base = v (K1; K5 converts the same words),
    and its result leaves shared memory as uint4 rows (row i: the swizzled
    words of 4i .. 4i + 3) times fin; the inverse's first pass reads the 16
    contiguous words from base = 16 v (K1; K2 forms its products there), and
    its last pass stores its registers times fin to base + (j << c), lanes
    on consecutive words."""
    n = 1 << logn
    plan = nc._radix_plan(logn)
    roots = nc._roots_plain((q,), n, inverse, torch.device("cpu"))[0]
    smem = torch.full((n,), -1, dtype=torch.int64)
    passes = plan.inverse if inverse else plan.forward
    v = torch.arange(n >> nc.RADIX_BITS)[:, None]
    k = torch.arange(16)[None]
    out = torch.full((n,), -1, dtype=torch.int64)
    for i, ps in enumerate(passes):
        el = _elements(logn, ps.c)
        if i == 0:
            addr = 16 * v + k if inverse else v + (k << (logn - 4))
            assert torch.equal(addr, el)
            if inverse:                               # uint4-aligned words
                assert bool((addr[:, ::4] % 4 == 0).all())
            else:
                assert _lanes_consecutive(addr)
            regs = x[addr]
        else:
            regs = smem[_swizzle(el)]
        _run_pass(regs, el, ps, roots, q, logn, inverse)
        if inverse and i == len(passes) - 1:
            assert _lanes_consecutive(el)
            out[el] = regs * fin % q
        else:
            smem[_swizzle(el)] = regs
    if not inverse:
        sw = _swizzle(4 * torch.arange(n // 4))
        rows = torch.stack([smem[sw ^ t] for t in range(4)], dim=1)
        out = (rows * fin % q).reshape(n)
    assert int(out.min()) >= 0
    return out


@pytest.mark.parametrize("logn", LOGNS)
def test_emulated_plan_equals_plain_both_ways(logn):
    n = 1 << logn
    rng = np.random.default_rng(logn)
    for q in PRIMES:
        x = torch.from_numpy(rng.integers(0, q, (1, n)))
        fwd = nc.ntt_multi_plain(x, (q,)).long()[0]
        assert torch.equal(_emulate(x[0], q, logn, False), fwd)
        inv = nc.ntt_multi_plain(x, (q,), inverse=True, fin=(1,)).long()[0]
        assert torch.equal(_emulate(x[0], q, logn, True), inv)


@pytest.mark.parametrize("logn", LOGNS)
def test_k1_maps_with_fin_equal_plain(logn):
    n = 1 << logn
    rng = np.random.default_rng(100 + logn)
    for q in PRIMES:
        x = torch.from_numpy(rng.integers(0, q, (1, n)))
        fin = int(rng.integers(1, q))
        for inverse in (False, True):
            want = nc.ntt_multi_plain(x, (q,), inverse=inverse,
                                      fin=(fin,)).long()[0]
            assert torch.equal(_emulate(x[0], q, logn, inverse, fin), want)


def _banks_hit(words) -> int:
    """Most words of one warp access that share a bank (1: no conflict)."""
    return max(int(torch.bincount(w % 32).max()) for w in words)


@pytest.mark.parametrize("logn", LOGNS)
def test_shared_memory_accesses_hit_distinct_banks(logn):
    n = 1 << logn
    plan = nc._radix_plan(logn)
    sw = _swizzle(torch.arange(n))
    assert torch.equal(torch.sort(sw).values, torch.arange(n))
    for ps in plan.forward + plan.inverse:
        el = _elements(logn, ps.c)
        for warp in el.split(32):                 # virtual threads, in lanes
            assert _banks_hit(_swizzle(warp).T) == 1
    # K1's and K5's read-out: lane l of a warp reads words 4l .. 4l + 3
    out = _swizzle(torch.arange(n).reshape(-1, 32, 4))
    assert _banks_hit(out.permute(0, 2, 1).reshape(-1, 32)) == 1


PTXAS_LOG = """nvcc -gencode arch=compute_90a,code=sm_90a ...
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN3fhe12_GLOBAL__N_114ext_ntt_kernelILi14ELi4EEEvPKjPjS3_S3_S3_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN3fhe12_GLOBAL__N_114ext_ntt_kernelILi14ELi4EEEvPKjPjS3_S3_S3_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 58 registers, used 1 barriers, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN3fhe12_GLOBAL__N_119tensor_eval4_kernelILi9EEEvPKjS3_S3_S3_NS0_7StridesEPjS3_S3_S3_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN3fhe12_GLOBAL__N_119tensor_eval4_kernelILi9EEEvPKjS3_S3_S3_NS0_7StridesEPjS3_S3_S3_ii
    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 452 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN3fhe12_GLOBAL__N_116ntt_multi_kernelEPKjPjS2_S2_S2_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN3fhe12_GLOBAL__N_116ntt_multi_kernelEPKjPjS2_S2_S2_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 24 registers, 404 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_stack_and_spills():
    rep = _cuda.ptxas_report(PTXAS_LOG)
    assert [r["kernel"] for r in rep] == [
        "ext_ntt_kernel<14, 4>", "tensor_eval4_kernel<9>", "ntt_multi_kernel"]
    fields = ("registers", "stack", "spill_stores", "spill_loads")
    assert [tuple(r[f] for f in fields) for r in rep] == [
        (58, 0, 0, 0), (64, 16, 8, 4), (24, 0, 0, 0)]
    assert rep[0]["name"].startswith("_ZN3fhe12_GLOBAL__N_114ext_ntt")
