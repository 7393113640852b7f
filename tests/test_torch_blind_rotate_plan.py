"""The schedule of K10's cluster layout, the blind rotation on the card
(csrc/blind_rotate_cuda.cu, launched by ops/blind_rotate_cuda.py::_plan),
emulated in int64 torch on the CPU and held against blind_rotate_plain bit
for bit (tolerance 0): one "block" per CRT prime, each with its own copy of
the 64-bit accumulator; the digits formed from the rotated accumulator in the
first forward pass's element sets; the C*l digit polynomials side by side on
the register-resident chain (the plan's passes, twiddle and swizzle maps of
tests/test_torch_radix_plan.py); the contraction into the first inverse
pass's registers; n^-1 in the last inverse pass; the CRT from the two blocks'
exchange buffers, as the kernel reads them.  Also: the plan's thread and
virtual-thread maps cover every (polynomial, coefficient) once, a block fits
the H100, and supported() accepts every shape the first version's shared
memory rule accepted.  The device-memory layout has its own file,
tests/test_torch_blind_rotate_dm.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fhe_study_tpu_torch.arith import tn
from fhe_study_tpu_torch.ops import _cuda
from fhe_study_tpu_torch.ops import blind_rotate_cuda as brc
from fhe_study_tpu_torch.ops import ntt as ntt_mod
from fhe_study_tpu_torch.ops import ntt_cuda as nc
from fhe_study_tpu_torch.utils import k10_phases
from test_torch_radix_plan import _elements, _run_pass, _swizzle

CPU = torch.device("cpu")
P0, P1 = ntt_mod.CRT_PRIMES_TFHE
SHAPES = [(C, l) for C in (2, 3) for l in (1, 2, 3)]
CLUSTER_DEGREES = range(brc.BR_CLUSTER_LOGN[0], brc.BR_CLUSTER_LOGN[1] + 1)
# the degrees whose polynomial a block holds: the cluster and device-memory
# layouts (past them the grid layout, tests/test_torch_degree16.py)
BLOCK_DEGREES = range(brc.BR_CLUSTER_LOGN[0], nc.CHUNK_LOGN + 1)
W = {1: 20, 2: 12, 3: 21}        # digit widths: l = 3 takes w * l = 63


def _maps(plan, polys: int, c: int, first_inverse: bool = False):
    """(thread, polynomial, elements) of every virtual thread of a pass loop
    over ``polys`` polynomials: t = thread + g * threads takes polynomial
    t >> (log n - 4) and its virtual thread t mod (n / 16); the contraction
    (first_inverse) holds the 16 contiguous words from 16 v."""
    logn = plan.logn
    vth = 1 << (logn - nc.RADIX_BITS)
    t = torch.arange(polys * vth)
    el = _elements(logn, c)[t % vth]
    if first_inverse:
        assert torch.equal(el, 16 * (t % vth)[:, None] + torch.arange(16))
    return t % plan.threads, t >> (logn - nc.RADIX_BITS), el


def _rotation(logn: int):
    """The contraction's chunk rotation of virtual thread v: (v >> 1) & 3."""
    return (torch.arange(1 << (logn - nc.RADIX_BITS)) >> 1) & 3


def _rotated_elements(logn: int):
    """[n/16, 16]: the element in each register of the contraction before
    the rotation back: slot 4u + i holds word 4((u + rot) & 3) + i of the
    virtual thread's 16 contiguous words."""
    rot = _rotation(logn)
    v = torch.arange(1 << (logn - nc.RADIX_BITS))
    u = torch.arange(4)
    ch = (u[None] + rot[:, None]) & 3                    # [V, 4]
    return (16 * v[:, None, None] + 4 * ch[:, :, None]
            + torch.arange(4)).reshape(-1, 16)


def _passes(regs, el, ps, roots, q, logn, inverse):
    """One pass on [polys, n/16, 16] registers, every polynomial alike."""
    P, V = regs.shape[:2]
    flat = regs.reshape(P * V, 16)
    _run_pass(flat, el.repeat(P, 1), ps, roots, q, logn, inverse)
    regs.copy_(flat.reshape(P, V, 16))


def _block_step(acc, h, ev, r, C, l, w, plan):
    """One CMux step of the block of prime r on one ciphertext: returns its
    exchange buffer [2C, n] (swizzled words, n^-1 applied)."""
    logn, n = plan.logn, 1 << plan.logn
    q = (P0, P1)[r]
    fwd, inv = nc._roots_plain((q,), n, False, CPU)[0], \
        nc._roots_plain((q,), n, True, CPU)[0]
    rp = plan.radix
    F, cols = plan.forward_polys, plan.inverse_polys
    dig = torch.full((F, n), -1, dtype=torch.int64)
    # forward pass 0 from the rotated accumulator
    c0 = rp.forward[0].c
    el = _elements(logn, c0)
    p = torch.arange(F)
    cc, i = p // l, p % l
    src = el + h                                         # in [0, 3n)
    a_src = torch.stack([acc[int(c)][src % n] for c in cc])     # [F, V, 16]
    a_src = torch.where((src // n) % 2 == 1, -a_src, a_src)
    a_own = torch.stack([acc[int(c)][el] for c in cc])
    d = a_src - a_own                                    # wraps as u64
    regs = torch.stack([tn.shr(d[k], 64 - w * (int(i[k]) + 1)) & ((1 << w) - 1)
                        for k in range(F)])
    _passes(regs, el, rp.forward[0], fwd, q, logn, False)
    dig[:, _swizzle(el)] = regs
    for ps in rp.forward[1:]:
        el = _elements(logn, ps.c)
        regs = dig[:, _swizzle(el)]
        _passes(regs, el, ps, fwd, q, logn, False)
        dig[:, _swizzle(el)] = regs
    # the contraction in the first inverse pass's registers, in the lane's
    # rotated chunk order, then rotated back
    el = _elements(logn, rp.inverse[0].c)
    assert rp.forward[-1].c == rp.inverse[0].c == 0
    rot = _rotation(logn)
    elx = _rotated_elements(logn)
    sb = _swizzle(el[:, :1])
    assert torch.equal(_swizzle(elx), sb ^ (elx & 15))   # d[db ^ i]
    e = dig[:, _swizzle(elx)]                            # [F, V, 16]
    key = ev[r].reshape(F, cols, n)[:, :, elx]           # [F, cols, V, 16]
    regs = (e[:, None] * key % q).sum(0) % q             # [cols, V, 16]
    for bit, by in ((1, 4), (2, 8)):
        turn = (rot & bit) != 0
        regs[:, turn] = torch.roll(regs[:, turn], by, dims=-1)
    res = torch.full((cols, n), -1, dtype=torch.int64)
    _passes(regs, el, rp.inverse[0], inv, q, logn, True)
    res[:, _swizzle(el)] = regs
    for k, ps in enumerate(rp.inverse[1:], 1):
        el = _elements(logn, ps.c)
        regs = res[:, _swizzle(el)]
        _passes(regs, el, ps, inv, q, logn, True)
        if k == len(rp.inverse) - 1:
            regs = regs * pow(n, -1, q) % q
        res[:, _swizzle(el)] = regs
    assert int(res.min()) >= 0
    return res


def _crt(res0, res1, C: int, n: int):
    """The kernel's CRT: word idx = c n + k reads column 2c + limb at the
    swizzled word of k in both exchange buffers."""
    idx = torch.arange(C * n)
    k, c = idx % n, idx // n
    val = torch.zeros(C * n, dtype=torch.int64)
    half, m12 = P0 * P1 // 2, P0 * P1
    for limb in range(2):
        a0 = res0[2 * c + limb, _swizzle(k)]
        a1 = res1[2 * c + limb, _swizzle(k)]
        a0p = torch.where(a0 >= P1, a0 - P1, a0)
        dm = (a1 - a0p) % P1 * pow(P0, -1, P1) % P1
        g = a0 + P0 * dm
        g = torch.where(g > half, g - m12, g)
        val = val + g * (1 << (32 * limb))
    return val.reshape(C, n)


def _emulate(shifts, acc0, ev1, ev2, n: int, w: int):
    steps, B = shifts.shape
    C, l = acc0.shape[1], ev1.shape[2]
    plan = brc._plan(C, l, n)
    out = torch.empty_like(acc0)
    ev = torch.stack([ev1, ev2]).long()
    for b in range(B):
        accs = [acc0[b].clone(), acc0[b].clone()]        # one per block
        for j in range(steps):
            h = int(shifts[j, b])
            res = [_block_step(accs[r], h, ev[:, j], r, C, l, w, plan)
                   for r in range(2)]
            for r in range(2):
                accs[r] = accs[r] + _crt(res[0], res[1], C, n)
        assert torch.equal(accs[0], accs[1])
        out[b] = accs[0]
    return out


def _inputs(rng, steps: int, B: int, C: int, l: int, n: int):
    key = (steps, C, l, C, 2, n)
    ev1 = torch.from_numpy(rng.integers(0, P0, key)).int()
    ev2 = torch.from_numpy(rng.integers(0, P1, key)).int()
    zeros = torch.zeros_like(ev1)              # Shoup planes: plain ignores
    shifts = torch.from_numpy(rng.integers(0, 2 * n, (steps, B))).int()
    i64 = np.iinfo(np.int64)
    acc0 = torch.from_numpy(rng.integers(i64.min, i64.max, (B, C, n),
                                         dtype=np.int64))
    return shifts, acc0, ev1, zeros, ev2, zeros


@pytest.mark.parametrize("logn", [7, 8, 9, 10])
@pytest.mark.parametrize("C,l", SHAPES)
def test_schedule_equals_plain(logn, C, l):
    n, w = 1 << logn, W[l]
    rng = np.random.default_rng(1000 * logn + 10 * C + l)
    shifts, acc0, ev1, ev1s, ev2, ev2s = _inputs(rng, 3, 2, C, l, n)
    want = brc.blind_rotate_plain(shifts, acc0, ev1, ev1s, ev2, ev2s, n, w)
    got = _emulate(shifts, acc0, ev1, ev2, n, w)
    assert torch.equal(got, want)


@pytest.mark.parametrize("logn", BLOCK_DEGREES)
@pytest.mark.parametrize("C,l", SHAPES)
def test_plan_maps_cover_every_word_once(logn, C, l):
    """Every pass loop of the plan reaches each (polynomial, coefficient)
    once; the contraction's virtual threads hold 16 contiguous words; the
    CRT loop's C n words each once; the passes run every stage in order.
    The device-memory layout runs the same maps on one polynomial a block
    (its forward and inverse blocks), at the one-buffer block shape."""
    n = 1 << logn
    plan = brc._plan(C, l, n)
    if plan.layout == "cluster":
        assert (plan.threads, plan.cluster) == (brc.BR_THREADS, 2)
        assert logn in CLUSTER_DEGREES
    else:
        assert (plan.threads, plan.cluster) == (nc._radix_plan(logn).threads,
                                                2)
        plan = plan._replace(forward_polys=1, inverse_polys=1)
    assert plan.threads % 8 == 0 and plan.threads <= 1024
    rp = plan.radix
    assert [p.c + u for p in rp.forward for u in p.stages] == \
        list(range(logn - 1, -1, -1))
    assert [p.c + u for p in rp.inverse for u in p.stages] == list(range(logn))
    for polys, passes in ((plan.forward_polys, rp.forward),
                          (plan.inverse_polys, rp.inverse)):
        for k, ps in enumerate(passes):
            thread, poly, el = _maps(plan, polys, ps.c,
                                     first_inverse=passes is rp.inverse
                                     and k == 0)
            words = (poly[:, None] * n + el).flatten()
            assert torch.equal(torch.sort(words).values,
                               torch.arange(polys * n))
            assert int(thread.max()) < plan.threads
    # forward pass 0 reads the accumulator at element v + (k << c0): lanes
    # on consecutive words
    assert torch.equal(_elements(logn, rp.forward[0].c)[:, 0],
                       torch.arange(n >> 4))
    idx = torch.arange(C * n)
    assert torch.equal(torch.sort(_swizzle(idx % n) + (idx // n) * n).values,
                       idx)


@pytest.mark.parametrize("logn", BLOCK_DEGREES)
def test_plan_fits_a_block_and_stages_the_bench_shape(logn):
    """The cluster layout where a ciphertext's working set fits a block, its
    key planes staged where they fit beside it; elsewhere the device-memory
    layout, one polynomial a block."""
    n = 1 << logn
    for C in (2, 3, 4):
        for l in range(1, 7):
            staged, direct = brc._plan(C, l, n), brc._plan(C, l, n, False)
            assert not direct.staged
            if brc._smem(C, l, n, False) > brc._SMEM_LIMIT:
                assert staged == direct and direct.layout == "device"
                assert direct.smem_bytes == 4 * n <= brc._SMEM_LIMIT
                continue
            assert direct.layout == staged.layout == "cluster"
            assert direct.smem_bytes == brc._smem(C, l, n, False)
            if staged.staged:
                assert staged.smem_bytes <= brc._SMEM_LIMIT
                assert staged.smem_bytes - direct.smem_bytes == \
                    2 * 4 * C * l * 2 * C * n
            else:
                assert staged == direct
            # every buffer starts on 16 bytes (bulk copies, uint4 words)
            assert all(x % 16 == 0 for x in (brc._BARRIER_BYTES, 8 * C * n,
                                             4 * C * l * n, 8 * C * n))
    # the bench's shape: the key planes of a step staged, 208 KB and the
    # mbarriers a block, one block an SM
    bench = brc._plan(2, 2, 1024)
    assert bench.staged and bench.smem_bytes == 208 * 1024 + 32
    assert not brc._plan(2, 2, 1024, aligned=False).staged


def _old_supported(n: int, k: int, beta: int, l: int) -> bool:
    """supported() of the first version (one 1,024-thread block a
    ciphertext): its shared memory held the accumulator, the digits of both
    primes and the columns of both primes."""
    w = beta.bit_length() - 1
    C = k + 1
    return (n & (n - 1) == 0
            and 8 <= n.bit_length() - 1 <= 14
            and beta == (1 << w) and 1 <= w and w * l <= 64
            and beta <= min(P0, P1) and C * l * n * beta < (1 << 26)
            and all((p - 1) % (2 * n) == 0 for p in (P0, P1))
            and C * n * 8 + (2 * C * l + 4 * C) * n * 4 <= 232448)


def test_supported_accepts_every_shape_it_accepted_before():
    more = 0
    for logn in range(7, 16):
        n = 1 << logn
        for k in (1, 2, 3):
            for w in range(1, 14):
                for l in range(1, 9):
                    param = SimpleNamespace(ring=SimpleNamespace(n=n), k=k)
                    old = _old_supported(n, k, 1 << w, l)
                    new = brc.supported(param, 1 << w, l)
                    assert new or not old, (n, k, w, l)
                    more += new and not old
    assert more > 0          # a block now holds one prime's buffers


@pytest.mark.parametrize("logn", CLUSTER_DEGREES)
def test_contraction_reads_hit_distinct_banks(logn):
    """Warp w of the contraction loop runs t = 32 w .. 32 w + 31 (column
    t >> (log n - 4), virtual thread t mod n/16).  Its scalar digit reads
    (every lane the same register slot) touch 32 distinct banks or the same
    word; its 16-byte key reads, 8 lanes at a time, 8 distinct 16-byte bank
    groups or the same chunk.  Without the rotation the key reads would
    conflict 4 ways."""
    n, C, l = 1 << logn, 2, 2
    cols, F = 2 * C, C * l
    V = n >> nc.RADIX_BITS
    elx = _rotated_elements(logn)
    for t0 in range(0, cols * V, 32):
        t = torch.arange(t0, t0 + 32)
        o, v = t // V, t % V
        for ri in range(F):
            for slot in range(16):
                word = ri * n + _swizzle(elx[v, slot])
                assert len(set((word % 32).tolist())) == \
                    len(set(word.tolist()))
            for u in range(4):
                chunk = ((ri * cols + o) * n + elx[v, 4 * u]) // 4
                assert bool((elx[v, 4 * u] % 4 == 0).all())
                for ph in chunk.split(8):
                    assert len(set((ph % 8).tolist())) == len(set(ph.tolist()))
                plain = ((ri * cols + o) * n + 16 * v + 4 * u) // 4
                if V >= 8:
                    assert max(torch.bincount(p % 8).max().item()
                               for p in plain.split(8)) == 4


def test_ptxas_report_reads_bool_template_arguments():
    """K10's instances take a bool (staged), mangled as ``Lb1E``."""
    log = ("ptxas info    : Compiling entry function '_ZN3fhe53_GLOBAL__N__0d"
           "0bfc7c_20_blind_rotate_cuda_cu_0ddb620619blind_rotate_kernelILi10"
           "ELb1EEEvPKiPKyPKjS7_S7_S7_PyS7_S7_S7_S7_S7_iiiiii' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n")
    assert [r["kernel"] for r in _cuda.ptxas_report(log)] == [
        "blind_rotate_kernel<10, 1>"]


def test_phase_counters_fit_the_kernel_source():
    """utils/k10_phases.py finds each of its marks once in K10's source."""
    src = (_cuda.CSRC / "blind_rotate_cuda.cu").read_text()
    out = k10_phases.instrumented_source(src)
    assert out.count("FHE_PHASE(") == len(k10_phases.PHASES) + 1


def test_device_phase_counters_fit_the_layout_source():
    """utils/k10_phases.py --device finds each of its marks once in the
    device-memory layout's unit: the seven phase boundaries and the
    macro."""
    src = (_cuda.CSRC / k10_phases.DM_UNIT).read_text()
    out = k10_phases.dm_instrumented(src)
    assert out.count("FHE_PHASE(") == len(k10_phases.DM_PHASES) + 1
