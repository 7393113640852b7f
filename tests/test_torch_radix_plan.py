"""The pass plan of the register-resident chains that K1 (ntt_multi), K2
(tensor_eval4), K3 (ks_contract), K5 (ext_ntt), K6 (tensor_mul4), K7
(ks_fused), K8 (ks_fused_eval), K9 (ntt) and K12 (ntt_smem_ceiling) run on
the card (csrc/radix_chain.cuh,
mirrored by ops/ntt_cuda.py::_radix_plan), checked on the CPU at every ring
degree each kernel takes (2^7 .. 2^15): every stage is run once and in
order, a block fits the H100 (256 threads and one polynomial, three blocks
an SM, or at n = 2^15 512 threads and one block; or the 512 threads and
three polynomials of K6, K7 and K8, at n = 2^15 one half of each on a
two-block cluster), a torch emulation of the plan's element,
twiddle and
shared-memory maps equals the plain transform bit for bit in
both directions, K1's own maps (its first pass from a row in device memory,
the forward's uint4 read-out and the inverse's stores, each with fin) equal
ntt_multi_plain, K9's (the same on int64 words: 16-byte vectors of two
words, n^-1 on the inverse) equal ntt_plain under a 30-bit and a 31-bit
prime, K12's (reps forward chains through the resident buffer) equals
ntt_smem_ceiling_plain, K3's schedule (the contraction into the first inverse
pass) equals ks_contract_plain, K6's (four forward chains, x0's transform
kept per virtual thread, the products between x1's last forward pass and
the first inverse pass, three inverse chains) equals tensor_mul4_plain with
and without a source basis, K7's and K8's (the digit rows reduced in the
first forward pass, the contraction summed in the last into two
accumulators, K8's add chains, lift and eval-domain store, the first
inverse pass in registers, two inverse chains) equal ks_fused_plain and
ks_fused_eval_plain from 1, 3 and 4 limb rows and with reps >= 2, the
cluster split of n = 2^15 (the first forward stage formed by each block
from both halves of the row, bits log n - 2 .. 0 on its own half under the
split root tables, the last inverse stage from the peer's half) equals the
plain transforms at n = 2^15 and at smaller n under the same split, K6's
schedule on the cluster (over the destination prime a virtual thread's
words of both halves and pass 0 in registers; from a source basis each
block's own half's words, directly or from the lift's rows, and the first
stage across the cluster by pairs; the closing stage by pairs) equals
tensor_mul4_plain, K7's and K8's (a virtual thread's words of both halves
read before the reductions and the top stage, the closing stage by pairs,
half of them a block, straight to the outputs) equal ks_fused_plain and
ks_fused_eval_plain, each at n = 2^15 and 2^9, and every
warp's shared-memory access hits 32 distinct banks.  Also the parser
of ptxas's register report that chip_smoke.py reads.  Tolerance 0
throughout.
"""

import numpy as np
import pytest
import torch

from fhe_study_tpu_torch.ops import _cuda, alu_bench, ext_cuda
from fhe_study_tpu_torch.ops import ntt as ntt_mod
from fhe_study_tpu_torch.ops import ntt_cuda as nc
from fhe_study_tpu_torch.ops.primes import ntt_primes
from fhe_study_tpu_torch.utils import sass_counts

LOGNS = nc.BLOCK_LOGNS                        # one block's chains, and
THREE_LOGNS = nc.BLOCK_LOGNS                  # K6-K8's (a split at 2^15)
PRIMES = ntt_primes(3, 30, 1 << 15)           # 2n-th roots up to n = 2^14
WIDE_PRIMES = ntt_primes(3, 30, 1 << 16)      # and at n = 2^15
CPU = torch.device("cpu")
# the plans the kernels run: K1-K5 on one buffer (256 threads, 512 at
# n = 2^15: max_threads None), K6 on 512 threads and three (at n = 2^15 one
# half a block)
PLANS = {"radix": nc._radix_plan, "tensor_mul4": nc._mul4_plan}


def _primes(logn: int) -> tuple:
    """Three 30-bit primes with 2n-th roots of unity at n = 2^logn."""
    return PRIMES if logn < nc.WIDE_LOGN else WIDE_PRIMES


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
    if logn < nc.WIDE_LOGN:
        # three blocks of 64 KB fit an SM at n = 2^14, at 256 threads of up
        # to 85 registers
        assert plan.threads <= nc.RADIX_THREADS
        assert 3 * (plan.smem_bytes + 1024) <= 233472
        assert 3 * plan.threads <= 2048 and 3 * plan.threads * 85 <= 65536
    else:
        # one block of 128 KB an SM at n = 2^15: 512 threads of up to 128
        # registers, 4 virtual threads each (16 warps an SM, not 8)
        assert (plan.threads, plan.groups) == (nc.WIDE_THREADS, 4)
        assert plan.smem_bytes + 1024 <= 233472
        assert 2 * (plan.smem_bytes + 1024) > 233472
        assert plan.threads * 128 <= 65536


def _run_pass(regs, el, ps, roots, q: int, logn: int, inverse: bool):
    """The stages of one pass on the [..., n/16, 16] registers of every
    virtual thread (el: the elements they hold), in place."""
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
        a, b = regs[..., lo], regs[..., hi]
        if inverse:
            regs[..., lo], regs[..., hi] = (a + b) % q, (a - b) % q * w % q
        else:
            v = b * w % q
            regs[..., lo], regs[..., hi] = (a + v) % q, (a - v) % q


def _lanes_consecutive(addr) -> bool:
    """[virtual threads, 16] word addresses: for each of the 16 accesses the
    lanes of every warp (16 at n = 2^8 and 8 at 2^7, where a block is half
    or a quarter of a warp) touch
    consecutive words (coalesced)."""
    warps = addr.reshape(-1, min(32, addr.shape[0]), 16)
    return bool((warps[:, 1:] - warps[:, :-1] == 1).all())


def _emulate(x, q: int, logn: int, inverse: bool, fin: int = 1,
             first=None, vec: int = 4, roots=None):
    """The kernels' data flow on a row x [..., n] of device memory (the
    leading dimensions: blocks side by side): each pass runs
    its stages on [n/16, 16] registers, passes exchange through a swizzled
    shared-memory buffer.  The forward's first pass reads word
    base + (j << c0) of the row, base = v (K1; K5 converts the same words),
    and its result leaves shared memory as 16-byte rows of ``vec`` words
    (row i: the swizzled words of vec i .. vec i + vec - 1; 4 int32 words,
    or 2 int64 of K9) times fin; the inverse's first pass reads the 16
    contiguous words from base = 16 v in 16-byte vectors (K1, K9; K2 forms
    its products there), and its last pass stores its registers times fin
    to base + (j << c), lanes on consecutive words.  ``first``, where given,
    forms the first pass's [..., n/16, 16] registers from its element
    addresses instead of reading x (K3); ``roots``, where given, is the root table (a split
    row)."""
    n = 1 << logn
    plan = nc._radix_plan(logn)
    if roots is None:
        roots = nc._roots_plain((q,), n, inverse, torch.device("cpu"))[0]
    passes = plan.inverse if inverse else plan.forward
    v = torch.arange(n >> nc.RADIX_BITS)[:, None]
    k = torch.arange(16)[None]
    for i, ps in enumerate(passes):
        el = _elements(logn, ps.c)
        if i == 0:
            addr = 16 * v + k if inverse else v + (k << (logn - 4))
            assert torch.equal(addr, el)
            if inverse:                               # 16-byte vectors
                assert bool((addr[:, ::vec] % vec == 0).all())
            else:
                assert _lanes_consecutive(addr)
            regs = x[..., addr] if first is None else first(addr)
            lead = regs.shape[:-2]
            smem = torch.full((*lead, n), -1, dtype=torch.int64)
            out = torch.full((*lead, n), -1, dtype=torch.int64)
        else:
            regs = smem[..., _swizzle(el)]
        _run_pass(regs, el, ps, roots, q, logn, inverse)
        if inverse and i == len(passes) - 1:
            assert _lanes_consecutive(el)
            out[..., el] = regs * fin % q
        else:
            smem[..., _swizzle(el)] = regs
    if not inverse:
        out = _read_out(smem, n, vec) * fin % q
    assert int(out.min()) >= 0
    return out


def _read_out(smem, n: int, vec: int):
    """The forward's coalesced read-out of a swizzled buffer [..., n]: lane
    i takes the ``vec`` words from vec i (one 16-byte store)."""
    sw = _swizzle(vec * torch.arange(n // vec))
    return torch.stack([smem[..., sw ^ t] for t in range(vec)],
                       dim=-1).reshape(smem.shape)


# The cluster split of K6, K7 and K8 at n = 2^15 (csrc/radix_chain.cuh's
# Split), written out in torch at any n.

def _split_roots(q: int, logn: int, inverse: bool):
    """The root table, the two rows of its split (ops/ntt_cuda.py
    ::_split_index) and the top stage's root, which both rows hold at word
    0."""
    roots = nc._roots_plain((q,), 1 << logn, inverse, CPU)[0]
    rows = roots[torch.from_numpy(nc._split_index(1 << logn))]
    assert torch.equal(rows[:, 0], roots[1].expand(2))
    return roots, rows, int(roots[1])


def _top_forward(row, t: int, q: int, r: int):
    """Block r's half after the forward chain's first stage (bit
    log n - 1), from both halves of the row (split_word)."""
    h = row.shape[-1] // 2
    v = row[..., h:] * t % q
    return (row[..., :h] + v) % q if r == 0 else (row[..., :h] - v) % q


def _top_inverse(lo, hi, t: int, fin: int, q: int):
    """The inverse chain's last stage (bit log n - 1) from the two
    blocks' halves, times fin: block 0 lo + hi, block 1
    (lo - hi) t, each reading the peer's word."""
    return torch.cat([(lo + hi) % q * fin % q,
                      (lo - hi) % q * t % q * fin % q], dim=-1)


def _emulate_split(x, q: int, logn: int, inverse: bool, fin: int = 1):
    """The transform of x [n] on a two-block cluster: each block runs the
    chain of n/2 words (the plan at log n - 1) under its split row."""
    _, rows, t = _split_roots(q, logn, inverse)
    h = (1 << logn) // 2
    if not inverse:
        return torch.cat([
            _emulate(_top_forward(x, t, q, r), q, logn - 1, False, fin,
                     roots=rows[r]) for r in (0, 1)])
    lo, hi = (_emulate(x[r * h:(r + 1) * h], q, logn - 1, True,
                       roots=rows[r]) for r in (0, 1))
    return _top_inverse(lo, hi, t, fin, q)


@pytest.mark.parametrize("logn", (9, nc.WIDE_LOGN))
def test_cluster_split_equals_plain_both_ways(logn):
    """The split at n = 2^15, where K6, K7 and K8 run it, and at n = 2^9
    under the same maps: the forward's first stage from both halves, bits
    log n - 2 .. 0 within each half; the inverse's bits 0 .. log n - 2
    within each half, then the top stage from the peer's half, times fin."""
    n = 1 << logn
    rng = np.random.default_rng(600 + logn)
    for q in _primes(logn)[:2]:
        x = torch.from_numpy(rng.integers(0, q, (1, n)))
        fin = int(rng.integers(1, q))
        assert torch.equal(_emulate_split(x[0], q, logn, False),
                           nc.ntt_multi_plain(x, (q,)).long()[0])
        assert torch.equal(_emulate_split(x[0], q, logn, True, fin),
                           nc.ntt_multi_plain(x, (q,), inverse=True,
                                              fin=(fin,)).long()[0])


def test_split_tables_reorder_each_stage_of_the_roots():
    """Row r of a split table holds, for each stage of the half's chain,
    the roots of that stage that block r's elements take, and word 0 the top
    stage's; each index of the table lies in exactly one row but for 1."""
    for logn in (8, nc.WIDE_LOGN):
        n = 1 << logn
        idx = nc._split_index(n)
        assert idx.shape == (2, n // 2) and (idx[:, 0] == 1).all()
        assert sorted(idx[:, 1:].ravel().tolist()) == list(range(2, n))
        for r in (0, 1):
            for j in range(logn - 1):           # stage bits of the half
                i = np.arange(n // 2)
                assert (idx[r][((n // 2) >> (j + 1)) + (i >> (j + 1))] ==
                        (n >> (j + 1)) + ((r * n // 2 + i) >> (j + 1))).all()
    qs = PRIMES[:2]
    tw = nc._split_twiddles(qs, 512, True, CPU)
    full = nc._twiddles(qs, 512, True, CPU)
    assert tw.shape == (2, 2, 2, 256)
    assert torch.equal(tw, full[:, :, torch.from_numpy(nc._split_index(512))])
    assert nc._chain_twiddles(qs, 512, True, CPU) is full


@pytest.mark.parametrize("logn", LOGNS)
def test_emulated_plan_equals_plain_both_ways(logn):
    n = 1 << logn
    rng = np.random.default_rng(logn)
    for q in _primes(logn):
        x = torch.from_numpy(rng.integers(0, q, (1, n)))
        fwd = nc.ntt_multi_plain(x, (q,)).long()[0]
        assert torch.equal(_emulate(x[0], q, logn, False), fwd)
        inv = nc.ntt_multi_plain(x, (q,), inverse=True, fin=(1,)).long()[0]
        assert torch.equal(_emulate(x[0], q, logn, True), inv)


@pytest.mark.parametrize("logn", LOGNS)
def test_k1_maps_with_fin_equal_plain(logn):
    n = 1 << logn
    rng = np.random.default_rng(100 + logn)
    for q in _primes(logn):
        x = torch.from_numpy(rng.integers(0, q, (1, n)))
        fin = int(rng.integers(1, q))
        for inverse in (False, True):
            want = nc.ntt_multi_plain(x, (q,), inverse=inverse,
                                      fin=(fin,)).long()[0]
            assert torch.equal(_emulate(x[0], q, logn, inverse, fin), want)


# K9's primes: the TFHE pair's 30-bit one and the CRT pair's 31-bit one
K9_PRIMES = (ntt_mod.CRT_PRIMES_TFHE[0], ntt_mod.CRT_PRIMES[0])


@pytest.mark.parametrize("logn", LOGNS)
def test_k9_schedule_equals_plain(logn):
    """K9: K1's schedule on int64 words, 2 a 16-byte vector (the inverse's
    first pass, the forward's read-out), the inverse with n^-1, the
    forward without fin; and its read-out hits 32 distinct banks."""
    n = 1 << logn
    rng = np.random.default_rng(600 + logn)
    assert [q.bit_length() for q in K9_PRIMES] == [30, 31]
    for q in K9_PRIMES:
        x = torch.from_numpy(rng.integers(0, q, n))
        assert torch.equal(_emulate(x, q, logn, False, vec=2),
                           nc.ntt_plain(x, q))
        assert torch.equal(_emulate(x, q, logn, True, pow(n, -1, q), vec=2),
                           nc.ntt_plain(x, q, inverse=True))
    lanes = _swizzle(2 * torch.arange(n // 2)).reshape(-1, min(32, n // 2))
    assert _banks_hit(lanes) == 1 and _banks_hit(lanes ^ 1) == 1


def test_k9_plan_at_n_128():
    """K9 alone takes n = 2^7 (the reference's ntt_u32 takes it): 8 threads
    of 16 words, one group, two passes each way (4 and 3 stages), 512
    bytes of shared memory; its schedule on int64 words equals ntt_plain
    under both primes, and so does the 65537 of the graft entry."""
    plan = nc._radix_plan(7)
    assert (plan.threads, plan.groups, plan.smem_bytes) == (8, 1, 512)
    assert [p.stages for p in plan.forward] == [(3, 2, 1, 0), (2, 1, 0)]
    assert [p.c for p in plan.forward] == [3, 0]
    assert [p.c for p in plan.inverse] == [0, 3]
    assert _stage_bits(plan.forward) == list(range(6, -1, -1))
    assert _stage_bits(plan.inverse) == list(range(7))
    rng = np.random.default_rng(607)
    for q in K9_PRIMES + (2 ** 16 + 1,):
        x = torch.from_numpy(rng.integers(0, q, 128))
        assert torch.equal(_emulate(x, q, 7, False, vec=2),
                           nc.ntt_plain(x, q))
        assert torch.equal(_emulate(x, q, 7, True, pow(128, -1, q), vec=2),
                           nc.ntt_plain(x, q, inverse=True))
    sw = _swizzle(torch.arange(128))
    assert torch.equal(torch.sort(sw).values, torch.arange(128))


def _emulate_k12(x, q: int, logn: int, reps: int):
    """K12's data flow on one row x: loaded into the swizzled buffer word by
    word, ``reps`` forward chains through it (every pass from shared memory
    back to it), then K1's uint4 read-out."""
    n = 1 << logn
    plan = nc._radix_plan(logn)
    roots = nc._roots_plain((q,), n, False, CPU)[0]
    smem = torch.full((1, n), -1, dtype=torch.int64)
    smem[0][_swizzle(torch.arange(n))] = x
    for _ in range(reps):
        _through_smem(smem, [0], plan.forward, roots, q, logn, False)
    return _read_out(smem[0], n, 4)


@pytest.mark.parametrize("logn", LOGNS)
def test_k12_schedule_equals_plain(logn):
    n = 1 << logn
    rng = np.random.default_rng(700 + logn)
    q = _primes(logn)[logn % len(PRIMES)]
    x = torch.from_numpy(rng.integers(0, q, (1, n)))
    for reps in (0, 1, 3):
        want = alu_bench.ntt_smem_ceiling_plain(x.int(), q, reps)[0]
        assert torch.equal(_emulate_k12(x[0], q, logn, reps), want.long())


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


@pytest.mark.parametrize("logn", THREE_LOGNS)
def test_tensor_mul4_plan_covers_every_stage_and_fits_an_sm(logn):
    """K6's plan: the same passes on 512 threads, three buffers, one block
    an SM (512 threads of up to 128 registers, 192 KB at n = 2^14); at
    n = 2^15 each block of the split runs the plan of its half, the top
    stage aside (192 KB again)."""
    plan = nc._mul4_plan(logn)
    if logn == nc.WIDE_LOGN:
        assert plan == nc._mul4_plan(logn - 1)
        # beside the buffers, x0's transform for the second group of
        # virtual threads (K6 keeps the first in registers): 224 KB
        side = nc._mul4_plan(logn, side=True)
        assert side.smem_bytes - plan.smem_bytes == 4 * 16 * plan.threads
        assert plan.groups == 2 and side.smem_bytes == 229376 <= 232448
        logn -= 1
    else:
        assert nc._mul4_plan(logn, side=True) == plan
    assert _stage_bits(plan.forward) == list(range(logn - 1, -1, -1))
    assert _stage_bits(plan.inverse) == list(range(logn))
    assert (plan.forward, plan.inverse) == (nc._radix_plan(logn).forward,
                                            nc._radix_plan(logn).inverse)
    assert plan.threads == min(nc.MUL4_THREADS, 1 << (logn - 4))
    assert plan.threads * plan.groups << nc.RADIX_BITS == 1 << logn
    assert plan.smem_bytes == nc.MUL4_BUFFERS * 4 << logn
    assert plan.smem_bytes + 1024 <= 233472 and plan.threads * 128 <= 65536
    # the forward chain's last pass and the inverse chain's first hold the
    # same bits, so a virtual thread owns the same elements in both
    assert plan.forward[-1].c == plan.inverse[0].c == 0


@pytest.mark.parametrize(
    "logn,kind", [(logn, kind) for kind in PLANS
                  for logn in (LOGNS if kind == "radix" else THREE_LOGNS)],
    ids=lambda v: str(v))
def test_warps_of_each_thread_count_hit_distinct_banks(logn, kind):
    """Warp w of group g runs virtual threads g * threads + 32 w .. + 31."""
    plan = PLANS[kind](logn)
    for ps in plan.forward + plan.inverse:
        el = _elements(plan.logn, ps.c)
        for g in range(plan.groups):
            for lane0 in range(0, plan.threads, 32):
                vt = g * plan.threads + torch.arange(
                    lane0, min(lane0 + 32, plan.threads))
                assert _banks_hit(_swizzle(el[vt]).T) == 1


def _mont(a, b, q: int):
    """The kernels' Montgomery product a * b * 2^-32 mod q, exactly."""
    return a * b % q * pow(1 << 32, -1, q) % q


@pytest.mark.parametrize("logn", LOGNS)
def test_k3_schedule_equals_plain(logn):
    """K3: the R Montgomery products of each digit and key row summed into
    the first inverse pass's registers (16 contiguous words a virtual
    thread), the rest of the chain as K2's, n^-1 in the last pass."""
    n = 1 << logn
    rng = np.random.default_rng(200 + logn)
    for q, R in zip(_primes(logn), (1, 4, 3)):
        edm = torch.from_numpy(rng.integers(0, q, (R, n)))
        keys = [torch.from_numpy(rng.integers(0, q, (R, n)))
                for _ in range(2)]
        want = nc.ks_contract_plain(edm[:, None, None].int(),
                                    keys[0][:, None].int(),
                                    keys[1][:, None].int(), (q,))
        for key, half in zip(keys, want):
            def contract(addr, key=key):
                acc = torch.zeros_like(addr)
                for r in range(R):
                    acc = (acc + _mont(edm[r][addr], key[r][addr], q)) % q
                return acc
            got = _emulate(None, q, logn, True, pow(n, -1, q), first=contract)
            assert torch.equal(got, half[0, 0].long())


def _run_regs(regs, ps, roots, q: int, logn: int, inverse: bool):
    """One pass on [polynomials, virtual threads, 16] registers."""
    for r in regs:
        _run_pass(r, _elements(logn, ps.c), ps, roots, q, logn, inverse)


def _through_smem(smem, bufs, passes, roots, q: int, logn: int,
                  inverse: bool):
    """Passes from the swizzled buffers ``bufs`` of smem through registers
    back to the same words, each buffer in turn."""
    for ps in passes:
        sw = _swizzle(_elements(logn, ps.c))
        regs = torch.stack([smem[b][sw] for b in bufs])
        _run_regs(regs, ps, roots, q, logn, inverse)
        for b, r in zip(bufs, regs):
            smem[b][sw] = r


def _emulate_k6(x0, x1, y0, y1, q: int, logn: int, fin: int):
    """K6's data flow on four operand rows over q (a source basis converted
    word by word as the first pass reads it), three shared-memory buffers:
    y0, y1, x0 forward into buffers 0, 1, 2, one after another; each virtual
    thread takes its own words of x0's transform into registers; x1 forward
    in buffer 2 but for its last pass, which forms x1 y1, x0 y1 + x1 y0 and
    x0 y0 in registers from x1, x0 and its own words of buffers 0 and 1, runs
    the first inverse pass on each and stores it into buffer 2, 1, 0 at the
    same words; the rest of the three inverse chains, the last pass times
    fin, lanes on consecutive words."""
    n = 1 << logn
    plan = nc._mul4_plan(logn)
    fwd, inv = (nc._roots_plain((q,), n, inv, CPU)[0]
                for inv in (False, True))
    smem = torch.full((nc.MUL4_BUFFERS, n), -1, dtype=torch.int64)
    v = torch.arange(n >> nc.RADIX_BITS)[:, None]
    first = v + (torch.arange(16)[None] << (logn - 4))
    f0, fl, i0, il = (plan.forward[0], plan.forward[-1], plan.inverse[0],
                      plan.inverse[-1])

    def run(regs, ps, roots, inverse):
        _run_regs(regs, ps, roots, q, logn, inverse)

    def through_smem(bufs, passes, roots, inverse):
        _through_smem(smem, bufs, passes, roots, q, logn, inverse)

    def forward_head(row, buf):
        """First pass from the row in device memory, then the passes through
        shared memory but the last."""
        regs = row[first][None]
        run(regs, f0, fwd, False)
        smem[buf][_swizzle(first)] = regs[0]
        through_smem([buf], plan.forward[1:-1], fwd, False)

    assert torch.equal(first, _elements(logn, f0.c))
    assert _lanes_consecutive(first)
    for row, buf in ((y0, 0), (y1, 1), (x0, 2)):
        forward_head(row, buf)
        through_smem([buf], [fl], fwd, False)
    own = _elements(logn, fl.c)
    assert fl.c == i0.c == 0 and torch.equal(own, 16 * v + torch.arange(16))
    sw = _swizzle(own)
    x0e = smem[2][sw].clone()                 # per virtual thread
    smem[2].fill_(-1)                         # x0 never goes back
    forward_head(x1, 2)
    x = smem[2][sw][None]
    run(x, fl, fwd, False)
    u0, u1 = smem[0][sw], smem[1][sw]
    prods = torch.stack([_mont(x0e, u0, q),
                         (_mont(x0e, u1, q) + _mont(x[0], u0, q)) % q,
                         _mont(x[0], u1, q)])
    run(prods, i0, inv, True)
    for b in range(3):
        smem[b][sw] = prods[b]
    through_smem([0, 1, 2], plan.inverse[1:-1], inv, True)
    el = _elements(logn, il.c)
    assert _lanes_consecutive(el)
    regs = torch.stack([smem[b][_swizzle(el)] for b in range(3)])
    run(regs, il, inv, True)
    out = torch.full((3, n), -1, dtype=torch.int64)
    for b in range(3):
        out[b][el] = regs[b] * fin % q
    assert int(out.min()) >= 0
    return out


def _emulate_k6_cluster(ops, q: int, logn: int, fin: int, convert=None):
    """K6 for one (prime, polynomial) on a two-block cluster, as
    tensor_mul4_kernel's split instance runs it at n = 2^15 (and here at any
    n): block r holds half r of the three buffers and runs the chains of
    n/2 words under row r of the split tables, the operands in the kernel's
    order y0, y1, x0, x1.  Over the destination prime (convert None, ops the
    four rows [n] over q) each operand's first pass (split_words) reads a
    virtual thread's 16 words of both halves of the row, forms block r's
    half of the top stage and runs pass 0 in registers.  From a source
    basis (ops the four operands' rows [.., n] as the kernel reads them,
    convert(rows) their words over q: the conversion from 4 source rows, or
    the sums from the lift's rows) block r converts only the words of its
    own half, r h + i, 16 a thread with lanes on consecutive words, into its
    buffer; then the top stage by pairs across the cluster (block r takes
    the pairs i in [r h/2, (r + 1) h/2), its own word and the peer's, and
    writes both), and the chain of the half from pass 0 in shared memory.
    Then K6's schedule on each half (_emulate_k6): x0's words into
    registers before x1 enters buffer 2, x1's last pass forming the three
    products and the first inverse pass; the inverse chains to their end in
    shared memory, and the closing stage by pairs (split_inverse_out): block
    r takes the pairs i in [r h/2, (r + 1) h/2) of each product and writes
    elements i and h + i, times fin."""
    n = 1 << logn
    h, hl = n // 2, logn - 1
    plan = nc._radix_plan(hl, nc.MUL4_THREADS, nc.MUL4_BUFFERS)
    assert plan == nc._mul4_plan(logn) or logn != nc.WIDE_LOGN
    _, fwd, t = _split_roots(q, logn, False)
    _, inv, ti = _split_roots(q, logn, True)
    f0, fl, i0 = plan.forward[0], plan.forward[-1], plan.inverse[0]
    v = torch.arange(h >> nc.RADIX_BITS)[:, None]
    first = v + (torch.arange(16)[None] << f0.c)
    assert torch.equal(first, _elements(hl, f0.c))
    assert _lanes_consecutive(first)
    own = _elements(hl, fl.c)
    assert fl.c == i0.c == 0 and torch.equal(own, 16 * v + torch.arange(16))
    sw = _swizzle(own)
    # the own half's words a thread converts: i0 + 16 j threads + m threads
    runs = torch.arange(0, h, 16 * plan.threads)[:, None, None]
    words = (runs + torch.arange(plan.threads)[None, :, None]
             + plan.threads * torch.arange(16)[None, None, :])
    assert torch.equal(torch.sort(words.flatten()).values, torch.arange(h))
    assert _lanes_consecutive(words.reshape(-1, 16))
    smem = torch.full((2, nc.MUL4_BUFFERS, h), -1, dtype=torch.int64)
    x0e = [None, None]
    for k, row in enumerate(ops):
        buf = min(k, 2)
        if k == 3:                            # x0 leaves buffer 2
            for r in (0, 1):
                x0e[r] = smem[r][2][sw].clone()
                smem[r][2].fill_(-1)
        if convert is None:
            for r in (0, 1):
                lo, hi = row[first], row[h + first]
                x = hi * t % q
                x = (lo + x) % q if r == 0 else (lo - x) % q
                _run_pass(x, first, f0, fwd[r], q, hl, False)
                smem[r][buf][_swizzle(first)] = x
            passes = plan.forward[1:-1]
        else:
            for r in (0, 1):
                half = convert(row[..., r * h:(r + 1) * h])
                smem[r][buf][_swizzle(words)] = half[words]
            for r in (0, 1):                  # block r's pairs, in place
                i = _swizzle(torch.arange(r * h // 2, (r + 1) * h // 2))
                a, b = smem[0][buf][i], smem[1][buf][i] * t % q
                smem[0][buf][i], smem[1][buf][i] = (a + b) % q, (a - b) % q
            passes = plan.forward[:-1]
        for r in (0, 1):
            _through_smem(smem[r], [buf], passes, fwd[r], q, hl, False)
            if k < 3:
                _through_smem(smem[r], [buf], [fl], fwd[r], q, hl, False)
    for r in (0, 1):
        x = smem[r][2][sw][None]
        _run_regs(x, fl, fwd[r], q, hl, False)
        u0, u1 = smem[r][0][sw], smem[r][1][sw]
        prods = torch.stack([_mont(x0e[r], u0, q),
                             (_mont(x0e[r], u1, q) + _mont(x[0], u0, q)) % q,
                             _mont(x[0], u1, q)])
        _run_regs(prods, i0, inv[r], q, hl, True)
        for b in range(3):
            smem[r][b][sw] = prods[b]
        _through_smem(smem[r], [0, 1, 2], plan.inverse[1:], inv[r], q, hl,
                      True)
    out = torch.full((3, n), -1, dtype=torch.int64)
    for r in (0, 1):
        i = torch.arange(r * h // 2, (r + 1) * h // 2)
        for b in range(3):
            mine = smem[r][b][_swizzle(i)]
            other = smem[r ^ 1][b][_swizzle(i)]
            x0, x1 = (other, mine) if r else (mine, other)
            out[b][i] = (x0 + x1) % q * fin % q
            out[b][h + i] = (x0 - x1) % q * ti % q * fin % q
    assert int(out.min()) >= 0
    return out


def _k6(logn: int, ops, q: int, fin: int, convert=None, split=None):
    """K6's schedule at n = 2^logn on the operand rows x0, x1, y0, y1
    (converted by ``convert`` where given): the cluster's at 2^15, or
    wherever ``split`` says so."""
    x0, x1, y0, y1 = ops
    if logn == nc.WIDE_LOGN if split is None else split:
        return _emulate_k6_cluster((y0, y1, x0, x1), q, logn, fin, convert)
    return _emulate_k6(*(o if convert is None else convert(o) for o in ops),
                       q, logn, fin)


def _converts(src: tuple, q: int) -> dict:
    """The two ways K6 forms an operand's words over q from its source rows
    [Ls, n]: (the rows the kernel reads, the conversion of any slice of
    them).  Direct (4 sources): each word converted from the source rows;
    staged: the lift's rows (ext_lift: the y_i, then alpha), each word's sum
    formed from them."""
    def direct(rows):
        return ext_cuda.base_extend_fused_plain(rows.int(), src,
                                                (q,))[0].long()

    def lift(rows):
        ys, alpha = ext_cuda.lift_plain(rows, src)
        return torch.cat([ys, alpha[None]])

    def staged(rows):
        return ext_cuda.base_extend_sum_plain(rows[:-1], rows[-1], src,
                                              (q,))[0].long()
    return {"direct": (lambda rows: rows, direct), "staged": (lift, staged)}


SRC_PRIMES = ntt_primes(5, 30, 1 << 16, skip=len(WIDE_PRIMES))


def _k6_cases(rng, logn: int, q: int, split=None):
    """(label, K6's schedule, tensor_mul4_plain) over q and from source
    bases of 4 primes (the direct instance) and of 1 + log n mod 5 (staged:
    the same words from the lift's rows), under a random scale."""
    n = 1 << logn
    scale = int(rng.integers(1, 1 << 16))
    fin = nc._tensor_fin((q,), n, (scale,))[0]
    ops = [torch.from_numpy(rng.integers(0, q, (1, n))) for _ in range(4)]
    want = nc.tensor_mul4_plain(*(o.int() for o in ops), (q,),
                                scale=(scale,))[0]
    got = _k6(logn, [o[0] for o in ops], q, fin, split=split)
    yield "over q", got, want
    for ls in (4, 1 + logn % 5):
        src = SRC_PRIMES[:ls]
        rows = [torch.from_numpy(np.stack([rng.integers(0, s, n)
                                           for s in src])).int()
                for _ in range(4)]
        want = nc.tensor_mul4_plain(*rows, (q,), scale=(scale,), src=src)[0]
        form = "direct" if ls == 4 else "staged"
        read, convert = _converts(src, q)[form]
        got = _k6(logn, [read(r) for r in rows], q, fin, convert, split)
        yield f"{form} from {ls}", got, want


@pytest.mark.parametrize("logn", THREE_LOGNS)
def test_k6_schedule_equals_plain(logn):
    """Over the destination prime, and from source bases of 4 primes (the
    BFV P basis's direct instance) and of 1 + log n mod 5 (the staged
    layout, the same words from the lift's rows); at n = 2^15 the
    cluster's schedule."""
    rng = np.random.default_rng(300 + logn)
    q = _primes(logn)[logn % 3]
    for label, got, want in _k6_cases(rng, logn, q):
        assert torch.equal(got, want.long()), label


@pytest.mark.parametrize("logn", (9, nc.WIDE_LOGN))
def test_k6_cluster_schedule_equals_plain(logn):
    """K6's schedule on the cluster of n = 2^15, at 2^15 and at n = 2^9
    split the same way, under another prime and scale: over the
    destination prime (both halves' words in the first pass, pass 0 in
    registers), from 4 sources and staged from 1 + log n mod 5 (each block
    its own half's words, the top stage across the cluster by pairs), the
    closing stage by pairs."""
    rng = np.random.default_rng(800 + logn)
    q = WIDE_PRIMES[(logn + 1) % 3]
    for label, got, want in _k6_cases(rng, logn, q, split=True):
        assert torch.equal(got, want.long()), label


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


def test_ptxas_report_reads_negative_template_arguments():
    """K6's instance without a source basis has LS = -1, which the Itanium
    ABI mangles as ``Lin1E``."""
    log = ("ptxas info    : Compiling entry function '_ZN3fhe12_GLOBAL__N_118"
           "tensor_mul4_kernelILi14ELin1EEEvPKjS3_S3_S3_NS_7StridesEPjS3_S3_"
           "S3_S3_S3_S3_iii' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n")
    assert [r["kernel"] for r in _cuda.ptxas_report(log)] == [
        "tensor_mul4_kernel<14, -1>"]


def test_ceiling_loop_counts_read_from_sass():
    """sass_counts.ceiling_loops counts the global loads and barriers of the
    longest loop of each ntt_smem_ceiling_kernel (one outside it, a shorter
    loop beside it); at n = 2^8 one forward transform holds 20 loads (two
    passes of four stages: 2 x (2 + 1 + 1 + 1) each) and 2 barriers."""
    lines = ["        Function : _ZN3fhe12_GLOBAL__N_123ntt_smem_ceiling_"
             "kernelILi8EEEvPKjPjS3_S3_ji",
             "        /*0000*/                   LDG.E R2, desc[UR4][R2.64] ;",
             "        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;",
             "        /*0020*/              @P0 BRA 0x10 ;"]
    loop = (["LDG.E.128.CONSTANT R4, desc[UR4][R6.64]"] * 20
            + ["BAR.SYNC.DEFER_BLOCKING 0x0"] * 2 + ["IADD3 R8, R8, 0x1, RZ"])
    for i, ins in enumerate(loop):
        lines.append(f"        /*{0x30 + 16 * i:04x}*/                   "
                     f"{ins} ;")
    lines.append(f"        /*{0x30 + 16 * len(loop):04x}*/              "
                 f"@P1 BRA 0x30 ;")
    got = sass_counts.ceiling_loops("\n".join(lines) + "\n")
    assert got == {8: (20, 2)} == {8: sass_counts.chain_loads(8)}
    assert sass_counts.chain_loads(14) == (36, 4)


def _emulate_ks(limbs, keys, q: int, logn: int, reps: int, fin: int,
                adds=None, lift: int = 0, roots=None):
    """K7's data flow (adds None) or K8's for one (prime, polynomial), three
    shared-memory buffers (work, acc_0, acc_1): each digit row r of limbs
    [R, n] forward in the work buffer, its first pass read from the limb
    (lanes on consecutive words) with ``reps`` conditional subtractions;
    its last pass (the 16 contiguous words of a virtual thread) forms the
    Montgomery products with keys[h][r] and adds them into acc_h at the same
    words (row 0 writes them: the buffers start unwritten, -1).  K7 runs the
    first inverse pass on the last row's sums in registers.  K8 then runs
    adds[h] forward in the work buffer, and its last pass forms e_h = acc_h *
    lift + NTT(add_h), stores it to the eval-domain output and runs the first
    inverse pass on it in registers into acc_h.  Then the rest of the two
    inverse chains, the last pass times fin, lanes on consecutive words.
    Returns [2, n] (K7) or [4, n] (K8: e_0, e_1, then the two inverses).
    ``roots``, where given, is the pair of (forward, inverse) root tables
    (the rows of a split)."""
    n = 1 << logn
    R = limbs.shape[0]
    plan = nc._mul4_plan(logn)
    fwd, inv = roots or (nc._roots_plain((q,), n, inv, CPU)[0]
                         for inv in (False, True))
    smem = torch.full((nc.MUL4_BUFFERS, n), -1, dtype=torch.int64)
    v = torch.arange(n >> nc.RADIX_BITS)[:, None]
    first = v + (torch.arange(16)[None] << (logn - 4))
    f0, fl, i0, il = (plan.forward[0], plan.forward[-1], plan.inverse[0],
                      plan.inverse[-1])
    assert torch.equal(first, _elements(logn, f0.c))
    assert _lanes_consecutive(first)
    own = _elements(logn, fl.c)
    assert fl.c == i0.c == 0 and torch.equal(own, 16 * v + torch.arange(16))
    sw = _swizzle(own)
    # uint4 words of the key rows and of the eval-domain stores
    assert bool((own[:, ::4] % 4 == 0).all())
    evals = torch.full((2, n), -1, dtype=torch.int64)
    rows = [(limbs[r], reps) for r in range(R)]
    rows += [] if adds is None else [(a, 0) for a in adds]
    for k, (row, subs) in enumerate(rows):
        regs = row[first].clone()
        for _ in range(subs):
            regs = torch.where(regs >= q, regs - q, regs)
        _run_pass(regs, first, f0, fwd, q, logn, False)
        smem[0][_swizzle(first)] = regs
        _through_smem(smem, [0], plan.forward[1:-1], fwd, q, logn, False)
        x = smem[0][sw].clone()
        _run_pass(x, own, fl, fwd, q, logn, False)
        smem[0].fill_(-1)                     # the next row overwrites it
        digit = k < R
        in_regs = k == R - 1 if adds is None else not digit
        for h in (0, 1) if digit else (k - R,):
            if digit:
                y = _mont(x, keys[h][k][own], q)
                if k > 0:
                    y = (y + smem[1 + h][sw]) % q
            else:
                y = (smem[1 + h][sw] * lift % q + x) % q
                evals[h][own] = y
            if in_regs:
                _run_pass(y, own, i0, inv, q, logn, True)
            assert int(y.min()) >= 0
            smem[1 + h][sw] = y
    _through_smem(smem, [1, 2], plan.inverse[1:-1], inv, q, logn, True)
    el = _elements(logn, il.c)
    assert _lanes_consecutive(el)
    out = torch.full((2, n), -1, dtype=torch.int64)
    for h in range(2):
        regs = smem[1 + h][_swizzle(el)]
        _run_pass(regs, el, il, inv, q, logn, True)
        out[h][el] = regs * fin % q
    assert int(out.min()) >= 0
    return out if adds is None else torch.cat([evals, out])


def _emulate_ks_cluster(limbs, keys, q: int, logn: int, reps: int,
                        fin: int, adds=None, lift: int = 0):
    """K7 (adds None) or K8 for one (prime, polynomial) on a two-block
    cluster, as ks_body's split instance runs it at n = 2^15 (and here at
    any n): block r holds half r of the three buffers and runs the chains
    of n/2 words under row r of the split tables.  Each row's first pass
    (split_words) reads a virtual thread's 16 words of both halves of the
    row, makes the reductions on all 32, then forms block r's half of the
    top stage and pass 0; the last pass multiplies by row k's key words of
    half r into the accumulators; K8's add rows as _emulate_ks, the
    eval-domain rows written by half.  After the rows
    each block runs its inverse chains to the end in shared memory, and the
    closing stage (split_inverse_out) gives block r the pairs i in
    [r h/2, (r + 1) h/2): its own word and the peer's of both halves, and
    it writes elements i and h + i of each output, times fin."""
    n = 1 << logn
    h, hl = n // 2, logn - 1
    R = limbs.shape[0]
    plan = nc._radix_plan(hl, nc.MUL4_THREADS, nc.MUL4_BUFFERS)
    assert plan == nc._mul4_plan(logn) or logn != nc.WIDE_LOGN
    _, fwd, t = _split_roots(q, logn, False)
    _, inv, ti = _split_roots(q, logn, True)
    f0, fl, i0 = plan.forward[0], plan.forward[-1], plan.inverse[0]
    v = torch.arange(h >> nc.RADIX_BITS)[:, None]
    first = v + (torch.arange(16)[None] << f0.c)
    assert torch.equal(first, _elements(hl, f0.c))
    own = _elements(hl, fl.c)
    sw = _swizzle(own)
    smem = torch.full((2, nc.MUL4_BUFFERS, h), -1, dtype=torch.int64)
    evals = torch.full((2, n), -1, dtype=torch.int64)
    rows = [(limbs[k], reps) for k in range(R)]
    rows += [] if adds is None else [(a, 0) for a in adds]
    for k, (row, subs) in enumerate(rows):
        digit = k < R
        in_regs = k == R - 1 if adds is None else not digit
        for r in (0, 1):
            lo, hi = row[first].clone(), row[h + first].clone()
            for _ in range(subs):
                lo = torch.where(lo >= q, lo - q, lo)
                hi = torch.where(hi >= q, hi - q, hi)
            x = hi * t % q
            x = (lo + x) % q if r == 0 else (lo - x) % q
            _run_pass(x, first, f0, fwd[r], q, hl, False)
            smem[r][0][_swizzle(first)] = x
            _through_smem(smem[r], [0], plan.forward[1:-1], fwd[r], q, hl,
                          False)
            x = smem[r][0][sw].clone()
            _run_pass(x, own, fl, fwd[r], q, hl, False)
            smem[r][0].fill_(-1)              # the next row overwrites it
            for hh in (0, 1) if digit else (k - R,):
                if digit:
                    y = _mont(x, keys[hh][k][r * h + own], q)
                    if k > 0:
                        y = (y + smem[r][1 + hh][sw]) % q
                else:
                    y = (smem[r][1 + hh][sw] * lift % q + x) % q
                    evals[hh][r * h + own] = y
                if in_regs:
                    _run_pass(y, own, i0, inv[r], q, hl, True)
                assert int(y.min()) >= 0
                smem[r][1 + hh][sw] = y
    for r in (0, 1):
        _through_smem(smem[r], [1, 2], plan.inverse[1:], inv[r], q, hl, True)
    out = torch.full((2, n), -1, dtype=torch.int64)
    for r in (0, 1):
        i = torch.arange(r * h // 2, (r + 1) * h // 2)
        for hh in (0, 1):
            mine = smem[r][1 + hh][_swizzle(i)]
            other = smem[r ^ 1][1 + hh][_swizzle(i)]
            x0, x1 = (other, mine) if r else (mine, other)
            out[hh][i] = (x0 + x1) % q * fin % q
            out[hh][h + i] = (x0 - x1) % q * ti % q * fin % q
    assert int(out.min()) >= 0
    return out if adds is None else torch.cat([evals, out])


def _ks(logn: int):
    return _emulate_ks_cluster if logn == nc.WIDE_LOGN else _emulate_ks


# a destination prime of 26 bits against 30-bit source primes: reps >= 2
NARROW = ntt_primes(1, 26, 1 << 16)[0]


def _ks_inputs(rng, logn: int, q: int, R: int, wide: bool):
    """Limb rows [R, n] over SRC_PRIMES (wide) or below q, and the keys
    [2, R, n] over q."""
    n = 1 << logn
    bound = max(SRC_PRIMES) if wide else q
    limbs = torch.from_numpy(rng.integers(0, bound, (R, n)))
    keys = torch.from_numpy(rng.integers(0, q, (2, R, n)))
    return limbs, keys, (SRC_PRIMES if wide else (q,))


# (prime, R, wide source primes): R = 1, 3 and 4, one case with reps >= 2
KS_CASES = ((WIDE_PRIMES[0], 1, False), (WIDE_PRIMES[1], 3, False),
            (NARROW, 4, True))


@pytest.mark.parametrize("logn", THREE_LOGNS)
def test_k7_schedule_equals_plain(logn):
    n = 1 << logn
    rng = np.random.default_rng(400 + logn)
    for q, R, wide in KS_CASES:
        limbs, keys, src = _ks_inputs(rng, logn, q, R, wide)
        reps = nc.digit_reps((q,), src)
        assert reps >= 2 or not wide
        want = nc.ks_fused_plain(limbs[:, None].int(), keys[0][:, None].int(),
                                 keys[1][:, None].int(), (q,), src)
        fin = nc._tensor_fin((q,), n, None)[0]
        got = _ks(logn)(limbs, keys, q, logn, reps, fin)
        assert torch.equal(got, torch.stack([w[0, 0] for w in want]).long())


@pytest.mark.parametrize("logn", THREE_LOGNS)
def test_k8_schedule_equals_plain(logn):
    n = 1 << logn
    rng = np.random.default_rng(500 + logn)
    for q, R, wide in KS_CASES:
        limbs, keys, src = _ks_inputs(rng, logn, q, R, wide)
        adds = torch.from_numpy(rng.integers(0, q, (2, n)))
        reps = nc.digit_reps((q,), src)
        want = nc.ks_fused_eval_plain(
            limbs[:, None].int(), keys[0][:, None].int(),
            keys[1][:, None].int(), (q,), src,
            tuple(a[None].int() for a in adds))
        got = _ks(logn)(limbs, keys, q, logn, reps, pow(n, -1, q), adds,
                        (1 << 32) % q)
        assert torch.equal(got, torch.stack([w[0, 0] for w in want]).long())


# K7 and K8 on the cluster schedule of n = 2^15 from R = 1
# and 3 limb rows, the second with reps >= 2, at 2^15 and at n = 2^9 split
# the same way
KS_CLUSTER_CASES = ((WIDE_PRIMES[2], 1, False), (NARROW, 3, True))


@pytest.mark.parametrize("logn", (9, nc.WIDE_LOGN))
@pytest.mark.parametrize("evalf", (False, True), ids=("k7", "k8"))
def test_ks_cluster_schedule_equals_plain(logn, evalf):
    n = 1 << logn
    rng = np.random.default_rng(700 + logn + 50 * evalf)
    for q, R, wide in KS_CLUSTER_CASES:
        limbs, keys, src = _ks_inputs(rng, logn, q, R, wide)
        reps = nc.digit_reps((q,), src)
        assert reps >= 2 or not wide
        kb, ka = (k[:, None].int() for k in keys)
        if evalf:
            adds = torch.from_numpy(rng.integers(0, q, (2, n)))
            want = nc.ks_fused_eval_plain(limbs[:, None].int(), kb, ka, (q,),
                                          src, tuple(a[None].int()
                                                     for a in adds))
            got = _emulate_ks_cluster(limbs, keys, q, logn, reps,
                                      pow(n, -1, q), adds, (1 << 32) % q)
        else:
            want = nc.ks_fused_plain(limbs[:, None].int(), kb, ka, (q,), src)
            got = _emulate_ks_cluster(limbs, keys, q, logn, reps,
                                      nc._tensor_fin((q,), n, None)[0])
        assert torch.equal(got, torch.stack([w[0, 0] for w in want]).long())


@pytest.mark.parametrize("logn", THREE_LOGNS)
def test_ks_fused_plan_fits_an_sm(logn):
    """K7 and K8 run K6's plan: 512 threads of up to 128 registers and three
    buffers in the 227 KB a block may take, at every log n (at n = 2^15 one
    half of each buffer in each block of the split)."""
    plan = nc._mul4_plan(logn)
    held = logn - (logn == nc.WIDE_LOGN)      # the words a block holds
    assert plan.logn == held and plan.smem_bytes == 3 * 4 << held
    assert plan.smem_bytes <= 232448 and plan.threads * 128 <= 65536
    assert plan.threads * plan.groups << nc.RADIX_BITS == 1 << held
