"""K10's split layout at n = 2^16 (csrc/blind_rotate_split_cuda.cu) and K12's
split ceiling there (csrc/bench_cuda.cu), on the CPU:

  * the split schedule of K10 written out in int64 torch, block by block —
    the forward blocks (ciphertext, digit polynomial, prime, half), each
    forming its half after the top stage from the digits at i and i + h of
    the rotated accumulator (split_word) and running the chain of h words
    (the kernel's passes, swizzle and coalesced read-out) under row (prime,
    half) of the chunk tables at n; the inverse clusters of four (prime,
    half) per (ciphertext, column), each contracting its half by
    Montgomery products (a factor 2^-32) in the first inverse pass and
    running the chain, then the top inverse stage with n^-1 2^32 between
    the halves of a prime (each block a disjoint half of the pairs, reading
    and writing both halves), the CRT lift by quarters from the two primes'
    words and the limb-shifted adds — equals
    ``blind_rotate_plain`` bit for bit at n = 2^10 (halves of 2^9) and at
    n = 2^16 (B = 1, 2 steps, C = 2, l = 5, w = 6: the short bootstrap's
    gadget there; the JAX package's chain at this shape is held in
    tests/test_torch_degree16.py);
  * K12's split (the top stage through the peer's half between two cluster
    barriers, then each half's chain) equals the plain version at 2^16
    over 2 repetitions, and at 2^10;
  * ``_plan`` takes the split layout at 2^16 (blocks, clusters of four,
    128 KB, no scratch between passes), the grid layout past it, refuses
    the device-memory layout at 2^16; K10's and K12's wrappers queue their
    C calls at 2^16 on CPU tensors with the C call recorded, not made.

The chains run batched over all the blocks of a launch: the kernel's
index maps are the same for every block.  Tolerance 0 throughout.
"""

import numpy as np
import pytest
import torch

from fhe_study_tpu_torch.ops import _cuda, alu_bench
from fhe_study_tpu_torch.ops import blind_rotate_cuda as brc
from fhe_study_tpu_torch.ops import ntt as ntt_mod
from fhe_study_tpu_torch.ops import ntt_cuda as nc
from chunk_emulation import _table
from test_torch_blind_rotate_dm import _lift
from test_torch_blind_rotate_plan import _inputs
from test_torch_lift import _fake_card
from test_torch_radix_plan import (_elements, _swizzle, _twiddle_index,
                                   _lanes_consecutive)

P0, P1 = ntt_mod.CRT_PRIMES_TFHE
N = 1 << 16


# -- a half's chain on every block of a launch at once ------------------------

def _chain(regs, roots, q, logh: int, inverse: bool):
    """radix_chain.cuh's chain of 2^logh words on P blocks at once: regs
    [P, h/16, 16] the registers of the first pass (its stages still to
    run), roots [P, h] each block's table row, q [P] its prime.  Each pass
    runs its stages on the registers and stores them into the swizzled
    buffer, from which the next pass loads; returns the buffers [P, h]
    (swizzled), as the last pass's barrier leaves them."""
    plan = nc._radix_plan(logh)
    q = q[:, None, None]
    h = 1 << logh
    smem = torch.full((regs.shape[0], h), -1, dtype=torch.int64)
    for i, ps in enumerate(plan.inverse if inverse else plan.forward):
        el = _elements(logh, ps.c)
        if i > 0:
            regs = smem[:, _swizzle(el)]
        for u in ps.stages:
            j = ps.c + u
            k = torch.arange(16)
            lo = k[(k >> u) & 1 == 0]
            hi = lo | (1 << u)
            ti = _twiddle_index(logh, ps.c, u, el)
            assert torch.equal(ti, (h >> (j + 1)) + (el[:, lo] >> (j + 1)))
            w = roots[:, ti]
            a, b = regs[:, :, lo], regs[:, :, hi]
            if inverse:
                regs[:, :, lo], regs[:, :, hi] = (a + b) % q, \
                    (a - b) % q * w % q
            else:
                v = b * w % q
                regs[:, :, lo], regs[:, :, hi] = (a + v) % q, (a - v) % q
        smem[:, _swizzle(el)] = regs
    return smem


def _read_out(smem):
    """The forward's coalesced read-out of swizzled buffers [P, h]: lane i
    stores words swizzle(4 i) ^ t, t < 4, to 4 i + t (one 16-byte store)."""
    h = smem.shape[-1]
    idx = (_swizzle(4 * torch.arange(h // 4))[:, None]
           ^ torch.arange(4)[None]).reshape(-1)
    return smem[:, idx]


def _first_pass_addresses(logh: int, inverse: bool):
    """[h/16, 16]: the element addresses of the first pass's registers,
    v + (k << c0) forward (lanes on consecutive words), 16 v + k inverse
    (16 contiguous words)."""
    plan = nc._radix_plan(logh)
    v = torch.arange(1 << (logh - 4))[:, None]
    k = torch.arange(16)[None]
    if inverse:
        addr = 16 * v + k
        assert torch.equal(addr, _elements(logh, plan.inverse[0].c))
    else:
        addr = v + (k << plan.forward[0].c)
        assert torch.equal(addr, _elements(logh, plan.forward[0].c))
        assert _lanes_consecutive(addr)
    return addr


def _top_stage(halves, t, fin, q, inverse: bool):
    """split_top_stage on the swizzled halves [2, h] of one polynomial's
    two blocks: the block of half r takes the pairs i in [r h/2, (r + 1)
    h/2), reading and writing word swizzle(i) of both halves; returns the
    halves after it and checks that every pair ran once."""
    h = halves.shape[-1]
    out = halves.clone()
    ran = torch.zeros(h, dtype=torch.int64)
    for r in (0, 1):
        i = torch.arange(r * (h // 2), (r + 1) * (h // 2))
        sw = _swizzle(i)
        x0, x1 = halves[0, sw], halves[1, sw]
        if inverse:
            y0, y1 = (x0 + x1) % q * fin % q, (x0 - x1) % q * t % q * fin % q
        else:
            v = x1 * t % q
            y0, y1 = (x0 + v) % q, (x0 - v) % q
        out[0, sw], out[1, sw] = y0, y1
        ran[i] += 1
    assert bool((ran == 1).all())
    return out


# -- K10's split layout, block by block ---------------------------------------

def _split_layout(shifts, acc0, ev1, ev2, n: int, w: int):
    """The split layout's steps: the forward launch's blocks, then the
    inverse launch's clusters, numbered as the kernels number them."""
    steps, B = shifts.shape
    C, l = acc0.shape[1], ev1.shape[2]
    F, cols = C * l, 2 * C
    logn = n.bit_length() - 1
    logh, h = logn - 1, n // 2
    qs = torch.tensor([P0, P1])
    # row (p, r) of the chunk tables at n with chunks of h words: the
    # split's, the top stage's root at word 0 of both rows
    fwd = torch.stack([_table(q, n, logh, False) for q in (P0, P1)])
    inv = torch.stack([_table(q, n, logh, True) for q in (P0, P1)])
    assert bool((fwd[:, 0, 0] == fwd[:, 1, 0]).all())
    assert bool((inv[:, 0, 0] == inv[:, 1, 0]).all())
    acc = acc0.clone()
    ev = torch.stack([ev1, ev2]).long().reshape(2, steps, F, cols, n)
    faddr = _first_pass_addresses(logh, False)
    iaddr = _first_pass_addresses(logh, True).reshape(-1)
    dig = torch.full((B, 2, F, n), -1, dtype=torch.int64)
    for j in range(steps):
        # forward: block ((b F + f) 2 + p) 2 + r
        blk = torch.arange(B * F * 4)
        r, p, bf = blk & 1, (blk >> 1) & 1, blk >> 2
        b, f = bf // F, bf % F
        cc, i = f // l, f % l
        hs = shifts[j].long()[b] % (2 * n)
        rows = acc[b, cc]                                    # [blocks, n]
        shift = (64 - w * (i + 1))[:, None, None]

        def digit(e):
            """Digit i of acc X^-h - acc at elements e [h/16, 16] of each
            block: w bits from 64 - w (i + 1) (the arithmetic shift's sign
            bits lie above them)."""
            src = e[None] + hs[:, None, None]
            x = rows.gather(1, (src % n).reshape(len(blk), -1)).reshape(
                src.shape)
            x = torch.where((src // n) % 2 == 1, -x, x)
            d = x - rows.gather(1, e.reshape(1, -1).expand(len(blk), -1)
                                ).reshape(src.shape)
            return (d >> shift) & ((1 << w) - 1)

        # split_word: x[i] + w1 x[i + h] (half 0), x[i] - w1 x[i + h]
        q = qs[p][:, None, None]
        v = digit(faddr + h) * fwd[p, r, 0][:, None, None] % q
        lo = digit(faddr)
        regs = torch.where(r[:, None, None] == 0, (lo + v) % q, (lo - v) % q)
        halves = _read_out(_chain(regs, fwd[p, r], qs[p], logh, False))
        for k in range(len(blk)):
            dig[b[k], p[k], f[k], r[k] * h:(r[k] + 1) * h] = halves[k]
        # inverse: cluster b 2C + o, block rank p 2 + r
        blk = torch.arange(B * cols * 4)
        rank, bo = blk & 3, blk >> 2
        p, r = rank >> 1, rank & 1
        b, o = bo // cols, bo % cols
        at = r[:, None] * h + iaddr[None]                    # [blocks, h]
        d = dig[b, p].gather(2, at[:, None].expand(-1, F, -1))
        key = ev[:, j][p, :, o].gather(2, at[:, None].expand(-1, F, -1))
        # Montgomery products: d key 2^-32 mod q
        q = qs[p][:, None]
        rinv = torch.tensor([pow(1 << 32, -1, P0), pow(1 << 32, -1, P1)])[p]
        prods = d * key % q[:, :, None] * rinv[:, None, None] % q[:, :, None]
        regs = (prods.sum(1) % q).reshape(-1, h >> 4, 16)
        smem = _chain(regs, inv[p, r], qs[p], logh, True)
        smem = smem.reshape(B * cols, 2, 2, h)                # [cluster, p, r]
        for c in range(B * cols):
            for pi, qi in enumerate((P0, P1)):
                smem[c, pi] = _top_stage(smem[c, pi], int(inv[pi, 0, 0]),
                                         pow(n, -1, qi) * (1 << 32) % qi,
                                         qi, True)
            b_, o_ = divmod(c, cols)
            lifted = torch.full((n,), -1, dtype=torch.int64)
            for pi in (0, 1):                 # block (pi, r): quarter pi
                for ri in (0, 1):
                    e = torch.arange(pi * (h // 2), (pi + 1) * (h // 2))
                    sw = _swizzle(e)
                    assert bool((lifted[ri * h + e] == -1).all())
                    lifted[ri * h + e] = _lift(smem[c, 0, ri, sw],
                                               smem[c, 1, ri, sw])
            acc[b_, o_ >> 1] += lifted * (1 << (32 * (o_ & 1)))
    return acc


@pytest.mark.parametrize("logn,C,l,w,steps,B", [(10, 2, 2, 12, 2, 2),
                                                (10, 3, 1, 20, 1, 1),
                                                (16, 2, 5, 6, 2, 1)])
def test_split_layout_schedule_equals_plain(logn, C, l, w, steps, B):
    n = 1 << logn
    rng = np.random.default_rng(4000 * logn + 10 * C + l)
    shifts, acc0, ev1, ev1s, ev2, ev2s = _inputs(rng, steps, B, C, l, n)
    want = brc.blind_rotate_plain(shifts, acc0, ev1, ev1s, ev2, ev2s, n, w)
    assert torch.equal(_split_layout(shifts, acc0, ev1, ev2, n, w), want)


# -- K12's split ceiling ------------------------------------------------------

def _split_ceiling(x, q: int, reps: int):
    """ntt_smem_ceiling_split_kernel on x [B, n]: block r of each pair loads
    half r into its swizzled buffer; each repetition the top stage, then
    each half's forward chain under row r; the buffers stored at the end."""
    B, n = x.shape
    logh, h = n.bit_length() - 2, n // 2
    tab = _table(q, n, logh, False)
    t = int(tab[0, 0])
    assert int(tab[1, 0]) == t
    halves = torch.full((B, 2, h), -1, dtype=torch.int64)
    halves[..., _swizzle(torch.arange(h))] = x.long().reshape(B, 2, h)
    el = _elements(logh, nc._radix_plan(logh).forward[0].c)
    for _ in range(reps):
        for b in range(B):
            halves[b] = _top_stage(halves[b], t, 1, q, False)
        regs = halves.reshape(2 * B, h)[:, _swizzle(el)]
        rows = tab.repeat(B, 1)
        halves = _chain(regs, rows, torch.full((2 * B,), q), logh,
                        False).reshape(B, 2, h)
    return _read_out(halves.reshape(2 * B, h)).reshape(B, n)


@pytest.mark.parametrize("logn,B,reps", [(16, 1, 2), (10, 3, 3), (10, 2, 0)])
def test_split_ceiling_equals_plain(logn, B, reps):
    n = 1 << logn
    q = P0
    x = torch.from_numpy(np.random.default_rng(70 + logn).integers(
        0, q, (B, n))).int()
    want = alu_bench.ntt_smem_ceiling_plain(x, q, reps).long()
    assert torch.equal(_split_ceiling(x, q, reps), want)


# -- plans and wrappers -------------------------------------------------------

def test_split_plan_at_n_2_16():
    """At 2^16 the split layout from the shape alone: per ciphertext 4 C l
    forward blocks and 4 2C inverse blocks in clusters of four (2,560 and
    1,024 at B = 64, C = 2, l = 5), a half's one-buffer shape (512
    threads, 128 KB), the digit scratch and nothing between passes; the
    grid layout only when named there, and past 2^17 (the quarter layout
    at 2^17); the device-memory layout refused."""
    plan = brc._plan(2, 5, N)
    assert plan.layout == "split" and not plan.staged
    assert plan.cluster == 4 and plan.radix == nc._radix_plan(15)
    assert (plan.threads, plan.smem_bytes) == (nc.WIDE_THREADS, 4 << 15)
    assert tuple(64 * b for b in plan.blocks) == (2560, 1024)
    assert plan.scratch_bytes == 2 * 4 * 10 * N
    assert brc._plan(2, 5, N, layout="grid").layout == "grid"
    assert brc._plan(2, 1, 2 * N).layout == "quarter"
    with pytest.raises(ValueError, match="layout"):
        brc._plan(2, 1, 2 * N, layout="split")
    for logn in range(18, 23):
        assert brc._plan(2, 1, 1 << logn).layout == "grid"
        with pytest.raises(ValueError, match="layout"):
            brc._plan(2, 1, 1 << logn, layout="split")
    for layout in ("device", "cluster"):
        with pytest.raises(ValueError, match="layout"):
            brc._plan(2, 5, N, layout=layout)
    assert alu_bench.ceiling_layout(16) == "split"
    assert alu_bench.ceiling_layout(16, "chunked") == "chunked"
    assert alu_bench.ceiling_layout(17) == "chunked"
    assert alu_bench.ceiling_layout(15) == "block"
    with pytest.raises(ValueError, match="layout"):
        alu_bench.ceiling_layout(17, "split")


def test_wrappers_queue_the_split_at_n_2_16():
    """On CPU tensors up to the C call (recorded, not made): K10 at 2^16
    gets layout code 3, the chunk tables, a half's shape and the digit
    scratch, and counts one launch under "split" (under "grid" where the
    caller names it, with the grid's scratch); K12 at 2^16 gets split = 1
    and no scratch (chunked where named: split = 0 and a scratch)."""
    C, l, w, steps, B = 2, 5, 6, 2, 3
    rng = np.random.default_rng(5)
    shifts, acc0, ev1, ev1s, ev2, ev2s = _inputs(rng, steps, B, C, l, N)
    x = torch.zeros((2, N), dtype=torch.int32)
    calls = {}
    _cuda.reset_launches()
    with _fake_card(calls, (_cuda.BLIND_ROTATE, _cuda.NTT_SMEM_CEILING)):
        brc.blind_rotate_kernel(shifts, acc0, ev1, ev1s, ev2, ev2s, N, w)
        brc.blind_rotate_kernel(shifts, acc0, ev1, ev1s, ev2, ev2s, N, w,
                                layout="grid")
        alu_bench.ntt_smem_ceiling_kernel(x, P0, 2)
        alu_bench.ntt_smem_ceiling_kernel(x, P0, 2, layout="chunked")
    (split, grid), (k12, k12c) = calls["blind_rotate"], calls[
        "ntt_smem_ceiling"]
    for args, code in ((split, 3), (grid, 2)):
        assert len(args) == len(_cuda.BLIND_ROTATE.argtypes)
        assert args[13:19] == (steps, B, C, l, w, 16)
        assert args[19:23] == (nc.WIDE_THREADS, 4 << 15, 0, code)
        assert args[12] is not None
    assert _cuda.BLIND_ROTATE.by_layout == {"cluster": 0, "device": 0,
                                            "split": 1, "grid": 1,
                                            "quarter": 0}
    assert k12[2] is None and k12[-2] == 1 and k12c[2] is not None \
        and k12c[-2] == 0
    assert tuple(k12[10:12]) == (nc.WIDE_THREADS, 4 << 15)
    assert _cuda.NTT_SMEM_CEILING.by_layout == {"block": 0, "chunked": 1,
                                                "split": 1}
    _cuda.reset_launches()
