"""K10's quarter layout at n = 2^17 (csrc/blind_rotate_quarter_cuda.cu), on
the CPU:

  * the quarter schedule written out in int64 torch, block by block — the
    forward clusters of four (ciphertext, digit polynomial, prime), block
    r forming the digits of its quarter's elements r h + i of the rotated
    accumulator (h = n/4) as bytes, those of virtual thread v of pass 0 at
    16 v .. 16 v + 15, then reading its virtual threads' bytes of the four
    quarters, forming its quarter after both top stages
    (quarter_top) and running its chain of h words (the kernel's passes,
    swizzle and coalesced read-out) under row (prime, quarter) of the
    chunk tables at n; the inverse clusters of eight (prime, quarter) per
    (ciphertext, column), each contracting its quarter by Montgomery
    products (a factor 2^-32; lanes on consecutive 16-byte words) into
    shared memory, running the chain from pass 0, then the two top inverse
    stages between the quarters of a prime as one radix-4 exchange with
    n^-1 2^32, the CRT lift by halves of each quarter from the two primes'
    words and the limb-shifted adds — equals ``blind_rotate_plain`` bit
    for bit at n = 2^10 (quarters of 2^8) over 2 steps and at n = 2^17
    (B = 1, 1 step, C = 2, l = 6, w = 5: the short bootstrap's gadget
    there);
  * ``blind_rotate_plain`` equals the JAX package's step-by-step chain
    under jax.jit at n = 2^10;
  * ``_plan`` takes the quarter layout at 2^17 (blocks, clusters of eight,
    128 KB, the digit scratch), the split layout at 2^16 and the grid
    layout at 2^18; the wrapper queues its C call at 2^17 on CPU tensors
    with the call recorded, not made; the probe's phase marks fit the
    unit.

The chains run batched over all the blocks of a launch: the kernel's
index maps are the same for every block.  Tolerance 0 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_study_tpu.arith.params import RingParam as JRingParam
from fhe_study_tpu.arith.params import TORUS_Q
from fhe_study_tpu.models.gfhe import glwe as JG
from fhe_study_tpu.models.tfhe import tggsw as jtggsw
from fhe_study_tpu.models.tfhe import tglwe as jtglwe
from fhe_study_tpu_torch.ops import _cuda
from fhe_study_tpu_torch.ops import blind_rotate_cuda as brc
from fhe_study_tpu_torch.ops import ntt as ntt_mod
from fhe_study_tpu_torch.ops import ntt_cuda as nc
from fhe_study_tpu_torch.utils import interop, k10_phases
from chunk_emulation import _table
from test_torch_blind_rotate_dm import _lift
from test_torch_blind_rotate_plan import _inputs
from test_torch_blind_rotate_split import _chain, _read_out
from test_torch_lift import _fake_card
from test_torch_radix_plan import _elements, _swizzle

P0, P1 = ntt_mod.CRT_PRIMES_TFHE
N = 1 << 17


def _signed(a, b, r, q):
    """a + b (r = 0) or a - b (r = 1), mod q, elementwise."""
    return torch.where(r == 0, (a + b) % q, (a - b) % q)


def _quarter_stages(quarters, r1, r2, fin, q):
    """quarter_stages on the swizzled quarters [4, h] of one polynomial's
    four blocks, both top inverse stages as one radix-4 butterfly a word
    (bit 15 with root r2[b] of half b, then bit 16 with r1, and fin): the
    block of quarter k takes the words i in [k h/4, (k + 1) h/4), reading
    and writing word swizzle(i) of all four; returns them after the stages
    and checks that every word ran once."""
    h = quarters.shape[-1]
    out = quarters.clone()
    ran = torch.zeros(h, dtype=torch.int64)
    for k in range(4):
        i = torch.arange(k * (h // 4), (k + 1) * (h // 4))
        sw = _swizzle(i)
        v = [quarters[m, sw] for m in range(4)]
        for b in (0, 1):
            v[2 * b], v[2 * b + 1] = ((v[2 * b] + v[2 * b + 1]) % q,
                                      (v[2 * b] - v[2 * b + 1]) % q
                                      * r2[b] % q)
        for m in (0, 1):
            v[m], v[m + 2] = ((v[m] + v[m + 2]) % q * fin % q,
                              (v[m] - v[m + 2]) % q * r1 % q * fin % q)
        for m in range(4):
            out[m, sw] = v[m]
        ran[i] += 1
    assert bool((ran == 1).all())
    return out


def _digit_bytes(digit, r, h: int, logh: int):
    """The forward clusters' quarters of digit bytes [clusters, 4, V, 16]
    (V = h/16 virtual threads of pass 0): block r of a cluster of four
    forms the digits of its quarter's elements r h + v + (k << c0), element
    at byte 16 v + k of its buffer (one 16-byte word a virtual thread);
    checks that each element lies at one byte and each digit fits one."""
    el = _elements(logh, nc._radix_plan(logh).forward[0].c)   # [V, 16]
    assert torch.equal(el.reshape(-1).sort().values, torch.arange(h))
    d = digit(r[:, None, None] * h + el[None])                # [blocks, V, 16]
    assert int(d.max()) < 256
    return d.reshape(-1, 4, h >> 4, 16)


def _contraction_words(logh: int) -> torch.Tensor:
    """The words of a quarter that thread t's lane reads in group g, as the
    inverse kernel reads them: 4 (u T + t) + i of the group's T 16 words,
    u < 4, i < 4 (consecutive 16-byte words across the lanes); returns
    them in (g, u, t, i) order and checks that they cover the quarter
    once."""
    plan = nc._radix_plan(logh)
    T, h = plan.threads, 1 << logh
    g = torch.arange(plan.groups)[:, None, None, None]
    u = torch.arange(4)[None, :, None, None]
    t = torch.arange(T)[None, None, :, None]
    i = torch.arange(4)[None, None, None, :]
    words = (g * (16 * T) + 4 * (u * T + t) + i).reshape(-1)
    assert torch.equal(words.sort().values, torch.arange(h))
    return words


def _quarter_layout(shifts, acc0, ev1, ev2, n: int, w: int):
    """The quarter layout's steps: the forward launch's clusters, then the
    inverse launch's, numbered as the kernels number them."""
    steps, B = shifts.shape
    C, l = acc0.shape[1], ev1.shape[2]
    F, cols = C * l, 2 * C
    logn = n.bit_length() - 1
    logh, h = logn - 2, n // 4
    qs = torch.tensor([P0, P1])
    # row (p, r) of the chunk tables at n with chunks of h words; word 0 of
    # rows 1, 2, 3: the top stages' roots 1 (bit log n - 1) and 2, 3
    fwd = torch.stack([_table(q, n, logh, False) for q in (P0, P1)])
    inv = torch.stack([_table(q, n, logh, True) for q in (P0, P1)])
    for p, q in enumerate((P0, P1)):
        for tab, inverse in ((fwd, False), (inv, True)):
            roots = nc._roots_plain((q,), n, inverse, torch.device("cpu"))[0]
            assert torch.equal(tab[p, 1:, 0], roots[1:4])
    acc = acc0.clone()
    ev = torch.stack([ev1, ev2]).long().reshape(2, steps, F, cols, n)
    cwords = _contraction_words(logh)
    el0 = _elements(logh, 0)                 # the inverse's pass 0
    dig = torch.full((B, 2, F, n), -1, dtype=torch.int64)
    for j in range(steps):
        # forward: block ((b F + f) 2 + p) 4 + r
        blk = torch.arange(B * F * 8)
        r, p, bf = blk & 3, (blk >> 2) & 1, blk >> 3
        b, f = bf // F, bf % F
        cc, i = f // l, f % l
        hs = shifts[j].long()[b] % (2 * n)
        rows = acc[b, cc]                                    # [blocks, n]
        shift = (64 - w * (i + 1))[:, None, None]
        q = qs[p][:, None, None]

        def digit(e):
            """Digit i of acc X^-h - acc at elements e of each block."""
            e = e.expand(len(blk), *e.shape[1:])
            src = e + hs[:, None, None]
            x = rows.gather(1, (src % n).reshape(len(blk), -1)).reshape(
                src.shape)
            x = torch.where((src // n) % 2 == 1, -x, x)
            d = x - rows.gather(1, e.reshape(len(blk), -1)).reshape(src.shape)
            return (d >> shift) & ((1 << w) - 1)

        # the blocks of a cluster form their quarters' digit bytes; each
        # reads its virtual threads' bytes of all four
        by = _digit_bytes(digit, r, h, logh)
        x = [by[:, k].repeat_interleave(4, 0) for k in range(4)]
        # quarter_top: bit 16 pairs i with i + 2h, then bit 15 (root 2 +
        # b16) pairs i with i + h of the half
        hb, lb = (r >> 1)[:, None, None], (r & 1)[:, None, None]
        w1 = fwd[p, 1, 0][:, None, None]
        w2 = fwd[p, 2 + (r >> 1), 0][:, None, None]
        lo = _signed(x[0], x[2] * w1 % q, hb, q)
        hi = _signed(x[1], x[3] * w1 % q, hb, q)
        regs = _signed(lo, hi * w2 % q, lb, q)
        quarters = _read_out(_chain(regs, fwd[p, r], qs[p], logh, False))
        for k in range(len(blk)):
            dig[b[k], p[k], f[k], r[k] * h:(r[k] + 1) * h] = quarters[k]
        # inverse: cluster b 2C + o, block rank p 4 + r
        blk = torch.arange(B * cols * 8)
        rank, bo = blk & 7, blk >> 3
        p, r = rank >> 2, rank & 3
        b, o = bo // cols, bo % cols
        at = (r[:, None] * h + cwords[None])[:, None].expand(-1, F, -1)
        d = dig[b, p].gather(2, at)
        key = ev[:, j][p, :, o].gather(2, at)
        # Montgomery products: d key 2^-32 mod q
        q = qs[p][:, None, None]
        rinv = torch.tensor([pow(1 << 32, -1, P0), pow(1 << 32, -1, P1)])[p]
        prods = d * key % q * rinv[:, None, None] % q
        smem = torch.full((len(blk), h), -1, dtype=torch.int64)
        smem[:, _swizzle(cwords)] = prods.sum(1) % q[:, :, 0]
        smem = _chain(smem[:, _swizzle(el0)], inv[p, r], qs[p], logh, True)
        smem = smem.reshape(B * cols, 2, 4, h)               # [cluster, p, r]
        for c in range(B * cols):
            for pi, qi in enumerate((P0, P1)):
                fin = pow(n, -1, qi) * (1 << 32) % qi
                t1, t2 = int(inv[pi, 1, 0]), inv[pi, 2:4, 0].tolist()
                smem[c, pi] = _quarter_stages(smem[c, pi], t1, t2, fin, qi)
            b_, o_ = divmod(c, cols)
            lifted = torch.full((n,), -1, dtype=torch.int64)
            for pi in (0, 1):                 # block (pi, ri): half pi
                for ri in range(4):
                    e = torch.arange(pi * (h // 2), (pi + 1) * (h // 2))
                    sw = _swizzle(e)
                    assert bool((lifted[ri * h + e] == -1).all())
                    lifted[ri * h + e] = _lift(smem[c, 0, ri, sw],
                                               smem[c, 1, ri, sw])
            acc[b_, o_ >> 1] += lifted * (1 << (32 * (o_ & 1)))
    return acc


@pytest.mark.parametrize("logn,C,l,w,steps,B", [(10, 2, 2, 8, 2, 2),
                                                (10, 3, 1, 7, 2, 1),
                                                (17, 2, 6, 5, 1, 1)])
def test_quarter_layout_schedule_equals_plain(logn, C, l, w, steps, B):
    n = 1 << logn
    # the reference's gate at 2^17 (C l n 2^w < 2^26) leaves digits of at
    # most 8 bits, a byte each in the forward's exchange
    assert w <= 8
    rng = np.random.default_rng(5000 * logn + 10 * C + l)
    shifts, acc0, ev1, ev1s, ev2, ev2s = _inputs(rng, steps, B, C, l, n)
    want = brc.blind_rotate_plain(shifts, acc0, ev1, ev1s, ev2, ev2s, n, w)
    assert torch.equal(_quarter_layout(shifts, acc0, ev1, ev2, n, w), want)


def test_plain_equals_the_jax_chain_at_n_2_10():
    """blind_rotate_plain, which every layout is held to, against the JAX
    package's step-by-step chain under jax.jit (the scan body of its
    blind_rotation with the key's evaluations: left_rotate, then
    cmux_evals with the Shoup planes it reads) at n = 2^10, C = 2, l = 2,
    2 steps on 2 ciphertexts."""
    n, C, l, w, steps, B = 1 << 10, 2, 2, 12, 2, 2
    rng = np.random.default_rng(78)
    shifts, acc0, ev1, _, ev2, _ = _inputs(rng, steps, B, C, l, n)
    ev1s, ev2s = ((e.long() * (1 << 32) // p).to(torch.int32)
                  for e, p in ((ev1, P0), (ev2, P1)))
    got = brc.blind_rotate_plain(shifts, acc0, ev1, ev1s, ev2, ev2s, n, w)
    JP = JG.Param(JG.ERR_SIGMA, JRingParam(TORUS_Q, n), C - 1, 2)

    def chain(sh, a, b, e1, e2, e1s, e2s):
        def step(acc, xs):
            h, x1, x2, x1s, x2s = xs
            rot = jtglwe.left_rotate(JP, acc, h)
            return jtggsw.cmux_evals(JP, 1 << w, l, jtggsw.TGGSWEvals(
                x1, x2, x1s, x2s), acc, rot), None
        return jax.lax.scan(step, JG.GLWE(a=a, b=b),
                            (sh, e1, e2, e1s, e2s))[0]

    def jx(t):
        return jnp.asarray(interop.bits_to_numpy(t))

    a0 = jx(acc0)
    out = jax.jit(chain)(jnp.asarray(shifts.numpy().astype(np.uint64)),
                         a0[:, :C - 1], a0[:, C - 1],
                         *(jx(e) for e in (ev1, ev2, ev1s, ev2s)))
    want = np.concatenate([np.asarray(out.a), np.asarray(out.b)[:, None]], 1)
    np.testing.assert_array_equal(interop.bits_to_numpy(got),
                                  want.astype(np.uint64))


def test_quarter_phase_counters_fit_the_unit():
    """utils/k10_phases.py --quarter finds each of its marks once in the
    quarter layout's unit: the ten phase boundaries and the macro."""
    src = (_cuda.CSRC / k10_phases.QUARTER_UNIT).read_text()
    out = k10_phases.quarter_instrumented(src)
    assert out.count("FHE_PHASE(") == len(k10_phases.QUARTER_PHASES) + 1


# -- plans and wrappers -------------------------------------------------------

def test_quarter_plan_at_n_2_17():
    """At 2^17 the quarter layout from the shape alone: per ciphertext 8 C l
    forward blocks and 8 2C inverse blocks in clusters of eight (6,144 and
    2,048 at B = 64, C = 2, l = 6), a quarter's one-buffer shape (512
    threads, 128 KB), the digit scratch and nothing between passes; the
    grid layout when named there; the split at 2^16 and the grid at 2^18
    by rule, the quarter refused at both."""
    plan = brc._plan(2, 6, N)
    assert plan.layout == "quarter" and not plan.staged
    assert plan.cluster == 8 and plan.radix == nc._radix_plan(15)
    assert (plan.threads, plan.smem_bytes) == (nc.WIDE_THREADS, 4 << 15)
    assert tuple(64 * b for b in plan.blocks) == (6144, 2048)
    assert plan.scratch_bytes == 2 * 4 * 12 * N
    assert brc._plan(2, 6, N, layout="grid").layout == "grid"
    assert brc._plan(2, 5, N // 2).layout == "split"
    assert brc._plan(2, 1, 2 * N).layout == "grid"
    for n in (N // 2, 2 * N):
        with pytest.raises(ValueError, match="layout"):
            brc._plan(2, 1, n, layout="quarter")
    for layout in ("device", "cluster", "split"):
        with pytest.raises(ValueError, match="layout"):
            brc._plan(2, 6, N, layout=layout)


def test_wrapper_queues_the_quarter_at_n_2_17():
    """On CPU tensors up to the C call (recorded, not made): K10 at 2^17
    gets layout code 4, the chunk tables, a quarter's shape, the digit
    scratch and the final multiplier n^-1 2^32 (the Montgomery
    contraction's), and counts one launch under "quarter" (under "grid"
    where the caller names it, with the grid's scratch and n^-1)."""
    C, l, w, steps, B = 2, 6, 5, 1, 1
    rng = np.random.default_rng(6)
    shifts, acc0, ev1, ev1s, ev2, ev2s = _inputs(rng, steps, B, C, l, N)
    calls, seen = {}, []
    _cuda.reset_launches()
    rows = nc._prime_rows
    nc._prime_rows = lambda qs, fin, dev: seen.append((qs, fin)) or rows(
        qs, fin, dev)
    try:
        with _fake_card(calls, (_cuda.BLIND_ROTATE,)):
            brc.blind_rotate_kernel(shifts, acc0, ev1, ev1s, ev2, ev2s, N, w)
            brc.blind_rotate_kernel(shifts, acc0, ev1, ev1s, ev2, ev2s, N, w,
                                    layout="grid")
    finally:
        nc._prime_rows = rows
    quarter, grid = calls["blind_rotate"]
    for args, code in ((quarter, 4), (grid, 2)):
        assert len(args) == len(_cuda.BLIND_ROTATE.argtypes)
        assert args[13:19] == (steps, B, C, l, w, 17)
        assert args[19:23] == (nc.WIDE_THREADS, 4 << 15, 0, code)
        assert args[12] is not None
    (qs4, fin4), (qs2, fin2) = seen
    assert qs4 == qs2 == (P0, P1, P1) and fin2[0] == pow(N, -1, P0)
    assert fin4[0] == pow(N, -1, P0) * (1 << 32) % P0
    assert _cuda.BLIND_ROTATE.by_layout == {
        "cluster": 0, "device": 0, "split": 0, "grid": 1, "quarter": 1}
    _cuda.reset_launches()
