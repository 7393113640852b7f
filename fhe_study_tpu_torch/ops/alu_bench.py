"""Integer issue-rate loops and the shared-memory NTT ceiling: the two
measuring kernels of ``csrc/bench_cuda.cu`` beside their plain PyTorch
versions — the counterpart of fhe_study_tpu/ops/vpu_bench.py.

  K12 ntt_smem_ceiling <- vpu_bench.ntt_vmem_ceiling (_ntt_repeat_kernel)
  K13 alu_rate         <- vpu_bench.alu_rate         (_alu_kernel)

``ntt_smem_ceiling`` loops the package's own forward chain (the
register-resident passes of csrc/radix_chain.cuh that K1-K8 run, fully
reduced after every butterfly, at K1's block shape) on polynomials that stay
in shared memory: butterflies/s with device memory out of the way.  It is
the ceiling of THIS chain, not of the card: a chain with fewer instructions
a butterfly (lazy reduction) would beat it.  ``alu_rate`` iterates one 32-bit
operation on words that stay in registers: the reference's four (``add``,
``mul``, ``addmod``, ``shoup_lazy``) and the three that the package's kernels
are made of (``shoup_mul``, ``mont_mul`` and one whole ``butterfly`` of
csrc/modarith.cuh).

The ``*_kernel`` wrappers and ``*_plain`` versions map tensors to tensors
and are compared bit for bit; ``ntt_smem_ceiling`` and ``alu_rate`` make
seeded inputs, launch the kernels, time them with CUDA events and return
rates, beside the operands and the output of the last timed launch so that
the caller can hold that launch against the plain version.  They measure the
kernels and nothing else: on any device but a CUDA card they raise.
"""

import ctypes

import numpy as np
import torch

from . import _cuda, ntt_cuda
from . import ntt as ntt_mod

M32 = (1 << 32) - 1
ALU_THREADS = 256        # kAluThreads of csrc/bench_cuda.cu
ALU_PER_THREAD = 4       # kAluPer
ALU_UNROLL = 16          # kAluUnroll: rounds come in multiples of it
ALU_Q = 998244353        # the reference's modulus, below 2^30
OPS = ("add", "mul", "addmod", "shoup_lazy", "shoup_mul", "mont_mul",
       "butterfly")      # the order of AluOp in csrc/bench_cuda.cu

# SASS instructions per word and round in the loop of csrc/bench_cuda.cu
# (per butterfly for "butterfly"), counted from the built library by
# utils/sass_counts.py (nvcc 12.9, sm_90a): they turn a word rate into an
# instruction rate.  chip_smoke.py reads the counts of its own build and uses
# those.  What the compiler made of each operation:
#   add         half an IADD3: two dependent adds fold into one three-input add
#   mul         IMAD
#   addmod      ISETP, SEL, IADD3 (x + y - (x + y >= q ? q : 0)), and 4 adds
#               a loop body of 64 word-rounds that it could not fold
#   shoup_lazy  IMAD.HI.U32, 2 IMAD
#   shoup_mul   the same, then ISETP, SEL, IADD3
#   mont_mul    IMAD.WIDE.U32, IMAD, IMAD.HI.U32, 3 adds, ISETP, SEL
#   butterfly   shoup_mul's 6, the sum's and the difference's ISETP, SEL, add,
#               and one add more
OP_COUNTS = {
    "add": 0.5,
    "mul": 1.0,
    "addmod": 3.0625,
    "shoup_lazy": 3.0,
    "shoup_mul": 6.0,
    "mont_mul": 8.0,
    "butterfly": 13.0,
}

# The same instructions by integer pipe (utils/sass_counts.PIPES): (ALU, FMA,
# wide) per word and round, ALU + FMA = OP_COUNTS; "wide" counts the
# IMAD.HI / IMAD.WIDE among the FMA instructions, which take two FMA issue
# slots and one ALU slot each.  The compiler moves some adds to the FMA pipe
# (IMAD.IADD, VIADD) to balance the two:
#   add         (0.5, 0, 0)             IADD3
#   mul         (0, 1, 0)               IMAD
#   addmod      (2.9375, 0.125, 0)      60 IADD3 + 8 IMAD.IADD of 68 adds
#   shoup_lazy  (0, 3, 1)
#   shoup_mul   (2.734375, 3.265625, 1) 47 IADD3 + 17 IMAD.IADD of 64 adds
#   mont_mul    (3.8125, 4.1875, 2)     116 IADD3 + 54 VIADD + 22 IMAD.IADD
#   butterfly   (7, 6, 1)               1 IADD3 + 3 IMAD.IADD a butterfly
# These are the work units of every kernel's bound (utils/kernel_check.py).
OP_PIPES = {
    "add": (0.5, 0.0, 0.0),
    "mul": (0.0, 1.0, 0.0),
    "addmod": (2.9375, 0.125, 0.0),
    "shoup_lazy": (0.0, 3.0, 1.0),
    "shoup_mul": (2.734375, 3.265625, 1.0),
    "mont_mul": (3.8125, 4.1875, 2.0),
    "butterfly": (7.0, 6.0, 1.0),
}

# The loops themselves, by mnemonic (cuobjdump -sass of the same build; a
# body holds ALU_UNROLL rounds on ALU_PER_THREAD words, with the loop
# counter's UIADD3, ISETP.LE.AND and BRA): tests hold OP_PIPES to these
# through sass_counts.pipe_counts.
LOOP_SASS = {
    "add": {"IADD3": 32, "UIADD3": 1, "ISETP.LE.AND": 1, "BRA": 1},
    "mul": {"IMAD": 64, "UIADD3": 1, "ISETP.LE.AND": 1, "BRA": 1},
    "addmod": {"IMAD.IADD": 8, "UIADD3": 1, "ISETP.GE.U32.AND": 64,
               "SEL": 64, "IADD3": 60, "ISETP.LE.AND": 1, "BRA": 1},
    "shoup_lazy": {"IMAD.HI.U32": 64, "UIADD3": 1, "ISETP.LE.AND": 1,
                   "IMAD": 128, "BRA": 1},
    "shoup_mul": {"IMAD.HI.U32": 64, "UIADD3": 1, "ISETP.LE.AND": 1,
                  "IMAD": 128, "ISETP.GE.U32.AND": 64, "SEL": 64,
                  "IMAD.IADD": 17, "IADD3": 47, "BRA": 1},
    "mont_mul": {"IMAD.WIDE.U32": 64, "UMOV": 7, "IADD3": 116, "IMAD": 64,
                 "UIADD3": 1, "VIADD": 54, "ISETP.LE.AND": 1,
                 "IMAD.HI.U32": 64, "ISETP.GE.U32.AND": 64, "SEL": 64,
                 "IMAD.IADD": 22, "BRA": 1},
    "butterfly": {"IMAD.HI.U32": 32, "UIADD3": 1, "ISETP.LE.AND": 1,
                  "IMAD": 64, "ISETP.GE.U32.AND": 96, "SEL": 96,
                  "IMAD.IADD": 96, "IADD3": 32, "BRA": 1},
}


# -- K13: one operation iterated ---------------------------------------------

def _umulhi(a, b):
    """High word of the 32 x 32-bit product of u32 values held in int64,
    without forming a product above 2^63."""
    return (a * (b >> 16) + ((a * (b & 0xFFFF)) >> 16)) >> 16


def _nq(q: int) -> int:
    return (-pow(q, -1, 1 << 32)) % (1 << 32)


def op_body(op: str):
    """(x, y, yp) -> x' for one round of ``op`` (any but "butterfly") modulo
    ALU_Q on u32 values held in int64, with the 32-bit wrap of the kernel."""
    q, nq = ALU_Q, _nq(ALU_Q)

    def shoup_lazy(x, y, yp):
        return (x * y - _umulhi(x, yp) * q) & M32

    def shoup_mul(x, y, yp):
        r = shoup_lazy(x, y, yp)
        return torch.where(r >= q, r - q, r)

    def addmod(x, y, yp):
        s = x + y
        return torch.where(s >= q, s - q, s)

    def mont_mul(x, y, yp):
        p = x * y                                    # x, y < q < 2^31
        m = ((p & M32) * nq) & M32
        t = (p + m * q) >> 32
        return torch.where(t >= q, t - q, t)

    return {"add": lambda x, y, yp: (x + y) & M32,
            "mul": lambda x, y, yp: (x * y) & M32,
            "addmod": addmod, "shoup_lazy": shoup_lazy,
            "shoup_mul": shoup_mul, "mont_mul": mont_mul}[op]


def _check_rounds(op: str, rounds: int) -> None:
    if op not in OPS:
        raise ValueError(f"unknown operation {op!r}; one of {OPS}")
    if rounds < 0 or rounds % ALU_UNROLL:
        raise ValueError(f"rounds={rounds}: the loop runs multiples of "
                         f"{ALU_UNROLL}")


def _words(x):
    """The [ALU_PER_THREAD, threads] view of a flat operand: word k of
    thread t lies at k * threads + t."""
    if x.numel() == 0 or x.numel() % (ALU_PER_THREAD * ALU_THREADS):
        raise ValueError(f"{x.numel()} words: need a positive multiple of "
                         f"{ALU_PER_THREAD * ALU_THREADS}")
    return x.reshape(ALU_PER_THREAD, -1)


def alu_rate_plain(x, y, yp, op: str, rounds: int):
    """``rounds`` rounds of ``op`` modulo ALU_Q, each feeding the next: int32
    tensors holding u32 bits, any shape -> the same.  "butterfly" pairs the words
    (2k, 2k+1) of a thread: u' = u + v*w, v' = u - v*w mod q with the
    twiddle pair (y, yp) of word 2k."""
    _check_rounds(op, rounds)
    xs, ys, yps = (_words(v).long() & M32 for v in (x, y, yp))
    q = ALU_Q
    if op == "butterfly":
        mul = op_body("shoup_mul")
        u, v = xs[0::2], xs[1::2]
        for _ in range(rounds):
            t = mul(v, ys[0::2], yps[0::2])
            s, d = u + t, u - t
            u, v = torch.where(s >= q, s - q, s), torch.where(d < 0, d + q, d)
        xs = torch.stack([u, v], dim=1).reshape(xs.shape)
    else:
        body = op_body(op)
        for _ in range(rounds):
            xs = body(xs, ys, yps)
    # u32 bits back into int32
    return torch.where(xs >= 1 << 31, xs - (1 << 32), xs).int().reshape(
        x.shape)


def alu_rate_kernel(x, y, yp, op: str, rounds: int):
    """K13 on CUDA int32 tensors of one shape (u32 bits), modulo ALU_Q."""
    _check_rounds(op, rounds)
    dev = x.device
    for name, v in (("x", x), ("y", y), ("yp", yp)):
        _cuda.check(v, name, dev)
        if v.shape != x.shape:
            raise ValueError(f"{name} has shape {tuple(v.shape)}, expected "
                             f"{tuple(x.shape)}")
    threads = _words(x).shape[1]
    out = torch.empty_like(x)
    _cuda.ALU_RATE.launch(dev, x.data_ptr(), y.data_ptr(), yp.data_ptr(),
                          out.data_ptr(), threads, rounds // ALU_UNROLL,
                          OPS.index(op), ALU_Q, _nq(ALU_Q))
    return out


def resident_blocks(device, op: str | None = None, n: int | None = None):
    """(blocks per SM, SMs) of a measuring kernel on the card: an
    ``alu_rate`` operation, or the ceiling loop at ring degree n (at its
    plan's threads and shared memory; past 2^15 its chunk chain's, one
    block a chunk of 2^15 words)."""
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    fn = _cuda.library().fhe_bench_resident
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(-1 if op is None else OPS.index(op),
                 0 if n is None
                 else _cuda.log2_degree(n, _cuda.NTT_SMEM_CEILING),
                 ctypes.byref(per_sm), ctypes.byref(sms))
    if err != 0:
        raise RuntimeError(f"fhe_bench_resident: CUDA error {err}")
    return per_sm.value, sms.value


def _bits(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(device)


def _card(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the measuring loops time CUDA kernels; got device "
                         f"{device}")
    return device


def _timed(fn, x, iters: int):
    """(seconds, last input, last output) of ``iters`` chained launches,
    each fed the last one's output so that no cache can serve it, after one
    warm-up launch; by CUDA events."""
    fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = x
    for _ in range(iters):
        x, out = out, fn(out)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3, x, out


def alu_rate(op: str, device, *, rounds: int = 1 << 16, shape=(256, 1024),
             iters: int = 3) -> dict:
    """Sustained word rate of one u32 operation sequence on a CUDA card.

    Returns {"elems_per_s", "ops_per_s", "dt", "rounds", "device",
    "operands", "out"}; for "butterfly" an element is one butterfly (two
    words).  The words stay in registers for all ``rounds``; device memory
    is touched once at entry and exit.  ``operands`` are the (x, y, yp) of
    the last timed launch and ``out`` is what it stored."""
    device = _card(device)
    q = ALU_Q
    rng = np.random.default_rng(0)
    x = rng.integers(0, q, shape)
    y = rng.integers(1, q, shape)
    yp = (y.astype(np.uint64) << np.uint64(32)) // np.uint64(q)
    x, y, yp = (_bits(a, device) for a in (x, y, yp))
    dt, last, out = _timed(
        lambda cur: alu_rate_kernel(cur, y, yp, op, rounds), x, iters)
    elems = float(np.prod(shape)) * rounds * iters
    if op == "butterfly":
        elems /= 2
    return {"elems_per_s": elems / dt, "ops_per_s": elems * OP_COUNTS[op] / dt,
            "dt": dt, "rounds": rounds,
            "device": torch.cuda.get_device_name(device),
            "operands": (last, y, yp), "out": out}


# -- K12: the forward chain on a resident polynomial -------------------------

def _check_q(q: int) -> None:
    if not 1 < q < (1 << 31):
        raise ValueError(f"modulus {q}: the chain needs q < 2^31")


def ntt_smem_ceiling_plain(x, q: int, reps: int):
    """``reps`` forward transforms of x int32 [B, n] under the prime q."""
    _check_q(q)
    r = x[None]
    for _ in range(reps):
        r = ntt_cuda.ntt_multi_plain(r, (q,))
    return r[0]


# K12's split layout: at n = 2^16 each polynomial resident on a cluster of
# two blocks, one half each (csrc/bench_cuda.cu)
SPLIT_LOGN = ntt_cuda.CHUNK_LOGN + 1


def ceiling_layout(logn: int, layout: str | None = None) -> str:
    """K12's layout at 2^logn: one block a polynomial up to 2^15 ("block"),
    split at 2^16, chunked past it; at 2^16 ``layout`` may name the
    chunked schedule, to measure it there."""
    default = _cuda.SPLIT if logn == SPLIT_LOGN else ntt_cuda._layout(logn)
    if layout not in (None, default) and not (
            logn == SPLIT_LOGN and layout == _cuda.CHUNKED):
        raise ValueError(f"K12 layout {layout!r} at n = 2^{logn}")
    return layout or default


def ntt_smem_ceiling_kernel(x, q: int, reps: int, layout: str | None = None):
    """K12: one block per polynomial of x int32 [B, n], n = 2^7 .. 2^15, on
    K1's plan (``ntt_cuda._radix_plan``), the polynomial in shared memory for
    all ``reps`` chains.  At 2^16 one cluster of two blocks per polynomial,
    each holding a half for all ``reps`` transforms, the top stage through
    distributed shared memory (``layout`` "split", the rule there).  Past
    2^15 no block holds the polynomial: each of the ``reps`` transforms
    runs K1's chunked schedule (top passes through a scratch, then one
    block a chunk of 2^15 words; ``ntt_cuda._chunk_plan``), all queued by
    the one C call (``layout`` "chunked", the rule past 2^16).  Its default
    prime, the reference's 998244353, has 2n-th roots up to n = 2^22;
    2013265921 up to 2^26."""
    _check_q(q)
    dev = x.device
    _cuda.check(x, "x", dev)
    if x.ndim != 2 or reps < 0:
        raise ValueError(f"x has shape {tuple(x.shape)}, reps={reps}: need "
                         "[B, n] and reps >= 0")
    B, n = x.shape
    logn = _cuda.log2_degree(n, _cuda.NTT_SMEM_CEILING)
    layout = ceiling_layout(logn, layout)
    out = torch.empty_like(x)
    if B == 0:
        return out
    split = layout == _cuda.SPLIT
    tw = ntt_cuda._chunk_tables((q,), n, False, dev)
    cons = ntt_cuda._prime_rows((q,), None, dev)
    tmp = None if split else ntt_cuda._chunk_scratch(logn, x.numel(), dev)
    _cuda.NTT_SMEM_CEILING.launch(dev, x.data_ptr(), out.data_ptr(),
                                  None if tmp is None else tmp.data_ptr(),
                                  tw[0].data_ptr(), tw[1].data_ptr(),
                                  cons.data_ptr(), q, B, logn, reps,
                                  *ntt_cuda._transform_plan(logn), int(split),
                                  layout=layout)
    return out


def split_clusters(device) -> int:
    """The split ceiling's clusters of two that the card runs at once."""
    return _cuda.max_clusters("fhe_ceiling_split_clusters", device)


def ntt_smem_ceiling(device, q: int | None = None, n: int = 1 << 14, *,
                     B: int = 64, reps: int = 64, iters: int = 3,
                     layout: str | None = None) -> dict:
    """Butterflies/s of the forward chain on shared-memory-resident
    polynomials on a CUDA card: one load, ``reps`` transforms, one store.

    Returns {"butterflies_per_sec", "dt", "reps", "q", "n", "B", "layout",
    "device", "operands", "out"}: ``operands`` is the (x,) of the last
    timed launch and ``out`` what it stored.  B = 64 blocks leave half of a 132-SM card idle;
    pass a multiple of ``resident_blocks(device, n=n)`` for the whole card
    (past n = 2^15 that many chunks of 2^15 words: B = blocks * 2^15 / n;
    at 2^16 split, ``split_clusters``).  Past 2^16 no block holds the
    polynomial, so the rate is the ceiling of the chunked schedule (every
    transform through device memory), not of a resident chain; at 2^16
    that of the polynomial resident on a cluster of two blocks, or, with
    ``layout`` "chunked", of the chunked schedule there."""
    device = _card(device)
    if q is None:
        q = ntt_mod.CRT_PRIMES_TFHE[0]
    logn = n.bit_length() - 1
    rng = np.random.default_rng(0)
    x = _bits(rng.integers(0, q, (B, n)), device)
    dt, last, out = _timed(
        lambda cur: ntt_smem_ceiling_kernel(cur, q, reps, layout), x, iters)
    bf = B * reps * iters * logn * (n // 2)
    return {"butterflies_per_sec": bf / dt, "dt": dt, "reps": reps, "q": q,
            "n": n, "B": B, "layout": ceiling_layout(logn, layout),
            "device": torch.cuda.get_device_name(device),
            "operands": (last,), "out": out}
