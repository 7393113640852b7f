#!/usr/bin/env python3
"""Where a step of K10 (csrc/blind_rotate_cuda.cu) spends its cycles.

    python3 -m fhe_study_tpu_torch.utils.k10_phases [--steps 1024] [--batch 64]

Builds a copy of the kernel with a clock64() reading by thread 0 at each
phase boundary of a step (each boundary but the key wait and the last pass
is a block barrier, so thread 0's reading there is the block's), runs it at
N = 1024, K = 1, beta = 4096, l = 2 on random keys and accumulators, holds
its output equal to the kernel's, and prints the cycles a step of every phase,
mean, least and most over the blocks.  The counters cost a few percent of
the kernel's time.  Needs one CUDA card and nvcc (no torch headers).
"""

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..ops import _cuda
from ..ops import blind_rotate_cuda as brc
from ..ops import ntt as ntt_mod
from ..ops import ntt_cuda
from . import kernel_check, prng

PHASES = ("forward pass 0 (digits)", "forward passes 1..", "key wait",
          "contraction + inverse pass 0", "inverse passes 1..",
          "last inverse pass + push", "wait for the peer", "CRT")
SLOTS = 16
_COUNTERS = f"""
__device__ unsigned long long g_phase[4096 * {SLOTS}];
extern "C" int fhe_k10_phases(unsigned long long* host, int clear) {{
  static unsigned long long zero[4096 * {SLOTS}];
  return clear ? (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero))
               : (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(zero));
}}
#define FHE_PHASE(i) if (threadIdx.x == 0) {{ const long long t_ = clock64(); \\
  g_phase[blockIdx.x * {SLOTS} + (i)] += t_ - phase_t; phase_t = t_; }}
"""
# (text of the kernel, the same text with a counter in front of or after it)
_MARKS = (
    ('#include "radix_chain.cuh"\n', None),
    ("  const uint32_t kwords = static_cast<uint32_t>(fwd * cols) << LOGN;\n",
     "  long long phase_t = clock64();\n"),
    ("    BrPasses<LOGN, 1, S::passes, false>", 0),
    ("    // the contraction in the first inverse pass's registers", 1),
    ("    uint32_t* rb = res", 2),
    ("    if constexpr (STAGED) {\n      // the buffer is consumed", 3),
    ("    // the last inverse pass, times n^-1", 4),
    ("    // this block's columns, and the peer's", 5),
    ("    // exact CRT lift", 6),
    ("  }\n  // no store to the peer is left in flight", 7),
)


def instrumented_source(src: str) -> str:
    """The kernel's source with the phase counters; raises if a mark is not
    found exactly once (the kernel changed: update _MARKS)."""
    for mark, what in _MARKS:
        if src.count(mark) != 1:
            raise ValueError(f"k10_phases: mark {mark!r} found "
                             f"{src.count(mark)} times")
        if what is None:
            src = src.replace(mark, mark + _COUNTERS)
        elif isinstance(what, str):
            src = src.replace(mark, mark + what)
        else:
            src = src.replace(mark, f"    FHE_PHASE({what})\n" + mark)
    return src


def build(out: Path) -> ctypes.CDLL:
    cu = out / "blind_rotate_phases.cu"
    cu.write_text(instrumented_source(
        (_cuda.CSRC / "blind_rotate_cuda.cu").read_text()))
    so = out / "libk10_phases.so"
    res = subprocess.run([_cuda._nvcc(), *_cuda.ARCH, "-std=c++17", "-O3",
                          "-Xcompiler", "-fPIC", "-shared",
                          f"-I{_cuda.CSRC}", "-o", str(so), str(cu)],
                         capture_output=True, text=True, check=False)
    if res.returncode:
        raise _cuda.KernelBuildError(res.stderr)
    return ctypes.CDLL(str(so))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k10_phases: no CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    gen = prng.Gen(3)
    inputs = kernel_check.blind_rotate_inputs(1024, 1, 4096, 2, args.steps,
                                              args.batch, dev, gen)
    shifts, acc0, ev1, ev1s, ev2, ev2s, n, w = inputs
    want = brc.blind_rotate_kernel(*inputs)
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(Path(tmp))
        steps, B = shifts.shape
        C, l = acc0.shape[1], ev1.shape[2]
        plan = brc._plan(C, l, n)
        pq = ntt_mod.CRT_PRIMES_TFHE
        tw = ntt_cuda._twiddles(pq, n, False, dev)
        twinv = ntt_cuda._twiddles(pq, n, True, dev)
        cons = ntt_cuda._prime_rows(
            (pq[0], pq[1], pq[1]),
            (pow(n, -1, pq[0]), pow(n, -1, pq[1]), pow(pq[0], -1, pq[1])),
            dev)
        got = torch.empty_like(acc0)
        fn = lib.fhe_blind_rotate
        fn.argtypes = _cuda.BLIND_ROTATE.argtypes
        lib.fhe_k10_phases(None, 1)
        err = fn(shifts.data_ptr(), acc0.data_ptr(), ev1.data_ptr(),
                 ev1s.data_ptr(), ev2.data_ptr(), ev2s.data_ptr(),
                 got.data_ptr(), tw[0].data_ptr(), tw[1].data_ptr(),
                 twinv[0].data_ptr(), twinv[1].data_ptr(), cons.data_ptr(),
                 steps, B, C, l, w, plan.logn, plan.threads,
                 plan.smem_bytes, int(plan.staged),
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err or not torch.equal(got, want):
            raise RuntimeError(f"the instrumented kernel failed ({err}) or "
                               "differs from the kernel")
        cycles = np.zeros(4096 * SLOTS, dtype=np.uint64)
        lib.fhe_k10_phases(ctypes.c_void_p(cycles.ctypes.data), 0)
    per = cycles.reshape(-1, SLOTS)[:2 * B, :len(PHASES)] / steps
    print(f"K10 at N=1024, C=2, l=2, {steps} steps, B={B}, {2 * B} blocks "
          f"[{card}]: cycles a step of thread 0, mean (least, most) over "
          "the blocks")
    for i, name in enumerate(PHASES):
        col = per[:, i]
        print(f"  {name:30s} {col.mean():8.1f} ({col.min():.1f}, "
              f"{col.max():.1f})")
    print(f"  {'all':30s} {per.sum(1).mean():8.1f}", flush=True)


if __name__ == "__main__":
    main()
