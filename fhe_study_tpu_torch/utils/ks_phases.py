#!/usr/bin/env python3
"""Where a block of K7 (ks_fused) and K8 (ks_fused_eval) spends its cycles at
n = 2^15, their split instance on two-block clusters (csrc/ks_fused.cuh).

    python3 -m fhe_study_tpu_torch.utils.ks_phases [--csrc DIR] [--R 29 14]
        [--batch 128]

Builds a copy of the two kernels' units with a clock64() reading by thread 0
at each phase boundary of a block (each boundary is a block or cluster
barrier, so thread 0's reading there is the block's), runs each at
n = 2^15, R = L limb rows over the L primes of RNS-BFV's Q (phase 19 of
chip_smoke.py: L = 29, and phase 18's L = 14), B polynomials, c_limbs and
K8's adds strided views of one [L, B, 3, n] tensor, holds its output equal
to the package's kernel, and prints the cycles of every phase, a row of a
block (a digit row, or one of K8's two add rows) or a block, mean (least,
most) over the blocks.  ``--csrc`` names another checkout's csrc directory
(the parent's schedule, with its own marks); the package's wrappers launch
it, so its entry points must take the same arguments.  The counters cost a
few percent of the kernels' time.  Needs one CUDA card and nvcc (no torch
headers).
"""

import argparse
import ctypes
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..models import bfv_rns
from ..ops import _cuda
from ..ops import ntt_cuda as nc
from . import prng

LOGN = 15
SLOTS = 8
BLOCKS = 32768          # the most blocks a call may have (2 L B)
# the phases: those of a digit row, those of K8's add rows, the closing
PHASES = ("digit rows: first pass (limb words, reduction, top stage, pass 0)",
          "digit rows: middle passes",
          "digit rows: last pass (key products)",
          "add rows: first pass", "add rows: middle passes",
          "add rows: last pass (e_h)",
          "closing: inverse passes of the halves",
          "closing: top stage across the cluster, output")
_COUNTERS = f"""
__device__ unsigned long long g_phase[{BLOCKS} * {SLOTS}];
extern "C" int fhe_ks_phases(unsigned long long* host, int clear) {{
  static unsigned long long zero[{BLOCKS} * {SLOTS}];
  return clear ? (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero))
               : (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(zero));
}}
#define FHE_PHASE(i) if (threadIdx.x == 0) {{ const long long t_ = clock64(); \\
  g_phase[blockIdx.x * {SLOTS} + (i)] += t_ - phase_t; phase_t = t_; }}
"""
# the units (each with its own counters) and the header they include; a
# unit's entry falls to the chunked schedule past 2^15, which the probe
# never takes: a stub stands for it
UNITS = ("ks_fused_cuda.cu", "ks_fused_eval_cuda.cu")
HEADER = "ks_fused.cuh"
_STUB = """
namespace fhe {
int ks_fused_chunked(const uint32_t*, long long, long long, const uint32_t*,
                     const uint32_t*, const uint32_t*, long long, long long,
                     const uint32_t*, long long, long long, uint32_t*,
                     uint32_t*, const uint32_t*, const uint32_t*,
                     const uint32_t*, const uint32_t*, const uint32_t*,
                     const uint32_t*, int, int, int, int, int, int, int,
                     cudaStream_t) {
  return static_cast<int>(cudaErrorInvalidValue);
}
}  // namespace fhe
"""
# Each schedule's marks in the header: (text, what) with what None (the
# counters after it), a string (put before it), ("before", i) or
# ("after", i) (a phase boundary, i a C++ expression of the slot).
MARKS = {
    # the parent's: ks_body's split branches (split_word, split_inverse_top)
    "split_word": (
        ('#include "radix_chain.cuh"\n', None),
        ("  const int r = split ? cluster_rank() : 0;\n",
         "  long long phase_t = clock64();\n"),
        ("    RadixPasses<LOGH, 1, last, false, kKsThreads>::run(a, w, wsh, "
         "q);\n", ("before", "digit ? 0 : 3")),
        ("    // the last forward pass: K7's last row and K8's add rows end "
         "in the\n", ("before", "digit ? 1 : 4")),
        ("    __syncthreads();               // the next row's first pass "
         "reuses a\n", ("after", "digit ? 2 : 5")),
        ("    split_inverse_top<kKsThreads>(\n", ("before", "6")),
        ("  } else {\n    RadixPasses<LOGH, 1, last, true, kKsThreads, "
         "2>::run(a + h, wi, wish, q);\n", ("before", "7")),
    ),
    # the new one's: split_words, the end of a row an arrival on row_read
    # (the next row's first pass waits before its first store: from there
    # a row's phases are thread 0's own), split_inverse_out
    "split_words": (
        ('#include "radix_chain.cuh"\n', None),
        ("  const int r = split ? cluster_rank() : 0;\n",
         "  long long phase_t = clock64();\n"),
        ("    RadixPasses<LOGH, 1, last, false, kKsThreads>::run(a, w, wsh, "
         "q);\n", ("before", "digit ? 0 : 3")),
        ("    // the last forward pass: K7's last row and K8's add rows end "
         "in the\n", ("before", "digit ? 1 : 4")),
        ("    if constexpr (split) {\n      token = mbar_arrive(row_read());\n"
         "    } else {\n      __syncthreads();\n    }\n",
         ("after", "digit ? 2 : 5")),
        ("    split_inverse_out<LOGH, kKsThreads, 2>(\n", ("before", "6")),
        ("  } else {\n    RadixPasses<LOGH, 1, last, true, kKsThreads, "
         "2>::run(a + h, wi, wish, q);\n", ("before", "7")),
    ),
}


def instrumented(src: str) -> tuple:
    """(schedule, the header's text with the phase counters) for the first
    schedule whose marks are each found exactly once; raises if none is."""
    for name, marks in MARKS.items():
        if all(src.count(mark) == 1 for mark, _ in marks):
            break
    else:
        raise ValueError("ks_phases: no schedule's marks match the header "
                         "(the kernel changed: update MARKS)")
    for mark, what in marks:
        if what is None:
            src = src.replace(mark, mark + _COUNTERS + _STUB)
        elif isinstance(what, str):
            src = src.replace(mark, what + mark)
        else:
            at = f"    FHE_PHASE({what[1]})\n"
            src = src.replace(mark, at + mark if what[0] == "before"
                              else mark + at)
    return name, src


def build(csrc: Path, out: Path) -> tuple:
    """(schedule, {unit: CDLL}) of the instrumented units, built in
    parallel."""
    schedule, text = instrumented((csrc / HEADER).read_text())
    (out / HEADER).write_text(text)

    def one(unit):
        shutil.copy(csrc / unit, out / unit)
        so = out / f"lib{Path(unit).stem}_phases.so"
        res = subprocess.run([_cuda._nvcc(), *_cuda.ARCH, "-std=c++17", "-O3",
                              "-Xptxas=-v", "-Xcompiler", "-fPIC", "-shared",
                              f"-I{csrc}", "-o", str(so), str(out / unit)],
                             capture_output=True, text=True, check=False)
        if res.returncode:
            raise _cuda.KernelBuildError(res.stderr)
        spills = [r for r in _cuda.ptxas_report(res.stdout + res.stderr)
                  if "<15>" in r["kernel"]]
        return ctypes.CDLL(str(so)), spills

    with ThreadPoolExecutor(len(UNITS)) as pool:
        built = dict(zip(UNITS, pool.map(one, UNITS)))
    return schedule, built


def run(kernel, lib, call, blocks: int) -> np.ndarray:
    """[blocks, SLOTS] cycles of one call through the instrumented
    library's entry (swapped in for the package's), its output held equal
    to the package's kernel."""
    want = call()
    fn = getattr(lib, kernel.symbol)
    fn.argtypes = kernel.argtypes
    fn.restype = ctypes.c_int
    saved, kernel._fn = kernel._fn, fn
    try:
        lib.fhe_ks_phases(None, 1)
        got = call()
        torch.cuda.synchronize()
    finally:
        kernel._fn = saved
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError(f"ks_phases: the instrumented {kernel.name} "
                           "differs from the kernel")
    cycles = np.zeros(BLOCKS * SLOTS, dtype=np.uint64)
    lib.fhe_ks_phases(ctypes.c_void_p(cycles.ctypes.data), 0)
    return cycles.reshape(-1, SLOTS)[:blocks].astype(np.float64)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", default=str(_cuda.CSRC))
    ap.add_argument("--R", type=int, nargs="+", default=[29, 14])
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ks_phases: no CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    B, n = args.batch, 1 << LOGN
    if 2 * max(args.R) * B > BLOCKS:
        sys.exit(f"ks_phases: at most {BLOCKS} blocks (2 R B)")
    with tempfile.TemporaryDirectory() as tmp:
        schedule, libs = build(Path(args.csrc), Path(tmp))
        for unit, (_, spills) in libs.items():
            print(f"ks_phases: {unit} ({schedule}) ptxas: " + "; ".join(
                f"{r['kernel']} {r['registers']} registers, "
                f"{r['spill_stores']} bytes spill stores" for r in spills),
                flush=True)
        for L in args.R:
            qs = bfv_rns.RnsParam(n=n, t=256, L=L, M=L + 1).qs
            res = prng.device_residues(L, dev)
            c3 = res(qs, (B, 3, n))
            kb, ka = (res(qs, (L, n)).transpose(0, 1).contiguous()
                      for _ in range(2))
            c, adds = c3[..., 2, :], (c3[..., 0, :], c3[..., 1, :])
            calls = {
                _cuda.KS_FUSED: (UNITS[0], lambda: nc.ks_fused_kernel(
                    c, kb, ka, qs, qs)),
                _cuda.KS_FUSED_EVAL: (
                    UNITS[1], lambda: nc.ks_fused_eval_kernel(
                        c, kb, ka, qs, qs, adds))}
            for kernel, (unit, call) in calls.items():
                per = run(kernel, libs[unit][0], call, 2 * L * B)
                print(f"{kernel.name} ({schedule}) at n=2^{LOGN}, R=L={L}, "
                      f"B={B}, {2 * L * B} blocks [{card}]: cycles of thread "
                      "0, mean (least, most) over the blocks", flush=True)
                for i, name in enumerate(PHASES):
                    if not per[:, i].any():
                        continue
                    # the first six a row (R digit rows, 2 add rows)
                    col = per[:, i] / ((L if i < 3 else 2) if i < 6 else 1)
                    print(f"  {name:62s} {col.mean():10.1f} ({col.min():.1f}, "
                          f"{col.max():.1f}) a {'row' if i < 6 else 'block'}")
                print(f"  {'all, a block':62s} {per.sum(1).mean():10.1f}",
                      flush=True)
            del c3, kb, ka, c, adds
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
