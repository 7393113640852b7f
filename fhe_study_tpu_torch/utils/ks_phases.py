#!/usr/bin/env python3
"""Where a block of K7 (ks_fused) and K8 (ks_fused_eval), or of K6
(tensor_mul4), spends its cycles at n = 2^15, their split instance on
two-block clusters (csrc/ks_fused.cuh, csrc/tensor_mul4.cuh).

    python3 -m fhe_study_tpu_torch.utils.ks_phases [--csrc DIR] [--R 29 14]
        [--batch 128] [--k6]

Builds a copy of the kernels' units with a clock64() reading by thread 0
at each phase boundary of a block (each boundary is a block or cluster
barrier, so thread 0's reading there is the block's), runs each at
n = 2^15, holds its output equal to the package's kernel, and prints the
cycles of every phase, mean (least, most) over the blocks.

K7 and K8 (the default): R = L limb rows over the L primes of RNS-BFV's Q
(phase 19 of chip_smoke.py: L = 29, and phase 18's L = 14), B polynomials,
c_limbs and K8's adds strided views of one [L, B, 3, n] tensor; a phase is
counted a row of a block (a digit row, or one of K8's two add rows) or a
block.

``--k6``: K6 at the BFV tensor's arguments, for each L of ``--R``: over Q
(L primes), and over P (L + 1 primes) staged from the L primes of Q; then
over P direct from 4 primes (L = 4, M = 5), each on four [L, B, n]
operands with the scale t = 256; a phase is counted a block, for each
operand (y0, y1, x0, x1 in the kernel's order) and for the products and
the inverse chains.

``--csrc`` names another checkout's csrc directory (the parent's schedule,
with its own marks); the package's wrappers launch it, so its entry points
must take the same arguments.  The counters cost a few percent of the
kernels' time.  Needs one CUDA card and nvcc (no torch headers).
"""

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..models import bfv_rns
from ..ops import _cuda
from ..ops import ntt_cuda as nc
from . import prng

LOGN = 15
BLOCKS = 32768          # the most blocks a call may have (2 L B)


def _counters(slots: int) -> str:
    """The counters of a probe of `slots` phases and their read-out."""
    return f"""
__device__ unsigned long long g_phase[{BLOCKS} * {slots}];
extern "C" int fhe_phases(unsigned long long* host, int clear) {{
  static unsigned long long zero[{BLOCKS} * {slots}];
  return clear ? (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero))
               : (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(zero));
}}
#define FHE_PHASE(i) if (threadIdx.x == 0) {{ const long long t_ = clock64(); \\
  g_phase[blockIdx.x * {slots} + (i)] += t_ - phase_t; phase_t = t_; }}
"""


class Probe(NamedTuple):
    """A kernel header's probe: its phases (one counter each), its marks by
    schedule (the text of the header, each with what goes in; (text, None):
    the counters after it, (text, str): the string before it, (text,
    ("before" | "after", i)): a phase boundary, i a C++ expression of the
    slot), the units it builds (name -> the unit's text, None for the
    checkout's own unit of that name; each unit to its own library, with
    its own counters), the checkout's units those include, and the text
    that goes after the counters (stubs)."""
    header: str
    phases: tuple
    marks: dict
    units: dict
    copies: tuple = ()
    stub: str = ""


# K7 and K8: a unit's entry falls to the chunked schedule past 2^15, which
# the probe never takes: a stub stands for it
_KS_STUB = """
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
KS = Probe(
    header="ks_fused.cuh",
    # those of a digit row, those of K8's add rows, the closing
    phases=("digit rows: first pass (limb words, reduction, top stage, "
            "pass 0)",
            "digit rows: middle passes",
            "digit rows: last pass (key products)",
            "add rows: first pass", "add rows: middle passes",
            "add rows: last pass (e_h)",
            "closing: inverse passes of the halves",
            "closing: top stage across the cluster, output"),
    marks={
        # the new schedule's: split_words, the end of a row an arrival on
        # row_read (the next row's first pass waits before its first store:
        # from there a row's phases are thread 0's own), split_inverse_out
        "split_words": (
            ('#include "radix_chain.cuh"\n', None),
            ("  const int r = split ? cluster_rank() : 0;\n",
             "  long long phase_t = clock64();\n"),
            ("    RadixPasses<LOGH, 1, last, false, kKsThreads>::run(a, w, "
             "wsh, q);\n", ("before", "digit ? 0 : 3")),
            ("    // the last forward pass: K7's last row and K8's add rows "
             "end in the\n", ("before", "digit ? 1 : 4")),
            ("    if constexpr (split) {\n      token = mbar_arrive("
             "row_read());\n    } else {\n      __syncthreads();\n    }\n",
             ("after", "digit ? 2 : 5")),
            ("    split_inverse_out<LOGH, kKsThreads, 2>(\n", ("before", "6")),
            ("  } else {\n    RadixPasses<LOGH, 1, last, true, kKsThreads, "
             "2>::run(a + h, wi, wish, q);\n", ("before", "7")),
        ),
    },
    units={"ks_fused_cuda.cu": None, "ks_fused_eval_cuda.cu": None},
    stub=_KS_STUB)

# K6: one unit holds both of the checkout's (the entry and the staged
# instances), so that the counters are defined once; the chunked schedule
# past 2^15 is stubbed, and so is the lift, whose rows the package's own
# entry, called just before on the same arguments, leaves in the scratch
_K6_UNIT = """#include "tensor_mul4_staged_cuda.cu"
#include "tensor_mul4_cuda.cu"

namespace fhe {
int tensor_mul4_chunked(const uint32_t* const (&)[4], const Strides&,
                        uint32_t*, uint32_t*, uint32_t*, const uint32_t*,
                        const uint32_t*, const uint32_t*, const uint32_t*,
                        const uint32_t*, const uint32_t*, int, int, int, int,
                        int, int, cudaStream_t) {
  return static_cast<int>(cudaErrorInvalidValue);
}
int ext_lift(const LiftIn&, int, uint32_t*, const uint32_t*, int, int, int,
             int, cudaStream_t) {
  return 0;
}
}  // namespace fhe

// Fills `bytes` at p with 0xff words (no residue) on `stream`: the output
// the package's entry wrote, before the instrumented entry writes it again.
extern "C" int fhe_poison(void* p, long long bytes, cudaStream_t stream) {
  return static_cast<int>(
      cudaMemsetAsync(p, 0xff, static_cast<size_t>(bytes), stream));
}
"""
_K6_OPERANDS = ("y0", "y1", "x0", "x1")
_K6_PHASES = tuple(
    f"{o}: {what}" for o in _K6_OPERANDS for what in (
        "first pass (words or own-half sums; in registers the top stage "
        "and pass 0)",
        "top stage across the cluster (two cluster barriers)",
        "passes through shared memory",
        "last pass")) + (
    "prologue; x0's words into registers and the side",
    "products with x1's last pass and the first inverse pass",
    "inverse passes of the halves",
    "closing: top stage across the cluster, output")
_K6_COMMON = (
    ('#include "radix_chain.cuh"\n', None),
    ("  const int r = split ? cluster_rank() : 0;\n",
     "  long long phase_t = clock64();\n"),
    ("    if (k < 3) {\n", ("before", "4 * k + 2")),
    ("  }\n  // 3. x1's last pass; the products", ("before", "4 * k + 3")),
    ("  // 4. the rest of the three inverse chains\n", ("before", "17")),
)
_K6_FIN = ("    const uint32_t fin = cons[4 * p + 2], fin_sh = cons[4 * p + "
           "3];\n    uint32_t* out3 = out + (static_cast<size_t>(p) * B + b) "
           "* 3 * n;\n")
K6 = Probe(
    header="tensor_mul4.cuh",
    phases=_K6_PHASES,
    marks={
        # the parent's: the first stage word by word (split_word, or both
        # halves' sums) into shared memory, the chain from pass 0 there,
        # split_inverse_top
        "split_word": _K6_COMMON + (
            ("    if constexpr (split) {\n      // the first forward stage "
             "(bit 14)", ("before", "16")),
            ("      RadixPasses<LOGH, 0, last, false, kMul4Threads>::run(buf, "
             "wk, wshk, q);\n    } else if constexpr (LS == kStagedSrc) {",
             ("before", "4 * k")),
            (_K6_FIN + "    split_inverse_top<kMul4Threads>(\n",
             ("before", "18")),
            ("        [&](int k, int i, uint32_t v) { out3[k * n + r * h + i] "
             "= v; });\n", ("after", "19")),
        ),
        # the new one's: over Q split_words and pass 0 in registers; from a
        # source basis the own half's sums, then the stage across the
        # cluster (split_top_stage); split_inverse_out
        "split_words": _K6_COMMON + (
            ("    if constexpr (split && LS == kNoSrc) {\n", ("before", "16")),
            ("      RadixPasses<LOGH, 1, last, false, kMul4Threads>::run(buf, "
             "wk, wshk, q);\n    } else if constexpr (split) {",
             ("before", "4 * k")),
            ("      cluster_sync();\n      split_top_stage<LOGH, kMul4Threads, "
             "false>(\n", ("before", "4 * k")),
            ("      RadixPasses<LOGH, 0, last, false, kMul4Threads>::run(buf, "
             "wk, wshk, q);\n    } else if constexpr (LS == kStagedSrc) {",
             ("before", "4 * k + 1")),
            (_K6_FIN + "    split_inverse_out<LOGH, kMul4Threads, 3>(\n",
             ("before", "18")),
            ("        [&](int k, int i, uint32_t v) { out3[k * n + i] = v; "
             "});\n", ("after", "19")),
        ),
    },
    units={"tensor_mul4_phases.cu": _K6_UNIT},
    copies=("tensor_mul4_cuda.cu", "tensor_mul4_staged_cuda.cu"))


def instrumented(probe: Probe, src: str) -> tuple:
    """(schedule, the header's text with the phase counters) for the first
    schedule whose marks are each found exactly once; raises if none is."""
    for name, marks in probe.marks.items():
        if all(src.count(mark) == 1 for mark, _ in marks):
            break
    else:
        raise ValueError(f"ks_phases: no schedule's marks match "
                         f"{probe.header} (the kernel changed: update its "
                         "marks)")
    for mark, what in marks:
        if what is None:
            src = src.replace(mark, mark + _counters(len(probe.phases))
                              + probe.stub)
        elif isinstance(what, str):
            src = src.replace(mark, what + mark)
        else:
            at = f"    FHE_PHASE({what[1]})\n"
            src = src.replace(mark, at + mark if what[0] == "before"
                              else mark + at)
    return name, src


def build(probe: Probe, csrc: Path, out: Path) -> tuple:
    """(schedule, {unit: (CDLL, ptxas's report of its n = 2^15
    instances)}) of the instrumented units, built in parallel."""
    schedule, text = instrumented(probe, (csrc / probe.header).read_text())
    (out / probe.header).write_text(text)
    for unit in probe.copies:
        shutil.copy(csrc / unit, out / unit)

    def one(item):
        unit, body = item
        if body is None:
            shutil.copy(csrc / unit, out / unit)
        else:
            (out / unit).write_text(body)
        so = out / f"lib{Path(unit).stem}_phases.so"
        res = subprocess.run([_cuda._nvcc(), *_cuda.ARCH, "-std=c++17", "-O3",
                              "-Xptxas=-v", "-Xcompiler", "-fPIC", "-shared",
                              f"-I{csrc}", "-o", str(so), str(out / unit)],
                             capture_output=True, text=True, check=False)
        if res.returncode:
            raise _cuda.KernelBuildError(res.stderr)
        wide = [r for r in _cuda.ptxas_report(res.stdout + res.stderr)
                if re.search(rf"<{LOGN}[,>]", r["kernel"])]
        return ctypes.CDLL(str(so)), wide

    with ThreadPoolExecutor(len(probe.units)) as pool:
        built = dict(zip(probe.units, pool.map(one, probe.units.items())))
    return schedule, built


def run(kernel, lib, call, blocks: int, slots: int,
        swap=None) -> np.ndarray:
    """[blocks, slots] cycles of one call through the instrumented
    library's entry (swapped in for the package's, or swap(package's,
    instrumented) where given), its output held equal to the package's
    kernel."""
    want = call()
    fn = getattr(lib, kernel.symbol)
    fn.argtypes = kernel.argtypes
    fn.restype = ctypes.c_int
    saved = kernel._fn
    kernel._fn = fn if swap is None else swap(saved, fn)
    try:
        lib.fhe_phases(None, 1)
        got = call()
        torch.cuda.synchronize()
    finally:
        kernel._fn = saved
    if isinstance(want, torch.Tensor):
        got, want = (got,), (want,)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError(f"ks_phases: the instrumented {kernel.name} "
                           "differs from the kernel")
    cycles = np.zeros(BLOCKS * slots, dtype=np.uint64)
    lib.fhe_phases(ctypes.c_void_p(cycles.ctypes.data), 0)
    return cycles.reshape(-1, slots)[:blocks].astype(np.float64)


def _report(per: np.ndarray, probe: Probe, per_row) -> None:
    """One line a phase that ran: cycles of thread 0 a row (per_row(i):
    the rows phase i counts over) or a block, mean (least, most) over the
    blocks; then a block's sum."""
    for i, name in enumerate(probe.phases):
        if not per[:, i].any():
            continue
        rows = per_row(i)
        col = per[:, i] / rows
        print(f"  {name:78s} {col.mean():10.1f} ({col.min():.1f}, "
              f"{col.max():.1f}) a {'row' if rows > 1 else 'block'}")
    print(f"  {'all, a block':78s} {per.sum(1).mean():10.1f}", flush=True)


def _print_ptxas(built: dict, schedule: str) -> None:
    for unit, (_, wide) in built.items():
        print(f"ks_phases: {unit} ({schedule}) ptxas: " + "; ".join(
            f"{r['kernel']} {r['registers']} registers, "
            f"{r['stack']} bytes stack, {r['spill_stores']} bytes spill "
            f"stores" for r in wide), flush=True)


def ks(args, dev, card: str) -> None:
    """K7 and K8 at R = L limb rows over Q, for each L of --R."""
    B, n = args.batch, 1 << LOGN
    with tempfile.TemporaryDirectory() as tmp:
        schedule, libs = build(KS, Path(args.csrc), Path(tmp))
        _print_ptxas(libs, schedule)
        units = tuple(KS.units)
        for L in args.R:
            qs = bfv_rns.RnsParam(n=n, t=256, L=L, M=L + 1).qs
            res = prng.device_residues(L, dev)
            c3 = res(qs, (B, 3, n))
            kb, ka = (res(qs, (L, n)).transpose(0, 1).contiguous()
                      for _ in range(2))
            c, adds = c3[..., 2, :], (c3[..., 0, :], c3[..., 1, :])
            calls = {
                _cuda.KS_FUSED: (units[0], lambda: nc.ks_fused_kernel(
                    c, kb, ka, qs, qs)),
                _cuda.KS_FUSED_EVAL: (
                    units[1], lambda: nc.ks_fused_eval_kernel(
                        c, kb, ka, qs, qs, adds))}
            for kernel, (unit, call) in calls.items():
                per = run(kernel, libs[unit][0], call, 2 * L * B,
                          len(KS.phases))
                print(f"{kernel.name} ({schedule}) at n=2^{LOGN}, R=L={L}, "
                      f"B={B}, {2 * L * B} blocks [{card}]: cycles of thread "
                      "0, mean (least, most) over the blocks", flush=True)
                # the first six a row (R digit rows, 2 add rows)
                _report(per, KS,
                        lambda i: (L if i < 3 else 2) if i < 6 else 1)
            del c3, kb, ka, c, adds
            torch.cuda.empty_cache()


def k6(args, dev, card: str) -> None:
    """K6 over Q and over P staged from Q, for each L of --R, then over P
    direct from 4 primes."""
    B, n, t = args.batch, 1 << LOGN, 256
    cases = []
    for L in args.R:
        param = bfv_rns.RnsParam(n=n, t=t, L=L, M=L + 1)
        cases += [(f"over Q, L={L}", param.qs, param.qs, None),
                  (f"over P ({L + 1}) staged from {L}", param.qs, param.ps,
                   param.qs)]
    param = bfv_rns.RnsParam(n=n, t=t, L=4, M=5)
    cases.append(("over P (5) direct from 4", param.qs, param.ps, param.qs))
    with tempfile.TemporaryDirectory() as tmp:
        schedule, libs = build(K6, Path(args.csrc), Path(tmp))
        _print_ptxas(libs, schedule)
        lib = libs["tensor_mul4_phases.cu"][0]
        lib.fhe_poison.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_void_p]
        lib.fhe_poison.restype = ctypes.c_int

        def chained(package, probe):
            """The package's entry (the lift into the scratch, and the
            kernel), its output poisoned, then the instrumented entry on
            the same arguments: (.., out at 14, .., Ls, Ld, B, logn,
            threads, smem, stream)."""
            def call(*a):
                ld, b, logn, stream = a[-6], a[-5], a[-4], a[-1]
                return (package(*a)
                        or lib.fhe_poison(a[14], 12 * ld * b << logn, stream)
                        or probe(*a))
            return call

        for label, qs, dst, src in cases:
            res = prng.device_residues(len(qs) + len(dst), dev)
            ops = [res(qs, (B, n)) for _ in range(4)]
            scale = (t,) * len(dst)
            per = run(_cuda.TENSOR_MUL4, lib,
                      lambda: nc.tensor_mul4_kernel(*ops, dst, scale=scale,
                                                    src=src),
                      2 * len(dst) * B, len(K6.phases), swap=chained)
            print(f"tensor_mul4 ({schedule}) at n=2^{LOGN}, {label}, B={B}, "
                  f"{2 * len(dst) * B} blocks [{card}]: cycles of thread 0, "
                  "mean (least, most) over the blocks", flush=True)
            _report(per, K6, lambda i: 1)
            del ops
            torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", default=str(_cuda.CSRC))
    ap.add_argument("--R", type=int, nargs="+", default=[29, 14])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--k6", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ks_phases: no CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    if 2 * (max(args.R) + 1) * args.batch > BLOCKS:
        sys.exit(f"ks_phases: at most {BLOCKS} blocks (2 M B)")
    (k6 if args.k6 else ks)(args, dev, card)


if __name__ == "__main__":
    main()
