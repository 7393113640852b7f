#!/usr/bin/env python3
"""Where a step of K10 (csrc/blind_rotate_cuda.cu) spends its cycles.

    python3 -m fhe_study_tpu_torch.utils.k10_phases [--steps 1024] [--batch 64]
    python3 -m fhe_study_tpu_torch.utils.k10_phases --device [--steps 400]
        [--batch 64]
    python3 -m fhe_study_tpu_torch.utils.k10_phases --grid [--steps 16]
        [--batch 64]
    python3 -m fhe_study_tpu_torch.utils.k10_phases --quarter [--steps 16]
        [--batch 64]

Builds a copy of the kernel with a clock64() reading by thread 0 at each
phase boundary of a step (each boundary but the key wait and the last pass
is a block barrier, so thread 0's reading there is the block's), runs it at
N = 1024, K = 1, beta = 4096, l = 2 on random keys and accumulators, holds
its output equal to the kernel's, and prints the cycles a step of every phase,
mean, least and most over the blocks.  The counters cost a few percent of
the kernel's time.  Needs one CUDA card and nvcc (no torch headers).

``--device`` probes the device-memory layout (csrc/blind_rotate_dm_cuda.cu)
at the two shapes of chip_smoke.py's phase 21 (N = 4096, beta = 2^11,
l = 2 and N = 2^15, beta = 2^8, l = 3; K = 1, ``--batch`` ciphertexts,
``--steps`` CMux steps): a copy of its unit with a clock64() reading by
thread 0 at each phase boundary of a block (block or cluster barriers but
the forward's end, which is thread 0's own), swapped in for the package's
entry and held equal to it, gives the cycles a step of every phase of the
forward and the inverse blocks; CUDA events give the device time of a
one-step call (the accumulator's copy and one launch of each) and of the
whole chain; one ``torch.profiler`` window over the whole chain gives each
launch's device time by kernel and the idle gaps between the launches.

``--grid`` times the grid layout (csrc/blind_rotate_grid_cuda.cu) at
chip_smoke.py's phase 22 shape at 2^17 (N = 2^17, beta = 2^5, l = 6, K = 1,
``--batch`` ciphertexts, ``--steps`` CMux steps, 16 by default: a prefix of
the path's 400, each step alike): CUDA events over the chain, and one
``torch.profiler`` window's device time by launch kind (the forward's top
pass, the chunk chains forward, the chunk chains inverse with the
contraction, the last top pass with the CRT and the add) and the idle gaps.

``--quarter`` probes the quarter layout (csrc/blind_rotate_quarter_cuda.cu)
at the same shape: the inverse clusters of eight the card runs at once,
the package's build against the grid layout (CUDA events, in turns) and its
launches from the profiler; then copies of the unit with a clock64()
reading by thread 0 at each phase boundary of a block (block or cluster
barriers but the forward's end), swapped in for the package's entry and
held equal to the grid layout's output, gives the cycles a step of every
phase and its launches.
"""

import argparse
import ctypes
import json
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


# the other layouts' entry points, which fhe_blind_rotate names and the
# probe never takes
_LAYOUT_STUBS = """
namespace fhe {
#define FHE_LAYOUT_STUB(name, ...) \\
  int name(const int*, const unsigned long long*, const uint32_t*, \\
           const uint32_t*, const uint32_t*, const uint32_t*, \\
           unsigned long long*, uint32_t*, const uint32_t*, const uint32_t*, \\
           const uint32_t*, const uint32_t*, const uint32_t*, int, int, int, \\
           int, int, int, int, int, __VA_ARGS__ cudaStream_t) { \\
    return static_cast<int>(cudaErrorInvalidValue); \\
  }
FHE_LAYOUT_STUB(blind_rotate_dm, int,)
FHE_LAYOUT_STUB(blind_rotate_grid, int,)
FHE_LAYOUT_STUB(blind_rotate_split, int,)
}  // namespace fhe
"""


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
        (_cuda.CSRC / "blind_rotate_cuda.cu").read_text()) + _LAYOUT_STUBS)
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
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", action="store_true")
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--quarter", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k10_phases: no CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    if args.device:
        device_layout(args.steps or 400, args.batch, dev, card)
        return
    if args.grid:
        grid_layout(args.steps or 16, args.batch, dev, card)
        return
    if args.quarter:
        quarter_layout(args.steps or 16, args.batch, dev, card)
        return
    args.steps = args.steps or 1024
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
                 None, steps, B, C, l, w, plan.logn, plan.threads,
                 plan.smem_bytes, int(plan.staged), 0,
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


# -- the device-memory layout ---------------------------------------------

DM_UNIT = "blind_rotate_dm_cuda.cu"
DM_PHASES = ("forward: digits and pass 0", "forward: passes 1.. and the store",
             "inverse: contraction", "inverse: passes before the last",
             "inverse: last pass (n^-1 2^32)", "inverse: cluster wait",
             "inverse: CRT lift and 64-bit atomics")
DM_CONFIGS = ((1 << 12, 1 << 11, 2), (1 << 15, 1 << 8, 3))
DM_BLOCKS = 4096
# the probe's entry: fhe_blind_rotate's arguments, into blind_rotate_dm as
# fhe_blind_rotate calls it for layout 1
_DM_ENTRY = """
extern "C" int fhe_k10dm_probe(
    const int* shifts, const unsigned long long* acc0, const uint32_t* ev1,
    const uint32_t* ev1s, const uint32_t* ev2, const uint32_t* ev2s,
    unsigned long long* out, const uint32_t* tw, const uint32_t* tw_sh,
    const uint32_t* twinv, const uint32_t* twinv_sh, const uint32_t* cons,
    uint32_t* scratch, int steps, int B, int C, int l, int w, int logn,
    int threads, int smem, int staged, int layout, cudaStream_t stream) {
  const bool aligned = !(fhe::misaligned(ev1) || fhe::misaligned(ev1s) ||
                         fhe::misaligned(ev2) || fhe::misaligned(ev2s));
  if (layout != 1 || staged) return static_cast<int>(cudaErrorInvalidValue);
  return fhe::blind_rotate_dm(shifts, acc0, ev1, ev1s, ev2, ev2s, out,
                              scratch, tw, tw_sh, twinv, twinv_sh, cons,
                              steps, B, C, l, w, logn, threads, smem,
                              aligned ? 1 : 0, stream);
}
"""
# (text of the unit, what): None the counters after it, a str that string
# after it, an int a phase boundary before it, ("after", i) one after it,
# ("after-brace", i) one before the kernel's closing brace
DM_MARKS = (
    ('#include "radix_chain.cuh"\n', None),
    ("  const int shift = 64 - w * (f - cc * l + 1);\n",
     "  long long phase_t = clock64();\n"),
    ("  RadixPasses<LOGN, 1, S::passes, false, S::threads>::run(\n", 0),
    ("    row[i] = make_uint4(a[sw], a[sw ^ 1], a[sw ^ 2], a[sw ^ 3]);\n"
     "  }\n}\n", ("after-brace", 1)),
    ("  const int cols = 2 * C;\n", "  long long phase_t = clock64();\n"),
    ("  RadixPasses<LOGN, 0, last, true, S::threads>::run(\n", 2),
    ("#pragma unroll 1\n  for (int gi = 0; gi < S::groups; ++gi) {\n"
     "    const int base = radix_base(threadIdx.x + gi * S::threads, cl);\n",
     3),
    ("  // both primes' columns are complete and visible to the cluster\n"
     "  cluster_sync();\n", 4),
    ("  const uint32_t peer = cluster_addr(a, p ^ 1);\n", 5),
    ("  // the peer has read this block's words before any block exits\n"
     "  cluster_sync();\n", ("after", 6)),
)


def _dm_counters() -> str:
    slots = len(DM_PHASES)
    return f"""
__device__ unsigned long long g_phase[{DM_BLOCKS} * {slots}];
extern "C" int fhe_k10_phases(unsigned long long* host, int clear) {{
  static unsigned long long zero[{DM_BLOCKS} * {slots}];
  return clear ? (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero))
               : (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(zero));
}}
#define FHE_PHASE(i) if (threadIdx.x == 0 && blockIdx.x < {DM_BLOCKS}) {{ \\
  const long long t_ = clock64(); \\
  g_phase[blockIdx.x * {slots} + (i)] += t_ - phase_t; phase_t = t_; }}
"""


def dm_instrumented(src: str) -> str:
    """The unit's text with the phase counters and the probe's entry, whose
    arguments are fhe_blind_rotate's; raises if a mark is not found exactly
    once (the kernel changed: update DM_MARKS)."""
    for mark, what in DM_MARKS:
        if src.count(mark) != 1:
            raise ValueError(f"k10_phases: mark {mark!r} found "
                             f"{src.count(mark)} times in {DM_UNIT}")
        if what is None:
            src = src.replace(mark, mark + _dm_counters())
        elif isinstance(what, str):
            src = src.replace(mark, mark + what)
        elif isinstance(what, int):
            src = src.replace(mark, f"  FHE_PHASE({what})\n" + mark)
        elif what[0] == "after":
            src = src.replace(mark, mark + f"  FHE_PHASE({what[1]})\n")
        else:     # before the closing brace of the kernel
            src = src.replace(mark, mark[:-2] + f"  FHE_PHASE({what[1]})\n}}\n")
    return src + _DM_ENTRY


def dm_build(out: Path) -> tuple:
    """(CDLL, ptxas's lines) of the instrumented unit."""
    cu = out / "blind_rotate_dm_phases.cu"
    cu.write_text(dm_instrumented((_cuda.CSRC / DM_UNIT).read_text()))
    so = out / "libk10dm_phases.so"
    res = subprocess.run([_cuda._nvcc(), *_cuda.ARCH, "-std=c++17", "-O3",
                          "-Xptxas=-v", "-Xcompiler", "-fPIC", "-shared",
                          f"-I{_cuda.CSRC}", "-o", str(so), str(cu)],
                         capture_output=True, text=True, check=False)
    if res.returncode:
        raise _cuda.KernelBuildError(res.stderr)
    report = [f"{r['kernel']} {r['registers']} registers, {r['stack']} bytes "
              f"stack, {r['spill_stores']} bytes spill stores"
              for r in _cuda.ptxas_report(res.stdout + res.stderr)]
    return ctypes.CDLL(str(so)), report


# the device-memory layout's launch kinds: (label, text of the kernel's name)
DM_KINDS = (("forward", "forward"), ("inverse", "inverse"))


def launch_gaps(fn, kinds: tuple = DM_KINDS) -> dict:
    """Device time by launch kind (the first of ``kinds`` whose text the
    kernel's name holds; "copy" otherwise) and the idle gaps between
    consecutive device activities (kernels and copies) of one call of fn,
    from a torch.profiler window (its Chrome trace)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    evs = sorted((e["ts"], e["dur"], e["name"])
                 for e in trace.get("traceEvents", [])
                 if e.get("ph") == "X" and e.get("cat") in (
                     "kernel", "gpu_memcpy", "gpu_memset"))
    if not evs:
        return {}
    by = {}
    for _, dur, name in evs:
        key = next((label for label, text in kinds if text in name), "copy")
        by.setdefault(key, []).append(dur)
    gaps = np.array([b[0] - (a[0] + a[1]) for a, b in zip(evs, evs[1:])])
    return {"launches": len(evs),
            "by_kernel_us": {k: (float(np.mean(v)), float(np.min(v)),
                                 float(np.max(v)), len(v))
                             for k, v in by.items()},
            "span_us": evs[-1][0] + evs[-1][1] - evs[0][0],
            "busy_us": float(sum(e[1] for e in evs)),
            "gap_us": (float(gaps.sum()), float(np.mean(gaps)),
                       float(np.median(gaps)), float(gaps.max()))}


def _events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(3):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def device_layout(steps: int, B: int, dev, card: str) -> None:
    """The --device run (see the module docstring)."""
    kernel = _cuda.BLIND_ROTATE
    with tempfile.TemporaryDirectory() as tmp:
        lib, report = dm_build(Path(tmp))
        print("k10_phases --device ptxas: " + "; ".join(
            r for r in report if "<12" in r or "<15" in r), flush=True)
        probe = lib.fhe_k10dm_probe
        probe.argtypes = kernel.argtypes
        probe.restype = ctypes.c_int
        for n, beta, l in DM_CONFIGS:
            gen = prng.Gen(26 + n)
            inputs = kernel_check.blind_rotate_inputs(n, 1, beta, l, steps,
                                                      B, dev, gen)
            plan = brc._plan(2, l, n)
            if plan.layout != "device":
                raise RuntimeError(f"k10_phases: plan {plan}")
            call = lambda: brc.blind_rotate_kernel(*inputs)  # noqa: E731
            want = call()
            saved = kernel._fn
            kernel._fn = probe
            try:
                lib.fhe_k10_phases(None, 1)
                got = call()
                torch.cuda.synchronize()
            finally:
                kernel._fn = saved
            if not torch.equal(got, want):
                raise RuntimeError("k10_phases: the instrumented device "
                                   "layout differs from the kernel")
            cycles = np.zeros(DM_BLOCKS * len(DM_PHASES), dtype=np.uint64)
            lib.fhe_k10_phases(ctypes.c_void_p(cycles.ctypes.data), 0)
            per = cycles.reshape(DM_BLOCKS, -1).astype(np.float64) / steps
            shape = (f"N={n} C=2 l={l} beta=2^{beta.bit_length() - 1} "
                     f"B={B} steps={steps}")
            print(f"k10_phases --device at {shape}, plan "
                  f"threads={plan.threads} cluster={plan.cluster} "
                  f"smem={plan.smem_bytes} staged={plan.staged} [{card}]: "
                  "cycles a step of thread 0, mean (least, most) over the "
                  "blocks that ran the phase", flush=True)
            for i, name in enumerate(DM_PHASES):
                col = per[:, i][per[:, i] > 0]
                if col.size:
                    print(f"  {name:40s} {col.mean():10.1f} ({col.min():.1f},"
                          f" {col.max():.1f}) over {col.size} blocks")
            fwd = per[:, :2].sum(1)
            inv = per[:, 2:].sum(1)
            print(f"  {'forward block, all':40s} {fwd[fwd > 0].mean():10.1f}"
                  f"\n  {'inverse block, all':40s} {inv[inv > 0].mean():10.1f}",
                  flush=True)
            one = (inputs[0][:1].contiguous(), inputs[1],
                   *(e[:1].contiguous() for e in inputs[2:6]), n,
                   inputs[7])
            step_ms = _events_ms(lambda: brc.blind_rotate_kernel(*one), 20)
            chain_ms = _events_ms(call, 1)
            print(f"  CUDA events: a one-step call {step_ms * 1e3:.2f} us; "
                  f"the chain of {steps} steps {chain_ms:.3f} ms = "
                  f"{chain_ms / steps * 1e3:.2f} us a step", flush=True)
            gaps = launch_gaps(call)
            if not gaps:
                print("  torch.profiler recorded no device activity",
                      flush=True)
                continue
            print(f"  torch.profiler, one chain: {gaps['launches']} device "
                  f"activities over {gaps['span_us'] / 1e3:.3f} ms, busy "
                  f"{gaps['busy_us'] / 1e3:.3f} ms; " + "; ".join(
                      f"{k} {m:.2f} us a launch ({lo:.2f}, {hi:.2f}) x {c}"
                      for k, (m, lo, hi, c) in gaps["by_kernel_us"].items())
                  + "; idle gaps {:.3f} ms in all, {:.2f} us mean, {:.2f} "
                  "us median, {:.2f} us most".format(
                      gaps["gap_us"][0] / 1e3, *gaps["gap_us"][1:]),
                  flush=True)
            del inputs, want, got
            torch.cuda.empty_cache()


# -- past one block: the grid layout at 2^17 ----------------------------------

# phase 22's shape at 2^17 (chip_smoke.py): N, beta, l; K = 1
WIDE_CONFIG = (1 << 17, 1 << 5, 6)
GRID_KINDS = (("top forward (digits, bits 16..15)", "brg_top_forward"),
              ("chunk forward", "ntt_chunk_kernel"),
              ("chunk inverse (contraction)", "brg_chunk_inverse"),
              ("top inverse", "brg_top_inverse"),
              ("top last (n^-1, CRT, add)", "brg_top_last"))


def wide_inputs(steps: int, B: int, dev, seed: int) -> tuple:
    """blind_rotate_kernel's arguments at WIDE_CONFIG: the key planes drawn
    on the card (prng.device_residues), shifts and accumulators on the
    host."""
    n, beta, l = WIDE_CONFIG
    p1, p2 = ntt_mod.CRT_PRIMES_TFHE
    res = prng.device_residues(seed, dev)
    gen = prng.Gen(seed)
    key = (steps, 2, l, 2, 2, n)
    ev1, ev2 = res((p1,), key)[0], res((p2,), key)[0]
    ev1s, ev2s = (kernel_check._u32_bits(e.long() * (1 << 32) // p)
                  for e, p in ((ev1, p1), (ev2, p2)))
    shifts = prng.uniform_mod(gen, (steps, B), 2 * n, dev).int()
    acc0 = prng.uniform_u64(gen, (B, 2, n), dev)
    return shifts, acc0, ev1, ev1s, ev2, ev2s, n, beta.bit_length() - 1


def print_launches(label: str, call, steps: int, kinds: tuple) -> None:
    """CUDA events over the chain, and one torch.profiler window's device
    time by launch kind (a launch, and a step) and idle gaps."""
    chain_ms = _events_ms(call, 1)
    print(f"  {label}: CUDA events, the chain of {steps} steps "
          f"{chain_ms:.3f} ms = {chain_ms / steps * 1e3:.2f} us a step",
          flush=True)
    gaps = launch_gaps(call, kinds)
    if not gaps:
        print("  torch.profiler recorded no device activity", flush=True)
        return
    print(f"  {label}: torch.profiler, one chain: {gaps['launches']} device "
          f"activities over {gaps['span_us'] / 1e3:.3f} ms, busy "
          f"{gaps['busy_us'] / 1e3:.3f} ms; idle gaps "
          f"{gaps['gap_us'][0] / 1e3:.3f} ms in all "
          f"({gaps['gap_us'][0] / steps:.2f} us a step), "
          f"{gaps['gap_us'][1]:.2f} us mean, {gaps['gap_us'][2]:.2f} us "
          f"median, {gaps['gap_us'][3]:.2f} us most", flush=True)
    busy = gaps["busy_us"]
    for kind, (m, lo, hi, c) in gaps["by_kernel_us"].items():
        print(f"    {kind:36s} {m:9.2f} us a launch ({lo:.2f}, {hi:.2f}) x "
              f"{c}: {m * c / steps:9.2f} us a step, {m * c / busy:.3f} of "
              "the busy time", flush=True)


def grid_layout(steps: int, B: int, dev, card: str) -> None:
    """The --grid run (see the module docstring)."""
    n, beta, l = WIDE_CONFIG
    inputs = wide_inputs(steps, B, dev, 27 + steps)
    plan = brc._plan(2, l, n, layout="grid")
    print(f"k10_phases --grid at N={n} C=2 l={l} beta=2^"
          f"{beta.bit_length() - 1} B={B} steps={steps}, plan "
          f"threads={plan.threads} smem={plan.smem_bytes} blocks a "
          f"ciphertext {plan.blocks} [{card}]", flush=True)
    print_launches("grid", lambda: brc.blind_rotate_kernel(
        *inputs, layout="grid"), steps, GRID_KINDS)


# -- the quarter layout at 2^17 -----------------------------------------------

QUARTER_UNIT = "blind_rotate_quarter_cuda.cu"
QUARTER_PHASES = (
    "forward: digits",
    "forward: top stages and pass 0 (the bytes across the cluster)",
    "forward: passes and the store",
    "inverse: contraction", "inverse: chain (passes 0..)",
    "inverse: cluster wait (chains)",
    "inverse: top stages (exchanges, waits)",
    "inverse: cluster wait (top stages)",
    "inverse: CRT lift and 64-bit atomics", "inverse: last cluster wait")
QUARTER_BLOCKS = 8192
QUARTER_KINDS = (("forward", "brq_forward"), ("inverse", "brq_inverse"))
_QUARTER_ENTRY = """
extern "C" int fhe_k10q_probe(
    const int* shifts, const unsigned long long* acc0, const uint32_t* ev1,
    const uint32_t* ev1s, const uint32_t* ev2, const uint32_t* ev2s,
    unsigned long long* out, const uint32_t* tw, const uint32_t* tw_sh,
    const uint32_t* twinv, const uint32_t* twinv_sh, const uint32_t* cons,
    uint32_t* scratch, int steps, int B, int C, int l, int w, int logn,
    int threads, int smem, int staged, int layout, cudaStream_t stream) {
  const bool aligned = !(fhe::misaligned(ev1) || fhe::misaligned(ev1s) ||
                         fhe::misaligned(ev2) || fhe::misaligned(ev2s));
  if (layout != 4 || staged) return static_cast<int>(cudaErrorInvalidValue);
  return fhe::blind_rotate_quarter(shifts, acc0, ev1, ev1s, ev2, ev2s, out,
                                   scratch, tw, tw_sh, twinv, twinv_sh, cons,
                                   steps, B, C, l, w, logn, threads, smem,
                                   aligned ? 1 : 0, stream);
}
"""
# (text of the unit, what), as DM_MARKS
QUARTER_MARKS = (
    ('#include "radix_chain.cuh"\n', None),
    ("  const int shift = 64 - w * (f - cc * l + 1);\n",
     "  long long phase_t = clock64();\n"),
    ("  // every quarter's digits are formed and visible to the cluster\n", 0),
    ("  // the peers have read this block's bytes (and pass 0's words are "
     "in)\n  cluster_sync();\n", ("after", 1)),
    ("    row[i] = make_uint4(a[sw], a[sw ^ 1], a[sw ^ 2], a[sw ^ 3]);\n"
     "  }\n}\n", ("after-brace", 2)),
    ("  const int cols = 2 * C;\n", "  long long phase_t = clock64();\n"),
    ("  __syncthreads();\n  RadixPasses<kWideLogN, 0, S::passes, true, "
     "S::threads>::run(\n", 3),
    ("  // the quarters of prime p are through their chains\n", 4),
    ("  quarter_stages(a, rank", 5),
    ("  // both primes' columns are complete and visible to the cluster\n", 6),
    ("  const uint32_t other = cluster_addr(a, rank ^ kQuarters);", 7),
    ("  // the peers have read this block's words before any block exits\n",
     8),
    ("  // the peers have read this block's words before any block exits\n"
     "  cluster_sync();\n}\n", ("after-brace", 9)),
)


def quarter_instrumented(src: str) -> str:
    """The quarter unit's text with the phase counters and the probe's
    entry; raises if a mark is not found exactly once (the kernel changed:
    update QUARTER_MARKS)."""
    slots = len(QUARTER_PHASES)
    counters = f"""
__device__ unsigned long long g_phase[{QUARTER_BLOCKS} * {slots}];
extern "C" int fhe_k10_phases(unsigned long long* host, int clear) {{
  static unsigned long long zero[{QUARTER_BLOCKS} * {slots}];
  return clear ? (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero))
               : (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(zero));
}}
#define FHE_PHASE(i) \\
  if (threadIdx.x == 0 && blockIdx.x < {QUARTER_BLOCKS}) {{ \\
  const long long t_ = clock64(); \\
  g_phase[blockIdx.x * {slots} + (i)] += t_ - phase_t; phase_t = t_; }}
"""
    for mark, what in QUARTER_MARKS:
        if src.count(mark) != 1:
            raise ValueError(f"k10_phases: mark {mark!r} found "
                             f"{src.count(mark)} times in {QUARTER_UNIT}")
        if what is None:
            src = src.replace(mark, mark + counters)
        elif isinstance(what, str):
            src = src.replace(mark, mark + what)
        elif isinstance(what, int):
            src = src.replace(mark, f"  FHE_PHASE({what})\n" + mark)
        elif what[0] == "after":
            src = src.replace(mark, mark + f"  FHE_PHASE({what[1]})\n")
        else:     # before the closing brace of the kernel
            src = src.replace(mark,
                              mark[:-2] + f"  FHE_PHASE({what[1]})\n}}\n")
    return src + _QUARTER_ENTRY


def quarter_build(out: Path) -> tuple:
    """(CDLL, ptxas's lines) of the instrumented unit."""
    cu = out / "blind_rotate_quarter_phases.cu"
    cu.write_text(quarter_instrumented(
        (_cuda.CSRC / QUARTER_UNIT).read_text()))
    so = out / "libk10q_phases.so"
    res = subprocess.run([_cuda._nvcc(), *_cuda.ARCH, "-std=c++17", "-O3",
                          "-Xptxas=-v", "-Xcompiler", "-fPIC", "-shared",
                          f"-I{_cuda.CSRC}", "-o", str(so), str(cu)],
                         capture_output=True, text=True, check=False)
    if res.returncode:
        raise _cuda.KernelBuildError(res.stderr)
    report = [f"{r['kernel']} {r['registers']} registers, {r['stack']} "
              f"bytes stack, {r['spill_stores']} bytes spill stores"
              for r in _cuda.ptxas_report(res.stdout + res.stderr)]
    return ctypes.CDLL(str(so)), report


def quarter_layout(steps: int, B: int, dev, card: str) -> None:
    """The --quarter run (see the module docstring)."""
    kernel = _cuda.BLIND_ROTATE
    n, beta, l = WIDE_CONFIG
    inputs = wide_inputs(steps, B, dev, 28 + steps)
    plan = brc._plan(2, l, n, layout=_cuda.QUARTER)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clusters = brc.quarter_clusters(dev)
    shape = (f"N={n} C=2 l={l} beta=2^{beta.bit_length() - 1} B={B} "
             f"steps={steps}")
    print(f"k10_phases --quarter at {shape}, plan threads={plan.threads} "
          f"smem={plan.smem_bytes} cluster={plan.cluster} blocks a "
          f"ciphertext {plan.blocks}; inverse clusters of "
          f"{plan.cluster} at once: {clusters} ({plan.cluster * clusters} "
          f"of {sms} SMs, {sms - plan.cluster * clusters} idle) [{card}]",
          flush=True)
    grid = lambda: brc.blind_rotate_kernel(  # noqa: E731
        *inputs, layout="grid")
    quarter = lambda: brc.blind_rotate_kernel(  # noqa: E731
        *inputs, layout=_cuda.QUARTER)
    want = grid()
    if not torch.equal(quarter(), want):
        raise RuntimeError("k10_phases: the quarter layout differs from the "
                           "grid layout")
    runs = {"quarter": [], "grid": []}
    for _ in range(3):
        for name, fn in (("quarter", quarter), ("grid", grid)):
            runs[name].append(_events_ms(fn, 1))
    print(f"  the package's build, CUDA events in turns (best of 3 of 3): "
          f"quarter {min(runs['quarter']):.3f} ms, grid "
          f"{min(runs['grid']):.3f} ms = "
          f"{min(runs['grid']) / min(runs['quarter']):.3f}x; "
          f"{min(runs['quarter']) / steps * 1e3:.2f} us a step", flush=True)
    print_launches("quarter", quarter, steps, QUARTER_KINDS)
    with tempfile.TemporaryDirectory() as tmp:
        lib, report = quarter_build(Path(tmp))
        print("  instrumented build; ptxas: " + "; ".join(report),
              flush=True)
        probe = lib.fhe_k10q_probe
        probe.argtypes = kernel.argtypes
        probe.restype = ctypes.c_int
        saved = kernel._fn
        kernel._fn = probe
        try:
            lib.fhe_k10_phases(None, 1)
            got = quarter()
            torch.cuda.synchronize()
            cycles = np.zeros(QUARTER_BLOCKS * len(QUARTER_PHASES),
                              dtype=np.uint64)
            lib.fhe_k10_phases(ctypes.c_void_p(cycles.ctypes.data), 0)
            if not torch.equal(got, want):
                raise RuntimeError("k10_phases: the instrumented build "
                                   "differs from the kernel")
            per = cycles.reshape(QUARTER_BLOCKS, -1).astype(
                np.float64) / steps
            for i, name in enumerate(QUARTER_PHASES):
                col = per[:, i][per[:, i] > 0]
                if col.size:
                    print(f"    {name:42s} {col.mean():10.1f} "
                          f"({col.min():.1f}, {col.max():.1f}) over "
                          f"{col.size} blocks")
            fwd, inv = per[:, :3].sum(1), per[:, 3:].sum(1)
            print(f"    {'forward block, all':42s} "
                  f"{fwd[fwd > 0].mean():10.1f}\n    "
                  f"{'inverse block, all':42s} {inv[inv > 0].mean():10.1f}",
                  flush=True)
            print_launches("instrumented", quarter, steps, QUARTER_KINDS)
        finally:
            kernel._fn = saved


if __name__ == "__main__":
    main()
