"""The hand-written CUDA kernels: build, load, launch, and dispatch by device.

The sources under ``fhe_study_tpu_torch/csrc/`` are compiled by ``nvcc`` for
``sm_90a``, each ``.cu`` file in its own process and all of them at once,
then linked into one shared library with a plain C interface, loaded with
``ctypes``.  The build runs once, at the first launch, into
``_build/torch_kernels/<hash of the sources and flags>/``; nothing is built
when a module is imported.  A missing ``nvcc`` or a failed build raises with
the compiler's message.

The dispatch rule lives here (``on_cuda``), decided by the device of the
input tensors alone: CPU tensors take a function's plain PyTorch version,
CUDA tensors its kernel.  There is no fallback from a kernel to its plain
version, and the kernel wrappers (``check``) refuse CPU tensors.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "_build" / "torch_kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas=-v", "-c")
LINK_FLAGS = (*ARCH, "-shared")
LIB_NAME = "libfhe_kernels.so"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def _nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.is_file():
        return str(DEFAULT_NVCC)
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels cannot be built")


def _sources() -> list:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def build_dir() -> Path:
    """Build directory keyed by the sources' content and the flags."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _run(cmd: list) -> tuple:
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    return cmd, res, time.perf_counter() - t0


@lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library: one
    ``nvcc -c`` process per ``.cu`` file, all started together, then one
    link.  ``build.log`` keeps every command, its output (ptxas's register
    report) and its seconds, in that order."""
    out = build_dir()
    so = out / LIB_NAME
    if not so.is_file():
        out.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), os.getpid()
        cus = [p for p in _sources() if p.suffix == ".cu"]
        objs = [out / f"{p.stem}.{tag}.o" for p in cus]
        with ThreadPoolExecutor(max_workers=len(cus)) as pool:
            steps = list(pool.map(_run, [[nvcc, *COMPILE_FLAGS, "-o", str(o),
                                          str(p)] for p, o in zip(cus, objs)]))
        tmp = out / f"{LIB_NAME}.{tag}.tmp"
        if all(res.returncode == 0 for _, res, _ in steps):
            steps.append(_run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                               *(str(o) for o in objs)]))
        (out / "build.log").write_text("".join(
            " ".join(cmd) + "\n" + res.stdout + res.stderr
            + f"-- {sec:.1f} s\n" for cmd, res, sec in steps))
        for o in objs:
            o.unlink(missing_ok=True)
        for _, res, _ in steps:
            if res.returncode != 0:
                raise KernelBuildError(
                    f"nvcc exited with {res.returncode}:\n"
                    f"{res.stderr.strip()}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.fhe_error_string.argtypes = [ctypes.c_int]
    lib.fhe_error_string.restype = ctypes.c_char_p
    return lib


def build_log() -> str:
    """nvcc's command line and output (ptxas register and shared-memory
    report) of the current build; builds first if needed."""
    library()
    return (build_dir() / "build.log").read_text()


def build_seconds(log: str) -> dict:
    """The seconds of each command of a build log, by the file it compiles
    (its last argument) or "link"."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.fullmatch(r"-- ([0-9.]+) s", line)
        if m and name is not None:
            out[name] = float(m.group(1))
            name = None
        elif " -o " in line and line.split()[0].endswith("nvcc"):
            name = ("link" if " -shared" in line
                    else line.split()[-1].rsplit("/", 1)[-1])
    return out


def ptxas_report(log: str) -> list:
    """Per entry function of a build log, in order: its mangled ``name``,
    ``kernel`` (the name with its integer template arguments, as
    ``ext_ntt_kernel<14, 4>``), and ptxas's ``registers``, ``stack`` frame
    bytes, ``spill_stores`` and ``spill_loads`` bytes."""
    entries, props = [], {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = {"name": m.group(1), "kernel": _kernel_label(m.group(1))}
            entries.append(current)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = {"name": m.group(1)}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and current is not None and props.get("name") == current["name"]:
            current.update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    return entries


def _kernel_label(mangled: str) -> str:
    """The innermost name of an Itanium-mangled function and its integer
    and bool template arguments (a negative one is mangled with an ``n``;
    a bool reads 0 or 1)."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while (m := re.match(r"\d+", mangled[pos:])):
        start = pos + m.end()
        name = mangled[start:start + int(m.group())]
        pos = start + int(m.group())
    args = re.match(r"I((?:L[ib]n?\d+E)+)E", mangled[pos:])
    if not args:
        return name
    values = re.findall(r"L[ib](n?\d+)E", args.group(1))
    return f"{name}<{', '.join(v.replace('n', '-') for v in values)}>"


PTR = ctypes.c_void_p
INT = ctypes.c_int
U32 = ctypes.c_uint
I64 = ctypes.c_longlong


# The ring degrees (log2 n, both ends included) that each kernel takes.
# Every kernel of the radix chain starts at 2^7 (a block of 8 threads, two
# passes of 4 and 3 stages), the least degree of the reference's Pallas
# kernels.  One block holds the polynomial up to 2^15 (csrc/radix_chain.cuh,
# by_logn_wide; the three-buffer kernels K6, tensor_mul, K7 and K8 there on
# two-block clusters, one half a block).  Past it every transform kernel
# goes on across blocks (csrc/ntt_chunks.cuh: top passes through device
# memory, then one block a chunk of 2^15 words) to 2^26, the largest degree
# at which a prime of either package has its 2n-th roots (TRANSFORM_LOGN):
# K1 and K9, K2, K3, K5 and K12 with their products, contraction, extension
# or repetitions folded into the first pass, K6 and tensor_mul with their
# four forwards through an eval scratch and K2's products and inverses
# after them, K7 and K8 with their digit rows' forwards one after another
# and the gadget sums in device memory; K12 at 2^16 also on two-block
# clusters, the polynomial resident.  K10, on its two-block clusters up to
# 2^12, with its working set in device memory beyond a block, at 2^16 each
# polynomial split over a cluster's shared memory (at 2^17 in quarters)
# and across blocks past it (ops/blind_rotate_cuda.py::_plan), reaches
# 2^22, where the
# reference's gate ends (its CRT pair's roots).
TRANSFORM_LOGN = (7, 26)
BLIND_ROTATE_LOGN = (7, 22)


class Kernel:
    """One C entry point of the kernel library and its count of launches.

    ``launches`` grows by one per launch of the kernel and nowhere else.
    ``source`` is the CUDA file and ``replaces`` the TPU kernel it ports
    (file:line of the function that reaches ``pl.pallas_call``).  ``logn``
    is the range of ring degrees it takes (``log2_degree``), None for a
    kernel without one.  A kernel with several layouts (K10; K5 and K6, whose
    conversion is direct or staged; K2, K3, K5-K8 and K12 past one block,
    "chunked") names them in ``layouts`` (layout -> its source);
    ``by_layout`` counts the launches of each, and ``launches`` all of
    them."""

    def __init__(self, name: str, symbol: str, source: str, replaces: str,
                 *argtypes, logn: tuple | None = None,
                 layouts: dict | None = None):
        self.name = name
        self.symbol = symbol
        self.source = source
        self.replaces = replaces
        self.argtypes = [*argtypes, PTR]          # + the CUDA stream
        self.logn = logn
        self.launches = 0
        self.layouts = layouts or {}
        self.by_layout = dict.fromkeys(self.layouts, 0)
        self._fn = None

    @property
    def degrees(self) -> range:
        """The log2 n this kernel takes, in order."""
        return range(self.logn[0], self.logn[1] + 1)

    def launch(self, device: torch.device, *args,
               layout: str | None = None) -> None:
        if (layout is None) != (not self.layouts) or (
                layout is not None and layout not in self.layouts):
            raise ValueError(f"{self.name}: layout {layout!r}, expected one "
                             f"of {list(self.layouts)}")
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self._fn(*args, stream)
        if err != 0:
            msg = library().fhe_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {msg}")
        self.launches += 1
        if layout is not None:
            self.by_layout[layout] += 1


_NTT_CU = "fhe_study_tpu_torch/csrc/ntt_cuda.cu"
_EXT_CU = "fhe_study_tpu_torch/csrc/ext_cuda.cu"
NTT_MULTI = Kernel("ntt_multi", "fhe_ntt_multi",
                   "fhe_study_tpu_torch/csrc/ntt_multi_cuda.cu",
                   "fhe_study_tpu/ops/ntt_pallas.py:404",
                   PTR, PTR, PTR, PTR, PTR, PTR, *([INT] * 8),
                   logn=TRANSFORM_LOGN)
# K2, K3, K5-K8 and K12 in two layouts: one block a polynomial up to 2^15
# ("block"; K5's and K6's "direct" and "staged"), and past it on the
# chunked schedule ("chunked"; K5's and K6's "chunked direct" and "chunked
# staged"), each from its own unit
CHUNKED = "chunked"
_K2_CU = "fhe_study_tpu_torch/csrc/tensor_eval4_chunks_cuda.cu"
TENSOR_EVAL4 = Kernel("tensor_eval4", "fhe_tensor_eval4", _NTT_CU,
                      "fhe_study_tpu/ops/ntt_pallas.py:794",
                      PTR, PTR, PTR, PTR, *([I64] * 8),
                      PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT,
                      logn=TRANSFORM_LOGN,
                      layouts={"block": _NTT_CU, CHUNKED: _K2_CU})
_KS_CU = "fhe_study_tpu_torch/csrc/ks_contract_cuda.cu"
KS_CONTRACT = Kernel("ks_contract", "fhe_ks_contract", _KS_CU,
                     "fhe_study_tpu/ops/ntt_pallas.py:1273",
                     *([PTR] * 7), *([INT] * 7), logn=TRANSFORM_LOGN,
                     layouts={"block": _KS_CU, CHUNKED: (
                         "fhe_study_tpu_torch/csrc/"
                         "ks_contract_chunks_cuda.cu")})
BASE_EXTEND = Kernel("base_extend", "fhe_base_extend", _EXT_CU,
                     "fhe_study_tpu/ops/ext_pallas.py:133",
                     PTR, PTR, PTR, PTR, INT, INT, I64, INT, INT)
# K5 and K6 convert from a source basis in one of two layouts
# (ops/ntt_cuda.py::lift_plan): "direct", each word in the kernel from the
# source rows (the counts with an instance), or "staged", the lift
# (csrc/ext.cuh's ext_lift_kernel) first into a scratch, then the kernel
# from its rows; one C call queues both launches, counted as one.  Both keep
# the two apart past one block too (K6 counts its operands without a source
# basis as "direct").
_EXT_NTT_CU = "fhe_study_tpu_torch/csrc/ext_ntt_cuda.cu"
_FORWARD_CHUNKS_CU = "fhe_study_tpu_torch/csrc/forward_chunks_cuda.cu"
EXT_NTT = Kernel("ext_ntt", "fhe_ext_ntt", _EXT_NTT_CU,
                 "fhe_study_tpu/ops/ntt_pallas.py:905",
                 *([PTR] * 8), *([INT] * 6), logn=TRANSFORM_LOGN,
                 layouts={"direct": _EXT_NTT_CU, "staged": _EXT_NTT_CU,
                          f"{CHUNKED} direct": _FORWARD_CHUNKS_CU,
                          f"{CHUNKED} staged": _FORWARD_CHUNKS_CU})
_MUL4_CU = "fhe_study_tpu_torch/csrc/tensor_mul4_cuda.cu"
_MUL4_CHUNKS_CU = "fhe_study_tpu_torch/csrc/tensor_mul4_chunks_cuda.cu"
_TENSOR_MUL4_ARGS = (PTR, PTR, PTR, PTR, *([I64] * 8), *([PTR] * 9),
                     *([INT] * 6))
# K6 and tensor_mul, K7 and K8 past one block run the chunked schedule of
# their own units: K6's "chunked direct" (no source basis, or from 4) and
# "chunked staged", the others' "chunked"
TENSOR_MUL4 = Kernel("tensor_mul4", "fhe_tensor_mul4", _MUL4_CU,
                     "fhe_study_tpu/ops/ntt_pallas.py:677",
                     *_TENSOR_MUL4_ARGS, logn=TRANSFORM_LOGN,
                     layouts={"direct": _MUL4_CU, "staged": (
                         "fhe_study_tpu_torch/csrc/tensor_mul4_staged_cuda.cu"),
                         f"{CHUNKED} direct": _MUL4_CHUNKS_CU,
                         f"{CHUNKED} staged": _MUL4_CHUNKS_CU})
# the stacked-operand form: the same kernels, fed row strides
TENSOR_MUL = Kernel("tensor_mul", "fhe_tensor_mul4", _MUL4_CU,
                    "fhe_study_tpu/ops/ntt_pallas.py:604",
                    *_TENSOR_MUL4_ARGS, logn=TRANSFORM_LOGN,
                    layouts={"block": _MUL4_CU, CHUNKED: _MUL4_CHUNKS_CU})
_KS_FUSED_CU = "fhe_study_tpu_torch/csrc/ks_fused_cuda.cu"
_KS_FUSED_EVAL_CU = "fhe_study_tpu_torch/csrc/ks_fused_eval_cuda.cu"
_KS_FUSED_CHUNKS_CU = "fhe_study_tpu_torch/csrc/ks_fused_chunks_cuda.cu"
KS_FUSED = Kernel("ks_fused", "fhe_ks_fused", _KS_FUSED_CU,
                  "fhe_study_tpu/ops/ntt_pallas.py:1103",
                  PTR, I64, I64, *([PTR] * 9), *([INT] * 7),
                  logn=TRANSFORM_LOGN,
                  layouts={"block": _KS_FUSED_CU,
                           CHUNKED: _KS_FUSED_CHUNKS_CU})
KS_FUSED_EVAL = Kernel("ks_fused_eval", "fhe_ks_fused_eval",
                       _KS_FUSED_EVAL_CU,
                       "fhe_study_tpu/ops/ntt_pallas.py:1216",
                       PTR, I64, I64, PTR, PTR, PTR, I64, I64, PTR, I64, I64,
                       *([PTR] * 8), *([INT] * 7), logn=TRANSFORM_LOGN,
                       layouts={"block": _KS_FUSED_EVAL_CU,
                                CHUNKED: _KS_FUSED_CHUNKS_CU})
NTT = Kernel("ntt", "fhe_ntt", "fhe_study_tpu_torch/csrc/ntt_multi_cuda.cu",
             "fhe_study_tpu/ops/ntt_pallas.py:1296",
             PTR, PTR, PTR, PTR, PTR, PTR, *([INT] * 6),
             logn=TRANSFORM_LOGN)
# K10's five layouts (ops/blind_rotate_cuda.py::_plan): two-block clusters,
# the working set in device memory, at 2^16 each polynomial split over a
# cluster's shared memory, at 2^17 in quarters over a cluster's, and past
# it across blocks
_BR_CU = "fhe_study_tpu_torch/csrc/blind_rotate_cuda.cu"
SPLIT = "split"
QUARTER = "quarter"
BLIND_ROTATE = Kernel("blind_rotate", "fhe_blind_rotate", _BR_CU,
                      "fhe_study_tpu/ops/blind_rotate_pallas.py:392",
                      *([PTR] * 13), *([INT] * 10), logn=BLIND_ROTATE_LOGN,
                      layouts={"cluster": _BR_CU, "device": (
                          "fhe_study_tpu_torch/csrc/blind_rotate_dm_cuda.cu"),
                          SPLIT: ("fhe_study_tpu_torch/csrc/"
                                  "blind_rotate_split_cuda.cu"),
                          "grid": ("fhe_study_tpu_torch/csrc/"
                                   "blind_rotate_grid_cuda.cu"),
                          QUARTER: ("fhe_study_tpu_torch/csrc/"
                                    "blind_rotate_quarter_cuda.cu")})
BASE_EXTEND_SUM = Kernel("base_extend_sum", "fhe_base_extend_sum", _EXT_CU,
                         "fhe_study_tpu/ops/ext_pallas.py:207",
                         PTR, PTR, PTR, PTR, INT, INT, I64, INT)
_BENCH_CU = "fhe_study_tpu_torch/csrc/bench_cuda.cu"
# K12 at 2^16 also "split": resident on two-block clusters
NTT_SMEM_CEILING = Kernel("ntt_smem_ceiling", "fhe_ntt_smem_ceiling",
                          _BENCH_CU, "fhe_study_tpu/ops/vpu_bench.py:168",
                          *([PTR] * 6), U32, *([INT] * 6),
                          logn=TRANSFORM_LOGN,
                          layouts={"block": _BENCH_CU,
                                   CHUNKED: _FORWARD_CHUNKS_CU,
                                   SPLIT: _BENCH_CU})
ALU_RATE = Kernel("alu_rate", "fhe_alu_rate", _BENCH_CU,
                  "fhe_study_tpu/ops/vpu_bench.py:86",
                  PTR, PTR, PTR, PTR, I64, INT, INT, U32, U32)
# The lift alone (the first launch of K5's and K6's staged layout), for
# holding it against ops/ext_cuda.py::lift_plain: no TPU kernel of its own,
# so not one of KERNELS; K5 and K6 count its launches on their paths.
EXT_LIFT = Kernel("ext_lift", "fhe_ext_lift", _EXT_CU,
                  "fhe_study_tpu/ops/ntt_pallas.py:905",
                  PTR, PTR, PTR, INT, INT, INT, INT)
KERNELS = (NTT_MULTI, TENSOR_EVAL4, KS_CONTRACT, BASE_EXTEND, EXT_NTT,
           TENSOR_MUL4, TENSOR_MUL, KS_FUSED, KS_FUSED_EVAL, NTT,
           BLIND_ROTATE, BASE_EXTEND_SUM, NTT_SMEM_CEILING, ALU_RATE)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
        k.by_layout = dict.fromkeys(k.layouts, 0)


def launches() -> dict:
    return {k.name: k.launches for k in KERNELS}


def chunked_launches(kernel: Kernel) -> int:
    """The launches of ``kernel`` past one block (its "chunked" layouts)."""
    return sum(v for layout, v in kernel.by_layout.items()
               if layout.startswith(CHUNKED))


def max_clusters(symbol: str, device) -> int:
    """The clusters of a cluster launch that the card runs at once
    (cudaOccupancyMaxActiveClusters through the library's ``symbol``)."""
    fn = getattr(library(), symbol)
    fn.argtypes = [ctypes.POINTER(INT)]
    fn.restype = INT
    got = INT(0)
    with torch.cuda.device(device):
        err = fn(ctypes.byref(got))
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA error {err}")
    return got.value


def on_cuda(*tensors) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU; raises for a mix or any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on devices {sorted(kinds)}: need all on the "
                     "CPU (plain version) or all on CUDA (kernel)")


def check(t: torch.Tensor, name: str, device: torch.device,
          rows: bool = False, dtype: torch.dtype = torch.int32) -> None:
    """A kernel operand: ``dtype`` on CUDA ``device``, contiguous (or, with
    rows=True, contiguous along the last axis only)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}: the kernels take CUDA "
                         "tensors (CPU tensors go to the plain versions)")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if rows:
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last axis must be contiguous")
    elif not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def aligned(t: torch.Tensor) -> bool:
    """t's data starts on a 16-byte boundary (the kernels' uint4 words)."""
    return t.data_ptr() % 16 == 0


def log2_degree(n: int, kernel: Kernel) -> int:
    """log2 n for a ring degree that ``kernel`` takes (its ``logn``);
    raises, naming the kernel and its range, for any other."""
    lo, hi = kernel.logn
    logn = n.bit_length() - 1
    if n != 1 << logn or not lo <= logn <= hi:
        raise ValueError(f"ring degree {n}: the CUDA kernel {kernel.name} "
                         f"takes n = 2^{lo} .. 2^{hi}")
    return logn
