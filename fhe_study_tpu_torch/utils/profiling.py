"""Observability: op timing, roofline estimates, noise budget, tracing — the
counterpart of fhe_study_tpu/utils/profiling.py.

  * ``timed`` — block wall timing (the caller synchronises the device);
  * ``time_fn`` — warm up and time a function on a CUDA device with CUDA
    events, or on the CPU with the host clock;
  * ``ntt_roofline`` — butterflies and unfused stage-chain bytes of a batch
    of transforms against the card's device-memory rate;
  * ``noise_budget_bits`` — log2 of the remaining decryption headroom;
  * ``trace`` — context manager around ``torch.profiler``.
"""

import contextlib
import time
from dataclasses import dataclass

import torch

# device-memory rate of one NVIDIA H100 SXM (data sheet), bytes/s
H100_MEMORY_BYTES_PER_S = 3.35e12


@contextlib.contextmanager
def timed(label: str, results: dict | None = None):
    t0 = time.perf_counter()
    yield
    # the caller synchronises the device inside the block
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = dt


def time_fn(fn, *args, device, iters: int = 10, warmup: int = 2):
    """Warm up and time fn(*args); returns seconds per call.  On a CUDA
    ``device`` the window is bracketed by CUDA events on its current stream,
    on the CPU by the host clock."""
    device = torch.device(device)
    for _ in range(warmup):
        fn(*args)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


@dataclass
class Roofline:
    butterflies: int
    hbm_bytes: int
    secs: float

    @property
    def butterflies_per_sec(self):
        return self.butterflies / self.secs

    @property
    def hbm_gbps(self):
        return self.hbm_bytes / self.secs / 1e9

    def report(self, peak_gbps: float = H100_MEMORY_BYTES_PER_S / 1e9):
        """Against the H100's device-memory rate by default: a stage chain
        that went through device memory at every stage could not pass 1.0;
        the kernels keep the stages in shared memory and do."""
        return {
            "butterflies_per_sec": self.butterflies_per_sec,
            "hbm_gbps": self.hbm_gbps,
            "hbm_fraction_of_peak": self.hbm_gbps / peak_gbps,
        }


def ntt_roofline(batch: int, n: int, secs: float, dtype_bytes: int = 8):
    """Model: log2(n) stages x n/2 butterflies; each stage reads and writes
    the full array once from device memory in the unfused worst case."""
    logn = n.bit_length() - 1
    return Roofline(
        butterflies=batch * logn * (n // 2),
        hbm_bytes=batch * logn * 2 * n * dtype_bytes,
        secs=secs,
    )


def noise_budget_bits(phase_err, q: int):
    """log2(q / (2·|err|)) — bits of headroom before decryption fails.
    phase_err: centered error tensor (int64)."""
    e = torch.clamp(phase_err.abs().double(), min=1.0)
    return torch.log2(float(q) / (2.0 * e))


@contextlib.contextmanager
def trace(dirname: str):
    """Profile the block (CPU and, where there is one, CUDA activity) and
    write a Chrome trace under ``dirname``; yields the profiler."""
    import pathlib

    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = pathlib.Path(dirname)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
