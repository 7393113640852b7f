#!/usr/bin/env python3
"""Time each CUDA kernel of the PyTorch port at the paths' shapes.

    python3 fhe_study_tpu_torch/utils/kernel_times.py [--tree DIR] [--batch 128]

Times one call of every case of ``utils/kernel_check.cases`` (N = 2^14,
L = 4, M = 5, t = 256) and, where the checkout has them, of
``utils/kernel_check.tfhe_cases`` (N = 1024, K = 1, beta = 4096, l = 2,
1024 steps, 64 ciphertexts, and the blind rotation over 700 steps),
``ckks_cases`` (N = 2^13, L = 4, K = 2, 32 ciphertexts), ``ext_sum_cases`` and
``bench_cases`` with CUDA events and prints one line a case and the sum a
kernel.  ``--tree`` names another checkout whose ``fhe_study_tpu_torch`` is
timed instead of this one, so two commits can be compared on one card in
one go: run it on the parent, the change, the change and the parent.
Run it as a file, not with -m, so that the package it imports is the one
under ``--tree``.  Needs one CUDA card and nvcc.
"""

import argparse
import pathlib
import subprocess
import sys

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).parents[2]))
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_times: no CUDA card")
    sys.path.insert(0, args.tree)
    from fhe_study_tpu_torch.models import bfv_rns as R
    from fhe_study_tpu_torch.utils import kernel_check

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    param = R.RnsParam(n=1 << 14, t=256, L=4, M=5)
    cases = kernel_check.cases(param, args.batch, dev, gen)
    if hasattr(kernel_check, "tfhe_cases"):       # absent in older checkouts
        cases += kernel_check.tfhe_cases(1024, 1, 4096, 2, 1024, 64, dev, gen)
        cases.append(kernel_check.blind_rotate_case(1024, 1, 4096, 2, 700, 64,
                                                    dev, gen))
    if hasattr(kernel_check, "ckks_cases"):
        from fhe_study_tpu_torch.models.ckks import ckks_rns as C
        cases += kernel_check.ckks_cases(
            C.Param(n=1 << 13, L=4, delta=2.0 ** 28), 32, 2, dev, gen)
        cases += [c for c in kernel_check.ext_sum_cases(1 << 13, 32, dev, gen)
                  if c.timed]
        cases += kernel_check.bench_cases(1 << 14, 64, dev, gen, reps=8,
                                          rounds=1024)
    sums = {}
    for case in cases:
        case.kernel()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            case.kernel()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / args.reps
        sums[case.name] = sums.get(case.name, 0.0) + ms
        print(f"{case.name:13s} {case.label:48s} {ms:8.4f} ms", flush=True)
    print(f"tree {args.tree} [{card}]: "
          + ", ".join(f"{k} {v:.4f}" for k, v in sums.items())
          + f"; all {sum(sums.values()):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
