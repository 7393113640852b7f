#!/usr/bin/env python3
"""Time each CUDA kernel of the PyTorch port at the paths' shapes.

    python3 fhe_study_tpu_torch/utils/kernel_times.py [--tree DIR] [--batch 128]
        [--degree15 | --conversion | --ks15 | --k10dm | --paths]

Times one call of every case of ``utils/kernel_check.cases`` (N = 2^14,
L = 4, M = 5, t = 256), of ``linear_cases`` (N = 2^12, L = 2, M = 3, 1024
ciphertexts) and, where the checkout has them, of
``utils/kernel_check.tfhe_cases`` (N = 1024, K = 1, beta = 4096, l = 2,
1024 steps, 64 ciphertexts, and the blind rotation over 700 steps),
``ckks_cases`` (N = 2^13, L = 4, K = 2, 32 ciphertexts), ``ext_sum_cases``
(and K11 at a BFV width, Q -> P on [4, 128, 2^14]) and ``bench_cases``
with CUDA events and prints one line a case and the sum a kernel.  Each
case is timed twice: as called (``--reps`` calls back to back, so the
device waits whenever the host's launch path is slower than the kernel) and
on the device alone (the same calls queued behind device
work that outlasts their enqueueing), beside the host's seconds to enqueue a
call and the device-alone time's share of the case's bound
(``kernel_check.bound``, as chip_smoke.py computes it: the largest of its
bytes over 3.35 TB/s, its integer instructions over 128 a clock and SM, and
each integer pipe's issue slots over 64 a clock and SM, at the card's
maximum SM clock) and of the issue-only bound (bytes or all instructions at
128, the bound before the pipes were counted).  A tree from before the
pipe-aware bound gets its times only: its cases do the same work as this
tree's of the same label.
Beside K6 (tensor_mul4) it times, as a yardstick, the redesigned kernels
that give the same output: K1's forward of the four operands (stacked
beforehand, as tensor_mul takes them) then K2 over Q, and K5's Q -> P
forward of the four then K2 over P; beside K7 (ks_fused) K1's forward
(fin = 2^32) of the reduced digit rows then K3 over R rows; each first held
equal to the kernel it stands beside.  ``--tree`` names another checkout whose ``fhe_study_tpu_torch`` is
timed instead of this one, so two commits can be compared on one card in
one go: run it on the parent, the change, the change and the parent.
Run it as a file, not with -m, so that the package it imports is the one
under ``--tree``.  Needs one CUDA card and nvcc.  It first builds that
checkout's kernels and prints the build's seconds.

It also measures the shared-memory ceiling (K12) on the whole card at
N = 2^14 (as many blocks as the card holds at once, 64 transforms each), as
butterflies/s, and the single-prime transform (K9) forward and inverse at
every n from 2^8 to 2^15 on 2^22 coefficients, on the device alone beside
its byte bound.

Then it times the BFV chains of chip_smoke.py's phase 6 the same way (a
chain of 4 of ``mul_e`` and ``mul`` with either relin key at B = 128, and of
the linear step at N = 2^12, B = 1024; best of 3 after a warm-up), on keys
and ciphertexts drawn from one seed, and prints ms an op; the TFHE chains
of phase 9 (a chain of 3 of ``bootstrap`` and of ``bootstrap_short`` at
N = 1024, B = 64, each decrypt-checked first), as ms a batch and
bootstraps/s; and the paths of the single-prime transform (K9), as ms an
op: TFHE key generation (``new_bootstrapping_key`` and
``precompute_btk_evals`` at N = 1024, K = 1, beta = 4096, l = 2, 1024
steps; best of 3, the key first checked by bootstrapping 64 messages with
it) and ``bfv_batch.batch_encode`` and ``batch_decode`` at n = 2^13,
t = 65537, B = 32 (round-trip checked first).

``--degree15`` times chip_smoke.py's phase 18 configuration instead (ring
degree 2^15, L = 14, M = 15, K = 15, t = 256, B = ``--batch``): every case
of ``kernel_check.cases`` there (the one-buffer kernels and K4, operands
drawn on the card), K12's full-card ceiling at n = 2^15, and a chain of 4
``mul_e`` with the hybrid key (best of 3, its output decrypt-checked), as ms
an op and ct-mul/s.

``--conversion`` times K5 (ext_ntt) and K6 (tensor_mul4) converting from a
wide source basis at N = 2^15, B = ``--batch``: K5 Q -> P on the [L, B, 2,
n] pair and K6 over P from the four [L, B, n] operands, at L = 14 (M = 15)
and L = 29 (M = 30), each on the device alone beside its bound (the least
work of ``kernel_check.cases``) and beside the composition of kernels that
gives the same output, held equal to it first: K4 (base_extend) then K1
(ntt_multi), and K4 on the four operands stacked then K6 over P without a
source basis; where the tree takes K5 past 2^15, also K5 Q -> P at
N = 2^16, L = 14, M = 15 (chip_smoke.py's phase 23 primes) beside K4 + K1.  Where the tree has the staged layout
(``ops/ntt_cuda.py::lift_plan``) it also times the lift alone on K5's
operand, and K5 and K6 at N = 2^14, L = 4, M = 5 in their direct instance
and forced into the staged layout (outputs held equal).

``--ks15`` times the three-buffer kernels at ring degree 2^15, their
instance on two-block clusters, at the BFV paths' shapes
(``kernel_check.cases`` at N = 2^15, M = L + 1, t = 256, B = ``--batch``,
for chip_smoke.py's phase 19 L = 29 and phase 18's L = 14), each on the
device alone beside its bound: K6 (tensor_mul4) over Q and over P from Q
(staged), ``tensor_mul`` on the stacked operand, K7 (ks_fused) and K8
(ks_fused_eval) at R = L; beside K6 over P the composition K4 on the four
operands stacked then K6 over P (held equal to it first) and the lift's
words the staged instance reads through L2, beside K7 K1's forward of the
reduced digit rows then K3 (``yardsticks``' composition, held equal to K7
first); K10's split layout at N = 2^16 (l = 5, 16 steps, 64 ciphertexts),
whose code the instance shares nothing of; then phase 19's ops at L = 29
(``mul`` and ``mul_e`` with the gadget key as chains of 4,
``key_switch`` over 4 calls) and phase 18's ``mul`` with the hybrid key
at L = 14, K = 15 (a chain of 4); best of 3, each decrypt-checked first,
as ms an op.

``--k10dm`` times K10's device-memory layout at chip_smoke.py's phase 21
shapes (K = 1, 400 CMux steps, B = 64; N = 4096, beta = 2^11, l = 2 and
N = 2^15, beta = 2^8, l = 3) on the device alone beside its bound, then
the two ``bootstrap_short`` pipelines of phase 21 at those shapes (t = 64
and 16, n_lwe = 400, beta_ks = 16, l_ks = 8; a chain of 3, each fed the
last one's output, decrypt-checked, best of 3) as ms a batch, and as
controls that share no code with the layout K10's split layout at
N = 2^16 (l = 5, 16 steps, 64 ciphertexts) and every case of
``kernel_check.cases`` at N = 2^14, L = 4, M = 5 (K1-K8), each on the
device alone; the card's SM clock is sampled beside each K10 time.

``--paths`` times only the BFV chains: those of phase 6 above (N = 2^14)
and chip_smoke.py's phase 20 ops at N = 128, t = 16, L = 3, M = 4,
B = 128 (``mul_e`` and ``mul`` with either key, ``key_switch``), as ms an
op, best of 3.
"""

import argparse
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).parents[2]))
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--degree15", action="store_true")
    ap.add_argument("--conversion", action="store_true")
    ap.add_argument("--ks15", action="store_true")
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--k10dm", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_times: no CUDA card")
    sys.path.insert(0, args.tree)
    from fhe_study_tpu_torch.models import bfv_rns as R
    from fhe_study_tpu_torch.ops import _cuda
    from fhe_study_tpu_torch.utils import kernel_check, prng

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    _cuda.library()
    print(f"build {args.tree}: {time.perf_counter() - t0:.1f} s -> "
          f"{_cuda.build_dir()}", flush=True)
    dev = torch.device("cuda", 0)
    gen = prng.Gen(1)
    if args.degree15:
        degree15(args, card)
        return
    if args.conversion:
        conversion(args, card)
        return
    if args.ks15:
        ks15(args, card)
        return
    if args.k10dm:
        k10dm(args, card)
        return
    if args.paths:
        per_op = {**bfv_chains(R, dev, 4), **small_chains(R, dev, 4)}
        print(f"paths {args.tree} [{card}]: "
              + ", ".join(f"{k} {v:.4f}" for k, v in per_op.items())
              + " ms an op", flush=True)
        return
    param = R.RnsParam(n=1 << 14, t=256, L=4, M=5)
    cases = kernel_check.cases(param, args.batch, dev, gen)
    cases += kernel_check.linear_cases(R.RnsParam(n=1 << 12, t=256, L=2, M=3),
                                       1024, dev, gen)
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
        cases += ext_sum_bfv(kernel_check, dev, gen)
        cases += kernel_check.bench_cases(1 << 14, 64, dev, gen, reps=8,
                                          rounds=1024)
    bound_of = card_bound(kernel_check, dev)
    busy = torch.zeros(1 << 28, dtype=torch.int32, device=dev)    # 1 GiB
    sums, alone = time_cases(cases, args.reps, busy, bound_of)
    for label, fn in yardsticks(param, args.batch, dev, gen):
        ms = events_ms(fn, args.reps)
        device_ms, host_ms = events_ms(fn, args.reps, busy)
        print(f"yardstick     {label:48s} {ms:8.4f} ms; on the device alone "
              f"{device_ms:8.4f} ms; host enqueue {host_ms:.4f} ms a call",
              flush=True)
    del busy
    from fhe_study_tpu_torch.ops import alu_bench
    per_sm, sms = alu_bench.resident_blocks(dev, n=1 << 14)
    ceiling = alu_bench.ntt_smem_ceiling(dev, n=1 << 14, B=per_sm * sms,
                                         reps=64)
    print(f"ceiling {args.tree} [{card}]: n=2^14, B={per_sm * sms} "
          f"({per_sm} blocks x {sms} SMs), reps=64: "
          f"{ceiling['butterflies_per_sec']:.4e} butterflies/s", flush=True)
    print(f"ntt degrees {args.tree} [{card}]: " + "; ".join(
        f"n={n} {d} {ms:.4f} ms ({bound / ms:.3f} of its bound {bound:.4f})"
        for n, d, ms, bound in ntt_degrees(dev, gen)), flush=True)
    for label, by in (("", sums), (" (device alone)", alone)):
        print(f"tree {args.tree}{label} [{card}]: "
              + ", ".join(f"{k} {v:.4f}" for k, v in by.items())
              + f"; all {sum(by.values()):.4f} ms", flush=True)
    per_op = bfv_chains(R, dev, 4)
    print(f"chains {args.tree} [{card}]: "
          + ", ".join(f"{k} {v:.4f}" for k, v in per_op.items())
          + " ms an op", flush=True)
    per_batch = tfhe_chains(dev, 3)
    print(f"tfhe {args.tree} [{card}]: "
          + ", ".join(f"{k} {v:.4f} ms a batch of 64 = {64e3 / v:.1f}/s"
                      for k, v in per_batch.items()), flush=True)
    times, shapes = ntt_paths(dev)
    print(f"ntt paths {args.tree} [{card}]: "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
          + " ms an op; K9 launches in one key generation: "
          + ", ".join(f"{c} x {list(shp)} q={q} {'inv' if inv else 'fwd'}"
                      for (shp, q, inv), c in shapes.items()), flush=True)


def time_cases(cases, reps: int, busy, bound_of) -> tuple:
    """Each case's kernel as called and on the device alone, printed with
    its share of its bound; returns the two sums by kernel name."""
    sums, alone = {}, {}
    for case in cases:
        case.kernel()
        ms = events_ms(case.kernel, reps)
        device_ms, host_ms = events_ms(case.kernel, reps, busy)
        sums[case.name] = sums.get(case.name, 0.0) + ms
        alone[case.name] = alone.get(case.name, 0.0) + device_ms
        b = bound_of(case)
        share = ("" if b is None else
                 f", {b.ms / device_ms:.3f} of its bound {b.ms:.4f} ms by "
                 f"{b.term} ({b.issue_only_ms / device_ms:.3f} of the "
                 f"issue-only bound {b.issue_only_ms:.4f})")
        print(f"{case.name:13s} {case.label:48s} {ms:8.4f} ms; on the device "
              f"alone {device_ms:8.4f} ms{share}; host enqueue "
              f"{host_ms:.4f} ms a call", flush=True)
    return sums, alone


def card_bound(kernel_check, dev):
    """case -> kernel_check.bound of the case on this card (its SMs and
    maximum SM clock), or None for a tree from before the bound."""
    if not hasattr(kernel_check, "bound"):
        return lambda case: None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    return lambda case: kernel_check.bound(case.bytes, case.ops, sms,
                                           sm_mhz * 1e6)


def degree15(args, card: str) -> None:
    """The --degree15 run: the cases, the ceiling and the mul_e chain at
    chip_smoke.py's phase 18 configuration."""
    from fhe_study_tpu_torch.models import bfv_rns as R
    from fhe_study_tpu_torch.ops import alu_bench
    from fhe_study_tpu_torch.ops import ntt_cuda as nc
    from fhe_study_tpu_torch.utils import kernel_check, prng
    dev = torch.device("cuda", 0)
    n, K, B = 1 << 15, 15, args.batch
    param = R.RnsParam(n=n, t=256, L=14, M=15)
    print(f"degree15 {args.tree} [{card}]: N={n} L=14 M=15 K={K} B={B}, "
          f"{nc.WIDE_THREADS} threads a block at n = 2^15", flush=True)
    cases = kernel_check.cases(param, B, dev, prng.Gen(1), K=K,
                               res=prng.device_residues(1, dev))
    busy = torch.zeros(1 << 28, dtype=torch.int32, device=dev)
    _, alone = time_cases(cases, args.reps, busy,
                          card_bound(kernel_check, dev))
    del cases, busy
    print(f"degree15 {args.tree} (device alone) [{card}]: "
          + ", ".join(f"{k} {v:.4f}" for k, v in alone.items())
          + f"; all {sum(alone.values()):.4f} ms", flush=True)
    per_sm, sms = alu_bench.resident_blocks(dev, n=n)
    ceiling = alu_bench.ntt_smem_ceiling(dev, n=n, B=per_sm * sms, reps=64)
    print(f"degree15 ceiling {args.tree} [{card}]: n=2^15, B={per_sm * sms} "
          f"({per_sm} blocks x {sms} SMs), reps=64: "
          f"{ceiling['butterflies_per_sec']:.4e} butterflies/s", flush=True)
    del ceiling
    gen = prng.Gen(7)
    sk, pk = R.new_key(gen, param, dev)
    hk = R.hybrid_rlk1(gen, param, sk, K=K)
    m = [torch.randint(0, 256, (B, n), device=dev) for _ in range(2)]
    x, y = (R.to_evals(param, R.encrypt(gen, param, pk, mi, batch=(B,)))
            for mi in m)

    def run():
        c = x
        for _ in range(4):
            c = R.mul_e(param, hk, c, y)
        return c

    got = R.decrypt(param, sk, R.from_evals(param, R.mul_e(param, hk, x, y)))
    a, b = (v.cpu().numpy().astype(np.float64) for v in m)
    lin = np.rint(np.fft.irfft(np.fft.rfft(a, 2 * n) * np.fft.rfft(b, 2 * n),
                               2 * n)).astype(np.int64)
    if not np.array_equal(got.cpu().numpy(), (lin[:, :n] - lin[:, n:]) % 256):
        raise RuntimeError("degree15: mul_e does not decrypt to the product")
    ms = best_of_3(run) / 4
    print(f"degree15 chain {args.tree} [{card}]: mul_e (HRLK) {ms:.4f} ms an "
          f"op = {B * 1e3 / ms:.1f} ct-mul/s (a chain of 4, best of 3; one "
          f"op decrypt-checked)", flush=True)


CONVERSION_REPS = 3


def conversion(args, card: str) -> None:
    """The --conversion run (see the module docstring)."""
    from fhe_study_tpu_torch.models import bfv_rns as R
    from fhe_study_tpu_torch.ops import _cuda, ext_cuda
    from fhe_study_tpu_torch.ops import ntt_cuda as nc
    from fhe_study_tpu_torch.utils import kernel_check as kc
    from fhe_study_tpu_torch.utils import prng
    dev = torch.device("cuda", 0)
    B, reps = args.batch, CONVERSION_REPS
    bound_of = card_bound(kc, dev)
    busy = torch.zeros(1 << 28, dtype=torch.int32, device=dev)

    def timed(label, fn, nbytes, ops):
        fn()
        ms, _ = events_ms(fn, reps, busy)
        b = bound_of(kc.Case("", "", fn, fn, nbytes, ops))
        share = ("" if b is None else f", bound {b.ms:.4f} ms by {b.term}, "
                 f"{b.ms / ms:.3f} of it")
        print(f"conversion {args.tree} [{card}]: {label}: on the device "
              f"alone {ms:.4f} ms{share}", flush=True)

    def held(label, kern, comp):
        if not kc.equal(kern(), comp()):
            raise RuntimeError(f"conversion: {label} != the kernel's output")

    for L in (14, 29):
        param = R.RnsParam(n=1 << 15, t=256, L=L, M=L + 1)
        qs, ps, n, M = param.qs, param.ps, param.n, L + 1
        res = prng.device_residues(L, dev)
        x2 = res(qs, (B, 2, n))
        ct = [res(qs, (B, n)) for _ in range(4)]
        t_p = (param.t,) * M
        rows, tw = B * n, 2 * n
        shape = f"L={L} M={M} B={B} n={n}"

        def k6_comp():
            e = ext_cuda.base_extend_fused_kernel(torch.stack(ct, dim=-2),
                                                  qs, ps)
            return nc.tensor_mul4_kernel(*(e[..., i, :] for i in range(4)),
                                         ps, scale=t_p)

        k5 = (lambda: nc.ext_ntt_kernel(x2, qs, ps))
        k5_comp = (lambda: nc.ntt_multi_kernel(
            ext_cuda.base_extend_fused_kernel(x2, qs, ps), ps))
        k6 = (lambda: nc.tensor_mul4_kernel(*ct, ps, scale=t_p, src=qs))
        held(f"K4 + K1 at {shape}", k5, k5_comp)
        held(f"K4 + K6 over P at {shape}", k6, k6_comp)
        # the least work of each (kernel_check.cases's "Q->P" and "P basis,
        # Q->P inside"), which its composition does too
        k5_words = 2 * (L + M) * rows + tw * M
        k5_ops = kc._ext_ops(2 * rows, L, M) + kc._ntt_ops(n, 2 * M * B)
        timed(f"K5 ext_ntt Q->P [{L}, {B}, 2, {n}]", k5, 4 * k5_words,
              k5_ops)
        timed(f"K4 + K1 (the same output) at {shape}", k5_comp,
              4 * k5_words, k5_ops)
        k6_words = 4 * L * rows + 3 * M * rows + 2 * tw * M
        k6_ops = (kc._ntt_ops(n, 7 * M * B) + M * rows * (
            4 * kc.MONT_OPS + kc.ADD_OPS + 3 * kc.SHOUP_OPS)
            + kc._ext_ops(4 * rows, L, M))
        timed(f"K6 tensor_mul4 over P from {L} sources, four [{L}, {B}, "
              f"{n}]", k6, 4 * k6_words, k6_ops)
        timed(f"K4 + K6 over P (the same output) at {shape}", k6_comp,
              4 * k6_words, k6_ops)
        if hasattr(nc, "lift_plan"):
            timed(f"the lift alone on K5's [{L}, {B}, 2, {n}]",
                  lambda: ext_cuda.lift_kernel(x2, qs),
                  4 * (2 * L + 1) * 2 * rows,
                  2 * rows * L * (kc.SHOUP_OPS + kc.WIDE_MAC_OPS))
        del x2, ct, k5, k6, k5_comp
        torch.cuda.empty_cache()
    if _cuda.EXT_NTT.logn[1] > 15:
        conversion_past_a_block(args, card, timed, held)
    if not hasattr(nc, "lift_plan"):
        return
    # the direct instances against the staged layout where both take the
    # source count: phase 3's L = 4 at N = 2^14
    param = R.RnsParam(n=1 << 14, t=256, L=4, M=5)
    qs, ps, n = param.qs, param.ps, param.n
    res = prng.device_residues(4, dev)
    x2 = res(qs, (B, 2, n))
    ct = [res(qs, (B, n)) for _ in range(4)]
    t_p = (param.t,) * 5
    want = None
    for form in ("direct", "staged", "direct again", "staged again"):
        saved = nc.EXT_NTT_DIRECT, nc.MUL4_DIRECT
        if form.startswith("staged"):
            nc.EXT_NTT_DIRECT, nc.MUL4_DIRECT = (), ()
        try:
            calls = (("K5 Q->P", lambda: nc.ext_ntt_kernel(x2, qs, ps)),
                     ("K6 over P from Q", lambda: nc.tensor_mul4_kernel(
                         *ct, ps, scale=t_p, src=qs)))
            got = tuple(fn() for _, fn in calls)
            want = got if want is None else want
            if not kc.equal(got, want):
                raise RuntimeError(f"conversion: {form} != direct at L=4")
            for label, fn in calls:
                ms, _ = events_ms(fn, 10, busy)
                print(f"conversion {args.tree} [{card}]: L=4 M=5 B={B} "
                      f"n={n}: {label}, {form}: on the device alone "
                      f"{ms:.4f} ms", flush=True)
        finally:
            nc.EXT_NTT_DIRECT, nc.MUL4_DIRECT = saved


KS15_REPS = 3


def ks15(args, card: str) -> None:
    """The --ks15 run (see the module docstring)."""
    from fhe_study_tpu_torch.models import bfv_rns as R
    from fhe_study_tpu_torch.ops import ext_cuda
    from fhe_study_tpu_torch.ops import ntt_cuda as nc
    from fhe_study_tpu_torch.utils import kernel_check as kc
    from fhe_study_tpu_torch.utils import prng
    dev = torch.device("cuda", 0)
    B, n = args.batch, 1 << 15
    bound_of = card_bound(kc, dev)
    busy = torch.zeros(1 << 28, dtype=torch.int32, device=dev)

    def timed(label, case, fn=None):
        fn = fn or case.kernel
        fn()
        ms, _ = events_ms(fn, KS15_REPS, busy)
        b = bound_of(case)
        print(f"ks15 {args.tree} [{card}]: {label}: on the device alone "
              f"{ms:.4f} ms, bound {b.ms:.4f} ms by {b.term}, "
              f"{b.ms / ms:.3f} of it", flush=True)

    names = ("tensor_mul4", "tensor_mul", "ks_fused", "ks_fused_eval")
    for L in (29, 14):
        param = R.RnsParam(n=n, t=256, L=L, M=L + 1)
        qs, ps, M = param.qs, param.ps, L + 1
        cases = [c for c in kc.cases(param, B, dev, prng.Gen(1),
                                     res=prng.device_residues(L, dev))
                 if c.name in names]
        for case in cases:
            timed(f"{case.name} {case.label}", case)
            if case.name != "ks_fused":
                continue
            # the limb and key words the split instance reads through L2:
            # each block both halves of every limb row, its half of both
            # key rows
            print(f"ks15 {args.tree}: {case.name} at R=L={L}: limb and key "
                  f"words through L2 {16 * L * L * B * n / 1e9:.2f} GB a "
                  f"call, the bound's bytes {case.bytes / 1e9:.3f} GB",
                  flush=True)
        # K4 on the four operands stacked, then K6 over P without a source
        # basis: K6 over P's output from the same operands
        res = prng.device_residues(L + 200, dev)
        ct = [res(qs, (B, n)) for _ in range(4)]
        t_p = (param.t,) * M
        kern = (lambda: nc.tensor_mul4_kernel(*ct, ps, scale=t_p, src=qs))

        def comp():
            e = ext_cuda.base_extend_fused_kernel(torch.stack(ct, dim=-2),
                                                  qs, ps)
            return nc.tensor_mul4_kernel(*(e[..., i, :] for i in range(4)),
                                         ps, scale=t_p)
        if not kc.equal(kern(), comp()):
            raise RuntimeError(f"ks15: K4 + K6 != K6 over P at L={L}")
        k6p = next(c for c in cases if c.label.startswith("P basis"))
        timed(f"K4 + K6 over P (K6 over P's output) at L={L} M={M} B={B} "
              f"n={n}", k6p, comp)
        # the lift's rows (L + 1 of each of 4 operands) that the staged
        # instance's 2 M B blocks read through L2, h = n / 2 words each
        own = 2 * M * B * 4 * (L + 1) * (n // 2) * 4
        print(f"ks15 {args.tree}: tensor_mul4 over P from {L}: lift words "
              f"through L2 {own / 1e9:.2f} GB a call with each block its own "
              f"half ({2 * own / 1e9:.2f} GB with both halves), the bound's "
              f"bytes {k6p.bytes / 1e9:.3f} GB", flush=True)
        del ct, kern, comp, k6p
        # K1's forward (fin = 2^32) of the reduced digit rows, then K3: the
        # same output from the same limbs and keys as K7's case
        res = prng.device_residues(L + 100, dev)
        c3 = res(qs, (B, 3, n))
        gb, ga = (res(qs, (L, n)).transpose(0, 1).contiguous()
                  for _ in range(2))
        d = torch.empty((L, L, B, n), dtype=torch.int32, device=dev)
        reps = nc.digit_reps(qs, qs)
        for j, q in enumerate(qs):
            x = c3[..., 2, :]
            for _ in range(reps):
                x = torch.where(x >= q, x - q, x)
            d[:, j] = x
        d = d.view(L * L, B, n)
        mont = tuple((1 << 32) % q for q in qs) * L
        kern = (lambda: nc.ks_fused_kernel(c3[..., 2, :], gb, ga, qs, qs))
        comp = (lambda: nc.ks_contract_kernel(
            nc.ntt_multi_kernel(d, qs * L, fin=mont).view(L, L, B, n),
            gb, ga, qs))
        if not kc.equal(kern(), comp()):
            raise RuntimeError(f"ks15: K1 + K3 != K7 at R=L={L}")
        k7case = next(c for c in cases if c.name == "ks_fused")
        timed(f"K1 forward of the R reduced rows + K3 (K7's output) at "
              f"R=L={L} B={B} n={n}", k7case, comp)
        del cases, c3, gb, ga, d, kern, comp, k7case
        torch.cuda.empty_cache()
    gen = prng.Gen(2)
    case = kc.blind_rotate_case(1 << 16, 1, 1 << 6, 5, 16, 64, dev, gen,
                                layout="split")
    timed(f"blind_rotate {case.label}", case)
    del case, busy
    torch.cuda.empty_cache()
    per_op = gadget_chains(R, dev, B)
    per_op.update(hybrid_mul_chain(R, dev, B))
    print(f"ks15 chains {args.tree} [{card}]: "
          + ", ".join(f"{k} {v:.4f}" for k, v in per_op.items())
          + f" ms an op (N={n} t=256 B={B}; RLK at L=29 M=30, HRLK at "
          "L=14 M=15 K=15)", flush=True)


# chip_smoke.py's phase 21: (N, t, beta, l) of its two configurations
K10DM_CONFIGS = ((1 << 12, 64, 1 << 11, 2), (1 << 15, 16, 1 << 8, 3))
K10DM_STEPS, K10DM_BATCH, K10DM_REPS = 400, 64, 3


def k10dm(args, card: str) -> None:
    """The --k10dm run (see the module docstring)."""
    from fhe_study_tpu_torch.models import bfv_rns as R
    from fhe_study_tpu_torch.utils import kernel_check as kc
    from fhe_study_tpu_torch.utils import prng
    dev = torch.device("cuda", 0)
    bound_of = card_bound(kc, dev)
    busy = torch.zeros(1 << 28, dtype=torch.int32, device=dev)

    def timed(label, case):
        case.kernel()
        ms, _ = events_ms(case.kernel, K10DM_REPS, busy)
        clock = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        b = bound_of(case)
        print(f"k10dm {args.tree} [{card}, SM {clock}]: {label}: on the "
              f"device alone {ms:.4f} ms, bound {b.ms:.4f} ms by {b.term}, "
              f"{b.ms / ms:.3f} of it", flush=True)

    for n, _, beta, l in K10DM_CONFIGS:
        case = kc.blind_rotate_case(n, 1, beta, l, K10DM_STEPS, K10DM_BATCH,
                                    dev, prng.Gen(26 + n))
        timed(f"blind_rotate {case.label}", case)
        del case
        torch.cuda.empty_cache()
    case = kc.blind_rotate_case(1 << 16, 1, 1 << 6, 5, 16, 64, dev,
                                prng.Gen(2), layout="split")
    timed(f"blind_rotate {case.label} (control)", case)
    del case
    for case in kc.cases(R.RnsParam(n=1 << 14, t=256, L=4, M=5), 128, dev,
                         prng.Gen(1)):
        timed(f"{case.name} {case.label} (control)", case)
    del busy
    torch.cuda.empty_cache()
    per_batch = short_chains(dev, 3)
    print(f"k10dm chains {args.tree} [{card}]: "
          + ", ".join(f"{k} {v:.4f} ms a batch of {K10DM_BATCH}"
                      for k, v in per_batch.items()), flush=True)


def short_chains(dev, chain: int) -> dict:
    """ms a batch of chip_smoke.py's phase 21 ``bootstrap_short`` at each
    of K10DM_CONFIGS: a chain of ``chain`` bootstraps, each fed the last
    one's output, decrypt-checked, best of 3; keys drawn on the card."""
    from fhe_study_tpu_torch.arith.params import TORUS_Q, RingParam
    from fhe_study_tpu_torch.models.gfhe.glwe import ERR_SIGMA, Param
    from fhe_study_tpu_torch.models.tfhe import bootstrap, tglwe, tlwe
    from fhe_study_tpu_torch.utils import prng
    out = {}
    for n, t, beta, l in K10DM_CONFIGS:
        gen = prng.Gen(21 + n)
        tp = Param(ERR_SIGMA, RingParam(TORUS_Q, n), 1, t)
        kw = dict(beta=beta, l=l, beta_ks=16, l_ks=8)
        s, _ = tglwe.new_key(gen, tp, dev)
        s_flat = tglwe.sk_to_tlwe(s)
        sbtk = bootstrap.new_short_bootstrapping_key(
            gen, tp, s, n_lwe=K10DM_STEPS, **kw)
        sevals = bootstrap.precompute_short_btk_evals(tp, sbtk)
        table = bootstrap.compute_lookup_table_standard(tp, dev)
        msgs = torch.arange(K10DM_BATCH, device=dev) % (t // 2)
        ct = tlwe.encrypt_uniform(gen, tp.lwe(), s_flat,
                                  tlwe.encode(tp, msgs),
                                  batch=(K10DM_BATCH,))

        def run():
            c = ct
            for _ in range(chain):
                c = bootstrap.bootstrap_short(tp, sbtk, table, c,
                                              btk_evals=sevals, **kw)
            return c
        got = tlwe.decode(tp, tlwe.decrypt(tp.lwe(), s_flat, run()))
        if not torch.equal(got, msgs):
            raise RuntimeError(f"bootstrap_short at N={n}: a chain of "
                               f"{chain} decrypts wrong")
        out[f"bootstrap_short N={n} l={l}"] = best_of_3(run) / chain
        del sbtk, sevals, ct
        torch.cuda.empty_cache()
    return out


def hybrid_mul_chain(R, dev, B: int) -> dict:
    """ms an op of chip_smoke.py's phase 18 ``mul`` with the hybrid key at
    N = 2^15, L = 14, M = 15, K = 15, t = 256: a chain of 4, best of 3,
    one op decrypt-checked against the numpy FFT negacyclic product
    first."""
    from fhe_study_tpu_torch.utils import prng
    gen = prng.Gen(18)
    n, t = 1 << 15, 256
    param = R.RnsParam(n=n, t=t, L=14, M=15)
    sk, pk = R.new_key(gen, param, dev)
    hk = R.hybrid_rlk1(gen, param, sk, K=15)
    m = [torch.randint(0, t, (B, n), device=dev) for _ in range(2)]
    c1, c2 = (R.encrypt(gen, param, pk, mi, batch=(B,)) for mi in m)
    a, b = (v.cpu().numpy().astype(np.float64) for v in m)
    lin = np.rint(np.fft.irfft(np.fft.rfft(a, 2 * n) * np.fft.rfft(b, 2 * n),
                               2 * n)).astype(np.int64)
    got = R.decrypt(param, sk, R.mul(param, hk, c1, c2))
    if not np.array_equal(got.cpu().numpy(), (lin[:, :n] - lin[:, n:]) % t):
        raise RuntimeError("hybrid_mul_chain: mul (HRLK) does not decrypt "
                           "to the product")
    return _chain_ms({"mul (HRLK)": (lambda c: R.mul(param, hk, c, c2), c1)},
                     4)


def gadget_chains(R, dev, B: int) -> dict:
    """ms an op of chip_smoke.py's phase 19 ops at N = 2^15, L = 29,
    M = 30, t = 256: mul and mul_e with the gadget key as chains of 4,
    key_switch over 4 calls, best of 3; one op of each decrypt-checked
    against the numpy FFT negacyclic product (key_switch: against the
    message) first."""
    from fhe_study_tpu_torch.utils import prng
    gen = prng.Gen(19)
    n, t = 1 << 15, 256
    param = R.RnsParam(n=n, t=t, L=29, M=30)
    sk, pk = R.new_key(gen, param, dev)
    rlk = R.rlk_key(gen, param, sk)
    m = [torch.randint(0, t, (B, n), device=dev) for _ in range(2)]
    c1, c2 = (R.encrypt(gen, param, pk, mi, batch=(B,)) for mi in m)
    a, b = (v.cpu().numpy().astype(np.float64) for v in m)
    lin = np.rint(np.fft.irfft(np.fft.rfft(a, 2 * n) * np.fft.rfft(b, 2 * n),
                               2 * n)).astype(np.int64)
    want = (lin[:, :n] - lin[:, n:]) % t
    x, y = R.to_evals(param, c1), R.to_evals(param, c2)
    checks = {
        "mul (RLK)": R.decrypt(param, sk, R.mul(param, rlk, c1, c2)),
        "mul_e (RLK)": R.decrypt(param, sk, R.from_evals(
            param, R.mul_e(param, rlk, x, y)))}
    for label, got in checks.items():
        if not np.array_equal(got.cpu().numpy(), want):
            raise RuntimeError(f"gadget_chains: {label} does not decrypt to "
                               "the product")
    out = _chain_ms({"mul (RLK)": (lambda c: R.mul(param, rlk, c, c2), c1),
                     "mul_e (RLK)": (lambda c: R.mul_e(param, rlk, c, y), x)},
                    4)
    del rlk, x, y
    sk2, _ = R.new_key(gen, param, dev)
    ksk = R.ksk_key(gen, param, sk, sk2)
    got = R.decrypt(param, sk2, R.key_switch(param, ksk, c1))
    if not np.array_equal(got.cpu().numpy(), m[0].cpu().numpy()):
        raise RuntimeError("gadget_chains: key_switch does not decrypt to "
                           "the message")
    out.update(_chain_ms({"key_switch": (
        lambda c: R.key_switch(param, ksk, c1), c1)}, 4))
    return out


def conversion_past_a_block(args, card: str, timed, held) -> None:
    """K5 Q -> P past one block (its chunked schedule) at n = 2^16 on
    chip_smoke.py's phase 23 widths (14 -> 15 primes with 2^17-th roots,
    staged) beside K4 + K1, which give the same output."""
    from fhe_study_tpu_torch.ops import ext_cuda
    from fhe_study_tpu_torch.ops import ntt_cuda as nc
    from fhe_study_tpu_torch.ops.primes import ntt_primes
    from fhe_study_tpu_torch.utils import kernel_check as kc
    from fhe_study_tpu_torch.utils import prng
    dev = torch.device("cuda", 0)
    n, L, M, B = 1 << 16, 14, 15, args.batch
    primes = ntt_primes(L + M, 30, 2 * n)
    qs, ps = primes[:L], primes[L:]
    x2 = prng.device_residues(16, dev)(qs, (B, 2, n))
    shape = f"L={L} M={M} B={B} n={n}"
    k5 = (lambda: nc.ext_ntt_kernel(x2, qs, ps))
    k5_comp = (lambda: nc.ntt_multi_kernel(
        ext_cuda.base_extend_fused_kernel(x2, qs, ps), ps))
    held(f"K4 + K1 at {shape}", k5, k5_comp)
    case = kc.ext_ntt_case("", x2, qs, ps)
    timed(f"K5 ext_ntt Q->P [{L}, {B}, 2, {n}] (chunked)", k5, case.bytes,
          case.ops)
    timed(f"K4 + K1 (the same output) at {shape}", k5_comp, case.bytes,
          case.ops)
    del x2, k5, k5_comp, case
    nc.drop_tables()
    torch.cuda.empty_cache()


def ext_sum_bfv(kernel_check, dev, gen) -> list:
    """K11 at a BFV width: Q -> P on [4, 128, 2^14] residues of the bench's
    primes, unsigned and centered (kernel_check._ext_sum_pair, which trees
    since K11 was ported have)."""
    from fhe_study_tpu_torch.ops.primes import ntt_primes
    from fhe_study_tpu_torch.utils import prng
    primes = ntt_primes(9, 30, 1 << 16)
    qs, ps = primes[:4], primes[4:]
    x = prng.uniform_mod_multi(gen, (128, 1 << 14), qs, dev)
    return [c for centered in (False, True)
            for c in kernel_check._ext_sum_pair(x, qs, ps, centered,
                                                "Q->P [4, 128, 16384]")
            if c.timed]


def yardsticks(param, batch: int, dev, gen) -> list:
    """(label, call) pairs: K6 over Q and over P (Q -> P inside) on the
    path's four [L, B, n] operands, each followed by the composition of
    redesigned kernels that gives the same output from the same values
    stacked as [L, B, 4, n] (the stacking is not timed); then K7 on the
    path's strided c2 and [L, L, n] gadget key, followed by K1's forward
    with fin = 2^32 mod q of the digit rows (c2's limbs reduced mod each
    prime, laid out [R, L, B, n] as K3 reads them: neither is timed) over
    the primes repeated R times, then K3.  Each composition is held equal
    to the kernel before it first."""
    from fhe_study_tpu_torch.ops import ntt_cuda as nc
    from fhe_study_tpu_torch.utils import kernel_check, prng
    qs, ps, n, L = param.qs, param.ps, param.n, param.L
    t_q, t_p = (param.t,) * len(qs), (param.t,) * len(ps)
    x4 = prng.uniform_mod_multi(gen, (batch, 4, n), qs, dev)
    ct = [x4[..., i, :].contiguous() for i in range(4)]

    def eval4(e, dst, scale):
        return nc.tensor_eval4_kernel(*(e[..., i, :] for i in range(4)), dst,
                                      scale=scale)

    rows = [
        ("Q: K6 tensor_mul4", lambda: nc.tensor_mul4_kernel(*ct, qs,
                                                            scale=t_q)),
        ("Q: K1 forward of the four + K2",
         lambda: eval4(nc.ntt_multi_kernel(x4, qs), qs, t_q)),
        ("P, Q->P inside: K6 tensor_mul4",
         lambda: nc.tensor_mul4_kernel(*ct, ps, scale=t_p, src=qs)),
        ("P: K5 Q->P of the four + K2",
         lambda: eval4(nc.ext_ntt_kernel(x4, qs, ps), ps, t_p)),
    ]
    c3 = prng.uniform_mod_multi(gen, (batch, 3, n), qs, dev)
    gb, ga = (torch.stack([prng.uniform_mod_multi(gen, (n,), qs, dev)
                           for _ in range(L)]) for _ in range(2))
    qv = torch.tensor(qs, dtype=torch.int64, device=dev).view(1, L, 1, 1)
    d = c3[..., 2, :].long()[:, None].expand(L, L, batch, n)
    for _ in range(nc.digit_reps(qs, qs)):
        d = torch.where(d >= qv, d - qv, d)
    d = d.int().contiguous().view(L * L, batch, n)
    mont = tuple((1 << 32) % q for q in qs) * L
    rows += [
        ("Q: K7 ks_fused, R=L, strided c2",
         lambda: nc.ks_fused_kernel(c3[..., 2, :], gb, ga, qs, qs)),
        ("Q: K1 forward of the R reduced rows + K3",
         lambda: nc.ks_contract_kernel(
             nc.ntt_multi_kernel(d, qs * L, fin=mont).view(L, L, batch, n),
             gb, ga, qs)),
    ]
    for (_, kern), (label, comp) in zip(rows[::2], rows[1::2]):
        if not kernel_check.equal(kern(), comp()):
            raise RuntimeError(f"yardstick {label}: output != the kernel's")
    return rows


def events_ms(fn, reps: int, busy=None):
    """ms a call of ``reps`` calls of fn by CUDA events.  With ``busy`` (a
    device tensor), the calls queue behind 16 passes over it, enough device
    work for the host to enqueue them all first, and the result is
    (device ms a call, host ms to enqueue a call)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if busy is not None:
        for _ in range(16):
            busy.add_(1)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    return ms if busy is None else (ms, host)


def best_of_3(run) -> float:
    """Least device ms of three calls of run after a warm-up."""
    run()
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        run()
        end.record()
        torch.cuda.synchronize()
        runs.append(begin.elapsed_time(end))
    return min(runs)


def tfhe_chains(dev, chain: int) -> dict:
    """ms a batch of each TFHE pipeline of chip_smoke.py's phase 9 (N = 1024,
    K = 1, t = 8, B = 64, beta = 4096, l = 2, beta_ks = 16, l_ks = 8): a
    chain of ``chain`` bootstraps, each fed the last one's output, best of
    3; keys and messages from one seed."""
    from fhe_study_tpu_torch.arith.params import TORUS_Q, RingParam
    from fhe_study_tpu_torch.models.gfhe.glwe import ERR_SIGMA, Param
    from fhe_study_tpu_torch.models.tfhe import bootstrap, tglwe, tlwe
    from fhe_study_tpu_torch.utils import prng
    gen = prng.Gen(8)
    tp = Param(ERR_SIGMA, RingParam(TORUS_Q, 1024), 1, 8)
    kw = dict(beta=4096, l=2, beta_ks=16, l_ks=8)
    s, _ = tglwe.new_key(gen, tp, dev)
    s_flat = tglwe.sk_to_tlwe(s)
    btk, _ = bootstrap.new_bootstrapping_key(gen, tp, s, s_lwe_out=s_flat,
                                             **kw)
    evals = bootstrap.precompute_btk_evals(tp, btk)
    sbtk = bootstrap.new_short_bootstrapping_key(gen, tp, s, n_lwe=700, **kw)
    sevals = bootstrap.precompute_short_btk_evals(tp, sbtk)
    table = bootstrap.compute_lookup_table_standard(tp, dev)
    msgs = torch.arange(64, device=dev) % 4
    ct = tlwe.encrypt_uniform(gen, tp.lwe(), s_flat, tlwe.encode(tp, msgs),
                              batch=(64,))
    steps = {
        "bootstrap": lambda c: bootstrap.bootstrap(
            tp, btk, table, c, mode="standard", btk_evals=evals, **kw),
        "bootstrap_short": lambda c: bootstrap.bootstrap_short(
            tp, sbtk, table, c, btk_evals=sevals, **kw),
    }
    out = {}
    for label, step in steps.items():
        def run():
            c = ct
            for _ in range(chain):
                c = step(c)
            return c
        got = tlwe.decode(tp, tlwe.decrypt(tp.lwe(), s_flat, run()))
        if not torch.equal(got, msgs):
            raise RuntimeError(f"{label}: a chain of {chain} decrypts wrong")
        out[label] = best_of_3(run) / chain
    return out


def ntt_degrees(dev, gen) -> list:
    """(n, direction, device ms, byte-bound ms) of K9 on [2^22 / n, n] int64
    words under a 30-bit prime, at every n from 2^8 that the tree's K9
    takes up to 2^22, where the prime's 2n-th roots end (to 2^14 before
    2^15 was added, to 2^15 before the transforms crossed blocks)."""
    from fhe_study_tpu_torch.ops import _cuda
    from fhe_study_tpu_torch.ops import ntt as ntt_mod
    from fhe_study_tpu_torch.ops import ntt_cuda as nc
    from fhe_study_tpu_torch.utils import prng
    q = ntt_mod.CRT_PRIMES_TFHE[0]
    busy = torch.zeros(1 << 26, dtype=torch.int32, device=dev)
    rows = []
    top = min(_cuda.NTT.logn[1] if hasattr(_cuda.NTT, "logn") else 14, 22)
    for logn in range(8, top + 1):
        n = 1 << logn
        x = prng.uniform_mod(gen, ((1 << 22) >> logn, n), q, dev)
        bound = (16 * x.numel() + 8 * n) / 3.35e9
        for inverse in (False, True):
            def call():
                return nc.ntt_kernel(x, q, inverse=inverse)
            call()                      # the tables go to the card first
            ms, _ = events_ms(call, 20, busy)
            rows.append((n, "inv" if inverse else "fwd", ms, bound))
    return rows


def ntt_paths(dev) -> tuple:
    """ms an op of the user paths that launch K9: TFHE key generation at
    N = 1024, K = 1, beta = 4096, l = 2 (1024 steps; best of 3), and the
    batched BFV encode and decode at n = 2^13, t = 65537, B = 32 (mean of 20
    calls as called); each checked first.  Also K9's launches in one key
    generation, counted by (shape, prime, inverse)."""
    from fhe_study_tpu_torch.arith.params import TORUS_Q, RingParam
    from fhe_study_tpu_torch.models import bfv_batch
    from fhe_study_tpu_torch.models.gfhe.glwe import ERR_SIGMA, Param
    from fhe_study_tpu_torch.models.tfhe import bootstrap, tglwe, tlwe
    from fhe_study_tpu_torch.ops import ntt_cuda as nc
    from fhe_study_tpu_torch.utils import prng
    gen = prng.Gen(9)
    tp = Param(ERR_SIGMA, RingParam(TORUS_Q, 1024), 1, 8)
    kw = dict(beta=4096, l=2, beta_ks=16, l_ks=8)
    s, _ = tglwe.new_key(gen, tp, dev)
    s_flat = tglwe.sk_to_tlwe(s)

    def keygen():
        btk, _ = bootstrap.new_bootstrapping_key(gen, tp, s, s_lwe_out=s_flat,
                                                 **kw)
        return btk, bootstrap.precompute_btk_evals(tp, btk)

    shapes, kernel = {}, nc.ntt_kernel

    def counted(x, q, inverse=False):
        key = (tuple(x.shape), q, inverse)
        shapes[key] = shapes.get(key, 0) + 1
        return kernel(x, q, inverse=inverse)

    nc.ntt_kernel = counted
    try:
        btk, evals = keygen()
    finally:
        nc.ntt_kernel = kernel
    msgs = torch.arange(64, device=dev) % 4
    ct = tlwe.encrypt_uniform(gen, tp.lwe(), s_flat, tlwe.encode(tp, msgs),
                              batch=(64,))
    table = bootstrap.compute_lookup_table_standard(tp, dev)
    out = bootstrap.bootstrap(tp, btk, table, ct, mode="standard",
                              btk_evals=evals, **kw)
    if not torch.equal(tlwe.decode(tp, tlwe.decrypt(tp.lwe(), s_flat, out)),
                       msgs):
        raise RuntimeError("key generation: a bootstrap under the new key "
                           "decrypts wrong")
    del btk, evals, out
    times = {"key generation": best_of_3(keygen)}
    t, n = 65537, 1 << 13
    slots = prng.uniform_mod(gen, (32, 2, n // 2), t, dev)
    m = bfv_batch.batch_encode(t, n, slots)
    if not torch.equal(bfv_batch.batch_decode(t, n, m), slots):
        raise RuntimeError("batch_decode(batch_encode(slots)) != slots")
    times["batch_encode"] = events_ms(
        lambda: bfv_batch.batch_encode(t, n, slots), 20)
    times["batch_decode"] = events_ms(
        lambda: bfv_batch.batch_decode(t, n, m), 20)
    return times, shapes


def bfv_chains(R, dev, chain: int) -> dict:
    """ms an op of each BFV chain of chip_smoke.py's phase 6, best of 3."""
    from fhe_study_tpu_torch.utils import prng
    gen = prng.Gen(7)
    param = R.RnsParam(n=1 << 14, t=256, L=4, M=5)
    lin = R.RnsParam(n=1 << 12, t=256, L=2, M=3)
    sk, pk = R.new_key(gen, param, dev)
    hk, rlk = R.hybrid_rlk1(gen, param, sk), R.rlk_key(gen, param, sk)
    c1, c2 = (R.encrypt(gen, param, pk,
                        torch.randint(0, 256, (128, param.n), device=dev),
                        batch=(128,)) for _ in range(2))
    x, y = R.to_evals(param, c1), R.to_evals(param, c2)
    _, lpk = R.new_key(gen, lin, dev)
    lm = [torch.randint(0, 256, (1024, lin.n), device=dev) for _ in range(2)]
    le = [R.to_evals(lin, R.encrypt(gen, lin, lpk, m, batch=(1024,)))
          for m in lm]
    lem = R.pt_to_evals(lin, lm[1])
    steps = {
        "mul_e (HRLK)": (lambda c: R.mul_e(param, hk, c, y), x),
        "mul_e (RLK)": (lambda c: R.mul_e(param, rlk, c, y), x),
        "mul (RLK)": (lambda c: R.mul(param, rlk, c, c2), c1),
        "mul (HRLK)": (lambda c: R.mul(param, hk, c, c2), c1),
        "linear step": (lambda c: R.mul_pt_e(lin, R.add_e(lin, c, le[1]),
                                             lem), le[0]),
    }
    return _chain_ms(steps, chain)


def _chain_ms(steps: dict, chain: int) -> dict:
    """ms an op of each (step, start) of ``steps`` as a chain of ``chain``,
    best of 3."""
    out = {}
    for label, (step, start) in steps.items():
        def run():
            c = start
            for _ in range(chain):
                c = step(c)
        out[label] = best_of_3(run) / chain
    return out


def small_chains(R, dev, chain: int) -> dict:
    """ms an op of chip_smoke.py's phase 20 ops at N = 128, t = 16, L = 3,
    M = 4, B = 128: mul_e and mul with either key, chained, and key_switch
    called ``chain`` times on one ciphertext; best of 3."""
    from fhe_study_tpu_torch.utils import prng
    gen = prng.Gen(20)
    param = R.RnsParam(n=128, t=16, L=3, M=4)
    sk, pk = R.new_key(gen, param, dev)
    sk2, _ = R.new_key(gen, param, dev)
    hk, rlk = R.hybrid_rlk1(gen, param, sk), R.rlk_key(gen, param, sk)
    ksk = R.ksk_key(gen, param, sk, sk2)
    c1, c2 = (R.encrypt(gen, param, pk,
                        torch.randint(0, 16, (128, param.n), device=dev),
                        batch=(128,)) for _ in range(2))
    x, y = R.to_evals(param, c1), R.to_evals(param, c2)
    return _chain_ms({
        "n=128 mul_e (HRLK)": (lambda c: R.mul_e(param, hk, c, y), x),
        "n=128 mul_e (RLK)": (lambda c: R.mul_e(param, rlk, c, y), x),
        "n=128 mul (RLK)": (lambda c: R.mul(param, rlk, c, c2), c1),
        "n=128 mul (HRLK)": (lambda c: R.mul(param, hk, c, c2), c1),
        "n=128 key_switch": (lambda c: R.key_switch(param, ksk, c1), c1),
    }, chain)


if __name__ == "__main__":
    main()
