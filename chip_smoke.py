#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's paths once on one CUDA card.

    python3 chip_smoke.py            # from the repository root, one card

The paths are those of RNS-BFV (models/bfv_rns.py) at N = 2^14, L = 4
Q-primes, M = 5 P-primes, K = 2 auxiliary primes, t = 256, a batch of 128
ciphertexts, its linear pipeline at N = 2^12, L = 2, M = 3, a batch of
1024, and TFHE programmable bootstrapping (models/tfhe/bootstrap.py) at
N = 1024, K = 1, t = 8, a batch of 64, blind-rotation gadget 4096^2,
key-switch gadget 16^8: the full chain of 1024 CMux steps and the
keyswitch-first pipeline over a short key of 700.  Phases, each of which
raises (and so exits non-zero) on any failure:

  1. toolchain and card: torch, CUDA, nvcc; the kernels built from csrc/;
  2. each of the eleven kernel entries against its plain PyTorch version on
     the card, bit for bit, at the paths' shapes (batch 8) and at n = 256;
  3. the eval-resident path: keygen -> hybrid relin key -> encrypt 128
     plaintext pairs -> to_evals -> mul_e -> from_evals -> decrypt;
  4. the coefficient-domain and gadget paths on the same ciphertexts: mul
     with the gadget key, mul with the hybrid key, to_evals -> gadget mul_e
     -> from_evals, key_switch to a second key (decrypted under it), and the
     stacked tensor (tensor_mul_multi, held against tensor_mul4);
  5. the linear pipeline: pt_to_evals, to_evals x 2, one
     mul_pt_e(add_e(., .), em) step;
     every launch counter is set to 0 before each path of 3-5 and read after
     it, and every decrypted result is held against an independent numpy FFT
     negacyclic product for every coefficient;
  6. timing with CUDA events: chains of 8 (hybrid mul_e, gadget mul_e, mul,
     the linear step) and each kernel variant against its plain version at
     the paths' shapes, beside the least time the card could take (bound);
  7. the TFHE full-chain path: tglwe.new_key -> new_bootstrapping_key ->
     precompute_btk_evals -> encrypt_uniform of 64 messages -> bootstrap ->
     decrypt and decode, all 64 held against the messages; the fused chain
     held against the step-by-step chain (fused=False) on the card;
  8. the short path: new_short_bootstrapping_key(n_lwe=700) ->
     bootstrap_short twice, the second on the output of the first;
  9. TFHE timing: a chain of 3 bootstraps of each pipeline, each fed the
     last one's output, as bootstraps/s; the key switch and the sample
     extraction apart; the two TFHE kernels beside plain and bound.

It prints each finding on a line of its own, then the kernels' JSON record,
the card's name and power limit, and as its last line
{"ok": true, "device": {...}}.  Without a CUDA card it exits non-zero.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20240614
N, L, M, T, BATCH, CHAIN = 1 << 14, 4, 5, 256, 128, 8
LIN_N, LIN_L, LIN_M, LIN_BATCH = 1 << 12, 2, 3, 1024
PARITY_BATCH = 8
TFHE_N, TFHE_K, TFHE_T, TFHE_BATCH, TFHE_CHAIN = 1024, 1, 8, 64, 3
TFHE_BETA, TFHE_L, TFHE_BETA_KS, TFHE_L_KS, TFHE_N_LWE = 4096, 2, 16, 8, 700
# the bound's denominators: device memory rate of the H100 SXM data sheet,
# and 64 INT32 lanes per SM per clock (4 partitions x 16, the Hopper
# architecture's figure) times the SM count and the maximum SM clock that
# the card in hand reports
MEMORY_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64


def say(*parts) -> None:
    print(*parts, flush=True)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def smi(field: str) -> str:
    return run(["nvidia-smi", f"--query-gpu={field}",
                "--format=csv,noheader"]).splitlines()[0].strip()


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn over reps calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def negacyclic_reference(a: np.ndarray, b: np.ndarray, t: int):
    """a * b mod (X^n + 1, t) by a float64 FFT of length 2n; exact here
    because every linear-convolution coefficient is below 2^31."""
    n = a.shape[-1]
    lin = np.fft.irfft(np.fft.rfft(a.astype(np.float64), 2 * n)
                       * np.fft.rfft(b.astype(np.float64), 2 * n), 2 * n)
    r = np.rint(lin)
    err = float(np.abs(lin - r).max())
    if err >= 0.25:
        raise RuntimeError(f"FFT reference not exact: rounding error {err}")
    r = r.astype(np.int64)
    return (r[..., :n] - r[..., n:]) % t, err


def main() -> None:
    wall0 = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA card (torch.cuda.is_available() is "
                 "False); nothing was run")
    from fhe_study_tpu_torch.arith.params import TORUS_Q, RingParam
    from fhe_study_tpu_torch.models import bfv_rns as R
    from fhe_study_tpu_torch.models.gfhe.glwe import ERR_SIGMA, Param
    from fhe_study_tpu_torch.models.tfhe import bootstrap, tglwe, tlwe
    from fhe_study_tpu_torch.ops import _cuda, ntt, ntt_cuda
    from fhe_study_tpu_torch.utils import kernel_check, prng

    dev = torch.device("cuda", 0)

    # 1. toolchain and card ------------------------------------------------
    name_limit = smi("name,power.limit")
    card = f"{torch.cuda.get_device_name(0)} ({name_limit})"
    nvcc = run([_cuda._nvcc(), "--version"]).splitlines()[-1]
    say(f"toolchain: python {sys.version.split()[0]}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc}")
    say(f"card: {card}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    int_ops_per_s = sms * INT32_LANES_PER_SM * sm_mhz * 1e6
    say(f"bound: bytes over {MEMORY_BYTES_PER_S / 1e12} TB/s, integer "
        f"operations over {sms} SMs x {INT32_LANES_PER_SM} lanes x "
        f"{sm_mhz:.0f} MHz = {int_ops_per_s / 1e12:.2f} T/s")
    t0 = time.perf_counter()
    _cuda.library()
    build_s = time.perf_counter() - t0
    say(f"build: {len(_cuda.KERNELS)} kernel entries from "
        f"fhe_study_tpu_torch/csrc in {build_s:.1f} s -> {_cuda.build_dir()}")
    for line in _cuda.build_log().splitlines():
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            say("  ptxas:", line.split("ptxas info    :")[-1].strip())

    # 2. kernels against their plain versions ------------------------------
    err = {k.name: 0 for k in _cuda.KERNELS}
    checked = {k.name: 0 for k in _cuda.KERNELS}

    def check(case, got, want) -> None:
        diff = kernel_check.max_abs_err(got, want)
        if not kernel_check.equal(got, want):
            raise RuntimeError(f"{case.name} [{case.label}]: kernel != plain "
                               f"(max |diff| {diff})")
        err[case.name] = max(err[case.name], diff)
        checked[case.name] += 1

    gen = torch.Generator(device=dev).manual_seed(SEED)
    for n in (N, 256):
        param = R.RnsParam(n=n, t=T, L=L, M=M)
        for case in kernel_check.cases(param, PARITY_BATCH, dev, gen):
            got, want = case.kernel(), case.plain()
            torch.cuda.synchronize()
            check(case, got, want)
    tfhe_parity = [
        *kernel_check.tfhe_cases(TFHE_N, TFHE_K, TFHE_BETA, TFHE_L, TFHE_N,
                                 PARITY_BATCH, dev, gen),
        *kernel_check.tfhe_cases(TFHE_N, TFHE_K, TFHE_BETA, TFHE_L,
                                 TFHE_N_LWE, PARITY_BATCH, dev, gen),
        *kernel_check.tfhe_cases(256, 1, 256, 3, 256, PARITY_BATCH, dev, gen)]
    for case in tfhe_parity:
        got, want = case.kernel(), case.plain()
        torch.cuda.synchronize()
        check(case, got, want)
    del tfhe_parity, case, got, want
    missing = [k for k, v in checked.items() if v == 0]
    if missing:
        raise RuntimeError(f"kernels with no parity case: {missing}")
    say(f"parity: kernel == plain (torch.equal) for "
        f"{sum(checked.values())} variants at n={N} and n=256 (batch "
        f"{PARITY_BATCH}) and, for the TFHE kernels, at n={TFHE_N} over "
        f"{TFHE_N} and {TFHE_N_LWE} steps and at n=256: {checked}")

    # 3-5. the paths at full width -----------------------------------------
    path_launches = {}

    def drive(label: str, expects: tuple, fn):
        """Run one path with the launch counters set to 0 just before and
        read just after; every kernel it should go through must have been
        launched."""
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _cuda.launches()
        path_launches[label] = counts
        unlaunched = [k for k in expects if counts[k] == 0]
        if unlaunched:
            raise RuntimeError(f"{label}: never launched {unlaunched}")
        say(f"path: {label} in {seconds:.2f} s (host clock, first call); "
            f"launches { {k: v for k, v in counts.items() if v} }")
        return out

    def verify(label: str, rec, ref, what: str) -> None:
        got = rec.cpu().numpy()
        bad = int((got != ref).sum()) if got.shape == ref.shape else ref.size
        if bad:
            raise RuntimeError(f"{label}: {bad} of {ref.size} decrypted "
                               f"coefficients differ from {what}")
        say(f"verify: {label}: decrypted == {what} for all {ref.shape[0]} x "
            f"{ref.shape[1]} coefficients")

    param = R.RnsParam(n=N, t=T, L=L, M=M)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    st = {}

    def eval_path():
        st["sk"], st["pk"] = R.new_key(gen, param, dev)
        st["hk"] = R.hybrid_rlk1(gen, param, st["sk"])
        st["m"] = [prng.uniform_mod(gen, (BATCH, N), T, dev)
                   for _ in range(2)]
        st["c"] = [R.encrypt(gen, param, st["pk"], m, batch=(BATCH,))
                   for m in st["m"]]
        st["e"] = [R.to_evals(param, c) for c in st["c"]]
        ce = R.mul_e(param, st["hk"], *st["e"])
        return ce, R.decrypt(param, st["sk"], R.from_evals(param, ce))

    shape = f"N={N} L={L} M={M} K=2 t={T} B={BATCH}"
    ce, rec = drive(
        f"keygen -> encrypt -> to_evals -> mul_e (HRLK) -> from_evals -> "
        f"decrypt at {shape}",
        ("ntt_multi", "tensor_eval4", "ks_contract", "base_extend",
         "ext_ntt"), eval_path)
    for name, v in zip(("e0q", "e1q", "e0p", "e1p"), ce):
        want = (len(param.qs) if name.endswith("q") else len(param.ps),
                BATCH, N)
        if tuple(v.shape) != want or v.dtype != torch.int32:
            raise RuntimeError(f"CTE.{name}: {tuple(v.shape)} {v.dtype}")
    sk, hk, (c1, c2), (x, y) = st["sk"], st["hk"], st["c"], st["e"]
    m1, m2 = (m.cpu().numpy() for m in st["m"])
    product, fft_err = negacyclic_reference(m1, m2, T)
    fft = f"the numpy FFT negacyclic product (rounding error {fft_err:.2e})"
    verify("mul_e (HRLK)", rec, product, fft)

    rlk = R.rlk_key(gen, param, sk)
    sk2, _ = R.new_key(gen, param, dev)
    ksk = R.ksk_key(gen, param, sk, sk2)

    rec = drive(f"mul (RLK) -> decrypt at {shape}",
                ("tensor_mul4", "base_extend", "ks_fused", "ntt_multi"),
                lambda: R.decrypt(param, sk, R.mul(param, rlk, c1, c2)))
    verify("mul (RLK)", rec, product, fft)
    rec = drive(f"mul (HRLK) -> decrypt at {shape}",
                ("tensor_mul4", "base_extend", "ntt_multi", "ks_contract"),
                lambda: R.decrypt(param, sk, R.mul(param, hk, c1, c2)))
    verify("mul (HRLK)", rec, product, fft)
    rec = drive(
        f"to_evals -> mul_e (RLK) -> from_evals -> decrypt at {shape}",
        ("ntt_multi", "tensor_eval4", "base_extend", "ks_fused_eval",
         "ext_ntt"),
        lambda: R.decrypt(param, sk, R.from_evals(param, R.mul_e(
            param, rlk, R.to_evals(param, c1), R.to_evals(param, c2)))))
    verify("mul_e (RLK)", rec, product, fft)
    rec = drive(f"key_switch -> decrypt under the second key at {shape}",
                ("ks_fused", "ntt_multi"),
                lambda: R.decrypt(param, sk2, R.key_switch(param, ksk, c1)))
    verify("key_switch", rec, m1, "the plaintext that was encrypted")
    t_q = (T,) * L
    stacked = drive(
        f"tensor_mul_multi on the stacked ciphertext pair at {shape}",
        ("tensor_mul",),
        lambda: ntt.tensor_mul_multi(
            torch.stack([c1.c0, c1.c1, c2.c0, c2.c1], dim=-2), param.qs,
            scale=t_q))
    x4 = torch.stack([c1.c0, c1.c1, c2.c0, c2.c1], dim=-2)
    if not torch.equal(stacked, ntt_cuda.tensor_mul_plain(x4, param.qs,
                                                          scale=t_q)):
        raise RuntimeError("tensor_mul_multi != its plain version on the "
                           "stacked ciphertexts")
    if not torch.equal(stacked, ntt.tensor_mul4(*c1, *c2, param.qs,
                                                scale=t_q)):
        raise RuntimeError("tensor_mul_multi != tensor_mul4 on the same "
                           "ciphertexts")
    say("verify: tensor_mul_multi == tensor_mul_plain == tensor_mul4 "
        "(torch.equal) on the ciphertexts whose product decrypt-verified in "
        "mul above")

    lin = R.RnsParam(n=LIN_N, t=T, L=LIN_L, M=LIN_M)
    lin_shape = f"N={LIN_N} L={LIN_L} M={LIN_M} t={T} B={LIN_BATCH}"

    def linear_step():
        st["lsk"], pk = R.new_key(gen, lin, dev)
        st["lm"] = [prng.uniform_mod(gen, (LIN_BATCH, LIN_N), T, dev)
                    for _ in range(2)]
        cts = [R.encrypt(gen, lin, pk, m, batch=(LIN_BATCH,))
               for m in st["lm"]]
        st["lem"] = R.pt_to_evals(lin, st["lm"][1])
        st["le"] = [R.to_evals(lin, c) for c in cts]
        step = R.mul_pt_e(lin, R.add_e(lin, *st["le"]), st["lem"])
        return R.decrypt(lin, st["lsk"], R.from_evals(lin, step))

    rec = drive(f"linear: pt_to_evals, to_evals x 2, mul_pt_e(add_e) -> "
                f"from_evals -> decrypt at {lin_shape}",
                ("ntt_multi", "ext_ntt"), linear_step)
    lm1, lm2 = (m.cpu().numpy() for m in st["lm"])
    product, fft_err = negacyclic_reference((lm1 + lm2) % T, lm2, T)
    verify("linear step (m1 + m2) * m2", rec, product,
           f"the numpy FFT negacyclic product (rounding error {fft_err:.2e})")

    # 6. timing ------------------------------------------------------------
    def chain_of(step, start):
        def chain():
            c = start
            for _ in range(CHAIN):
                c = step(c)
            return c
        return chain

    def per_op_launches(fn) -> dict:
        _cuda.reset_launches()
        fn()
        return {k: v for k, v in _cuda.launches().items() if v}

    chains = [
        ("mul_e (HRLK)", "ct-mul/s", BATCH,
         lambda c: R.mul_e(param, hk, c, y), x),
        ("mul_e (RLK)", "ct-mul/s", BATCH,
         lambda c: R.mul_e(param, rlk, c, y), x),
        ("mul (RLK)", "ct-mul/s", BATCH,
         lambda c: R.mul(param, rlk, c, c2), c1),
        ("mul (HRLK)", "ct-mul/s", BATCH,
         lambda c: R.mul(param, hk, c, c2), c1),
        ("linear mul_pt_e(add_e)", "ops/s", LIN_BATCH,
         lambda c: R.mul_pt_e(lin, R.add_e(lin, c, st["le"][1]), st["lem"]),
         st["le"][0]),
    ]
    for label, unit, batch, step, start in chains:
        per_op = per_op_launches(lambda: step(start))
        chain = chain_of(step, start)
        chain()                                       # warm up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = [time_ms(chain, 1, warmup=0) for _ in range(3)]
        peak = torch.cuda.max_memory_allocated()
        best = min(runs)
        say(f"timing: chain of {CHAIN} {label} at B={batch}: runs "
            f"{[round(r, 3) for r in runs]} ms, best {best:.3f} ms = "
            f"{best / CHAIN:.3f} ms per op = "
            f"{batch * CHAIN / (best / 1e3):.1f} {unit}; peak device memory "
            f"{peak / 2**30:.2f} GiB; launches per op {per_op} [{card}]")
    # a kernel's ms, plain_ms and bound_ms: one call of each of its variants
    # at the paths' shapes, summed
    ms = {k.name: 0.0 for k in _cuda.KERNELS}
    plain_ms, byte_ms, op_ms, bound_ms = dict(ms), dict(ms), dict(ms), dict(ms)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def time_case(case) -> None:
        check(case, case.kernel(), case.plain())
        k_ms = time_ms(case.kernel, case.kernel_reps)
        p_ms = time_ms(case.plain, case.plain_reps, warmup=case.plain_warmup)
        b_ms = case.bytes / MEMORY_BYTES_PER_S * 1e3
        o_ms = case.ops / int_ops_per_s * 1e3
        ms[case.name] += k_ms
        plain_ms[case.name] += p_ms
        byte_ms[case.name] += b_ms
        op_ms[case.name] += o_ms
        bound_ms[case.name] += max(b_ms, o_ms)
        say(f"timing: {case.name:13s} {case.label:48s} kernel {k_ms:8.3f} ms"
            f"  plain {p_ms:9.3f} ms  bound {max(b_ms, o_ms):7.4f} ms "
            f"(bytes {b_ms:.4f}, operations {o_ms:.4f})  [{card}]")

    for case in (kernel_check.cases(param, BATCH, dev, gen)
                 + kernel_check.linear_cases(lin, LIN_BATCH, dev, gen)):
        time_case(case)
    # the BFV state is done with: free it, so that the TFHE phases' peak
    # memory is their own
    del case, chains, step, start, chain, sk, sk2, hk, rlk, ksk, c1, c2
    del x, y, ce, rec, stacked, x4
    st.clear()
    torch.cuda.empty_cache()

    # 7. TFHE: the full chain ------------------------------------------------
    tp = Param(ERR_SIGMA, RingParam(TORUS_Q, TFHE_N), TFHE_K, TFHE_T)
    gadget = dict(beta=TFHE_BETA, l=TFHE_L, beta_ks=TFHE_BETA_KS,
                  l_ks=TFHE_L_KS)
    tshape = (f"N={TFHE_N} K={TFHE_K} t={TFHE_T} B={TFHE_BATCH} "
              f"beta={TFHE_BETA} l={TFHE_L} beta_ks={TFHE_BETA_KS} "
              f"l_ks={TFHE_L_KS}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    table = bootstrap.compute_lookup_table_standard(tp, dev)
    msgs = torch.arange(TFHE_BATCH, device=dev) % (TFHE_T // 2)
    ts = {}

    def decoded(s_key, ct):
        return tlwe.decode(tp, tlwe.decrypt(tp.lwe(), s_key, ct))

    def verify_messages(label: str, got) -> None:
        bad = int((got != msgs).sum())
        if tuple(got.shape) != (TFHE_BATCH,) or bad:
            raise RuntimeError(f"{label}: {bad} of {TFHE_BATCH} bootstrapped "
                               "messages differ from the ones encrypted")
        say(f"verify: {label}: decode(decrypt) == m for all {TFHE_BATCH} "
            "messages")

    def full_path():
        s, _ = tglwe.new_key(gen, tp, dev)
        ts["s_flat"] = tglwe.sk_to_tlwe(s)
        ts["btk"], s_out = bootstrap.new_bootstrapping_key(
            gen, tp, s, s_lwe_out=ts["s_flat"], **gadget)
        ts["s"] = s
        ts["evals"] = bootstrap.precompute_btk_evals(tp, ts["btk"])
        ts["c"] = tlwe.encrypt_uniform(gen, tp.lwe(), ts["s_flat"],
                                       tlwe.encode(tp, msgs),
                                       batch=(TFHE_BATCH,))
        out = bootstrap.bootstrap(tp, ts["btk"], table, ts["c"],
                                  mode="standard", btk_evals=ts["evals"],
                                  **gadget)
        return out, decoded(s_out, out)

    out, got = drive(f"tglwe.new_key -> new_bootstrapping_key -> "
                     f"precompute_btk_evals -> encrypt_uniform -> bootstrap "
                     f"-> decrypt at {tshape}", ("ntt", "blind_rotate"),
                     full_path)
    if int(ts["c"].a.max()) <= 1 << 60:
        raise RuntimeError("the ciphertext masks are not uniform")
    if tuple(out.a.shape) != (TFHE_BATCH, tp.kn) or out.a.dtype != torch.int64:
        raise RuntimeError(f"bootstrap output: {tuple(out.a.shape)}")
    verify_messages(f"bootstrap ({TFHE_N} CMux steps)", got)
    s_flat, btk, evals, ct = ts["s_flat"], ts["btk"], ts["evals"], ts["c"]

    stepwise = drive(
        f"blind_rotation(fused=False), {TFHE_N} steps of cmux_evals, at "
        f"{tshape}", ("ntt_multi",),
        lambda: bootstrap.blind_rotation(
            tp, btk, table, ct, TFHE_BETA, TFHE_L, btk_evals=evals,
            fused=False))
    fused = bootstrap.blind_rotation(tp, btk, table, ct, TFHE_BETA, TFHE_L,
                                     btk_evals=evals)
    if not (torch.equal(fused.a, stepwise.a)
            and torch.equal(fused.b, stepwise.b)):
        raise RuntimeError("blind_rotate kernel != the step-by-step chain")
    say(f"verify: blind_rotate (one launch) == {TFHE_N} steps of cmux_evals "
        f"(torch.equal) on the {TFHE_BATCH} ciphertexts")
    del stepwise, fused

    # 8. TFHE: the keyswitch-first pipeline ---------------------------------
    def short_path():
        ts["sbtk"] = bootstrap.new_short_bootstrapping_key(
            gen, tp, ts["s"], n_lwe=TFHE_N_LWE, **gadget)
        ts["sevals"] = bootstrap.precompute_short_btk_evals(tp, ts["sbtk"])
        first = bootstrap.bootstrap_short(tp, ts["sbtk"], table, ct,
                                          btk_evals=ts["sevals"], **gadget)
        second = bootstrap.bootstrap_short(tp, ts["sbtk"], table, first,
                                           btk_evals=ts["sevals"], **gadget)
        return decoded(s_flat, first), decoded(s_flat, second)

    got1, got2 = drive(
        f"new_short_bootstrapping_key(n_lwe={TFHE_N_LWE}) -> "
        f"precompute_short_btk_evals -> bootstrap_short x 2 -> decrypt at "
        f"{tshape}", ("ntt", "blind_rotate"), short_path)
    verify_messages(f"bootstrap_short ({TFHE_N_LWE} CMux steps)", got1)
    verify_messages("bootstrap_short of its own output", got2)
    sbtk, sevals = ts["sbtk"], ts["sevals"]

    launches = {k.name: sum(c[k.name] for c in path_launches.values())
                for k in _cuda.KERNELS}
    never = [k for k, v in launches.items() if v == 0]
    if never:
        raise RuntimeError(f"kernels launched on no path: {never}")

    # 9. TFHE timing ---------------------------------------------------------
    def chain_of_bootstraps(step):
        def chain():
            c = ct
            for _ in range(TFHE_CHAIN):
                c = step(c)
            return c
        return chain

    pipelines = [
        (f"bootstrap ({TFHE_N} steps)", lambda c: bootstrap.bootstrap(
            tp, btk, table, c, mode="standard", btk_evals=evals, **gadget)),
        (f"bootstrap_short ({TFHE_N_LWE} steps)",
         lambda c: bootstrap.bootstrap_short(tp, sbtk, table, c,
                                             btk_evals=sevals, **gadget)),
    ]
    for label, step in pipelines:
        per_op = per_op_launches(lambda: step(ct))
        chain = chain_of_bootstraps(step)
        verify_messages(f"chain of {TFHE_CHAIN} {label}",
                        decoded(s_flat, chain()))          # and warm up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = [time_ms(chain, 1, warmup=0) for _ in range(3)]
        peak = torch.cuda.max_memory_allocated()
        best = min(runs)
        say(f"timing: chain of {TFHE_CHAIN} {label} at B={TFHE_BATCH}: runs "
            f"{[round(r, 3) for r in runs]} ms, best {best:.3f} ms = "
            f"{best / TFHE_CHAIN:.3f} ms per batch = "
            f"{best / TFHE_CHAIN / TFHE_BATCH:.4f} ms per bootstrap = "
            f"{TFHE_BATCH * TFHE_CHAIN / (best / 1e3):.1f} bootstraps/s; "
            f"peak device memory {peak / 2**30:.2f} GiB; launches per "
            f"bootstrap {per_op} [{card}]")
    # the parts of a bootstrap outside the blind-rotation kernel
    rotated = bootstrap.blind_rotation(tp, btk, table, ct, TFHE_BETA, TFHE_L,
                                       btk_evals=evals)
    extracted = tglwe.sample_extraction(tp, rotated, 0)
    parts = [
        ("blind_rotation (mod switch, table rotation, the kernel)",
         lambda: bootstrap.blind_rotation(tp, btk, table, ct, TFHE_BETA,
                                          TFHE_L, btk_evals=evals)),
        ("sample_extraction",
         lambda: tglwe.sample_extraction(tp, rotated, 0)),
        (f"tlwe.key_switch {tp.kn} -> {tp.kn}",
         lambda: tlwe.key_switch(tp.lwe(), TFHE_BETA_KS, TFHE_L_KS,
                                 tlwe.KSK(btk.ksk_a, btk.ksk_b), extracted)),
        (f"tlwe.key_switch {tp.kn} -> {TFHE_N_LWE}",
         lambda: tlwe.key_switch(tp.lwe(), TFHE_BETA_KS, TFHE_L_KS,
                                 tlwe.KSK(sbtk.ksk_a, sbtk.ksk_b), ct)),
    ]
    for label, fn in parts:
        torch.cuda.reset_peak_memory_stats()
        say(f"timing: part {label} at B={TFHE_BATCH}: {time_ms(fn, 3):.3f} "
            f"ms; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    del rotated, extracted, parts, pipelines
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    for case in kernel_check.ntt_cases(TFHE_N, TFHE_K, TFHE_L, TFHE_N, dev,
                                       gen):
        time_case(case)
    for steps in (TFHE_N, TFHE_N_LWE):
        time_case(kernel_check.blind_rotate_case(
            TFHE_N, TFHE_K, TFHE_BETA, TFHE_L, steps, TFHE_BATCH, dev, gen))
    step_ops = kernel_check.cmux_step_ops(TFHE_N, TFHE_K + 1, TFHE_L)
    say(f"work: one CMux step on one ciphertext at N={TFHE_N}, C="
        f"{TFHE_K + 1}, l={TFHE_L}: {sum(step_ops.values())} 32-bit integer "
        f"operations {step_ops}")

    say(f"parity: kernel == plain (torch.equal) for all "
        f"{sum(checked.values())} variants, those at the full batch of each "
        f"path (B={BATCH} at n={N}; B={LIN_BATCH} at n={LIN_N}; "
        f"B={TFHE_BATCH} at n={TFHE_N}) included: {checked}")

    record = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         "max_abs_err": err[k.name], "ms": ms[k.name],
         "plain_ms": plain_ms[k.name], "bound_ms": bound_ms[k.name],
         "bound_by": ("operations" if op_ms[k.name] >= byte_ms[k.name]
                      else "bytes"),
         # no PyTorch call computes a modular NTT, an RNS base conversion,
         # a gadget contraction or a chain of CMux steps
         "library_ms": None} for k in _cuda.KERNELS]}
    say(json.dumps(record))
    say(f"wall: {time.perf_counter() - wall0:.1f} s in all")
    say(name_limit)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
