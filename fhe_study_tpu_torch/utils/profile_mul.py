"""Per-stage device time of the RNS-BFV multiply — the counterpart of
scripts/profile_mul.py.

    python3 -m fhe_study_tpu_torch.utils.profile_mul [eval|coeff|all]
        [--n 16384] [--L 4] [--M 5] [--batch 128] [--reps 20] [--seed 1]

  eval  — the stages of the eval-resident ``bfv_rns.mul_e`` (the headline
          path), with the gadget key (RLK) and with the 1-row hybrid key
          (HRLK);
  coeff — the stages of the coefficient-domain ``bfv_rns.mul``, with
          either key.

Stages, as the reference names them: A the degree-2 tensor over Q (K2
``tensor_eval4`` / K6 ``tensor_mul4``), B the same over P, C the scaled
extension w_Q -> P with its epilogue (K4), D the centered extension r_P -> Q
(K4), E the relinearization (K8 ``ks_fused_eval`` / K7 ``ks_fused`` for RLK;
for HRLK ``relinearize_hybrid``: K4, K1, K3, two K4 and the adds), F the
re-entry (K5 ``ext_ntt`` for RLK, ``to_evals`` for HRLK, the coefficient
path's u64 adds), G the whole multiply.  Each stage runs on the inputs the
real multiply hands it (``stages``; their composition equals the multiply
bit for bit), ``reps`` calls back to back between two CUDA events, best of
three; A..F is summed beside G, and one ``torch.profiler`` window over
``reps`` whole multiplies splits the device time into the package's
kernels and torch's own (the glue), beside the window's CUDA-event time.
It runs on the card only and prints the card's name and power limit.
"""

import argparse
import subprocess

import torch

from ..models import bfv_rns as R
from ..ops import ext_cuda, modops32, ntt
from . import prng


def stages(param, key, x, y, mode: str):
    """[(name, fn)] of the multiply's stages on the inputs the real
    multiply hands them, and ``compose()``, the result of the stages'
    outputs put together as the multiply puts them.  mode "eval": x, y are
    CTEs and the multiply is ``mul_e``; "coeff": CTs and ``mul``."""
    qs, ps = param.qs, param.ps
    Q = R._basis(qs).prod
    qinv = tuple(pow(Q, -1, p) for p in ps)
    scale_q, scale_p = (param.t,) * len(qs), (param.t,) * len(ps)
    if mode == "eval":
        A = lambda: ntt.tensor_eval4(x.e0q, x.e1q, y.e0q, y.e1q, qs,  # noqa
                                     scale=scale_q)
        B = lambda: ntt.tensor_eval4(x.e0p, x.e1p, y.e0p, y.e1p, ps,  # noqa
                                     scale=scale_p)
        full = lambda: R.mul_e(param, key, x, y)                      # noqa
    else:
        ops4 = (x.c0, x.c1, y.c0, y.c1)
        A = lambda: ntt.tensor_mul4(*ops4, qs, scale=scale_q)         # noqa
        B = lambda: ntt.tensor_mul4(*ops4, ps, scale=scale_p,         # noqa
                                    src=qs)
        full = lambda: R.mul(param, key, x, y)                        # noqa
    w_q, w_p = A(), B()
    C = lambda: ext_cuda.base_extend_fused(w_q, qs, ps, w=w_p,        # noqa
                                           sub_mul=qinv)
    r_p = C()
    D = lambda: R.fast_base_extend(r_p, ps, qs, centered=True)        # noqa
    out3 = D()
    c0, c1, c2 = (out3[..., i, :] for i in range(3))
    hybrid = isinstance(key, R.HRLK)
    if hybrid:
        E = lambda: R.relinearize_hybrid(param, key, c0, c1, c2)      # noqa
    elif mode == "eval":
        E = lambda: ntt.ks_fused_eval(c2, key.b, key.a, qs, qs,       # noqa
                                      adds=(c0, c1))
    else:
        E = lambda: ntt.ks_fused_multi(c2, key.b, key.a, qs, qs)     # noqa
    e_out = E()
    if hybrid and mode == "eval":
        F = lambda: R.to_evals(param, e_out)                          # noqa
    elif mode == "eval":
        r01 = torch.stack([e_out[2], e_out[3]], dim=-2)
        F = lambda: ntt.ext_ntt(r01, qs, ps)                          # noqa
    elif hybrid:
        F = None                   # relinearize_hybrid's adds are inside E
    else:
        qv = modops32.qvec(qs, c0.ndim, c0.device)
        F = lambda: R.CT(modops32.addmod(c0, e_out[0], qv),           # noqa
                         modops32.addmod(c1, e_out[1], qv))

    def compose():
        if mode == "coeff":
            return e_out if hybrid else F()
        if hybrid:
            return F()
        ep = F()
        return R.CTE(e_out[0], e_out[1], ep[..., 0, :], ep[..., 1, :])

    names = ["A tensor Q", "B tensor P", "C ext wQ->P +sub", "D ext rP->Q "
             "centered", "E relin", "F re-entry / adds"]
    out = [(nm, f) for nm, f in zip(names, (A, B, C, D, E, F)) if f]
    return out + [("G whole multiply", full)], compose


def _events_ms(fn, reps: int) -> float:
    """ms a call of ``reps`` calls back to back between two CUDA events
    (the caller has warmed fn up)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile(param, key, x, y, mode: str, reps: int) -> dict:
    """{stage: ms a call (best of three runs of ``reps``)} and the
    profiler's split of ``reps`` whole multiplies."""
    named, compose = stages(param, key, x, y, mode)
    want = named[-1][1]()
    if not all(torch.equal(a, b) for a, b in zip(compose(), want)):
        raise RuntimeError(f"{mode}: the stages do not compose to the "
                           "multiply")
    for _, f in named:
        f()
    ms = {nm: min(_events_ms(f, reps) for _ in range(3)) for nm, f in named}
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    full = named[-1][1]
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        window = _events_ms(full, reps) * reps
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    ours = sum(r[0] for r in rows if "fhe" in r[2])
    busy = sum(r[0] for r in rows)
    return {"ms": ms, "window_ms": window, "busy_ms": busy,
            "kernels_ms": ours, "glue_ms": busy - ours,
            "glue_launches": sum(r[1] for r in rows if "fhe" not in r[2]),
            "top": sorted(rows, reverse=True)[:8], "reps": reps}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="all",
                    choices=("eval", "coeff", "all"))
    ap.add_argument("--n", type=int, default=1 << 14)
    ap.add_argument("--L", type=int, default=4)
    ap.add_argument("--M", type=int, default=5)
    ap.add_argument("--t", type=int, default=256)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_mul times the card: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    param = R.RnsParam(n=opts.n, t=opts.t, L=opts.L, M=opts.M)
    gen = prng.Gen(opts.seed)
    sk, pk = R.new_key(gen, param, dev)
    keys = {"RLK": R.rlk_key(gen, param, sk),
            "HRLK": R.hybrid_rlk1(gen, param, sk)}
    B = opts.batch
    m = [prng.uniform_mod(gen, (B, opts.n), opts.t, dev) for _ in range(2)]
    c = [R.encrypt(gen, param, pk, x, batch=(B,)) for x in m]
    e = [R.to_evals(param, x) for x in c]
    runs = []
    if opts.mode in ("eval", "all"):
        runs += [("mul_e", "eval", k, e) for k in ("HRLK", "RLK")]
    if opts.mode in ("coeff", "all"):
        runs += [("mul", "coeff", k, c) for k in ("RLK", "HRLK")]
    shape = (f"N={opts.n} L={opts.L} M={opts.M} t={opts.t} B={B}, "
             f"{opts.reps} calls a run, best of 3, CUDA events")
    for op, mode, kname, (x, y) in runs:
        res = profile(param, keys[kname], x, y, mode, opts.reps)
        total = sum(v for k, v in res["ms"].items() if not k.startswith("G"))
        for name, v in res["ms"].items():
            print(f"profile_mul: {op} {kname} {name:24s} {v:9.4f} ms "
                  f"[{shape}] [{card}]", flush=True)
        print(f"profile_mul: {op} {kname} sum of the stages {total:.4f} ms "
              f"against the whole multiply {res['ms']['G whole multiply']:.4f}"
              f" ms; {B / total * 1e3:.0f} ct-mul/s at the sum", flush=True)
        print(f"profile_mul: {op} {kname} profiler window of {res['reps']} "
              f"multiplies {res['window_ms']:.3f} ms (CUDA events): device "
              f"busy {res['busy_ms']:.3f} ms (idle share "
              f"{1 - res['busy_ms'] / res['window_ms']:.3f}), the package's "
              f"kernels {res['kernels_ms']:.3f} ms, torch's kernels (the "
              f"glue) {res['glue_ms']:.3f} ms in {res['glue_launches']} "
              f"launches [{card}]", flush=True)
        for ms_, count, key in res["top"]:
            print(f"profile_mul:   {ms_:8.3f} ms in {count:4d} launches of "
                  f"{key[:90]}", flush=True)


if __name__ == "__main__":
    main()
