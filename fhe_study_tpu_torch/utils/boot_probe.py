"""CKKS-bootstrap probe: end-to-end and per-stage precision at any ring size
— the counterpart of scripts/boot_probe.py's ``e2e`` and ``stages`` (its
``hlo`` measures the size of XLA's serialized graphs and has none here).

    python3 -m fhe_study_tpu_torch.utils.boot_probe e2e --logn 12 --stages 2
    python3 -m fhe_study_tpu_torch.utils.boot_probe stages --logn 6 \
        --device cpu

``e2e`` builds the key set (precompute_keys), runs make_staged's bootstrap
and prints the refreshed bits (-log2 of the largest slot error) and the
times.  ``stages`` runs the same bootstrap stage by stage and decrypts after
C2S (the w slots) and after EvalMod (the arcsin polynomial of
sin(2 pi t / Q0), after a least-squares fit of its scale) against ground
truth from the secret key: the raised phase t decrypted exactly.  That
locates the stage that loses bits.  The defaults
are the reference probe's (double base, delta0 = 2^45, delta_w = 2^60,
deg 30, three arcsin terms, h = 64, (K, r) = suggest_K_r(n, h),
L = 28 + 2r + 4(S - 1)).
"""

import argparse
import math
import time

import numpy as np
import torch

from ..models.ckks import bootstrap as BB
from ..models.ckks import ckks_rns as C
from ..models.ckks import eval as ev
from ..models.ckks import poly as P
from . import prng


def config(n: int, *, L=None, delta0=2.0 ** 45, delta_w=2.0 ** 60, deg=30,
           K=None, r=None, arcsin_terms=3, h=64, base_limbs=2, drops=None,
           stages=1) -> dict:
    """The bootstrap's keyword arguments (make_staged's) and the ring's."""
    k0, r0 = BB.suggest_K_r(n, h)
    K = k0 if K is None else K
    r = r0 if r is None else r
    return dict(n=n, L=28 + 2 * r + 4 * (stages - 1) if L is None else L,
                h=h, delta0=delta0, K=K, r=r, deg=deg, delta_w=delta_w,
                arcsin_terms=arcsin_terms, s2c_drops=drops,
                base_limbs=base_limbs, c2s_stages=stages, s2c_stages=stages)


def pipeline_kw(cfg: dict) -> dict:
    """The keyword arguments of precompute_keys and make_staged in cfg."""
    return {k: v for k, v in cfg.items() if k not in ("n", "L", "h",
                                                      "delta0")}


def setup(cfg: dict, batch: int, device, seed: int = 0) -> dict:
    """Keys, B ciphertexts of real slots z ~ U(-1, 1) dropped to
    base_limbs limbs, the key set and the staged bootstrap."""
    n = cfg["n"]
    param = C.Param(n=n, L=cfg["L"], delta=cfg["delta0"])
    gen = prng.Gen(seed)
    sk, pk = C.new_key(gen, param, device, h=cfg["h"])
    z = np.random.default_rng(seed).uniform(-1, 1, (batch, n // 2))
    zt = torch.from_numpy(z).to(device)
    ct = C.encrypt(gen, param, pk, C.encode(param, zt, torch.zeros_like(zt)),
                   batch=(batch,))
    ct_low, _ = P.level_drop(param, ct, cfg["base_limbs"])
    t0 = time.perf_counter()
    arrays, static, pout = BB.precompute_keys(
        seed + 1, param, sk, cfg["delta0"], **pipeline_kw(cfg))
    key_s = time.perf_counter() - t0
    run = BB.make_staged(param, static, cfg["delta0"], **pipeline_kw(cfg))
    return dict(cfg=cfg, param=param, sk=sk, z=z, ct_low=ct_low,
                arrays=arrays, static=static, pout=pout, run=run,
                key_s=key_s)


def slots(param, sk, ct, delta: float | None = None):
    """The real parts of ct's slots (float64 numpy [B, n/2]) at param's
    scale, or at delta if given."""
    p = C.Param(n=param.n, L=ct.c0.shape[0],
                delta=param.delta if delta is None else delta,
                prime_bits=param.prime_bits)
    rr, _ = C.decode(p, C.decrypt_to_coeffs(p, sk, ct))
    return rr.cpu().numpy()


def _halves(n: int, v, radix: bool):
    """Coefficients [B, n] -> the slot layout of the two C2S chains: chain
    1 holds the lower half, chain 2 the upper; the radix-split maps leave
    them bit-reversed in the 5-orbit coordinate t (eval.c2s_stage_maps)."""
    m = n // 2
    lo, hi = v[:, :m], v[:, m:]
    if not radix:
        return lo, hi
    j_of, _ = ev._t_maps(n)
    br = ev._bitrev(m)
    out = []
    for h in (lo, hi):
        e = np.empty_like(h)
        e[:, j_of] = h[:, br]
        out.append(e)
    return tuple(out)


def stage_errors(param, sk, ct_low, z, run, keys, pout, *, K, r, delta_w,
                 arcsin_terms, base_limbs, c2s_stages) -> tuple:
    """Run the staged bootstrap step by step on keys (a FrozenKeys of the
    set run takes); returns ({"C2S w", "EvalMod", "final"} -> largest
    absolute error, the output ct).  EvalMod is held
    against its target, the arcsin polynomial of sin(2 pi t / Q0) (the
    reference probe compared with sin alone, which the correction moves
    away from); pout: the output Param (precompute_keys')."""
    n = param.n
    Q0 = BB._base(param, base_limbs)
    p_unit = C.Param(n=n, L=param.L, delta=1.0, prime_bits=param.prime_bits)
    raised = BB._raise(param, ct_low, base_limbs)
    t_true = C.decrypt_to_coeffs(p_unit, sk, raised,
                                 crt_limbs=3).cpu().numpy()
    vmax = BB._vmax(K, r)
    w_true = (2 * math.pi * t_true / Q0 - math.pi / 2) / ((1 << r) * vmax)
    # EvalMod's target: the arcsin correction applied to sin(2 pi t / Q0)
    s_true = np.polynomial.polynomial.polyval(
        np.sin(2 * math.pi * t_true / Q0), BB._arcsin_coeffs(arcsin_terms))
    radix = c2s_stages > 1
    last_c2s = max(i for i, (label, _) in enumerate(run.stages)
                   if label.startswith("C2S"))
    errs = {}
    halves = [(C.CT(ct_low.c0, ct_low.c1), None)] * 2
    for i, (label, step) in enumerate(run.stages):
        halves = step(keys, halves)
        (a, _), (b, _) = halves
        if i == last_c2s:
            got = np.concatenate([slots(param, sk, c, delta_w)
                                  for c in (a, b)], axis=-1)
            want = np.concatenate(_halves(n, w_true, radix), axis=-1)
            errs["C2S w"] = float(np.abs(got - want).max())
        elif label == "EvalMod 2":
            got = np.concatenate([slots(param, sk, c, delta_w)
                                  for c in (a, b)], axis=-1)
            want = np.concatenate(_halves(n, s_true, radix), axis=-1)
            fit = float(np.vdot(want, got) / (np.vdot(got, got) or 1.0))
            errs["EvalMod"] = float(np.abs(fit * got - want).max())
    errs["final"] = float(np.abs(slots(pout, sk, a) - z).max())
    return errs, a


def _bits(err: float) -> float:
    return -math.log2(max(err, 1e-300))


def cmd_e2e(cfg: dict, batch: int, device) -> None:
    pr = setup(cfg, batch, device)
    print(f"keys in {pr['key_s']:.1f} s ({BB.nbytes(pr['arrays']) / 2**30:.3f}"
          f" GiB, no secret)", flush=True)
    t0 = time.perf_counter()
    out, pout = pr["run"](pr["arrays"], pr["ct_low"].c0, pr["ct_low"].c1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    err = float(np.abs(slots(pout, pr["sk"], out) - pr["z"]).max())
    print(f"bootstrap in {dt:.2f} s, pout L={pout.L} "
          f"delta=2^{math.log2(pout.delta):.2f}; max err {err:.3e} "
          f"({_bits(err):.1f} refreshed bits; the reference bench's decrypt "
          f"gate is 2^-18)", flush=True)


def cmd_stages(cfg: dict, batch: int, device) -> None:
    pr = setup(cfg, batch, device)
    errs, _ = stage_errors(pr["param"], pr["sk"], pr["ct_low"], pr["z"],
                           pr["run"], BB.FrozenKeys(pr["arrays"],
                                                    pr["static"]),
                           pr["pout"],
                           **{k: cfg[k] for k in ("K", "r", "delta_w",
                                                  "arcsin_terms",
                                                  "base_limbs",
                                                  "c2s_stages")})
    for k, e in errs.items():
        print(f"{k:12s} max err {e:.3e} ({_bits(e):.1f} bits)", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cmd", choices=("e2e", "stages"))
    ap.add_argument("--logn", type=int, default=11)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--L", type=int)
    ap.add_argument("--delta0", type=float, default=2.0 ** 45,
                    help="absolute, e.g. 3.6e16")
    ap.add_argument("--dw", type=float, default=60, help="log2 delta_w")
    ap.add_argument("--deg", type=int, default=30)
    ap.add_argument("--K", type=int)
    ap.add_argument("--r", type=int)
    ap.add_argument("--arcsin", type=int, default=3)
    ap.add_argument("--h", type=int, default=64)
    ap.add_argument("--base", type=int, default=2, choices=(1, 2))
    ap.add_argument("--drops", type=int)
    ap.add_argument("--stages", type=int, default=1)
    a = ap.parse_args(argv)
    cfg = config(1 << a.logn, L=a.L, delta0=a.delta0, delta_w=2.0 ** a.dw,
                 deg=a.deg, K=a.K, r=a.r, arcsin_terms=a.arcsin, h=a.h,
                 base_limbs=a.base, drops=a.drops, stages=a.stages)
    print(f"n={cfg['n']} L={cfg['L']} K={cfg['K']} r={cfg['r']} B={a.batch} "
          f"S={a.stages} delta0=2^{math.log2(cfg['delta0']):.1f}", flush=True)
    {"e2e": cmd_e2e, "stages": cmd_stages}[a.cmd](cfg, a.batch,
                                                  torch.device(a.device))


if __name__ == "__main__":
    main()
