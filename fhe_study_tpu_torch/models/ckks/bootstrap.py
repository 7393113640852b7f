"""CKKS bootstrapping: refresh an exhausted (level 1 or 2) ciphertext to a
high level without decrypting — the counterpart of
fhe_study_tpu/models/ckks/bootstrap.py (eprint 2018/153 structure):

  1. ModRaise      — reinterpret the low-level residues (centered) over the
                     full basis: phase becomes t = m + Q0*I, |I| <= K, with
                     Q0 = q0 (mod_raise) or q0*q1 (mod_raise2).
  2. CoeffToSlot   — eval's slot maps with the twist constants folded in:
                     slots w = (2*pi*t/Q0 - pi/2) / (2^r * vmax), |w| <= 1.
  3. EvalMod       — cos(vmax*w) by even Taylor series in y = w^2
                     (poly.poly_eval / poly_eval2), then r double-angle steps
                     cos(2x) = 2cos^2 x - 1, yielding sin(2*pi*t/Q0), then
                     an arcsin correction.
  4. SlotToCoeff   — eval's slot maps back: coefficients return to ~m, now
                     under the big modulus.

Keys: ``BootstrapKeys`` builds each relinearization key (per level) and
Galois key (per level and element) lazily from the secret key, its mask
and its noise each drawn on a host stream keyed by all the bits of its own
seed, a keyed hash of one master seed and the key's labels
(``hybrid_ks.key_seeds``): the same key whatever order it is asked for in.
``precompute_keys`` finds the complete set by running one bootstrap of an
all-zero ciphertext (batch 1) with lazy keys on the secret key's device,
then keeps no secret.  ``bootstrap`` (lazy or frozen keys) and
``make_staged`` (a frozen set) run one list of stages; ``pack_seeded`` /
``expand_seeded`` ship a set as its ``b`` planes and per-key mask seeds.

Every ciphertext operation is one of eval's and poly's (K1, K3, K4, K6, K7
on the card); ModRaise is int64 torch.  The reference's jit, eval_shape and
tracer handling have no counterpart: a stage is a Python function.
"""

import math
from functools import lru_cache

import numpy as np
import torch

from .. import hybrid_ks
from . import ckks_rns, eval as ev, poly


# the auxiliary primes of every hybrid key the lazy builders make (the
# reference's default K)
AUX_PRIMES = 2


def _level(param, L: int, delta: float | None = None):
    """param's ring and primes at L limbs (and scale delta, if given)."""
    return ckks_rns.Param(n=param.n, L=L,
                          delta=param.delta if delta is None else delta,
                          prime_bits=param.prime_bits)


class BootstrapKeys:
    """Lazy per-level key cache (holds sk).  seed: the master seed (an int,
    not a live generator, whose state would depend on the order of
    requests)."""

    def __init__(self, seed: int, param, sk):
        self.seed = seed
        self.param = param
        self.sk = sk
        self._rlk = None
        self._rot = None
        self._plans = {}   # (tag, L, ...) -> ev.RmapPlan (C2S/S2C reuse)

    def rlks(self):
        # persistent: later bootstrap() calls reuse already-built keys
        if self._rlk is None:
            self._rlk = _LazyRlk(self)
        return self._rlk

    def rotkeys(self):
        if self._rot is None:
            self._rot = _LazyRot(self)
        return self._rot


def _rlk_subkey(master: int, L: int) -> tuple:
    """The (mask, noise) seeds of the relinearization key at level L: shared
    by the lazy builder and the seeded-key packer (pack_seeded)."""
    return hybrid_ks.key_seeds(master, "rlk", L)


def _rot_subkey(master: int, L: int, g: int) -> tuple:
    # (L, g) as two labels, not one packed int: Galois elements range over
    # [1, 2n), so a packing like L*C + g collides for n > C/2, and two keys
    # with identical (a, e) reveal g*(sigma_g1(s) - sigma_g2(s)) noiselessly
    return hybrid_ks.key_seeds(master, "rot", L, g)


class _LazyRlk(dict):
    # holds bk's seed, param and sk, not bk: a reference back to the
    # BootstrapKeys that holds this cache would make a cycle, which keeps
    # every key alive until Python's cyclic collector happens to run
    def __init__(self, bk):
        super().__init__()
        self.seed, self.param, self.sk = bk.seed, bk.param, bk.sk

    def __missing__(self, L):
        pL = _level(self.param, L)
        s_evals = self.sk.s_evals[:L]
        self[L] = ckks_rns.hybrid_rlk_with(
            pL, ckks_rns.SecretKey(s_evals),
            *hybrid_ks.seeded_draws(pL, _rlk_subkey(self.seed, L),
                                    AUX_PRIMES, s_evals.device),
            K=AUX_PRIMES)
        return self[L]


class _LazyRot(ev.RotKeys):
    def __init__(self, bk):                       # no cycle, as _LazyRlk
        super().__init__({})
        self.seed, self.param, self.sk = bk.seed, bk.param, bk.sk

    def aux_count(self, L: int) -> int:
        return AUX_PRIMES

    def get(self, L: int, g: int):
        if (L, g) not in self.keys:
            pL = _level(self.param, L)
            s_evals = self.sk.s_evals[:L]
            self.keys[(L, g)] = hybrid_ks.galois_key_hybrid_with(
                pL, ckks_rns.SecretKey(s_evals), g,
                *hybrid_ks.seeded_draws(pL, _rot_subkey(self.seed, L, g),
                                        AUX_PRIMES, s_evals.device),
                K=AUX_PRIMES)
        return self.keys[(L, g)]


def freeze(keys: BootstrapKeys):
    """Split built key material into (arrays, static): ``arrays`` the
    tensors (every HybridKSK and plan em), ``static`` the host-side plan
    metadata.  Call after one bootstrap() has filled the caches; rebuild
    with FrozenKeys(arrays, static).  Raises if a tensor requires grad or
    the tensors lie on more than one device."""
    arrays = {
        "rlk": dict(keys.rlks()),
        "rot": dict(keys.rotkeys().keys),
        "em": {k: p.em for k, p in keys._plans.items()},
    }
    static = {k: (p.n1, frozenset(p.need_d), frozenset(p.need_e), p.maps,
                  p.pt_levels)
              for k, p in keys._plans.items()}
    tensors = ([t for k in arrays["rlk"].values() for t in k]
               + [t for k in arrays["rot"].values() for t in k]
               + list(arrays["em"].values()))
    if any(t.requires_grad for t in tensors):
        raise ValueError("a bootstrap key tensor requires grad: keys are "
                         "integer residues built outside autograd")
    devices = {t.device for t in tensors}
    if len(devices) > 1:
        raise ValueError(f"bootstrap keys lie on several devices: {devices}")
    return arrays, static


class FrozenKeys:
    """Prebuilt bootstrap key material (see freeze); a drop-in for
    BootstrapKeys that builds nothing."""

    def __init__(self, arrays, static):
        self._rlk = arrays["rlk"]
        self._rot = ev.RotKeys(arrays["rot"])
        self._plans = {
            k: ev.RmapPlan(n1, set(nd), set(ne), maps, arrays["em"][k], pl)
            for k, (n1, nd, ne, maps, pl) in static.items()}

    def rlks(self):
        return self._rlk

    def rotkeys(self):
        return self._rot


def nbytes(tree) -> int:
    """Bytes of every tensor and numpy array in a key set or a pack (dicts
    and tuples walked; a seed counts 8 bytes)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, tuple):
        return sum(nbytes(v) for v in tree)
    return 8 if isinstance(tree, int) else 0


def pack_seeded(arrays, master_seed: int, em_src=None):
    """Seeded-mask compression of a frozen bootstrap key set: every
    HybridKSK keeps its ``b`` plane and its mask seed, not its ``a`` plane
    — half the key bytes.  With em_src (precompute_keys(with_em_src=True))
    the plans ship their compact int64 sources instead of em.
    expand_seeded rebuilds the rest bit for bit.

    The pack holds only the mask seeds: not the master seed, not a noise
    seed (from which the noise, hence the secret key, would follow).  Each
    noise seed is a hash of its own of the master seed, and its stream is
    keyed by all of its 63 bits, so no mask seed narrows it."""
    rlk = {L: (k.b, hybrid_ks.seed_of(master_seed, "rlk", L))
           for L, k in arrays["rlk"].items()}
    rot = {lg: (k.b, hybrid_ks.seed_of(master_seed, "rot", *lg))
           for lg, k in arrays["rot"].items()}
    out = {"rlk": rlk, "rot": rot}
    if em_src is not None:
        out["em_src"] = em_src
    else:
        out["em"] = arrays["em"]
    return out


def expand_seeded(packed, param_boot):
    """Inverse of pack_seeded: every ``a`` plane redrawn from its seed and
    transformed (K1), every em rebuilt from its source (eval.realize_em),
    on the device the pack's ``b`` planes lie on."""
    def with_a(L, b, ka):
        return hybrid_ks.HybridKSK(b=b, a=hybrid_ks.expand_a(
            _level(param_boot, L), ka, int(b.shape[1]) - L, b.device))

    rlk = {L: with_a(L, b, ka) for L, (b, ka) in packed["rlk"].items()}
    rot = {(L, g): with_a(L, b, ka)
           for (L, g), (b, ka) in packed["rot"].items()}
    if "em_src" in packed:
        dev = next(iter(rot.values())).b.device
        em = {k: ev.realize_em(_level(param_boot, int(Lp)), m, dev)
              for k, (m, Lp, _pl) in packed["em_src"].items()}
    else:
        em = packed["em"]
    return {"rlk": rlk, "rot": rot, "em": em}


def mod_raise(param_boot, ct_l1):
    """Level-1 residues (mod q0 = qs[0]), centered lift, re-reduced over the
    full basis.  Output phase = m + q0*I over Q.  int64: every value and
    compare stays in [0, q0)."""
    qs = param_boot.qs
    q0 = qs[0]

    def raise_one(c):
        v = c[0].long()                            # [., n] mod q0
        # centered: v_c in (-q0/2, q0/2]; residues of v_c mod each q_j
        neg = v > q0 // 2
        out = []
        for qj in qs:
            pos = v if qj == q0 else v % qj
            vneg = (qj - (q0 - v) % qj) % qj
            out.append(torch.where(neg, vneg, pos))
        return torch.stack(out, 0).int()

    return ckks_rns.CT(raise_one(ct_l1.c0), raise_one(ct_l1.c1))


def mod_raise2(param_boot, ct_l2):
    """Double-base ModRaise: level-2 residues (mod q0 and q1) -> full
    basis.  2-limb Garner lift v = v0 + q0·((v1 − v0)·q0^{-1} mod q1)
    in [0, Q0), Q0 = q0·q1, then the centered representative re-reduced per
    prime.  Output phase = m + Q0·I.  Exact in int64: d·inv01 < 2^62 and
    v < q0·q1 < 2^62, every compare between non-negative values.

    The point (see bootstrap(base_limbs=2)): the refreshed precision is
    delta0 / (additive KS+rescale noise ~2^8), and delta0 is capped by the
    ModRaise base (|m| << Q0): one ~30-bit prime caps delta0 at ~2^24, the
    2-limb base lifts it to ~2^45 and beyond."""
    qs = param_boot.qs
    q0, q1 = qs[0], qs[1]
    Q0 = q0 * q1
    inv01 = pow(q0, -1, q1)

    def raise_one(c):
        v0 = c[0].long()                           # [., n] mod q0
        v1 = c[1].long()
        d = (v1 + q1 - v0 % q1) % q1
        t = (d * inv01) % q1
        v = v0 + q0 * t
        neg = v > Q0 // 2
        out = []
        for qj in qs:
            pos = v % qj
            vneg = (qj - (Q0 - v) % qj) % qj
            out.append(torch.where(neg, vneg, pos))
        return torch.stack(out, 0).int()

    return ckks_rns.CT(raise_one(ct_l2.c0), raise_one(ct_l2.c1))


def _raise(param_boot, ct, base_limbs: int):
    return (mod_raise(param_boot, ct) if base_limbs == 1
            else mod_raise2(param_boot, ct))


def suggest_K_r(n: int, h: int | None = None, sigma_mult: float = 5.0):
    """EvalMod range parameters for a given ring size / secret weight.

    The ModRaise overflow t = v0 + v1*s has per-coefficient deviation
    sigma_I = sqrt((1 + h_eff)/12) base units (v uniform in +-Q0/2, s
    ternary with h_eff nonzeros; dense ternary has h_eff ~ 2n/3).  K must
    cover the max over ~n coefficients: sigma_mult * sigma_I.  r then
    keeps vmax = (2*pi*(K+.5) + pi/2)/2^r in the ~4..6 range where the
    deg~30 cosine Taylor converges."""
    h_eff = (2 * n) // 3 if h is None else h
    sigma_i = math.sqrt((1 + h_eff) / 12.0)
    K = max(7, math.ceil(sigma_mult * sigma_i))
    r = max(3, math.ceil(math.log2((2 * math.pi * (K + 0.5)
                                    + math.pi / 2) / 5.0)))
    return K, r


@lru_cache(maxsize=None)
def _cos_taylor_even(deg: int, vmax: float):
    """cos(vmax*w) = sum_j c_j (w^2)^j, j = 0..deg/2 (exact even Taylor)."""
    out = []
    for j in range(deg // 2 + 1):
        out.append((-1.0) ** j * vmax ** (2 * j) / math.factorial(2 * j))
    return tuple(out)


def _base(param_boot, base_limbs: int) -> int:
    """The ModRaise base modulus: q0 (classic) or q0·q1 (double-base)."""
    return math.prod(param_boot.qs[:base_limbs])


def _vmax(K: int, r: int) -> float:
    return (2 * math.pi * (K + 0.5) + math.pi / 2) / (1 << r)


def _plan(keys, pkey, param, maps, pt_levels: int, device):
    """keys' plan under pkey, built at param's level on first use."""
    if pkey not in keys._plans:
        keys._plans[pkey] = ev.build_rmap_plan(param, maps, device,
                                               pt_levels=pt_levels)
    return keys._plans[pkey]


def _stage_raise_c2s(param_boot, keys, ct_l1, K, r, delta_w,
                     base_limbs: int = 1):
    """ModRaise + C2S (twist folded) + affine shift -> [(ct, param)] x 2.

    base_limbs=2: the raised phases t reach K·Q0 ~ 2^63, so a one-prime
    diagonal encoding (rounding ~2^-30 relative) would leak ~2^33 of
    absolute w-phase error; a TWO-prime plaintext scale keeps the rounding
    ~2^8 absolute against the 2^60 w-phase.  The matvec consumes 2
    levels."""
    n = param_boot.n
    rk = keys.rotkeys()
    ct = _raise(param_boot, ct_l1, base_limbs)
    a, b, pt_levels = _c2s_ms_consts(param_boot, K, r, delta_w, base_limbs)
    (A1, B1), (A2, B2) = ev._c2s_matrices(n)
    scale_fold = a * delta_w
    p_unit = _level(param_boot, param_boot.L, 1.0)
    plan = _plan(keys, ("c2s", param_boot.L, K, r, delta_w, base_limbs),
                 p_unit, [(A1 * scale_fold, B1 * scale_fold),
                          (A2 * scale_fold, B2 * scale_fold)],
                 pt_levels, ct.c0.device)
    cs, _ = ev.apply_rmap_plan(p_unit, rk, ct, plan)
    p_ = _level(param_boot, param_boot.L - pt_levels, delta_w)
    return [(poly.add_pt_const(p_, c_, b * 1.0), p_) for c_ in cs]


def _c2s_ms_consts(param_boot, K, r, delta_w, base_limbs):
    Q0 = _base(param_boot, base_limbs)
    vmax = _vmax(K, r)
    a = 2 * math.pi / (Q0 * (1 << r) * vmax)
    b = (-math.pi / 2) / ((1 << r) * vmax)
    return a, b, (1 if base_limbs == 1 else 2)


def _same(m1, m2) -> bool:
    return np.array_equal(m1[0], m2[0]) and np.array_equal(m1[1], m2[1])


def _c2s_ms_stage(param_boot, keys, s, c1, c2, L_cur, K, r, delta_w,
                  base_limbs: int, stages: int):
    """Apply C2S stage `s` to both chains (stage 0: c1 is the raised ct,
    c2 ignored — one shared plan emits both chains).  Returns (c1', c2')."""
    n = param_boot.n
    rk = keys.rotkeys()
    a, _, pt_levels = _c2s_ms_consts(param_boot, K, r, delta_w, base_limbs)
    m1, m2 = ev.c2s_stage_maps(n, stages, fold=(a * delta_w) / 2)[s]
    pL = _level(param_boot, L_cur, 1.0)
    dev = c1.c0.device
    if s == 0:
        plan = _plan(keys, ("c2s_ms", s, L_cur, K, r, delta_w, base_limbs,
                            stages), pL, [m1, m2], pt_levels, dev)
        (c1, c2), _ = ev.apply_rmap_plan(pL, rk, c1, plan)
        return c1, c2
    same = _same(m1, m2)
    outs = []
    for chain, (mm, cc) in enumerate(((m1, c1), (m2, c2))):
        ch = 0 if same else chain
        plan = _plan(keys, ("c2s_ms", s, ch, L_cur, K, r, delta_w,
                            base_limbs, stages), pL, [mm], pt_levels, dev)
        (o,), _ = ev.apply_rmap_plan(pL, rk, cc, plan)
        outs.append(o)
    return outs[0], outs[1]


def _s2c_ms_stage(param_boot, keys, s, c1, c2, L_cur, base_limbs: int,
                  stages: int):
    """Apply S2C stage `s` to both chains.  Returns (c1', c2')."""
    n = param_boot.n
    rk = keys.rotkeys()
    fold = (_base(param_boot, base_limbs) / (2 * math.pi)
            if base_limbs == 1 else 1.0)
    pt_levels = 1 if base_limbs == 1 else 2
    smaps = ev.s2c_stage_maps(n, stages)
    m1, m2 = smaps[s]
    if s == len(smaps) - 1 and fold != 1.0:
        m1 = (m1[0] * fold, m1[1] * fold)
        m2 = (m2[0] * fold, m2[1] * fold)
    pL = _level(param_boot, L_cur, 1.0)
    same = _same(m1, m2)
    outs = []
    for chain, (mm, cc) in enumerate(((m1, c1), (m2, c2))):
        ch = 0 if same else chain
        plan = _plan(keys, ("s2c_ms", s, ch, L_cur, base_limbs, stages), pL,
                     [mm], pt_levels, cc.c0.device)
        (o,), _ = ev.apply_rmap_plan(pL, rk, cc, plan)
        outs.append(o)
    return outs[0], outs[1]


def _combine(param_boot, pf, c1, c2, delta0, drops, base_limbs):
    """The S2C tail: add the chains, set the output scale, final rescales.

    phase = delta_sin * fold * sin(2 pi t / Q0) ~ delta_sin * fold *
    (2 pi / Q0) * delta0 * msg: base_limbs=1 folded Q0/(2 pi) into the map
    (it cancels); base_limbs=2 folded nothing (Q0/(2 pi) ~ 2^57 would
    overflow the encoding) and carries the factor in the output delta.
    drops: primes the final rescale removes; by default 1 in the classic
    base and 0 in the double base (its output delta is already ~2^48)."""
    n = param_boot.n
    out = ckks_rns.add(pf, c1, c2)
    out_delta = (pf.delta * delta0 if base_limbs == 1
                 else pf.delta * (2 * math.pi / _base(param_boot, base_limbs))
                 * delta0)
    pout = _level(param_boot, pf.L, out_delta)
    if drops is None:
        drops = 1 if base_limbs == 1 else 0
    for _ in range(drops):
        out, _ = ckks_rns.rescale(pout, out)
        pout = _level(param_boot, pout.L - 1, pout.delta / pout.qs[pout.L - 1])
    return out, pout


def _arcsin_coeffs(terms: int):
    """arcsin(s) Taylor: s + s^3/6 + 3 s^5/40 + 15 s^7/336 ... (`terms`
    odd-power terms) — cancels the linearization error of
    sin(2 pi m / q0) ~ 2 pi m / q0 up to O((m/q0)^{2*terms+1})."""
    out = [0.0, 1.0]
    c = 1.0
    for j in range(1, terms):
        c *= (2 * j - 1) / (2 * j)
        out += [0.0, c / (2 * j + 1)]
    return out


def _stage_evalmod(keys, c_, p_, K, r, deg, double=False, arcsin_terms=2):
    """cos Taylor in w^2 + double-angle ladder + arcsin correction — one
    half of EvalMod.  double=True runs every multiply at the two-prime-drop
    scale (poly.mul_ct2/poly_eval2) for ~2^-40-grade relative error per
    level instead of ~2^-24."""
    rlks = keys.rlks()
    mul = poly.mul_ct2 if double else poly.mul_ct
    peval = poly.poly_eval2 if double else poly.poly_eval
    coeffs = _cos_taylor_even(deg, _vmax(K, r))
    y, py = mul(rlks, c_, p_, c_, p_)                      # y = w^2
    cosv, pc = peval(rlks, y, py, list(coeffs))
    for _ in range(r):                                     # double angle
        sq, ps = mul(rlks, cosv, pc, cosv, pc)
        dbl = ckks_rns.add(ps, sq, sq)                     # 2 cos^2
        cosv = poly.add_pt_const(ps, dbl, -1.0)
        pc = ps
    return peval(rlks, cosv, pc, _arcsin_coeffs(arcsin_terms))


def _stage_s2c(param_boot, keys, halves, delta0, double=False,
               drops: int | None = None, base_limbs: int = 1):
    """S2C (scaled by Q0/(2 pi) in the classic base), combine halves, final
    rescale (see _combine for the scale and the default drops: in the
    double base the output stays at the double-prime scale, where the
    additive noise sits ~46 bits below it)."""
    n = param_boot.n
    rk = keys.rotkeys()
    (s1, p1), (s2, p2) = halves
    L = min(p1.L, p2.L)
    s1, p1 = poly.level_drop(p1, s1, L)
    s2, p2 = poly.level_drop(p2, s2, L)
    D1, D2 = ev._s2c_matrices(n)
    fold = (_base(param_boot, base_limbs) / (2 * math.pi)
            if base_limbs == 1 else 1.0)
    pt_levels = 1 if base_limbs == 1 else 2
    plans = [_plan(keys, (tag, L, base_limbs), _level(param_boot, L, 1.0),
                   [(D * fold, None)], pt_levels, s1.c0.device)
             for tag, D in (("s2c1", D1), ("s2c2", D2))]
    (c1,), pf = ev.apply_rmap_plan(p1, rk, s1, plans[0])
    (c2,), _ = ev.apply_rmap_plan(_level(param_boot, L, p2.delta), rk, s2,
                                  plans[1])
    return _combine(param_boot, pf, c1, c2, delta0, drops, base_limbs)


def _is_double(delta_w: float, double):
    # delta_w ~ one prime (2^30) -> single-drop ladder; ~ two primes
    # (2^60) -> double-drop.  Explicit `double` overrides the heuristic.
    return (delta_w > 2.0 ** 45) if double is None else double


def _pipeline(param_boot, delta0: float, K: int, r: int, deg: int,
              delta_w: float, double: bool | None, arcsin_terms: int,
              s2c_drops: int | None, base_limbs: int, c2s_stages: int,
              s2c_stages: int):
    """The bootstrap as (label, step) pairs in order: ModRaise + C2S (one
    step, or one a radix stage), EvalMod on each half, S2C (one step, or one
    a radix stage).  step(keys, halves) -> halves on the pair
    [(ct, Param), (ct, Param)]: the first step reads the input from
    halves[0][0]; the last leaves (output, output Param) in both.

    The radix split (stages > 1) runs sparse butterfly-group plans instead
    of one dense plan (per-stage diagonals shrink from O(n/2) rows to
    O(2^(log(n/2)/stages))), at (stages-1)*pt_levels extra levels.  Its two
    chains are the lower and upper coefficient halves; C2S stage 0 shares
    one plan and its hoisted babies across both; the coefficient layout in
    between is bit-reversed in t, which the slot-wise EvalMod does not
    see."""
    dbl = _is_double(delta_w, double)
    _, shift, pt_levels = _c2s_ms_consts(param_boot, K, r, delta_w,
                                         base_limbs)

    def c2s_dense(keys, halves):
        return _stage_raise_c2s(param_boot, keys, halves[0][0], K, r,
                                delta_w, base_limbs)

    def c2s_ms(s):
        L_cur = param_boot.L - s * pt_levels
        last = s == c2s_stages - 1

        def step(keys, halves):
            (a, _), (b, _) = halves
            if s == 0:
                a, b = _raise(param_boot, a, base_limbs), None
            a, b = _c2s_ms_stage(param_boot, keys, s, a, b, L_cur, K, r,
                                 delta_w, base_limbs, c2s_stages)
            p_ = _level(param_boot, L_cur - pt_levels,
                        delta_w if last else 1.0)
            if last:                                   # the affine shift
                a, b = (poly.add_pt_const(p_, c_, shift * 1.0)
                        for c_ in (a, b))
            return [(a, p_), (b, p_)]
        return step

    def evalmod(half):
        def step(keys, halves):
            halves = list(halves)
            halves[half] = _stage_evalmod(keys, *halves[half], K, r, deg,
                                          dbl, arcsin_terms)
            return halves
        return step

    def s2c_dense(keys, halves):
        out = _stage_s2c(param_boot, keys, halves, delta0, dbl, s2c_drops,
                         base_limbs)
        return [out, out]

    def s2c_ms(s):
        def step(keys, halves):
            (a, pa), (b, pb) = halves
            if s == 0:                     # both chains at the lower level
                L = min(pa.L, pb.L)
                a, pa = poly.level_drop(pa, a, L)
                b, pb = poly.level_drop(pb, b, L)
            a, b = _s2c_ms_stage(param_boot, keys, s, a, b, pa.L,
                                 base_limbs, s2c_stages)
            p_ = _level(param_boot, pa.L - pt_levels, pa.delta)
            if s < s2c_stages - 1:
                return [(a, p_), (b, p_)]
            out = _combine(param_boot, p_, a, b, delta0, s2c_drops,
                           base_limbs)
            return [out, out]
        return step

    stages = ([(f"C2S {s}", c2s_ms(s)) for s in range(c2s_stages)]
              if c2s_stages > 1 else [("C2S", c2s_dense)])
    stages += [("EvalMod 1", evalmod(0)), ("EvalMod 2", evalmod(1))]
    stages += ([(f"S2C {s}", s2c_ms(s)) for s in range(s2c_stages)]
               if s2c_stages > 1 else [("S2C", s2c_dense)])
    return stages


def _run(stages, keys, ct):
    halves = [(ct, None), (ct, None)]
    for _, step in stages:
        halves = step(keys, halves)
    return halves[0]


def bootstrap(param_boot, keys, ct_l1, delta0: float, K: int = 7, r: int = 3,
              deg: int = 24, delta_w: float = 2.0 ** 30,
              double: bool | None = None, arcsin_terms: int = 2,
              s2c_drops: int | None = None, base_limbs: int = 1,
              c2s_stages: int = 1, s2c_stages: int = 1):
    """ct_l1: level-base_limbs ciphertext with message scale delta0
    (|phase| << Q0).  Returns (ct', param') at a high level with the same
    message and scale ~delta0 (exact output scale in param'.delta).

    delta_w must sit at the rescale granularity: ~2^30 (single mode, one
    prime dropped a multiply) or ~2^60 (double mode, auto-detected: EvalMod
    at double-prime scales, ~20+ refreshed bits instead of ~8; pair it
    with deg >= 30 and arcsin_terms >= 3).  keys: lazy (BootstrapKeys) or
    prebuilt (FrozenKeys)."""
    return _run(_pipeline(param_boot, delta0, K, r, deg, delta_w, double,
                          arcsin_terms, s2c_drops, base_limbs, c2s_stages,
                          s2c_stages), keys, ct_l1)


def precompute_keys(seed: int, param_boot, sk, delta0: float, *,
                    K: int = 7, r: int = 3, deg: int = 24,
                    delta_w: float = 2.0 ** 30, double: bool | None = None,
                    arcsin_terms: int = 2, s2c_drops: int | None = None,
                    base_limbs: int = 1, with_em_src: bool = False,
                    c2s_stages: int = 1, s2c_stages: int = 1):
    """The complete bootstrap key set (per-level hybrid relinearization and
    Galois keys, C2S/S2C plans) from the secret key, on its device.  Returns
    (arrays, static, pout) — or (arrays, static, pout, em_src) with
    with_em_src — holding no secret: ``arrays`` for FrozenKeys/make_staged,
    ``static`` the plan metadata, ``pout`` the output Param.

    Discovery runs the pipeline once on an all-zero level-base_limbs
    ciphertext of batch 1 with lazy keys: the keys and plans a bootstrap
    asks for depend on the parameters only, never on the data."""
    keys = BootstrapKeys(seed, param_boot, sk)
    zero = torch.zeros((base_limbs, 1, param_boot.n), dtype=torch.int32,
                       device=sk.s_evals.device)
    _, pout = bootstrap(param_boot, keys, ckks_rns.CT(zero, zero),
                        delta0=delta0, K=K, r=r, deg=deg, delta_w=delta_w,
                        double=double, arcsin_terms=arcsin_terms,
                        s2c_drops=s2c_drops, base_limbs=base_limbs,
                        c2s_stages=c2s_stages, s2c_stages=s2c_stages)
    arrays, static = freeze(keys)
    if not with_em_src:
        return arrays, static, pout
    # the compact integer sources of the plans' em (ev.realize_em rebuilds
    # em from them bit for bit): ~L/2 times smaller than em
    em_src = {k: (p.src_m, p.src_L, p.pt_levels)
              for k, p in keys._plans.items()}
    return arrays, static, pout, em_src


def make_staged(param_boot, static, delta0: float, K: int = 7, r: int = 3,
                deg: int = 24, delta_w: float = 2.0 ** 30,
                double: bool | None = None, arcsin_terms: int = 2,
                s2c_drops: int | None = None, base_limbs: int = 1,
                c2s_stages: int = 1, s2c_stages: int = 1):
    """bootstrap's stages on a frozen key set (static: plan metadata from
    freeze/precompute_keys).

    Returns run(arrays, c0, c1) -> (CT, pout); run.pout is set by each
    call.  run.stages lists bootstrap's (label, step) pairs, each
    step(keys, halves) -> halves with keys = FrozenKeys(arrays, static)
    (see _pipeline), for timing or probing one stage."""
    stages = _pipeline(param_boot, delta0, K, r, deg, delta_w, double,
                       arcsin_terms, s2c_drops, base_limbs, c2s_stages,
                       s2c_stages)

    def run(arrays, c0, c1):
        out, run.pout = _run(stages, FrozenKeys(arrays, static),
                             ckks_rns.CT(c0, c1))
        return out, run.pout

    run.stages = stages
    return run
