"""CKKS evaluation toolkit: slot rotations, conjugation, and general slot
linear transforms (matrix-vector via rotation diagonals) — the counterpart
of fhe_study_tpu/models/ckks/eval.py.

For the device encoder's natural slot order (slot j = m(zeta^{2j+1}),
encoder_device.py), the automorphism phi_g moves slot values by the
permutation/conjugation of galois.ckks_slot_perm.  The odd-unit group mod 2n
factors as <5> x <-1>, so every complex-LINEAR slot map decomposes over
rotations of z and rotations of conj(z):

    M z = sum_k d_k * rho_k(z)  +  sum_k e_k * rho_k(z_c)

with rho_k = phi_{5^k}, z_c = phi_{2n-1}(z) (the conjugated ciphertext), and
host-computed diagonals d_k/e_k.  Key switching uses the hybrid (P-extended)
keys, so the rotation noise stays ~1 unit.  Plaintext diagonals are encoded
at scale q_last so that the trailing rescale returns the ciphertext to its
input scale.

The host half (diagonals, BSGS grouping, the radix-split special-FFT stage
maps) is numpy, as in the reference; the loops that only gather are written
as numpy gathers and give the same arrays.  The ciphertext half runs on the
ciphertexts' device: hoisted babies through ``hybrid_ks.hoist_digits`` (K1)
and ``ks_hoisted`` (K3 over R = L digit rows, then 2 x K4), giants through
``rotate_hybrid``'s key switch (K7 over Q u P, then 2 x K4), the diagonals'
encode + NTT + Montgomery lift through K1, and the eval-domain contraction
(Montgomery products and an exact tree of modular adds) in plain torch, as
the reference leaves it to XLA.  The reference's ``lax.scan`` over babies
and giants (and its unrolled form for at most 4 babies) exist for its
compile size only; here one Python loop computes both forms.
"""

from functools import lru_cache

import numpy as np
import torch

from ...ops import modops32
from ...ops.ntt import _addmod_v, _qvec, intt_multi, ntt_multi
from ...utils import prng
from .. import galois, hybrid_ks
from ..bfv_rns import _to_residues
from . import ckks_rns, encoder_device


class RotKeys:
    """Hybrid Galois keys for a set of rotation steps (+ conjugation),
    built PER LEVEL (the RNS gadget is basis-dependent, the same reason
    relinearization keys are per level in poly.py)."""

    def __init__(self, keys: dict):
        self.keys = dict(keys)        # (L, g) -> HybridKSK

    @classmethod
    def build(cls, gen: prng.Gen, param, sk, steps, conj: bool = True,
              K: int = 2, min_L: int = 2, levels=None):
        """Keys for every level in ``levels`` (default min_L .. param.L),
        each drawn from ``gen`` in turn."""
        n = param.n
        gs = sorted({galois.rotation_element(n, k) for k in steps if
                     k % (n // 2)})
        if conj:
            gs.append(galois.conj_element(n))
        keys = {}
        for L in (range(min_L, param.L + 1) if levels is None else levels):
            pL = ckks_rns.Param(n=n, L=L, delta=param.delta,
                                prime_bits=param.prime_bits)
            skL = ckks_rns.SecretKey(sk.s_evals[:L])
            for g in gs:
                keys[(L, g)] = hybrid_ks.galois_key_hybrid(gen, pL, skL, g,
                                                           K=K)
        return cls(keys)

    def get(self, L: int, g: int):
        if (L, g) not in self.keys:
            raise KeyError(f"missing Galois key (L={L}, g={g})")
        return self.keys[(L, g)]

    def aux_count(self, L: int) -> int:
        """The auxiliary prime count K of the keys at level L."""
        for (lv, _), k in self.keys.items():
            if lv == L:
                return k.b.shape[1] - L
        raise KeyError(f"no Galois key at level L={L}")

    def nbytes(self) -> int:
        return sum(k.b.numel() * k.b.element_size()
                   + k.a.numel() * k.a.element_size()
                   for k in self.keys.values())


def rotate(param, rk: RotKeys, ct, k: int):
    """phi_{5^k}: slots move by galois.ckks_slot_perm(n, 5^k)."""
    g = galois.rotation_element(param.n, k)
    if g == 1:
        return ct
    return hybrid_ks.rotate_hybrid(param, rk.get(param.L, g), ct, g)


def conjugate(param, rk: RotKeys, ct):
    g = galois.conj_element(param.n)
    return hybrid_ks.rotate_hybrid(param, rk.get(param.L, g), ct, g)


@lru_cache(maxsize=None)
def _orbit_maps(n: int):
    """For each rotation step k: (perm, conj) of phi_{5^k}; plus the
    conjugation map."""
    half = n // 2
    rots = [galois.ckks_slot_perm(n, pow(5, k, 2 * n)) for k in range(half)]
    conj = galois.ckks_slot_perm(n, 2 * n - 1)
    return rots, conj


@lru_cache(maxsize=None)
def _orbit_tables(n: int):
    """_orbit_maps as [half, half] arrays (step k, slot j): the source slot
    of each diagonal entry, and whether it is reached through z_c."""
    rots, (pc, _) = _orbit_maps(n)
    perm = np.stack([p for p, _ in rots]).astype(np.int64)
    cj = np.stack([c for _, c in rots])
    return np.where(cj, pc[perm], perm), cj


def matrix_diagonals(M, n: int):
    """Host-side: decompose complex [n/2, n/2] M into rotation diagonals.

    Returns (d, e): dicts k -> complex [n/2] vector with
    M z = sum_k d[k] * rho_k(z) + sum_k e[k] * rho_k(z_c); zero diagonals
    are omitted (banded matrices touch few rotations).  Where rho_k(z)[j]
    is conj(z[perm[j]]) (antilinear), the entry is reached through z_c:
    rho_k(z_c)[j] = z[pc[perm[j]]]."""
    half = n // 2
    M = np.asarray(M, np.complex128)
    if M.shape != (half, half):
        raise ValueError(f"M has shape {M.shape}, need {(half, half)}")
    src, cj = _orbit_tables(n)
    v = M[np.arange(half)[None, :], src]                # [k, j]
    nz = v != 0
    dk = np.where(nz & ~cj, v, 0).astype(np.complex128)
    ek = np.where(nz & cj, v, 0).astype(np.complex128)
    d = {k: dk[k] for k in np.flatnonzero((nz & ~cj).any(1)).tolist()}
    e = {k: ek[k] for k in np.flatnonzero((nz & cj).any(1)).tolist()}
    return d, e


def _encode_diag(param, vec, scale: float, device):
    m = encoder_device.encode(torch.from_numpy(np.ascontiguousarray(
                                  vec.real)).to(device),
                              torch.from_numpy(np.ascontiguousarray(
                                  vec.imag)).to(device), param.n, scale)
    return _to_residues(m, param.qs)


def matvec(param, rk: RotKeys, ct, M):
    """Homomorphic y = M z: rotations + plaintext diagonal multiplies + one
    rescale.  Returns (ct', param') at the input scale, one level down.
    rk must hold every rotation step with a nonzero diagonal."""
    d, e = matrix_diagonals(np.asarray(M), param.n)
    scale_pt = float(param.qs[-1])        # the rescale eats exactly this
    dev = ct.c0.device
    acc = None
    zc = conjugate(param, rk, ct) if e else None
    for src, diags in ((ct, d), (zc, e)):
        for k, vec in sorted(diags.items()):
            term = ckks_rns.mul_pt(param, rotate(param, rk, src, k),
                                   _encode_diag(param, vec, scale_pt, dev))
            acc = term if acc is None else ckks_rns.add(param, acc, term)
    if acc is None:
        raise ValueError("zero matrix")
    # acc carries scale delta * q_last; the drop returns it to delta
    ct2, _ = ckks_rns.rescale(param, acc)
    param2 = ckks_rns.Param(n=param.n, L=param.L - 1, delta=param.delta,
                            prime_bits=param.prime_bits)
    return ct2, param2


# -- baby-step/giant-step (BSGS) slot maps ------------------------------------
# ~2 sqrt(n/2) rotations instead of one per diagonal, with the baby rotations
# hoisted (one digit decomposition per input ciphertext).

def _inv_slot_apply(n: int, g: int, u):
    """Host: v with slotmap_g(v) = u, i.e. v[perm[j]] = conj^{cj[j]}(u[j]),
    so that d .* rho_g(w) == rho_g(inv(d) .* w) for plaintext diagonals."""
    perm, cj = galois.ckks_slot_perm(n, g)
    v = np.empty_like(u)
    v[perm] = np.where(cj, np.conj(u), u)
    return v


def rmap_diagonals(A, B, n: int):
    """Diagonals of the R-linear slot map y = A z + B conj(z):
    y = sum_k D_k .* rho_k(z) + sum_k E_k .* rho_k(z_c).  The B part rides
    the same orbit through z_c: B z_c gives its d-diagonals to E and its
    e-diagonals (which reach back through (z_c)_c = z) to D."""
    D, E = {}, {}
    for M, (lin, anti) in ((A, (D, E)), (B, (E, D))):
        if M is None or not np.any(M):
            continue
        d, e = matrix_diagonals(np.asarray(M), n)
        for k, v in d.items():
            lin[k] = lin.get(k, 0) + v
        for k, v in e.items():
            anti[k] = anti.get(k, 0) + v
    return D, E


def _bsgs_n1(n: int) -> int:
    half = n // 2
    return 1 << ((half.bit_length()) // 2)


def bsgs_steps(n: int, n1: int | None = None):
    """Rotation steps a RotKeys ring needs for rmap_bsgs (babies + giants;
    conj=True covers the antilinear part)."""
    half = n // 2
    n1 = n1 or _bsgs_n1(n)
    return sorted(set(range(1, n1)) |
                  {n1 * i for i in range(1, -(-half // n1))})


class RmapPlan:
    """Precomputed BSGS plan for a fixed list of maps y_m = A_m z + B_m z_c.

    k = n1*i + j splits every rotation as rho_{n1 i} o rho_j.  Host side:
    combined diagonals, giant-block grouping, inverse-giant pre-rotation of
    every diagonal (exact complex).  Device side: ALL diagonals encoded,
    transformed and Montgomery-lifted, so that applying the plan is pointwise
    contraction with no per-term transform.  Reusable across ciphertexts at
    the same level; em is int32 [L, num + 1, n] on the device (its last row
    is zero, the pad of the contraction tree).  pt_levels: how many top
    primes the diagonal encoding scale spans (apply rescales that many
    times)."""

    def __init__(self, n1, need_d, need_e, maps, em, pt_levels: int = 1):
        self.n1 = n1
        self.need_d = need_d        # baby steps j feeding rho_j(z)
        self.need_e = need_e        # baby steps j feeding rho_j(z_c)
        self.maps = maps            # per map: [(gi, [(idx, src, j), ...])]
        self.em = em                # [L, num + 1, n] Montgomery eval domain
        self.pt_levels = pt_levels


def _plan_vectors(n: int, maps, n1: int):
    """The host half of a plan: (need_d, need_e, per-map giant blocks, V)
    with V [num + 1, n/2] the diagonals, each pre-rotated by the inverse of
    its giant step, and a zero row last."""
    half = n // 2
    vecs, plan_maps = [], []
    need_d, need_e = set(), set()
    for (A, B) in maps:
        D, E = rmap_diagonals(A, B, n)
        if not (D or E):
            raise ValueError("zero map")
        giants = []
        for i in range(-(-half // n1)):
            gi = i * n1
            ggi = galois.rotation_element(n, gi)
            entries = []
            for j in range(min(n1, half - gi)):
                k = gi + j
                if k in D:
                    entries.append((len(vecs), 0, j))
                    need_d.add(j)
                    vecs.append(_inv_slot_apply(n, ggi, D[k]))
                if k in E:
                    entries.append((len(vecs), 1, j))
                    need_e.add(j)
                    vecs.append(_inv_slot_apply(n, ggi, E[k]))
            if entries:
                giants.append((gi, entries))
        plan_maps.append(giants)
    vecs.append(np.zeros(half, np.complex128))   # pad row: index `num` is 0
    return need_d, need_e, plan_maps, np.stack(vecs)


def build_rmap_plan(param, maps, device, n1: int | None = None,
                    pt_levels: int = 1) -> RmapPlan:
    """The plan of ``maps`` (a list of (A, B) pairs, either may be None) at
    ``param``'s level, its em on ``device``."""
    n = param.n
    n1 = n1 or _bsgs_n1(n)
    scale_pt = 1.0
    for q in param.qs[param.L - pt_levels:]:
        scale_pt *= float(q)
    need_d, need_e, plan_maps, V = _plan_vectors(n, maps, n1)
    # in slabs of ~16M coefficients: only the int32 em is kept whole
    chunk = max(1, (1 << 24) // n)
    m_parts = []
    for i0 in range(0, V.shape[0], chunk):
        Vc = V[i0: i0 + chunk]
        m_parts.append(encoder_device.encode(
            torch.from_numpy(np.ascontiguousarray(Vc.real)).to(device),
            torch.from_numpy(np.ascontiguousarray(Vc.imag)).to(device), n,
            scale_pt).cpu().numpy())
    plan = RmapPlan(n1, need_d, need_e, plan_maps, None, pt_levels)
    # the compact host-side source of em (the float64-sensitive encode is
    # done and exact); realize_em re-derives em from it with integer ops
    plan.src_m = np.concatenate(m_parts)                 # [num+1, n] int64
    plan.src_L = param.L
    plan.em = realize_em(param, plan.src_m, device)
    return plan


def realize_em(param, m, device):
    """em from its compact integer source (RmapPlan.src_m): residue split +
    forward NTT with the Montgomery lift folded in (K1), exact integer ops,
    in slabs of ~2M coefficients.  param must carry the plan's own limb
    count (src_L)."""
    n = m.shape[-1]
    chunk = max(1, (1 << 21) // n)
    mt = torch.as_tensor(np.asarray(m, np.int64))
    parts = [ntt_multi(_to_residues(mt[i0: i0 + chunk].to(device), param.qs),
                       param.qs, mont=True)
             for i0 in range(0, mt.shape[0], chunk)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def apply_rmap_plan(param, rk: RotKeys, ct, plan: RmapPlan):
    """Execute a plan: (n1-1) hoisted baby rotations of z (+ of z_c if any
    map has an antilinear part) shared across all maps; per (map, giant
    block) one eval-domain pointwise contraction + one full rotation.  One
    rescale per pt_level and map.  Returns ([ct_m...], param')."""
    n, qs, L = param.n, param.qs, param.L
    K = rk.aux_count(L)
    edm = hybrid_ks.hoist_digits(param, ct.c1, K)
    zc = edm_c = None
    if plan.need_e:
        gc = galois.conj_element(n)
        zc = hybrid_ks.rotate_hoisted(param, rk.get(L, gc), ct, gc, edm)
        edm_c = hybrid_ks.hoist_digits(param, zc.c1, K)

    # hoisted babies -> stacked eval operands [L, nb_all, B.., n], the need_d
    # babies then the need_e ones
    babies_d = sorted(plan.need_d)
    babies_e = sorted(plan.need_e)
    slot_of = {(0, j): i for i, j in enumerate(babies_d)}
    slot_of.update({(1, j): len(babies_d) + i
                    for i, j in enumerate(babies_e)})
    parts0, parts1 = [], []
    for base, ed, babies in ((ct, edm, babies_d), (zc, edm_c, babies_e)):
        for j in babies:
            g = galois.rotation_element(n, j)
            r = (base if j == 0 else
                 hybrid_ks.rotate_hoisted(param, rk.get(L, g), base, g, ed))
            parts0.append(ntt_multi(r.c0, qs)[:, None])
            parts1.append(ntt_multi(r.c1, qs)[:, None])
    EB0 = torch.cat(parts0, dim=1)
    EB1 = torch.cat(parts1, dim=1)
    del parts0, parts1, edm, edm_c

    dev = ct.c0.device
    nbatch = ct.c0.ndim - 2
    qv32e, nqv32e, _ = modops32.consts(qs, EB0.ndim, dev)
    qv = _qvec(qs, ct.c0.ndim, dev)
    pad_idx = plan.em.shape[1] - 1       # the all-zero diagonal row

    def inner_ct(em_idx, slot_idx):
        """[Emax] index tables -> contracted inner ct (coefficient domain)."""
        em_g = plan.em.index_select(1, em_idx)           # [L, Emax, n]
        em_g = em_g.reshape(em_g.shape[:2] + (1,) * nbatch + (n,))
        p0 = modops32.mont_mul(EB0.index_select(1, slot_idx), em_g, qv32e,
                               nqv32e)
        p1 = modops32.mont_mul(EB1.index_select(1, slot_idx), em_g, qv32e,
                               nqv32e)
        while p0.shape[1] > 1:           # exact tree addmod over entries
            p0 = modops32.addmod(p0[:, 0::2], p0[:, 1::2], qv32e)
            p1 = modops32.addmod(p1[:, 0::2], p1[:, 1::2], qv32e)
        return (intt_multi(p0[:, 0].contiguous(), qs),
                intt_multi(p1[:, 0].contiguous(), qs))

    outs = []
    param2 = ckks_rns.Param(n=param.n, L=L - plan.pt_levels,
                            delta=param.delta, prime_bits=param.prime_bits)
    for giants in plan.maps:
        emax = max(len(e) for _, e in giants)
        emax = 1 << (emax - 1).bit_length()           # pow2 for the tree

        def tables(entries):
            ei = np.full(emax, pad_idx, np.int64)
            sl = np.zeros(emax, np.int64)
            for t, (idx, src, j) in enumerate(entries):
                ei[t] = idx
                sl[t] = slot_of[(src, j)]
            return torch.from_numpy(ei).to(dev), torch.from_numpy(sl).to(dev)

        a0 = a1 = None
        for gi, entries in giants:
            c0, c1 = inner_ct(*tables(entries))
            if gi != 0:
                ggi = galois.rotation_element(n, gi)
                c0 = galois.apply_galois(c0, ggi, qs)
                c1 = galois.apply_galois(c1, ggi, qs)
                c0, c1 = hybrid_ks.hybrid_key_switch(
                    param, rk.get(L, ggi), ckks_rns.CT(c0, c1))
            # the reference starts the giants' sum from the block of gi = 0
            # (or from zero) and adds each rotated block in order
            a0 = c0 if a0 is None else _addmod_v(a0, c0, qv)
            a1 = c1 if a1 is None else _addmod_v(a1, c1, qv)
        ct2 = type(ct)(a0, a1)
        for lv in range(plan.pt_levels):      # one drop per pt-scale prime
            pL = ckks_rns.Param(n=param.n, L=L - lv, delta=param.delta,
                                prime_bits=param.prime_bits)
            ct2, _ = ckks_rns.rescale(pL, ct2)
        outs.append(ct2)
    return outs, param2


# -- multi-stage (radix-split) special-FFT factorization ----------------------
# Slot evaluation is y_t = p(zeta^{5^t mod 2n}) in the 5-orbit coordinates t
# (slot rotations act as translations of t).  The decimation recursion
# applies because 5^(mm/2) == 1 + (2n/2^d)*odd, so the paired point at every
# depth is the negation.  Each butterfly level is a matrix with
# rotation-diagonals {0, +-mm/2}; grouping adjacent levels keeps the product
# sparse.  The leftover input bit reversal is absorbed by the slot-layout
# freedom between C2S and S2C.

@lru_cache(maxsize=None)
def _special_fft_factors(n: int):
    """Butterfly factors of F (t-space, [m, m], m = n/2):
    F = factors[0] @ ... @ factors[-1] @ Pbr, F[t, k] = zeta^(5^t * k).
    Factor d has nonzeros only on t-diagonals {0, +-(m >> (d+1))}."""
    m = n // 2
    zeta = np.exp(1j * np.pi / n)
    logm = m.bit_length() - 1
    factors = []
    for d in range(logm):
        mm = m >> d
        F = np.zeros((m, m), np.complex128)
        for b in range(0, m, mm):
            for t in range(mm // 2):
                e = (pow(5, t, 2 * n) * (1 << d)) % (2 * n)
                y = zeta ** e
                F[b + t, b + t] = 1
                F[b + t, b + mm // 2 + t] = y
                F[b + mm // 2 + t, b + t] = 1
                F[b + mm // 2 + t, b + mm // 2 + t] = -y
        factors.append(F)
    return factors


@lru_cache(maxsize=None)
def _bitrev(m: int):
    bits = m.bit_length() - 1
    return np.array([int(format(t, f"0{bits}b")[::-1], 2) if bits else 0
                     for t in range(m)], np.int64)


@lru_cache(maxsize=None)
def _t_maps(n: int):
    """5-orbit coordinates: t -> (slot j, conj flag).  Slot j holds the
    evaluation at zeta^(2j+1); 5^t mod 2n lands either at u = 2j+1
    (linear) or at 2n-u (the conjugate point)."""
    m = n // 2
    j_of_t = np.empty(m, np.int64)
    cj_of_t = np.empty(m, bool)
    u = 1
    for t in range(m):
        if u < n:
            j_of_t[t] = (u - 1) // 2
            cj_of_t[t] = False
        else:
            j_of_t[t] = (2 * n - u - 1) // 2
            cj_of_t[t] = True
        u = (u * 5) % (2 * n)
    if len(set(j_of_t.tolist())) != m:
        raise ValueError("the 5-orbit does not cover the slots")
    return j_of_t, cj_of_t


def _t_to_nat(n: int, lin=None, anti=None):
    """t-space map -> natural-slot (A, B) pair for the rmap machinery.

    V_t = conj^{cj(t)}(z[j(t)]); out V'_t = lin V + anti conj(V); written
    back as z'[j(t)] = conj^{cj(t)}(V'_t).  A t-entry v with total conj
    parity p lands as conj^{cj_o}(v) in A (p even) or B (p odd) at
    [j_out, j_in]; t -> j is a bijection, so no two entries share a place."""
    m = n // 2
    j_of, cj_of = _t_maps(n)
    A = np.zeros((m, m), np.complex128)
    B = np.zeros((m, m), np.complex128)
    for M, base_parity in ((lin, 0), (anti, 1)):
        if M is None:
            continue
        to, ti = np.nonzero(M)
        v = M[to, ti]
        v = np.where(cj_of[to], np.conj(v), v)
        parity = (base_parity ^ cj_of[to] ^ cj_of[ti]).astype(bool)
        A[j_of[to[~parity]], j_of[ti[~parity]]] += v[~parity]
        B[j_of[to[parity]], j_of[ti[parity]]] += v[parity]
    return A, B


def _group_prod(mats):
    out = mats[0]
    for M in mats[1:]:
        out = out @ M
    return out


def _split_groups(k: int, S: int):
    """k factor indices into S contiguous groups, coarse levels first."""
    S = max(1, min(S, k))
    base, extra = divmod(k, S)
    sizes = [base + (1 if i < extra else 0) for i in range(S)]
    out, i = [], 0
    for s in sizes:
        out.append(list(range(i, i + s)))
        i += s
    return out


@lru_cache(maxsize=None)
def _sigma_t(n: int):
    """sigma in t-space: sigma_j = x_j^m = i*(-1)^j, the X^m evaluation, as
    a t-indexed diagonal (exponent 5^t * m mod 2n)."""
    m = n // 2
    zeta = np.exp(1j * np.pi / n)
    return np.array([zeta ** ((pow(5, t, 2 * n) * m) % (2 * n))
                     for t in range(m)], np.complex128)


@lru_cache(maxsize=None)
def c2s_stage_maps(n: int, S: int, fold: complex = 1.0):
    """Per-stage natural (A, B) maps for the radix-split CoeffToSlot.

    Returns a list of S entries, each [(A, B) of chain 1, (A, B) of chain
    2]: chain 1 yields the LOWER coefficient half, chain 2 the UPPER (its
    first stage folds the diag(conj(sigma)) pre-multiply).  The LAST stage
    of both chains folds the real extraction out = fold*(y + conj(y)).
    The output coefficient layout is bit-reversed in t (s2c_stage_maps
    consumes it)."""
    factors = _special_fft_factors(n)
    inv = [np.linalg.inv(F) for F in factors]
    # the group holding inv[0] (the coarsest butterfly) runs first; within
    # a group the product is reversed, so that stage s = 0 .. S-1 applied in
    # order composes to inv[L-1] @ ... @ inv[0]
    stage_mats = []
    for g in _split_groups(len(inv), S):
        stage_mats.append(_group_prod([inv[i] for i in reversed(g)]))
    sig_c = np.conj(_sigma_t(n))
    out = []
    for s, M in enumerate(stage_mats):
        first, last = (s == 0), (s == S - 1)
        M2 = M @ np.diag(sig_c) if first else M
        if last:
            e1 = _t_to_nat(n, lin=fold * M, anti=fold * np.conj(M))
            e2 = _t_to_nat(n, lin=fold * M2, anti=fold * np.conj(M2))
        else:
            e1 = _t_to_nat(n, lin=M)
            e2 = _t_to_nat(n, lin=M2)
        out.append((e1, e2))
    return out


@lru_cache(maxsize=None)
def s2c_stage_maps(n: int, S: int):
    """Per-stage natural (A, B) maps for the radix-split SlotToCoeff.
    Chain 1 consumes ct1 (lower coefficients, bit-reversed-in-t layout),
    chain 2 ct2; chain 2's LAST stage folds the diag(sigma) post-multiply,
    so that the final combine is a plain ciphertext add."""
    factors = _special_fft_factors(n)
    groups = _split_groups(len(factors), S)
    # the factors[-1] group runs first
    stage_mats = []
    for g in reversed(groups):
        stage_mats.append(_group_prod([factors[i] for i in g]))
    sig = _sigma_t(n)
    out = []
    for s, M in enumerate(stage_mats):
        last = (s == len(stage_mats) - 1)
        M2 = np.diag(sig) @ M if last else M
        out.append((_t_to_nat(n, lin=M), _t_to_nat(n, lin=M2)))
    return out


def rmap_bsgs_multi(param, rk: RotKeys, ct, maps, n1: int | None = None):
    """build_rmap_plan + apply_rmap_plan in one go (single-use maps).
    Returns ([ct_m...], param')."""
    return apply_rmap_plan(param, rk, ct,
                           build_rmap_plan(param, maps, ct.c0.device, n1))


def rmap_bsgs(param, rk: RotKeys, ct, A, B=None, n1: int | None = None):
    """Single-map rmap_bsgs_multi.  Returns (ct', param')."""
    outs, param2 = rmap_bsgs_multi(param, rk, ct, [(A, B)], n1=n1)
    return outs[0], param2


# -- CoeffToSlot / SlotToCoeff ------------------------------------------------
# For the device encoder, slot_j(ct) = m(zeta^{2j+1})/delta with
# D[j,k] = zeta^{(2j+1)k} satisfying D D^H = n I and D conj(D)^T = 0, so the
# (real) coefficient vector recovers as p = (1/n)(D^H z + conj(D^H z)).

def linear_rmap(param, rk: RotKeys, ct, A, B):
    """Homomorphic R-linear slot map y = A z + B conj(z) (two matvecs; one
    level).  Zero matrices are skipped."""
    A = np.asarray(A)
    B = np.asarray(B)
    outs = []
    if np.any(A):
        outs.append(matvec(param, rk, ct, A))
    if np.any(B):
        outs.append(matvec(param, rk, conjugate(param, rk, ct), B))
    if not outs:
        raise ValueError("zero map")
    if len(outs) == 1:
        return outs[0]
    (c1, p1), (c2, _) = outs
    return ckks_rns.add(p1, c1, c2), p1


@lru_cache(maxsize=None)
def _c2s_matrices(n: int):
    """A1/B1 (slots -> first-half coefficients) and A2/B2 (second half)."""
    half = n // 2
    k = np.arange(n)[:, None]
    j = np.arange(half)[None, :]
    zeta = np.exp(1j * np.pi / n)
    Dh = zeta ** (-((2 * j + 1) * k))          # [n, half] = D^H
    A = Dh / n
    return ((A[:half], A[:half].conj()), (A[half:], A[half:].conj()))


@lru_cache(maxsize=None)
def _s2c_matrices(n: int):
    """D1, D2: coefficients-in-slots -> slots of the packed polynomial."""
    half = n // 2
    j = np.arange(half)[:, None]
    k = np.arange(n)[None, :]
    zeta = np.exp(1j * np.pi / n)
    D = zeta ** ((2 * j + 1) * k)              # [half, n]
    return D[:, :half], D[:, half:]


def coeff_to_slot(param, rk: RotKeys, ct):
    """-> (ct1, ct2, param'): slots(ct1) = coefficients p[0:n/2], slots(ct2)
    = p[n/2:n] (both real; one level consumed).  BSGS with the hoisted
    babies shared across the two matrix halves."""
    (A1, B1), (A2, B2) = _c2s_matrices(param.n)
    (c1, c2), p1 = rmap_bsgs_multi(param, rk, ct, [(A1, B1), (A2, B2)])
    return c1, c2, p1


def slot_to_coeff(param, rk: RotKeys, ct1, ct2):
    """Inverse of coeff_to_slot: packs slots(ct1)|slots(ct2) back into the
    coefficient positions.  -> (ct, param')."""
    D1, D2 = _s2c_matrices(param.n)
    c1, p1 = rmap_bsgs(param, rk, ct1, D1)
    c2, _ = rmap_bsgs(param, rk, ct2, D2)
    return ckks_rns.add(p1, c1, c2), p1
