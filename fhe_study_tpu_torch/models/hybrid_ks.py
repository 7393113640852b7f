"""Hybrid (P-extended / GHS-style) key switching for the RNS schemes — the
counterpart of fhe_study_tpu/models/hybrid_ks.py.

The plain RNS-gadget key switch (bfv_rns.ksk_key/key_switch) has noise
~ sqrt(n L) * 2^30 * sigma: fine for BFV's Q/t headroom, but it dominates
CKKS rotation error.  The hybrid switch encrypts the key material scaled by
an auxiliary modulus P = prod(p_j), contracts the digits over the extended
basis Q u P, and divides the result by P with rounding: the gadget noise
shrinks by a factor P (~2^60 with two extension primes).

Digits of a single-prime residue extend to the other primes by plain
reduction (they are integers below q_i); the contraction is the NTT-domain
gadget product of relinearization (K7 from limb residues, K3 on hoisted
digits); the P-division is one pass of K4 (centered extension P -> Q with its
``(w - ext) * c`` epilogue), the same residues as the reference's
extend-subtract-multiply.

``seed_of`` / ``expand_a`` regenerate a seeded key's mask from its mask
seed (``key_seeds``: the mask and the noise each on a stream of its own,
keyed by a hash of a master seed and the key's labels), on the port's own
streams (the reference's are threefry): a key that the JAX package built
cannot be expanded here, only carried across whole (utils/interop.py).
K is an argument everywhere; there is no environment override.
"""

import math
from typing import NamedTuple

import torch

from ..ops import ext_cuda
from ..ops.ntt import (_addmod_v, _qvec, _submod_v, intt_multi,
                       ks_contract_multi, ks_fused_multi, mulmod_v, ntt_multi)
from ..ops.primes import ntt_primes
from ..utils import prng
from . import bfv_rns, galois


class HybridKSK(NamedTuple):
    """L gadget rows over the EXTENDED basis Q u P, NTT domain:
    b, a: int32 [L_rows, L+K_primes, N]."""
    b: torch.Tensor
    a: torch.Tensor


def ks_ext_primes(param, K: int = 2) -> tuple:
    """K auxiliary primes, disjoint from the scheme's Q (and P, if any)."""
    skip = param.L + getattr(param, "M", 0)
    return ntt_primes(K, param.prime_bits, 1 << 16, skip=skip)


def _centered_coeffs(param, s_evals_q):
    """NTT(s) over Q -> small signed coefficients as int64 (|s| <= q0/4
    assumed — secret keys are binary/ternary)."""
    qs = param.qs
    r0 = intt_multi(s_evals_q[:param.L], qs)[0].long()
    q0 = qs[0]
    return torch.where(r0 > q0 // 2, r0 - q0, r0)


def _evals_over(param, s_coeffs, primes: tuple):
    return ntt_multi(bfv_rns._to_residues(s_coeffs, primes), primes)


def hybrid_ksk_with(param, s_old_evals, s_new_evals, a, e,
                    K: int = 2) -> HybridKSK:
    """Hybrid key-switching key from its draws: row i encrypts
    P * g_i * s_old under s_new over basis Q u P (g_i the RNS gadget of
    bfv_rns.ksk_key; P * g_i == 0 mod every p_j).  a: [L_rows, L+K, n]
    uniform residues over Q u P, e: [L_rows, n] signed noise."""
    qs = param.qs
    ps = ks_ext_primes(param, K)
    both = qs + ps
    L, nb = param.L, len(qs) + len(ps)
    if tuple(a.shape[:2]) != (L, nb) or e.shape[0] != L:
        raise ValueError(f"need a [L, L+K, n] and e [L, n] with L={L}, "
                         f"K={K}; got {tuple(a.shape)} and {tuple(e.shape)}")
    bq = bfv_rns._basis(qs)
    P = math.prod(ps)
    dev = a.device
    se_old = _evals_over(param, _centered_coeffs(param, s_old_evals), both)
    se_new = _evals_over(param, _centered_coeffs(param, s_new_evals), both)
    bv = _qvec(both, a.ndim - 1, dev)[None]
    # msg_i residues: (P * Qhat_i * [Qhat_i^-1]_{q_i}) mod q_j; 0 mod p_j
    gv = torch.tensor([[P * bq.hat[i] * bq.hat_inv[i] % q for q in both]
                       for i in range(L)], dtype=torch.int64,
                      device=dev).reshape((L, nb) + (1,) * (a.ndim - 2))
    # the transform wants the prime axis leading and contiguous: no copy
    # when a is the transposed view of such a draw, as _ksk_draws makes it
    ea = ntt_multi(a.transpose(0, 1).contiguous(), both).transpose(0, 1)
    ee = ntt_multi(bfv_rns._to_residues(e, both), both).transpose(0, 1)
    b = _submod_v(_addmod_v(mulmod_v(se_old[None], gv, bv), ee, bv),
                  mulmod_v(ea, se_new[None], bv), bv)
    return HybridKSK(b=b.contiguous(), a=ea.contiguous())


def _ksk_draws(gen: prng.Gen, param, K: int, device):
    """(a, e) of a hybrid key: as the reference, a is drawn [L+K, L_rows, n]
    in one sampler call and its two leading axes are swapped."""
    both = param.qs + ks_ext_primes(param, K)
    k_a, k_e = prng.split(gen, 2)
    shp = (param.L, param.n)
    return (prng.uniform_mod_multi(k_a, shp, both, device).transpose(0, 1),
            prng.gaussian_int(k_e, shp, bfv_rns.ERR_SIGMA, device))


def hybrid_ksk(gen: prng.Gen, param, s_old_evals, s_new_evals,
               K: int = 2) -> HybridKSK:
    return hybrid_ksk_with(param, s_old_evals, s_new_evals,
                           *_ksk_draws(gen, param, K, s_new_evals.device),
                           K=K)


def key_seeds(master: int, tag: str, *labels: int) -> tuple:
    """(mask seed, noise seed) of the key labelled (tag, *labels) under the
    master seed: two keyed hashes of their own (prng.derive_seed), not two
    draws of one generator, so the mask seed, which a seeded pack ships,
    tells nothing of the noise seed, whose noise would give the secret key
    away."""
    return (prng.derive_seed(master, tag + "/a", *labels),
            prng.derive_seed(master, tag + "/e", *labels))


def seed_of(master: int, tag: str, *labels: int) -> int:
    """The mask seed of the key labelled (tag, *labels): a packer keeps it
    instead of the key's ``a`` plane (seeded-key compression: half the key
    bytes); expand_a redraws the plane from it."""
    return key_seeds(master, tag, *labels)[0]


def _seeded_mask(param, ka_seed: int, K: int, device):
    """The mask draw of a seeded key, [L+K, L_rows, n] (see _ksk_draws)."""
    return prng.uniform_mod_multi(
        prng.Gen(ka_seed), (param.L, param.n),
        param.qs + ks_ext_primes(param, K), device)


def seeded_draws(param, seeds: tuple, K: int, device):
    """(a, e) of a hybrid key from its (mask, noise) seeds (key_seeds), each
    a stream keyed by all of its bits: as _ksk_draws lays them out."""
    ka_seed, ke_seed = seeds
    return (_seeded_mask(param, ka_seed, K, device).transpose(0, 1),
            prng.gaussian_int(prng.Gen(ke_seed), (param.L, param.n),
                              bfv_rns.ERR_SIGMA, device))


def expand_a(param, ka_seed: int, K: int, device):
    """Regenerate a seeded HybridKSK's ``a`` plane (NTT domain, int32
    [L, L+K, n]) bit for bit from its mask seed: the host draw of
    seeded_draws, then K1 over Q u P on ``device``."""
    both = param.qs + ks_ext_primes(param, K)
    a = _seeded_mask(param, ka_seed, K, device)
    return ntt_multi(a, both).transpose(0, 1).contiguous()


def _div_by_P_round(param, acc, ps: tuple):
    """acc: coeff-domain [L+K, ..., n] residues of X over Q u P ->
    round(X / P) over Q: subtract the centered remainder, multiply by
    P^-1 mod Q (exact).  One K4 pass on the card."""
    qs, L = param.qs, param.L
    pinv = tuple(pow(math.prod(ps), -1, q) for q in qs)
    return ext_cuda.base_extend_fused(acc[L:], ps, qs, centered=True,
                                      w=acc[:L], sub_mul=pinv)


def hoist_digits(param, c1, K: int = 2):
    """The rotation-independent half of a hybrid key switch: extended-basis
    NTT-domain Montgomery digits of c1 (int32 [L_rows, L+K, ..., n]).

    phi_g commutes with the digit extraction (a ring automorphism mod every
    basis prime, applied to the SAME small integer digit polynomials) and
    acts on the eval domain as a pure permutation (galois.eval_perm), so ONE
    decomposition + NTT serves every rotation of the same ciphertext
    (hoisting, eprint 2018/244 §5)."""
    both = param.qs + ks_ext_primes(param, K)
    bv = _qvec(both, c1.ndim, c1.device)
    # row i = c1's limb-i residue mod each prime of the extended basis
    # (integers below q_i -> plain reduction); the prime axis leads for the
    # transform, whose epilogue lifts into the Montgomery domain
    d = (c1.long()[None] % bv[:, None]).int()            # [L+K, L_rows, ..]
    # a view: the copy into rows-first order falls to the consumer (the
    # eval-domain gather of rotate_hoisted makes one anyway)
    return ntt_multi(d, both, mont=True).transpose(0, 1)


def ks_hoisted(param, hksk: HybridKSK, edm):
    """Gadget contraction + INTT + P-division on hoisted digits.  Returns
    (r0, r1), coeff-domain over Q: the switched encryption of c1*s_old (add
    r0 to c0 to finish a key switch)."""
    K = hksk.b.shape[1] - param.L
    ps = ks_ext_primes(param, K)
    acc0, acc1 = ks_contract_multi(edm.contiguous(), hksk.b, hksk.a,
                                   param.qs + ps)
    return (_div_by_P_round(param, acc0, ps), _div_by_P_round(param, acc1, ps))


def hybrid_key_switch(param, hksk: HybridKSK, c) -> "bfv_rns.CT":
    """(c0, 0) + round(P^-1 * sum_i [c1]_{q_i} * KSK_i): the low-noise
    switch; c may carry batch axes.  Digit reduction, forward transforms,
    contraction and inverses run as ONE launch (K7), no digit grid in device
    memory.  (Callers with several rotations of one ciphertext hoist
    instead: hoist_digits once, then ks_hoisted per rotation.)"""
    K = hksk.b.shape[1] - param.L
    ps = ks_ext_primes(param, K)
    r0c, r1c = ks_fused_multi(c.c1, hksk.b, hksk.a, param.qs + ps, param.qs)
    r0 = _div_by_P_round(param, r0c, ps)
    r1 = _div_by_P_round(param, r1c, ps)
    qv = _qvec(param.qs, r0.ndim, r0.device)
    return bfv_rns.CT(_addmod_v(c.c0, r0, qv), r1)


# -- Galois integration ------------------------------------------------------

def _rotated_evals(param, sk, g: int):
    qs = param.qs
    s_evals = sk.s_evals[:param.L].contiguous()
    sg = galois.apply_galois(intt_multi(s_evals, qs), g, qs)
    return ntt_multi(sg, qs), s_evals


def galois_key_hybrid_with(param, sk, g: int, a, e, K: int = 2) -> HybridKSK:
    """Hybrid Galois key from its draws (as hybrid_ksk_with takes them)."""
    return hybrid_ksk_with(param, *_rotated_evals(param, sk, g), a, e, K=K)


def galois_key_hybrid(gen: prng.Gen, param, sk, g: int,
                      K: int = 2) -> HybridKSK:
    """Hybrid Galois key: phi_g(s) -> s with P-suppressed noise."""
    return hybrid_ksk(gen, param, *_rotated_evals(param, sk, g), K=K)


def rotate_hybrid(param, hgk: HybridKSK, ct, g: int):
    qs = param.qs
    c0 = galois.apply_galois(ct.c0, g, qs)
    c1 = galois.apply_galois(ct.c1, g, qs)
    out = hybrid_key_switch(param, hgk, bfv_rns.CT(c0, c1))
    return type(ct)(out.c0, out.c1)


def rotate_hoisted(param, hgk: HybridKSK, ct, g: int, edm):
    """rotate_hybrid against precomputed hoisted digits (hoist_digits of
    ct.c1): the per-rotation forward transforms collapse to one eval-domain
    gather.

    The digit representatives differ from rotate_hybrid's (signed-permuted
    against canonical lifts), so ciphertext bits differ; decryptions agree
    with the same noise bound (|digit| < q_i either way)."""
    if g == 1:
        return ct
    perm = galois.eval_perm_on(param.n, g, edm.device)
    r0, r1 = ks_hoisted(param, hgk, edm.index_select(-1, perm))
    c0g = galois.apply_galois(ct.c0, g, param.qs)
    qv = _qvec(param.qs, r0.ndim, r0.device)
    return type(ct)(_addmod_v(c0g, r0, qv), r1)
