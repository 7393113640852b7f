"""RNS-BFV — the counterpart of fhe_study_tpu/models/bfv_rns.py: keygen,
encrypt, decrypt, the linear operations, the ciphertext x ciphertext multiply
in the coefficient domain (``mul``) and on the eval-resident representation
``CTE`` (``mul_e``), each with the RNS-gadget relinearization (``RLK``) or
the 1-row hybrid one (``HRLK``), key switching, the noise budget and the
modulus drop.

Residues are int32 tensors [L, ..., N] with the limb axis leading, row i
modulo qs[i] (every prime is below 2^30, so the bits equal the reference's
u32).  Each random function is a deterministic core (``*_with``) fed with its
draws, and a sampling wrapper on an explicit ``prng.Gen``; the cores
reproduce the reference bit for bit on the same draws.

Divergences kept from the reference (the port reproduces them):
  * the t/Q scaling floors instead of rounding half away (<= 1 unit of
    noise);
  * the base extension's alpha is the 2^59 fixed point of the reference, so
    a boundary slip happens exactly where the reference's does.
"""

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..ops import ext_cuda, modops, modops32
from ..ops.ntt import (_addmod_v, _qvec, _submod_v, ext_ntt, intt_multi,
                       ks_contract_multi, ks_fused_eval, ks_fused_multi,
                       mulmod_v, ntt_multi, tensor_eval4, tensor_mul4)
from ..ops.primes import ntt_primes
from ..utils import prng
from ..utils.rounding import round_half_away
from . import hybrid_ks as H

ERR_SIGMA = 3.2


@dataclass(frozen=True)
class RnsParam:
    n: int            # ring degree
    t: int            # plaintext modulus
    L: int            # number of Q-basis primes
    M: int            # number of P-basis (extension) primes
    prime_bits: int = 30

    def __post_init__(self):
        if self.n < 2 or self.n & (self.n - 1):
            raise ValueError(f"ring degree n={self.n} must be a power of two")
        if self.L < 1 or self.M < 1 or self.t < 2:
            raise ValueError(f"need L, M >= 1 and t >= 2 (got L={self.L}, "
                             f"M={self.M}, t={self.t})")

    @property
    def qs(self):
        return ntt_primes(self.L, self.prime_bits, 1 << 16)

    @property
    def ps(self):
        return ntt_primes(self.M, self.prime_bits, 1 << 16, skip=self.L)


class _Basis:
    """Host CRT data of one prime basis."""

    def __init__(self, primes):
        self.primes = tuple(primes)
        self.prod = math.prod(self.primes)
        self.hat = [self.prod // p for p in self.primes]            # Q̂_i
        self.hat_inv = [pow(h, -1, p) for h, p in zip(self.hat, self.primes)]
        self.inv_f = np.array([1.0 / p for p in self.primes])


@lru_cache(maxsize=None)
def _basis(primes: tuple) -> _Basis:
    return _Basis(primes)


def _to_residues(x, primes):
    """Signed integers [..., n] -> int32 residues [L, ..., n]."""
    x = torch.as_tensor(x).long()
    return torch.remainder(x[None], _qvec(primes, x.ndim + 1, x.device)).int()


def fast_base_extend(x, src: tuple, dst: tuple, centered: bool = False):
    """HPS fast base conversion: x [Ls, ..., n] residues -> [Ld, ..., n].

    centered=False reads the value in [0, S), centered=True in (-S/2, S/2);
    fhe_study_tpu.models.bfv_rns.fast_base_extend documents why each caller
    is exact.  One pass of K4 on the card (ops/ext_cuda.py)."""
    return ext_cuda.base_extend_fused(x, src, dst, centered=centered)


def _bcast_mid(x, target_ndim: int):
    """Insert singleton axes after the limb axis so an unbatched key
    [L, n] broadcasts against ciphertexts [L, B..., n]."""
    extra = target_ndim - x.ndim
    if extra <= 0:
        return x
    return x.reshape(x.shape[:1] + (1,) * extra + x.shape[1:])


class SecretKey(NamedTuple):
    s_evals: torch.Tensor   # [L+M, ..., N] NTT(s) per prime (Q then P)


class PublicKey(NamedTuple):
    b: torch.Tensor  # [L, ..., N]  (-a·s + e)
    a: torch.Tensor


class RLK(NamedTuple):
    """RNS-gadget relin (or key-switching) key, NTT domain:
    [L_rows, L_primes, ..., N]."""
    b: torch.Tensor
    a: torch.Tensor


class CT(NamedTuple):
    c0: torch.Tensor  # [L, ..., N]
    c1: torch.Tensor


class CTE(NamedTuple):
    """Eval-domain resident ciphertext: canonical NTT-domain residues over
    the Q basis ([L, ..., N]) and the P basis ([M, ..., N])."""
    e0q: torch.Tensor
    e1q: torch.Tensor
    e0p: torch.Tensor
    e1p: torch.Tensor


class HRLK(NamedTuple):
    """1-row hybrid relin key over basis Q u P_K, NTT domain: [L+K, N]."""
    b: torch.Tensor
    a: torch.Tensor


# -- keys -------------------------------------------------------------------

def new_key_with(param: RnsParam, s, a, e):
    """Key pair from its draws: s [batch.., n] in {0, 1}, a [L, batch.., n]
    uniform residues over Q, e [batch.., n] signed noise."""
    qs, L = param.qs, param.L
    both = qs + param.ps
    s_evals = ntt_multi(_to_residues(s, both), both)
    qv = _qvec(qs, a.ndim, a.device)
    ea = ntt_multi(a, qs)
    a_s = intt_multi(mulmod_v(ea, s_evals[:L], qv), qs)
    b = _submod_v(_to_residues(e, qs), a_s, qv)
    return SecretKey(s_evals), PublicKey(b=b, a=a)


def new_key(gen: prng.Gen, param: RnsParam, device):
    k_s, k_a, k_e = prng.split(gen, 3)
    shp = (param.n,)
    return new_key_with(param, prng.binary(k_s, shp, device),
                        prng.uniform_mod_multi(k_a, shp, param.qs, device),
                        prng.gaussian_int(k_e, shp, ERR_SIGMA, device))


def _gadget_key(param: RnsParam, target, s, a, e) -> RLK:
    """Row i: (target * g_i + e_i - a_i * s, a_i) in the NTT domain over Q,
    g_i = Qhat_i * [Qhat_i^-1]_{q_i} the RNS gadget.  target, s: [L, .., n]
    eval residues; a: [L_rows, L_primes, .., n] uniform residues; e:
    [L_rows, .., n] signed noise."""
    qs, L = param.qs, param.L
    bq = _basis(qs)
    if a.shape[0] != L or a.shape[1] != L or e.shape[0] != L:
        raise ValueError(f"need a [L, L, .., n] and e [L, .., n] with L={L}; "
                         f"got {tuple(a.shape)} and {tuple(e.shape)}")
    qv = _qvec(qs, a.ndim - 1, a.device)[None]
    gv = torch.tensor([[bq.hat[i] * bq.hat_inv[i] % q for q in qs]
                       for i in range(L)], dtype=torch.int64,
                      device=a.device).reshape((L, L) + (1,) * (a.ndim - 2))
    ea = torch.stack([ntt_multi(a[i].contiguous(), qs) for i in range(L)])
    ee = torch.stack([ntt_multi(_to_residues(e[i], qs), qs)
                      for i in range(L)])
    b = _submod_v(_addmod_v(mulmod_v(target[None], gv, qv), ee, qv),
                  mulmod_v(ea, s[None], qv), qv)
    return RLK(b=b, a=ea)


def _gadget_draws(gen: prng.Gen, param: RnsParam, device):
    """(a, e) of a gadget key: the reference draws a as [L_primes, L_rows,
    n] in one sampler call and swaps the two leading axes."""
    k_a, k_e = prng.split(gen, 2)
    shp = (param.L, param.n)
    return (prng.uniform_mod_multi(k_a, shp, param.qs, device).transpose(0, 1),
            prng.gaussian_int(k_e, shp, ERR_SIGMA, device))


def rlk_key_with(param: RnsParam, sk: SecretKey, a, e) -> RLK:
    """Gadget relin key from its draws (shapes as in _gadget_key): row i
    encrypts s^2 * g_i under s."""
    sq = sk.s_evals[:param.L]
    qv = _qvec(param.qs, sq.ndim, sq.device)
    return _gadget_key(param, mulmod_v(sq, sq, qv), sq, a, e)


def rlk_key(gen: prng.Gen, param: RnsParam, sk: SecretKey) -> RLK:
    return rlk_key_with(param, sk,
                        *_gadget_draws(gen, param, sk.s_evals.device))


def ksk_key_with(param: RnsParam, sk_old: SecretKey, sk_new: SecretKey, a,
                 e) -> RLK:
    """Key-switching key from its draws: row i encrypts s_old * g_i under
    s_new (the relin key is the case s_old = s_new^2)."""
    L = param.L
    return _gadget_key(param, sk_old.s_evals[:L], sk_new.s_evals[:L], a, e)


def ksk_key(gen: prng.Gen, param: RnsParam, sk_old: SecretKey,
            sk_new: SecretKey) -> RLK:
    return ksk_key_with(param, sk_old, sk_new,
                        *_gadget_draws(gen, param, sk_new.s_evals.device))


def hybrid_rlk1_with(param: RnsParam, sk: SecretKey, a, e, K: int = 2):
    """Hybrid relin key from its draws: a [L+K, n] uniform residues over
    Q u P_K, e [n] signed noise.  Encrypts P*s^2 under s over Q u P_K."""
    qs = param.qs
    ks = H.ks_ext_primes(param, K)
    both = qs + ks
    P = math.prod(ks)
    s = H._centered_coeffs(param, sk.s_evals)        # small signed coeffs
    se = ntt_multi(_to_residues(s, both), both)      # [L+K, n]
    bv = _qvec(both, se.ndim, se.device)
    s2 = mulmod_v(se, se, bv)
    ea = ntt_multi(a, both)
    ee = ntt_multi(_to_residues(e, both), both)
    pg = _qvec([P % p for p in both], se.ndim, se.device)  # 0 on the K primes
    b = _submod_v(_addmod_v(mulmod_v(s2, pg, bv), ee, bv),
                  mulmod_v(ea, se, bv), bv)
    return HRLK(b=b, a=ea)


def hybrid_rlk1(gen: prng.Gen, param: RnsParam, sk: SecretKey,
                K: int = 2) -> HRLK:
    device = sk.s_evals.device
    both = param.qs + H.ks_ext_primes(param, K)
    k_a, k_e = prng.split(gen, 2)
    return hybrid_rlk1_with(
        param, sk, prng.uniform_mod_multi(k_a, (param.n,), both, device),
        prng.gaussian_int(k_e, (param.n,), ERR_SIGMA, device), K=K)


# -- encrypt / decrypt ------------------------------------------------------

def _delta_m(param: RnsParam, m, device):
    """Δ·m over Q as residues [L, batch.., n], Δ_i = (Q//t) mod q_i."""
    qs = param.qs
    delta = _basis(qs).prod // param.t
    mr = _to_residues(torch.as_tensor(m).to(device), qs)
    return mulmod_v(mr, _qvec([delta % q for q in qs], mr.ndim, device),
                    _qvec(qs, mr.ndim, device))


def encrypt_with(param: RnsParam, pk: PublicKey, m, u, e0, e1) -> CT:
    """c = (Δ·m + pk.b·u + e0, pk.a·u + e1), Δ_i = (Q//t) mod q_i; m, u,
    e0, e1 are [batch.., n] integers (u ternary, e0/e1 signed noise)."""
    qs = param.qs
    u_res = _to_residues(u, qs)
    qv = _qvec(qs, u_res.ndim, u_res.device)
    dm = _delta_m(param, m, u_res.device)
    eu = ntt_multi(u_res, qs)
    epb = _bcast_mid(ntt_multi(pk.b, qs), eu.ndim)
    epa = _bcast_mid(ntt_multi(pk.a, qs), eu.ndim)
    c0 = _addmod_v(_addmod_v(intt_multi(mulmod_v(epb, eu, qv), qs),
                             _to_residues(e0, qs), qv), dm, qv)
    c1 = _addmod_v(intt_multi(mulmod_v(epa, eu, qv), qs),
                   _to_residues(e1, qs), qv)
    return CT(c0, c1)


def encrypt(gen: prng.Gen, param: RnsParam, pk: PublicKey, m,
            batch=()) -> CT:
    device = pk.b.device
    shp = tuple(batch) + (param.n,)
    k_u, k_e0, k_e1 = prng.split(gen, 3)
    return encrypt_with(param, pk, m, prng.ternary(k_u, shp, device),
                        prng.gaussian_int(k_e0, shp, ERR_SIGMA, device),
                        prng.gaussian_int(k_e1, shp, ERR_SIGMA, device))


def _phase(param: RnsParam, sk: SecretKey, c: CT):
    """c0 + c1·s over Q, residues [L, batch.., n]."""
    qs = param.qs
    qv = _qvec(qs, c.c0.ndim, c.c0.device)
    se = _bcast_mid(sk.s_evals[:param.L], c.c1.ndim)
    return _addmod_v(c.c0, intt_multi(mulmod_v(ntt_multi(c.c1, qs), se, qv),
                                      qs), qv)


def decrypt(param: RnsParam, sk: SecretKey, c: CT):
    """m = round(t·x/Q) mod t via per-limb HPS accumulation (int64)."""
    qs = param.qs
    bq = _basis(qs)
    dev, nd = c.c0.device, c.c0.ndim
    qv = _qvec(qs, nd, dev)
    cs = _phase(param, sk, c)
    ys = mulmod_v(cs, _qvec(bq.hat_inv, nd, dev), qv)
    wf = torch.from_numpy(param.t * bq.inv_f).to(dev).reshape(qv.shape)
    v = torch.sum(ys.double() * wf, dim=0)
    return modops.coerce_i64(round_half_away(v), param.t)


# -- linear ops -------------------------------------------------------------

def add(param: RnsParam, x: CT, y: CT) -> CT:
    qv = _qvec(param.qs, x.c0.ndim, x.c0.device)
    return CT(_addmod_v(x.c0, y.c0, qv), _addmod_v(x.c1, y.c1, qv))


def add_pt(param: RnsParam, x: CT, m) -> CT:
    qv = _qvec(param.qs, x.c0.ndim, x.c0.device)
    return CT(_addmod_v(x.c0, _delta_m(param, m, x.c0.device), qv), x.c1)


def mul_pt(param: RnsParam, x: CT, m) -> CT:
    """Ciphertext x plaintext polynomial, coefficient domain (5 transforms)."""
    qs = param.qs
    qv = _qvec(qs, x.c0.ndim, x.c0.device)
    em = ntt_multi(_to_residues(torch.as_tensor(m).to(x.c0.device), qs), qs)
    return CT(*(intt_multi(mulmod_v(ntt_multi(c.contiguous(), qs), em, qv),
                           qs) for c in x))


# -- multiplication ---------------------------------------------------------

def _check_capacity(param: RnsParam) -> None:
    q_bits = sum(math.log2(q) for q in param.qs)
    p_bits = sum(math.log2(p) for p in param.ps)
    need_p = math.log2(param.t) + math.log2(param.n) + q_bits + 2
    if not (p_bits > need_p and param.t <= (1 << 22)):
        raise ValueError(f"P basis too small: {p_bits:.0f} bits, need > "
                         f"{need_p:.0f}")


def _check_rlk(rlk, who: str) -> None:
    if not isinstance(rlk, (RLK, HRLK)):
        raise TypeError(f"{who} takes an RLK (gadget) or an HRLK (hybrid) "
                        f"relin key; got {type(rlk).__name__}")


def _scale_to_q(param: RnsParam, w_q, w_p):
    """r = floor(t·v/Q) from w = t·v over Q and over P: (w_P - ext(w_Q))·Q^-1
    over P (K4's sub_mul epilogue; [w]_Q is the unsigned remainder), then the
    centered extension of the small signed r back to Q.  Returns the three
    [L, .., n] views (c0, c1, c2) of one [L, .., 3, n] tensor."""
    qs, ps = param.qs, param.ps
    Q = _basis(qs).prod
    qinv = tuple(pow(Q, -1, p) for p in ps)
    r_p = ext_cuda.base_extend_fused(w_q, qs, ps, w=w_p, sub_mul=qinv)
    out3 = fast_base_extend(r_p, ps, qs, centered=True)
    return [out3[..., i, :] for i in range(3)]


def _tensor(param: RnsParam, x: CT, y: CT):
    """Degree-2 product over Q and P, then floor(t·v/Q) mapped back to Q.
    One K6 launch per basis (the P one extends Q -> P inside the kernel);
    t is folded into the inverse transforms."""
    _check_capacity(param)
    qs, ps = param.qs, param.ps
    ops4 = (x.c0, x.c1, y.c0, y.c1)
    w_q = tensor_mul4(*ops4, qs, scale=(param.t,) * len(qs))
    w_p = tensor_mul4(*ops4, ps, scale=(param.t,) * len(ps), src=qs)
    return _scale_to_q(param, w_q, w_p)


def relinearize(param: RnsParam, rlk: RLK, c0, c1, c2) -> CT:
    """RNS-gadget relin: the digits are c2's own limb residues (each reduced
    mod every prime), contracted against the key rows in the NTT domain —
    one K7 launch; the adds of (c0, c1) stay outside it, as in the
    reference."""
    qs = param.qs
    if c2.shape[0] != param.L:
        raise ValueError(f"c2 has {c2.shape[0]} limbs for L={param.L}")
    acc0, acc1 = ks_fused_multi(c2, rlk.b, rlk.a, qs, qs)
    qv = _qvec(qs, acc0.ndim, acc0.device)
    return CT(_addmod_v(c0, acc0, qv), _addmod_v(c1, acc1, qv))


def mul(param: RnsParam, rlk, x: CT, y: CT) -> CT:
    """ct x ct multiply; rlk selects the relinearization: RLK = RNS gadget
    (L digit rows), HRLK = 1-row hybrid P-extension."""
    _check_rlk(rlk, "mul")
    c0, c1, c2 = _tensor(param, x, y)
    if isinstance(rlk, HRLK):
        return relinearize_hybrid(param, rlk, c0, c1, c2)
    return relinearize(param, rlk, c0, c1, c2)


# -- eval-resident ciphertexts ----------------------------------------------

def to_evals(param: RnsParam, c: CT) -> CTE:
    """CT (coeff domain over Q) -> CTE: forward NTT over Q, then the
    unsigned HPS extension + forward NTT over P (fused, K5)."""
    x2 = torch.stack([c.c0, c.c1], dim=-2)           # [L, ..., 2, n]
    eq = ntt_multi(x2, param.qs)
    ep = ext_ntt(x2, param.qs, param.ps)
    return CTE(eq[..., 0, :], eq[..., 1, :], ep[..., 0, :], ep[..., 1, :])


def from_evals(param: RnsParam, ce: CTE) -> CT:
    """CTE -> CT: inverse NTT over the Q basis (P evals are redundant)."""
    r = intt_multi(torch.stack([ce.e0q, ce.e1q], dim=-2), param.qs)
    return CT(r[..., 0, :].contiguous(), r[..., 1, :].contiguous())


def add_e(param: RnsParam, x: CTE, y: CTE) -> CTE:
    """Homomorphic add, eval domain (pointwise over both bases)."""
    qv = _qvec(param.qs, x.e0q.ndim, x.e0q.device)
    pv = _qvec(param.ps, x.e0p.ndim, x.e0p.device)
    return CTE(modops32.addmod(x.e0q, y.e0q, qv),
               modops32.addmod(x.e1q, y.e1q, qv),
               modops32.addmod(x.e0p, y.e0p, pv),
               modops32.addmod(x.e1p, y.e1p, pv))


def pt_to_evals(param: RnsParam, m):
    """Plaintext [batch.., n] -> Montgomery-lifted NTT residues (mq, mp) over
    Q and P: computed once per plaintext operand, after which every mul_pt_e
    is one pointwise product per component with no transform."""
    m = torch.as_tensor(m)
    return tuple(ntt_multi(_to_residues(m, primes), primes, mont=True)
                 for primes in (param.qs, param.ps))


def mul_pt_e(param: RnsParam, x: CTE, em) -> CTE:
    """Ciphertext x plaintext, eval domain: pointwise Montgomery products
    against pt_to_evals output on both bases (the products of mul_pt)."""
    mq, mp = em
    qv, nqv, _ = modops32.consts(param.qs, x.e0q.ndim, x.e0q.device)
    pv, npv, _ = modops32.consts(param.ps, x.e0p.ndim, x.e0p.device)
    return CTE(modops32.mont_mul(x.e0q, mq, qv, nqv),
               modops32.mont_mul(x.e1q, mq, qv, nqv),
               modops32.mont_mul(x.e0p, mp, pv, npv),
               modops32.mont_mul(x.e1p, mp, pv, npv))


def mul_e(param: RnsParam, rlk, x: CTE, y: CTE) -> CTE:
    """Eval-resident ct x ct multiply + relinearization (RLK: RNS gadget,
    HRLK: 1-row hybrid).  Bit-identical to
    to_evals(mul(from_evals(x), from_evals(y))) with every transform that the
    eval residency makes redundant removed."""
    _check_rlk(rlk, "mul_e")
    _check_capacity(param)
    qs, ps = param.qs, param.ps
    # 1. degree-2 products in the resident eval domain; the inverses fold t
    w_q = tensor_eval4(x.e0q, x.e1q, y.e0q, y.e1q, qs,
                       scale=(param.t,) * len(qs))
    w_p = tensor_eval4(x.e0p, x.e1p, y.e0p, y.e1p, ps,
                       scale=(param.t,) * len(ps))
    # 2. r = floor(t·v/Q) over P, then the centered extension back to Q
    c0, c1, c2 = _scale_to_q(param, w_q, w_p)
    if isinstance(rlk, HRLK):
        # 3'. 1-row hybrid relin, then re-enter both eval bases
        return to_evals(param, relinearize_hybrid(param, rlk, c0, c1, c2))
    # 3. gadget relin emitting the result in both domains (K8: eval Q and
    # coefficient Q), then 4. re-enter the P basis (K5)
    e0q, e1q, r0, r1 = ks_fused_eval(c2, rlk.b, rlk.a, qs, qs, adds=(c0, c1))
    ep = ext_ntt(torch.stack([r0, r1], dim=-2), qs, ps)
    return CTE(e0q, e1q, ep[..., 0, :], ep[..., 1, :])


def relinearize_hybrid(param: RnsParam, hk: HRLK, c0, c1, c2) -> CT:
    """(c0 + round(P^-1 * c2 * hk.b), c1 + round(P^-1 * c2 * hk.a)).
    c0, c1, c2: [L, ..., n] residues over Q; returns a CT over Q.

    The P-division round(acc/P) = (acc_Q - centered-ext(acc_P)) * P^-1 is
    one K4 pass per output (its centered + sub_mul epilogue)."""
    qs, L = param.qs, param.L
    K = hk.b.shape[0] - L
    ks = H.ks_ext_primes(param, K)
    both = qs + ks
    c2 = c2.contiguous()
    d = torch.cat([c2, fast_base_extend(c2, qs, ks)], dim=0)   # [L+K, ..., n]
    edm = ntt_multi(d, both, mont=True)
    acc0, acc1 = ks_contract_multi(edm[None], hk.b[None], hk.a[None], both)
    pinv = tuple(pow(math.prod(ks), -1, q) for q in qs)
    ks0 = ext_cuda.base_extend_fused(acc0[L:], ks, qs, centered=True,
                                     w=acc0[:L], sub_mul=pinv)
    ks1 = ext_cuda.base_extend_fused(acc1[L:], ks, qs, centered=True,
                                     w=acc1[:L], sub_mul=pinv)
    qv = _qvec(qs, ks0.ndim, ks0.device)
    return CT(modops32.addmod(c0, ks0, qv), modops32.addmod(c1, ks1, qv))


# -- key switching, noise, modulus drop ---------------------------------------

def key_switch(param: RnsParam, ksk: RLK, c: CT) -> CT:
    """(c0, 0) + sum_i [c1]_{q_i} * KSK_i: moves c under the new key."""
    return relinearize(param, ksk, c.c0, torch.zeros_like(c.c1), c.c1)


def noise_budget_bits(param: RnsParam, sk: SecretKey, c: CT, m):
    """log2 of the remaining decryption headroom, per ciphertext:
    log2(Q/2t) - log2 max|e| with e = (c0 + c1·s) - Δ·m measured exactly by
    a centered 2-limb CRT (valid while |e| < q0·q1/2, about 2^59)."""
    qs = param.qs
    if len(qs) < 2:
        raise ValueError("noise_budget_bits needs L >= 2 (2-limb CRT)")
    qv = _qvec(qs, c.c0.ndim, c.c0.device)
    err = _submod_v(_phase(param, sk, c), _delta_m(param, m, c.c0.device), qv)
    q0, q1 = qs[0], qs[1]
    r0, r1 = err[0].long(), err[1].long()
    d = modops.mulmod(modops.submod(r1, r0 % q1, q1), pow(q0, -1, q1), q1)
    v = r0 + q0 * d                      # < q0·q1 < 2^60: exact in int64
    m01 = q0 * q1
    mag = torch.where(v > m01 // 2, m01 - v, v)
    worst = mag.amax(dim=-1).double()
    cap = math.log2(_basis(qs).prod / (2 * param.t))
    return cap - torch.log2(torch.clamp(worst, min=1.0))


def mod_switch_drop(param: RnsParam, c: CT) -> CT:
    """Drop the last Q prime: c' = (c - [c]_{q_last}) * q_last^-1, a
    ciphertext under the first L-1 primes."""
    qs = param.qs
    last, rest = qs[-1], qs[:-1]
    qv = _qvec(rest, c.c0.ndim, c.c0.device)
    inv = _qvec([pow(last, -1, q) for q in rest], c.c0.ndim, c.c0.device)
    return CT(*(mulmod_v(_submod_v(x[:-1], x[-1:] % qv, qv), inv, qv)
                for x in c))
