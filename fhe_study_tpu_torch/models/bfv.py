"""Single-modulus BFV (eprint 2012/144; tensor and relinearization per eprint
2021/204 p.9) — the counterpart of fhe_study_tpu/models/bfv.py, over
arith/rq and arith/rn with int64 tensors.

Two execution paths share one API, as in the reference:

  * parity path (``fast=False``): the reference pipeline — lift to Z[X]
    uncentered, dense exact int64 convolution, scale t/q in float64, THEN
    fold negacyclically;
  * device path (``fast=True``): centered lift, CRT-NTT convolutions
    (``ntt.polymul_i64_crt``: K9 on the card at the reference's shapes),
    fold first.  It differs from the parity path by at most 1 a
    coefficient.

Relinearization splits the key's coefficients into two limbs (rlk = hi 2^w
+ lo), so every convolution stays exact, and rounds the /p in float64.
``relinearize_f64`` is the reference's other variant: it folds before it
rounds, and computes the exact product where the reference's i128 -> i64
cast would wrap (a documented divergence).

Keys, plaintexts and ciphertexts are int64 [..., n]; the relinearization
key lives mod p*q.  Each function that draws has a ``*_with`` core fed with
its draws and a sampling wrapper on an explicit ``prng.Gen``.
"""

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..arith import rn, rq
from ..arith.params import RingParam
from ..ops import modops, ntt
from ..utils import prng
from ..utils.rounding import round_half_away

ERR_SIGMA = 3.2


@dataclass(frozen=True)
class Param:
    ring: RingParam
    t: int
    p: int  # relinearization extension factor (modulus p*q)

    def pt(self) -> RingParam:
        return RingParam(self.t, self.ring.n)

    @property
    def pq(self) -> int:
        return self.p * self.ring.q

    @property
    def delta(self) -> int:
        return self.ring.q // self.t


class SecretKey(NamedTuple):
    s: torch.Tensor        # [..., n] binary in [0, q)
    s_evals: torch.Tensor  # NTT(s), the reference's cached evaluations


class PublicKey(NamedTuple):
    b: torch.Tensor  # -a·s + e
    a: torch.Tensor


class RLK(NamedTuple):
    r0: torch.Tensor  # mod p*q
    r1: torch.Tensor


class RLWE(NamedTuple):
    c0: torch.Tensor
    c1: torch.Tensor


def _times_s(param: Param, x, s_evals):
    """x * s in R_q from s's evaluations."""
    q = param.ring.q
    return ntt.intt(modops.mulmod(ntt.ntt(x, q), s_evals, q), q)


# -- keys ---------------------------------------------------------------------

def new_key_with(param: Param, s, a, e):
    """(sk, pk) from the draws: s binary, a uniform mod q, e the noise mod q;
    pk = (-a·s + e, a)."""
    q = param.ring.q
    sk = SecretKey(s, ntt.ntt(s, q))
    neg_as = rq.neg(_times_s(param, a, sk.s_evals), q)
    return sk, PublicKey(b=rq.add(neg_as, e, q), a=a)


def new_key(gen: prng.Gen, param: Param, device, batch=()):
    q, shape = param.ring.q, tuple(batch) + (param.ring.n,)
    k_s, k_a, k_e = prng.split(gen, 3)
    return new_key_with(param, prng.binary(k_s, shape, device),
                        prng.uniform_mod(k_a, shape, q, device),
                        prng.gaussian_mod(k_e, shape, ERR_SIGMA, q, device))


def rlk_key_with(param: Param, sk: SecretKey, a, e) -> RLK:
    """rlk = (-(a·s + e) + p·s^2 mod p·q, a) from a uniform mod p·q and the
    noise e mod p·q.  a·s and s^2 are exact integer convolutions (s is
    binary, so they fit int64 while n·p·q < 2^63)."""
    pq, n = param.pq, param.ring.n
    if pq >= 1 << 62:
        raise ValueError(f"p*q = {pq}: the relinearization key needs "
                         "p*q < 2^62")
    s = sk.s.long()
    a_s = rn.naive_poly_mul(a, s)
    s2 = rn.naive_poly_mul(s, s)
    r0 = modops.submod(
        modops.mulmod(rq.from_i64(s2, pq, n, s.device), param.p % pq, pq),
        rq.from_i64(a_s, pq, n, s.device), pq)
    return RLK(r0=modops.submod(r0, e, pq), r1=a)


def rlk_key(gen: prng.Gen, param: Param, sk: SecretKey, batch=()) -> RLK:
    pq, shape = param.pq, tuple(batch) + (param.ring.n,)
    k_a, k_e = prng.split(gen, 2)
    dev = sk.s.device
    return rlk_key_with(param, sk, prng.uniform_mod(k_a, shape, pq, dev),
                        prng.gaussian_mod(k_e, shape, ERR_SIGMA, pq, dev))


# -- encrypt / decrypt --------------------------------------------------------

def encrypt_with(param: Param, pk: PublicKey, m, u, e1, e2) -> RLWE:
    """c = (pk0·u + e1 + Delta·m, pk1·u + e2) from the draws: u ternary
    (signed), e1 and e2 the noise mod q."""
    q = param.ring.q
    eu = ntt.ntt(modops.coerce_i64(u, q), q)
    m_q = modops.coerce_u64(m, q)
    c0 = rq.add(rq.add(ntt.intt(modops.mulmod(ntt.ntt(pk.b, q), eu, q), q),
                       e1, q), rq.scalar_mul_u64(m_q, param.delta, q), q)
    c1 = rq.add(ntt.intt(modops.mulmod(ntt.ntt(pk.a, q), eu, q), q), e2, q)
    return RLWE(c0, c1)


def encrypt(gen: prng.Gen, param: Param, pk: PublicKey, m, batch=()) -> RLWE:
    q, shape = param.ring.q, tuple(batch) + (param.ring.n,)
    k_u, k_e1, k_e2 = prng.split(gen, 3)
    dev = pk.b.device
    return encrypt_with(param, pk, m, prng.ternary(k_u, shape, dev),
                        prng.gaussian_mod(k_e1, shape, ERR_SIGMA, q, dev),
                        prng.gaussian_mod(k_e2, shape, ERR_SIGMA, q, dev))


def decrypt(param: Param, sk: SecretKey, c: RLWE):
    """m = round(t/q · (c0 + c1·s)) mod t."""
    q = param.ring.q
    cs = rq.add(c.c0, _times_s(param, c.c1, sk.s_evals), q)
    return modops.coerce_u64(rq.mul_div_round(cs, param.t, q, q), param.t)


# -- linear homomorphic ops ---------------------------------------------------

def add(c0: RLWE, c1: RLWE, param: Param) -> RLWE:
    q = param.ring.q
    return RLWE(rq.add(c0.c0, c1.c0, q), rq.add(c0.c1, c1.c1, q))


def add_const(param: Param, c: RLWE, m) -> RLWE:
    """c0 + Delta·m."""
    q = param.ring.q
    m_q = modops.coerce_u64(m, q)
    return RLWE(rq.add(c.c0, rq.scalar_mul_u64(m_q, param.delta, q), q), c.c1)


# -- multiplication -----------------------------------------------------------

def tensor(param: Param, a: RLWE, b: RLWE, fast: bool = False):
    """The degree-2 product scaled by t/q.

    parity path: uncentered [0, q) lift -> exact int64 dense convolution
    (unreduced, 2n - 1 coefficients) -> round(t·v/q) in float64 -> mod q ->
    negacyclic fold; its noise grows as n^2·q·t, so it stops decrypting
    beyond n of about 32 (the reference's own tests run n = 16).
    fast path: centered lift to (-q/2, q/2], CRT-NTT convolution (folded),
    then the same scaling."""
    q, n, t = param.ring.q, param.ring.n, param.t
    a0, a1, b0, b1 = (x.long() for x in (a.c0, a.c1, b.c0, b.c1))
    if fast:
        a0, a1, b0, b1 = (rq.to_centered_i64(x, q) for x in (a0, a1, b0, b1))
        mul = ntt.polymul_i64_crt

        def post(v):
            r = round_half_away(float(t) * v.double() / float(q))
            return rq.from_i64(r.long(), q, n, v.device)
    else:
        if n * q * q >= 1 << 62:
            raise ValueError("the parity tensor needs n*q^2 < 2^62")
        mul = rn.naive_mul

        def post(v):
            return rn.mul_div_round_to_rq(v, t, q, q, n)
    return (post(mul(a0, b0)), post(mul(a0, b1) + mul(a1, b0)),
            post(mul(a1, b1)))


def _limbs(r, w: int):
    """(hi, lo) of non-negative r below 2^(2w): r = hi 2^w + lo."""
    return r >> w, r & ((1 << w) - 1)


def _div_p_round(param: Param, hi_prod, lo_prod, w: int):
    """round((hi_prod 2^w + lo_prod) / p) in float64, into R_q."""
    p = param.p
    v = (hi_prod.double() * (float(1 << w) / float(p))
         + lo_prod.double() / float(p))
    return rq.from_i64(round_half_away(v).long(), param.ring.q,
                       param.ring.n, v.device)


def relinearize(param: Param, rlk: RLK, c0, c1, c2,
                fast: bool = False) -> RLWE:
    """(c0, c1) + round(c2·rlk / p), the two limbs of each key component
    convolved apart (unreduced on the parity path, CRT-NTT on the fast one,
    where c2 is centered)."""
    q, w = param.ring.q, 28 if fast else 32
    if param.pq >= 1 << (2 * w):
        raise ValueError(f"p*q = {param.pq} does not split into two "
                         f"{w}-bit limbs")
    c2i = rq.to_centered_i64(c2, q) if fast else c2.long()
    mul = ntt.polymul_i64_crt if fast else rn.naive_mul

    def scaled(r):
        hi, lo = _limbs(r, w)
        return _div_p_round(param, mul(c2i, hi), mul(c2i, lo), w)

    return RLWE(rq.add(c0, scaled(rlk.r0), q), rq.add(c1, scaled(rlk.r1), q))


def relinearize_f64(param: Param, rlk: RLK, c0, c1, c2) -> RLWE:
    """The reference's float64 relinearization variant (dead code there):
    fold c2·rlk_i negacyclically over Z FIRST, THEN round each folded
    coefficient / p — the opposite order of ``relinearize``.  The reference
    computes the product in i128 and casts it to i64, so its coefficients
    beyond 2^63 would wrap; this computes the intended exact value through
    the same two-limb split (a documented divergence)."""
    q, w = param.ring.q, 32
    if param.pq >= 1 << (2 * w):
        raise ValueError(f"p*q = {param.pq} does not split into two "
                         f"{w}-bit limbs")
    c2i = c2.long()

    def scaled(r):
        hi, lo = _limbs(r, w)
        return _div_p_round(param, rn.naive_poly_mul(c2i, hi),
                            rn.naive_poly_mul(c2i, lo), w)

    return RLWE(rq.add(c0, scaled(rlk.r0), q), rq.add(c1, scaled(rlk.r1), q))


def mul(param: Param, rlk: RLK, a: RLWE, b: RLWE, fast: bool = False) -> RLWE:
    return relinearize(param, rlk, *tensor(param, a, b, fast=fast), fast=fast)


def mul_const(param: Param, rlk: RLK, c: RLWE, m, fast: bool = False) -> RLWE:
    """A noiseless encryption of Delta·m, then the full ct x ct multiply."""
    q = param.ring.q
    m_q = modops.coerce_u64(m, q)
    md = RLWE(rq.scalar_mul_u64(m_q, param.delta, q), torch.zeros_like(c.c0))
    return mul(param, rlk, c, md, fast=fast)
