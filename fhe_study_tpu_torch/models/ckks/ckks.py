"""Single-modulus CKKS (eprint 2016/421) over R_q — the counterpart of
fhe_study_tpu/models/ckks/ckks.py: keys, encrypt, decrypt, add and sub on
int64 [..., n] tensors.

Keys and encryption masks are ternary (U[-1, 1) rounded), the reference's
distributions.  ``sub`` is the correct subtraction; the reference adds the
second components (c0.1 + c1.1), a sign slip masked only by its ternary
public keys, and ``sub_reference_quirk`` reproduces it for parity.
"""

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ...arith import rq
from ...arith.params import RingParam
from ...ops import modops, ntt
from ...utils import prng

ERR_SIGMA = 3.2


@dataclass(frozen=True)
class Param:
    ring: RingParam
    t: int


class SecretKey(NamedTuple):
    s: torch.Tensor
    s_evals: torch.Tensor


class PublicKey(NamedTuple):
    b: torch.Tensor  # -a·s + e
    a: torch.Tensor


class CT(NamedTuple):
    c0: torch.Tensor
    c1: torch.Tensor


def _times(q: int, x, e_evals):
    """x * e in R_q from e's evaluations."""
    return ntt.intt(modops.mulmod(ntt.ntt(x, q), e_evals, q), q)


def new_key_with(param: Param, s, a, e):
    """(sk, pk) from the draws: s and a ternary (signed), e the noise mod q;
    pk = (-a·s + e, a)."""
    q = param.ring.q
    s, a = modops.coerce_i64(s, q), modops.coerce_i64(a, q)
    sk = SecretKey(s, ntt.ntt(s, q))
    neg_as = rq.neg(_times(q, a, sk.s_evals), q)
    return sk, PublicKey(b=rq.add(neg_as, e, q), a=a)


def new_key(gen: prng.Gen, param: Param, device, batch=()):
    q, shape = param.ring.q, tuple(batch) + (param.ring.n,)
    k_s, k_a, k_e = prng.split(gen, 3)
    return new_key_with(param, prng.ternary(k_s, shape, device),
                        prng.ternary(k_a, shape, device),
                        prng.gaussian_mod(k_e, shape, ERR_SIGMA, q, device))


def encrypt_with(param: Param, pk: PublicKey, m, v, e0, e1) -> CT:
    """c = (m + e0 + v·pk0, v·pk1 + e1) from the draws: v ternary (signed),
    e0 and e1 the noise mod q; m int64 coefficients of R."""
    q = param.ring.q
    ev = ntt.ntt(modops.coerce_i64(v, q), q)
    m_q = modops.coerce_i64(m, q)
    c0 = rq.add(rq.add(m_q, e0, q), _times(q, pk.b, ev), q)
    return CT(c0, rq.add(_times(q, pk.a, ev), e1, q))


def encrypt(gen: prng.Gen, param: Param, pk: PublicKey, m, batch=()) -> CT:
    q, shape = param.ring.q, tuple(batch) + (param.ring.n,)
    k_v, k_e0, k_e1 = prng.split(gen, 3)
    dev = pk.b.device
    return encrypt_with(param, pk, torch.as_tensor(m, device=dev),
                        prng.ternary(k_v, shape, dev),
                        prng.gaussian_mod(k_e0, shape, ERR_SIGMA, q, dev),
                        prng.gaussian_mod(k_e1, shape, ERR_SIGMA, q, dev))


def decrypt(param: Param, sk: SecretKey, c: CT):
    """The centered lift of c0 + c1·s: int64 coefficients of R."""
    q = param.ring.q
    return rq.to_centered_i64(rq.add(c.c0, _times(q, c.c1, sk.s_evals), q), q)


def add(param: Param, a: CT, b: CT) -> CT:
    q = param.ring.q
    return CT(rq.add(a.c0, b.c0, q), rq.add(a.c1, b.c1, q))


def sub(param: Param, a: CT, b: CT) -> CT:
    """The correct homomorphic subtraction."""
    q = param.ring.q
    return CT(rq.sub(a.c0, b.c0, q), rq.sub(a.c1, b.c1, q))


def sub_reference_quirk(param: Param, a: CT, b: CT) -> CT:
    """The reference's (c0.0 - c1.0, c0.1 + c1.1)."""
    q = param.ring.q
    return CT(rq.sub(a.c0, b.c0, q), rq.add(a.c1, b.c1, q))
