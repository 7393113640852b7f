"""Generalized LWE over a ring — the counterpart of
fhe_study_tpu/models/gfhe/glwe.py over the torus ring.

    GLWE(a=[..., k, n], b=[..., n])    int64 torus words

Any leading batch dims are supported.  Randomness comes from an explicit
``torch.Generator``; tensors are made on an explicit ``device`` or on the
device of the key they are made from.  ``encrypt_s_with`` takes the draws,
so a test can replay another sampler's.

As in the reference, ``encrypt_s`` samples its mask from the KEY
distribution (binary) — the reference quirk that its TFHE bootstrapping
behaviour rests on; ``encrypt`` (public key) gives uniformly masked
ciphertexts.  Secret keys are true uniform bits.

The Rq-world ``encode`` / ``decode`` / ``mod_switch``, ``new_ksk`` /
``key_switch`` and the GLev layer come with the slice that ports ``RqRing``.
"""

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ...arith.params import RingParam
from ...arith.ring import ring_for

# sigma = 3.2, eprint 2022/162 p.5
ERR_SIGMA = 3.2


@dataclass(frozen=True)
class Param:
    err_sigma: float
    ring: RingParam
    k: int
    t: int

    def pt(self) -> RingParam:
        return RingParam(self.t, self.ring.n)

    def lwe(self) -> "Param":
        """Flattened LWE view: n=1, k=K*N (the TFHE key-reinterpretation
        trick)."""
        return Param(ERR_SIGMA, RingParam(self.ring.q, 1),
                     self.k * self.ring.n, self.t)

    @property
    def kn(self) -> int:
        return self.k * self.ring.n


class GLWE(NamedTuple):
    a: torch.Tensor  # [..., k, n]
    b: torch.Tensor  # [..., n]


class PublicKey(NamedTuple):
    b: torch.Tensor  # [..., n]      (a·s + e)
    a: torch.Tensor  # [..., k, n]


def zero(param: Param, device, batch=()):
    ring = ring_for(param.ring)
    return GLWE(a=ring.zeros(tuple(batch) + (param.k,), device),
                b=ring.zeros(batch, device))


def from_plaintext(param: Param, p):
    ring = ring_for(param.ring)
    return GLWE(a=ring.zeros(tuple(p.shape[:-1]) + (param.k,), p.device), b=p)


# -- keys -------------------------------------------------------------------

def new_key(gen: torch.Generator, param: Param, device, batch=()):
    """(sk, pk): s <- bits, a <- uniform, pk = (a·s + e, a)."""
    ring = ring_for(param.ring)
    s = ring.rand_bin(gen, tuple(batch) + (param.k,), device)
    return s, pk_from_sk(gen, param, s)


def pk_from_sk(gen: torch.Generator, param: Param, s):
    """pk = (a·s + e, a) for an existing secret key."""
    ring = ring_for(param.ring)
    batch = tuple(s.shape[:-2])
    a = ring.rand_uniform(gen, batch + (param.k,), s.device)
    e = ring.rand_err(gen, batch, param.err_sigma, s.device)
    return PublicKey(b=ring.add(ring.contract(a, s), e), a=a)


# -- encrypt / decrypt ------------------------------------------------------

def encrypt_s_with(param: Param, sk, m, a, e) -> GLWE:
    """Secret-key encryption from given draws: mask a [..., k, n], noise
    e [..., n]; m the already-scaled plaintext [..., n]."""
    ring = ring_for(param.ring)
    return GLWE(a=a, b=ring.add(ring.add(ring.contract(a, sk), m), e))


def encrypt_s(gen: torch.Generator, param: Param, sk, m, batch=()) -> GLWE:
    """Secret-key encryption; mask from the KEY distribution (binary), as
    the reference."""
    ring = ring_for(param.ring)
    a = ring.rand_bin(gen, tuple(batch) + (param.k,), sk.device)
    e = ring.rand_err(gen, batch, param.err_sigma, sk.device)
    return encrypt_s_with(param, sk, m, a, e)


def encrypt(gen: torch.Generator, param: Param, pk: PublicKey, m,
            batch=()) -> GLWE:
    """Public-key encryption."""
    ring = ring_for(param.ring)
    dev = pk.b.device
    u = ring.rand_bin(gen, batch, dev)
    e0 = ring.rand_err(gen, batch, param.err_sigma, dev)
    e1 = ring.rand_err(gen, tuple(batch) + (param.k,), param.err_sigma, dev)
    b = ring.add(ring.add(ring.mul(pk.b, u), m), e0)
    d = ring.add(ring.mul(pk.a, u[..., None, :]), e1)
    return GLWE(a=d, b=b)


def decrypt(param: Param, sk, ct: GLWE):
    """b - a·s; the scaled plaintext plus noise."""
    ring = ring_for(param.ring)
    return ring.sub(ct.b, ring.contract(ct.a, sk))


# -- homomorphic ops --------------------------------------------------------

def add(param: Param, c0: GLWE, c1: GLWE) -> GLWE:
    ring = ring_for(param.ring)
    return GLWE(a=ring.add(c0.a, c1.a), b=ring.add(c0.b, c1.b))


def sub(param: Param, c0: GLWE, c1: GLWE) -> GLWE:
    ring = ring_for(param.ring)
    return GLWE(a=ring.sub(c0.a, c1.a), b=ring.sub(c0.b, c1.b))


def neg(param: Param, c: GLWE) -> GLWE:
    ring = ring_for(param.ring)
    return GLWE(a=ring.neg(c.a), b=ring.neg(c.b))


def add_pt(param: Param, c: GLWE, p) -> GLWE:
    ring = ring_for(param.ring)
    return GLWE(a=c.a, b=ring.add(c.b, p))


def sub_pt(param: Param, c: GLWE, p) -> GLWE:
    ring = ring_for(param.ring)
    return GLWE(a=c.a, b=ring.sub(c.b, p))


def mul_pt(param: Param, c: GLWE, p) -> GLWE:
    """ct · plaintext (ring product on every component)."""
    ring = ring_for(param.ring)
    return GLWE(a=ring.mul(c.a, p[..., None, :]), b=ring.mul(c.b, p))
