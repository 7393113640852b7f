"""Generalized LWE over a ring — the counterpart of
fhe_study_tpu/models/gfhe/glwe.py, over the torus and over Z_q.

    GLWE(a=[..., k, n], b=[..., n])    int64 (torus words, or residues mod q)
    GLev(a=[..., l, k, n], b=[..., l, n])
    KSK(a=[..., k_src, l, k, n], b=[..., k_src, l, n])

Any leading batch dims are supported.  Randomness comes from an explicit
``prng.Gen``; tensors are made on an explicit ``device`` or on the device of
the key they are made from.  The ``*_with`` forms take the draws, so a test
can replay another sampler's.

As in the reference, ``encrypt_s`` samples its mask from the KEY
distribution (binary) — the reference quirk that its TFHE bootstrapping
behaviour rests on; ``encrypt`` (public key) gives uniformly masked
ciphertexts.  Secret keys are true uniform bits.  ``encode`` / ``decode``
(Delta = floor(q / t)) and ``mod_switch`` are the Z_q world's.
"""

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ...arith.params import RingParam
from ...arith.ring import ring_for
from ...ops import modops
from ...utils import prng

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


class GLev(NamedTuple):
    """l GLWEs stacked on a level axis: a [..., l, k, n], b [..., l, n]."""
    a: torch.Tensor
    b: torch.Tensor


class KSK(NamedTuple):
    """k_src GLevs: a [..., k_src, l, k, n], b [..., k_src, l, n]."""
    a: torch.Tensor
    b: torch.Tensor


def zero(param: Param, device, batch=()):
    ring = ring_for(param.ring)
    return GLWE(a=ring.zeros(tuple(batch) + (param.k,), device),
                b=ring.zeros(batch, device))


def from_plaintext(param: Param, p):
    ring = ring_for(param.ring)
    return GLWE(a=ring.zeros(tuple(p.shape[:-1]) + (param.k,), p.device), b=p)


# -- keys -------------------------------------------------------------------

def new_key(gen: prng.Gen, param: Param, device, batch=()):
    """(sk, pk): s <- bits, a <- uniform, pk = (a·s + e, a)."""
    ring = ring_for(param.ring)
    s = ring.rand_bin(gen, tuple(batch) + (param.k,), device)
    return s, pk_from_sk(gen, param, s)


def pk_from_sk(gen: prng.Gen, param: Param, s):
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


def encrypt_s(gen: prng.Gen, param: Param, sk, m, batch=()) -> GLWE:
    """Secret-key encryption; mask from the KEY distribution (binary), as
    the reference."""
    ring = ring_for(param.ring)
    a = ring.rand_bin(gen, tuple(batch) + (param.k,), sk.device)
    e = ring.rand_err(gen, batch, param.err_sigma, sk.device)
    return encrypt_s_with(param, sk, m, a, e)


def encrypt(gen: prng.Gen, param: Param, pk: PublicKey, m,
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


def mod_switch(param: Param, c: GLWE, p: int) -> GLWE:
    ring = ring_for(param.ring)
    return GLWE(a=ring.mod_switch(c.a, p), b=ring.mod_switch(c.b, p))


# -- encode / decode (the Z_q world: Delta = floor(q / t)) --------------------

def encode(param: Param, m):
    """m mod t -> Delta * m mod q."""
    ring = ring_for(param.ring)
    m_q = modops.coerce_u64(m, param.ring.q)
    return ring.scalar_mul_u64(m_q, param.ring.q // param.t)


def decode(param: Param, p):
    return ring_for(param.ring).decode_scale(p, param.t)


# -- key switching ------------------------------------------------------------

def new_ksk_with(param: Param, beta: int, l: int, sk, new_sk, a, e) -> KSK:
    """KSK from given draws: GLev_i = Enc_new_sk(sk_i) at levels 1..l
    (glev.encrypt_s_with), a [k_src, l, ..., k, n], e [k_src, l, ..., n]."""
    from . import glev
    levs = [glev.encrypt_s_with(param, beta, l, new_sk, sk[..., i, :], a[i],
                                e[i]) for i in range(param.k)]
    return KSK(a=torch.stack([g.a for g in levs], dim=-4),
               b=torch.stack([g.b for g in levs], dim=-3))


def new_ksk(gen: prng.Gen, param: Param, beta: int, l: int, sk,
            new_sk) -> KSK:
    """KSK = k GLevs, GLev_i = Enc_new_sk(sk_i) at levels i = 1..l."""
    from . import glev
    levs = [glev.encrypt_s(g, param, beta, l, new_sk, sk[..., i, :])
            for i, g in enumerate(prng.split(gen, param.k))]
    return KSK(a=torch.stack([g.a for g in levs], dim=-4),
               b=torch.stack([g.b for g in levs], dim=-3))


def key_switch(param: Param, beta: int, l: int, ksk: KSK, ct: GLWE) -> GLWE:
    """(0, b) - sum_i GLev_i * decompose(a_i), as one contraction over the
    (k_src * l) axis per output component.  The KSK keeps its own leading
    dims (it may be unbatched while the ciphertext is batched)."""
    ring = ring_for(param.ring)
    k, n = param.k, param.ring.n
    d = ring.decompose(ct.a, beta, l).movedim(0, -2)   # [..., k_src, l, n]
    batch = tuple(ct.b.shape[:-1])
    M = k * l
    d_flat = d.reshape(batch + (M, n))
    rhs_b = ring.contract(ksk.b.reshape(ksk.b.shape[:-3] + (M, n)), d_flat)
    # the a components: each of the k output columns contracted, the column
    # axis moved in front so it broadcasts against the digits
    ka = ksk.a.reshape(ksk.a.shape[:-4] + (M, k, n)).movedim(-2, 0)
    extra = d_flat.ndim - (ka.ndim - 1)               # ct dims not in ksk
    if extra > 0:
        ka = ka.reshape(ka.shape[:1] + (1,) * extra + ka.shape[1:])
    rhs_a = ring.contract(ka, d_flat).movedim(0, -2)   # [..., k, n]
    return GLWE(a=ring.sub(ring.zeros(batch + (k,), ct.b.device), rhs_a),
                b=ring.sub(ct.b, rhs_b))
