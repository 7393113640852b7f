"""The rings the GLWE layer runs over — the counterpart of
fhe_study_tpu/arith/ring.py:

  * RqRing(q, n)  — Z_q[X]/(X^n+1), int64 [..., n] in [0, q);
  * TorusRing(n)  — T_{n,2^64}[X], int64 [..., n] holding the u64 bits
    (n = 1 recovers the scalar torus T64).

Elements are stacked along axis -2 for GLWE masks: a mask is [..., k, n].
``contract(x, y)`` — sum_k x_k * y_k — is the hot op: one transform of each
operand, pointwise products reduced in the eval domain, one inverse
transform (four, over two CRT primes, on the torus).
"""

from dataclasses import dataclass

import torch

from ..ops import modops, ntt
from ..utils import prng
from . import rq, tn
from .params import RingParam, TORUS_Q


@dataclass(frozen=True)
class RqRing:
    q: int
    n: int

    @property
    def param(self):
        return RingParam(self.q, self.n)

    # construction ---------------------------------------------------------
    def zeros(self, shape, device):
        return rq.zeros(shape, self.n, device)

    def from_u64(self, coeffs, device):
        return rq.from_u64(coeffs, self.q, self.n, device)

    # sampling -------------------------------------------------------------
    def rand_uniform(self, gen, shape, device):
        return prng.uniform_mod(gen, tuple(shape) + (self.n,), self.q, device)

    def rand_bin(self, gen, shape, device):
        return prng.binary(gen, tuple(shape) + (self.n,), device)

    def rand_err(self, gen, shape, sigma, device):
        return prng.gaussian_mod(gen, tuple(shape) + (self.n,), sigma,
                                 self.q, device)

    # arithmetic -----------------------------------------------------------
    def add(self, a, b):
        return modops.addmod(a, b, self.q)

    def sub(self, a, b):
        return modops.submod(a, b, self.q)

    def neg(self, a):
        return modops.negmod(a, self.q)

    def mul(self, a, b):
        if self.n == 1:
            return modops.mulmod(a, b, self.q)
        return ntt.negacyclic_mul(a, b, self.q)

    def scalar_mul_u64(self, a, s: int):
        return rq.scalar_mul_u64(a, s, self.q)

    def contract(self, x, y):
        """sum over axis -2 of ring products:
        [..., M, n] x [..., M, n] -> [..., n].  The sum of M products each
        below q wraps as the reference's u64 sum does."""
        if self.n == 1:
            return modops.coerce_u64(modops.mulmod(x, y, self.q).sum(-2),
                                     self.q)
        prod = modops.mulmod(ntt.ntt(x, self.q), ntt.ntt(y, self.q), self.q)
        return ntt.intt(modops.coerce_u64(prod.sum(-2), self.q), self.q)

    # gadget / switching ---------------------------------------------------
    def decompose(self, a, beta: int, l: int):
        return modops.decompose(a, self.q, beta, l)

    def mod_switch(self, a, p: int):
        return modops.mod_switch(a, self.q, p)

    def mul_div_round(self, a, num: int, den: int):
        return modops.mul_div_round(a, num, den, self.q)

    def decode_scale(self, a, t: int):
        """round(t * v / q) mod t."""
        return modops.coerce_u64(modops.mul_div_round(a, t, self.q, self.q),
                                 t)


@dataclass(frozen=True)
class TorusRing:
    n: int
    q: int = TORUS_Q  # tag, matching the reference's RingParam convention

    @property
    def param(self):
        return RingParam(TORUS_Q, self.n)

    # construction ---------------------------------------------------------
    def zeros(self, shape, device):
        return torch.zeros(tuple(shape) + (self.n,), dtype=torch.int64,
                           device=device)

    def from_u64(self, coeffs, device):
        return tn.from_u64(coeffs, self.n, device)

    # sampling -------------------------------------------------------------
    def rand_uniform(self, gen, shape, device):
        return prng.uniform_u64(gen, tuple(shape) + (self.n,), device)

    def rand_bin(self, gen, shape, device):
        return prng.binary(gen, tuple(shape) + (self.n,), device)

    def rand_err(self, gen, shape, sigma, device):
        return prng.gaussian_torus(gen, tuple(shape) + (self.n,), sigma,
                                   device)

    # arithmetic (wrapping) -------------------------------------------------
    def add(self, a, b):
        return a + b

    def sub(self, a, b):
        return a - b

    def neg(self, a):
        return -a

    def mul(self, a, b):
        if self.n == 1:
            return a * b
        return tn.mul(a, b)

    def scalar_mul_u64(self, a, s: int):
        return a * tn.i64(s)

    def contract(self, x, y):
        """sum over axis -2 of torus ring products:
        [..., M, n] x [..., M, n] -> [..., n]."""
        if self.n == 1:
            return (x * y).sum(-2)          # wrapping: exact mod 2^64
        if self.n < 64:
            return tn.naive_mul(x, y).sum(-2)
        return self._contract_crt(x, y)

    def _contract_crt(self, x, y):
        """Fused CRT-NTT contraction: transform once, multiply pointwise,
        reduce over M in the eval domain, inverse-transform 4 limb sums."""
        p1, p2 = ntt.CRT_PRIMES[:2]
        xl = tn._split_limbs(x)   # [..., M, 4, n]
        yl = tn._split_limbs(y)
        return tn.limb_products_crt(
            ntt.ntt(xl, p1), ntt.ntt(yl, p1), ntt.ntt(xl, p2),
            ntt.ntt(yl, p2), reduce=lambda t: t.sum(-2))

    # gadget / switching ---------------------------------------------------
    def decompose(self, a, beta: int, l: int):
        return tn.decompose(a, beta, l)

    def mod_switch(self, a, p: int):
        return tn.mod_switch(a, p)

    def mul_div_round(self, a, num: int, den: int):
        return tn.mul_div_round(a, num, den)

    def decode_scale(self, a, t: int):
        return modops.coerce_u64(tn.mul_div_round(a, t, TORUS_Q), t)


def ring_for(param: RingParam):
    """RingParam -> ring object (q == u64::MAX tags the torus)."""
    if param.q == TORUS_Q:
        return TorusRing(param.n)
    return RqRing(param.q, param.n)
