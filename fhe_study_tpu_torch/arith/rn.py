"""R = Z[X]/(X^N+1): exact integer polynomial arithmetic on int64 [..., n]
— the counterpart of fhe_study_tpu/arith/rn.py, used by BFV's tensor and
relinearization, which must not wrap mod q before the scaling.

Two product paths, exact while the true coefficients fit their range:
``naive_mul`` (the dense outer product, summed on the anti-diagonals; exact
while every unreduced coefficient fits int64, which holds for the
reference's test parameters) and ``ntt.polymul_i64_crt`` (the 2-prime CRT
NTT, exact for |c| < ~2^60.7, the device path).
"""

import torch
import torch.nn.functional as F

from ..utils.rounding import round_half_away
from . import rq


def from_rq(a):
    """Rq -> R: the representatives in [0, q) as int64."""
    return a.long()


def reduce_negacyclic(c, n: int):
    """mod (X^n + 1) over Z: p[i - n] -= p[i], repeatedly."""
    while c.shape[-1] > n:
        m = min(n, c.shape[-1] - n)
        folded = c[..., :n] - F.pad(c[..., n:n + m], (0, n - m))
        rest = c[..., n + m:]
        c = torch.cat([folded, rest], dim=-1) if rest.shape[-1] else folded
    return c


def conv_full(a, b):
    """The full linear convolution, [..., 2n - 1], int64 (no reduction; a
    product or sum past 2^63 wraps as the reference's i64 does).  The
    anti-diagonal sum has repeated indices, so it is an ``index_add_``."""
    n = a.shape[-1]
    prod = a[..., :, None] * b[..., None, :]
    ar = torch.arange(n, device=a.device)
    idx = (ar[:, None] + ar[None, :]).reshape(-1)
    out = torch.zeros(prod.shape[:-2] + (2 * n - 1,), dtype=torch.int64,
                      device=a.device)
    return out.index_add_(-1, idx, prod.reshape(prod.shape[:-2] + (n * n,)))


def naive_mul(a, b):
    """The unreduced 2n - 1 coefficient product."""
    return conv_full(a, b)


def naive_poly_mul(a, b):
    """The product reduced mod (X^n + 1)."""
    return reduce_negacyclic(conv_full(a, b), a.shape[-1])


def mul(a, b):
    return naive_poly_mul(a, b)


def mod_centered_q(a, q: int):
    """coeff mod q with Rust's truncated ``%`` (torch.fmod), then centered:
    res > q/2 -> res - q."""
    r = torch.fmod(a, q)
    return torch.where(r > q // 2, r - q, r)


def mul_div_round_to_rq(v, num: int, den: int, q: int, n: int):
    """round(num * v / den) per coefficient in float64, then into Rq."""
    r = round_half_away(float(num) * v.double() / float(den))
    return rq.from_i64(r.long(), q, n, v.device)


def to_rq(a, q: int, n: int):
    return rq.from_i64(a, q, n, a.device)


def infinity_norm(a):
    return a.abs().amax(-1)
