"""TGSW over the scalar torus: (kn+1) TLevs — the counterpart of
fhe_study_tpu/models/tfhe/tgsw.py.

    TGSW(a=[..., kn+1, l, kn], b=[..., kn+1, l])

Row j < kn encrypts -s_j·m; row kn encrypts m.  The external product
TGSW × TLWE decomposes every ciphertext component and contracts over the
(kn+1)·l grid.
"""

from typing import NamedTuple

import torch

from ...arith import tn
from ...utils import prng
from ..gfhe.glwe import Param
from . import tlev as tlev_mod
from .tlwe import TLWE, _tlev_scales


class TGSW(NamedTuple):
    a: torch.Tensor  # [..., kn+1, l, kn]
    b: torch.Tensor  # [..., kn+1, l]


def encrypt_s_with(param: Param, beta: int, l: int, s, m, a, e) -> TGSW:
    """encrypt_s from given draws: masks a [..., kn+1, l, kn], noise
    e [..., kn+1, l]."""
    m = tn.as_torus(m, s.device)
    # messages per row: -s_j·m (j < kn), then m
    row_m = torch.cat([(-s) * m[..., None], m[..., None]], dim=-1)
    msgs = row_m[..., :, None] * _tlev_scales(beta, l, s.device)
    b = (a * s[..., None, None, :]).sum(-1) + msgs + e
    return TGSW(a=a, b=b)


def encrypt_s(gen: prng.Gen, param: Param, beta: int, l: int, s, m,
              batch=()) -> TGSW:
    """One batched encryption over the (kn+1, l) grid."""
    shape = tuple(batch) + (param.kn + 1, l)
    a = prng.binary(gen, shape + (param.kn,), s.device)
    e = prng.gaussian_torus(gen, shape, param.err_sigma, s.device)
    return encrypt_s_with(param, beta, l, s, m, a, e)


def decrypt(param: Param, s, c: TGSW, beta: int):
    last = tlev_mod.TLev(a=c.a[..., -1, :, :], b=c.b[..., -1, :])
    return tlev_mod.decrypt(param, s, last, beta)


def external_product(param: Param, beta: int, l: int, g: TGSW,
                     c: TLWE) -> TLWE:
    """TGSW ⊠ TLWE: decompose [a | b] and contract over (kn+1)·l."""
    ab = torch.cat([c.a, c.b[..., None]], dim=-1)         # [..., kn+1]
    d = tn.decompose(ab, beta, l)                         # [l, ..., kn+1]
    d = torch.movedim(d, 0, -1)                           # [..., kn+1, l]
    out_a = (d[..., None] * g.a).sum((-2, -3))            # [..., kn]
    out_b = (d * g.b).sum((-1, -2))
    return TLWE(a=out_a, b=out_b)


def cmux(param: Param, beta: int, l: int, bit: TGSW, c1: TLWE,
         c2: TLWE) -> TLWE:
    """c1 + bit ⊠ (c2 - c1)."""
    diff = TLWE(c2.a - c1.a, c2.b - c1.b)
    prod = external_product(param, beta, l, bit, diff)
    return TLWE(c1.a + prod.a, c1.b + prod.b)
