"""TLev: gadget vector of l TLWEs — the counterpart of
fhe_study_tpu/models/tfhe/tlev.py.

    TLev(a=[..., l, kn], b=[..., l])

Scales are u64::MAX // beta^i for i=1..l; decrypt reads level [0] and
rescales by beta / u64::MAX.
"""

from typing import NamedTuple

import torch

from ...arith import tn
from ...ops import modops
from ...utils import prng
from ..gfhe.glwe import Param
from . import tlwe as tlwe_mod
from .tlwe import TLWE, TORUS_MAX, _tlev_scales


class TLev(NamedTuple):
    a: torch.Tensor  # [..., l, kn]
    b: torch.Tensor  # [..., l]


def encode(param: Param, m):
    """Unscaled."""
    return tn.as_torus(m)


def decode(param: Param, p):
    return modops.coerce_u64(p, param.t)


def _encrypt_impl(enc, l, beta, m, batch, device):
    scales = _tlev_scales(beta, l, device)
    msgs = tn.as_torus(m, device)[..., None] * scales       # [..., l]
    ct = enc(msgs, tuple(batch) + (l,))
    return TLev(a=ct.a, b=ct.b)


def encrypt(gen: prng.Gen, param: Param, beta: int, l: int, pk, m,
            batch=()) -> TLev:
    return _encrypt_impl(
        lambda p, sh: tlwe_mod.encrypt(gen, param, pk, p, batch=sh),
        l, beta, m, batch, pk.b.device)


def encrypt_s(gen: prng.Gen, param: Param, beta: int, l: int, s, m,
              batch=()) -> TLev:
    return _encrypt_impl(
        lambda p, sh: tlwe_mod.encrypt_s(gen, param, s, p, batch=sh),
        l, beta, m, batch, s.device)


def decrypt(param: Param, s, c: TLev, beta: int):
    pt = tlwe_mod.decrypt(param, s, TLWE(a=c.a[..., 0, :], b=c.b[..., 0]))
    return tn.mul_div_round(pt, beta, TORUS_MAX)


def mul_vec(c: TLev, v) -> TLWE:
    """sum_i TLWE_i · v_i, v: [..., l]."""
    v = tn.as_torus(v, c.b.device)
    return TLWE(a=(c.a * v[..., None]).sum(-2), b=(c.b * v).sum(-1))
