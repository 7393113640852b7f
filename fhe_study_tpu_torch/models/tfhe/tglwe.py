"""TGLWE: RLWE over torus polynomials, GLWE<Tn> — the counterpart of
fhe_study_tpu/models/tfhe/tglwe.py.

    TGLWE(a=[..., K, N], b=[..., N])  — the generic gfhe GLWE tuple.

Key reinterpretation: a TLWE key in B^{KN} and a TGLWE key in B_N[X]^K are
reshapes of each other.
"""

import torch

from ...arith import tn
from ...ops import modops
from ...utils import prng
from ..gfhe import glwe as G
from ..gfhe.glwe import GLWE, Param
from . import tlwe as tlwe_mod
from .tlwe import TLWE, TORUS_MAX

TGLWE = GLWE  # alias: a [..., K, N], b [..., N]


def sk_to_tlwe(s):
    """B_N[X]^K -> B^{KN}: flatten [..., K, N] -> [..., K*N]."""
    return s.reshape(s.shape[:-2] + (s.shape[-2] * s.shape[-1],))


def sk_to_tglwe(s, k: int, n: int):
    """B^{KN} -> B_N[X]^K."""
    return s.reshape(s.shape[:-1] + (k, n))


def new_key(gen: prng.Gen, param: Param, device, batch=()):
    """Sample a TLWE key of length K·N, reinterpret it as K polys, derive
    the public key."""
    s_flat, _ = tlwe_mod.new_key(gen, param.lwe(), device, batch=batch)
    s = sk_to_tglwe(s_flat, param.k, param.ring.n)
    return s, G.pk_from_sk(gen, param, s)


def encode(param: Param, m):
    """m mod t -> coeffs · (u64::MAX // t)."""
    return tn.as_torus(m) * tn.i64(TORUS_MAX // param.t)


def decode(param: Param, p):
    return modops.coerce_u64(tn.mul_div_round(p, param.t, TORUS_MAX), param.t)


def new_const(param: Param, m):
    """Unscaled constant."""
    return tn.as_torus(m)


# encryption / ops delegate to the generic GLWE layer
def from_plaintext(param: Param, p):
    return G.from_plaintext(param, p)


def encrypt_s(gen: prng.Gen, param: Param, s, p, batch=()):
    return G.encrypt_s(gen, param, s, p, batch=batch)


def encrypt(gen: prng.Gen, param: Param, pk, p, batch=()):
    return G.encrypt(gen, param, pk, p, batch=batch)


def decrypt(param: Param, s, ct: TGLWE):
    return G.decrypt(param, s, ct)


def sample_extraction(param: Param, ct: TGLWE, h: int) -> TLWE:
    """Extract coefficient h as a TLWE over the flattened K·N key:
    a'_{ni+j} = a_{i,h-j} if j <= h else -a_{i,n+h-j}."""
    n = param.ring.n
    j = torch.arange(n, device=ct.a.device)
    idx = torch.where(j <= h, h - j, n + h - j)
    vals = ct.a.index_select(-1, idx)                       # [..., K, N]
    vals = torch.where(j > h, -vals, vals)
    new_a = vals.reshape(vals.shape[:-2] + (param.kn,))
    return TLWE(a=new_a, b=ct.b[..., h])


def left_rotate(param: Param, ct: TGLWE, h) -> TGLWE:
    """Multiply every component by X^{-h}, h in [0, 2N).  h broadcasts per
    batch; the mask gets an extra axis to broadcast over K."""
    n = param.ring.n
    h = torch.as_tensor(h, device=ct.b.device)
    h_a = h[..., None] if h.ndim > 0 else h
    return TGLWE(a=tn.left_rotate(ct.a, h_a, n), b=tn.left_rotate(ct.b, h, n))


def add(param: Param, c0, c1):
    return G.add(param, c0, c1)


def sub(param: Param, c0, c1):
    return G.sub(param, c0, c1)


def add_pt(param: Param, c, p):
    return G.add_pt(param, c, p)


def sub_pt(param: Param, c, p):
    return G.sub_pt(param, c, p)


def mul_pt(param: Param, c, p):
    return G.mul_pt(param, c, p)
