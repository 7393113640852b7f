"""TLWE: LWE over the scalar torus T64 — the counterpart of
fhe_study_tpu/models/tfhe/tlwe.py.

Flat representation (no length-1 poly axis), int64 torus words:

    TLWE(a=[..., kn], b=[...])

All torus arithmetic wraps — exact mod 2^64.  The functions that draw
randomness have a ``*_with`` form that takes the draws.
"""

from typing import NamedTuple

import torch

from ...arith import tn
from ...ops import modops
from ...utils import prng
from ..gfhe.glwe import Param

TORUS_MAX = 0xFFFFFFFFFFFFFFFF  # u64::MAX — the reference's Δ denominator

# the key switch sums kn_src * l products per output word; this many int64
# words of them are formed at a time (256 MiB)
_KS_CHUNK_WORDS = 1 << 25


class TLWE(NamedTuple):
    a: torch.Tensor  # [..., kn]
    b: torch.Tensor  # [...]


class PublicKey(NamedTuple):
    b: torch.Tensor  # [...]
    a: torch.Tensor  # [..., kn]


class KSK(NamedTuple):
    """kn_src TLevs: a [kn_src, l, kn_dst], b [kn_src, l]."""
    a: torch.Tensor
    b: torch.Tensor


def zero(param: Param, device, batch=()):
    return TLWE(a=torch.zeros(tuple(batch) + (param.kn,), dtype=torch.int64,
                              device=device),
                b=torch.zeros(tuple(batch), dtype=torch.int64, device=device))


def _torus(p, like):
    return tn.as_torus(p, like.device)


# -- keys -------------------------------------------------------------------

def new_key_with(param: Param, s, a, e):
    """(s, pk) from given draws: s, a [..., kn], e [...]."""
    return s, PublicKey(b=(a * s).sum(-1) + e, a=a)


def new_key(gen: prng.Gen, param: Param, device, batch=()):
    """s <- bits^kn; pk = (a·s + e, a)."""
    shape = tuple(batch) + (param.kn,)
    s = prng.binary(gen, shape, device)
    a = prng.uniform_u64(gen, shape, device)
    e = prng.gaussian_torus(gen, batch, param.err_sigma, device)
    return new_key_with(param, s, a, e)


# -- encode / decode --------------------------------------------------------

def encode(param: Param, m):
    """m mod t -> m * (u64::MAX // t)."""
    return tn.as_torus(m) * tn.i64(TORUS_MAX // param.t)


def decode(param: Param, p):
    """round(t * p / u64::MAX) mod t."""
    return modops.coerce_u64(tn.mul_div_round(p, param.t, TORUS_MAX), param.t)


def new_const(param: Param, m):
    """Unscaled constant for ct-pt multiplication."""
    return tn.as_torus(m)


# -- encrypt / decrypt ------------------------------------------------------

def _encrypt_with(s, p, a, e) -> TLWE:
    return TLWE(a=a, b=(a * s).sum(-1) + _torus(p, s) + e)


def encrypt_s(gen: prng.Gen, param: Param, s, p, batch=()) -> TLWE:
    """Secret-key encrypt with the reference's BINARY mask quirk; see
    encrypt_uniform for the standard LWE encryption."""
    a = prng.binary(gen, tuple(batch) + (param.kn,), s.device)
    e = prng.gaussian_torus(gen, batch, param.err_sigma, s.device)
    return _encrypt_with(s, p, a, e)


def encrypt_uniform_with(param: Param, s, p, a, e) -> TLWE:
    """encrypt_uniform from given draws: mask a [..., kn], noise e [...]."""
    return _encrypt_with(s, p, a, e)


def encrypt_uniform(gen: prng.Gen, param: Param, s, p,
                    batch=()) -> TLWE:
    """Standard LWE secret-key encryption: a <- U(T^kn)."""
    a = prng.uniform_u64(gen, tuple(batch) + (param.kn,), s.device)
    e = prng.gaussian_torus(gen, batch, param.err_sigma, s.device)
    return _encrypt_with(s, p, a, e)


def encrypt(gen: prng.Gen, param: Param, pk: PublicKey, p,
            batch=()) -> TLWE:
    """Public-key encrypt: u a scalar bit, b = pk.b*u + p + e0,
    a = pk.a*u + e1."""
    dev = pk.b.device
    u = prng.binary(gen, batch, dev)
    e0 = prng.gaussian_torus(gen, batch, param.err_sigma, dev)
    e1 = prng.gaussian_torus(gen, tuple(batch) + (param.kn,),
                             param.err_sigma, dev)
    return TLWE(a=pk.a * u[..., None] + e1,
                b=pk.b * u + _torus(p, pk.b) + e0)


def decrypt(param: Param, s, ct: TLWE):
    return ct.b - (ct.a * s).sum(-1)


# -- homomorphic ops --------------------------------------------------------

def add(c0: TLWE, c1: TLWE) -> TLWE:
    return TLWE(c0.a + c1.a, c0.b + c1.b)


def sub(c0: TLWE, c1: TLWE) -> TLWE:
    return TLWE(c0.a - c1.a, c0.b - c1.b)


def add_pt(c: TLWE, p) -> TLWE:
    return TLWE(c.a, c.b + _torus(p, c.b))


def sub_pt(c: TLWE, p) -> TLWE:
    return TLWE(c.a, c.b - _torus(p, c.b))


def mul_pt(c: TLWE, p) -> TLWE:
    p = _torus(p, c.b)
    return TLWE(c.a * p[..., None], c.b * p)


# -- switching --------------------------------------------------------------

def mod_switch(c: TLWE, q2: int) -> TLWE:
    """2^64 -> q2 = 2^j."""
    return TLWE(tn.mod_switch(c.a, q2), tn.mod_switch(c.b, q2))


def new_ksk_with(param: Param, beta: int, l: int, s_src, s_dst, a, e) -> KSK:
    """new_ksk from given draws: masks a [..., kn_src, l, kn_dst], noise
    e [..., kn_src, l]."""
    scales = _tlev_scales(beta, l, s_src.device)         # [l]
    msgs = s_src[..., :, None] * scales                  # [..., kn_src, l]
    b = (a * s_dst[..., None, None, :]).sum(-1) + msgs + e
    return KSK(a=a, b=b)


def new_ksk(gen: prng.Gen, param: Param, beta: int, l: int, s_src,
            s_dst, batch=(), uniform_mask: bool = False) -> KSK:
    """KSK[i] = TLev_s_dst(s_src_i), levels i=1..l, as ONE batched
    encryption over the (kn_src, l) grid.  Source and destination dimensions
    come from the key tensors (they may differ — the short-LWE bootstrap
    switches kn -> n_lwe).  uniform_mask=True uses the standard uniform LWE
    mask instead of the reference's binary one."""
    shape = tuple(batch) + (s_src.shape[-1], l)
    mask = prng.uniform_u64 if uniform_mask else prng.binary
    a = mask(gen, shape + (s_dst.shape[-1],), s_src.device)
    e = prng.gaussian_torus(gen, shape, param.err_sigma, s_src.device)
    return new_ksk_with(param, beta, l, s_src, s_dst, a, e)


def key_switch(param: Param, beta: int, l: int, ksk: KSK, ct: TLWE) -> TLWE:
    """(0, b) - sum_i TLev_i · decompose(a_i): a contraction over
    (kn_src · l).  The products [..., kn_src, l, kn_dst] are formed a chunk
    of kn_src at a time (torch does not fuse the multiply into the sum, and
    CUDA has no int64 matmul), so the temporary stays bounded."""
    d = tn.decompose(ct.a, beta, l)        # [l, ..., kn_src]
    d = torch.movedim(d, 0, -1)            # [..., kn_src, l]
    rhs_b = (d * ksk.b).sum((-1, -2))
    kn_src, _, kn_dst = ksk.a.shape[-3:]
    per_row = max(1, d[..., 0, :].numel() * kn_dst)
    rows = max(1, _KS_CHUNK_WORDS // per_row)
    rhs_a = 0
    for i in range(0, kn_src, rows):
        part = d[..., i:i + rows, :, None] * ksk.a[..., i:i + rows, :, :]
        rhs_a = rhs_a + part.sum((-2, -3))                 # [..., kn_dst]
    return TLWE(a=-rhs_a, b=ct.b - rhs_b)


def _tlev_scales(beta: int, l: int, device):
    """u64::MAX // beta^i for i=1..l (scale 1 once beta^i overflows 64
    bits)."""
    vals = []
    for i in range(1, l + 1):
        bi = beta ** i
        vals.append(tn.i64(TORUS_MAX // bi if bi <= TORUS_MAX else 1))
    return torch.tensor(vals, dtype=torch.int64, device=device)
