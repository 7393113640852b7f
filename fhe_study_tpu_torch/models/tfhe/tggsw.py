"""TGGSW + TGLev over torus polynomials — the counterpart of
fhe_study_tpu/models/tfhe/tggsw.py.

    TGLev(a=[..., l, K, N], b=[..., l, N])
    TGGSW(a=[..., K+1, l, K, N], b=[..., K+1, l, N])

The external product TGGSW ⊠ TGLWE is the bootstrapping workhorse: it
decomposes the (K+1) ciphertext polys into l digit polys each and contracts
the (K+1)·l grid of polynomial products (TorusRing.contract), or, with the
key pre-transformed (``TGGSWEvals``), multiplies in the eval domain of the
two CRT primes.
"""

from typing import NamedTuple

import torch

from ...arith import tn
from ...arith.ring import TorusRing
from ...ops import modops, ntt
from ...ops.modops32 import qvec
from ...utils import prng
from ..gfhe import glwe as G
from ..gfhe.glwe import GLWE, Param
from .tlwe import TORUS_MAX, _tlev_scales


class TGLev(NamedTuple):
    a: torch.Tensor  # [..., l, K, N]
    b: torch.Tensor  # [..., l, N]


class TGGSW(NamedTuple):
    a: torch.Tensor  # [..., K+1, l, K, N]
    b: torch.Tensor  # [..., K+1, l, N]


# -- TGLev ------------------------------------------------------------------

def tglev_encode(param: Param, m):
    return tn.as_torus(m)


def tglev_decode(param: Param, p):
    return modops.coerce_u64(p, param.t)


def _tglev_msgs(beta: int, l: int, m, device):
    scales = _tlev_scales(beta, l, device)                     # [l]
    return tn.as_torus(m, device)[..., None, :] * scales[:, None]  # [.., l, N]


def tglev_encrypt_s(gen: prng.Gen, param: Param, beta: int, l: int, s,
                    m, batch=()) -> TGLev:
    ct = G.encrypt_s(gen, param, s, _tglev_msgs(beta, l, m, s.device),
                     batch=tuple(batch) + (l,))
    return TGLev(a=ct.a, b=ct.b)


def tglev_encrypt(gen: prng.Gen, param: Param, beta: int, l: int, pk,
                  m, batch=()) -> TGLev:
    ct = G.encrypt(gen, param, pk, _tglev_msgs(beta, l, m, pk.b.device),
                   batch=tuple(batch) + (l,))
    return TGLev(a=ct.a, b=ct.b)


def tglev_decrypt(param: Param, s, c: TGLev, beta: int):
    pt = G.decrypt(param, s, GLWE(a=c.a[..., 0, :, :], b=c.b[..., 0, :]))
    return tn.mul_div_round(pt, beta, TORUS_MAX)


def tglev_mul_vec(param: Param, c: TGLev, v) -> GLWE:
    """sum_i TGLWE_i · v_i, v: [..., l, N]."""
    ring = TorusRing(param.ring.n)
    b = ring.contract(c.b, v)
    a = ring.contract(torch.movedim(c.a, -2, 0), v)
    return GLWE(a=torch.movedim(a, 0, -2), b=b)


# -- TGGSW ------------------------------------------------------------------

# Key words (int64) that a slice of a bootstrapping key's steps takes at
# once, in encrypt_s_with (mask words) and in precompute_evals (key words):
# the int64 temporaries of either (the limbs, their residues, the
# transforms' outputs and scratch) take about 14 times the slice, so 2^25
# words hold them near 3.5 GiB at any key size (the whole key at N = 2^16,
# l = 5 encrypted in one batch took 53.75 GiB of the card at its peak).
EVALS_SLICE_WORDS = 1 << 25


def _row_msgs(param: Param, beta: int, l: int, s, m):
    """Rows j < K hold -s_j·m (a polynomial product), row K holds m; each at
    the l gadget scales: [..., K+1, l, N]."""
    ring = TorusRing(param.ring.n)
    m = tn.as_torus(m, s.device)
    neg_sm = ring.mul(ring.neg(s), m[..., None, :])            # [..., K, N]
    rows = torch.cat([neg_sm, m[..., None, :]], dim=-2)        # [..., K+1, N]
    scales = _tlev_scales(beta, l, s.device)
    return rows[..., :, None, :] * scales[:, None]


def _b_of(param: Param, beta: int, l: int, s, m, a, e):
    return G.encrypt_s_with(param, s, _row_msgs(param, beta, l, s, m), a,
                            e).b


def encrypt_s_with(param: Param, beta: int, l: int, s, m, a, e) -> TGGSW:
    """encrypt_s from given draws: masks a [..., K+1, l, K, N], noise
    e [..., K+1, l, N].  Messages along a leading axis of keys under one
    key s (a bootstrapping key's steps: m [steps, N]) are encrypted in
    slices of that axis into the output (each key's words are its own
    alone, so the result is the same bit for bit), about
    EVALS_SLICE_WORDS mask words a slice."""
    steps = a.shape[0] if a.ndim > 4 else 0
    if not (steps and s.ndim == 2 and m.ndim == 2
            and m.shape[0] == e.shape[0] == steps
            and a.numel() > EVALS_SLICE_WORDS):
        return TGGSW(a=a, b=_b_of(param, beta, l, s, m, a, e))
    b = torch.empty(a.shape[:-2] + a.shape[-1:], dtype=torch.int64,
                    device=a.device)
    step = max(1, EVALS_SLICE_WORDS // a[:1].numel())
    for i in range(0, steps, step):
        part = slice(i, i + step)
        b[part] = _b_of(param, beta, l, s, m[part], a[part], e[part])
    return TGGSW(a=a, b=b)


def encrypt_s(gen: prng.Gen, param: Param, beta: int, l: int, s, m,
              batch=()) -> TGGSW:
    """One batched GLWE encryption over the (K+1, l) grid: the mask and
    then the noise drawn whole, in the order of glwe.encrypt_s, then the
    arithmetic of ``encrypt_s_with`` (in slices of keys where it slices)."""
    ring = TorusRing(param.ring.n)
    grid = tuple(batch) + (param.k + 1, l)
    a = ring.rand_bin(gen, grid + (param.k,), s.device)
    e = ring.rand_err(gen, grid, param.err_sigma, s.device)
    return encrypt_s_with(param, beta, l, s, m, a, e)


def decrypt(param: Param, s, c: TGGSW, beta: int):
    return tglev_decrypt(
        param, s, TGLev(a=c.a[..., -1, :, :, :], b=c.b[..., -1, :, :]), beta)


def _digits(c: GLWE, beta: int, l: int):
    """[a | b] decomposed: [..., K+1, l, N]."""
    ab = torch.cat([c.a, c.b[..., None, :]], dim=-2)          # [..., K+1, N]
    return torch.movedim(tn.decompose(ab, beta, l), 0, -2)


def external_product(param: Param, beta: int, l: int, g: TGGSW,
                     c: GLWE) -> GLWE:
    """TGGSW ⊠ TGLWE: decompose [a | b] -> (K+1, l) digit polys, contract
    against the key grid in one fused reduce."""
    ring = TorusRing(param.ring.n)
    k, n = param.k, param.ring.n
    d = _digits(c, beta, l)
    batch = torch.broadcast_shapes(d.shape[:-3], g.b.shape[:-3])
    M = (k + 1) * l
    d_flat = d.expand(batch + d.shape[-3:]).reshape(batch + (M, n))
    gb = g.b.expand(batch + g.b.shape[-3:]).reshape(batch + (M, n))
    out_b = ring.contract(gb, d_flat)
    ga = g.a.expand(batch + g.a.shape[-4:]).reshape(batch + (M, k, n))
    out_a = ring.contract(torch.movedim(ga, -2, 0), d_flat)   # [k, ..., n]
    return GLWE(a=torch.movedim(out_a, 0, -2), b=out_b)


def cmux(param: Param, beta: int, l: int, bit: TGGSW, c1: GLWE,
         c2: GLWE) -> GLWE:
    """c1 + bit ⊠ (c2 - c1)."""
    prod = external_product(param, beta, l, bit, G.sub(param, c2, c1))
    return G.add(param, c1, prod)


# ---------------------------------------------------------------------------
# Fast path: TGGSW keys pre-transformed to the CRT-NTT domain.
#
# The generic external product re-transforms the key polynomials at every
# call.  Here the key is kept as 32-bit limbs per CRT prime in the eval
# domain; digits are small (< beta <= 2^12), so they need only ONE limb, and
# the convolution bound (K+1)·l·n·beta·2^32 stays under the 2-prime CRT
# capacity.
# ---------------------------------------------------------------------------

class TGGSWEvals(NamedTuple):
    """[..., K+1(row), l, K+1(col), 2(limb), N] int32 per CRT prime, plain
    eval domain, each with its Shoup companion plane floor(w * 2^32 / p).
    The companions span the whole u32 range: their int32 holds the bits
    (the blind-rotation kernel reads them as uint32_t; the plain versions
    multiply exactly in int64 and do not need them)."""
    ev1: torch.Tensor
    ev2: torch.Tensor
    ev1s: torch.Tensor
    ev2s: torch.Tensor


def _u32_bits(x):
    """int64 values in [0, 2^32) -> the int32 of the same low bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).int()


def _evals_of(g: TGGSW) -> tuple:
    """(ev1, ev2, ev1s, ev2s) of one slice of keys."""
    ab = torch.cat([g.a, g.b[..., None, :]], dim=-2)   # [.., K+1r, l, K+1c, N]
    limbs = torch.stack([ab & 0xFFFFFFFF, tn.shr(ab, 32)], dim=-2)
    del ab
    out = []
    for p in ntt.CRT_PRIMES_TFHE:
        ev = ntt.ntt(limbs % p, p)
        out.append((ev.int(), _u32_bits(ev * (1 << 32) // p)))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def precompute_evals(param: Param, g: TGGSW) -> TGGSWEvals:
    """Transform a TGGSW (any leading batch dims) into eval-domain 32-bit
    limbs under both CRT primes, plus the Shoup planes.  A key with a
    leading axis of keys (a bootstrapping key's steps) is transformed in
    slices of that axis into the four planes (each value is its own key's
    alone, so the planes are the same bit for bit), about
    EVALS_SLICE_WORDS key words a slice."""
    per_key = g.a[:1].numel() + g.b[:1].numel() if g.a.ndim > 4 else 0
    if not per_key or g.a.numel() + g.b.numel() <= EVALS_SLICE_WORDS:
        return TGGSWEvals(*_evals_of(g))
    steps = g.a.shape[0]
    shape = g.b.shape[:-1] + (g.a.shape[-2] + 1, 2, g.b.shape[-1])
    planes = [torch.empty(shape, dtype=torch.int32, device=g.a.device)
              for _ in range(4)]
    step = max(1, EVALS_SLICE_WORDS // per_key)
    for i in range(0, steps, step):
        for plane, part in zip(planes, _evals_of(
                TGGSW(a=g.a[i:i + step], b=g.b[i:i + step]))):
            plane[i:i + step] = part
    return TGGSWEvals(*planes)


def external_product_evals(param: Param, gev: TGGSWEvals, c: GLWE,
                           beta: int, l: int) -> GLWE:
    """TGGSW ⊠ TGLWE with a pre-transformed key: forward-NTT only the (K+1)·l
    digit polys (single limb), reduce over the grid in the eval domain,
    inverse transforms, exact CRT recombination mod 2^64.  Both primes ride
    the multi-prime transforms (one launch per direction)."""
    pq = ntt.CRT_PRIMES_TFHE
    p1, p2 = pq
    k, n = param.k, param.ring.n
    # conv bound: (K+1)·l·n·beta·2^32 must stay under p1·p2/2 ≈ 2^58.4
    if (k + 1) * l * n * beta >= (1 << 26):
        raise ValueError("CRT capacity exceeded")
    d = _digits(c, beta, l)                                  # [..., K+1, l, N]
    if beta <= min(pq):
        # digits are unsigned in [0, beta): already reduced mod both primes
        dd = torch.stack([d, d]).int()
    else:
        dd = torch.stack([d % p1, d % p2]).int()
    ed = ntt.ntt_multi(dd, pq).long()                        # [2, .., r, l, N]
    ev = torch.stack([gev.ev1, gev.ev2]).long()              # [2, r, l, c, 2, N]
    edx = ed[..., :, :, None, None, :]                       # [2, .., r, l, 1, 1, N]
    extra = edx.ndim - ev.ndim          # ciphertext batch dims absent in the key
    if extra > 0:
        ev = ev.reshape(ev.shape[:1] + (1,) * extra + ev.shape[1:])
    # exact products in int64 (both factors < 2^30), then the contraction
    # over the (row, level) grid: at most (K+1)·l < 2^26 terms below 2^30
    prod = edx * ev % qvec(pq, edx.ndim, edx.device)
    s = prod.sum((-5, -4)) % qvec(pq, edx.ndim - 2, edx.device)
    r = ntt.intt_multi(s.int(), pq).long()      # [2, ..., K+1c, 2limb, N]
    gk = ntt.crt_lift_centered(r[0], r[1], p1, p2)
    out = gk[..., 0, :] + gk[..., 1, :] * (1 << 32)          # wrapping
    return GLWE(a=out[..., :k, :], b=out[..., k, :])


def cmux_evals(param: Param, beta: int, l: int, gev: TGGSWEvals,
               c1: GLWE, c2: GLWE) -> GLWE:
    prod = external_product_evals(param, gev, G.sub(param, c2, c1), beta, l)
    return G.add(param, c1, prod)
