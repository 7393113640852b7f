"""T_{N,q}[X] with q = 2^64 — torus polynomials, the counterpart of
fhe_study_tpu/arith/tn.py.

A torus element is a ``torch.int64`` holding the bits of the reference's u64:
two's-complement add, subtract, multiply and sum wrap exactly as u64 does, so
they are written plainly.  What is not the same on signed words is handled
where it occurs: right shifts are arithmetic (the sign bits are masked off),
the conversion to float64 goes through the two unsigned 32-bit halves, and
constants above 2^63 are folded to the signed word of the same bits (``i64``).

The scalar torus T64 is the n = 1 case; TLWE code stores it without a poly
axis.  Two product paths, both exact mod 2^64: ``naive_mul`` (wrapping
schoolbook) and ``mul_crt`` (16-bit limb split + 2-prime CRT NTT).
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import modops, ntt
from ..ops.modops import shr  # noqa: F401  (the torus code's logical shift)
from ..utils.rounding import round_half_away

_MASK32 = 0xFFFFFFFF


def i64(v: int) -> int:
    """The signed 64-bit integer with the bits of v mod 2^64."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def as_torus(x, device=None):
    """Tensor, numpy array (uint64 keeps its bits) or integers below 2^63 ->
    int64 torus tensor."""
    if isinstance(x, torch.Tensor):
        t = x.long()
    else:
        a = np.asarray(x)
        a = a.view(np.int64) if a.dtype == np.uint64 else a.astype(np.int64)
        t = torch.from_numpy(np.array(a))
    return t if device is None else t.to(device)


# -- basic wrapping ops -----------------------------------------------------

def add(a, b):
    return a + b


def sub(a, b):
    return a - b


def neg(a):
    return -a


def scalar_mul(a, s):
    """wrapping a * s (s: torus tensor or int)."""
    return a * (i64(s) if isinstance(s, int) else s)


# -- construction -----------------------------------------------------------

def reduce_negacyclic(c, n: int):
    """mod (X^n+1) with wrapping subtraction."""
    while c.shape[-1] > n:
        length = c.shape[-1]
        m = min(n, length - n)
        head, tail = c[..., :n], c[..., n:n + m]
        folded = head - F.pad(tail, (0, n - m))
        rest = c[..., n + m:]
        c = torch.cat([folded, rest], dim=-1) if rest.shape[-1] else folded
    return c


def from_u64(coeffs, n: int, device):
    return reduce_negacyclic(as_torus(coeffs, device), n)


def from_i64(coeffs, n: int, device):
    return reduce_negacyclic(as_torus(coeffs, device), n)


# -- products ---------------------------------------------------------------

def naive_mul(a, b):
    """Wrapping schoolbook negacyclic product.  The scatter-add has repeated
    indices (every i + j = k), so it is an ``index_add_``."""
    n = a.shape[-1]
    prod = a[..., :, None] * b[..., None, :]
    ar = torch.arange(n, device=a.device)
    idx = (ar[:, None] + ar[None, :]).reshape(-1)
    full = torch.zeros(prod.shape[:-2] + (2 * n - 1,), dtype=torch.int64,
                       device=a.device)
    full.index_add_(-1, idx, prod.reshape(prod.shape[:-2] + (n * n,)))
    return reduce_negacyclic(full, n)


_LIMB_BITS = 16
_NUM_LIMBS = 4


def _split_limbs(a):
    """[..., n] -> [..., 4, n] of 16-bit limbs (low first).  The arithmetic
    shift is followed by the mask and shift + 16 <= 64, so the sign bits
    never reach a limb."""
    mask = (1 << _LIMB_BITS) - 1
    return torch.stack([(a >> (_LIMB_BITS * i)) & mask
                        for i in range(_NUM_LIMBS)], dim=-2)


def limb_products_crt(ea1, eb1, ea2, eb2, reduce=None):
    """sum_{k=0..3} 2^(16k) * g_k mod 2^64 from the eval-domain limbs
    [..., 4, n] under the two CRT primes, g_k = sum_{c+d=k} a_c * b_d (each
    below 4 * n * 2^32 in absolute value, exact under the 2-prime CRT).
    ``reduce`` sums the pointwise products over an axis (the contraction)."""
    p1, p2 = ntt.CRT_PRIMES[:2]
    out = 0
    for k in range(_NUM_LIMBS):
        acc1 = acc2 = 0
        for c in range(k + 1):
            d = k - c
            t1 = ea1[..., c, :] * eb1[..., d, :] % p1
            t2 = ea2[..., c, :] * eb2[..., d, :] % p2
            acc1 = acc1 + (t1 if reduce is None else reduce(t1))
            acc2 = acc2 + (t2 if reduce is None else reduce(t2))
        r1 = ntt.intt(acc1 % p1, p1)
        r2 = ntt.intt(acc2 % p2, p2)
        # centered lift: a negacyclic convolution can be negative, and the
        # signed value is the right one mod 2^64; the multiply by 2^(16k)
        # wraps by definition (a left shift of a signed word need not)
        g_k = ntt.crt_lift_centered(r1, r2, p1, p2)
        out = out + g_k * (1 << (_LIMB_BITS * k))
    return out


def mul_crt(a, b):
    """Exact wrapping negacyclic product via limb-split CRT NTT."""
    p1, p2 = ntt.CRT_PRIMES[:2]
    al, bl = _split_limbs(a), _split_limbs(b)          # limbs < 2^16 < p
    return limb_products_crt(ntt.ntt(al, p1), ntt.ntt(bl, p1),
                             ntt.ntt(al, p2), ntt.ntt(bl, p2))


def mul(a, b):
    if a.shape[-1] >= 64:
        return mul_crt(a, b)
    return naive_mul(a, b)


# -- rotations / extraction -------------------------------------------------

def left_rotate(a, h, n: int):
    """Multiply by X^{-h}, h in [0, 2n) (any integer is taken mod 2n), a
    tensor broadcastable to a.shape[:-1] or an int: out[j] = a[(j + h) mod n],
    negated where (j + h) mod 2n >= n."""
    h = torch.remainder(torch.as_tensor(h, device=a.device).long(), 2 * n)
    idx = (torch.arange(n, device=a.device) + h[..., None]) % (2 * n)
    wrapped = idx >= n
    take = torch.where(wrapped, idx - n, idx)
    shape = torch.broadcast_shapes(a.shape, take.shape)
    vals = torch.gather(a.expand(shape), -1, take.expand(shape))
    return torch.where(wrapped.expand(shape), -vals, vals)


# -- switches / decomposition ----------------------------------------------

def _log2_pow2(q2: int) -> int:
    if q2 <= 0 or q2 & (q2 - 1):
        raise ValueError(f"modulus {q2} is not a power of two")
    return q2.bit_length() - 1


def mod_switch(a, q2: int):
    """2^64 -> q2 (power of two): logical right shift by 64 - log2(q2)."""
    return shr(a, 64 - _log2_pow2(q2))


def mod_switch_round(a, q2: int):
    """2^64 -> q2 (power of two), round to nearest: one guard bit, +1, >>1,
    mod q2 — all on the unsigned value."""
    log2_q2 = _log2_pow2(q2)
    shifted = shr(a, 63 - log2_q2)
    return shr(shifted + 1, 1) & (q2 - 1)


def mod_switch_to_rq(a, p: int):
    """Tn -> Rq mod switch."""
    return modops.coerce_u64(mod_switch(a, p), p)


def u64_to_f64(a):
    """The float64 nearest the unsigned value: both 32-bit halves convert
    exactly and their sum rounds once, as the u64 -> f64 conversion does
    (``a.double() + 2^64`` would round twice above 2^63)."""
    return (shr(a, 32).double() * float(1 << 32)
            + (a & _MASK32).double())


def mul_div_round(a, num: int, den: int):
    """round(num * v / den) as a torus word, f64 path, half away from zero."""
    r = round_half_away(float(num) * u64_to_f64(a) / float(den))
    return r.long()


def decompose_base2(a, l: int):
    """Bit decomposition MSB-first over the top l bits -> [l, ...]."""
    return torch.stack([(a >> (63 - i)) & 1 for i in range(l)])


def decompose_base2_reference(a, l: int):
    """The reference's l < 64 slice: the LOW l bits, MSB of the slice first
    (quirk parity only)."""
    return torch.stack([(a >> (l - 1 - i)) & 1 for i in range(l)])


def decompose_base_pow2(a, w: int, l: int):
    """Unsigned base-2^w gadget digits, MSB-first: digit_i = bits
    [64 - w(i+1), 64 - w*i) -> [l, ...]."""
    if w * l > 64:
        raise ValueError(f"w * l = {w * l} > 64")
    mask = i64((1 << w) - 1)
    return torch.stack([(a >> (64 - w * (i + 1))) & mask for i in range(l)])


def decompose(a, beta: int, l: int):
    if beta < 2 or beta & (beta - 1):
        raise ValueError("torus decomposition needs beta = 2^w")
    if beta == 2:
        return decompose_base2(a, l)
    return decompose_base_pow2(a, beta.bit_length() - 1, l)
