"""Z_q arithmetic on int64 tensors — the counterpart of
fhe_study_tpu/ops/modops.py, for any modulus 1 < q < 2^63.

The reference computes on u64.  Torch has no unsigned 64-bit arithmetic, so
a tensor here is ``torch.int64`` holding the u64 bits: add, subtract,
multiply and sum wrap exactly as u64 does, but ``>>`` is arithmetic and
``<`` is signed.  Where a value may reach 2^63 the code says so and uses the
logical shift ``shr`` or the unsigned compare ``uge``.  Canonical residues
lie in [0, q) with q < 2^63, so they are non-negative and compare as they
are.

Products: below 2^31, ``(a * b) % q`` is exact in int64 (the path of every
NTT prime); below 2^32 the product still fits 64 bits, and its unsigned
remainder is taken; from 2^32 up (odd q, e.g. the BFV relinearization
modulus p*q) a Montgomery product on the 128-bit product of ``mul128``
(32-bit limbs), as the reference.  Every function is elementwise over any
shape; ``q`` is a Python int.
"""

from functools import lru_cache

import torch

from ..utils.rounding import round_half_away

_MASK32 = (1 << 32) - 1
_SIGN = -(1 << 63)                  # the int64 of the u64 2^63


def _check_modulus(q: int) -> None:
    if not 1 < q < (1 << 63):
        raise ValueError(f"modulus {q}: the int64 forms need 1 < q < 2^63")


def _signed(v: int) -> int:
    """The int64 with the bits of v mod 2^64."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def as_u64(x, like: torch.Tensor) -> torch.Tensor:
    """An int operand (u64 value) as an int64 tensor on like's device."""
    if isinstance(x, torch.Tensor):
        return x.long()
    return torch.tensor(_signed(int(x)), dtype=torch.int64,
                        device=like.device)


def shr(a, k: int):
    """Logical (unsigned) right shift of the u64 bits by a static k < 64."""
    if k == 0:
        return a
    return (a >> k) & ((1 << (64 - k)) - 1)


def uge(a, b):
    """a >= b on the u64 bits: a signed compare with the sign bits flipped."""
    return (a ^ _SIGN) >= (b ^ _SIGN)


# -- add / sub / neg ----------------------------------------------------------

def addmod(a, b, q: int):
    """a + b mod q for canonical a, b (the sum may pass 2^63 when q > 2^62)."""
    _check_modulus(q)
    s = a + b
    return torch.where(uge(s, q) if q > (1 << 62) else s >= q, s - q, s)


def submod(a, b, q: int):
    """a - b mod q for canonical a, b."""
    _check_modulus(q)
    return torch.where(a >= b, a - b, (q - b) + a)


def negmod(a, q: int):
    """-a mod q for canonical a."""
    _check_modulus(q)
    return torch.where(a == 0, a, q - a)


def coerce_u64(v, q: int):
    """Unsigned 64-bit values, carried as int64 bits -> canonical [0, q):
    the low 63 bits and the top bit reduced apart (2^63 mod q for the top
    bit), so no value above 2^63 is ever divided."""
    _check_modulus(q)
    v = torch.as_tensor(v).long()
    low = (v & ((1 << 63) - 1)) % q
    top = shr(v, 63) * ((1 << 63) % q)
    return addmod(low, top, q)


def coerce_i64(v, q: int):
    """Signed integers -> canonical [0, q) as int64 (Rust (e % q + q) % q;
    torch.remainder already takes the divisor's sign)."""
    return torch.remainder(torch.as_tensor(v).long(), q)


def coerce_f64(v, q: int):
    """f64 -> round half away from zero -> canonical [0, q)."""
    return coerce_i64(round_half_away(torch.as_tensor(v).double()).long(), q)


# -- mul ----------------------------------------------------------------------

def mul128(a, b):
    """The full 64 x 64 -> 128-bit product of the u64 bits of a and b, as
    (hi, lo) int64 bits, from 32-bit limbs (each limb product wraps into the
    int64 of its u64 bits; the shifts of those are logical)."""
    a0, a1 = a & _MASK32, shr(a, 32)
    b0, b1 = b & _MASK32, shr(b, 32)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = shr(p00, 32) + (p01 & _MASK32) + (p10 & _MASK32)   # < 3 * 2^32
    lo = mid * (1 << 32) | (p00 & _MASK32)                   # wraps
    hi = p11 + shr(p01, 32) + shr(p10, 32) + shr(mid, 32)
    return hi, lo


@lru_cache(maxsize=None)
def _mont_consts(q: int) -> tuple:
    """(-q^-1 mod 2^64, 2^128 mod q) as int64 bits, for odd q < 2^63."""
    if q % 2 == 0 or not 1 < q < (1 << 63):
        raise ValueError(f"modulus {q}: the Montgomery path needs an odd "
                         "q < 2^63")
    return _signed(-pow(q, -1, 1 << 64)), (1 << 128) % q


def _mont_redc(hi, lo, q: int, nqinv: int):
    """Montgomery reduction of the 128-bit (hi, lo): value * 2^-64 mod q."""
    m = lo * nqinv                               # the low 64 bits, wrapping
    mh, _ = mul128(m, torch.full_like(m, q))
    carry = (lo != 0).long()                     # lo + ml == 0 mod 2^64
    t = hi + mh + carry                          # below 2q < 2^64
    return torch.where(uge(t, q), t - q, t)


def mulmod(a, b, q: int):
    """a * b mod q for canonical a, b in [0, q): exact for any q < 2^63
    (odd from 2^32 up).  b may be an int."""
    _check_modulus(q)
    a = torch.as_tensor(a).long()
    b = as_u64(b, a)
    if q < (1 << 31):
        return (a * b) % q
    if q < (1 << 32):
        return coerce_u64(a * b, q)              # the product's u64 bits
    nqinv, r2 = _mont_consts(q)
    a, b = torch.broadcast_tensors(a, b)
    t = _mont_redc(*mul128(a, b), q, nqinv)      # a * b * 2^-64 mod q
    return _mont_redc(*mul128(t, torch.full_like(t, r2)), q, nqinv)


def powmod(a, e: int, q: int):
    """a^e mod q (static exponent, square and multiply)."""
    base = torch.as_tensor(a).long()
    result = torch.ones_like(base)
    while e > 0:
        if e & 1:
            result = mulmod(result, base, q)
        base = mulmod(base, base, q)
        e >>= 1
    return result


def invmod_prime(a, q: int):
    """a^-1 mod q by Fermat (q prime: every NTT and RNS modulus); invmod
    takes any modulus."""
    return powmod(a, q - 2, q)


def _binary_inv_odd(a, m: int):
    """a^-1 mod odd m by the binary extended gcd, with the reference's
    static count of steps (4 bit-lengths + 4); a coprime to m."""
    if m % 2 == 0:
        raise ValueError(f"modulus {m}: the binary inverse needs it odd")
    u = coerce_u64(a, m)
    v = torch.full_like(u, m)
    x1, x2 = torch.ones_like(u), torch.zeros_like(u)

    def half(x):
        # x/2 if even, else (x + m)/2: x + m may pass 2^63, hence shr
        return torch.where(x & 1 == 0, x >> 1, shr(x + m, 1))

    for _ in range(4 * m.bit_length() + 4):
        u_even = u & 1 == 0
        v_even = ~u_even & (v & 1 == 0)
        odd = ~u_even & ~v_even
        sub_u, sub_v = odd & (u >= v), odd & (u < v)
        # every update from the old state, then assigned together
        h1, h2 = half(x1), half(x2)
        u, v, x1, x2 = (
            torch.where(u_even, u >> 1, torch.where(sub_u, u - v, u)),
            torch.where(v_even, v >> 1, torch.where(sub_v, v - u, v)),
            torch.where(u_even, h1,
                        torch.where(sub_u, submod(x1, x2, m), x1)),
            torch.where(v_even, h2,
                        torch.where(sub_v, submod(x2, x1, m), x2)))
    return torch.where(u == 1, x1, x2)


def invmod(a, q: int):
    """a^-1 mod q for ANY modulus with a coprime to q (the reference's egcd
    semantics): the binary xgcd for the odd part of q, Newton lifting for
    the 2-power part, combined by CRT.  A non-coprime input gives an
    unspecified output, as in the reference's jitted form."""
    _check_modulus(q)
    k = (q & -q).bit_length() - 1                # q = 2^k * m, m odd
    m = q >> k
    if k == 0:
        return _binary_inv_odd(a, q)
    # the inverse mod 2^k: a * a == 1 (mod 8), and five Newton doublings
    # x <- x * (2 - a x) reach 2^96 >= 2^64 (wrapping products)
    mask = (1 << k) - 1
    av = torch.as_tensor(a).long()
    x = av
    for _ in range(5):
        x = x * (2 - av * x)
    i1 = x & mask
    if m == 1:
        return i1
    i2 = _binary_inv_odd(av, m)
    # x == i2 (mod m), x == i1 (mod 2^k): x = i2 + m * ((i1 - i2) m^-1 mod 2^k)
    t = ((i1 - i2) * pow(m, -1, 1 << k)) & mask
    return i2 + m * t


def divmod_prime(a, b, q: int):
    """a / b = a * b^-1 mod q (q prime)."""
    return mulmod(a, invmod_prime(b, q), q)


def divmod_any(a, b, q: int):
    """a / b mod q for any modulus, b coprime to q."""
    return mulmod(a, invmod(b, q), q)


# -- mod switch / scaled rounding ---------------------------------------------

def mod_switch(v, q: int, q2: int):
    """round(v * q2 / q) mod q2, in float64 as the reference (v canonical)."""
    r = round_half_away(v.double() * float(q2) / float(q))
    return coerce_i64(r.long(), q2)


def mul_div_round(v, num: int, den: int, q: int):
    """round(num * v / den) mod q, in float64 as the reference."""
    r = round_half_away(float(num) * v.double() / float(den))
    return coerce_i64(r.long(), q)


# -- gadget decomposition -----------------------------------------------------

def decompose_base_beta(v, q: int, beta: int, l: int):
    """Unsigned digits of v (below 2^63) against the denominators
    q // beta^i, i = 1..l, most significant first: [l, ...].  Saturates to
    beta - 1 where v >= beta^l (the reference's approximate branch)."""
    v = torch.as_tensor(v).long()
    digits, rem = [], v
    for i in range(1, l + 1):
        den = q // beta ** i
        digits.append(rem // den)
        rem = rem % den
    out = torch.stack(digits)
    if beta ** l >= 1 << 63:                     # v < 2^63 never reaches it
        return out
    return torch.where((v >= beta ** l)[None], beta - 1, out)


def decompose_base2(v, q: int, l: int):
    """Bit decomposition, the most significant of the l-bit window first:
    [l, ...]; all ones where v >= 2^l."""
    v = torch.as_tensor(v).long()
    d = torch.stack([shr(v, s) & 1 for s in range(l - 1, -1, -1)])
    if l >= 64:
        return d
    return torch.where((shr(v, l) != 0)[None], 1, d)


def decompose(v, q: int, beta: int, l: int):
    """The reference's dispatch: beta == 2 takes the bit path."""
    if beta == 2:
        return decompose_base2(v, q, l)
    return decompose_base_beta(v, q, beta, l)


def recompose(digits, q: int, beta: int, l: int):
    """sum_i d_i * (q // beta^(i+1)) mod q (the sum wraps as u64 does)."""
    acc = torch.zeros_like(digits[0])
    for i in range(l):
        acc = acc + digits[i] * (q // beta ** (i + 1))
    return coerce_u64(acc, q)
