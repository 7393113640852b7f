"""Integer helpers of fhe_study_tpu/ops/modops.py that RNS-BFV and the torus
schemes need, on int64 tensors with a scalar modulus q < 2^31 (products below
2^62 are exact; larger moduli need 128-bit products and are not ported).

``coerce_u64`` takes int64 tensors that hold the bits of unsigned 64-bit
values (the torus representation) and reduces the unsigned value."""

import torch


def coerce_i64(v, q: int):
    """Signed integers -> canonical [0, q) as int64 (Rust (e % q + q) % q;
    torch.remainder already takes the divisor's sign)."""
    return torch.remainder(torch.as_tensor(v).long(), q)


def _check_modulus(q: int) -> None:
    if not 1 < q < (1 << 31):
        raise ValueError(f"modulus {q}: the int64 forms need 1 < q < 2^31")


def coerce_u64(v, q: int):
    """Unsigned 64-bit values, carried as int64 bits -> canonical [0, q):
    the low 63 bits and the top bit reduced apart (2^63 mod q for the top
    bit), so no value above 2^63 is ever formed."""
    _check_modulus(q)
    v = torch.as_tensor(v).long()
    low = (v & ((1 << 63) - 1)) % q
    top = (v >> 63) & 1
    return (low + top * ((1 << 63) % q)) % q


def addmod(a, b, q: int):
    """a + b mod q for canonical a, b."""
    _check_modulus(q)
    s = a + b
    return torch.where(s >= q, s - q, s)


def negmod(a, q: int):
    """-a mod q for canonical a."""
    _check_modulus(q)
    return torch.where(a == 0, a, q - a)


def submod(a, b, q: int):
    """a - b mod q for canonical a, b."""
    _check_modulus(q)
    return torch.where(a >= b, a - b, (q - b) + a)


def mulmod(a, b, q: int):
    """a * b mod q for canonical a, b."""
    _check_modulus(q)
    return (a * b) % q
