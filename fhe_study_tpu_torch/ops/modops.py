"""Integer helpers of fhe_study_tpu/ops/modops.py that RNS-BFV needs, on
int64 tensors with a scalar modulus q < 2^31 (products below 2^62 are exact;
larger moduli need 128-bit products and are not ported)."""

import torch


def coerce_i64(v, q: int):
    """Signed integers -> canonical [0, q) as int64 (Rust (e % q + q) % q;
    torch.remainder already takes the divisor's sign)."""
    return torch.remainder(torch.as_tensor(v).long(), q)


def _check_modulus(q: int) -> None:
    if not 1 < q < (1 << 31):
        raise ValueError(f"modulus {q}: the int64 forms need 1 < q < 2^31")


def submod(a, b, q: int):
    """a - b mod q for canonical a, b."""
    _check_modulus(q)
    return torch.where(a >= b, a - b, (q - b) + a)


def mulmod(a, b, q: int):
    """a * b mod q for canonical a, b."""
    _check_modulus(q)
    return (a * b) % q
