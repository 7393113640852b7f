"""R_q = Z_q[X]/(X^N+1): batched polynomial-ring operations on int64
[..., n] tensors — the counterpart of fhe_study_tpu/arith/rq.py.

Elements are int64 tensors with coefficients in [0, q), q < 2^63 (the u64
bits of the reference's elements); (q, n) are Python ints.  Products go
through the single-prime NTT of ops/ntt.py, which launches K9 on the card
where the reference launches its Pallas kernel.  Callers that reuse an
operand across many products hold its evaluations (``to_evals`` /
``mul_evals``).
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import modops, ntt


def _as_tensor(coeffs, device) -> torch.Tensor:
    """Tensor, numpy array (uint64 keeps its bits) or integers -> int64."""
    if isinstance(coeffs, torch.Tensor):
        return coeffs.long().to(device)
    a = np.asarray(coeffs)
    a = a.view(np.int64) if a.dtype == np.uint64 else a.astype(np.int64)
    return torch.from_numpy(np.array(a)).to(device)


# -- construction -------------------------------------------------------------

def reduce_negacyclic_u64(coeffs, q: int, n: int):
    """mod (X^n + 1) over Z_q of a coefficient tensor of length >= n:
    p[i - n] -= p[i], repeatedly."""
    c = coeffs
    while c.shape[-1] > n:
        m = min(n, c.shape[-1] - n)
        folded = modops.submod(c[..., :n], F.pad(c[..., n:n + m], (0, n - m)),
                               q)
        rest = c[..., n + m:]
        c = torch.cat([folded, rest], dim=-1) if rest.shape[-1] else folded
    return c


def from_u64(coeffs, q: int, n: int, device):
    """u64 values (any, length >= n) -> canonical ring element."""
    return reduce_negacyclic_u64(
        modops.coerce_u64(_as_tensor(coeffs, device), q), q, n)


def from_i64(coeffs, q: int, n: int, device):
    return reduce_negacyclic_u64(
        modops.coerce_i64(_as_tensor(coeffs, device), q), q, n)


def from_f64(coeffs, q: int, n: int, device):
    c = torch.as_tensor(coeffs, dtype=torch.float64, device=device)
    return reduce_negacyclic_u64(modops.coerce_f64(c, q), q, n)


def zeros(shape, n: int, device):
    return torch.zeros(tuple(shape) + (n,), dtype=torch.int64, device=device)


# -- ring ops -----------------------------------------------------------------

def add(a, b, q: int):
    return modops.addmod(a, b, q)


def sub(a, b, q: int):
    return modops.submod(a, b, q)


def neg(a, q: int):
    return modops.negmod(a, q)


def mul(a, b, q: int):
    """Ring product through the NTT (q prime, q = 1 mod 2n)."""
    return ntt.negacyclic_mul(a, b, q)


def to_evals(a, q: int):
    return ntt.ntt(a, q)


def from_evals(ea, q: int):
    return ntt.intt(ea, q)


def mul_evals(ea, eb, q: int):
    """Pointwise product in the evaluation domain."""
    return modops.mulmod(ea, eb, q)


def scalar_mul_u64(a, s, q: int):
    """a * s with s (tensor or int, u64 value) reduced mod q first."""
    s = modops.coerce_u64(modops.as_u64(s, a), q)
    return modops.mulmod(a, s, q)


def scalar_mul_f64(a, s, q: int):
    """round(a_i * s) mod q per coefficient."""
    return modops.coerce_f64(a.double() * s, q)


# -- conversions / switches ---------------------------------------------------

def remodule(a, q: int, p: int):
    """Reinterpret the coefficients mod p (crops when q >= p)."""
    return modops.coerce_u64(a, p)


def mod_switch(a, q: int, p: int):
    """Coefficient-wise round(v * p / q) mod p."""
    return modops.mod_switch(a, q, p)


def mul_div_round(a, num: int, den: int, q: int):
    """round(num * v / den) mod q, in float64."""
    return modops.mul_div_round(a, num, den, q)


def div_round(a, s: int, q: int):
    """round(v / s) mod q."""
    return modops.coerce_f64(a.double() / float(s), q)


def coeffs_mod(a, t: int):
    """The coefficients mod t."""
    return modops.coerce_u64(a, t)


def decompose(a, q: int, beta: int, l: int):
    """Gadget decomposition per coefficient -> [l, ..., n]."""
    return modops.decompose(a, q, beta, l)


# -- norms / lifts ------------------------------------------------------------

def infinity_norm(a, q: int):
    """max |centered lift| over the last axis."""
    return torch.where(a > q // 2, q - a, a).amax(-1)


def to_centered_i64(a, q: int):
    """Centered lift to (-q/2, q/2] as int64 (res > q/2 -> res - q)."""
    v = a.long()
    return torch.where(v > q // 2, v - q, v)


def to_r(a):
    """Lift to Z[X] keeping the representatives in [0, q) (not centered, as
    the reference's Rq::to_r)."""
    return a.long()


# -- matrix helpers -----------------------------------------------------------

def matrix_vec_product(m, v, q: int):
    """[..., r, c] x [..., c] -> [..., r] over Z_q: a sum of products, each
    below q (the sum wraps as u64 does)."""
    return modops.coerce_u64(modops.mulmod(m, v[..., None, :], q).sum(-1), q)


def matrix_transpose(m):
    return m.transpose(-1, -2)


def matrix_mul(a, b, q: int):
    """[..., r, k] x [..., k, c] -> [..., r, c] over Z_q."""
    prod = modops.mulmod(a[..., :, :, None], b[..., None, :, :], q)
    return modops.coerce_u64(prod.sum(-2), q)


# -- pretty printer (host; the reference's golden strings) --------------------

def to_string(a, q: int, n: int) -> str:
    coeffs = a.reshape(-1).tolist()
    if len(coeffs) != n:
        raise ValueError(f"{len(coeffs)} coefficients for n = {n}")
    parts = []
    for i in range(n - 1, -1, -1):
        v = int(coeffs[i])
        if v == 0:
            continue
        if i == 0:
            term = str(v)
        elif i == 1:
            term = "x" if v == 1 else f"{v}*x"
        else:
            term = f"x^{i}" if v == 1 else f"{v}*x^{i}"
        parts.append(term)
    return f"{' + '.join(parts) if parts else '0'} mod Z_{q}/(X^{n}+1)"
