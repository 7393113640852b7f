"""Homomorphic polynomial evaluation for RNS-CKKS — the counterpart of
fhe_study_tpu/models/ckks/poly.py.

Machinery: binary-decomposition power ladder (depth log2(deg)), level
alignment by LIMB TRUNCATION (dropping residues preserves both value and
scale while the phase stays under the smaller Q: no division involved),
per-level relinearization keys (the RNS gadget is defined with respect to
the current basis product, so each level gets its own key rows), and a final
constant fold that brings every monomial term to one common (level, scale)
before a single add + rescale.

Scale bookkeeping is exact-float, with the reference's own expressions:
Param.delta tracks the live scale; the final fold multiplies each term by
c_k * (target/actual) at plaintext scale q_drop, so all terms align.
Constants are encoded on the ciphertext's device; every multiply is
``ckks_rns.mul_hybrid`` (or ``mul_hybrid2``), so the kernels are those of
that module.
"""

from fractions import Fraction

import numpy as np
import torch

from ...ops.ntt import _addmod_v, _qvec
from ...utils import prng
from ..bfv_rns import _bcast_mid, _to_residues
from . import ckks_rns, encoder_device


def level_drop(param, ct, L2: int):
    """Truncate to L2 limbs: value mod Q_{L2}, scale unchanged (valid while
    the phase < Q_{L2}/2, always true for decryptable ciphertexts)."""
    if L2 > param.L:
        raise ValueError(f"cannot drop {param.L} limbs to {L2}")
    p2 = ckks_rns.Param(n=param.n, L=L2, delta=param.delta,
                        prime_bits=param.prime_bits)
    return ckks_rns.CT(ct.c0[:L2], ct.c1[:L2]), p2


def rlk_keys_all_levels(gen: prng.Gen, param, sk, min_L: int = 2,
                        K: int = 2) -> dict:
    """HYBRID relinearization keys for every level L in [min_L, param.L]
    (the RNS gadget is basis-dependent; the dropped primes above each level
    serve as that level's special modulus P), drawn from ``gen`` level by
    level."""
    out = {}
    for L in range(min_L, param.L + 1):
        pL = ckks_rns.Param(n=param.n, L=L, delta=param.delta,
                            prime_bits=param.prime_bits)
        out[L] = ckks_rns.hybrid_rlk(gen, pL,
                                     ckks_rns.SecretKey(sk.s_evals[:L]), K=K)
    return out


def mul_ct(rlks: dict, x, px, y, py):
    """x*y with automatic level alignment; returns (ct, param)."""
    L = min(px.L, py.L)
    x, px = level_drop(px, x, L)
    y, py = level_drop(py, y, L)
    pin = ckks_rns.Param(n=px.n, L=L, delta=px.delta, prime_bits=px.prime_bits)
    ct, pout = ckks_rns.mul_hybrid(pin, rlks[L], x, y)
    # mul_hybrid assumed both inputs at pin.delta; correct for py.delta
    pout = ckks_rns.Param(n=px.n, L=pout.L,
                          delta=px.delta * py.delta / pin.qs[-1],
                          prime_bits=px.prime_bits)
    return ct, pout


def _encode_const(param, c, scale: float, device):
    half = param.n // 2
    vec = np.full(half, c, np.complex128)
    m = encoder_device.encode(torch.from_numpy(vec.real.copy()).to(device),
                              torch.from_numpy(vec.imag.copy()).to(device),
                              param.n, scale)
    return _to_residues(m, param.qs)


def _encode_const_exact(param, c: float, scale_int, device):
    """REAL constant c at an exact integer scale, residues computed in
    arbitrary-precision Python integers.  A real constant's canonical
    embedding is the constant polynomial, so no FFT is involved: the only
    way to encode at scales above 2^62 (float64 rounding would inject an
    absolute error of ~2^(log2 v - 53), int64 coefficients would
    overflow).  Returns int32 [L, n]."""
    v = Fraction(c) * scale_int
    m_int = int(v + Fraction(1, 2)) if v >= 0 else -int(-v + Fraction(1, 2))
    out = torch.zeros((param.L, param.n), dtype=torch.int32, device=device)
    out[:, 0] = torch.tensor([m_int % q for q in param.qs],
                             dtype=torch.int32, device=device)
    return out


def add_pt_const(param, ct, c):
    """ct + constant (encoded at the ciphertext's live scale); ct may carry
    batch axes (the [L, n] plaintext broadcasts through the middle).

    Scales above ~2^52 take the exact big-integer path: the live scale
    drifts upward through mul_ct2 chains, and by ~14 multiply levels it
    crosses 2^63, where the float64 encode would overflow int64."""
    device = ct.c0.device
    if float(param.delta) > 2.0 ** 52:
        if float(np.imag(c)) != 0.0:
            raise ValueError("the exact constant path is real-only")
        m = _encode_const_exact(param, float(np.real(c)),
                                Fraction(float(param.delta)), device)
    else:
        m = _encode_const(param, c, param.delta, device)
    qv = _qvec(param.qs, ct.c0.ndim, device)
    m = _bcast_mid(m, ct.c0.ndim)
    return ckks_rns.CT(_addmod_v(ct.c0, m, qv), ct.c1)


def mul_ct2(rlks: dict, x, px, y, py):
    """x*y with level alignment, rescaling by TWO primes (the double-prime
    high-precision pipeline, ckks_rns.mul_hybrid2): the scale stays
    stationary at delta ~= q_i*q_j ~= 2^60.  Returns (ct, param)."""
    L = min(px.L, py.L)
    x, px = level_drop(px, x, L)
    y, py = level_drop(py, y, L)
    pin = ckks_rns.Param(n=px.n, L=L, delta=px.delta, prime_bits=px.prime_bits)
    ct, pout = ckks_rns.mul_hybrid2(pin, rlks[L], x, y)
    pout = ckks_rns.Param(n=px.n, L=pout.L,
                          delta=px.delta * py.delta
                          / (float(pin.qs[-1]) * float(pin.qs[-2])),
                          prime_bits=px.prime_bits)
    return ct, pout


def powers(rlks: dict, ct, param, ks: set, mul=mul_ct) -> dict:
    """{k: (ct, param)} for every k in ks (binary decomposition, memoized)."""
    memo = {1: (ct, param)}
    for k in sorted(ks):
        _power(memo, rlks, mul, k)
    return memo


def _power(memo: dict, rlks: dict, mul, k: int):
    # a module function, not a closure that calls itself: such a closure is
    # a reference cycle, which would hold rlks and every power until Python's
    # cyclic collector runs
    if k not in memo:
        hi = 1 << (k.bit_length() - 1)
        if hi == k:
            a, pa = _power(memo, rlks, mul, k // 2)
            memo[k] = mul(rlks, a, pa, a, pa)
        else:
            a, pa = _power(memo, rlks, mul, hi)
            b, pb = _power(memo, rlks, mul, k - hi)
            memo[k] = mul(rlks, a, pa, b, pb)
    return memo[k]


def _nonconstant(coeffs) -> set:
    ks = {k for k in range(1, len(coeffs)) if coeffs[k] != 0}
    if not ks:
        raise ValueError("need at least one non-constant term")
    return ks


def poly_eval(rlks: dict, ct, param, coeffs):
    """sum_k coeffs[k] * ct^k (complex coefficients, degree = len-1).

    Every term is brought to one common level and target scale (the input
    scale) by a plaintext constant multiply at scale q_drop, then summed
    and rescaled once.  Consumes depth(deg) + 1 levels."""
    coeffs = list(coeffs)
    ks = _nonconstant(coeffs)
    pw = powers(rlks, ct, param, ks)
    Lmin = min(pw[k][1].L for k in ks)
    target = param.delta                     # output scale
    q_drop = None
    terms = []
    for k in ks:
        x, px = level_drop(pw[k][1], pw[k][0], Lmin)
        if q_drop is None:
            q_drop = float(px.qs[-1])
        # fold coefficient AND scale correction into one plaintext constant
        c = coeffs[k] * (target / px.delta)
        m = _encode_const(px, c, q_drop, x.c0.device)
        terms.append(ckks_rns.mul_pt(px, x, m))
    pL = ckks_rns.Param(n=param.n, L=Lmin, delta=target * q_drop,
                        prime_bits=param.prime_bits)
    acc = terms[0]
    for t in terms[1:]:
        acc = ckks_rns.add(pL, acc, t)
    if coeffs[0] != 0:
        acc = add_pt_const(pL, acc, coeffs[0])
    out, _ = ckks_rns.rescale(pL, acc)
    pout = ckks_rns.Param(n=param.n, L=Lmin - 1,
                          delta=target * q_drop / pL.qs[-1],
                          prime_bits=param.prime_bits)
    return out, pout


def poly_eval2(rlks: dict, ct, param, coeffs):
    """poly_eval at DOUBLE-PRIME scales: ct multiplies through mul_ct2 (two
    primes dropped per level), the constant fold runs at the exact integer
    two-prime scale q_{L-1}*q_{L-2} (encoded in arbitrary precision), and
    the degree-0 term is added AFTER the final rescale so that its encoding
    scale stays ~delta.  Real coefficients only.  Consumes
    2*(depth(deg)+1) limbs."""
    coeffs = [float(c) for c in coeffs]
    ks = _nonconstant(coeffs)
    pw = powers(rlks, ct, param, ks, mul=mul_ct2)
    Lmin = min(pw[k][1].L for k in ks)
    target = param.delta                     # output scale
    q_drop_int = None
    terms = []
    for k in ks:
        x, px = level_drop(pw[k][1], pw[k][0], Lmin)
        if q_drop_int is None:
            q_drop_int = int(px.qs[-1]) * int(px.qs[-2])
        c = coeffs[k] * (target / px.delta)
        m = _encode_const_exact(px, c, q_drop_int, x.c0.device)
        terms.append(ckks_rns.mul_pt(px, x, m))
    pL = ckks_rns.Param(n=param.n, L=Lmin, delta=target * float(q_drop_int),
                        prime_bits=param.prime_bits)
    acc = terms[0]
    for t in terms[1:]:
        acc = ckks_rns.add(pL, acc, t)
    out, _ = ckks_rns.rescale2(pL, acc)
    pout = ckks_rns.Param(n=param.n, L=Lmin - 2, delta=target,
                          prime_bits=param.prime_bits)
    if coeffs[0] != 0:
        out = add_pt_const(pout, out, coeffs[0])
    return out, pout
