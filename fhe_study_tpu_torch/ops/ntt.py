"""Negacyclic NTT (Cooley-Tukey forward, Gentleman-Sande inverse): the
multi-prime transforms over RNS residues and the single-prime transform of
the torus code — the ported subset of fhe_study_tpu/ops/ntt.py.

The root tables are computed on the host with Python integers and cached,
bit-reversed exactly as the reference stores them, so every butterfly — and
every intermediate value — matches the JAX package bit for bit.

Residue tensors are int32 [L, ..., n], row i modulo qs[i].  Each transform
dispatches by the device of its inputs (ops/_cuda.on_cuda): CUDA tensors
launch the kernels of ops/ntt_cuda.py, CPU tensors run their plain PyTorch
versions there.  Names and return contracts are the reference's.

The single-prime ``ntt`` / ``intt`` / ``negacyclic_mul`` take int64 [..., n]
values in [0, q) and return the same, like the reference's u64 functions.
"""

from functools import lru_cache

import numpy as np
import torch

from . import _cuda, ntt_cuda
from .modops32 import (addmod as _addmod_v, qvec as _qvec,  # noqa: F401
                       submod as _submod_v)


def _primitive_root_of_unity(q: int, m: int) -> int:
    """Smallest-k primitive m-th root of unity (Pornin's method, as the
    reference): w = k^((q-1)/m), accepted if w^(m/2) != 1."""
    assert (q - 1) % m == 0, f"q={q} is not NTT-friendly for m={m}"
    for k in range(1, q):
        w = pow(k, (q - 1) // m, q)
        if pow(w, m // 2, q) != 1:
            return w
    raise ValueError("no primitive root of unity")


def _bit_reverse_perm(logn: int) -> np.ndarray:
    idx = np.arange(1 << logn)
    rev = np.zeros_like(idx)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


class NttPlan:
    """Tables for a negacyclic NTT over Z_q[X]/(X^n+1): ``roots[i]`` =
    w^bitrev(i) and ``roots_inv[i]`` = w^-bitrev(i) for a primitive 2n-th
    root w (numpy uint64, like the reference's plan)."""

    def __init__(self, q: int, n: int):
        assert n & (n - 1) == 0, "n must be a power of two"
        self.q = q
        self.n = n
        self.log_n = n.bit_length() - 1
        w = _primitive_root_of_unity(q, 2 * n)
        w_inv = pow(w, q - 2, q)
        pw, pw_inv = [1] * n, [1] * n
        for k in range(1, n):
            pw[k] = pw[k - 1] * w % q
            pw_inv[k] = pw_inv[k - 1] * w_inv % q
        rev = _bit_reverse_perm(self.log_n)
        self.root = w
        self.roots = np.array(pw, np.uint64)[rev]
        self.roots_inv = np.array(pw_inv, np.uint64)[rev]
        self.n_inv = pow(n, q - 2, q)


@lru_cache(maxsize=None)
def get_plan(q: int, n: int) -> NttPlan:
    return NttPlan(q, n)


# NTT-friendly primes p = 1 (mod 2^27) for exact integer convolutions by CRT
# (n up to 2^26); the first two are above 2^30.
CRT_PRIMES = (2013265921, 1811939329, 469762049)

# The pair below 2^30 of the TFHE eval-domain path (tggsw's pre-transformed
# keys and the blind-rotation kernel).  Capacity p1*p2/2 ~ 2^58.4, so the
# convolution bound is (K+1)*l*n*beta < 2^26.
CRT_PRIMES_TFHE = (998244353, 754974721)


def _single(a, q: int, inverse: bool):
    if a.shape[-1] == 1:
        return a
    if _cuda.on_cuda(a):
        # raises for q >= 2^31 or n outside 2^8 .. 2^14, as every kernel does
        return ntt_cuda.ntt_kernel(a.contiguous(), q, inverse=inverse)
    return ntt_cuda.ntt_plain(a, q, inverse=inverse)


def ntt(a, q: int):
    """Forward negacyclic NTT over the last axis; a int64 [..., n] in
    [0, q)."""
    return _single(a, q, False)


def intt(a, q: int):
    """Inverse negacyclic NTT over the last axis, times n^-1."""
    return _single(a, q, True)


def negacyclic_mul(a, b, q: int):
    """Polynomial product in Z_q[X]/(X^n+1): NTT, pointwise, INTT."""
    return intt(ntt(a, q) * ntt(b, q) % q, q)


def crt_lift_centered(r1, r2, p1: int, p2: int):
    """The integer in (-p1*p2/2, p1*p2/2] with residues r1 mod p1 and r2 mod
    p2 (Garner), as int64 (p1*p2 < 2^62).  Every value is below 2^62, so the
    signed compare is the reference's unsigned one."""
    inv = pow(p1, -1, p2)
    delta = (r2 - r1 % p2) % p2 * inv % p2
    g = r1 + p1 * delta                       # in [0, p1*p2)
    m = p1 * p2
    return torch.where(g > m // 2, g - m, g)


def mulmod_v(a, b, qv):
    """(a * b) mod q, exact in int64 (a, b < 2^31)."""
    return ((a.long() * b.long()) % qv).int()


def _transform(a, qs: tuple, inverse: bool, fin):
    if a.shape[0] != len(qs):
        raise ValueError(f"{a.shape[0]} residue rows for {len(qs)} primes")
    fn = (ntt_cuda.ntt_multi_kernel if _cuda.on_cuda(a)
          else ntt_cuda.ntt_multi_plain)
    return fn(a, qs, inverse=inverse, fin=fin)


def ntt_multi(a, qs: tuple, mont: bool = False):
    """Forward negacyclic NTT per prime: a [L, ..., n] -> same, row i mod
    qs[i].  mont=True returns the Montgomery lift x * 2^32 mod q (folded into
    the kernel's final multiply)."""
    fin = tuple((1 << 32) % q for q in qs) if mont else None
    return _transform(a, qs, False, fin)


def intt_multi(a, qs: tuple, scale: tuple | None = None):
    """Inverse negacyclic NTT per prime, times n^-1 and the optional
    per-prime ``scale`` (folded into one final multiply)."""
    n = a.shape[-1]
    fin = tuple(pow(n, -1, q) * (1 if scale is None else int(s)) % q
                for q, s in zip(qs, scale or (1,) * len(qs)))
    return _transform(a, qs, True, fin)


def tensor_eval4(x0, x1, y0, y1, dst: tuple, scale: tuple | None = None):
    """Degree-2 tensor of EVAL-domain operands ([Ld, ..., n] canonical NTT
    residues): returns [Ld, ..., 3, n] coefficient-domain
    scale * (x0y0, x0y1 + x1y0, x1y1)."""
    fn = (ntt_cuda.tensor_eval4_kernel if _cuda.on_cuda(x0, x1, y0, y1)
          else ntt_cuda.tensor_eval4_plain)
    return fn(x0, x1, y0, y1, dst, scale=scale)


def tensor_mul4(x0, x1, y0, y1, dst: tuple, scale: tuple | None = None,
                src: tuple | None = None):
    """Degree-2 tensor of four separate COEFFICIENT-domain operands:
    returns [Ld, ..., 3, n] coefficient-domain
    scale * (x0y0, x0y1 + x1y0, x1y1).  Without ``src`` the operands are
    [Ld, ..., n] residues mod dst; with it they are [Ls, ..., n] over ``src``
    and the unsigned HPS extension src -> dst runs first (inside the kernel
    on the card)."""
    fn = (ntt_cuda.tensor_mul4_kernel if _cuda.on_cuda(x0, x1, y0, y1)
          else ntt_cuda.tensor_mul4_plain)
    return fn(x0, x1, y0, y1, dst, scale=scale, src=src)


def tensor_mul_multi(x4, qs: tuple, scale: tuple | None = None):
    """tensor_mul4 on one stacked operand x4 [L, ..., 4, n] holding
    (x0, x1, y0, y1); returns [L, ..., 3, n]."""
    if x4.shape[-2] != 4 or x4.shape[0] != len(qs):
        raise ValueError(f"x4 has shape {tuple(x4.shape)} for {len(qs)} "
                         "primes; need [L, ..., 4, n]")
    fn = (ntt_cuda.tensor_mul_kernel if _cuda.on_cuda(x4)
          else ntt_cuda.tensor_mul_plain)
    return fn(x4, qs, scale=scale)


def ext_ntt(x, src: tuple, dst: tuple):
    """x [Ls, ..., P, n] coefficient residues over src -> [Ld, ..., P, n]
    canonical eval residues over dst: unsigned HPS extension fused with the
    forward transforms."""
    fn = (ntt_cuda.ext_ntt_kernel if _cuda.on_cuda(x)
          else ntt_cuda.ext_ntt_plain)
    return fn(x, src, dst)


def ks_contract_multi(edm, kb, ka, primes: tuple):
    """Key-switch contraction on hoisted digits: edm [R, Lp, ..., n]
    Montgomery-lifted eval digits, kb/ka [R, Lp, n] eval-domain key rows.
    Returns (r0, r1), each [Lp, ..., n]: r = INTT(sum_i edm_i * k_i)."""
    fn = (ntt_cuda.ks_contract_kernel if _cuda.on_cuda(edm, kb, ka)
          else ntt_cuda.ks_contract_plain)
    return fn(edm, kb, ka, primes)


def ks_fused_multi(c_limbs, kb, ka, primes: tuple, src_primes: tuple):
    """Gadget key switch from limb residues: c_limbs [R, ..., n] (row i below
    src_primes[i]), kb/ka [R, Lp, n] eval-domain key rows.  Returns (r0, r1),
    each [Lp, ..., n] coefficient domain:
    r = INTT(sum_i NTT([c_i] mod p_j) * k_ij)."""
    fn = (ntt_cuda.ks_fused_kernel if _cuda.on_cuda(c_limbs, kb, ka)
          else ntt_cuda.ks_fused_plain)
    return fn(c_limbs, kb, ka, primes, src_primes)


def ks_fused_eval(c_limbs, kb, ka, primes: tuple, src_primes: tuple, adds):
    """Eval-resident gadget key switch: as ks_fused_multi, plus adds =
    (c0, c1) coefficient-domain [Lp, ..., n].  Returns (e0, e1, r0, r1):
    e = NTT(c) + sum_i NTT(d_i) * k_i (eval domain), r = INTT(e)."""
    fn = (ntt_cuda.ks_fused_eval_kernel
          if _cuda.on_cuda(c_limbs, kb, ka, *adds)
          else ntt_cuda.ks_fused_eval_plain)
    return fn(c_limbs, kb, ka, primes, src_primes, adds)
