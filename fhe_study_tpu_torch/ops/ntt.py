"""Negacyclic NTT (Cooley-Tukey forward, Gentleman-Sande inverse): the
multi-prime transforms over RNS residues and the single-prime transform of
the torus code — the ported subset of fhe_study_tpu/ops/ntt.py.

The root tables are computed on the host with numpy (powers by doubling,
exact modular products) and cached, bit-reversed exactly as the reference
stores them, so every butterfly — and every intermediate value — matches
the JAX package bit for bit.

Residue tensors are int32 [L, ..., n], row i modulo qs[i].  Each multi-prime
op launches its kernel of ops/ntt_cuda.py exactly where the reference
launches its Pallas kernel (``multi_gate`` on its primes and n, and for the
three key-switch ops keys of [R, Lp, n]) and its tensors lie on the card
(ops/_cuda.on_cuda); everywhere else it runs its plain PyTorch version on
the tensors' own device, the counterpart of the reference's XLA path.
Names and return contracts are the reference's.

The single-prime ``ntt`` / ``intt`` / ``negacyclic_mul`` take int64 [..., n]
values in [0, q), any q < 2^63, and return the same, like the reference's
u64 functions.  They launch K9 on the card exactly where the reference
launches its Pallas kernel (``k9_gate``); elsewhere both devices run the
reference's stage loop on the wide modular product of ops/modops.py.  The
cyclic transforms (``ntt_cyclic``, the four-step building block) and the
exact integer products by CRT (``polymul_i64_crt``,
``negacyclic_conv_crt_u64``) sit on them.
"""

from functools import lru_cache

import numpy as np
import torch

from . import _cuda, modops, ntt_cuda
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
    """i -> i with its logn bits reversed, by doubling: the permutation of
    logn + 1 bits is 2 rev followed by 2 rev + 1."""
    rev = np.zeros(1, np.int64)
    for _ in range(logn):
        rev = np.concatenate([2 * rev, 2 * rev + 1])
    return rev


def _powers(w: int, n: int, q: int) -> np.ndarray:
    """w^k mod q for k < n as uint64, by doubling: the block of powers
    [k, 2k) is the block [0, k) times w^k.  The products are exact in
    uint64 for q < 2^32, in Python integers (an object array) above."""
    small = q < (1 << 32)
    out = np.empty(n, np.uint64 if small else object)
    out[0] = 1
    k = 1
    while k < n:
        step = pow(w, k, q)
        out[k:2 * k] = (out[:k] * np.uint64(step) % np.uint64(q) if small
                        else out[:k] * step % q)
        k *= 2
    return out.astype(np.uint64)


class NttPlan:
    """Tables for a negacyclic NTT over Z_q[X]/(X^n+1): ``roots[i]`` =
    w^bitrev(i) and ``roots_inv[i]`` = w^-bitrev(i) for a primitive 2n-th
    root w (numpy uint64, like the reference's plan).  Built with numpy in
    O(n) vector work, bit for bit the tables of a loop over n (which took
    about a minute at n = 2^26)."""

    def __init__(self, q: int, n: int):
        assert n & (n - 1) == 0, "n must be a power of two"
        self.q = q
        self.n = n
        self.log_n = n.bit_length() - 1
        w = _primitive_root_of_unity(q, 2 * n)
        rev = _bit_reverse_perm(self.log_n)
        self.root = w
        self.roots = _powers(w, n, q)[rev]
        self.roots_inv = _powers(pow(w, q - 2, q), n, q)[rev]
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


def k9_gate(q: int, n: int) -> bool:
    """Whether the reference sends a single-prime transform to its Pallas
    kernel (``_pallas_ok`` of fhe_study_tpu/ops/ntt.py): q < 2^31 and n a
    multiple of 128.  The port launches K9 there, at every n up to 2^26,
    the largest degree at which a prime of either package has its 2n-th
    roots (past 2^15 across blocks: ops/ntt_cuda.py::ntt_kernel)."""
    return q < (1 << 31) and n >= 128 and n % 128 == 0


def multi_gate(primes, n: int) -> bool:
    """Whether the reference sends a multi-prime op over ``primes`` at ring
    degree n to its Pallas kernel: n > 1 and ``_pallas_ok`` (``k9_gate``)
    for every prime.  The port launches the op's kernel there; elsewhere
    (n < 128 above all) both devices run the plain version."""
    return n > 1 and all(k9_gate(q, n) for q in primes)


def _launches(primes, n: int, *tensors) -> bool:
    """A multi-prime op's rule: its kernel where its tensors lie on the card
    and the gate holds, its plain version everywhere else.  Inside the gate
    a kernel that fails to build or launch raises."""
    return _cuda.on_cuda(*tensors) and multi_gate(primes, n)


@lru_cache(maxsize=None)
def _stage_roots(q: int, n: int, inverse: bool, device) -> torch.Tensor:
    plan = get_plan(q, n)
    return torch.from_numpy((plan.roots_inv if inverse else plan.roots)
                            .astype(np.int64)).to(device)


def _stage_loop(a, q: int, inverse: bool):
    """The reference's XLA stage loop on int64 [..., n] with the modular
    product of ops/modops.py (any q < 2^63); the inverse times n^-1."""
    plan = get_plan(q, a.shape[-1])
    roots = _stage_roots(q, a.shape[-1], inverse, a.device)
    n, batch = a.shape[-1], tuple(a.shape[:-1])
    r = a
    t, m = (1, n // 2) if inverse else (n // 2, 1)
    while (m > 0) if inverse else (m < n):
        r = r.reshape(batch + (m, 2, t))
        u, v = r[..., 0, :], r[..., 1, :]
        s = roots[m:2 * m, None]
        if inverse:
            r = torch.stack([modops.addmod(u, v, q),
                             modops.mulmod(modops.submod(u, v, q), s, q)], -2)
            t, m = t * 2, m // 2
        else:
            v = modops.mulmod(v, s, q)
            r = torch.stack([modops.addmod(u, v, q),
                             modops.submod(u, v, q)], -2)
            t, m = t // 2, m * 2
    r = r.reshape(a.shape)
    return modops.mulmod(r, plan.n_inv, q) if inverse else r


def _single(a, q: int, inverse: bool):
    n = a.shape[-1]
    if n == 1:
        return a
    if k9_gate(q, n) and _cuda.on_cuda(a):
        # raises outside K9's range (2^7 .. 2^26), as every kernel does
        return ntt_cuda.ntt_kernel(a.contiguous(), q, inverse=inverse)
    # Everywhere else the plain stage loop: K9's plain version on the CPU,
    # and outside the gate, where the reference runs XLA's stage loop, the
    # counterpart on both devices, not a fallback: the rule is fixed by
    # (q, n) and the device, never by an error.
    return _stage_loop(a.long(), q, inverse)


def ntt(a, q: int):
    """Forward negacyclic NTT over the last axis; a int64 [..., n] in
    [0, q)."""
    return _single(a, q, False)


def intt(a, q: int):
    """Inverse negacyclic NTT over the last axis, times n^-1."""
    return _single(a, q, True)


def negacyclic_mul(a, b, q: int):
    """Polynomial product in Z_q[X]/(X^n+1): NTT, pointwise, INTT."""
    return intt(modops.mulmod(ntt(a, q), ntt(b, q), q), q)


def crt_lift_centered(r1, r2, p1: int, p2: int):
    """The integer in (-p1*p2/2, p1*p2/2] with residues r1 mod p1 and r2 mod
    p2 (Garner), as int64 (p1*p2 < 2^62).  Every value is below 2^62, so the
    signed compare is the reference's unsigned one."""
    g = garner(r1, r2, p1, p2)
    m = p1 * p2
    return torch.where(g > m // 2, g - m, g)


def garner(r1, r2, p1: int, p2: int):
    """The integer in [0, p1*p2) with residues r1 mod p1 and r2 mod p2."""
    delta = (r2 - r1 % p2) % p2 * pow(p1, -1, p2) % p2
    return r1 + p1 * delta


def mulmod_v(a, b, qv):
    """(a * b) mod q, exact in int64 (a, b < 2^31)."""
    return ((a.long() * b.long()) % qv).int()


def _transform(a, qs: tuple, inverse: bool, fin):
    if a.shape[0] != len(qs):
        raise ValueError(f"{a.shape[0]} residue rows for {len(qs)} primes")
    fn = (ntt_cuda.ntt_multi_kernel if _launches(qs, a.shape[-1], a)
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
    fn = (ntt_cuda.tensor_eval4_kernel
          if _launches(dst, x0.shape[-1], x0, x1, y0, y1)
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
    fn = (ntt_cuda.tensor_mul4_kernel
          if _launches(tuple(dst) + tuple(src or ()), x0.shape[-1], x0, x1,
                       y0, y1)
          else ntt_cuda.tensor_mul4_plain)
    return fn(x0, x1, y0, y1, dst, scale=scale, src=src)


def tensor_mul_multi(x4, qs: tuple, scale: tuple | None = None):
    """tensor_mul4 on one stacked operand x4 [L, ..., 4, n] holding
    (x0, x1, y0, y1); returns [L, ..., 3, n]."""
    if x4.shape[-2] != 4 or x4.shape[0] != len(qs):
        raise ValueError(f"x4 has shape {tuple(x4.shape)} for {len(qs)} "
                         "primes; need [L, ..., 4, n]")
    fn = (ntt_cuda.tensor_mul_kernel if _launches(qs, x4.shape[-1], x4)
          else ntt_cuda.tensor_mul_plain)
    return fn(x4, qs, scale=scale)


def ext_ntt(x, src: tuple, dst: tuple):
    """x [Ls, ..., P, n] coefficient residues over src -> [Ld, ..., P, n]
    canonical eval residues over dst: unsigned HPS extension fused with the
    forward transforms."""
    fn = (ntt_cuda.ext_ntt_kernel
          if _launches(tuple(dst) + tuple(src), x.shape[-1], x)
          else ntt_cuda.ext_ntt_plain)
    return fn(x, src, dst)


def ks_contract_multi(edm, kb, ka, primes: tuple):
    """Key-switch contraction on hoisted digits: edm [R, Lp, ..., n]
    Montgomery-lifted eval digits, kb/ka [R, Lp, n] eval-domain key rows.
    Returns (r0, r1), each [Lp, ..., n]: r = INTT(sum_i edm_i * k_i)."""
    fn = (ntt_cuda.ks_contract_kernel
          if _launches(primes, edm.shape[-1], edm, kb, ka) and kb.ndim == 3
          else ntt_cuda.ks_contract_plain)
    return fn(edm, kb, ka, primes)


def ks_fused_multi(c_limbs, kb, ka, primes: tuple, src_primes: tuple):
    """Gadget key switch from limb residues: c_limbs [R, ..., n] (row i below
    src_primes[i]), kb/ka [R, Lp, n] eval-domain key rows.  Returns (r0, r1),
    each [Lp, ..., n] coefficient domain:
    r = INTT(sum_i NTT([c_i] mod p_j) * k_ij)."""
    fn = (ntt_cuda.ks_fused_kernel
          if _launches(primes, c_limbs.shape[-1], c_limbs, kb, ka)
          and kb.ndim == 3
          else ntt_cuda.ks_fused_plain)
    return fn(c_limbs, kb, ka, primes, src_primes)


def ks_fused_eval(c_limbs, kb, ka, primes: tuple, src_primes: tuple, adds):
    """Eval-resident gadget key switch: as ks_fused_multi, plus adds =
    (c0, c1) coefficient-domain [Lp, ..., n].  Returns (e0, e1, r0, r1):
    e = NTT(c) + sum_i NTT(d_i) * k_i (eval domain), r = INTT(e)."""
    fn = (ntt_cuda.ks_fused_eval_kernel
          if _launches(primes, c_limbs.shape[-1], c_limbs, kb, ka, *adds)
          and kb.ndim == 3
          else ntt_cuda.ks_fused_eval_plain)
    return fn(c_limbs, kb, ka, primes, src_primes, adds)


# -- the cyclic NTT, natural order (the four-step NTT's building block: the
# negacyclic transform is a psi twist and a cyclic transform) --------------

class CyclicPlan:
    """Tables of a natural-order iterative cyclic NTT of size n over Z_q:
    stage s (length 2^(s+1)) multiplies by w^((n / 2^(s+1)) j), j < 2^s."""

    def __init__(self, q: int, n: int, w: int | None = None):
        assert n & (n - 1) == 0, "n must be a power of two"
        self.q, self.n = q, n
        self.w = w if w is not None else _primitive_root_of_unity(q, n)
        logn = n.bit_length() - 1
        self.bitrev = _bit_reverse_perm(logn)
        w_inv = pow(self.w, q - 2, q)
        self.tw, self.tw_inv = (
            [np.array([pow(r, (n >> (s + 1)) * j, q) for j in range(1 << s)],
                      np.uint64) for s in range(logn)]
            for r in (self.w, w_inv))
        self.n_inv = pow(n, q - 2, q)


@lru_cache(maxsize=None)
def get_cyclic_plan(q: int, n: int, w: int | None = None) -> CyclicPlan:
    """w: an explicit n-th root (the four-step decomposition needs the inner
    transforms on powers of the outer root)."""
    return CyclicPlan(q, n, w)


def _ntt_cyclic_stages(a, q: int, tws):
    """Iterative DIT on bit-reversed input, natural-order output."""
    n, batch = a.shape[-1], tuple(a.shape[:-1])
    r = a
    for s in range(n.bit_length() - 1):
        half = 1 << s
        r = r.reshape(batch + (n // (2 * half), 2, half))
        u = r[..., 0, :]
        tw = torch.from_numpy(tws[s].astype(np.int64)).to(a.device)
        v = modops.mulmod(r[..., 1, :], tw, q)
        r = torch.stack([modops.addmod(u, v, q), modops.submod(u, v, q)],
                        -2).reshape(batch + (n // (2 * half), 2 * half))
    return r.reshape(a.shape)


def ntt_cyclic(a, q: int, w: int | None = None):
    """Cyclic DFT over Z_q in natural index order (the points of X^n - 1);
    a int64 [..., n] in [0, q).  Plain torch on every device: the
    reference has no kernel for it."""
    n = a.shape[-1]
    if n == 1:
        return a
    plan = get_cyclic_plan(q, n, w)
    return _ntt_cyclic_stages(a[..., torch.from_numpy(plan.bitrev)], q,
                              plan.tw)


def intt_cyclic(a, q: int, w: int | None = None):
    """The inverse of ntt_cyclic, times n^-1."""
    n = a.shape[-1]
    if n == 1:
        return a
    plan = get_cyclic_plan(q, n, w)
    r = _ntt_cyclic_stages(a[..., torch.from_numpy(plan.bitrev)], q,
                           plan.tw_inv)
    return modops.mulmod(r, plan.n_inv, q)


# -- exact integer negacyclic products by CRT over CRT_PRIMES[:2] ------------

def negacyclic_conv_crt_u64(a, b, num_primes: int = 2):
    """Exact negacyclic convolution of non-negative u64 values (int64 bits)
    whose result lies in [0, p1 p2); returns int64."""
    if num_primes != 2:
        raise ValueError("the CRT convolution takes two primes")
    p1, p2 = CRT_PRIMES[:2]
    r1 = negacyclic_mul(modops.coerce_u64(a, p1), modops.coerce_u64(b, p1),
                        p1)
    r2 = negacyclic_mul(modops.coerce_u64(a, p2), modops.coerce_u64(b, p2),
                        p2)
    return garner(r1, r2, p1, p2)


def polymul_i64_crt(a, b):
    """Exact negacyclic product of signed int64 coefficient tensors by the
    2-prime CRT; |c_k| < p1 p2 / 2 ~ 2^60.7 is the caller's.  Returns int64,
    centered."""
    p1, p2 = CRT_PRIMES[:2]
    r1 = negacyclic_mul(modops.coerce_i64(a, p1), modops.coerce_i64(b, p1),
                        p1)
    r2 = negacyclic_mul(modops.coerce_i64(a, p2), modops.coerce_i64(b, p2),
                        p2)
    return crt_lift_centered(r1, r2, p1, p2)
