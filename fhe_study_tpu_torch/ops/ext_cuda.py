"""RNS fast base extension (HPS conversion): the CUDA kernels of
``csrc/ext_cuda.cu`` beside their plain PyTorch versions — K4, the
counterpart of fhe_study_tpu/ops/ext_pallas.py::base_extend_fused, and K11,
that of ::base_extend_sum (the last line below alone, from given ys and
alpha).

For every coefficient, with S = prod(src):
  y_i   = x_i * (S/s_i)^-1 mod s_i
  alpha = (sum_i y_i * floor(2^59/s_i) [+ 2^58 when centered]) >> 59
  out_j = sum_i y_i * (S/s_i) - alpha * S  (mod d_j)
and, with (w, sub_mul), out_j = (w_j - out_j) * sub_mul[j] mod d_j.

alpha is the reference's 2^59 fixed point (fhe_study_tpu/models/bfv_rns.py
explains its exactness margins), never a float: at a boundary a float could
pick another alpha than the reference.  Each term y_i * floor(2^59/s_i) is
below 2^59, so the sum (plus 2^58 when centered) stays below 2^64 for up to
31 source primes, the reference's own bound: the plain version adds in int64,
which wraps as u64 does, and takes bits 59 .. 63 of the result.

The host tables ``_hat_inv`` and ``_ext_table`` are the counterparts of the
reference's ``bfv_rns._hat_inv_mont`` and ``bfv_rns._ext_table``: the plain
version uses them as they are, the kernel reads them packed with their Shoup
companions (no Montgomery lift is needed in either).
"""

from functools import lru_cache
from math import prod

import numpy as np
import torch

from . import _cuda
from .modops32 import qvec

MAX_SRC = 31


def _check_src(src: tuple) -> None:
    if not 1 <= len(src) <= MAX_SRC:
        raise ValueError(f"source basis of {len(src)} primes: the 2^59 "
                         f"fixed-point alpha needs 1 .. {MAX_SRC}")


@lru_cache(maxsize=None)
def _hat_inv(src: tuple) -> tuple:
    """(S/s_i)^-1 mod s_i for each source prime."""
    S = prod(src)
    return tuple(pow((S // s) % s, -1, s) for s in src)


@lru_cache(maxsize=None)
def _ext_table(src: tuple, dst: tuple) -> tuple:
    """(tab, smod): tab[i][j] = (S/s_i) mod d_j and smod[j] = S mod d_j."""
    S = prod(src)
    tab = tuple(tuple((S // s) % d for d in dst) for s in src)
    return tab, tuple(S % d for d in dst)


def _shoup(w: int, q: int) -> list:
    return [w, (w << 32) // q]


@lru_cache(maxsize=None)
def _kernel_table_host(src: tuple, dst: tuple,
                       sub_mul: tuple | None) -> np.ndarray:
    """Kernel constants, uint32, in the layout of csrc/modarith.cuh
    ExtTable: per source prime (s_i, Shoup pair of hat_inv_i, floor(2^59/s_i)
    as lo/hi words), per destination prime (d_j, Shoup pair of S mod d_j,
    Shoup pair of sub_mul[j]), then the Shoup pairs of tab[i][j]."""
    tab, smod = _ext_table(src, dst)
    words = []
    for s, h in zip(src, _hat_inv(src)):
        cfix = (1 << 59) // s
        words += [s, *_shoup(h, s), cfix & 0xFFFFFFFF, cfix >> 32]
    for j, d in enumerate(dst):
        c = 0 if sub_mul is None else int(sub_mul[j]) % d
        words += [d, *_shoup(smod[j], d), *_shoup(c, d)]
    for i in range(len(src)):
        for j, d in enumerate(dst):
            words += _shoup(tab[i][j], d)
    return np.array(words, np.uint64).astype(np.uint32)


@lru_cache(maxsize=None)
def kernel_table(src: tuple, dst: tuple, sub_mul: tuple | None, device):
    host = _kernel_table_host(src, dst, sub_mul)
    return torch.from_numpy(host.view(np.int32)).to(device)


def _check_epilogue(w, sub_mul) -> None:
    if (w is None) != (sub_mul is None):
        raise ValueError("w and sub_mul go together")


def lift_plain(x, src: tuple, centered: bool = False):
    """First half of the conversion, int64: (ys [Ls, ..., n], alpha
    [..., n]) with y_i = x_i * (S/s_i)^-1 mod s_i and alpha the 2^59
    fixed-point quotient (rounded when centered)."""
    _check_src(src)
    dev, nd = x.device, x.ndim
    ys = x.long() * qvec(_hat_inv(src), nd, dev) % qvec(src, nd, dev)
    cfix = qvec([(1 << 59) // s for s in src], nd, dev)
    # a u64 sum in int64 bits: past 2^63 it reads negative, and >> is
    # arithmetic, so the mask keeps bits 59 .. 63 alone
    alpha = ((ys * cfix).sum(0) + ((1 << 58) if centered else 0)) >> 59 & 31
    return ys, alpha


def lift_kernel(x, src: tuple, centered: bool = False):
    """The lift (csrc/ext.cuh's ext_lift_kernel, which K5 and K6 launch
    before their staged layout) alone, on a CUDA int32 x [Ls, ..., n]:
    lift_plain's (ys, alpha) as int32, views of one [Ls + 1, ..., n] tensor
    (its last row alpha), bit for bit.  4 consecutive coefficients a
    thread where n % 4 == 0 and x is 16-byte aligned, one otherwise."""
    _check_src(src)
    dev = x.device
    _cuda.check(x, "x", dev)
    if x.ndim < 2 or x.shape[0] != len(src):
        raise ValueError(f"x has shape {tuple(x.shape)}; need [{len(src)}, "
                         "..., n]")
    out = torch.empty((len(src) + 1,) + x.shape[1:], dtype=torch.int32,
                      device=dev)
    n = x.shape[-1]
    if x.numel() > 0:
        tab = kernel_table(tuple(src), (), None, dev)
        _cuda.EXT_LIFT.launch(dev, x.data_ptr(), out.data_ptr(),
                              tab.data_ptr(), len(src),
                              x.numel() // (len(src) * n), n, int(centered))
    return out[:-1], out[-1]


def base_extend_sum_plain(ys, alpha, src: tuple, dst: tuple):
    """Plain int64 version of the second half: ys [Ls, ..., n] (below s_i),
    alpha [..., n] -> sum_i ys_i * (S/s_i) - alpha * S per dst prime,
    [Ld, ..., n] int32."""
    _check_src(src)
    src, dst = tuple(src), tuple(dst)
    dev, nd = ys.device, ys.ndim
    tab, smod = _ext_table(src, dst)
    dv = qvec(dst, nd, dev)
    ys = ys.long()
    acc = torch.zeros((len(dst),) + ys.shape[1:], dtype=torch.int64,
                      device=dev)
    for i in range(len(src)):
        acc = acc + ys[i] * qvec(tab[i], nd, dev) % dv         # < Ls * d
    return ((acc - alpha.long() * qvec(smod, nd, dev)) % dv).int()


def base_extend_fused_plain(x, src: tuple, dst: tuple, centered: bool = False,
                            w=None, sub_mul: tuple | None = None):
    """Plain int64 version: x [Ls, ..., n] -> [Ld, ..., n] int32."""
    _check_epilogue(w, sub_mul)
    src, dst = tuple(src), tuple(dst)
    ext = base_extend_sum_plain(*lift_plain(x, src, centered), src, dst)
    if sub_mul is not None:
        dv = qvec(dst, x.ndim, x.device)
        c = qvec([int(v) % d for v, d in zip(sub_mul, dst)], x.ndim, x.device)
        ext = ((w.long() - ext) % dv * c % dv).int()
    return ext


EXT_VEC = 4        # kExtVec of csrc/ext_cuda.cu: coefficients a thread (vec)


def _ext_vec(total: int, *tensors) -> bool:
    """Whether K4 (K11) takes its vector form (4 coefficients a thread in
    uint4 words) for ``total`` coefficients a row: total % 4 == 0 and every
    row of x, w and out (ys, alpha and out) on a 16-byte boundary; the kernel
    refuses it otherwise and runs its word form on any shape.  Its instance
    is the source count."""
    return total % EXT_VEC == 0 and all(_cuda.aligned(t) for t in tensors)


def base_extend_fused_kernel(x, src: tuple, dst: tuple,
                             centered: bool = False, w=None,
                             sub_mul: tuple | None = None):
    """K4 on CUDA int32 tensors: one instance per source count, 4
    consecutive coefficients a thread where ``_ext_vec`` allows it."""
    _check_src(src)
    _check_epilogue(w, sub_mul)
    dev = x.device
    _cuda.check(x, "x", dev)
    if x.shape[0] != len(src):
        raise ValueError(f"x has {x.shape[0]} rows for {len(src)} primes")
    out = torch.empty((len(dst),) + x.shape[1:], dtype=torch.int32,
                      device=dev)
    if w is not None:
        _cuda.check(w, "w", dev)
        if w.shape != out.shape:
            raise ValueError(f"w has shape {tuple(w.shape)}, expected "
                             f"{tuple(out.shape)}")
    total = x.numel() // len(src)
    if total == 0:
        return out
    tab = kernel_table(tuple(src), tuple(dst),
                       None if sub_mul is None else tuple(sub_mul), dev)
    vec = _ext_vec(total, x, out, *(() if w is None else (w,)))
    _cuda.BASE_EXTEND.launch(
        dev, x.data_ptr(), None if w is None else w.data_ptr(),
        out.data_ptr(), tab.data_ptr(), len(src), len(dst), total,
        int(centered), int(vec))
    return out


def base_extend_fused(x, src: tuple, dst: tuple, centered: bool = False,
                      w=None, sub_mul: tuple | None = None):
    """x [Ls, ..., n] residues over src -> [Ld, ..., n] over dst (int32),
    the whole HPS conversion in one pass; see the module docstring."""
    ts = (x,) if w is None else (x, w)
    fn = (base_extend_fused_kernel if _cuda.on_cuda(*ts)
          else base_extend_fused_plain)
    return fn(x, src, dst, centered=centered, w=w, sub_mul=sub_mul)


def base_extend_sum_kernel(ys, alpha, src: tuple, dst: tuple):
    """K11 on CUDA int32 tensors: K4's structure (one instance per source
    count, 4 consecutive coefficients a thread where ``_ext_vec`` allows
    it)."""
    _check_src(src)
    dev = ys.device
    _cuda.check(ys, "ys", dev)
    _cuda.check(alpha, "alpha", dev)
    if ys.shape[0] != len(src) or alpha.shape != ys.shape[1:]:
        raise ValueError(f"ys {tuple(ys.shape)} and alpha "
                         f"{tuple(alpha.shape)} for {len(src)} primes: need "
                         "[Ls, ..., n] and [..., n]")
    out = torch.empty((len(dst),) + ys.shape[1:], dtype=torch.int32,
                      device=dev)
    total = alpha.numel()
    if total == 0:
        return out
    tab = kernel_table(tuple(src), tuple(dst), None, dev)
    _cuda.BASE_EXTEND_SUM.launch(dev, ys.data_ptr(), alpha.data_ptr(),
                                 out.data_ptr(), tab.data_ptr(), len(src),
                                 len(dst), total,
                                 int(_ext_vec(total, ys, alpha, out)))
    return out


def base_extend_sum(ys, alpha, src: tuple, dst: tuple):
    """The contraction alone, for a caller that holds (ys, alpha) already
    (int32 [Ls, ..., n] below s_i, and int32 [..., n] below Ls + 1) ->
    [Ld, ..., n] int32: sum_i ys_i * (S/s_i) - alpha * S per dst prime."""
    fn = (base_extend_sum_kernel if _cuda.on_cuda(ys, alpha)
          else base_extend_sum_plain)
    return fn(ys, alpha, src, dst)
