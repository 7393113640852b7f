"""The host side of K4 (base_extend, csrc/ext_cuda.cu), checked on the CPU:
the choice of the kernel's form (4 coefficients a thread in uint4 words, or
one word) for each source count (its instance, 1 .. 31), the
layout of the packed table the kernel stages into shared memory, and the
plain version that the kernel is held against on the card, against exact
Python-integer arithmetic at every source count.  Tolerance 0 throughout.
"""

from math import prod

import numpy as np
import pytest
import torch

from fhe_study_tpu_torch.ops import ext_cuda
from fhe_study_tpu_torch.ops.primes import ntt_primes

PRIMES = ntt_primes(36, 30, 1 << 16)   # 5 destination, up to 31 source


def _at_word(offset: int, numel: int) -> torch.Tensor:
    """A contiguous int32 tensor whose data starts ``offset`` words past a
    16-byte boundary."""
    buf = torch.zeros(numel + 8, dtype=torch.int32)
    skip = (-buf.data_ptr() // 4) % 4 + offset
    return buf[skip:skip + numel]


@pytest.mark.parametrize("ls", range(1, ext_cuda.MAX_SRC + 1))
def test_vector_form_needs_whole_uint4_rows(ls):
    """The instance is the source count (the kernel switches on it); the
    vector form is taken exactly when every row of x, w and out is whole
    uint4 words: total % 4 == 0 and each base on a 16-byte boundary."""
    for total in (256, 257, 258, 259, 4 * 3 * 5):
        for x_off, out_off in ((0, 0), (1, 0), (0, 2), (3, 3)):
            x, out = _at_word(x_off, ls * total), _at_word(out_off, total)
            assert ext_cuda._ext_vec(total, x, out) == (
                total % 4 == 0 and x_off == 0 and out_off == 0)
    x, out = _at_word(0, ls * 256), _at_word(0, 256)
    assert ext_cuda._ext_vec(256, x, out, _at_word(0, 256))
    assert not ext_cuda._ext_vec(256, x, out, _at_word(1, 256))


def test_kernel_table_layout():
    """ExtTable's layout (csrc/modarith.cuh): per source prime (s_i, Shoup
    pair of (S/s_i)^-1 mod s_i, floor(2^59/s_i) as lo/hi), per destination
    prime (d_j, Shoup pair of S mod d_j, Shoup pair of sub_mul[j]), then the
    Shoup pairs of (S/s_i) mod d_j, i-major; 5 (Ls + Ld) + 2 Ls Ld words:
    600 for 15 -> 15 primes, at most 2,232 for 31 -> 31 (8,928 bytes of
    shared memory a block, within the 48 KB a block takes unasked)."""
    src, dst, sub = PRIMES[:3], PRIMES[3:7], (5, 6, 7, 8)
    t = ext_cuda._kernel_table_host(src, dst, sub).astype(np.int64)
    ls, ld = len(src), len(dst)
    assert t.size == 5 * (ls + ld) + 2 * ls * ld
    assert ext_cuda._kernel_table_host(PRIMES[:15], PRIMES[:15], None).size \
        == 600
    assert ext_cuda._kernel_table_host(PRIMES[:31], PRIMES[5:], None).size \
        == 2232
    S = prod(src)
    for i, s in enumerate(src):
        h = pow(S // s % s, -1, s)
        cfix = (1 << 59) // s
        assert list(t[5 * i:5 * i + 5]) == [s, h, (h << 32) // s,
                                            cfix & 0xFFFFFFFF, cfix >> 32]
    for j, d in enumerate(dst):
        row = t[5 * ls + 5 * j:5 * ls + 5 * j + 5]
        assert list(row) == [d, S % d, ((S % d) << 32) // d, sub[j],
                             (sub[j] << 32) // d]
    base = 5 * (ls + ld)
    for i, s in enumerate(src):
        for j, d in enumerate(dst):
            v = S // s % d
            assert list(t[base + 2 * (i * ld + j):][:2]) == [v, (v << 32) // d]


def _python_ints(x, src, dst, centered, w, sub_mul):
    """The HPS conversion of every coefficient in exact integers."""
    S = prod(src)
    hat_inv = [pow(S // s % s, -1, s) for s in src]
    xs = x.reshape(len(src), -1).tolist()
    out = []
    for c in range(len(xs[0])):
        ys = [xs[i][c] * hat_inv[i] % s for i, s in enumerate(src)]
        alpha = (sum(y * ((1 << 59) // s) for y, s in zip(ys, src))
                 + ((1 << 58) if centered else 0)) >> 59
        assert alpha <= len(src)
        v = sum(y * (S // s) for y, s in zip(ys, src)) - alpha * S
        out.append([v % d for d in dst])
    got = np.array(out, dtype=np.int64).T
    if w is not None:
        wv = w.reshape(len(dst), -1).numpy().astype(np.int64)
        got = np.stack([(wv[j] - got[j]) % d * sub_mul[j] % d
                        for j, d in enumerate(dst)])
    return got.reshape((len(dst),) + tuple(x.shape[1:]))


@pytest.mark.parametrize("ls", range(1, ext_cuda.MAX_SRC + 1))
def test_plain_equals_python_integers(ls):
    """Odd totals (3 x 5 coefficients a row, the kernel's word form), both
    roundings, with and without the epilogue; the last coefficient has
    y_i = s_i - 1 in every row, where the 2^59 fixed-point sum of alpha is
    largest (past 2^63 from Ls = 17 on, from 16 when centered; below
    31 * 2^59 + 2^58 < 2^64 at Ls = 31: the int64 sum wraps as u64 does)."""
    rng = np.random.default_rng(ls)
    src, dst = PRIMES[len(PRIMES) - ls:], PRIMES[:5]
    S = prod(src)
    x = np.stack([rng.integers(0, s, (3, 5)) for s in src])
    for i, s in enumerate(src):             # y_i = x_i * hat_inv_i = s_i - 1
        x[i, -1, -1] = (s - 1) * (S // s % s) % s
    x = torch.from_numpy(x).int()
    w = torch.from_numpy(np.stack([rng.integers(0, d, (3, 5))
                                   for d in dst])).int()
    sub_mul = tuple(int(v) for v in rng.integers(1, 1 << 30, len(dst)))
    for centered in (False, True):
        for ww, sm in ((None, None), (w, sub_mul)):
            got = ext_cuda.base_extend_fused_plain(x, src, dst, centered,
                                                   w=ww, sub_mul=sm)
            want = _python_ints(x, src, dst, centered, ww,
                                None if sm is None else
                                [v % d for v, d in zip(sm, dst)])
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
