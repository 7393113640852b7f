"""Device-side CKKS canonical-embedding encoder: split-complex float64 FFT —
the counterpart of fhe_study_tpu/models/ckks/encoder_device.py.

The same twisted transform as encoder.Encoder on REAL float64 tensors (re, im
pairs), with the reference's iterative radix-2 structure stage for stage, so
that both packages round the same sums: plain torch, batched over leading
dims, on whatever device the slots lie on.
"""

from functools import lru_cache

import numpy as np
import torch

from ...ops.ntt import _bit_reverse_perm
from ...utils.rounding import round_half_away


@lru_cache(maxsize=None)
def _fft_tables_host(n: int, sign: int):
    """Per-stage twiddle (re, im) for a DIT FFT with e^{sign·2πi jk/n}, the
    bit-reversal permutation and the ±π/n twist (numpy)."""
    logn = n.bit_length() - 1
    bitrev = _bit_reverse_perm(logn).astype(np.int64)
    tws = []
    for s in range(logn):
        half = 1 << s
        ang = sign * 2.0 * np.pi * np.arange(half) / (2 * half)
        tws.append((np.cos(ang), np.sin(ang)))
    k = np.arange(n)
    twist = (np.cos(sign * np.pi * k / n), np.sin(sign * np.pi * k / n))
    return bitrev, tws, twist


@lru_cache(maxsize=None)
def _fft_tables(n: int, sign: int, device):
    bitrev, tws, twist = _fft_tables_host(n, sign)

    def dev(a):
        return torch.from_numpy(a).to(device)
    return (dev(bitrev), [(dev(c), dev(s)) for c, s in tws],
            (dev(twist[0]), dev(twist[1])))


def _fft_split(re, im, n: int, sign: int):
    """Radix-2 DIT over the last axis; natural-order output."""
    bitrev, tws, _ = _fft_tables(n, sign, re.device)
    re = re.index_select(-1, bitrev)
    im = im.index_select(-1, bitrev)
    batch = tuple(re.shape[:-1])
    for s in range(n.bit_length() - 1):
        half = 1 << s
        m = n // (2 * half)
        wr, wi = tws[s]
        re = re.reshape(batch + (m, 2, half))
        im = im.reshape(batch + (m, 2, half))
        ur, ui = re[..., 0, :], im[..., 0, :]
        vr0, vi0 = re[..., 1, :], im[..., 1, :]
        vr = vr0 * wr - vi0 * wi
        vi = vr0 * wi + vi0 * wr
        re = torch.stack([ur + vr, ur - vr], dim=-2)
        im = torch.stack([ui + vi, ui - vi], dim=-2)
    return re.reshape(batch + (n,)), im.reshape(batch + (n,))


def encode(z_re, z_im, n: int, delta: float):
    """[..., n/2] (re, im) float64 tensors -> int64 coefficients [..., n].
    The math of encoder.Encoder.encode (twisted DFT of the conjugate-
    symmetric expansion) with sign=-1 and the w^{-k} twist."""
    z_re = z_re.double() * delta
    z_im = z_im.double() * delta
    exp_re = torch.cat([z_re, z_re.flip(-1)], dim=-1)
    exp_im = torch.cat([z_im, -z_im.flip(-1)], dim=-1)
    fr, fi = _fft_split(exp_re, exp_im, n, -1)
    _, _, (tr, ti) = _fft_tables(n, -1, fr.device)
    alpha_re = (fr * tr - fi * ti) / n
    return round_half_away(alpha_re).long()


def decode(p, n: int, delta: float):
    """Coefficients [..., n] (integer or float64) -> (re, im) [..., n/2]."""
    pr = p.double()
    _, _, (tr, ti) = _fft_tables(n, +1, pr.device)
    fr, fi = _fft_split(pr * tr, pr * ti, n, +1)
    return fr[..., : n // 2] / delta, fi[..., : n // 2] / delta
