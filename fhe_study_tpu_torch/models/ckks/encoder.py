"""CKKS canonical-embedding encoder, FFT formulation, on the host — the
counterpart of fhe_study_tpu/models/ckks/encoder.py.

The Vandermonde matrix at the odd powers of the 2N-th root of unity is a
twisted DFT matrix with orthogonal rows (norm^2 = N), so projection and solve
collapse to one twisted FFT:

    encode:  alpha_k = Re[(1/N) * w^{-k} * DFT(pi_inv(z) * Delta)_k],  round
    decode:  sigma(p)_j = N * IDFT(p * w^k)_j,  first N/2, / Delta

with w = e^{i*pi/N}.  Runs in numpy complex128; it is the independent check
of the device encoder (encoder_device.py), which the encrypt and decrypt
paths use.
"""

import numpy as np


def _round_half_away_np(x):
    t = np.trunc(x)
    frac = x - t
    bump = np.where(np.abs(frac) >= 0.5, np.sign(frac), 0.0)
    return t + bump


class Encoder:
    """Canonical embedding C^{N/2} <-> R = Z[X]/(X^N+1), scale Delta."""

    def __init__(self, n: int, delta: float):
        self.n = n
        self.delta = float(delta)
        k = np.arange(n)
        self.twist = np.exp(-1j * np.pi * k / n)      # w^{-k}
        self.untwist = np.exp(1j * np.pi * k / n)     # w^{+k}

    def pi_inv(self, z):
        """C^{N/2} -> H: append reversed conjugates."""
        z = np.asarray(z, dtype=np.complex128)
        return np.concatenate([z, np.conj(z[..., ::-1])], axis=-1)

    def encode(self, z):
        """z: [..., N/2] complex -> int64 coefficient array [..., N]."""
        expanded = self.pi_inv(z) * self.delta
        alpha = self.twist * np.fft.fft(expanded, axis=-1) / self.n
        return _round_half_away_np(alpha.real).astype(np.int64)

    def decode(self, p):
        """int coefficients [..., N] -> [..., N/2] complex."""
        p = np.asarray(p, dtype=np.float64)
        sigma = np.fft.ifft(p * self.untwist, axis=-1) * self.n
        return sigma[..., : self.n // 2] / self.delta
