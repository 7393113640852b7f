"""RNS-CKKS: approximate arithmetic over a multi-prime modulus Q = prod(q_i)
— the counterpart of fhe_study_tpu/models/ckks/ckks_rns.py.

Encode on the device (split-complex FFT, encoder_device.py), encrypt and add
residue-wise over L ~30-bit NTT primes, multiply as tensor (K6, without
BFV's t/Q scaling) + relinearization + one rescale (``mod_switch_drop`` of
bfv_rns is exactly CKKS rescaling by q_last), decrypt by an exact CRT of the
first limbs, decode back through the FFT.

Residues are int32 tensors [L, ..., N]; slots and coefficients float64 /
int64.  Each function that draws has a deterministic core (``*_with``) fed
with its draws and a sampling wrapper on an explicit ``prng.Gen``;
the cores reproduce the reference bit for bit on the same draws.  The scale
``delta`` is a Python float updated by the reference's own expressions.
"""

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ...ops import modops
from ...ops.ntt import (_addmod_v, _qvec, _submod_v, intt_multi, mulmod_v,
                        ntt_multi, tensor_mul4)
from ...ops.primes import ntt_primes
from ...utils import prng
from .. import bfv_rns, hybrid_ks
from ..bfv_rns import _bcast_mid, _to_residues
from . import encoder_device

ERR_SIGMA = 3.2


@dataclass(frozen=True)
class Param:
    n: int
    L: int                 # number of RNS primes
    delta: float           # encoding scale
    prime_bits: int = 30

    def __post_init__(self):
        if self.n < 4 or self.n & (self.n - 1):
            raise ValueError(f"ring degree n={self.n} must be a power of two "
                             "(X^N+1 ring)")
        if self.L < 1 or not self.delta > 0:
            raise ValueError(f"need L >= 1 and delta > 0 (got L={self.L}, "
                             f"delta={self.delta})")

    @property
    def qs(self):
        return ntt_primes(self.L, self.prime_bits, 1 << 16)


class SecretKey(NamedTuple):
    s_evals: torch.Tensor     # [L, ..., N]


class PublicKey(NamedTuple):
    b: torch.Tensor
    a: torch.Tensor


class CT(NamedTuple):
    c0: torch.Tensor          # [L, ..., N]
    c1: torch.Tensor


def new_key_with(param: Param, s, a, e):
    """Key pair from its draws: s [batch.., n] ternary, a [L, batch.., n]
    uniform residues over Q, e [batch.., n] signed noise."""
    qs = param.qs
    s_evals = ntt_multi(_to_residues(s, qs), qs)
    qv = _qvec(qs, a.ndim, a.device)
    a_s = intt_multi(mulmod_v(ntt_multi(a, qs), s_evals, qv), qs)
    return (SecretKey(s_evals),
            PublicKey(b=_submod_v(_to_residues(e, qs), a_s, qv), a=a))


def new_key(gen: prng.Gen, param: Param, device, batch=(),
            h: int | None = None):
    """h: optional secret Hamming weight (sparse ternary, the CKKS
    bootstrapping convention, see prng.sparse_ternary).  Default: dense
    ternary, the reference's round(U[-1,1)) secret."""
    k_s, k_a, k_e = prng.split(gen, 3)
    shp = tuple(batch) + (param.n,)
    s = (prng.ternary(k_s, shp, device) if h is None
         else prng.sparse_ternary(k_s, shp, h, device))
    return new_key_with(param, s,
                        prng.uniform_mod_multi(k_a, shp, param.qs, device),
                        prng.gaussian_int(k_e, shp, ERR_SIGMA, device))


def encode(param: Param, z_re, z_im):
    """[..., N/2] complex slots (two float64 tensors) -> RNS residues
    [L, ..., N]."""
    m = encoder_device.encode(z_re, z_im, param.n, param.delta)
    return _to_residues(m, param.qs)


def encrypt_with(param: Param, pk: PublicKey, m_res, u, e0, e1) -> CT:
    """c = (pk.b·u + e0 + m, pk.a·u + e1); m_res [L, batch.., n] encoded
    residues, u, e0, e1 [batch.., n] integers (u ternary)."""
    qs = param.qs
    u_res = _to_residues(u, qs)
    qv = _qvec(qs, u_res.ndim, u_res.device)
    eu = ntt_multi(u_res, qs)
    epb = _bcast_mid(ntt_multi(pk.b, qs), eu.ndim)
    epa = _bcast_mid(ntt_multi(pk.a, qs), eu.ndim)
    c0 = _addmod_v(_addmod_v(intt_multi(mulmod_v(epb, eu, qv), qs),
                             _to_residues(e0, qs), qv), m_res, qv)
    c1 = _addmod_v(intt_multi(mulmod_v(epa, eu, qv), qs),
                   _to_residues(e1, qs), qv)
    return CT(c0, c1)


def encrypt(gen: prng.Gen, param: Param, pk: PublicKey, m_res,
            batch=()) -> CT:
    device = pk.b.device
    shp = tuple(batch) + (param.n,)
    k_u, k_e0, k_e1 = prng.split(gen, 3)
    return encrypt_with(param, pk, m_res, prng.ternary(k_u, shp, device),
                        prng.gaussian_int(k_e0, shp, ERR_SIGMA, device),
                        prng.gaussian_int(k_e1, shp, ERR_SIGMA, device))


def add(param: Param, x: CT, y: CT) -> CT:
    qv = _qvec(param.qs, x.c0.ndim, x.c0.device)
    return CT(_addmod_v(x.c0, y.c0, qv), _addmod_v(x.c1, y.c1, qv))


def sub(param: Param, x: CT, y: CT) -> CT:
    qv = _qvec(param.qs, x.c0.ndim, x.c0.device)
    return CT(_submod_v(x.c0, y.c0, qv), _submod_v(x.c1, y.c1, qv))


def mul_pt(param: Param, x: CT, m_res) -> CT:
    """Slot-wise ciphertext x plaintext product (NTT pointwise).  m_res:
    encoded residues [L, ..., N] (delta-scaled); the result carries scale
    delta^2: rescale it."""
    qs = param.qs
    qv = _qvec(qs, x.c0.ndim, x.c0.device)
    em = ntt_multi(_bcast_mid(m_res, x.c0.ndim).contiguous(), qs)
    return CT(*(intt_multi(mulmod_v(ntt_multi(c.contiguous(), qs), em, qv),
                           qs) for c in x))


def rescale(param: Param, x: CT):
    """Drop the last prime: scale delta -> delta / q_last; returns
    (ct', param') with L-1 limbs (the standard CKKS level drop)."""
    out = bfv_rns.mod_switch_drop(_bfv_param(param), bfv_rns.CT(x.c0, x.c1))
    new_param = Param(n=param.n, L=param.L - 1,
                      delta=param.delta / param.qs[-1] * 1.0,
                      prime_bits=param.prime_bits)
    return CT(out.c0, out.c1), new_param


def decrypt_to_coeffs(param: Param, sk: SecretKey, c: CT,
                      crt_limbs: int | None = None):
    """c0 + c1·s -> centered float64 coefficients.

    The decrypted phase Δ·z + e is tiny relative to Q, so it is recovered
    from the first few limbs only.  crt_limbs=2 (the default up to
    Δ <= 2^40): exact centered 2-prime CRT, valid while |phase| < q0·q1/2
    ~ 2^60, so int64 holds every value.  crt_limbs=3 (auto for the
    double-prime scales, Δ ~ q_i·q_j ~ 2^60): centered mixed-radix (Garner)
    digits summed in float64 in the reference's order; only the TOP digit is
    centered, so every term stays ~ |phase| and the error is ~2^-53
    RELATIVE."""
    qs = param.qs
    if crt_limbs is None:
        crt_limbs = 2 if param.delta <= 2.0 ** 40 else 3
    nl = c.c0.shape[0]
    qv = _qvec(qs, c.c0.ndim, c.c0.device)
    # slice the key to the ciphertext's limb count (rescaled cts are shorter)
    se = _bcast_mid(sk.s_evals[:nl], c.c1.ndim)
    cs = _addmod_v(c.c0, intt_multi(mulmod_v(ntt_multi(c.c1, qs), se, qv),
                                    qs), qv).long()
    q0, q1 = qs[0], qs[1]
    r0, r1 = cs[0], cs[1]
    d1 = modops.mulmod(modops.submod(r1, r0 % q1, q1), pow(q0, -1, q1), q1)
    if crt_limbs == 2:
        v = r0 + q0 * d1                        # in [0, q0*q1), below 2^60
        m01 = q0 * q1
        return torch.where(v > m01 // 2, -((m01 - v).double()), v.double())
    if crt_limbs != 3 or nl < 3:
        raise ValueError(f"crt_limbs={crt_limbs} on {nl} limbs: need 2, or 3 "
                         "with at least 3 limbs")
    q2, r2 = qs[2], cs[2]
    # Garner digits: v = r0 + q0·d1 + q0·q1·d2, each digit below its prime
    v01_q2 = modops.addmod(r0 % q2, modops.mulmod(d1 % q2, q0 % q2, q2), q2)
    d2 = modops.mulmod(modops.submod(r2, v01_q2, q2),
                       pow(q0 * q1, -1, q2), q2)
    # center the top digit: |phase| << q0·q1·q2/2 means d2 is ±small
    c2 = torch.where(d2 > q2 // 2, -((q2 - d2).double()), d2.double())
    return r0.double() + float(q0) * d1.double() + float(q0 * q1) * c2


def decode(param: Param, coeffs_f64):
    return encoder_device.decode(coeffs_f64, param.n, param.delta)


# -- hybrid (P-extended) multiply: the low-noise production path ------------

def _s2(param: Param, sk: SecretKey):
    sq = sk.s_evals[:param.L]
    return mulmod_v(sq, sq, _qvec(param.qs, sq.ndim, sq.device)), sq


def hybrid_rlk_with(param: Param, sk: SecretKey, a, e, K: int = 2):
    """hybrid_rlk from its draws (as hybrid_ks.hybrid_ksk_with takes
    them)."""
    return hybrid_ks.hybrid_ksk_with(param, *_s2(param, sk), a, e, K=K)


def hybrid_rlk(gen: prng.Gen, param: Param, sk: SecretKey, K: int = 2):
    """P-extended relinearization key: encrypts P*g_i*s^2 under s.  Noise
    after the switch is ~1 unit (against ~2^36 for the plain RNS gadget at
    30-bit primes): required for chained multiplications at delta ~ 2^30."""
    return hybrid_ks.hybrid_ksk(gen, param, *_s2(param, sk), K=K)


def _tensor_switch(param: Param, hrlk, x: CT, y: CT) -> CT:
    """(x (x) y) -> hybrid relinearize: a CT over Q at scale delta^2."""
    qs = param.qs
    d = tensor_mul4(x.c0, x.c1, y.c0, y.c1, qs)      # one launch (K6)
    d0, d1, d2 = d[..., 0, :], d[..., 1, :], d[..., 2, :]
    sw = hybrid_ks.hybrid_key_switch(param, hrlk, CT(d0, d2))
    qv = _qvec(qs, d1.ndim, d1.device)
    return CT(sw.c0, _addmod_v(sw.c1, d1, qv))


def mul_hybrid(param: Param, hrlk, x: CT, y: CT):
    """(x (x) y) -> hybrid relinearize -> rescale.  Returns (ct', param')
    with L-1 limbs and scale delta^2 / q_last."""
    ct = _tensor_switch(param, hrlk, x, y)
    out = bfv_rns.mod_switch_drop(_bfv_param(param),
                                  bfv_rns.CT(ct.c0, ct.c1))
    new_param = Param(n=param.n, L=param.L - 1,
                      delta=param.delta * param.delta / param.qs[-1],
                      prime_bits=param.prime_bits)
    return CT(out.c0, out.c1), new_param


# -- double-prime scale: the high-precision pipeline ------------------------
#
# With primes below 2^31 a single-prime scale caps delta at ~2^30 (slot
# precision ~2^-24 after noise).  Setting delta ~= q_i·q_j ~= 2^60 and
# rescaling by TWO primes per multiply keeps the scale stationary and lifts
# slot precision to ~2^-48: encode still fits (the float64 mantissa quantizes
# the 2^60-scaled coefficients to multiples of 2^7, a 2^-53 relative error,
# and the int64 residue conversion holds to 2^62); decrypt recovers the phase
# by the centered 3-limb Garner CRT.  Relin noise must be ~1 unit for the
# precision to survive, so the multiply is the hybrid switch.

def delta2(param_or_qs, L: int | None = None) -> float:
    """The stationary double-prime scale q_{L-1}·q_{L-2} (as float64)."""
    qs = param_or_qs.qs if hasattr(param_or_qs, "qs") else param_or_qs
    L = len(qs) if L is None else L
    return float(qs[L - 1]) * float(qs[L - 2])


def rescale2(param: Param, x: CT):
    """Drop the last TWO primes: delta -> delta/(q_{L-1}·q_{L-2})."""
    ct, p1 = rescale(param, x)
    return rescale(p1, ct)


def mul_hybrid2(param: Param, hrlk, x: CT, y: CT):
    """(x (x) y) -> hybrid relinearize -> rescale by TWO primes.  Returns
    (ct', param') with L-2 limbs and scale delta^2/(q_{L-1}·q_{L-2}):
    stationary at delta ~= 2^60 with ~30-bit primes."""
    p_sq = Param(n=param.n, L=param.L, delta=param.delta * param.delta,
                 prime_bits=param.prime_bits)   # the tensor carries delta^2
    return rescale2(p_sq, _tensor_switch(param, hrlk, x, y))


# -- multiply + rescale (the standard RNS-CKKS pipeline) --------------------

def _bfv_param(param: Param):
    # same prime sequence; t unused by the relin and mod-switch machinery
    return bfv_rns.RnsParam(n=param.n, t=2, L=param.L, M=1,
                            prime_bits=param.prime_bits)


def rlk_key_with(param: Param, sk: SecretKey, a, e):
    """RNS-gadget relin key from its draws (as bfv_rns.rlk_key_with)."""
    return bfv_rns.rlk_key_with(_bfv_param(param), sk, a, e)


def rlk_key(gen: prng.Gen, param: Param, sk: SecretKey):
    """RNS-gadget relinearization key (shared machinery with RNS-BFV)."""
    return bfv_rns.rlk_key(gen, _bfv_param(param), sk)


def mul(param: Param, rlk, x: CT, y: CT):
    """(x ⊗ y) -> relinearize -> rescale by q_last.

    Returns (ct', param') where param' has L-1 limbs and scale
    delta^2/q_last, the standard CKKS level drop.  No base extension is
    needed: CKKS multiplies mod Q directly and divides by ONE prime."""
    qs = param.qs
    d = tensor_mul4(x.c0, x.c1, y.c0, y.c1, qs)      # one launch (K6)
    bp = _bfv_param(param)
    ct = bfv_rns.relinearize(bp, rlk, d[..., 0, :], d[..., 1, :],
                             d[..., 2, :])
    ct = bfv_rns.mod_switch_drop(bp, ct)
    new_param = Param(n=param.n, L=param.L - 1,
                      delta=param.delta * param.delta / qs[-1],
                      prime_bits=param.prime_bits)
    return CT(ct.c0, ct.c1), new_param
