"""The port's coefficient-domain tensor and gadget key-switch functions against
the JAX package's Pallas kernels in interpret mode, bit for bit.

``ntt.tensor_mul4``, ``ntt.tensor_mul_multi``, ``ntt.ks_fused_multi`` and
``ntt.ks_fused_eval`` run their plain PyTorch versions on the CPU; the CUDA
kernels behind them are held against those plain versions on the card
(test_torch_cuda.py).  Inputs come from numpy seeds; tolerance 0 (integer
paths).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fhe_study_tpu.ops import ntt as jntt
from fhe_study_tpu.ops import ntt_pallas
from fhe_study_tpu.ops.primes import ntt_primes

from fhe_study_tpu_torch.ops import ntt, ntt_cuda

N, B = 256, 2
QS = ntt_primes(4, 30, 1 << 16)
PS = ntt_primes(5, 30, 1 << 16, skip=4)
KS = ntt_primes(2, 30, 1 << 16, skip=9)


def residues(seed, primes, shape):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, p, shape) for p in primes]
                    ).astype(np.uint32)


def tt(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def same(got, want):
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64))


def scale_of(kind, primes):
    return None if kind is None else tuple(q - 11 for q in primes)


@pytest.mark.parametrize("scale", [None, "q-11"])
@pytest.mark.parametrize("ext", [False, True])
def test_tensor_mul4_matches_pallas(ext, scale):
    ops = [residues(100 + i, QS, (B, N)) for i in range(4)]
    dst, src = (PS, QS) if ext else (QS, None)
    sc = scale_of(scale, dst)
    got = ntt.tensor_mul4(*(tt(o) for o in ops), dst, scale=sc, src=src)
    want = ntt_pallas.tensor_mul4_u32(*(jnp.asarray(o) for o in ops), dst,
                                      scale=sc, src=src, interpret=True)
    assert got.dtype == torch.int32 and tuple(got.shape) == (len(dst), B, 3, N)
    same(got, want)


def test_tensor_mul4_takes_strided_views_and_batch_axes():
    x = residues(110, QS, (B, 3, 4, N))
    xt = tt(x)
    got = ntt.tensor_mul4(*(xt[..., i, :] for i in range(4)), PS, src=QS)
    want = ntt_pallas.tensor_mul4_u32(
        *(jnp.asarray(x[..., i, :]) for i in range(4)), PS, src=QS,
        interpret=True)
    assert tuple(got.shape) == (len(PS), B, 3, 3, N)
    same(got, want)


@pytest.mark.parametrize("scale", [None, "q-11"])
def test_tensor_mul_multi_matches_pallas(scale):
    x4 = residues(120, QS, (B, 4, N))
    sc = scale_of(scale, QS)
    got = ntt.tensor_mul_multi(tt(x4), QS, scale=sc)
    same(got, ntt_pallas.tensor_mul_u32(jnp.asarray(x4), QS, scale=sc,
                                        interpret=True))
    same(got, ntt.tensor_mul4(*(tt(x4[..., i, :]) for i in range(4)), QS,
                              scale=sc))
    with pytest.raises(ValueError, match="4, n"):
        ntt.tensor_mul_multi(tt(x4[..., :3, :]), QS)


def gadget_inputs(seed, src, primes, R=None):
    R = len(src) if R is None else R
    c = residues(seed, src[:R], (B, N))
    kb = np.stack([residues(seed + 1 + r, primes, (N,)) for r in range(R)])
    ka = np.stack([residues(seed + 50 + r, primes, (N,)) for r in range(R)])
    return c, kb, ka


@pytest.mark.parametrize("primes", ["same", "extended"])
def test_ks_fused_multi_matches_pallas(primes):
    """R = L over Q as relinearize calls it, and a wider destination basis
    (primes != src_primes) as the hybrid key switch calls it."""
    dst = QS if primes == "same" else QS + KS
    c, kb, ka = gadget_inputs(200, QS, dst)
    g0, g1 = ntt.ks_fused_multi(tt(c), tt(kb), tt(ka), dst, QS)
    w0, w1 = ntt_pallas.ks_fused_u32(jnp.asarray(c), jnp.asarray(kb),
                                     jnp.asarray(ka), dst, QS,
                                     interpret=True)
    same(g0, w0)
    same(g1, w1)
    # and the reference's XLA path
    x0, x1 = jntt.ks_fused_multi(jnp.asarray(c).astype(jnp.uint64),
                                 jnp.asarray(kb).astype(jnp.uint64),
                                 jnp.asarray(ka).astype(jnp.uint64), dst, QS)
    same(g0, x0)
    same(g1, x1)


def test_digit_reduction_where_a_limb_exceeds_the_prime():
    """Limb residues c_i >= p_j (the primes descend, so every limb's top
    values exceed the later primes): the conditional subtractions must give
    c_i mod p_j, which the result pins against Pallas."""
    assert QS[0] > QS[-1] and ntt_cuda.digit_reps(QS, QS) == 2
    c, kb, ka = gadget_inputs(210, QS, QS)
    for i, q in enumerate(QS):
        c[i, :, :64] = q - 1 - np.arange(64, dtype=np.uint32)
        c[i, :, 64:70] = [0, 1, QS[-1] - 1, QS[-1], min(QS[-1] + 1, q - 1),
                          q - 1]
    assert (c[0] >= QS[-1]).sum() >= 64 * B
    g = ntt.ks_fused_multi(tt(c), tt(kb), tt(ka), QS, QS)
    w = ntt_pallas.ks_fused_u32(jnp.asarray(c), jnp.asarray(kb),
                                jnp.asarray(ka), QS, QS, interpret=True)
    for got, want in zip(g, w):
        same(got, want)
    adds = (residues(211, QS, (B, N)), residues(212, QS, (B, N)))
    g = ntt.ks_fused_eval(tt(c), tt(kb), tt(ka), QS, QS,
                          tuple(tt(a) for a in adds))
    w = ntt_pallas.ks_fused_eval_u32(
        jnp.asarray(c), jnp.asarray(kb), jnp.asarray(ka), QS, QS,
        tuple(jnp.asarray(a) for a in adds), interpret=True)
    for got, want in zip(g, w):
        same(got, want)


def test_ks_fused_eval_matches_pallas_on_strided_views():
    """mul_e hands c_limbs and adds as views of one [L, B, 3, n] stack."""
    out3 = residues(220, QS, (B, 3, N))
    _, kb, ka = gadget_inputs(221, QS, QS)
    t3 = tt(out3)
    got = ntt.ks_fused_eval(t3[..., 2, :], tt(kb), tt(ka), QS, QS,
                            (t3[..., 0, :], t3[..., 1, :]))
    want = ntt_pallas.ks_fused_eval_u32(
        jnp.asarray(out3[..., 2, :]), jnp.asarray(kb), jnp.asarray(ka), QS,
        QS, (jnp.asarray(out3[..., 0, :]), jnp.asarray(out3[..., 1, :])),
        interpret=True)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == (len(QS), B, N)
        same(g, w)
    # the eval-domain halves are the forward transforms of the coeff halves
    same(ntt.ntt_multi(got[2], QS), got[0].numpy())
    same(ntt.ntt_multi(got[3], QS), got[1].numpy())
    # and the coefficient halves are ks_fused_multi plus the adds
    r0, r1 = ntt.ks_fused_multi(t3[..., 2, :], tt(kb), tt(ka), QS, QS)
    qv = np.array(QS, np.int64).reshape(-1, 1, 1)
    same(got[2], (r0.numpy().astype(np.int64) + out3[..., 0, :]) % qv)
    same(got[3], (r1.numpy().astype(np.int64) + out3[..., 1, :]) % qv)
