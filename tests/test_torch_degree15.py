"""The port at ring degree n = 2^15 against the JAX package, bit for bit.

Every RNS prime of both packages is 1 mod 2^16, so both take negacyclic
transforms up to n = 2^15; the port's one-buffer kernels (K1, K2, K3, K5, K9
and K12) reach that degree on the card, and so do the three-buffer ones
(K6, tensor_mul, K7, K8) on two-block clusters; K10 stops at 2^14.  Here,
on the CPU, the port's functions run their plain versions and the JAX
package its XLA path (its Pallas kernels are TPU-only; off the TPU
``_pallas_ok`` sends these degrees to XLA), each under ``jax.jit``: the
transforms both ways, the eval-domain tensor, the fused extension, the
hybrid contraction, the coefficient-domain tensor (with and without a
source basis, and stacked) and the gadget key switches from limbs over 2-3
primes at B = 1, and one
``mul_e`` with the 1-row hybrid relin key at N = 2^15, L = 2, M = 3, K = 3,
B = 1 on keys and ciphertexts that the port draws and utils/interop.py
carries into JAX, decrypted against a numpy negacyclic product.  Inputs are
numpy draws from fixed seeds; tolerance 0 throughout.  Then each kernel's
range: every kernel takes 2^15 and 2^16 and refuses the degree past its
top (2^26; K10's 2^22), each naming its range.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_study_tpu.models import bfv_rns as J
from fhe_study_tpu.ops import ntt as jntt

from fhe_study_tpu_torch.models import bfv_rns as R
from fhe_study_tpu_torch.ops import _cuda, ntt
from fhe_study_tpu_torch.ops import blind_rotate_cuda as brc
from fhe_study_tpu_torch.ops import ntt_cuda as nc
from fhe_study_tpu_torch.ops.primes import ntt_primes
from fhe_study_tpu_torch.utils import interop, prng

N, T = 1 << 15, 256
QS = ntt_primes(3, 30, 1 << 16)
PS = ntt_primes(3, 30, 1 << 16, skip=3)
CPU = torch.device("cpu")


def residues(seed, primes, shape):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, p, shape) for p in primes]
                    ).astype(np.uint32)


def tt(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("mode", ["forward", "forward_mont", "inverse",
                                  "inverse_scale"])
def test_ntt_multi_matches_jax(mode):
    x = residues(1, QS, (1, N))
    mont = mode == "forward_mont"
    scale = tuple(q - 5 for q in QS) if mode == "inverse_scale" else None
    if mode.startswith("forward"):
        got = ntt.ntt_multi(tt(x), QS, mont=mont)
        want = jax.jit(lambda a: jntt.ntt_multi(a, QS, mont=mont))(
            jnp.asarray(x))
    else:
        got = ntt.intt_multi(tt(x), QS, scale=scale)
        want = jax.jit(lambda a: jntt.intt_multi(a, QS, scale=scale))(
            jnp.asarray(x))
    same(got, want)


def test_tensor_eval4_matches_jax():
    ops = [residues(10 + i, QS, (1, N)) for i in range(4)]
    sc = (T,) * len(QS)
    got = ntt.tensor_eval4(*(tt(o) for o in ops), QS, scale=sc)
    want = jax.jit(lambda *o: jntt.tensor_eval4(*o, QS, scale=sc))(
        *(jnp.asarray(o) for o in ops))
    same(got, want)


def test_ext_ntt_matches_jax():
    x = residues(20, QS[:2], (1, 2, N))
    got = ntt.ext_ntt(tt(x), QS[:2], PS)
    want = jax.jit(lambda a: jntt.ext_ntt(a, QS[:2], PS))(jnp.asarray(x))
    same(got, want)


def test_ks_contract_matches_jax():
    edm = residues(30, QS, (1, N))[None]             # [R=1, Lp, B, n]
    kb, ka = (residues(31 + i, QS, (N,))[None] for i in range(2))
    got = ntt.ks_contract_multi(tt(edm), tt(kb), tt(ka), QS)
    want = jax.jit(lambda e, b, a: jntt.ks_contract_multi(e, b, a, QS))(
        jnp.asarray(edm), jnp.asarray(kb), jnp.asarray(ka))
    same(got, tuple(want))


@pytest.mark.parametrize("src", [None, "Q"])
def test_tensor_mul4_matches_jax(src):
    """K6's plain version over two primes, from two source primes too."""
    basis = QS[:2] if src else PS[:2]
    ops = [residues(40 + i, basis, (1, N)) for i in range(4)]
    sc = tuple(range(3, 5))
    kw = dict(scale=sc, src=QS[:2] if src else None)
    got = ntt.tensor_mul4(*(tt(o) for o in ops), PS[:2], **kw)
    want = jax.jit(lambda *o: jntt.tensor_mul4(*o, PS[:2], **kw))(
        *(jnp.asarray(o) for o in ops))
    same(got, want)


def test_tensor_mul_matches_jax():
    """The stacked form (K6's kernel on row strides) over two primes."""
    x4 = residues(50, QS[:2], (1, 4, N))
    sc = (T, T)
    got = ntt.tensor_mul_multi(tt(x4), QS[:2], scale=sc)
    want = jax.jit(lambda a: jntt.tensor_mul_multi(a, QS[:2], scale=sc))(
        jnp.asarray(x4))
    same(got, want)


def test_ks_fused_pair_matches_jax():
    """K7 and K8's plain versions: R = 2 limb rows over two primes, limbs
    over wider primes than the destination (the digit reduction)."""
    c = residues(60, QS[:2], (1, N))
    kb, ka = (np.stack([residues(61 + 2 * i + r, PS[:2], (N,))
                        for r in range(2)]) for i in range(2))
    adds = tuple(residues(66 + i, PS[:2], (1, N)) for i in range(2))
    got = ntt.ks_fused_multi(tt(c), tt(kb), tt(ka), PS[:2], QS[:2])
    want = jax.jit(lambda c, b, a: jntt.ks_fused_multi(c, b, a, PS[:2],
                                                       QS[:2]))(
        *(jnp.asarray(v).astype(jnp.uint64) for v in (c, kb, ka)))
    same(tuple(got), tuple(want))
    got = ntt.ks_fused_eval(tt(c), tt(kb), tt(ka), PS[:2], QS[:2],
                            tuple(tt(a) for a in adds))
    want = jax.jit(lambda c, b, a, a0, a1: jntt.ks_fused_eval(
        c, b, a, PS[:2], QS[:2], (a0, a1)))(
        *(jnp.asarray(v) for v in (c, kb, ka, *adds)))
    same(tuple(got), tuple(want))


def test_mul_e_hybrid_matches_jax():
    """The slice's path at N = 2^15 with the smallest bases that hold its
    capacity (L = 2, M = 3) and K = 3 hybrid primes, B = 1: keys and
    ciphertexts drawn by the port (the reference's jitted key generation
    and encryption would compile for seconds at this degree) and carried
    into JAX; the JAX mul_e on them equals the port's bit for bit, and
    decrypts to the product."""
    jp = J.RnsParam(n=N, t=T, L=2, M=3)
    p = R.RnsParam(n=N, t=T, L=2, M=3)
    gen = prng.Gen(15)
    sk, pk = R.new_key(gen, p, CPU)
    hk = R.hybrid_rlk1(gen, p, sk, K=3)
    ms = [prng.uniform_mod(gen, (1, N), T, CPU) for _ in range(2)]
    x, y = (R.to_evals(p, R.encrypt(gen, p, pk, m, batch=(1,))) for m in ms)
    got = R.mul_e(p, hk, x, y)
    jx, jy, jhk = (tuple(jnp.asarray(a) for a in interop.to_numpy(v))
                   for v in (x, y, hk))
    want = jax.jit(lambda h, x, y: J.mul_e(jp, J.HRLK(*h), J.CTE(*x),
                                           J.CTE(*y)))(jhk, jx, jy)
    same(tuple(got), tuple(want))
    rec = R.decrypt(p, sk, R.from_evals(p, got))
    m1, m2 = (m.numpy()[0] for m in ms)
    lin = np.convolve(m1, m2)
    np.testing.assert_array_equal(rec.numpy()[0],
                                  (lin[:N] - np.append(lin[N:], 0)) % T)


ONE_BUFFER = ("ntt_multi", "tensor_eval4", "ks_contract", "ext_ntt", "ntt",
              "ntt_smem_ceiling")
NARROW = ("tensor_mul4", "tensor_mul", "ks_fused", "ks_fused_eval",
          "blind_rotate")
KERNELS = {k.name: k for k in _cuda.KERNELS}


@pytest.mark.parametrize("name", ONE_BUFFER + NARROW)
def test_kernel_range_at_n_2_15(name):
    """K1, K2, K3, K5, K9 and K12 take n = 2^15, and so do K6, tensor_mul,
    K7 and K8 (on two-block clusters, one half of their three buffers a
    block) and K10 (its working set in device memory, one polynomial a
    block at the one-buffer shape); every one takes 2^16 (across blocks:
    K6, tensor_mul, K7 and K8 too, on their chunked schedules) and refuses
    the degree past its top (2^26; K10's 2^22), with a message that names
    the range, on the card as on any device: the check comes before the
    kernel is built or launched."""
    k = KERNELS[name]
    assert _cuda.log2_degree(N, k) == 15
    top = 22 if name == "blind_rotate" else 26
    assert _cuda.log2_degree(2 * N, k) == 16      # past a block
    with pytest.raises(ValueError,
                       match=f"{name} takes n = 2\\^7 .. 2\\^{top}"):
        _cuda.log2_degree(2 << top, k)
    if name in ONE_BUFFER:
        assert nc._radix_plan(15).threads == nc.WIDE_THREADS
    elif name == "blind_rotate":
        plan = brc._plan(2, 3, N)
        assert (plan.layout, plan.threads) == ("device", nc.WIDE_THREADS)
        assert plan.smem_bytes == 4 * N
    else:
        plan = nc._mul4_plan(15)
        assert (plan.logn, plan.threads) == (14, nc.MUL4_THREADS)
        assert plan.smem_bytes == nc.MUL4_BUFFERS * 4 * N // 2
        assert nc._mul4_plan(15, side=True).smem_bytes <= 232448


def test_narrow_wrappers_refuse_n_2_15():
    """The wrappers of K6, tensor_mul, K7 and K8 raise the range error at
    n = 2^27 before anything else, naming 2^7 .. 2^26 (here on CPU tensors,
    which they would otherwise refuse for their device; views of one word,
    nothing of that size is allocated); at n = 2^15 and 2^16 they pass it
    and refuse the CPU tensors.  K10's checks its operands first."""
    for n, match in ((1 << 27, "takes n = 2\\^7 .. 2\\^26"),
                     (2 * N, "take CUDA tensors"), (N, "take CUDA tensors")):
        x = torch.zeros(1, dtype=torch.int32).expand(2, 1, n)
        keys = torch.zeros(1, dtype=torch.int32).expand(2, 2, n)
        calls = {
            "tensor_mul4": lambda: nc.tensor_mul4_kernel(x, x, x, x, QS[:2]),
            "tensor_mul": lambda: nc.tensor_mul_kernel(
                torch.zeros(1, dtype=torch.int32).expand(2, 1, 4, n),
                QS[:2]),
            "ks_fused": lambda: nc.ks_fused_kernel(x, keys, keys, QS[:2],
                                                   QS[:2]),
            "ks_fused_eval": lambda: nc.ks_fused_eval_kernel(
                x, keys, keys, QS[:2], QS[:2], (x, x)),
        }
        for name, call in calls.items():
            with pytest.raises(ValueError, match=match):
                call()
