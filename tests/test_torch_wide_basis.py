"""The base conversion from 16 to 31 source primes, against the JAX package
bit for bit.

The reference's fixed-point alpha sums Ls terms below 2^59 in u64, so it
converts from up to 31 source primes; the port's plain version adds them in
int64, which wraps as u64 does past 2^63, and takes bits 59 .. 63.  Here, on
the CPU at n = 256 with seeded numpy inputs, each port function runs its
plain version and the JAX package its XLA path under ``jax.jit``:
``fast_base_extend`` from 16, 29, 30 and 31 source primes, unsigned and
centered, and with the (w - ext) * c epilogue of the BFV scaling (the JAX
package's XLA form of it), at inputs whose last coefficient has every
y_i = s_i - 1 (the largest alpha sum, past 2^63); the fused extension and
forward transform (K5) and the coefficient-domain tensor from a source basis
(K6) from 31 primes; then RNS-BFV at L = 15, M = 16, where the
tensor converts from 16 primes and the hybrid key's K = 16 primes from 16:
the gadget key generation on the JAX package's draws, and ``mul`` and
``mul_e`` with the gadget and the hybrid key and ``key_switch`` on keys and
ciphertexts that
the port draws and utils/interop.py carries into JAX, decrypted against a
numpy negacyclic product.  A basis of 32 primes raises, naming 1 .. 31.
Tolerance 0 throughout.
"""

from math import prod

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_study_tpu.models import bfv_rns as J
from fhe_study_tpu.ops import modops32 as J32
from fhe_study_tpu.ops import ntt as jntt
from fhe_study_tpu.utils import prng as jprng

from fhe_study_tpu_torch.models import bfv_rns as R
from fhe_study_tpu_torch.ops import ext_cuda, ntt
from fhe_study_tpu_torch.ops.primes import ntt_primes
from fhe_study_tpu_torch.utils import interop, prng

N, T = 256, 256
POOL = ntt_primes(37, 30, 1 << 16)      # 5 destination, up to 32 source
DST, SRC = POOL[:5], POOL[5:]
CPU = torch.device("cpu")


def tt(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def same(got, want):
    got = (got,) if isinstance(got, torch.Tensor) else tuple(got)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(interop.to_numpy(g).astype(np.int64),
                                      np.asarray(w).astype(np.int64))


def wide_input(seed: int, src: tuple) -> np.ndarray:
    """[Ls, 2, n] residues whose last coefficient has y_i = s_i - 1 in
    every row (x_i = (s_i - 1) (S/s_i) mod s_i): the largest alpha sum."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, s, (2, N)) for s in src])
    S = prod(src)
    for i, s in enumerate(src):
        x[i, -1, -1] = (s - 1) * (S // s % s) % s
    return x.astype(np.uint32)


@pytest.mark.parametrize("ls", [16, 29, 30, 31])
def test_fast_base_extend_matches_jax(ls):
    src = SRC[:ls]
    x = wide_input(ls, src)
    # the fixed-point sum at the last coefficient passes 2^63
    cfix = sum((s - 1) * ((1 << 59) // s) for s in src)
    assert cfix >= 1 << 63 or ls == 16
    assert cfix + (1 << 58) >= 1 << 63 and cfix + (1 << 58) < 1 << 64
    w = np.stack([np.random.default_rng(100 + ls).integers(0, d, (2, N))
                  for d in DST]).astype(np.uint32)
    c = tuple(int(v) for v in np.random.default_rng(200 + ls).integers(
        1, 1 << 30, len(DST)))
    dv, dnq, _ = (jnp.asarray(v) for v in J32.consts(DST, 3))
    cm = jnp.asarray(np.array([(v % d << 32) % d for v, d in zip(c, DST)],
                              np.uint32)).reshape(dv.shape)

    @jax.jit
    def ref(x, w):
        outs = [J.fast_base_extend(x, src, DST, centered=cen)
                for cen in (False, True)]
        # the BFV scaling's epilogue in the JAX package's XLA form
        epi = J32.mont_mul(J32.submod(w, outs[0], dv), cm, dv, dnq)
        return (*outs, epi)

    want = ref(jnp.asarray(x), jnp.asarray(w))
    got = tuple(ext_cuda.base_extend_fused(tt(x), src, DST, centered=cen)
                for cen in (False, True))
    got += (ext_cuda.base_extend_fused(tt(x), src, DST, w=tt(w),
                                       sub_mul=c),)
    same(got, want)
    # through the model's entry and the two halves (K11's plain version)
    same(R.fast_base_extend(tt(x), src, DST, centered=True), want[1])
    ys, alpha = ext_cuda.lift_plain(tt(x), src, centered=True)
    assert int(alpha.min()) >= 0 and int(alpha.max()) <= ls
    same(ext_cuda.base_extend_sum_plain(ys, alpha, src, DST), want[1])


@pytest.mark.parametrize("ls", [31])
def test_ext_ntt_and_tensor_mul4_from_a_wide_basis_match_jax(ls):
    """K5 (the extension fused with the forward transform) and K6 with a
    source basis: their plain versions from 31 source primes (16 runs on
    the path of the BFV tests below)."""
    src = SRC[:ls]
    x = wide_input(300 + ls, src)
    ops = [wide_input(310 + ls + i, src)[:, :1] for i in range(4)]
    sc = tuple(range(3, 3 + len(DST)))

    @jax.jit
    def ref(x, *ops):
        return (jntt.ext_ntt(x, src, DST),
                jntt.tensor_mul4(*ops, DST, scale=sc, src=src))

    want = ref(jnp.asarray(x), *(jnp.asarray(o) for o in ops))
    same((ntt.ext_ntt(tt(x), src, DST),
          ntt.tensor_mul4(*(tt(o) for o in ops), DST, scale=sc, src=src)),
         want)


def test_a_basis_of_32_primes_raises():
    x = tt(np.zeros((32, 1, N), np.uint32))
    src = SRC[:32]
    for call in (lambda: ext_cuda.base_extend_fused(x, src, DST),
                 lambda: ext_cuda.lift_plain(x, src),
                 lambda: R.fast_base_extend(x, src, DST, centered=True),
                 lambda: ntt.ext_ntt(x, src, DST),
                 lambda: ntt.tensor_mul4(x, x, x, x, DST, src=src)):
        with pytest.raises(ValueError, match="32 primes.*1 \\.\\. 31"):
            call()


# RNS-BFV at L = 15 (450 bits of Q), M = 16: the tensor's P -> Q conversion
# from 16 primes; the hybrid key over K = 16 primes, so that P_K > Q and its
# P-division converts from 16
L, M, K, B = 15, 16, 16, 1
JP = J.RnsParam(n=N, t=T, L=L, M=M)
P = R.RnsParam(n=N, t=T, L=L, M=M)


def negacyclic(a, b):
    lin = np.convolve(a, b)
    return (lin[:N] - np.append(lin[N:], 0)) % T


def test_key_generation_at_l_15_matches_jax():
    """new_key and the gadget relin key from the JAX package's draws (its
    samplers, replayed on the same PRNG keys in the same jit) fed to the
    port's cores."""
    @jax.jit
    def ref(key):
        k_key, k_rlk = jprng.split(key, 2)
        sk, pk = J.new_key(k_key, JP)
        rlk = J.rlk_key(k_rlk, JP, sk)
        k_s, k_a, k_e = jprng.split(k_key, 3)
        draws = (jprng.binary(k_s, (N,)),
                 jprng.uniform_mod_multi(k_a, (N,), JP.qs),
                 jprng.gaussian_int(k_e, (N,), J.ERR_SIGMA))
        k_a, k_e = jprng.split(k_rlk, 2)
        rdraws = (jprng.uniform_mod_multi(k_a, (L, N), JP.qs),
                  jprng.gaussian_int(k_e, (L, N), J.ERR_SIGMA))
        return sk, pk, rlk, draws, rdraws

    sk, pk, rlk, (s, a, e), (ra, re) = ref(jax.random.PRNGKey(16))
    psk, ppk = R.new_key_with(P, torch.tensor(np.asarray(s)).long(),
                              interop.to_tensor(a, CPU),
                              torch.tensor(np.asarray(e)).long())
    same(psk, tuple(sk))
    same(ppk, tuple(pk))
    same(R.rlk_key_with(P, psk, interop.to_tensor(ra, CPU).transpose(0, 1),
                        torch.tensor(np.asarray(re)).long()), tuple(rlk))


@pytest.fixture(scope="module")
def wide():
    gen = prng.Gen(1516)
    sk, pk = R.new_key(gen, P, CPU)
    keys = {"RLK": R.rlk_key(gen, P, sk),
            "HRLK": R.hybrid_rlk1(gen, P, sk, K=K)}
    sk2, _ = R.new_key(gen, P, CPU)
    ksk = R.ksk_key(gen, P, sk, sk2)
    ms = [prng.uniform_mod(gen, (B, N), T, CPU) for _ in range(2)]
    cts = [R.encrypt(gen, P, pk, m, batch=(B,)) for m in ms]
    return dict(sk=sk, sk2=sk2, keys=keys, ksk=ksk, cts=cts,
                ms=[m.numpy()[0] for m in ms])


def _jax(x):
    return tuple(jnp.asarray(a) for a in interop.to_numpy(x))


# J.mul is the tensor then the relinearization its key selects: each is
# jitted once (the tensor for both keys).  J.mul_e with the gadget key equals
# to_evals of J.mul on from_evals of its operands (its contract, which the
# reference's own tests pin), so the gadget mul_e is held against that
# composition and the hybrid one against J.mul_e itself: one XLA compile of
# the whole eval-resident multiply instead of two
_tensor = jax.jit(lambda x, y: J._tensor(JP, J.CT(*x), J.CT(*y)))
_relin = {"RLK": jax.jit(lambda k, c0, c1, c2: J.relinearize(
              JP, J.RLK(*k), c0, c1, c2)),
          "HRLK": jax.jit(lambda k, c0, c1, c2: J.relinearize_hybrid(
              JP, J.HRLK(*k), c0, c1, c2))}
_to_evals = jax.jit(lambda c: J.to_evals(JP, J.CT(*c)))
_from_evals = jax.jit(lambda ce: J.from_evals(JP, J.CTE(*ce)))
_mul_e_hybrid = jax.jit(lambda k, x, y: J.mul_e(JP, J.HRLK(*k), J.CTE(*x),
                                                J.CTE(*y)))


@pytest.mark.parametrize("kind", ["RLK", "HRLK"])
def test_mul_and_mul_e_at_l_15_match_jax(wide, kind):
    key = wide["keys"][kind]
    jkey = _jax(key)
    x, y = wide["cts"]
    ex, ey = (R.to_evals(P, c) for c in (x, y))
    want_mul = _relin[kind](jkey, *_tensor(_jax(x), _jax(y)))
    if kind == "HRLK":
        want_mul_e = _mul_e_hybrid(jkey, _jax(ex), _jax(ey))
    else:
        c = (_from_evals(_jax(v)) for v in (ex, ey))
        want_mul_e = _to_evals(_relin[kind](jkey, *_tensor(*c)))
    got = (R.mul(P, key, x, y), R.mul_e(P, key, ex, ey))
    for g, w in zip(got, (want_mul, want_mul_e)):
        same(g, tuple(w))
    prod_m = negacyclic(*wide["ms"])
    for c in (got[0], R.from_evals(P, got[1])):
        np.testing.assert_array_equal(R.decrypt(P, wide["sk"], c).numpy()[0],
                                      prod_m)


def test_key_switch_at_l_15_matches_jax(wide):
    c = wide["cts"][0]
    want = jax.jit(lambda k, c: J.key_switch(JP, J.RLK(*k), J.CT(*c)))(
        _jax(wide["ksk"]), _jax(c))
    got = R.key_switch(P, wide["ksk"], c)
    same(got, tuple(want))
    np.testing.assert_array_equal(R.decrypt(P, wide["sk2"], got).numpy()[0],
                                  wide["ms"][0])
