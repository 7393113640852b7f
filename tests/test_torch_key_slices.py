"""TFHE bootstrapping keys generated in slices of CMux steps, bit for bit.

``tggsw.encrypt_s_with`` encrypts a key of many steps a slice of steps at a
time (``tggsw.EVALS_SLICE_WORDS`` mask words a slice, forced small here so
that a key of 10 steps takes three slices and a remainder or more), after
the whole mask and noise are drawn in one go.  Held here at N = 128 (K = 1)
and N = 256 (K = 2), n_lwe = 10:

  * the sliced ``new_short_bootstrapping_key`` and ``new_bootstrapping_key``
    equal the unsliced keys drawn from the same ``prng.Gen`` seed, for
    btk_a, btk_b, ksk_a, ksk_b, the short key (decrypted back out of the
    TGGSWs) and the output key;
  * the sliced ``*_with`` forms, and the sliced generators, fed the port's
    draws, equal the JAX package's ``new_short_bootstrapping_key`` and
    ``new_bootstrapping_key`` on those draws (its samplers answered with
    them, under jax.jit);
  * ``bootstrap_short`` (the plain chain) on the sliced key decodes;
  * at the card's path (N = 2^17, beta = 2^5, l = 6 and 7) the plan takes
    K10's quarter layout (the grid layout where named) and ``supported``
    holds, though each eval plane holds more than 2^31 words (nothing
    runs).

Tolerance 0.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_study_tpu.arith.params import RingParam as JRingParam
from fhe_study_tpu.arith.params import TORUS_Q
from fhe_study_tpu.models.gfhe import glwe as JG
from fhe_study_tpu.models.tfhe import bootstrap as jboot
from fhe_study_tpu.utils import prng as jprng

from fhe_study_tpu_torch.arith.params import RingParam
from fhe_study_tpu_torch.models.gfhe import glwe as G
from fhe_study_tpu_torch.models.tfhe import bootstrap, tggsw, tglwe, tlwe
from fhe_study_tpu_torch.ops import blind_rotate_cuda as brc
from fhe_study_tpu_torch.utils import interop, prng

T, N_LWE, BETA_KS, L_KS, BETA, L = 8, 10, 16, 8, 256, 3
RINGS = [(128, 1), (256, 2)]                 # (N, K)
# steps a slice: 10 steps -> 3, 3, 3, 1 and 4, 4, 2
PER_SLICE = [3, 4]
CPU = torch.device("cpu")


def param(n, k):
    return G.Param(G.ERR_SIGMA, RingParam(TORUS_Q, n), k, T)


def slices_of(monkeypatch, n, k, per_slice):
    """Force a slice of ``per_slice`` steps: the budget in mask words."""
    monkeypatch.setattr(tggsw, "EVALS_SLICE_WORDS",
                        per_slice * (k + 1) * L * k * n)


def secret(n, k):
    s, _ = tglwe.new_key(prng.Gen(n + k), param(n, k), CPU)
    return s


def assert_keys_equal(got, want):
    assert type(got) is type(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("per_slice", PER_SLICE)
@pytest.mark.parametrize("n,k", RINGS)
def test_sliced_short_key_is_the_unsliced_key(monkeypatch, n, k, per_slice):
    p, s = param(n, k), secret(n, k)
    kw = dict(n_lwe=N_LWE, beta=BETA, l=L, beta_ks=BETA_KS, l_ks=L_KS)
    whole = bootstrap.new_short_bootstrapping_key(prng.Gen(3), p, s, **kw)
    slices_of(monkeypatch, n, k, per_slice)
    calls = []
    real = tggsw._b_of
    monkeypatch.setattr(tggsw, "_b_of",
                        lambda *a: calls.append(a[4].shape[0]) or real(*a))
    sliced = bootstrap.new_short_bootstrapping_key(prng.Gen(3), p, s, **kw)
    assert calls == [per_slice] * (N_LWE // per_slice) + [N_LWE % per_slice]
    assert_keys_equal(sliced, whole)
    # the short key, decrypted back out of the sliced TGGSWs, is the seed's
    s_short = prng.binary(prng.Gen(3), (N_LWE,), CPU)
    bits = tggsw.decrypt(p, s, tggsw.TGGSW(a=sliced.btk_a, b=sliced.btk_b),
                         BETA) % BETA            # a noisy 0 rounds to BETA
    assert torch.equal(bits[:, 0], s_short)
    assert not bits[:, 1:].any()


@lru_cache(maxsize=None)
def whole_full_key(n, k):
    """The unsliced full key (at the module's slice budget, which takes a
    key of N <= 256 whole) and its output key."""
    assert tggsw.EVALS_SLICE_WORDS >= k * n * (k + 1) * L * k * n
    return bootstrap.new_bootstrapping_key(
        prng.Gen(4), param(n, k), secret(n, k), beta=BETA, l=L,
        beta_ks=BETA_KS, l_ks=L_KS)


# 128 keys -> 4 x 29 + 12 and 2 x 50 + 28; 512 -> 17 x 29 + 19, 10 x 50 + 12
@pytest.mark.parametrize("per_slice", [29, 50])
@pytest.mark.parametrize("n,k", RINGS)
def test_sliced_full_key_is_the_unsliced_key(monkeypatch, n, k, per_slice):
    p, s = param(n, k), secret(n, k)
    kw = dict(beta=BETA, l=L, beta_ks=BETA_KS, l_ks=L_KS)
    whole, out_whole = whole_full_key(n, k)
    slices_of(monkeypatch, n, k, per_slice)
    sliced, out_sliced = bootstrap.new_bootstrapping_key(prng.Gen(4), p, s,
                                                         **kw)
    assert p.kn % per_slice
    assert_keys_equal(sliced, whole)
    assert torch.equal(out_sliced, out_whole)


def port_draws(gen, shapes):
    """The port's draws in its generators' order: (sampler, shape) each."""
    samplers = {"binary": prng.binary, "uniform_u64": prng.uniform_u64,
                "gaussian": lambda g, shp, dev: prng.gaussian_torus(
                    g, shp, G.ERR_SIGMA, dev)}
    return [samplers[kind](gen, shape, CPU) for kind, shape in shapes]


def reference_on(fn, draws):
    """fn() (a JAX package generator) with its samplers answered by
    ``draws`` in order, under jax.jit (the draws its arguments)."""
    def run(*given):
        queue = list(given)

        def take(key, shape, *_):
            x = queue.pop(0)
            assert x.shape == tuple(shape)
            return x
        saved = {f: getattr(jprng, f) for f in ("binary", "uniform_u64",
                                                "gaussian_torus")}
        for f in saved:
            setattr(jprng, f, take)
        try:
            out = fn()
        finally:
            for f, v in saved.items():
                setattr(jprng, f, v)
        assert not queue
        return out
    return jax.jit(run)(*(jnp.asarray(interop.bits_to_numpy(d))
                          for d in draws))


def same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(interop.bits_to_numpy(g),
                                      np.asarray(w))


@pytest.mark.parametrize("n,k", RINGS)
def test_sliced_short_key_matches_the_reference_on_port_draws(monkeypatch,
                                                              n, k):
    p, s = param(n, k), secret(n, k)
    jp = JG.Param(JG.ERR_SIGMA, JRingParam(TORUS_Q, n), k, T)
    kn = k * n
    draws = port_draws(prng.Gen(5), [
        ("binary", (N_LWE,)), ("binary", (N_LWE, k + 1, L, k, n)),
        ("gaussian", (N_LWE, k + 1, L, n)),
        ("uniform_u64", (kn, L_KS, N_LWE)), ("gaussian", (kn, L_KS))])
    want = reference_on(lambda: jboot.new_short_bootstrapping_key(
        jax.random.PRNGKey(0), jp, jnp.asarray(interop.bits_to_numpy(s)),
        n_lwe=N_LWE, beta=BETA, l=L, beta_ks=BETA_KS, l_ks=L_KS), draws)
    slices_of(monkeypatch, n, k, 3)
    kw = dict(beta=BETA, l=L, beta_ks=BETA_KS, l_ks=L_KS)
    same(bootstrap.new_short_bootstrapping_key_with(
        p, s, draws[0], draws[1:3], draws[3:], **kw), want)
    same(bootstrap.new_short_bootstrapping_key(prng.Gen(5), p, s,
                                               n_lwe=N_LWE, **kw), want)


@pytest.mark.parametrize("n,k", RINGS)
def test_sliced_full_key_matches_the_reference_on_port_draws(monkeypatch, n,
                                                             k):
    p, s = param(n, k), secret(n, k)
    jp = JG.Param(JG.ERR_SIGMA, JRingParam(TORUS_Q, n), k, T)
    kn = k * n
    s_out = prng.binary(prng.Gen(6), (kn,), CPU)
    draws = port_draws(prng.Gen(7), [
        ("binary", (kn, k + 1, L, k, n)), ("gaussian", (kn, k + 1, L, n)),
        ("binary", (kn, L_KS, kn)), ("gaussian", (kn, L_KS))])
    want, _ = reference_on(lambda: jboot.new_bootstrapping_key(
        jax.random.PRNGKey(0), jp, jnp.asarray(interop.bits_to_numpy(s)),
        beta=BETA, l=L, beta_ks=BETA_KS, l_ks=L_KS,
        s_lwe_out=jnp.asarray(interop.bits_to_numpy(s_out))), draws)
    slices_of(monkeypatch, n, k, 50)
    kw = dict(beta=BETA, l=L, beta_ks=BETA_KS, l_ks=L_KS)
    same(bootstrap.new_bootstrapping_key_with(p, s, s_out, draws[:2],
                                              draws[2:], **kw), want)
    got, out = bootstrap.new_bootstrapping_key(prng.Gen(7), p, s,
                                               s_lwe_out=s_out, **kw)
    same(got, want)
    assert out is s_out


def test_bootstrap_short_on_a_sliced_key_decodes(monkeypatch):
    n, k, batch = 128, 1, 4
    p = param(n, k)
    gen = prng.Gen(8)
    s, _ = tglwe.new_key(gen, p, CPU)
    s_flat = tglwe.sk_to_tlwe(s)
    slices_of(monkeypatch, n, k, 3)
    kw = dict(beta=BETA, l=L, beta_ks=BETA_KS, l_ks=L_KS)
    sbtk = bootstrap.new_short_bootstrapping_key(gen, p, s, n_lwe=N_LWE,
                                                 **kw)
    m = torch.arange(batch) % (T // 2)
    c = tlwe.encrypt_uniform(gen, p.lwe(), s_flat, tlwe.encode(p, m),
                             batch=(batch,))
    out = bootstrap.bootstrap_short(
        p, sbtk, bootstrap.compute_lookup_table_standard(p, CPU), c,
        btk_evals=bootstrap.precompute_short_btk_evals(p, sbtk), **kw)
    assert torch.equal(tlwe.decode(p, tlwe.decrypt(p.lwe(), s_flat, out)), m)


@pytest.mark.parametrize("l", [6, 7])
def test_the_path_at_n_2_17_takes_the_grid(l):
    """The card's path at N = 2^17 (K = 1, beta = 2^5): the reference's
    gate admits it, the plan is the quarter layout (the grid layout, which
    the path took before it, where the caller names it), and each eval
    plane of a 400-step key holds more than 2^31 words, so the kernel's
    key offsets must be 64-bit (a step's slice, F 2C n words, stays
    32-bit)."""
    n, beta, steps = 1 << 17, 1 << 5, 400
    p = G.Param(G.ERR_SIGMA, RingParam(TORUS_Q, n), 1, 64)
    assert brc.supported(p, beta, l)
    assert 2 * l * n * beta < 1 << 26
    plan = brc._plan(2, l, n)
    assert plan.layout == "quarter" and plan.forward_polys == 2 * l
    assert plan.scratch_bytes == 2 * 4 * n * 2 * l
    plan = brc._plan(2, l, n, layout="grid")
    assert plan.layout == "grid" and plan.forward_polys == 2 * l
    assert plan.scratch_bytes == 2 * 4 * n * (2 * l + max(2 * l, 4))
    plane_words = steps * 2 * l * 2 * 2 * n
    assert plane_words >= 1 << 31
    assert 2 * l * 4 * n < 1 << 31
