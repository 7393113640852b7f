"""The port's TFHE bootstrapping against the JAX package, bit for bit at
n = 128, K = 1, t = 8, B <= 4: lookup tables, the bootstrapping keys (the JAX
samplers' draws replayed through the ``*_with`` forms), the whole-chain
blind rotation in plain torch against the Pallas kernel in interpret mode and
against the JAX step-by-step chain, ``blind_rotation`` in every mode,
``bootstrap`` and ``bootstrap_short``; then the port alone on keys from a
``prng.Gen``.  Both gadgets occur: beta = 256 / l = 3 and
beta = 4096 / l = 2; the short pipeline runs n_lwe = 64 steps.  Tolerance 0.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_study_tpu.arith import tn as jtn
from fhe_study_tpu.arith.params import RingParam as JRingParam
from fhe_study_tpu.arith.params import TORUS_Q
from fhe_study_tpu.models.gfhe import glwe as JG
from fhe_study_tpu.models.tfhe import bootstrap as jboot
from fhe_study_tpu.models.tfhe import tglwe as jtglwe
from fhe_study_tpu.models.tfhe import tlwe as jtlwe
from fhe_study_tpu.ops import blind_rotate_pallas as brp
from fhe_study_tpu.utils import prng as jprng

from fhe_study_tpu_torch.arith.params import RingParam
from fhe_study_tpu_torch.models.gfhe import glwe as G
from fhe_study_tpu_torch.models.tfhe import bootstrap, tglwe, tlwe
from fhe_study_tpu_torch.ops import _cuda
from fhe_study_tpu_torch.ops import blind_rotate_cuda as brc
from fhe_study_tpu_torch.utils import interop, prng

N, K, T, B, N_LWE = 128, 1, 8, 4, 64
BETA_KS, L_KS = 16, 8
JP = JG.Param(JG.ERR_SIGMA, JRingParam(TORUS_Q, N), K, T)
P = G.Param(G.ERR_SIGMA, RingParam(TORUS_Q, N), K, T)
CPU = torch.device("cpu")
GADGETS = {"256x3": (256, 3), "4096x2": (4096, 2)}


def tt(a):
    return interop.bits_to_tensor(np.asarray(a), CPU)


def port(obj):
    return interop.to_port(obj, CPU)


def same(got, want):
    got = (got,) if isinstance(got, torch.Tensor) else tuple(got)
    want = tuple(want) if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        bits = interop.bits_to_numpy(g)          # uint64, or uint32 planes
        np.testing.assert_array_equal(bits, w.astype(bits.dtype))


@lru_cache(maxsize=None)
def ref(gadget: str):
    """JAX keys and ciphertexts for one gadget: the full-chain key (output
    key = input key), the short key, uniform-mask and tiny-mask ciphertexts
    of B messages."""
    beta, l = GADGETS[gadget]
    k = jprng.split(jax.random.PRNGKey(len(gadget) + beta), 6)
    s, _ = jax.jit(lambda key: jtglwe.new_key(key, JP))(k[0])
    s_flat = jtglwe.sk_to_tlwe(s)
    btk, s_out = jax.jit(lambda key, s, sf: jboot.new_bootstrapping_key(
        key, JP, s, beta=beta, l=l, beta_ks=BETA_KS, l_ks=L_KS,
        s_lwe_out=sf))(k[1], s, s_flat)
    sbtk = jax.jit(lambda key, s: jboot.new_short_bootstrapping_key(
        key, JP, s, n_lwe=N_LWE, beta=beta, l=l, beta_ks=BETA_KS,
        l_ks=L_KS))(k[2], s)
    m = jnp.arange(B, dtype=jnp.uint64) % jnp.uint64(T // 2)
    c = jtlwe.encrypt_uniform(k[3], JP.lwe(), s_flat, jtlwe.encode(JP, m),
                              batch=(B,))
    m_all = jnp.arange(T, dtype=jnp.uint64)
    c_tiny = jtlwe.encrypt_s(k[4], JP.lwe(), s_flat, jtlwe.encode(JP, m_all),
                             batch=(T,))
    gev = jax.jit(lambda b: jboot.precompute_btk_evals(JP, b))(btk)
    return dict(beta=beta, l=l, k=k, s=s, s_flat=s_flat, btk=btk, sbtk=sbtk,
                m=m, c=c, m_all=m_all, c_tiny=c_tiny, gev=gev,
                table=jboot.compute_lookup_table_standard(JP))


def kernel_operands(r, c, gev):
    """What blind_rotation hands the fused chain, from the JAX functions:
    (shifts, acc0) for ciphertext c, as numpy."""
    steps = c.a.shape[-1]
    c2 = jtlwe.TLWE(a=jtn.mod_switch_round(c.a, 2 * N),
                    b=jtn.mod_switch_round(c.b, 2 * N))
    acc0 = jtglwe.left_rotate(JP, r["table"], c2.b + jnp.uint64(N // T))
    shifts = (jnp.uint64(2 * N) - c2.a.reshape(-1, steps).T) % jnp.uint64(
        2 * N)
    a0 = jnp.concatenate([acc0.a.reshape(-1, K, N),
                          acc0.b.reshape(-1, 1, N)], axis=1)
    return np.asarray(shifts.astype(jnp.int32)), np.asarray(a0)


@pytest.mark.parametrize("kind", ["reference", "standard"])
def test_lookup_tables(kind):
    mine, theirs = {
        "reference": (bootstrap.compute_lookup_table,
                      jboot.compute_lookup_table),
        "standard": (bootstrap.compute_lookup_table_standard,
                     jboot.compute_lookup_table_standard)}[kind]
    same(mine(P, CPU), theirs(JP))


def test_new_bootstrapping_key_with_replays_the_reference():
    r = ref("256x3")
    beta, l = r["beta"], r["l"]
    k_btk, _, k_ksk = jprng.split(r["k"][1], 3)
    ka, ke = jprng.split(k_btk, 2)
    btk_draws = (jprng.binary(ka, (N, K + 1, l, K, N)),
                 jprng.gaussian_torus(ke, (N, K + 1, l, N), JP.err_sigma))
    ka, ke = jprng.split(k_ksk, 2)
    ksk_draws = (jprng.binary(ka, (N, L_KS, N)),
                 jprng.gaussian_torus(ke, (N, L_KS), JP.err_sigma))
    got = bootstrap.new_bootstrapping_key_with(
        P, tt(r["s"]), tt(r["s_flat"]), tuple(map(tt, btk_draws)),
        tuple(map(tt, ksk_draws)), beta=beta, l=l, beta_ks=BETA_KS,
        l_ks=L_KS)
    same(got, r["btk"])
    same(bootstrap.precompute_btk_evals(P, got), r["gev"])


def test_new_short_bootstrapping_key_with_replays_the_reference():
    r = ref("4096x2")
    beta, l = r["beta"], r["l"]
    k_short, k_btk, k_ksk = jprng.split(r["k"][2], 3)
    s_short = jprng.binary(k_short, (N_LWE,))
    ka, ke = jprng.split(k_btk, 2)
    btk_draws = (jprng.binary(ka, (N_LWE, K + 1, l, K, N)),
                 jprng.gaussian_torus(ke, (N_LWE, K + 1, l, N),
                                      JP.err_sigma))
    ka, ke = jprng.split(k_ksk, 2)
    ksk_draws = (jprng.uniform_u64(ka, (N, L_KS, N_LWE)),
                 jprng.gaussian_torus(ke, (N, L_KS), JP.err_sigma))
    got = bootstrap.new_short_bootstrapping_key_with(
        P, tt(r["s"]), tt(s_short), tuple(map(tt, btk_draws)),
        tuple(map(tt, ksk_draws)), beta=beta, l=l, beta_ks=BETA_KS,
        l_ks=L_KS)
    same(got, r["sbtk"])
    with pytest.raises(ValueError, match="shrink"):
        bootstrap.new_short_bootstrapping_key_with(
            P, tt(r["s"]), tt(r["s_flat"]), (), (), beta=beta, l=l)


@pytest.mark.parametrize("gadget,short", [("256x3", False), ("4096x2", True)])
def test_blind_rotate_plain_matches_the_pallas_kernel(gadget, short):
    """The plain chain against the JAX package's fused kernel in interpret
    mode; with the short key the chain has N_LWE < kn steps."""
    r = ref(gadget)
    beta, l = r["beta"], r["l"]
    w = beta.bit_length() - 1
    if short:
        sb = r["sbtk"]
        c = jax.jit(lambda k, c: jtlwe.key_switch(
            JP.lwe(), BETA_KS, L_KS, k, c))(jtlwe.KSK(sb.ksk_a, sb.ksk_b),
                                            r["c"])
        gev = jax.jit(lambda b: jboot.precompute_short_btk_evals(JP, b))(sb)
    else:
        c, gev = r["c"], r["gev"]
    shifts, a0 = kernel_operands(r, c, gev)
    assert shifts.shape == ((N_LWE if short else N), B)
    want = brp.blind_rotate_fused(jnp.asarray(shifts), jnp.asarray(a0),
                                  gev.ev1, gev.ev1s, gev.ev2, gev.ev2s, N,
                                  w=w, interpret=True)
    pg = port(gev)
    args = (torch.from_numpy(shifts.copy()), tt(a0), pg.ev1, pg.ev1s, pg.ev2,
            pg.ev2s, N, w)
    got = brc.blind_rotate_plain(*args)
    same(got, want)
    before = _cuda.launches()
    assert torch.equal(brc.blind_rotate_fused(*args), got)   # CPU: plain
    assert _cuda.launches() == before


def test_blind_rotate_wrappers_check_their_operands():
    pg = port(ref("256x3")["gev"])
    shifts = torch.zeros((N, B), dtype=torch.int32)
    acc0 = torch.zeros((B, K + 1, N), dtype=torch.int64)
    with pytest.raises(ValueError, match="take CUDA tensors"):
        brc.blind_rotate_kernel(shifts, acc0, *(pg[i] for i in (0, 2, 1, 3)),
                                N, 8)
    with pytest.raises(ValueError, match="acc0 has shape"):
        brc.blind_rotate_plain(shifts, acc0[:, :, :64], pg.ev1, pg.ev1s,
                               pg.ev2, pg.ev2s, N, 8)
    with pytest.raises(ValueError, match="ev2s has shape"):
        brc.blind_rotate_plain(shifts, acc0, pg.ev1, pg.ev1s, pg.ev2,
                               pg.ev2s[:5], N, 8)
    with pytest.raises(ValueError, match="digit width"):
        brc.blind_rotate_plain(shifts, acc0, pg.ev1, pg.ev1s, pg.ev2,
                               pg.ev2s, N, 30)


def test_supported():
    big = G.Param(G.ERR_SIGMA, RingParam(TORUS_Q, 1024), 1, T)
    assert brc.supported(big, 4096, 2) and brc.supported(big, 256, 3)
    assert brc.supported(P, 256, 3)                     # n = 128: 2^7 on
    assert not brc.supported(big, 4096, 6)              # w * l > 64
    assert not brc.supported(big, 3000, 2)              # not a power of two
    assert not brc.supported(big, 1 << 14, 2)           # CRT capacity
    wide = G.Param(G.ERR_SIGMA, RingParam(TORUS_Q, 1 << 14), 1, T)
    assert brc.supported(wide, 16, 2)                   # past shared memory:
    assert brc._plan(2, 2, 1 << 14).layout == "device"  # in device memory
    widest = G.Param(G.ERR_SIGMA, RingParam(TORUS_Q, 1 << 15), 1, T)
    assert brc.supported(widest, 256, 3)
    assert brc.supported(G.Param(G.ERR_SIGMA, RingParam(TORUS_Q, 1 << 16),
                                  1, T), 16, 2)         # 2^16: across blocks
    assert brc._plan(2, 2, 1 << 16).layout == "split"    # on clusters
    assert brc._plan(2, 2, 1 << 17).layout == "quarter"  # in quarters
    assert brc._plan(2, 2, 1 << 18).layout == "grid"
    # one prime's buffers a block, the step's key planes staged beside them
    assert brc._plan(2, 2, 1024).smem_bytes == 208 * 1024 + 32


@pytest.mark.parametrize("mode", ["standard", "standard_own_evals",
                                  "standard_slow", "reference"])
def test_blind_rotation_modes(mode):
    """Every dispatch of blind_rotation against the JAX step-by-step chain:
    the fused chain and fused=False with given evals, the evals made inside,
    fast=False (coefficient-domain cmux), and the reference mode."""
    r = ref("256x3")
    beta, l = r["beta"], r["l"]
    btk = port(r["btk"])
    if mode == "reference":
        jtable, table = jboot.compute_lookup_table(JP), \
            bootstrap.compute_lookup_table(P, CPU)
        c, kw = r["c_tiny"], dict(mode="reference")
    else:
        jtable = r["table"]
        table = bootstrap.compute_lookup_table_standard(P, CPU)
        c, kw = r["c"], dict(mode="standard")
    fast = mode != "standard_slow"
    want = jax.jit(lambda b, t, c: jboot.blind_rotation(
        JP, b, t, c, beta=beta, l=l, fast=fast, fused=False, **kw))(
            r["btk"], jtable, c)
    if mode == "standard":
        gev = port(r["gev"])
        same(bootstrap.blind_rotation(P, btk, table, port(c), beta, l,
                                      btk_evals=gev, **kw), want)
        same(bootstrap.blind_rotation(P, btk, table, port(c), beta, l,
                                      btk_evals=gev, fused=False, **kw), want)
    else:
        same(bootstrap.blind_rotation(P, btk, table, port(c), beta, l,
                                      fast=fast, **kw), want)
    with pytest.raises(ValueError, match="mode"):
        bootstrap.blind_rotation(P, btk, table, port(c), beta, l, mode="x")


@pytest.mark.parametrize("gadget", list(GADGETS))
def test_bootstrap_matches_reference(gadget):
    r = ref(gadget)
    beta, l = r["beta"], r["l"]
    kw = dict(beta=beta, l=l, beta_ks=BETA_KS, l_ks=L_KS)
    want = jax.jit(lambda b, t, c, g: jboot.bootstrap(
        JP, b, t, c, mode="standard", btk_evals=g, fused=False, **kw))(
            r["btk"], r["table"], r["c"], r["gev"])
    table = bootstrap.compute_lookup_table_standard(P, CPU)
    got = bootstrap.bootstrap(P, port(r["btk"]), table, port(r["c"]),
                              btk_evals=port(r["gev"]), **kw)
    same(got, want)
    rec = tlwe.decode(P, tlwe.decrypt(P.lwe(), tt(r["s_flat"]), got))
    same(rec, r["m"])


@pytest.mark.parametrize("gadget", list(GADGETS))
def test_bootstrap_short_matches_reference(gadget):
    r = ref(gadget)
    beta, l = r["beta"], r["l"]
    kw = dict(beta=beta, l=l, beta_ks=BETA_KS, l_ks=L_KS)
    want = jax.jit(lambda b, t, c: jboot.bootstrap_short(
        JP, b, t, c, fused=False, **kw))(r["sbtk"], r["table"], r["c"])
    table = bootstrap.compute_lookup_table_standard(P, CPU)
    sbtk = port(r["sbtk"])
    got = bootstrap.bootstrap_short(
        P, sbtk, table, port(r["c"]),
        btk_evals=bootstrap.precompute_short_btk_evals(P, sbtk), **kw)
    same(got, want)
    rec = tlwe.decode(P, tlwe.decrypt(P.lwe(), tt(r["s_flat"]), got))
    same(rec, r["m"])


# -- the port alone, keys from a prng.Gen ------------------------------------

@lru_cache(maxsize=None)
def own():
    gen = prng.Gen(11)
    table = bootstrap.compute_lookup_table_standard(P, CPU)
    s, _ = tglwe.new_key(gen, P, CPU)
    s_flat = tglwe.sk_to_tlwe(s)
    return gen, table, s, s_flat


def test_port_bootstrap_returns_the_messages_under_a_fresh_key():
    gen, table, s, s_flat = own()
    kw = dict(beta=256, l=3, beta_ks=BETA_KS, l_ks=L_KS)
    btk, s_out = bootstrap.new_bootstrapping_key(gen, P, s, **kw)
    assert not torch.equal(s_out, s_flat)
    m = torch.arange(8) % (T // 2)
    c = tlwe.encrypt_uniform(gen, P.lwe(), s_flat, tlwe.encode(P, m),
                             batch=(8,))
    assert int(c.a.max()) > 1 << 60          # uniform masks: a real chain
    out = bootstrap.bootstrap(P, btk, table, c, **kw)
    assert torch.equal(tlwe.decode(P, tlwe.decrypt(P.lwe(), s_out, out)), m)


def test_port_bootstrap_short_composes():
    gen, table, s, s_flat = own()
    kw = dict(beta=4096, l=2, beta_ks=BETA_KS, l_ks=L_KS)
    sbtk = bootstrap.new_short_bootstrapping_key(gen, P, s, n_lwe=N_LWE, **kw)
    assert tuple(sbtk.ksk_a.shape) == (N, L_KS, N_LWE)
    evals = bootstrap.precompute_short_btk_evals(P, sbtk)
    m = torch.arange(8) % (T // 2)
    c = tlwe.encrypt_uniform(gen, P.lwe(), s_flat, tlwe.encode(P, m),
                             batch=(8,))
    first = bootstrap.bootstrap_short(P, sbtk, table, c, btk_evals=evals,
                                      **kw)
    second = bootstrap.bootstrap_short(P, sbtk, table, first,
                                       btk_evals=evals, **kw)
    for out in (first, second):
        assert torch.equal(
            tlwe.decode(P, tlwe.decrypt(P.lwe(), s_flat, out)), m)
    with pytest.raises(ValueError, match="shrink"):
        bootstrap.new_short_bootstrapping_key(gen, P, s, n_lwe=N, **kw)


def test_port_bootstrap_refreshes_noise():
    """Output noise is independent of (larger) input noise."""
    gen, table, s, s_flat = own()
    kw = dict(beta=256, l=3, beta_ks=BETA_KS, l_ks=L_KS)
    btk, s_out = bootstrap.new_bootstrapping_key(gen, P, s,
                                                 s_lwe_out=s_flat, **kw)
    m = torch.tensor([1, 2, 3])
    p = tlwe.encode(P, m)
    noisy = p + ((1 << 64) // (8 * T))          # a quarter of a slot
    c = tlwe.encrypt_uniform(gen, P.lwe(), s_flat, noisy, batch=(3,))
    out = bootstrap.bootstrap(P, btk, table, c, **kw)
    phase = interop.bits_to_numpy(tlwe.decrypt(P.lwe(), s_out, out))
    ideal = interop.bits_to_numpy(p)
    err = np.minimum(phase - ideal, ideal - phase)       # wrapping uint64
    assert (err < np.uint64(1 << 54)).all(), err
