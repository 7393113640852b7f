"""The port's TFHE layers (GLWE over the torus ring, TLWE, TLev, TGSW, TGLWE,
TGGSW) against the JAX package, bit for bit at n = 128, K = 1, t = 8.

Keys, ciphertexts and random draws come from the JAX package (on the CPU,
under jax.jit) and cross into the port bit for bit (utils/interop.py); the
functions that draw randomness are fed the JAX samplers' draws through their
``*_with`` forms, with the key splits of the JAX functions replayed here.
Tolerance 0 everywhere (integer arithmetic; ``mul_div_round`` is one
correctly rounded float64 expression).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_study_tpu.arith.params import RingParam as JRingParam
from fhe_study_tpu.arith.params import TORUS_Q
from fhe_study_tpu.models.gfhe import glwe as JG
from fhe_study_tpu.models.tfhe import tggsw as jtggsw
from fhe_study_tpu.models.tfhe import tglwe as jtglwe
from fhe_study_tpu.models.tfhe import tgsw as jtgsw
from fhe_study_tpu.models.tfhe import tlev as jtlev
from fhe_study_tpu.models.tfhe import tlwe as jtlwe
from fhe_study_tpu.utils import prng as jprng

from fhe_study_tpu_torch.arith.params import RingParam
from fhe_study_tpu_torch.models.gfhe import glwe as G
from fhe_study_tpu_torch.models.tfhe import tggsw, tglwe, tgsw, tlev, tlwe
from fhe_study_tpu_torch.utils import interop, prng

N, K, T, B = 128, 1, 8, 3
JP = JG.Param(JG.ERR_SIGMA, JRingParam(TORUS_Q, N), K, T)
P = G.Param(G.ERR_SIGMA, RingParam(TORUS_Q, N), K, T)
JS = JG.Param(JG.ERR_SIGMA, JRingParam(TORUS_Q, 1), 16, T)   # scalar torus
PS = G.Param(G.ERR_SIGMA, RingParam(TORUS_Q, 1), 16, T)
CPU = torch.device("cpu")


def tt(a):
    return interop.bits_to_tensor(np.asarray(a), CPU)


def port(obj):
    return interop.to_port(obj, CPU)


def same(got, want):
    """A port tensor (or tuple of them) == reference array(s), as bits."""
    got = (got,) if isinstance(got, torch.Tensor) else tuple(got)
    want = tuple(want) if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        bits = interop.bits_to_numpy(g)          # uint64, or uint32 planes
        np.testing.assert_array_equal(bits, w.astype(bits.dtype))


def keys(seed, n):
    return jprng.split(jax.random.PRNGKey(seed), n)


def torus(seed, shape):
    x = np.random.default_rng(seed).integers(0, 1 << 64, shape,
                                             dtype=np.uint64)
    x.flat[:4] = [0, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
    return x


# -- GLWE over the torus ring --------------------------------------------------

@pytest.fixture(scope="module")
def glwe_ref():
    k = keys(1, 4)
    s, pk = jax.jit(lambda key: JG.new_key(key, JP))(k[0])
    m = jtglwe.encode(JP, jprng.uniform_mod(k[1], (B, N), T))
    ct = jax.jit(lambda key, m: JG.encrypt_s(key, JP, s, m, batch=(B,)))(
        k[2], m)
    ct2 = jax.jit(lambda key, m: JG.encrypt(key, JP, pk, m, batch=(B,)))(
        k[3], m)
    return dict(s=s, pk=pk, m=m, ct=ct, ct2=ct2, key=k[2])


def test_glwe_param_views():
    assert (P.kn, P.lwe().kn, P.lwe().ring.n) == (JP.kn, JP.lwe().kn, 1)
    assert P.pt() == RingParam(T, N)
    z = G.zero(P, CPU, (2,))
    assert tuple(z.a.shape) == (2, K, N) and tuple(z.b.shape) == (2, N)
    p = tt(torus(1, (2, N)))
    same(G.from_plaintext(P, p), JG.from_plaintext(JP, jnp.asarray(
        interop.bits_to_numpy(p))))


def test_glwe_encrypt_s_with_replays_the_reference(glwe_ref):
    r = glwe_ref
    k_a, k_e = jprng.split(r["key"], 2)
    a = jprng.binary(k_a, (B, K, N))
    e = jprng.gaussian_torus(k_e, (B, N), JP.err_sigma)
    ct = G.encrypt_s_with(P, tt(r["s"]), tt(r["m"]), tt(a), tt(e))
    same(ct, r["ct"])
    same(G.decrypt(P, tt(r["s"]), ct),
         jax.jit(lambda s, c: JG.decrypt(JP, s, c))(r["s"], r["ct"]))


def test_glwe_decrypt_of_a_public_key_ciphertext(glwe_ref):
    r = glwe_ref
    same(G.decrypt(P, tt(r["s"]), port(r["ct2"])),
         jax.jit(lambda s, c: JG.decrypt(JP, s, c))(r["s"], r["ct2"]))


@pytest.mark.parametrize("op", ["add", "sub", "neg", "add_pt", "sub_pt",
                                "mul_pt"])
def test_glwe_homomorphic_ops(glwe_ref, op):
    r = glwe_ref
    c0, c1 = port(r["ct"]), port(r["ct2"])
    if op in ("add", "sub"):
        same(getattr(G, op)(P, c0, c1), getattr(JG, op)(JP, r["ct"],
                                                        r["ct2"]))
    elif op == "neg":
        same(G.neg(P, c0), JG.neg(JP, r["ct"]))
    else:
        p = torus(2, (B, N)) if op != "mul_pt" else np.random.default_rng(
            3).integers(0, 4, (B, N)).astype(np.uint64)
        want = jax.jit(lambda c, p: getattr(JG, op)(JP, c, p))(r["ct"], p)
        same(getattr(G, op)(P, c0, tt(p)), want)


def test_glwe_port_keys_and_encryptions_decrypt():
    gen = prng.Gen(4)
    s, pk = G.new_key(gen, P, CPU)
    assert set(s.unique().tolist()) == {0, 1}
    m = prng.uniform_mod(gen, (B, N), T, CPU)
    for ct in (G.encrypt_s(gen, P, s, tglwe.encode(P, m), batch=(B,)),
               G.encrypt(gen, P, pk, tglwe.encode(P, m), batch=(B,))):
        assert torch.equal(tglwe.decode(P, G.decrypt(P, s, ct)), m)


# -- TLWE -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tlwe_ref():
    k = keys(2, 6)
    lwe = JP.lwe()
    s, pk = jtlwe.new_key(k[0], lwe)
    s2, _ = jtlwe.new_key(k[1], lwe)
    m = jprng.uniform_mod(k[2], (B,), T)
    c = jtlwe.encrypt_uniform(k[3], lwe, s, jtlwe.encode(JP, m), batch=(B,))
    cs = jtlwe.encrypt_s(k[4], lwe, s, jtlwe.encode(JP, m), batch=(B,))
    return dict(k=k, s=s, pk=pk, s2=s2, m=m, c=c, cs=cs)


def test_tlwe_new_key_with(tlwe_ref):
    k_s, k_a, k_e = jprng.split(tlwe_ref["k"][0], 3)
    s = jprng.binary(k_s, (N,))
    a = jprng.uniform_u64(k_a, (N,))
    e = jprng.gaussian_torus(k_e, (), JP.err_sigma)
    got_s, got_pk = tlwe.new_key_with(P.lwe(), tt(s), tt(a), tt(e))
    same(got_s, tlwe_ref["s"])
    same(got_pk, tlwe_ref["pk"])


def test_tlwe_encrypt_uniform_with_and_decrypt(tlwe_ref):
    r = tlwe_ref
    k_a, k_e = jprng.split(r["k"][3], 2)
    a = jprng.uniform_u64(k_a, (B, N))
    e = jprng.gaussian_torus(k_e, (B,), JP.err_sigma)
    m = torch.from_numpy(np.asarray(r["m"]).astype(np.int64))
    ct = tlwe.encrypt_uniform_with(P.lwe(), tt(r["s"]), tlwe.encode(P, m),
                                   tt(a), tt(e))
    same(ct, r["c"])
    phase = tlwe.decrypt(P.lwe(), tt(r["s"]), ct)
    same(phase, jtlwe.decrypt(JP.lwe(), r["s"], r["c"]))
    assert torch.equal(tlwe.decode(P, phase), m)


def test_tlwe_encode_decode_on_the_whole_torus():
    m = np.arange(T, dtype=np.uint64)
    same(tlwe.encode(P, torch.arange(T)), jtlwe.encode(JP, m))
    p = torus(5, (4000,))
    same(tlwe.decode(P, tt(p)), jtlwe.decode(JP, jnp.asarray(p)))
    same(tlwe.new_const(P, [3, 5]), jtlwe.new_const(JP, [3, 5]))


@pytest.mark.parametrize("op", ["add", "sub", "add_pt", "sub_pt", "mul_pt",
                                "mod_switch"])
def test_tlwe_ops(tlwe_ref, op):
    c0, c1 = tlwe_ref["c"], tlwe_ref["cs"]
    if op in ("add", "sub"):
        same(getattr(tlwe, op)(port(c0), port(c1)),
             getattr(jtlwe, op)(c0, c1))
    elif op == "mod_switch":
        for q2 in (2 * N, N, 1 << 40):
            same(tlwe.mod_switch(port(c0), q2), jtlwe.mod_switch(c0, q2))
    else:
        p = torus(6, (B,))
        same(getattr(tlwe, op)(port(c0), tt(p)),
             getattr(jtlwe, op)(c0, jnp.asarray(p)))


def test_tlwe_binary_mask_and_public_key_encryptions_decrypt():
    gen = prng.Gen(6)
    lwe = P.lwe()
    s, pk = tlwe.new_key(gen, lwe, CPU)
    m = torch.arange(T)
    for ct in (tlwe.encrypt_s(gen, lwe, s, tlwe.encode(P, m), batch=(T,)),
               tlwe.encrypt(gen, lwe, pk, tlwe.encode(P, m), batch=(T,)),
               tlwe.encrypt_uniform(gen, lwe, s, tlwe.encode(P, m),
                                    batch=(T,))):
        assert torch.equal(tlwe.decode(P, tlwe.decrypt(lwe, s, ct)), m)
    z = tlwe.zero(lwe, CPU, (2,))
    assert tuple(z.a.shape) == (2, N) and tuple(z.b.shape) == (2,)


@pytest.mark.parametrize("uniform", [False, True])
def test_tlwe_new_ksk_with_and_key_switch(tlwe_ref, uniform):
    r = tlwe_ref
    lwe = JP.lwe()
    beta, l = 16, 8
    s_dst = r["s2"] if not uniform else r["s2"][:64]    # kn -> 64 as well
    ksk = jtlwe.new_ksk(r["k"][5], lwe, beta, l, r["s"], s_dst,
                        uniform_mask=uniform)
    k_a, k_e = jprng.split(r["k"][5], 2)
    shape = (N, l, s_dst.shape[-1])
    a = (jprng.uniform_u64 if uniform else jprng.binary)(k_a, shape)
    e = jprng.gaussian_torus(k_e, shape[:2], JP.err_sigma)
    got = tlwe.new_ksk_with(P.lwe(), beta, l, tt(r["s"]), tt(s_dst), tt(a),
                            tt(e))
    same(got, ksk)
    want = jax.jit(lambda k, c: jtlwe.key_switch(lwe, beta, l, k, c))(
        ksk, r["c"])
    switched = tlwe.key_switch(P.lwe(), beta, l, got, port(r["c"]))
    same(switched, want)
    m = torch.from_numpy(np.asarray(r["m"]).astype(np.int64))
    assert torch.equal(
        tlwe.decode(P, tlwe.decrypt(P.lwe(), tt(s_dst), switched)), m)


def test_tlwe_key_switch_in_chunks(tlwe_ref, monkeypatch):
    """The chunked contraction gives the same words whatever the chunk."""
    r = tlwe_ref
    gen = prng.Gen(7)
    ksk = tlwe.new_ksk(gen, P.lwe(), 16, 8, tt(r["s"]), tt(r["s2"]))
    whole = tlwe.key_switch(P.lwe(), 16, 8, ksk, port(r["c"]))
    monkeypatch.setattr(tlwe, "_KS_CHUNK_WORDS", 5 * B * 8 * N)
    parts = tlwe.key_switch(P.lwe(), 16, 8, ksk, port(r["c"]))
    assert torch.equal(whole.a, parts.a) and torch.equal(whole.b, parts.b)


def test_tlev_scales_fold_above_2_63():
    for beta, l in ((2, 64), (16, 8), (4096, 2), (1 << 32, 3)):
        same(tlwe._tlev_scales(beta, l, CPU),
             jtlwe._tlev_scales(beta, l))


# -- TLev and TGSW over the scalar torus -----------------------------------------

@pytest.fixture(scope="module")
def scalar_ref():
    k = keys(3, 5)
    s, pk = jtlwe.new_key(k[0], JS)
    m = jprng.uniform_mod(k[1], (B,), T)
    lev = jtlev.encrypt_s(k[2], JS, 4, 6, s, m, batch=(B,))
    g = jtgsw.encrypt_s(k[3], JS, 4, 6, s, m[0])
    c = jtlwe.encrypt_s(k[4], JS, s, jtlwe.encode(JS, m), batch=(B,))
    return dict(k=k, s=s, pk=pk, m=m, lev=lev, g=g, c=c)


def test_tlev(scalar_ref):
    r = scalar_ref
    lev = tlev.TLev(*(tt(f) for f in r["lev"]))
    same(tlev.decrypt(PS, tt(r["s"]), lev, 4),
         jtlev.decrypt(JS, r["s"], r["lev"], 4))
    v = torus(8, (B, 6))
    same(tlev.mul_vec(lev, tt(v)), jtlev.mul_vec(r["lev"], jnp.asarray(v)))
    same(tlev.decode(PS, tt(v)), jtlev.decode(JS, jnp.asarray(v)))
    same(tlev.encode(PS, [1, 2]), jtlev.encode(JS, [1, 2]))


def test_tlev_port_encryptions_decrypt():
    gen = prng.Gen(8)
    s, pk = tlwe.new_key(gen, PS, CPU)
    m = torch.tensor([1, 2, 3, 1])   # 0 with negative noise decrypts to beta
    for lev in (tlev.encrypt_s(gen, PS, 4, 6, s, m, batch=(4,)),
                tlev.encrypt(gen, PS, 4, 6, pk, m, batch=(4,))):
        assert tuple(lev.a.shape) == (4, 6, PS.kn)
        assert torch.equal(tlev.decode(PS, tlev.decrypt(PS, s, lev, 4)), m)


def test_tgsw_encrypt_s_with_and_products(scalar_ref):
    r = scalar_ref
    k_a, k_e = jprng.split(r["k"][3], 2)
    a = jprng.binary(k_a, (JS.kn + 1, 6, JS.kn))
    e = jprng.gaussian_torus(k_e, (JS.kn + 1, 6), JS.err_sigma)
    m0 = int(r["m"][0])
    g = tgsw.encrypt_s_with(PS, 4, 6, tt(r["s"]), torch.tensor(m0), tt(a),
                            tt(e))
    same(g, r["g"])
    same(tgsw.decrypt(PS, tt(r["s"]), g, 4),
         jtgsw.decrypt(JS, r["s"], r["g"], 4))
    c = tlwe.TLWE(*(tt(f) for f in r["c"]))
    same(tgsw.external_product(PS, 4, 6, g, c),
         jtgsw.external_product(JS, 4, 6, r["g"], r["c"]))
    c2 = tlwe.TLWE(c.a.flip(0), c.b.flip(0))
    jc2 = jtlwe.TLWE(r["c"].a[::-1], r["c"].b[::-1])
    same(tgsw.cmux(PS, 4, 6, g, c, c2),
         jtgsw.cmux(JS, 4, 6, r["g"], r["c"], jc2))
    gen = prng.Gen(9)
    mine = tgsw.encrypt_s(gen, PS, 4, 6, tt(r["s"]), torch.tensor(3))
    assert int(tgsw.decrypt(PS, tt(r["s"]), mine, 4)) == 3


# -- TGLWE ---------------------------------------------------------------------------

def test_tglwe_key_reshapes_and_encodings():
    gen = prng.Gen(10)
    s, pk = tglwe.new_key(gen, P, CPU)
    assert tuple(s.shape) == (K, N) and tuple(pk.a.shape) == (K, N)
    flat = tglwe.sk_to_tlwe(s)
    assert tuple(flat.shape) == (K * N,)
    assert torch.equal(tglwe.sk_to_tglwe(flat, K, N), s)
    m = np.arange(N, dtype=np.uint64) % T
    same(tglwe.encode(P, torch.from_numpy(m.astype(np.int64))),
         jtglwe.encode(JP, m))
    p = torus(11, (2, N))
    same(tglwe.decode(P, tt(p)), jtglwe.decode(JP, jnp.asarray(p)))
    same(tglwe.new_const(P, [1, 2]), jtglwe.new_const(JP, [1, 2]))
    msg = prng.uniform_mod(gen, (2, N), T, CPU)
    for ct in (tglwe.encrypt_s(gen, P, s, tglwe.encode(P, msg), batch=(2,)),
               tglwe.encrypt(gen, P, pk, tglwe.encode(P, msg), batch=(2,))):
        assert torch.equal(tglwe.decode(P, tglwe.decrypt(P, s, ct)), msg)


@pytest.mark.parametrize("h", [0, 1, 77, N - 1])
def test_tglwe_sample_extraction(glwe_ref, h):
    ct = glwe_ref["ct"]
    same(tglwe.sample_extraction(P, port(ct), h),
         jtglwe.sample_extraction(JP, ct, h))


def test_tglwe_left_rotate_and_ops(glwe_ref):
    ct, ct2 = glwe_ref["ct"], glwe_ref["ct2"]
    h = np.array([0, N + 3, 2 * N - 1])
    same(tglwe.left_rotate(P, port(ct), torch.from_numpy(h)),
         jtglwe.left_rotate(JP, ct, jnp.asarray(h)))
    same(tglwe.left_rotate(P, port(ct), 5), jtglwe.left_rotate(JP, ct, 5))
    same(tglwe.add(P, port(ct), port(ct2)), jtglwe.add(JP, ct, ct2))
    same(tglwe.sub(P, port(ct), port(ct2)), jtglwe.sub(JP, ct, ct2))
    p = torus(12, (B, N))
    same(tglwe.add_pt(P, port(ct), tt(p)), jtglwe.add_pt(JP, ct, p))
    same(tglwe.sub_pt(P, port(ct), tt(p)), jtglwe.sub_pt(JP, ct, p))
    same(tglwe.from_plaintext(P, tt(p)), jtglwe.from_plaintext(JP, p))


# -- TGGSW ---------------------------------------------------------------------------

GADGETS = [(256, 3), (4096, 2)]


@pytest.fixture(scope="module", params=GADGETS, ids=["256x3", "4096x2"])
def tggsw_ref(request, glwe_ref):
    beta, l = request.param
    k = keys(4, 2)
    s = glwe_ref["s"]
    m = np.zeros((2, N), np.uint64)
    m[:, 0] = [1, 0]
    m[1, 5] = 3
    g = jax.jit(lambda key: jtggsw.encrypt_s(key, JP, beta, l, s, m,
                                             batch=(2,)))(k[0])
    gev = jax.jit(lambda g: jtggsw.precompute_evals(JP, g))(g)
    return dict(beta=beta, l=l, key=k[0], s=s, m=m, g=g, gev=gev,
                c=glwe_ref["ct"][0][:2], cb=glwe_ref["ct"][1][:2],
                c2=glwe_ref["ct2"][0][:2], c2b=glwe_ref["ct2"][1][:2])


def test_tggsw_encrypt_s_with(tggsw_ref):
    r = tggsw_ref
    k_a, k_e = jprng.split(r["key"], 2)
    a = jprng.binary(k_a, (2, K + 1, r["l"], K, N))
    e = jprng.gaussian_torus(k_e, (2, K + 1, r["l"], N), JP.err_sigma)
    g = tggsw.encrypt_s_with(P, r["beta"], r["l"], tt(r["s"]), tt(r["m"]),
                             tt(a), tt(e))
    same(g, r["g"])
    same(tggsw.decrypt(P, tt(r["s"]), g, r["beta"]),
         jax.jit(lambda g: jtggsw.decrypt(JP, r["s"], g, r["beta"]))(r["g"]))


def test_tggsw_external_product_and_cmux(tggsw_ref):
    r = tggsw_ref
    beta, l = r["beta"], r["l"]
    g = port(r["g"])
    c = G.GLWE(tt(r["c"]), tt(r["cb"]))
    c2 = G.GLWE(tt(r["c2"]), tt(r["c2b"]))
    jc, jc2 = JG.GLWE(r["c"], r["cb"]), JG.GLWE(r["c2"], r["c2b"])
    ext, mux = jax.jit(lambda g, a, b: (
        jtggsw.external_product(JP, beta, l, g, a),
        jtggsw.cmux(JP, beta, l, g, a, b)))(r["g"], jc, jc2)
    same(tggsw.external_product(P, beta, l, g, c), ext)
    same(tggsw.cmux(P, beta, l, g, c, c2), mux)


def test_tggsw_precompute_evals_with_the_shoup_planes(tggsw_ref):
    r = tggsw_ref
    gev = tggsw.precompute_evals(P, port(r["g"]))
    for got, want in zip(gev, r["gev"]):
        assert got.dtype == torch.int32
        want = np.asarray(want)
        assert want.dtype == np.uint32
        np.testing.assert_array_equal(interop.bits_to_numpy(got), want)
    # the companions do span the whole u32 range, and cross bit for bit
    assert int(np.asarray(r["gev"].ev1s).max()) >= 1 << 31
    back = port(r["gev"])
    assert all(torch.equal(a, b) for a, b in zip(back, gev))


def test_tggsw_external_product_evals_and_cmux_evals(tggsw_ref):
    r = tggsw_ref
    beta, l = r["beta"], r["l"]
    gev = port(r["gev"])
    c = G.GLWE(tt(r["c"]), tt(r["cb"]))
    c2 = G.GLWE(tt(r["c2"]), tt(r["c2b"]))
    jc, jc2 = JG.GLWE(r["c"], r["cb"]), JG.GLWE(r["c2"], r["c2b"])
    got = tggsw.external_product_evals(P, gev, c, beta, l)
    ext, mux = jax.jit(lambda gev, a, b: (
        jtggsw.external_product_evals(JP, gev, a, beta, l),
        jtggsw.cmux_evals(JP, beta, l, gev, a, b)))(r["gev"], jc, jc2)
    same(got, ext)
    # the eval-domain product equals the coefficient-domain one
    want = tggsw.external_product(P, beta, l, port(r["g"]), c)
    assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)
    same(tggsw.cmux_evals(P, beta, l, gev, c, c2), mux)


def test_tggsw_external_product_evals_checks_the_crt_capacity():
    gev = tggsw.TGGSWEvals(*(torch.zeros((2, 2, 2, 2, N), dtype=torch.int32)
                             for _ in range(4)))
    c = G.zero(P, CPU)
    with pytest.raises(ValueError, match="CRT capacity"):
        tggsw.external_product_evals(P, gev, c, 1 << 20, 2)


def test_tglev(glwe_ref):
    s = glwe_ref["s"]
    k = keys(5, 1)
    m = np.zeros((N,), np.uint64)
    m[:3] = [1, 2, 3]
    lev = jax.jit(lambda key: jtggsw.tglev_encrypt_s(key, JP, 16, 4, s, m))(
        k[0])
    mine = tggsw.TGLev(*(tt(f) for f in lev))
    v = np.random.default_rng(13).integers(0, 16, (4, N)).astype(np.uint64)
    dec, prod = jax.jit(lambda lev, v: (
        jtggsw.tglev_decrypt(JP, s, lev, 16),
        jtggsw.tglev_mul_vec(JP, lev, v)))(lev, v)
    same(tggsw.tglev_decrypt(P, tt(s), mine, 16), dec)
    same(tggsw.tglev_mul_vec(P, mine, tt(v)), prod)
    same(tggsw.tglev_decode(P, tt(torus(14, (9,)))),
         jtggsw.tglev_decode(JP, jnp.asarray(torus(14, (9,)))))
    same(tggsw.tglev_encode(P, [4, 5]), jtggsw.tglev_encode(JP, [4, 5]))
    gen = prng.Gen(15)
    sk, pk = tglwe.new_key(gen, P, CPU)
    msg = torch.from_numpy(m.astype(np.int64))
    for own in (tggsw.tglev_encrypt_s(gen, P, 16, 4, sk, msg),
                tggsw.tglev_encrypt(gen, P, 16, 4, pk, msg)):
        assert torch.equal(
            tggsw.tglev_decode(P, tggsw.tglev_decrypt(P, sk, own, 16)), msg)
