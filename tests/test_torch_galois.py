"""The port's Galois automorphisms, rotation keys, hybrid key switching and
BFV batching against fhe_study_tpu.models.{galois, hybrid_ks, bfv_batch}.

The JAX side runs its XLA path on the CPU under jax.jit; keys and
ciphertexts cross through utils/interop.py and the ``*_with`` cores take the
JAX samplers' draws.  Tolerance 0 everywhere except where a test decodes
CKKS slots, which states its own (the reference tests').
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_study_tpu.models import bfv_batch as JB
from fhe_study_tpu.models import bfv_rns as JR
from fhe_study_tpu.models import galois as JG
from fhe_study_tpu.models import hybrid_ks as JH
from fhe_study_tpu.models.ckks import ckks_rns as JC
from fhe_study_tpu.utils import prng as jprng

from fhe_study_tpu_torch.models import bfv_batch, bfv_rns, galois
from fhe_study_tpu_torch.models import hybrid_ks as H
from fhe_study_tpu_torch.models.ckks import ckks_rns as C
from fhe_study_tpu_torch.ops import ntt as ntt_mod
from fhe_study_tpu_torch.utils import interop, prng

N, L, B, K = 256, 3, 2, 2
DELTA = 2.0 ** 25
JP = JC.Param(n=N, L=L, delta=DELTA)
P = C.Param(n=N, L=L, delta=DELTA)
CPU = torch.device("cpu")
GS = (5, 2 * N - 1, pow(5, 7, 2 * N))


def i64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def port(obj):
    return interop.to_port(obj, CPU)


def same(got, want):
    got = (got,) if isinstance(got, torch.Tensor) else tuple(got)
    want = tuple(want) if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(interop.to_numpy(g).astype(np.uint64),
                                      np.asarray(w).astype(np.uint64))


@pytest.fixture(scope="module")
def ref():
    ks = jprng.split(jax.random.PRNGKey(14), 8)
    sk, pk = jax.jit(lambda k: JC.new_key(k, JP))(ks[0])
    rng = np.random.default_rng(15)
    z = rng.uniform(-10, 10, (B, N // 2)) + 1j * rng.uniform(-10, 10,
                                                            (B, N // 2))
    m = jax.jit(lambda a, b: JC.encode(JP, a, b))(z.real, z.imag)
    c = jax.jit(lambda k, m: JC.encrypt(k, JP, pk, m, batch=(B,)))(ks[1], m)
    g = JG.rotation_element(N, 3)
    hgk = JH.galois_key_hybrid(ks[2], JP, sk, g)
    gk = jax.jit(lambda k, s: JG.galois_key(k, JP, JC.SecretKey(*s), g))(
        ks[3], sk)
    return dict(ks=ks, sk=sk, pk=pk, z=z, c=c, g=g, hgk=hgk, gk=gk)


@pytest.mark.parametrize("n", [64, 256])
def test_host_maps_match_jax(n):
    for g in (5, 2 * n - 1, pow(5, 9, 2 * n), 3):
        for got, want in zip(galois.galois_map(n, g), JG.galois_map(n, g)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(galois.eval_perm(n, g),
                                      JG.eval_perm(n, g))
        for got, want in zip(galois.ckks_slot_perm(n, g),
                             JG.ckks_slot_perm(n, g)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(galois._eval_exponents(n),
                                  JG._eval_exponents(n))
    for k in (0, 1, 5, -1, n):
        assert galois.rotation_element(n, k) == JG.rotation_element(n, k)
    assert galois.conj_element(n) == JG.conj_element(n)
    with pytest.raises(ValueError, match="odd"):
        galois.galois_map(n, 4)


@pytest.mark.parametrize("t,n", [(65537, 64), (12289, 256)])
def test_slot_maps_and_batching_match_jax(t, n):
    for got, want in zip(bfv_batch._slot_maps(t, n), JB._slot_maps(t, n)):
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(2)
    a = rng.integers(-t, t, (3, 2, n // 2))
    b = rng.integers(0, t, (3, 2, n // 2))
    ea = bfv_batch.batch_encode(t, n, i64(a))
    np.testing.assert_array_equal(
        ea.numpy().astype(np.uint64),
        np.asarray(JB.batch_encode(t, n, jnp.asarray(a))))
    dec = bfv_batch.batch_decode(t, n, ea)
    np.testing.assert_array_equal(
        dec.numpy().astype(np.uint64),
        np.asarray(JB.batch_decode(t, n, jnp.asarray(ea.numpy()))))
    np.testing.assert_array_equal(dec.numpy(), a % t)
    # slot-wise product: the ring product is elementwise on the slots
    eb = bfv_batch.batch_encode(t, n, i64(b))
    prod = ntt_mod.negacyclic_mul(ea, eb, t)
    np.testing.assert_array_equal(bfv_batch.batch_decode(t, n, prod).numpy(),
                                  (a % t) * b % t)
    with pytest.raises(ValueError, match="1 mod 2n"):
        bfv_batch._slot_maps(t + 2, n)


def test_np_ntt_ref_matches_the_transform():
    n, q = 64, 12289
    x = np.random.default_rng(22).integers(0, q, n)
    got = galois._np_ntt_ref(x.astype(np.uint64), ntt_mod.get_plan(q, n))
    np.testing.assert_array_equal(got.astype(np.int64),
                                  ntt_mod.ntt(i64(x), q).numpy())


@pytest.mark.parametrize("g", GS)
def test_apply_galois_matches_jax(ref, g):
    x = ref["c"].c0
    want = jax.jit(lambda v: JG.apply_galois(v, g, JP.qs))(x)
    got = galois.apply_galois(port(ref["c"]).c0, g, P.qs)
    assert got.dtype == torch.int32
    same(got, want)
    src, neg = JG.galois_map(N, g)
    tab = galois.apply_galois_tab(port(ref["c"]).c0, i64(src),
                                  torch.from_numpy(neg), P.qs)
    assert torch.equal(tab, got)
    m = np.random.default_rng(0).integers(-50, 50, (B, N))
    np.testing.assert_array_equal(
        galois.apply_galois_i64(i64(m), g).numpy(),
        np.asarray(JG.apply_galois_i64(jnp.asarray(m), g)))
    # NTT(phi_g(x)) == NTT(x)[eval_perm]
    lhs = ntt_mod.ntt_multi(got, P.qs)
    rhs = ntt_mod.ntt_multi(port(ref["c"]).c0, P.qs)[
        ..., torch.from_numpy(galois.eval_perm(N, g).astype(np.int64))]
    assert torch.equal(lhs, rhs)


def test_galois_key_and_apply_to_ct_match_jax(ref):
    g = ref["g"]
    k_a, k_e = jprng.split(ref["ks"][3], 2)
    a = np.stack([np.stack([np.asarray(jprng.uniform_mod(
        jax.random.fold_in(k_a, i * L + j), (N,), q))
        for j, q in enumerate(JP.qs)]) for i in range(L)])
    e = np.stack([np.asarray(jprng.gaussian_int(
        jax.random.fold_in(k_e, i), (N,), JR.ERR_SIGMA)) for i in range(L)])
    gk = galois.galois_key_with(P, port(ref["sk"]), g,
                                interop.to_tensor(a, CPU), i64(e))
    assert isinstance(gk, bfv_rns.RLK)
    same(gk, tuple(ref["gk"]))
    want = jax.jit(lambda k, c: JG.apply_to_ct(
        JP, JR.RLK(*k), JC.CT(*c), g))(ref["gk"], ref["c"])
    got = galois.apply_to_ct(P, gk, port(ref["c"]), g)
    assert isinstance(got, C.CT)
    same(got, tuple(want))


def _hybrid_draws(key):
    both = JP.qs + JH.ks_ext_primes(JP, K)
    k_a, k_e = jprng.split(key, 2)
    a = jnp.transpose(jprng.uniform_mod_multi(k_a, (L, N), both), (1, 0, 2))
    return (interop.to_tensor(a, CPU),
            i64(jprng.gaussian_int(k_e, (L, N), JR.ERR_SIGMA)))


def test_hybrid_ksk_and_key_switch_match_jax():
    """A BFV ciphertext moved between two keys by the P-extended switch."""
    jp = JR.RnsParam(n=N, t=65537, L=L, M=4)
    p = bfv_rns.RnsParam(n=N, t=65537, L=L, M=4)
    assert H.ks_ext_primes(p, K) == JH.ks_ext_primes(jp, K)
    ks = jprng.split(jax.random.PRNGKey(11), 5)
    new_key = jax.jit(lambda k: JR.new_key(k, jp))
    (sk1, pk1), (sk2, _) = new_key(ks[0]), new_key(ks[1])
    m = jprng.uniform_mod(ks[2], (B, N), jp.t)
    c = jax.jit(lambda k, m: JR.encrypt(k, jp, pk1, m, batch=(B,)))(ks[3], m)
    want_k = JH.hybrid_ksk(ks[4], jp, sk1.s_evals, sk2.s_evals)
    both = jp.qs + JH.ks_ext_primes(jp, K)
    k_a, k_e = jprng.split(ks[4], 2)
    a = jnp.transpose(jprng.uniform_mod_multi(k_a, (L, N), both), (1, 0, 2))
    e = jprng.gaussian_int(k_e, (L, N), JR.ERR_SIGMA)
    got_k = H.hybrid_ksk_with(p, port(sk1).s_evals, port(sk2).s_evals,
                              interop.to_tensor(a, CPU), i64(e), K=K)
    assert isinstance(got_k, H.HybridKSK)
    same(got_k, tuple(want_k))
    assert isinstance(port(want_k), H.HybridKSK)
    want = jax.jit(lambda k, c: JH.hybrid_key_switch(
        jp, JH.HybridKSK(*k), JR.CT(*c)))(want_k, c)
    got = H.hybrid_key_switch(p, got_k, port(c))
    same(got, tuple(want))
    rec = bfv_rns.decrypt(p, port(sk2), got)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(m))


def test_galois_key_hybrid_and_rotations_match_jax(ref):
    g = ref["g"]
    hgk = H.galois_key_hybrid_with(P, port(ref["sk"]), g,
                                   *_hybrid_draws(ref["ks"][2]), K=K)
    same(hgk, tuple(ref["hgk"]))
    c = port(ref["c"])
    want = jax.jit(lambda k, x: JH.rotate_hybrid(
        JP, JH.HybridKSK(*k), JC.CT(*x), g))(ref["hgk"], ref["c"])
    got = H.rotate_hybrid(P, hgk, c, g)
    assert isinstance(got, C.CT)
    same(got, tuple(want))
    # hoisting: the digits, the contraction on them, and the rotation
    want_edm = jax.jit(lambda c1: JH.hoist_digits(JP, c1, K=K))(ref["c"].c1)
    edm = H.hoist_digits(P, c.c1, K=K)
    assert tuple(edm.shape) == (L, L + K, B, N)
    same(edm, want_edm)
    want_r = jax.jit(lambda k, d: JH.ks_hoisted(JP, JH.HybridKSK(*k), d))(
        ref["hgk"], want_edm)
    same(H.ks_hoisted(P, hgk, edm), tuple(want_r))
    want_h = jax.jit(lambda k, x, d: JH.rotate_hoisted(
        JP, JH.HybridKSK(*k), JC.CT(*x), g, d))(ref["hgk"], ref["c"],
                                                  want_edm)
    got_h = H.rotate_hoisted(P, hgk, c, g, edm)
    same(got_h, tuple(want_h))
    assert H.rotate_hoisted(P, hgk, c, 1, edm) is c
    # both decode to the rotated slots (the reference tests' atol)
    perm, conj = galois.ckks_slot_perm(N, g)
    z = np.where(conj, ref["z"][:, perm].conj(), ref["z"][:, perm])
    for out in (got, got_h):
        rr, ri = C.decode(P, C.decrypt_to_coeffs(P, port(ref["sk"]), out))
        np.testing.assert_allclose(rr.numpy() + 1j * ri.numpy(), z,
                                   atol=2e-3)


def test_ckks_keyring_rotation_and_conjugation():
    """GaloisKeys through the gadget key switch: the reference's
    test_ckks_rotation setting (delta = 2^45, |z| <= 10, atol 0.5), composed
    hops and the conjugation."""
    p = C.Param(n=N, L=L, delta=2.0 ** 45)
    gen = prng.Gen(3)
    sk, pk = C.new_key(gen, p, CPU)
    rng = np.random.default_rng(4)
    z = rng.uniform(-10, 10, (B, N // 2)) + 1j * rng.uniform(-10, 10,
                                                            (B, N // 2))
    c = C.encrypt(gen, p, pk, C.encode(p, torch.from_numpy(z.real),
                                       torch.from_numpy(z.imag)), batch=(B,))
    gks = galois.GaloisKeys.for_rotations(gen, p, sk, steps=[1, 2],
                                          conj=True)
    assert sorted(gks.keys) == sorted(
        {galois.rotation_element(N, 1), galois.rotation_element(N, 2),
         galois.conj_element(N)})

    def slots_of(ct):
        rr, ri = C.decode(p, C.decrypt_to_coeffs(p, sk, ct))
        return rr.numpy() + 1j * ri.numpy()

    for k in (1, 3):                       # 3 = 1 + 2: two hops
        perm, conj = galois.ckks_slot_perm(N, galois.rotation_element(N, k))
        want = np.where(conj, z[:, perm].conj(), z[:, perm])
        np.testing.assert_allclose(slots_of(gks.rotate(p, c, k)), want,
                                   atol=0.5)
    assert gks.rotate(p, c, 0) is c
    np.testing.assert_allclose(slots_of(gks.conjugate(p, c)), z.conj(),
                               atol=0.5)
    with pytest.raises(KeyError, match="step 4"):
        gks.rotate(p, c, 4)
    with pytest.raises(KeyError, match="conj=True"):
        galois.GaloisKeys({}).conjugate(p, c)


def test_bfv_batched_rotation_end_to_end():
    """batch encode -> encrypt -> homomorphic row rotation + row swap ->
    decrypt -> decode; slots move like SEAL's rotate_rows (exact)."""
    n, t = 64, 65537
    p = bfv_rns.RnsParam(n=n, t=t, L=3, M=4)
    gen = prng.Gen(7)
    sk, pk = bfv_rns.new_key(gen, p, CPU)
    slots = np.arange(2 * n).reshape(2, 2, n // 2) % t
    m = bfv_batch.batch_encode(t, n, i64(slots))
    c = bfv_rns.encrypt(gen, p, pk, m, batch=(2,))
    gks = galois.GaloisKeys.for_rotations(gen, p, sk, conj=True)
    for k in (1, 3, n // 2 - 1):
        rec = bfv_rns.decrypt(p, sk, gks.rotate(p, c, k))
        np.testing.assert_array_equal(
            bfv_batch.batch_decode(t, n, rec).numpy(),
            np.roll(slots, -k, axis=-1), err_msg=f"rotation by {k}")
    rec = bfv_rns.decrypt(p, sk, gks.conjugate(p, c))
    np.testing.assert_array_equal(bfv_batch.batch_decode(t, n, rec).numpy(),
                                  slots[:, ::-1])
