"""The port's GLWE over Z_q (the Rq half of models/gfhe/glwe.py), GLev
(models/gfhe/glev.py) and single-modulus CKKS (models/ckks/ckks.py) against
the JAX package, at the reference tests' sizes (tests/test_glwe.py: q =
2^16 + 1, n = 128, k = 16; tests/test_ckks.py: n = 32 and 16).

JAX keys and ciphertexts are carried across (utils/interop.py, bit for bit)
and held bit-equal through encode, decrypt, decode, mod_switch, the
homomorphic operations, key_switch, the GLev decrypt and gadget product;
the ``*_with`` cores replay the JAX samplers' draws (encrypt_s, the GLev
encryption, new_ksk, the CKKS keys and encryption) and equal the JAX
samplers' outputs.  The port's own samplers are checked by decryption, and
CKKS decode by the JAX test's own criterion (every slot rounds to its
value).  Tolerance 0 otherwise.
"""

import functools

import numpy as np
import torch
import jax
import jax.numpy as jnp

from fhe_study_tpu.arith.params import RingParam as JRingParam
from fhe_study_tpu.models.ckks import ckks as JC
from fhe_study_tpu.models.gfhe import glev as JGL
from fhe_study_tpu.models.gfhe import glwe as JG
from fhe_study_tpu.utils import prng as jprng

from fhe_study_tpu_torch.arith.params import RingParam
from fhe_study_tpu_torch.models.ckks import Encoder
from fhe_study_tpu_torch.models.ckks import ckks as C
from fhe_study_tpu_torch.models.gfhe import glev as GL
from fhe_study_tpu_torch.models.gfhe import glwe as G
from fhe_study_tpu_torch.ops import modops
from fhe_study_tpu_torch.utils import interop, prng

CPU = torch.device("cpu")
Q = 2 ** 16 + 1
K, N = 16, 128
BATCH = 2


def tt(a):
    return interop.bits_to_tensor(np.asarray(a), CPU)


def same(got, want):
    got = (got,) if isinstance(got, torch.Tensor) else tuple(got)
    want = (want,) if not isinstance(want, (tuple, list)) else tuple(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(interop.bits_to_numpy(g),
                                      np.asarray(w).astype(np.uint64))


def params(n: int, t: int):
    return (JG.Param(JG.ERR_SIGMA, JRingParam(Q, n), K, t),
            G.Param(G.ERR_SIGMA, RingParam(Q, n), K, t))


def rand_glwe(seed: int, shape: tuple, k: int, n: int, q: int = Q):
    rng = np.random.default_rng(seed)
    return JG.GLWE(a=jnp.asarray(rng.integers(0, q, shape + (k, n),
                                              dtype=np.uint64)),
                   b=jnp.asarray(rng.integers(0, q, shape + (n,),
                                              dtype=np.uint64)))


@functools.lru_cache(maxsize=None)
def glwe_state(t: int):
    """A JAX key, a message, its secret-key encryption, and a second
    ciphertext of random residues at n = 128, k = 16."""
    jp, p = params(N, t)
    ks = jprng.split(jax.random.PRNGKey(t), 4)
    sk = jprng.binary(ks[0], (BATCH, K, N))
    m = jprng.uniform_mod(ks[1], (BATCH, N), t)
    enc_s = jax.jit(lambda k, m: JG.encrypt_s(k, jp, sk, JG.encode(jp, m),
                                              batch=(BATCH,)))
    return dict(jp=jp, p=p, ks=ks, sk=sk, m=m,
                c=rand_glwe(t, (BATCH,), K, N), cs=enc_s(ks[3], m))


def test_encode_decrypt_and_linear_ops_match_reference():
    """tests/test_glwe.py's encrypt/decrypt and addition configurations
    (t = 32), bit for bit on a JAX encryption and a random ciphertext."""
    r = glwe_state(32)
    jp, p = r["jp"], r["p"]
    sk = tt(r["sk"])
    c, cs = (interop.to_port(x, CPU) for x in (r["c"], r["cs"]))
    m = tt(r["m"])

    @jax.jit
    def ref(sk, c, cs, m):
        pt = JG.encode(jp, m)
        return (pt, JG.decrypt(jp, sk, c),
                JG.decode(jp, JG.decrypt(jp, sk, c)),
                JG.decode(jp, JG.decrypt(jp, sk, cs)), JG.add(jp, c, cs),
                JG.sub(jp, c, cs), JG.add_pt(jp, c, pt), JG.sub_pt(jp, c, pt))

    want = ref(r["sk"], r["c"], r["cs"], r["m"])
    pt = G.encode(p, m)
    got = (pt, G.decrypt(p, sk, c), G.decode(p, G.decrypt(p, sk, c)),
           G.decode(p, G.decrypt(p, sk, cs)), G.add(p, c, cs),
           G.sub(p, c, cs), G.add_pt(p, c, pt), G.sub_pt(p, c, pt))
    for g, w in zip(got, want):
        same(g, w)
    assert torch.equal(got[3], m)
    two = G.add(p, cs, cs)
    assert torch.equal(G.decode(p, G.decrypt(p, sk, two)), 2 * m % 32)


def test_encrypt_s_core_replays_the_reference():
    r = glwe_state(32)
    k_a, k_e = jprng.split(r["ks"][3], 2)
    a = jprng.binary(k_a, (BATCH, K, N))
    e = jprng.gaussian_mod(k_e, (BATCH, N), G.ERR_SIGMA, Q)
    got = G.encrypt_s_with(r["p"], tt(r["sk"]),
                           G.encode(r["p"], tt(r["m"])), tt(a), tt(e))
    same(got, r["cs"])


def test_mul_pt_and_mod_switch_match_reference():
    """tests/test_glwe.py's mul_plaintext (n = 16, t = 4) and mod_switch
    (n = 8, t = 4, q -> 2^8 + 1) configurations, bit for bit on random
    ciphertexts; the switched encryption of a port key decrypts under the
    switched key."""
    q2 = 2 ** 8 + 1
    jp16, p16 = params(16, 4)
    jc = rand_glwe(9, (BATCH,), K, 16)
    pm = np.random.default_rng(10).integers(0, Q, (BATCH, 16), dtype=np.uint64)
    same(G.mul_pt(p16, interop.to_port(jc, CPU), tt(pm)),
         jax.jit(lambda c, m: JG.mul_pt(jp16, c, m))(jc, jnp.asarray(pm)))
    jp8, p8 = params(8, 4)
    jc = rand_glwe(11, (BATCH,), K, 8)
    same(G.mod_switch(p8, interop.to_port(jc, CPU), q2),
         jax.jit(lambda c: JG.mod_switch(jp8, c, q2))(jc))
    gen = prng.Gen(12)
    sk, pk = G.new_key(gen, p8, CPU, batch=(BATCH,))
    m = prng.uniform_mod(gen, (BATCH, 8), 4, CPU)
    c2 = G.mod_switch(p8, G.encrypt(gen, p8, pk, G.encode(p8, m),
                                    batch=(BATCH,)), q2)
    p2 = G.Param(G.ERR_SIGMA, RingParam(q2, 8), K, 4)
    assert torch.equal(G.decode(p2, G.decrypt(p2, modops.coerce_u64(sk, q2),
                                              c2)), m)


def ksk_draws(key, k: int, l: int, n: int):
    """The JAX draws of new_ksk: k GLevs, l levels each, (a, e) a level:
    a [k, l, k, n], e [k, l, n]."""
    def level(kk):
        k_a, k_e = jprng.split(kk, 2)
        return (jprng.binary(k_a, (k, n)),
                jprng.gaussian_mod(k_e, (n,), JG.ERR_SIGMA, Q))

    levels = jax.vmap(lambda kk: jprng.split(kk, l))(jprng.split(key, k))
    return jax.jit(jax.vmap(jax.vmap(level)))(levels)


def test_ksk_core_replays_the_reference():
    """new_ksk_with on the JAX draws equals new_ksk (k = 2, l = 1, beta =
    2^16 at n = 128: the reference's new_ksk unrolls k * l encryptions)."""
    jp = JG.Param(JG.ERR_SIGMA, JRingParam(Q, N), 2, 2)
    p = G.Param(G.ERR_SIGMA, RingParam(Q, N), 2, 2)
    ks = jprng.split(jax.random.PRNGKey(13), 3)
    sk, sk2 = (jprng.binary(k, (2, N)) for k in ks[:2])
    want = jax.jit(lambda k: JG.new_ksk(k, jp, 1 << 16, 1, sk, sk2))(ks[2])
    a, e = ksk_draws(ks[2], 2, 1, N)
    same(G.new_ksk_with(p, 1 << 16, 1, tt(sk), tt(sk2), tt(a), tt(e)), want)


def test_key_switch_matches_reference():
    """tests/test_glwe.py's key switch (beta = 2, l = 16, t = 2, k = 16): an
    unbatched KSK (new_ksk_with on the JAX draws) on a batch of JAX
    ciphertexts, bit for bit against the jitted reference, decrypting
    under the new key."""
    jp, p = params(N, 2)
    beta, l = 2, 16
    ks = jprng.split(jax.random.PRNGKey(5), 5)
    sk, sk2 = (jprng.binary(k, (K, N)) for k in ks[:2])
    a, e = ksk_draws(ks[2], K, l, N)
    ksk = G.new_ksk_with(p, beta, l, tt(sk), tt(sk2), tt(a), tt(e))
    m = jprng.uniform_mod(ks[3], (BATCH, N), 2)
    jc = jax.jit(lambda k: JG.encrypt_s(k, jp, sk, JG.encode(jp, m),
                                        batch=(BATCH,)))(ks[4])
    want = jax.jit(lambda k, c: JG.key_switch(jp, beta, l, k, c))(
        JG.KSK(*(jnp.asarray(interop.bits_to_numpy(x)) for x in ksk)), jc)
    got = G.key_switch(p, beta, l, ksk, interop.to_port(jc, CPU))
    same(got, want)
    assert torch.equal(G.decode(p, G.decrypt(p, tt(sk2), got)), tt(m))


def test_glev_matches_reference():
    """tests/test_glwe.py's GLev: the sk encryption's core on the JAX draws
    (l = 2, beta = 256), then the [1]-level decrypt and the gadget product
    with a digit vector at beta = 2, l = 16, on a random GLev."""
    jp, p = params(N, 2)
    ks = jprng.split(jax.random.PRNGKey(6), 3)
    jsk = jprng.binary(ks[0], (K, N))
    m = jprng.uniform_mod(ks[1], (N,), 2)
    jg = jax.jit(lambda k: JGL.encrypt_s(k, jp, 256, 2, jsk, m))(ks[2])
    k_a, k_e = jax.vmap(lambda kk: jprng.split(kk, 2))(
        jprng.split(ks[2], 2)).swapaxes(0, 1)
    a = jax.vmap(lambda kk: jprng.binary(kk, (K, N)))(k_a)
    e = jax.vmap(lambda kk: jprng.gaussian_mod(kk, (N,), JG.ERR_SIGMA, Q))(k_e)
    sk = tt(jsk)
    same(GL.encrypt_s_with(p, 256, 2, sk, tt(m), tt(a), tt(e)), jg)
    rng = np.random.default_rng(7)
    g = JG.GLev(*(jnp.asarray(rng.integers(0, Q, shp, dtype=np.uint64))
                  for shp in ((16, K, N), (16, N))))
    v = rng.integers(0, 2, (16, N), dtype=np.uint64)

    @jax.jit
    def ref(g, v):
        return JGL.decrypt(jp, jsk, g, 2), JGL.mul_vec(jp, g, v)

    want = ref(g, jnp.asarray(v))
    pg = interop.to_port(g, CPU)
    same(GL.decrypt(p, sk, pg, 2), want[0])
    same(GL.mul_vec(p, pg, tt(v)), want[1])


def test_port_samplers_round_trip():
    """The port's own keys at n = 128, k = 16: both encryptions decrypt;
    a KSK drawn by the port switches keys; the pk-encrypted GLev
    decrypts."""
    _, p = params(N, 2)
    gen = prng.Gen(8)
    sk, pk = G.new_key(gen, p, CPU, batch=(4,))
    m = prng.uniform_mod(gen, (4, N), 2, CPU)
    for c in (G.encrypt(gen, p, pk, G.encode(p, m), batch=(4,)),
              G.encrypt_s(gen, p, sk, G.encode(p, m), batch=(4,))):
        assert torch.equal(G.decode(p, G.decrypt(p, sk, c)), m)
    s1, pk1 = G.new_key(gen, p, CPU)
    s2, _ = G.new_key(gen, p, CPU)
    ksk = G.new_ksk(gen, p, 2, 16, s1, s2)
    c = G.encrypt(gen, p, pk1, G.encode(p, m), batch=(4,))
    assert torch.equal(G.decode(p, G.decrypt(p, s2, G.key_switch(p, 2, 16,
                                                                 ksk, c))), m)
    g = GL.encrypt(gen, p, 2, 16, pk1, m[0])
    assert torch.equal(modops.coerce_u64(GL.decrypt(p, s1, g, 2), 2), m[0])


# -- single-modulus CKKS ------------------------------------------------------

def _rand_z(rng, batch, half, t):
    return (rng.integers(0, t, size=batch + (half,))
            + 1j * rng.integers(0, t, size=batch + (half,)))


def test_ckks_matches_reference():
    """tests/test_ckks.py's configurations: keys and encryptions replayed
    on the JAX draws (n = 32, t = 50, delta = 512), decrypt, add, sub and
    the reference's sign quirk bit for bit, and encode -> encrypt ->
    decrypt -> decode at n = 16, delta = 1024, where every slot rounds to
    its value as the JAX test holds."""
    n, t, delta, bt = 32, 50, 512, 16
    jp, p = JC.Param(JRingParam(Q, n), t), C.Param(RingParam(Q, n), t)
    ks = jprng.split(jax.random.PRNGKey(0), 3)
    jsk, jpk = jax.jit(lambda k: JC.new_key(k, jp, batch=(bt,)))(ks[0])
    k_s, k_a, k_e = jprng.split(ks[0], 3)
    sh = (bt, n)
    sk, pk = C.new_key_with(
        p, *(torch.from_numpy(np.array(jprng.ternary(k, sh)))
             for k in (k_s, k_a)),
        tt(jprng.gaussian_mod(k_e, sh, C.ERR_SIGMA, Q)))
    same(sk + pk, jsk + jpk)
    m = np.random.default_rng(1).integers(0, t, size=sh) * delta
    enc = jax.jit(lambda k: JC.encrypt(k, jp, jpk, m, batch=(bt,)))
    jc1, jc2 = (enc(k) for k in ks[1:])
    k_v, k_e0, k_e1 = jprng.split(ks[1], 3)
    c1 = C.encrypt_with(p, pk, torch.from_numpy(m),
                        torch.from_numpy(np.array(jprng.ternary(k_v, sh))),
                        *(tt(jprng.gaussian_mod(k, sh, C.ERR_SIGMA, Q))
                          for k in (k_e0, k_e1)))
    same(c1, jc1)
    c2 = interop.to_port(jc2, CPU)

    @jax.jit
    def ref(c1, c2):
        return (JC.decrypt(jp, jsk, c1).astype(jnp.uint64), JC.add(jp, c1, c2),
                JC.sub(jp, c1, c2), JC.sub_reference_quirk(jp, c1, c2))

    want = ref(jc1, jc2)
    got = (C.decrypt(p, sk, c1), C.add(p, c1, c2), C.sub(p, c1, c2),
           C.sub_reference_quirk(p, c1, c2))
    for g, w in zip(got, want):
        same(g, w)
    assert (np.round(got[0].numpy() / delta).astype(np.int64) % Q
            == m // delta % Q).all()

    n, t, delta = 16, 8, 1024.0
    p = C.Param(RingParam(Q, n), t)
    enc, rng, gen = Encoder(n, delta), np.random.default_rng(5), prng.Gen(9)
    sk, pk = C.new_key(gen, p, CPU, batch=(bt,))
    z0, z1 = _rand_z(rng, (bt,), n // 2, t), _rand_z(rng, (bt,), n // 2, t)
    ct0, ct1 = (C.encrypt(gen, p, pk, torch.from_numpy(enc.encode(z)),
                          batch=(bt,)) for z in (z0, z1))
    for ct, z in ((ct0, z0), (C.add(p, ct0, ct1), z0 + z1),
                  (C.sub(p, ct0, ct1), z0 - z1)):
        zd = enc.decode(C.decrypt(p, sk, ct).numpy())
        np.testing.assert_array_equal(np.round(zd.real), z.real)
        np.testing.assert_array_equal(np.round(zd.imag), z.imag)
