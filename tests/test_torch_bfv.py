"""The port's single-modulus BFV (models/bfv.py), its noise probe
(models/bfv_noise.py) and the graft entry (fhe_study_tpu_torch/entry.py)
against the JAX package.

JAX keys and ciphertexts are carried across (utils/interop.py, bit for bit)
and every deterministic function's output is held bit-equal to the jitted
JAX function's: the parity path at the reference tests' n = 16 (tensor,
relinearize, relinearize_f64, mul, mul_const, add, add_const, decrypt),
the device path through the entry's multiply at n = 256, B = 2 (the
reference's configuration otherwise: q = 2^16 + 1, t = 4, p = q^2), and the
key and encryption cores on the JAX samplers' draws.  The noise probe is
held to 1e-9 (it is an integer), the noise bounds to 1e-9 relative.  The
port's own samplers are checked by decryption: the reference tests'
products at n = 16 (parity) and n = 64 (device path) decrypt exactly.
"""

import functools

import numpy as np
import pytest
import torch
import jax

from fhe_study_tpu.arith.params import RingParam as JRingParam
from fhe_study_tpu.models import bfv as JB
from fhe_study_tpu.models import bfv_noise as JN
from fhe_study_tpu.utils import prng as jprng

from fhe_study_tpu_torch import entry as E
from fhe_study_tpu_torch.arith import rn
from fhe_study_tpu_torch.arith.params import RingParam
from fhe_study_tpu_torch.models import bfv as B
from fhe_study_tpu_torch.models import bfv_noise as N
from fhe_study_tpu_torch.utils import interop, prng

CPU = torch.device("cpu")
Q = 2 ** 16 + 1


def tt(a):
    return interop.bits_to_tensor(np.asarray(a), CPU)


def same(got, want):
    got = (got,) if isinstance(got, torch.Tensor) else tuple(got)
    want = (want,) if not isinstance(want, (tuple, list)) else tuple(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(interop.bits_to_numpy(g),
                                      np.asarray(w).astype(np.uint64))


def port(*objs):
    return tuple(interop.to_port(o, CPU) for o in objs)


def naive_product(m1, m2, t):
    """(m1 * m2) mod (X^n + 1, t) by the port's exact schoolbook product."""
    return rn.naive_poly_mul(m1.long(), m2.long()) % t


@functools.lru_cache(maxsize=None)
def jax_state(n: int, t: int, batch: int, seed: int):
    """The JAX package's keys, two messages and their encryptions."""
    jp = JB.Param(JRingParam(Q, n), t, Q * Q)
    ks = jprng.split(jax.random.PRNGKey(seed), 6)
    sk, pk = jax.jit(lambda k: JB.new_key(k, jp, batch=(batch,)))(ks[0])
    rlk = jax.jit(lambda k, s: JB.rlk_key(k, jp, s, batch=(batch,)))(ks[1], sk)
    m1, m2 = (jprng.uniform_mod(k, (batch, n), t) for k in ks[2:4])
    enc = jax.jit(lambda k, m: JB.encrypt(k, jp, pk, m, batch=(batch,)))
    return dict(jp=jp, p=B.Param(RingParam(Q, n), t, Q * Q), ks=ks, sk=sk,
                pk=pk, rlk=rlk, m1=m1, m2=m2, c1=enc(ks[4], m1),
                c2=enc(ks[5], m2))


def test_key_and_encryption_cores_replay_the_reference():
    """new_key_with, rlk_key_with and encrypt_with on the JAX samplers'
    draws equal new_key, rlk_key and encrypt."""
    r = jax_state(16, 2, 8, 3)
    jp, p, sh = r["jp"], r["p"], (8, 16)
    k_s, k_a, k_e = jprng.split(r["ks"][0], 3)
    sk, pk = B.new_key_with(p, tt(jprng.binary(k_s, sh)),
                            tt(jprng.uniform_mod(k_a, sh, Q)),
                            tt(jprng.gaussian_mod(k_e, sh, B.ERR_SIGMA, Q)))
    same(sk + pk, r["sk"] + r["pk"])
    k_a, k_e = jprng.split(r["ks"][1], 2)
    rlk = B.rlk_key_with(p, sk, tt(jprng.uniform_mod(k_a, sh, jp.pq)),
                         tt(jprng.gaussian_mod(k_e, sh, B.ERR_SIGMA, jp.pq)))
    same(rlk, r["rlk"])
    k_u, k_e1, k_e2 = jprng.split(r["ks"][4], 3)
    c1 = B.encrypt_with(p, pk, tt(r["m1"]),
                        torch.from_numpy(np.array(jprng.ternary(k_u, sh))),
                        tt(jprng.gaussian_mod(k_e1, sh, B.ERR_SIGMA, Q)),
                        tt(jprng.gaussian_mod(k_e2, sh, B.ERR_SIGMA, Q)))
    same(c1, r["c1"])


def test_parity_path_matches_reference():
    """The reference tests' n = 16, t = 2, p = q^2 (bfv/src/lib.rs tests):
    every operation of the parity path bit for bit, and the products
    decrypt to the exact plaintext product."""
    r = jax_state(16, 2, 8, 3)
    jp, p = r["jp"], r["p"]
    sk, rlk, c1, c2 = port(r["sk"], r["rlk"], r["c1"], r["c2"])
    m1, m2 = tt(r["m1"]), tt(r["m2"])

    @jax.jit
    def ref(rlk, c1, c2, m2):
        t3 = JB.tensor(jp, c1, c2)
        return (t3, JB.relinearize(jp, rlk, *t3),
                JB.relinearize_f64(jp, rlk, *t3),
                JB.mul_const(jp, rlk, c1, m2),
                JB.add(c1, c2, jp), JB.add_const(jp, c1, m2),
                JB.decrypt(jp, r["sk"], JB.mul(jp, rlk, c1, c2)))

    want = ref(r["rlk"], r["c1"], r["c2"], r["m2"])
    t3 = B.tensor(p, c1, c2)
    got = (t3, B.relinearize(p, rlk, *t3), B.relinearize_f64(p, rlk, *t3),
           B.mul_const(p, rlk, c1, m2), B.add(c1, c2, p),
           B.add_const(p, c1, m2), B.decrypt(p, sk, B.mul(p, rlk, c1, c2)))
    for g, w in zip(got, want):
        same(g, w)
    assert torch.equal(got[-1], naive_product(m1, m2, 2))
    assert torch.equal(B.decrypt(p, sk, got[2]), naive_product(m1, m2, 2))
    assert torch.equal(B.decrypt(p, sk, got[4]), (m1 + m2) % 2)


def test_entry_matches_reference():
    """The graft entry at n = 256, B = 2: the JAX entry's keys and
    ciphertexts (its code, at this n and batch) carried into the port's
    multiply (bfv.mul, fast=True), bit for bit against the jitted JAX
    function; the same function from ``entry`` runs on the CPU, and its own
    fresh ciphertexts decrypt."""
    r = jax_state(256, 4, 2, 0)
    jp = r["jp"]

    def jfn(c1_c0, c1_c1, c2_c0, c2_c1, r0, r1):
        out = JB.mul(jp, JB.RLK(r0, r1), JB.RLWE(c1_c0, c1_c1),
                     JB.RLWE(c2_c0, c2_c1), fast=True)
        return out.c0, out.c1

    args = (*r["c1"], *r["c2"], *r["rlk"])
    want = jax.jit(jfn)(*args)
    fn = E.multiply(r["p"])
    got = fn(*(tt(a) for a in args))
    same(got, want)
    # the port's own entry, built on the CPU
    s = E.setup("cpu", n=256, batch=2)
    fn2, args2 = E.entry("cpu", n=256, batch=2)
    assert all(torch.equal(a, b) for a, b in zip(
        args2, (*s.c1, *s.c2, *s.rlk)))
    out = fn2(*args2)
    assert [tuple(o.shape) for o in out] == [(2, 256)] * 2
    assert all(o.dtype == torch.int64 and int(o.min()) >= 0
               and int(o.max()) < Q for o in out)
    for c in (s.c1, s.c2):
        assert torch.equal(B.decrypt(s.param, s.sk, c), s.m)
    noise = N.measure_noise(s.param, s.sk, B.RLWE(*out),
                            naive_product(s.m, s.m, E.T))
    assert tuple(noise.shape) == (2,) and int(noise.max()) <= Q // 2


def test_noise_probe_and_bounds_match_reference():
    """The measured fresh noise of the entry's ciphertexts (n = 256, t = 4)
    equals the JAX probe's and stays under the reference's bound; the
    bounds agree to 1e-9 at tests/test_bfv_noise.py's configuration
    (n = 128, t = 32) and the entry's."""
    r = jax_state(256, 4, 2, 0)
    p, jp = r["p"], r["jp"]
    sk, c1 = port(r["sk"], r["c1"])
    got = N.measure_noise(p, sk, c1, tt(r["m1"]))
    want = jax.jit(lambda: JN.measure_noise(jp, r["sk"], r["c1"], r["m1"]))()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-9)
    for args in ((Q, 128, 32), (Q, 1024, 4), (2 ** 40 + 15, 4096, 65537)):
        mine, ref = N.bounds(*args), JN.bounds(*args)
        for f in ("fresh_bound", "mul_bound", "rt"):
            np.testing.assert_allclose(getattr(mine, f), getattr(ref, f),
                                       rtol=1e-9)
    assert np.isclose(N.bounds(Q, 128, 32).rt, Q / 32 - Q // 32)
    nb = N.bounds(Q, 256, 4)
    assert (got < nb.fresh_bound).all() and N.fresh_noise_ok(p, sk, c1,
                                                             tt(r["m1"]))


@pytest.mark.parametrize("n, fast", [(16, False), (64, True)])
def test_port_samplers_multiply_and_decrypt(n, fast):
    """The reference tests' mul_relin (n = 16, parity) and
    mul_relin_fast_path (n = 64) on the port's own keys: the product
    decrypts to the exact plaintext product, and so do add and add_const."""
    p = B.Param(RingParam(Q, n), 2, Q * Q)
    gen = prng.Gen(7 + n)
    sk, pk = B.new_key(gen, p, CPU, batch=(16,))
    rlk = B.rlk_key(gen, p, sk, batch=(16,))
    m1, m2 = (prng.uniform_mod(gen, (16, n), 2, CPU) for _ in range(2))
    c1, c2 = (B.encrypt(gen, p, pk, m, batch=(16,)) for m in (m1, m2))
    assert torch.equal(B.decrypt(p, sk, B.mul(p, rlk, c1, c2, fast=fast)),
                       naive_product(m1, m2, 2))
    assert torch.equal(B.decrypt(p, sk, B.add(c1, c2, p)), (m1 + m2) % 2)
    assert torch.equal(B.decrypt(p, sk, B.add_const(p, c1, m2)),
                       (m1 + m2) % 2)
