"""The port's RNS-BFV paths on its own samplers, decrypt-verified against
numpy: the coefficient-domain multiply with either relin key, the gadget
``mul_e``, the linear pipeline, key switching, and depth 2 with a modulus
drop.  No JAX function is called here."""

import numpy as np
import pytest
import torch

from fhe_study_tpu_torch.models import bfv_rns as R
from fhe_study_tpu_torch.utils import prng

N, B = 256, 2
CPU = torch.device("cpu")


def negacyclic(a, b, t):
    """a * b mod (X^n + 1, t) for [B, n] integer arrays."""
    n = a.shape[-1]
    lin = np.stack([np.convolve(x, y) for x, y in zip(a, b)])
    lin = np.concatenate([lin, np.zeros(lin.shape[:-1] + (1,), lin.dtype)],
                         -1)
    return (lin[:, :n] - lin[:, n:]) % t


def setup(param, seed, count=2):
    gen = prng.Gen(seed)
    sk, pk = R.new_key(gen, param, CPU)
    ms = [prng.uniform_mod(gen, (B, N), param.t, CPU)
          for _ in range(count)]
    cts = [R.encrypt(gen, param, pk, m, batch=(B,)) for m in ms]
    return gen, sk, pk, [m.numpy() for m in ms], cts


@pytest.mark.parametrize("kind", ["gadget", "hybrid"])
def test_mul_decrypts_to_the_product(kind):
    param = R.RnsParam(n=N, t=256, L=4, M=5)
    gen, sk, _, ms, cts = setup(param, 21)
    key = (R.rlk_key(gen, param, sk) if kind == "gadget"
           else R.hybrid_rlk1(gen, param, sk))
    ct = R.mul(param, key, *cts)
    assert all(v.dtype == torch.int32 and tuple(v.shape) == (4, B, N)
               for v in ct)
    np.testing.assert_array_equal(R.decrypt(param, sk, ct).numpy(),
                                  negacyclic(ms[0], ms[1], 256))


def test_gadget_mul_e_decrypts_and_equals_mul():
    param = R.RnsParam(n=N, t=256, L=4, M=5)
    gen, sk, _, ms, cts = setup(param, 22)
    rlk = R.rlk_key(gen, param, sk)
    assert tuple(rlk.b.shape) == (4, 4, N) and rlk.a.dtype == torch.int32
    ces = [R.to_evals(param, c) for c in cts]
    ce = R.mul_e(param, rlk, *ces)
    got = R.from_evals(param, ce)
    want = R.mul(param, rlk, *cts)
    assert torch.equal(got.c0, want.c0) and torch.equal(got.c1, want.c1)
    w1 = negacyclic(ms[0], ms[1], 256)
    np.testing.assert_array_equal(R.decrypt(param, sk, got).numpy(), w1)
    # depth 2, never leaving the eval domain: ((m1·m2) + m1) · m2
    ce2 = R.mul_e(param, rlk, R.add_e(param, ce, ces[0]), ces[1])
    rec = R.decrypt(param, sk, R.from_evals(param, ce2))
    np.testing.assert_array_equal(
        rec.numpy(), negacyclic((w1 + ms[0]) % 256, ms[1], 256))


def test_mul_e_rejects_other_key_types():
    param = R.RnsParam(n=N, t=256, L=4, M=5)
    _, _, _, _, cts = setup(param, 23)
    x = R.to_evals(param, cts[0])
    for fn, args in ((R.mul_e, (x, x)), (R.mul, (cts[0], cts[0]))):
        with pytest.raises(TypeError, match="RLK"):
            fn(param, (x.e0q, x.e1q), *args)


def test_linear_pipeline_decrypts():
    """The eval-resident linear step (c1 + c2) · m2 equals the
    coefficient-domain add + mul_pt bit for bit, and a chain of two steps
    decrypts to the plaintext algebra; add_pt too."""
    param = R.RnsParam(n=N, t=256, L=2, M=3)
    _, sk, _, ms, cts = setup(param, 24)
    m2 = torch.from_numpy(ms[1])
    em = R.pt_to_evals(param, m2)
    e1, e2 = (R.to_evals(param, c) for c in cts)
    step = R.mul_pt_e(param, R.add_e(param, e1, e2), em)
    got = R.from_evals(param, step)
    want = R.mul_pt(param, R.add(param, *cts), m2)
    assert torch.equal(got.c0, want.c0) and torch.equal(got.c1, want.c1)
    w1 = negacyclic((ms[0] + ms[1]) % 256, ms[1], 256)
    np.testing.assert_array_equal(R.decrypt(param, sk, got).numpy(), w1)
    step2 = R.mul_pt_e(param, R.add_e(param, step, e2), em)
    rec = R.decrypt(param, sk, R.from_evals(param, step2))
    np.testing.assert_array_equal(
        rec.numpy(), negacyclic((w1 + ms[1]) % 256, ms[1], 256))
    rec = R.decrypt(param, sk, R.add_pt(param, cts[0], m2))
    np.testing.assert_array_equal(rec.numpy(), (ms[0] + ms[1]) % 256)


def test_key_switch_moves_a_ciphertext_under_the_new_key():
    param = R.RnsParam(n=N, t=256, L=4, M=5)
    gen, sk, _, ms, cts = setup(param, 25)
    sk2, _ = R.new_key(gen, param, CPU)
    ksk = R.ksk_key(gen, param, sk, sk2)
    moved = R.key_switch(param, ksk, cts[0])
    np.testing.assert_array_equal(R.decrypt(param, sk2, moved).numpy(), ms[0])
    assert not np.array_equal(R.decrypt(param, sk, moved).numpy(), ms[0])
    before = R.noise_budget_bits(param, sk, cts[0], torch.from_numpy(ms[0]))
    after = R.noise_budget_bits(param, sk2, moved, torch.from_numpy(ms[0]))
    assert float(after.min()) > 0 and float((before - after).min()) > 0


def test_depth_two_with_a_modulus_drop():
    """(m1·m2)·m3 with the last prime dropped in between: the dropped
    ciphertext decrypts under the first L-1 primes, and the product of
    depth 2 decrypts."""
    param = R.RnsParam(n=N, t=4, L=4, M=5)
    gen, sk, _, ms, cts = setup(param, 26, count=3)
    rlk = R.rlk_key(gen, param, sk)
    c12 = R.mul(param, rlk, cts[0], cts[1])
    w12 = negacyclic(ms[0], ms[1], 4)
    budget = R.noise_budget_bits(param, sk, c12, torch.from_numpy(w12))
    assert float(budget.min()) > 30
    low = R.RnsParam(n=N, t=4, L=3, M=5)
    assert low.qs == param.qs[:3]
    sk_low = R.SecretKey(torch.cat([sk.s_evals[:3], sk.s_evals[4:]]))
    dropped = R.mod_switch_drop(param, c12)
    np.testing.assert_array_equal(R.decrypt(low, sk_low, dropped).numpy(),
                                  w12)
    c123 = R.mul(param, rlk, c12, cts[2])
    np.testing.assert_array_equal(R.decrypt(param, sk, c123).numpy(),
                                  negacyclic(w12, ms[2], 4))
