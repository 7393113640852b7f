"""The port's generator (utils/prng.Gen): full-width streams and the
samplers' distributions.

A ``Gen`` is keyed by every bit of its seed, so two seeds that agree in
their low 32 bits draw different keys (a torch CPU generator keeps only the
low 32 bits of a seed); a child of ``split`` draws a stream of its own; the
samplers keep the reference's distributions: ternary frequencies (.25, .5,
.25) to 0.01, exactly h nonzeros a row of a sparse ternary, the gaussian's
sigma within 5%, uniform residues in range with mean q/2 to 1%.
"""

import numpy as np
import pytest
import torch

from fhe_study_tpu_torch.arith.params import RingParam
from fhe_study_tpu_torch.models import bfv
from fhe_study_tpu_torch.models.gfhe import glwe as G
from fhe_study_tpu_torch.utils import prng

CPU = torch.device("cpu")
Q = 2 ** 16 + 1
SEED = 2 ** 40 + 12345


def test_seeds_equal_in_their_low_32_bits_give_different_keys():
    p = bfv.Param(RingParam(Q, 64), 4, Q * Q)
    keys = [bfv.new_key(prng.Gen(SEED + (j << 32)), p, CPU) for j in range(4)]
    for i in range(4):
        for j in range(i):
            assert not torch.equal(keys[i][0].s, keys[j][0].s)
            assert not torch.equal(keys[i][1].a, keys[j][1].a)
    gp = G.Param(G.ERR_SIGMA, RingParam(Q, 64), 2, 4)
    s1, _ = G.new_key(prng.Gen(SEED), gp, CPU)
    s2, _ = G.new_key(prng.Gen(SEED + (1 << 32)), gp, CPU)
    assert not torch.equal(s1, s2)
    # the same seed gives the same key, on every call
    again = bfv.new_key(prng.Gen(SEED), p, CPU)
    assert all(torch.equal(x, y) for x, y in zip(again[1], keys[0][1]))


def test_split_children_differ_from_parent_and_each_other():
    gen = prng.Gen(SEED)
    kids = prng.split(gen, 3)
    draws = [prng.uniform_mod(g, (64,), Q, CPU) for g in (gen, *kids)]
    for i in range(4):
        for j in range(i):
            assert not torch.equal(draws[i], draws[j])
    assert all(0 <= k.seed < 1 << 63 for k in kids)
    again = prng.split(prng.Gen(SEED), 3)
    assert [k.seed for k in again] == [k.seed for k in kids]


def test_generator_refuses_a_negative_or_non_integer_seed():
    for bad in (-1, 1.5, "7"):
        with pytest.raises(ValueError):
            prng.Gen(bad)


def test_samplers_keep_their_distributions():
    gen = prng.Gen(SEED)
    shape = (64, 1024)
    t = prng.ternary(gen, shape, CPU)
    freq = [float((t == v).double().mean()) for v in (-1, 0, 1)]
    np.testing.assert_allclose(freq, [0.25, 0.5, 0.25], atol=0.01)
    b = prng.binary(gen, shape, CPU)
    assert set(b.unique().tolist()) == {0, 1}
    assert abs(float(b.double().mean()) - 0.5) < 0.01
    g = prng.gaussian_int(gen, shape, 3.2, CPU).double()
    assert abs(float(g.mean())) < 0.05
    assert abs(float(g.std()) / 3.2 - 1) < 0.05
    gm = prng.gaussian_mod(gen, shape, 3.2, Q, CPU)
    assert int(gm.min()) >= 0 and int(gm.max()) < Q
    centered = torch.where(gm > Q // 2, gm - Q, gm).double()
    assert abs(float(centered.std()) / 3.2 - 1) < 0.05
    for q in (2, Q, Q * Q * Q):
        u = prng.uniform_mod(gen, shape, q, CPU)
        assert u.dtype == torch.int64
        assert int(u.min()) >= 0 and int(u.max()) < q
        assert abs(float(u.double().mean()) / (q - 1) - 0.5) < 0.01
    for h in (1, 64, 1024):
        s = prng.sparse_ternary(gen, (8, 1024), h, CPU)
        assert ((s != 0).sum(-1) == h).all()
        assert set(s.unique().tolist()) <= {-1, 0, 1}
    w = prng.uniform_u64(gen, shape, CPU)
    bits = w.numpy().view(np.uint64)
    for k in (0, 31, 63):
        assert abs(float(((bits >> np.uint64(k)) & np.uint64(1)).mean())
                   - 0.5) < 0.01
    with pytest.raises(ValueError):
        prng.sparse_ternary(gen, (8, 16), 17, CPU)
