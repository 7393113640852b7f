"""The port's models/ckks/bootstrap.py against
fhe_study_tpu.models.ckks.bootstrap, with hybrid_ks.seed_of / expand_a,
utils/serialization.py and interop.boot_arrays_to_port.

The host helpers are held equal with ==; mod_raise and mod_raise2 bit for
bit against the JAX functions and Python integers.  _stage_evalmod (single
and double ladder), one C2S and one S2C radix stage run under jax.jit on
keys the port drew (carried into JAX as u32) and, for the stages, on the
port's plans (the reference builds its plans eagerly, seconds a plan here);
integer outputs are held bit for bit.  The port's key discovery
(precompute_keys) is held to the key sets, plan keys and output Param that
the JAX package's precompute_keys gives for the same three configurations
(literals below: the reference takes minutes here to find them), and its
bootstrap to the JAX tests' decrypt tolerances (tests/test_ckks_bootstrap.py:
1e-2 for the single base and the radix split, 2^-25 for the double base,
which the reference's tier marks slow and this file keeps).
"""

import gc
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_study_tpu.models import hybrid_ks as JH
from fhe_study_tpu.models.ckks import bootstrap as JB
from fhe_study_tpu.models.ckks import ckks_rns as JC
from fhe_study_tpu.models.ckks import eval as JE

from fhe_study_tpu_torch.models import hybrid_ks as H
from fhe_study_tpu_torch.models.ckks import bootstrap as B
from fhe_study_tpu_torch.models.ckks import ckks_rns as C
from fhe_study_tpu_torch.models.ckks import eval as E
from fhe_study_tpu_torch.models.ckks import poly as P
from fhe_study_tpu_torch.utils import interop, prng, serialization

CPU = torch.device("cpu")
MASTER = 20240614
G7 = (5, 17, 25, 33, 49, 61, 63)      # the Galois elements of n = 32


def to_jax_ct(ct):
    return JC.CT(*(jnp.asarray(interop.to_numpy(c).astype(np.uint64))
                   for c in ct))


def same_ct(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(interop.to_numpy(g).astype(np.uint64),
                                      np.asarray(w).astype(np.uint64))


def jax_ksk(k):
    return JH.HybridKSK(b=jnp.asarray(interop.to_numpy(k.b)),
                        a=jnp.asarray(interop.to_numpy(k.a)))


def encrypt(gen, param, pk, z):
    return C.encrypt(gen, param, pk, C.encode(
        param, torch.from_numpy(np.ascontiguousarray(z.real)),
        torch.from_numpy(np.ascontiguousarray(z.imag))))


# -- host helpers -------------------------------------------------------------

QS = SimpleNamespace(qs=C.Param(n=32, L=6, delta=1.0).qs)
HOST = {
    "suggest_K_r": lambda m: [m.suggest_K_r(n, h, s)
                              for n in (32, 2048, 4096, 8192)
                              for h in (None, 16, 64) for s in (5.0, 6.5)],
    "_cos_taylor_even": lambda m: [m._cos_taylor_even(d, v)
                                   for d in (4, 24, 30)
                                   for v in (4.6, 5.233)],
    "_base": lambda m: [m._base(QS, b) for b in (1, 2, 3)],
    "_c2s_ms_consts": lambda m: [m._c2s_ms_consts(QS, K, r, dw, b)
                                 for K, r in ((7, 3), (12, 5))
                                 for dw in (2.0 ** 30, 2.0 ** 60)
                                 for b in (1, 2)],
    "_arcsin_coeffs": lambda m: [m._arcsin_coeffs(t) for t in range(1, 6)],
    "_is_double": lambda m: [m._is_double(dw, d)
                             for dw in (2.0 ** 30, 2.0 ** 45, 2.0 ** 46,
                                        2.0 ** 60)
                             for d in (None, True, False)],
}


@pytest.mark.parametrize("name", sorted(HOST))
def test_host_helpers_equal_jax(name):
    assert HOST[name](B) == HOST[name](JB)


# -- ModRaise -----------------------------------------------------------------

@pytest.mark.parametrize("base", [1, 2])
def test_mod_raise_bit_exact(base):
    """Residues of the centered representative of v mod Q0 over the full
    basis: the port == the JAX function == Python integers, the edges of
    the centering included."""
    n, L = 16, 8
    param = C.Param(n=n, L=L, delta=2.0 ** 45)
    qs = param.qs
    Q0 = B._base(param, base)
    rng = np.random.default_rng(3 + base)
    vs = [[int(x) for x in rng.integers(0, Q0, n)] for _ in range(4)]
    vs[0][:4] = [0, Q0 // 2, Q0 // 2 + 1, Q0 - 1]
    res = np.array([[[v % q for v in row] for row in vs] for q in qs[:base]],
                   np.int64)                             # [base, 4, n]
    ct = C.CT(torch.from_numpy(res[:, :2]).int(),
              torch.from_numpy(res[:, 2:]).int())
    fn, jfn = ((B.mod_raise, JB.mod_raise) if base == 1
               else (B.mod_raise2, JB.mod_raise2))
    got = fn(param, ct)
    want = jfn(JC.Param(n=n, L=L, delta=param.delta), to_jax_ct(ct))
    same_ct(got, want)
    big = np.array([[[(v if v <= Q0 // 2 else v - Q0) % q for v in row]
                     for row in vs] for q in qs], np.int64)
    np.testing.assert_array_equal(torch.cat(list(got), dim=1).numpy(), big)


# -- EvalMod ------------------------------------------------------------------

# the smallest case that takes every branch of _stage_evalmod: deg 2 (the
# cosine with a constant term), r = 1 (one doubling), one arcsin term (no
# constant term); the single ladder's constants take the float encode, the
# double one's the exact path (poly's own branches: test_torch_ckks_poly);
# L is what each consumes, plus 2
EVALMOD = {"single": (6, False), "double": (10, True)}
EM_K, EM_R, EM_DEG, EM_TERMS = 7, 1, 2, 1


@pytest.mark.parametrize("mode", sorted(EVALMOD))
def test_stage_evalmod_bit_exact(mode):
    n = 16
    L, double = EVALMOD[mode]
    param = C.Param(n=n, L=L, delta=1.0)
    param = C.Param(n=n, L=L, delta=C.delta2(param) if double else 2.0 ** 30)
    gen = prng.Gen(31 + L)
    sk, pk = C.new_key(gen, param, CPU)
    rlks = P.rlk_keys_all_levels(gen, param, sk)
    w = np.random.default_rng(L).uniform(-1, 1, n // 2)
    ct = encrypt(gen, param, pk, w.astype(complex))
    keys = B.FrozenKeys({"rlk": rlks, "rot": {}, "em": {}}, {})
    got, pg = B._stage_evalmod(keys, ct, param, EM_K, EM_R, EM_DEG, double,
                               EM_TERMS)
    jkeys = SimpleNamespace(rlks=lambda: {lv: jax_ksk(k)
                                          for lv, k in rlks.items()})
    jparam = JC.Param(n=n, L=L, delta=param.delta)
    cell = {}

    def ref(c0, c1):
        out, cell["p"] = JB._stage_evalmod(jkeys, JC.CT(c0, c1), jparam,
                                           EM_K, EM_R, EM_DEG, double,
                                           EM_TERMS)
        return tuple(out)

    same_ct(got, jax.jit(ref)(*to_jax_ct(ct)))
    assert (pg.L, pg.delta) == (cell["p"].L, cell["p"].delta) == (2, pg.delta)


# -- one C2S and one S2C radix stage ------------------------------------------

@pytest.fixture(scope="module")
def stage_keys():
    """A key set at n = 16, L = 4 and two ciphertexts at full level."""
    param = C.Param(n=16, L=4, delta=2.0 ** 45)
    gen = prng.Gen(41)
    sk, pk = C.new_key(gen, param, CPU)
    rng = np.random.default_rng(42)
    cts = [encrypt(gen, param, pk, rng.uniform(-1, 1, 8)
                   + 1j * rng.uniform(-1, 1, 8)) for _ in range(2)]
    return param, B.BootstrapKeys(MASTER, param, sk), cts


def _jax_stage(keys, fn):
    """fn(jkeys) under jax.jit, with jkeys holding the port's Galois keys
    and plans; the reference's plan builder must not be reached."""
    def no_build(*a, **k):
        raise AssertionError("the reference built a plan: its plan key "
                             "differs from the port's")

    jkeys = SimpleNamespace(
        rotkeys=lambda: JE.RotKeys({lg: jax_ksk(k) for lg, k
                                    in keys.rotkeys().keys.items()}),
        _plans={})
    for pkey, p in keys._plans.items():
        jp = JE.RmapPlan(p.n1, p.need_d, p.need_e, p.maps,
                         interop.to_numpy(p.em), p.pt_levels)
        jkeys._plans[pkey] = jp
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JE, "build_rmap_plan", no_build)
        return fn(jkeys)


def test_c2s_ms_stage_bit_exact(stage_keys):
    """Stage 0 of the double-base radix C2S on a ModRaised ciphertext: one
    shared plan emits both chains."""
    param, keys, cts = stage_keys
    raised = B.mod_raise2(param, P.level_drop(param, cts[0], 2)[0])
    args = (4, 7, 3, 2.0 ** 60, 2, 2)
    got = B._c2s_ms_stage(param, keys, 0, raised, None, *args)
    assert set(keys._plans) >= {("c2s_ms", 0, 4, 7, 3, 2.0 ** 60, 2, 2)}
    jparam = JC.Param(n=16, L=4, delta=param.delta)
    want = _jax_stage(keys, lambda jk: jax.jit(
        lambda c0, c1: tuple(tuple(c) for c in JB._c2s_ms_stage(
            jparam, jk, 0, JC.CT(c0, c1), None, *args)))(
        *to_jax_ct(raised)))
    for g, w in zip(got, want):
        same_ct(g, w)


def test_s2c_ms_stage_bit_exact(stage_keys):
    """The last S2C radix stage in the classic base: per-chain plans (chain
    2 folds diag(sigma)) with the Q0/(2 pi) fold."""
    param, keys, cts = stage_keys
    c1, c2 = (P.level_drop(param, c, 3)[0] for c in cts)
    got = B._s2c_ms_stage(param, keys, 1, c1, c2, 3, 1, 2)
    assert set(keys._plans) >= {("s2c_ms", 1, 0, 3, 1, 2),
                                ("s2c_ms", 1, 1, 3, 1, 2)}
    jparam = JC.Param(n=16, L=4, delta=param.delta)
    want = _jax_stage(keys, lambda jk: jax.jit(
        lambda a0, a1, b0, b1: tuple(tuple(c) for c in JB._s2c_ms_stage(
            jparam, jk, 1, JC.CT(a0, a1), JC.CT(b0, b1), 3, 1, 2)))(
        *to_jax_ct(c1), *to_jax_ct(c2)))
    for g, w in zip(got, want):
        same_ct(g, w)


# -- key discovery and the whole bootstrap ------------------------------------

def _rot(levels, gs=G7):
    return {(L, g) for L in levels for g in gs}


# (L, delta0, options) -> what the JAX package's precompute_keys discovers
# at n = 32: relinearization levels, Galois keys, plan keys, output level
# and scale, each read from the reference (its key builders stubbed with
# random residues, which changes neither the set nor the scale)
CONFIGS = {
    "single": (18, 2.0 ** 24, {}, {
        "rlk": [7, 8, 9, 10, 11, 13, 14, 15, 16, 17],
        "rot": _rot((5, 18)),
        "plans": {("c2s", 18, 7, 3, 2.0 ** 30, 1), ("s2c1", 5, 1),
                  ("s2c2", 5, 1)},
        "pout_L": 3, "pout_delta": 19374324.517017175, "tol": 1e-2}),
    "radix": (20, 2.0 ** 24, dict(c2s_stages=2, s2c_stages=2), {
        "rlk": [8, 9, 10, 11, 12, 14, 15, 16, 17, 18],
        "rot": (_rot((5,), (17, 33, 49)) | _rot((6,), (5, 17, 25, 61))
                | _rot((19,), (5, 17, 25, 61, 63))
                | _rot((20,), (17, 33, 49))),
        "plans": {("c2s_ms", 0, 20, 7, 3, 2.0 ** 30, 1, 2),
                  ("c2s_ms", 1, 0, 19, 7, 3, 2.0 ** 30, 1, 2),
                  ("s2c_ms", 0, 0, 6, 1, 2), ("s2c_ms", 1, 0, 5, 1, 2),
                  ("s2c_ms", 1, 1, 5, 1, 2)},
        "pout_L": 3, "pout_delta": 19703241.59088661, "tol": 1e-2}),
    "double": (34, 2.0 ** 45, dict(K=7, r=3, deg=30, delta_w=2.0 ** 60,
                                   arcsin_terms=3, base_limbs=2), {
        "rlk": [10, 12, 14, 16, 18, 20, 24, 26, 28, 30, 32],
        "rot": _rot((6, 34)),
        "plans": {("c2s", 34, 7, 3, 2.0 ** 60, 2), ("s2c1", 6, 2),
                  ("s2c2", 6, 2)},
        "pout_L": 4, "pout_delta": 370325575457843.06, "tol": 2.0 ** -25}),
}


@pytest.fixture(scope="module")
def built():
    """Per configuration: keys, a ciphertext dropped to base_limbs limbs,
    and the port's precomputed key set (with em sources)."""
    cache = {}

    def get(name):
        if name not in cache:
            L, delta0, kw, _ = CONFIGS[name]
            param = C.Param(n=32, L=L, delta=delta0)
            gen = prng.Gen(len(cache) + 51)
            sk, pk = C.new_key(gen, param, CPU)
            rng = np.random.default_rng(L)
            z = rng.uniform(-1, 1, 16) + 1j * rng.uniform(-1, 1, 16)
            ct, _ = P.level_drop(param, encrypt(gen, param, pk, z),
                                 kw.get("base_limbs", 1))
            arrays, static, pout, em_src = B.precompute_keys(
                MASTER, param, sk, delta0, with_em_src=True, **kw)
            cache[name] = SimpleNamespace(
                param=param, sk=sk, z=z, ct=ct, kw=kw, delta0=delta0,
                arrays=arrays, static=static, pout=pout, em_src=em_src)
        return cache[name]
    return get


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_precompute_keys_matches_jax_key_sets(name, built):
    b, want = built(name), CONFIGS[name][3]
    assert sorted(b.arrays["rlk"]) == want["rlk"]
    assert set(b.arrays["rot"]) == want["rot"]
    assert set(b.static) == set(b.arrays["em"]) == want["plans"]
    assert b.pout.L == want["pout_L"]
    assert b.pout.delta == want["pout_delta"]
    for lv, k in b.arrays["rlk"].items():
        assert k.b.shape == k.a.shape == (lv, lv + B.AUX_PRIMES, 32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bootstrap_refreshes(name, built):
    """make_staged on the precomputed set == bootstrap() with lazy keys,
    bit for bit, and the output decrypts to z within the JAX tests'
    tolerance."""
    b = built(name)
    run = B.make_staged(b.param, b.static, b.delta0, **b.kw)
    out, pout = run(b.arrays, *b.ct)
    assert pout == run.pout == b.pout
    lazy = B.BootstrapKeys(MASTER, b.param, b.sk)
    out_l, pout_l = B.bootstrap(b.param, lazy, b.ct, b.delta0, **b.kw)
    assert pout_l == pout
    for x, y in zip(out, out_l):
        assert torch.equal(x, y)
    rr, ri = C.decode(pout, C.decrypt_to_coeffs(
        pout, b.sk, out, crt_limbs=3 if pout.delta > 2.0 ** 40 else 2))
    got = rr.numpy() + 1j * ri.numpy()
    np.testing.assert_allclose(got, b.z, atol=CONFIGS[name][3]["tol"])


@pytest.mark.parametrize("order", ["forward", "reverse"])
def test_lazy_keys_equal_precomputed_in_any_order(order, built):
    b = built("radix")
    keys = B.BootstrapKeys(MASTER, b.param, b.sk)
    rots = sorted(b.arrays["rot"])
    rlks = sorted(b.arrays["rlk"])
    if order == "reverse":
        rots, rlks = rots[::-1], rlks[::-1]
    for lg in rots[:4] + rots[-2:]:
        got, want = keys.rotkeys().get(*lg), b.arrays["rot"][lg]
        assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)
    for lv in rlks[:3]:
        assert torch.equal(keys.rlks()[lv].b, b.arrays["rlk"][lv].b)


def _seeded_key(param, sk, master, K=3):
    seeds = H.key_seeds(master, "rot", param.L, 5)
    return H.galois_key_hybrid_with(
        param, sk, 5, *H.seeded_draws(param, seeds, K, CPU), K=K)


def test_precompute_keys_leaves_no_reference_cycle():
    """The key set that precompute_keys discovers is freed as soon as the
    last reference to it goes: no cycle (the lazy caches and their
    BootstrapKeys, or powers' memo) holds it until Python's cyclic
    collector happens to run, which on a card keeps gigabytes alive."""
    L, delta0, kw, _ = CONFIGS["single"]
    param = C.Param(n=32, L=L, delta=delta0)
    sk, _ = C.new_key(prng.Gen(64), param, CPU)
    gc.collect()
    gc.disable()
    try:
        arrays, _, _ = B.precompute_keys(MASTER, param, sk, delta0, **kw)
        refs = ([weakref.ref(k.a) for k in arrays["rlk"].values()]
                + [weakref.ref(k.a) for k in arrays["rot"].values()]
                + [weakref.ref(em) for em in arrays["em"].values()])
        del arrays
        alive = sum(r() is not None for r in refs)
    finally:
        gc.enable()
    assert alive == 0, f"{alive} of {len(refs)} key tensors outlive the set"


def test_expand_a_rebuilds_the_mask():
    param = C.Param(n=32, L=5, delta=2.0 ** 30)
    sk, _ = C.new_key(prng.Gen(61), param, CPU)
    for master in (0, 2 ** 62 + 7):
        key = _seeded_key(param, sk, master)
        a = H.expand_a(param, H.seed_of(master, "rot", param.L, 5), 3, CPU)
        assert torch.equal(a, key.a) and a.is_contiguous()


def test_seeds_equal_in_their_low_32_bits_give_different_keys():
    """The seeded draws use every bit of a seed: two masters, and four mask
    or noise seeds, that agree in their low 32 bits give different keys,
    masks and noise."""
    param = C.Param(n=32, L=5, delta=2.0 ** 30)
    sk, _ = C.new_key(prng.Gen(62), param, CPU)
    master = 2 ** 40 + 12345
    k1, k2 = (_seeded_key(param, sk, m) for m in (master, master + 2 ** 32))
    assert not torch.equal(k1.a, k2.a) and not torch.equal(k1.b, k2.b)
    seeds = [master + (j << 32) for j in range(4)]
    masks = {tuple(prng.uniform_mod_multi(
        prng.Gen(s), (4, 32), param.qs, CPU).flatten().tolist())
        for s in seeds}
    noise = {tuple(prng.gaussian_int(
        prng.Gen(s), (4, 32), 3.2, CPU).flatten().tolist()) for s in seeds}
    assert len(masks) == len(noise) == 4


def test_seeded_pack_round_trip(built, tmp_path):
    """pack_seeded -> save_pytree -> load_pytree -> expand_seeded gives the
    built set bit for bit; the pack is under 0.62 of its bytes and holds
    the mask seeds alone, neither the master seed nor a noise seed; the
    rotation seeds do not collide where a packed L*8192 + g would."""
    b = built("single")
    pack = B.pack_seeded(b.arrays, MASTER, em_src=b.em_src)
    assert B.nbytes(pack) < 0.62 * B.nbytes(b.arrays)
    seeds = ([B._rlk_subkey(MASTER, lv) for lv in b.arrays["rlk"]]
             + [B._rot_subkey(MASTER, *lg) for lg in b.arrays["rot"]])
    forbidden = {MASTER} | {ke for _, ke in seeds}
    stored = ([s for _, s in pack["rlk"].values()]
              + [s for _, s in pack["rot"].values()])
    assert set(stored) == {ka for ka, _ in seeds}
    assert not set(stored) & forbidden
    assert len(set(stored)) == len(stored)
    aliases = {B._rot_subkey(MASTER, lv, g) for lv in range(1, 20)
               for g in (1, 3, 5, 8192 + 3)}
    assert len({s for pair in aliases for s in pair}) == 19 * 4 * 2
    path = str(tmp_path / "bootkeys.npz")
    serialization.save_pytree(path, pack)
    out = B.expand_seeded(serialization.load_pytree(path, CPU), b.param)
    assert set(out["em"]) == set(b.arrays["em"])
    for pkey, em in b.arrays["em"].items():
        assert torch.equal(out["em"][pkey], em)
    for part in ("rlk", "rot"):
        assert set(out[part]) == set(b.arrays[part])
        for k, key in b.arrays[part].items():
            assert torch.equal(out[part][k].a, key.a)
            assert torch.equal(out[part][k].b, key.b)


def test_serialization_round_trip(tmp_path):
    tree = {("c2s", 18, 7, 3, 2.0 ** 30, 1): (torch.arange(6).int(), 17),
            (5, 63): [np.arange(4, dtype=np.int64), None, "s", 0.1, True],
            3: {"deep": (torch.ones(2, 3, dtype=torch.float64),
                         2 ** 70)}}
    path = str(tmp_path / "tree.npz")
    serialization.save_pytree(path, tree)
    got = serialization.load_pytree(path, CPU)
    assert set(got) == set(tree)
    k = ("c2s", 18, 7, 3, 2.0 ** 30, 1)
    assert torch.equal(got[k][0], tree[k][0]) and got[k][1] == 17
    np.testing.assert_array_equal(got[(5, 63)][0], tree[(5, 63)][0])
    assert got[(5, 63)][1:] == [None, "s", 0.1, True]
    assert torch.equal(got[3]["deep"][0], tree[3]["deep"][0])
    assert got[3]["deep"][1] == 2 ** 70
    z = torch.zeros((1, 3, 4), dtype=torch.int32)
    with pytest.raises(TypeError, match="HybridKSK"):
        serialization.save_pytree(path, {1: H.HybridKSK(b=z, a=z)})


def test_freeze_rejects_mixed_devices(built):
    b = built("single")
    keys = B.BootstrapKeys(MASTER, b.param, b.sk)
    keys.rlks()[4]
    keys.rotkeys().keys[(4, 5)] = H.HybridKSK(
        *(t.to("meta") for t in keys.rlks()[4]))
    with pytest.raises(ValueError, match="several devices"):
        B.freeze(keys)


# -- the JAX package's frozen key set carried across --------------------------

def test_boot_arrays_to_port(monkeypatch):
    """A frozen JAX key set (its key builders stubbed with random residues,
    one port plan carried in) -> the port's FrozenKeys on the same static,
    tensors equal."""
    n, L = 16, 6
    rng = np.random.default_rng(71)

    def fake(key, pL, sk, *g, K=2):
        both = pL.qs + JH.ks_ext_primes(pL, K)
        b, a = (np.stack([np.stack([rng.integers(0, q, n, dtype=np.uint32)
                                    for q in both]) for _ in range(pL.L)])
                for _ in range(2))
        return JH.HybridKSK(b=jnp.asarray(b), a=jnp.asarray(a))

    monkeypatch.setattr(JC, "hybrid_rlk", fake)
    monkeypatch.setattr(JH, "galois_key_hybrid", fake)
    jparam = JC.Param(n=n, L=L, delta=2.0 ** 30)
    jkeys = JB.BootstrapKeys(jax.random.PRNGKey(0), jparam,
                             JC.SecretKey(jnp.zeros((L, n), jnp.uint64)))
    for lv in (4, 5):
        jkeys.rlks()[lv]
    for g in (5, 31):
        jkeys.rotkeys().get(L, g)
    plan = E.build_rmap_plan(C.Param(n=n, L=L, delta=1.0),
                             [(E._s2c_matrices(n)[0], None)], CPU)
    pkey = ("s2c1", L, 1)
    jkeys._plans[pkey] = JE.RmapPlan(plan.n1, plan.need_d, plan.need_e,
                                     plan.maps, interop.to_numpy(plan.em),
                                     plan.pt_levels)
    arrays, static = JB.freeze(jkeys)
    jfk = JB.FrozenKeys(arrays, static)
    fk = B.FrozenKeys(interop.boot_arrays_to_port(arrays, CPU), static)
    assert set(fk.rlks()) == set(jfk.rlks()) == {4, 5}
    for lv, k in jfk.rlks().items():
        same_ct(fk.rlks()[lv], k)
    assert set(fk.rotkeys().keys) == set(jfk.rotkeys().keys) == {(L, 5),
                                                                 (L, 31)}
    for (lv, g), k in jfk.rotkeys().keys.items():
        same_ct(fk.rotkeys().get(lv, g), k)
    got, want = fk._plans[pkey], jfk._plans[pkey]
    same_ct((got.em,), (want.em,))
    assert torch.equal(got.em, plan.em)
    assert (got.n1, got.need_d, got.need_e, got.maps, got.pt_levels) == (
        want.n1, want.need_d, want.need_e, want.maps, want.pt_levels)
