"""The port's models/ckks/eval.py against fhe_study_tpu.models.ckks.eval.

The host half (numpy) is held equal to the JAX package's functions array for
array.  For the ciphertext half, keys and a ciphertext are drawn by the port
and carried into the JAX package (u32 keys, u64 residues), and the JAX
package's coeff_to_slot and rmap_bsgs run under jax.jit on plans whose em
the port built (the reference builds its plans eagerly, which takes
seconds a plan here; the port's em is held within one unit of the
reference's own encode and realize_em first).  The first plan has at most 4
rotated babies, the second more than 4.  Integer outputs are held bit for
bit; decoded slots against numpy at the reference tests' tolerance
(tests/test_ckks_eval.py: 5e-2).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_study_tpu.models import hybrid_ks as JH
from fhe_study_tpu.models.ckks import ckks_rns as JC
from fhe_study_tpu.models.ckks import encoder_device as JD
from fhe_study_tpu.models.ckks import eval as JE

from fhe_study_tpu_torch.models import galois
from fhe_study_tpu_torch.models.ckks import ckks_rns as C
from fhe_study_tpu_torch.models.ckks import eval as E
from fhe_study_tpu_torch.utils import interop, prng

N, L = 16, 4
HALF = N // 2
CPU = torch.device("cpu")
PARAM = C.Param(n=N, L=L, delta=2.0 ** 25)
JPARAM = JC.Param(n=N, L=L, delta=PARAM.delta)


def _rand(rng, *shape):
    return rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)


def same_ct(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(interop.to_numpy(g).astype(np.uint64),
                                      np.asarray(w).astype(np.uint64))


def decoded(param, sk, ct):
    rr, ri = C.decode(param, C.decrypt_to_coeffs(param, sk, ct))
    return rr.numpy() + 1j * ri.numpy()


# -- the host half ----------------------------------------------------------

NUMPY_FUNCTIONS = {
    "_orbit_maps": lambda m: m._orbit_maps(32),
    "_special_fft_factors": lambda m: m._special_fft_factors(32),
    "_bitrev": lambda m: m._bitrev(16),
    "_t_maps": lambda m: m._t_maps(32),
    "_sigma_t": lambda m: m._sigma_t(32),
    "_split_groups": lambda m: [m._split_groups(k, S) for k in (1, 4, 5)
                                for S in (1, 2, 3, 7)],
    "_bsgs_n1": lambda m: [m._bsgs_n1(n) for n in (8, 16, 64, 4096)],
    "bsgs_steps": lambda m: [m.bsgs_steps(n, n1) for n in (16, 64)
                             for n1 in (None, 2, 8)],
    "_inv_slot_apply": lambda m: [m._inv_slot_apply(
        32, g, _rand(np.random.default_rng(g), 16)) for g in (5, 25, 63)],
    "_c2s_matrices": lambda m: m._c2s_matrices(32),
    "_s2c_matrices": lambda m: m._s2c_matrices(32),
    "c2s_stage_maps": lambda m: [m.c2s_stage_maps(n, S) for n in (16, 32)
                                 for S in (1, 2, 3)]
                                + [m.c2s_stage_maps(16, 2, 0.25 + 0.5j)],
    "s2c_stage_maps": lambda m: [m.s2c_stage_maps(n, S) for n in (16, 32)
                                 for S in (1, 2, 3)],
    "_t_to_nat": lambda m: [m._t_to_nat(32, lin=_rand(
        np.random.default_rng(4), 16, 16) * (np.arange(16) % 3 == 0),
        anti=_rand(np.random.default_rng(5), 16, 16))],
    "_group_prod": lambda m: m._group_prod(
        [_rand(np.random.default_rng(i), 8, 8) for i in range(3)]),
}


def _flatten(x):
    """Arrays (and dict keys) of a nested result, in order."""
    if isinstance(x, dict):
        return [np.asarray(sorted(x))] + [a for k in sorted(x)
                                          for a in _flatten(x[k])]
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _flatten(v)]
    return [np.asarray(x)]


@pytest.mark.parametrize("name", sorted(NUMPY_FUNCTIONS))
def test_numpy_half_matches_jax(name):
    got = _flatten(NUMPY_FUNCTIONS[name](E))
    want = _flatten(NUMPY_FUNCTIONS[name](JE))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("density", [1.0, 0.4, 0.0])
def test_matrix_and_rmap_diagonals_match_jax(density):
    rng = np.random.default_rng(int(density * 10))
    for n in (16, 32):
        A = _rand(rng, n // 2, n // 2) * (rng.random((n // 2, n // 2))
                                          < density)
        B = _rand(rng, n // 2, n // 2) * (rng.random((n // 2, n // 2)) < 0.5)
        for got, want in ((E.matrix_diagonals(A, n),
                           JE.matrix_diagonals(A, n)),
                          (E.rmap_diagonals(A, B, n),
                           JE.rmap_diagonals(A, B, n)),
                          (E.rmap_diagonals(None, B, n),
                           JE.rmap_diagonals(None, B, n))):
            for g, w in zip(got, want):
                assert list(g) == list(w)
                for k in g:
                    np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(ValueError, match="shape"):
        E.matrix_diagonals(np.eye(4), 16)


# -- the ciphertext half ----------------------------------------------------

def _setup(n: int, seed: int):
    """A key pair, a ciphertext of random slots and hybrid Galois keys for
    every step and conjugation at L and L - 1, drawn by the port; the keys
    also as the JAX package's."""
    param = C.Param(n=n, L=L, delta=PARAM.delta)
    gen = prng.Gen(seed)
    sk, pk = C.new_key(gen, param, CPU)
    z = _rand(np.random.default_rng(seed), n // 2)
    ct = C.encrypt(gen, param, pk, C.encode(param, torch.from_numpy(z.real),
                                            torch.from_numpy(z.imag)))
    rk = E.RotKeys.build(gen, param, sk, steps=range(1, n // 2), conj=True,
                         levels=[L, L - 1])
    jrk = JE.RotKeys({k: JH.HybridKSK(b=jnp.asarray(interop.to_numpy(v.b)),
                                      a=jnp.asarray(interop.to_numpy(v.a)))
                      for k, v in rk.keys.items()})
    return dict(param=param, sk=sk, z=z, ct=ct, rk=rk, jrk=jrk)


def _jax_maps(fn, setup):
    """fn(jparam, jrk, x) under jax.jit on setup's ciphertext, with the
    reference's build_rmap_plan answered by the port's plan (carried as the
    reference's RmapPlan); returns (outputs, plans)."""
    plans = []

    def port_plan(param, maps, n1=None, pt_levels=1):
        plan = E.build_rmap_plan(setup["param"], maps, CPU, n1, pt_levels)
        jplan = JE.RmapPlan(plan.n1, plan.need_d, plan.need_e, plan.maps,
                            interop.to_numpy(plan.em), plan.pt_levels)
        jplan.src_m, jplan.src_L = plan.src_m, plan.src_L
        plans.append(jplan)
        return jplan

    jparam = JC.Param(n=setup["param"].n, L=L, delta=PARAM.delta)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JE, "build_rmap_plan", port_plan)
        out = jax.jit(lambda c0, c1: fn(jparam, setup["jrk"], JC.CT(c0, c1)))(
            *(jnp.asarray(interop.to_numpy(c).astype(np.uint64))
              for c in setup["ct"]))
    return out, plans


@pytest.fixture(scope="module")
def ref():
    """coeff_to_slot at n = 8 (its plan rotates one baby on z and on z_c,
    the reference's unrolled form, and one giant) and rmap_bsgs at n = 16,
    n1 = 8 (7 babies: the reference's lax.scan form)."""
    small, wide = _setup(8, 21), _setup(N, 22)
    rng = np.random.default_rng(23)
    A, B = _rand(rng, HALF, HALF), _rand(rng, HALF, HALF)
    c2s, c2s_plans = _jax_maps(
        lambda p, rk, x: [tuple(c) for c in JE.coeff_to_slot(p, rk, x)[:2]],
        small)
    bsgs, bsgs_plans = _jax_maps(
        lambda p, rk, x: tuple(JE.rmap_bsgs(p, rk, x, A, B, n1=8)[0]), wide)
    return dict(small=small, wide=wide, A=A, B=B, c2s=c2s, bsgs=bsgs,
                plans=c2s_plans + bsgs_plans)


def test_plans_have_both_baby_forms(ref):
    """coeff_to_slot's plan rotates at most 4 babies on z and z_c, with a
    rotated giant; rmap_bsgs at n1 = 8 rotates 7."""
    c2s, bsgs = ref["plans"]
    for plan, babies in ((c2s, 1), (bsgs, 7)):
        assert len(plan.need_d - {0}) == babies
        assert len(plan.need_e - {0}) == babies
    assert any(gi for m in c2s.maps for gi, _ in m)


def test_em_within_one_unit_of_jax(ref):
    """The port's encode and residue NTT of a plan's diagonals against the
    reference's encoder_device.encode and realize_em on the same vectors."""
    n, param = 8, ref["small"]["param"]
    (A1, B1), (A2, B2) = E._c2s_matrices(n)
    *_, V = E._plan_vectors(n, [(A1, B1), (A2, B2)], E._bsgs_n1(n))
    plan = ref["plans"][0]
    scale = float(param.qs[-1])
    m = np.asarray(jax.jit(lambda re, im: JD.encode(re, im, n, scale))(
        V.real, V.imag))
    assert np.abs(plan.src_m - m).max() <= 1
    em = np.asarray(JE.realize_em(JC.Param(n=n, L=L, delta=param.delta),
                                  m)).astype(np.int64)
    diff = np.abs(np.asarray(plan.em).astype(np.int64) - em)
    diff = np.minimum(diff, np.asarray(param.qs)[:, None, None] - diff)
    assert diff.max() <= 1
    port_em = E.realize_em(param, plan.src_m, CPU)
    np.testing.assert_array_equal(interop.to_numpy(port_em),
                                  np.asarray(plan.em))


def test_apply_rmap_plan_matches_jax(ref):
    """apply_rmap_plan on the carried plans == the reference's, bit for bit,
    on both sides of the 4-baby split."""
    c2s, bsgs = (interop.rmap_plan_to_port(p, CPU) for p in ref["plans"])
    small, wide = ref["small"], ref["wide"]
    outs, p2 = E.apply_rmap_plan(small["param"], small["rk"], small["ct"],
                                 c2s)
    assert p2.L == L - 1 and len(outs) == 2
    for got, want in zip(outs, ref["c2s"]):
        same_ct(got, want)
    (got,), _ = E.apply_rmap_plan(PARAM, wide["rk"], wide["ct"], bsgs)
    same_ct(got, ref["bsgs"])


def test_coeff_to_slot_and_rmap_bsgs_match_jax(ref):
    small, wide = ref["small"], ref["wide"]
    c1, c2, p1 = E.coeff_to_slot(small["param"], small["rk"], small["ct"])
    same_ct(c1, ref["c2s"][0])
    same_ct(c2, ref["c2s"][1])
    got, p2 = E.rmap_bsgs(PARAM, wide["rk"], wide["ct"], ref["A"], ref["B"],
                          n1=8)
    same_ct(got, ref["bsgs"])
    (g1,), _ = E.rmap_bsgs_multi(PARAM, wide["rk"], wide["ct"],
                                 [(ref["A"], ref["B"])], n1=8)
    same_ct(g1, ref["bsgs"])
    # decoded: A z + B conj(z), and the coefficients in slots
    z = wide["z"]
    np.testing.assert_allclose(decoded(p2, wide["sk"], got),
                               ref["A"] @ z + ref["B"] @ z.conj(), atol=5e-2)
    z = small["z"]
    p_true = C.encode(small["param"], torch.from_numpy(z.real),
                      torch.from_numpy(z.imag))[0].numpy()
    q0 = PARAM.qs[0]
    p_true = np.where(p_true > q0 // 2, p_true - q0, p_true) / PARAM.delta
    np.testing.assert_allclose(decoded(p1, small["sk"], c1).real,
                               p_true[:4], atol=2e-2)
    np.testing.assert_allclose(decoded(p1, small["sk"], c2).real,
                               p_true[4:], atol=2e-2)


def test_slot_to_coeff_returns_the_slots(ref):
    """C2S then S2C (the reference's round trip) on the port: the original
    slot vector back (5e-2)."""
    wide = ref["wide"]
    c1, c2, p1 = E.coeff_to_slot(PARAM, wide["rk"], wide["ct"])
    back, p2 = E.slot_to_coeff(p1, wide["rk"], c1, c2)
    assert p2.L == L - 2
    np.testing.assert_allclose(decoded(p2, wide["sk"], back), wide["z"],
                               atol=5e-2)


def test_matvec_and_linear_rmap_decode_to_numpy(ref):
    rng = np.random.default_rng(24)
    w = ref["wide"]
    sk, z, ct, rk = w["sk"], w["z"], w["ct"], w["rk"]
    M = _rand(rng, HALF, HALF)
    got, p2 = E.matvec(PARAM, rk, ct, M)
    np.testing.assert_allclose(decoded(p2, sk, got), M @ z, atol=5e-2)
    got, p2 = E.linear_rmap(PARAM, rk, ct, ref["A"], ref["B"])
    np.testing.assert_allclose(decoded(p2, sk, got),
                               ref["A"] @ z + ref["B"] @ z.conj(), atol=5e-2)
    with pytest.raises(ValueError, match="zero"):
        E.linear_rmap(PARAM, rk, ct, np.zeros((HALF, HALF)),
                      np.zeros((HALF, HALF)))


def test_rotations_and_keys(ref):
    """RotKeys.build draws working keys per level; rotate / conjugate move
    the slots as galois.ckks_slot_perm says; missing keys raise."""
    w = ref["wide"]
    sk, z, ct, rk = w["sk"], w["z"], w["ct"], w["rk"]
    assert sorted({lv for lv, _ in rk.keys}) == [L - 1, L]
    assert rk.nbytes() == sum(4 * 2 * lv * (lv + 2) * N
                              for lv, _ in rk.keys)
    for k in (1, 3):
        perm, cj = galois.ckks_slot_perm(N, galois.rotation_element(N, k))
        np.testing.assert_allclose(decoded(PARAM, sk, E.rotate(PARAM, rk,
                                                               ct, k)),
                                   np.where(cj, z[perm].conj(), z[perm]),
                                   atol=1e-3)
    assert E.rotate(PARAM, rk, ct, 0) is ct
    np.testing.assert_allclose(decoded(PARAM, sk, E.conjugate(PARAM, rk, ct)),
                               z.conj(), atol=1e-3)
    with pytest.raises(KeyError, match="missing Galois key"):
        rk.get(L - 2, 5)
    back = interop.rot_keys_to_port(w["jrk"], CPU)
    assert back.keys.keys() == rk.keys.keys()
    for k, v in back.keys.items():
        assert torch.equal(v.b, rk.keys[k].b) and torch.equal(v.a,
                                                               rk.keys[k].a)
