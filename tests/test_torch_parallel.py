"""The port's parallel layer (fhe_study_tpu_torch/parallel) against the JAX
package's on the CPU: mesh layouts without processes, the four-step
tables, and the sharded functions in 8 gloo ranks (one spawn, a module
fixture) against the JAX functions on the conftest's 8 virtual devices, on
the same numpy-seeded or carried inputs, bit for bit.

The reference's ``polymul_i64_crt_ep`` and ``key_switch_tp`` are
shard_maps manual over one axis (``axis_names={"ep"}`` / ``{"tp"}``); the
installed JAX refuses those on a mesh with other axes ("out_specs argument
must refer to an axis marked as manual"), so they run here on a 1-D mesh
of their own axis (two devices), which is the same computation, and the
reference's whole step is its four parts so run (its ``bfv.mul`` under
``jax.jit``).  The port runs all of them on factor_mesh(8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from fhe_study_tpu.arith.params import RingParam as JRingParam
from fhe_study_tpu.models import bfv as jbfv
from fhe_study_tpu.models.gfhe import glwe as JG
from fhe_study_tpu.parallel import mesh as jmesh
from fhe_study_tpu.parallel import ntt_sharded as jns
from fhe_study_tpu.parallel import pipeline as jpipe
from fhe_study_tpu.utils import prng as jprng

from fhe_study_tpu_torch.arith.params import RingParam
from fhe_study_tpu_torch.models import bfv
from fhe_study_tpu_torch.models.gfhe import glwe as G
from fhe_study_tpu_torch.parallel import (comm, launch, mesh, ntt_sharded,
                                          pipeline)
from fhe_study_tpu_torch.utils import interop

Q = 2 ** 16 + 1
WORLD = 8
SPAWN_TIMEOUT_S = 240
CPU = torch.device("cpu")


def ids(m) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(m.devices)


@pytest.mark.parametrize("dp,ep,sp", [(None, 1, 1), (4, 1, 2), (2, 2, 2),
                                      (1, 2, 4), (1, 8, 1), (2, 1, 1)])
def test_rank_grid_is_make_mesh_device_ids(dp, ep, sp):
    want = ids(jmesh.make_mesh(dp=dp, ep=ep, sp=sp))
    np.testing.assert_array_equal(mesh.rank_grid(WORLD, dp, ep, sp), want)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_factor_grid_is_factor_mesh_device_ids(n):
    jm = jpipe.factor_mesh(n)
    assert pipeline.factor_sizes(n) == dict(jm.shape)
    np.testing.assert_array_equal(pipeline.factor_grid(n), ids(jm))


@pytest.mark.parametrize("q,n,n1", [(Q, 256, 16), (Q, 64, 8),
                                    (12289, 1024, 32), (Q, 128, 16)])
def test_four_step_consts(q, n, n1):
    got = ntt_sharded._four_step_consts(q, n, n1)
    want = jns._four_step_consts(q, n, n1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("n,S", [(256, 2), (4096, 2), (1024, 8), (64, 4)])
def test_split_n1_is_the_reference_split(n, S):
    n1 = S
    while n1 * n1 < n:
        n1 *= 2
    assert ntt_sharded.split_n1(n, S) == n1


def test_split_n1_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="does not split"):
        ntt_sharded.split_n1(8, 4)


# -- the sharded functions, in 8 ranks -----------------------------------

def _np(x):
    return launch.from_rank(x)


def _glwe_setup(key, jkp):
    """A KSK (beta=2, l=8) and a GLWE encryption of a binary message under
    its source key."""
    ks = jprng.split(key, 4)
    s1, _ = JG.new_key(ks[0], jkp)
    s2, _ = JG.new_key(ks[1], jkp)
    msg = jnp.arange(jkp.ring.n, dtype=jnp.uint64) % 2
    return (JG.new_ksk(ks[2], jkp, 2, 8, s1, s2),
            JG.encrypt_s(ks[3], jkp, s1, JG.encode(jkp, msg)))


def _step_setup(key, jparam, jks_param, beta, l, B):
    """The reference dryrun's keys and ciphertexts (pipeline.py:637-648)."""
    ks = jprng.split(key, 8)
    n = jparam.ring.n
    sk, pk = jbfv.new_key(ks[0], jparam, batch=(B,))
    rlk = jbfv.rlk_key(ks[1], jparam, sk, batch=(B,))
    m = jprng.uniform_mod(ks[2], (B, n), jparam.t)
    c1 = jbfv.encrypt(ks[3], jparam, pk, m, batch=(B,))
    c2 = jbfv.encrypt(ks[4], jparam, pk, m, batch=(B,))
    gsk, _ = JG.new_key(ks[5], jks_param)
    gsk2, _ = JG.new_key(ks[6], jks_param)
    ksk = JG.new_ksk(ks[7], jks_param, beta, l, gsk, gsk2)
    gct = JG.encrypt_s(ks[5], jks_param, gsk,
                       JG.encode(jks_param, m[0] % jks_param.t))
    return c1, c2, rlk, ksk, gct


@pytest.fixture(scope="module")
def case():
    """The JAX side's inputs and outputs (every call under jax.jit), and
    the port's outputs from one spawn of 8 gloo ranks on the same
    inputs."""
    rng = np.random.default_rng(14)
    out = {}
    jm8 = jpipe.factor_mesh(WORLD)
    jep = Mesh(np.array(jax.devices()[:2]), ("ep",))
    jtp = Mesh(np.array(jax.devices()[:2]), ("tp",))
    # sp: four-step product on dp4 x sp2 (the reference test's mesh)
    a = rng.integers(0, Q, size=(8, 256), dtype=np.uint64)
    b = rng.integers(0, Q, size=(8, 256), dtype=np.uint64)
    jsp = jmesh.make_mesh(dp=4, sp=2)
    out["sp"] = np.asarray(jax.jit(
        lambda u, v: jns.negacyclic_mul_sharded(u, v, Q, jsp, axis="sp"))(
            jnp.asarray(a), jnp.asarray(b)))
    # ep: signed CRT product on ep2
    x = rng.integers(-2 ** 20, 2 ** 20, size=(3, 256), dtype=np.int64)
    y = rng.integers(-2 ** 20, 2 ** 20, size=(3, 256), dtype=np.int64)
    ep_prod = jax.jit(lambda u, v: jpipe.polymul_i64_crt_ep(u, v, jep))
    out["ep"] = np.asarray(ep_prod(jnp.asarray(x), jnp.asarray(y)))
    # tp: GLWE key switch (k=4, beta=2, l=8) with a JAX KSK, on tp2
    jkp = JG.Param(JG.ERR_SIGMA, JRingParam(Q, 128), 4, 2)
    jksk, jct = jax.jit(lambda k: _glwe_setup(k, jkp))(
        jax.random.PRNGKey(3))
    out["tp"] = jax.jit(lambda k, c: jpipe.key_switch_tp(
        jkp, 2, 8, k, c, jtp))(jksk, jct)
    # the whole step at the reference dryrun's shapes (q = 65537, n = 64)
    n, beta, l, B = 64, 2, 8, 2
    jparam = jbfv.Param(JRingParam(Q, n), 2, Q * Q)
    jks_param = JG.Param(JG.ERR_SIGMA, JRingParam(Q, n), 4, 2)
    c1, c2, rlk, ksk, gct = jax.jit(
        lambda k: _step_setup(k, jparam, jks_param, beta, l, B))(
            jax.random.PRNGKey(0))
    out["step"] = (
        jax.jit(lambda u, v, r: jbfv.mul(jparam, r, jbfv.RLWE(*u),
                                         jbfv.RLWE(*v), fast=True))(
            tuple(c1), tuple(c2), rlk),
        ep_prod(c1[0].astype(jnp.int64)[0], c2[0].astype(jnp.int64)[0]),
        jax.jit(lambda u, v: jns.negacyclic_mul_sharded(
            u, v, Q, jm8, axis="sp"))(c1[0][0], c2[0][0]),
        jax.jit(lambda k, c: jpipe.key_switch_tp(
            jks_param, beta, l, k, c, jtp))(ksk, gct))

    def port(obj):
        return _np(interop.to_port(obj, CPU))

    kp = G.Param(G.ERR_SIGMA, RingParam(Q, 128), 4, 2)
    param = bfv.Param(RingParam(Q, n), 2, Q * Q)
    ks_param = G.Param(G.ERR_SIGMA, RingParam(Q, n), 4, 2)
    f8 = launch.MeshOf(pipeline.factor_mesh, (WORLD,))
    steps = (
        (ntt_sharded.negacyclic_mul_sharded,
         (a.astype(np.int64), b.astype(np.int64), Q,
          launch.MeshOf(mesh.make_mesh, (WORLD, 4, 1, 2)), "sp")),
        (pipeline.polymul_i64_crt_ep, (x, y, f8)),
        (pipeline.key_switch_tp, (kp, 2, 8, port(jksk), port(jct), f8)),
        (pipeline.ct_mul_step,
         (f8, param, ks_param, beta, l, port(c1), port(c2), port(rlk),
          port(ksk), port(gct))),
        (comm.staged_bytes, ()),
    )
    out["port"] = launch.spawn(launch.calls, WORLD, "cpu", "gloo",
                               SPAWN_TIMEOUT_S, steps)
    return out


def _u64(x) -> np.ndarray:
    return np.asarray(x).view(np.uint64) if np.asarray(x).dtype == np.int64 \
        else np.asarray(x)


def test_negacyclic_mul_sharded(case):
    for rank_out in case["port"]:
        np.testing.assert_array_equal(rank_out[0].astype(np.uint64),
                                      case["sp"])


def test_polymul_i64_crt_ep(case):
    for rank_out in case["port"]:
        np.testing.assert_array_equal(rank_out[1], case["ep"])


def test_key_switch_tp(case):
    for rank_out in case["port"]:
        for got, want in zip(rank_out[2], case["tp"]):
            np.testing.assert_array_equal(_u64(got), np.asarray(want))


def test_multichip_ct_mul_step(case):
    want_out, want_ep, want_sp, want_ks = case["step"]
    for rank_out in case["port"]:
        out, ep, sp, ks_out = rank_out[3]
        for got, want in zip(out, want_out):
            np.testing.assert_array_equal(_u64(got), np.asarray(want))
        np.testing.assert_array_equal(ep, np.asarray(want_ep))
        np.testing.assert_array_equal(_u64(sp), np.asarray(want_sp))
        for got, want in zip(ks_out, want_ks):
            np.testing.assert_array_equal(_u64(got), np.asarray(want))


def test_cpu_ranks_stage_nothing(case):
    """gloo takes CPU tensors where they lie: no byte goes through a
    staging copy."""
    assert [r[4] for r in case["port"]] == [0] * WORLD
