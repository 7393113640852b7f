"""The plain versions of the last three kernels against the JAX package:
``base_extend_sum`` against ops/ext_pallas.py (interpret mode), the
shared-memory ceiling loop against ops/vpu_bench.py's repeat kernel
(interpret mode, mod q: the reference's chain is lazy, the port's fully
reduced), the ``alu_rate`` operations against vpu_bench._op_body iterated,
and utils/profiling against the reference's counts.  Tolerance 0.
"""

from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fhe_study_tpu.ops import ext_pallas, ntt_pallas
from fhe_study_tpu.ops import vpu_bench as V
from fhe_study_tpu.utils import profiling as jprof

from fhe_study_tpu_torch.ops import _cuda, alu_bench, ext_cuda
from fhe_study_tpu_torch.ops.primes import ntt_primes
from fhe_study_tpu_torch.utils import prng, profiling

CPU = torch.device("cpu")
Q = alu_bench.ALU_Q


def res(rng, primes, shape):
    return torch.from_numpy(np.stack(
        [rng.integers(0, p, shape) for p in primes]).astype(np.int32))


@pytest.mark.parametrize("ls,ld,shape,centered", [
    (2, 4, (3, 256), True), (2, 4, (3, 256), False),
    (4, 5, (2, 3, 256), False), (5, 4, (2, 3, 256), True)])
def test_base_extend_sum_matches_jax(ls, ld, shape, centered):
    """The hoisting shapes (src = the K = 2 auxiliary primes, dst = Q) and
    the BFV ones."""
    primes = ntt_primes(ls + ld, 30, 1 << 16)
    src, dst = primes[ld:], primes[:ld]
    x = res(np.random.default_rng(ls), src, shape)
    ys, alpha = ext_cuda.lift_plain(x, src, centered)
    assert int(ys.max()) < max(src) and 0 <= int(alpha.min())
    assert int(alpha.max()) <= ls
    got = ext_cuda.base_extend_sum(ys.int(), alpha.int(), src, dst)
    assert got.dtype == torch.int32 and tuple(got.shape) == (ld,) + shape
    want = ext_pallas.base_extend_sum(
        jnp.asarray(ys.numpy().astype(np.uint64)),
        jnp.asarray(alpha.numpy().astype(np.uint64)), src, dst,
        interpret=True)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(want))
    # lift + sum is the whole conversion, in both packages
    assert torch.equal(got, ext_cuda.base_extend_fused_plain(
        x, src, dst, centered=centered))
    fused = ext_pallas.base_extend_fused(
        jnp.asarray(x.numpy().astype(np.uint32)), src, dst,
        centered=centered, interpret=True)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(fused))


def test_base_extend_sum_checks_its_operands():
    src, dst = ntt_primes(2, 30, 1 << 16), ntt_primes(2, 30, 1 << 16, 2)
    ys = torch.zeros((2, 4, 256), dtype=torch.int32)
    before = _cuda.launches()
    with pytest.raises(ValueError, match="take CUDA tensors"):
        ext_cuda.base_extend_sum_kernel(ys, ys[0], src, dst)
    with pytest.raises(ValueError, match="devices"):
        ext_cuda.base_extend_sum(ys, ys[0].to("meta"), src, dst)
    for bad in ((), ntt_primes(32, 30, 1 << 16, skip=4)):
        with pytest.raises(ValueError, match="1 .. 31"):
            ext_cuda.base_extend_sum_plain(ys, ys[0], bad, dst)
    assert _cuda.launches() == before


def _repeat_reference(x, q, n, reps):
    """vpu_bench._ntt_repeat_kernel in interpret mode, as the JAX package's
    own test builds it."""
    logn = n.bit_length() - 1
    tw = ntt_pallas._tw_dev((q,), n, "fwd")
    B = x.shape[0]
    return pl.pallas_call(
        partial(V._ntt_repeat_kernel, q=q, n=n, reps=reps),
        out_shape=jax.ShapeDtypeStruct((B, n), jnp.uint32), grid=(1,),
        in_specs=[pl.BlockSpec((B, n), lambda i: (0 * i, 0 * i),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, 2, logn, n),
                               lambda i: (0 * i, 0 * i, 0 * i, 0 * i),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((B, n), lambda i: (0 * i, 0 * i),
                               memory_space=pltpu.VMEM),
        interpret=True)(x, tw)


@pytest.mark.parametrize("reps", [0, 1, 2])
def test_ceiling_loop_matches_jax(reps):
    n, B = 512, 8
    x = np.random.default_rng(3).integers(0, Q, (B, n)).astype(np.uint32)
    got = alu_bench.ntt_smem_ceiling_plain(
        torch.from_numpy(x.astype(np.int32)), Q, reps)
    assert got.dtype == torch.int32 and int(got.max()) < Q
    if reps == 0:
        np.testing.assert_array_equal(got.numpy(), x)
        return
    want = np.asarray(_repeat_reference(jnp.asarray(x), Q, n, reps))
    np.testing.assert_array_equal(got.numpy().astype(np.uint64),
                                  want.astype(np.uint64) % Q)


def _operands(shape=(4, 1024), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, Q, shape).astype(np.uint32)
    y = rng.integers(1, Q, shape).astype(np.uint32)
    yp = ((y.astype(np.uint64) << np.uint64(32)) // np.uint64(Q)
          ).astype(np.uint32)
    return x, y, yp


def _bits(a):
    return torch.from_numpy(a.view(np.int32))


@pytest.mark.parametrize("op", ["add", "mul", "addmod", "shoup_lazy"])
def test_alu_ops_match_jax_bodies(op):
    """32 rounds of the port's plain loop == vpu_bench._op_body iterated."""
    x, y, yp = _operands()
    rounds = 2 * alu_bench.ALU_UNROLL
    body = jax.jit(V._op_body(op))
    want = jnp.asarray(x)
    for _ in range(rounds):
        want = body(want, jnp.asarray(y), jnp.asarray(yp), jnp.uint32(Q))
    got = alu_bench.alu_rate_plain(_bits(x), _bits(y), _bits(yp), op, rounds)
    assert got.dtype == torch.int32 and got.shape == (4, 1024)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    if op in ("add", "mul"):               # the values really wrap
        assert int(np.asarray(want).max()) >= 1 << 31


@pytest.mark.parametrize("op", ["shoup_mul", "mont_mul", "butterfly"])
def test_alu_ops_of_the_kernels_match_python_integers(op):
    """The three operations of csrc/modarith.cuh against exact integer
    arithmetic: x*y mod q, x*y*2^-32 mod q, and the forward butterfly."""
    x, y, yp = _operands(shape=(4, 256), seed=1)
    rounds = alu_bench.ALU_UNROLL
    got = alu_bench.alu_rate_plain(_bits(x), _bits(y), _bits(yp), op, rounds)
    xs, ys = x.astype(object), y.astype(object)
    if op == "butterfly":
        u, v, w = xs[0::2], xs[1::2], ys[0::2]
        for _ in range(rounds):
            t = v * w % Q
            u, v = (u + t) % Q, (u - t) % Q
        want = np.stack([u, v], axis=1).reshape(x.shape)
    else:
        factor = ys if op == "shoup_mul" else ys * pow(1 << 32, -1, Q) % Q
        want = xs
        for _ in range(rounds):
            want = want * factor % Q
    np.testing.assert_array_equal(got.numpy().astype(object), want)


def test_alu_rate_checks_its_arguments():
    x, y, yp = (_bits(a) for a in _operands())
    with pytest.raises(ValueError, match="multiples of 16"):
        alu_bench.alu_rate_plain(x, y, yp, "add", 8)
    with pytest.raises(ValueError, match="unknown operation"):
        alu_bench.alu_rate_plain(x, y, yp, "xor", 16)
    with pytest.raises(ValueError, match="multiple of 1024"):
        alu_bench.alu_rate_plain(x[:, :100], y[:, :100], yp[:, :100], "add",
                                 16)
    before = _cuda.launches()
    with pytest.raises(ValueError, match="take CUDA tensors"):
        alu_bench.alu_rate_kernel(x, y, yp, "add", 16)
    with pytest.raises(ValueError, match="take CUDA tensors"):
        alu_bench.ntt_smem_ceiling_kernel(x[:, :256].contiguous(), Q, 1)
    assert _cuda.launches() == before
    assert set(alu_bench.OP_COUNTS) == set(alu_bench.OPS)
    assert set(V.OP_COUNTS) < set(alu_bench.OPS)


def test_measuring_entry_points_need_a_card():
    """They time the kernels and nothing else: no plain version stands in."""
    before = _cuda.launches()
    with pytest.raises(ValueError, match="time CUDA kernels"):
        alu_bench.alu_rate("addmod", CPU, rounds=32, shape=(4, 1024), iters=1)
    with pytest.raises(ValueError, match="time CUDA kernels"):
        alu_bench.ntt_smem_ceiling(CPU, n=256, B=8, reps=2, iters=1)
    assert _cuda.launches() == before


def test_bound_counts_are_the_recorded_sass_counts():
    """The primitives' instruction counts by pipe that every bound is made
    of are the ones read from the built loops, and the alu_rate cases carry
    them."""
    from fhe_study_tpu_torch.utils import kernel_check as kc
    rec = alu_bench.OP_PIPES
    assert kc.BUTTERFLY_OPS == kc.Work(*rec["butterfly"])
    assert kc.MONT_OPS == kc.Work(*rec["mont_mul"])
    assert kc.SHOUP_OPS == kc.Work(*rec["shoup_mul"])
    assert kc.ADD_OPS == kc.Work(*rec["addmod"])
    gen = prng.Gen(3)
    cases = kc.bench_cases(256, 2, CPU, gen, rounds=32)
    ceiling, alu = cases[0], cases[1:]
    assert (ceiling.n, ceiling.timed) == (256, True)
    assert ceiling.ops == ceiling.butterflies * kc.BUTTERFLY_OPS
    words = 256 * 1024
    for op, case in zip(alu_bench.OPS, alu):
        units = words // 2 if op == "butterfly" else words
        assert case.ops == units * 32 * kc.Work(*rec[op]), op
    halved = kc.bench_cases(256, 2, CPU, gen, rounds=32,
                            counts={op: (0.5, 0, 0) for op in rec})
    assert halved[1].ops == kc.Work(words * 32 // 2)
    whole = [c for c in kc.ext_sum_cases(256, 2, CPU, gen)
             if not c.timed]
    assert len(whole) == 4 and all("whole conversion" in c.label
                                   for c in whole)


@pytest.mark.parametrize("op", alu_bench.OPS)
def test_pipe_table_on_the_recorded_loops(op):
    """utils/sass_counts' mnemonic -> pipe table splits each recorded loop
    into the (ALU, FMA, wide) counts that OP_PIPES records, and each pair
    sums to the loop's scalar count (OP_COUNTS)."""
    from fhe_study_tpu_torch.utils import sass_counts
    units = alu_bench.ALU_UNROLL * alu_bench.ALU_PER_THREAD
    units //= 2 if op == "butterfly" else 1
    alu, fma, wide = sass_counts.pipe_counts(alu_bench.LOOP_SASS[op])
    assert (alu / units, fma / units, wide / units) == alu_bench.OP_PIPES[op]
    assert (alu + fma) / units == alu_bench.OP_COUNTS[op]
    assert wide <= fma
    with pytest.raises(ValueError, match="no pipe"):
        sass_counts.pipe_counts({"FFMA": 1, **alu_bench.LOOP_SASS[op]})


def test_bound_takes_the_slowest_term():
    """kernel_check.bound: bytes over 3.35 TB/s, all instructions over 128
    a clock and SM, each pipe's slots (wide = 2 FMA + 1 ALU) over 64."""
    from fhe_study_tpu_torch.utils import kernel_check as kc
    sms, clock = 132, 1.98e9
    per_ms = sms * clock * 1e-3
    b = kc.bound(0, kc.Work(64, 0), sms, clock)
    assert b.term == "ALU"
    assert b.ms == pytest.approx(1 / per_ms)
    assert b.issue_only_ms == pytest.approx(0.5 / per_ms)
    b = kc.bound(0, kc.Work(0, 48, 16), sms, clock)
    assert b.term == "FMA" and b.ms == pytest.approx(1 / per_ms)
    assert b.alu_ms == pytest.approx(0.25 / per_ms)
    b = kc.bound(0, kc.Work(64, 64), sms, clock)
    assert b.issue_ms == b.alu_ms == b.fma_ms == pytest.approx(1 / per_ms)
    b = kc.bound(3.35e9, kc.Work(1, 1), sms, clock)
    assert (b.term, b.ms) == ("bytes", pytest.approx(1.0))
    assert sum([kc.Work(1, 2, 1), kc.Work(3)]) == kc.Work(4, 2, 1)
    assert 2 * kc.Work(1, 2, 1) == kc.Work(2, 4, 2)


def test_ntt_roofline_matches_jax():
    for batch, n, secs, nb in ((9 * 64 * 8 * 3, 1 << 14, 0.01, 4),
                               (7, 256, 1.5, 8)):
        mine = profiling.ntt_roofline(batch, n, secs, dtype_bytes=nb)
        ref = jprof.ntt_roofline(batch, n, secs, dtype_bytes=nb)
        assert (mine.butterflies, mine.hbm_bytes) == (ref.butterflies,
                                                      ref.hbm_bytes)
        assert mine.butterflies_per_sec == ref.butterflies_per_sec
        assert mine.hbm_gbps == ref.hbm_gbps
        rep = mine.report()
        assert rep["hbm_fraction_of_peak"] == pytest.approx(
            mine.hbm_gbps / 3350.0)
        assert mine.report(peak_gbps=100.0)["hbm_fraction_of_peak"] == \
            ref.report(peak_gbps=100.0)["hbm_fraction_of_peak"]


def test_profiling_helpers():
    e = torch.tensor([0, 1, -4, 1 << 20])
    np.testing.assert_array_equal(
        profiling.noise_budget_bits(e, 1 << 30).numpy(),
        np.asarray(jprof.noise_budget_bits(jnp.asarray(e.numpy()), 1 << 30)))
    results = {}
    with profiling.timed("block", results):
        calls = []
    assert results["block"] >= 0
    dt = profiling.time_fn(lambda a: calls.append(a), 1, device=CPU, iters=3,
                           warmup=2)
    assert len(calls) == 5 and dt >= 0
