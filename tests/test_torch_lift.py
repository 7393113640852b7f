"""The lift (the first half of the base conversion, which K5 ext_ntt and K6
tensor_mul4 run once per polynomial before their staged layout) on the CPU.

``ext_cuda.lift_plain``, which the lift kernel is held against on the card,
against the JAX package's own first half: the ys and alpha of
``fhe_study_tpu/models/bfv_rns.py::fast_base_extend``'s XLA branch, rebuilt
here from the reference's ``modops32.mont_mul``, ``_hat_inv_mont`` and its
2^59 fixed-point alpha under ``jax.jit``, from 14, 16, 29 and 31 source
primes, unsigned and centered, at inputs whose last coefficient has every
y_i = s_i - 1 (the largest alpha sum, past 2^63 from 16 sources).  Then the
wrappers' plan (``ntt_cuda.lift_plan``): which source counts take the
staged layout, the scratch's shape and bytes at N = 2^15, B = 128 on the
paths that run it, one counted launch per op (the lift queued by the same C
call, with its scratch), and the word maps that the staged forms read the
lift's rows through (each word of a polynomial once, lanes on consecutive
words).  Tolerance 0 throughout.
"""

import contextlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_study_tpu.models import bfv_rns as J
from fhe_study_tpu.ops import modops32 as J32

from fhe_study_tpu_torch.ops import _cuda, ext_cuda
from fhe_study_tpu_torch.ops import ntt_cuda as nc
from fhe_study_tpu_torch.ops.primes import ntt_primes

N = 256
SRC = ntt_primes(31, 30, 1 << 16, skip=5)


def _input(seed: int, src: tuple) -> np.ndarray:
    """[Ls, 2, n] residues whose last coefficient has y_i = s_i - 1 in
    every row: the largest alpha sum."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, s, (2, N)) for s in src])
    S = 1
    for s in src:
        S *= s
    for i, s in enumerate(src):
        x[i, -1, -1] = (s - 1) * (S // s % s) % s
    return x.astype(np.uint32)


def _jax_lift(src: tuple, centered: bool):
    """fast_base_extend's first half as the JAX package writes it (its XLA
    branch): Montgomery ys, then the 2^59 fixed-point alpha in u64."""
    sv, snq, _ = (jnp.asarray(c) for c in J32.consts(src, 3))
    him = jnp.asarray(J._hat_inv_mont(src)).reshape(sv.shape)
    cfix = jnp.asarray(np.array([(1 << 59) // p for p in src], np.uint64)
                       ).reshape(sv.shape)
    half = jnp.uint64(1 << 58) if centered else jnp.uint64(0)

    @jax.jit
    def lift(x):
        ys = J32.mont_mul(x, him, sv, snq)
        tsum = jnp.sum(ys.astype(jnp.uint64) * cfix, axis=0)
        return ys, ((tsum + half) >> jnp.uint64(59)).astype(jnp.uint32)

    return lift


@pytest.mark.parametrize("ls", [14, 16, 29, 31])
def test_lift_plain_matches_the_reference_first_half(ls):
    src = SRC[:ls]
    x = _input(ls, src)
    for centered in (False, True):
        want_ys, want_alpha = _jax_lift(src, centered)(jnp.asarray(x))
        ys, alpha = ext_cuda.lift_plain(torch.from_numpy(x.astype(np.int64)),
                                        src, centered)
        np.testing.assert_array_equal(ys.numpy(),
                                      np.asarray(want_ys).astype(np.int64))
        np.testing.assert_array_equal(alpha.numpy(),
                                      np.asarray(want_alpha).astype(np.int64))
        assert int(alpha.max()) <= ls


@pytest.mark.parametrize("ls", range(1, ext_cuda.MAX_SRC + 1))
def test_staged_layout_takes_every_count_without_an_instance(ls):
    """K5 converts in its kernel from 2 and 4 source primes, K6 from 4;
    every other count is staged, with a scratch of (Ls + 1) rows an
    operand (one operand for K5, four for K6)."""
    for kernel, direct, ops in ((_cuda.EXT_NTT, (2, 4), 1),
                                (_cuda.TENSOR_MUL4, (4,), 4)):
        plan = nc.lift_plan(kernel, ls, 3, 128)
        assert plan.staged == (ls not in direct)
        if plan.staged:
            assert plan.shape == (ops, ls + 1, 3, 128)
            assert plan.bytes == 4 * ops * (ls + 1) * 3 * 128
        else:
            assert plan == nc.LiftPlan(False, (), 0)


@pytest.mark.parametrize("kernel,ls,batch,want", [
    # mul_e and to_evals: K5 on the [L, 128, 2, 2^15] pair
    (_cuda.EXT_NTT, 14, 256, ((1, 15, 256, 1 << 15), 503_316_480)),
    (_cuda.EXT_NTT, 29, 256, ((1, 30, 256, 1 << 15), 1_006_632_960)),
    # mul: K6 over P from four [L, 128, 2^15] operands
    (_cuda.TENSOR_MUL4, 14, 128, ((4, 15, 128, 1 << 15), 1_006_632_960)),
    (_cuda.TENSOR_MUL4, 29, 128, ((4, 30, 128, 1 << 15), 2_013_265_920)),
])
def test_scratch_at_the_paths_of_degree_2_15(kernel, ls, batch, want):
    plan = nc.lift_plan(kernel, ls, batch, 1 << 15)
    assert plan.staged and (plan.shape, plan.bytes) == want


@contextlib.contextmanager
def _fake_card(calls: dict, kernels=(_cuda.EXT_NTT, _cuda.TENSOR_MUL4)):
    """The wrappers of ``kernels`` (by default K5 and K6) run on CPU tensors
    up to their C call, which is recorded (its arguments) instead of made:
    the launch path, its count and its layout, without a card."""
    saved = (_cuda.check, torch.cuda.device, torch.cuda.current_stream,
             {k: k._fn for k in kernels})

    class _Stream:
        cuda_stream = 0

    _cuda.check = lambda *a, **k: None
    torch.cuda.device = lambda d: contextlib.nullcontext()
    torch.cuda.current_stream = lambda d: _Stream()
    for k in saved[3]:
        k._fn = (lambda name: lambda *a: calls.setdefault(name, []).append(a)
                 or 0)(k.name)
    try:
        yield
    finally:
        _cuda.check, torch.cuda.device, torch.cuda.current_stream = saved[:3]
        for k, fn in saved[3].items():
            k._fn = fn


@pytest.mark.parametrize("ls", [3, 4, 14])
def test_one_counted_launch_an_op_with_its_scratch(ls):
    """One C call (and one count) a call of K5 and of K6 with a source
    basis: staged, it gets a scratch pointer (the lift is queued inside the
    call), direct a null one; the layout is counted beside."""
    n, src, dst = 128, SRC[:ls], SRC[ls:ls + 5]
    x = torch.zeros((ls, 2, 3, n), dtype=torch.int32)
    ops = [torch.zeros((ls, 3, n), dtype=torch.int32) for _ in range(4)]
    over_dst = [torch.zeros((5, 3, n), dtype=torch.int32) for _ in range(4)]
    calls = {}
    _cuda.reset_launches()
    with _fake_card(calls):
        nc.ext_ntt_kernel(x, src, dst)
        nc.tensor_mul4_kernel(*ops, dst, src=src)
        nc.tensor_mul4_kernel(*over_dst, dst)
    k5, k6 = calls["ext_ntt"], calls["tensor_mul4"]
    assert len(k5) == 1 and len(k6) == 2
    assert _cuda.EXT_NTT.launches == 1 and _cuda.TENSOR_MUL4.launches == 2
    k5_staged = ls not in nc.EXT_NTT_DIRECT
    k6_staged = ls not in nc.MUL4_DIRECT
    # the lift's scratch (K5's second argument, K6's thirteenth), the chunk
    # scratch (K6's fourteenth: none in one block) and the source count
    # (K6's twenty-second)
    assert (k5[0][1] is not None) == k5_staged
    assert (k6[0][12] is not None) == k6_staged and k6[0][21] == ls
    assert k6[1][12] is None and k6[1][21] == 0
    assert k6[0][13] is None and k6[1][13] is None
    assert _cuda.EXT_NTT.by_layout == {"direct": int(not k5_staged),
                                       "staged": int(k5_staged),
                                       "chunked direct": 0,
                                       "chunked staged": 0}
    assert _cuda.TENSOR_MUL4.by_layout == {"direct": 1 + int(not k6_staged),
                                           "staged": int(k6_staged),
                                           "chunked direct": 0,
                                           "chunked staged": 0}
    _cuda.reset_launches()


@pytest.mark.parametrize("logn", nc.BLOCK_LOGNS)
def test_staged_word_maps_cover_each_word_once(logn):
    """K5's staged first pass reads word base + (j << c0) of each lift row
    for the 16 words j of the virtual thread at base (K6's below 2^15 the
    same on its plan); at 2^15 K6's split block reads, a run, words
    i0 + (m % 8) threads of its half and their partners h on (m >= 8).
    Each map covers the polynomial once, with lanes on consecutive words."""
    n = 1 << logn
    for plan in (nc._radix_plan(logn), nc._mul4_plan(logn)):
        if plan.logn != logn:
            continue
        c0 = plan.forward[0].c
        seen = []
        for g in range(plan.groups):
            v = np.arange(plan.threads) + g * plan.threads
            for j in range(16):
                words = v + (j << c0)
                if plan.threads >= 32:
                    assert np.all(np.diff(words[:32]) == 1)
                seen.append(words)
        assert np.array_equal(np.sort(np.concatenate(seen)), np.arange(n))
    if logn == nc.WIDE_LOGN:
        plan, h = nc._mul4_plan(logn), n // 2
        run, T = 8 * plan.threads, plan.threads
        lo, hi = [], []
        for t in range(T):
            for i0 in range(t, h, run):
                m = np.arange(16)
                words = i0 + (m % 8) * T + (m // 8) * h
                lo.append(words[:8])
                hi.append(words[8:])
                assert np.array_equal(words[8:], words[:8] + h)
        assert np.array_equal(np.sort(np.concatenate(lo)), np.arange(h))
        assert np.array_equal(np.sort(np.concatenate(hi)), np.arange(h, n))
