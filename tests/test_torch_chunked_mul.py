"""K6 tensor_mul4, tensor_mul, K7 ks_fused and K8 ks_fused_eval past one
block's polynomial (n = 2^16 .. 2^26 on the card: the chunked schedules of
csrc/tensor_mul4_chunks_cuda.cu and csrc/ks_fused_chunks_cuda.cu), on the
CPU.

  * K6's chunked schedule written out in torch (tests/chunk_emulation.py):
    each operand's forward with its word formed in the first top pass (the
    word of a strided operand row, its extension from 4 source rows direct,
    or from the lift's rows), the chunk chains into the eval scratch; then
    K2's products formed in the first inverse pass of the chunk chains from
    the scratch's four operand chunks, the inverse top passes, the last
    with n^-1 2^32 scale; tensor_mul's stacked operand read on its row
    strides;
  * K7's and K8's: each digit row's forward with the limb reduced by
    `reps` conditional subtractions in the first top pass, the Montgomery
    products with kb and ka added into the two sums at each word's own
    address after the chunk chains (row 0 writes them); K7's inverses of
    the sums with n^-1 2^32; K8's e_h = acc_h 2^32 + NTT(add_h) formed
    after add_h's chunk chains, and its inverse with n^-1;
    each equals the plain version bit for bit at (n, c) = (2^10, 2^7), and
    at (2^16, 2^15) for one case each;
  * each wrapper at n = 2^16 makes one C call with the chunk tables, the
    chunk's block shape and its scratch, counted under its chunked layout
    (the C call recorded instead of made, tests/test_torch_lift.py's fake
    card);
  * against the JAX package at n = 2^16, B = 1 (its XLA path under one
    ``jax.jit``), over two 30-bit primes with 2^17-th roots, R = 2: the
    port's ``tensor_mul4`` (no source basis, and from 3 sources),
    ``tensor_mul_multi``, ``ks_fused_multi`` and ``ks_fused_eval``.

Inputs are numpy draws from fixed seeds; tolerance 0 throughout.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_study_tpu.ops import ntt as jntt

from fhe_study_tpu_torch.ops import _cuda, ext_cuda, ntt
from fhe_study_tpu_torch.ops import ntt_cuda as nc
from fhe_study_tpu_torch.ops.primes import ntt_primes
from chunk_emulation import _chunked
from test_torch_lift import _fake_card
from test_torch_radix_plan import _mont

N = 1 << 16
QS = ntt_primes(2, 30, 1 << 17)               # 2^17-th roots: n = 2^16
SRC = ntt_primes(4, 30, 1 << 16, skip=8)      # any primes apart from QS
R32 = 1 << 32
# XLA's backend optimisation off for the references (integer programs:
# exact at any level), as tests/test_torch_degree16.py compiles its own
JAX_FAST = {"xla_backend_optimization_level": 0}


def _primes(logn: int) -> tuple:
    return ntt_primes(2, 30, 2 << logn)


def _rows(rng, primes, shape):
    """int64 [len(primes), *shape] residues, row i below primes[i]."""
    return torch.stack([torch.from_numpy(rng.integers(0, q, shape))
                        for q in primes])


def _k6_emulated(ops, q: int, p: int, b: int, logn: int, logc: int,
                 fin: int, src=None):
    """K6's chunked schedule for destination prime q (row p of the
    operands without a source basis) and polynomial b: [3, n]."""
    lifts = ([ext_cuda.lift_plain(o, src) for o in ops]
             if src is not None and len(src) not in nc.MUL4_DIRECT else None)
    evals = []
    for i, o in enumerate(ops):
        if src is None:
            def first(el, o=o):
                return o[p, b, el.reshape(-1)].long().reshape(el.shape)
        elif lifts is None:
            def first(el, o=o):
                return ext_cuda.base_extend_fused_plain(
                    o[:, b, el.reshape(-1)], src, (q,))[0].long().reshape(
                        el.shape)
        else:
            def first(el, ys=lifts[i][0], alpha=lifts[i][1]):
                return ext_cuda.base_extend_sum_plain(
                    ys[:, b, el.reshape(-1)], alpha[b, el.reshape(-1)], src,
                    (q,))[0].long().reshape(el.shape)
        evals.append(_chunked(None, q, logn, logc, False, first=first))
    out = []
    for k in range(3):
        def first(r, addr, k=k):
            e = [v[r * (1 << logc) + addr] for v in evals]
            if k == 1:
                return (_mont(e[0], e[3], q) + _mont(e[1], e[2], q)) % q
            return _mont(e[k // 2], e[2 + k // 2], q)
        out.append(_chunked(None, q, logn, logc, True, fin, first=first))
    return torch.stack(out)


def _strided_ops(rng, primes, B: int, n: int):
    """x0, x1 the halves of a [B, 2, n] pair, y1, y0 those of another, the
    pairs one word off the 16-byte alignment: strided rows."""
    out = []
    for _ in range(2):
        buf = torch.cat([torch.zeros(1, dtype=torch.int32),
                         _rows(rng, primes, (B, 2, n)).int().reshape(-1)])
        out.append(buf[1:].view(len(primes), B, 2, n))
    return [out[0][..., 0, :], out[0][..., 1, :], out[1][..., 1, :],
            out[1][..., 0, :]]


@pytest.mark.parametrize("logn,logc,forms", [
    (10, 7, ("strided", "stacked", 4, 3)), (16, 15, (3,))])
def test_k6_chunked_schedule_equals_plain(logn, logc, forms):
    """Two destination primes and two polynomials at 2^10, the last of each
    emulated (rows past the first: their strides count); one of each at
    2^16.  Operands without a source basis as strided rows one word off,
    tensor_mul's stacked operand on its row strides, and from 4 (direct)
    and 3 (staged) source primes."""
    n = 1 << logn
    dst = _primes(logn) if logn < 16 else _primes(logn)[:1]
    B = 2 if logn < 16 else 1
    rng = np.random.default_rng(50 + logn)
    scale = tuple(int(v) for v in rng.integers(1, 1 << 20, len(dst)))
    for form in forms:
        src = None if isinstance(form, str) else SRC[:form]
        if form == "strided":
            ops = _strided_ops(rng, dst, B, n)
            want = nc.tensor_mul4_plain(*ops, dst, scale=scale)
        elif form == "stacked":
            x4 = _rows(rng, dst, (B, 4, n)).int()
            ops = [x4[..., i, :] for i in range(4)]
            want = nc.tensor_mul_plain(x4, dst, scale=scale)
        else:
            ops = [_rows(rng, src, (B, n)).int() for _ in range(4)]
            want = nc.tensor_mul4_plain(*ops, dst, scale=scale, src=src)
        p, b = len(dst) - 1, B - 1
        fin = nc._tensor_fin((dst[p],), n, (scale[p],))[0]
        got = _k6_emulated(ops, dst[p], p, b, logn, logc, fin, src)
        assert torch.equal(got, want[p, b].long()), form


def _ks_emulated(c, keys, q: int, p: int, b: int, reps: int, logn: int,
                 logc: int, adds):
    """K7's ([2, n]) and K8's ([4, n]) chunked schedules for prime q (row p
    of the keys and adds) and polynomial b: the digit rows' accumulation,
    which the two share, then each one's own end."""
    n = 1 << logn
    acc = [None, None]
    for r in range(c.shape[0]):
        def first(el, r=r):
            v = c[r, b, el.reshape(-1)].long()
            for _ in range(reps):
                v = torch.where(v >= q, v - q, v)
            return v.reshape(el.shape)
        d = _chunked(None, q, logn, logc, False, first=first)
        for h in (0, 1):
            prod = _mont(d, keys[h][r, p].long(), q)
            acc[h] = prod if r == 0 else (acc[h] + prod) % q
    fin = pow(n, -1, q) * (R32 % q) % q
    k7 = torch.stack([_chunked(a, q, logn, logc, True, fin) for a in acc])
    e = []
    for h in (0, 1):
        def first(el, h=h):
            return adds[h][p, b, el.reshape(-1)].long().reshape(el.shape)
        t = _chunked(None, q, logn, logc, False, first=first)
        e.append((acc[h] * (R32 % q) + t) % q)
    return k7, torch.stack(e + [_chunked(x, q, logn, logc, True,
                                         pow(n, -1, q)) for x in e])


@pytest.mark.parametrize("logn,logc,rs", [(10, 7, (1, 3)), (16, 15, (2,))])
def test_k7_k8_chunked_schedule_equals_plain(logn, logc, rs):
    """R limb rows over 30-bit source primes above the destination primes
    (reps >= 2), c_limbs and K8's adds strided views ([R, B, 3, n] and
    [Lp, B, 2, n] rows); two primes and two polynomials at 2^10, the last
    of each emulated, one of each at 2^16."""
    n = 1 << logn
    dst = ntt_primes(2 if logn < 16 else 1, 28, 2 << logn)
    B = 2 if logn < 16 else 1
    rng = np.random.default_rng(60 + logn)
    for R in rs:
        src = SRC[:R]
        reps = nc.digit_reps(dst, src)
        assert reps >= 2
        c = _rows(rng, src, (B, 3, n)).int()[..., 2, :]
        keys = [torch.stack([_rows(rng, dst, (n,)) for _ in range(R)]).int()
                for _ in range(2)]
        pair = _rows(rng, dst, (B, 2, n)).int()
        adds = (pair[..., 0, :], pair[..., 1, :])
        k7 = nc.ks_fused_plain(c, *keys, dst, src)
        k8 = nc.ks_fused_eval_plain(c, *keys, dst, src, adds)
        p, b = len(dst) - 1, B - 1
        g7, g8 = _ks_emulated(c, keys, dst[p], p, b, reps, logn, logc, adds)
        assert torch.equal(g7, torch.stack([w[p, b] for w in k7]).long()), R
        assert torch.equal(g8, torch.stack([w[p, b] for w in k8]).long()), R


def test_wrappers_queue_the_chunked_schedule_at_n_2_16(monkeypatch):
    """On CPU tensors up to the C call (recorded, not made): one call of
    each wrapper with its argument list, the chunk tables [L, 2, 2^15] of
    both directions, the chunk's block shape (512 threads, 128 KB) and its
    32-bit scratch (K6's eval scratch of 4 Ld B n words, K7's and K8's one
    digit row of Lp B n; K6's lift too from 3 sources), and one launch
    under its layout past one block."""
    kernels = (_cuda.TENSOR_MUL4, _cuda.TENSOR_MUL, _cuda.KS_FUSED,
               _cuda.KS_FUSED_EVAL)
    B, qs, cpu = 3, QS, torch.device("cpu")
    scratch = []
    real = nc._chunk_scratch
    monkeypatch.setattr(nc, "_chunk_scratch", lambda logn, words, dev: (
        scratch.append(words), real(logn, words, dev))[1])
    ops = [torch.zeros((2, B, N), dtype=torch.int32) for _ in range(4)]
    keys = torch.zeros((2, 2, N), dtype=torch.int32)
    calls = {}
    _cuda.reset_launches()
    with _fake_card(calls, kernels):
        nc.tensor_mul4_kernel(*ops, qs, scale=(3, 5))
        for ls in (4, 3):
            nc.tensor_mul4_kernel(
                *(torch.zeros((ls, B, N), dtype=torch.int32)
                  for _ in range(4)), qs, src=SRC[:ls])
        nc.tensor_mul_kernel(torch.zeros((2, B, 4, N), dtype=torch.int32),
                             qs)
        nc.ks_fused_kernel(ops[0], keys, keys, qs, SRC[:2])
        nc.ks_fused_eval_kernel(ops[0], keys, keys, qs, SRC[:2],
                                (ops[1], ops[2]))
    assert scratch == [4 * 2 * B * N] * 4 + [2 * B * N] * 2
    shape = (nc.WIDE_THREADS, 4 << nc.CHUNK_LOGN)
    for k in kernels:
        for args in calls[k.name]:
            assert len(args) == len(k.argtypes)          # the stream last
            assert tuple(args[-3:-1]) == shape
        assert _cuda.chunked_launches(k) == k.launches == len(calls[k.name])
    assert _cuda.TENSOR_MUL4.by_layout == {"direct": 0, "staged": 0,
                                           "chunked direct": 2,
                                           "chunked staged": 1}
    assert _cuda.TENSOR_MUL.by_layout == {"block": 0, "chunked": 1}
    assert _cuda.KS_FUSED.by_layout == _cuda.KS_FUSED_EVAL.by_layout == {
        "block": 0, "chunked": 1}
    fwd, inv = (nc._chunk_twiddles(qs, N, 1 << 15, i, cpu)
                for i in (False, True))
    assert fwd.shape == inv.shape == (2, 2, 2, 1 << 15)
    tables = (fwd[0].data_ptr(), fwd[1].data_ptr(), inv[0].data_ptr(),
              inv[1].data_ptr())
    plain, direct, staged = calls["tensor_mul4"]
    for args in (plain, direct, staged, *calls["tensor_mul"]):
        assert args[13] is not None and tuple(args[16:20]) == tables
    assert plain[12] is None and direct[12] is None and staged[12] is not None
    assert (plain[21], direct[21], staged[21]) == (0, 4, 3)
    (k7,), (k8,) = calls["ks_fused"], calls["ks_fused_eval"]
    assert k7[6] is not None and tuple(k7[7:11]) == tables
    assert k8[12] is not None and tuple(k8[13:17]) == tables
    _cuda.reset_launches()


def _res(seed, primes, shape):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, p, shape) for p in primes]
                    ).astype(np.uint32)


@pytest.fixture(scope="module")
def jax_refs():
    """The five JAX functions at n = 2^16 on the operands below, under one
    ``jax.jit`` (compiled with XLA's backend optimisation off: integer
    programs, exact at any level)."""
    sc = (256, 256)
    ops = [_res(70 + i, QS, (1, N)) for i in range(4)]
    src = SRC[:3]
    sops = [_res(75 + i, src, (1, N)) for i in range(4)]
    x4 = _res(80, QS, (1, 4, N))
    c = _res(85, SRC[:2], (1, N))                    # [R=2, B, n]
    kb, ka = (np.stack([_res(86 + 2 * r + i, QS, (N,)) for r in range(2)])
              for i in range(2))
    adds = [_res(95 + i, QS, (1, N)) for i in range(2)]

    def refs(ops, sops, x4, c, kb, ka, adds):
        return (jntt.tensor_mul4(*ops, QS, scale=sc),
                jntt.tensor_mul4(*sops, QS, scale=sc, src=src),
                jntt.tensor_mul_multi(x4, QS, scale=sc),
                jntt.ks_fused_multi(c, kb, ka, QS, SRC[:2]),
                jntt.ks_fused_eval(c, kb, ka, QS, SRC[:2], tuple(adds)))

    args = [jax.tree_util.tree_map(jnp.asarray, a)
            for a in (ops, sops, x4, c, kb, ka, adds)]
    # the reference's transforms each under an inner jax.jit while it is
    # traced: calls of one shape (the three tensors' four forwards, the
    # digits' forward of both key switches, every inverse of one shape) are
    # traced once, not once a call; their values are the same
    with pytest.MonkeyPatch.context() as mp:
        for name, static in (("ntt_multi", ("qs", "mont")),
                             ("intt_multi", ("qs", "scale"))):
            mp.setattr(jntt, name, jax.jit(getattr(jntt, name),
                                           static_argnames=static))
        want = jax.jit(refs).lower(*args).compile(JAX_FAST)(*args)
    return (ops, sops, src, x4, c, kb, ka, adds, sc), want


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = tuple(want) if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))


def _tt(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def test_tensor_mul4_matches_jax(jax_refs):
    (ops, sops, src, *_, sc), want = jax_refs
    _same(ntt.tensor_mul4(*(_tt(o) for o in ops), QS, scale=sc), want[0])
    _same(ntt.tensor_mul4(*(_tt(o) for o in sops), QS, scale=sc, src=src),
          want[1])


def test_tensor_mul_multi_matches_jax(jax_refs):
    (_, _, _, x4, *_, sc), want = jax_refs
    _same(ntt.tensor_mul_multi(_tt(x4), QS, scale=sc), want[2])


def test_ks_fused_multi_matches_jax(jax_refs):
    (_, _, _, _, c, kb, ka, _, _), want = jax_refs
    _same(ntt.ks_fused_multi(_tt(c), _tt(kb), _tt(ka), QS, SRC[:2]),
          want[3])


def test_ks_fused_eval_matches_jax(jax_refs):
    (_, _, _, _, c, kb, ka, adds, _), want = jax_refs
    _same(ntt.ks_fused_eval(_tt(c), _tt(kb), _tt(ka), QS, SRC[:2],
                            tuple(_tt(a) for a in adds)), want[4])
