"""The port's CUDA kernels on the card: each against its plain version, and
the whole slice on the card against the slice on the CPU, bit for bit.

Every test here needs a CUDA card and nvcc, and skips without a card.  The
file imports neither jax nor the JAX package, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from fhe_study_tpu_torch.arith.params import TORUS_Q, RingParam
from fhe_study_tpu_torch.models import bfv_rns as R
from fhe_study_tpu_torch.models import galois
from fhe_study_tpu_torch.models import hybrid_ks as H
from fhe_study_tpu_torch.models.ckks import ckks_rns as C
from fhe_study_tpu_torch.models.gfhe.glwe import ERR_SIGMA, Param
from fhe_study_tpu_torch.models.tfhe import bootstrap, tggsw, tglwe, tlwe
from fhe_study_tpu_torch.ops import (_cuda, alu_bench, blind_rotate_cuda,
                                     ext_cuda, ntt, ntt_cuda)
from fhe_study_tpu_torch.ops.primes import ntt_primes
from fhe_study_tpu_torch.utils import kernel_check, prng

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [256, 1 << 14, 1 << 15])
def test_kernels_match_plain(cuda, n):
    param = R.RnsParam(n=n, t=256, L=4, M=5)
    gen = prng.Gen(5)
    for case in kernel_check.cases(param, 2, cuda, gen):
        got, want = case.kernel(), case.plain()
        torch.cuda.synchronize()
        assert kernel_check.equal(got, want), (case.name, case.label)


@pytest.mark.parametrize("logn", ntt_cuda.BLOCK_LOGNS)
def test_radix_kernels_match_plain_at_every_degree(cuda, logn):
    """The redesigned kernels: K1-K3, K5-K9 and K12 on the
    register-resident chains, where each log n has its own pass structure
    (K1 both ways, with and without fin, on aligned and word-offset rows; K9
    both ways under a 30-bit and a 31-bit prime, on aligned and word-offset
    int64 rows; K12 over 0, 1 and 3 transforms; K2
    on contiguous, strided and unaligned rows; K3 from 1, 2, 4 and 9 digit
    rows over 2 and 6 primes, aligned and not; K5 from every source count
    1..31 (2 and 4 direct, the others staged); K6 with and without a scale,
    on strided, stacked and unaligned rows, from 1..31 source primes (4
    direct, the others staged); the lift alone from 1..31, unsigned and
    centered, in its vector and word forms; K7 and K8
    from 1, 2, 4 and 9 limb rows (39 at n = 2^11) over 2 and 6 narrower
    primes, on the paths' strided views and one word off; K3, K7 and K8 at
    R = 43 over the 45 primes of Q u P at n = 2^12), K4 from 1..5, 15 and
    16..31 source primes and K11 from every source count 1..31, each in its
    vector and word forms; at n = 2^15 K6, K7 and K8 on two-block
    clusters."""
    gen = prng.Gen(11)
    cases = kernel_check.radix_cases(logn, 3, cuda, gen)
    one = {"ntt_multi", "tensor_eval4", "ks_contract", "ext_ntt",
           "base_extend", "ntt", "ntt_smem_ceiling", "base_extend_sum",
           "ext_lift"}
    three = {"tensor_mul4", "tensor_mul", "ks_fused", "ks_fused_eval"}
    assert {c.name for c in cases} == one | three
    for case in cases:
        got, want = case.kernel(), case.plain()
        torch.cuda.synchronize()
        assert kernel_check.equal(got, want), (case.name, case.label)


def test_radix_kernels_have_no_stack_frame_or_spills(cuda):
    """Every instance of the redesigned kernels: K2, K3, K7, K8 and K12 per
    log n 2^7 .. 2^15, K1 and K9 (both ways) per log n, K5 and K6 per log n
    and source form (K5: 2, 4, staged; K6: none, 4, staged), the lift in its
    two forms, K4 and K11 per source count 1 .. 31 and form,
    K10's clusters per log n 2^7 .. 2^12, staged and direct, and its
    device-memory layout's forward and inverse kernels per log n 2^7 ..
    2^15; past 2^15 the chunk chains of K1, K9, K10's grid layout and of
    K5 and K12 (K1's both ways, K9's both ways, K10's forward, K5's and
    K12's forward, K6's forward, K7's and K8's inverse), the top passes of
    K1 and K9 (four stage counts, both ways, K9's first and last on int64
    words), of K2 and K3 (inverse, four each), of K5 and K12 (forward,
    four), of K6 (forward, four) and of K7 and K8 (both ways, four each),
    the first top passes (four stage counts each: K5's from 2 and 4
    sources and staged, K6's without a source basis, from 4 and staged,
    K7's and K8's digits and adds), the chunk kernels of K2 and K3, K7's
    and K8's chunk chains with their gadget products (two), K10's grid
    kernels (four stage counts each; its forward's first pass and the
    others), at 2^16 K10's split forward and inverse kernels and K12's
    split loop, and at 2^17 K10's quarter forward and inverse kernels."""
    report = _cuda.ptxas_report(_cuda.build_log())
    counts = {"tensor_eval4_kernel": 9, "ks_contract_kernel": 9,
              "ks_fused_kernel": 9, "ks_fused_eval_kernel": 9,
              "ext_ntt_kernel": 9 * 3, "tensor_mul4_kernel": 9 * 3,
              "ntt_multi_kernel": 9 * 2, "base_extend_kernel": 31 * 2,
              "base_extend_sum_kernel": 31 * 2, "ext_lift_kernel": 2,
              "blind_rotate_kernel": 6 * 2, "br_forward_kernel": 9,
              "br_inverse_kernel": 9, "ntt_kernel": 9 * 2,
              "ntt_smem_ceiling_kernel": 9, "ntt_chunk_kernel": 8,
              "ntt_top_kernel": 4 * 4 + 3 * 4 + 4 + 2 * 4,
              "brg_top_forward_kernel": 4 * 2,
              "brg_chunk_inverse_kernel": 1, "brg_top_inverse_kernel": 4,
              "brg_top_last_kernel": 4, "brs_forward_kernel": 1,
              "brs_inverse_kernel": 1, "ntt_smem_ceiling_split_kernel": 1,
              "brq_forward_kernel": 1, "brq_inverse_kernel": 1,
              "tensor_eval4_chunk_kernel": 1,
              "ks_contract_chunk_kernel": 1, "first_top_kernel": 4 * 7,
              "ks_mac_chunk_kernel": 2}
    radix = [r for r in report if r["kernel"].split("<")[0] in counts]
    for name, count in counts.items():
        assert sum(r["kernel"].split("<")[0] == name for r in radix) == count
    for r in radix:
        assert (r["stack"], r["spill_stores"], r["spill_loads"]) == (0, 0, 0), r


@pytest.mark.parametrize("R", (1, 3, 29))
def test_ks_fused_cluster_instance_matches_plain(cuda, R):
    """K7 and K8 at n = 2^15, their instance on two-block clusters
    (csrc/ks_fused.cuh's ks_body at Split<15>), from R limb rows over
    30-bit primes to 6 primes of 28 bits (reps >= 2) on 5 polynomials:
    c_limbs and K8's adds strided views (as bfv_rns hands them in) with
    aligned keys, then c_limbs, the keys and the adds one word off the
    16-byte alignment (the keys' word loads), each equal to the plain
    versions; and neither instance has a stack frame or spills."""
    n, B = 1 << 15, 5
    gen = prng.Gen(24 + R)
    dst = ntt_primes(6, 28, 1 << 16)
    src = ntt_primes(R, 30, 1 << 16)
    limbs = torch.stack([prng.uniform_mod_multi(gen, (B, 3, n), (s,), cuda)[0]
                         for s in src])
    pair = prng.uniform_mod_multi(gen, (B, 2, n), dst, cuda)
    kb, ka = (torch.stack([prng.uniform_mod_multi(gen, (n,), dst, cuda)
                           for _ in range(R)]) for _ in range(2))
    off = kernel_check._offset_word
    forms = {"strided": (limbs[..., 2, :], kb, ka,
                         (pair[..., 0, :], pair[..., 1, :])),
             "one word off": (off(limbs[..., 2, :].contiguous()), off(kb),
                              off(ka), (off(pair[..., 0, :].contiguous()),
                                        off(pair[..., 1, :].contiguous())))}
    assert ntt_cuda.digit_reps(dst, src) >= 2
    for label, (c, b, a, adds) in forms.items():
        for kern, plain, extra in (
                (ntt_cuda.ks_fused_kernel, ntt_cuda.ks_fused_plain, ()),
                (ntt_cuda.ks_fused_eval_kernel, ntt_cuda.ks_fused_eval_plain,
                 (adds,))):
            got = kern(c, b, a, dst, src, *extra)
            want = plain(c, b, a, dst, src, *extra)
            torch.cuda.synchronize()
            assert kernel_check.equal(got, want), (kern.__name__, label)
    report = _cuda.ptxas_report(_cuda.build_log())
    split = [r for r in report if r["kernel"] in ("ks_fused_kernel<15>",
                                                  "ks_fused_eval_kernel<15>")]
    assert len(split) == 2
    for r in split:
        assert (r["stack"], r["spill_stores"], r["spill_loads"]) == (0, 0, 0), r


@pytest.mark.parametrize("ls", (0, 4, 14, 29, 31))
def test_tensor_mul4_cluster_instance_matches_plain(cuda, ls):
    """K6 and tensor_mul at n = 2^15, their instance on two-block clusters
    (csrc/tensor_mul4.cuh at Split<15>), on 5 polynomials with a scale:
    over 6 destination primes (ls = 0; tensor_mul on the stacked rows),
    direct from 4 source primes, staged from 14, 29 and 31; the operands
    strided views of one [Ls, B, 4, n] tensor, then each one word off the
    16-byte alignment, each equal to the plain versions; and no
    tensor_mul4_kernel<15, *> instance has a stack frame or spills."""
    n, B = 1 << 15, 5
    dst = ntt_primes(6, 28, 1 << 16)
    src = ntt_primes(ls, 30, 1 << 16) if ls else None
    scale = tuple(range(3, 3 + len(dst)))
    res = prng.device_residues(25 + ls, cuda)
    four = res(src or dst, (B, 4, n))
    off = kernel_check._offset_word
    forms = {"strided": [four[..., i, :] for i in range(4)],
             "one word off": [off(four[..., i, :].contiguous())
                              for i in range(4)]}
    for label, ops in forms.items():
        got = ntt_cuda.tensor_mul4_kernel(*ops, dst, scale=scale, src=src)
        want = ntt_cuda.tensor_mul4_plain(*ops, dst, scale=scale, src=src)
        torch.cuda.synchronize()
        assert kernel_check.equal(got, want), ("tensor_mul4", label)
    if src is None:
        for label, x4 in (("stacked", four), ("one word off", off(four))):
            got = ntt_cuda.tensor_mul_kernel(x4, dst, scale=scale)
            want = ntt_cuda.tensor_mul_plain(x4, dst, scale=scale)
            torch.cuda.synchronize()
            assert kernel_check.equal(got, want), ("tensor_mul", label)
    report = _cuda.ptxas_report(_cuda.build_log())
    split = [r for r in report
             if r["kernel"].startswith("tensor_mul4_kernel<15,")]
    assert len(split) == 3
    for r in split:
        assert (r["stack"], r["spill_stores"], r["spill_loads"]) == (0, 0, 0), r


def test_redesigned_kernels_refuse_another_plan(cuda):
    """K1 and K9 refuse a block size or shared memory other than their
    build's and 16-byte loads from an unaligned row, K12 another block size
    or shared memory; K4 its vector form on a row length that is no multiple
    of 4 or an unaligned row; K7 another block size or shared memory, K8 an
    output off the 16-byte alignment.  Each refusal raises."""
    qs = R.RnsParam(n=256, t=256, L=4, M=5).qs
    x = torch.zeros((4, 2, 256), dtype=torch.int32, device=cuda)
    tw = ntt_cuda._twiddles(qs, 256, True, cuda)
    cons = ntt_cuda._prime_rows(qs, None, cuda)
    plan = ntt_cuda._radix_plan(8)
    for threads, smem, vec, src in ((plan.threads * 2, plan.smem_bytes, 1, x),
                                    (plan.threads, plan.smem_bytes * 2, 1, x),
                                    (plan.threads, plan.smem_bytes, 1,
                                     x.view(-1)[1:])):
        with pytest.raises(RuntimeError, match="fhe_ntt_multi"):
            _cuda.NTT_MULTI.launch(cuda, src.data_ptr(), x.data_ptr(),
                                   None, tw[0].data_ptr(), tw[1].data_ptr(),
                                   cons.data_ptr(), 4, 1, 8, 1, 1, vec,
                                   threads, smem)
    x64 = torch.zeros((2, 256), dtype=torch.int64, device=cuda)
    for threads, smem, vec, src in ((plan.threads * 2, plan.smem_bytes, 1,
                                     x64),
                                    (plan.threads, plan.smem_bytes * 2, 1,
                                     x64),
                                    (plan.threads, plan.smem_bytes, 1,
                                     x64.view(-1)[1:])):
        with pytest.raises(RuntimeError, match="fhe_ntt"):
            _cuda.NTT.launch(cuda, src.data_ptr(), x64.data_ptr(), None,
                             tw[0].data_ptr(), tw[1].data_ptr(),
                             cons.data_ptr(), 1, 8, 1, vec, threads, smem)
    fwd0 = ntt_cuda._twiddles(qs[:1], 256, False, cuda)
    cons0 = ntt_cuda._prime_rows(qs[:1], None, cuda)
    for threads, smem in ((plan.threads * 2, plan.smem_bytes),
                          (plan.threads, plan.smem_bytes // 2)):
        with pytest.raises(RuntimeError, match="fhe_ntt_smem_ceiling"):
            _cuda.NTT_SMEM_CEILING.launch(cuda, x.data_ptr(), x.data_ptr(),
                                          None, fwd0[0].data_ptr(),
                                          fwd0[1].data_ptr(),
                                          cons0.data_ptr(), qs[0], 2, 8, 1,
                                          threads, smem, 0, layout="block")
    tab = ext_cuda.kernel_table(qs, qs[:2], None, cuda)
    out = torch.zeros((2, 2, 256), dtype=torch.int32, device=cuda)
    for src, total in ((x, 511), (x.view(-1)[1:], 508)):
        with pytest.raises(RuntimeError, match="fhe_base_extend"):
            _cuda.BASE_EXTEND.launch(cuda, src.data_ptr(), None,
                                     out.data_ptr(), tab.data_ptr(), 4, 2,
                                     total, 0, 1)
    # K7 and K8 on limbs x [4, 2, 256] and keys [4, 4, 256]
    keys = torch.zeros((4, 4, 256), dtype=torch.int32, device=cuda)
    out4 = torch.zeros(4 * 4 * 2 * 256 + 1, dtype=torch.int32, device=cuda)
    fwd = ntt_cuda._twiddles(qs, 256, False, cuda)
    tables = (fwd[0].data_ptr(), fwd[1].data_ptr(), tw[0].data_ptr(),
              tw[1].data_ptr(), cons.data_ptr())
    ks = ntt_cuda._radix_plan(8, ntt_cuda.MUL4_THREADS, ntt_cuda.MUL4_BUFFERS)
    for threads, smem in ((ks.threads * 2, ks.smem_bytes),
                          (ks.threads, ks.smem_bytes // 3)):
        with pytest.raises(RuntimeError, match="fhe_ks_fused"):
            _cuda.KS_FUSED.launch(cuda, x.data_ptr(), 512, 256,
                                  keys.data_ptr(), keys.data_ptr(),
                                  out4.data_ptr(), None, *tables, 4, 4, 2, 8,
                                  1, threads, smem, layout="block")
    with pytest.raises(RuntimeError, match="fhe_ks_fused_eval"):
        _cuda.KS_FUSED_EVAL.launch(cuda, x.data_ptr(), 512, 256,
                                   keys.data_ptr(), keys.data_ptr(),
                                   x.data_ptr(), 512, 256, x.data_ptr(), 512,
                                   256, out4[1:].data_ptr(), None, *tables,
                                   cons.data_ptr(), 4, 4, 2, 8, 1, ks.threads,
                                   ks.smem_bytes, layout="block")


def test_blind_rotate_clusters_match_plain(cuda):
    """K10 on its two-block clusters at n = 2^7, 2^8 and 2^9 (the shapes of
    kernel_check.blind_rotate_sweep there: C = 2, 3; l = 1, 2, 3; 1, 2 and
    17 steps; 1 to 133 ciphertexts; staged, direct and unaligned key
    planes), bit for bit."""
    gen = prng.Gen(12)
    done = 0
    for case in kernel_check.blind_rotate_sweep(cuda, gen):
        if case.layout != "cluster" or case.args[-2] > 512:
            continue
        got, want = case.kernel(), case.plain()
        torch.cuda.synchronize()
        assert kernel_check.equal(got, want), case.label
        done += 1
    assert done > 100


@pytest.mark.parametrize("n,C,l,w", [(1 << 12, 2, 2, 11), (1 << 15, 2, 3, 8),
                                     (1 << 11, 2, 7, 9), (1 << 9, 4, 32, 2),
                                     (256, 2, 2, 12)])
def test_blind_rotate_device_layout_matches_plain(cuda, n, C, l, w):
    """K10 with its working set in device memory: configuration a's shape,
    configuration b's, two shapes over a block's shared memory at small n,
    and the layout forced at n = 256, where the plan takes the clusters;
    over 17 steps on 3 ciphertexts, and with key planes one word off, bit
    for bit; one launch a chain, counted under K10's name and its
    layout's."""
    gen = prng.Gen(n + C + l)
    args = kernel_check.blind_rotate_inputs(n, C - 1, 1 << w, l, 17, 3, cuda,
                                            gen)
    layout = "device"
    assert (blind_rotate_cuda._plan(C, l, n).layout == layout) == (n > 256)
    _cuda.reset_launches()
    got = blind_rotate_cuda.blind_rotate_kernel(*args, layout=layout)
    torch.cuda.synchronize()
    assert _cuda.launches()["blind_rotate"] == 1
    assert _cuda.BLIND_ROTATE.by_layout == {"cluster": 0, "device": 1,
                                            "split": 0, "grid": 0,
                                            "quarter": 0}
    assert torch.equal(got, blind_rotate_cuda.blind_rotate_plain(*args))
    off = [kernel_check._offset_word(e) for e in args[2:6]]
    shifts, acc0 = args[0][:2].contiguous(), args[1]
    got = blind_rotate_cuda.blind_rotate_kernel(
        shifts, acc0, *(e[:2] for e in off), n, w, layout=layout)
    assert torch.equal(got, blind_rotate_cuda.blind_rotate_plain(
        shifts, acc0, *(e[:2] for e in off), n, w))


def test_blind_rotate_refuses_another_plan(cuda):
    """K10 refuses a block size, shared memory or staging other than its
    plan's, and staging from planes that are not 16-byte aligned; in its
    device-memory layout a block size or shared memory other than the
    one-buffer shape's, staging, and no scratch; and a cluster past
    2^12."""
    n, C, l = 256, 2, 2
    shifts = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
    acc0 = torch.zeros((1, C, n), dtype=torch.int64, device=cuda)
    ev = torch.zeros((2, C, l, C, 2, n), dtype=torch.int32, device=cuda)
    tw = ntt_cuda._twiddles((998244353, 754974721), n, False, cuda)
    cons = ntt_cuda._prime_rows((998244353, 754974721, 754974721), None, cuda)
    plan = blind_rotate_cuda._plan(C, l, n)
    assert plan.staged
    direct = blind_rotate_cuda._plan(C, l, n, False)
    off = ev.view(-1)[1:].view(-1)
    for key, threads, smem, staged in (
            (ev, plan.threads // 2, plan.smem_bytes, 1),
            (ev, plan.threads, plan.smem_bytes + 16, 1),
            (ev, plan.threads, direct.smem_bytes, 1),
            (ev, plan.threads, plan.smem_bytes, 0),
            (off, plan.threads, plan.smem_bytes, 1)):
        with pytest.raises(RuntimeError, match="fhe_blind_rotate"):
            _cuda.BLIND_ROTATE.launch(
                cuda, shifts.data_ptr(), acc0.data_ptr(), key.data_ptr(),
                key.data_ptr(), key.data_ptr(), key.data_ptr(),
                acc0.data_ptr(), tw[0].data_ptr(), tw[1].data_ptr(),
                tw[0].data_ptr(), tw[1].data_ptr(), cons.data_ptr(), None, 2,
                1, C, l, 12, 8, threads, smem, staged, 0, layout="cluster")
    dm = blind_rotate_cuda._plan(C, l, n, layout="device")
    scratch = torch.empty(dm.scratch_bytes // 4, dtype=torch.int32,
                          device=cuda)
    for buf, logn, threads, smem, staged in (
            (scratch, 8, dm.threads * 2, dm.smem_bytes, 0),
            (scratch, 8, dm.threads, dm.smem_bytes * 2, 0),
            (scratch, 8, dm.threads, dm.smem_bytes, 1),
            (None, 8, dm.threads, dm.smem_bytes, 0),
            (scratch, 16, dm.threads, dm.smem_bytes, 0)):
        with pytest.raises(RuntimeError, match="fhe_blind_rotate"):
            _cuda.BLIND_ROTATE.launch(
                cuda, shifts.data_ptr(), acc0.data_ptr(), ev.data_ptr(),
                ev.data_ptr(), ev.data_ptr(), ev.data_ptr(),
                acc0.data_ptr(), tw[0].data_ptr(), tw[1].data_ptr(),
                tw[0].data_ptr(), tw[1].data_ptr(), cons.data_ptr(),
                buf.data_ptr() if buf is not None else None, 2, 1, C, l, 12,
                logn, threads, smem, staged, 1, layout="device")
    with pytest.raises(RuntimeError, match="fhe_blind_rotate"):
        _cuda.BLIND_ROTATE.launch(
            cuda, shifts.data_ptr(), acc0.data_ptr(), ev.data_ptr(),
            ev.data_ptr(), ev.data_ptr(), ev.data_ptr(), acc0.data_ptr(),
            tw[0].data_ptr(), tw[1].data_ptr(), tw[0].data_ptr(),
            tw[1].data_ptr(), cons.data_ptr(), None, 2, 1, C, l, 12, 13,
            plan.threads, plan.smem_bytes, 0, 0, layout="cluster")


def test_linear_kernels_match_plain(cuda):
    param = R.RnsParam(n=256, t=256, L=2, M=3)
    gen = prng.Gen(6)
    for case in kernel_check.linear_cases(param, 4, cuda, gen):
        got, want = case.kernel(), case.plain()
        torch.cuda.synchronize()
        assert kernel_check.equal(got, want), (case.name, case.label)


def _slice(param, device, seed=3, batch=2):
    gen = prng.Gen(seed)      # same draws on any device
    sk, pk = R.new_key(gen, param, device)
    hk = R.hybrid_rlk1(gen, param, sk)
    m = [prng.uniform_mod(gen, (batch, param.n), param.t, "cpu")
         for _ in range(2)]
    c = [R.encrypt(gen, param, pk, mi.to(device), batch=(batch,))
         for mi in m]
    ce = R.mul_e(param, hk, *(R.to_evals(param, ci) for ci in c))
    return m, ce, R.decrypt(param, sk, R.from_evals(param, ce))


def test_slice_on_card_matches_cpu(cuda):
    param = R.RnsParam(n=1024, t=256, L=4, M=5)
    _cuda.reset_launches()
    m, ce, rec = _slice(param, cuda)
    torch.cuda.synchronize()
    counts = _cuda.launches()
    for name in ("ntt_multi", "tensor_eval4", "ks_contract", "base_extend",
                 "ext_ntt"):
        assert counts[name] > 0, counts
    _, ce_cpu, rec_cpu = _slice(param, torch.device("cpu"))
    for got, want in zip(ce, ce_cpu):
        assert torch.equal(got.cpu(), want)
    assert torch.equal(rec.cpu(), rec_cpu)
    a, b = (x.numpy() for x in m)
    n = param.n
    lin = np.stack([np.convolve(x, y) for x, y in zip(a, b)])
    want = (lin[:, :n] - np.pad(lin[:, n:], ((0, 0), (0, 1)))) % param.t
    np.testing.assert_array_equal(rec_cpu.numpy(), want)


def test_slice_at_n_2_15_on_card_matches_cpu(cuda):
    """mul_e HRLK at N = 2^15 (L = 2, M = 3, K = 3, B = 2): the one-buffer
    kernels at 2^15 on the card equal the plain versions on the CPU, and the
    product decrypts."""
    param = R.RnsParam(n=1 << 15, t=256, L=2, M=3)

    def run(device):
        gen = prng.Gen(15)
        sk, pk = R.new_key(gen, param, device)
        hk = R.hybrid_rlk1(gen, param, sk, K=3)
        m = [prng.uniform_mod(gen, (2, param.n), param.t, device)
             for _ in range(2)]
        x, y = (R.to_evals(param, R.encrypt(gen, param, pk, mi, batch=(2,)))
                for mi in m)
        ce = R.mul_e(param, hk, x, y)
        return m, ce, R.decrypt(param, sk, R.from_evals(param, ce))

    _cuda.reset_launches()
    m, ce, rec = run(cuda)
    torch.cuda.synchronize()
    counts = _cuda.launches()
    for name in ("ntt_multi", "tensor_eval4", "ks_contract", "base_extend",
                 "ext_ntt"):
        assert counts[name] > 0, counts
    _, ce_cpu, rec_cpu = run(torch.device("cpu"))
    for got, want in zip(ce, ce_cpu):
        assert torch.equal(got.cpu(), want)
    assert torch.equal(rec.cpu(), rec_cpu)
    a, b = (x.cpu().numpy() for x in m)
    n = param.n
    lin = np.stack([np.convolve(x, y) for x, y in zip(a, b)])
    want = (lin[:, :n] - np.pad(lin[:, n:], ((0, 0), (0, 1)))) % param.t
    np.testing.assert_array_equal(rec_cpu.numpy(), want)


def test_three_buffer_kernels_at_n_2_15_on_card_match_cpu(cuda):
    """mul with either relin key, the gadget mul_e and key_switch at
    N = 2^15 (L = 2, M = 3, K = 3, B = 2): K6, K7 and K8 on their two-block
    clusters on the card equal the plain versions on the CPU, and decrypt."""
    param = R.RnsParam(n=1 << 15, t=256, L=2, M=3)

    def run(device):
        gen = prng.Gen(16)
        sk, pk = R.new_key(gen, param, device)
        sk2, _ = R.new_key(gen, param, device)
        keys = (R.rlk_key(gen, param, sk), R.hybrid_rlk1(gen, param, sk, K=3))
        ksk = R.ksk_key(gen, param, sk, sk2)
        m = [prng.uniform_mod(gen, (2, param.n), param.t, device)
             for _ in range(2)]
        x, y = (R.encrypt(gen, param, pk, mi, batch=(2,)) for mi in m)
        outs = [R.mul(param, k, x, y) for k in keys]
        outs.append(R.from_evals(param, R.mul_e(
            param, keys[0], R.to_evals(param, x), R.to_evals(param, y))))
        ks = R.key_switch(param, ksk, x)
        recs = [R.decrypt(param, sk, c) for c in outs]
        recs.append(R.decrypt(param, sk2, ks))
        return m, outs + [ks], recs

    _cuda.reset_launches()
    m, outs, recs = run(cuda)
    torch.cuda.synchronize()
    counts = _cuda.launches()
    for name in ("tensor_mul4", "ks_fused", "ks_fused_eval", "base_extend"):
        assert counts[name] > 0, counts
    _, outs_cpu, recs_cpu = run(torch.device("cpu"))
    for got, want in zip(outs, outs_cpu):
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    a, b = (x.cpu().numpy() for x in m)
    n = param.n
    lin = np.stack([np.convolve(x, y) for x, y in zip(a, b)])
    want = (lin[:, :n] - np.pad(lin[:, n:], ((0, 0), (0, 1)))) % param.t
    for rec, rec_cpu in zip(recs[:3], recs_cpu[:3]):
        assert torch.equal(rec.cpu(), rec_cpu)
        np.testing.assert_array_equal(rec_cpu.numpy(), want)
    assert torch.equal(recs[3].cpu(), m[0].cpu())


def test_wide_basis_paths_on_card_match_cpu(cuda):
    """RNS-BFV at L = 15, M = 16, n = 256 (the tensor's P -> Q conversion
    from 16 primes, the hybrid key's K = 16 from 16): mul and mul_e with
    either key on the card equal the CPU's and decrypt; a basis of 32
    primes raises on the card too."""
    param = R.RnsParam(n=256, t=256, L=15, M=16)

    def run(device):
        gen = prng.Gen(17)
        sk, pk = R.new_key(gen, param, device)
        keys = (R.rlk_key(gen, param, sk),
                R.hybrid_rlk1(gen, param, sk, K=16))
        m = [prng.uniform_mod(gen, (2, param.n), param.t, device)
             for _ in range(2)]
        x, y = (R.encrypt(gen, param, pk, mi, batch=(2,)) for mi in m)
        ex, ey = R.to_evals(param, x), R.to_evals(param, y)
        outs = [R.mul(param, k, x, y) for k in keys]
        outs += [R.from_evals(param, R.mul_e(param, k, ex, ey)) for k in keys]
        return m, outs, [R.decrypt(param, sk, c) for c in outs]

    m, outs, recs = run(cuda)
    _, outs_cpu, recs_cpu = run(torch.device("cpu"))
    for got, want in zip(outs, outs_cpu):
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    a, b = (x.cpu().numpy() for x in m)
    lin = np.stack([np.convolve(x, y) for x, y in zip(a, b)])
    want = (lin[:, :256] - np.pad(lin[:, 256:], ((0, 0), (0, 1)))) % 256
    for rec in recs_cpu:
        np.testing.assert_array_equal(rec.numpy(), want)
    src = param.qs + param.ps + H.ks_ext_primes(param, 1)
    x32 = torch.zeros((32, 2, 256), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="1 \\.\\. 31"):
        ext_cuda.base_extend_fused(x32, src, param.qs)


def _paths(param, device, seed=4, batch=2):
    """mul with both relin keys, the gadget mul_e, a key switch and one step
    of the linear pipeline, on draws that are the same on any device."""
    gen = prng.Gen(seed)
    sk, pk = R.new_key(gen, param, device)
    sk2, _ = R.new_key(gen, param, device)
    rlk, hk = R.rlk_key(gen, param, sk), R.hybrid_rlk1(gen, param, sk)
    ksk = R.ksk_key(gen, param, sk, sk2)
    m = [prng.uniform_mod(gen, (batch, param.n), param.t, "cpu")
         for _ in range(2)]
    c = [R.encrypt(gen, param, pk, mi.to(device), batch=(batch,))
         for mi in m]
    e = [R.to_evals(param, ci) for ci in c]
    em = R.pt_to_evals(param, m[1].to(device))
    outs = [*R.mul(param, rlk, *c), *R.mul(param, hk, *c),
            *R.mul_e(param, rlk, *e), *R.key_switch(param, ksk, c[0]),
            *R.mul_pt_e(param, R.add_e(param, *e), em)]
    return outs, R.decrypt(param, sk, R.mul(param, rlk, *c))


def test_small_degree_kernels_match_plain(cuda):
    """Every radix-chain kernel and K10 at n = 2^7 at the shapes of the
    reference tests' small configurations (RNS-BFV at n = 128, t = 16,
    L = 3, M = 4; TFHE at n = 128, beta = 256, l = 3), bit for bit."""
    param = R.RnsParam(**kernel_check.SMALL_BFV)
    cases = kernel_check.small_degree_cases(param, 3, 3, cuda, prng.Gen(17))
    assert {c.name for c in cases} >= {
        "ntt_multi", "tensor_eval4", "ks_contract", "ext_ntt", "tensor_mul4",
        "tensor_mul", "ks_fused", "ks_fused_eval", "ntt", "blind_rotate",
        "ntt_smem_ceiling"}
    for case in cases:
        got, want = case.kernel(), case.plain()
        torch.cuda.synchronize()
        assert kernel_check.equal(got, want), (case.name, case.label)


def test_slice_at_n_128_on_card_matches_cpu(cuda):
    """mul_e with the hybrid key at the reference's n = 128, t = 16, L = 3,
    M = 4 goes through the kernels at 2^7 and equals the CPU's."""
    param = R.RnsParam(**kernel_check.SMALL_BFV)
    _cuda.reset_launches()
    _, ce, rec = _slice(param, cuda)
    torch.cuda.synchronize()
    counts = _cuda.launches()
    for name in ("ntt_multi", "tensor_eval4", "ks_contract", "ext_ntt"):
        assert counts[name] > 0, counts
    _, ce_cpu, rec_cpu = _slice(param, torch.device("cpu"))
    for got, want in zip(ce, ce_cpu):
        assert torch.equal(got.cpu(), want)
    assert torch.equal(rec.cpu(), rec_cpu)


def test_paths_at_n_64_on_card_launch_no_multi_prime_kernel(cuda):
    """At n = 64 no multi-prime op passes the reference's gate: on the card
    the paths run the plain versions (K4, which has no ring degree, still
    launches) and equal the CPU's."""
    param = R.RnsParam(n=64, t=65537, L=3, M=4)
    _cuda.reset_launches()
    outs, rec = _paths(param, cuda)
    torch.cuda.synchronize()
    counts = _cuda.launches()
    for name in ("ntt_multi", "tensor_eval4", "ks_contract", "ext_ntt",
                 "tensor_mul4", "tensor_mul", "ks_fused", "ks_fused_eval"):
        assert counts[name] == 0, counts
    assert counts["base_extend"] > 0, counts
    outs_cpu, rec_cpu = _paths(param, torch.device("cpu"))
    for got, want in zip(outs, outs_cpu):
        assert torch.equal(got.cpu(), want)
    assert torch.equal(rec.cpu(), rec_cpu)


def test_paths_on_card_match_cpu(cuda):
    param = R.RnsParam(n=1024, t=256, L=4, M=5)
    _cuda.reset_launches()
    outs, rec = _paths(param, cuda)
    torch.cuda.synchronize()
    counts = _cuda.launches()
    for name in ("tensor_mul4", "ks_fused", "ks_fused_eval"):
        assert counts[name] > 0, counts
    outs_cpu, rec_cpu = _paths(param, torch.device("cpu"))
    assert len(outs) == len(outs_cpu)
    for got, want in zip(outs, outs_cpu):
        assert torch.equal(got.cpu(), want)
    assert torch.equal(rec.cpu(), rec_cpu)


def test_wrappers_check_dtype_and_layout(cuda):
    qs = R.RnsParam(n=256, t=256, L=4, M=5).qs
    x = torch.zeros((4, 2, 256), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        ntt_cuda.ntt_multi_kernel(x.long(), qs)
    with pytest.raises(ValueError, match="contiguous"):
        ntt_cuda.ntt_multi_kernel(x.transpose(0, 1), qs)
    with pytest.raises(ValueError, match="rows"):
        ntt_cuda.ntt_multi_kernel(x[:3], qs)
    keys = torch.zeros((4, 4, 256), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="expected"):
        ntt_cuda.ks_fused_kernel(x, keys[:3], keys, qs, qs)
    with pytest.raises(ValueError, match="rows"):
        ntt_cuda.tensor_mul4_kernel(x, x, x, x, qs, src=qs[:3])
    with pytest.raises(ValueError, match="last axis"):
        ntt_cuda.ks_fused_eval_kernel(x, keys, keys, qs, qs,
                                      (x, x.transpose(1, 2)))


@pytest.mark.parametrize("n,k,beta,l,steps", [(256, 1, 256, 3, 40),
                                              (1024, 1, 4096, 2, 48),
                                              (1024, 1, 256, 3, 16),
                                              (256, 2, 256, 2, 24)])
def test_tfhe_kernels_match_plain(cuda, n, k, beta, l, steps):
    gen = prng.Gen(7)
    for case in kernel_check.tfhe_cases(n, k, beta, l, steps, 3, cuda, gen):
        got, want = case.kernel(), case.plain()
        torch.cuda.synchronize()
        assert kernel_check.equal(got, want), (case.name, case.label)


def _bootstraps(param, device, seed=8, batch=4, n_lwe=160):
    """bootstrap and two composed bootstrap_short on draws that are the same
    on any device; returns the ciphertexts and the decoded messages."""
    gen = prng.Gen(seed)
    kw = dict(beta=4096, l=2, beta_ks=16, l_ks=8)
    table = bootstrap.compute_lookup_table_standard(param, device)
    s, _ = tglwe.new_key(gen, param, device)
    s_flat = tglwe.sk_to_tlwe(s)
    btk, _ = bootstrap.new_bootstrapping_key(gen, param, s, s_lwe_out=s_flat,
                                             **kw)
    sbtk = bootstrap.new_short_bootstrapping_key(gen, param, s, n_lwe=n_lwe,
                                                 **kw)
    m = torch.arange(batch, device=device) % (param.t // 2)
    c = tlwe.encrypt_uniform(gen, param.lwe(), s_flat, tlwe.encode(param, m),
                             batch=(batch,))
    outs = [bootstrap.bootstrap(param, btk, table, c, **kw)]
    outs.append(bootstrap.bootstrap_short(param, sbtk, table, c, **kw))
    outs.append(bootstrap.bootstrap_short(param, sbtk, table, outs[-1], **kw))
    recs = [tlwe.decode(param, tlwe.decrypt(param.lwe(), s_flat, o))
            for o in outs]
    return m, outs, recs


def test_bootstrap_on_card_matches_cpu(cuda):
    param = Param(ERR_SIGMA, RingParam(TORUS_Q, 256), 1, 8)
    _cuda.reset_launches()
    m, outs, recs = _bootstraps(param, cuda)
    torch.cuda.synchronize()
    counts = _cuda.launches()
    assert counts["ntt"] > 0 and counts["blind_rotate"] == 3, counts
    _, outs_cpu, recs_cpu = _bootstraps(param, torch.device("cpu"))
    for got, want in zip(outs, outs_cpu):
        assert torch.equal(got.a.cpu(), want.a)
        assert torch.equal(got.b.cpu(), want.b)
    for rec, rec_cpu in zip(recs, recs_cpu):
        assert torch.equal(rec.cpu(), rec_cpu) and torch.equal(rec, m)


def test_tfhe_wrappers_check_dtype_and_layout(cuda):
    x = torch.zeros((4, 2, 256), dtype=torch.int64, device=cuda)
    q = 998244353
    with pytest.raises(TypeError, match="int64"):
        ntt_cuda.ntt_kernel(x.int(), q)
    with pytest.raises(ValueError, match="contiguous"):
        ntt_cuda.ntt_kernel(x.transpose(0, 1), q)
    with pytest.raises(ValueError, match="2\\^31"):
        ntt_cuda.ntt_kernel(x, (1 << 31) + 11)
    with pytest.raises(ValueError, match="2\\^7 .. 2\\^26"):
        ntt_cuda.ntt_kernel(x[..., :64].contiguous(), q)
    # the dispatching transform raises too inside the reference's kernel
    # gate (q < 2^31, n a multiple of 128): no plain version there
    with pytest.raises(ValueError, match="2\\^7 .. 2\\^26"):
        ntt.ntt(torch.zeros((1, 384), dtype=torch.int64, device=cuda), q)
    # outside it (q >= 2^31 or n < 128) both devices run the plain
    # transform, as the reference runs XLA there
    wide = 1099511922689                 # a 41-bit prime, 1 mod 2^15
    y = prng.uniform_mod(prng.Gen(17), (2, 256), wide, "cpu")
    _cuda.reset_launches()
    assert torch.equal(ntt.intt(ntt.ntt(y.to(cuda), wide), wide).cpu(), y)
    yq = y[:, :64] % q
    assert torch.equal(ntt.ntt(yq.to(cuda), q).cpu(), ntt.ntt(yq, q))
    assert _cuda.launches()["ntt"] == 0
    shifts = torch.zeros((3, 1), dtype=torch.int32, device=cuda)
    acc0 = torch.zeros((1, 2, 256), dtype=torch.int64, device=cuda)
    ev = torch.zeros((3, 2, 2, 2, 2, 256), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        blind_rotate_cuda.blind_rotate_kernel(shifts.long(), acc0, ev, ev, ev,
                                              ev, 256, 12)
    with pytest.raises(ValueError, match="ev2 has shape"):
        blind_rotate_cuda.blind_rotate_kernel(shifts, acc0, ev, ev, ev[:2],
                                              ev, 256, 12)
    out = blind_rotate_cuda.blind_rotate_kernel(shifts, acc0, ev, ev, ev, ev,
                                                256, 12)
    assert torch.equal(out, acc0)         # a zero key leaves the accumulator


@pytest.mark.parametrize("n", [256, 1 << 13])
def test_ckks_and_bench_kernels_match_plain(cuda, n):
    """The variants RNS-CKKS launches, base_extend_sum (also against the
    whole conversion) and the two measuring loops, bit for bit."""
    param = C.Param(n=n, L=4, delta=2.0 ** 28)
    gen = prng.Gen(9)
    for case in (kernel_check.ckks_cases(param, 2, 2, cuda, gen)
                 + kernel_check.ext_sum_cases(n, 2, cuda, gen)
                 + kernel_check.bench_cases(n, 3, cuda, gen)):
        got, want = case.kernel(), case.plain()
        torch.cuda.synchronize()
        assert kernel_check.equal(got, want), (case.name, case.label)


def _ckks(param, device, seed=10, batch=2):
    """Path A on draws that are the same on any device: multiply, a hybrid
    and a hoisted rotation, the gadget keyring's conjugation."""
    gen = prng.Gen(seed)
    z = torch.from_numpy(gen.rng.random((2, batch, param.n // 2))) * 2 - 1
    sk, pk = C.new_key(gen, param, device)
    hrlk = C.hybrid_rlk(gen, param, sk)
    zero = torch.zeros_like(z[0]).to(device)
    c = [C.encrypt(gen, param, pk, C.encode(param, zi.to(device), zero),
                   batch=(batch,)) for zi in z]
    out, p2 = C.mul_hybrid(param, hrlk, c[0], C.add(param, *c))
    g = galois.rotation_element(param.n, 3)
    hgk = H.galois_key_hybrid(gen, param, sk, g)
    rot = H.rotate_hybrid(param, hgk, c[0], g)
    hoisted = H.rotate_hoisted(param, hgk, c[0], g,
                               H.hoist_digits(param, c[0].c1))
    ring = galois.GaloisKeys.for_rotations(gen, param, sk, steps=[1],
                                           conj=True)
    conj = ring.conjugate(param, c[0])
    rr, _ = C.decode(p2, C.decrypt_to_coeffs(p2, sk, out))
    return z, [*out, *rot, *hoisted, *conj], rr


def test_ckks_on_card_matches_cpu(cuda):
    param = C.Param(n=1024, L=4, delta=2.0 ** 28)
    _cuda.reset_launches()
    z, outs, rr = _ckks(param, cuda)
    torch.cuda.synchronize()
    counts = _cuda.launches()
    for name in ("ntt_multi", "tensor_mul4", "ks_fused", "ks_contract",
                 "base_extend"):
        assert counts[name] > 0, counts
    _, outs_cpu, rr_cpu = _ckks(param, torch.device("cpu"))
    for got, want in zip(outs, outs_cpu):
        assert torch.equal(got.cpu(), want)
    # the decode is float64 on both: the card's FFT rounds the same sums
    np.testing.assert_allclose(rr.cpu().numpy(), rr_cpu.numpy(), atol=1e-9)
    np.testing.assert_allclose(rr_cpu.numpy(),
                               ((z[0] + z[1]) * z[0]).numpy(), atol=1e-2)


def _maps(device, n=256, L=6):
    """Two radix-split stage maps of n through build_rmap_plan +
    apply_rmap_plan at the double-prime scale, keys and plans made on the
    CPU and carried to ``device``: the first stage's plan holds both chains'
    maps (babies on z, giants), the last C2S stage's has an antilinear
    part (babies on z_c too)."""
    from fhe_study_tpu_torch.models.ckks import eval as E
    cpu = torch.device("cpu")
    param = C.Param(n=n, L=L, delta=2.0 ** 60)
    gen = prng.Gen(7)
    sk, pk = C.new_key(gen, param, cpu, h=16)
    rng = np.random.default_rng(8)
    z = torch.from_numpy(rng.uniform(-1, 1, (2, n // 2)))
    ct = C.encrypt(gen, param, pk, C.encode(param, z, -z), batch=(2,))
    outs = []
    for s, maps in ((0, E.c2s_stage_maps(n, 2)[0]),
                    (1, E.c2s_stage_maps(n, 2)[1][:1])):
        pL = C.Param(n=n, L=L - 2 * s, delta=param.delta)
        plan = E.build_rmap_plan(pL, list(maps), cpu, pt_levels=2)
        steps = sorted({j for j in plan.need_d | plan.need_e if j}
                       | {gi for m in plan.maps for gi, _ in m if gi})
        rk = E.RotKeys.build(gen, pL, sk, steps, conj=bool(plan.need_e),
                             levels=[pL.L])
        plan.em = plan.em.to(device)
        rk = E.RotKeys({k: H.HybridKSK(*(t.to(device) for t in v))
                        for k, v in rk.keys.items()})
        got, _ = E.apply_rmap_plan(pL, rk, C.CT(*(c.to(device) for c in ct)),
                                   plan)
        outs += got
        ct = C.CT(*(c.cpu() for c in got[0]))
    return outs


def test_ckks_maps_on_card_match_cpu(cuda):
    """apply_rmap_plan on the card (K1, K3 over R = L rows, K7, K4 and the
    plain-torch contraction) == the same call on the CPU, n = 256."""
    _cuda.reset_launches()
    outs = _maps(cuda)
    torch.cuda.synchronize()
    counts = _cuda.launches()
    for name in ("ntt_multi", "ks_contract", "ks_fused", "base_extend"):
        assert counts[name] > 0, counts
    for got, want in zip(outs, _maps(torch.device("cpu"))):
        assert torch.equal(got.c0.cpu(), want.c0)
        assert torch.equal(got.c1.cpu(), want.c1)


def test_bench_wrappers_check_and_measure(cuda):
    x = torch.zeros((4, 1024), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        alu_bench.alu_rate_kernel(x.long(), x, x, "add", 16)
    with pytest.raises(ValueError, match="multiples of 16"):
        alu_bench.alu_rate_kernel(x, x, x, "add", 8)
    with pytest.raises(ValueError, match="2\\^7 .. 2\\^26"):
        alu_bench.ntt_smem_ceiling_kernel(x[:, :64].contiguous(), 12289, 1)
    with pytest.raises(ValueError, match="alpha"):
        ext_cuda.base_extend_sum_kernel(x, x, (12289, 40961), (65537,))
    per_sm, sms = alu_bench.resident_blocks(cuda, n=1 << 14)
    assert per_sm >= 1 and sms >= 1
    r = alu_bench.ntt_smem_ceiling(cuda, n=1024, B=sms, reps=4)
    assert r["butterflies_per_sec"] > 0 and "cpu" not in r["device"]
    r = alu_bench.alu_rate("butterfly", cuda, rounds=64)
    assert r["elems_per_s"] > 0 and r["rounds"] == 64


@pytest.mark.parametrize("q", [2 ** 16 + 1, 2013265921, 1811939329])
@pytest.mark.parametrize("shape", [(3, 128), (32, 256, 128), (4, 1024)])
def test_k9_matches_plain_at_the_slice_shapes(cuda, q, shape):
    """K9 at n = 2^7 (its own instance) and at the graft entry shape,
    both ways, on aligned and word-offset rows."""
    x = prng.uniform_mod(prng.Gen(14), shape, q, cuda)
    off = prng.uniform_mod(prng.Gen(15), (x.numel() + 1,), q, cuda)[1:]
    for rows in (x, off.view(shape)):
        for inverse in (False, True):
            got = ntt_cuda.ntt_kernel(rows, q, inverse=inverse)
            torch.cuda.synchronize()
            assert torch.equal(got, ntt_cuda.ntt_plain(rows, q,
                                                       inverse=inverse))


def test_entry_on_card_matches_cpu(cuda):
    """The graft entry at its full width: the same seed gives the same
    keys and ciphertexts on the card and the CPU, and the multiply on the
    card (48 launches of K9) equals the one on the CPU bit for bit."""
    from fhe_study_tpu_torch import entry
    fn, args = entry.entry(cuda)
    fn_cpu, args_cpu = entry.entry("cpu")
    assert all(torch.equal(a.cpu(), b) for a, b in zip(args, args_cpu))
    _cuda.reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    assert _cuda.launches()["ntt"] == 48
    assert all(torch.equal(a.cpu(), b)
               for a, b in zip(out, fn_cpu(*args_cpu)))


def test_glwe_key_switch_on_card_matches_cpu(cuda):
    """GLWE over Z_q at the reference test's n = 128, k = 16: the key
    switch (K9 at n = 128) on the card equals the CPU's and decrypts."""
    from fhe_study_tpu_torch.models.gfhe import glwe as G
    p = G.Param(G.ERR_SIGMA, RingParam(2 ** 16 + 1, 128), 16, 2)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        gen = prng.Gen(16)
        s1, pk = G.new_key(gen, p, dev)
        s2, _ = G.new_key(gen, p, dev)
        ksk = G.new_ksk(gen, p, 2, 16, s1, s2)
        m = prng.uniform_mod(gen, (4, 128), 2, dev)
        c = G.encrypt(gen, p, pk, G.encode(p, m), batch=(4,))
        out[dev.type] = G.key_switch(p, 2, 16, ksk, c)
        assert torch.equal(G.decode(p, G.decrypt(p, s2, out[dev.type])), m)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(out["cuda"],
                                                       out["cpu"]))


def test_parallel_ranks_on_the_card_stage_through_the_host(cuda):
    """Two gloo ranks on the card: the four-step product over sp and the
    CRT product over ep equal the unsharded calls on the CPU, and every
    collective's CUDA tensors went through the host (counted)."""
    from fhe_study_tpu_torch.arith import rq
    from fhe_study_tpu_torch.parallel import (comm, launch, mesh,
                                              ntt_sharded, pipeline)
    rng = np.random.default_rng(17)
    q = 65537
    a, b = (rng.integers(0, q, size=(3, 1024)) for _ in range(2))
    x, y = (rng.integers(-2 ** 20, 2 ** 20, size=(4, 1024)) for _ in range(2))
    steps = (
        (ntt_sharded.negacyclic_mul_sharded,
         (a, b, q, launch.MeshOf(mesh.make_mesh, (2, 1, 1, 2)), "sp")),
        (pipeline.polymul_i64_crt_ep,
         (x, y, launch.MeshOf(pipeline.factor_mesh, (2,)))),
        (comm.staged_bytes, ()),
    )
    out = launch.spawn(launch.calls, 2, "cuda", "gloo", 300, steps)
    want_sp = rq.mul(torch.from_numpy(a), torch.from_numpy(b), q).numpy()
    want_ep = ntt.polymul_i64_crt(torch.from_numpy(x),
                                  torch.from_numpy(y)).numpy()
    for sp, ep, staged in out:
        np.testing.assert_array_equal(sp, want_sp)
        np.testing.assert_array_equal(ep, want_ep)
        assert staged > 0


# -- past one block: n = 2^16 and 2^17 ---------------------------------------

@pytest.mark.parametrize("logn", [16, 17])
def test_transforms_past_a_block_match_plain(cuda, logn):
    """K1 and K9 across blocks (top passes, then one block a chunk of
    2^15 words): K1 over the TFHE pair both ways, with and without fin, on
    aligned and word-offset rows; K9 both ways under each prime; the
    dispatchers launch them; bit for bit."""
    n = 1 << logn
    qs = (998244353, 754974721)
    res = prng.device_residues(logn, cuda)
    x = res(qs, (3, n))
    for rows in (x, kernel_check._offset_word(x)):
        for kw in ({}, dict(fin=(3, 5)), dict(inverse=True),
                   dict(inverse=True, fin=(7, 11))):
            got = ntt_cuda.ntt_multi_kernel(rows, qs, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, ntt_cuda.ntt_multi_plain(rows, qs, **kw))
    for i, q in enumerate(qs):
        y = x[i].long()
        for inverse in (False, True):
            got = ntt_cuda.ntt_kernel(y, q, inverse=inverse)
            torch.cuda.synchronize()
            assert torch.equal(got, ntt_cuda.ntt_plain(y, q, inverse=inverse))
    _cuda.reset_launches()
    assert torch.equal(ntt.intt(ntt.ntt(x[0].long(), qs[0]), qs[0]),
                       x[0].long())
    assert torch.equal(ntt.intt_multi(ntt.ntt_multi(x, qs), qs), x)
    assert _cuda.launches()["ntt"] == 2 and _cuda.launches()["ntt_multi"] == 2


@pytest.mark.parametrize("logn", [16, 17])
def test_chunked_ops_past_a_block_match_plain(cuda, logn):
    """K2 (strided views, a scale), K3 (R = 3, the digit rows one word
    off), K5 (from 2 sources direct, from 3 staged) and K12 (2 transforms;
    named at 2^16, where its rule is the split) across blocks on their
    chunked schedules, bit for bit; each launch counted under its chunked
    layout."""
    n = 1 << logn
    qs = (998244353, 754974721)
    src = ntt_primes(3, 30, 1 << 16, skip=8)
    res = prng.device_residues(logn, cuda)
    pair = res(qs, (2, 2, n))
    edm = kernel_check._offset_word(
        res(qs, (3, 2, n)).transpose(0, 1).contiguous())
    kb, ka = (res(qs, (3, n)).transpose(0, 1).contiguous() for _ in range(2))
    cases = [
        kernel_check.tensor_eval4_case(
            "strided", [pair[..., 0, :], pair[..., 1, :], pair[..., 1, :],
                        pair[..., 0, :]], qs, (3, 5)),
        kernel_check.ks_contract_case("R=3", edm, kb, ka, qs),
        kernel_check.ext_ntt_case("direct", res(src[:2], (3, n)), src[:2],
                                  qs),
        kernel_check.ext_ntt_case("staged", res(src, (2, n)), src, qs),
        kernel_check.ceiling_case("reps=2", res(qs[:1], (3, n))[0], qs[0],
                                  2, "chunked")]
    _cuda.reset_launches()
    for case in cases:
        got = case.kernel()
        torch.cuda.synchronize()
        assert kernel_check.equal(got, case.plain()), case.label
    assert {k.name: _cuda.chunked_launches(k) for k in (
        _cuda.TENSOR_EVAL4, _cuda.KS_CONTRACT, _cuda.EXT_NTT,
        _cuda.NTT_SMEM_CEILING)} == {"tensor_eval4": 1, "ks_contract": 1,
                                     "ext_ntt": 2, "ntt_smem_ceiling": 1}
    assert _cuda.EXT_NTT.by_layout["chunked staged"] == 1


@pytest.mark.parametrize("logn", [16, 17])
def test_chunked_mul_past_a_block_matches_plain(cuda, logn):
    """K6 (without a source basis on strided views, from 4 sources direct,
    from 3 staged), tensor_mul (stacked), K7 and K8 (R = 3, c_limbs and
    adds strided views) across blocks on their chunked schedules, bit for
    bit; each launch counted under its chunked layout."""
    n = 1 << logn
    qs = (998244353, 754974721)
    src = ntt_primes(4, 30, 1 << 16, skip=8)
    res = prng.device_residues(100 + logn, cuda)
    pair = res(qs, (2, 2, n))
    limbs = torch.stack([res((s,), (2, 3, n))[0] for s in src[:3]])
    kb, ka = (res(qs, (3, n)).transpose(0, 1).contiguous() for _ in range(2))
    cases = [
        kernel_check.tensor_mul4_case(
            "strided", [pair[..., 0, :], pair[..., 1, :], pair[..., 1, :],
                        pair[..., 0, :]], qs, (3, 5)),
        kernel_check.tensor_mul4_case(
            "direct", [res(src, (2, n)) for _ in range(4)], qs, None, src),
        kernel_check.tensor_mul4_case(
            "staged", [res(src[:3], (2, n)) for _ in range(4)], qs, (3, 5),
            src[:3]),
        kernel_check.tensor_mul_case("stacked", res(qs, (2, 4, n)), qs),
        kernel_check.ks_fused_case("R=3", limbs[..., 2, :], kb, ka, qs,
                                   src[:3]),
        kernel_check.ks_fused_eval_case(
            "R=3", limbs[..., 2, :], kb, ka, qs, src[:3],
            (pair[..., 0, :], pair[..., 1, :]))]
    _cuda.reset_launches()
    for case in cases:
        got = case.kernel()
        torch.cuda.synchronize()
        assert kernel_check.equal(got, case.plain()), case.label
    assert {k.name: _cuda.chunked_launches(k) for k in (
        _cuda.TENSOR_MUL4, _cuda.TENSOR_MUL, _cuda.KS_FUSED,
        _cuda.KS_FUSED_EVAL)} == {"tensor_mul4": 3, "tensor_mul": 1,
                                  "ks_fused": 1, "ks_fused_eval": 1}
    assert _cuda.TENSOR_MUL4.by_layout["chunked staged"] == 1


@pytest.mark.parametrize("logn,C,l,w", [(16, 2, 5, 6), (16, 1, 3, 7),
                                        (17, 2, 2, 6), (17, 3, 1, 6)])
def test_blind_rotate_grid_layout_matches_plain(cuda, logn, C, l, w):
    """K10 past 2^15 in its grid layout (named by the caller, where the
    plan takes the split at 2^16 and the quarter layout at 2^17) over 3
    steps on 2 ciphertexts, and with key
    planes one word off, bit for bit; one launch a chain, counted under its
    layout."""
    n = 1 << logn
    gen = prng.Gen(logn + C + l)
    args = kernel_check.blind_rotate_inputs(n, C - 1, 1 << w, l, 3, 2, cuda,
                                            gen)
    assert blind_rotate_cuda._plan(C, l, n).layout == {
        16: "split", 17: "quarter"}[logn]
    _cuda.reset_launches()
    got = blind_rotate_cuda.blind_rotate_kernel(*args, layout="grid")
    torch.cuda.synchronize()
    assert _cuda.launches()["blind_rotate"] == 1
    assert _cuda.BLIND_ROTATE.by_layout == {"cluster": 0, "device": 0,
                                            "split": 0, "grid": 1,
                                            "quarter": 0}
    assert torch.equal(got, blind_rotate_cuda.blind_rotate_plain(*args))
    off = [kernel_check._offset_word(e) for e in args[2:6]]
    got = blind_rotate_cuda.blind_rotate_kernel(args[0], args[1], *off, n, w,
                                                layout="grid")
    assert torch.equal(got, blind_rotate_cuda.blind_rotate_plain(
        args[0], args[1], *off, n, w))


@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_blind_rotate_split_layout_matches_plain(cuda, C):
    """K10 at 2^16 in its split layout at every (C, l, w) of the
    reference's gate there (kernel_check.gate_shapes; this C's), over 2
    steps on 1 to 3 ciphertexts in turn, and the first shape's key planes
    one word off, bit for bit; one launch a chain, counted under
    "split"."""
    n = 1 << 16
    gen = prng.Gen(160 + C)
    shapes = [s for s in kernel_check.gate_shapes(n) if s[0] == C]
    assert shapes
    for i, (_, l, w) in enumerate(shapes):
        args = kernel_check.blind_rotate_inputs(n, C - 1, 1 << w, l, 2,
                                                1 + i % 3, cuda, gen)
        assert blind_rotate_cuda._plan(C, l, n).layout == "split"
        _cuda.reset_launches()
        got = blind_rotate_cuda.blind_rotate_kernel(*args)
        torch.cuda.synchronize()
        assert _cuda.BLIND_ROTATE.by_layout["split"] == 1
        assert torch.equal(got, blind_rotate_cuda.blind_rotate_plain(
            *args)), (C, l, w)
        if i == 0:
            off = [kernel_check._offset_word(e) for e in args[2:6]]
            got = blind_rotate_cuda.blind_rotate_kernel(args[0], args[1],
                                                        *off, n, w)
            assert torch.equal(got, blind_rotate_cuda.blind_rotate_plain(
                args[0], args[1], *off, n, w))
    assert blind_rotate_cuda.split_clusters(cuda) >= 1


@pytest.mark.parametrize("beta,l", [(1 << 5, 6), (1 << 5, 7)])
def test_blind_rotate_quarter_layout_matches_plain(cuda, beta, l):
    """K10 at 2^17 in its quarter layout (the plan's there) at both gadgets
    of chip_smoke.py's phase 22 (K = 1), over 3 steps on 2 ciphertexts,
    and with key planes one word off, bit for bit; one launch a chain,
    counted under "quarter"; its inverse clusters of eight schedule."""
    n = 1 << 17
    gen = prng.Gen(170 + l)
    args = kernel_check.blind_rotate_inputs(n, 1, beta, l, 3, 2, cuda, gen)
    assert blind_rotate_cuda._plan(2, l, n).layout == "quarter"
    _cuda.reset_launches()
    got = blind_rotate_cuda.blind_rotate_kernel(*args)
    torch.cuda.synchronize()
    assert _cuda.launches()["blind_rotate"] == 1
    assert _cuda.BLIND_ROTATE.by_layout == {"cluster": 0, "device": 0,
                                            "split": 0, "grid": 0,
                                            "quarter": 1}
    assert torch.equal(got, blind_rotate_cuda.blind_rotate_plain(*args))
    off = [kernel_check._offset_word(e) for e in args[2:6]]
    got = blind_rotate_cuda.blind_rotate_kernel(args[0], args[1], *off, n,
                                                args[7])
    assert torch.equal(got, blind_rotate_cuda.blind_rotate_plain(
        args[0], args[1], *off, n, args[7]))
    assert blind_rotate_cuda.quarter_clusters(cuda) >= 1


def test_ceiling_split_matches_plain(cuda):
    """K12 at 2^16 on two-block clusters over 0, 1 and 3 repetitions on 1
    to 3 polynomials, and on the chunked schedule where named, bit for bit;
    each launch counted under its layout."""
    q = 998244353
    res = prng.device_residues(161, cuda)
    _cuda.reset_launches()
    for B, reps in ((1, 0), (2, 1), (3, 3)):
        x = res((q,), (B, 1 << 16))[0]
        want = alu_bench.ntt_smem_ceiling_plain(x, q, reps)
        for layout in (None, "chunked"):
            got = alu_bench.ntt_smem_ceiling_kernel(x, q, reps, layout)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (B, reps, layout)
    assert _cuda.NTT_SMEM_CEILING.by_layout == {"block": 0, "chunked": 3,
                                                "split": 3}
    assert alu_bench.split_clusters(cuda) >= 1


def test_bootstrap_short_at_n_2_16_on_card_matches_cpu(cuda):
    """bootstrap_short at N = 2^16, K = 1, beta = 2^6, l = 5 on a 4-step
    short key: keys, ciphertexts and outputs equal on the card (K9, K10's
    split layout) and the CPU (plain versions), and fused == step by step
    (K1 at 2^16) on the card."""
    param = Param(ERR_SIGMA, RingParam(TORUS_Q, 1 << 16), 1, 64)
    kw = dict(beta=1 << 6, l=5, beta_ks=16, l_ks=8)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        gen = prng.Gen(22)
        s, _ = tglwe.new_key(gen, param, dev)
        s_flat = tglwe.sk_to_tlwe(s)
        sbtk = bootstrap.new_short_bootstrapping_key(gen, param, s, n_lwe=4,
                                                     **kw)
        evals = bootstrap.precompute_short_btk_evals(param, sbtk)
        m = torch.arange(4, device=dev) % 32
        c = tlwe.encrypt_uniform(gen, param.lwe(), s_flat,
                                 tlwe.encode(param, m), batch=(4,))
        table = bootstrap.compute_lookup_table_standard(param, dev)
        _cuda.reset_launches()
        out[dev.type] = bootstrap.bootstrap_short(param, sbtk, table, c,
                                                  btk_evals=evals, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert _cuda.BLIND_ROTATE.by_layout["split"] == 1
            step = bootstrap.bootstrap_short(param, sbtk, table, c,
                                             btk_evals=evals, fused=False,
                                             **kw)
            assert _cuda.launches()["ntt_multi"] > 0
            assert torch.equal(step.a, out["cuda"].a)
            assert torch.equal(step.b, out["cuda"].b)
    assert torch.equal(out["cuda"].a.cpu(), out["cpu"].a)
    assert torch.equal(out["cuda"].b.cpu(), out["cpu"].b)


def test_sliced_key_generation_on_card_matches_cpu(cuda, monkeypatch):
    """new_short_bootstrapping_key (10 steps) and new_bootstrapping_key (256
    keys) at N = 256, K = 1, beta = 2^8, l = 3 with the TGGSW encryption
    forced into slices of 3 steps (3 + 3 + 3 + 1; 85 x 3 + 1): the card's
    keys (K9 at 256) equal the CPU's and the card's unsliced keys, and the
    eval planes of the sliced short key equal the CPU's."""
    param = Param(ERR_SIGMA, RingParam(TORUS_Q, 256), 1, 8)
    kw = dict(beta=1 << 8, l=3, beta_ks=16, l_ks=8)

    def keys(dev):
        s, _ = tglwe.new_key(prng.Gen(30), param, dev)
        short = bootstrap.new_short_bootstrapping_key(prng.Gen(31), param, s,
                                                      n_lwe=10, **kw)
        full, out = bootstrap.new_bootstrapping_key(prng.Gen(32), param, s,
                                                    **kw)
        return (*short, *full, out,
                *bootstrap.precompute_short_btk_evals(param, short))

    whole = keys(cuda)
    monkeypatch.setattr(tggsw, "EVALS_SLICE_WORDS", 3 * 2 * 3 * 256)
    _cuda.reset_launches()
    sliced = keys(cuda)
    torch.cuda.synchronize()
    assert _cuda.launches()["ntt"] > 0
    cpu = keys(torch.device("cpu"))
    for got, one, want in zip(sliced, whole, cpu):
        assert torch.equal(got, one)
        assert torch.equal(got.cpu(), want)
