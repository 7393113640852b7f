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

from fhe_study_tpu_torch.models import bfv_rns as R
from fhe_study_tpu_torch.ops import _cuda, ntt_cuda
from fhe_study_tpu_torch.utils import kernel_check

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [256, 1 << 14])
def test_kernels_match_plain(cuda, n):
    param = R.RnsParam(n=n, t=256, L=4, M=5)
    gen = torch.Generator(device=cuda).manual_seed(5)
    for case in kernel_check.cases(param, 2, cuda, gen):
        got, want = case.kernel(), case.plain()
        torch.cuda.synchronize()
        assert kernel_check.equal(got, want), (case.name, case.label)


def test_linear_kernels_match_plain(cuda):
    param = R.RnsParam(n=256, t=256, L=2, M=3)
    gen = torch.Generator(device=cuda).manual_seed(6)
    for case in kernel_check.linear_cases(param, 4, cuda, gen):
        got, want = case.kernel(), case.plain()
        torch.cuda.synchronize()
        assert kernel_check.equal(got, want), (case.name, case.label)


def _slice(param, device, seed=3, batch=2):
    gen = torch.Generator().manual_seed(seed)      # same draws on any device
    sk, pk = R.new_key(gen, param, device)
    hk = R.hybrid_rlk1(gen, param, sk)
    m = [torch.randint(0, param.t, (batch, param.n), generator=gen)
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


def _paths(param, device, seed=4, batch=2):
    """mul with both relin keys, the gadget mul_e, a key switch and one step
    of the linear pipeline, on draws that are the same on any device."""
    gen = torch.Generator().manual_seed(seed)
    sk, pk = R.new_key(gen, param, device)
    sk2, _ = R.new_key(gen, param, device)
    rlk, hk = R.rlk_key(gen, param, sk), R.hybrid_rlk1(gen, param, sk)
    ksk = R.ksk_key(gen, param, sk, sk2)
    m = [torch.randint(0, param.t, (batch, param.n), generator=gen)
         for _ in range(2)]
    c = [R.encrypt(gen, param, pk, mi.to(device), batch=(batch,))
         for mi in m]
    e = [R.to_evals(param, ci) for ci in c]
    em = R.pt_to_evals(param, m[1].to(device))
    outs = [*R.mul(param, rlk, *c), *R.mul(param, hk, *c),
            *R.mul_e(param, rlk, *e), *R.key_switch(param, ksk, c[0]),
            *R.mul_pt_e(param, R.add_e(param, *e), em)]
    return outs, R.decrypt(param, sk, R.mul(param, rlk, *c))


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
