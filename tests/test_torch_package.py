"""The port's package boundary: no jax, dispatch by device that never falls
back, the kernel loader's failures, and the host-side helpers it copied from
the JAX package (primes, root tables, rounding, samplers, interop)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fhe_study_tpu.ops import ntt as jntt
from fhe_study_tpu.ops.primes import ntt_primes as jprimes
from fhe_study_tpu.utils.rounding import round_half_away as jround

from fhe_study_tpu_torch.models import bfv_rns, hybrid_ks
from fhe_study_tpu_torch.models.ckks import ckks_rns
from fhe_study_tpu_torch.models.tfhe import tggsw, tlwe
from fhe_study_tpu_torch.ops import (_cuda, alu_bench, blind_rotate_cuda,
                                     ext_cuda, ntt, ntt_cuda, primes)
from fhe_study_tpu_torch.utils import interop, prng
from fhe_study_tpu_torch.utils.rounding import round_half_away

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "fhe_study_tpu_torch"

# Where pytest-xdist spreads the test files over several worker processes
# on one machine, each worker keeps torch's CPU kernels to its share of the
# cores: torch's default, every core in every worker, sets the workers
# spinning against one another (a 2^15 chain emulation of
# tests/test_torch_radix_plan.py took 2.2 s so in a run of six workers on
# eight cores, 0.06 s alone).  Every worker collects this module, so the
# setting reaches every test it runs.
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))


NO_JAX = """
import sys
BANNED = ("jax", "jaxlib", "fhe_study_tpu")
for m in [m for m in sys.modules if m.split(".")[0] in BANNED]:
    del sys.modules[m]


class Ban:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("the port imported " + name)


sys.meta_path.insert(0, Ban())
import importlib
import pkgutil
import fhe_study_tpu_torch
names = [m.name for m in pkgutil.walk_packages(fhe_study_tpu_torch.__path__,
                                               "fhe_study_tpu_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
import pathlib
root = pathlib.Path(fhe_study_tpu_torch.__file__).parent
files = {".".join(("fhe_study_tpu_torch",)
                  + f.relative_to(root).with_suffix("").parts)
         for f in root.rglob("*.py") if f.name != "__init__.py"}
walked = {m for m in names if m not in
          {".".join(("fhe_study_tpu_torch",) + d.relative_to(root).parts)
           for d in root.rglob("*") if d.is_dir()}}
assert walked == files, walked ^ files
bad = [m for m in sys.modules if m.split(".")[0] in BANNED]
assert not bad, bad
"""


def test_import_loads_no_jax():
    """Importing every module of the port, and chip_smoke.py, with jax and
    the JAX package made unimportable."""
    res = subprocess.run([sys.executable, "-c", NO_JAX], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_sources_import_no_jax():
    for f in [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]:
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                root = words[1].split(".")[0]
                assert root not in ("jax", "jaxlib", "fhe_study_tpu"), \
                    f"{f.name}: {line}"


def test_dispatch_raises_on_mixed_devices():
    with pytest.raises(ValueError, match="devices"):
        _cuda.on_cuda(torch.zeros(2), torch.zeros(2, device="meta"))
    assert _cuda.on_cuda(torch.zeros(2)) is False


def test_kernel_wrappers_take_only_cuda_tensors():
    """A wrapper given a CPU tensor raises; it never runs the plain
    version (that is the dispatcher's choice, by device, alone)."""
    qs = primes.ntt_primes(4, 30, 1 << 16)
    x = torch.zeros((4, 1, 256), dtype=torch.int32)
    keys = torch.zeros((4, 4, 256), dtype=torch.int32)
    calls = [
        lambda: ntt_cuda.ntt_multi_kernel(x, qs),
        lambda: ntt_cuda.tensor_eval4_kernel(x, x, x, x, qs),
        lambda: ntt_cuda.ks_contract_kernel(x[None], x[None, :, 0],
                                            x[None, :, 0], qs),
        lambda: ntt_cuda.ext_ntt_kernel(x, qs, qs),
        lambda: ext_cuda.base_extend_fused_kernel(x, qs, qs),
        lambda: ntt_cuda.tensor_mul4_kernel(x, x, x, x, qs),
        lambda: ntt_cuda.tensor_mul4_kernel(x, x, x, x, qs, src=qs),
        lambda: ntt_cuda.tensor_mul_kernel(keys[:, None], qs),
        lambda: ntt_cuda.ks_fused_kernel(x, keys, keys, qs, qs),
        lambda: ntt_cuda.ks_fused_eval_kernel(x, keys, keys, qs, qs, (x, x)),
        lambda: ntt_cuda.ntt_kernel(x.long(), qs[0]),
        lambda: blind_rotate_cuda.blind_rotate_kernel(
            torch.zeros((3, 1), dtype=torch.int32),
            torch.zeros((1, 2, 256), dtype=torch.int64),
            *(torch.zeros((3, 2, 2, 2, 2, 256), dtype=torch.int32),) * 4,
            256, 12),
        lambda: ext_cuda.base_extend_sum_kernel(x, x[0], qs, qs),
        lambda: alu_bench.ntt_smem_ceiling_kernel(x[0], qs[0], 1),
        lambda: alu_bench.alu_rate_kernel(keys, keys, keys, "add", 16),
    ]
    before = _cuda.launches()
    for call in calls:
        with pytest.raises(ValueError, match="take CUDA tensors"):
            call()
    assert _cuda.launches() == before


def test_every_kernel_names_its_plain_version_and_its_pallas_kernel():
    """Fourteen entries; each has a wrapper and a plain version beside it, and
    ``replaces`` is the file:line of the ``def`` of an existing function of
    the JAX package that reaches ``pl.pallas_call``."""
    pallas = {"ntt_multi": "ntt_multi_u32", "tensor_eval4": "tensor_eval4_u32",
              "ks_contract": "ks_contract_u32",
              "base_extend": "base_extend_fused", "ext_ntt": "ext_ntt_u32",
              "tensor_mul4": "tensor_mul4_u32", "tensor_mul": "tensor_mul_u32",
              "ks_fused": "ks_fused_u32", "ks_fused_eval": "ks_fused_eval_u32",
              "ntt": "ntt_u32", "blind_rotate": "blind_rotate_fused",
              "base_extend_sum": "base_extend_sum",
              "ntt_smem_ceiling": "ntt_vmem_ceiling", "alu_rate": "alu_rate"}
    assert [k.name for k in _cuda.KERNELS] == list(pallas)
    assert set(_cuda.launches()) == set(pallas)
    for k in _cuda.KERNELS:
        mod = {"base_extend": ext_cuda, "base_extend_sum": ext_cuda,
               "blind_rotate": blind_rotate_cuda,
               "ntt_smem_ceiling": alu_bench,
               "alu_rate": alu_bench}.get(k.name, ntt_cuda)
        stem = "base_extend_fused" if k.name == "base_extend" else k.name
        assert callable(getattr(mod, stem + "_kernel"))
        assert callable(getattr(mod, stem + "_plain"))
        assert (REPO / k.source).is_file()
        path, line = k.replaces.rsplit(":", 1)
        src = (REPO / path).read_text().splitlines()
        assert src[int(line) - 1].startswith(f"def {pallas[k.name]}("), \
            (k.name, src[int(line) - 1])
        assert "pallas_call" in (REPO / path).read_text()


def test_kernels_refuse_unsupported_ring_degrees():
    """Each kernel names its own range: every kernel of the radix chain
    (K1-K3, K5-K9 with tensor_mul, and K12; K6, tensor_mul, K7 and K8 at
    2^15 on two-block clusters) goes on across blocks to 2^26 and refuses
    2^27, K10 (past a block's shared memory in device memory, past 2^15
    across blocks) to 2^22; n = 128, the least degree of the reference's
    Pallas kernels, is every radix-chain kernel's first."""
    wide = (_cuda.NTT_MULTI, _cuda.NTT, _cuda.TENSOR_EVAL4, _cuda.KS_CONTRACT,
            _cuda.EXT_NTT, _cuda.NTT_SMEM_CEILING, _cuda.TENSOR_MUL4,
            _cuda.TENSOR_MUL, _cuda.KS_FUSED, _cuda.KS_FUSED_EVAL)
    tops = {**dict.fromkeys(wide, 26), _cuda.BLIND_ROTATE: 22}
    for k, top in tops.items():
        for n in (64, 1 << (top + 1), 384):
            with pytest.raises(ValueError, match=f"2\\^7 .. 2\\^{top}"):
                _cuda.log2_degree(n, k)
        assert _cuda.log2_degree(1 << top, k) == top
    for k in wide + (_cuda.BLIND_ROTATE,):
        for logn in range(16, tops[k] + 1):
            assert _cuda.log2_degree(1 << logn, k) == logn
    for k in _cuda.KERNELS:
        if k.logn is not None:
            assert _cuda.log2_degree(128, k) == 7, k.name
    assert {k for k in _cuda.KERNELS if k.logn is not None} == set(tops)
    assert _cuda.log2_degree(1 << 15, _cuda.BLIND_ROTATE) == 15
    assert _cuda.log2_degree(1 << 14, _cuda.TENSOR_MUL4) == 14
    assert _cuda.log2_degree(1 << 15, _cuda.TENSOR_MUL4) == 15
    assert _cuda.log2_degree(1 << 15, _cuda.NTT_MULTI) == 15


@pytest.fixture
def bare_loader(monkeypatch, tmp_path):
    """The loader with an empty build directory and no nvcc anywhere."""
    monkeypatch.setattr(_cuda, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_cuda, "DEFAULT_NVCC", tmp_path / "none" / "nvcc")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    _cuda.library.cache_clear()
    yield tmp_path
    _cuda.library.cache_clear()


def test_missing_nvcc_raises(bare_loader):
    with pytest.raises(_cuda.KernelBuildError, match="nvcc not found"):
        _cuda.library()


def test_failed_build_raises_with_the_compiler_message(bare_loader,
                                                       monkeypatch):
    fake = bare_loader / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(bare_loader / "cuda"))
    with pytest.raises(_cuda.KernelBuildError,
                       match="exited with 2:\nerror: no such intrinsic"):
        _cuda.library()
    assert not list((bare_loader / "build").rglob("*.so"))


def test_build_dir_is_keyed_by_the_sources(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// one\n")
    monkeypatch.setattr(_cuda, "CSRC", src)
    first = _cuda.build_dir()
    (src / "a.cu").write_text("// two\n")
    assert _cuda.build_dir() != first
    assert first.parent == _cuda.BUILD_ROOT


def test_primes_and_root_tables_match_reference():
    for args in [(4, 30, 1 << 16), (5, 30, 1 << 16, 4), (3, 30, 1 << 12)]:
        assert primes.ntt_primes(*args) == jprimes(*args)
    for q in primes.ntt_primes(2, 30, 1 << 16):
        mine, ref = ntt.get_plan(q, 256), jntt.get_plan(q, 256)
        np.testing.assert_array_equal(mine.roots, ref.roots)
        np.testing.assert_array_equal(mine.roots_inv, ref.roots_inv)
        assert (mine.root, mine.n_inv) == (ref.root, ref.n_inv)


def test_round_half_away_matches_reference():
    x = np.array([-2.5, -1.5, -0.5, -0.49999999999999994, 0.0, 0.5,
                  0.49999999999999994, 1.5, 2.5, 3.7, -3.7, 1e15 + 0.5])
    np.testing.assert_array_equal(
        round_half_away(torch.from_numpy(x)).numpy(),
        np.asarray(jround(jnp.asarray(x))))


def test_samplers_have_the_reference_distributions():
    gen = prng.Gen(0)
    shape = (64, 1024)
    t = prng.ternary(gen, shape, "cpu")
    freq = [float((t == v).double().mean()) for v in (-1, 0, 1)]
    np.testing.assert_allclose(freq, [0.25, 0.5, 0.25], atol=0.01)
    b = prng.binary(gen, shape, "cpu")
    assert set(b.unique().tolist()) == {0, 1}
    assert abs(float(b.double().mean()) - 0.5) < 0.01
    g = prng.gaussian_int(gen, shape, 3.2, "cpu").double()
    assert abs(float(g.mean())) < 0.05 and abs(float(g.std()) - 3.2) < 0.05
    qs = primes.ntt_primes(3, 30, 1 << 16)
    u = prng.uniform_mod_multi(gen, shape, qs, "cpu")
    assert u.dtype == torch.int32 and tuple(u.shape) == (3,) + shape
    for row, q in zip(u, qs):
        assert 0 <= int(row.min()) and int(row.max()) < q
        assert abs(float(row.double().mean()) / q - 0.5) < 0.01


def test_samplers_are_determined_by_the_seed():
    def draw(seed):
        g = prng.Gen(seed)
        a, b = prng.split(g, 2)
        return prng.ternary(a, (8,), "cpu"), prng.gaussian_int(b, (8,), 3.2,
                                                               "cpu")
    assert all(torch.equal(x, y) for x, y in zip(draw(1), draw(1)))
    assert not all(torch.equal(x, y) for x, y in zip(draw(1), draw(2)))


def test_interop_round_trip_and_range_check():
    a = np.array([[0, 5, (1 << 31) - 1]], np.uint64)
    ct = interop.to_port(bfv_rns.CT(a, a), "cpu")
    assert isinstance(ct, bfv_rns.CT) and ct.c0.dtype == torch.int32
    for got in interop.to_numpy(ct):
        np.testing.assert_array_equal(got, a)
    with pytest.raises(ValueError, match="2\\^31"):
        interop.to_tensor(np.array([1 << 31], np.uint64), "cpu")
    with pytest.raises(TypeError):
        interop.to_tensor(np.array([0.5]), "cpu")
    with pytest.raises(TypeError, match="cannot carry"):
        interop.to_port((a, a), "cpu")
    # kinds of one name are told apart by their module; HybridKSK's u32
    # planes cross as int32 under the same range check
    for kind in (ckks_rns.CT, ckks_rns.PublicKey, hybrid_ks.HybridKSK):
        got = interop.to_port(kind(a.astype(np.uint32), a), "cpu")
        assert type(got) is kind and got[0].dtype == torch.int32
        for back in interop.to_numpy(got):
            np.testing.assert_array_equal(back, a)
    assert type(interop.to_port(ckks_rns.SecretKey(a), "cpu")) \
        is ckks_rns.SecretKey
    assert type(interop.to_port(bfv_rns.SecretKey(a), "cpu")) \
        is bfv_rns.SecretKey
    with pytest.raises(ValueError, match="2\\^31"):
        interop.to_port(hybrid_ks.HybridKSK(a, a + (1 << 31)), "cpu")


def test_interop_carries_torus_words_and_shoup_planes_bit_for_bit():
    """u64 torus words above 2^63 and u32 words above 2^31 keep their bits
    (the residue path refuses them); scalars keep their shape."""
    w = np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1], np.uint64)
    ct = interop.to_port(tlwe.TLWE(w, w[3]), "cpu")
    assert isinstance(ct, tlwe.TLWE) and ct.a.dtype == torch.int64
    assert ct.a.tolist() == [0, 1, (1 << 63) - 1, -(1 << 63), -1]
    assert tuple(ct.b.shape) == ()
    for got, want in zip(interop.bits_to_numpy(ct), (w, w[3])):
        np.testing.assert_array_equal(got, want)
    planes = np.array([0, (1 << 31) - 1, 1 << 31, (1 << 32) - 1], np.uint32)
    ev = interop.to_port(tggsw.TGGSWEvals(*(planes,) * 4), "cpu")
    assert ev.ev1s.dtype == torch.int32
    assert ev.ev1s.tolist() == [0, (1 << 31) - 1, -(1 << 31), -1]
    np.testing.assert_array_equal(interop.bits_to_numpy(ev.ev2s), planes)
    with pytest.raises(TypeError, match="uint64 or uint32"):
        interop.bits_to_tensor(np.array([1], np.int64), "cpu")
    with pytest.raises(TypeError, match="int64 or int32"):
        interop.bits_to_numpy(torch.zeros(2))
    assert set(interop.BIT_KINDS) == {
        ("tlwe", "TLWE"), ("glwe", "GLWE"), ("glwe", "GLev"), ("glwe", "KSK"),
        ("tggsw", "TGGSW"), ("tggsw", "TGGSWEvals"), ("tlwe", "KSK"),
        ("bootstrap", "BootstrappingKey"),
        ("bootstrap", "ShortBootstrappingKey"), ("bfv", "SecretKey"),
        ("bfv", "PublicKey"), ("bfv", "RLK"), ("bfv", "RLWE"),
        ("ckks", "SecretKey"), ("ckks", "PublicKey"), ("ckks", "CT")}


def test_build_is_one_command_over_every_source(bare_loader, monkeypatch):
    """One compiler process per .cu file, then one link command over every
    file's object; the log keeps every command, compiles first."""
    fake = bare_loader / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\nwhile [ $# -gt 1 ]; do\n"
                    "  [ \"$1\" = -o ] && out=$2\n  shift\ndone\n"
                    "echo built > $out\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(bare_loader / "cuda"))
    with pytest.raises(OSError):            # the fake library is no ELF file
        _cuda.library()
    log = (_cuda.build_dir() / "build.log").read_text().splitlines()
    cus = sorted(p.name for p in _cuda.CSRC.iterdir() if p.suffix == ".cu")
    cmds = [line for line in log if not line.startswith("-- ")]
    k = len(cus)
    assert k == 21 and len(cmds) == k + 1
    assert all(line.endswith(" s") for line in log if line.startswith("-- "))
    assert [line.rsplit("/", 1)[-1] for line in cmds[:k]] == cus
    assert all(" -c " in line and " -shared " not in line
               for line in cmds[:k])
    link = cmds[k].split()
    assert " -shared " in cmds[k] and " -c " not in cmds[k]
    assert [w.rsplit("/", 1)[-1].split(".")[0] for w in link[-k:]] == \
        [c.removesuffix(".cu") for c in cus]
    assert not list(_cuda.build_dir().glob("*.o"))     # objects cleaned up
