"""The port's loader of the native golden model (runtime/native.py, built
from native/golden.cpp), and the port's arithmetic held against it: modular
products up to 2^48, the NTT inside and outside the kernel gate, and the
negacyclic products over Z_q, Z and the torus.  Skipped without g++, as
tests/test_native.py is.  Tolerance 0.
"""

import shutil

import numpy as np
import pytest
import torch

from fhe_study_tpu_torch.arith import rq, tn
from fhe_study_tpu_torch.ops import modops, ntt
from fhe_study_tpu_torch.runtime import native
from fhe_study_tpu_torch.utils import interop

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def golden():
    if shutil.which("g++") is None:
        pytest.skip("no native toolchain (g++)")
    return native


def tt(a):
    return interop.bits_to_tensor(np.asarray(a, np.uint64), CPU)


def bits(t):
    return interop.bits_to_numpy(t)


def test_mulmod_cross(golden):
    rng = np.random.default_rng(0)
    for q in (65537, 2013265921, 65537 ** 3):
        a, b = (rng.integers(0, q, 32, dtype=np.uint64) for _ in range(2))
        want = [golden.mulmod(int(x), int(y), q) for x, y in zip(a, b)]
        assert bits(modops.mulmod(tt(a), tt(b), q)).tolist() == want
        assert golden.powmod(3, q - 2, q) == modops.powmod(
            torch.tensor(3), q - 2, q).item()
    assert golden.invmod(12345, 65537) == modops.invmod(
        torch.tensor(12345), 65537).item()


def test_ntt_cross(golden):
    rng = np.random.default_rng(1)
    for q, n in ((65537, 64), (65537, 256), (2013265921, 512)):
        x = rng.integers(0, q, n, dtype=np.uint64)
        want = golden.ntt(x, q)
        np.testing.assert_array_equal(bits(ntt.ntt(tt(x), q)), want)
        np.testing.assert_array_equal(bits(ntt.intt(tt(want), q)),
                                      golden.ntt(want, q, inverse=True))


def test_polymul_cross(golden):
    rng = np.random.default_rng(2)
    q, n = 65537, 128
    a, b = (rng.integers(0, q, n, dtype=np.uint64) for _ in range(2))
    np.testing.assert_array_equal(bits(rq.mul(tt(a), tt(b), q)),
                                  golden.polymul_mod(a, b, q))
    at, bt = (rng.integers(0, 1 << 64, n, dtype=np.uint64) for _ in range(2))
    np.testing.assert_array_equal(bits(tn.mul_crt(tt(at), tt(bt))),
                                  golden.polymul_torus(at, bt))
    ai, bi = (rng.integers(-(1 << 20), 1 << 20, n) for _ in range(2))
    got = ntt.polymul_i64_crt(torch.from_numpy(ai), torch.from_numpy(bi))
    np.testing.assert_array_equal(got.numpy(), golden.polymul_i64(ai, bi))


def test_loader_builds_its_own_library(golden, monkeypatch, tmp_path):
    """The library lands under _build/torch_golden/<hash>/, apart from the
    JAX package's _build/libgolden.so; with no g++ on PATH a fresh build
    raises instead of returning None."""
    golden.mulmod(1, 1, 3)
    built = list(golden.BUILD_ROOT.glob("*/libgolden.so"))
    assert built and all(p.parent.parent == golden.BUILD_ROOT for p in built)
    golden._lib.cache_clear()
    monkeypatch.setattr(golden, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path / "none"))
    try:
        with pytest.raises(golden.NativeBuildError, match="g\\+\\+"):
            golden.mulmod(1, 1, 3)
        assert not golden.available()
    finally:
        golden._lib.cache_clear()
