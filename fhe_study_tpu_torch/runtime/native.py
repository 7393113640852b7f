"""ctypes bridge to the native golden model (native/golden.cpp) — the port's
own loader, the counterpart of fhe_study_tpu/runtime/native.py.

golden.cpp shares no code or tables with either package: 128-bit-exact
modular products, the negacyclic NTT on the reference's schedule, and exact
negacyclic products over Z_q, Z and the mod-2^64 torus.  The tests hold the
port's arithmetic against it.  It works on numpy arrays on the host.

The library is built by ``g++`` at the first call into
``_build/torch_golden/<hash of the source>/libgolden.so``: a directory of
its own, so it never races the JAX package's loader, and written under a
per-process name then renamed, so concurrent test workers never load a
half-written file.  A missing toolchain or a failed build raises
``NativeBuildError``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "native" / "golden.cpp"
BUILD_ROOT = ROOT / "_build" / "torch_golden"
FLAGS = ("-O2", "-shared", "-fPIC")


class NativeBuildError(RuntimeError):
    """g++ is missing or refused golden.cpp."""


def available() -> bool:
    """Whether a C++ compiler is on PATH (the library can be built)."""
    return shutil.which("g++") is not None


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SRC.read_bytes())
    so = BUILD_ROOT / h.hexdigest()[:16] / "libgolden.so"
    if not so.is_file():
        gxx = shutil.which("g++")
        if gxx is None:
            raise NativeBuildError("g++ not found: the golden model cannot "
                                   "be built")
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"libgolden.{os.getpid()}.tmp")
        res = subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(SRC)],
                             capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise NativeBuildError(f"g++ exited with {res.returncode}:\n"
                                   f"{res.stderr.strip()}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    u64 = ctypes.c_uint64
    lib.golden_mulmod.restype = u64
    lib.golden_mulmod.argtypes = [u64] * 3
    lib.golden_powmod.restype = u64
    lib.golden_powmod.argtypes = [u64] * 3
    lib.golden_invmod.restype = u64
    lib.golden_invmod.argtypes = [u64] * 2
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.golden_ntt.argtypes = [u64p, u64, u64, ctypes.c_int]
    lib.golden_ntt.restype = None
    lib.golden_polymul_mod.argtypes = [u64p, u64p, u64p, u64, u64]
    lib.golden_polymul_mod.restype = None
    lib.golden_polymul_torus.argtypes = [u64p, u64p, u64p, u64]
    lib.golden_polymul_torus.restype = None
    lib.golden_polymul_i64.argtypes = [i64p, i64p, i64p, u64]
    lib.golden_polymul_i64.restype = None
    return lib


def mulmod(a: int, b: int, q: int) -> int:
    return int(_lib().golden_mulmod(a, b, q))


def powmod(x: int, k: int, q: int) -> int:
    return int(_lib().golden_powmod(x, k, q))


def invmod(x: int, q: int) -> int:
    """x^-1 mod a prime q."""
    return int(_lib().golden_invmod(x, q))


def _vec(x, dtype) -> np.ndarray:
    a = np.ascontiguousarray(np.array(x, dtype))
    if a.ndim != 1:
        raise ValueError(f"the golden model takes one polynomial, got shape "
                         f"{a.shape}")
    return a


def ntt(x, q: int, inverse: bool = False) -> np.ndarray:
    """The negacyclic NTT (or its inverse, times n^-1) of one polynomial."""
    data = _vec(x, np.uint64)
    _lib().golden_ntt(data, data.shape[0], q, int(inverse))
    return data


def polymul_mod(a, b, q: int) -> np.ndarray:
    a, b = _vec(a, np.uint64), _vec(b, np.uint64)
    out = np.zeros_like(a)
    _lib().golden_polymul_mod(a, b, out, a.shape[0], q)
    return out


def polymul_torus(a, b) -> np.ndarray:
    a, b = _vec(a, np.uint64), _vec(b, np.uint64)
    out = np.zeros_like(a)
    _lib().golden_polymul_torus(a, b, out, a.shape[0])
    return out


def polymul_i64(a, b) -> np.ndarray:
    a, b = _vec(a, np.int64), _vec(b, np.int64)
    out = np.zeros_like(a)
    _lib().golden_polymul_i64(a, b, out, a.shape[0])
    return out
