"""The reference's kernel gate for the multi-prime ops, and ring degrees 2^7
and 2^6, on the CPU.

The JAX package sends a multi-prime op to its Pallas kernel only where
``_pallas_ok(p, n)`` holds for every prime and n > 1 (and, for the three
key-switch ops, where the keys are [R, Lp, n]); everywhere else it runs XLA.
The port's ``ops.ntt.multi_gate`` is that rule, and each of the eight
dispatchers launches its kernel exactly inside it when its tensors lie on
the card.  Here: ``multi_gate`` against ``_pallas_ok`` over a grid of
(q, n) with the TPU backend faked as tests/test_torch_rq.py fakes it; each
dispatcher at n = 64, 128 and 256 with the tensors taken for CUDA ones and
each kernel wrapper replaced by a recorder that runs the plain version (the
kernel is reached exactly inside the gate, the result is the plain
version's); the plans of the register-resident chains and of K10 at
log n = 7 (8 threads, one group, no split); then RNS-BFV at n = 128, t = 16,
L = 3, M = 4 (the reference's tests/test_bfv_rns.py configuration): ``mul``
and ``mul_e`` with the gadget and the hybrid key against the JAX package
under ``jax.jit``, and ``mul_e`` with the hybrid key at n = 64, t = 65537
(tests/test_galois.py's), on keys and ciphertexts the port draws, carried
into JAX by utils/interop.py, each decrypted against a numpy negacyclic
product.  Tolerance 0 throughout.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_study_tpu.models import bfv_rns as J
from fhe_study_tpu.ops import ntt as jntt

from fhe_study_tpu_torch.models import bfv_rns as R
from fhe_study_tpu_torch.ops import _cuda, ntt, ntt_cuda
from fhe_study_tpu_torch.ops import blind_rotate_cuda as brc
from fhe_study_tpu_torch.ops.primes import ntt_primes
from fhe_study_tpu_torch.utils import interop, prng

CPU = torch.device("cpu")
QS = ntt_primes(3, 30, 1 << 10)          # 2n-th roots up to n = 512
SRC = ntt_primes(2, 30, 1 << 10, skip=3)

# the grid of tests/test_torch_rq.py's K9 gate, and prime sets mixing both
# sides of 2^31
GATE_Q = [2 ** 16 + 1, 2013265921, 1811939329, (1 << 31) - 1, 1 << 31,
          1099511922689]
GATE_N = [1, 2, 64, 128, 256, 384, 1024, 1 << 14, 1 << 15]


def test_multi_gate_is_the_reference_rule(monkeypatch):
    """ntt.multi_gate(primes, n) == n > 1 and _pallas_ok(p, n) for every
    prime, on a TPU backend, for every single prime and pair of the grid."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jntt, "_USE_PALLAS", True)
    sets = [(q,) for q in GATE_Q] + [(a, b) for a in GATE_Q for b in GATE_Q]
    for primes in sets:
        for n in GATE_N:
            want = n > 1 and all(jntt._pallas_ok(p, n) for p in primes)
            assert ntt.multi_gate(primes, n) == want, (primes, n)


def _res(seed: int, primes: tuple, shape: tuple) -> torch.Tensor:
    """[len(primes), *shape] int32 residues, row i below primes[i]."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack(
        [rng.integers(0, q, shape) for q in primes]).astype(np.int32))


def _keys(seed: int, R_: int, n: int, ndim: int = 3):
    """kb, ka: [R, Lp, n] eval-domain key rows (ndim 4: [R, Lp, 1, n], the
    aligned keys that the reference's plain path also takes)."""
    kb, ka = (torch.stack([_res(seed + 10 * i + h, QS, (n,))
                           for i in range(R_)]) for h in range(2))
    return (kb, ka) if ndim == 3 else (kb[:, :, None], ka[:, :, None])


def _ops(n: int, ndim: int = 3) -> dict:
    """Each dispatcher of ops/ntt.py, its wrapper's name in ops/ntt_cuda.py
    and a call on seeded operands at ring degree n."""
    x = _res(1, QS, (2, n))
    four = [_res(2 + i, QS, (2, n)) for i in range(4)]
    four_src = [_res(6 + i, SRC, (2, n)) for i in range(4)]
    kb, ka = _keys(20, 2, n, ndim)
    edm = torch.stack([_res(40 + i, QS, (2, n)) for i in range(2)])
    limbs = torch.stack([_res(50 + i, (SRC[i],), (2, n))[0]
                         for i in range(2)])
    adds = (_res(60, QS, (2, n)), _res(61, QS, (2, n)))
    return {
        "ntt_multi": ("ntt_multi", lambda: ntt.ntt_multi(x, QS)),
        "intt_multi": ("ntt_multi",
                       lambda: ntt.intt_multi(x, QS, scale=(3, 5, 7))),
        "tensor_eval4": ("tensor_eval4",
                         lambda: ntt.tensor_eval4(*four, QS, scale=(2, 3, 4))),
        "tensor_mul4": ("tensor_mul4",
                        lambda: ntt.tensor_mul4(*four_src, QS, src=SRC)),
        "tensor_mul_multi": ("tensor_mul", lambda: ntt.tensor_mul_multi(
            torch.stack(four, -2), QS)),
        "ext_ntt": ("ext_ntt", lambda: ntt.ext_ntt(x[:2], SRC, QS)),
        "ks_contract_multi": ("ks_contract", lambda: ntt.ks_contract_multi(
            edm, kb, ka, QS)),
        "ks_fused_multi": ("ks_fused", lambda: ntt.ks_fused_multi(
            limbs, kb, ka, QS, SRC)),
        "ks_fused_eval": ("ks_fused_eval", lambda: ntt.ks_fused_eval(
            limbs, kb, ka, QS, SRC, adds)),
    }


WRAPPERS = ("ntt_multi", "tensor_eval4", "tensor_mul4", "tensor_mul",
            "ext_ntt", "ks_contract", "ks_fused", "ks_fused_eval")


def _recorders(monkeypatch) -> list:
    """Each kernel wrapper replaced by a recorder that runs its plain
    version; the names it was called under, in order."""
    calls = []
    for name in WRAPPERS:
        plain = getattr(ntt_cuda, name + "_plain")

        def record(*args, _name=name, _plain=plain, **kw):
            calls.append(_name)
            return _plain(*args, **kw)

        monkeypatch.setattr(ntt_cuda, name + "_kernel", record)
    return calls


def _same(got, want):
    got = (got,) if isinstance(got, torch.Tensor) else tuple(got)
    want = (want,) if isinstance(want, torch.Tensor) else tuple(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [64, 128, 256])
@pytest.mark.parametrize("op", list(_ops(128)))
def test_dispatch_follows_the_gate(monkeypatch, op, n):
    """With the tensors taken for CUDA ones, each multi-prime dispatcher
    reaches its kernel wrapper exactly where multi_gate holds (n = 128 and
    256 here, never n = 64), and its plain version everywhere else; the
    result is the plain version's either way."""
    wrapper, call = _ops(n)[op]
    want = call()                                   # the CPU: plain
    calls = _recorders(monkeypatch)
    monkeypatch.setattr(_cuda, "on_cuda", lambda *t: True)
    got = call()
    _same(got, want)
    gate = ntt.multi_gate(QS + SRC, n)
    assert gate == (n >= 128)
    assert calls == ([wrapper] if gate else [])


@pytest.mark.parametrize("op", ["ks_contract_multi", "ks_fused_multi",
                                "ks_fused_eval"])
def test_key_switch_ops_take_the_kernel_only_on_three_axis_keys(
        monkeypatch, op):
    """Inside the gate, keys other than [R, Lp, n] (here [R, Lp, 1, n], which
    the plain versions align against the digits as the reference's XLA
    path does) take the plain version, as in the reference."""
    _, call = _ops(256, ndim=4)[op]
    want = call()
    calls = _recorders(monkeypatch)
    monkeypatch.setattr(_cuda, "on_cuda", lambda *t: True)
    _same(call(), want)
    assert calls == []
    _, call3 = _ops(256)[op]
    _same(call3(), want)                # the same keys on three axes
    assert len(calls) == 1


def test_plans_at_log_n_7():
    """The plans the kernels check at n = 2^7: 8 virtual threads on 8
    threads (a quarter of a warp), one group, two passes a chain (stage
    bits 6..3 then 2..0 forward, 0..3 then 4..6 inverse), one n-word buffer
    (K1-K3, K5, K9, K12) or three (K6-K8, no split); K10 at C = 2, l = 3
    (the TFHE tests' gadget 256^3) with the step's key planes staged."""
    plan = ntt_cuda._radix_plan(7)
    assert (plan.threads, plan.groups, plan.smem_bytes) == (8, 1, 512)
    assert [(p.c, p.stages) for p in plan.forward] == [(3, (3, 2, 1, 0)),
                                                       (0, (2, 1, 0))]
    assert [(p.c, p.stages) for p in plan.inverse] == [(0, (0, 1, 2, 3)),
                                                       (3, (1, 2, 3))]
    mul4 = ntt_cuda._mul4_plan(7)
    assert mul4 == ntt_cuda._mul4_plan(7, side=True)
    assert (mul4.threads, mul4.groups, mul4.smem_bytes) == (8, 1, 3 * 512)
    assert (mul4.forward, mul4.inverse) == (plan.forward, plan.inverse)
    br = brc._plan(2, 3, 128)
    assert (br.threads, br.cluster, br.staged) == (256, 2, True)
    assert (br.forward_polys, br.inverse_polys) == (6, 4)
    assert br.radix == ntt_cuda._radix_plan(7, brc.BR_THREADS)
    assert br.smem_bytes == (32 + 8 * 2 * 128 + 4 * 6 * 128 + 12 * 4 * 128
                             + 2 * 4 * 6 * 4 * 128)
    assert ntt_cuda._split_index(1 << 7).shape == (2, 64)


# -- RNS-BFV at n = 128 and n = 64 against the JAX package ------------------

B = 2


def _negacyclic(a, b, n: int, t: int):
    lin = np.convolve(a.astype(np.int64), b.astype(np.int64))
    return (lin[:n] - np.append(lin[n:], 0)) % t


def _jax(x):
    return tuple(jnp.asarray(a) for a in interop.to_numpy(x))


def _draw(n: int, t: int, seed: int, kinds=("RLK", "HRLK")):
    param = R.RnsParam(n=n, t=t, L=3, M=4)
    gen = prng.Gen(seed)
    sk, pk = R.new_key(gen, param, CPU)
    keys = {}
    if "RLK" in kinds:
        keys["RLK"] = R.rlk_key(gen, param, sk)
    if "HRLK" in kinds:
        keys["HRLK"] = R.hybrid_rlk1(gen, param, sk)
    ms = [prng.uniform_mod(gen, (B, n), t, CPU) for _ in range(2)]
    cts = [R.encrypt(gen, param, pk, m, batch=(B,)) for m in ms]
    want = np.stack([_negacyclic(a, b, n, t) for a, b in
                     zip(ms[0].numpy(), ms[1].numpy())])
    return param, sk, keys, cts, want


JP128 = J.RnsParam(n=128, t=16, L=3, M=4)
_tensor = jax.jit(lambda x, y: J._tensor(JP128, J.CT(*x), J.CT(*y)))
_relin = {"RLK": jax.jit(lambda k, c0, c1, c2: J.relinearize(
              JP128, J.RLK(*k), c0, c1, c2)),
          "HRLK": jax.jit(lambda k, c0, c1, c2: J.relinearize_hybrid(
              JP128, J.HRLK(*k), c0, c1, c2))}
_to_evals = jax.jit(lambda c: J.to_evals(JP128, J.CT(*c)))
_from_evals = jax.jit(lambda ce: J.from_evals(JP128, J.CTE(*ce)))


@pytest.fixture(scope="module")
def bfv128():
    return _draw(128, 16, 1707)


@pytest.mark.parametrize("kind", ["RLK", "HRLK"])
def test_mul_and_mul_e_at_n_128_match_jax(bfv128, kind):
    """mul and mul_e with either key at the reference's n = 128, t = 16,
    L = 3, M = 4.  J.mul is the tensor then the relinearization its key
    selects, and J.mul_e equals to_evals of J.mul on from_evals of its
    operands (its contract, pinned by the reference's own
    test_eval_resident_mul_matches_mul): each piece is jitted once."""
    param, sk, keys, (x, y), want = bfv128
    key = keys[kind]
    ex, ey = (R.to_evals(param, c) for c in (x, y))
    want_mul = _relin[kind](_jax(key), *_tensor(_jax(x), _jax(y)))
    c = (_from_evals(_jax(v)) for v in (ex, ey))
    want_mul_e = _to_evals(_relin[kind](_jax(key), *_tensor(*c)))
    got = (R.mul(param, key, x, y), R.mul_e(param, key, ex, ey))
    for g, w in zip(got, (want_mul, want_mul_e)):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(interop.to_numpy(a),
                                          np.asarray(b))
    for ct in (got[0], R.from_evals(param, got[1])):
        np.testing.assert_array_equal(R.decrypt(param, sk, ct).numpy(), want)


def test_mul_e_hybrid_at_n_64_matches_jax():
    """mul_e with the hybrid key at tests/test_galois.py's n = 64,
    t = 65537, L = 3, M = 4, where no multi-prime op passes the gate."""
    param, sk, keys, (x, y), want = _draw(64, 65537, 1708, kinds=("HRLK",))
    jp = J.RnsParam(n=64, t=65537, L=3, M=4)
    ex, ey = (R.to_evals(param, c) for c in (x, y))
    ref = jax.jit(lambda k, a, b: J.mul_e(jp, J.HRLK(*k), J.CTE(*a),
                                          J.CTE(*b)))
    w = ref(_jax(keys["HRLK"]), _jax(ex), _jax(ey))
    got = R.mul_e(param, keys["HRLK"], ex, ey)
    for a, b in zip(got, w):
        np.testing.assert_array_equal(interop.to_numpy(a), np.asarray(b))
    np.testing.assert_array_equal(
        R.decrypt(param, sk, R.from_evals(param, got)).numpy(), want)
