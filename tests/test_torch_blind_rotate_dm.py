"""K10's device-memory layout (csrc/blind_rotate_dm_cuda.cu) and the gate
that sends every shape of the reference's fused chain to a kernel, on the
CPU:

  * ``supported`` equals the reference's ``supported`` (fhe_study_tpu/ops/
    blind_rotate_pallas.py) for every n = 2^7 .. 2^22, K = 0 .. 3, digit
    width w >= 1 and l with w l <= 64; ``_plan`` takes the cluster layout
    exactly where a ciphertext's working set fits a block, the
    device-memory layout elsewhere up to 2^15, the split layout at 2^16
    and the grid layout past it;
  * the layout's schedule written out in int64 torch — the forward blocks
    (ciphertext, digit polynomial, prime) into the scratch [B, 2, C l, n],
    the inverse clusters (ciphertext, column) with the Montgomery
    contraction from the scratch, the CRT by halves and the limb-shifted
    adds into the accumulator, step after step — equals
    ``blind_rotate_plain`` at n = 128 and 256, C = 2, 3, l = 1 .. 3, on 1,
    3 and 5 ciphertexts, bit for bit;
  * ``blind_rotation`` of the port (the fused chain's plain version on the
    CPU) equals the JAX package's step-by-step chain under ``jax.jit`` at
    N = 4096, K = 1, beta = 2^11, l = 2 (tests/test_bootstrap.py's t = 128
    bootstrap with N doubled) over 8 steps on 2 ciphertexts, on a key drawn
    by the port and carried into JAX, bit for bit.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fhe_study_tpu.arith.params import RingParam as JRingParam
from fhe_study_tpu.arith.params import TORUS_Q
from fhe_study_tpu.models.gfhe import glwe as JG
from fhe_study_tpu.models.tfhe import bootstrap as jboot
from fhe_study_tpu.models.tfhe import tggsw as jtggsw
from fhe_study_tpu.models.tfhe import tlwe as jtlwe
from fhe_study_tpu.ops import blind_rotate_pallas as brp

from fhe_study_tpu_torch.arith.params import RingParam
from fhe_study_tpu_torch.models.gfhe import glwe as G
from fhe_study_tpu_torch.models.tfhe import bootstrap, tglwe, tlwe
from fhe_study_tpu_torch.ops import _cuda
from fhe_study_tpu_torch.ops import blind_rotate_cuda as brc
from fhe_study_tpu_torch.ops import ntt as ntt_mod
from fhe_study_tpu_torch.ops import ntt_cuda as nc
from fhe_study_tpu_torch.utils import interop, prng
from test_torch_blind_rotate_plan import _inputs
from test_torch_radix_plan import _emulate

CPU = torch.device("cpu")
P0, P1 = ntt_mod.CRT_PRIMES_TFHE


def _shapes(logns):
    """(n, K, w, l) for every K = 0 .. 3, w >= 1 up to the widest digit
    below both primes, and l >= 1 with w l <= 64."""
    top = min(P0, P1).bit_length()
    return [(1 << logn, k, w, l) for logn in logns for k in range(4)
            for w in range(1, top + 1) for l in range(1, 64 // w + 1)]


def test_supported_equals_the_reference_up_to_n_2_15():
    """Every n from 2^7 to 2^22, where the reference's gate ends (the CRT
    pair's 2n-th roots): the port's gate is the reference's, and at each n
    the plan's layout is the one its shape takes (the split at 2^16, the
    quarter at 2^17)."""
    took = dict.fromkeys(("cluster", "device", "split", "quarter", "grid"),
                         0)
    for n, k, w, l in _shapes(range(7, 23)):
        param = SimpleNamespace(ring=SimpleNamespace(n=n), k=k)
        ref = brp.supported(param, 1 << w, l)
        assert brc.supported(param, 1 << w, l) == ref, (n, k, w, l)
        if ref:
            plan = brc._plan(k + 1, l, n)
            fits = brc._smem(k + 1, l, n, False) <= brc._SMEM_LIMIT
            assert plan.layout == ("split" if n == 1 << 16 else
                                   "quarter" if n == 1 << 17 else
                                   "grid" if n > 1 << 15 else
                                   "cluster" if fits else "device")
            took[plan.layout] += 1
    assert took["cluster"] + took["device"] > 6000
    assert took["quarter"] + took["grid"] > 1000 and took["grid"] > 800
    assert took["split"] > 600 and took["quarter"] > 200
    assert _cuda.log2_degree(1 << 22, _cuda.BLIND_ROTATE) == 22
    with pytest.raises(ValueError, match="2\\^7 .. 2\\^22"):
        _cuda.log2_degree(1 << 23, _cuda.BLIND_ROTATE)


@pytest.mark.parametrize("logn", [12, 15])
def test_device_plan_is_the_one_buffer_shape(logn):
    """At C = 2, l = 3 (past a block at 2^12): a forward block per digit
    polynomial and prime, a cluster of two inverse blocks per column, each
    at K1's block shape, the key read from device memory; the scratch of a
    ciphertext holds a step's digit evaluations under both primes."""
    n = 1 << logn
    plan = brc._plan(2, 3, n)
    radix = nc._radix_plan(logn)
    assert plan.layout == "device" and not plan.staged
    assert (plan.threads, plan.smem_bytes) == (radix.threads, 4 * n)
    assert plan.radix == radix and plan.cluster == 2
    assert plan.blocks == (2 * 6, 2 * 4)
    assert plan.scratch_bytes == 2 * 6 * n * 4
    assert brc._plan(2, 3, n, False) == plan
    assert brc._plan(2, 2, 1024).layout == "cluster"


def _device_layout(shifts, acc0, ev1, ev2, n: int, w: int):
    """The device-memory layout's schedule, launch by launch (a launch's
    blocks under one prime side by side on the one-buffer chain,
    tests/test_torch_radix_plan.py::_emulate): per step the forward blocks
    (ciphertext, digit polynomial, prime), their first pass formed from
    the rotated accumulator, into the scratch; then the inverse clusters
    (ciphertext, column) of a block per prime: block p sums the Montgomery
    products of its lanes' consecutive 16-byte words of the digit and key
    rows into its shared buffer as the forward's read-out leaves it (pass
    0 then reads each element's sum, as ``_emulate`` reads a row), runs
    the chain, n^-1 2^32 in its last pass, and lifts half p from its words
    and its peer's."""
    steps, B = shifts.shape
    C, l = acc0.shape[1], ev1.shape[2]
    F, cols = C * l, 2 * C
    logn = n.bit_length() - 1
    # thread t of a block takes words 4 (u T + t) .. + 3 of each group's
    # 16 T, u < 4: every word once
    threads = nc._radix_plan(logn).threads
    t, u, i = (torch.arange(threads)[:, None, None],
               torch.arange(4)[None, :, None], torch.arange(4)[None, None])
    off = (4 * (u * threads + t) + i).reshape(-1)
    assert torch.equal(torch.sort(off).values, torch.arange(16 * threads))
    acc = acc0.clone()                               # the output, [B, C, n]
    dig = torch.full((B, 2, F, n), -1, dtype=torch.int64)
    ev = torch.stack([ev1, ev2]).long()
    for j in range(steps):
        # forward: block (b F + f) 2 + p, digit i of component c of b
        b, f = torch.arange(B * F) // F, torch.arange(B * F) % F
        cc, i = f // l, f % l
        h = shifts[j].long()[b] % (2 * n)
        rows = acc[b, cc]                                     # [BF, n]

        def digits(addr):
            src = addr[None] + h[:, None, None]
            r = rows.gather(1, (src % n).reshape(len(b), -1)).reshape(src.shape)
            r = torch.where((src // n) % 2 == 1, -r, r)
            # bits 64 - w (i + 1) .. 64 - w i - 1 (an arithmetic shift
            # keeps them, the mask drops the rest)
            r = r - rows[:, addr]
            return (r >> (64 - w * (i + 1))[:, None, None]) & ((1 << w) - 1)

        for p in range(2):
            dig[b, p, f] = _emulate(None, (P0, P1)[p], logn, False,
                                    first=digits)
        # inverse: cluster b cols + o, block p under prime p
        res = []
        for p in range(2):
            q = (P0, P1)[p]
            key = ev[p, j].reshape(F, cols, n)
            prod = dig[:, p, :, None] * key[None] % q * pow(nc.R32, -1, q) % q
            res.append(_emulate(prod.sum(1) % q, q, logn, True,
                                fin=pow(n, -1, q) * nc.R32 % q))
        # block p lifts half p from its words and its peer's
        for p in range(2):
            idx = torch.arange(p * n // 2, (p + 1) * n // 2)
            lifted = _lift(res[0][..., idx], res[1][..., idx])  # [B, 2C, .]
            for o in range(cols):
                acc[:, o >> 1, idx] += lifted[:, o] * (1 << (32 * (o & 1)))
    return acc


def _lift(r0, r1):
    """The kernel's exact centred CRT lift of residues (r0 mod P0, r1 mod
    P1) to (-P0 P1 / 2, P0 P1 / 2]."""
    r0p = torch.where(r0 >= P1, r0 - P1, r0)          # P0 < 2 P1
    g = r0 + P0 * ((r1 - r0p) % P1 * pow(P0, -1, P1) % P1)
    return torch.where(g > P0 * P1 // 2, g - P0 * P1, g)


@pytest.mark.parametrize("B", [1, 3, 5])
@pytest.mark.parametrize("logn", [7, 8])
@pytest.mark.parametrize("C,l", [(2, 1), (2, 2), (2, 3), (3, 1), (3, 2),
                                 (3, 3)])
def test_device_layout_schedule_equals_plain(logn, C, l, B):
    n, w = 1 << logn, {1: 20, 2: 12, 3: 21}[l]
    rng = np.random.default_rng(2000 * logn + 10 * C + l + 100 * B)
    shifts, acc0, ev1, ev1s, ev2, ev2s = _inputs(rng, 2, B, C, l, n)
    want = brc.blind_rotate_plain(shifts, acc0, ev1, ev1s, ev2, ev2s, n, w)
    assert torch.equal(_device_layout(shifts, acc0, ev1, ev2, n, w), want)


# -- blind_rotation at N = 4096 against the JAX package ----------------------

N, K, T, STEPS, B = 4096, 1, 128, 8, 2
BETA, L = 1 << 11, 2


def test_blind_rotation_at_n_4096_matches_the_jax_chain():
    """The shape of configuration a: (K+1) l N beta = 2^25 passes the
    reference's gate; a block's shared memory does not hold it, so on the
    card it takes the device-memory layout."""
    P = G.Param(G.ERR_SIGMA, RingParam(TORUS_Q, N), K, T)
    JP = JG.Param(JG.ERR_SIGMA, JRingParam(TORUS_Q, N), K, T)
    assert brc.supported(P, BETA, L) and brp.supported(JP, BETA, L)
    assert brc._plan(K + 1, L, N).layout == "device"
    gen = prng.Gen(18)
    s, _ = tglwe.new_key(gen, P, CPU)
    sbtk = bootstrap.new_short_bootstrapping_key(
        gen, P, s, n_lwe=STEPS, beta=BETA, l=L, beta_ks=16, l_ks=8)
    evals = bootstrap.precompute_short_btk_evals(P, sbtk)
    rng = np.random.default_rng(18)
    i64 = np.iinfo(np.int64)
    a, b = (torch.from_numpy(rng.integers(i64.min, i64.max, shape,
                                          dtype=np.int64))
            for shape in ((B, STEPS), (B,)))
    table = bootstrap.compute_lookup_table_standard(P, CPU)
    got = bootstrap.blind_rotation(P, sbtk, table, tlwe.TLWE(a, b), BETA, L,
                                   btk_evals=evals)
    before = _cuda.launches()
    assert torch.equal(got.b, bootstrap.blind_rotation(
        P, sbtk, table, tlwe.TLWE(a, b), BETA, L, btk_evals=evals,
        fused=False).b)
    assert _cuda.launches() == before

    def jx(t):
        return jnp.asarray(interop.bits_to_numpy(t))

    jkey = jboot.ShortBootstrappingKey(*(jx(t) for t in sbtk))
    jev = jtggsw.TGGSWEvals(**{f: jx(getattr(evals, f))
                               for f in evals._fields})
    want = jax.jit(lambda k, t, c, e: jboot.blind_rotation(
        JP, k, t, c, beta=BETA, l=L, btk_evals=e, fused=False))(
            jkey, jboot.compute_lookup_table_standard(JP),
            jtlwe.TLWE(jx(a), jx(b)), jev)
    for g, w in ((got.a, want.a), (got.b, want.b)):
        np.testing.assert_array_equal(interop.bits_to_numpy(g),
                                      np.asarray(w))
