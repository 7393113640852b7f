"""The graft entry point on the port — the counterpart of
``__graft_entry__.entry``: the flagship model, a batched BFV ciphertext x
ciphertext multiply with relinearization on the device path (``fast=True``).

The configuration is the reference's: q = 2^16 + 1, n = 1024, t = 4,
p = q^2, a batch of 4 ciphertexts, keys and messages from one seed.  Its
multiply runs 48 single-prime transforms of [4, 1024] (K9 on the card).
At this q the noise of one multiply exceeds Delta/2, so the product does
not decrypt; the reference behaves the same, and ``setup`` hands the keys
and messages out for the noise probe (models/bfv_noise.py).

    fn, args = entry("cuda")      # the card is the default
    c0, c1 = fn(*args)

``dryrun_multichip(n_devices)`` is the counterpart of
``__graft_entry__.dryrun_multichip``: parallel/pipeline.py's ``dryrun`` in
n_devices ranks (parallel/launch.py), the dp/ep/sp/tp step and the
sharded BFV, TFHE and CKKS stages, each bit-equal to the unsharded call and
decrypt-verified.
"""

from typing import NamedTuple

import torch

from .arith.params import RingParam
from .models import bfv
from .utils import prng

Q = 2 ** 16 + 1
N, T, BATCH = 1024, 4, 4


class Setup(NamedTuple):
    param: bfv.Param
    sk: bfv.SecretKey
    pk: bfv.PublicKey
    rlk: bfv.RLK
    m: torch.Tensor          # [batch, n] in [0, t), encrypted twice
    c1: bfv.RLWE
    c2: bfv.RLWE


def setup(device="cuda", n: int = N, batch: int = BATCH) -> Setup:
    """The entry's keys, message and two ciphertexts on ``device``, from
    seed 0 (the reference fixes PRNGKey(0))."""
    device = torch.device(device)
    param = bfv.Param(RingParam(Q, n), T, Q * Q)
    ks = prng.split(prng.Gen(0), 6)
    sk, pk = bfv.new_key(ks[0], param, device, batch=(batch,))
    rlk = bfv.rlk_key(ks[1], param, sk, batch=(batch,))
    m = prng.uniform_mod(ks[2], (batch, n), T, device)
    c1 = bfv.encrypt(ks[3], param, pk, m, batch=(batch,))
    c2 = bfv.encrypt(ks[4], param, pk, m, batch=(batch,))
    return Setup(param, sk, pk, rlk, m, c1, c2)


def multiply(param: bfv.Param):
    """The entry's function of six tensors: (c1, c2, rlk) -> the product."""
    def fn(c1_c0, c1_c1, c2_c0, c2_c1, r0, r1):
        out = bfv.mul(param, bfv.RLK(r0, r1), bfv.RLWE(c1_c0, c1_c1),
                      bfv.RLWE(c2_c0, c2_c1), fast=True)
        return out.c0, out.c1
    return fn


def entry(device="cuda", n: int = N, batch: int = BATCH):
    """(fn, example_args), the arguments built on ``device``."""
    s = setup(device, n, batch)
    return multiply(s.param), (s.c1.c0, s.c1.c1, s.c2.c0, s.c2.c1, s.rlk.r0,
                               s.rlk.r1)


def dryrun_multichip(n_devices: int, device="cuda", backend=None,
                     timeout_s: float = 600.0,
                     full_width: tuple | None = None) -> list:
    """``pipeline.dryrun`` in ``n_devices`` ranks; returns each rank's
    report.  ``backend`` None: NCCL on CUDA (one card a rank), gloo on the
    CPU; several ranks on one card take ``backend="gloo"``.
    ``full_width`` = (n, L, M, t, B, seed) adds the full-width paths."""
    from .parallel import launch, pipeline
    return launch.spawn(pipeline.dryrun, n_devices, str(device), backend,
                        timeout_s, (n_devices, str(device), full_width))
