"""Samplers for keys, masks and noise on an explicit generator, ``Gen``.

They draw the distributions of fhe_study_tpu/utils/prng.py (the streams
differ: threefry there, numpy's PCG64 here):

  * binary: uniform bits {0, 1};
  * ternary: round-half-away of U[-1, 1), i.e. {-1, 0, 1} with probabilities
    (.25, .5, .25), the reference's distribution;
  * sparse_ternary: exactly h nonzeros with random signs on the last axis;
  * gaussian_int: Normal(0, sigma) in float64, rounded half away from zero;
    gaussian_mod: the same reduced into [0, q);
  * uniform_mod / uniform_mod_multi: uniform residues in [0, q), q < 2^63;
  * uniform_u64: uniform over the whole torus, as int64 holding the u64 bits;
  * gaussian_torus: gaussian_int wrapped mod 2^64 (the int64 value is
    already the two's-complement bits).

A ``Gen`` is a numpy PCG64 stream keyed by every bit of a non-negative int
seed (numpy's SeedSequence takes the whole int), so no two seeds share a
stream.  It is stateful: each draw moves it on, so the order of the draws
on one generator is part of what they give.  Every draw is made on the host
and lands on ``device``, so one seed gives the same numbers whatever card
the data goes to.  The one exception is ``device_residues``, which draws
kernel operands for timing on the card with torch's generator there.

Seeds: ``split`` draws 63-bit child seeds from a generator (the order of
calls matters); ``derive_seed`` is the order-free counterpart of the
reference's ``jax.random.fold_in`` chains: a keyed hash of a master seed and
a tuple of labels, so a key set built lazily in any order gets the same
subkeys (models/ckks/bootstrap.py draws each key's mask and noise from
``Gen(seed)`` of such seeds).
"""

import hashlib
import json

import numpy as np
import torch

from .rounding import round_half_away


class Gen:
    """A stream of random draws: numpy's PCG64 keyed by all bits of
    ``seed``, a non-negative int."""

    def __init__(self, seed: int):
        if not isinstance(seed, (int, np.integer)) or seed < 0:
            raise ValueError(f"seed must be a non-negative int, got {seed!r}")
        self.seed = int(seed)
        self.rng = np.random.Generator(np.random.PCG64(self.seed))

    def __repr__(self) -> str:
        return f"Gen({self.seed})"


def _to(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


def uniform_mod(gen: Gen, shape, q: int, device):
    """Uniform over [0, q) as int64 (q < 2^63)."""
    return _to(gen.rng.integers(0, q, tuple(shape), dtype=np.int64), device)


def uniform_mod_multi(gen: Gen, shape, qs: tuple, device):
    """Uniform residues over a prime basis (each q < 2^31): int32
    [len(qs), *shape], drawn prime by prime as int32 on the host (the same
    numbers as int64 draws) and copied to ``device`` once."""
    return _to(np.stack([gen.rng.integers(0, q, tuple(shape), dtype=np.int32)
                         for q in qs]), device)


def device_residues(seed: int, device):
    """A drawer of kernel operands made on the card: (primes, shape) ->
    int32 [len(primes), *shape] uniform residues (up to a bias of 2^-32),
    from torch's generator on ``device`` seeded with ``seed``.  Its stream
    is the card's, not a ``Gen``'s: it draws the operands that
    utils/kernel_check.py times at full batch (gigabytes at n = 2^15, tens
    of seconds on the host), and never a key, a mask or noise."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def res(primes, shape):
        qv = torch.tensor(primes, dtype=torch.int64, device=device)
        raw = torch.randint(0, 1 << 62, (len(primes), *shape), generator=g,
                            device=device, dtype=torch.int64)
        return (raw % qv.view(-1, *([1] * len(shape)))).int()
    return res


def binary(gen: Gen, shape, device):
    """Uniform bits {0, 1} as int64."""
    return uniform_mod(gen, shape, 2, device)


def ternary(gen: Gen, shape, device):
    """{-1, 0, 1} with probabilities (.25, .5, .25), as int64."""
    u = torch.from_numpy(gen.rng.random(tuple(shape))) * 2.0 - 1.0
    return round_half_away(u).long().to(device)


def sparse_ternary(gen: Gen, shape, h: int, device):
    """{-1, 0, 1} with EXACTLY h nonzeros (random signs) along the last axis,
    as int64: the sparse-secret distribution of the CKKS bootstrapping
    literature (Hamming weight h, typically 64)."""
    n = shape[-1]
    if not 0 < h <= n:
        raise ValueError(f"Hamming weight h={h} outside 1 .. n={n}")
    k_perm, k_sign = split(gen, 2)
    # the ranks of uniform draws are a uniform permutation of each row, so
    # exactly h of them lie below h
    perm = torch.from_numpy(k_perm.rng.random(tuple(shape))).argsort(dim=-1)
    signs = 2 * uniform_mod(k_sign, shape, 2, "cpu") - 1
    return torch.where(perm < h, signs, torch.zeros_like(signs)).to(device)


def gaussian_int(gen: Gen, shape, sigma: float, device):
    """Normal(0, sigma) rounded to the nearest integer (int64)."""
    g = sigma * torch.from_numpy(gen.rng.standard_normal(tuple(shape)))
    return round_half_away(g).long().to(device)


def gaussian_mod(gen: Gen, shape, sigma: float, q: int, device):
    """Rounded gaussian reduced into [0, q) (int64)."""
    return torch.remainder(gaussian_int(gen, shape, sigma, device), q)


def uniform_u64(gen: Gen, shape, device):
    """Uniform over the full u64 range, as the int64 of the same bits."""
    a = gen.rng.integers(0, 1 << 64, tuple(shape), dtype=np.uint64)
    return _to(a.view(np.int64), device)


def gaussian_torus(gen: Gen, shape, sigma: float, device):
    """Rounded gaussian wrapped mod 2^64 (torus noise), int64 bits."""
    return gaussian_int(gen, shape, sigma, device)


def split(gen: Gen, n: int) -> list:
    """n generators keyed by 63-bit seeds drawn from gen."""
    return [Gen(int(s)) for s in gen.rng.integers(0, 1 << 63, n,
                                                  dtype=np.int64)]


def derive_seed(master: int, tag: str, *labels: int) -> int:
    """A 63-bit seed: BLAKE2b keyed with ``master`` over the JSON text of
    [tag, *labels].  That text differs for any two label tuples, so two
    distinct (tag, labels) meet only by a hash collision (the reference's
    two chained fold_ins give the same injectivity in (L, g))."""
    if not 0 <= master < 1 << 256:
        raise ValueError(f"master seed must lie in [0, 2^256), got {master}")
    msg = json.dumps([tag, *(int(x) for x in labels)]).encode()
    h = hashlib.blake2b(msg, key=master.to_bytes(32, "little"),
                        digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1
