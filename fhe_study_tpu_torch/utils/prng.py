"""Samplers for keys, masks and noise on an explicit ``torch.Generator``.

They draw the distributions of fhe_study_tpu/utils/prng.py (the streams
differ: threefry there, the generator's own here):

  * binary: uniform bits {0, 1};
  * ternary: round-half-away of U[-1, 1), i.e. {-1, 0, 1} with probabilities
    (.25, .5, .25), the reference's distribution;
  * sparse_ternary: exactly h nonzeros with random signs on the last axis;
  * gaussian_int: Normal(0, sigma) in float64, rounded half away from zero;
  * uniform_mod / uniform_mod_multi: uniform residues in [0, q);
  * uniform_u64: uniform over the whole torus, as int64 holding the u64 bits
    (two 32-bit draws, high and low);
  * gaussian_torus: gaussian_int wrapped mod 2^64 (the int64 value is
    already the two's-complement bits).

Draws happen on the generator's device and land on ``device``; so a CPU
generator gives the same numbers whatever card the data goes to.

Seeds: ``split`` draws child seeds from a generator (the order of calls
matters); ``derive_seed`` is the order-free counterpart of the reference's
``jax.random.fold_in`` chains: a keyed hash of a master seed and a tuple of
labels, so a key set built lazily in any order gets the same subkeys.

A torch CPU generator keeps only the low 32 bits of its seed (mt19937's
seeding), so whatever a ``torch.Generator`` draws has at most 2^32 streams.
The ``seeded_*`` samplers draw from a numpy PCG64 stream keyed by every bit
of an int seed instead: the per-key mask and noise of a seeded key set
(models/ckks/bootstrap.py), whose mask seeds are shipped and must not let
anyone search for the noise seed.
"""

import hashlib
import json

import numpy as np
import torch

from .rounding import round_half_away


def uniform_mod(gen: torch.Generator, shape, q: int, device):
    """Uniform over [0, q) as int64."""
    return torch.randint(0, q, tuple(shape), generator=gen,
                         dtype=torch.int64, device=gen.device).to(device)


def uniform_mod_multi(gen: torch.Generator, shape, qs: tuple, device):
    """Uniform residues over a prime basis: int32 [len(qs), *shape]."""
    return torch.stack([uniform_mod(gen, shape, q, device) for q in qs]).int()


def binary(gen: torch.Generator, shape, device):
    """Uniform bits {0, 1} as int64."""
    return uniform_mod(gen, shape, 2, device)


def ternary(gen: torch.Generator, shape, device):
    """{-1, 0, 1} with probabilities (.25, .5, .25), as int64."""
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float64,
                   device=gen.device) * 2.0 - 1.0
    return round_half_away(u).long().to(device)


def sparse_ternary(gen: torch.Generator, shape, h: int, device):
    """{-1, 0, 1} with EXACTLY h nonzeros (random signs) along the last axis,
    as int64: the sparse-secret distribution of the CKKS bootstrapping
    literature (Hamming weight h, typically 64)."""
    n = shape[-1]
    if not 0 < h <= n:
        raise ValueError(f"Hamming weight h={h} outside 1 .. n={n}")
    k_perm, k_sign = split(gen, 2)
    # the ranks of uniform draws are a uniform permutation of each row, so
    # exactly h of them lie below h
    perm = torch.rand(tuple(shape), generator=k_perm, dtype=torch.float64,
                      device=gen.device).argsort(dim=-1)
    signs = 2 * uniform_mod(k_sign, shape, 2, gen.device) - 1
    return torch.where(perm < h, signs, torch.zeros_like(signs)).to(device)


def gaussian_int(gen: torch.Generator, shape, sigma: float, device):
    """Normal(0, sigma) rounded to the nearest integer (int64)."""
    g = sigma * torch.randn(tuple(shape), generator=gen, dtype=torch.float64,
                            device=gen.device)
    return round_half_away(g).long().to(device)


def uniform_u64(gen: torch.Generator, shape, device):
    """Uniform over the full u64 range, as the int64 of the same bits."""
    hi, lo = (torch.randint(0, 1 << 32, tuple(shape), generator=gen,
                            dtype=torch.int64, device=gen.device)
              for _ in range(2))
    return (hi * (1 << 32) + lo).to(device)   # the multiply wraps, as u64 does


def gaussian_torus(gen: torch.Generator, shape, sigma: float, device):
    """Rounded gaussian wrapped mod 2^64 (torus noise), int64 bits."""
    return gaussian_int(gen, shape, sigma, device)


def split(gen: torch.Generator, n: int) -> list:
    """n independent generators on gen's device, seeded from gen."""
    seeds = torch.randint(0, 1 << 62, (n,), generator=gen,
                          dtype=torch.int64, device=gen.device).tolist()
    out = []
    for s in seeds:
        g = torch.Generator(device=gen.device)
        g.manual_seed(s)
        out.append(g)
    return out


def _wide(seed: int) -> np.random.Generator:
    # SeedSequence takes every bit of the int: no two seeds share a stream
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return np.random.Generator(np.random.PCG64(seed))


def seeded_uniform_mod_multi(seed: int, shape, qs: tuple, device):
    """uniform_mod_multi on the stream of ``seed`` (all its bits), drawn on
    the host: the same residues whatever device they land on."""
    rng = _wide(seed)
    return torch.stack([torch.from_numpy(rng.integers(0, q, tuple(shape),
                                                      dtype=np.int64))
                        for q in qs]).int().to(device)


def seeded_gaussian_int(seed: int, shape, sigma: float, device):
    """gaussian_int on the stream of ``seed`` (all its bits)."""
    g = sigma * torch.from_numpy(_wide(seed).standard_normal(tuple(shape)))
    return round_half_away(g).long().to(device)


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
