"""Carry the JAX package's RNS-BFV state into the port and back.

The JAX package's ``SecretKey``, ``PublicKey``, ``RLK``, ``HRLK``, ``CT`` and
``CTE`` hold u32 or u64 residue arrays.  ``to_port`` turns one of them, given as any
NamedTuple of array-likes of the same name (``numpy.asarray`` reads a jax
array without this module importing jax), into the port's NamedTuple of int32
tensors on a given device; ``to_numpy`` turns a port tensor or NamedTuple
back into numpy u32 for comparison.  Every residue is below 2^31 (all primes
are), so the int32 bits equal the u32 ones; anything else raises.
"""

import numpy as np
import torch

from ..models import bfv_rns

KINDS = {k.__name__: k for k in (bfv_rns.SecretKey, bfv_rns.PublicKey,
                                 bfv_rns.RLK, bfv_rns.HRLK, bfv_rns.CT,
                                 bfv_rns.CTE)}


def to_tensor(a, device) -> torch.Tensor:
    """Unsigned or signed integer array with values in [0, 2^31) -> int32
    tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.kind not in "ui":
        raise TypeError(f"residues must be integers, got {a.dtype}")
    if a.size and (int(a.min()) < 0 or int(a.max()) >= 1 << 31):
        raise ValueError("residues must lie in [0, 2^31)")
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.int32))
                            ).to(device)


def to_port(obj, device):
    """A reference SecretKey/PublicKey/RLK/HRLK/CT/CTE -> the port's."""
    kind = KINDS.get(type(obj).__name__)
    if kind is None or len(obj) != len(kind._fields):
        raise TypeError(f"cannot carry {type(obj).__name__} across; "
                        f"known: {sorted(KINDS)}")
    return kind(*(to_tensor(f, device) for f in obj))


def to_numpy(x):
    """Port residue tensor -> numpy u32; a NamedTuple -> tuple of them."""
    if isinstance(x, torch.Tensor):
        a = x.detach().cpu().numpy()
        if a.size and int(a.min()) < 0:
            raise ValueError("negative value in a residue tensor")
        return a.astype(np.uint32)
    return tuple(to_numpy(f) for f in x)
