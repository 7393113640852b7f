"""Carry the JAX package's RNS-BFV, RNS-CKKS and TFHE state into the port and
back.

The JAX package's RNS-BFV ``SecretKey``, ``PublicKey``, ``RLK``, ``HRLK``,
``CT`` and ``CTE``, its RNS-CKKS ``SecretKey``, ``PublicKey`` and ``CT`` and
the ``HybridKSK`` of hybrid key switching hold u32 or u64 residue arrays;
kinds of one name are told apart by the module that defines them
(``bfv_rns`` or ``ckks_rns`` in both packages).  ``to_port`` turns one of them, given as any
NamedTuple of array-likes of the same name (``numpy.asarray`` reads a jax
array without this module importing jax), into the port's NamedTuple of int32
tensors on a given device; ``to_numpy`` turns a port tensor or NamedTuple
back into numpy u32 for comparison.  Every residue is below 2^31 (all primes
are), so the int32 bits equal the u32 ones; anything else raises.

The torus schemes' tuples (``TLWE``, ``GLWE``, ``TGGSW``, ``TGGSWEvals``,
the TLWE ``KSK``, ``BootstrappingKey``, ``ShortBootstrappingKey``) hold u64
torus words and, in ``TGGSWEvals``, u32 words that span the whole range (the
Shoup planes); the single-modulus schemes' (``bfv.SecretKey``,
``PublicKey``, ``RLK``, ``RLWE``; ``ckks.SecretKey``, ``PublicKey``, ``CT``;
the Z_q ``glwe.GLev`` and ``KSK``) hold u64 residues, the relinearization
key's above 2^31.  ``bits_to_tensor`` carries all of those bit for bit
(uint64 -> int64, uint32 -> int32, a numpy ``view``), and ``bits_to_numpy``
brings them back.

The CKKS evaluation state crosses by ``rot_keys_to_port`` (a ``RotKeys``),
``rlks_to_port`` (a per-level relinearization key dict),
``rmap_plan_to_port`` (an ``RmapPlan`` with its em) and
``boot_arrays_to_port`` (the arrays of a frozen bootstrap key set, for the
port's ``bootstrap.FrozenKeys`` beside the same static).
"""

import numpy as np
import torch

from ..models import bfv, bfv_rns, hybrid_ks
from ..models.ckks import ckks, ckks_rns
from ..models.ckks import eval as ckks_eval
from ..models.gfhe import glwe
from ..models.tfhe import bootstrap, tggsw, tlwe

def _key(kind) -> tuple:
    """(last part of the defining module, name) of a NamedTuple type: the
    same for a kind of the JAX package and its counterpart here."""
    return kind.__module__.rsplit(".", 1)[-1], kind.__name__


KINDS = {_key(k): k for k in (
    bfv_rns.SecretKey, bfv_rns.PublicKey, bfv_rns.RLK, bfv_rns.HRLK,
    bfv_rns.CT, bfv_rns.CTE, ckks_rns.SecretKey, ckks_rns.PublicKey,
    ckks_rns.CT, hybrid_ks.HybridKSK)}
# carried bit for bit: the fields are torus words, u64 residues or
# full-range u32 words
BIT_KINDS = {_key(k): k for k in (
    tlwe.TLWE, glwe.GLWE, glwe.GLev, glwe.KSK, tggsw.TGGSW, tggsw.TGGSWEvals,
    tlwe.KSK, bootstrap.BootstrappingKey, bootstrap.ShortBootstrappingKey,
    bfv.SecretKey, bfv.PublicKey, bfv.RLK, bfv.RLWE, ckks.SecretKey,
    ckks.PublicKey, ckks.CT)}
_SIGNED = {np.dtype(np.uint64): np.int64, np.dtype(np.uint32): np.int32}
_UNSIGNED = {torch.int64: np.uint64, torch.int32: np.uint32}


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


def bits_to_tensor(a, device) -> torch.Tensor:
    """uint64 (or uint32) array -> int64 (int32) tensor of the same bits."""
    a = np.array(a)                    # a writable, contiguous copy
    signed = _SIGNED.get(a.dtype)
    if signed is None:
        raise TypeError(f"bit-preserving carry takes uint64 or uint32, got "
                        f"{a.dtype}")
    return torch.from_numpy(a.view(signed)).to(device)


def bits_to_numpy(x):
    """int64 (int32) tensor -> numpy uint64 (uint32) of the same bits; a
    NamedTuple -> tuple of them."""
    if isinstance(x, torch.Tensor):
        unsigned = _UNSIGNED.get(x.dtype)
        if unsigned is None:
            raise TypeError(f"bit-preserving carry takes int64 or int32, "
                            f"got {x.dtype}")
        return x.detach().cpu().contiguous().numpy().view(unsigned)
    return tuple(bits_to_numpy(f) for f in x)


def to_port(obj, device):
    """A reference NamedTuple -> the port's of the same name and module:
    int32 residues for the RNS kinds, bit for bit for the others."""
    key = _key(type(obj))
    kind, carry = ((KINDS[key], to_tensor) if key in KINDS else
                   (BIT_KINDS.get(key), bits_to_tensor))
    if kind is None or len(obj) != len(kind._fields):
        raise TypeError(f"cannot carry {type(obj).__name__} across; known: "
                        f"{sorted('.'.join(k) for k in [*KINDS, *BIT_KINDS])}")
    return kind(*(carry(f, device) for f in obj))


def to_numpy(x):
    """Port residue tensor -> numpy u32; a NamedTuple -> tuple of them."""
    if isinstance(x, torch.Tensor):
        a = x.detach().cpu().numpy()
        if a.size and int(a.min()) < 0:
            raise ValueError("negative value in a residue tensor")
        return a.astype(np.uint32)
    return tuple(to_numpy(f) for f in x)


def rot_keys_to_port(rk, device) -> "ckks_eval.RotKeys":
    """A reference ``eval.RotKeys`` ((L, g) -> HybridKSK) -> the port's."""
    return ckks_eval.RotKeys({lg: to_port(k, device)
                              for lg, k in rk.keys.items()})


def rlks_to_port(rlks: dict, device) -> dict:
    """A per-level relinearization key dict (``poly.rlk_keys_all_levels``)
    -> the same dict of the port's HybridKSK."""
    return {L: to_port(k, device) for L, k in rlks.items()}


def rmap_plan_to_port(plan, device) -> "ckks_eval.RmapPlan":
    """A reference ``eval.RmapPlan`` -> the port's, its em (u32
    [L, num + 1, n]) as int32 on ``device``; the host tables and the
    integer source of em are carried as they are."""
    out = ckks_eval.RmapPlan(plan.n1, set(plan.need_d), set(plan.need_e),
                             plan.maps, to_tensor(plan.em, device),
                             plan.pt_levels)
    out.src_m, out.src_L = np.asarray(plan.src_m), plan.src_L
    return out


def boot_arrays_to_port(arrays, device) -> dict:
    """The arrays of a reference bootstrap key set (``bootstrap.freeze`` or
    ``precompute_keys``: relinearization keys by level, Galois keys by
    (level, element), plan em by plan key) -> the same dicts of the port's
    HybridKSK and int32 em on ``device``.  The static half is plain Python
    and serves both packages as it is."""
    return {"rlk": rlks_to_port(arrays["rlk"], device),
            "rot": {lg: to_port(k, device)
                    for lg, k in arrays["rot"].items()},
            "em": {k: to_tensor(em, device)
                   for k, em in arrays["em"].items()}}
