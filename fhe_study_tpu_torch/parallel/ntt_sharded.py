"""Coefficient-sharded negacyclic NTT / polynomial multiply (four-step) —
the counterpart of fhe_study_tpu/parallel/ntt_sharded.py.

The ring degree n is sharded across the ``sp`` mesh axis and the NTT runs as
the four-step decomposition n = n1·n2:

    negacyclic twist (psi^j, local)
    -> column NTT of size n2 (local, root w^{n1})
    -> twiddle w^{j1·k2} (local)
    -> tile exchange (comm.all_to_all)                 <- the only comm
    -> row NTT of size n1 (local, root w^{n2})

Pointwise products happen in the transformed (k2-sharded) layout; the
inverse mirrors the pipeline.  One all_to_all each way.

Layout convention, as the reference's: a polynomial a_j (j = j1 + n1*j2) is
the row-major matrix A[j2, j1] = a.reshape(n2, n1); the LAST axis (j1, size
n1) is cut into S column slabs.  The transform leaves B[k2, k1] =
â_{k2 + n2·k1} with the k2 axis (size n2) cut into S row slabs.  Each rank
works on its slab; ``negacyclic_mul_sharded`` takes and returns global
tensors.  The local transforms are ops/ntt.py's ``ntt_cyclic`` /
``intt_cyclic`` and ``modops.mulmod``: plain torch on every device, as XLA
is in the reference.
"""

from functools import lru_cache

import numpy as np
import torch

from ..ops import modops, ntt
from . import comm, mesh as mesh_mod


@lru_cache(maxsize=None)
def _four_step_consts(q: int, n: int, n1: int):
    """Host-precomputed twist/twiddle tables for the n = n1*n2 split
    (numpy uint64, as the reference's)."""
    n2 = n // n1
    psi = ntt.get_plan(q, n).root          # primitive 2n-th root
    w = pow(psi, 2, q)                     # primitive n-th root
    psi_pows = np.array([pow(psi, i, q) for i in range(n)], np.uint64)
    psi_inv = pow(psi, q - 2, q)
    psi_inv_pows = np.array([pow(psi_inv, i, q) for i in range(n)],
                            np.uint64)
    twist = psi_pows.reshape(n2, n1)       # psi^{j1 + n1*j2}
    untwist = psi_inv_pows.reshape(n2, n1)
    # twiddle w^{j1*k2}: [n2 (k2), n1 (j1)]
    tw = np.array([[pow(w, a * b, q) for b in range(n1)] for a in range(n2)],
                  np.uint64)
    w_inv = pow(w, q - 2, q)
    tw_inv = np.array([[pow(w_inv, a * b, q) for b in range(n1)]
                       for a in range(n2)], np.uint64)
    return (twist, untwist, tw, tw_inv, w, pow(w, n2, q), pow(w, n1, q))


def _fwd_local(x, tw_slab, q, mesh, axis, w_n1, w_n2, twist_slab):
    """local [.., n2, n1/S] column slab -> [.., n2/S, n1] row slab."""
    x = modops.mulmod(x, twist_slab, q)                    # negacyclic twist
    x = x.movedim(-2, -1)                                  # [.., c, n2]
    x = ntt.ntt_cyclic(x, q, w_n1)                         # col NTT (size n2)
    x = x.movedim(-1, -2)                                  # [.., n2, c]
    x = modops.mulmod(x, tw_slab, q)                       # twiddle
    x = comm.all_to_all(x, mesh, axis, split_dim=x.dim() - 2,
                        concat_dim=x.dim() - 1)
    # received: [.., n2/S, c*S = n1]
    return ntt.ntt_cyclic(x, q, w_n2)                      # row NTT (size n1)


def _inv_local(x, tw_inv_slab, q, mesh, axis, w_n1, w_n2, untwist_slab):
    """inverse: local [.., n2/S, n1] row slab -> [.., n2, n1/S]."""
    x = ntt.intt_cyclic(x, q, w_n2)                        # row INTT
    x = modops.mulmod(x, tw_inv_slab, q)                   # inverse twiddle
    x = comm.all_to_all(x, mesh, axis, split_dim=x.dim() - 1,
                        concat_dim=x.dim() - 2)
    # received: [.., n2, c]
    x = x.movedim(-2, -1)
    x = ntt.intt_cyclic(x, q, w_n1)                        # col INTT
    x = x.movedim(-1, -2)
    return modops.mulmod(x, untwist_slab, q)               # untwist


def split_n1(n: int, S: int) -> int:
    """n1: a multiple of S near sqrt(n) (both factors must divide by S)."""
    n1 = S
    while n1 * n1 < n:
        n1 *= 2
    if n1 % S or (n // n1) % S:
        raise ValueError(f"n={n} does not split four-step over {S} ranks")
    return n1


def negacyclic_mul_sharded(a, b, q: int, mesh, axis: str = "sp"):
    """Ring product in Z_q[X]/(X^n+1) with the coefficient axis sharded over
    ``axis``.  a, b: global int64 [..., n] in [0, q) (any batch dims, the
    same on every rank); returns the global product."""
    n = a.shape[-1]
    S = comm.axis_size(mesh, axis)
    n1 = split_n1(n, S)
    n2 = n // n1
    twist, untwist, tw, tw_inv, w, w_n2, w_n1 = _four_step_consts(q, n, n1)
    # NOTE: w_n2 = w^{n2} (order n1, used for ROW transforms of size n1);
    #       w_n1 = w^{n1} (order n2, used for COLUMN transforms of size n2).

    def col(t):                  # [.., n2, n1] -> this rank's [.., n2, n1/S]
        return mesh_mod.shard(t, mesh, axis, -1)

    def const(t):
        return torch.from_numpy(t.astype(np.int64)).to(a.device)

    batch = tuple(a.shape[:-1])
    A = col(a.long().reshape(batch + (n2, n1)))
    B = col(b.long().reshape(batch + (n2, n1)))
    twist_s, tw_s, untwist_s = (col(const(t)) for t in (twist, tw, untwist))
    tw_inv_s = mesh_mod.shard(const(tw_inv), mesh, axis, 0)
    ea = _fwd_local(A, tw_s, q, mesh, axis, w_n1, w_n2, twist_s)
    eb = _fwd_local(B, tw_s, q, mesh, axis, w_n1, w_n2, twist_s)
    ec = modops.mulmod(ea, eb, q)
    out = _inv_local(ec, tw_inv_s, q, mesh, axis, w_n1, w_n2, untwist_s)
    return mesh_mod.unshard(out, mesh, axis, -1).reshape(batch + (n,))
