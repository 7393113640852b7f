"""BFV SIMD batching: pack 2 x n/2 plaintext slots into one ciphertext — the
counterpart of fhe_study_tpu/models/bfv_batch.py.

For a plaintext modulus t that is prime with t = 1 (mod 2n),
Z_t[X]/(X^n+1) splits by CRT into n copies of Z_t; homomorphic add/mul become
slot-wise SIMD ops and Galois automorphisms become slot rotations
(galois.py).

Slot layout (SEAL BatchEncoder semantics): a [2, n/2] matrix.  Slot (r, j)
is the evaluation of m at psi^{E(r,j)} with E(0,j) = 5^j mod 2n and
E(1,j) = -5^j mod 2n.  Then:
  * phi_{5^k}  : both rows rotate LEFT by k   (galois.rotation_element)
  * phi_{2n-1} : the rows swap                (galois.conj_element)

Encode and decode ride the single-prime negacyclic transform over q = t
(ops/ntt.ntt / intt, K9 on the card): one transform plus a static
permutation.
"""

from functools import lru_cache

import numpy as np
import torch

from ..ops import ntt as ntt_mod
from .galois import _np_ntt_ref


@lru_cache(maxsize=None)
def _slot_maps(t: int, n: int):
    """(enc_perm, dec_perm): static permutations between the transform's
    output order and the [2, n/2] slot matrix (row-major flattened).

    dec_perm[s] = output position holding slot s;
    enc_perm[i] = slot index stored at output position i."""
    if (t - 1) % (2 * n):
        raise ValueError(f"t={t} must be 1 mod 2n for batching")
    # exponent of the evaluation point at each output position, by
    # evaluating the transform of X (whose value at psi^e is psi^e) and
    # taking discrete logs against the 2n-th root psi
    plan = ntt_mod.get_plan(t, n)
    psi = plan.root
    x = np.zeros(n, dtype=object)
    x[1] = 1
    evals = _np_ntt_ref(x, plan)
    dlog = {}
    acc = 1
    for e in range(2 * n):
        dlog[acc] = e
        acc = acc * psi % t
    exp_at = np.array([dlog[int(v)] for v in evals], np.int64)  # [n]
    pos_of_exp = {int(e): i for i, e in enumerate(exp_at)}
    dec = np.zeros(n, np.int32)
    for j in range(n // 2):
        e = pow(5, j, 2 * n)
        dec[j] = pos_of_exp[e]                   # row 0
        dec[n // 2 + j] = pos_of_exp[2 * n - e]  # row 1
    enc = np.zeros(n, np.int32)
    enc[dec] = np.arange(n, dtype=np.int32)
    return enc, dec


@lru_cache(maxsize=None)
def _slot_maps_on(t: int, n: int, device):
    return tuple(torch.from_numpy(p.astype(np.int64)).to(device)
                 for p in _slot_maps(t, n))


def batch_encode(t: int, n: int, slots):
    """slots: integer tensor [..., 2, n/2] (values mod t) -> coefficients
    [..., n] int64 in [0, t)."""
    enc, _ = _slot_maps_on(t, n, slots.device)
    flat = torch.remainder(slots.long().reshape(slots.shape[:-2] + (n,)), t)
    return ntt_mod.intt(flat.index_select(-1, enc), t)


def batch_decode(t: int, n: int, m):
    """coefficients [..., n] (mod t) -> slots [..., 2, n/2] int64."""
    _, dec = _slot_maps_on(t, n, m.device)
    evals = ntt_mod.ntt(torch.remainder(m.long(), t), t)
    return evals.index_select(-1, dec).reshape(m.shape[:-1] + (2, n // 2))
