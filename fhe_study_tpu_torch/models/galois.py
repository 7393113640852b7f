"""Galois automorphisms and rotation keys for the RNS schemes — the
counterpart of fhe_study_tpu/models/galois.py.

For odd g coprime to 2n, phi_g(m)(X) = m(X^g) mod (X^n + 1) is a static
gather with a sign mask on coefficients, and a pure permutation of the
evaluation points zeta^e -> zeta^{g e}.  Applying phi_g to both components of
an RLWE pair gives an encryption of phi_g(m) under phi_g(s); a key switch
with a key that encrypts phi_g(s) under s completes the rotation.  The same
for RNS-BFV and RNS-CKKS (both are RLWE pairs over one limb layout).

The maps are computed on the host once per (n, g) and cached; the gathers
are plain torch (``index_select`` + ``where``) on the tensor's device, as
they are plain XLA in the reference.
"""

from functools import lru_cache

import numpy as np
import torch

from ..ops.ntt import _qvec, get_plan, intt_multi, ntt_multi
from ..ops.primes import ntt_primes
from ..utils import prng
from . import bfv_rns


@lru_cache(maxsize=None)
def galois_map(n: int, g: int):
    """Gather map for phi_g over Z[X]/(X^n+1): out[j] = sign[j] * in[src[j]].

    Coefficient i of the input lands at X^{i*g mod 2n}; exponents >= n fold
    negacyclically to (e - n, negated).  g must be odd (coprime to 2n), which
    makes i -> (i*g mod 2n) mod n a bijection on [0, n)."""
    if g % 2 != 1:
        raise ValueError(f"Galois element {g} must be odd (coprime to 2n)")
    g = g % (2 * n)
    ginv = pow(g, -1, 2 * n)
    j = np.arange(n)
    i0 = (j * ginv) % (2 * n)
    neg = i0 >= n
    src = np.where(neg, i0 - n, i0).astype(np.int32)
    return src, neg


@lru_cache(maxsize=None)
def _map_on(n: int, g: int, device):
    """galois_map as (int64 index, bool mask) tensors on ``device``."""
    src, neg = galois_map(n, g)
    return (torch.from_numpy(src.astype(np.int64)).to(device),
            torch.from_numpy(neg).to(device))


def _np_ntt_ref(x, plan):
    """Numpy mirror of ops.ntt's forward butterfly on Python integers
    (host-side precompute only)."""
    q = plan.q
    n = plan.n
    r = x.astype(object).copy()          # python ints: exact mod-q products
    roots = plan.roots
    t, m = n // 2, 1
    while m < n:
        r = r.reshape(-1, m, 2, t)
        u = r[:, :, 0, :]
        s = roots[m:2 * m].astype(object)
        v = (r[:, :, 1, :] * s[None, :, None]) % q
        r = np.stack([(u + v) % q, (u - v) % q], axis=2)
        t //= 2
        m *= 2
    return r.reshape(n)


@lru_cache(maxsize=None)
def _eval_exponents(n: int):
    """e_j (odd, mod 2n) with NTT(x)[j] = x(w^{e_j}) for the package's root
    ordering.  Prime-independent: every NttPlan uses the same bit-reversed
    exponent schedule; computed by discrete-logging the transform of the
    monomial X on one small plan."""
    q = ntt_primes(1, 30, 2 * n)[0]
    plan = get_plan(q, n)
    x = np.zeros(n, np.uint64)
    x[1] = 1
    v = _np_ntt_ref(x, plan)
    dlog = {pow(plan.root, k, q): k for k in range(2 * n)}
    return np.array([dlog[int(vj)] for vj in v], np.int64)


@lru_cache(maxsize=None)
def eval_perm(n: int, g: int):
    """pi (int32 [n]) with NTT(phi_g(x)) = NTT(x)[pi]: phi_g is a pure
    permutation in the evaluation domain (x(w^e) -> x(w^{g e}); the odd
    exponents mod 2n are closed under multiplication by odd g)."""
    e = _eval_exponents(n)
    pos = {int(ej): j for j, ej in enumerate(e)}
    return np.array([pos[(g * int(ej)) % (2 * n)] for ej in e], np.int32)


@lru_cache(maxsize=None)
def eval_perm_on(n: int, g: int, device):
    """eval_perm as an int64 index tensor on ``device``."""
    return torch.from_numpy(eval_perm(n, g).astype(np.int64)).to(device)


def apply_galois_tab(x, src, neg, qs: tuple):
    """phi on residue tensors [L, ..., n] from its table operands (src [n]
    int64 index, neg [n] bool)."""
    qv = _qvec(qs, x.ndim, x.device)
    y = x.index_select(-1, src)
    return torch.where(neg & (y != 0), (qv - y).to(x.dtype), y)


def apply_galois(x, g: int, qs: tuple):
    """phi_g on residue tensors [L, ..., n] (mod q_i per limb)."""
    return apply_galois_tab(x, *_map_on(x.shape[-1], g, x.device), qs)


def apply_galois_i64(x, g: int):
    """phi_g on signed integer coefficient tensors [..., n] (plaintext
    side)."""
    src, neg = _map_on(x.shape[-1], g, x.device)
    y = x.long().index_select(-1, src)
    return torch.where(neg, -y, y)


def _rotated_key(param, sk, g: int) -> "bfv_rns.SecretKey":
    qs, L = param.qs, param.L
    s_coeffs = intt_multi(sk.s_evals[:L].contiguous(), qs)
    return bfv_rns.SecretKey(ntt_multi(apply_galois(s_coeffs, g, qs), qs))


def galois_key_with(param, sk, g: int, a, e) -> "bfv_rns.RLK":
    """Galois key from its draws (a [L_rows, L_primes, n] uniform residues,
    e [L_rows, n] signed noise, as bfv_rns.ksk_key_with takes them)."""
    return bfv_rns.ksk_key_with(
        param, _rotated_key(param, sk, g),
        bfv_rns.SecretKey(sk.s_evals[:param.L]), a, e)


def galois_key(gen: prng.Gen, param, sk, g: int) -> "bfv_rns.RLK":
    """Key-switching key phi_g(s) -> s (a "Galois key").

    ``param`` needs .qs/.L/.n (bfv_rns.RnsParam and ckks_rns.Param both fit);
    ``sk`` needs .s_evals [>=L, ..., n]."""
    return bfv_rns.ksk_key(gen, param, _rotated_key(param, sk, g),
                           bfv_rns.SecretKey(sk.s_evals[:param.L]))


def apply_to_ct(param, gk, ct, g: int):
    """Rotate a ciphertext: phi_g on both components, then key switch back
    under the original key.  Returns the same CT type as the input."""
    qs = param.qs
    c0 = apply_galois(ct.c0, g, qs)
    c1 = apply_galois(ct.c1, g, qs)
    out = bfv_rns.key_switch(param, gk, bfv_rns.CT(c0, c1))
    return type(ct)(out.c0, out.c1)


def conj_element(n: int) -> int:
    """g = 2n - 1: complex conjugation (CKKS) / row swap (BFV batching)."""
    return 2 * n - 1


def rotation_element(n: int, k: int) -> int:
    """g = 5^k mod 2n: rotation by k slots in the orbit-of-5 slot order."""
    return pow(5, k % (n // 2), 2 * n)


@lru_cache(maxsize=None)
def ckks_slot_perm(n: int, g: int):
    """Effect of phi_g on the device encoder's natural slot order
    (encoder_device: slot j = m(zeta^{2j+1}), zeta = e^{i pi/n}).

    Returns (perm [n/2] int32, conj [n/2] bool):
      decode(phi_g(ct))[j] = conj?(decode(ct)[perm[j]])
    (m has real coefficients, so the value at zeta^{-e} is the conjugate of
    the value at zeta^{e})."""
    half = n // 2
    e = (g * (2 * np.arange(half, dtype=np.int64) + 1)) % (2 * n)
    conj = e >= n
    perm = np.where(conj, (2 * n - e - 1) // 2, (e - 1) // 2).astype(np.int32)
    return perm, conj


class GaloisKeys:
    """A keyring of Galois keys indexed by group element g, with the usual
    power-of-two generating set so any rotation needs <= log2(n/2) hops."""

    def __init__(self, keys: dict):
        self.keys = dict(keys)

    @classmethod
    def for_rotations(cls, gen: prng.Gen, param, sk, steps=None,
                      conj: bool = False):
        """Build keys for the given rotation steps (default: +/- powers of
        two — enough to compose any rotation)."""
        n = param.n
        if steps is None:
            steps = []
            p = 1
            while p < n // 2:
                steps += [p, -p]
                p *= 2
        gs = sorted({rotation_element(n, k) for k in steps}
                    | ({conj_element(n)} if conj else set()))
        gens = prng.split(gen, len(gs))
        return cls({g: galois_key(gi, param, sk, g)
                    for g, gi in zip(gs, gens)})

    def rotate(self, param, ct, k: int):
        """Rotate by k slots, composing power-of-two hops as needed."""
        n = param.n
        k = k % (n // 2)
        if k == 0:
            return ct
        g = rotation_element(n, k)
        if g in self.keys:
            return apply_to_ct(param, self.keys[g], ct, g)
        out = ct
        p, rem = 1, k
        while rem:
            if rem & 1:
                g = rotation_element(n, p)
                if g not in self.keys:
                    raise KeyError(f"missing Galois key for step {p}")
                out = apply_to_ct(param, self.keys[g], out, g)
            rem >>= 1
            p *= 2
        return out

    def conjugate(self, param, ct):
        g = conj_element(param.n)
        if g not in self.keys:
            raise KeyError("keyring built without conj=True")
        return apply_to_ct(param, self.keys[g], ct, g)
