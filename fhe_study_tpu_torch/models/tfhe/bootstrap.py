"""TFHE programmable bootstrapping: lookup tables, blind rotation, key
switch — the counterpart of fhe_study_tpu/models/tfhe/bootstrap.py.

The blind rotation is the full CMux chain over the LWE key bits, with two
mod-switch modes:

  * mode="standard": q2 = 2N — real TFHE; the test polynomial is negacyclic,
    so messages live in [0, t/2).
  * mode="reference": q2 = K·N — reproduces the reference's observable
    behaviour (identity over [0, t)) for tiny-mask (encrypt_s) ciphertexts,
    where all switched mask digits vanish.

The BootstrappingKey is per key BIT (K·N TGGSWs).  With the key
pre-transformed (``precompute_btk_evals``) the whole chain is one launch of
the blind-rotation kernel on the card; ``fused=False`` walks it step by step
through ``cmux_evals`` (or ``cmux`` when ``fast`` is off) on either device.
"""

from typing import NamedTuple

import torch

from ...arith import tn
from ...ops import blind_rotate_cuda as brc
from ...utils import prng
from ..gfhe.glwe import GLWE, Param
from . import tlwe as tlwe_mod
from . import tglwe as tglwe_mod
from . import tggsw as tggsw_mod
from .tlwe import TLWE
from .tggsw import TGGSW


class BootstrappingKey(NamedTuple):
    btk_a: torch.Tensor  # [kn, K+1, l, K, N]  — TGGSW per LWE key bit
    btk_b: torch.Tensor  # [kn, K+1, l, N]
    ksk_a: torch.Tensor  # [kn, l_ks, kn]
    ksk_b: torch.Tensor  # [kn, l_ks]


def _table(param: Param, values, device) -> GLWE:
    v = tglwe_mod.encode(param, values.to(device) % param.t)
    return tglwe_mod.from_plaintext(param, v)


def compute_lookup_table(param: Param, device) -> GLWE:
    """v(X): t plaintext values each repeated N/t times, encoded, wrapped as
    a noiseless TGLWE.  Used with mode="reference" (q2 = K·N): one slot
    window per message."""
    n, t = param.ring.n, param.t
    return _table(param, torch.arange(t).repeat_interleave(n // t), device)


def compute_lookup_table_standard(param: Param, device) -> GLWE:
    """Identity table for mode="standard" (q2 = 2N, negacyclic): messages
    live in [0, t/2); each of the t/2 values occupies a 2N/t window."""
    n, t = param.ring.n, param.t
    return _table(param, torch.arange(t // 2).repeat_interleave(2 * n // t),
                  device)


def _bits_poly(bits, n: int):
    """Each key bit as the constant polynomial m_j(X) = s_j: [kn, N]."""
    poly = torch.zeros((bits.shape[0], n), dtype=torch.int64,
                       device=bits.device)
    poly[:, 0] = bits
    return poly


def _key_with(param: Param, s_tglwe, bits, s_dst, btk_draws, ksk_draws,
              beta: int, l: int, beta_ks: int, l_ks: int) -> tuple:
    """(btk_a, btk_b, ksk_a, ksk_b) from given draws: TGGSWs of ``bits``
    under s_tglwe, and the key-switching key s_flat -> s_dst."""
    g = tggsw_mod.encrypt_s_with(param, beta, l, s_tglwe,
                                 _bits_poly(bits, param.ring.n), *btk_draws)
    ksk = tlwe_mod.new_ksk_with(param.lwe(), beta_ks, l_ks,
                                tglwe_mod.sk_to_tlwe(s_tglwe), s_dst,
                                *ksk_draws)
    return g.a, g.b, ksk.a, ksk.b


def new_bootstrapping_key_with(param: Param, s_tglwe, s_lwe_out, btk_draws,
                               ksk_draws, beta: int = 2, l: int = 64,
                               beta_ks: int = 2, l_ks: int = 64
                               ) -> BootstrappingKey:
    """new_bootstrapping_key from given draws: btk_draws = (a, e) of the
    batched TGGSW encryption ([kn, K+1, l, K, N] and [kn, K+1, l, N]),
    ksk_draws = (a, e) of the key-switching key ([kn, l_ks, kn_out] and
    [kn, l_ks])."""
    return BootstrappingKey(*_key_with(
        param, s_tglwe, tglwe_mod.sk_to_tlwe(s_tglwe), s_lwe_out, btk_draws,
        ksk_draws, beta, l, beta_ks, l_ks))


def new_bootstrapping_key(gen: prng.Gen, param: Param, s_tglwe,
                          beta: int = 2, l: int = 64,
                          beta_ks: int = 2, l_ks: int = 64,
                          s_lwe_out=None):
    """BTK = (TGGSW_s(s_bit_j) for each of the kn LWE key bits, KSK:
    extracted key -> a fresh TLWE key, or ``s_lwe_out``).  All kn TGGSW
    encryptions run as one batch.  Returns (key, s_lwe_out)."""
    s_flat = tglwe_mod.sk_to_tlwe(s_tglwe)                  # [kn]
    if s_lwe_out is None:
        s_lwe_out, _ = tlwe_mod.new_key(gen, param.lwe(), s_flat.device)
    g = tggsw_mod.encrypt_s(gen, param, beta, l, s_tglwe,
                            _bits_poly(s_flat, param.ring.n),
                            batch=(param.kn,))
    ksk = tlwe_mod.new_ksk(gen, param.lwe(), beta_ks, l_ks, s_flat, s_lwe_out)
    return BootstrappingKey(btk_a=g.a, btk_b=g.b, ksk_a=ksk.a,
                            ksk_b=ksk.b), s_lwe_out


def precompute_btk_evals(param: Param, btk):
    """Transform the whole bootstrapping key to the CRT-NTT domain once;
    pass the result to blind_rotation / bootstrap via btk_evals."""
    return tggsw_mod.precompute_evals(param, TGGSW(a=btk.btk_a, b=btk.btk_b))


def blind_rotation(param: Param, btk, table: GLWE, c: TLWE,
                   beta: int = 2, l: int = 64, mode: str = "standard",
                   fast: bool = True, btk_evals=None,
                   fused: bool | None = None) -> GLWE:
    """acc = v·X^{-b'}; for each key bit j: acc = CMux(btk_j, acc,
    acc·X^{+a'_j}).  Final rotation ≈ -(b' - Σ a'_j s_j) = -phase(m).

    fast=True (when the CRT bound admits it) multiplies against the key in
    the eval domain (``btk_evals``, or the transform of ``btk`` made here).
    The chain then runs as ONE call of ``ops.blind_rotate_cuda`` whenever
    its static conditions hold (``supported``); fused=False forces the
    step-by-step chain through ``cmux_evals``, and so do parameters the
    fused chain does not support, as in the reference.  With fast off, or
    beyond the bound, the chain runs through ``cmux`` on the
    coefficient-domain key.  All of these are bit-identical."""
    if mode not in ("standard", "reference"):
        raise ValueError(f"mode {mode!r}")
    kn, n = param.kn, param.ring.n
    q2 = (2 * n) if mode == "standard" else kn
    if mode == "standard":
        # round-to-nearest switch (floor bias ≈ kn/4 units = a full window)
        c2 = TLWE(a=tn.mod_switch_round(c.a, q2),
                  b=tn.mod_switch_round(c.b, q2))
    else:
        c2 = tlwe_mod.mod_switch(c, q2)   # reference floor semantics
    # half-window centering: land phases mid-slot so the lookup tolerates
    # ±window/2 of noise and switching error
    half = (n // param.t) if mode == "standard" else (n // param.t) // 2
    acc0 = tglwe_mod.left_rotate(param, table, c2.b + half)
    # switched values are below 2^62, so the signed remainder is the
    # reference's unsigned one
    shifts = (2 * n - c2.a) % (2 * n)                      # [..., steps]

    use_fast = fast and (param.k + 1) * l * n * beta < (1 << 26)
    if use_fast:
        gev = btk_evals if btk_evals is not None else \
            precompute_btk_evals(param, btk)
        if (fused is None or fused) and brc.supported(param, beta, l):
            batch = tuple(c2.b.shape)
            # chain length = the ciphertext's mask length (n_lwe < kn in the
            # keyswitch-first pipeline)
            steps = c2.a.shape[-1]
            a0 = torch.cat([acc0.a.reshape(-1, param.k, n),
                            acc0.b.reshape(-1, 1, n)], dim=1).contiguous()
            out = brc.blind_rotate_fused(
                shifts.reshape(-1, steps).T.int().contiguous(), a0, gev.ev1,
                gev.ev1s, gev.ev2, gev.ev2s, n, w=beta.bit_length() - 1)
            out = out.reshape(batch + (param.k + 1, n))
            return GLWE(a=out[..., :param.k, :], b=out[..., param.k, :])
        acc = acc0
        for j in range(c2.a.shape[-1]):
            rot = tglwe_mod.left_rotate(param, acc, shifts[..., j])
            acc = tggsw_mod.cmux_evals(
                param, beta, l,
                tggsw_mod.TGGSWEvals(gev.ev1[j], gev.ev2[j], gev.ev1s[j],
                                     gev.ev2s[j]), acc, rot)
        return acc
    acc = acc0
    for j in range(c2.a.shape[-1]):
        rot = tglwe_mod.left_rotate(param, acc, shifts[..., j])
        acc = tggsw_mod.cmux(param, beta, l,
                             TGGSW(a=btk.btk_a[j], b=btk.btk_b[j]), acc, rot)
    return acc


class ShortBootstrappingKey(NamedTuple):
    """Keys for the keyswitch-FIRST pipeline over a short LWE dimension
    n_lwe < K·N: KSK (kn -> n_lwe) + per-bit TGGSWs of the short key."""
    btk_a: torch.Tensor   # [n_lwe, K+1, l, K, N]
    btk_b: torch.Tensor   # [n_lwe, K+1, l, N]
    ksk_a: torch.Tensor   # [kn, l_ks, n_lwe]
    ksk_b: torch.Tensor   # [kn, l_ks]


def new_short_bootstrapping_key_with(param: Param, s_tglwe, s_short,
                                     btk_draws, ksk_draws, beta: int = 256,
                                     l: int = 3, beta_ks: int = 16,
                                     l_ks: int = 8) -> ShortBootstrappingKey:
    """new_short_bootstrapping_key from a given short key and given draws
    (as new_bootstrapping_key_with, over n_lwe)."""
    if s_short.shape[-1] >= param.kn:
        raise ValueError("short dimension must shrink the chain")
    return ShortBootstrappingKey(*_key_with(
        param, s_tglwe, s_short, s_short, btk_draws, ksk_draws, beta, l,
        beta_ks, l_ks))


def new_short_bootstrapping_key(gen: prng.Gen, param: Param, s_tglwe,
                                n_lwe: int, beta: int = 256, l: int = 3,
                                beta_ks: int = 16, l_ks: int = 8
                                ) -> ShortBootstrappingKey:
    """Production TFHE key layout: an intermediate SHORT LWE key s' of
    dimension n_lwe cuts the CMux chain from K·N to n_lwe steps.

    Pipeline (bootstrap_short): key_switch kn->n_lwe FIRST, then blind-rotate
    over n_lwe bits, then sample-extract — the output lands back under the
    ORIGINAL extracted key s_flat, so bootstraps compose without a trailing
    key switch."""
    if n_lwe >= param.kn:
        raise ValueError("short dimension must shrink the chain")
    s_flat = tglwe_mod.sk_to_tlwe(s_tglwe)                  # [kn]
    s_short = prng.binary(gen, (n_lwe,), s_flat.device)
    g = tggsw_mod.encrypt_s(gen, param, beta, l, s_tglwe,
                            _bits_poly(s_short, param.ring.n),
                            batch=(n_lwe,))
    ksk = tlwe_mod.new_ksk(gen, param.lwe(), beta_ks, l_ks, s_flat, s_short,
                           uniform_mask=True)
    return ShortBootstrappingKey(btk_a=g.a, btk_b=g.b,
                                 ksk_a=ksk.a, ksk_b=ksk.b)


def precompute_short_btk_evals(param: Param, sbtk: ShortBootstrappingKey):
    return precompute_btk_evals(param, sbtk)


def bootstrap_short(param: Param, sbtk: ShortBootstrappingKey, table: GLWE,
                    c: TLWE, beta: int = 256, l: int = 3,
                    beta_ks: int = 16, l_ks: int = 8,
                    btk_evals=None, fused: bool | None = None) -> TLWE:
    """key_switch (kn -> n_lwe) -> blind rotation (n_lwe CMux steps) ->
    sample_extraction.  Input and output both live under s_flat."""
    ksk = tlwe_mod.KSK(a=sbtk.ksk_a, b=sbtk.ksk_b)
    c_short = tlwe_mod.key_switch(param.lwe(), beta_ks, l_ks, ksk, c)
    rotated = blind_rotation(param, sbtk, table, c_short, beta, l,
                             mode="standard", btk_evals=btk_evals,
                             fused=fused)
    return tglwe_mod.sample_extraction(param, rotated, 0)


def bootstrap(param: Param, btk: BootstrappingKey, table: GLWE, c: TLWE,
              beta: int = 2, l: int = 64,
              beta_ks: int = 2, l_ks: int = 64,
              mode: str = "standard", fast: bool = True,
              btk_evals=None, fused: bool | None = None) -> TLWE:
    """blind rotation -> sample_extraction(0) -> key switch."""
    rotated = blind_rotation(param, btk, table, c, beta, l, mode, fast=fast,
                             btk_evals=btk_evals, fused=fused)
    c_h = tglwe_mod.sample_extraction(param, rotated, 0)
    ksk = tlwe_mod.KSK(a=btk.ksk_a, b=btk.ksk_b)
    return tlwe_mod.key_switch(param.lwe(), beta_ks, l_ks, ksk, c_h)
