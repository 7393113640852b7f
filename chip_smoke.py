#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's paths once on one CUDA card.

    python3 chip_smoke.py            # from the repository root, one card

The paths are those of RNS-BFV (models/bfv_rns.py) at N = 2^14, L = 4
Q-primes, M = 5 P-primes, K = 2 auxiliary primes, t = 256, a batch of 128
ciphertexts, its linear pipeline at N = 2^12, L = 2, M = 3, a batch of
1024, TFHE programmable bootstrapping (models/tfhe/bootstrap.py) at
N = 1024, K = 1, t = 8, a batch of 64, blind-rotation gadget 4096^2,
key-switch gadget 16^8 (the full chain of 1024 CMux steps and the
keyswitch-first pipeline over a short key of 700), RNS-CKKS
(models/ckks/ckks_rns.py with models/hybrid_ks.py and models/galois.py) at
N = 2^13, L = 4 primes of 30 bits, delta = 2^28, K = 2, a batch of 32, the
NTT mode: a chain of 8 ntt_multi over 9 primes, B = 64, N = 2^14, and the
CKKS linear maps and polynomial evaluation (models/ckks/eval.py, poly.py) at
the n = 2^12 bootstrap's ring and prime count: N = 4096, L = 43, S = 2
stages, h = 64, a batch of 8, and that bootstrap itself
(models/ckks/bootstrap.py) in the JAX bench's production configuration,
the Rq layer's schemes with the graft entry (fhe_study_tpu_torch/
entry.py: single-modulus BFV at q = 2^16 + 1, n = 1024, B = 4), the
parallel layer (fhe_study_tpu_torch/parallel/) in 8 ranks on the card, and
RNS-BFV's mul_e with the hybrid key at ring degree 2^15: N = 2^15, L = 14,
M = 15, K = 15, t = 256, B = 128 (the Homomorphic Encryption Standard's
n = 32768 row allows log q <= 881 at 128-bit classical security, as does
SEAL's BFVDefault(32768); the key modulus Q P_K here is 29 primes of 30
bits, 870 bits), also its mul with the hybrid key, and the gadget keyring
at the same degree with that whole modulus in Q: N = 2^15, L = 29, M = 30,
t = 256, B = 128, and the JAX package's own tests' small configurations:
RNS-BFV at N = 128, t = 16, L = 3, M = 4, B = 128, TFHE at N = 128, K = 1,
t = 8, gadget 256^3, B = 64, and RNS-BFV and RNS-CKKS at N = 64, below the
kernels' gate, and TFHE's keyswitch-first bootstrap past a block's shared
memory: N = 4096, gadget 2^11 x 2, and N = 2^15, gadget 2^8 x 3, over a
short key of 400, B = 64, and past one block's polynomial at N = 2^16,
gadget 2^6 x 5 (the reference's gate there with the widest top-bits gadget
that decodes), over the same short key, B = 64, and the op layer past one
block's polynomial at N = 2^16, B = 128 on phase 18's and phase 19's
widths over primes with 2^17-th roots.
Phases, each of which raises (and so exits non-zero) on any failure:

  1. toolchain and card: torch, CUDA, nvcc; the kernels built from csrc/;
  2. each of the first eleven kernel entries against its plain PyTorch
     version on the card, bit for bit, at the paths' shapes (batch 8) and at
     n = 256; the redesigned kernels at every n from 2^7 to 2^15 (K6, K7,
     K8 at 2^15 on two-block clusters) on a batch
     of 3 (kernel_check.radix_cases): K1 forward and inverse, with and
     without fin, on contiguous and word-offset rows; K9 forward and inverse
     under a 30-bit and a 31-bit prime, on aligned and word-offset int64
     rows; K12 over 0, 1 and 3 transforms; K2 on contiguous,
     strided and unaligned rows; K5 from every count of 1 to 31 source
     primes (2 and 4 in its direct instances, the others in its staged
     layout: the lift first); the lift alone from 1 to 31 source primes,
     unsigned and centered, on rows of n and n - 1 and one word off (its
     vector and word forms);
     K4 from 1, 2, 3, 4, 5 and 15 source primes to 1, 4 and 5, unsigned and
     centered, with and without the epilogue, on a row length that is no
     multiple of 4 and on unaligned rows, and from 16 to 31 to 5 (both
     forms); K3 from 1, 2, 4 and 9 digit rows over 2 and 6 primes, aligned
     and word-offset; K6 (and tensor_mul) with and without a scale on
     contiguous, strided, stacked and unaligned rows and from every count
     of 1 to 31 source primes (4 direct, the others staged); K7 and K8
     from 1, 2, 4 and 9 limb rows over
     30-bit primes to 2 and 6 primes of 28 bits (reps >= 2), 39 rows to 2
     primes at n = 2^11, 29 rows (phase 19's R = L) to both at n = 2^15,
     R = L = 4 on the paths' strided views (K8's adds
     too) and every operand one word off; K3, K7 and K8 at R = 43 over the 45 primes
     of Q u P at n = 2^12 (the CKKS maps' shape); K11 from every source
     count 1 .. 31 to 5 primes, unsigned and centered, in its vector and
     word forms; K10 in both its layouts at every n from 2^7 to 2^15, C = 2
     and 3, l = 1, 2 and 3, over 1, 2 and 17 steps: on its two-block
     clusters where the plan takes them, on 1, 3, 64, 67 and 133
     ciphertexts, with its working set in device memory elsewhere, on 1, 3
     and 67 (1 and 3 at 2^14 and 2^15), and at (n, C, l) = (2^11, 2, 7),
     (2^9, 4, 32) and C = 1 (kernel_check.blind_rotate_sweep), staged and
     direct key planes and planes one word off; ptxas's
     registers, stack frame and spills of every kernel (phase 1), which must
     show neither for K1-K12;
  3. the eval-resident path: keygen -> hybrid relin key -> encrypt 128
     plaintext pairs -> to_evals -> mul_e -> from_evals -> decrypt;
  4. the coefficient-domain and gadget paths on the same ciphertexts: mul
     with the gadget key, mul with the hybrid key, to_evals -> gadget mul_e
     -> from_evals, key_switch to a second key (decrypted under it), and the
     stacked tensor (tensor_mul_multi, held against tensor_mul4);
  5. the linear pipeline: pt_to_evals, to_evals x 2, one
     mul_pt_e(add_e(., .), em) step;
     every launch counter is set to 0 before each path and read after it,
     and every decrypted result is held against an independent numpy FFT
     negacyclic product for every coefficient;
  6. timing with CUDA events: chains of 4 (hybrid mul_e, gadget mul_e, mul,
     the linear step) and each kernel variant against its plain version at
     the paths' shapes, beside the least time the card could take (its
     bound, utils/kernel_check.bound: bytes over 3.35 TB/s, all integer
     instructions over 128 a clock and SM, each integer pipe's issue slots
     over 64; a kernel under it fails the run) and the issue-only bound of
     earlier runs;
  7. the TFHE full-chain path: tglwe.new_key -> new_bootstrapping_key ->
     precompute_btk_evals -> encrypt_uniform of 64 messages -> bootstrap ->
     decrypt and decode, all 64 held against the messages; the fused chain
     held against the step-by-step chain (fused=False) on the card;
  8. the short path: new_short_bootstrapping_key(n_lwe=700) ->
     bootstrap_short twice, the second on the output of the first;
  9. TFHE timing: a chain of 3 bootstraps of each pipeline, each fed the
     last one's output, as bootstraps/s; the key switch and the sample
     extraction apart; the two TFHE kernels beside plain and bound;
 10. the last three entries (base_extend_sum, ntt_smem_ceiling, alu_rate)
     against their plain versions, base_extend_sum also against the whole
     conversion, and the variants of earlier kernels that RNS-CKKS launches
     (K3 over R = 4 rows, K7 and K1 over the extended basis of 6 primes, K6
     without a scale, K4 from 2 to 4 primes), bit for bit, at N = 2^13 (the
     measuring loops at N = 2^14) and n = 256; the SASS instruction counts
     of the alu_rate loops read back from the build (the instruction rates
     of phase 12 and the bounds of phase 13 use these, not recorded ones);
 11. RNS-CKKS at full width, keys generated on the card: new_key ->
     hybrid_rlk -> encode and encrypt two slot vectors -> add -> mul_hybrid
     -> decrypt_to_coeffs -> decode, held against (z1 + z2) * z1 in all
     32 x 4096 slots (atol 1e-2); on the same ciphertexts rotate_hybrid, and
     eight rotate_hoisted from one hoist_digits, each decoded and held
     against the slots moved by galois.ckks_slot_perm; the contraction-only
     base extension driven on that path's own accumulator; the gadget
     keyring (GaloisKeys.for_rotations, conj=True) on a CKKS ciphertext at
     delta = 2^55 and on a batched RNS-BFV ciphertext (bfv_batch, t = 65537,
     exact); mul_hybrid2 at L = 7, delta = q_6 q_5, through the 3-limb
     decrypt;
 12. the NTT mode: the chain of 8 ntt_multi, 3 times, as butterflies/s
     (utils/profiling.ntt_roofline) beside the shared-memory ceiling (K12:
     the register-resident chain of every NTT kernel, on resident
     polynomials; its SASS loop held to one transform's loads) at
     B = 64 and on a full card at n = 2^14, 2^13 and 1024, and the alu_rate
     operations' issue rates; the last timed launch of every one of these
     is held against the plain version (the ceiling's on four polynomials,
     an alu_rate launch as 64 shorter ones, the first of which is held
     against plain); each alu_rate loop must issue at 0.85-1.05 of its own
     pipe-aware bound (the pipe model's check); a link's share of its bound
     beside its share of the ceiling, the host's enqueue time a link, and a
     link's time on the device alone;
 13. timing: the CKKS step as a chain (add + mul_hybrid, 3 iterations, the
     padded output fed back) as ops/s, eight rotations hoisted against
     eight unhoisted, and every variant of phase 10 beside plain and bound;
     each pure transform's share of the ceiling at its n (K1's link, K9's
     variants at the shapes of TFHE key generation);
 14. the CKKS linear maps: a fresh encryption at N = 4096, L = 43, scale
     2^60 through the two c2s_stage_maps(4096, 2) stages, then the two
     s2c_stage_maps(4096, 2) stages (build_rmap_plan at two primes a
     diagonal scale -> apply_rmap_plan), each stage's Galois keys drawn on
     the card at its level only, each stage's output decrypted and held
     against numpy's application of the same maps (5e-2), and the chains
     added at the end against 2z; then poly_eval (degree 7, delta = 2^28,
     L = 8) and poly_eval2 (0.5 + z - 0.25z^3 at the double-prime scale,
     L = 9; 1e-9) at N = 4096, each also held bit for bit against the same
     call on the CPU (poly_eval's slots are reported against the 5e-3 that
     the reference test holds at n = 32: at n = 4096 its noise exceeds it);
     each stage's launches by kernel, its
     ms (CUDA events, best of 3), key bytes and peak memory; the kernel
     variants of the maps at L = 43 beside plain and bound;
 15. CKKS bootstrapping at N = 4096, L = 43, S = 2 radix stages a side,
     h = 64, (K, r) = suggest_K_r(4096, 64) = (12, 5), double-base ModRaise,
     delta0 = 2^55, working scale 2^60, cosine degree 30, four arcsin
     terms, B = 8 (bench.py, bench_ckks_boot): precompute_keys on the card
     (key bytes by level, seconds), pack_seeded -> expand_seeded on the card
     with every a plane, b plane and em torch.equal to the built set, the
     pack under 0.62 of the set's bytes and holding the mask seeds alone (no
     master or noise seed); encrypt -> level_drop to 2 -> make_staged on the
     expanded set -> decrypt_to_coeffs(crt_limbs=3) -> decode, every slot
     within 2^-18 (the bench's decrypt gate), the refreshed bits and
     boot_probe's stage errors (C2S w, EvalMod, final) printed; the same
     pipeline at n = 256, B = 1 on the card and on the CPU, the outputs
     torch.equal; a chain of 3
     bootstraps (each output dropped to 2 limbs and fed back) timed as
     bootstraps/s, the ms of each stage, launches by kernel per bootstrap
     and peak memory; every distinct kernel argument shape the refresh
     launched held against its plain version;
 16. slice 4, the Rq layer and the graft entry: ``entry.setup`` on the
     card at the entry's configuration (q = 2^16 + 1, n = 1024, t = 4,
     p = q^2, B = 4): encrypt, add and add_const decrypt exactly; the
     entry's ``bfv.mul(fast=True)`` through K9 (48 launches of [4, 1024]),
     equal to the same call on the CPU bit for bit; ``polymul_i64_crt`` at
     the entry's shapes against the exact product in Python integers; the
     product's noise beside Delta/2 (at this q it does not decrypt, as in
     the reference: printed, not held); then the reference tests'
     configurations: ``bfv.mul`` at n = 64, t = 2, B = 64 (plain
     transforms) decrypts, GLWE over Z_q at n = 128, k = 16: encrypt and
     encrypt_s decrypt and ``key_switch`` (beta = 2, l = 16, B = 32, K9 at
     n = 128) decrypts under the new key, single-modulus CKKS at n = 16
     round-trips every slot; K9 held against plain at every argument
     signature the phase launched; the entry mul's ms (CUDA events, best of
     3) and K9 beside its bound at [4, 1024] and at the key switch's
     [32, 256, 128], also on the device alone;
 17. slice 8, the parallel layer: ``entry.dryrun_multichip`` in 8 ranks on
     this one card over gloo (NCCL refuses two ranks on one card; gloo
     moves host memory, so every CUDA tensor of a collective is staged
     through the host, and the bytes are counted), factor_mesh(8) = dp1 x
     ep2 x sp2 x tp2 as in the reference's dryrun: (a) the dp/ep/sp/tp step
     at q = 65537, n = 64; (b) the RNS ct-mul at N = 2^12, L = 4, M = 5,
     t = 16 on dp4 x ep2 (simulate_hosts = 2) and the four-step product at
     N = 2^12 on dp4 x sp2; (c) bootstrap_short at N = 1024, n_lwe = 32 on
     dp x tp; (d) CKKS rotate + mul + rescale at n = 4096, L = 4 on dp x tp;
     (e) at full width: mul_e HRLK at N = 2^14, L = 4, M = 5, t = 256,
     B = 128 on dp4 x ep2, equal in every rank to phase 3's single-rank
     result (sha256), TFHE bootstrap at N = 1024, B = 64 on dp8 (K10), and
     polymul_i64_crt_ep at the entry's [4, 1024] (K9); each sharded result
     bit-equal to the unsharded call in the rank and decrypt-verified; each
     rank holds every kernel argument signature it launched against plain;
     each program's ms (CUDA events) and staged bytes, and the launches by
     kernel summed over the ranks, which the kernels' record counts; then
     the same programs in one rank over NCCL;
 18. slice 10, ring degree 2^15: keygen -> hybrid_rlk1(K = 15) -> encrypt
     128 plaintext pairs -> to_evals -> mul_e -> from_evals -> decrypt at
     N = 2^15, L = 14, M = 15, t = 256, held against the numpy FFT
     negacyclic product in all 128 x 32768 coefficients; the launches of
     one mul_e by kernel held to K2 2, K4 5, K1 2, K3 1, K5 1, every one at
     n = 2^15, each launched signature held against plain; a chain of 4
     mul_e timed (CUDA events, best of 3) as ms an op and ct-mul/s and its
     output decrypted against the numpy chain; K1, K2, K3, K4 and K5 at the
     path's shapes (kernel_check.cases at n = 2^15, K = 15), K9 on
     [8, 2^15] under a 30-bit and a 31-bit prime and K12 at n = 2^15, each
     against its plain version at batch 8; each kernel at the path's shape
     on the device alone beside its bound; K12's full-card ceiling at
     n = 2^15 beside K1's rate; the 2^15 instances' registers; peak device
     memory; then mul with the hybrid key on the same keys (K6 over Q and
     over P from 14 sources, K4, K1, K3 at n = 2^15, the three-buffer
     kernels on two-block clusters): decrypt-verified after one op and after
     a timed chain of 4, its launches per op, each signature at batch 8
     against plain; K6, tensor_mul, K7 and K8 at the path's shapes against
     plain and on the device alone beside their bounds; K5 (in mul_e) and
     K6 over P (in mul) convert from 14 sources in their staged layout
     (counted), and the lift alone on their operands is held against plain
     at batch 8 and timed at the paths' shapes beside its bound;
 19. slice 11, the gadget keyring at N = 2^15, L = 29, M = 30, t = 256,
     B = 128 (the whole 870 bits of the modulus in Q, so the tensor's
     conversions run from 29 and 30 source primes): keygen -> rlk_key (29
     digit rows) -> encrypt -> mul -> decrypt; to_evals -> mul_e ->
     from_evals -> decrypt; ksk_key to a fresh key -> key_switch ->
     decrypt under it; each decrypt-verified in all 128 x 32768
     coefficients, mul and mul_e also after a chain of 4 (CUDA events,
     best of 3), key_switch timed over 4 calls; launches per op; every
     argument signature of each op at batch 8 held against plain; peak
     device memory; K4 (from 29 and 30), K5 (from 29), K6 (from 29), K7,
     K8 (R = 29), K11 (from 29) and the lift (from 29, on K5's and K6's
     operands, also held against plain at batch 8) at the path's shapes on
     the device alone beside their bounds; K5 and K6 over P in their
     staged layout (counted an op);
 20. slice 12, the reference tests' configurations at n = 2^7 and the
     multi-prime kernels' gate: the n = 2^7 instances' registers; RNS-BFV
     at N = 128, t = 16, L = 3, M = 4, B = 128 (tests/test_bfv_rns.py):
     keygen -> hybrid_rlk1 -> encrypt -> to_evals -> mul_e -> from_evals ->
     decrypt, mul with both keys, the gadget mul_e, key_switch, pt_to_evals
     -> mul_pt_e(add_e), the stacked tensor, each decrypt-verified; K1-K3
     and K5-K8 (and tensor_mul) launched; each op's launches and argument
     signatures at batch 8 held against plain, every launch at n = 128,
     chains of 4 decrypt-verified and timed (CUDA events, best of 3), the
     other ops timed; t = 4: from_evals(mul_e) == mul, the round trip, the
     depth-2 chain; TFHE at N = 128, K = 1, t = 8, beta = 256, l = 3,
     beta_ks = 16, l_ks = 8, B = 64 (tests/test_bootstrap.py): bootstrap
     (one blind_rotate a bootstrap, equal to the step-by-step chain) and two
     bootstrap_short over a short key of 64, every message decoded, chains
     of 4 timed; the gate at N = 64 (tests/test_galois.py): RNS-BFV at
     t = 65537 (mul_e with both keys, a rotation by the gadget key) and
     RNS-CKKS at delta = 2^25 (mul_hybrid, rotate_hybrid), no launch of
     K1-K3 or K5-K8, every output equal to the CPU's, decrypted or decoded
     against numpy; every n = 2^7 kernel at these shapes against plain and
     on the device alone beside its bound, with its launches an op;
 21. slice 13, K10 with its working set in device memory: TFHE
     bootstrap_short at N = 4096, K = 1, beta = 2^11, l = 2 (configuration
     a: tests/test_bootstrap.py's t = 128 bootstrap with N doubled, here at
     t = 64) and at N = 2^15, K = 1, beta = 2^8, l = 3 (configuration b, at
     t = 16), both over a short key of 400 and the key switch 16^8, B = 64:
     keys generated on the card, all 64 messages decoded, one blind_rotate
     launch (in the device-memory layout) a bootstrap, the kernel's
     rotation == the step-by-step chain's (torch.equal), a chain of 3 timed
     beside one step-by-step bootstrap, peak device memory with the keys
     resident; K10 on the device alone beside its bound and its layout's
     own bound at a, b and N = 1024 in both layouts;
 22. slice 15, past one block's polynomial: TFHE bootstrap_short at
     N = 2^16, K = 1, beta = 2^6, l = 5, n_lwe = 400, key switch 16^8,
     B = 64: keys built on the card (K9 at 2^16 across blocks; the key
     bytes, the peak memory and the build's seconds printed), t the largest
     power of two from 1024 down whose 64 messages all decode with margin
     (the largest phase error at most half of half a slot), every message
     decoded, the fused chain (one launch of K10's split layout, slice 18:
     each polynomial over the shared memory of a cluster's blocks) == the
     step-by-step chain (K1 at 2^16) bit for bit, no plain version run on
     the card at 2^16 (the plain functions wrapped and counted), the
     launches by kernel and by layout, a chain of 3 timed, K10 on the
     device alone at the path's 400 steps in its split layout and in its
     grid layout named, in turns, beside its bound and its own traffic,
     and K1, K9 and K10 (both layouts) at the path's shapes against plain
     and timed beside their bounds (K10 at 16 steps); then bootstrap_short
     at N = 2^17, K = 1, (beta, l) = (2^5, 6), B = 64 on a 400-step key
     built on the card in slices of steps, every message decoded at t =
     256, one launch a bootstrap of K10's quarter layout (slice 23: each
     polynomial in quarters over the shared memory of a cluster of eight),
     fused == step by step over the key's last 8 steps, a chain of 3
     timed, K10 at the path's arguments in its quarter layout and in its
     grid layout named, in turns, beside its bounds; then the grid layout's
     own path, blind_rotation at N = 2^18, beta = 2^4, l = 7 over 8 steps
     of a key built on the card, fused == step by step.  Phase 2 also
     holds K1 and K9 at 2^16, 2^17, 2^20, 2^22 and 2^26 on batches of 1 to
     3, and K10's split layout at every (C, l, w) of the reference's gate
     at 2^16, its quarter layout at every one at 2^17 and its grid layout
     at one shape at each n from 2^18 to 2^22, against plain;
 23. slice 16, K2, K3, K5 and K12 past one block's polynomial through the
     op layer at N = 2^16, B = 128 on phase 18's widths (Q, P and K of 14,
     15 and 15 primes with 2^17-th roots: no scheme draws such primes):
     ntt.tensor_eval4 over Q and over P, ntt.ks_contract_multi at R = 1
     over Q u K, ntt.ext_ntt Q -> P (staged) and 4 -> 5 (direct), and
     alu_bench.ntt_smem_ceiling on the whole card at 2^15, 2^16 (split on
     two-block clusters, slice 18; and chunked, named) and 2^17;
     every output == its plain version on the card, the launches by layout
     held, no plain version run on the card past one block, each kernel on
     the device alone beside its bound and its own traffic's.  Phase 2 also
     holds the four at 2^16, 2^17, 2^20, 2^22 and 2^26 against plain;
 24. slice 17, K6, tensor_mul, K7 and K8 past one block's polynomial
     through the op layer at N = 2^16, B = 128 (primes with 2^17-th roots):
     ntt.tensor_mul4 over Q (14 primes, no source basis), over P from Q
     (14 -> 15, staged) and 4 -> 5 (direct), ntt.tensor_mul_multi on the
     stacked operand over Q (phase 18's widths), ntt.ks_fused_multi and
     ntt.ks_fused_eval at R = L = 29 over 29 primes (phase 19's gadget
     widths), c_limbs and the adds strided views; every output == its plain
     version on the card (formed over slices of the batch), the launches by
     layout held, no plain version run on the card past one block, each
     kernel on the device alone beside its bound and its own traffic's,
     peak device memory.  Phase 2 also holds the four, with K6 without a
     source basis, from 4 direct and from 3 staged, and K7 and K8 at R = 1
     and 3, at 2^16, 2^17, 2^20, 2^22 and 2^26 against plain.
     Each phase prints its wall time and the device memory still held as
     it ends.

It prints each finding on a line of its own, then the kernels' JSON record,
the card's name and power limit, and as its last line
{"ok": true, "device": {...}}.  Without a CUDA card it exits non-zero.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20240614
N, L, M, T, BATCH, CHAIN = 1 << 14, 4, 5, 256, 128, 4
LIN_N, LIN_L, LIN_M, LIN_BATCH = 1 << 12, 2, 3, 1024
PARITY_BATCH = 8
TFHE_N, TFHE_K, TFHE_T, TFHE_BATCH, TFHE_CHAIN = 1024, 1, 8, 64, 3
TFHE_BETA, TFHE_L, TFHE_BETA_KS, TFHE_L_KS, TFHE_N_LWE = 4096, 2, 16, 8, 700
CK_N, CK_L, CK_K, CK_DELTA, CK_BATCH, CK_ITERS = 1 << 13, 4, 2, 2.0 ** 28, 32, 3
CK_STEPS = (1, 2, 3, 5, 7, 11, 13, 17)       # the eight hoisted rotations
CK2_L, CK2_BATCH = 7, 4                      # the double-prime scale
CK_GADGET_DELTA, CK_GADGET_BATCH, BATCH_T = 2.0 ** 55, 4, 65537
# the n = 2^12 CKKS bootstrap of the JAX bench (bench.py, bench_ckks_boot):
# S = 2 radix-split stages, sparse secret h = 64, suggest_K_r(4096, 64) =
# (K, r) = (12, 5), so L = 29 + 2r + 4(S - 1) = 43 primes; the linear maps
# run at the working scale 2^60 with two primes per diagonal scale
BOOT_N, BOOT_S, BOOT_H, BOOT_B, BOOT_DELTA = 1 << 12, 2, 64, 8, 2.0 ** 60
BOOT_L = 29 + 2 * 5 + 4 * (BOOT_S - 1)
# the bootstrap itself: messages at delta0 = 2^55 over the double base
# q0*q1, EvalMod's cosine to degree 30 and four arcsin terms; a chain of 3
# refreshes is timed; card against CPU at the smallest ring the kernels take
BOOT_DELTA0, BOOT_DEG, BOOT_ARCSIN, BOOT_CHAIN = 2.0 ** 55, 30, 4, 3
BOOT_SMALL_N = 256
NTT_L, NTT_B, NTT_CHAIN, NTT_ITERS = 9, 64, 8, 3
# phase 17: (ranks, backend) of each dryrun_multichip run, its time limit,
# and the kernels its paths must launch (mul_e HRLK; the gadget R.mul;
# bootstrap; the CRT products)
P17_RUNS = ((8, "gloo"), (1, "nccl"))
P17_TIMEOUT_S = 600.0
P17_KERNELS = ("ntt_multi", "tensor_eval4", "ks_contract", "base_extend",
               "ext_ntt", "tensor_mul4", "ks_fused", "ntt", "blind_rotate")
# phase 18, slice 10: mul_e HRLK at ring degree 2^15 with the most primes
# the kernels take there: L = 14 Q-primes and M = L + 1 = 15 P-primes (K4
# converts from at most 15 sources), K = 15 hybrid primes so that P_K > Q
# (Q P_K: 29 primes of 30 bits, 870 bits, within the HE Standard's 881 for
# n = 32768); the launches of one mul_e by kernel, and the one-buffer
# kernels whose n = 2^15 instances ptxas must report
W_N, W_L, W_M, W_K = 1 << 15, 14, 15, 15
W_PER_OP = {"tensor_eval4": 2, "base_extend": 5, "ntt_multi": 2,
            "ks_contract": 1, "ext_ntt": 1}
W_INSTANCES = {"ntt_multi": 2, "tensor_eval4": 1, "ks_contract": 1,
               "ext_ntt": 3, "ntt": 2, "ntt_smem_ceiling": 1,
               "tensor_mul4": 3, "ks_fused": 1, "ks_fused_eval": 1}
# slice 11 at ring degree 2^15: mul with the hybrid key on phase 18's keys;
# then the gadget keyring with the whole modulus in Q: L = 29 Q-primes of 30
# bits (870 bits, the HE Standard's 881 for n = 32768 less one prime) and
# M = 30 P-primes, the least that holds the tensor's capacity (P above
# t n Q 4); the launches of one op by kernel
W_MUL_PER_OP = {"tensor_mul4": 2, "base_extend": 5, "ntt_multi": 1,
                "ks_contract": 1}
G_N, G_L, G_M = 1 << 15, 29, 30
G_PER_OP = {
    "mul (RLK)": {"tensor_mul4": 2, "base_extend": 2, "ks_fused": 1},
    "mul_e (RLK)": {"tensor_eval4": 2, "base_extend": 2,
                    "ks_fused_eval": 1, "ext_ntt": 1},
    "key_switch": {"ks_fused": 1}}
# phase 20, slice 12: the reference tests' own small configurations
# (kernel_check.SMALL_BFV and SMALL_TFHE at n = 128; the t = 4 of
# tests/test_bfv_rns.py:111 on 2 ciphertexts), the radix-chain kernels that
# must launch there, and their instances at 2^7; the gate at n = 64
# (tests/test_galois.py: RNS-BFV at t = 65537 with the rotation g = 5,
# RNS-CKKS at delta = 2^25, L = 3, M = 4, 4 ciphertexts) and the slot
# tolerances held there: the reference test's 2e-3 for the rotation, 1e-2
# for the product of slots up to 10
S_T4, S_T4_BATCH = 4, 2
S_KERNELS = ("ntt_multi", "tensor_eval4", "ks_contract", "ext_ntt",
             "tensor_mul4", "tensor_mul", "ks_fused", "ks_fused_eval")
S_INSTANCES = {**W_INSTANCES, "blind_rotate": 2}
S_GATE_N, S_GATE_T, S_GALOIS, S_GATE_B = 64, 65537, 5, 4
S_L, S_M = 3, 4
S_CK_DELTA, S_CK_MUL_ATOL, S_CK_ROT_ATOL = 2.0 ** 25, 1e-2, 2e-3
# phase 21, slice 13: bootstrap_short past a block's shared memory, (N, t,
# beta, l) of configurations a and b (n_lwe, beta_ks, l_ks and B those of
# phase 8 but the short key of 400); t is the largest power of two whose
# messages all decode with margin (PERF.md §6: the top-bits gadget of
# w l = 22 and 24 bits leaves a rotation error of about 2^56 and 2^57.6)
P21_CONFIGS = (("a", 1 << 12, 64, 1 << 11, 2), ("b", 1 << 15, 16, 1 << 8, 3))
P21_N_LWE = 400
# phase 22, slice 15: bootstrap_short past one block's polynomial, (N, beta,
# l) within the reference's gate ((K+1) l N beta = 2 * 5 * 2^16 * 2^6 <
# 2^26, the widest top-bits gadget that decodes: w l = 30); the powers of
# two tried for t, largest first; a CMux step count for the record's K10
# row, whose plain chain is timed (400 steps take half a minute there)
P22_N, P22_BETA, P22_L = 1 << 16, 1 << 6, 5
P22_TS = (1024, 512, 256, 128, 64, 32)
P22_ROW_STEPS = 16
# phase 22, slice 22: the path past 2^16, at N = P22_GRID_N (K10's quarter
# layout since slice 23); its fused chain held against the step-by-step
# chain over the key's last P22_GRID_STEPS steps
P22_GRID_N, P22_GRID_STEPS = 1 << 17, 8
# phase 22, slice 23: the path that runs K10's grid layout now that 2^17
# takes the quarters: blind_rotation at (N, beta, l) = P22_WIDEST within the
# reference's gate (2 * 7 * 2^18 * 2^4 < 2^26) over a key of P22_GRID_STEPS
# steps, fused == step by step
P22_WIDEST = (1 << 18, 1 << 4, 7)
# phase 22, slice 22: bootstrap_short at N = P22_GRID_N end to end on a key
# of P21_N_LWE steps generated in slices of steps; the gadgets tried in turn
# until a t of P22_TS decodes: (2^5, 6), w l = 30 as at 2^16, and (2^5, 7),
# w l = 35, both within the reference's gate (2 * 7 * 2^17 * 2^5 < 2^26);
# the 2^16 key build must peak below P22_KEY_PEAK_GIB (53.75 GiB unsliced)
P22_GRID_GADGETS = ((1 << 5, 6), (1 << 5, 7))
P22_KEY_PEAK_GIB = 30
# phase 23, slice 16: K2, K3, K5 and K12 past one block at N = 2^16 on
# phase 18's widths (Q, P and K of 14, 15 and 15 primes with 2^17-th roots,
# from the package's prime search: no scheme draws such primes, so the
# op layer is the path), K5 also from bench_bfv's direct 4 -> 5; K12's
# ceiling at these degrees on the whole card (at 2^16 split, and chunked
# named beside it), and the repetitions of its record rows
P23_N, P23_LOGNS, P23_ROW_REPS = 1 << 16, (15, 16, 17), 8
P23_LAYOUTS = {"tensor_eval4": {"chunked": 2}, "ks_contract": {"chunked": 1},
               "ext_ntt": {"chunked direct": 1, "chunked staged": 1},
               "ntt_smem_ceiling": {"block": 4, "split": 4, "chunked": 4}}
# phase 24, slice 17: K6, tensor_mul, K7 and K8 past one block at N = 2^16
# through the op layer: phase 18's widths for the tensors (Q 14, P 15
# primes with 2^17-th roots, from Q staged; bench_bfv's 4 -> 5 direct) and
# phase 19's gadget widths for the key switches (R = L = 29 limb rows over
# the 29 primes of Q u P); the launches by layout the path must make
P24_N = 1 << 16
P24_LAYOUTS = {"tensor_mul4": {"chunked direct": 2, "chunked staged": 1},
               "tensor_mul": {"chunked": 1}, "ks_fused": {"chunked": 1},
               "ks_fused_eval": {"chunked": 1}}
CEILING_REPS, ALU_ROUNDS = 64, 1 << 16
# the bound (utils/kernel_check.bound) takes the SM count and the maximum SM
# clock that the card in hand reports; each alu_rate loop must issue at
# ALU_SHARE of its own pipe-aware bound, or the pipe model is wrong
ALU_SHARE = (0.85, 1.05)
ALU_SHORT_ROUNDS = 1024      # the timed alu_rate launch is held in such pieces
# the redesigned kernels: K1, K2, K3, K5, K6 (tensor_mul4 and, on row
# strides, tensor_mul), K7, K8 (ks_fused, ks_fused_eval), K9 (ntt), K10
# (blind_rotate) and K12 (ntt_smem_ceiling) on csrc/radix_chain.cuh, K4
# and K11 (and K5, K6) with the source count at compile time; ptxas must
# give no instance of them a stack frame or spills
RADIX_KERNELS = {"ntt_multi", "tensor_eval4", "ks_contract", "ext_ntt",
                 "base_extend", "tensor_mul4", "tensor_mul", "ks_fused",
                 "ks_fused_eval", "ntt", "blind_rotate", "ntt_smem_ceiling",
                 "base_extend_sum", "br_forward", "br_inverse", "ext_lift",
                 "ntt_top", "ntt_chunk", "brg_top_forward",
                 "brg_chunk_inverse", "brg_top_inverse", "brg_top_last",
                 "tensor_eval4_chunk", "ks_contract_chunk", "first_top",
                 "ks_mac_chunk", "brs_forward", "brs_inverse",
                 "ntt_smem_ceiling_split", "brq_forward", "brq_inverse"}
# K10's kernels by layout: the clusters', the device-memory layout's, the
# split layout's (2^16), the quarter layout's (2^17) and the grid layout's
# (past 2^17)
K10_KERNELS = {"blind_rotate_kernel": "cluster", "br_forward_kernel": "device",
               "br_inverse_kernel": "device", "brs_forward_kernel": "split",
               "brs_inverse_kernel": "split",
               "brq_forward_kernel": "quarter",
               "brq_inverse_kernel": "quarter",
               "brg_top_forward_kernel": "grid",
               "brg_chunk_inverse_kernel": "grid",
               "brg_top_inverse_kernel": "grid", "brg_top_last_kernel": "grid"}
# the kernels' JSON record has one row per entry of _cuda.KERNELS, K10's
# (its cluster layout) followed by one for its device-memory layout, one
# for its split layout, one for its quarter layout and one for its grid
# layout, and those of K2, K3,
# K5-K8 (K6 also as tensor_mul) and K12 (one block a polynomial) each by
# one for their chunked layouts past 2^15, K12's also by one for its split
# layout at 2^16
DM_ROW = "blind_rotate_dm"
QUARTER_ROW = "blind_rotate_quarter"
GRID_ROW = "blind_rotate_grid"
CHUNKED_ROW = "{}_chunked"
SPLIT_ROW = "{}_split"
# the lift (_cuda.EXT_LIFT), held against plain beside them: K5 and K6
# launch it in their staged layout and count it as their own launch
LIFT = "ext_lift"
LIFT_LAUNCHES = ("its launches count under ext_ntt and tensor_mul4, which "
                 "queue it in their staged layout")
RADIX_BATCH = 3              # the small odd batch of their every-degree sweep


def say(*parts) -> None:
    print(*parts, flush=True)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def smi(field: str) -> str:
    return run(["nvidia-smi", f"--query-gpu={field}",
                "--format=csv,noheader"]).splitlines()[0].strip()


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn over reps calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


BOOT_KERNELS = ("ntt_multi", "ks_contract", "tensor_mul4", "ks_fused",
                "base_extend")


def negacyclic_reference(a: np.ndarray, b: np.ndarray, t: int):
    """a * b mod (X^n + 1, t) by a float64 FFT of length 2n; exact here
    because every linear-convolution coefficient is below 2^31."""
    n = a.shape[-1]
    lin = np.fft.irfft(np.fft.rfft(a.astype(np.float64), 2 * n)
                       * np.fft.rfft(b.astype(np.float64), 2 * n), 2 * n)
    r = np.rint(lin)
    err = float(np.abs(lin - r).max())
    if err >= 0.25:
        raise RuntimeError(f"FFT reference not exact: rounding error {err}")
    r = r.astype(np.int64)
    return (r[..., :n] - r[..., n:]) % t, err


def negacyclic_exact(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a * b mod (X^n + 1) over Z, row by row in Python integers."""
    n = a.shape[-1]
    out = np.empty(a.shape, dtype=object)
    for idx in np.ndindex(a.shape[:-1]):
        full = np.append(np.convolve(a[idx].astype(object),
                                     b[idx].astype(object)), 0)
        out[idx] = full[:n] - full[n:]
    return out


def queued_ms(fn, reps: int, busy: torch.Tensor) -> float:
    """Device ms a call of fn on the device alone: ``reps`` calls queued
    behind 16 passes over ``busy``, so the host has enqueued them all before
    the first one runs, timed by CUDA events around the calls."""
    torch.cuda.synchronize()
    for _ in range(16):
        busy.add_(1)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    wall0 = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA card (torch.cuda.is_available() is "
                 "False); nothing was run")
    from fhe_study_tpu_torch.arith.params import TORUS_Q, RingParam
    from fhe_study_tpu_torch.models import bfv_batch, galois
    from fhe_study_tpu_torch.models import bfv_rns as R
    from fhe_study_tpu_torch.models import hybrid_ks as H
    from fhe_study_tpu_torch.models.ckks import ckks_rns as C
    from fhe_study_tpu_torch.models.gfhe.glwe import ERR_SIGMA, Param
    from fhe_study_tpu_torch.models.tfhe import bootstrap, tggsw, tglwe, tlwe
    from fhe_study_tpu_torch.ops import (_cuda, alu_bench, ext_cuda, ntt,
                                         ntt_cuda)
    from fhe_study_tpu_torch.ops.primes import ntt_primes
    from fhe_study_tpu_torch.parallel import pipeline
    from fhe_study_tpu_torch.utils import (kernel_check, profiling, prng,
                                           sass_counts)
    from fhe_study_tpu_torch.utils.kernel_check import record_calls

    dev = torch.device("cuda", 0)
    marks = [wall0]
    chunked = [k for k in _cuda.KERNELS
               if any(lay.startswith(_cuda.CHUNKED) for lay in k.layouts)]
    split = [k for k in _cuda.KERNELS if _cuda.SPLIT in k.layouts]
    record_rows = [r for k in _cuda.KERNELS for r in (
        (k.name, DM_ROW, SPLIT_ROW.format(k.name), QUARTER_ROW, GRID_ROW)
        if k is _cuda.BLIND_ROTATE
        else (k.name, CHUNKED_ROW.format(k.name), SPLIT_ROW.format(k.name))
        if k in split
        else (k.name, CHUNKED_ROW.format(k.name)) if k in chunked
        else (k.name,))]

    def row(case) -> str:
        """The record's row of a case: K10's by its layout, K2's, K3's,
        K5's and K12's past one block their chunked row, K12's split at
        2^16 its split row."""
        if case.layout == _cuda.CHUNKED:
            return CHUNKED_ROW.format(case.name)
        if case.layout == _cuda.SPLIT:
            return SPLIT_ROW.format(case.name)
        return {"device": DM_ROW, "grid": GRID_ROW,
                _cuda.QUARTER: QUARTER_ROW}.get(case.layout, case.name)

    def phase_done(label: str) -> None:
        marks.append(time.perf_counter())
        say(f"wall: phase {label} took {marks[-1] - marks[-2]:.1f} s; "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held on the "
            f"card")

    # 1. toolchain and card ------------------------------------------------
    name_limit = smi("name,power.limit")
    card = f"{torch.cuda.get_device_name(0)} ({name_limit})"
    nvcc = run([_cuda._nvcc(), "--version"]).splitlines()[-1]
    say(f"toolchain: python {sys.version.split()[0]}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc}")
    say(f"card: {card}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    clock = sm_mhz * 1e6

    def bound(nbytes, work):
        return kernel_check.bound(nbytes, work, sms, clock)

    say(f"bound: the largest of bytes over "
        f"{kernel_check.MEMORY_BYTES_PER_S / 1e12} TB/s, all integer "
        f"instructions over {kernel_check.ISSUE_PER_SM_CLOCK} a clock and SM, "
        f"and each integer pipe's issue slots (ALU; FMA, IMAD.HI and "
        f"IMAD.WIDE two slots and one ALU slot each) over "
        f"{kernel_check.PIPE_PER_SM_CLOCK} a clock and SM, on {sms} SMs at "
        f"{sm_mhz:.0f} MHz; the primitives' SASS counts (ALU, FMA, wide): "
        f"{kernel_check.BUTTERFLY_OPS} a butterfly, {kernel_check.MONT_OPS} a "
        f"Montgomery product, {kernel_check.SHOUP_OPS} a Shoup product, "
        f"{kernel_check.ADD_OPS} a modular add")
    t0 = time.perf_counter()
    _cuda.library()
    build_s = time.perf_counter() - t0
    say(f"build: {len(_cuda.KERNELS)} kernel entries from "
        f"fhe_study_tpu_torch/csrc in {build_s:.1f} s -> {_cuda.build_dir()}")
    ptxas = _cuda.ptxas_report(_cuda.build_log())
    radix_entries = [r for r in ptxas if r["kernel"].split("<")[0]
                     .removesuffix("_kernel") in RADIX_KERNELS]
    spilled = [r["kernel"] for r in radix_entries
               if (r.get("stack"), r.get("spill_stores"),
                   r.get("spill_loads")) != (0, 0, 0)]
    for r in ptxas:
        say(f"  ptxas: {r['kernel']}: {r.get('registers')} registers, "
            f"{r.get('stack')} bytes stack frame, {r.get('spill_stores')} "
            f"bytes spill stores, {r.get('spill_loads')} bytes spill loads")
    k10_entries = [r for r in radix_entries
                   if r["kernel"].split("<")[0] in K10_KERNELS]
    k10_layouts = {r["kernel"].split("<")[0] for r in k10_entries}
    if spilled or not radix_entries or k10_layouts != set(K10_KERNELS):
        raise RuntimeError(f"ptxas gave a stack frame or spills to {spilled} "
                           f"(K10's kernels built: {sorted(k10_layouts)}): "
                           "the redesigned kernels must keep their words "
                           "in registers")
    say(f"ptxas: no stack frame and no spills in the {len(radix_entries)} "
        f"instances of {sorted(RADIX_KERNELS)} ({len(k10_entries)} of "
        f"blind_rotate: its clusters' blind_rotate_kernel, br_forward and "
        f"br_inverse of its device-memory layout, brs_forward and "
        f"brs_inverse of its split layout, brq_forward and brq_inverse of "
        f"its quarter layout, and the four kernels of its grid layout; the "
        f"transforms past a block: "
        f"{sum(r['kernel'].startswith(('ntt_top', 'ntt_chunk')) for r in radix_entries)} "
        f"instances of ntt_top_kernel and ntt_chunk_kernel)")
    say(f"build: seconds a unit (compiled in parallel), then the link: "
        f"{_cuda.build_seconds(_cuda.build_log())}")
    lift_entries = [r for r in ptxas if r["kernel"].startswith("ext_lift")]
    if len(lift_entries) != 2:
        raise RuntimeError(f"the lift's instances: {lift_entries}")
    say("ptxas: the lift (ext_lift_kernel, the first launch of K5's and K6's "
        "staged layout), word and vector forms: " + "; ".join(
            f"{r['kernel']} {r['registers']} registers, {r['stack']} bytes "
            f"stack frame, {r['spill_stores']} + {r['spill_loads']} bytes "
            f"spilled" for r in lift_entries))

    phase_done("1 (toolchain and build)")

    # 2. kernels against their plain versions ------------------------------
    # the lift is held against lift_plain beside the record's kernels (its
    # launches on the paths count under K5 and K6)
    err = dict.fromkeys(record_rows + [LIFT], 0)
    checked = dict.fromkeys(record_rows + [LIFT], 0)

    def hold(name: str, label: str, got, want) -> None:
        diff = kernel_check.max_abs_err(got, want)
        if not kernel_check.equal(got, want):
            raise RuntimeError(f"{name} [{label}]: kernel != plain "
                               f"(max |diff| {diff})")
        err[name] = max(err[name], diff)
        checked[name] += 1

    def check(case, got, want) -> None:
        hold(row(case), case.label, got, want)

    gen = prng.Gen(SEED)
    for n in (N, 256):
        param = R.RnsParam(n=n, t=T, L=L, M=M)
        for case in kernel_check.cases(param, PARITY_BATCH, dev, gen):
            got, want = case.kernel(), case.plain()
            torch.cuda.synchronize()
            check(case, got, want)
    tfhe_parity = [
        *kernel_check.tfhe_cases(TFHE_N, TFHE_K, TFHE_BETA, TFHE_L, TFHE_N,
                                 PARITY_BATCH, dev, gen),
        *kernel_check.tfhe_cases(TFHE_N, TFHE_K, TFHE_BETA, TFHE_L,
                                 TFHE_N_LWE, PARITY_BATCH, dev, gen),
        *kernel_check.tfhe_cases(256, 1, 256, 3, 256, PARITY_BATCH, dev, gen)]
    for case in tfhe_parity:
        got, want = case.kernel(), case.plain()
        torch.cuda.synchronize()
        check(case, got, want)
    # the kernels on the register-resident chains, at every ring degree they
    # take: each log n has its own pass structure (K6-K8 at 2^15 on two-block
    # clusters)
    radix_checked = 0
    for logn in ntt_cuda.BLOCK_LOGNS:
        for case in kernel_check.radix_cases(logn, RADIX_BATCH, dev, gen):
            got, want = case.kernel(), case.plain()
            torch.cuda.synchronize()
            check(case, got, want)
            radix_checked += 1
    say(f"parity: ntt_multi (forward and inverse, with and without fin, "
        f"contiguous and word-offset rows), ntt (forward and inverse under a "
        f"30-bit and a 31-bit prime, aligned and word-offset int64 rows), "
        f"ntt_smem_ceiling (reps 0, 1, 3), tensor_eval4 (contiguous, strided, "
        f"unaligned rows), ks_contract ({kernel_check.KS_SWEEP_R} digit rows "
        f"over {kernel_check.KS_SWEEP_LP} primes, aligned and word-offset), "
        f"ks_fused and ks_fused_eval ({kernel_check.KS_SWEEP_R} limb rows over "
        f"{kernel_check.KS_SWEEP_LP} narrower primes, "
        f"{kernel_check.KS_BOOT_R} rows at n = 2^{kernel_check.KS_BOOT_LOGN}, "
        f"{kernel_check.KS_PATH_R} rows at n = 2^{ntt_cuda.WIDE_LOGN}, "
        f"strided and word-offset), "
        f"tensor_mul4 and tensor_mul (with and without a scale; contiguous, "
        f"strided, stacked and unaligned rows; from 1 to "
        f"{ext_cuda.MAX_SRC} source primes, 4 direct, the others staged), "
        f"ext_ntt (from 1 to {ext_cuda.MAX_SRC} source primes, 2 and 4 "
        f"direct, the others staged), the lift alone (from 1 to "
        f"{ext_cuda.MAX_SRC} source primes, unsigned and centered, vector "
        f"and word forms), "
        f"ks_contract, ks_fused and ks_fused_eval at R="
        f"{kernel_check.KS_MAPS_R} over {kernel_check.KS_MAPS_LP} primes at "
        f"n = 2^{kernel_check.KS_MAPS_LOGN}, base_extend_sum (from 1 to "
        f"{ext_cuda.MAX_SRC} source primes to "
        f"{kernel_check.EXT_SUM_SWEEP_LD}, vector and word forms) and "
        f"base_extend (from {kernel_check.EXT_SWEEP_LS} to "
        f"{kernel_check.EXT_SWEEP_LD} primes, unsigned and centered, with and "
        f"without the epilogue, vector and word forms; from 16 to "
        f"{ext_cuda.MAX_SRC} to 5) == plain (torch.equal) at every n each "
        f"takes in one block, 2^{ntt_cuda.BLOCK_LOGNS[0]} .. "
        f"2^{ntt_cuda.BLOCK_LOGNS[-1]} "
        f"(tensor_mul4, tensor_mul, ks_fused and ks_fused_eval at "
        f"2^{ntt_cuda.WIDE_LOGN} on two-block clusters), batch "
        f"{RADIX_BATCH}: {radix_checked} variants")
    # K10 in both layouts at every ring degree it takes, on batches beyond
    # the clusters the card holds at once
    k10_checked = dict.fromkeys(_cuda.BLIND_ROTATE.layouts, 0)
    t0 = time.perf_counter()
    for case in kernel_check.blind_rotate_sweep(dev, gen):
        got, want = case.kernel(), case.plain()
        torch.cuda.synchronize()
        check(case, got, want)
        k10_checked[case.layout] += 1
    t_block = time.perf_counter() - t0
    # past 2^15: K10's split layout at every (C, l, w) of the reference's
    # gate at 2^16, its quarter layout at every one at 2^17 and its grid
    # layout at one shape at each larger n; K1 and K9 across blocks;
    # each new shape also timed (its kernel, best of 3) beside its bound and
    # the bound of its own traffic (the top passes' words; K10's a step,
    # kernel_check.cmux_step_bytes)
    shares = {}

    def own_bytes(case) -> tuple:
        """(n, the bytes of the kernel's own traffic) of a case past one
        block: K10's steps (kernel_check.cmux_step_bytes), the transform
        kernels' inputs and outputs and their top passes' words
        (kernel_check.own_bytes)."""
        if case.name == "blind_rotate":
            shifts, acc0, ev1 = case.args[:3]
            n = case.args[6]
            steps, B = shifts.shape
            return n, steps * sum(kernel_check.cmux_step_bytes(
                n, acc0.shape[1], ev1.shape[2], B,
                layout=case.layout).values())
        return case.n, kernel_check.own_bytes(case)

    def share(case) -> None:
        k_ms = min(time_ms(case.kernel, 1, warmup=0) for _ in range(3))
        n, own = own_bytes(case)
        b, bo = bound(case.bytes, case.ops), bound(own, case.ops)
        if k_ms < b.ms:
            raise RuntimeError(f"{case.name} [{case.label}]: the kernel's "
                               f"{k_ms:.4f} ms is under its bound {b}")
        shares.setdefault((case.name, n, case.layout), []).append(
            (k_ms, b.ms / k_ms, bo.ms / k_ms))

    t1 = time.perf_counter()
    for case in kernel_check.blind_rotate_wide_sweep(dev, SEED + 70):
        got, want = case.kernel(), case.plain()
        torch.cuda.synchronize()
        check(case, got, want)
        share(case)
        k10_checked[case.layout] += 1
    t2 = time.perf_counter()
    wide_checked = {}
    for case in kernel_check.wide_transform_cases(dev, SEED + 71):
        got, want = case.kernel(), case.plain()
        torch.cuda.synchronize()
        check(case, got, want)
        share(case)
        wide_checked[case.name] = wide_checked.get(case.name, 0) + 1
    t_ops = time.perf_counter()
    ops_checked = {}
    for case in kernel_check.wide_op_cases(dev, SEED + 72):
        got, want = case.kernel(), case.plain()
        torch.cuda.synchronize()
        check(case, got, want)
        del got, want
        share(case)
        ops_checked[case.name] = ops_checked.get(case.name, 0) + 1
    del case
    for (name, n, layout), rs in sorted(shares.items()):
        ks, bs, os_ = zip(*rs)
        say(f"timing: {name} at n = {n} {layout} (phase 2's shapes, kernel "
            f"alone, "
            f"best of 3): {len(rs)} variants, {min(ks):.4f} .. "
            f"{max(ks):.4f} ms, {min(bs):.3f} .. {max(bs):.3f} of the bound, "
            f"{min(os_):.3f} .. {max(os_):.3f} of the bound of its own "
            f"traffic [{card}]")
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    say(f"parity: past one block, ntt_multi (forward with and without fin, "
        f"inverse with n^-1 and with fin, contiguous and word-offset rows) "
        f"and ntt (both ways under each prime, aligned and word-offset int64 "
        f"rows) == plain (torch.equal) at n = 2^"
        f"{kernel_check.WIDE_SWEEP_LOGNS} on batches "
        f"{kernel_check.WIDE_SWEEP_B}: {wide_checked} variants in "
        f"{t_ops - t2:.1f} s; on their chunked schedules, tensor_eval4 (with "
        f"and without a scale, on strided views), ks_contract (R in "
        f"{kernel_check.WIDE_OPS_R}, aligned and edm one word off), ext_ntt "
        f"(from {kernel_check.WIDE_OPS_LS} source primes: 2 and 4 direct, "
        f"the others staged) and ntt_smem_ceiling (reps "
        f"{kernel_check.WIDE_OPS_REPS}), tensor_mul4 (from "
        f"{kernel_check.WIDE_MUL4_LS} source primes: None without a source "
        f"basis, 4 direct, 3 staged), tensor_mul (stacked), ks_fused and "
        f"ks_fused_eval (R in {kernel_check.WIDE_OPS_R}, c_limbs and adds "
        f"strided) == plain (torch.equal) at the same "
        f"n, each variant at one of those batches in turn: {ops_checked} "
        f"variants in {t3 - t_ops:.1f} s (ntt_smem_ceiling at "
        f"2^{alu_bench.SPLIT_LOGN} split and chunked); blind_rotate's split "
        f"layout at every (C, l, w) of the reference's gate at "
        f"n = 2^{kernel_check.BR_SPLIT_LOGN} "
        f"({len(kernel_check.gate_shapes(1 << kernel_check.BR_SPLIT_LOGN))} "
        f"shapes), its quarter layout at every one at "
        f"n = 2^{kernel_check.BR_QUARTER_LOGN} "
        f"({len(kernel_check.gate_shapes(1 << kernel_check.BR_QUARTER_LOGN))}"
        f" shapes; (steps, B) in turn from {kernel_check.BR_GRID_RUNS}) and "
        f"its grid layout at (log n, C, l) in {kernel_check.BR_GRID_WIDER} "
        f"at the gate's widest digit, key planes one word off at the first "
        f"shape of each (n, C): {k10_checked['split']} split, "
        f"{k10_checked[_cuda.QUARTER]} quarter and {k10_checked['grid']} "
        f"grid variants in {t2 - t1:.1f} s")
    say(f"parity: blind_rotate == plain (torch.equal) for C in "
        f"{kernel_check.BR_SWEEP_C}, l in {kernel_check.BR_SWEEP_L}, every n "
        f"from 2^{_cuda.BLIND_ROTATE.logn[0]} to "
        f"2^{ntt_cuda.CHUNK_LOGN}, steps in "
        f"{kernel_check.BR_SWEEP_STEPS}: on two-block clusters (B in "
        f"{kernel_check.BR_SWEEP_B}; staged and direct key planes) and with "
        f"the working set in device memory (B in "
        f"{kernel_check.BR_DM_SWEEP_B}, 67 left out from "
        f"2^{kernel_check.BR_DM_WIDE_LOGN}; the widest digit of the "
        f"reference's gate), at (log n, C, l, w) in "
        f"{kernel_check.BR_DM_SMALL} and C = 1, and the key planes one word "
        f"off, with the split, quarter and grid layouts' above: "
        f"{k10_checked} "
        f"variants by layout in {t_block:.1f} s (past 2^15 "
        f"{t2 - t1:.1f} s)")
    del tfhe_parity
    say(f"parity: kernel == plain (torch.equal) for "
        f"{sum(checked.values())} variants at n={N} and n=256 (batch "
        f"{PARITY_BATCH}) and, for the TFHE kernels, at n={TFHE_N} over "
        f"{TFHE_N} and {TFHE_N_LWE} steps and at n=256: {checked}")

    phase_done("2 (kernels against plain)")

    # 3-5. the paths at full width -----------------------------------------
    path_launches = {}

    def drive(label: str, expects: tuple, fn):
        """Run one path with the launch counters set to 0 just before and
        read just after; every kernel it should go through must have been
        launched."""
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _cuda.launches()
        counts[DM_ROW] = _cuda.BLIND_ROTATE.by_layout["device"]
        counts[GRID_ROW] = _cuda.BLIND_ROTATE.by_layout["grid"]
        counts[QUARTER_ROW] = _cuda.BLIND_ROTATE.by_layout[_cuda.QUARTER]
        for k in chunked:
            counts[CHUNKED_ROW.format(k.name)] = _cuda.chunked_launches(k)
        for k in split:
            counts[SPLIT_ROW.format(k.name)] = k.by_layout[_cuda.SPLIT]
        path_launches[label] = counts
        unlaunched = [k for k in expects if counts[k] == 0]
        if unlaunched:
            raise RuntimeError(f"{label}: never launched {unlaunched}")
        say(f"path: {label} in {seconds:.2f} s (host clock, first call); "
            f"launches { {k: v for k, v in counts.items() if v} }")
        return out

    def verify(label: str, rec, ref, what: str) -> None:
        got = rec.cpu().numpy()
        bad = int((got != ref).sum()) if got.shape == ref.shape else ref.size
        if bad:
            raise RuntimeError(f"{label}: {bad} of {ref.size} decrypted "
                               f"coefficients differ from {what}")
        say(f"verify: {label}: decrypted == {what} for all {ref.shape[0]} x "
            f"{ref.shape[1]} coefficients")

    param = R.RnsParam(n=N, t=T, L=L, M=M)
    gen = prng.Gen(SEED + 1)
    st = {}

    def eval_path():
        st["sk"], st["pk"] = R.new_key(gen, param, dev)
        st["hk"] = R.hybrid_rlk1(gen, param, st["sk"])
        st["m"] = [prng.uniform_mod(gen, (BATCH, N), T, dev)
                   for _ in range(2)]
        st["c"] = [R.encrypt(gen, param, st["pk"], m, batch=(BATCH,))
                   for m in st["m"]]
        st["e"] = [R.to_evals(param, c) for c in st["c"]]
        ce = R.mul_e(param, st["hk"], *st["e"])
        return ce, R.decrypt(param, st["sk"], R.from_evals(param, ce))

    shape = f"N={N} L={L} M={M} K=2 t={T} B={BATCH}"
    ce, rec = drive(
        f"keygen -> encrypt -> to_evals -> mul_e (HRLK) -> from_evals -> "
        f"decrypt at {shape}",
        ("ntt_multi", "tensor_eval4", "ks_contract", "base_extend",
         "ext_ntt"), eval_path)
    for name, v in zip(("e0q", "e1q", "e0p", "e1p"), ce):
        want = (len(param.qs) if name.endswith("q") else len(param.ps),
                BATCH, N)
        if tuple(v.shape) != want or v.dtype != torch.int32:
            raise RuntimeError(f"CTE.{name}: {tuple(v.shape)} {v.dtype}")
    sk, hk, (c1, c2), (x, y) = st["sk"], st["hk"], st["c"], st["e"]
    mul_e_digest = pipeline.digest(ce)      # phase 17 holds its ranks to it
    m1, m2 = (m.cpu().numpy() for m in st["m"])
    product, fft_err = negacyclic_reference(m1, m2, T)
    fft = f"the numpy FFT negacyclic product (rounding error {fft_err:.2e})"
    verify("mul_e (HRLK)", rec, product, fft)

    rlk = R.rlk_key(gen, param, sk)
    sk2, _ = R.new_key(gen, param, dev)
    ksk = R.ksk_key(gen, param, sk, sk2)

    rec = drive(f"mul (RLK) -> decrypt at {shape}",
                ("tensor_mul4", "base_extend", "ks_fused", "ntt_multi"),
                lambda: R.decrypt(param, sk, R.mul(param, rlk, c1, c2)))
    verify("mul (RLK)", rec, product, fft)
    rec = drive(f"mul (HRLK) -> decrypt at {shape}",
                ("tensor_mul4", "base_extend", "ntt_multi", "ks_contract"),
                lambda: R.decrypt(param, sk, R.mul(param, hk, c1, c2)))
    verify("mul (HRLK)", rec, product, fft)
    rec = drive(
        f"to_evals -> mul_e (RLK) -> from_evals -> decrypt at {shape}",
        ("ntt_multi", "tensor_eval4", "base_extend", "ks_fused_eval",
         "ext_ntt"),
        lambda: R.decrypt(param, sk, R.from_evals(param, R.mul_e(
            param, rlk, R.to_evals(param, c1), R.to_evals(param, c2)))))
    verify("mul_e (RLK)", rec, product, fft)
    rec = drive(f"key_switch -> decrypt under the second key at {shape}",
                ("ks_fused", "ntt_multi"),
                lambda: R.decrypt(param, sk2, R.key_switch(param, ksk, c1)))
    verify("key_switch", rec, m1, "the plaintext that was encrypted")
    t_q = (T,) * L
    stacked = drive(
        f"tensor_mul_multi on the stacked ciphertext pair at {shape}",
        ("tensor_mul",),
        lambda: ntt.tensor_mul_multi(
            torch.stack([c1.c0, c1.c1, c2.c0, c2.c1], dim=-2), param.qs,
            scale=t_q))
    x4 = torch.stack([c1.c0, c1.c1, c2.c0, c2.c1], dim=-2)
    if not torch.equal(stacked, ntt_cuda.tensor_mul_plain(x4, param.qs,
                                                          scale=t_q)):
        raise RuntimeError("tensor_mul_multi != its plain version on the "
                           "stacked ciphertexts")
    if not torch.equal(stacked, ntt.tensor_mul4(*c1, *c2, param.qs,
                                                scale=t_q)):
        raise RuntimeError("tensor_mul_multi != tensor_mul4 on the same "
                           "ciphertexts")
    say("verify: tensor_mul_multi == tensor_mul_plain == tensor_mul4 "
        "(torch.equal) on the ciphertexts whose product decrypt-verified in "
        "mul above")

    lin = R.RnsParam(n=LIN_N, t=T, L=LIN_L, M=LIN_M)
    lin_shape = f"N={LIN_N} L={LIN_L} M={LIN_M} t={T} B={LIN_BATCH}"

    def linear_step():
        st["lsk"], pk = R.new_key(gen, lin, dev)
        st["lm"] = [prng.uniform_mod(gen, (LIN_BATCH, LIN_N), T, dev)
                    for _ in range(2)]
        cts = [R.encrypt(gen, lin, pk, m, batch=(LIN_BATCH,))
               for m in st["lm"]]
        st["lem"] = R.pt_to_evals(lin, st["lm"][1])
        st["le"] = [R.to_evals(lin, c) for c in cts]
        step = R.mul_pt_e(lin, R.add_e(lin, *st["le"]), st["lem"])
        return R.decrypt(lin, st["lsk"], R.from_evals(lin, step))

    rec = drive(f"linear: pt_to_evals, to_evals x 2, mul_pt_e(add_e) -> "
                f"from_evals -> decrypt at {lin_shape}",
                ("ntt_multi", "ext_ntt"), linear_step)
    lm1, lm2 = (m.cpu().numpy() for m in st["lm"])
    product, fft_err = negacyclic_reference((lm1 + lm2) % T, lm2, T)
    verify("linear step (m1 + m2) * m2", rec, product,
           f"the numpy FFT negacyclic product (rounding error {fft_err:.2e})")

    phase_done("3-5 (BFV paths)")

    # 6. timing ------------------------------------------------------------
    def chain_of(step, start):
        def chain():
            c = start
            for _ in range(CHAIN):
                c = step(c)
            return c
        return chain

    def per_op_launches(fn) -> dict:
        _cuda.reset_launches()
        fn()
        return {k: v for k, v in _cuda.launches().items() if v}

    chains = [
        ("mul_e (HRLK)", "ct-mul/s", BATCH,
         lambda c: R.mul_e(param, hk, c, y), x),
        ("mul_e (RLK)", "ct-mul/s", BATCH,
         lambda c: R.mul_e(param, rlk, c, y), x),
        ("mul (RLK)", "ct-mul/s", BATCH,
         lambda c: R.mul(param, rlk, c, c2), c1),
        ("mul (HRLK)", "ct-mul/s", BATCH,
         lambda c: R.mul(param, hk, c, c2), c1),
        ("linear mul_pt_e(add_e)", "ops/s", LIN_BATCH,
         lambda c: R.mul_pt_e(lin, R.add_e(lin, c, st["le"][1]), st["lem"]),
         st["le"][0]),
    ]
    for label, unit, batch, step, start in chains:
        per_op = per_op_launches(lambda: step(start))
        chain = chain_of(step, start)
        chain()                                       # warm up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = [time_ms(chain, 1, warmup=0) for _ in range(3)]
        peak = torch.cuda.max_memory_allocated()
        best = min(runs)
        say(f"timing: chain of {CHAIN} {label} at B={batch}: runs "
            f"{[round(r, 3) for r in runs]} ms, best {best:.3f} ms = "
            f"{best / CHAIN:.3f} ms per op = "
            f"{batch * CHAIN / (best / 1e3):.1f} {unit}; peak device memory "
            f"{peak / 2**30:.2f} GiB; launches per op {per_op} [{card}]")
    # a kernel's ms, plain_ms and bound_ms: one call of each of its variants
    # at the paths' shapes, summed
    ms = dict.fromkeys(record_rows, 0.0)
    plain_ms, byte_ms, op_ms, bound_ms = dict(ms), dict(ms), dict(ms), dict(ms)
    gen = prng.Gen(SEED + 2)

    case_ms, timed_chains = {}, []

    def time_case(case) -> None:
        check(case, case.kernel(), case.plain())
        k_ms = time_ms(case.kernel, case.kernel_reps)
        case_ms[case.label] = k_ms
        if case.butterflies:
            timed_chains.append(case)
        p_ms = time_ms(case.plain, case.plain_reps, warmup=case.plain_warmup)
        b = bound(case.bytes, case.ops)
        if k_ms < b.ms:
            raise RuntimeError(
                f"{case.name} [{case.label}]: the kernel's {k_ms:.4f} ms is "
                f"under its bound {b}: the bound is no bound")
        ms[row(case)] += k_ms
        plain_ms[row(case)] += p_ms
        byte_ms[row(case)] += b.bytes_ms
        op_ms[row(case)] += b.ops_ms
        bound_ms[row(case)] += b.ms
        say(f"timing: {case.name:13s} {case.label:48s} kernel {k_ms:8.3f} ms"
            f"  plain {p_ms:9.3f} ms  bound {b.ms:7.4f} ms by {b.term} "
            f"(bytes {b.bytes_ms:.4f}, issue {b.issue_ms:.4f}, ALU "
            f"{b.alu_ms:.4f}, FMA {b.fma_ms:.4f}; the kernel at "
            f"{b.ms / k_ms:.3f} of the bound, {b.issue_only_ms / k_ms:.3f} of "
            f"the issue-only bound {b.issue_only_ms:.4f})  [{card}]")

    for case in (kernel_check.cases(param, BATCH, dev, gen)
                 + kernel_check.linear_cases(lin, LIN_BATCH, dev, gen)):
        time_case(case)
    # the BFV state is done with: free it, so that the TFHE phases' peak
    # memory is their own
    del case, chains, step, start, chain, sk, sk2, hk, rlk, ksk, c1, c2
    del x, y, ce, rec, stacked, x4
    st.clear()
    torch.cuda.empty_cache()

    phase_done("6 (BFV timing)")

    # 7. TFHE: the full chain ------------------------------------------------
    tp = Param(ERR_SIGMA, RingParam(TORUS_Q, TFHE_N), TFHE_K, TFHE_T)
    gadget = dict(beta=TFHE_BETA, l=TFHE_L, beta_ks=TFHE_BETA_KS,
                  l_ks=TFHE_L_KS)
    tshape = (f"N={TFHE_N} K={TFHE_K} t={TFHE_T} B={TFHE_BATCH} "
              f"beta={TFHE_BETA} l={TFHE_L} beta_ks={TFHE_BETA_KS} "
              f"l_ks={TFHE_L_KS}")
    gen = prng.Gen(SEED + 3)
    table = bootstrap.compute_lookup_table_standard(tp, dev)
    msgs = torch.arange(TFHE_BATCH, device=dev) % (TFHE_T // 2)
    ts = {}

    def decoded(s_key, ct):
        return tlwe.decode(tp, tlwe.decrypt(tp.lwe(), s_key, ct))

    def verify_messages(label: str, got) -> None:
        bad = int((got != msgs).sum())
        if tuple(got.shape) != (TFHE_BATCH,) or bad:
            raise RuntimeError(f"{label}: {bad} of {TFHE_BATCH} bootstrapped "
                               "messages differ from the ones encrypted")
        say(f"verify: {label}: decode(decrypt) == m for all {TFHE_BATCH} "
            "messages")

    def full_path():
        s, _ = tglwe.new_key(gen, tp, dev)
        ts["s_flat"] = tglwe.sk_to_tlwe(s)
        ts["btk"], s_out = bootstrap.new_bootstrapping_key(
            gen, tp, s, s_lwe_out=ts["s_flat"], **gadget)
        ts["s"] = s
        ts["evals"] = bootstrap.precompute_btk_evals(tp, ts["btk"])
        ts["c"] = tlwe.encrypt_uniform(gen, tp.lwe(), ts["s_flat"],
                                       tlwe.encode(tp, msgs),
                                       batch=(TFHE_BATCH,))
        out = bootstrap.bootstrap(tp, ts["btk"], table, ts["c"],
                                  mode="standard", btk_evals=ts["evals"],
                                  **gadget)
        return out, decoded(s_out, out)

    out, got = drive(f"tglwe.new_key -> new_bootstrapping_key -> "
                     f"precompute_btk_evals -> encrypt_uniform -> bootstrap "
                     f"-> decrypt at {tshape}", ("ntt", "blind_rotate"),
                     full_path)
    if int(ts["c"].a.max()) <= 1 << 60:
        raise RuntimeError("the ciphertext masks are not uniform")
    if tuple(out.a.shape) != (TFHE_BATCH, tp.kn) or out.a.dtype != torch.int64:
        raise RuntimeError(f"bootstrap output: {tuple(out.a.shape)}")
    verify_messages(f"bootstrap ({TFHE_N} CMux steps)", got)
    s_flat, btk, evals, ct = ts["s_flat"], ts["btk"], ts["evals"], ts["c"]

    stepwise = drive(
        f"blind_rotation(fused=False), {TFHE_N} steps of cmux_evals, at "
        f"{tshape}", ("ntt_multi",),
        lambda: bootstrap.blind_rotation(
            tp, btk, table, ct, TFHE_BETA, TFHE_L, btk_evals=evals,
            fused=False))
    fused = bootstrap.blind_rotation(tp, btk, table, ct, TFHE_BETA, TFHE_L,
                                     btk_evals=evals)
    if not (torch.equal(fused.a, stepwise.a)
            and torch.equal(fused.b, stepwise.b)):
        raise RuntimeError("blind_rotate kernel != the step-by-step chain")
    say(f"verify: blind_rotate (one launch) == {TFHE_N} steps of cmux_evals "
        f"(torch.equal) on the {TFHE_BATCH} ciphertexts")
    del stepwise, fused

    phase_done("7 (TFHE full chain)")

    # 8. TFHE: the keyswitch-first pipeline ---------------------------------
    def short_path():
        ts["sbtk"] = bootstrap.new_short_bootstrapping_key(
            gen, tp, ts["s"], n_lwe=TFHE_N_LWE, **gadget)
        ts["sevals"] = bootstrap.precompute_short_btk_evals(tp, ts["sbtk"])
        first = bootstrap.bootstrap_short(tp, ts["sbtk"], table, ct,
                                          btk_evals=ts["sevals"], **gadget)
        second = bootstrap.bootstrap_short(tp, ts["sbtk"], table, first,
                                           btk_evals=ts["sevals"], **gadget)
        return decoded(s_flat, first), decoded(s_flat, second)

    got1, got2 = drive(
        f"new_short_bootstrapping_key(n_lwe={TFHE_N_LWE}) -> "
        f"precompute_short_btk_evals -> bootstrap_short x 2 -> decrypt at "
        f"{tshape}", ("ntt", "blind_rotate"), short_path)
    verify_messages(f"bootstrap_short ({TFHE_N_LWE} CMux steps)", got1)
    verify_messages("bootstrap_short of its own output", got2)
    sbtk, sevals = ts["sbtk"], ts["sevals"]

    phase_done("8 (TFHE short pipeline)")

    # 9. TFHE timing ---------------------------------------------------------
    def chain_of_bootstraps(step):
        def chain():
            c = ct
            for _ in range(TFHE_CHAIN):
                c = step(c)
            return c
        return chain

    pipelines = [
        (f"bootstrap ({TFHE_N} steps)", lambda c: bootstrap.bootstrap(
            tp, btk, table, c, mode="standard", btk_evals=evals, **gadget)),
        (f"bootstrap_short ({TFHE_N_LWE} steps)",
         lambda c: bootstrap.bootstrap_short(tp, sbtk, table, c,
                                             btk_evals=sevals, **gadget)),
    ]
    for label, step in pipelines:
        per_op = per_op_launches(lambda: step(ct))
        chain = chain_of_bootstraps(step)
        verify_messages(f"chain of {TFHE_CHAIN} {label}",
                        decoded(s_flat, chain()))          # and warm up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = [time_ms(chain, 1, warmup=0) for _ in range(3)]
        peak = torch.cuda.max_memory_allocated()
        best = min(runs)
        say(f"timing: chain of {TFHE_CHAIN} {label} at B={TFHE_BATCH}: runs "
            f"{[round(r, 3) for r in runs]} ms, best {best:.3f} ms = "
            f"{best / TFHE_CHAIN:.3f} ms per batch = "
            f"{best / TFHE_CHAIN / TFHE_BATCH:.4f} ms per bootstrap = "
            f"{TFHE_BATCH * TFHE_CHAIN / (best / 1e3):.1f} bootstraps/s; "
            f"peak device memory {peak / 2**30:.2f} GiB; launches per "
            f"bootstrap {per_op} [{card}]")
    # the parts of a bootstrap outside the blind-rotation kernel
    rotated = bootstrap.blind_rotation(tp, btk, table, ct, TFHE_BETA, TFHE_L,
                                       btk_evals=evals)
    extracted = tglwe.sample_extraction(tp, rotated, 0)
    parts = [
        ("blind_rotation (mod switch, table rotation, the kernel)",
         lambda: bootstrap.blind_rotation(tp, btk, table, ct, TFHE_BETA,
                                          TFHE_L, btk_evals=evals)),
        ("sample_extraction",
         lambda: tglwe.sample_extraction(tp, rotated, 0)),
        (f"tlwe.key_switch {tp.kn} -> {tp.kn}",
         lambda: tlwe.key_switch(tp.lwe(), TFHE_BETA_KS, TFHE_L_KS,
                                 tlwe.KSK(btk.ksk_a, btk.ksk_b), extracted)),
        (f"tlwe.key_switch {tp.kn} -> {TFHE_N_LWE}",
         lambda: tlwe.key_switch(tp.lwe(), TFHE_BETA_KS, TFHE_L_KS,
                                 tlwe.KSK(sbtk.ksk_a, sbtk.ksk_b), ct)),
    ]
    for label, fn in parts:
        torch.cuda.reset_peak_memory_stats()
        say(f"timing: part {label} at B={TFHE_BATCH}: {time_ms(fn, 3):.3f} "
            f"ms; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    del rotated, extracted, parts, pipelines
    gen = prng.Gen(SEED + 4)
    for case in kernel_check.ntt_cases(TFHE_N, TFHE_K, TFHE_L, TFHE_N, dev,
                                       gen):
        time_case(case)
    for steps in (TFHE_N, TFHE_N_LWE):
        time_case(kernel_check.blind_rotate_case(
            TFHE_N, TFHE_K, TFHE_BETA, TFHE_L, steps, TFHE_BATCH, dev, gen))
    step_ops = kernel_check.cmux_step_ops(TFHE_N, TFHE_K + 1, TFHE_L)
    say(f"work: one CMux step on one ciphertext at N={TFHE_N}, C="
        f"{TFHE_K + 1}, l={TFHE_L}: {sum(step_ops.values())} 32-bit integer "
        f"operations {step_ops}")

    del sbtk, sevals, btk, evals, ct, ts
    torch.cuda.empty_cache()

    phase_done("9 (TFHE timing)")

    # 10. the last three kernels and the CKKS variants, against plain --------
    cp = C.Param(n=CK_N, L=CK_L, delta=CK_DELTA)
    gen = prng.Gen(SEED + 5)
    for n in (CK_N, 256):
        small = C.Param(n=n, L=CK_L, delta=CK_DELTA)
        for case in (kernel_check.ckks_cases(small, PARITY_BATCH, CK_K, dev,
                                             gen)
                     + kernel_check.ext_sum_cases(n, PARITY_BATCH, dev, gen)
                     + kernel_check.bench_cases(2 * n if n == CK_N else n,
                                                PARITY_BATCH, dev, gen)):
            got, want = case.kernel(), case.plain()
            torch.cuda.synchronize()
            check(case, got, want)
    del case, got, want
    missing = [k for k, v in checked.items() if v == 0]
    if missing:
        raise RuntimeError(f"kernels with no parity case: {missing}")
    say(f"parity: kernel == plain (torch.equal) for the CKKS variants, "
        f"base_extend_sum (also == the whole conversion, unsigned and "
        f"centered) and the measuring loops at n={CK_N} (loops: n={2 * CK_N})"
        f" and n=256, batch {PARITY_BATCH}: {checked}")
    listing = sass_counts.disassemble()
    sass = sass_counts.loop_counts(listing)
    sass_per = {op: sass[op]["per_word_round"] for op in alu_bench.OPS}
    sass_pipes = {op: sass[op]["pipes"] for op in alu_bench.OPS}
    # the ceiling's reps loop must load what one transform loads: a twiddle
    # load hoisted out of it would make the ceiling do less than the kernels
    loops = sass_counts.ceiling_loops(listing)
    chain = {logn: sass_counts.chain_loads(logn)
             for logn in ntt_cuda.BLOCK_LOGNS}
    if loops != chain:
        raise RuntimeError(f"ntt_smem_ceiling's loops (global loads, "
                           f"barriers) {loops} != one transform's {chain}")
    say(f"sass: the reps loop of ntt_smem_ceiling_kernel holds one forward "
        f"transform's (global loads, barriers) at every log n: {loops}")
    for op in alu_bench.OPS:
        same = ("as recorded" if sass_pipes[op] == alu_bench.OP_PIPES[op]
                else f"NOT the recorded {alu_bench.OP_PIPES[op]}: another "
                f"compiler; this build's counts are used below")
        say(f"sass: alu_rate {op:10s} {sass_per[op]:.4f} instructions a "
            f"{'butterfly' if op == 'butterfly' else 'word'} and round in "
            f"this build, (ALU, FMA, wide) {sass_pipes[op]} ({same}): "
            f"{sass[op]['loop']}")

    phase_done("10 (last kernels and CKKS variants)")

    # 11. RNS-CKKS at full width ---------------------------------------------
    cshape = (f"N={CK_N} L={CK_L} K={CK_K} "
              f"delta=2^{round(np.log2(CK_DELTA))} B={CK_BATCH}")
    rng = np.random.default_rng(SEED)
    z1, z2 = (rng.uniform(-1, 1, (CK_BATCH, CK_N // 2)) for _ in range(2))
    zero = torch.zeros((CK_BATCH, CK_N // 2), dtype=torch.float64, device=dev)
    cs = {}

    def on_card(a):
        return torch.from_numpy(a).to(dev)

    def slots_of(p, key, c):
        rr, ri = C.decode(p, C.decrypt_to_coeffs(p, key, c))
        return rr.cpu().numpy() + 1j * ri.cpu().numpy()

    def verify_slots(label: str, got, want, atol: float) -> None:
        worst = float(np.abs(got - want).max())
        if (got.shape != want.shape or not np.isfinite(got).all()
                or not np.allclose(got, want, atol=atol)):
            raise RuntimeError(f"{label}: decoded slots differ from the "
                               f"plaintext result by up to {worst:.3e} "
                               f"(atol {atol})")
        say(f"verify: {label}: decoded == plaintext in all {want.shape[0]} x "
            f"{want.shape[1]} slots (max |diff| {worst:.3e}, atol {atol})")

    def ckks_path():
        cs["sk"], cs["pk"] = C.new_key(gen, cp, dev)
        cs["hrlk"] = C.hybrid_rlk(gen, cp, cs["sk"], K=CK_K)
        cs["c"] = [C.encrypt(gen, cp, cs["pk"],
                             C.encode(cp, on_card(z), zero),
                             batch=(CK_BATCH,)) for z in (z1, z2)]
        c1, c2 = cs["c"]
        out, p2 = C.mul_hybrid(cp, cs["hrlk"], c1, C.add(cp, c1, c2))
        return out, p2, slots_of(p2, cs["sk"], out)

    out, p2, got = drive(
        f"ckks: new_key -> hybrid_rlk -> encode, encrypt x 2 -> add -> "
        f"mul_hybrid -> decrypt_to_coeffs -> decode at {cshape}",
        ("ntt_multi", "tensor_mul4", "ks_fused", "base_extend"), ckks_path)
    if (p2.L != CK_L - 1 or tuple(out.c0.shape) != (CK_L - 1, CK_BATCH, CK_N)
            or out.c0.dtype != torch.int32):
        raise RuntimeError(f"mul_hybrid output: {p2}, {tuple(out.c0.shape)}")
    verify_slots("add + mul_hybrid", got, ((z1 + z2) * z1).astype(complex),
                 1e-2)
    csk, hrlk, (c1, c2) = cs["sk"], cs["hrlk"], cs["c"]

    def moved(z, g):
        perm, conj = galois.ckks_slot_perm(CK_N, g)
        return np.where(conj, z[:, perm].conj(), z[:, perm]).astype(complex)

    t0 = time.perf_counter()
    gs = [galois.rotation_element(CK_N, k) for k in CK_STEPS]
    for g in gs:
        galois.eval_perm_on(CK_N, g, dev)
        galois._map_on(CK_N, g, dev)
    say(f"host: eval_perm and galois_map of {len(gs)} Galois elements at "
        f"n={CK_N} in {time.perf_counter() - t0:.2f} s (Python integers, "
        "cached per (n, g); outside every timed window)")

    def rotations():
        cs["hgk"] = [H.galois_key_hybrid(gen, cp, csk, g, K=CK_K)
                     for g in gs]
        first = H.rotate_hybrid(cp, cs["hgk"][0], c1, gs[0])
        cs["edm"] = H.hoist_digits(cp, c1.c1, K=CK_K)
        hoisted = [H.rotate_hoisted(cp, k, c1, g, cs["edm"])
                   for k, g in zip(cs["hgk"], gs)]
        return ([slots_of(cp, csk, first)]
                + [slots_of(cp, csk, r) for r in hoisted])

    rot = drive(f"ckks rotations: galois_key_hybrid x {len(gs)} -> "
                f"rotate_hybrid; hoist_digits -> rotate_hoisted x {len(gs)} "
                f"-> decode at {cshape}",
                ("ntt_multi", "ks_fused", "ks_contract", "base_extend"),
                rotations)
    verify_slots(f"rotate_hybrid by {CK_STEPS[0]}", rot[0],
                 moved(z1, gs[0]), 1e-2)
    for k, g, got in zip(CK_STEPS, gs, rot[1:]):
        verify_slots(f"rotate_hoisted by {k}", got, moved(z1, g), 1e-2)
    hgk, edm = cs["hgk"], cs["edm"]

    # base_extend_sum: no function of either package calls it (the hoisted
    # rotations it was written for go through the whole conversion), so it
    # is driven through its dispatcher, on the accumulator that this path's
    # key switch hands the P-division
    ks = H.ks_ext_primes(cp, CK_K)
    acc0, _ = ntt.ks_fused_multi(c1.c1, hrlk.b, hrlk.a, cp.qs + ks, cp.qs)

    def ext_sum_path():
        ys, alpha = ext_cuda.lift_plain(acc0[CK_L:], ks, True)
        return ext_cuda.base_extend_sum(ys.int(), alpha.int(), ks, cp.qs)

    got = drive(f"base_extend_sum on the (ys, alpha) of the key switch's "
                f"auxiliary residues [{CK_K}, {CK_BATCH}, {CK_N}]",
                ("base_extend_sum",), ext_sum_path)
    if not torch.equal(got, ext_cuda.base_extend_fused(acc0[CK_L:], ks, cp.qs,
                                                       centered=True)):
        raise RuntimeError("base_extend_sum != the whole centered conversion "
                           "on the path's accumulator")
    say("verify: base_extend_sum == base_extend_fused (torch.equal) on the "
        "accumulator of the multiply that decoded right above")
    del acc0, got

    # the gadget keyring: its noise, ~ n sqrt(L) * 2^30 * sigma a hop in a
    # slot, does not shrink with P, so CKKS needs a larger scale for it
    # (3-limb decrypt) and the reference's own test of it holds |z| <= 10 to
    # atol 0.5; batched RNS-BFV is exact
    gp = C.Param(n=CK_N, L=CK_L, delta=CK_GADGET_DELTA)
    zg = (rng.uniform(-10, 10, (CK_GADGET_BATCH, CK_N // 2))
          + 1j * rng.uniform(-10, 10, (CK_GADGET_BATCH, CK_N // 2)))

    def keyring_ckks():
        sk, pk = C.new_key(gen, gp, dev)
        c = C.encrypt(gen, gp, pk, C.encode(gp, on_card(zg.real.copy()),
                                            on_card(zg.imag.copy())),
                      batch=(CK_GADGET_BATCH,))
        ring = galois.GaloisKeys.for_rotations(gen, gp, sk, steps=[1, 2],
                                               conj=True)
        return (slots_of(gp, sk, ring.rotate(gp, c, 3)),
                slots_of(gp, sk, ring.conjugate(gp, c)))

    got3, gotc = drive(
        f"ckks keyring: GaloisKeys.for_rotations(steps=[1, 2], conj=True) -> "
        f"rotate by 3 (two hops), conjugate at N={CK_N} L={CK_L} delta=2^55 "
        f"B={CK_GADGET_BATCH}", ("ntt_multi", "ks_fused"), keyring_ckks)
    verify_slots("GaloisKeys.rotate by 3", got3,
                 moved(zg, galois.rotation_element(CK_N, 3)), 0.5)
    verify_slots("GaloisKeys.conjugate", gotc, zg.conj(), 0.5)

    bp = R.RnsParam(n=CK_N, t=BATCH_T, L=L, M=M)
    bslots = rng.integers(0, BATCH_T, (CK_GADGET_BATCH, 2, CK_N // 2))

    def keyring_bfv():
        sk, pk = R.new_key(gen, bp, dev)
        m = bfv_batch.batch_encode(BATCH_T, CK_N, on_card(bslots))
        c = R.encrypt(gen, bp, pk, m, batch=(CK_GADGET_BATCH,))
        ring = galois.GaloisKeys.for_rotations(gen, bp, sk, steps=[1, 2],
                                               conj=True)
        return [bfv_batch.batch_decode(BATCH_T, CK_N, R.decrypt(bp, sk, r))
                for r in (ring.rotate(bp, c, 3), ring.conjugate(bp, c))]

    rot3, swapped = drive(
        f"bfv batching: batch_encode -> encrypt -> GaloisKeys rotate by 3, "
        f"conjugate -> decrypt -> batch_decode at N={CK_N} t={BATCH_T} L={L} "
        f"M={M} B={CK_GADGET_BATCH}", ("ntt", "ntt_multi", "ks_fused"),
        keyring_bfv)
    for label, got, want in (("row rotation by 3", rot3,
                              np.roll(bslots, -3, axis=-1)),
                             ("row swap", swapped, bslots[:, ::-1])):
        if not np.array_equal(got.cpu().numpy(), want):
            raise RuntimeError(f"bfv batching: {label} moved the slots wrong")
        say(f"verify: bfv batching: {label} == the slots moved, all "
            f"{want.shape[0]} x 2 x {want.shape[2]}")
    del rot3, swapped

    p7 = C.Param(n=CK_N, L=CK2_L, delta=1.0)
    p7 = C.Param(n=CK_N, L=CK2_L, delta=C.delta2(p7))
    za, zb = (rng.uniform(-1, 1, (CK2_BATCH, CK_N // 2)) for _ in range(2))

    def double_scale():
        sk, pk = C.new_key(gen, p7, dev)
        hk = C.hybrid_rlk(gen, p7, sk, K=CK_K)
        z0 = zero[:CK2_BATCH]
        ca, cb = (C.encrypt(gen, p7, pk, C.encode(p7, on_card(z), z0),
                            batch=(CK2_BATCH,)) for z in (za, zb))
        out, p5 = C.mul_hybrid2(p7, hk, ca, cb)
        return p5, slots_of(p5, sk, out)

    p5, got = drive(
        f"ckks double-prime scale: new_key -> hybrid_rlk -> encrypt x 2 -> "
        f"mul_hybrid2 -> 3-limb decrypt_to_coeffs -> decode at N={CK_N} "
        f"L={CK2_L} delta=q6*q5 B={CK2_BATCH}",
        ("ntt_multi", "tensor_mul4", "ks_fused", "base_extend"), double_scale)
    if p5.L != CK2_L - 2 or p5.delta <= 2.0 ** 40:
        raise RuntimeError(f"mul_hybrid2 parameters: {p5}")
    verify_slots("mul_hybrid2", got, (za * zb).astype(complex), 1e-9)

    phase_done("11 (RNS-CKKS)")

    # 12. the NTT mode -------------------------------------------------------
    nqs = ntt_primes(NTT_L, 30, 1 << 16)
    a0 = prng.uniform_mod_multi(gen, (NTT_B, N), nqs, dev)
    busy = torch.zeros(1 << 28, dtype=torch.int32, device=dev)   # 1 GiB
    resident = {n: alu_bench.resident_blocks(dev, n=n)
                for n in (N, CK_N, TFHE_N)}
    alu_shape = {op: (sms * alu_bench.resident_blocks(dev, op=op)[0], 1024)
                 for op in alu_bench.OPS}
    nb = {}

    def ntt_chain(x):
        for _ in range(NTT_CHAIN):
            x = ntt.ntt_multi(x, nqs)
        return x

    def timed_chain(ahead: bool):
        """Seconds of NTT_ITERS chains on the device, and on the host's
        clock the seconds it took to enqueue them; with ahead, the chains
        queue behind device work that outlasts their enqueueing, so the
        device runs them back to back (their own time)."""
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if ahead:
            for _ in range(16):
                busy.add_(1)
        start.record()
        t0 = time.perf_counter()
        cur = a0
        for _ in range(NTT_ITERS):
            cur = ntt_chain(cur)           # chained: no cache can serve it
        host = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        return cur, start.elapsed_time(end) / 1e3, host

    def ntt_mode():
        cur = ntt_chain(a0)                                  # warm up
        cur, nb["dt"], nb["host"] = timed_chain(False)
        nb["device_dt"] = timed_chain(True)[1]
        nb["ceiling_64"] = alu_bench.ntt_smem_ceiling(
            dev, n=N, B=NTT_B, reps=CEILING_REPS)
        nb["ceiling"] = {n: alu_bench.ntt_smem_ceiling(
            dev, n=n, B=resident[n][0] * sms, reps=CEILING_REPS)
            for n in resident}
        nb["alu"] = {op: alu_bench.alu_rate(op, dev, rounds=ALU_ROUNDS,
                                            shape=alu_shape[op])
                     for op in alu_bench.OPS}
        return cur

    cur = drive(f"ntt mode: chain of {NTT_CHAIN} ntt_multi x {NTT_ITERS} over "
                f"{NTT_L} primes, B={NTT_B}, N={N}; the shared-memory "
                f"ceiling; the alu_rate operations",
                ("ntt_multi", "ntt_smem_ceiling", "alu_rate"), ntt_mode)
    del busy
    if not torch.equal(ntt.intt_multi(ntt.ntt_multi(a0, nqs), nqs), a0):
        raise RuntimeError("ntt mode: intt_multi(ntt_multi(x)) != x")
    head = a0[:, :2].contiguous()
    if not torch.equal(ntt.ntt_multi(head, nqs),
                       ntt_cuda.ntt_multi_plain(head, nqs)):
        raise RuntimeError("ntt mode: ntt_multi != its plain version")
    if tuple(cur.shape) != (NTT_L, NTT_B, N) or int(cur.max()) >= max(nqs):
        raise RuntimeError("ntt mode: the chain's output left its range")
    say(f"verify: ntt mode: intt_multi(ntt_multi(x)) == x on all {NTT_L} x "
        f"{NTT_B} polynomials; the first link == its plain version")
    # the launches whose rates are printed below, held against the plain
    # versions: the ceiling's last timed launch on its first and last two
    # polynomials (each block is one polynomial) ...
    for r in (nb["ceiling_64"], *nb["ceiling"].values()):
        (xin,), rows = r["operands"], [0, 1, r["B"] - 2, r["B"] - 1]
        hold("ntt_smem_ceiling",
             f"the timed launch, reps={r['reps']} B={r['B']} n={r['n']}",
             r["out"][rows],
             alu_bench.ntt_smem_ceiling_plain(xin[rows], r["q"], r["reps"]))
    # ... and each alu_rate's as a chain of shorter launches on the same
    # grid, the first of which is held against the plain version on the
    # words of the first and the last block
    for op, r in nb["alu"].items():
        x, y, yp = r["operands"]
        threads = x.numel() // alu_bench.ALU_PER_THREAD
        cols = torch.cat([torch.arange(alu_bench.ALU_THREADS),
                          torch.arange(threads - alu_bench.ALU_THREADS,
                                       threads)]).to(dev)

        def part(v):
            words = v.reshape(alu_bench.ALU_PER_THREAD, -1)
            return words[:, cols].contiguous()

        cur = alu_bench.alu_rate_kernel(x, y, yp, op, ALU_SHORT_ROUNDS)
        hold("alu_rate", f"{op} rounds={ALU_SHORT_ROUNDS} on {list(x.shape)}, "
             f"first and last block", part(cur),
             alu_bench.alu_rate_plain(part(x), part(y), part(yp), op,
                                      ALU_SHORT_ROUNDS))
        for _ in range(r["rounds"] // ALU_SHORT_ROUNDS - 1):
            cur = alu_bench.alu_rate_kernel(cur, y, yp, op, ALU_SHORT_ROUNDS)
        hold("alu_rate", f"{op}: the timed launch, rounds={r['rounds']} on "
             f"{list(x.shape)} == {r['rounds'] // ALU_SHORT_ROUNDS} launches "
             f"of {ALU_SHORT_ROUNDS}", r["out"], cur)
    say(f"verify: the timed launches of the measuring loops: the ceiling's "
        f"(reps={CEILING_REPS}) == plain on 4 polynomials of each of "
        f"{1 + len(nb['ceiling'])} configurations; every alu_rate's "
        f"(rounds={ALU_ROUNDS}) == "
        f"{ALU_ROUNDS // ALU_SHORT_ROUNDS} launches of {ALU_SHORT_ROUNDS} "
        f"rounds, whose first == plain on the first and last block")
    roof = profiling.ntt_roofline(NTT_L * NTT_B * NTT_CHAIN * NTT_ITERS, N,
                                  nb["dt"], dtype_bytes=4)
    rep = roof.report()
    ceil_bf = {n: c["butterflies_per_sec"] for n, c in nb["ceiling"].items()}
    say(f"ntt mode: {roof.butterflies_per_sec:.4e} butterflies/s over "
        f"{nb['dt'] * 1e3:.3f} ms ({nb['dt'] * 1e3 / NTT_ITERS / NTT_CHAIN:.4f}"
        f" ms a link of {NTT_L * NTT_B} transforms); as device-memory "
        f"traffic of an unfused chain {rep['hbm_gbps']:.1f} GB/s = "
        f"{rep['hbm_fraction_of_peak']:.3f} of "
        f"{profiling.H100_MEMORY_BYTES_PER_S / 1e12} TB/s; "
        f"{roof.butterflies_per_sec / ceil_bf[N]:.3f} of the shared-memory "
        f"ceiling [{card}]")
    # the link's own bound: its butterflies at the issue rate, or its rows
    # and root tables through device memory
    links = NTT_ITERS * NTT_CHAIN
    link_ms = nb["dt"] * 1e3 / links
    device_ms = nb["device_dt"] * 1e3 / links
    lb = bound(4 * (2 * NTT_L * NTT_B * N + 2 * NTT_L * N),
               NTT_L * NTT_B * (N // 2) * (N.bit_length() - 1)
               * kernel_check.BUTTERFLY_OPS)
    link_bound = lb.ms
    say(f"ntt mode: a link {link_ms:.4f} ms against its bound "
        f"{link_bound:.4f} ms by {lb.term} (issue {lb.issue_ms:.4f}, ALU "
        f"{lb.alu_ms:.4f}, FMA {lb.fma_ms:.4f}, bytes {lb.bytes_ms:.4f}): "
        f"{link_bound / link_ms:.3f} of the bound "
        f"({lb.issue_only_ms / link_ms:.3f} of the issue-only bound), "
        f"{roof.butterflies_per_sec / ceil_bf[N]:.3f} of the shared-memory "
        f"ceiling of its own chain; the host took "
        f"{nb['host'] * 1e3 / links:.4f} ms to enqueue a link; on "
        f"the device alone (queued behind device work) a link takes "
        f"{device_ms:.4f} ms, {link_bound / device_ms:.3f} of the bound "
        f"[{card}]")
    say(f"ceiling: the register-resident forward chain on polynomials "
        f"resident in shared memory, reps={CEILING_REPS}, n={N}: B={NTT_B} "
        f"(64 of {sms} SMs busy) "
        f"{nb['ceiling_64']['butterflies_per_sec']:.4e} butterflies/s; "
        + "; ".join(f"n={n}, B={resident[n][0] * sms} ({resident[n][0]} "
                    f"resident blocks x {sms} SMs) {ceil_bf[n]:.4e}"
                    for n in resident)
        + f".  This is the ceiling of the chain that K1-K10 run (its "
        f"butterflies, shared-memory exchanges, twiddle loads and barriers), "
        f"not of the card: fewer instructions a butterfly would raise it "
        f"[{card}]")
    # each loop against its own pipe-aware bound: one word (butterfly) a
    # round has the work of this build's loop, so the bound of one second's
    # worth of clocks is the most that the model lets it issue
    off_model = {}
    for op in alu_bench.OPS:
        r = nb["alu"][op]
        per_clk = r["elems_per_s"] / (sms * clock)
        unit = bound(0, kernel_check.Work(*sass_pipes[op]))
        most = 1e3 / unit.ms                   # words (butterflies) a second
        share = r["elems_per_s"] / most
        if not ALU_SHARE[0] <= share <= ALU_SHARE[1]:
            off_model[op] = share
        say(f"alu_rate: {op:10s} {r['elems_per_s']:.4e} "
            f"{'butterflies' if op == 'butterfly' else 'words'}/s on "
            f"{list(alu_shape[op])} words, rounds={r['rounds']}: "
            f"{per_clk:.2f} a clock and SM at {sm_mhz:.0f} MHz = "
            f"{per_clk * sass_per[op]:.1f} SASS instructions of the "
            f"{kernel_check.ISSUE_PER_SM_CLOCK} an SM can issue; "
            f"{share:.3f} of its pipe-aware bound of {most:.4e} (by "
            f"{unit.term}; (ALU, FMA, wide) {sass_pipes[op]} a unit) "
            f"[{card}]")
    if off_model:
        raise RuntimeError(f"alu_rate loops outside {ALU_SHARE} of their "
                           f"pipe-aware bound: {off_model}; the pipe model "
                           f"(utils/sass_counts.PIPES) is wrong")
    say(f"alu_rate: every loop issues at {ALU_SHARE[0]}-{ALU_SHARE[1]} of its "
        f"pipe-aware bound")
    bf_issue = nb["alu"]["butterfly"]["elems_per_s"]
    bf_unit = bound(0, kernel_check.BUTTERFLY_OPS)
    bf_bound = 1e3 / bf_unit.ms
    say(f"ceiling: the butterfly alone, in registers, issues at "
        f"{bf_issue:.4e} butterflies/s, {bf_issue / bf_bound:.3f} of the "
        f"bound's {bf_bound:.4e} ({kernel_check.BUTTERFLY_OPS} a butterfly, "
        f"by {bf_unit.term}; {bf_issue * bf_unit.issue_only_ms * 1e-3:.3f} of "
        f"the issue-only {1e3 / bf_unit.issue_only_ms:.4e}); the "
        f"shared-memory chain reaches {ceil_bf[N] / bf_issue:.3f} of the "
        f"butterfly's rate and {ceil_bf[N] / bf_bound:.3f} of the bound")

    phase_done("12 (NTT mode)")

    # 13. CKKS timing --------------------------------------------------------
    def pad(a):
        return torch.cat([a, a[-1:]], dim=0)

    def ckks_step(b):
        out = C.mul_hybrid(cp, hrlk, c1, C.add(cp, c1, b))[0]
        return C.CT(pad(out.c0), pad(out.c1))

    def ckks_chain():
        cur = c2
        for _ in range(CK_ITERS):
            cur = ckks_step(cur)       # the padded copy feeds the next step
        return cur

    per_op = per_op_launches(lambda: ckks_step(c2))
    ckks_chain()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = [time_ms(ckks_chain, 1, warmup=0) for _ in range(3)]
    peak = torch.cuda.max_memory_allocated()
    step_ms = min(runs) / CK_ITERS
    say(f"timing: ckks add + mul_hybrid, {CK_ITERS} chained steps at "
        f"{cshape}: runs {[round(r, 3) for r in runs]} ms, best "
        f"{min(runs):.3f} ms = {step_ms:.3f} ms a step = "
        f"{CK_BATCH / (step_ms / 1e3):.1f} ops/s; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches a step {per_op} [{card}]")
    # where the step's device time goes: one profiled chain, its kernels'
    # own times by name against the chain's CUDA-event time above
    with profiling.trace(str(_cuda.BUILD_ROOT.parent / "torch_trace")) as prof:
        ckks_chain()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        say("profile: torch.profiler recorded no device time on this "
            "machine; the step's breakdown was not measured")
    else:
        busy = sum(r[0] for r in rows)
        ours = sum(r[0] for r in rows if "fhe" in r[2])
        say(f"profile: {CK_ITERS} ckks steps: {sum(r[1] for r in rows)} "
            f"device kernels busy {busy:.3f} ms of the chain's "
            f"{min(runs):.3f} ms (idle share {1 - busy / min(runs):.2f}); "
            f"the package's kernels {ours:.3f} ms, torch's elementwise and "
            f"copy kernels {busy - ours:.3f} ms [{card}]")
        for ms_, count, key in rows[:6]:
            say(f"profile:   {ms_:7.3f} ms in {count:4d} launches of "
                f"{key[:90]}")
    for label, fn in (
            ("unhoisted (rotate_hybrid)",
             lambda: [H.rotate_hybrid(cp, k, c1, g)
                      for k, g in zip(hgk, gs)]),
            ("hoisted (hoist_digits + rotate_hoisted)",
             lambda: [H.rotate_hoisted(cp, k, c1, g,
                                       H.hoist_digits(cp, c1.c1, K=CK_K)
                                       if i == 0 else edm)
                      for i, (k, g) in enumerate(zip(hgk, gs))])):
        fn()
        runs = [time_ms(fn, 1, warmup=0) for _ in range(3)]
        say(f"timing: {len(gs)} rotations of one ciphertext batch, {label}: "
            f"runs {[round(r, 3) for r in runs]} ms, best {min(runs):.3f} ms "
            f"= {min(runs) / len(gs):.3f} ms a rotation; launches "
            f"{per_op_launches(fn)} [{card}]")
    gen = prng.Gen(SEED + 6)
    before = dict(ms)
    ckks_cases = kernel_check.ckks_cases(cp, CK_BATCH, CK_K, dev, gen)
    for case in ckks_cases:
        time_case(case)
    # kernels of one step: K6, K7 and the two P-divisions (K4)
    in_step = {"tensor_mul4": 1, "ks_fused": 1, "base_extend": 2}
    kernel_ms = sum((ms[k] - before[k]) * c for k, c in in_step.items())
    say(f"timing: ckks step: its {sum(in_step.values())} kernel launches "
        f"take {kernel_ms:.3f} ms of the step's {step_ms:.3f} ms; the "
        f"remainder ({step_ms - kernel_ms:.3f} ms) is the plain-torch adds, "
        f"the modulus drop, the pad and launch gaps [{card}]")
    for case in (kernel_check.ext_sum_cases(CK_N, CK_BATCH, dev, gen)
                 + kernel_check.bench_cases(N, NTT_B, dev, gen, reps=8,
                                            rounds=ALU_SHORT_ROUNDS,
                                            counts=sass_pipes)):
        if case.timed:
            time_case(case)
        else:                                    # kernel against kernel
            check(case, case.kernel(), case.plain())
    # each pure transform against the ceiling of its chain at its n: K1's
    # link of the NTT mode and K9's variants at the shapes of key generation
    pure = [("ntt_multi", f"NTT-mode link [{NTT_L},{NTT_B},{N}]",
             roof.butterflies_per_sec, N)]
    pure += [(c.name, c.label, c.butterflies / (case_ms[c.label] / 1e3), c.n)
             for c in timed_chains if c.name == "ntt"]
    for name, label, rate, n in pure:
        say(f"ceiling: {name:13s} {label:48s} {rate:.4e} butterflies/s = "
            f"{rate / ceil_bf[n]:.3f} of the shared-memory ceiling at n={n} "
            f"[{card}]")

    phase_done("13 (CKKS timing)")

    # 14. slice 7a: CKKS linear maps and polynomial evaluation ---------------
    # the radix-split CoeffToSlot and SlotToCoeff stages of the n = 2^12
    # bootstrap at their level and working scale, each stage's plans built
    # and its Galois keys drawn just before it and freed after it
    from fhe_study_tpu_torch.models.ckks import eval as E
    from fhe_study_tpu_torch.models.ckks import poly as P
    bp = C.Param(n=BOOT_N, L=BOOT_L, delta=BOOT_DELTA)
    bshape = (f"N={BOOT_N} L={BOOT_L} S={BOOT_S} K={CK_K} h={BOOT_H} "
              f"delta=2^{round(np.log2(BOOT_DELTA))} B={BOOT_B}")
    gen = prng.Gen(SEED + 7)
    zb = (rng.uniform(-1, 1, (BOOT_B, BOOT_N // 2))
          + 1j * rng.uniform(-1, 1, (BOOT_B, BOOT_N // 2)))
    t0 = time.perf_counter()
    stage_maps = ([("C2S", m) for m in E.c2s_stage_maps(BOOT_N, BOOT_S)]
                  + [("S2C", m) for m in E.s2c_stage_maps(BOOT_N, BOOT_S)])
    say(f"host: c2s_stage_maps and s2c_stage_maps({BOOT_N}, {BOOT_S}) in "
        f"{time.perf_counter() - t0:.1f} s (numpy)")
    bsk, bpk = C.new_key(gen, bp, dev, h=BOOT_H)
    cts = [C.encrypt(gen, bp, bpk, C.encode(bp, on_card(zb.real.copy()),
                                            on_card(zb.imag.copy())),
                     batch=(BOOT_B,))]
    want = [zb]

    def numpy_map(m, z):
        A, B = m
        out = np.zeros_like(z)
        if A is not None and np.any(A):
            out = out + z @ A.T
        if B is not None and np.any(B):
            out = out + z.conj() @ B.T
        return out

    L_cur = BOOT_L
    for s, (kind, (m1, m2)) in enumerate(stage_maps):
        tag = f"{kind} stage {s % BOOT_S}"
        pL = C.Param(n=BOOT_N, L=L_cur, delta=BOOT_DELTA)
        t0 = time.perf_counter()
        if s == 0:                       # one plan emits both chains
            jobs = [(E.build_rmap_plan(pL, [m1, m2], dev, pt_levels=2), 0)]
        else:
            same = all(np.array_equal(a, b) for a, b in zip(m1, m2))
            p1 = E.build_rmap_plan(pL, [m1], dev, pt_levels=2)
            p2 = p1 if same else E.build_rmap_plan(pL, [m2], dev, pt_levels=2)
            jobs = [(p1, 0), (p2, 1)]
        plans = {id(p): p for p, _ in jobs}.values()
        steps = sorted({j for p in plans for j in p.need_d | p.need_e if j}
                       | {gi for p in plans for m in p.maps for gi, _ in m
                          if gi})
        conj = any(p.need_e for p in plans)
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rk = E.RotKeys.build(gen, pL, bsk, steps=steps, conj=conj, K=CK_K,
                             levels=[L_cur])
        torch.cuda.synchronize()
        key_s = time.perf_counter() - t0
        em_bytes = sum(p.em.numel() * 4 for p in plans)
        say(f"ckks maps: {tag} at L={L_cur}: {len(plans)} plan(s), "
            f"{sum(len(p.need_d) for p in plans)} + "
            f"{sum(len(p.need_e) for p in plans)} babies (z, z_c), "
            f"{sum(len(m) for p in plans for m in p.maps)} giant blocks, "
            f"{len(rk.keys)} Galois keys of {rk.nbytes() / 2**30:.3f} GiB "
            f"drawn on the host in {key_s:.1f} s, em "
            f"{em_bytes / 2**30:.3f} GiB; plans built in {host_s:.1f} s")

        def stage(inputs=cts, jobs=jobs, rk=rk, pL=pL):
            outs = []
            for plan, i in jobs:
                got, _ = E.apply_rmap_plan(pL, rk, inputs[i], plan)
                outs += got
            return outs

        label = (f"ckks maps: {tag}: apply_rmap_plan at "
                 f"{bshape.replace(f'L={BOOT_L}', f'L={L_cur}')}")
        outs = drive(label, ("ntt_multi", "ks_contract", "base_extend",
                             "ks_fused"), stage)
        want = ([numpy_map(m1, want[0]), numpy_map(m2, want[0])] if s == 0
                else [numpy_map(m1, want[0]), numpy_map(m2, want[1])])
        L_cur -= 2
        pout = C.Param(n=BOOT_N, L=L_cur, delta=BOOT_DELTA)
        for chain, (c, w) in enumerate(zip(outs, want)):
            if c.c0.shape[0] != L_cur:
                raise RuntimeError(f"{tag}: output at {c.c0.shape[0]} limbs, "
                                   f"expected {L_cur}")
            verify_slots(f"ckks maps: {tag}, chain {chain + 1}",
                         slots_of(pout, bsk, c), w, 5e-2)
        runs = [time_ms(stage, 1, warmup=0) for _ in range(3)]
        say(f"timing: ckks maps: {tag} at L={L_cur + 2}, B={BOOT_B}: runs "
            f"{[round(r, 3) for r in runs]} ms, best {min(runs):.3f} ms; "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
            f"{ {k: v for k, v in path_launches[label].items() if v} } "
            f"[{card}]")
        cts = outs
        del rk, jobs, plans, stage
        torch.cuda.empty_cache()
    # the two chains of C2S then S2C give 2z (the real extraction's
    # y + conj(y) at fold 1)
    pout = C.Param(n=BOOT_N, L=L_cur, delta=BOOT_DELTA)
    verify_slots("ckks maps: C2S then S2C, the two chains added",
                 slots_of(pout, bsk, C.add(pout, *cts)), 2 * zb, 5e-2)
    del cts, outs, bsk, bpk
    torch.cuda.empty_cache()

    # poly_eval and poly_eval2 at n = 2^12, at the reference tests' levels
    zr = rng.uniform(-1, 1, (BOOT_B, BOOT_N // 2))
    coeffs = [1.0, -2.0, 0.0, 0.5, 0.0, 0.0, 0.0, -0.25]
    p8 = C.Param(n=BOOT_N, L=8, delta=2.0 ** 28)
    p9 = C.Param(n=BOOT_N, L=9, delta=1.0)
    p9 = C.Param(n=BOOT_N, L=9, delta=C.delta2(p9))
    coeffs2 = [0.5, 1.0, 0.0, -0.25]

    def poly_path(param, z, fn, cs):
        sk, pk = C.new_key(gen, param, dev)
        rlks = P.rlk_keys_all_levels(gen, param, sk, K=CK_K)
        c = C.encrypt(gen, param, pk, C.encode(param, on_card(z.real.copy()),
                                               on_card(z.imag.copy())),
                      batch=(BOOT_B,))
        return sk, rlks, c, *fn(rlks, c, param, cs)

    def on_cpu(t):
        return type(t)(*(v.cpu() for v in t))

    def poly_check(label, param, z, fn, cs):
        """fn on the card, decoded against numpy; and the same call on the
        CPU (the plain versions, which tier-1 holds to the reference bit
        for bit) on the same keys and ciphertext, bit for bit."""
        sk, rlks, c, out, pout = drive(
            f"ckks poly: new_key -> rlk_keys_all_levels -> encrypt -> "
            f"{label} -> decode at N={BOOT_N} L={param.L} B={BOOT_B}",
            ("ntt_multi", "tensor_mul4", "ks_fused", "base_extend"),
            lambda: poly_path(param, z, fn, cs))
        cpu_out, cpu_p = fn({k: on_cpu(v) for k, v in rlks.items()},
                            on_cpu(c), param, cs)
        if (not all(torch.equal(a.cpu(), b) for a, b in zip(out, cpu_out))
                or cpu_p != pout):
            raise RuntimeError(f"{label}: the card's output != the same call "
                               "on the CPU")
        say(f"verify: {label}: the card's output == the same call on the CPU "
            f"(torch.equal, all {out.c0.shape[0]} x {BOOT_B} x {BOOT_N} "
            f"residues of both components)")
        return pout, slots_of(pout, sk, out)

    pout, got = poly_check("poly_eval (degree 7, delta=2^28)", p8,
                           zr.astype(complex), P.poly_eval, coeffs)
    want = sum(c * zr ** k for k, c in enumerate(coeffs)).astype(complex)
    worst = float(np.abs(got - want).max())
    if not np.isfinite(got).all() or got.shape != want.shape:
        raise RuntimeError(f"poly_eval: decoded {got.shape}, not finite")
    # at delta = 2^28 on 30-bit primes the ladder's scale falls to 2^16 at
    # z^7, and the slot error grows with n (PERF.md §6): the reference
    # test's 5e-3 at n = 32 is reported here, not held
    say(f"verify: poly_eval 1 - 2z + 0.5z^3 - 0.25z^7 at N={BOOT_N}: decoded "
        f"against numpy in all {BOOT_B} x {BOOT_N // 2} slots: max |diff| "
        f"{worst:.3e}, {'within' if worst <= 5e-3 else 'NOT within'} the "
        f"5e-3 that tests/test_ckks_poly.py holds at n=32")
    pout2, got = poly_check("poly_eval2 (delta=q8*q7)", p9, zb,
                            P.poly_eval2, coeffs2)
    if pout2.delta != p9.delta:
        raise RuntimeError(f"poly_eval2 output scale {pout2.delta} != "
                           f"{p9.delta}")
    verify_slots("poly_eval2 0.5 + z - 0.25z^3", got,
                 0.5 + zb - 0.25 * zb ** 3, 1e-9)
    # the kernel variants of the maps at their widest level
    gen = prng.Gen(SEED + 8)
    for case in kernel_check.ckks_cases(bp, BOOT_B, CK_K, dev, gen):
        time_case(case)
    phase_done("14 (CKKS maps and polynomials, n = 2^12)")

    # 15. slice 7b: the n = 2^12 bootstrap on the card -----------------------
    # the JAX bench's production configuration (bench.py, bench_ckks_boot):
    # double-base ModRaise, delta0 = 2^55, working scale 2^60, deg 30, four
    # arcsin terms, S = 2 radix stages each side
    from fhe_study_tpu_torch.models.ckks import bootstrap as BB
    from fhe_study_tpu_torch.utils import boot_probe
    kr = BB.suggest_K_r(BOOT_N, BOOT_H)
    if kr != (12, 5):
        raise RuntimeError(f"suggest_K_r({BOOT_N}, {BOOT_H}) = {kr}, the "
                           "bench's configuration needs (12, 5)")
    cfg = boot_probe.config(BOOT_N, L=BOOT_L, delta0=BOOT_DELTA0,
                            delta_w=BOOT_DELTA, deg=BOOT_DEG, K=kr[0],
                            r=kr[1], arcsin_terms=BOOT_ARCSIN, h=BOOT_H,
                            stages=BOOT_S)
    kw = boot_probe.pipeline_kw(cfg)
    bp = C.Param(n=BOOT_N, L=BOOT_L, delta=BOOT_DELTA0)
    b7shape = (f"N={BOOT_N} L={BOOT_L} S={BOOT_S} h={BOOT_H} K,r={kr} "
               f"delta0=2^{round(np.log2(BOOT_DELTA0))} "
               f"delta_w=2^{round(np.log2(BOOT_DELTA))} deg={BOOT_DEG} "
               f"arcsin={BOOT_ARCSIN} B={BOOT_B}")
    gen = prng.Gen(SEED + 9)
    bsk, bpk = C.new_key(gen, bp, dev, h=BOOT_H)
    master = SEED + 10
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    arrays, static, pout, em_src = BB.precompute_keys(
        master, bp, bsk, BOOT_DELTA0, with_em_src=True, **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    by_level = {}
    for L_, k in arrays["rlk"].items():
        by_level.setdefault(L_, [0, 0, 0])[0] += BB.nbytes(k)
    for (L_, _), k in arrays["rot"].items():
        by_level.setdefault(L_, [0, 0, 0])[1] += BB.nbytes(k)
    for em in arrays["em"].values():
        by_level.setdefault(em.shape[0], [0, 0, 0])[2] += BB.nbytes(em)
    full_bytes = BB.nbytes(arrays)
    say(f"boot keys: precompute_keys at {b7shape} in {build_s:.1f} s (one "
        f"bootstrap of a zero ciphertext with lazy keys, then freeze): "
        f"{len(arrays['rlk'])} relinearization keys at L="
        f"{sorted(arrays['rlk'])}, {len(arrays['rot'])} Galois keys at L="
        f"{sorted({L_ for L_, _ in arrays['rot']})}, {len(static)} plans "
        f"{sorted(static, key=str)}; {full_bytes / 2**30:.3f} GiB in all, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; pout "
        f"L={pout.L} delta={pout.delta!r} [{card}]")
    for L_ in sorted(by_level, reverse=True):
        rl, ro, em = by_level[L_]
        say(f"boot keys:   L={L_}: relinearization {rl / 2**20:.1f} MiB, "
            f"Galois {ro / 2**20:.1f} MiB, plan em {em / 2**20:.1f} MiB")
    pack = BB.pack_seeded(arrays, master, em_src=em_src)
    pack_bytes = BB.nbytes(pack)
    t0 = time.perf_counter()
    expanded = BB.expand_seeded(pack, bp)
    torch.cuda.synchronize()
    expand_s = time.perf_counter() - t0
    pairs = ([(f"rlk L={L_} {f}", getattr(k, f),
               getattr(expanded["rlk"][L_], f))
              for L_, k in arrays["rlk"].items() for f in ("a", "b")]
             + [(f"rot {lg} {f}", getattr(k, f),
                 getattr(expanded["rot"][lg], f))
                for lg, k in arrays["rot"].items() for f in ("a", "b")]
             + [(f"em {pk_}", em, expanded["em"][pk_])
                for pk_, em in arrays["em"].items()])
    bad = [lbl for lbl, x, y in pairs if not torch.equal(x, y)]
    if bad or set(expanded["em"]) != set(arrays["em"]):
        raise RuntimeError(f"expand_seeded != the built key set at {bad[:5]}")
    if pack_bytes >= 0.62 * full_bytes:
        raise RuntimeError(f"the seeded pack holds {pack_bytes} bytes, not "
                           f"under 0.62 of the set's {full_bytes}")
    stored = ({s_ for _, s_ in pack["rlk"].values()}
              | {s_ for _, s_ in pack["rot"].values()})
    seeds = ([BB._rlk_subkey(master, L_) for L_ in arrays["rlk"]]
             + [BB._rot_subkey(master, *lg) for lg in arrays["rot"]])
    forbidden = {master} | {ke for _, ke in seeds}
    if (stored != {ka for ka, _ in seeds} or stored & forbidden
            or len(stored) != len(seeds)):
        raise RuntimeError("the seeded pack holds a seed other than the "
                           "mask seeds, or two keys share a mask seed")
    say(f"boot keys: pack_seeded {pack_bytes / 2**30:.3f} GiB = "
        f"{pack_bytes / full_bytes:.3f} of the set (bound 0.62), "
        f"{len(stored)} mask seeds, none equal to the master seed or a "
        f"noise seed; expand_seeded on the card in {expand_s:.1f} s: all "
        f"{len(pairs)} a planes, b planes and em torch.equal to the built "
        f"set [{card}]")
    del arrays, pack, em_src, pairs
    torch.cuda.empty_cache()

    zb = rng.uniform(-1, 1, (BOOT_B, BOOT_N // 2))
    zt = on_card(zb)
    ct = C.encrypt(gen, bp, bpk, C.encode(bp, zt, torch.zeros_like(zt)),
                   batch=(BOOT_B,))
    ct2, _ = P.level_drop(bp, ct, 2)
    boot_run = BB.make_staged(bp, static, BOOT_DELTA0, **kw)
    shapes, seen = {}, {}
    boot_label = (f"ckks bootstrap: make_staged (ModRaise + C2S x {BOOT_S}, "
                  f"EvalMod x 2, S2C x {BOOT_S}) on the expanded keys, "
                  f"input dropped to 2 limbs, at {b7shape}")
    with record_calls(shapes, seen, BOOT_KERNELS):
        out, pout2 = drive(boot_label, ("ntt_multi", "ks_contract",
                                        "base_extend", "tensor_mul4",
                                        "ks_fused"),
                           lambda: boot_run(expanded, ct2.c0, ct2.c1))
    boot_launches = {k: v for k, v in path_launches[boot_label].items() if v}
    if boot_launches != {k: v for k, v in seen.items() if v}:
        raise RuntimeError(f"bootstrap: the recorded calls launched {seen}, "
                           f"the path {boot_launches}: some launches went "
                           "round the recorder and their shapes would go "
                           "unchecked")
    if pout2 != pout or boot_run.pout != pout:
        raise RuntimeError(f"make_staged's output Param {pout2} != "
                           f"precompute_keys' {pout}")
    # the real parts, as the bench's gate reads them
    got = slots_of(pout, bsk, out).real
    if got.shape != zb.shape or not np.isfinite(got).all():
        raise RuntimeError(f"bootstrap: decoded {got.shape}, not finite")
    err_b = float(np.abs(got - zb).max())
    if not err_b < 2.0 ** -18:
        raise RuntimeError(f"bootstrap: max slot error {err_b:.3e} is not "
                           "under the bench's decrypt gate 2^-18")
    say(f"verify: bootstrap at {b7shape}: output L={pout.L}, decoded "
        f"against z in all {BOOT_B} x {BOOT_N // 2} slots: max |diff| "
        f"{err_b:.3e} < 2^-18 = {-np.log2(err_b):.1f} refreshed bits (the "
        f"JAX package's record: 20.3-28.2 bits)")
    frozen = BB.FrozenKeys(expanded, static)
    errs, out_p = boot_probe.stage_errors(
        bp, bsk, ct2, zb, boot_run, frozen, pout, K=kr[0], r=kr[1],
        delta_w=BOOT_DELTA, arcsin_terms=BOOT_ARCSIN, base_limbs=2,
        c2s_stages=BOOT_S)
    if not all(torch.equal(x, y) for x, y in zip(out_p, out)):
        raise RuntimeError("the staged bootstrap run step by step != run()")
    say("boot probe: max errors against the secret key's ground truth: "
        + ", ".join(f"{k} {e:.3e} ({-np.log2(max(e, 1e-300)):.1f} bits)"
                    for k, e in errs.items()))

    # the same pipeline at n = 256, B = 1, on the card and on the CPU
    cfg_s = dict(cfg, n=BOOT_SMALL_N)
    outs = {}
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        pr = boot_probe.setup(cfg_s, 1, where, seed=SEED + 11)
        outs[where.type] = pr["run"](pr["arrays"], *pr["ct_low"])
        if where.type == "cuda":
            torch.cuda.synchronize()
        outs[where.type + " s"] = time.perf_counter() - t0
    if not (all(torch.equal(x.cpu(), y) for x, y in zip(outs["cuda"][0],
                                                         outs["cpu"][0]))
            and outs["cuda"][1] == outs["cpu"][1]):
        raise RuntimeError(f"bootstrap at n={BOOT_SMALL_N}: the card's "
                           "output != the CPU's")
    say(f"verify: bootstrap at n={BOOT_SMALL_N}, L={BOOT_L}, K,r={kr}, "
        f"h={BOOT_H}, B=1: the card's output == the CPU's (torch.equal, "
        f"both components, {outs['cuda'][0].c0.shape[0]} limbs); keys + "
        f"bootstrap {outs['cuda s']:.1f} s on the card, "
        f"{outs['cpu s']:.1f} s on the CPU")
    del outs, pr

    # timing: a chain of BOOT_CHAIN, each output dropped to 2 limbs and
    # bootstrapped again (bench.py's loop)
    def boot_chain():
        cur = ct2
        for _ in range(BOOT_CHAIN):
            o, _ = boot_run(expanded, cur.c0, cur.c1)
            cur, _ = P.level_drop(pout, o, 2)
        return cur

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    boot_held = torch.cuda.memory_allocated()
    chain_ms = time_ms(boot_chain, 1, warmup=0)
    peak = torch.cuda.max_memory_allocated()
    stage_ms = {}
    for _ in range(2):
        halves = [(C.CT(ct2.c0, ct2.c1), None)] * 2
        for label, step in boot_run.stages:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            halves = step(frozen, halves)
            e1.record()
            torch.cuda.synchronize()
            stage_ms[label] = min(stage_ms.get(label, 1e30),
                                  e0.elapsed_time(e1))
    say(f"timing: ckks bootstrap at {b7shape}: a chain of {BOOT_CHAIN} in "
        f"{chain_ms:.1f} ms (CUDA events) = "
        f"{BOOT_B * BOOT_CHAIN / (chain_ms / 1e3):.2f} bootstraps/s; peak "
        f"device memory {peak / 2**30:.2f} GiB (keys resident; "
        f"{boot_held / 2**30:.2f} GiB held as the chain began); stage ms "
        f"(best of 2): "
        + ", ".join(f"{k} {v:.1f}" for k, v in stage_ms.items())
        + f"; launches a bootstrap {boot_launches} [{card}]")

    # every distinct (kernel, argument shape) the refresh launched, held
    # against its plain version on the arguments it was given
    for (name, *_), (kern, plain, args, kwargs) in shapes.items():
        hold(name, "bootstrap shape", kern(*args, **kwargs),
             plain(*args, **kwargs))
    torch.cuda.synchronize()
    say(f"parity: the bootstrap's {len(shapes)} distinct kernel argument "
        f"shapes, seen in all {sum(seen.values())} of its launches ("
        + ", ".join(f"{k} {sum(1 for n_, *_ in shapes if n_ == k)}"
                    for k in sorted({n_ for n_, *_ in shapes}))
        + ") == plain (torch.equal)")
    del shapes, frozen, expanded, out, out_p, ct, ct2, bsk, bpk
    torch.cuda.empty_cache()
    phase_done("15 (CKKS bootstrap, n = 2^12)")

    # 16. slice 4: the Rq layer, single-modulus BFV, GLWE over Z_q, CKKS ---
    # the graft entry (__graft_entry__.entry's configuration: q = 2^16 +
    # 1, n = 1024, t = 4, p = q^2, B = 4, bfv.mul with fast=True), keys and
    # encryption on the card; then the reference tests' configurations
    from fhe_study_tpu_torch import entry as EN
    from fhe_study_tpu_torch.arith import rn, rq
    from fhe_study_tpu_torch.models import bfv as SB
    from fhe_study_tpu_torch.models import bfv_noise
    from fhe_study_tpu_torch.models.ckks import Encoder
    from fhe_study_tpu_torch.models.ckks import ckks as SC
    from fhe_study_tpu_torch.models.gfhe import glwe as G
    cpu = torch.device("cpu")
    k9_shapes, k9_seen = {}, {}
    eshape = (f"q={EN.Q} n={EN.N} t={EN.T} p=q^2 B={EN.BATCH} (the "
              f"graft entry)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with record_calls(k9_shapes, k9_seen, ("ntt",)):
        es = EN.setup(dev)
        torch.cuda.synchronize()
        entry_setup_s = time.perf_counter() - t0
        ep, em = es.param, es.m
        for what, ct, want in (
                ("encrypt", es.c2, em),
                ("add", SB.add(es.c1, es.c2, ep), 2 * em % EN.T),
                ("add_const", SB.add_const(ep, es.c1, em), 2 * em % EN.T)):
            if not torch.equal(SB.decrypt(ep, es.sk, ct), want):
                raise RuntimeError(f"entry: {what} does not decrypt")
    say(f"verify: entry at {eshape}: keys, rlk and two encryptions on the "
        f"card in {entry_setup_s:.2f} s (host clock); encrypt, add and "
        f"add_const decrypt exactly in all {em.numel()} coefficients")
    efn = EN.multiply(ep)
    eargs = (*es.c1, *es.c2, *es.rlk)
    entry_label = f"entry: bfv.mul (fast=True) at {eshape}"
    seen_before = k9_seen.get("ntt", 0)
    with record_calls(k9_shapes, k9_seen, ("ntt",)):
        eout = drive(entry_label, ("ntt",), lambda: efn(*eargs))
    entry_k9 = path_launches[entry_label]["ntt"]
    if entry_k9 != k9_seen["ntt"] - seen_before:
        raise RuntimeError("entry: a K9 launch went round the recorder")
    eout_cpu = efn(*(a.cpu() for a in eargs))
    if not all(torch.equal(x.cpu(), y) for x, y in zip(eout, eout_cpu)):
        raise RuntimeError("entry: mul on the card != mul on the CPU")
    say(f"verify: entry mul on the card == the same call on the CPU "
        f"(torch.equal, both components, {eout[0].numel()} coefficients "
        f"each) on the same inputs")
    # polymul_i64_crt at the entry's shapes: the tensor's centered operands
    # and the relinearization's c2 by the key's high limb
    t3 = SB.tensor(ep, es.c1, es.c2, fast=True)
    for what, a, b in (
            ("tensor c1.c0 x c2.c0", rq.to_centered_i64(es.c1.c0, EN.Q),
             rq.to_centered_i64(es.c2.c0, EN.Q)),
            ("relinearize c2 x rlk.r0 >> 28", rq.to_centered_i64(t3[2], EN.Q),
             es.rlk.r0 >> 28)):
        got = ntt.polymul_i64_crt(a, b).cpu().numpy().astype(object)
        want = negacyclic_exact(a.cpu().numpy(), b.cpu().numpy())
        bad = int((got != want).sum())
        if bad:
            raise RuntimeError(f"polymul_i64_crt {what}: {bad} coefficients "
                               "differ from the exact product")
        say(f"verify: polymul_i64_crt {what} {list(a.shape)}: every "
            f"coefficient == the exact negacyclic product in Python integers "
            f"(largest |c| = 2^{np.log2(float(np.abs(want).max())):.1f})")
    prod = rn.naive_poly_mul(em.cpu(), em.cpu()) % EN.T
    noise = bfv_noise.measure_noise(ep, es.sk, SB.RLWE(*eout), prod.to(dev))
    wrong = int((SB.decrypt(ep, es.sk, SB.RLWE(*eout)).cpu() != prod).sum())
    say(f"noise: entry mul at {eshape}: |v|_inf by ciphertext "
        f"{noise.tolist()} against Delta/2 = {ep.delta // 2}; the product "
        f"decrypts wrong in {wrong} of {prod.numel()} coefficients (the "
        f"configuration's noise: the reference's own entry does the same; "
        f"not a check)")
    efn(*eargs)
    entry_runs = [time_ms(lambda: efn(*eargs), 1, warmup=0) for _ in range(3)]
    entry_ms = min(entry_runs)

    # the reference tests' configurations on the card
    mp = SB.Param(RingParam(EN.Q, 64), 2, EN.Q * EN.Q)
    g16 = prng.Gen(SEED + 12)
    sk64, pk64 = SB.new_key(g16, mp, dev, batch=(64,))
    rlk64 = SB.rlk_key(g16, mp, sk64, batch=(64,))
    mm = [prng.uniform_mod(g16, (64, 64), 2, dev) for _ in range(2)]
    cm = [SB.encrypt(g16, mp, pk64, x, batch=(64,)) for x in mm]
    rec = SB.decrypt(mp, sk64, SB.mul(mp, rlk64, *cm, fast=True))
    want = rn.naive_poly_mul(mm[0].cpu(), mm[1].cpu()) % 2
    if not torch.equal(rec.cpu(), want):
        raise RuntimeError("bfv mul at n=64 does not decrypt")
    say("verify: bfv.mul (fast=True) at q=65537 n=64 t=2 B=64 (the "
        "reference test's): decrypted == the exact product in all 64 x 64 "
        "coefficients (plain transforms: below the kernels' n, in both "
        "packages)")
    gp = G.Param(G.ERR_SIGMA, RingParam(EN.Q, 128), 16, 32)
    gshape = "q=65537 n=128 k=16"
    with record_calls(k9_shapes, k9_seen, ("ntt",)):
        gsk, gpk = G.new_key(g16, gp, dev, batch=(32,))
        gm = prng.uniform_mod(g16, (32, 128), 32, dev)
        for what, ct in (("encrypt", G.encrypt(g16, gp, gpk, G.encode(gp, gm),
                                               batch=(32,))),
                         ("encrypt_s", G.encrypt_s(g16, gp, gsk,
                                                   G.encode(gp, gm),
                                                   batch=(32,)))):
            if not torch.equal(G.decode(gp, G.decrypt(gp, gsk, ct)), gm):
                raise RuntimeError(f"glwe {what} at {gshape} does not "
                                   "decrypt")
        kp = G.Param(G.ERR_SIGMA, RingParam(EN.Q, 128), 16, 2)
        s1, p1 = G.new_key(g16, kp, dev)
        s2, _ = G.new_key(g16, kp, dev)
        ksk = G.new_ksk(g16, kp, 2, 16, s1, s2)
        km = prng.uniform_mod(g16, (32, 128), 2, dev)
        kc = G.encrypt(g16, kp, p1, G.encode(kp, km), batch=(32,))
    ks_label = f"glwe key_switch beta=2 l=16 at {gshape} t=2 B=32"
    seen_before = k9_seen["ntt"]
    with record_calls(k9_shapes, k9_seen, ("ntt",)):
        kout = drive(ks_label, ("ntt",),
                     lambda: G.key_switch(kp, 2, 16, ksk, kc))
    if path_launches[ks_label]["ntt"] != k9_seen["ntt"] - seen_before:
        raise RuntimeError("key_switch: a K9 launch went round the recorder")
    if not torch.equal(G.decode(kp, G.decrypt(kp, s2, kout)), km):
        raise RuntimeError("glwe key_switch does not decrypt under the new "
                           "key")
    say(f"verify: glwe at {gshape} t=32 B=32: encrypt and encrypt_s decrypt "
        f"exactly; key_switch (beta=2, l=16, B=32, K9 at n=128) decrypts "
        f"under the new key in all 32 x 128 coefficients")
    cp16 = SC.Param(RingParam(EN.Q, 16), 8)
    enc16 = Encoder(16, 512.0)
    csk, cpk = SC.new_key(g16, cp16, dev, batch=(200,))
    rng16 = np.random.default_rng(SEED + 13)
    z16 = (rng16.integers(0, 8, (200, 8))
           + 1j * rng16.integers(0, 8, (200, 8)))
    cct = SC.encrypt(g16, cp16, cpk, torch.from_numpy(enc16.encode(z16)),
                     batch=(200,))
    zd = enc16.decode(SC.decrypt(cp16, csk, cct).cpu().numpy())
    if not (np.array_equal(np.round(zd.real), z16.real)
            and np.array_equal(np.round(zd.imag), z16.imag)):
        raise RuntimeError("ckks encode -> encrypt -> decrypt -> decode at "
                           "n=16 does not round to the slots")
    say("verify: single-modulus ckks at q=65537 n=16 t=8 delta=512 B=200 "
        "(the reference test's): encode -> encrypt -> decrypt -> decode "
        "rounds to every slot")

    # K9 against plain at every (shape, prime, direction) this phase
    # launched, then its times at the entry's shape and the n = 128 one
    for (name, *_), (kern, plain, args, kwargs) in k9_shapes.items():
        hold(name, "slice 4 shape", kern(*args, **kwargs),
             plain(*args, **kwargs))
    torch.cuda.synchronize()
    k9_sigs = sorted({(tuple(a[0].shape), a[1], kw.get("inverse", False))
                      for kern, plain, a, kw in k9_shapes.values()})
    say(f"parity: K9 == plain (torch.equal) at all {len(k9_shapes)} "
        f"argument signatures this phase launched, {sum(k9_seen.values())} "
        f"launches: (shape, q, inverse) {k9_sigs}")
    busy = torch.zeros(1 << 28, dtype=torch.int32, device=dev)
    k9_alone = {}
    for what, shp, qs in (
            ("entry [4, 1024]", (EN.BATCH, EN.N),
             (EN.Q,) + ntt.CRT_PRIMES[:2]),
            ("key_switch digits [32, 256, 128]", (32, 256, 128), (EN.Q,))):
        for q in qs:
            for inverse in (False, True):
                x = prng.uniform_mod(g16, shp, q, dev)
                case = kernel_check.ntt_case(
                    f"slice 4 {what} q={q} {'inv' if inverse else 'fwd'}",
                    x, q, inverse)
                time_case(case)
                a_ms = queued_ms(case.kernel, 20, busy)
                b = bound(case.bytes, case.ops)
                k9_alone[case.label] = (a_ms, b)
                say(f"timing: ntt {case.label}: on the device alone "
                    f"{a_ms:.4f} ms = {b.ms / a_ms:.4f} of its bound "
                    f"{b.ms:.5f} ms by {b.term} [{card}]")
    del busy
    say(f"timing: entry mul at {eshape}: runs "
        f"{[round(r, 3) for r in entry_runs]} ms (CUDA events), best "
        f"{entry_ms:.3f} ms; {entry_k9} K9 launches of "
        f"[{EN.BATCH}, {EN.N}] ({entry_k9 / max(entry_ms, 1e-9):.1f} a ms) "
        f"[{card}]")
    del es, eargs, eout, eout_cpu, t3, sk64, pk64, rlk64, cm, gsk, gpk, ksk
    del kc, kout, csk, cpk, cct, k9_shapes
    torch.cuda.empty_cache()
    phase_done("16 (slice 4: Rq, BFV, GLWE over Z_q, CKKS, the entry)")

    # 17. slice 8: the parallel layer in several ranks on this card --------
    # 8 ranks on cuda:0 over gloo (NCCL refuses two ranks on one card; gloo
    # stages CUDA tensors through the host, parallel/comm.py), factor_mesh(8)
    # = dp1 x ep2 x sp2 x tp2 as in the reference's dryrun; then the same
    # programs in one rank over NCCL, the route of one rank a card
    full = (N, L, M, T, BATCH, SEED + 1)     # phase 3's paths and draws
    for world, backend in P17_RUNS:
        label = f"phase 17: dryrun_multichip in {world} ranks over {backend}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reports = EN.dryrun_multichip(world, "cuda", backend, P17_TIMEOUT_S,
                                      full)
        seconds = time.perf_counter() - t0
        counts = {k.name: sum(r["launches"].get(k.name, 0) for r in reports)
                  for k in _cuda.KERNELS}
        path_launches[label] = counts
        unlaunched = [k for k in P17_KERNELS if counts[k] == 0]
        if unlaunched:
            raise RuntimeError(f"{label}: never launched {unlaunched}")
        say(f"path: {label} in {seconds:.1f} s (host clock, spawn to the "
            f"last result); launches summed over ranks "
            f"{ {k: v for k, v in counts.items() if v} }")
        for what in reports[0]["programs"]:
            got = [r["programs"][what] for r in reports]
            if not isinstance(got[0], dict):
                say(f"verify: {label}: {what}: {got[0]} in every rank")
                continue
            ms_ = [g["ms"] for g in got]
            say(f"timing: {label}: {what}: {min(ms_):.3f}-{max(ms_):.3f} ms "
                f"over the ranks (CUDA events, one call, rank 0 "
                f"{ms_[0]:.3f}); staged through the host "
                f"{sum(g['staged_bytes'] for g in got)} bytes in all ranks "
                f"[{card}]")
            if "digest" in got[0]:
                if {g["digest"] for g in got} != {mul_e_digest}:
                    raise RuntimeError(f"{label}: {what} != phase 3's "
                                       "single-rank mul_e")
                say(f"verify: {label}: {what} == phase 3's single-rank mul_e "
                    f"in every rank (sha256 of all four components)")
        held = {}
        for r in reports:
            for name, (n_sig, diff) in r["held"].items():
                held[name] = held.get(name, 0) + n_sig
                err[name] = max(err[name], diff)
                checked[name] += n_sig
        missing = [k for k, v in counts.items() if v and k not in held]
        if missing:
            raise RuntimeError(f"{label}: launched {missing} at no held "
                               "signature")
        say(f"parity: {label}: every rank held each distinct kernel argument "
            f"signature it launched against plain (torch.equal): {held} "
            f"signatures over the ranks")
    torch.cuda.empty_cache()
    phase_done("17 (slice 8: the parallel layer, 8 gloo ranks and 1 NCCL "
               "rank on one card)")

    def staged_per_op(L: int, per_op: dict) -> dict:
        """The launches of one op (per_op) that K5 and K6 make in their
        staged layout at L Q-primes: K5's conversion Q -> P, and K6's over P
        from Q (one of its two: the other, over Q, has no source basis)."""
        out = {}
        if per_op.get("ext_ntt") and ntt_cuda.lift_plan(
                _cuda.EXT_NTT, L, 1, N).staged:
            out["ext_ntt"] = per_op["ext_ntt"]
        if per_op.get("tensor_mul4") and ntt_cuda.lift_plan(
                _cuda.TENSOR_MUL4, L, 1, N).staged:
            out["tensor_mul4"] = per_op["tensor_mul4"] // 2
        return out

    def slice_op(tag: str, shape: str, n: int, per_op: dict, op, small_op,
                 chain, decrypt, want_chain, what: str, L: int,
                 held_at: int = PARITY_BATCH):
        """One op of a slice beyond its driven path: its launches per op at
        full batch (``op``) == per_op, those of K5 and K6 in their staged
        layout == staged_per_op(L, per_op), and through the recorded
        wrappers on
        the same op at batch held_at (``small_op``), every launch at ring
        degree n and every argument signature held against plain;
        ``chain`` (CHAIN ops) timed by CUDA events, best of 3, its output
        decrypt-verified against want_chain where given; the chain's peak
        device memory.  Returns the best ms an op."""
        got = per_op_launches(op)
        staged = {k.name: k.by_layout["staged"]
                  for k in (_cuda.EXT_NTT, _cuda.TENSOR_MUL4)
                  if k.by_layout["staged"]}
        if staged != staged_per_op(L, per_op):
            raise RuntimeError(f"{tag}: staged launches of one op {staged} "
                               f"!= {staged_per_op(L, per_op)}")
        sigs, seen = {}, {}
        with record_calls(sigs, seen, tuple(per_op)):
            small_op()
        if got != per_op or seen != per_op:
            raise RuntimeError(f"{tag}: launches of one op {got} (at batch "
                               f"{held_at} through the recorded wrappers "
                               f"{seen}) != {per_op}")
        degrees = {a.shape[-1] for (_, _, args, kw) in sigs.values()
                   for a in (*args, *kw.values())
                   if isinstance(a, torch.Tensor)}
        if degrees != {n}:
            raise RuntimeError(f"{tag}: launched at last axes {degrees}")
        held = kernel_check.hold_recorded(sigs)
        for name, (n_sig, diff) in held.items():
            err[name] = max(err[name], diff)
            checked[name] += n_sig
        say(f"verify: {tag}: one op launches {got} (of which K5's and K6's "
            f"in their staged layout {staged}), every launch at n = {n}; "
            f"each of its {len(sigs)} argument signatures at batch "
            f"{held_at} == plain (torch.equal): {held}")
        del sigs
        out = chain()                      # warm up; its output is decrypted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = [time_ms(chain, 1, warmup=0) for _ in range(3)]
        peak = torch.cuda.max_memory_allocated()
        best = min(runs)
        if want_chain is not None:
            verify(f"{tag}, chain of {CHAIN}", decrypt(out), want_chain, what)
        say(f"timing: {tag} at {shape}, {CHAIN} ops: runs "
            f"{[round(r, 3) for r in runs]} ms, best {best:.3f} ms = "
            f"{best / CHAIN:.3f} ms per op = "
            f"{BATCH * CHAIN / (best / 1e3):.1f} ops/s; peak device memory "
            f"{peak / 2**30:.2f} GiB over the chain; launches per op "
            f"{got} [{card}]")
        return best / CHAIN

    def chain_product(m1, m2, t=T):
        """m1 * m2^CHAIN mod (X^n + 1, t): the plaintext of a chain."""
        want, errs = m1, []
        for _ in range(CHAIN):
            want, e = negacyclic_reference(want, m2, t)
            errs.append(e)
        return want, max(errs)

    # 18. slice 10: ring degree 2^15 ------------------------------------------
    w_param = R.RnsParam(n=W_N, t=T, L=W_L, M=W_M)
    w_shape = f"N={W_N} L={W_L} M={W_M} K={W_K} t={T} B={BATCH}"
    w_logn = W_N.bit_length() - 1
    wide = [r for r in radix_entries
            if r["kernel"].split("<")[0].removesuffix("_kernel")
            in W_INSTANCES
            and r["kernel"].split("<")[1].split(",")[0].rstrip(">")
            == str(w_logn)]
    got_inst = {k: sum(r["kernel"].startswith(k + "_kernel<") for r in wide)
                for k in W_INSTANCES}
    if got_inst != W_INSTANCES:
        raise RuntimeError(f"the n = 2^{w_logn} instances {got_inst} != "
                           f"{W_INSTANCES}")
    say(f"ptxas: the {len(wide)} instances at n = 2^{w_logn} (no stack frame "
        f"or spills, phase 1): "
        + "; ".join(f"{r['kernel']} {r['registers']} registers" for r in wide))
    gen = prng.Gen(SEED + 20)
    w = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()

    def wide_path():
        w["sk"], pk = R.new_key(gen, w_param, dev)
        w["hk"] = R.hybrid_rlk1(gen, w_param, w["sk"], K=W_K)
        w["m"] = [prng.uniform_mod(gen, (BATCH, W_N), T, dev)
                  for _ in range(2)]
        w["c"] = [R.encrypt(gen, w_param, pk, m, batch=(BATCH,))
                  for m in w["m"]]
        w["small"] = [R.encrypt(gen, w_param, pk, m[:PARITY_BATCH],
                                batch=(PARITY_BATCH,)) for m in w["m"]]
        w["e"] = [R.to_evals(w_param, c) for c in w["c"]]
        ce = R.mul_e(w_param, w["hk"], *w["e"])
        return R.decrypt(w_param, w["sk"], R.from_evals(w_param, ce))

    rec = drive(f"slice 10: keygen -> hybrid_rlk1 -> encrypt -> to_evals -> "
                f"mul_e (HRLK) -> from_evals -> decrypt at {w_shape}",
                tuple(W_PER_OP), wide_path)
    path_peak = torch.cuda.max_memory_allocated()
    wm1, wm2 = (m.cpu().numpy() for m in w["m"])
    product, fft_err = negacyclic_reference(wm1, wm2, T)
    verify(f"slice 10 mul_e (HRLK) at {w_shape}", rec, product,
           f"the numpy FFT negacyclic product (rounding error "
           f"{fft_err:.2e})")
    (wx, wy), whk = w["e"], w["hk"]
    say(f"path: slice 10 peak device memory {path_peak / 2**30:.2f} GiB over "
        f"the path (of which {held_before / 2**30:.2f} GiB were held before "
        f"the phase)")
    want, err_c = chain_product(wm1, wm2)
    chain_what = (f"the numpy FFT negacyclic products of the same chain "
                  f"(rounding error at most {err_c:.2e})")

    def w_chain():
        c = wx
        for _ in range(CHAIN):
            c = R.mul_e(w_param, whk, c, wy)
        return c

    slice_op("slice 10 mul_e (HRLK)", w_shape, W_N, W_PER_OP,
             lambda: R.mul_e(w_param, whk, wx, wy),
             lambda: R.mul_e(w_param, whk, wx, wy), w_chain,
             lambda c: R.decrypt(w_param, w["sk"], R.from_evals(w_param, c)),
             want, chain_what, W_L, held_at=BATCH)
    # slice 11: mul with the hybrid key at 2^15 on the same keys: K6 over Q
    # and over P from 14 sources on two-block clusters, K4, K1, K3
    (wc1, wc2), (ws1, ws2) = w["c"], w["small"]
    rec = drive(f"slice 11: mul (HRLK) -> decrypt at {w_shape}",
                tuple(W_MUL_PER_OP),
                lambda: R.decrypt(w_param, w["sk"], R.mul(w_param, whk, wc1,
                                                          wc2)))
    verify(f"slice 11 mul (HRLK) at {w_shape}", rec, product,
           f"the numpy FFT negacyclic product (rounding error "
           f"{fft_err:.2e})")

    def w_mul_chain():
        c = wc1
        for _ in range(CHAIN):
            c = R.mul(w_param, whk, c, wc2)
        return c

    slice_op("slice 11 mul (HRLK)", w_shape, W_N, W_MUL_PER_OP,
             lambda: R.mul(w_param, whk, wc1, wc2),
             lambda: R.mul(w_param, whk, ws1, ws2), w_mul_chain,
             lambda c: R.decrypt(w_param, w["sk"], c), want, chain_what,
             W_L)
    del rec, want, product, wc1, wc2, ws1, ws2
    # each widened kernel against plain at the path's shapes, batch 8; K9 on
    # [8, 2^15] under a 30-bit and a 31-bit prime; K12 at n = 2^15
    gen = prng.Gen(SEED + 21)
    w_cases = kernel_check.cases(w_param, PARITY_BATCH, dev, gen, K=W_K)
    for q in (ntt.CRT_PRIMES_TFHE[0], ntt.CRT_PRIMES[0]):
        x9 = prng.uniform_mod(gen, (PARITY_BATCH, W_N), q, dev)
        w_cases += [kernel_check.ntt_case(
            f"slice 10 [{PARITY_BATCH}, {W_N}] q={q} "
            f"{'inverse' if inv else 'forward'}", x9, q, inv)
            for inv in (False, True)]
    w_cases += [c for c in kernel_check.bench_cases(W_N, PARITY_BATCH, dev,
                                                    gen)
                if c.name == "ntt_smem_ceiling"]
    w_cases += kernel_check.lift_cases(w_param, PARITY_BATCH, dev, gen)
    for case in w_cases:
        got, want = case.kernel(), case.plain()
        torch.cuda.synchronize()
        check(case, got, want)
    say(f"parity: slice 10 at n = {W_N}, batch {PARITY_BATCH}: "
        f"{len(w_cases)} variants of {sorted({c.name for c in w_cases})} == "
        f"plain (torch.equal)")
    del w_cases, case, got, want, x9
    # each at the path's shape (B = 128, operands drawn on the card), and K9
    # on [128, 2^15], on the device alone, beside its bound
    t_cases = kernel_check.cases(
        w_param, BATCH, dev, gen, K=W_K,
        res=prng.device_residues(SEED + 22, dev))
    q9 = ntt.CRT_PRIMES[0]
    x9 = prng.uniform_mod(gen, (BATCH, W_N), q9, dev)
    t_cases += [kernel_check.ntt_case(
        f"[{BATCH}, {W_N}] q={q9} {'inverse' if inv else 'forward'}", x9, q9,
        inv) for inv in (False, True)]
    t_cases += kernel_check.lift_cases(
        w_param, BATCH, dev, gen, res=prng.device_residues(SEED + 23, dev))
    busy = torch.zeros(1 << 28, dtype=torch.int32, device=dev)
    w_ms = {}
    for case in t_cases:
        case.kernel()
        a_ms = queued_ms(case.kernel, 10, busy)
        b = bound(case.bytes, case.ops)
        if a_ms < b.ms:
            raise RuntimeError(f"slice 10 {case.name} [{case.label}]: "
                               f"{a_ms:.4f} ms is under its bound {b}")
        w_ms[case.label] = a_ms
        say(f"timing: slice 10 {case.name:13s} {case.label:44s} on the "
            f"device alone {a_ms:8.4f} ms, bound {b.ms:.4f} ms by {b.term} "
            f"(bytes {b.bytes_ms:.4f}, issue {b.issue_ms:.4f}, ALU "
            f"{b.alu_ms:.4f}, FMA {b.fma_ms:.4f}): {b.ms / a_ms:.3f} of it; "
            + (LIFT_LAUNCHES if case.name == LIFT else
               f"{W_PER_OP.get(case.name, 0)} launches of {case.name} per "
               f"mul_e, {W_MUL_PER_OP.get(case.name, 0)} per mul (HRLK)")
            + f" [{card}]")
    del busy
    per_sm = alu_bench.resident_blocks(dev, n=W_N)[0]
    ceil = alu_bench.ntt_smem_ceiling(dev, n=W_N, B=per_sm * sms,
                                      reps=CEILING_REPS)
    (xin,), rows = ceil["operands"], [0, 1, ceil["B"] - 2, ceil["B"] - 1]
    hold("ntt_smem_ceiling", f"slice 10: the timed launch, reps="
         f"{ceil['reps']} B={ceil['B']} n={W_N}", ceil["out"][rows],
         alu_bench.ntt_smem_ceiling_plain(xin[rows], ceil["q"],
                                          ceil["reps"]))
    k1 = next(c for c in t_cases if c.name == "ntt_multi"
              and c.label.startswith("forward Q "))
    k1_rate = k1.butterflies / (w_ms[k1.label] * 1e-3)
    bf_bound = 1e3 / bound(0, kernel_check.BUTTERFLY_OPS).ms
    say(f"ceiling: slice 10, n = {W_N}: B={ceil['B']} ({per_sm} resident "
        f"block(s) x {sms} SMs), reps={CEILING_REPS}: "
        f"{ceil['butterflies_per_sec']:.4e} butterflies/s = "
        f"{ceil['butterflies_per_sec'] / bf_bound:.3f} of the bound's "
        f"{bf_bound:.4e} (its timed launch == plain on 4 polynomials); K1's "
        f"forward Q at the path's shape {k1_rate:.4e} butterflies/s = "
        f"{k1_rate / ceil['butterflies_per_sec']:.3f} of it [{card}]")
    del t_cases, k1, ceil, xin, x9, w, wx, wy, whk
    torch.cuda.empty_cache()
    phase_done(f"18 (slice 10: ring degree 2^15, mul_e HRLK at {w_shape}) "
               f"[{card}]")

    # 19. slice 11: the gadget keyring at the whole modulus ------------------
    g_param = R.RnsParam(n=G_N, t=T, L=G_L, M=G_M)
    g_shape = f"N={G_N} L={G_L} M={G_M} t={T} B={BATCH}"
    gen = prng.Gen(SEED + 30)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    g = {}

    def gadget_path():
        g["sk"], g["pk"] = R.new_key(gen, g_param, dev)
        g["rlk"] = R.rlk_key(gen, g_param, g["sk"])
        g["m"] = [prng.uniform_mod(gen, (BATCH, G_N), T, dev)
                  for _ in range(2)]
        g["c"] = [R.encrypt(gen, g_param, g["pk"], m, batch=(BATCH,))
                  for m in g["m"]]
        return R.decrypt(g_param, g["sk"], R.mul(g_param, g["rlk"],
                                                  *g["c"]))

    t0 = time.perf_counter()
    rec = drive(f"slice 11: keygen -> rlk_key -> encrypt -> mul (RLK) -> "
                f"decrypt at {g_shape}", tuple(G_PER_OP["mul (RLK)"]),
                gadget_path)
    path_peak = torch.cuda.max_memory_allocated()
    rlk_bytes = sum(t.numel() * t.element_size() for t in g["rlk"])
    gm1, gm2 = (m.cpu().numpy() for m in g["m"])
    product, fft_err = negacyclic_reference(gm1, gm2, T)
    fft = (f"the numpy FFT negacyclic product (rounding error "
           f"{fft_err:.2e})")
    verify(f"slice 11 mul (RLK) at {g_shape}", rec, product, fft)
    say(f"path: slice 11 keys and ciphertexts at {g_shape} in "
        f"{time.perf_counter() - t0:.1f} s (host clock, the op and decrypt "
        f"included); rlk {rlk_bytes / 2**20:.1f} MiB ({G_L} digit rows); "
        f"peak device memory {path_peak / 2**30:.2f} GiB over the path (of "
        f"which {held_before / 2**30:.2f} GiB were held before the phase)")
    grlk, (gc1, gc2) = g["rlk"], g["c"]
    gs1, gs2 = (R.encrypt(gen, g_param, g["pk"], m[:PARITY_BATCH],
                          batch=(PARITY_BATCH,)) for m in g["m"])
    want, err_c = chain_product(gm1, gm2)
    chain_what = (f"the numpy FFT negacyclic products of the same chain "
                  f"(rounding error at most {err_c:.2e})")

    def g_decrypt(c):
        return R.decrypt(g_param, g["sk"], c)

    def g_mul_chain():
        c = gc1
        for _ in range(CHAIN):
            c = R.mul(g_param, grlk, c, gc2)
        return c

    g_ms = {"mul (RLK)": slice_op(
        "slice 11 mul (RLK)", g_shape, G_N, G_PER_OP["mul (RLK)"],
        lambda: R.mul(g_param, grlk, gc1, gc2),
        lambda: R.mul(g_param, grlk, gs1, gs2), g_mul_chain, g_decrypt,
        want, chain_what, G_L)}
    rec = drive(f"slice 11: to_evals -> mul_e (RLK) -> from_evals -> "
                f"decrypt at {g_shape}",
                ("ntt_multi", "ext_ntt", *G_PER_OP["mul_e (RLK)"]),
                lambda: g_decrypt(R.from_evals(g_param, R.mul_e(
                    g_param, grlk, R.to_evals(g_param, gc1),
                    R.to_evals(g_param, gc2)))))
    verify(f"slice 11 mul_e (RLK) at {g_shape}", rec, product, fft)
    gx, gy = (R.to_evals(g_param, c) for c in (gc1, gc2))
    gsx, gsy = (R.to_evals(g_param, c) for c in (gs1, gs2))

    def g_mul_e_chain():
        c = gx
        for _ in range(CHAIN):
            c = R.mul_e(g_param, grlk, c, gy)
        return c

    g_ms["mul_e (RLK)"] = slice_op(
        "slice 11 mul_e (RLK)", g_shape, G_N, G_PER_OP["mul_e (RLK)"],
        lambda: R.mul_e(g_param, grlk, gx, gy),
        lambda: R.mul_e(g_param, grlk, gsx, gsy), g_mul_e_chain,
        lambda c: g_decrypt(R.from_evals(g_param, c)), want, chain_what,
        G_L)
    del gx, gy, gsx, gsy, g["rlk"], grlk
    g["sk2"], _ = R.new_key(gen, g_param, dev)
    gksk = R.ksk_key(gen, g_param, g["sk"], g["sk2"])
    rec = drive(f"slice 11: ksk_key -> key_switch -> decrypt under the new "
                f"key at {g_shape}", tuple(G_PER_OP["key_switch"]),
                lambda: R.decrypt(g_param, g["sk2"],
                                  R.key_switch(g_param, gksk, gc1)))
    verify(f"slice 11 key_switch at {g_shape}", rec, gm1,
           "the plaintext that was encrypted")

    def g_ks_calls():
        for _ in range(CHAIN):
            c = R.key_switch(g_param, gksk, gc1)
        return c

    g_ms["key_switch"] = slice_op(
        "slice 11 key_switch", g_shape, G_N, G_PER_OP["key_switch"],
        lambda: R.key_switch(g_param, gksk, gc1),
        lambda: R.key_switch(g_param, gksk, gs1), g_ks_calls, None, None,
        "", G_L)
    del rec, want, product, gksk, gs1, gs2
    # each kernel of the slice at the path's shapes (B = 128, operands drawn
    # on the card) on the device alone beside its bound: K6, K7, K8 at R = L
    # over Q and the conversions from 29 and 30 sources (kernel_check.cases
    # at this param), and K11 from 29 sources to 30
    res = prng.device_residues(SEED + 31, dev)
    g_cases = [c for c in kernel_check.cases(g_param, BATCH, dev, gen,
                                             res=res)
               if c.name in ("tensor_mul4", "ks_fused", "ks_fused_eval",
                             "ext_ntt")
               or c.label.startswith(("Q->P (w - ext)", "P->Q centered"))]
    g_cases.append(kernel_check._ext_sum_pair(
        res(g_param.qs, (BATCH, G_N)), g_param.qs, g_param.ps, True,
        f"Q->P [{G_L}, {BATCH}, {G_N}]")[0])
    g_cases += kernel_check.lift_cases(g_param, BATCH, dev, gen, res=res)
    for case in kernel_check.lift_cases(g_param, PARITY_BATCH, dev, gen):
        check(case, case.kernel(), case.plain())
    say(f"parity: slice 11 the lift (from {G_L} sources) on K5's and K6's "
        f"operands at batch {PARITY_BATCH} == plain (torch.equal)")
    busy = torch.zeros(1 << 28, dtype=torch.int32, device=dev)
    for case in g_cases:
        case.kernel()
        a_ms = queued_ms(case.kernel, 3, busy)
        b = bound(case.bytes, case.ops)
        if a_ms < b.ms:
            raise RuntimeError(f"slice 11 {case.name} [{case.label}]: "
                               f"{a_ms:.4f} ms is under its bound {b}")
        per = {tag: ops.get(case.name, 0) for tag, ops in G_PER_OP.items()}
        say(f"timing: slice 11 {case.name:13s} {case.label:44s} on the "
            f"device alone {a_ms:8.4f} ms, bound {b.ms:.4f} ms by {b.term} "
            f"(bytes {b.bytes_ms:.4f}, issue {b.issue_ms:.4f}, ALU "
            f"{b.alu_ms:.4f}, FMA {b.fma_ms:.4f}): {b.ms / a_ms:.3f} of it; "
            + (LIFT_LAUNCHES if case.name == LIFT else
               f"launches per op {per}") + f" [{card}]")
    del g_cases, case, busy, res, g, gc1, gc2
    torch.cuda.empty_cache()
    say(f"timing: slice 11 at {g_shape}: ms an op "
        f"{ {k: round(v, 3) for k, v in g_ms.items()} } [{card}]")
    phase_done(f"19 (slice 11: the gadget keyring at {g_shape}) [{card}]")

    # 20. slice 12: the reference tests' small configurations ---------------
    # (a) RNS-BFV at n = 128, t = 16, L = 3, M = 4 (tests/test_bfv_rns.py:
    # 149) through K1-K3 and K5-K8 at 2^7: the 2^7 instances, the paths,
    # each op's launches and argument signatures, chains of 4
    s_param = R.RnsParam(**kernel_check.SMALL_BFV)
    s_n, s_t = s_param.n, s_param.t
    s_shape = (f"N={s_n} L={len(s_param.qs)} M={len(s_param.ps)} K=2 "
               f"t={s_t} B={BATCH}")
    s_logn = s_n.bit_length() - 1
    small = [r for r in radix_entries
             if r["kernel"].split("<")[0].removesuffix("_kernel")
             in S_INSTANCES
             and r["kernel"].split("<")[1].split(",")[0].rstrip(">")
             == str(s_logn)]
    got_inst = {k: sum(r["kernel"].startswith(k + "_kernel<") for r in small)
                for k in S_INSTANCES}
    if got_inst != S_INSTANCES:
        raise RuntimeError(f"the n = 2^{s_logn} instances {got_inst} != "
                           f"{S_INSTANCES}")
    say(f"ptxas: the {len(small)} instances at n = 2^{s_logn} (no stack "
        f"frame or spills, phase 1): "
        + "; ".join(f"{r['kernel']} {r['registers']} registers"
                    for r in small))
    gen = prng.Gen(SEED + 40)
    sb = {}
    s_per_op = {}
    launches_before = len(path_launches)

    def small_path():
        sb["sk"], pk = R.new_key(gen, s_param, dev)
        sb["hk"] = R.hybrid_rlk1(gen, s_param, sb["sk"])
        sb["m"] = [prng.uniform_mod(gen, (BATCH, s_n), s_t, dev)
                   for _ in range(2)]
        sb["c"] = [R.encrypt(gen, s_param, pk, m, batch=(BATCH,))
                   for m in sb["m"]]
        sb["small"] = [R.encrypt(gen, s_param, pk, m[:PARITY_BATCH],
                                 batch=(PARITY_BATCH,)) for m in sb["m"]]
        sb["e"] = [R.to_evals(s_param, c) for c in sb["c"]]
        ce = R.mul_e(s_param, sb["hk"], *sb["e"])
        return R.decrypt(s_param, sb["sk"], R.from_evals(s_param, ce))

    rec = drive(f"slice 12: keygen -> hybrid_rlk1 -> encrypt -> to_evals -> "
                f"mul_e (HRLK) -> from_evals -> decrypt at {s_shape}",
                tuple(W_PER_OP), small_path)
    sm1, sm2 = (m.cpu().numpy() for m in sb["m"])
    product, fft_err = negacyclic_reference(sm1, sm2, s_t)
    fft = f"the numpy FFT negacyclic product (rounding error {fft_err:.2e})"
    verify(f"slice 12 mul_e (HRLK) at {s_shape}", rec, product, fft)
    ssk, shk = sb["sk"], sb["hk"]
    (sc1, sc2), (ss1, ss2), (sx, sy) = sb["c"], sb["small"], sb["e"]
    srlk = R.rlk_key(gen, s_param, ssk)
    ssk2, _ = R.new_key(gen, s_param, dev)
    sksk = R.ksk_key(gen, s_param, ssk, ssk2)
    s_ops = {"mul (RLK)": G_PER_OP["mul (RLK)"], "mul (HRLK)": W_MUL_PER_OP}
    for tag, key in (("mul (RLK)", srlk), ("mul (HRLK)", shk)):
        rec = drive(f"slice 12: {tag} -> decrypt at {s_shape}",
                    tuple(s_ops[tag]),
                    lambda: R.decrypt(s_param, ssk, R.mul(s_param, key, sc1,
                                                          sc2)))
        verify(f"slice 12 {tag} at {s_shape}", rec, product, fft)
    rec = drive(f"slice 12: to_evals -> mul_e (RLK) -> from_evals -> decrypt "
                f"at {s_shape}", ("ntt_multi", "ext_ntt",
                                  *G_PER_OP["mul_e (RLK)"]),
                lambda: R.decrypt(s_param, ssk, R.from_evals(s_param, R.mul_e(
                    s_param, srlk, R.to_evals(s_param, sc1),
                    R.to_evals(s_param, sc2)))))
    verify(f"slice 12 mul_e (RLK) at {s_shape}", rec, product, fft)
    rec = drive(f"slice 12: key_switch -> decrypt under the second key at "
                f"{s_shape}", tuple(G_PER_OP["key_switch"]),
                lambda: R.decrypt(s_param, ssk2,
                                  R.key_switch(s_param, sksk, sc1)))
    verify(f"slice 12 key_switch at {s_shape}", rec, sm1,
           "the plaintext that was encrypted")
    sem = {}

    def s_linear():
        sem["em"] = R.pt_to_evals(s_param, sb["m"][1])
        step = R.mul_pt_e(s_param, R.add_e(s_param, sx, sy), sem["em"])
        return R.decrypt(s_param, ssk, R.from_evals(s_param, step))

    rec = drive(f"slice 12: pt_to_evals, mul_pt_e(add_e) -> from_evals -> "
                f"decrypt at {s_shape}", ("ntt_multi",), s_linear)
    want, e_lin = negacyclic_reference((sm1 + sm2) % s_t, sm2, s_t)
    verify(f"slice 12 linear step (m1 + m2) * m2 at {s_shape}", rec, want,
           f"the numpy FFT negacyclic product (rounding error {e_lin:.2e})")
    s_tq = (s_t,) * len(s_param.qs)
    sx4 = torch.stack([sc1.c0, sc1.c1, sc2.c0, sc2.c1], dim=-2)
    stacked = drive(f"slice 12: tensor_mul_multi on the stacked pair at "
                    f"{s_shape}", ("tensor_mul",),
                    lambda: ntt.tensor_mul_multi(sx4, s_param.qs,
                                                 scale=s_tq))
    if not (torch.equal(stacked, ntt_cuda.tensor_mul_plain(
            sx4, s_param.qs, scale=s_tq))
            and torch.equal(stacked, ntt.tensor_mul4(*sc1, *sc2, s_param.qs,
                                                     scale=s_tq))):
        raise RuntimeError("slice 12: tensor_mul_multi != tensor_mul_plain "
                           "or tensor_mul4 on the same ciphertexts")
    say("verify: slice 12 tensor_mul_multi == tensor_mul_plain == "
        "tensor_mul4 (torch.equal) on the ciphertexts of mul above")
    s_phase = {}
    for label in list(path_launches)[launches_before:]:
        for k, v in path_launches[label].items():
            s_phase[k] = s_phase.get(k, 0) + v
    missing = [k for k in S_KERNELS if not s_phase.get(k)]
    if missing:
        raise RuntimeError(f"slice 12 at n = {s_n}: never launched {missing}")
    say(f"verify: slice 12 at n = {s_n}: K1-K3 and K5-K8 launched, by kernel "
        f"over the paths { {k: s_phase[k] for k in S_KERNELS} }")
    want, err_c = chain_product(sm1, sm2, s_t)
    chain_what = (f"the numpy FFT negacyclic products of the same chain "
                  f"(rounding error at most {err_c:.2e})")
    s_ms = {}

    def s_dec(c):
        return R.decrypt(s_param, ssk, c)

    def s_dec_e(c):
        return s_dec(R.from_evals(s_param, c))

    ssx, ssy = (R.to_evals(s_param, c) for c in (ss1, ss2))
    for tag, key, per_op in (("mul_e (HRLK)", shk, W_PER_OP),
                             ("mul_e (RLK)", srlk, G_PER_OP["mul_e (RLK)"])):
        s_per_op[tag] = per_op
        s_ms[tag] = slice_op(
            f"slice 12 {tag}", s_shape, s_n, per_op,
            lambda: R.mul_e(s_param, key, sx, sy),
            lambda: R.mul_e(s_param, key, ssx, ssy),
            chain_of(lambda c: R.mul_e(s_param, key, c, sy), sx), s_dec_e,
            want, chain_what, S_L)
    for tag, key in (("mul (RLK)", srlk), ("mul (HRLK)", shk)):
        s_per_op[tag] = s_ops[tag]
        s_ms[tag] = slice_op(
            f"slice 12 {tag}", s_shape, s_n, s_ops[tag],
            lambda: R.mul(s_param, key, sc1, sc2),
            lambda: R.mul(s_param, key, ss1, ss2),
            chain_of(lambda c: R.mul(s_param, key, c, sc2), sc1), s_dec,
            want, chain_what, S_L)
    s_per_op["key_switch"] = G_PER_OP["key_switch"]
    s_ms["key_switch"] = slice_op(
        "slice 12 key_switch", s_shape, s_n, G_PER_OP["key_switch"],
        lambda: R.key_switch(s_param, sksk, sc1),
        lambda: R.key_switch(s_param, sksk, ss1),
        chain_of(lambda c: R.key_switch(s_param, sksk, sc1), sc1), None, None,
        "", S_L)

    def best_of_3(fn) -> float:
        fn()
        return min(time_ms(fn, 1, warmup=0) for _ in range(3))

    for tag, fn in (("to_evals", lambda: R.to_evals(s_param, sc1)),
                    ("from_evals", lambda: R.from_evals(s_param, sx)),
                    ("pt_to_evals", lambda: R.pt_to_evals(s_param,
                                                          sb["m"][1])),
                    ("add_e", lambda: R.add_e(s_param, sx, sy)),
                    ("mul_pt_e", lambda: R.mul_pt_e(s_param, sx,
                                                    sem["em"]))):
        s_per_op[tag] = per_op_launches(fn)
        s_ms[tag] = best_of_3(fn)
    say(f"timing: slice 12 at {s_shape}, CUDA events, best of 3: ms an op "
        f"{ {k: round(v, 4) for k, v in s_ms.items()} }; launches an op "
        f"{s_per_op} [{card}]")
    # the reference's test at t = 4 (tests/test_bfv_rns.py:111): mul_e on
    # eval-resident ciphertexts equals mul, the round trip is the identity,
    # and a depth-2 chain ((m1 m2) + m1) m2 stays eval-resident
    p4 = R.RnsParam(n=s_n, t=S_T4, L=S_L, M=S_M)
    sk4, pk4 = R.new_key(gen, p4, dev)
    rlk4 = R.rlk_key(gen, p4, sk4)
    m4 = [prng.uniform_mod(gen, (S_T4_BATCH, s_n), S_T4, dev)
          for _ in range(2)]
    c4 = [R.encrypt(gen, p4, pk4, m, batch=(S_T4_BATCH,)) for m in m4]
    ref4 = R.mul(p4, rlk4, *c4)
    e4 = [R.to_evals(p4, c) for c in c4]
    ce4 = R.mul_e(p4, rlk4, *e4)
    got4 = R.from_evals(p4, ce4)
    rt4 = R.from_evals(p4, e4[0])
    if not (torch.equal(got4.c0, ref4.c0) and torch.equal(got4.c1, ref4.c1)
            and torch.equal(rt4.c0, c4[0].c0)
            and torch.equal(rt4.c1, c4[0].c1)):
        raise RuntimeError(f"slice 12 at t = {S_T4}: from_evals(mul_e) != "
                           "mul, or the round trip is not the identity")
    rec = R.decrypt(p4, sk4, R.from_evals(p4, R.mul_e(
        p4, rlk4, R.add_e(p4, ce4, e4[0]), e4[1])))
    a4, b4 = (m.cpu().numpy() for m in m4)
    w1, _ = negacyclic_reference(a4, b4, S_T4)
    w2, _ = negacyclic_reference((w1 + a4) % S_T4, b4, S_T4)
    verify(f"slice 12 at N={s_n} t={S_T4} B={S_T4_BATCH}: mul_e (RLK) == mul "
           f"(torch.equal), to_evals -> from_evals == id, and the depth-2 "
           f"chain mul_e(add_e(mul_e, x), y)", rec, w2,
           "((m1 m2) + m1) m2 by numpy")
    del sb, rec, product, want, sx4, stacked, ssx, ssy, c4, e4, ce4

    # (b) TFHE at n = 128, K = 1, t = 8, beta = 256, l = 3, beta_ks = 16,
    # l_ks = 8 (tests/test_bootstrap.py:48-57): bootstrap through K10, and
    # the keyswitch-first pipeline over a short key of 64
    sf = kernel_check.SMALL_TFHE
    s_tp = Param(ERR_SIGMA, RingParam(TORUS_Q, sf["n"]), sf["k"], TFHE_T)
    s_gadget = dict(beta=sf["beta"], l=sf["l"], beta_ks=TFHE_BETA_KS,
                    l_ks=TFHE_L_KS)
    s_tshape = (f"N={sf['n']} K={sf['k']} t={TFHE_T} B={TFHE_BATCH} "
                f"beta={sf['beta']} l={sf['l']} beta_ks={TFHE_BETA_KS} "
                f"l_ks={TFHE_L_KS}")
    gen = prng.Gen(SEED + 41)
    s_table = bootstrap.compute_lookup_table_standard(s_tp, dev)
    stf = {}

    def s_decoded(s_key, ct):
        return tlwe.decode(s_tp, tlwe.decrypt(s_tp.lwe(), s_key, ct))

    def small_tfhe():
        s, _ = tglwe.new_key(gen, s_tp, dev)
        stf["s_flat"] = tglwe.sk_to_tlwe(s)
        stf["btk"], s_out = bootstrap.new_bootstrapping_key(
            gen, s_tp, s, s_lwe_out=stf["s_flat"], **s_gadget)
        stf["s"] = s
        stf["evals"] = bootstrap.precompute_btk_evals(s_tp, stf["btk"])
        stf["c"] = tlwe.encrypt_uniform(gen, s_tp.lwe(), stf["s_flat"],
                                        tlwe.encode(s_tp, msgs),
                                        batch=(TFHE_BATCH,))
        out = bootstrap.bootstrap(s_tp, stf["btk"], s_table, stf["c"],
                                  mode="standard", btk_evals=stf["evals"],
                                  **s_gadget)
        return s_decoded(s_out, out)

    got = drive(f"slice 12: tglwe.new_key -> new_bootstrapping_key -> "
                f"precompute_btk_evals -> encrypt_uniform -> bootstrap -> "
                f"decrypt at {s_tshape}", ("ntt", "blind_rotate"),
                small_tfhe)
    verify_messages(f"slice 12 bootstrap ({sf['n']} CMux steps) at "
                    f"{s_tshape}", got)
    s_btk, s_evals, s_ct, s_flat = (stf[k] for k in ("btk", "evals", "c",
                                                     "s_flat"))
    stepwise = bootstrap.blind_rotation(s_tp, s_btk, s_table, s_ct,
                                        sf["beta"], sf["l"],
                                        btk_evals=s_evals, fused=False)
    fused = bootstrap.blind_rotation(s_tp, s_btk, s_table, s_ct, sf["beta"],
                                     sf["l"], btk_evals=s_evals)
    if not (torch.equal(fused.a, stepwise.a)
            and torch.equal(fused.b, stepwise.b)):
        raise RuntimeError("slice 12: blind_rotate kernel != the "
                           "step-by-step chain at n = 128")
    say(f"verify: slice 12 blind_rotate (one launch) == {sf['n']} steps of "
        f"cmux_evals (torch.equal) on the {TFHE_BATCH} ciphertexts")
    del stepwise, fused

    def s_short():
        stf["sbtk"] = bootstrap.new_short_bootstrapping_key(
            gen, s_tp, stf["s"], n_lwe=sf["n_lwe"], **s_gadget)
        stf["sevals"] = bootstrap.precompute_short_btk_evals(s_tp,
                                                             stf["sbtk"])
        first = bootstrap.bootstrap_short(s_tp, stf["sbtk"], s_table, s_ct,
                                          btk_evals=stf["sevals"], **s_gadget)
        second = bootstrap.bootstrap_short(s_tp, stf["sbtk"], s_table, first,
                                           btk_evals=stf["sevals"],
                                           **s_gadget)
        return s_decoded(s_flat, first), s_decoded(s_flat, second)

    got1, got2 = drive(f"slice 12: new_short_bootstrapping_key(n_lwe="
                       f"{sf['n_lwe']}) -> bootstrap_short x 2 -> decrypt at "
                       f"{s_tshape}", ("ntt", "blind_rotate"), s_short)
    verify_messages(f"slice 12 bootstrap_short ({sf['n_lwe']} CMux steps)",
                    got1)
    verify_messages("slice 12 bootstrap_short of its own output", got2)
    s_sbtk, s_sevals = stf["sbtk"], stf["sevals"]
    for tag, step in (
            (f"bootstrap ({sf['n']} steps)",
             lambda c: bootstrap.bootstrap(s_tp, s_btk, s_table, c,
                                           mode="standard",
                                           btk_evals=s_evals, **s_gadget)),
            (f"bootstrap_short ({sf['n_lwe']} steps)",
             lambda c: bootstrap.bootstrap_short(s_tp, s_sbtk, s_table, c,
                                                 btk_evals=s_sevals,
                                                 **s_gadget))):
        per_op = per_op_launches(lambda: step(s_ct))
        if per_op.get("blind_rotate") != 1:
            raise RuntimeError(f"slice 12 {tag}: launches {per_op}, not one "
                               "blind_rotate a bootstrap")
        s_per_op[tag.split(" (")[0]] = per_op
        chain = chain_of(step, s_ct)
        verify_messages(f"slice 12 chain of {CHAIN} {tag}",
                        s_decoded(s_flat, chain()))
        torch.cuda.synchronize()
        runs = [time_ms(chain, 1, warmup=0) for _ in range(3)]
        best = min(runs)
        s_ms[tag] = best / CHAIN
        say(f"timing: slice 12 chain of {CHAIN} {tag} at {s_tshape}: runs "
            f"{[round(r, 3) for r in runs]} ms, best {best:.3f} ms = "
            f"{best / CHAIN:.3f} ms a batch = "
            f"{TFHE_BATCH * CHAIN / (best / 1e3):.1f} bootstraps/s; launches "
            f"a bootstrap {per_op} [{card}]")
    del stf, s_btk, s_evals, s_sbtk, s_sevals, s_ct

    # (c) the gate at n = 64: RNS-BFV at t = 65537 (tests/test_galois.py:50:
    # mul_e with both keys, one rotation) and RNS-CKKS at delta = 2^25
    # (:145: mul_hybrid, one rotation); no multi-prime op passes the gate,
    # so on the card they run their plain versions (K4 has no degree) and
    # equal the CPU's bit for bit
    def gate_bfv(device):
        gen = prng.Gen(SEED + 42)
        p = R.RnsParam(n=S_GATE_N, t=S_GATE_T, L=S_L, M=S_M)
        sk, pk = R.new_key(gen, p, device)
        rlk, hk = R.rlk_key(gen, p, sk), R.hybrid_rlk1(gen, p, sk)
        gk = galois.galois_key(gen, p, sk, S_GALOIS)
        m = [prng.uniform_mod(gen, (S_GATE_B, p.n), p.t, device)
             for _ in range(2)]
        c = [R.encrypt(gen, p, pk, mi, batch=(S_GATE_B,)) for mi in m]
        e = [R.to_evals(p, ci) for ci in c]
        prods = [R.mul_e(p, k, *e) for k in (rlk, hk)]
        rot = galois.apply_to_ct(p, gk, c[0], S_GALOIS)
        recs = [R.decrypt(p, sk, R.from_evals(p, ce)) for ce in prods]
        recs.append(R.decrypt(p, sk, rot))
        return ([mi.cpu().numpy() for mi in m],
                [*prods[0], *prods[1], *rot], recs)

    def gate_ckks(device):
        gen = prng.Gen(SEED + 43)
        cp = C.Param(n=S_GATE_N, L=S_L, delta=S_CK_DELTA)
        sk, pk = C.new_key(gen, cp, device)
        hr = C.hybrid_rlk(gen, cp, sk)
        g = galois.rotation_element(cp.n, 1)
        hgk = H.galois_key_hybrid(gen, cp, sk, g)
        z = np.random.default_rng(SEED + 43).uniform(
            -10, 10, (4, S_GATE_B, cp.n // 2))
        # encoded on the host: the float FFT of the encoder is not bit for
        # bit the same on both devices, the residues it rounds to are moved
        m = [C.encode(cp, torch.from_numpy(z[i]), torch.from_numpy(z[i + 1]))
             .to(device) for i in (0, 2)]
        c1, c2 = (C.encrypt(gen, cp, pk, mi, batch=(S_GATE_B,)) for mi in m)
        out, p2 = C.mul_hybrid(cp, hr, c1, c2)
        rot = H.rotate_hybrid(cp, hgk, c1, g)
        dec = [C.decode(p2, C.decrypt_to_coeffs(p2, sk, out)),
               C.decode(cp, C.decrypt_to_coeffs(cp, sk, rot))]
        return z, g, [*out, *rot], dec

    cpu = torch.device("cpu")
    gate_kernels = ("ntt_multi", "tensor_eval4", "ks_contract", "ext_ntt",
                    "tensor_mul4", "tensor_mul", "ks_fused", "ks_fused_eval")
    for tag, fn in ((f"RNS-BFV at N={S_GATE_N} t={S_GATE_T} L={S_L} M={S_M} "
                     f"B={S_GATE_B}: mul_e (RLK), mul_e (HRLK), rotation "
                     f"g={S_GALOIS} (gadget key)", gate_bfv),
                    (f"RNS-CKKS at N={S_GATE_N} L={S_L} delta=2^"
                     f"{int(np.log2(S_CK_DELTA))} B={S_GATE_B}: mul_hybrid, "
                     f"rotate_hybrid by 1", gate_ckks)):
        on_card = drive(f"slice 12, the gate: {tag}", ("base_extend",),
                        lambda: fn(dev))
        counts = path_launches[f"slice 12, the gate: {tag}"]
        if any(counts[k] for k in gate_kernels):
            raise RuntimeError(f"slice 12 gate: {tag} launched "
                               f"{ {k: counts[k] for k in gate_kernels} } "
                               f"at n = {S_GATE_N}")
        on_cpu = fn(cpu)
        outs, outs_cpu = on_card[-2], on_cpu[-2]
        if not all(torch.equal(a.cpu(), b) for a, b in zip(outs, outs_cpu)):
            raise RuntimeError(f"slice 12 gate: {tag}: the card's "
                               "ciphertexts != the CPU's")
        say(f"verify: slice 12 gate, {tag}: no launch of "
            f"{list(gate_kernels)}; all {len(outs)} output tensors == the "
            f"CPU's (torch.equal)")
        if fn is gate_bfv:
            (a, b), recs = on_card[0], on_card[2]
            prod = np.stack([(np.array(r, dtype=np.int64) % S_GATE_T)
                             for r in negacyclic_exact(a, b)])
            for label, rec in (("mul_e (RLK)", recs[0]),
                               ("mul_e (HRLK)", recs[1])):
                verify(f"slice 12 gate {label} at N={S_GATE_N}", rec, prod,
                       "the exact negacyclic product mod t")
            phi = np.zeros_like(a)
            for i in range(S_GATE_N):
                e = i * S_GALOIS % (2 * S_GATE_N)
                sign = 1 if e < S_GATE_N else -1
                phi[:, e % S_GATE_N] += sign * a[:, i]
            verify(f"slice 12 gate rotation g={S_GALOIS} at N={S_GATE_N}",
                   recs[2], phi % S_GATE_T,
                   "m1(X^g) mod (X^n + 1, t) by numpy")
        else:
            z, g, _, dec = on_card
            zc = [z[0] + 1j * z[1], z[2] + 1j * z[3]]
            perm, conj = galois.ckks_slot_perm(S_GATE_N, g)
            zr = zc[0][:, perm]
            for label, (re, im), want, atol in (
                    ("mul_hybrid", dec[0], zc[0] * zc[1], S_CK_MUL_ATOL),
                    ("rotate_hybrid", dec[1], np.where(conj, zr.conj(), zr),
                     S_CK_ROT_ATOL)):
                err_z = float(np.abs(re.cpu().numpy() + 1j * im.cpu().numpy()
                                     - want).max())
                if not err_z <= atol:
                    raise RuntimeError(f"slice 12 gate CKKS {label}: slot "
                                       f"error {err_z} above {atol}")
                say(f"verify: slice 12 gate CKKS {label} at N={S_GATE_N}: "
                    f"every slot within {err_z:.3e} of numpy (atol {atol})")
    del on_card, on_cpu

    # every 2^7 kernel at these shapes (B = 128, TFHE B = 64, operands drawn
    # on the card), held against plain, then on the device alone beside its
    # bound and the launches it takes in each op of the phase
    gen = prng.Gen(SEED + 44)
    s_cases = kernel_check.small_degree_cases(
        s_param, BATCH, TFHE_BATCH, dev, gen,
        res=prng.device_residues(SEED + 45, dev))
    busy = torch.zeros(1 << 26, dtype=torch.int32, device=dev)
    for case in s_cases:
        check(case, case.kernel(), case.plain())
        p_ms = time_ms(case.plain, 1, warmup=0)
        a_ms = queued_ms(case.kernel, 10, busy)
        b = bound(case.bytes, case.ops)
        if a_ms < b.ms:
            raise RuntimeError(f"slice 12 {case.name} [{case.label}]: "
                               f"{a_ms:.4f} ms is under its bound {b}")
        per = {tag: ops[case.name] for tag, ops in s_per_op.items()
               if ops.get(case.name)}
        say(f"timing: slice 12 {case.name:16s} {case.label:44s} on the "
            f"device alone {a_ms:8.4f} ms, plain {p_ms:8.3f} ms, bound "
            f"{b.ms:.5f} ms by {b.term} (bytes {b.bytes_ms:.5f}, issue "
            f"{b.issue_ms:.5f}, ALU {b.alu_ms:.5f}, FMA {b.fma_ms:.5f}): "
            f"{b.ms / a_ms:.4f} of it; launches an op {per} [{card}]")
    say(f"parity: slice 12 at n = {s_n}: {len(s_cases)} variants of "
        f"{sorted({c.name for c in s_cases})} at the phase's shapes == plain "
        f"(torch.equal)")
    del s_cases, case, busy
    torch.cuda.empty_cache()
    phase_done(f"20 (slice 12: the reference tests' configurations at "
               f"n = {s_n} and n = {S_GATE_N}) [{card}]")

    # 21. slice 13: bootstrap_short past a block's shared memory -----------
    # (configurations a and b of P21_CONFIGS): keys on the card, all 64
    # messages, one launch of K10's device-memory layout a bootstrap, the
    # kernel's rotation == the step-by-step chain's, a chain of 3 beside one
    # step-by-step bootstrap, the peak memory with the keys resident; then
    # K10 on the device alone in both layouts beside its bounds
    dm_logns = {c[1].bit_length() - 1 for c in P21_CONFIGS}
    dm_inst = [f"{r['kernel']} {r['registers']} registers" for r in k10_entries
               if r["kernel"].startswith(("br_forward", "br_inverse"))
               and int(r["kernel"].split("<")[1].rstrip(">")) in dm_logns]
    if len(dm_inst) != 2 * len(dm_logns):
        raise RuntimeError(f"phase 21: the device-memory layout's instances "
                           f"at log n in {dm_logns}: {dm_inst}")
    say(f"ptxas: phase 21's instances (no stack frame or spills, phase 1): "
        + "; ".join(dm_inst))
    p21_cases = []
    for tag, n21, t21, beta21, l21 in P21_CONFIGS:
        tp21 = Param(ERR_SIGMA, RingParam(TORUS_Q, n21), TFHE_K, t21)
        kw21 = dict(beta=beta21, l=l21, beta_ks=TFHE_BETA_KS, l_ks=TFHE_L_KS)
        shape21 = (f"N={n21} K={TFHE_K} t={t21} B={TFHE_BATCH} "
                   f"beta=2^{beta21.bit_length() - 1} l={l21} "
                   f"beta_ks={TFHE_BETA_KS} l_ks={TFHE_L_KS} "
                   f"n_lwe={P21_N_LWE}")
        plan21 = kernel_check.brc._plan(TFHE_K + 1, l21, n21)
        if plan21.layout != "device":
            raise RuntimeError(f"phase 21 {tag}: plan {plan21}")
        gen = prng.Gen(SEED + 50 + len(tag) + n21)
        msgs21 = torch.arange(TFHE_BATCH, device=dev) % (t21 // 2)
        table21 = bootstrap.compute_lookup_table_standard(tp21, dev)
        st21 = {}

        def p21_path():
            s, _ = tglwe.new_key(gen, tp21, dev)
            st21["s_flat"] = tglwe.sk_to_tlwe(s)
            st21["sbtk"] = bootstrap.new_short_bootstrapping_key(
                gen, tp21, s, n_lwe=P21_N_LWE, **kw21)
            st21["sevals"] = bootstrap.precompute_short_btk_evals(
                tp21, st21["sbtk"])
            st21["c"] = tlwe.encrypt_uniform(
                gen, tp21.lwe(), st21["s_flat"], tlwe.encode(tp21, msgs21),
                batch=(TFHE_BATCH,))
            out = bootstrap.bootstrap_short(tp21, st21["sbtk"], table21,
                                            st21["c"],
                                            btk_evals=st21["sevals"], **kw21)
            return tlwe.decrypt(tp21.lwe(), st21["s_flat"], out)

        label21 = (f"slice 13 ({tag}): tglwe.new_key -> "
                   f"new_short_bootstrapping_key -> precompute_short_btk_evals"
                   f" -> encrypt_uniform -> bootstrap_short -> decrypt at "
                   f"{shape21}")
        phase21 = drive(label21, ("ntt", "blind_rotate", DM_ROW), p21_path)
        got21 = tlwe.decode(tp21, phase21)
        bad = int((got21 != msgs21).sum())
        if bad:
            raise RuntimeError(f"phase 21 {tag}: {bad} of {TFHE_BATCH} "
                               "bootstrapped messages differ")
        # the phase's distance from each message's encoding, against half a
        # message window (2^63 / t)
        dist = int((phase21 - tlwe.encode(tp21, msgs21)).abs().max())
        say(f"verify: slice 13 ({tag}) bootstrap_short ({P21_N_LWE} CMux "
            f"steps) at {shape21}: decode(decrypt) == m for all {TFHE_BATCH} "
            f"messages; the largest phase error 2^{np.log2(dist):.2f} = "
            f"{dist / 2.0 ** (63 - (t21.bit_length() - 1)):.3f} of half a "
            f"message window")
        sbtk21, sev21, c21, sflat21 = (st21[k] for k in ("sbtk", "sevals",
                                                         "c", "s_flat"))
        c_short = tlwe.key_switch(tp21.lwe(), TFHE_BETA_KS, TFHE_L_KS,
                                  tlwe.KSK(sbtk21.ksk_a, sbtk21.ksk_b), c21)
        _cuda.reset_launches()
        fused21 = bootstrap.blind_rotation(tp21, sbtk21, table21, c_short,
                                           beta21, l21, btk_evals=sev21)
        torch.cuda.synchronize()
        by_layout = dict(_cuda.BLIND_ROTATE.by_layout)
        stepwise21 = bootstrap.blind_rotation(tp21, sbtk21, table21, c_short,
                                              beta21, l21, btk_evals=sev21,
                                              fused=False)
        if not (torch.equal(fused21.a, stepwise21.a)
                and torch.equal(fused21.b, stepwise21.b)):
            raise RuntimeError(f"phase 21 {tag}: blind_rotate kernel != the "
                               "step-by-step chain")
        if by_layout != {"cluster": 0, "device": 1, "split": 0, "grid": 0,
                         _cuda.QUARTER: 0}:
            raise RuntimeError(f"phase 21 {tag}: K10 launches by layout "
                               f"{by_layout}")
        say(f"verify: slice 13 ({tag}) blind_rotate (one launch, layout "
            f"{by_layout}) == {P21_N_LWE} steps of cmux_evals (torch.equal) "
            f"on the {TFHE_BATCH} ciphertexts")
        del fused21, stepwise21

        def step21(c, fused=None):
            return bootstrap.bootstrap_short(tp21, sbtk21, table21, c,
                                             btk_evals=sev21, fused=fused,
                                             **kw21)

        per_op = per_op_launches(lambda: step21(c21))
        if per_op.get("blind_rotate") != 1 or \
                _cuda.BLIND_ROTATE.by_layout["device"] != 1:
            raise RuntimeError(f"phase 21 {tag}: launches {per_op}, not one "
                               "blind_rotate (device layout) a bootstrap")
        def chain21():
            c = c21
            for _ in range(TFHE_CHAIN):
                c = step21(c)
            return c

        last = chain21()                                   # and warm up
        if not torch.equal(tlwe.decode(tp21, tlwe.decrypt(
                tp21.lwe(), sflat21, last)), msgs21):
            raise RuntimeError(f"phase 21 {tag}: the chain of {TFHE_CHAIN} "
                               "bootstraps lost a message")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = [time_ms(chain21, 1, warmup=0) for _ in range(3)]
        peak = torch.cuda.max_memory_allocated()
        best = min(runs)
        step_ms = time_ms(lambda: step21(c21, fused=False), 1, warmup=0)
        say(f"timing: slice 13 ({tag}) chain of {TFHE_CHAIN} bootstrap_short "
            f"at {shape21}: runs {[round(r, 3) for r in runs]} ms, best "
            f"{best:.3f} ms = {best / TFHE_CHAIN:.3f} ms a batch = "
            f"{TFHE_BATCH * TFHE_CHAIN / (best / 1e3):.1f} bootstraps/s; the "
            f"step-by-step chain (fused=False), one bootstrap_short: "
            f"{step_ms:.3f} ms = {TFHE_BATCH / (step_ms / 1e3):.1f} "
            f"bootstraps/s ({step_ms / (best / TFHE_CHAIN):.1f}x); peak device "
            f"memory {peak / 2**30:.2f} GiB with the keys resident "
            f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB held); "
            f"launches a bootstrap {per_op} [{card}]")
        p21_cases.append((tag, kernel_check.blind_rotate_case(
            n21, TFHE_K, beta21, l21, P21_N_LWE, TFHE_BATCH, dev, gen)))
        del st21, sbtk21, sev21, c21, c_short, chain21, last, phase21
        torch.cuda.empty_cache()
    # K10 on the device alone beside its bound (every input read once, the
    # output written once) and, for the device-memory layout, the bound of
    # its own traffic a step (kernel_check.cmux_step_bytes); at N = 1024
    # (phase 9's shape, over phase 8's 700 steps) in both layouts
    gen = prng.Gen(SEED + 60)
    args1024 = kernel_check.blind_rotate_inputs(
        TFHE_N, TFHE_K, TFHE_BETA, TFHE_L, TFHE_N_LWE, TFHE_BATCH, dev, gen)
    for layout in ("cluster", "device"):
        p21_cases.append((f"N={TFHE_N}", kernel_check.blind_rotate_case(
            TFHE_N, TFHE_K, TFHE_BETA, TFHE_L, TFHE_N_LWE, TFHE_BATCH, dev,
            gen, layout=layout, args=args1024)))
    for tag, case in p21_cases:
        time_case(case)
        k_ms = case_ms[case.label]
        b = bound(case.bytes, case.ops)
        n21, l21 = case.args[-2], case.args[2].shape[2]
        own = (P21_N_LWE * sum(kernel_check.cmux_step_bytes(
            n21, TFHE_K + 1, l21, TFHE_BATCH).values())
            if case.layout == "device" else case.bytes)
        bo = bound(own, case.ops)
        on_path = ("1 a bootstrap (phase 21)" if not tag.startswith("N=")
                   else "1 a bootstrap (phases 7-9)"
                   if case.layout == "cluster" else "0 (forced here)")
        say(f"timing: slice 13 ({tag}) K10 {case.layout} layout, "
            f"{case.label}: device {k_ms:.3f} ms, bound {b.ms:.3f} ms by "
            f"{b.term}, {b.ms / k_ms:.3f} of it; its own traffic "
            f"{own / 1e9:.3f} GB, bound {bo.ms:.3f} ms by {bo.term}, "
            f"{bo.ms / k_ms:.3f} of it; {k_ms / P21_N_LWE * 1e3:.2f} us a "
            f"step; launches on the path: {on_path} [{card}]")
    del p21_cases, case, args1024
    torch.cuda.empty_cache()
    phase_done(f"21 (slice 13: bootstrap_short at N=4096 and N=2^15 through "
               f"K10's device-memory layout) [{card}]")

    # 22. slice 15: bootstrap_short past one block's polynomial ------------
    # (N = 2^16, beta = 2^6, l = 5): keys built on the card in slices of
    # steps (K9 across blocks; the build's peak held below
    # P22_KEY_PEAK_GIB), t chosen, every message decoded, the fused chain
    # (K10's split layout, slice 18) == the step-by-step chain (K1 across
    # blocks), no plain version on the card at 2^16, a chain of 3 timed,
    # K10 on the device alone in its split layout and in its grid layout
    # named (A/B in turns), K1, K9 and K10 in both layouts at the path's
    # shapes beside plain and their bounds; then bootstrap_short at 2^17
    # end to end (slice 22) through the quarter layout (slice 23), and the
    # grid layout's own path at 2^18
    grid_inst = [f"{r['kernel']} {r['registers']} registers" for r in ptxas
                 if r["kernel"].split("<")[0] in (
                     "ntt_top_kernel", "ntt_chunk_kernel")
                 or K10_KERNELS.get(r["kernel"].split("<")[0]) in (
                     "split", "quarter", "grid")]
    say(f"ptxas: phase 22's instances (no stack frame or spills, phase 1): "
        + "; ".join(grid_inst))
    plan22 = kernel_check.brc._plan(TFHE_K + 1, P22_L, P22_N)
    split_row = SPLIT_ROW.format("blind_rotate")
    if plan22.layout != _cuda.SPLIT or plan22.cluster != 4:
        raise RuntimeError(f"phase 22: plan {plan22}")
    clusters22 = kernel_check.brc.split_clusters(dev)
    say(f"plan: slice 18 K10 at {P22_N} C={TFHE_K + 1} l={P22_L}: layout "
        f"{plan22.layout}, {plan22.threads} threads and "
        f"{plan22.smem_bytes // 1024} KB a block; a step "
        f"{plan22.blocks[0] * TFHE_BATCH} forward blocks and "
        f"{plan22.blocks[1] * TFHE_BATCH} inverse blocks in clusters of "
        f"{plan22.cluster} at B={TFHE_BATCH}; the card runs {clusters22} "
        f"inverse clusters at once ({plan22.cluster * clusters22} of {sms} "
        f"SMs; cudaOccupancyMaxActiveClusters) [{card}]")

    def tp22(t):
        return Param(ERR_SIGMA, RingParam(TORUS_Q, P22_N), TFHE_K, t)

    kw22 = dict(beta=P22_BETA, l=P22_L, beta_ks=TFHE_BETA_KS,
                l_ks=TFHE_L_KS)
    shape22 = (f"N={P22_N} K={TFHE_K} B={TFHE_BATCH} "
               f"beta=2^{P22_BETA.bit_length() - 1} l={P22_L} "
               f"beta_ks={TFHE_BETA_KS} l_ks={TFHE_L_KS} n_lwe={P21_N_LWE}")
    # the plain versions of the path's kernels, wrapped: a call on card
    # tensors past one block counts (the path must run none)
    plain_on_card = {}

    def watched(store, name, fn, degree):
        def call(*args, **kwargs):
            if args[0].is_cuda and degree(args) > 1 << ntt_cuda.CHUNK_LOGN:
                store[name] = store.get(name, 0) + 1
            return fn(*args, **kwargs)
        return call

    def short_keys(st, gen, param_of, kw):
        """A short bootstrapping key of P21_N_LWE steps at param_of(t) and
        its eval planes built on the card, into ``st``: the build's seconds
        and peak device memory, the TGGSW encryption's alone among them."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st["held"] = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        s, _ = tglwe.new_key(gen, param_of(P22_TS[0]), dev)
        st["s_flat"] = tglwe.sk_to_tlwe(s)
        st["sbtk"] = bootstrap.new_short_bootstrapping_key(
            gen, param_of(P22_TS[0]), s, n_lwe=P21_N_LWE, **kw)
        torch.cuda.synchronize()
        st["gen_s"] = time.perf_counter() - t0
        st["gen_peak"] = torch.cuda.max_memory_allocated()
        st["sevals"] = bootstrap.precompute_short_btk_evals(
            param_of(P22_TS[0]), st["sbtk"])
        torch.cuda.synchronize()
        st["key_s"] = time.perf_counter() - t0
        st["key_peak"] = torch.cuda.max_memory_allocated()
        st["key_ntt"] = _cuda.launches()["ntt"]

    def largest_t(st, gen, param_of, kw, tag):
        """t: the largest power of two of P22_TS whose messages all decode
        with margin under st's keys (which do not depend on t), into
        ``st``; the bootstrap's output phases, or None if no t decodes."""
        for t in P22_TS:
            pt = param_of(t)
            msgs = torch.arange(TFHE_BATCH, device=dev) % (t // 2)
            c = tlwe.encrypt_uniform(gen, pt.lwe(), st["s_flat"],
                                     tlwe.encode(pt, msgs),
                                     batch=(TFHE_BATCH,))
            table = bootstrap.compute_lookup_table_standard(pt, dev)
            ph = tlwe.decrypt(pt.lwe(), st["s_flat"],
                              bootstrap.bootstrap_short(
                                  pt, st["sbtk"], table, c,
                                  btk_evals=st["sevals"], **kw))
            bad = int((tlwe.decode(pt, ph) != msgs).sum())
            dist = int((ph - tlwe.encode(pt, msgs)).abs().max())
            half = 2.0 ** (63 - (t.bit_length() - 1))
            say(f"verify: {tag} t={t}: {bad} of {TFHE_BATCH} messages "
                f"wrong; the largest phase error 2^"
                f"{np.log2(max(dist, 1)):.2f} = {dist / half:.3f} of half "
                f"a slot")
            if bad == 0 and dist <= half / 2:
                st.update(t=t, msgs=msgs, c=c, table=table, ph=ph,
                          err=dist / half)
                return ph
        return None

    plain_fns = [(ntt, "_stage_loop", lambda a: a[0].shape[-1]),
                 (ntt_cuda, "ntt_multi_plain", lambda a: a[0].shape[-1]),
                 (ntt_cuda, "ntt_plain", lambda a: a[0].shape[-1]),
                 (kernel_check.brc, "blind_rotate_plain", lambda a: a[6])]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in plain_fns]
    for mod, name, degree in plain_fns:
        setattr(mod, name, watched(plain_on_card, name, getattr(mod, name),
                                   degree))
    try:
        gen = prng.Gen(SEED + 80)
        st22 = {}

        def p22_path():
            short_keys(st22, gen, tp22, kw22)
            ph = largest_t(st22, gen, tp22, kw22, "slice 15")
            if ph is None:
                raise RuntimeError(f"phase 22: no t of {P22_TS} decodes "
                                   "with margin")
            return ph

        label22 = (f"slice 15: tglwe.new_key -> new_short_bootstrapping_key "
                   f"-> precompute_short_btk_evals -> encrypt_uniform -> "
                   f"bootstrap_short -> decrypt at {shape22}, t from "
                   f"{P22_TS}")
        drive(label22, ("ntt", "blind_rotate", split_row), p22_path)
        t22 = st22["t"]
        p22 = tp22(t22)
        sbtk22, sev22, c22, table22 = (st22[k] for k in ("sbtk", "sevals",
                                                         "c", "table"))
        key_bytes = sum(x.numel() * x.element_size() for x in sbtk22)
        eval_bytes = sum(x.numel() * x.element_size() for x in sev22)
        if st22["key_peak"] >= P22_KEY_PEAK_GIB * 2**30:
            raise RuntimeError(f"phase 22: the key build at 2^16 peaked at "
                               f"{st22['key_peak'] / 2**30:.2f} GiB")
        say(f"verify: slice 15 bootstrap_short ({P21_N_LWE} CMux steps) at "
            f"{shape22} t={t22}: decode(decrypt) == m for all {TFHE_BATCH} "
            f"messages; keys built on the card in {st22['key_s']:.1f} s "
            f"(the TGGSW encryption {st22['gen_s']:.1f} s, peak "
            f"{st22['gen_peak'] / 2**30:.2f} GiB; K9 launches "
            f"{st22['key_ntt']}): the short key {key_bytes / 2**30:.2f} GiB, "
            f"its eval-domain planes {eval_bytes / 2**30:.2f} GiB, peak "
            f"device memory {st22['key_peak'] / 2**30:.2f} GiB while "
            f"building them, {(st22['key_peak'] - st22['held']) / 2**30:.2f}"
            f" GiB over the {st22['held'] / 2**30:.2f} GiB held before (below "
            f"{P22_KEY_PEAK_GIB} GiB; 53.75 GiB with the encryption in one "
            f"batch; both in slices of {tggsw.EVALS_SLICE_WORDS} words) "
            f"[{card}]")
        c_short = tlwe.key_switch(p22.lwe(), TFHE_BETA_KS, TFHE_L_KS,
                                  tlwe.KSK(sbtk22.ksk_a, sbtk22.ksk_b), c22)
        rec22, seen22 = {}, {}
        with record_calls(rec22, seen22, ("blind_rotate", "ntt_multi")):
            _cuda.reset_launches()
            fused22 = bootstrap.blind_rotation(p22, sbtk22, table22, c_short,
                                               P22_BETA, P22_L,
                                               btk_evals=sev22)
            torch.cuda.synchronize()
            by_layout = dict(_cuda.BLIND_ROTATE.by_layout)
            _cuda.reset_launches()
            stepwise22 = bootstrap.blind_rotation(
                p22, sbtk22, table22, c_short, P22_BETA, P22_L,
                btk_evals=sev22, fused=False)
            torch.cuda.synchronize()
            step_launches = {k: v for k, v in _cuda.launches().items() if v}
        if not (torch.equal(fused22.a, stepwise22.a)
                and torch.equal(fused22.b, stepwise22.b)):
            raise RuntimeError("phase 22: blind_rotate kernel != the "
                               "step-by-step chain")
        if by_layout != {"cluster": 0, "device": 0, "split": 1, "grid": 0,
                         _cuda.QUARTER: 0} \
                or step_launches.get("ntt_multi", 0) < P21_N_LWE:
            raise RuntimeError(f"phase 22: K10 launches by layout "
                               f"{by_layout}; the step-by-step chain's "
                               f"{step_launches}")
        say(f"verify: slice 15 blind_rotate (one launch, layout {by_layout}) "
            f"== {P21_N_LWE} steps of cmux_evals (torch.equal; their "
            f"launches {step_launches}: K1 at n = {P22_N}) on the "
            f"{TFHE_BATCH} ciphertexts")
        del fused22, stepwise22

        def step22(c, fused=None):
            return bootstrap.bootstrap_short(p22, sbtk22, table22, c,
                                             btk_evals=sev22, fused=fused,
                                             **kw22)

        per_op = per_op_launches(lambda: step22(c22))
        if per_op.get("blind_rotate") != 1 or \
                _cuda.BLIND_ROTATE.by_layout[_cuda.SPLIT] != 1:
            raise RuntimeError(f"phase 22: launches {per_op}, not one "
                               "blind_rotate (split layout) a bootstrap")

        def chain22():
            c = c22
            for _ in range(TFHE_CHAIN):
                c = step22(c)
            return c

        last = chain22()                                   # and warm up
        if not torch.equal(tlwe.decode(p22, tlwe.decrypt(
                p22.lwe(), st22["s_flat"], last)), st22["msgs"]):
            raise RuntimeError(f"phase 22: the chain of {TFHE_CHAIN} "
                               "bootstraps lost a message")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = [time_ms(chain22, 1, warmup=0) for _ in range(3)]
        peak = torch.cuda.max_memory_allocated()
        best = min(runs)
        say(f"timing: slice 15 chain of {TFHE_CHAIN} bootstrap_short at "
            f"{shape22} t={t22}: runs {[round(r, 3) for r in runs]} ms, best "
            f"{best:.3f} ms = {best / TFHE_CHAIN:.3f} ms a batch = "
            f"{TFHE_BATCH * TFHE_CHAIN / (best / 1e3):.1f} bootstraps/s; "
            f"peak device memory {peak / 2**30:.2f} GiB with the keys "
            f"resident ({torch.cuda.memory_allocated() / 2**30:.2f} GiB "
            f"held); launches a bootstrap {per_op} [{card}]")
        if plain_on_card:
            raise RuntimeError(f"phase 22: plain versions ran on the card "
                               f"past one block: {plain_on_card}")
        say(f"verify: slice 15: no plain version ran on the card at "
            f"n = {P22_N} (the plain transforms and blind_rotate_plain "
            f"watched through the key build, the bootstraps, the "
            f"step-by-step chain and the timed chain)")
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    # K10 on the device alone at the path's own arguments (400 steps) beside
    # its bound and its own traffic, in its split layout (the plan's) and
    # its grid layout (named), best of 3 in turns; the record's rows at the
    # path's shapes:
    # K10 at P22_ROW_STEPS of its steps (both layouts), K1's two transforms
    # of the step-by-step chain, K9's of key generation on 16 keys
    br_args = next(args for (name, *_), (_, _, args, _) in rec22.items()
                   if name == "blind_rotate")
    busy = torch.zeros(1 << 28, dtype=torch.int32, device=dev)
    if not torch.equal(
            kernel_check.brc.blind_rotate_kernel(*br_args),
            kernel_check.brc.blind_rotate_kernel(*br_args, layout="grid")):
        raise RuntimeError("phase 22: K10's split and grid layouts differ "
                           "at the path's arguments")
    ab22 = {_cuda.SPLIT: [], "grid": []}
    for _ in range(3):
        for layout in ab22:
            ab22[layout].append(queued_ms(
                lambda: kernel_check.brc.blind_rotate_kernel(
                    *br_args, layout=layout), 1, busy))
    ops22 = P21_N_LWE * TFHE_BATCH * sum(kernel_check.cmux_step_ops(
        P22_N, TFHE_K + 1, P22_L).values())
    b = bound(4 * sum(e.numel() for e in br_args[2:6])
              + 2 * 8 * br_args[1].numel() + 4 * br_args[0].numel()
              + 4 * 4 * 2 * P22_N, ops22)
    for layout, runs in ab22.items():
        k_ms = min(runs)
        own = P21_N_LWE * sum(kernel_check.cmux_step_bytes(
            P22_N, TFHE_K + 1, P22_L, TFHE_BATCH, layout=layout).values())
        bo = bound(own, ops22)
        say(f"timing: slice 18 K10 {layout} layout"
            f"{' (the plan)' if layout == _cuda.SPLIT else ' (named)'}, "
            f"steps={P21_N_LWE} B={TFHE_BATCH} n={P22_N} beta={P22_BETA} "
            f"l={P22_L} (the path's arguments), on the device alone, runs "
            f"{[round(r, 3) for r in runs]} ms in turns with the other "
            f"layout: best {k_ms:.3f} ms, bound {b.ms:.3f} ms by {b.term}, "
            f"{b.ms / k_ms:.3f} of it; its own traffic {own / 1e9:.3f} GB, "
            f"bound {bo.ms:.3f} ms by {bo.term}, {bo.ms / k_ms:.3f} of it; "
            f"{k_ms / P21_N_LWE * 1e3:.2f} us a step [{card}]")
    say(f"timing: slice 18 K10 at the path's arguments: split "
        f"{min(ab22[_cuda.SPLIT]):.3f} ms against grid "
        f"{min(ab22['grid']):.3f} ms, "
        f"{min(ab22['grid']) / min(ab22[_cuda.SPLIT]):.3f}x; launches on the "
        f"path: 1 a bootstrap, split [{card}]")
    sl = P22_ROW_STEPS
    row_args = (br_args[0][:sl].contiguous(), br_args[1],
                *(e[:sl] for e in br_args[2:6]), *br_args[6:])
    gen = prng.Gen(SEED + 81)
    res22 = prng.device_residues(SEED + 82, dev)
    p22_cases = [kernel_check.blind_rotate_case(
        P22_N, TFHE_K, P22_BETA, P22_L, sl, TFHE_BATCH, dev, gen,
        layout=layout, args=row_args) for layout in (_cuda.SPLIT, "grid")]
    for (name, *_), (_, _, args, kwargs) in rec22.items():
        if name == "ntt_multi":
            x, qs = args[0], tuple(args[1])
            p22_cases.append(kernel_check.ntt_multi_case(
                f"cmux_evals {'inverse' if kwargs.get('inverse') else 'fwd'}"
                f" {list(x.shape)}", res22(qs, tuple(x.shape[1:])), qs,
                kwargs.get("inverse", False), kwargs.get("fin")))
    p22_cases += kernel_check.ntt_cases(P22_N, TFHE_K, P22_L, sl, dev, gen)
    for case in p22_cases:
        time_case(case)
        k_ms = case_ms[case.label]
        bo = bound(own_bytes(case)[1], case.ops)
        say(f"timing: slice 15 {case.name} {case.label} (the path's shapes"
            f"{f', {sl} of its {P21_N_LWE} steps' if case.name == 'blind_rotate' else ''}"
            f"): the bound of its own traffic {bo.ms:.4f} ms by {bo.term}, "
            f"{bo.ms / k_ms:.3f} of it [{card}]")
    # (time_case keeps the transforms' cases for phase 12's rates, which ran)
    done22 = {id(c) for c in p22_cases}
    timed_chains[:] = [c for c in timed_chains if id(c) not in done22]
    del (st22, sbtk22, sev22, c22, c_short, table22, last, rec22, br_args,
         row_args, p22_cases, case, busy)
    ntt_cuda.drop_tables()
    torch.cuda.empty_cache()
    # slice 22, the path past 2^16 end to end: bootstrap_short at N = 2^17
    # on a key of P21_N_LWE steps generated on the card in slices of steps,
    # at the first gadget of P22_GRID_GADGETS at which a t of P22_TS decodes
    # (the plain versions watched again); one K10 launch a bootstrap in its
    # quarter layout (slice 23), fused == step by step over the key's last
    # P22_GRID_STEPS steps (K1 at 2^17; key rows past 2^31 words of each
    # plane), a chain of 3 timed, K10 on the device alone at the path's
    # arguments in its quarter layout and in its grid layout named, in
    # turns, beside their bounds; then, the key freed, K10 over
    # P22_ROW_STEPS of its steps (both layouts), K1's transforms of the
    # step-by-step chain and K9's of key generation beside plain and their
    # bounds
    plan_g = kernel_check.brc._plan(TFHE_K + 1, P22_GRID_GADGETS[0][1],
                                    P22_GRID_N)
    if plan_g.layout != _cuda.QUARTER or plan_g.cluster != 8:
        raise RuntimeError(f"phase 22: the plan at 2^17 {plan_g}")
    clusters_g = kernel_check.brc.quarter_clusters(dev)
    say(f"plan: slice 23 K10 at {P22_GRID_N} C={TFHE_K + 1} "
        f"l={P22_GRID_GADGETS[0][1]}: layout {plan_g.layout}, "
        f"{plan_g.threads} threads and {plan_g.smem_bytes // 1024} KB a "
        f"block; a step {plan_g.blocks[0] * TFHE_BATCH} forward blocks and "
        f"{plan_g.blocks[1] * TFHE_BATCH} inverse blocks in clusters of "
        f"{plan_g.cluster} at B={TFHE_BATCH}; the card runs {clusters_g} "
        f"inverse clusters at once ({plan_g.cluster * clusters_g} of {sms} "
        f"SMs; cudaOccupancyMaxActiveClusters) [{card}]")

    def tpg(t):
        return Param(ERR_SIGMA, RingParam(TORUS_Q, P22_GRID_N), TFHE_K, t)

    for mod, name, degree in plain_fns:
        setattr(mod, name, watched(plain_on_card, name, getattr(mod, name),
                                   degree))
    tried = []
    try:
        for beta_g, l_g in P22_GRID_GADGETS:
            kwg = dict(beta=beta_g, l=l_g, beta_ks=TFHE_BETA_KS,
                       l_ks=TFHE_L_KS)
            shape_g = (f"N={P22_GRID_N} K={TFHE_K} B={TFHE_BATCH} "
                       f"beta=2^{beta_g.bit_length() - 1} l={l_g} "
                       f"beta_ks={TFHE_BETA_KS} l_ks={TFHE_L_KS} "
                       f"n_lwe={P21_N_LWE}")
            gen = prng.Gen(SEED + 83)
            stg = {}

            def p22_grid_path():
                short_keys(stg, gen, tpg, kwg)
                return largest_t(stg, gen, tpg, kwg, f"slice 22 ({shape_g})")

            ph = drive(f"slice 22: tglwe.new_key -> new_short_bootstrapping_"
                       f"key (in slices of steps) -> precompute_short_btk_"
                       f"evals -> encrypt_uniform -> bootstrap_short -> "
                       f"decrypt at {shape_g}, t from {P22_TS}",
                       ("ntt", "blind_rotate", QUARTER_ROW), p22_grid_path)
            tried.append((shape_g, stg.get("t")))
            if ph is not None:
                break
            del stg
            torch.cuda.empty_cache()
        else:
            raise RuntimeError(f"phase 22: no t of {P22_TS} decodes at 2^17 "
                               f"with any gadget of {P22_GRID_GADGETS}")
        tg = stg["t"]
        pg = tpg(tg)
        sbtk_g, sev_g, c_g, table_g = (stg[k] for k in ("sbtk", "sevals",
                                                        "c", "table"))
        key_bytes = sum(x.numel() * x.element_size() for x in sbtk_g)
        eval_bytes = sum(x.numel() * x.element_size() for x in sev_g)
        plane = sev_g.ev1.numel()
        say(f"verify: slice 22 bootstrap_short ({P21_N_LWE} CMux steps) at "
            f"{shape_g} t={tg}: decode(decrypt) == m for all {TFHE_BATCH} "
            f"messages, the largest phase error {stg['err']:.3f} of half a "
            f"slot (gadgets tried: {tried}); keys built on the card in "
            f"{stg['key_s']:.1f} s (the TGGSW encryption in slices of "
            f"{tggsw.EVALS_SLICE_WORDS} mask words {stg['gen_s']:.1f} s, "
            f"peak {stg['gen_peak'] / 2**30:.2f} GiB; K9 launches "
            f"{stg['key_ntt']}): the short key {key_bytes / 2**30:.2f} GiB, "
            f"its eval-domain planes {eval_bytes / 2**30:.2f} GiB (2^"
            f"{np.log2(plane):.2f} words a plane), peak device memory "
            f"{stg['key_peak'] / 2**30:.2f} GiB while building them, "
            f"{(stg['key_peak'] - stg['held']) / 2**30:.2f} GiB over the "
            f"{stg['held'] / 2**30:.2f} GiB held before [{card}]")
        # the path needs the eval planes and the key-switching key, not the
        # coefficient-domain TGGSWs (the step-by-step chain's products take
        # about 13 GB more)
        sbtk_g = stg["sbtk"] = sbtk_g._replace(
            btk_a=sbtk_g.btk_a.new_empty((0, *sbtk_g.btk_a.shape[1:])),
            btk_b=sbtk_g.btk_b.new_empty((0, *sbtk_g.btk_b.shape[1:])))
        torch.cuda.empty_cache()

        def stepg(c, fused=None):
            return bootstrap.bootstrap_short(pg, sbtk_g, table_g, c,
                                             btk_evals=sev_g, fused=fused,
                                             **kwg)

        recg, seeng = {}, {}
        with record_calls(recg, seeng, ("blind_rotate",)):
            per_op = per_op_launches(lambda: stepg(c_g))
        if per_op != {"blind_rotate": 1} or dict(
                _cuda.BLIND_ROTATE.by_layout) != {
                    "cluster": 0, "device": 0, "split": 0, "grid": 0,
                    _cuda.QUARTER: 1}:
            raise RuntimeError(f"phase 22: launches {per_op}, by layout "
                               f"{_cuda.BLIND_ROTATE.by_layout}, not one "
                               "blind_rotate (quarter layout) a bootstrap")
        br_args = next(args for (name, *_), (_, _, args, _) in recg.items()
                       if name == "blind_rotate")
        # fused == step by step over the key's last steps, on the path's own
        # key-switched ciphertexts
        tail = P22_GRID_STEPS
        c_short = tlwe.key_switch(pg.lwe(), TFHE_BETA_KS, TFHE_L_KS,
                                  tlwe.KSK(sbtk_g.ksk_a, sbtk_g.ksk_b), c_g)
        c_tail = tlwe.TLWE(a=c_short.a[..., -tail:], b=c_short.b)
        ev_tail = tggsw.TGGSWEvals(*(e[-tail:] for e in sev_g))
        recg = {}
        with record_calls(recg, seeng, ("blind_rotate", "ntt_multi")):
            _cuda.reset_launches()
            fused_g = bootstrap.blind_rotation(pg, sbtk_g, table_g, c_tail,
                                               beta_g, l_g, btk_evals=ev_tail)
            torch.cuda.synchronize()
            by_layout = dict(_cuda.BLIND_ROTATE.by_layout)
            _cuda.reset_launches()
            step_g = bootstrap.blind_rotation(
                pg, sbtk_g, table_g, c_tail, beta_g, l_g, btk_evals=ev_tail,
                fused=False)
            torch.cuda.synchronize()
            step_launches = {k: v for k, v in _cuda.launches().items() if v}
        if not (torch.equal(fused_g.a, step_g.a)
                and torch.equal(fused_g.b, step_g.b)):
            raise RuntimeError("phase 22: K10's quarter layout at 2^17 != "
                               "the step-by-step chain")
        if by_layout[_cuda.QUARTER] != 1 or \
                step_launches.get("ntt_multi", 0) < tail:
            raise RuntimeError(f"phase 22: K10 at 2^17 by layout "
                               f"{by_layout}; the step-by-step chain's "
                               f"{step_launches}")
        say(f"verify: slice 22 blind_rotate (one launch, layout {by_layout})"
            f" == {tail} steps of cmux_evals (torch.equal; their launches "
            f"{step_launches}: K1 at n = {P22_GRID_N}) over the key's last "
            f"{tail} steps (from word 2^"
            f"{np.log2(plane // P21_N_LWE * (P21_N_LWE - tail)):.2f} of each "
            f"plane) on the path's {TFHE_BATCH} key-switched ciphertexts "
            f"[{card}]")
        del fused_g, step_g, c_short, c_tail, ev_tail

        def chaing():
            c = c_g
            for _ in range(TFHE_CHAIN):
                c = stepg(c)
            return c

        last = chaing()                                    # and warm up
        if not torch.equal(tlwe.decode(pg, tlwe.decrypt(
                pg.lwe(), stg["s_flat"], last)), stg["msgs"]):
            raise RuntimeError(f"phase 22: the chain of {TFHE_CHAIN} "
                               "bootstraps at 2^17 lost a message")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = [time_ms(chaing, 1, warmup=0) for _ in range(3)]
        peak = torch.cuda.max_memory_allocated()
        best = min(runs)
        say(f"timing: slice 22 chain of {TFHE_CHAIN} bootstrap_short at "
            f"{shape_g} t={tg}: runs {[round(r, 3) for r in runs]} ms, best "
            f"{best:.3f} ms = {best / TFHE_CHAIN:.3f} ms a batch = "
            f"{TFHE_BATCH * TFHE_CHAIN / (best / 1e3):.1f} bootstraps/s; "
            f"peak device memory {peak / 2**30:.2f} GiB with the keys "
            f"resident ({torch.cuda.memory_allocated() / 2**30:.2f} GiB "
            f"held); launches a bootstrap {per_op} [{card}]")
        if plain_on_card:
            raise RuntimeError(f"phase 22: plain versions ran on the card "
                               f"past one block: {plain_on_card}")
        say(f"verify: slice 22: no plain version ran on the card at "
            f"n = {P22_GRID_N} (watched through the key build, the "
            f"bootstraps, the step-by-step chain and the timed chain)")
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    # K10 on the device alone at the path's own arguments (all its steps)
    # in its quarter layout (the plan's) and its grid layout (named), best
    # of 3 in turns, each beside its bound and its own traffic's
    busy = torch.zeros(1 << 28, dtype=torch.int32, device=dev)
    if not torch.equal(
            kernel_check.brc.blind_rotate_kernel(*br_args),
            kernel_check.brc.blind_rotate_kernel(*br_args, layout="grid")):
        raise RuntimeError("phase 22: K10's quarter and grid layouts differ "
                           "at the path's arguments at 2^17")
    abg = {_cuda.QUARTER: [], "grid": []}
    for _ in range(3):
        for layout in abg:
            abg[layout].append(queued_ms(
                lambda: kernel_check.brc.blind_rotate_kernel(
                    *br_args, layout=layout), 1, busy))
    ops_g = P21_N_LWE * TFHE_BATCH * sum(kernel_check.cmux_step_ops(
        P22_GRID_N, TFHE_K + 1, l_g).values())
    b = bound(kernel_check.blind_rotate_bytes(*br_args), ops_g)
    for layout, runs in abg.items():
        k_ms = min(runs)
        own = P21_N_LWE * sum(kernel_check.cmux_step_bytes(
            P22_GRID_N, TFHE_K + 1, l_g, TFHE_BATCH, layout=layout).values())
        bo = bound(own, ops_g)
        if k_ms < b.ms:
            raise RuntimeError(f"phase 22: K10 at 2^17 ({layout}) in "
                               f"{k_ms:.3f} ms is under its bound {b}")
        say(f"timing: slice 23 K10 {layout} layout"
            f"{' (the plan)' if layout == plan_g.layout else ' (named)'}, "
            f"steps={P21_N_LWE} B={TFHE_BATCH} n={P22_GRID_N} beta={beta_g} "
            f"l={l_g} (the path's arguments), on the device alone, runs "
            f"{[round(r, 3) for r in runs]} ms in turns with the other "
            f"layout: best {k_ms:.3f} ms, bound {b.ms:.3f} ms by {b.term}, "
            f"{b.ms / k_ms:.3f} of it; its own traffic {own / 1e9:.3f} GB, "
            f"bound {bo.ms:.3f} ms by {bo.term}, {bo.ms / k_ms:.3f} of it; "
            f"{k_ms / P21_N_LWE * 1e3:.2f} us a step [{card}]")
    say(f"timing: slice 23 K10 at the path's arguments at 2^17: quarter "
        f"{min(abg[_cuda.QUARTER]):.3f} ms against grid "
        f"{min(abg['grid']):.3f} ms, "
        f"{min(abg['grid']) / min(abg[_cuda.QUARTER]):.3f}x; launches on "
        f"the path: 1 a bootstrap, {plan_g.layout} [{card}]")
    sl = P22_ROW_STEPS
    row_args = (br_args[0][:sl].contiguous(), br_args[1],
                *(e[:sl].clone() for e in br_args[2:6]), *br_args[6:])
    # the rows' cases at the path's shapes, the key freed first (the plain
    # chain's products take about 13 GB at 2^17)
    k1_shapes = [(tuple(args[0].shape), tuple(args[1]),
                  kwargs.get("inverse", False), kwargs.get("fin"))
                 for (name, *_), (_, _, args, kwargs) in recg.items()
                 if name == "ntt_multi"]
    del (stg, sbtk_g, sev_g, c_g, table_g, last, recg, br_args, busy)
    torch.cuda.empty_cache()
    gen = prng.Gen(SEED + 84)
    resg = prng.device_residues(SEED + 85, dev)
    pg_cases = [kernel_check.blind_rotate_case(
        P22_GRID_N, TFHE_K, beta_g, l_g, sl, TFHE_BATCH, dev, gen,
        layout=layout, args=row_args) for layout in (_cuda.QUARTER, "grid")]
    for shp, qs, inverse, fin in k1_shapes:
        pg_cases.append(kernel_check.ntt_multi_case(
            f"cmux_evals {'inverse' if inverse else 'fwd'} {list(shp)}",
            resg(qs, shp[1:]), qs, inverse, fin))
    pg_cases += kernel_check.ntt_cases(P22_GRID_N, TFHE_K, l_g, sl, dev, gen)
    for case in pg_cases:
        time_case(case)
        k_ms = case_ms[case.label]
        bo = bound(own_bytes(case)[1], case.ops)
        say(f"timing: slice 22 {case.name} {case.label} (the path's shapes"
            f"{f', {sl} of its {P21_N_LWE} steps' if case.name == 'blind_rotate' else ''}"
            f"): the bound of its own traffic {bo.ms:.4f} ms by {bo.term}, "
            f"{bo.ms / k_ms:.3f} of it [{card}]")
    done22 = {id(c) for c in pg_cases}
    timed_chains[:] = [c for c in timed_chains if id(c) not in done22]
    del row_args, pg_cases, case
    ntt_cuda.drop_tables()
    torch.cuda.empty_cache()
    # slice 23, the grid layout's own path past 2^17: blind_rotation at
    # (N, beta, l) = P22_WIDEST on a short key of P22_GRID_STEPS steps built
    # on the card, on TFHE_BATCH random LWE ciphertexts; one K10 launch in
    # its grid layout, fused == step by step (K1 at 2^18), no plain version
    # on the card
    n_w, beta_w, l_w = P22_WIDEST
    if kernel_check.brc._plan(TFHE_K + 1, l_w, n_w).layout != "grid":
        raise RuntimeError("phase 22: the plan at 2^18 is not the grid")
    p_w = Param(ERR_SIGMA, RingParam(TORUS_Q, n_w), TFHE_K, 2)
    kw_w = dict(beta=beta_w, l=l_w, beta_ks=TFHE_BETA_KS, l_ks=TFHE_L_KS)
    shape_w = (f"N={n_w} K={TFHE_K} B={TFHE_BATCH} "
               f"beta=2^{beta_w.bit_length() - 1} l={l_w} "
               f"n_lwe={P22_GRID_STEPS}")
    gen = prng.Gen(SEED + 86)
    st_w = {}

    def p22_widest_path():
        s, _ = tglwe.new_key(gen, p_w, dev)
        st_w["sbtk"] = bootstrap.new_short_bootstrapping_key(
            gen, p_w, s, n_lwe=P22_GRID_STEPS, **kw_w)
        st_w["evals"] = bootstrap.precompute_short_btk_evals(p_w,
                                                             st_w["sbtk"])
        st_w["c"] = tlwe.TLWE(
            a=prng.uniform_u64(gen, (TFHE_BATCH, P22_GRID_STEPS), dev),
            b=prng.uniform_u64(gen, (TFHE_BATCH,), dev))
        st_w["table"] = bootstrap.compute_lookup_table_standard(p_w, dev)
        out = bootstrap.blind_rotation(p_w, st_w["sbtk"], st_w["table"],
                                       st_w["c"], beta_w, l_w,
                                       btk_evals=st_w["evals"])
        st_w["by_layout"] = dict(_cuda.BLIND_ROTATE.by_layout)
        return out

    for mod, name, degree in plain_fns:
        setattr(mod, name, watched(plain_on_card, name, getattr(mod, name),
                                   degree))
    try:
        fused_w = drive(f"slice 23: tglwe.new_key -> new_short_bootstrapping"
                        f"_key -> precompute_short_btk_evals -> "
                        f"blind_rotation at {shape_w}",
                        ("ntt", "blind_rotate", GRID_ROW), p22_widest_path)
        _cuda.reset_launches()
        step_w = bootstrap.blind_rotation(p_w, st_w["sbtk"], st_w["table"],
                                          st_w["c"], beta_w, l_w,
                                          btk_evals=st_w["evals"],
                                          fused=False)
        torch.cuda.synchronize()
        step_launches = {k: v for k, v in _cuda.launches().items() if v}
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    if not (torch.equal(fused_w.a, step_w.a)
            and torch.equal(fused_w.b, step_w.b)):
        raise RuntimeError("phase 22: K10's grid layout at 2^18 != the "
                           "step-by-step chain")
    if st_w["by_layout"] != {"cluster": 0, "device": 0, "split": 0,
                             "grid": 1, _cuda.QUARTER: 0} or \
            step_launches.get("ntt_multi", 0) < P22_GRID_STEPS:
        raise RuntimeError(f"phase 22: K10 at 2^18 by layout "
                           f"{st_w['by_layout']}; the step-by-step chain's "
                           f"{step_launches}")
    if plain_on_card:
        raise RuntimeError(f"phase 22: plain versions ran on the card past "
                           f"one block: {plain_on_card}")
    say(f"verify: slice 23 blind_rotate (one launch, layout "
        f"{st_w['by_layout']}) == {P22_GRID_STEPS} steps of cmux_evals "
        f"(torch.equal; their launches {step_launches}: K1 at n = {n_w}) at "
        f"{shape_w}; no plain version ran on the card [{card}]")
    del st_w, fused_w, step_w
    ntt_cuda.drop_tables()
    torch.cuda.empty_cache()
    phase_done(f"22 (slice 15: bootstrap_short at N=2^16 through K10's split "
               f"layout, t={t22}; slice 22: at N=2^17 through its quarter "
               f"layout, beta={beta_g} l={l_g} t={tg}; slice 23: "
               f"blind_rotation at N=2^18 through its grid layout) [{card}]")

    # 23. slice 16: K2, K3, K5 and K12 past one block's polynomial -------
    # through the op layer's entry points (ops/ntt.py's tensor_eval4,
    # ks_contract_multi and ext_ntt; alu_bench.ntt_smem_ceiling) at N =
    # 2^16, B = 128, after phase 22's keys are freed: every output == its
    # plain version on the card, launches under the chunked layouts, no
    # plain version on the card on the path, each kernel on the device alone
    # beside its bound and its own traffic's
    chunk_inst = [f"{r['kernel']} {r['registers']} registers" for r in ptxas
                  if r["kernel"].startswith(("tensor_eval4_chunk_kernel",
                                             "ks_contract_chunk_kernel",
                                             "first_top_kernel"))]
    say(f"ptxas: phase 23's instances (no stack frame or spills, phase 1; "
        f"with the chunk chains and top passes of phase 22): "
        + "; ".join(chunk_inst))
    primes23 = ntt_primes(W_L + W_M + W_K, 30, 2 * P23_N)
    q23, p23 = primes23[:W_L], primes23[W_L:W_L + W_M]
    qk23 = q23 + primes23[W_L + W_M:]
    shape23 = (f"N={P23_N} B={BATCH}, Q {W_L}, P {W_M} and K {W_K} primes "
               f"of 30 bits with 2^17-th roots")
    res23 = prng.device_residues(SEED + 90, dev)
    card_blocks = {}
    for logn in P23_LOGNS:
        per_sm = alu_bench.resident_blocks(dev, n=1 << logn)[0]
        card_blocks[logn] = max(1, per_sm * sms * (1 << ntt_cuda.CHUNK_LOGN)
                                >> logn)
    # the split ceiling: one polynomial a cluster of two, as many as the
    # card runs at once
    split_b23 = alu_bench.split_clusters(dev)
    in23, out23, ceil23 = {}, {}, {}
    plain23 = {}

    def p23_path():
        eq = [res23(q23, (BATCH, 2, P23_N)) for _ in range(2)]
        ep = [res23(p23, (BATCH, 2, P23_N)) for _ in range(2)]
        in23["tensor_eval4 Q"] = (*(e[..., i, :] for e in eq for i in (0, 1)),
                                  q23, (T,) * W_L)
        in23["tensor_eval4 P"] = (*(e[..., i, :] for e in ep for i in (0, 1)),
                                  p23, (T,) * W_M)
        in23["ks_contract R=1 QK"] = (
            res23(qk23, (BATCH, P23_N))[None],
            res23(qk23, (P23_N,))[None], res23(qk23, (P23_N,))[None], qk23)
        in23["ext_ntt Q->P"] = (res23(q23, (BATCH, 2, P23_N)), q23, p23)
        in23["ext_ntt 4->5"] = (res23(q23[:L], (BATCH, 2, P23_N)), q23[:L],
                                p23[:M])
        for label, args in in23.items():
            if label.startswith("tensor_eval4"):
                out23[label] = ntt.tensor_eval4(*args[:5], scale=args[5])
            elif label.startswith("ks_contract"):
                out23[label] = ntt.ks_contract_multi(*args)
            else:
                out23[label] = ntt.ext_ntt(*args)
        for logn in P23_LOGNS:
            ceil23[logn] = alu_bench.ntt_smem_ceiling(
                dev, n=1 << logn, reps=CEILING_REPS,
                B=(split_b23 if logn == alu_bench.SPLIT_LOGN
                   else card_blocks[logn]))
        return out23

    plain_fns = [(ntt_cuda, fn, lambda a: a[0].shape[-1]) for fn in (
        "tensor_eval4_plain", "ks_contract_plain", "ext_ntt_plain",
        "ntt_multi_plain")] + [(alu_bench, "ntt_smem_ceiling_plain",
                                lambda a: a[0].shape[-1])]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in plain_fns]
    for mod, name, degree in plain_fns:
        setattr(mod, name, watched(plain23, name, getattr(mod, name),
                                   degree))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        drive(f"slice 16: ntt.tensor_eval4 over Q and P, "
              f"ntt.ks_contract_multi over Q u K, ntt.ext_ntt Q -> P and "
              f"{L} -> {M}, alu_bench.ntt_smem_ceiling at n = 2^"
              f"{P23_LOGNS} at {shape23}",
              tuple(CHUNKED_ROW.format(name) for name in P23_LAYOUTS)
              + (SPLIT_ROW.format("ntt_smem_ceiling"),), p23_path)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    peak23 = torch.cuda.max_memory_allocated()
    by_layout23 = {k.name: {lay: v for lay, v in k.by_layout.items() if v}
                   for k in chunked if k.name in P23_LAYOUTS}
    if plain23:
        raise RuntimeError(f"phase 23: plain versions ran on the card past "
                           f"one block: {plain23}")
    # K12: a warm-up and 3 timed calls at each n, those at 2^15 in a block
    if by_layout23 != P23_LAYOUTS:
        raise RuntimeError(f"phase 23: launches by layout {by_layout23}, "
                           f"not {P23_LAYOUTS}")
    say(f"verify: slice 16 at {shape23}: no plain version ran on the card "
        f"past one block on the path; launches by layout {by_layout23}; "
        f"peak device memory {peak23 / 2**30:.2f} GiB [{card}]")
    cases23 = {
        label: (kernel_check.tensor_eval4_case(
            f"{label} {[len(args[4]), BATCH, P23_N]} strided views",
            args[:4], args[4], args[5]) if label.startswith("tensor_eval4")
            else kernel_check.ks_contract_case(
                f"{label} {list(args[0].shape)}", *args)
            if label.startswith("ks_contract")
            else kernel_check.ext_ntt_case(
                f"{label} {list(args[0].shape)} ("
                f"{'direct' if len(args[1]) in ntt_cuda.EXT_NTT_DIRECT else 'staged'})",
                *args))._replace(plain_reps=1, plain_warmup=0)
        for label, args in in23.items()}
    for label, case in cases23.items():
        hold(row(case), f"slice 16 path, {case.label}", out23[label],
             case.plain())
    # and K12 at 2^16 on the chunked schedule, named, beside the split
    ceil23["16 chunked"] = alu_bench.ntt_smem_ceiling(
        dev, n=P23_N, B=card_blocks[16], reps=CEILING_REPS,
        layout=_cuda.CHUNKED)
    for logn, ceil in ceil23.items():
        (xin,), rows = ceil["operands"], [0, 1, ceil["B"] - 2, ceil["B"] - 1]
        hold({_cuda.CHUNKED: CHUNKED_ROW, _cuda.SPLIT: SPLIT_ROW}.get(
                 ceil["layout"], "{}").format("ntt_smem_ceiling"),
             f"slice 16: the timed launch, reps={ceil['reps']} "
             f"B={ceil['B']} n={ceil['n']} {ceil['layout']}",
             ceil["out"][rows],
             alu_bench.ntt_smem_ceiling_plain(xin[rows], ceil["q"],
                                              ceil["reps"]))
    del out23
    say(f"verify: slice 16: every output of the path == its plain version "
        f"on the card (torch.equal; K12's timed launches on 4 of their "
        f"polynomials) [{card}]")
    for layout, B12 in ((_cuda.SPLIT, split_b23),
                        (_cuda.CHUNKED, card_blocks[16])):
        x12 = res23(q23[:1], (B12, P23_N))[0]
        cases23[f"ntt_smem_ceiling {layout}"] = kernel_check.ceiling_case(
            f"reps={P23_ROW_REPS} [{B12}, {P23_N}] {layout} (the whole "
            f"card)", x12, q23[0], P23_ROW_REPS, layout)
    busy = torch.zeros(1 << 28, dtype=torch.int32, device=dev)
    for case in cases23.values():
        time_case(case)
        k_ms = min(queued_ms(case.kernel, 1, busy) for _ in range(3))
        b, bo = bound(case.bytes, case.ops), bound(
            kernel_check.own_bytes(case), case.ops)
        if k_ms < b.ms:
            raise RuntimeError(f"{case.name} [{case.label}]: {k_ms:.4f} ms "
                               f"is under its bound {b}")
        say(f"timing: slice 16 {case.name} {case.label}: on the device alone "
            f"{k_ms:.4f} ms (best of 3), bound {b.ms:.4f} ms by {b.term}, "
            f"{b.ms / k_ms:.3f} of it; its own traffic's bound {bo.ms:.4f} "
            f"ms by {bo.term}, {bo.ms / k_ms:.3f} of it; launches on the "
            f"path by layout "
            f"{by_layout23[case.name]} [{card}]")
    bf_bound = 1e3 / bound(0, kernel_check.BUTTERFLY_OPS).ms
    say("ceiling: slice 16 and 18, the whole card (K12, reps="
        f"{CEILING_REPS}): " + "; ".join(
            f"n = {c['n']} {c['layout']} B={c['B']}: "
            f"{c['butterflies_per_sec']:.4e} butterflies/s = "
            f"{c['butterflies_per_sec'] / bf_bound:.3f} of the bound's "
            f"{bf_bound:.4e}" for c in ceil23.values())
        + f"; at 2^16 split {ceil23[16]['butterflies_per_sec'] / ceil23['16 chunked']['butterflies_per_sec']:.3f}x"
        f" the chunked schedule's rate [{card}]")
    timed_chains[:] = [c for c in timed_chains
                       if all(c is not d for d in cases23.values())]
    del in23, cases23, ceil23, busy, x12, case
    ntt_cuda.drop_tables()
    torch.cuda.empty_cache()
    phase_done(f"23 (slice 16: K2, K3, K5 and K12 past one block at "
               f"{shape23}) [{card}]")

    # 24. slice 17: K6, tensor_mul, K7 and K8 past one block's polynomial -
    # through the op layer's entry points (ops/ntt.py's tensor_mul4,
    # tensor_mul_multi, ks_fused_multi and ks_fused_eval) at N = 2^16,
    # B = 128, after phase 23's tensors are freed: every output == its plain
    # version on the card (the plain value over slices of the batch), the
    # launches by layout held, no plain version on the card on the path,
    # each kernel on the device alone beside its bound and its own
    # traffic's
    inst24 = [f"{r['kernel']} {r['registers']} registers" for r in ptxas
              if r["kernel"].startswith(("first_top_kernel",
                                         "ks_mac_chunk_kernel"))]
    say(f"ptxas: phase 24's instances (no stack frame or spills, phase 1; "
        f"K6's products and inverses are phase 23's tensor_eval4_chunk_kernel, "
        f"the chunk chains and top passes phase 22's): " + "; ".join(inst24))
    g24 = ntt_primes(G_L, 30, 2 * P24_N)         # phase 19's 29 = Q u P
    q24, p24 = g24[:W_L], g24[W_L:W_L + W_M]
    shape24 = (f"N={P24_N} B={BATCH}, Q {W_L} and P {W_M} primes, the "
               f"gadget's R = L = {G_L} rows over {G_L} primes, of 30 bits "
               f"with 2^17-th roots")
    res24 = prng.device_residues(SEED + 95, dev)
    in24, out24, plain24 = {}, {}, {}

    def p24_path():
        ct = [res24(q24, (BATCH, P24_N)) for _ in range(4)]
        in24["tensor_mul4 Q"] = (ct, q24, (T,) * W_L, None)
        in24["tensor_mul4 Q->P"] = (ct, p24, (T,) * W_M, q24)
        in24["tensor_mul4 4->5"] = ([c[:L] for c in ct], p24[:M], (T,) * M,
                                    q24[:L])
        in24["tensor_mul stacked Q"] = (res24(q24, (BATCH, 4, P24_N)), q24,
                                        (T,) * W_L)
        out3 = res24(g24, (BATCH, 3, P24_N))     # _scale_to_q's output
        kb, ka = (res24(g24, (G_L, P24_N)).transpose(0, 1).contiguous()
                  for _ in range(2))
        in24[f"ks_fused R={G_L}"] = (out3[..., 2, :], kb, ka, g24, g24)
        in24[f"ks_fused_eval R={G_L}"] = (out3[..., 2, :], kb, ka, g24, g24,
                                          (out3[..., 0, :], out3[..., 1, :]))
        for label, args in in24.items():
            if label.startswith("tensor_mul4"):
                out24[label] = ntt.tensor_mul4(*args[0], args[1],
                                               scale=args[2], src=args[3])
            elif label.startswith("tensor_mul"):
                out24[label] = ntt.tensor_mul_multi(args[0], args[1],
                                                    scale=args[2])
            elif label.startswith("ks_fused_eval"):
                out24[label] = ntt.ks_fused_eval(*args)
            else:
                out24[label] = ntt.ks_fused_multi(*args)
        return out24

    plain_fns = [(ntt_cuda, fn, lambda a: a[0].shape[-1]) for fn in (
        "tensor_mul4_plain", "tensor_mul_plain", "ks_fused_plain",
        "ks_fused_eval_plain", "ntt_multi_plain")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in plain_fns]
    for mod, name, degree in plain_fns:
        setattr(mod, name, watched(plain24, name, getattr(mod, name),
                                   degree))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        drive(f"slice 17: ntt.tensor_mul4 over Q, over P from Q and {L} -> "
              f"{M}, ntt.tensor_mul_multi over Q, ntt.ks_fused_multi and "
              f"ntt.ks_fused_eval at R = {G_L} at {shape24}",
              tuple(CHUNKED_ROW.format(name) for name in P24_LAYOUTS),
              p24_path)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    peak24 = torch.cuda.max_memory_allocated()
    kernels24 = [k for k in chunked if k.name in P24_LAYOUTS]
    by_layout24 = {k.name: {lay: v for lay, v in k.by_layout.items() if v}
                   for k in kernels24}
    if plain24:
        raise RuntimeError(f"phase 24: plain versions ran on the card past "
                           f"one block: {plain24}")
    if by_layout24 != P24_LAYOUTS:
        raise RuntimeError(f"phase 24: launches by layout {by_layout24}, "
                           f"not {P24_LAYOUTS}")
    say(f"verify: slice 17 at {shape24}: no plain version ran on the card "
        f"past one block on the path; launches by layout {by_layout24}; "
        f"peak device memory {peak24 / 2**30:.2f} GiB [{card}]")

    def case24(label, args):
        if label.startswith("tensor_mul4"):
            ops, dst, sc, src = args
            form = ("no source basis" if src is None else
                    f"{len(src)} -> {len(dst)} primes, "
                    f"{'direct' if len(src) in ntt_cuda.MUL4_DIRECT else 'staged'}")
            return kernel_check.tensor_mul4_case(
                f"{label} [{len(dst)}, {BATCH}, {P24_N}] ({form})", ops, dst,
                sc, src)
        if label.startswith("tensor_mul"):
            return kernel_check.tensor_mul_case(
                f"{label} {list(args[0].shape)}", *args)
        make = (kernel_check.ks_fused_eval_case
                if label.startswith("ks_fused_eval")
                else kernel_check.ks_fused_case)
        return make(f"{label} {[G_L, BATCH, P24_N]} over {G_L} primes, "
                    f"strided c_limbs", *args)

    cases24 = {label: case24(label, args)._replace(plain_reps=1,
                                                   plain_warmup=0)
               for label, args in in24.items()}
    for label, case in cases24.items():
        hold(row(case), f"slice 17 path, {case.label}", out24[label],
             case.plain())
    del out24
    say(f"verify: slice 17: every output of the path == its plain version "
        f"on the card (torch.equal; the plain values over slices of the "
        f"batch, kernel_check.PLAIN_WORDS) [{card}]")
    busy = torch.zeros(1 << 28, dtype=torch.int32, device=dev)
    for case in cases24.values():
        time_case(case)
        k_ms = min(queued_ms(case.kernel, 1, busy) for _ in range(3))
        b, bo = bound(case.bytes, case.ops), bound(
            kernel_check.own_bytes(case), case.ops)
        if k_ms < b.ms:
            raise RuntimeError(f"{case.name} [{case.label}]: {k_ms:.4f} ms "
                               f"is under its bound {b}")
        say(f"timing: slice 17 {case.name} {case.label}: on the device alone "
            f"{k_ms:.4f} ms (best of 3), bound {b.ms:.4f} ms by {b.term}, "
            f"{b.ms / k_ms:.3f} of it; its own traffic's bound {bo.ms:.4f} "
            f"ms by {bo.term}, {bo.ms / k_ms:.3f} of it; launches on the "
            f"path by layout {by_layout24[case.name]} [{card}]")
    timed_chains[:] = [c for c in timed_chains
                       if all(c is not d for d in cases24.values())]
    del in24, cases24, busy, case
    ntt_cuda.drop_tables()
    torch.cuda.empty_cache()
    phase_done(f"24 (slice 17: K6, tensor_mul, K7 and K8 past one block at "
               f"{shape24}) [{card}]")

    # (phase 17's ranks report K10's launches, not its layouts: they run it
    # at N = 1024, on clusters)
    launches = {r: sum(c.get(r, 0) for c in path_launches.values())
                for r in record_rows}
    # K10's row counts its cluster layout, K2's, K3's, K5's and K12's their
    # launches up to one block; the counter's are all layouts'
    launches["blind_rotate"] -= (launches[DM_ROW] + launches[GRID_ROW]
                                 + launches[QUARTER_ROW])
    for k in chunked:
        launches[k.name] -= launches[CHUNKED_ROW.format(k.name)]
    for k in split:
        launches[k.name] -= launches[SPLIT_ROW.format(k.name)]
    never = [k for k, v in launches.items() if v == 0]
    if never:
        raise RuntimeError(f"kernels launched on no path: {never}")

    say(f"parity: kernel == plain (torch.equal) for all "
        f"{sum(checked.values())} variants, those at the full batch of each "
        f"path (B={BATCH} at n={N}; B={LIN_BATCH} at n={LIN_N}; "
        f"B={TFHE_BATCH} at n={TFHE_N}; B={CK_BATCH} at n={CK_N}) included: "
        f"{checked}")

    kernel_of = {k.name: k for k in _cuda.KERNELS}
    kernel_of[DM_ROW] = kernel_of[GRID_ROW] = _cuda.BLIND_ROTATE
    kernel_of[QUARTER_ROW] = _cuda.BLIND_ROTATE
    source = {k.name: k.source for k in _cuda.KERNELS}
    source[DM_ROW] = _cuda.BLIND_ROTATE.layouts["device"]
    source[GRID_ROW] = _cuda.BLIND_ROTATE.layouts["grid"]
    source[QUARTER_ROW] = _cuda.BLIND_ROTATE.layouts[_cuda.QUARTER]
    for k in chunked:
        kernel_of[CHUNKED_ROW.format(k.name)] = k
        source[CHUNKED_ROW.format(k.name)] = next(
            src for lay, src in k.layouts.items()
            if lay.startswith(_cuda.CHUNKED))
    for k in split:
        kernel_of[SPLIT_ROW.format(k.name)] = k
        source[SPLIT_ROW.format(k.name)] = k.layouts[_cuda.SPLIT]
    record = {"kernels": [
        {"name": r, "route": "cuda", "source": source[r],
         "replaces": kernel_of[r].replaces, "launches": launches[r],
         "max_abs_err": err[r], "ms": ms[r],
         "plain_ms": plain_ms[r], "bound_ms": bound_ms[r],
         "bound_by": ("operations" if op_ms[r] >= byte_ms[r] else "bytes"),
         # no PyTorch call computes a modular NTT, an RNS base conversion,
         # a gadget contraction or a chain of CMux steps; the measuring
         # loops iterate one operation in registers or shared memory, which
         # no tensor call does
         "library_ms": None} for r in record_rows]}
    say(json.dumps(record))
    say(f"wall: {time.perf_counter() - wall0:.1f} s in all")
    say(name_limit)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
