"""PyTorch + CUDA port of fhe_study_tpu for one NVIDIA Hopper GPU (H100).

The JAX package ``fhe_study_tpu`` stays the reference; this package mirrors
its layout (``ops/``, ``arith/``, ``models/``, ``utils/``, ``runtime/``)
and imports neither jax nor fhe_study_tpu.  It covers RNS-BFV and RNS-CKKS
with rotations and bootstrapping, TFHE programmable bootstrapping, the Z_q
layer with single-modulus BFV and CKKS and GLWE over Z_q, and the graft
entry (``entry.py``).

Residues are ``torch.int32`` tensors (every prime is below 2^31, so the bits
equal the reference's u32); the hand-written CUDA kernels under ``csrc/``
read them as ``uint32_t``.  Torus elements and the Z_q layer's elements are
``torch.int64`` holding the bits of the reference's u64.  A function given
CPU tensors runs its plain PyTorch version; given CUDA tensors it launches
its kernel — built by nvcc on first use — or raises.
"""
