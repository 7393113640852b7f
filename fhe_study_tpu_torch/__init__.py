"""PyTorch + CUDA port of fhe_study_tpu for one NVIDIA Hopper GPU (H100).

The JAX package ``fhe_study_tpu`` stays the reference; this package mirrors
its layout (``ops/``, ``models/``, ``utils/``) and imports neither jax nor
fhe_study_tpu.  It covers RNS-BFV (``models/bfv_rns.py``) and TFHE
programmable bootstrapping (``arith/``, ``models/gfhe``, ``models/tfhe``).

Residues are ``torch.int32`` tensors (every prime is below 2^31, so the bits
equal the reference's u32); the hand-written CUDA kernels under ``csrc/``
read them as ``uint32_t``.  Torus elements are ``torch.int64`` holding the
bits of the reference's u64.  A function given CPU tensors runs its plain
PyTorch version; given CUDA tensors it launches its kernel — built by nvcc
on first use — or raises.
"""
