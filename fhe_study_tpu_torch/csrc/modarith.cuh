// Device code shared by the RNS kernels: exact arithmetic mod q < 2^31 on
// 32-bit lanes (the butterflies of every NTT chain, radix_chain.cuh) and the
// per-coefficient HPS base conversion.
//
// Every residue is canonical in [0, q) with q < 2^31 (the package stores
// them as int32; the kernels read the same bits as uint32_t).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fhe {

// Largest source basis of a base conversion: each term of the 2^59
// fixed-point sum of alpha is below 2^59, so the sum (with 2^58 when
// centered) stays below 2^64, the reference's bound (the plain version adds
// in int64, which wraps as u64 does, and reads bits 59 .. 63).
constexpr int kMaxSrc = 31;

__device__ __forceinline__ uint32_t addmod(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t submod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + (q - b);
}

// a * w mod q (Harvey/Shoup) with wsh = floor(w * 2^32 / q): any a < 2^32,
// w < q < 2^31.  The raw difference lies in [0, 2q); one correction.
__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w,
                                              uint32_t wsh, uint32_t q) {
  const uint32_t hi = __umulhi(a, wsh);
  const uint32_t r = a * w - hi * q;
  return r >= q ? r - q : r;
}

// Montgomery product a * b * 2^-32 mod q for a, b < q < 2^31, with
// nq = -q^-1 mod 2^32.  p + m*q < 2^62 + 2^63 fits in 64 bits and the
// quotient lies in [0, 2q).
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t q, uint32_t nq) {
  const uint64_t p = static_cast<uint64_t>(a) * b;
  const uint32_t m = static_cast<uint32_t>(p) * nq;
  const uint32_t t =
      static_cast<uint32_t>((p + static_cast<uint64_t>(m) * q) >> 32);
  return t >= q ? t - q : t;
}

// Per-prime constants, one row of four words: q, -q^-1 mod 2^32, and the
// final multiplier with its Shoup companion.
struct PrimeRow {
  uint32_t q, nq, fin, fin_sh;
};

__device__ __forceinline__ PrimeRow prime_row(const uint32_t* cons, int p) {
  return PrimeRow{cons[4 * p], cons[4 * p + 1], cons[4 * p + 2],
                  cons[4 * p + 3]};
}

// Constants of one HPS conversion src -> dst, packed by the host
// (ops/ext_cuda.py::_ext_table): per source prime i five words (s_i, the
// Shoup pair of Qhat_i^-1 mod s_i, floor(2^59/s_i) as lo/hi), per
// destination prime j five words (d_j, the Shoup pair of S mod d_j, the
// Shoup pair of the sub_mul epilogue constant), then the Shoup pairs of
// (S/s_i) mod d_j.
struct ExtTable {
  const uint32_t* t;
  int ls, ld;
  __device__ __forceinline__ uint32_t src(int i, int f) const {
    return t[5 * i + f];
  }
  __device__ __forceinline__ uint32_t dst(int j, int f) const {
    return t[5 * ls + 5 * j + f];
  }
  __device__ __forceinline__ uint32_t tab(int i, int j, int f) const {
    return t[5 * (ls + ld) + 2 * (i * ld + j) + f];
  }
};

// The unsigned conversion of one coefficient (source row i at x[i * stride])
// to destination prime j: y_i = x_i * Qhat_i^-1 mod s_i, alpha = (sum_i y_i
// * floor(2^59/s_i)) >> 59 (the reference's 2^59 fixed point, bit for bit),
// then sum_i y_i * (S/s_i) - alpha * S mod d_j.  With LS > 0 the y_i stay in
// LS registers (the source count at compile time: no run-time-indexed array,
// so no local memory); the generic form (LS = 0, any e.ls up to kMaxSrc)
// keeps no per-thread array: one loop takes each y_i into both sums, and
// stays a loop (short code where it is inlined many times).  K5 and K6 run
// it on their way into the forward chain.
template <int LS>
__device__ __forceinline__ uint32_t ext_coeff(const uint32_t* x, size_t stride,
                                              const ExtTable& e, int j) {
  const uint32_t d = e.dst(j, 0);
  uint64_t acc = 0;
  uint32_t sum = 0;
  if constexpr (LS > 0) {
    uint32_t ys[LS];
#pragma unroll
    for (int i = 0; i < LS; ++i) {
      ys[i] = shoup_mul(x[i * stride], e.src(i, 1), e.src(i, 2), e.src(i, 0));
      acc += static_cast<uint64_t>(ys[i]) *
             (static_cast<uint64_t>(e.src(i, 3)) |
              (static_cast<uint64_t>(e.src(i, 4)) << 32));
    }
#pragma unroll
    for (int i = 0; i < LS; ++i) {
      sum = addmod(sum, shoup_mul(ys[i], e.tab(i, j, 0), e.tab(i, j, 1), d), d);
    }
  } else {
#pragma unroll 1
    for (int i = 0; i < e.ls; ++i) {
      const uint32_t y =
          shoup_mul(x[i * stride], e.src(i, 1), e.src(i, 2), e.src(i, 0));
      acc += static_cast<uint64_t>(y) *
             (static_cast<uint64_t>(e.src(i, 3)) |
              (static_cast<uint64_t>(e.src(i, 4)) << 32));
      sum = addmod(sum, shoup_mul(y, e.tab(i, j, 0), e.tab(i, j, 1), d), d);
    }
  }
  const uint32_t alpha = static_cast<uint32_t>(acc >> 59);
  return submod(sum, shoup_mul(alpha, e.dst(j, 1), e.dst(j, 2), d), d);
}

// p is not on a 16-byte boundary (no uint4 words there).
inline bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace fhe
