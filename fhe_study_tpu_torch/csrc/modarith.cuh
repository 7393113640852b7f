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
// then sum_i y_i * (S/s_i) - alpha * S mod d_j.  The y_i stay in LS
// registers (the source count at compile time: no run-time-indexed array,
// so no local memory).  K5 and K6 run it on their way into the forward
// chain from the source counts they instantiate; from any other count they
// read the y_i and alpha that ext_lift formed once per polynomial
// (ext_from_lift).
template <int LS>
__device__ __forceinline__ uint32_t ext_coeff(const uint32_t* x, size_t stride,
                                              const ExtTable& e, int j) {
  const uint32_t d = e.dst(j, 0);
  uint64_t acc = 0;
  uint32_t sum = 0;
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
  const uint32_t alpha = static_cast<uint32_t>(acc >> 59);
  return submod(sum, shoup_mul(alpha, e.dst(j, 1), e.dst(j, 2), d), d);
}

// The operands of one lift (ext_lift): up to four [Ls, B, n] views, row i
// of polynomial b of operand o at x[o] + i * sl[o] + b * sb[o] (K6's four
// operands may be strided views; K5's one is contiguous).
struct LiftIn {
  const uint32_t* x[4];
  long long sl[4], sb[4];
};

// One contiguous operand [Ls, B, n] (K5's, and the lift alone).
inline LiftIn lift_in(const uint32_t* x, int B, int n) {
  return LiftIn{{x, x, x, x},
                {static_cast<long long>(B) * n, 0, 0, 0},
                {n, 0, 0, 0}};
}

// The first half of the unsigned or centered conversion, once per
// polynomial (csrc/ext.cuh's ext_lift_kernel): for each of the `ops`
// operands, y_i = x_i * (S/s_i)^-1 mod s_i and alpha = (sum_i y_i *
// floor(2^59/s_i) [+ 2^58]) >> 59 into lift + o (Ls + 1) B n as Ls + 1
// rows of B n words, row Ls alpha.  ext holds the conversion's packed table
// (its source part is read).  Queued on `stream`; returns
// cudaGetLastError() or cudaErrorInvalidValue for a shape it refuses.
// Defined in csrc/ext_cuda.cu; K5 and K6 launch it before their staged
// form.
int ext_lift(const LiftIn& in, int ops, uint32_t* lift, const uint32_t* ext,
             int Ls, int B, int n, int centered, cudaStream_t stream);

// The source-count argument of the instances of K5 and K6 (and of K5's
// first top pass past one block) that read the lift's rows instead of the
// sources: any 1 .. kMaxSrc source primes.
constexpr int kStagedSrc = 0;

// The Shoup pairs of (S/s_i) mod d_p for each source i, then that of
// S mod d_p: the 2 Ls + 2 words of ext_from_lift's table for destination
// prime p, staged by the block into `column` (the caller then waits on a
// barrier).
__device__ __forceinline__ void stage_column(uint32_t* column,
                                             const ExtTable& e, int p) {
  for (int w = threadIdx.x; w < 2 * e.ls + 2; w += blockDim.x) {
    const int i = w >> 1, f = w & 1;
    column[w] = i < e.ls ? e.tab(i, p, f) : e.dst(p, 1 + f);
  }
}

// The second half of the conversion for W words of one polynomial from the
// lift's rows (ext_lift): row i < ls holds y_i, row ls alpha, `stride`
// words apart, word k of each at rows + off(k); column is stage_column's.
// v[k] = sum_i y_i (S/s_i) - alpha S mod d, the arithmetic of ext.cuh's
// ext_sum.  The sources run in the outer loop and the W words in the inner
// one, so each iteration issues W independent loads (lanes on consecutive
// words) before it waits on any; the W sums stay in registers.
template <int W, typename Off>
__device__ __forceinline__ void ext_from_lift(uint32_t (&v)[W],
                                              const uint32_t* rows,
                                              size_t stride,
                                              const uint32_t* column, int ls,
                                              uint32_t d, Off off) {
#pragma unroll
  for (int k = 0; k < W; ++k) v[k] = 0;
#pragma unroll 1
  for (int i = 0; i < ls; ++i) {
    const uint32_t* y = rows + i * stride;
    uint32_t t[W];
#pragma unroll
    for (int k = 0; k < W; ++k) t[k] = __ldg(y + off(k));
    const uint32_t w = column[2 * i], wsh = column[2 * i + 1];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      v[k] = addmod(v[k], shoup_mul(t[k], w, wsh, d), d);
    }
  }
  const uint32_t* alpha = rows + ls * stride;
  const uint32_t sm = column[2 * ls], smsh = column[2 * ls + 1];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    v[k] = submod(v[k], shoup_mul(__ldg(alpha + off(k)), sm, smsh, d), d);
  }
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
