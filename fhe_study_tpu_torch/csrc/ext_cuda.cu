// Hopper kernels of the RNS fast base extension (HPS conversion): K4 replaces
// fhe_study_tpu/ops/ext_pallas.py::base_extend_fused (_ext_fused_kernel), K11
// (further down, on K4's structure) base_extend_sum.
//
// out_j = sum_i y_i * (S/s_i) - alpha * S  (mod d_j),
//   y_i = x_i * (S/s_i)^-1 mod s_i,
//   alpha = (sum_i y_i * floor(2^59/s_i) [+ 2^58 centered]) >> 59,
// with the optional epilogue out_j = (w_j - out_j) * c_j mod d_j (the BFV
// t/Q scaling and the hybrid relinearization's P-division).
//
// K4's layout: the op is fully per coefficient.  One instance per source
// count LS = 1 .. 15 keeps the y_i of a thread in LS registers (fully
// unrolled: no run-time-indexed array, so no local memory).  In its vector
// form (VEC, when the coefficient count is a multiple of 4 and x, w and out
// are 16-byte aligned) a thread owns 4 consecutive coefficients: one uint4
// load from each of the LS source rows and the Ld rows of w, one uint4 store
// to each of the Ld output rows, and each constant read once for the 4; the
// word form (any count and alignment) owns one coefficient, lanes on
// consecutive words.  Each block first stages the packed table (at most
// 5 (Ls + Ld) + 2 Ls Ld words) into shared memory, so no constant is read
// from device memory per coefficient.  What bounds it: Ls words in (and Ld
// of w) and Ld out per coefficient against ~(Ls * Ld) Shoup products, about
// 5 instructions a byte at Ls = 4, Ld = 5 where the H100 issues 10 for each
// byte its memory moves: the bytes.
// The arithmetic is ext_coeff's of modarith.cuh (Shoup products, the 64-bit
// alpha; 2^58 added to its sum when centered), bit for bit.

#include <cstdint>
#include <type_traits>

#include "modarith.cuh"

namespace fhe {
namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // grid-stride beyond this
constexpr int kExtVec = 4;                    // coefficients a thread (VEC)

// Words of the packed table of an Ls -> Ld conversion (ExtTable's layout).
__host__ __device__ constexpr int ext_words(int ls, int ld) {
  return 5 * (ls + ld) + 2 * ls * ld;
}

template <int K>
__device__ __forceinline__ void load_coeffs(uint32_t (&d)[K],
                                            const uint32_t* p) {
  if constexpr (K == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else {
    d[0] = __ldg(p);
  }
}

template <int K>
__device__ __forceinline__ void store_coeffs(uint32_t* p,
                                             const uint32_t (&d)[K]) {
  if constexpr (K == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(d[0], d[1], d[2], d[3]);
  } else {
    p[0] = d[0];
  }
}

// The table of one block: the packed constants staged into shared memory.
__device__ __forceinline__ ExtTable stage_table(uint32_t* tab,
                                                const uint32_t* ext, int ls,
                                                int ld) {
  for (int i = threadIdx.x; i < ext_words(ls, ld); i += blockDim.x) {
    tab[i] = ext[i];
  }
  __syncthreads();
  return ExtTable{tab, ls, ld};
}

// v = sum_i y_i * (S/s_i) - alpha * S mod d_j, for K coefficients at once.
template <int LS, int K>
__device__ __forceinline__ void ext_sum(const uint32_t (&y)[LS][K],
                                        const uint32_t (&alpha)[K],
                                        const ExtTable& e, int j,
                                        uint32_t (&v)[K]) {
  const uint32_t d = e.dst(j, 0);
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = 0;
#pragma unroll
  for (int i = 0; i < LS; ++i) {
    const uint32_t t = e.tab(i, j, 0), tsh = e.tab(i, j, 1);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = addmod(v[k], shoup_mul(y[i][k], t, tsh, d), d);
    }
  }
  const uint32_t sm = e.dst(j, 1), smsh = e.dst(j, 2);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = submod(v[k], shoup_mul(alpha[k], sm, smsh, d), d);
  }
}

template <int LS, int VEC>
__global__ void __launch_bounds__(kThreads)
base_extend_kernel(const uint32_t* __restrict__ x,
                   const uint32_t* __restrict__ w,
                   uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ ext, int Ld, long long total,
                   int centered) {
  constexpr int K = VEC != 0 ? kExtVec : 1;
  extern __shared__ uint32_t tab[];
  const ExtTable e = stage_table(tab, ext, LS, Ld);
  const long long units = total / K;             // VEC: total % 4 == 0
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long u = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       u < units; u += step) {
    const long long c = u * K;
    uint32_t y[LS][K];
    uint64_t acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = centered ? (1ull << 58) : 0ull;
#pragma unroll
    for (int i = 0; i < LS; ++i) {
      load_coeffs<K>(y[i], x + i * total + c);
      const uint32_t s = e.src(i, 0), h = e.src(i, 1), hsh = e.src(i, 2);
      const uint64_t cfix = static_cast<uint64_t>(e.src(i, 3)) |
                            (static_cast<uint64_t>(e.src(i, 4)) << 32);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        y[i][k] = shoup_mul(y[i][k], h, hsh, s);
        acc[k] += static_cast<uint64_t>(y[i][k]) * cfix;
      }
    }
    uint32_t alpha[K];
#pragma unroll
    for (int k = 0; k < K; ++k) alpha[k] = static_cast<uint32_t>(acc[k] >> 59);
    for (int j = 0; j < Ld; ++j) {
      uint32_t v[K];
      ext_sum<LS, K>(y, alpha, e, j, v);
      if (w != nullptr) {
        const uint32_t d = e.dst(j, 0);
        uint32_t wv[K];
        load_coeffs<K>(wv, w + j * total + c);
        const uint32_t cm = e.dst(j, 3), cmsh = e.dst(j, 4);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          v[k] = shoup_mul(submod(wv[k], v[k], d), cm, cmsh, d);
        }
      }
      store_coeffs<K>(out + j * total + c, v);
    }
  }
}

// K11 — replaces ext_pallas.py::base_extend_sum (_ext_kernel): the second
// half of the conversion alone, for a caller that holds (ys, alpha) already:
// out_j = sum_i ys_i * (S/s_i) - alpha * S  (mod d_j).  K4's structure: one
// instance per source count (the ys of a thread in LS registers), the table
// staged in shared memory, and in its vector form 4 consecutive coefficients
// a thread, one uint4 load from each of the LS rows of ys and from alpha and
// one uint4 store to each of the Ld output rows.  Ls + 1 words in and Ld out
// per coefficient against Ls * Ld Shoup products and modular adds: about 4
// instructions a byte at Ls = 4, Ld = 5, where the H100 issues 10 for each
// byte its memory moves, so bytes bound it.
template <int LS, int VEC>
__global__ void __launch_bounds__(kThreads)
base_extend_sum_kernel(const uint32_t* __restrict__ ys,
                       const uint32_t* __restrict__ alpha,
                       uint32_t* __restrict__ out,
                       const uint32_t* __restrict__ ext, int Ld,
                       long long total) {
  constexpr int K = VEC != 0 ? kExtVec : 1;
  extern __shared__ uint32_t tab[];
  const ExtTable e = stage_table(tab, ext, LS, Ld);
  const long long units = total / K;             // VEC: total % 4 == 0
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long u = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       u < units; u += step) {
    const long long c = u * K;
    uint32_t y[LS][K], al[K];
#pragma unroll
    for (int i = 0; i < LS; ++i) load_coeffs<K>(y[i], ys + i * total + c);
    load_coeffs<K>(al, alpha + c);
    for (int j = 0; j < Ld; ++j) {
      uint32_t v[K];
      ext_sum<LS, K>(y, al, e, j, v);
      store_coeffs<K>(out + j * total + c, v);
    }
  }
}

unsigned grid_for(long long threads) {
  const long long blocks = (threads + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

// launch(std::integral_constant<int, Ls>{}): the instance for Ls source
// primes (1 .. kMaxSrc), by recursion over the compile-time counts.
template <int LS = 1, typename Launch>
int by_src_count(int Ls, Launch&& launch) {
  if constexpr (LS > kMaxSrc) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (Ls != LS) return by_src_count<LS + 1>(Ls, launch);
    launch(std::integral_constant<int, LS>{});
    return static_cast<int>(cudaGetLastError());
  }
}

// The packed table fits the 48 KB of dynamic shared memory a block gets
// without opting in, and the vector form's operands are 4-word rows on
// 16-byte boundaries.
bool bad_shape(int Ls, int Ld, long long total) {
  return Ls < 1 || Ls > kMaxSrc || Ld < 1 || total < 1 ||
         sizeof(uint32_t) * ext_words(Ls, Ld) > 48 * 1024;
}

bool bad_vec(long long total, const void* a, const void* b, const void* c) {
  return total % kExtVec != 0 || misaligned(a) || misaligned(b) ||
         (c != nullptr && misaligned(c));
}

}  // namespace
}  // namespace fhe

using namespace fhe;

// vec: the vector form (total % 4 == 0 and x, w, out 16-byte aligned, as
// ops/ext_cuda.py::_ext_vec decides); refused otherwise.
extern "C" int fhe_base_extend(const uint32_t* x, const uint32_t* w,
                               uint32_t* out, const uint32_t* ext, int Ls,
                               int Ld, long long total, int centered, int vec,
                               cudaStream_t stream) {
  if (bad_shape(Ls, Ld, total) || (vec && bad_vec(total, x, out, w))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(uint32_t) * ext_words(Ls, Ld);
  return by_src_count(Ls, [&](auto ls) {
    constexpr int LS = decltype(ls)::value;
    if (vec) {
      base_extend_kernel<LS, 1><<<grid_for(total / kExtVec), kThreads, smem,
                                  stream>>>(x, w, out, ext, Ld, total,
                                            centered);
    } else {
      base_extend_kernel<LS, 0><<<grid_for(total), kThreads, smem, stream>>>(
          x, w, out, ext, Ld, total, centered);
    }
  });
}

// vec: as fhe_base_extend's, on ys, alpha and out.
extern "C" int fhe_base_extend_sum(const uint32_t* ys, const uint32_t* alpha,
                                   uint32_t* out, const uint32_t* ext, int Ls,
                                   int Ld, long long total, int vec,
                                   cudaStream_t stream) {
  if (bad_shape(Ls, Ld, total) || (vec && bad_vec(total, ys, alpha, out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(uint32_t) * ext_words(Ls, Ld);
  return by_src_count(Ls, [&](auto ls) {
    constexpr int LS = decltype(ls)::value;
    if (vec) {
      base_extend_sum_kernel<LS, 1><<<grid_for(total / kExtVec), kThreads,
                                      smem, stream>>>(ys, alpha, out, ext, Ld,
                                                      total);
    } else {
      base_extend_sum_kernel<LS, 0><<<grid_for(total), kThreads, smem,
                                      stream>>>(ys, alpha, out, ext, Ld,
                                                total);
    }
  });
}

extern "C" const char* fhe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
