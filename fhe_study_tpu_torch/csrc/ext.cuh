// K4 base_extend and K11 base_extend_sum: the kernel templates and their
// launch, shared by the two translation units that instantiate them
// (csrc/ext_cuda.cu: the entry points and the source counts 1 ..
// kNarrowSrc; csrc/ext_wide_cuda.cu: kNarrowSrc + 1 .. kMaxSrc), so that
// their instances compile in parallel.  ext_cuda.cu's header describes the
// kernels.
#pragma once

#include <cstdint>
#include <type_traits>

#include "modarith.cuh"

namespace fhe {

// The source counts of csrc/ext_cuda.cu's instances; ext_wide_cuda.cu
// holds the rest, up to kMaxSrc.
constexpr int kNarrowSrc = 15;

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

// The lift of K5 and K6 (ext_lift, modarith.cuh), on K4's structure: 4
// consecutive coefficients a thread in its vector form (n % 4 == 0, every
// row on a 16-byte boundary), one in its word form; blockIdx.y is the
// operand.  The source loop is a run-time one (any 1 .. kMaxSrc primes, one
// instance a form): each y_i is stored as it is formed, so nothing of Ls
// words stays in registers, and only the K 64-bit alpha sums do.  Ls words
// in and Ls + 1 out per coefficient against Ls Shoup products and
// multiply-adds: the bytes bound it.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
ext_lift_kernel(LiftIn in, uint32_t* __restrict__ lift,
                const uint32_t* __restrict__ ext, int Ls, int B, int n,
                int centered) {
  constexpr int K = VEC != 0 ? kExtVec : 1;
  extern __shared__ uint32_t tab[];
  const ExtTable e = stage_table(tab, ext, Ls, 0);    // the source part
  const int o = blockIdx.y;
  // selects: no run-time index into the parameters
  const uint32_t* x = o == 0 ? in.x[0] : (o == 1 ? in.x[1] :
                                          (o == 2 ? in.x[2] : in.x[3]));
  const long long sl = o == 0 ? in.sl[0] : (o == 1 ? in.sl[1] :
                                            (o == 2 ? in.sl[2] : in.sl[3]));
  const long long sb = o == 0 ? in.sb[0] : (o == 1 ? in.sb[1] :
                                            (o == 2 ? in.sb[2] : in.sb[3]));
  const long long total = static_cast<long long>(B) * n;
  uint32_t* const ys = lift + static_cast<long long>(o) * (Ls + 1) * total;
  const long long units = total / K;             // VEC: n % 4 == 0
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long u = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       u < units; u += step) {
    const long long c = u * K;
    const long long b = c / n;
    const uint32_t* xc = x + b * sb + (c - b * n);
    uint64_t acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = centered ? (1ull << 58) : 0ull;
#pragma unroll 4
    for (int i = 0; i < Ls; ++i) {
      uint32_t y[K];
      load_coeffs<K>(y, xc + i * sl);
      const uint32_t s = e.src(i, 0), h = e.src(i, 1), hsh = e.src(i, 2);
      const uint64_t cfix = static_cast<uint64_t>(e.src(i, 3)) |
                            (static_cast<uint64_t>(e.src(i, 4)) << 32);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        y[k] = shoup_mul(y[k], h, hsh, s);
        acc[k] += static_cast<uint64_t>(y[k]) * cfix;
      }
      store_coeffs<K>(ys + i * total + c, y);
    }
    uint32_t alpha[K];
#pragma unroll
    for (int k = 0; k < K; ++k) alpha[k] = static_cast<uint32_t>(acc[k] >> 59);
    store_coeffs<K>(ys + Ls * total + c, alpha);
  }
}

unsigned grid_for(long long threads) {
  const long long blocks = (threads + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

// launch(std::integral_constant<int, Ls>{}): the instance for Ls source
// primes (LS .. HI), by recursion over the compile-time counts.
template <int LS, int HI, typename Launch>
int by_src_count(int Ls, Launch&& launch) {
  if constexpr (LS > HI) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (Ls != LS) return by_src_count<LS + 1, HI>(Ls, launch);
    launch(std::integral_constant<int, LS>{});
    return static_cast<int>(cudaGetLastError());
  }
}

// K4 from LO .. HI source primes, on a shape its entry point has checked.
template <int LO, int HI>
int base_extend_counts(const uint32_t* x, const uint32_t* w, uint32_t* out,
                       const uint32_t* ext, int Ls, int Ld, long long total,
                       int centered, int vec, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * ext_words(Ls, Ld);
  return by_src_count<LO, HI>(Ls, [&](auto ls) {
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

// K11 from LO .. HI source primes, on a shape its entry point has checked.
template <int LO, int HI>
int base_extend_sum_counts(const uint32_t* ys, const uint32_t* alpha,
                           uint32_t* out, const uint32_t* ext, int Ls, int Ld,
                           long long total, int vec, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * ext_words(Ls, Ld);
  return by_src_count<LO, HI>(Ls, [&](auto ls) {
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

}  // namespace

// The instances from kNarrowSrc + 1 .. kMaxSrc source primes
// (csrc/ext_wide_cuda.cu).
int base_extend_wide(const uint32_t* x, const uint32_t* w, uint32_t* out,
                     const uint32_t* ext, int Ls, int Ld, long long total,
                     int centered, int vec, cudaStream_t stream);
int base_extend_sum_wide(const uint32_t* ys, const uint32_t* alpha,
                         uint32_t* out, const uint32_t* ext, int Ls, int Ld,
                         long long total, int vec, cudaStream_t stream);

}  // namespace fhe
