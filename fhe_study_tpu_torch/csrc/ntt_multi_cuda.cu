// K1 and K9: the Hopper kernels of the negacyclic transforms,
//   fhe_ntt_multi <- fhe_study_tpu/ops/ntt_pallas.py::ntt_multi_u32
//   fhe_ntt       <- fhe_study_tpu/ops/ntt_pallas.py::ntt_u32
// K1 transforms rows [L, B, n], one prime a row, then applies an optional
// per-prime final Shoup multiply (n^-1, t/n, the Montgomery 2^32, ...).  K9
// runs the same body on a flat batch [B, n] under one prime in int64 words
// (the torus code's residues): it reads each word's low half and writes the
// high half zero, so no cast passes over device memory; n^-1 is the fin of
// its inverse, its forward has none.
//
// One block per (prime, polynomial) runs the register-resident chain of
// radix_chain.cuh.  The forward's first pass reads its 16 words straight
// from device memory, lanes on consecutive words; the result leaves shared
// memory in coalesced 16-byte stores (4 words of K1, 2 of K9) with fin
// applied.  The inverse's first pass reads 16 contiguous words, in 16-byte
// vectors when the rows are 16-byte aligned (`vec`) and word by word
// otherwise; its last pass stores lanes on consecutive words, fin folded in.
// What bounds it: K1 moves 8 bytes a coefficient against (log n) / 2
// butterflies of 13 instructions, so the issue rate; K9 moves 16, which at
// the H100's data-sheet rates outlasts its butterflies at every log n (4.8
// against 1.9 ps a coefficient at n = 1024), so device memory.  Both take
// n = 2^7 .. 2^15 at radix_chain.cuh's one-buffer block shape (OneBuffer:
// 8 threads at 2^7, 512 threads and one block an SM at 2^15).
//
// Each entry launches on the given stream and returns cudaGetLastError(); a
// refused launch never runs, so the caller raises.

#include <climits>
#include <cstdint>

#include "modarith.cuh"
#include "radix_chain.cuh"

namespace fhe {
namespace {

// Word i of a row as a residue: an int64 word holds it in its low half,
// which is loaded alone (the card is little-endian).  Callers pass the
// thread's base into the pointer and a constant i, so the 16 loads of a
// pass take immediate offsets from one address.
template <typename Word>
__device__ __forceinline__ uint32_t row_word(const Word* row, int i) {
  if constexpr (sizeof(Word) == 8) {
    return __ldg(reinterpret_cast<const uint32_t*>(row) + 2 * i);
  } else {
    return __ldg(row + i);
  }
}

// Four consecutive words at p as residues: 16-byte loads when p is 16-byte
// aligned (vec), word loads otherwise.
template <typename Word>
__device__ __forceinline__ void row_words(uint32_t (&d)[4], const Word* p,
                                          bool vec) {
  if constexpr (sizeof(Word) == 8) {
    if (vec) {
      const uint4* v = reinterpret_cast<const uint4*>(p);
      const uint4 lo = __ldg(v);
      const uint4 hi = __ldg(v + 1);
      d[0] = lo.x; d[1] = lo.z; d[2] = hi.x; d[3] = hi.z;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) d[j] = row_word(p, j);
    }
  } else {
    operand_words(d, p, vec);
  }
}

template <int LOGN, int INV, typename Word>
__device__ __forceinline__ void ntt_rows(const Word* __restrict__ x,
                                         Word* __restrict__ out,
                                         const uint32_t* __restrict__ tw,
                                         const uint32_t* __restrict__ tw_sh,
                                         const uint32_t* __restrict__ cons,
                                         int B, int use_fin, int vec) {
  using S = typename OneBuffer<LOGN>::Shape;
  constexpr int n = S::n;
  extern __shared__ uint32_t a[];
  const int p = blockIdx.x / B;              // block p * B + b: row p * B + b
  const PrimeRow c = prime_row(cons, p);
  const uint32_t* w = tw + static_cast<size_t>(p) * n;
  const uint32_t* wsh = tw_sh + static_cast<size_t>(p) * n;
  const Word* row = x + static_cast<size_t>(blockIdx.x) * n;
  Word* o = out + static_cast<size_t>(blockIdx.x) * n;
  if constexpr (INV != 0) {
    constexpr int last = S::passes - 1;
    constexpr int cl = S::inv_c(last);
#pragma unroll 1
    for (int g = 0; g < S::groups; ++g) {
      const int base = (threadIdx.x + g * S::threads) << kRadixBits;
      uint32_t r[kRadix];
#pragma unroll
      for (int j = 0; j < kRadix; j += 4) {
        uint32_t d[4];
        row_words(d, row + base + j, vec != 0);
#pragma unroll
        for (int i = 0; i < 4; ++i) r[j + i] = d[i];
      }
      radix_pass<LOGN, 0, true>(r, base, w, wsh, c.q);
      radix_store<0>(a, r, base);
    }
    __syncthreads();
    RadixPasses<LOGN, 1, last, true, S::threads>::run(a, w, wsh, c.q);
#pragma unroll 1
    for (int g = 0; g < S::groups; ++g) {
      const int base = radix_base(threadIdx.x + g * S::threads, cl);
      uint32_t r[kRadix];
      radix_load<cl>(r, a, base);
      radix_pass<LOGN, last, true>(r, base, w, wsh, c.q);
#pragma unroll
      for (int j = 0; j < kRadix; ++j) {
        o[base + (j << cl)] =
            use_fin ? shoup_mul(r[j], c.fin, c.fin_sh, c.q) : r[j];
      }
    }
  } else {
    constexpr int c0 = S::fwd_c(0);
#pragma unroll 1
    for (int g = 0; g < S::groups; ++g) {
      const int base = threadIdx.x + g * S::threads;  // radix_base(v, c0)
      uint32_t r[kRadix];
#pragma unroll
      for (int j = 0; j < kRadix; ++j) r[j] = row_word(row + base, j << c0);
      radix_pass<LOGN, 0, false>(r, base, w, wsh, c.q);
      radix_store<c0>(a, r, base);
    }
    __syncthreads();
    RadixPasses<LOGN, 1, S::passes, false, S::threads>::run(a, w, wsh, c.q);
    // lane i stores the kv words from kv * i: 16 bytes
    constexpr int kv = 16 / static_cast<int>(sizeof(Word));
    for (int i = threadIdx.x; i < n / kv; i += S::threads) {
      const int sw = radix_swizzle(kv * i);
      uint32_t v[kv];
#pragma unroll
      for (int t = 0; t < kv; ++t) v[t] = a[sw ^ t];
      if (use_fin) {
#pragma unroll
        for (int t = 0; t < kv; ++t) {
          v[t] = shoup_mul(v[t], c.fin, c.fin_sh, c.q);
        }
      }
      if constexpr (kv == 4) {
        reinterpret_cast<uint4*>(o)[i] = make_uint4(v[0], v[1], v[2], v[3]);
      } else {
        reinterpret_cast<longlong2*>(o)[i] = make_longlong2(v[0], v[1]);
      }
    }
  }
}

template <int LOGN, int INV>
__global__ void __launch_bounds__(OneBuffer<LOGN>::threads,
                                  OneBuffer<LOGN>::blocks)
ntt_multi_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 const uint32_t* __restrict__ tw,
                 const uint32_t* __restrict__ tw_sh,
                 const uint32_t* __restrict__ cons, int B, int use_fin,
                 int vec) {
  ntt_rows<LOGN, INV>(x, out, tw, tw_sh, cons, B, use_fin, vec);
}

template <int LOGN, int INV>
__global__ void __launch_bounds__(OneBuffer<LOGN>::threads,
                                  OneBuffer<LOGN>::blocks)
ntt_kernel(const long long* __restrict__ x, long long* __restrict__ out,
           const uint32_t* __restrict__ tw,
           const uint32_t* __restrict__ tw_sh,
           const uint32_t* __restrict__ cons, int B, int vec) {
  ntt_rows<LOGN, INV>(x, out, tw, tw_sh, cons, B, INV, vec);
}

template <int INV>
struct NttMultiLaunch {
  template <int LOGN, typename... Args>
  static int run(Args... args) {
    return one_buffer_launch<LOGN>(ntt_multi_kernel<LOGN, INV>, args...);
  }
};

template <int INV>
struct NttLaunch {
  template <int LOGN, typename... Args>
  static int run(Args... args) {
    return one_buffer_launch<LOGN>(ntt_kernel<LOGN, INV>, args...);
  }
};

}  // namespace
}  // namespace fhe

using namespace fhe;

// vec: the inverse reads its rows as uint4 (x 16-byte aligned); the
// forward's read-out always stores uint4 rows (out 16-byte aligned).
extern "C" int fhe_ntt_multi(const uint32_t* x, uint32_t* out,
                             const uint32_t* tw, const uint32_t* tw_sh,
                             const uint32_t* cons, int L, int B, int logn,
                             int inverse, int use_fin, int vec, int threads,
                             int smem, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(L) * B;
  if (L < 1 || B < 1 || blocks > INT_MAX || misaligned(out) ||
      (vec && misaligned(x))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nb = static_cast<int>(blocks);
  if (inverse) {
    return by_logn_wide<NttMultiLaunch<1>>(logn, threads, smem, nb, stream,
                                           x, out, tw, tw_sh, cons, B,
                                           use_fin, vec);
  }
  return by_logn_wide<NttMultiLaunch<0>>(logn, threads, smem, nb, stream, x,
                                         out, tw, tw_sh, cons, B, use_fin,
                                         vec);
}

// K9 on [B, n] int64 words under the one prime of cons (its fin n^-1 for
// the inverse); vec as for fhe_ntt_multi.
extern "C" int fhe_ntt(const long long* x, long long* out, const uint32_t* tw,
                       const uint32_t* tw_sh, const uint32_t* cons, int B,
                       int logn, int inverse, int vec, int threads, int smem,
                       cudaStream_t stream) {
  if (B < 1 || misaligned(out) || (vec && misaligned(x))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (inverse) {
    return by_logn_wide<NttLaunch<1>>(logn, threads, smem, B, stream, x, out,
                                      tw, tw_sh, cons, B, vec);
  }
  return by_logn_wide<NttLaunch<0>>(logn, threads, smem, B, stream, x, out, tw,
                                    tw_sh, cons, B, vec);
}
