// K1: the Hopper kernel of the multi-prime negacyclic transform,
//   fhe_ntt_multi <- fhe_study_tpu/ops/ntt_pallas.py::ntt_multi_u32
//                    (_ntt_kernel_multi)
// rows [L, B, n] of residues, one prime per row; the forward or the inverse
// transform of every row, then an optional per-prime final Shoup multiply
// (the inverse's n^-1, t/n, the Montgomery 2^32, ...).
//
// Layout: one block per (prime, polynomial) runs the register-resident chain
// of radix_chain.cuh (16 words a thread, four stages a pass, ceil(log n / 4)
// - 1 exchanges through swizzled shared memory: 3 barriers at n = 2^14 where
// the one-stage chain of modarith.cuh takes 14), as K2 and K5 do.
//   forward: the first pass (stage bits log n - 1 .. log n - 4) reads its 16
//     words straight from device memory, lanes on consecutive words (K5's
//     first pass without the conversion); the last pass leaves the result in
//     shared memory, read out as coalesced uint4 rows with fin applied.
//   inverse: the first pass (stage bits 0..3) reads 16 contiguous words, as
//     uint4 when the rows are 16-byte aligned (`vec`) and word by word
//     otherwise (K2's first pass with a plain load for its products); the
//     last pass stores lanes on consecutive words with fin folded in.
// What bounds it: device memory sees 8 bytes a coefficient, against
// (log n) / 2 butterflies of 13 instructions, so the issue rate; beside the
// counted butterflies a pass issues its shared-memory words, their address
// XORs and the twiddle loads, and the block waits at its barriers.
//
// The entry launches on the given stream and returns cudaGetLastError(); a
// refused launch never runs, so the caller raises.

#include <climits>
#include <cstdint>

#include "modarith.cuh"
#include "radix_chain.cuh"

namespace fhe {
namespace {

template <int LOGN, int INV>
__global__ void __launch_bounds__(kRadixThreads, kRadixBlocks)
ntt_multi_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 const uint32_t* __restrict__ tw,
                 const uint32_t* __restrict__ tw_sh,
                 const uint32_t* __restrict__ cons, int B, int use_fin,
                 int vec) {
  using S = RadixShape<LOGN>;
  constexpr int n = S::n;
  extern __shared__ uint32_t a[];
  const int p = blockIdx.x / B;              // block p * B + b: row p * B + b
  const PrimeRow c = prime_row(cons, p);
  const uint32_t* w = tw + static_cast<size_t>(p) * n;
  const uint32_t* wsh = tw_sh + static_cast<size_t>(p) * n;
  const uint32_t* row = x + static_cast<size_t>(blockIdx.x) * n;
  uint32_t* o = out + static_cast<size_t>(blockIdx.x) * n;
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
        operand_words(d, row + base + j, vec != 0);
#pragma unroll
        for (int i = 0; i < 4; ++i) r[j + i] = d[i];
      }
      radix_pass<LOGN, 0, true>(r, base, w, wsh, c.q);
      radix_store<0>(a, r, base);
    }
    __syncthreads();
    RadixPasses<LOGN, 1, last, true>::run(a, w, wsh, c.q);
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
      for (int j = 0; j < kRadix; ++j) r[j] = __ldg(row + base + (j << c0));
      radix_pass<LOGN, 0, false>(r, base, w, wsh, c.q);
      radix_store<c0>(a, r, base);
    }
    __syncthreads();
    RadixPasses<LOGN, 1, S::passes, false>::run(a, w, wsh, c.q);
    uint4* o4 = reinterpret_cast<uint4*>(o);
    for (int i = threadIdx.x; i < n / 4; i += S::threads) {
      const int sw = radix_swizzle(4 * i);
      uint32_t v[4] = {a[sw], a[sw ^ 1], a[sw ^ 2], a[sw ^ 3]};
      if (use_fin) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          v[t] = shoup_mul(v[t], c.fin, c.fin_sh, c.q);
        }
      }
      o4[i] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int INV>
struct NttMultiLaunch {
  template <int LOGN, typename... Args>
  static int run(Args... args) {
    return radix_launch<LOGN>(ntt_multi_kernel<LOGN, INV>, args...);
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
    return by_logn<NttMultiLaunch<1>>(logn, threads, smem, nb, stream, x, out,
                                      tw, tw_sh, cons, B, use_fin, vec);
  }
  return by_logn<NttMultiLaunch<0>>(logn, threads, smem, nb, stream, x, out,
                                    tw, tw_sh, cons, B, use_fin, vec);
}
