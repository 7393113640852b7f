// The forward's first top pass past one block's polynomial (csrc/
// ntt_chunks.cuh) when the kernel forms the words it transforms in it: K5's
// extension (csrc/forward_chunks_cuda.cu), K6's four operands with or
// without their extension (csrc/tensor_mul4_chunks_cuda.cu), K7's and K8's
// digits and K8's adds (csrc/ks_fused_chunks_cuda.cu).  Each thread forms
// its 2^K words at their element addresses, as K10's grid layout forms its
// digits there (csrc/blind_rotate_grid_cuda.cu), runs the pass's stages on
// them and stores them into the 32-bit scratch that the other top passes
// and the chunk chains then read.
#pragma once

#include <cstdint>

#include "modarith.cuh"
#include "ntt_chunks.cuh"

namespace fhe {
namespace {

// The source-count argument of the first top pass that reads each word as
// it is (no source basis), less q `reps` times by conditional subtractions
// (K7's and K8's digits; 0 elsewhere).
constexpr int kPlainSrc = -1;

// The first top pass over bits [lo, lo + K) of destination polynomial
// p B + b of tmp [Ld, B, n] (K = top_bits(logn, 0)), under prime p of cons,
// its words i at:
//   LS = kPlainSrc   x[p sl + b sb + i] (a row of a strided view; sl = 0:
//                    the same row under every prime), reduced by `reps`
//                    conditional subtractions of q;
//   LS = 2, 4        the extension of source rows x + b sb + i, sl words
//                    apart, to p (ext_coeff<LS>, the y_i in registers);
//   LS = kStagedSrc  the extension from the lift's Ls + 1 rows x + b sb,
//                    sl words apart (ext_from_lift, the block's table
//                    column in shared memory).
// ext: the conversion's packed table (null without a source basis); tw /
// tw_sh the forward chunk tables [Ld, 2^s, 2^15].  The blocks of one
// polynomial b run p fastest, as the one-block kernels' do, so that the Ld
// destination primes' blocks read its rows side by side, from L2 after the
// first.
template <int K, int LS>
__global__ void __launch_bounds__(kTopThreads)
first_top_kernel(const uint32_t* __restrict__ x, long long sl, long long sb,
                 uint32_t* __restrict__ tmp, const uint32_t* __restrict__ ext,
                 const uint32_t* __restrict__ tw,
                 const uint32_t* __restrict__ tw_sh,
                 const uint32_t* __restrict__ cons, int Ls, int Ld, int B,
                 int logn, int lo, int reps) {
  __shared__ uint32_t column[LS == kStagedSrc ? 2 * kMaxSrc + 2 : 1];
  const int per = (1 << (logn - K)) / kTopThreads;
  const int bp = blockIdx.x / per;           // b * Ld + p
  const int v = (blockIdx.x - bp * per) * kTopThreads + threadIdx.x;
  const int b = bp / Ld;
  const int p = bp - b * Ld;
  const uint32_t q = cons[4 * p];
  const size_t n = static_cast<size_t>(1) << logn;
  const int base = top_base(v, lo, K);
  uint32_t r[1 << K];
  if constexpr (LS == kPlainSrc) {
    const uint32_t* row = x + p * sl + b * sb + base;
#pragma unroll
    for (int k = 0; k < (1 << K); ++k) {
      r[k] = __ldg(row + (static_cast<size_t>(k) << lo));
    }
#pragma unroll 1
    for (int s = 0; s < reps; ++s) {
#pragma unroll
      for (int k = 0; k < (1 << K); ++k) r[k] = r[k] >= q ? r[k] - q : r[k];
    }
  } else {
    const ExtTable e{ext, LS != kStagedSrc ? LS : Ls, Ld};
    const uint32_t* row = x + b * sb;
    if constexpr (LS == kStagedSrc) {
      stage_column(column, e, p);
      __syncthreads();
      ext_from_lift(r, row, static_cast<size_t>(sl), column, Ls, q,
                    [&](int k) { return base + (k << lo); });
    } else {
#pragma unroll
      for (int k = 0; k < (1 << K); ++k) {
        r[k] = ext_coeff<LS>(row + base + (k << lo), static_cast<size_t>(sl),
                             e, p);
      }
    }
  }
  top_stages<K, false>(r, base, lo, logn, tw + p * n, tw_sh + p * n, q);
  uint32_t* o = tmp + (static_cast<size_t>(p) * B + b) * n + base;
#pragma unroll
  for (int k = 0; k < (1 << K); ++k) o[static_cast<size_t>(k) << lo] = r[k];
}

template <int LS>
struct FirstTop {
  template <int K>
  static auto kernel() { return &first_top_kernel<K, LS>; }
};

// The first top pass of Ld B polynomials of 2^logn words into tmp (its
// rows p B + b), queued on `stream`.
template <int LS>
int first_top_launch(const uint32_t* x, long long sl, long long sb,
                     uint32_t* tmp, const uint32_t* ext, const uint32_t* tw,
                     const uint32_t* tw_sh, const uint32_t* cons, int Ls,
                     int Ld, int B, int logn, int reps, cudaStream_t stream) {
  const int K = top_bits(logn, 0);
  return top_pass_launch<FirstTop<LS>>(
      K, top_blocks(static_cast<long long>(Ld) * B, logn, K), stream, x, sl,
      sb, tmp, ext, tw, tw_sh, cons, Ls, Ld, B, logn, top_lo(logn, 0), reps);
}

// The forward's other top passes (past the first, which first_top_launch
// has queued) in place in tmp, over `polys` polynomials of 2^logn words,
// row i under prime (i / B) mod Ld; the caller's chunk chains follow.
inline int other_tops(uint32_t* tmp, const uint32_t* tw,
                      const uint32_t* tw_sh, const uint32_t* cons,
                      long long polys, int B, int Ld, int logn,
                      cudaStream_t stream) {
  int err = 0;
  for (int t = 1; t < top_passes(logn) && err == 0; ++t) {
    err = top_launch<false>(top_bits(logn, t), tmp, tmp, tw, tw_sh, cons,
                            polys, B, Ld, logn, top_lo(logn, t), 0, stream);
  }
  return err;
}

}  // namespace
}  // namespace fhe
