// K5: the Hopper kernel of the base extension fused with the forward
// transform,
//   fhe_ext_ntt <- fhe_study_tpu/ops/ntt_pallas.py::ext_ntt_u32
//                  (_ext_ntt_kernel)
// on the register-resident chain of radix_chain.cuh; ntt_cuda.cu's header
// says what bounds the chain kernels.  Its own translation unit, so that its
// 27 unrolled instances (per log n, 2^7 .. 2^15, and form: from 2 and 4
// source primes, and staged) compile beside the others; at 2^15 one block
// of 512 threads an SM (radix_chain.cuh's OneBuffer).  The lift that the
// staged form reads is csrc/ext.cuh's ext_lift_kernel, launched by this
// entry on the same stream (its launch counts as one with the kernel's).
// Past n = 2^15 the entry queues the chunked form of
// csrc/forward_chunks_cuda.cu (the extension in the first top pass).
//
// The entry launches on the given stream and returns cudaGetLastError(); a
// refused launch never runs, so the caller raises.

#include <climits>
#include <cstdint>

#include "modarith.cuh"
#include "radix_chain.cuh"

namespace fhe {
namespace {

// K5: unsigned HPS extension of rows [Ls, B, n] to destination prime p,
// fused with its forward transform, one block per (b, p), p fastest so that
// the Ld blocks reading one polynomial's rows run side by side and share
// them in L2.  The conversion writes straight into the registers of the
// first pass of the register-resident forward chain (radix_chain.cuh:
// stage bits log n - 1 .. log n - 4, so lanes read consecutive words of each
// row); the last pass leaves the result in shared memory, read out as
// coalesced uint4 rows.  Two forms:
//   direct (LS = 2, 4): x is the source rows; each word is converted by
//     ext_coeff<LS> of modarith.cuh, its y_i in registers;
//   staged (LS = kStagedSrc, any 1 .. 31 source primes): the entry has run
//     the lift (ext_lift) first, and x is its Ls + 1 rows (the y_i, then
//     alpha) of B n words; the block stages its prime's column of the
//     table in shared memory and forms each word's sum from them
//     (ext_from_lift: the sources in the outer loop, each iteration 16
//     independent loads).  Every y_i and alpha is formed once per
//     polynomial, not once per destination block, and no dependent load
//     chain a word is left.

template <int LOGN, int LS>
__global__ void __launch_bounds__(OneBuffer<LOGN>::threads,
                                  OneBuffer<LOGN>::blocks)
ext_ntt_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
               const uint32_t* __restrict__ ext,
               const uint32_t* __restrict__ tw,
               const uint32_t* __restrict__ tw_sh, int Ls, int Ld, int B) {
  using S = typename OneBuffer<LOGN>::Shape;
  constexpr int n = S::n;
  constexpr int c0 = S::fwd_c(0);
  extern __shared__ uint32_t a[];
  __shared__ uint32_t column[LS == kStagedSrc ? 2 * kMaxSrc + 2 : 1];
  const int p = blockIdx.x % Ld;
  const int b = blockIdx.x / Ld;
  const ExtTable e{ext, LS != kStagedSrc ? LS : Ls, Ld};
  const uint32_t q = e.dst(p, 0);
  const uint32_t* w = tw + static_cast<size_t>(p) * n;
  const uint32_t* wsh = tw_sh + static_cast<size_t>(p) * n;
  const uint32_t* row = x + static_cast<size_t>(b) * n;
  const size_t stride = static_cast<size_t>(B) * n;
  if constexpr (LS == kStagedSrc) {
    stage_column(column, e, p);
    __syncthreads();
  }
#pragma unroll 1
  for (int g = 0; g < S::groups; ++g) {
    const int base = threadIdx.x + g * S::threads;    // radix_base(v, c0)
    uint32_t r[kRadix];
    if constexpr (LS == kStagedSrc) {
      ext_from_lift(r, row, stride, column, Ls, q,
                    [&](int j) { return base + (j << c0); });
    } else {
#pragma unroll
      for (int j = 0; j < kRadix; ++j) {
        r[j] = ext_coeff<LS>(row + base + (j << c0), stride, e, p);
      }
    }
    radix_pass<LOGN, 0, false>(r, base, w, wsh, q);
    radix_store<c0>(a, r, base);
  }
  __syncthreads();
  RadixPasses<LOGN, 1, S::passes, false, S::threads>::run(a, w, wsh, q);
  uint4* o = reinterpret_cast<uint4*>(out + (static_cast<size_t>(p) * B + b) * n);
  for (int i = threadIdx.x; i < n / 4; i += S::threads) {
    const int sw = radix_swizzle(4 * i);
    o[i] = make_uint4(a[sw], a[sw ^ 1], a[sw ^ 2], a[sw ^ 3]);
  }
}

template <int LS>
struct ExtNttLaunch {
  struct F {
    template <int LOGN, typename... Args>
    static int run(Args... args) {
      return one_buffer_launch<LOGN>(ext_ntt_kernel<LOGN, LS>, args...);
    }
  };
};

}  // namespace

// K5 past one block (csrc/forward_chunks_cuda.cu).
int ext_ntt_chunked(const uint32_t* x, uint32_t* lift, uint32_t* tmp,
                    uint32_t* out, const uint32_t* ext, const uint32_t* tw,
                    const uint32_t* tw_sh, const uint32_t* cons, int Ls,
                    int Ld, int B, int logn, int threads, int smem,
                    cudaStream_t stream);

}  // namespace fhe

using namespace fhe;

// lift: null for the direct form (Ls = 2 or 4), else the lift's scratch of
// (Ls + 1) B n words, which the staged form fills (ext_lift) and then reads,
// both queued on `stream` (ops/ntt_cuda.py::lift_plan decides the form).
// Past n = 2^15 (csrc/forward_chunks_cuda.cu) tw / tw_sh are the chunk
// tables, threads and smem a chunk's, cons the destination primes' rows and
// tmp a scratch of Ld B n words (16-byte aligned); below it neither is read.
extern "C" int fhe_ext_ntt(const uint32_t* x, uint32_t* lift, uint32_t* tmp,
                           uint32_t* out, const uint32_t* ext,
                           const uint32_t* tw, const uint32_t* tw_sh,
                           const uint32_t* cons, int Ls, int Ld, int B,
                           int logn, int threads, int smem,
                           cudaStream_t stream) {
  const long long blocks = static_cast<long long>(Ld) * B;
  if (Ls < 1 || Ls > kMaxSrc || Ld < 1 || B < 1 || blocks > INT_MAX ||
      logn < 7) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (logn > kWideLogN) {
    return ext_ntt_chunked(x, lift, tmp, out, ext, tw, tw_sh, cons, Ls, Ld,
                           B, logn, threads, smem, stream);
  }
  const int nb = static_cast<int>(blocks);
  if (lift != nullptr) {
    const int n = 1 << logn;
    const int err =
        ext_lift(lift_in(x, B, n), 1, lift, ext, Ls, B, n, 0, stream);
    if (err != 0) return err;
    return by_logn_wide<ExtNttLaunch<kStagedSrc>::F>(
        logn, threads, smem, nb, stream, lift, out, ext, tw, tw_sh, Ls, Ld,
        B);
  }
  switch (Ls) {
    case 2:
      return by_logn_wide<ExtNttLaunch<2>::F>(logn, threads, smem, nb, stream,
                                              x, out, ext, tw, tw_sh, Ls, Ld,
                                              B);
    case 4:
      return by_logn_wide<ExtNttLaunch<4>::F>(logn, threads, smem, nb, stream,
                                              x, out, ext, tw, tw_sh, Ls, Ld,
                                              B);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
