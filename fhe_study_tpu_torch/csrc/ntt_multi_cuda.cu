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
// 8 threads at 2^7, 512 threads and one block an SM at 2^15), and n =
// 2^16 .. 2^26 across blocks (ntt_chunks.cuh: top passes through device
// memory, then one block a chunk of 2^15 words on the same chain).
//
// Each entry launches on the given stream and returns cudaGetLastError(); a
// refused launch never runs, so the caller raises.

#include <climits>
#include <cstdint>

#include "modarith.cuh"
#include "ntt_chunks.cuh"
#include "radix_chain.cuh"

namespace fhe {
namespace {

template <int LOGN, int INV>
__global__ void __launch_bounds__(OneBuffer<LOGN>::threads,
                                  OneBuffer<LOGN>::blocks)
ntt_multi_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 const uint32_t* __restrict__ tw,
                 const uint32_t* __restrict__ tw_sh,
                 const uint32_t* __restrict__ cons, int L, int B,
                 int use_fin, int vec) {
  ntt_rows<LOGN, INV>(x, out, tw, tw_sh, cons, B, L, 0, use_fin, vec);
}

template <int LOGN, int INV>
__global__ void __launch_bounds__(OneBuffer<LOGN>::threads,
                                  OneBuffer<LOGN>::blocks)
ntt_kernel(const long long* __restrict__ x, long long* __restrict__ out,
           const uint32_t* __restrict__ tw,
           const uint32_t* __restrict__ tw_sh,
           const uint32_t* __restrict__ cons, int B, int vec) {
  ntt_rows<LOGN, INV>(x, out, tw, tw_sh, cons, B, 1, 0, INV, vec);
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
// forward's read-out always stores uint4 rows (out 16-byte aligned).  Past
// n = 2^kChunkLogN the transform runs across blocks (ntt_chunks.cuh's
// ntt_chunked): tw / tw_sh are then the chunk tables, threads and smem a
// chunk's, and tmp a scratch of L B n 32-bit words (16-byte aligned);
// below it tmp is not read.
extern "C" int fhe_ntt_multi(const uint32_t* x, uint32_t* out, uint32_t* tmp,
                             const uint32_t* tw, const uint32_t* tw_sh,
                             const uint32_t* cons, int L, int B, int logn,
                             int inverse, int use_fin, int vec, int threads,
                             int smem, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(L) * B;
  if (L < 1 || B < 1 || blocks > INT_MAX || misaligned(out) ||
      (vec && misaligned(x))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (logn > kChunkLogN) {
    return ntt_chunked(x, out, tmp, tw, tw_sh, cons, L, B, logn, inverse,
                       use_fin, vec, threads, smem, stream);
  }
  const int nb = static_cast<int>(blocks);
  if (inverse) {
    return by_logn_wide<NttMultiLaunch<1>>(logn, threads, smem, nb, stream,
                                           x, out, tw, tw_sh, cons, L, B,
                                           use_fin, vec);
  }
  return by_logn_wide<NttMultiLaunch<0>>(logn, threads, smem, nb, stream, x,
                                         out, tw, tw_sh, cons, L, B, use_fin,
                                         vec);
}

// K9 on [B, n] int64 words under the one prime of cons (its fin n^-1 for
// the inverse); vec and tmp (B n 32-bit words past 2^kChunkLogN) as for
// fhe_ntt_multi.
extern "C" int fhe_ntt(const long long* x, long long* out, uint32_t* tmp,
                       const uint32_t* tw, const uint32_t* tw_sh,
                       const uint32_t* cons, int B, int logn, int inverse,
                       int vec, int threads, int smem, cudaStream_t stream) {
  if (B < 1 || misaligned(out) || (vec && misaligned(x))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (logn > kChunkLogN) {
    return ntt_chunked(x, out, tmp, tw, tw_sh, cons, 1, B, logn, inverse,
                       inverse, vec, threads, smem, stream);
  }
  if (inverse) {
    return by_logn_wide<NttLaunch<1>>(logn, threads, smem, B, stream, x, out,
                                      tw, tw_sh, cons, B, vec);
  }
  return by_logn_wide<NttLaunch<0>>(logn, threads, smem, B, stream, x, out, tw,
                                    tw_sh, cons, B, vec);
}
