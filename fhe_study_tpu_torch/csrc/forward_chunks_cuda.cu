// K5 ext_ntt and K12 ntt_smem_ceiling past one block's polynomial, n =
// 2^16 .. 2^26 — with csrc/ext_ntt_cuda.cu and csrc/bench_cuda.cu,
// fhe_study_tpu/ops/ntt_pallas.py::ext_ntt_u32 and fhe_study_tpu/ops/
// vpu_bench.py::ntt_vmem_ceiling — on the forward chunked schedule of
// csrc/ntt_chunks.cuh, called by fhe_ext_ntt and fhe_ntt_smem_ceiling.
// The two share the forward's chunk chain of 2^15 words and its top
// passes, compiled here once, beside the other units.
//
// K5, queued by the one C call on the caller's stream:
//   lift          from a source count without a direct instance, the lift
//                 (ext_lift, csrc/ext.cuh) into its scratch, as at 2^15;
//   first top     the forward's first top pass over each destination
//                 polynomial (prime p, polynomial b) of tmp [Ld, B, n]: each
//                 thread forms its 2^K words as extension sums, from the
//                 source rows (2 and 4 sources: ext_coeff<LS>, the y_i in
//                 registers) or from the lift's rows (ext_from_lift, the
//                 block's table column in shared memory), as K10's grid
//                 layout forms its digits there (csrc/blind_rotate_grid_
//                 cuda.cu), then its stages;
//   top passes    the others, in place in tmp (ntt_top_kernel);
//   chunk chains  one block a chunk of 2^15 words from tmp into out
//                 (ntt_chunk_kernel, K1's chain): the extended coefficients
//                 exist only in the 32-bit scratch.
// K12: `reps` forward transforms of [B, n], each its top passes from x (the
// first) or out into tmp and its chunk chains from tmp into out, all
// queued by the one C call; reps = 0 copies x.  Past 2^15 no block holds
// the polynomial, so its rate is the ceiling of the chunked schedule, not
// of a resident chain.
//
// What bounds them: the butterflies (and K5's conversion sums, as at
// 2^15), beside the top passes' round trips through device memory (8
// bytes a word each: one pass to 2^19, two to 2^23, three to 2^26; K12's
// every transform also reads and writes its polynomial once).

#include <climits>
#include <cstdint>

#include "modarith.cuh"
#include "ntt_chunks.cuh"
#include "radix_chain.cuh"

namespace fhe {
namespace {

// K5's first top pass over bits [lo, lo + K) of destination polynomial
// p B + b of tmp [Ld, B, n] (K = top_bits(logn, 0)): x the source rows
// [LS, B, n] (direct) or the lift's rows [Ls + 1, B, n] (LS = kStagedSrc);
// ext the conversion's packed table; tw / tw_sh the forward chunk tables
// [Ld, 2^s, 2^15].  The blocks of one polynomial b run p fastest, as the
// one-block form's do, so that the Ld destination primes' blocks read its
// source (or lift) rows side by side, from L2 after the first.
template <int K, int LS>
__global__ void __launch_bounds__(kTopThreads)
ext_top_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ tmp,
               const uint32_t* __restrict__ ext,
               const uint32_t* __restrict__ tw,
               const uint32_t* __restrict__ tw_sh, int Ls, int Ld, int B,
               int logn, int lo) {
  __shared__ uint32_t column[LS == kStagedSrc ? 2 * kMaxSrc + 2 : 1];
  const int per = (1 << (logn - K)) / kTopThreads;
  const int bp = blockIdx.x / per;           // b * Ld + p
  const int v = (blockIdx.x - bp * per) * kTopThreads + threadIdx.x;
  const int b = bp / Ld;
  const int p = bp - b * Ld;
  const int poly = p * B + b;
  const ExtTable e{ext, LS != kStagedSrc ? LS : Ls, Ld};
  const uint32_t q = e.dst(p, 0);
  const size_t n = static_cast<size_t>(1) << logn;
  const int base = top_base(v, lo, K);
  const uint32_t* row = x + b * n;
  const size_t stride = static_cast<size_t>(B) * n;
  uint32_t r[1 << K];
  if constexpr (LS == kStagedSrc) {
    stage_column(column, e, p);
    __syncthreads();
    ext_from_lift(r, row, stride, column, Ls, q,
                  [&](int k) { return base + (k << lo); });
  } else {
#pragma unroll
    for (int k = 0; k < (1 << K); ++k) {
      r[k] = ext_coeff<LS>(row + base + (k << lo), stride, e, p);
    }
  }
  top_stages<K, false>(r, base, lo, logn, tw + p * n, tw_sh + p * n, q);
  uint32_t* o = tmp + poly * n + base;
#pragma unroll
  for (int k = 0; k < (1 << K); ++k) o[static_cast<size_t>(k) << lo] = r[k];
}

template <int LS>
struct ExtTop {
  template <int K>
  static auto kernel() { return &ext_top_kernel<K, LS>; }
};

}  // namespace

// K5 past one block: x [Ls, B, n]; lift null (Ls = 2 or 4, direct) or the
// lift's scratch of (Ls + 1) B n words; tmp a scratch of Ld B n words
// (16-byte aligned); tw / tw_sh the forward chunk tables [Ld, 2^s, 2^15]
// and cons their primes' rows; threads and smem a chunk's shape.
int ext_ntt_chunked(const uint32_t* x, uint32_t* lift, uint32_t* tmp,
                    uint32_t* out, const uint32_t* ext, const uint32_t* tw,
                    const uint32_t* tw_sh, const uint32_t* cons, int Ls,
                    int Ld, int B, int logn, int threads, int smem,
                    cudaStream_t stream) {
  int err = tmp == nullptr || misaligned(tmp) || misaligned(out)
                ? static_cast<int>(cudaErrorInvalidValue)
                : chunked_shape(logn, threads, smem);
  const int s = logn - kChunkLogN;
  const long long polys = static_cast<long long>(Ld) * B;
  if (err == 0 && (polys << s) > INT_MAX) {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err == 0 && lift != nullptr) {
    err = ext_lift(lift_in(x, B, 1 << logn), 1, lift, ext, Ls, B, 1 << logn,
                   0, stream);
  }
  if (err == 0) {
    const int K = top_bits(logn, 0), lo = top_lo(logn, 0);
    const long long blocks = top_blocks(polys, logn, K);
    if (lift != nullptr) {
      err = top_pass_launch<ExtTop<kStagedSrc>>(K, blocks, stream, lift, tmp,
                                                ext, tw, tw_sh, Ls, Ld, B,
                                                logn, lo);
    } else if (Ls == 2) {
      err = top_pass_launch<ExtTop<2>>(K, blocks, stream, x, tmp, ext, tw,
                                       tw_sh, Ls, Ld, B, logn, lo);
    } else if (Ls == 4) {
      err = top_pass_launch<ExtTop<4>>(K, blocks, stream, x, tmp, ext, tw,
                                       tw_sh, Ls, Ld, B, logn, lo);
    } else {
      err = static_cast<int>(cudaErrorInvalidValue);
    }
  }
  for (int t = 1; t < top_passes(logn) && err == 0; ++t) {
    err = top_launch<false>(top_bits(logn, t), tmp, tmp, tw, tw_sh, cons,
                            polys, B, Ld, logn, top_lo(logn, t), 0, stream);
  }
  if (err == 0) {
    err = chunk_launch<0>(static_cast<const uint32_t*>(tmp), out, tw, tw_sh,
                          cons, polys, B, Ld, s, 0, 1, threads, smem,
                          stream);
  }
  return err;
}

// K12 past one block: `reps` forward transforms of x [B, n] under the one
// prime of cons into out, through tmp (B n words, 16-byte aligned); tw /
// tw_sh the forward chunk tables [1, 2^s, 2^15].
int ntt_smem_ceiling_chunked(const uint32_t* x, uint32_t* out, uint32_t* tmp,
                             const uint32_t* tw, const uint32_t* tw_sh,
                             const uint32_t* cons, int B, int logn, int reps,
                             int threads, int smem, cudaStream_t stream) {
  int err = tmp == nullptr || misaligned(tmp)
                ? static_cast<int>(cudaErrorInvalidValue)
                : chunked_shape(logn, threads, smem);
  if (err == 0 && reps == 0) {
    err = static_cast<int>(cudaMemcpyAsync(
        out, x, (sizeof(uint32_t) * B) << logn, cudaMemcpyDeviceToDevice,
        stream));
  }
  for (int i = 0; i < reps && err == 0; ++i) {
    err = chunked_forward(i == 0 ? x : out, out, tmp, tw, tw_sh, cons, 1, B,
                          logn, 0, threads, smem, stream);
  }
  return err;
}

// Blocks of the chunk chain an SM holds at its shape (K12's ceiling on the
// whole card past one block).
int ntt_chunk_resident(int* per_sm) {
  using S = typename OneBuffer<kChunkLogN>::Shape;
  const int smem = S::n * static_cast<int>(sizeof(uint32_t));
  auto kernel = &ntt_chunk_kernel<0, uint32_t, uint32_t>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kernel, S::threads, smem));
}

}  // namespace fhe
