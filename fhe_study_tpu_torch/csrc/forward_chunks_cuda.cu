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
//                 polynomial (prime p, polynomial b) of tmp [Ld, B, n]
//                 (csrc/first_top.cuh): each thread forms its 2^K words as
//                 extension sums, from the source rows (2 and 4 sources:
//                 ext_coeff<LS>, the y_i in registers) or from the lift's
//                 rows (ext_from_lift, the block's table column in shared
//                 memory), then its stages;
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

#include "first_top.cuh"
#include "modarith.cuh"
#include "ntt_chunks.cuh"
#include "radix_chain.cuh"

namespace fhe {

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
  // the source rows [Ls, B, n] (direct) or the lift's [Ls + 1, B, n]
  const long long sl = static_cast<long long>(B) << logn, sb = 1LL << logn;
  if (err == 0) {
    if (lift != nullptr) {
      err = first_top_launch<kStagedSrc>(lift, sl, sb, tmp, ext, tw, tw_sh,
                                         cons, Ls, Ld, B, logn, 0, stream);
    } else if (Ls == 2) {
      err = first_top_launch<2>(x, sl, sb, tmp, ext, tw, tw_sh, cons, Ls, Ld,
                                B, logn, 0, stream);
    } else if (Ls == 4) {
      err = first_top_launch<4>(x, sl, sb, tmp, ext, tw, tw_sh, cons, Ls, Ld,
                                B, logn, 0, stream);
    } else {
      err = static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (err == 0) {
    err = other_tops(tmp, tw, tw_sh, cons, polys, B, Ld, logn, stream);
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
