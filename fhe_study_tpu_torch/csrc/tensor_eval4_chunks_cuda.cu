// K2 tensor_eval4 past one block's polynomial, n = 2^16 .. 2^26 — with
// csrc/ntt_cuda.cu, fhe_study_tpu/ops/ntt_pallas.py::tensor_eval4_u32 —
// on the chunked schedule of csrc/ntt_chunks.cuh, called by
// fhe_tensor_eval4.  Its own translation unit, so that its chain of 2^15
// words compiles beside the others.  Two launches and the top passes, all
// queued by the one C call on the caller's stream:
//
//   chunk chains  one block per (prime, polynomial, product, chunk of 2^15
//                 words): csrc/tensor_eval4.cuh's block, its products formed
//                 in the first inverse pass from the four operand chunks
//                 (strided views, uint4 where aligned), the chain under the
//                 chunk's row of the inverse chunk tables, the words into
//                 out without the final multiplier;
//   top passes    the inverse's top passes in place over the 3 Ld B output
//                 polynomials (ntt_top_kernel: each thread reads and writes
//                 its own words), from bit 2^15 up; the last multiplies by
//                 n^-1 * 2^32 * scale.
//
// What bounds it: the one-block form's butterflies and products
// (csrc/ntt_cuda.cu), beside the top passes' round trips of the output
// through device memory (8 bytes a word each: one pass to 2^19, two to
// 2^23, three to 2^26).

#include <climits>
#include <cstdint>

#include "modarith.cuh"
#include "ntt_chunks.cuh"
#include "radix_chain.cuh"
#include "tensor_eval4.cuh"

namespace fhe {
namespace {

__global__ void __launch_bounds__(OneBuffer<kChunkLogN>::threads,
                                  OneBuffer<kChunkLogN>::blocks)
tensor_eval4_chunk_kernel(const uint32_t* __restrict__ x0,
                          const uint32_t* __restrict__ x1,
                          const uint32_t* __restrict__ y0,
                          const uint32_t* __restrict__ y1, Strides st,
                          uint32_t* __restrict__ out,
                          const uint32_t* __restrict__ twinv,
                          const uint32_t* __restrict__ twinv_sh,
                          const uint32_t* __restrict__ cons, int B, int s,
                          int vec) {
  tensor_eval4_rows<kChunkLogN>(x0, x1, y0, y1, st, out, twinv, twinv_sh,
                                cons, B, s, 0, vec);
}

}  // namespace

// out [Ld, B, 3, n]; twinv / twinv_sh the inverse chunk tables [Ld, 2^s,
// 2^15]; cons's fin n^-1 * 2^32 * scale; threads and smem a chunk's
// one-buffer shape, refused otherwise.
int tensor_eval4_chunked(const uint32_t* x0, const uint32_t* x1,
                         const uint32_t* y0, const uint32_t* y1, Strides st,
                         uint32_t* out, const uint32_t* twinv,
                         const uint32_t* twinv_sh, const uint32_t* cons,
                         int Ld, int B, int logn, int threads, int smem,
                         int vec, cudaStream_t stream) {
  if (Ld < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int shape = chunked_shape(logn, threads, smem);
  if (shape != 0) return shape;
  const int s = logn - kChunkLogN;
  const long long polys = 3LL * Ld * B;
  if ((polys << s) > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_smem(&tensor_eval4_chunk_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  tensor_eval4_chunk_kernel<<<static_cast<unsigned>(polys << s), threads,
                              smem, stream>>>(x0, x1, y0, y1, st, out, twinv,
                                              twinv_sh, cons, B, s, vec);
  int err = static_cast<int>(cudaGetLastError());
  for (int t = top_passes(logn) - 1; t >= 0 && err == 0; --t) {
    err = top_launch<true>(top_bits(logn, t), out, out, twinv, twinv_sh,
                           cons, polys, 3 * B, Ld, logn, top_lo(logn, t),
                           t == 0 ? 1 : 0, stream);
  }
  return err;
}

}  // namespace fhe
