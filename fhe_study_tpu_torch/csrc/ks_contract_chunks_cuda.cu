// K3 ks_contract past one block's polynomial, n = 2^16 .. 2^26 — with
// csrc/ks_contract_cuda.cu, fhe_study_tpu/ops/ntt_pallas.py::
// ks_contract_u32 — on the chunked schedule of csrc/ntt_chunks.cuh, called
// by fhe_ks_contract.  Its own translation unit, so that its chain of 2^15
// words compiles beside the others.  Queued by the one C call on the
// caller's stream:
//
//   chunk chains  one block per (prime, polynomial, key half, chunk of 2^15
//                 words): csrc/ks_contract.cuh's block, the R-term
//                 Montgomery contraction of the digit rows' chunk against
//                 the key rows' chunk in the first inverse pass (uint4 or
//                 word by word, by vec), as K10's grid layout contracts in
//                 its chunk chains (csrc/blind_rotate_grid_cuda.cu), the
//                 chain under the chunk's row of the inverse chunk tables,
//                 the words into out without n^-1;
//   top passes    the inverse's top passes in place over the 2 Lp B output
//                 polynomials (ntt_top_kernel), from bit 2^15 up; the last
//                 multiplies by n^-1.
//
// What bounds it: the one-block form's butterflies and products
// (csrc/ks_contract_cuda.cu), beside the top passes' round trips of the
// output through device memory (8 bytes a word each).

#include <climits>
#include <cstdint>

#include "ks_contract.cuh"
#include "modarith.cuh"
#include "ntt_chunks.cuh"
#include "radix_chain.cuh"

namespace fhe {
namespace {

__global__ void __launch_bounds__(OneBuffer<kChunkLogN>::threads,
                                  OneBuffer<kChunkLogN>::blocks)
ks_contract_chunk_kernel(const uint32_t* __restrict__ edm,
                         const uint32_t* __restrict__ kb,
                         const uint32_t* __restrict__ ka,
                         uint32_t* __restrict__ out,
                         const uint32_t* __restrict__ twinv,
                         const uint32_t* __restrict__ twinv_sh,
                         const uint32_t* __restrict__ cons, int R, int Lp,
                         int B, int s, int vec) {
  ks_contract_rows<kChunkLogN>(edm, kb, ka, out, twinv, twinv_sh, cons, R,
                               Lp, B, s, 0, vec);
}

}  // namespace

// out [2, Lp, B, n]; twinv / twinv_sh the inverse chunk tables [Lp, 2^s,
// 2^15]; cons's fin n^-1; threads and smem a chunk's one-buffer shape,
// refused otherwise.
int ks_contract_chunked(const uint32_t* edm, const uint32_t* kb,
                        const uint32_t* ka, uint32_t* out,
                        const uint32_t* twinv, const uint32_t* twinv_sh,
                        const uint32_t* cons, int R, int Lp, int B, int logn,
                        int vec, int threads, int smem, cudaStream_t stream) {
  const int shape = chunked_shape(logn, threads, smem);
  if (shape != 0) return shape;
  const int s = logn - kChunkLogN;
  const long long polys = 2LL * Lp * B;
  if ((polys << s) > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_smem(&ks_contract_chunk_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ks_contract_chunk_kernel<<<static_cast<unsigned>(polys << s), threads,
                             smem, stream>>>(edm, kb, ka, out, twinv,
                                             twinv_sh, cons, R, Lp, B, s,
                                             vec);
  int err = static_cast<int>(cudaGetLastError());
  for (int t = top_passes(logn) - 1; t >= 0 && err == 0; --t) {
    err = top_launch<true>(top_bits(logn, t), out, out, twinv, twinv_sh,
                           cons, polys, B, Lp, logn, top_lo(logn, t),
                           t == 0 ? 1 : 0, stream);
  }
  return err;
}

}  // namespace fhe
