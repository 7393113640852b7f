// K6 tensor_mul4 (and on the stacked operand's row strides, tensor_mul)
// past one block's polynomial, n = 2^16 .. 2^26 — with csrc/
// tensor_mul4_cuda.cu, fhe_study_tpu/ops/ntt_pallas.py::tensor_mul4_u32
// and tensor_mul_u32 — on the chunked schedule of csrc/ntt_chunks.cuh,
// called by fhe_tensor_mul4.  Past 2^15 no block holds the three buffers of
// the one-block form (csrc/tensor_mul4.cuh), so the four forward
// transforms go through a 32-bit eval-domain scratch in device memory, and
// the products and the three inverses are K2's chunked form.  Queued by the
// one C call on the caller's stream:
//
//   lift          from a source count without a direct instance, the lift
//                 of the four operands (ext_lift, csrc/ext.cuh) into its
//                 scratch, one launch, as at 2^15;
//   first tops    for each operand, the forward's first top pass over its
//                 Ld B destination polynomials into its quarter of the
//                 scratch tmp [4, Ld, B, n] (csrc/first_top.cuh): the word
//                 of the operand row (strided views), or its extension from
//                 4 source rows direct or from the lift's rows, as K5's
//                 chunked form does;
//   top passes    the forward's others, in place over all 4 Ld B
//                 polynomials of tmp (ntt_top_kernel);
//   chunk chains  the forward's, one block a chunk of 2^15 words, in place
//                 in tmp (ntt_chunk_kernel: a block reads all its words
//                 before it writes any): tmp then holds NTT(x0), NTT(x1),
//                 NTT(y0), NTT(y1);
//   K2            tensor_eval4_chunked (csrc/tensor_eval4_chunks_cuda.cu) on
//                 the four quarters: the three products formed in the first
//                 inverse pass of the chunk chains, into out, then the
//                 inverse top passes in place in out, the last times
//                 n^-1 * 2^32 * scale.
//
// What bounds it: the seven transforms' butterflies and the products (and
// the conversion with a source basis), as at 2^15, beside device memory:
// the top passes' round trips of each of the seven transforms (8 bytes a
// word each: one pass to 2^19, two to 2^23, three to 2^26) and the eval
// scratch's (each of the four transforms written once and read once by
// the products).

#include <climits>
#include <cstdint>

#include "first_top.cuh"
#include "modarith.cuh"
#include "ntt_chunks.cuh"
#include "radix_chain.cuh"
#include "tensor_eval4.cuh"
#include "tensor_mul4.cuh"

namespace fhe {

// K6 past one block: ops the four operands x0, x1, y0, y1 (row (p, b) of
// operand o at ops[o] + p st.l[o] + b st.b[o]: [Ld, B, n] over dst without a
// source basis, Ls = 0; [Ls, B, n] over src with one); lift null (Ls = 0 or
// 4, direct) or the lift's scratch of 4 (Ls + 1) B n words; tmp the eval
// scratch of 4 Ld B n words (16-byte aligned); out [Ld, B, 3, n]; tw / tw_sh
// and twinv / twinv_sh the forward and inverse chunk tables [Ld, 2^s, 2^15];
// cons's fin n^-1 * 2^32 * scale; threads and smem a chunk's one-buffer
// shape, refused otherwise.
int tensor_mul4_chunked(const uint32_t* const (&ops)[4], const Strides& st,
                        uint32_t* lift, uint32_t* tmp, uint32_t* out,
                        const uint32_t* ext, const uint32_t* tw,
                        const uint32_t* tw_sh, const uint32_t* twinv,
                        const uint32_t* twinv_sh, const uint32_t* cons,
                        int Ls, int Ld, int B, int logn, int threads,
                        int smem, cudaStream_t stream) {
  int err = tmp == nullptr || misaligned(tmp)
                ? static_cast<int>(cudaErrorInvalidValue)
                : chunked_shape(logn, threads, smem);
  const int s = logn - kChunkLogN;
  const long long n = 1LL << logn;
  const long long polys = 4LL * Ld * B;      // those of the scratch
  if (err == 0 && (polys << s) > INT_MAX) {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  const bool staged = Ls > 0 && lift != nullptr;
  if (err == 0 && !staged && Ls != 0 && Ls != 4) {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err == 0 && staged) {
    const LiftIn in{{ops[0], ops[1], ops[2], ops[3]},
                    {st.l[0], st.l[1], st.l[2], st.l[3]},
                    {st.b[0], st.b[1], st.b[2], st.b[3]}};
    err = ext_lift(in, 4, lift, ext, Ls, B, static_cast<int>(n), 0, stream);
  }
  for (int o = 0; o < 4 && err == 0; ++o) {
    uint32_t* e = tmp + o * Ld * B * n;
    if (staged) {
      // operand o's lift rows: (Ls + 1) B n words from lift + o (Ls + 1) B n
      err = first_top_launch<kStagedSrc>(lift + o * (Ls + 1) * B * n, B * n,
                                         n, e, ext, tw, tw_sh, cons, Ls, Ld,
                                         B, logn, 0, stream);
    } else if (Ls == 4) {
      err = first_top_launch<4>(ops[o], st.l[o], st.b[o], e, ext, tw, tw_sh,
                                cons, Ls, Ld, B, logn, 0, stream);
    } else {
      err = first_top_launch<kPlainSrc>(ops[o], st.l[o], st.b[o], e, nullptr,
                                        tw, tw_sh, cons, Ls, Ld, B, logn, 0,
                                        stream);
    }
  }
  if (err == 0) {
    err = other_tops(tmp, tw, tw_sh, cons, polys, B, Ld, logn, stream);
  }
  if (err == 0) {
    err = chunk_launch<0>(static_cast<const uint32_t*>(tmp), tmp, tw, tw_sh,
                          cons, polys, B, Ld, s, 0, 1, threads, smem, stream);
  }
  if (err == 0) {
    const long long quarter = Ld * B * n;    // one operand's words
    const Strides es{{B * n, B * n, B * n, B * n}, {n, n, n, n}};
    err = tensor_eval4_chunked(tmp, tmp + quarter, tmp + 2 * quarter,
                               tmp + 3 * quarter, es,
                               out, twinv, twinv_sh, cons, Ld, B, logn,
                               threads, smem, 1, stream);
  }
  return err;
}

}  // namespace fhe
