// K6: the Hopper kernel of the degree-2 tensor of coefficient-domain
// ciphertexts,
//   fhe_tensor_mul4 <- fhe_study_tpu/ops/ntt_pallas.py::tensor_mul4_u32
//                      (_tensor4_kernel), and through operand strides
//                      tensor_mul_u32 (_tensor_kernel_multi)
// (x0 y0, x0 y1 + x1 y0, x1 y1) = INTT(NTT(x_i) * NTT(y_j)) times scale,
// with the optional unsigned HPS conversion src -> dst of every operand on
// its way in (the BFV tensor over P from ciphertexts over Q): from 4 source
// primes each word is converted in the first pass (ext_coeff<4>); from any
// other count the entry first runs the lift (csrc/ext.cuh's
// ext_lift_kernel, one launch for the four operands, on the same stream and
// counted as one with the kernel's) into a scratch of each operand's y_i and
// alpha, and the staged form forms each word's sum from those rows
// (ext_from_lift of modarith.cuh: the sources in the outer loop, 16
// independent loads an iteration), so no block recomputes the y_i and alpha
// that the Ld destination blocks of a polynomial share.
//
// Layout: one block per (dst prime, polynomial), the prime fastest so that
// the blocks converting one polynomial's source rows run side by side and
// share them in L2.  Seven transforms on the register-resident chain of
// radix_chain.cuh in one launch, with every evaluation-domain value on chip.
// Four operands each enter two products, so three n-word buffers must be
// live (192 KB at n = 2^14: one block an SM); the block runs 512 threads,
// two virtual threads each at n = 2^14, with up to 128 registers a thread.
// At n = 2^15 (384 KB) a cluster of two such blocks takes each (dst prime,
// polynomial), block r holding the elements whose top bit is r
// (radix_chain.cuh's Split).  Over the destination basis the first pass
// reads a virtual thread's 16 words of both halves of the operand row (32
// loads in flight, split_words) and forms the first forward stage and pass
// 0 in registers; with a source basis each block converts only the words
// of its own half (half the conversion and half the lift's reads through
// L2) and the first stage runs in place across the cluster, each block half
// of the pairs through distributed shared memory (split_top_stage), between
// two cluster barriers.  The chain of the half runs from there as below,
// with x0's words of the second group of virtual threads kept in 32 KB of
// shared memory beside the buffers (224 KB a block: 128 registers hold only
// one group beside x1's chain), no barrier after a forward chain's last pass
// (a thread alone reads its words again), and the last inverse stage by
// pairs, each block half of them with the peer's words through distributed
// shared memory, both elements of a pair stored (split_inverse_out).  Its
// phases are measured by utils/ks_phases.py --k6.
//   1. the forward chains of y0, y1 and x0 into buffers 0, 1, 2, and of x1
//      into buffer 2 but for its last pass, one operand after another in a
//      run-time loop (one copy of the chain's code); the first pass reads
//      the operand row (strided views allowed) with lanes on consecutive
//      words, or with a source basis its conversion (ext_coeff<4>, or the
//      sums over the lift's rows);
//   2. before x1 enters buffer 2, each thread takes its own 16 words a
//      virtual thread of x0's transform into registers;
//   3. x1's last pass holds bits 0..3, as the inverse chain's first pass
//      does, so a thread owns the same 16 elements in both: it forms x1 y1,
//      x0 y1 + x1 y0 and x0 y0 one after another as Montgomery products (a
//      factor 2^-32 each) from its registers and its own words of buffers 0
//      and 1, runs the first inverse pass on each in registers and stores it
//      into buffer 2, 1 or 0 at the same words (no other thread touches them
//      in that pass): the products need no exchange through shared memory;
//   4. the remaining inverse passes on the three buffers, the last times
//      n^-1 * 2^32 * scale, stored with lanes on consecutive words of the
//      [Ld, B, 3, n] output.
// Carrying x0 (16 words a virtual thread) rather than x0 y0 and x0 y1 (32)
// across x1's chain does the same four products in half the registers.  The
// code is kept short on purpose: on an H100 the same schedule with the three
// chains side by side in registers (sharing each twiddle load, but with
// much longer code) ran slower and took minutes to build (PERF.md).
// What bounds it: 7 words a coefficient through device memory (more with a
// source basis) against 7 log n / 2 butterflies of 13 instructions and the
// products: the issue rate.  With one block an SM no other block hides its
// barriers.
//
// The kernel template is in csrc/tensor_mul4.cuh; this unit instantiates it
// without a source basis and from 4 source primes, csrc/
// tensor_mul4_staged_cuda.cu its staged form (so that the two parts of the
// 27 instances compile in parallel), n = 2^7 .. 2^15.  Past 2^15 the entry
// queues the chunked form of csrc/tensor_mul4_chunks_cuda.cu: the forwards
// through an eval scratch in device memory, the products and inverses on
// K2's chunked schedule.  The entry launches on
// the given stream and returns cudaGetLastError(); a refused launch never
// runs, so the caller raises.

#include <climits>
#include <cstdint>

#include "tensor_mul4.cuh"

using namespace fhe;

// Ls = 0: the operands are [Ld, B, n] rows over dst; Ls = 1 .. 31: [Ls, B,
// n] rows over src, converted on the way in: from 4 in the kernel (lift
// null), from any count staged (lift: a scratch of 4 (Ls + 1) B n words,
// which ext_lift fills with each operand's Ls + 1 rows and the kernel then
// reads; ops/ntt_cuda.py::lift_plan decides the form).  Past n = 2^15
// (csrc/tensor_mul4_chunks_cuda.cu) tmp is the eval scratch of 4 Ld B n
// words (16-byte aligned), tw / tw_sh and twinv / twinv_sh the chunk
// tables and threads and smem a chunk's; below it tmp is not read.
extern "C" int fhe_tensor_mul4(const uint32_t* x0, const uint32_t* x1,
                               const uint32_t* y0, const uint32_t* y1,
                               long long sl0, long long sb0, long long sl1,
                               long long sb1, long long sl2, long long sb2,
                               long long sl3, long long sb3, uint32_t* lift,
                               uint32_t* tmp, uint32_t* out,
                               const uint32_t* ext, const uint32_t* tw,
                               const uint32_t* tw_sh, const uint32_t* twinv,
                               const uint32_t* twinv_sh, const uint32_t* cons,
                               int Ls, int Ld, int B, int logn, int threads,
                               int smem, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(Ld) * B;
  if (Ls < 0 || Ls > kMaxSrc || Ld < 1 || B < 1 || blocks > INT_MAX ||
      logn < 7) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides st{{sl0, sl1, sl2, sl3}, {sb0, sb1, sb2, sb3}};
  if (logn > kWideLogN) {
    return tensor_mul4_chunked({x0, x1, y0, y1}, st, lift, tmp, out, ext, tw,
                               tw_sh, twinv, twinv_sh, cons, Ls, Ld, B, logn,
                               threads, smem, stream);
  }
  const int nb = static_cast<int>(blocks);
  if (Ls > 0 && lift != nullptr) {
    const int n = 1 << logn;
    const LiftIn in{{x0, x1, y0, y1}, {sl0, sl1, sl2, sl3},
                    {sb0, sb1, sb2, sb3}};
    const int err = ext_lift(in, 4, lift, ext, Ls, B, n, 0, stream);
    if (err != 0) return err;
    // operand o's lift rows: (Ls + 1) B n words from lift + o (Ls + 1) B n
    const long long total = static_cast<long long>(B) * n;
    const long long blk = (Ls + 1) * total;
    const Strides ls{{total, total, total, total}, {n, n, n, n}};
    return tensor_mul4_staged(logn, threads, smem, nb, stream, lift,
                               lift + blk, lift + 2 * blk, lift + 3 * blk, ls,
                               out, ext, tw, tw_sh, twinv, twinv_sh, cons, Ls,
                               Ld, B);
  }
  switch (Ls) {
    case 0:
      return by_logn_wide<TensorMul4Launch<kNoSrc>>(
          logn, threads, smem, nb, stream, x0, x1, y0, y1, st, out, ext, tw,
          tw_sh, twinv, twinv_sh, cons, Ls, Ld, B);
    case 4:
      return by_logn_wide<TensorMul4Launch<4>>(
          logn, threads, smem, nb, stream, x0, x1, y0, y1, st, out, ext, tw,
          tw_sh, twinv, twinv_sh, cons, Ls, Ld, B);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
