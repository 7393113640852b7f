// K7 ks_fused and K8 ks_fused_eval: the kernel templates of the gadget key
// switch from limb residues, shared by the two translation units that
// instantiate them (csrc/ks_fused_cuda.cu: K7, csrc/ks_fused_eval_cuda.cu:
// K8), so that their instances compile in parallel.
//   fhe_ks_fused      <- fhe_study_tpu/ops/ntt_pallas.py::ks_fused_u32
//                        (_ks_kernel_multi, fwd=True)
//   fhe_ks_fused_eval <- ntt_pallas.py::ks_fused_eval_u32 (_ks_eval_kernel)
// For prime p and polynomial b: d_r = limb r of b reduced mod p by `reps`
// conditional subtractions (the reference's count: reps covers max(src) /
// min(primes)); acc_h = sum_r NTT(d_r) * key_h[r, p] for the two key halves
// (h = 0: kb, 1: ka) as Montgomery products, a factor 2^-32 each.  K7
// returns INTT(acc_h) times fin = n^-1 * 2^32, [2, Lp, B, n]; K8 returns
// e_h = acc_h * 2^32 + NTT(add_h) in the eval domain and INTT(e_h) times
// n^-1, [4, Lp, B, n] = (e0, e1, r0, r1).  The order of operations is the
// reference's, so every word equals the plain versions'.  These kernels take
// n = 2^7 .. 2^15; past 2^15 the entries queue the chunked form of
// csrc/ks_fused_chunks_cuda.cu (the same accumulation, the two sums in
// device memory).
//
// Layout: K6's (csrc/tensor_mul4.cuh).  One block per (prime, polynomial),
// the prime fastest so that the Lp blocks reading one polynomial's R limbs
// run side by side and share them in L2; 512 threads of up to 128
// registers, three n-word buffers in shared memory (the work buffer and the
// two accumulators: 192 KB at n = 2^14, one block an SM).  At n = 2^15 a
// cluster of two such blocks per (prime, polynomial), each holding one half
// of the three buffers (radix_chain.cuh's Split): the first
// forward stage formed by each block for its half from both halves of
// each row in the first pass (split_words: a virtual thread's 32 words
// issued before any reduction), the end of a row an arrival on a
// shared-memory barrier that the next row's first pass waits on only
// before its first store, and the last inverse stage across the cluster
// straight to the outputs (split_inverse_out: each block half of the
// pairs, one word through distributed shared memory, eight in flight).
//   1. each digit row r runs the register-resident forward chain of
//      radix_chain.cuh in the work buffer.  Its first pass reads limb r with
//      lanes on consecutive words and makes the subtractions in registers;
//      its last pass (bits 0..3: 16 contiguous elements a virtual thread)
//      multiplies them by kb[r, p] and ka[r, p] (uint4 words when both are
//      16-byte aligned) and adds the products into the two accumulators at
//      the thread's own swizzled words, which row 0 writes instead of
//      reading.  A virtual thread owns the same 16 words in every row, so
//      the accumulators need no barrier and no zeroing pass;
//   2. K7: the last row's two sums run the first inverse pass in registers
//      before they are stored.  K8: add_h's forward chain in the work
//      buffer, for h = 0 then 1; its last pass forms e_h = acc_h * 2^32 +
//      NTT(add_h) (a Shoup product by 2^32 mod q), stores it to out[h] as
//      four uint4 words, and runs the first inverse pass on it in registers
//      into acc_h's words;
//   3. the rest of the two inverse chains over the two accumulators, the
//      last pass times fin, stored with lanes on consecutive words.
// The rows and halves are run-time loops over one copy of each chain, and
// each phase reads its twiddles through radix_opaque pointers (K6's
// lessons: the chains unrolled side by side ran slower and built for
// minutes; a hoisted twiddle holds a register across a whole chain).
// What bounds it: R + 2 transforms a block for K7 and R + 4 for K8, of
// (n / 2) log n butterflies of 13 instructions, beside 2R Montgomery
// products and modular adds a coefficient: the issue rate.  With one block
// an SM no other block hides its barriers.  At 2^15 the limb and key words
// through L2 follow (16 R n bytes a (prime, polynomial): each block reads
// both halves of every limb row); the phases of a block are measured by
// utils/ks_phases.py.
#pragma once

#include <cstdint>

#include "modarith.cuh"
#include "radix_chain.cuh"

namespace fhe {
namespace {

constexpr int kKsThreads = 512;
constexpr int kKsBuffers = 3;

// The split's barrier of a row's readers of the work buffer (ks_body):
// shared memory only in the instances that call it.
__device__ __forceinline__ uint64_t* row_read() {
  __shared__ uint64_t bar;
  return &bar;
}

// The kernel body; EVAL selects K8.  Limb r of polynomial b starts at
// c + r * sl + b * sb, add_h's row (p, b) at add_h + p * al_h + b * ab_h
// (strided views with a contiguous last axis), key row (r, p) at
// (r * Lp + p) * n of the [R, Lp, n] keys, output row (h, p, b) at
// ((h * Lp + p) * B + b) * n.  `lift` holds 2^32 mod q as K8's final
// multiplier; vec: kb and ka are read as uint4.
template <int LOGN, bool EVAL>
__device__ __forceinline__ void ks_body(
    const uint32_t* __restrict__ c, long long sl, long long sb,
    const uint32_t* __restrict__ kb, const uint32_t* __restrict__ ka,
    const uint32_t* __restrict__ add0, long long al0, long long ab0,
    const uint32_t* __restrict__ add1, long long al1, long long ab1,
    uint32_t* __restrict__ out, const uint32_t* __restrict__ tw,
    const uint32_t* __restrict__ tw_sh, const uint32_t* __restrict__ twinv,
    const uint32_t* __restrict__ twinv_sh, const uint32_t* __restrict__ cons,
    const uint32_t* __restrict__ lift, int R, int Lp, int B, int reps,
    bool vec) {
  // at n = 2^15 one half of each buffer a block, on a two-block cluster
  // (radix_chain.cuh's Split): the chains below are those of h words, and
  // the block's words of the rows in device memory start r h on
  constexpr bool split = Split<LOGN>::on;
  constexpr int LOGH = Split<LOGN>::logh;
  using S = RadixShape<LOGH, kKsThreads>;
  constexpr int n = 1 << LOGN;
  constexpr int h = S::n;
  constexpr int last = S::passes - 1;
  constexpr int c0 = S::fwd_c(0);
  constexpr int cl = S::inv_c(last);
  extern __shared__ uint32_t a[];      // work buffer; acc_0, acc_1 at a + h,
                                       // a + 2 h
  // split: a row's last pass has read the work buffer (and stored its
  // sums) when every thread has arrived on row_read; a thread waits on it
  // only before its next store into the buffer, after the next row's loads
  // and first stages
  [[maybe_unused]] uint64_t token = 0;
  if constexpr (split) {
    if (threadIdx.x == 0) mbar_init(row_read(), kKsThreads);
  }
  const int r = split ? cluster_rank() : 0;
  const unsigned blk = blockIdx.x / Split<LOGN>::blocks;
  const int p = blk % Lp;
  const int b = blk / Lp;
  const PrimeRow pr = prime_row(cons, p);
  const uint32_t q = pr.q;
  // the root tables' row of this prime (and, split, of this half)
  const size_t prow = (static_cast<size_t>(p) * Split<LOGN>::blocks + r) * h;
  const size_t half = static_cast<size_t>(r) * h;
  // rows 0 .. R - 1: the digits; K8's rows R and R + 1: add_0 and add_1
#pragma unroll 1
  for (int k = 0; k < (EVAL ? R + 2 : R); ++k) {
    const bool digit = k < R;
    const uint32_t* src =
        digit ? c + k * sl + b * sb
              : (k == R ? add0 + p * al0 + b * ab0 : add1 + p * al1 + b * ab1);
    const int subs = digit ? reps : 0;
    const uint32_t* w = radix_opaque(tw) + prow;
    const uint32_t* wsh = radix_opaque(tw_sh) + prow;
#pragma unroll 1
    for (int g = 0; g < S::groups; ++g) {
      const int base = threadIdx.x + g * S::threads;  // radix_base(v, c0)
      uint32_t x[kRadix];
      if constexpr (split) {
        // both halves' words, reduced, then the top stage
        split_words<c0>(x, src, base, h, r, subs, w[0], wsh[0], q);
      } else {
#pragma unroll
        for (int j = 0; j < kRadix; ++j) x[j] = __ldg(src + base + (j << c0));
#pragma unroll 1
        for (int s = 0; s < subs; ++s) {
#pragma unroll
          for (int j = 0; j < kRadix; ++j) x[j] = x[j] >= q ? x[j] - q : x[j];
        }
      }
      radix_pass<LOGH, 0, false>(x, base, w, wsh, q);
      if constexpr (split) {
        if (g == 0 && k > 0) mbar_wait(row_read(), token);
      }
      radix_store<c0>(a, x, base);
    }
    __syncthreads();
    RadixPasses<LOGH, 1, last, false, kKsThreads>::run(a, w, wsh, q);
    // the last forward pass: K7's last row and K8's add rows end in the
    // first inverse pass, on the same 16 words a virtual thread
    const bool inv = EVAL ? !digit : k == R - 1;
    const uint32_t* wi = twinv + prow;
    const uint32_t* wish = twinv_sh + prow;
    const int h0 = digit ? 0 : k - R;
    const int h1 = digit ? 2 : h0 + 1;
#pragma unroll 1
    for (int g = 0; g < S::groups; ++g) {
      const int base = (threadIdx.x + g * S::threads) << kRadixBits;
      uint32_t x[kRadix];
      radix_load<0>(x, a, base);
      radix_pass<LOGH, last, false>(x, base, w, wsh, q);
#pragma unroll 1
      for (int hh = h0; hh < h1; ++hh) {
        uint32_t* acc = a + (1 + hh) * h;
        uint32_t y[kRadix];
        if (digit) {
          if (k > 0) {
            radix_load<0>(y, acc, base);
          } else {
#pragma unroll
            for (int j = 0; j < kRadix; ++j) y[j] = 0;
          }
          const uint32_t* key = radix_opaque(hh == 0 ? kb : ka) +
                                (static_cast<size_t>(k) * Lp + p) * n + half +
                                base;
#pragma unroll
          for (int j = 0; j < kRadix; j += 4) {
            uint32_t kw[4];
            operand_words(kw, key + j, vec);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              y[j + i] =
                  addmod(y[j + i], mont_mul(x[j + i], kw[i], q, pr.nq), q);
            }
          }
        } else if constexpr (EVAL) {
          const PrimeRow rl = prime_row(lift, p);
          radix_load<0>(y, acc, base);
#pragma unroll
          for (int j = 0; j < kRadix; ++j) {
            y[j] = addmod(shoup_mul(y[j], rl.fin, rl.fin_sh, q), x[j], q);
          }
          uint4* e = reinterpret_cast<uint4*>(
              out + ((static_cast<size_t>(hh) * Lp + p) * B + b) * n + half +
              base);
#pragma unroll
          for (int j = 0; j < kRadix; j += 4) {
            e[j >> 2] = make_uint4(y[j], y[j + 1], y[j + 2], y[j + 3]);
          }
        }
        if (inv) {
          radix_pass<LOGH, 0, true>(y, base, radix_opaque(wi),
                                    radix_opaque(wish), q);
        }
        radix_store<0>(acc, y, base);
      }
    }
    // the next row's first pass reuses a
    if constexpr (split) {
      token = mbar_arrive(row_read());
    } else {
      __syncthreads();
    }
  }
  // the rest of the two inverse chains
  const uint32_t* wi = radix_opaque(twinv) + prow;
  const uint32_t* wish = radix_opaque(twinv_sh) + prow;
  if constexpr (split) {
    // every sum stored; the last pass back to shared memory, then the top
    // stage across the cluster, times fin, into elements i and h + i of
    // each output row
    mbar_wait(row_read(), token);
    RadixPasses<LOGH, 1, last + 1, true, kKsThreads, 2>::run(a + h, wi, wish,
                                                             q);
    split_inverse_out<LOGH, kKsThreads, 2>(
        a + h, r, wi[0], wish[0], pr.fin, pr.fin_sh, q,
        [&](int hh, int i, uint32_t v) {
          out[((static_cast<size_t>(EVAL ? 2 + hh : hh) * Lp + p) * B + b) *
                  n + i] = v;
        });
  } else {
    RadixPasses<LOGH, 1, last, true, kKsThreads, 2>::run(a + h, wi, wish, q);
#pragma unroll 1
    for (int g = 0; g < S::groups; ++g) {
      const int base = radix_base(threadIdx.x + g * S::threads, cl);
#pragma unroll 1
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t x[kRadix];
        radix_load<cl>(x, a + (1 + hh) * h, base);
        radix_pass<LOGH, last, true>(x, base, wi, wish, q);
        uint32_t* o = out + ((static_cast<size_t>(EVAL ? 2 + hh : hh) * Lp +
                              p) * B + b) * n;
#pragma unroll
        for (int j = 0; j < kRadix; ++j) {
          o[base + (j << cl)] = shoup_mul(x[j], pr.fin, pr.fin_sh, q);
        }
      }
    }
  }
}

template <int LOGN>
__global__ void __launch_bounds__(kKsThreads, 1)
ks_fused_kernel(const uint32_t* __restrict__ c, long long sl, long long sb,
                const uint32_t* __restrict__ kb,
                const uint32_t* __restrict__ ka, uint32_t* __restrict__ out,
                const uint32_t* __restrict__ tw,
                const uint32_t* __restrict__ tw_sh,
                const uint32_t* __restrict__ twinv,
                const uint32_t* __restrict__ twinv_sh,
                const uint32_t* __restrict__ cons, int R, int Lp, int B,
                int reps, int vec) {
  ks_body<LOGN, false>(c, sl, sb, kb, ka, nullptr, 0, 0, nullptr, 0, 0, out,
                       tw, tw_sh, twinv, twinv_sh, cons, nullptr, R, Lp, B,
                       reps, vec != 0);
}

template <int LOGN>
__global__ void __launch_bounds__(kKsThreads, 1)
ks_fused_eval_kernel(const uint32_t* __restrict__ c, long long sl,
                     long long sb, const uint32_t* __restrict__ kb,
                     const uint32_t* __restrict__ ka,
                     const uint32_t* __restrict__ add0, long long al0,
                     long long ab0, const uint32_t* __restrict__ add1,
                     long long al1, long long ab1,
                     uint32_t* __restrict__ out,
                     const uint32_t* __restrict__ tw,
                     const uint32_t* __restrict__ tw_sh,
                     const uint32_t* __restrict__ twinv,
                     const uint32_t* __restrict__ twinv_sh,
                     const uint32_t* __restrict__ cons,
                     const uint32_t* __restrict__ lift, int R, int Lp, int B,
                     int reps, int vec) {
  ks_body<LOGN, true>(c, sl, sb, kb, ka, add0, al0, ab0, add1, al1, ab1, out,
                      tw, tw_sh, twinv, twinv_sh, cons, lift, R, Lp, B, reps,
                      vec != 0);
}

// kb and ka 16-byte aligned: every key row starts a multiple of n >= 128
// words on, so each row's uint4 words are aligned too.
inline bool ks_vec(const uint32_t* kb, const uint32_t* ka) {
  return !misaligned(kb) && !misaligned(ka);
}

}  // namespace

// K7 (add0 null) and K8 past one block's polynomial (csrc/
// ks_fused_chunks_cuda.cu).
int ks_fused_chunked(const uint32_t* c, long long sl, long long sb,
                     const uint32_t* kb, const uint32_t* ka,
                     const uint32_t* add0, long long al0, long long ab0,
                     const uint32_t* add1, long long al1, long long ab1,
                     uint32_t* out, uint32_t* tmp, const uint32_t* tw,
                     const uint32_t* tw_sh, const uint32_t* twinv,
                     const uint32_t* twinv_sh, const uint32_t* cons,
                     const uint32_t* lift, int R, int Lp, int B, int logn,
                     int reps, int threads, int smem, cudaStream_t stream);

}  // namespace fhe
