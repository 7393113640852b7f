// K6 tensor_mul4: the kernel template, shared by the two translation units
// that instantiate it (csrc/tensor_mul4_cuda.cu: the entry point and the
// instances without a source basis and from 4 source primes, the BFV P
// basis; csrc/tensor_mul4_staged_cuda.cu: the staged form, from any source
// count), so that their instances compile in parallel, up to n = 2^15.
// tensor_mul4_cuda.cu's header describes the kernel; past 2^15 the entry
// queues the chunked form of csrc/tensor_mul4_chunks_cuda.cu.
#pragma once

#include <cstdint>

#include "modarith.cuh"
#include "radix_chain.cuh"

namespace fhe {
namespace {

constexpr int kMul4Threads = 512;
constexpr int kMul4Buffers = 3;
// Words beside the three buffers of a split block: x0's transform for the
// groups of virtual threads past the first (32 KB at n = 2^15; 224 KB in
// all, of the 227 KB a block may take).
template <int LOGN>
constexpr int kMul4Side =
    Split<LOGN>::on
        ? (RadixShape<Split<LOGN>::logh, kMul4Threads>::groups - 1) *
              kMul4Threads * kRadix
        : 0;
// LS of the instance whose operands are over the destination basis already;
// LS = 4 (the BFV P basis from Q) converts each word on its way in, and
// kStagedSrc (any 1 .. 31 source primes) reads the lift's rows instead
// (ext_lift, run by the entry first: each operand's y_i and alpha are formed
// once per polynomial, not once per destination block).
constexpr int kNoSrc = -1;

// Word i of an operand row under destination prime p: the word itself, or
// its conversion from the source rows, sl words apart (LS = 4).
template <int LS>
__device__ __forceinline__ uint32_t mul4_word(const uint32_t* row,
                                              long long sl, int i,
                                              const ExtTable& e, int p) {
  if constexpr (LS == kNoSrc) {
    return __ldg(row + i);
  } else {
    return ext_coeff<LS>(row + i, static_cast<size_t>(sl), e, p);
  }
}

template <int LOGN, int LS>
__global__ void __launch_bounds__(kMul4Threads, 1)
tensor_mul4_kernel(const uint32_t* __restrict__ x0,
                   const uint32_t* __restrict__ x1,
                   const uint32_t* __restrict__ y0,
                   const uint32_t* __restrict__ y1, Strides st,
                   uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ ext,
                   const uint32_t* __restrict__ tw,
                   const uint32_t* __restrict__ tw_sh,
                   const uint32_t* __restrict__ twinv,
                   const uint32_t* __restrict__ twinv_sh,
                   const uint32_t* __restrict__ cons, int Ls, int Ld, int B) {
  // at n = 2^15 one half of each buffer a block, on a two-block cluster
  // (radix_chain.cuh's Split): the chains below are those of h words
  constexpr bool split = Split<LOGN>::on;
  constexpr int LOGH = Split<LOGN>::logh;
  using S = RadixShape<LOGH, kMul4Threads>;
  constexpr int n = 1 << LOGN;
  constexpr int h = S::n;
  constexpr int last = S::passes - 1;
  constexpr int c0 = S::fwd_c(0);
  constexpr int cl = S::inv_c(last);
  extern __shared__ uint32_t a[];            // buffers 0, 1, 2 at a + k * h
  // the staged form's table column of this prime (stage_column)
  __shared__ uint32_t column[LS == kStagedSrc ? 2 * kMaxSrc + 2 : 1];
  uint32_t* const a2 = a + 2 * h;
  // x0's transform rides across x1's chain in registers, a virtual thread's
  // 16 words for each of the `kept` first groups; split, the block has room
  // beside its three half buffers for the other groups' words (kMul4Side),
  // which frees 16 registers a group
  constexpr int kept = split ? 1 : S::groups;
  uint32_t* const side = a + 3 * h;          // [group - kept][j][thread]
  const int r = split ? cluster_rank() : 0;
  const unsigned blk = blockIdx.x / Split<LOGN>::blocks;
  const int p = blk % Ld;
  const int b = blk / Ld;
  const uint32_t q = cons[4 * p], nq = cons[4 * p + 1];
  // the root tables' row of this prime (and, split, of this half)
  const size_t trow = (static_cast<size_t>(p) * Split<LOGN>::blocks + r) * h;
  const uint32_t* w = tw + trow;
  const uint32_t* wsh = tw_sh + trow;
  // row p of each operand, or its source (lift) rows from row 0
  const long long row = LS == kNoSrc ? p : 0;
  if constexpr (LS == kStagedSrc) {
    stage_column(column, ExtTable{ext, Ls, Ld}, p);
    __syncthreads();
  }
  // 1-2. the forward chains: k = 0, 1, 2, 3 -> y0, y1, x0, x1.  The
  // pointers each iteration reads through are made opaque in it, so that no
  // twiddle or table word is hoisted out of the loop (it would hold a
  // register across all four chains).
  uint32_t x0e[kept][kRadix];
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    // operand k's rows and their stride (selects: no run-time index into
    // the parameters)
    const long long sl = k == 0 ? st.l[2] : (k == 1 ? st.l[3] :
                                             (k == 2 ? st.l[0] : st.l[1]));
    const long long sb = k == 0 ? st.b[2] : (k == 1 ? st.b[3] :
                                             (k == 2 ? st.b[0] : st.b[1]));
    const uint32_t* src =
        (k == 0 ? y0 : (k == 1 ? y1 : (k == 2 ? x0 : x1))) + row * sl + b * sb;
    uint32_t* buf = a + (k < 2 ? k : 2) * h;
    const uint32_t* wk = radix_opaque(w);
    const uint32_t* wshk = radix_opaque(wsh);
    const ExtTable e{radix_opaque(ext), LS > 0 ? LS : Ls, Ld};
    if (k == 3) {                       // x0 leaves buffer 2 for registers
#pragma unroll
      for (int g = 0; g < S::groups; ++g) {
        const int base = (threadIdx.x + g * S::threads) << kRadixBits;
        if (g < kept) {
          radix_load<0>(x0e[split ? 0 : g], a2, base);
        } else {
          uint32_t t[kRadix];
          radix_load<0>(t, a2, base);
#pragma unroll
          for (int j = 0; j < kRadix; ++j) {
            side[((g - kept) * kRadix + j) * S::threads + threadIdx.x] = t[j];
          }
        }
      }
      __syncthreads();
    }
    if constexpr (split && LS == kNoSrc) {
      // a virtual thread's 16 words of both halves of the row, 32 loads in
      // flight (split_words), the first forward stage (bit 14) into this
      // block's half and pass 0 in registers
      const uint32_t w1 = radix_opaque(wk)[0];
      const uint32_t w1sh = radix_opaque(wshk)[0];
#pragma unroll 1
      for (int g = 0; g < S::groups; ++g) {
        const int base = threadIdx.x + g * S::threads;  // radix_base(v, c0)
        uint32_t x[kRadix];
        split_words<c0>(x, src, base, h, r, 0, w1, w1sh, q);
        radix_pass<LOGH, 0, false>(x, base, radix_opaque(wk),
                                   radix_opaque(wshk), q);
        radix_store<c0>(buf, x, base);
      }
      __syncthreads();
      RadixPasses<LOGH, 1, last, false, kMul4Threads>::run(buf, wk, wshk, q);
    } else if constexpr (split) {
      // with a source basis each block converts only the words of its own
      // half, r h + i (from the lift's rows, or each word from 4 sources),
      // 16 a thread at a time with lanes on consecutive words, into its
      // buffer; then the first forward stage in place across the cluster
      // (each block half of the pairs, the peer's words through distributed
      // shared memory), and the chain of the half from shared memory.  The
      // first cluster barrier also orders the peer's taking x0 out of
      // buffer 2 (k = 3) before this block's stage writes into it.
      constexpr int run = kRadix * S::threads;
      static_assert(h % run == 0, "whole runs of the half");
      const uint32_t* half = radix_opaque(src) + r * h;
#pragma unroll 1
      for (int i0 = threadIdx.x; i0 < h; i0 += run) {
        uint32_t v[kRadix];
        if constexpr (LS == kStagedSrc) {
          ext_from_lift(v, half, static_cast<size_t>(sl), column, Ls, q,
                        [&](int m) { return i0 + m * S::threads; });
        } else {
#pragma unroll
          for (int m = 0; m < kRadix; ++m) {
            v[m] = mul4_word<LS>(half, sl, i0 + m * S::threads, e, p);
          }
        }
#pragma unroll
        for (int m = 0; m < kRadix; ++m) {
          buf[radix_swizzle(i0 + m * S::threads)] = v[m];
        }
      }
      cluster_sync();
      split_top_stage<LOGH, kMul4Threads, false>(
          buf, r, cluster_addr(buf, r ^ 1), radix_opaque(wk)[0],
          radix_opaque(wshk)[0], 0, 0, q);
      cluster_sync();
      RadixPasses<LOGH, 0, last, false, kMul4Threads>::run(buf, wk, wshk, q);
    } else if constexpr (LS == kStagedSrc) {
      // each word's sum from the lift's rows goes to shared memory as it is
      // formed, 8 words at a time in a rolled loop, and pass 0 runs from
      // there, so that the sums never sit beside a pass's 16 words in
      // registers (so placed, or with the runs unrolled, they spilled at
      // 128 registers beside x0's words at n = 2^7 .. 2^13)
      constexpr int run = kRadix / 2;
#pragma unroll 1
      for (int g = 0; g < S::groups; ++g) {
        const int base = threadIdx.x + g * S::threads;  // radix_base(v, c0)
#pragma unroll 1
        for (int hf = 0; hf < kRadix / run; ++hf) {
          uint32_t v[run];
          ext_from_lift(v, src, static_cast<size_t>(sl), column, Ls, q,
                        [&](int j) { return base + ((j + hf * run) << c0); });
#pragma unroll
          for (int j = 0; j < run; ++j) {
            buf[radix_swizzle(base + ((j + hf * run) << c0))] = v[j];
          }
        }
      }
      __syncthreads();
      RadixPasses<LOGH, 0, last, false, kMul4Threads>::run(buf, wk, wshk, q);
    } else {
#pragma unroll 1
      for (int g = 0; g < S::groups; ++g) {
        const int base = threadIdx.x + g * S::threads;  // radix_base(v, c0)
        uint32_t x[kRadix];
#pragma unroll
        for (int j = 0; j < kRadix; ++j) {
          x[j] = mul4_word<LS>(src, sl, base + (j << c0), e, p);
        }
        radix_pass<LOGH, 0, false>(x, base, radix_opaque(wk),
                                   radix_opaque(wshk), q);
        radix_store<c0>(buf, x, base);
      }
      __syncthreads();
      RadixPasses<LOGH, 1, last, false, kMul4Threads>::run(buf, wk, wshk, q);
    }
    if (k < 3) {
#pragma unroll 1
      for (int g = 0; g < S::groups; ++g) {
        const int base = (threadIdx.x + g * S::threads) << kRadixBits;
        uint32_t x[kRadix];
        radix_load<0>(x, buf, base);
        radix_pass<LOGH, last, false>(x, base, wk, wshk, q);
        radix_store<0>(buf, x, base);
      }
      // split: no barrier, since the next thread to read these words is the
      // one that stored them (x0 leaving buffer 2, the products), and the
      // next operand's first stores go to another buffer or wait on the
      // barrier after x0 leaves
      if constexpr (!split) __syncthreads();
    }
  }
  // 3. x1's last pass; the products one at a time, each through the first
  // inverse pass.  The inverse chain's pointers are formed only now, out of
  // the loop's registers.
  const uint32_t* w3 = radix_opaque(w);
  const uint32_t* wsh3 = radix_opaque(wsh);
  const uint32_t* wi = radix_opaque(twinv) + trow;
  const uint32_t* wish = radix_opaque(twinv_sh) + trow;
  // unrolled, x0e's groups stay in registers; split, x0e holds one group
  // and the loop stays rolled (unrolled, its schedule spilled at 128
  // registers)
  constexpr int unroll_g = split ? 1 : S::groups;
#pragma unroll unroll_g
  for (int g = 0; g < S::groups; ++g) {
    const int base = (threadIdx.x + g * S::threads) << kRadixBits;
    uint32_t x[kRadix], xs[kRadix];
    if (g >= kept) {                    // x0's words from beside the buffers,
      const uint32_t* sd = radix_opaque(side);  // not before this group
#pragma unroll
      for (int j = 0; j < kRadix; ++j) {
        xs[j] = sd[((g - kept) * kRadix + j) * S::threads + threadIdx.x];
      }
    }
    radix_load<0>(x, a2, base);
    radix_pass<LOGH, last, false>(x, base, w3, wsh3, q);
#pragma unroll 1
    for (int k = 2; k >= 0; --k) {      // x1 y1, x0 y1 + x1 y0, x0 y0
      uint32_t u[kRadix], pr[kRadix];
      radix_load<0>(u, k == 0 ? a : a + h, base);
#pragma unroll
      for (int j = 0; j < kRadix; ++j) {
        const uint32_t x0j = g < kept ? x0e[split ? 0 : g][j] : xs[j];
        pr[j] = mont_mul(k == 2 ? x[j] : x0j, u[j], q, nq);
      }
      if (k == 1) {
        radix_load<0>(u, a, base);
#pragma unroll
        for (int j = 0; j < kRadix; ++j) {
          pr[j] = addmod(pr[j], mont_mul(x[j], u[j], q, nq), q);
        }
      }
      radix_pass<LOGH, 0, true>(pr, base, wi, wish, q);
      radix_store<0>(a + k * h, pr, base);
    }
  }
  __syncthreads();
  // 4. the rest of the three inverse chains
  wi = radix_opaque(wi);
  wish = radix_opaque(wish);
  if constexpr (split) {
    // the last pass back to shared memory, then the top stage across the
    // cluster by pairs, times fin, into elements i and h + i of each
    // product for this block's half of the pairs
    RadixPasses<LOGH, 1, last + 1, true, kMul4Threads, 3>::run(a, wi, wish,
                                                               q);
    const uint32_t fin = cons[4 * p + 2], fin_sh = cons[4 * p + 3];
    uint32_t* out3 = out + (static_cast<size_t>(p) * B + b) * 3 * n;
    split_inverse_out<LOGH, kMul4Threads, 3>(
        a, r, wi[0], wish[0], fin, fin_sh, q,
        [&](int k, int i, uint32_t v) { out3[k * n + i] = v; });
  } else {
    RadixPasses<LOGH, 1, last, true, kMul4Threads, 3>::run(a, wi, wish, q);
    const uint32_t fin = cons[4 * p + 2], fin_sh = cons[4 * p + 3];
    uint32_t* out3 = out + (static_cast<size_t>(p) * B + b) * 3 * n;
#pragma unroll 1
    for (int g = 0; g < S::groups; ++g) {
      const int base = radix_base(threadIdx.x + g * S::threads, cl);
#pragma unroll 1
      for (int k = 0; k < 3; ++k) {
        uint32_t x[kRadix];
        radix_load<cl>(x, a + k * n, base);
        radix_pass<LOGN, last, true>(x, base, wi, wish, q);
#pragma unroll
        for (int j = 0; j < kRadix; ++j) {
          out3[k * n + base + (j << cl)] = shoup_mul(x[j], fin, fin_sh, q);
        }
      }
    }
  }
}

template <int LS>
struct TensorMul4Launch {
  template <int LOGN, typename... Args>
  static int run(Args... args) {
    return split_launch<LOGN, kMul4Threads, kMul4Buffers, kMul4Side<LOGN>>(
        tensor_mul4_kernel<LOGN, LS>, args...);
  }
};

}  // namespace

// K6 past one block's polynomial (csrc/tensor_mul4_chunks_cuda.cu).
int tensor_mul4_chunked(const uint32_t* const (&ops)[4], const Strides& st,
                        uint32_t* lift, uint32_t* tmp, uint32_t* out,
                        const uint32_t* ext, const uint32_t* tw,
                        const uint32_t* tw_sh, const uint32_t* twinv,
                        const uint32_t* twinv_sh, const uint32_t* cons,
                        int Ls, int Ld, int B, int logn, int threads,
                        int smem, cudaStream_t stream);

// The staged instances' launch (csrc/tensor_mul4_staged_cuda.cu).
int tensor_mul4_staged(int logn, int threads, int smem, int blocks,
                        cudaStream_t stream, const uint32_t* x0,
                        const uint32_t* x1, const uint32_t* y0,
                        const uint32_t* y1, Strides st, uint32_t* out,
                        const uint32_t* ext, const uint32_t* tw,
                        const uint32_t* tw_sh, const uint32_t* twinv,
                        const uint32_t* twinv_sh, const uint32_t* cons,
                        int Ls, int Ld, int B);

}  // namespace fhe
