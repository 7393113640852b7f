// K2 tensor_eval4 <- fhe_study_tpu/ops/ntt_pallas.py::tensor_eval4_u32
// (_tensor_eval_kernel): the block that both of its forms run, one block a
// polynomial (csrc/ntt_cuda.cu, n = 2^7 .. 2^15) and one block a chunk of
// 2^15 words past that (csrc/tensor_eval4_chunks_cuda.cu, n = 2^16 ..
// 2^26, the top passes after it; K6's products past one block run it
// there too).
#pragma once

#include <cstdint>

#include "modarith.cuh"
#include "radix_chain.cuh"

namespace fhe {
namespace {

// Product k of the degree-2 tensor of eval-domain operands, chunk r of
// polynomial (p, b) (block (((p B + b) 2^s + r) 3 + k; s = 0: the whole
// polynomial), k fastest so that the three blocks reading one chunk of a
// row pair run side by side and share it in L2: k = 0 -> x0*y0, 1 -> x0*y1 + x1*y0,
// 2 -> x1*y1 as Montgomery products (a factor 2^-32 each) straight into the
// registers of the first pass of the register-resident inverse chain of
// 2^LOGN words (radix_chain.cuh: stage bits 0..3 on 16 contiguous words,
// read as uint4 when every row is 16-byte aligned, `vec`), its other passes
// through shared memory, under row (p, r) of the tables (the [Ld, n]
// tables at s = 0, the chunk tables [Ld, 2^s, 2^LOGN] past a block).  With
// use_fin the last pass multiplies by n^-1 * 2^32 * scale; its stores are
// coalesced (lanes on consecutive words) into the block's words of out.
template <int LOGN>
__device__ __forceinline__ void tensor_eval4_rows(
    const uint32_t* __restrict__ x0, const uint32_t* __restrict__ x1,
    const uint32_t* __restrict__ y0, const uint32_t* __restrict__ y1,
    Strides st, uint32_t* __restrict__ out,
    const uint32_t* __restrict__ twinv, const uint32_t* __restrict__ twinv_sh,
    const uint32_t* __restrict__ cons, int B, int s, int use_fin, int vec) {
  using S = typename OneBuffer<LOGN>::Shape;
  constexpr int n = S::n;
  constexpr int last = S::passes - 1;
  constexpr int cl = S::inv_c(last);
  extern __shared__ uint32_t a[];
  const int k = blockIdx.x % 3;
  const int rest = blockIdx.x / 3;           // (p * B + b) * 2^s + r
  const int r = rest & ((1 << s) - 1);
  const int pb = rest >> s;                  // p * B + b
  const int b = pb % B;
  const int p = pb / B;
  const PrimeRow c = prime_row(cons, p);
  const size_t trow = (static_cast<size_t>(p) << s) + r;
  const uint32_t* w = twinv + trow * n;
  const uint32_t* wsh = twinv_sh + trow * n;
  const size_t off = static_cast<size_t>(r) * n;
  const uint32_t* r0 = x0 + p * st.l[0] + b * st.b[0] + off;
  const uint32_t* r1 = x1 + p * st.l[1] + b * st.b[1] + off;
  const uint32_t* s0 = y0 + p * st.l[2] + b * st.b[2] + off;
  const uint32_t* s1 = y1 + p * st.l[3] + b * st.b[3] + off;
  // k = 1 sums two products; k = 0 and 2 take one, from (r0, s0) or (r1, s1)
  const uint32_t* u0 = k == 2 ? r1 : r0;
  const uint32_t* v0 = k == 0 ? s0 : s1;
#pragma unroll 1
  for (int g = 0; g < S::groups; ++g) {
    const int base = (threadIdx.x + g * S::threads) << kRadixBits;
    uint32_t x[kRadix];
#pragma unroll
    for (int j = 0; j < kRadix; j += 4) {
      uint32_t A[4], Bw[4];
      operand_words(A, u0 + base + j, vec != 0);
      operand_words(Bw, v0 + base + j, vec != 0);
#pragma unroll
      for (int i = 0; i < 4; ++i) x[j + i] = mont_mul(A[i], Bw[i], c.q, c.nq);
      if (k == 1) {
        operand_words(A, r1 + base + j, vec != 0);
        operand_words(Bw, s0 + base + j, vec != 0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[j + i] = addmod(x[j + i], mont_mul(A[i], Bw[i], c.q, c.nq), c.q);
        }
      }
    }
    radix_pass<LOGN, 0, true>(x, base, w, wsh, c.q);
    radix_store<0>(a, x, base);
  }
  __syncthreads();
  RadixPasses<LOGN, 1, last, true, S::threads>::run(a, w, wsh, c.q);
  // chunk r of output row (p B + b) 3 + k
  uint32_t* o = out + ((static_cast<size_t>(pb * 3 + k) << s) + r) * n;
#pragma unroll 1
  for (int g = 0; g < S::groups; ++g) {
    const int base = radix_base(threadIdx.x + g * S::threads, cl);
    uint32_t x[kRadix];
    radix_load<cl>(x, a, base);
    radix_pass<LOGN, last, true>(x, base, w, wsh, c.q);
#pragma unroll
    for (int j = 0; j < kRadix; ++j) {
      o[base + (j << cl)] =
          use_fin ? shoup_mul(x[j], c.fin, c.fin_sh, c.q) : x[j];
    }
  }
}

// The four operands' rows may be read as uint4: every row 16-byte aligned.
inline bool operands_vec(const uint32_t* const (&rows)[4], const Strides& st) {
  bool vec = true;
  for (int o = 0; o < 4; ++o) {
    vec = vec && reinterpret_cast<uintptr_t>(rows[o]) % 16 == 0 &&
          st.l[o] % 4 == 0 && st.b[o] % 4 == 0;
  }
  return vec;
}

}  // namespace

// K2 past one block (csrc/tensor_eval4_chunks_cuda.cu), also the products
// and inverses of K6 past one block (csrc/tensor_mul4_chunks_cuda.cu).
int tensor_eval4_chunked(const uint32_t* x0, const uint32_t* x1,
                         const uint32_t* y0, const uint32_t* y1, Strides st,
                         uint32_t* out, const uint32_t* twinv,
                         const uint32_t* twinv_sh, const uint32_t* cons,
                         int Ld, int B, int logn, int threads, int smem,
                         int vec, cudaStream_t stream);

}  // namespace fhe
