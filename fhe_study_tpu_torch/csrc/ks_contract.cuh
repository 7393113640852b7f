// K3 ks_contract <- fhe_study_tpu/ops/ntt_pallas.py::ks_contract_u32
// (_ks_kernel_multi, fwd=False): the block that both of its forms run, one
// block a polynomial (csrc/ks_contract_cuda.cu, n = 2^7 .. 2^15) and one
// block a chunk of 2^15 words past that (csrc/ks_contract_chunks_cuda.cu,
// n = 2^16 .. 2^26, the top passes after it).
#pragma once

#include <cstdint>

#include "modarith.cuh"
#include "radix_chain.cuh"

namespace fhe {
namespace {

// Key half h of chunk r of polynomial (p, b): block ((p B + b) 2^s + r) 2
// + h (s = 0: the whole polynomial), the half fastest so that the two
// blocks reading one chunk of a digit row run side by side and share it in
// L2.  The first
// pass of the register-resident inverse chain of 2^LOGN words
// (radix_chain.cuh: stage bits 0..3 on 16 contiguous words a virtual
// thread) accumulates the R Montgomery products of the digit rows edm
// [R, Lp, B, n] with the key rows (kb or ka [R, Lp, n]) straight into its
// registers, reading them as uint4 when all three are 16-byte aligned
// (`vec`); its other passes go through swizzled shared memory, under row
// (p, r) of the tables (the [Lp, n] tables at s = 0, the chunk tables
// [Lp, 2^s, 2^LOGN] past a block), and the last stores lanes on consecutive
// words of the [2, Lp, B, n] output, times n^-1 with use_fin.  R is a
// run-time loop: 1 row on BFV, 4 for a CKKS rotation, L for the hoisted key
// switch.
template <int LOGN>
__device__ __forceinline__ void ks_contract_rows(
    const uint32_t* __restrict__ edm, const uint32_t* __restrict__ kb,
    const uint32_t* __restrict__ ka, uint32_t* __restrict__ out,
    const uint32_t* __restrict__ twinv, const uint32_t* __restrict__ twinv_sh,
    const uint32_t* __restrict__ cons, int R, int Lp, int B, int s,
    int use_fin, int vec) {
  using S = typename OneBuffer<LOGN>::Shape;
  constexpr int n = S::n;
  constexpr int last = S::passes - 1;
  constexpr int cl = S::inv_c(last);
  extern __shared__ uint32_t a[];
  const int h = blockIdx.x & 1;
  const int rest = blockIdx.x >> 1;          // (p * B + b) * 2^s + r
  const int r = rest & ((1 << s) - 1);
  const int pb = rest >> s;                  // p * B + b
  const int p = pb / B;
  const PrimeRow c = prime_row(cons, p);
  const size_t trow = (static_cast<size_t>(p) << s) + r;
  const uint32_t* w = twinv + trow * n;
  const uint32_t* wsh = twinv_sh + trow * n;
  const size_t row = static_cast<size_t>(n) << s;    // words a polynomial
  const size_t off = static_cast<size_t>(r) * n;
  // digit row (r, p, b) of [R, Lp, B, n] and key row (r, p) of [R, Lp, n]
  const uint32_t* dig = edm + static_cast<size_t>(pb) * row + off;
  const uint32_t* key = (h == 0 ? kb : ka) + static_cast<size_t>(p) * row + off;
  const size_t dstep = static_cast<size_t>(Lp) * B * row;
  const size_t kstep = static_cast<size_t>(Lp) * row;
#pragma unroll 1
  for (int g = 0; g < S::groups; ++g) {
    const int base = (threadIdx.x + g * S::threads) << kRadixBits;
    uint32_t x[kRadix];
#pragma unroll
    for (int j = 0; j < kRadix; ++j) x[j] = 0;
    const uint32_t* dr = dig + base;
    const uint32_t* kr = key + base;
#pragma unroll 1
    for (int i = 0; i < R; ++i, dr += dstep, kr += kstep) {
#pragma unroll
      for (int j = 0; j < kRadix; j += 4) {
        uint32_t D[4], K[4];
        operand_words(D, dr + j, vec != 0);
        operand_words(K, kr + j, vec != 0);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          x[j + u] = addmod(x[j + u], mont_mul(D[u], K[u], c.q, c.nq), c.q);
        }
      }
    }
    // the pass's twiddles are read through opaque pointers, so that their
    // loads are not hoisted above the contraction (ptxas spilled at n = 2^13)
    radix_pass<LOGN, 0, true>(x, base, radix_opaque(w), radix_opaque(wsh),
                              c.q);
    radix_store<0>(a, x, base);
  }
  __syncthreads();
  RadixPasses<LOGN, 1, last, true, S::threads>::run(a, w, wsh, c.q);
  uint32_t* o = out + (static_cast<size_t>(h) * Lp * B + pb) * row + off;
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

}  // namespace
}  // namespace fhe
