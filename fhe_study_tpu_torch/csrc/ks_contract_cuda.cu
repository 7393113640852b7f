// K3: the Hopper kernel of the key-switching contraction on hoisted digits,
//   fhe_ks_contract <- fhe_study_tpu/ops/ntt_pallas.py::ks_contract_u32
//                      (_ks_kernel_multi, fwd=False)
// out[h, p, b] = INTT(sum_r edm[r, p, b] * key_h[r, p]) for the two key
// halves (h = 0: kb, 1: ka), as Montgomery products: the digits arrive
// lifted by 2^32, so each product is the plain d * k.
//
// Layout: K2's (csrc/ntt_cuda.cu) with the contraction in place of the
// products.  One block per (prime, polynomial, key half), the half fastest so
// that the two blocks reading one digit row run side by side and share it in
// L2.  The first pass of the register-resident inverse chain
// (radix_chain.cuh: stage bits 0..3 on 16 contiguous words a virtual
// thread) accumulates the R products straight into its registers, reading
// the digit and key rows as uint4 when all three are 16-byte aligned
// (`vec`); its other passes go through swizzled shared memory, and the last
// multiplies by n^-1 and stores lanes on consecutive words of the
// [2, Lp, B, n] output.  R is a run-time loop: 1 row on BFV, 4 for a CKKS
// rotation, L for the hoisted key switch.
// What bounds it: for each half a coefficient, R digit words in (the second
// half finds them in L2; the key rows are shared by the batch) and one word
// out, against log n / 2 butterflies of 13 instructions and R Montgomery
// products with their adds (8 + 3): the issue rate, at every R the paths
// use.  n = 2^7 .. 2^15, at radix_chain.cuh's one-buffer block shape
// (OneBuffer).
//
// The entry launches on the given stream and returns cudaGetLastError(); a
// refused launch never runs, so the caller raises.

#include <climits>
#include <cstdint>

#include "modarith.cuh"
#include "radix_chain.cuh"

namespace fhe {
namespace {

template <int LOGN>
__global__ void __launch_bounds__(OneBuffer<LOGN>::threads,
                                  OneBuffer<LOGN>::blocks)
ks_contract_kernel(const uint32_t* __restrict__ edm,
                   const uint32_t* __restrict__ kb,
                   const uint32_t* __restrict__ ka,
                   uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ twinv,
                   const uint32_t* __restrict__ twinv_sh,
                   const uint32_t* __restrict__ cons, int R, int Lp, int B,
                   int vec) {
  using S = typename OneBuffer<LOGN>::Shape;
  constexpr int n = S::n;
  constexpr int last = S::passes - 1;
  constexpr int cl = S::inv_c(last);
  extern __shared__ uint32_t a[];
  const int h = blockIdx.x & 1;
  const int pb = blockIdx.x >> 1;            // p * B + b
  const int p = pb / B;
  const PrimeRow c = prime_row(cons, p);
  const uint32_t* w = twinv + static_cast<size_t>(p) * n;
  const uint32_t* wsh = twinv_sh + static_cast<size_t>(p) * n;
  // digit row (r, p, b) of [R, Lp, B, n] and key row (r, p) of [R, Lp, n]
  const uint32_t* dig = edm + static_cast<size_t>(pb) * n;
  const uint32_t* key = (h == 0 ? kb : ka) + static_cast<size_t>(p) * n;
  const size_t dstep = static_cast<size_t>(Lp) * B * n;
  const size_t kstep = static_cast<size_t>(Lp) * n;
#pragma unroll 1
  for (int g = 0; g < S::groups; ++g) {
    const int base = (threadIdx.x + g * S::threads) << kRadixBits;
    uint32_t x[kRadix];
#pragma unroll
    for (int j = 0; j < kRadix; ++j) x[j] = 0;
    const uint32_t* dr = dig + base;
    const uint32_t* kr = key + base;
#pragma unroll 1
    for (int r = 0; r < R; ++r, dr += dstep, kr += kstep) {
#pragma unroll
      for (int j = 0; j < kRadix; j += 4) {
        uint32_t D[4], K[4];
        operand_words(D, dr + j, vec != 0);
        operand_words(K, kr + j, vec != 0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[j + i] = addmod(x[j + i], mont_mul(D[i], K[i], c.q, c.nq), c.q);
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
  uint32_t* o = out + (static_cast<size_t>(h) * Lp * B + pb) * n;
#pragma unroll 1
  for (int g = 0; g < S::groups; ++g) {
    const int base = radix_base(threadIdx.x + g * S::threads, cl);
    uint32_t x[kRadix];
    radix_load<cl>(x, a, base);
    radix_pass<LOGN, last, true>(x, base, w, wsh, c.q);
#pragma unroll
    for (int j = 0; j < kRadix; ++j) {
      o[base + (j << cl)] = shoup_mul(x[j], c.fin, c.fin_sh, c.q);
    }
  }
}

struct KsContractLaunch {
  template <int LOGN, typename... Args>
  static int run(Args... args) {
    return one_buffer_launch<LOGN>(ks_contract_kernel<LOGN>, args...);
  }
};

}  // namespace
}  // namespace fhe

using namespace fhe;

// vec: the digit and key rows are read as uint4 (edm, kb, ka 16-byte
// aligned; every row starts a multiple of n >= 128 words on).
extern "C" int fhe_ks_contract(const uint32_t* edm, const uint32_t* kb,
                               const uint32_t* ka, uint32_t* out,
                               const uint32_t* twinv,
                               const uint32_t* twinv_sh, const uint32_t* cons,
                               int R, int Lp, int B, int logn, int vec,
                               int threads, int smem, cudaStream_t stream) {
  const long long blocks = 2LL * Lp * B;
  if (R < 1 || Lp < 1 || B < 1 || blocks > INT_MAX ||
      (vec && (misaligned(edm) || misaligned(kb) || misaligned(ka)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return by_logn_wide<KsContractLaunch>(logn, threads, smem,
                                        static_cast<int>(blocks), stream, edm,
                                        kb, ka, out, twinv, twinv_sh, cons, R,
                                        Lp, B, vec);
}
