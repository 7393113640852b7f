// Hopper kernels of the negacyclic transforms on the RNS-BFV main path.
//
// Each kernel replaces one Pallas kernel of fhe_study_tpu/ops/ntt_pallas.py.
// Eight live in translation units of their own, so that their unrolled
// instances compile in parallel: K1 fhe_ntt_multi <- ntt_multi_u32 and K9
// fhe_ntt <- ntt_u32 (csrc/ntt_multi_cuda.cu), K3 fhe_ks_contract <-
// ks_contract_u32 (csrc/ks_contract_cuda.cu), K5 fhe_ext_ntt <- ext_ntt_u32
// (csrc/ext_ntt_cuda.cu), K6 fhe_tensor_mul4 <- tensor_mul4_u32 and
// tensor_mul_u32 (csrc/tensor_mul4_cuda.cu), K7 fhe_ks_fused <- ks_fused_u32
// (csrc/ks_fused_cuda.cu) and K8 fhe_ks_fused_eval <- ks_fused_eval_u32
// (csrc/ks_fused_eval_cuda.cu).  Here:
//   fhe_tensor_eval4   <- tensor_eval4_u32  (_tensor_eval_kernel)
//
// fhe_tensor_eval4 (K2), like the others, runs the register-resident chain
// of radix_chain.cuh: four stages a pass on 16 words a thread in registers,
// ceil(log n / 4) - 1 exchanges through swizzled shared memory (3 barriers
// at n = 2^14), the twiddles of a pass in vector loads, its products
// straight into the registers of the first pass.  One block of at most 256
// threads per polynomial, each thread playing up to 4 virtual threads, 3
// blocks an SM at n = 2^14; at n = 2^15 one block of 512 threads an SM
// (radix_chain.cuh's OneBuffer).  K2 and K5 read 41-50% of their issue bound on
// an H100 80GB HBM3 at 700 W (PERF.md); what is left is the instructions
// beyond the counted butterflies (shared-memory words and their addresses,
// twiddle loads) and the latency around the barriers.
//
// The entry point launches on the given stream and returns
// cudaGetLastError(); a refused launch never runs, so the caller raises.

#include <climits>
#include <cstdint>

#include "modarith.cuh"
#include "radix_chain.cuh"

namespace fhe {
namespace {

// K2: product k of the degree-2 tensor of eval-domain operands, one block
// per (p, b, k), k fastest so that the three blocks reading one row pair run
// side by side and share it in L2: k = 0 -> x0*y0, 1 -> x0*y1 + x1*y0,
// 2 -> x1*y1 as Montgomery products (a factor 2^-32 each) straight into the
// registers of the first pass of the register-resident inverse chain
// (radix_chain.cuh: stage bits 0..3 on 16 contiguous words, read as uint4
// when every row is 16-byte aligned, `vec`), its other passes through shared
// memory, and the final multiply by n^-1 * 2^32 * scale folded into the last
// pass, whose stores are coalesced (lanes on consecutive words).
template <int LOGN>
__global__ void __launch_bounds__(OneBuffer<LOGN>::threads,
                                  OneBuffer<LOGN>::blocks)
tensor_eval4_kernel(const uint32_t* __restrict__ x0,
                    const uint32_t* __restrict__ x1,
                    const uint32_t* __restrict__ y0,
                    const uint32_t* __restrict__ y1, Strides st,
                    uint32_t* __restrict__ out,
                    const uint32_t* __restrict__ twinv,
                    const uint32_t* __restrict__ twinv_sh,
                    const uint32_t* __restrict__ cons, int B, int vec) {
  using S = typename OneBuffer<LOGN>::Shape;
  constexpr int n = S::n;
  constexpr int last = S::passes - 1;
  constexpr int cl = S::inv_c(last);
  extern __shared__ uint32_t a[];
  const int k = blockIdx.x % 3;
  const int pb = blockIdx.x / 3;             // p * B + b
  const int b = pb % B;
  const int p = pb / B;
  const PrimeRow c = prime_row(cons, p);
  const uint32_t* w = twinv + static_cast<size_t>(p) * n;
  const uint32_t* wsh = twinv_sh + static_cast<size_t>(p) * n;
  const uint32_t* r0 = x0 + p * st.l[0] + b * st.b[0];
  const uint32_t* r1 = x1 + p * st.l[1] + b * st.b[1];
  const uint32_t* s0 = y0 + p * st.l[2] + b * st.b[2];
  const uint32_t* s1 = y1 + p * st.l[3] + b * st.b[3];
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
  uint32_t* o = out + static_cast<size_t>(blockIdx.x) * n;
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

struct TensorEval4Launch {
  template <int LOGN, typename... Args>
  static int run(Args... args) {
    return one_buffer_launch<LOGN>(tensor_eval4_kernel<LOGN>, args...);
  }
};

}  // namespace
}  // namespace fhe

using namespace fhe;

extern "C" int fhe_tensor_eval4(const uint32_t* x0, const uint32_t* x1,
                                const uint32_t* y0, const uint32_t* y1,
                                long long sl0, long long sb0, long long sl1,
                                long long sb1, long long sl2, long long sb2,
                                long long sl3, long long sb3, uint32_t* out,
                                const uint32_t* twinv,
                                const uint32_t* twinv_sh,
                                const uint32_t* cons, int Ld, int B, int logn,
                                int threads, int smem, cudaStream_t stream) {
  const Strides st{{sl0, sl1, sl2, sl3}, {sb0, sb1, sb2, sb3}};
  // uint4 operand loads need every row 16-byte aligned
  const uint32_t* rows[4] = {x0, x1, y0, y1};
  bool vec = true;
  for (int o = 0; o < 4; ++o) {
    vec = vec && reinterpret_cast<uintptr_t>(rows[o]) % 16 == 0 &&
          st.l[o] % 4 == 0 && st.b[o] % 4 == 0;
  }
  const long long blocks = 3LL * Ld * B;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return by_logn_wide<TensorEval4Launch>(logn, threads, smem,
                                         static_cast<int>(blocks), stream, x0,
                                         x1, y0, y1, st, out, twinv, twinv_sh,
                                         cons, B, static_cast<int>(vec));
}
