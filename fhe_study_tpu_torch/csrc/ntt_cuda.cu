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
// at n = 2^7 .. 2^15, one block a polynomial (csrc/tensor_eval4.cuh); past
// 2^15 its entry queues the chunked form of csrc/tensor_eval4_chunks_cuda.cu.
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
#include "tensor_eval4.cuh"

namespace fhe {
namespace {

// K2 at n = 2^LOGN <= 2^15: one block per (p, b, k), the whole polynomial
// in shared memory, n^-1 * 2^32 * scale in the last pass.
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
  tensor_eval4_rows<LOGN>(x0, x1, y0, y1, st, out, twinv, twinv_sh, cons, B,
                          0, 1, vec);
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

// threads and smem: the one-buffer plan at 2^logn <= 2^15, a chunk's past
// it, where twinv / twinv_sh are the chunk tables [Ld, 2^s, 2^15] and the
// inverse top passes run in place in out (ops/ntt_cuda.py::
// tensor_eval4_kernel).
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
  const int vec = operands_vec({x0, x1, y0, y1}, st) ? 1 : 0;
  if (logn > kWideLogN) {
    return tensor_eval4_chunked(x0, x1, y0, y1, st, out, twinv, twinv_sh,
                                cons, Ld, B, logn, threads, smem, vec,
                                stream);
  }
  const long long blocks = 3LL * Ld * B;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return by_logn_wide<TensorEval4Launch>(logn, threads, smem,
                                         static_cast<int>(blocks), stream, x0,
                                         x1, y0, y1, st, out, twinv, twinv_sh,
                                         cons, B, vec);
}
