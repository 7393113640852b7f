// K3: the Hopper kernel of the key-switching contraction on hoisted digits,
//   fhe_ks_contract <- fhe_study_tpu/ops/ntt_pallas.py::ks_contract_u32
//                      (_ks_kernel_multi, fwd=False)
// out[h, p, b] = INTT(sum_r edm[r, p, b] * key_h[r, p]) for the two key
// halves (h = 0: kb, 1: ka), as Montgomery products: the digits arrive
// lifted by 2^32, so each product is the plain d * k.
//
// Layout: K2's (csrc/ntt_cuda.cu) with the contraction in place of the
// products, one block per (prime, polynomial, key half): csrc/
// ks_contract.cuh's block, the last pass times n^-1.
// What bounds it: for each half a coefficient, R digit words in (the second
// half finds them in L2; the key rows are shared by the batch) and one word
// out, against log n / 2 butterflies of 13 instructions and R Montgomery
// products with their adds (8 + 3): the issue rate, at every R the paths
// use.  n = 2^7 .. 2^15, at radix_chain.cuh's one-buffer block shape
// (OneBuffer); past 2^15 the entry queues the chunked form of
// csrc/ks_contract_chunks_cuda.cu.
//
// The entry launches on the given stream and returns cudaGetLastError(); a
// refused launch never runs, so the caller raises.

#include <climits>
#include <cstdint>

#include "ks_contract.cuh"
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
  ks_contract_rows<LOGN>(edm, kb, ka, out, twinv, twinv_sh, cons, R, Lp, B,
                         0, 1, vec);
}

struct KsContractLaunch {
  template <int LOGN, typename... Args>
  static int run(Args... args) {
    return one_buffer_launch<LOGN>(ks_contract_kernel<LOGN>, args...);
  }
};

}  // namespace

// K3 past one block (csrc/ks_contract_chunks_cuda.cu).
int ks_contract_chunked(const uint32_t* edm, const uint32_t* kb,
                        const uint32_t* ka, uint32_t* out,
                        const uint32_t* twinv, const uint32_t* twinv_sh,
                        const uint32_t* cons, int R, int Lp, int B, int logn,
                        int vec, int threads, int smem, cudaStream_t stream);

}  // namespace fhe

using namespace fhe;

// vec: the digit and key rows are read as uint4 (edm, kb, ka 16-byte
// aligned; every row starts a multiple of n >= 128 words on).  threads and
// smem: the one-buffer plan at 2^logn <= 2^15, a chunk's past it, where
// twinv / twinv_sh are the chunk tables [Lp, 2^s, 2^15] and the inverse top
// passes run in place in out.
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
  if (logn > kWideLogN) {
    return ks_contract_chunked(edm, kb, ka, out, twinv, twinv_sh, cons, R,
                               Lp, B, logn, vec, threads, smem, stream);
  }
  return by_logn_wide<KsContractLaunch>(logn, threads, smem,
                                        static_cast<int>(blocks), stream, edm,
                                        kb, ka, out, twinv, twinv_sh, cons, R,
                                        Lp, B, vec);
}
