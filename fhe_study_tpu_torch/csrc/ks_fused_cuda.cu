// K7: the Hopper kernel of the gadget key switch from limb residues,
//   fhe_ks_fused <- fhe_study_tpu/ops/ntt_pallas.py::ks_fused_u32
//                   (_ks_kernel_multi, fwd=True)
// csrc/ks_fused.cuh holds the kernel and describes it; this unit
// instantiates it per log n, 2^7 .. 2^15 (csrc/ks_fused_eval_cuda.cu holds
// K8's instances, so that the two compile in parallel; csrc/
// ks_fused_chunks_cuda.cu both past 2^15).  The entry launches on
// the given stream and returns cudaGetLastError(); a refused launch never
// runs, so the caller raises.

#include <climits>
#include <cstdint>

#include "ks_fused.cuh"

namespace fhe {
namespace {

struct KsFusedLaunch {
  template <int LOGN, typename... Args>
  static int run(Args... args) {
    return split_launch<LOGN, kKsThreads, kKsBuffers>(ks_fused_kernel<LOGN>,
                                                     args...);
  }
};

}  // namespace
}  // namespace fhe

using namespace fhe;

// c: [R, B, n] limb rows (strides sl, sb); kb, ka: [R, Lp, n]; out:
// [2, Lp, B, n].  Past n = 2^15 (csrc/ks_fused_chunks_cuda.cu) tmp is a
// scratch of Lp B n words, tw / tw_sh and twinv / twinv_sh the chunk tables
// and threads and smem a chunk's; below it tmp is not read.
extern "C" int fhe_ks_fused(const uint32_t* c, long long sl, long long sb,
                            const uint32_t* kb, const uint32_t* ka,
                            uint32_t* out, uint32_t* tmp, const uint32_t* tw,
                            const uint32_t* tw_sh, const uint32_t* twinv,
                            const uint32_t* twinv_sh, const uint32_t* cons,
                            int R, int Lp, int B, int logn, int reps,
                            int threads, int smem, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(Lp) * B;
  if (R < 1 || Lp < 1 || B < 1 || reps < 0 || blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (logn > kWideLogN) {
    return ks_fused_chunked(c, sl, sb, kb, ka, nullptr, 0, 0, nullptr, 0, 0,
                            out, tmp, tw, tw_sh, twinv, twinv_sh, cons,
                            nullptr, R, Lp, B, logn, reps, threads, smem,
                            stream);
  }
  return by_logn_wide<KsFusedLaunch>(
      logn, threads, smem, static_cast<int>(blocks), stream, c, sl, sb, kb,
      ka, out, tw, tw_sh, twinv, twinv_sh, cons, R, Lp, B, reps,
      static_cast<int>(ks_vec(kb, ka)));
}
