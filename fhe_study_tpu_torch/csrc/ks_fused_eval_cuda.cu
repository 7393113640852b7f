// K8: the Hopper kernel of the gadget relinearization of an eval-resident
// ciphertext,
//   fhe_ks_fused_eval <- fhe_study_tpu/ops/ntt_pallas.py::ks_fused_eval_u32
//                        (_ks_eval_kernel)
// csrc/ks_fused.cuh holds the kernel and describes it; this unit
// instantiates it per log n, 2^7 .. 2^15 (csrc/ks_fused_cuda.cu holds K7's
// instances, so that the two compile in parallel; csrc/
// ks_fused_chunks_cuda.cu both past 2^15).  The entry launches on the given
// stream and returns cudaGetLastError(); a refused launch never runs, so
// the caller raises.

#include <climits>
#include <cstdint>

#include "ks_fused.cuh"

namespace fhe {
namespace {

struct KsFusedEvalLaunch {
  template <int LOGN, typename... Args>
  static int run(Args... args) {
    return split_launch<LOGN, kKsThreads, kKsBuffers>(
        ks_fused_eval_kernel<LOGN>, args...);
  }
};

}  // namespace
}  // namespace fhe

using namespace fhe;

// c: [R, B, n] limb rows (strides sl, sb); kb, ka: [R, Lp, n]; add0, add1:
// [Lp, B, n] rows (strides al, ab); out: [4, Lp, B, n], 16-byte aligned
// (the eval-domain rows are stored as uint4 words).  `lift` holds 2^32 mod q
// as its final multiplier.  Past n = 2^15 (csrc/ks_fused_chunks_cuda.cu)
// tmp is a scratch of Lp B n words, tw / tw_sh and twinv / twinv_sh the
// chunk tables and threads and smem a chunk's; below it tmp is not read.
extern "C" int fhe_ks_fused_eval(
    const uint32_t* c, long long sl, long long sb, const uint32_t* kb,
    const uint32_t* ka, const uint32_t* add0, long long al0, long long ab0,
    const uint32_t* add1, long long al1, long long ab1, uint32_t* out,
    uint32_t* tmp, const uint32_t* tw, const uint32_t* tw_sh,
    const uint32_t* twinv, const uint32_t* twinv_sh, const uint32_t* cons,
    const uint32_t* lift, int R, int Lp, int B, int logn, int reps,
    int threads, int smem, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(Lp) * B;
  if (R < 1 || Lp < 1 || B < 1 || reps < 0 || blocks > INT_MAX ||
      misaligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (logn > kWideLogN) {
    return ks_fused_chunked(c, sl, sb, kb, ka, add0, al0, ab0, add1, al1,
                            ab1, out, tmp, tw, tw_sh, twinv, twinv_sh, cons,
                            lift, R, Lp, B, logn, reps, threads, smem,
                            stream);
  }
  return by_logn_wide<KsFusedEvalLaunch>(
      logn, threads, smem, static_cast<int>(blocks), stream, c, sl, sb, kb,
      ka, add0, al0, ab0, add1, al1, ab1, out, tw, tw_sh, twinv, twinv_sh,
      cons, lift, R, Lp, B, reps, static_cast<int>(ks_vec(kb, ka)));
}
