// K6 tensor_mul4's staged instances (LS = kStagedSrc: any 1 .. 31 source
// primes, from the lift's rows), in a translation unit of their own so that
// they compile beside the instances without a source basis and from 4
// (csrc/tensor_mul4_cuda.cu, which describes the kernel and holds its entry
// point).

#include <cstdint>

#include "tensor_mul4.cuh"

namespace fhe {

int tensor_mul4_staged(int logn, int threads, int smem, int blocks,
                        cudaStream_t stream, const uint32_t* x0,
                        const uint32_t* x1, const uint32_t* y0,
                        const uint32_t* y1, Strides st, uint32_t* out,
                        const uint32_t* ext, const uint32_t* tw,
                        const uint32_t* tw_sh, const uint32_t* twinv,
                        const uint32_t* twinv_sh, const uint32_t* cons,
                        int Ls, int Ld, int B) {
  return by_logn_wide<TensorMul4Launch<kStagedSrc>>(
      logn, threads, smem, blocks, stream, x0, x1, y0, y1, st, out, ext, tw,
      tw_sh, twinv, twinv_sh, cons, Ls, Ld, B);
}

}  // namespace fhe
