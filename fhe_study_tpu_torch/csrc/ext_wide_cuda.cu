// K4 base_extend's and K11 base_extend_sum's instances from kNarrowSrc + 1
// .. kMaxSrc (16 .. 31) source primes, in a translation unit of their own so
// that they compile beside the counts 1 .. 15 (csrc/ext_cuda.cu, which
// describes the kernels and holds their entry points; csrc/ext.cuh holds
// the kernels).  The entry points have checked the shape.

#include <cstdint>

#include "ext.cuh"

namespace fhe {

int base_extend_wide(const uint32_t* x, const uint32_t* w, uint32_t* out,
                     const uint32_t* ext, int Ls, int Ld, long long total,
                     int centered, int vec, cudaStream_t stream) {
  return base_extend_counts<kNarrowSrc + 1, kMaxSrc>(
      x, w, out, ext, Ls, Ld, total, centered, vec, stream);
}

int base_extend_sum_wide(const uint32_t* ys, const uint32_t* alpha,
                         uint32_t* out, const uint32_t* ext, int Ls, int Ld,
                         long long total, int vec, cudaStream_t stream) {
  return base_extend_sum_counts<kNarrowSrc + 1, kMaxSrc>(
      ys, alpha, out, ext, Ls, Ld, total, vec, stream);
}

}  // namespace fhe
