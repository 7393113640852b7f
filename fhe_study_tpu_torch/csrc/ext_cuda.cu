// Hopper kernels of the RNS fast base extension (HPS conversion): K4 replaces
// fhe_study_tpu/ops/ext_pallas.py::base_extend_fused (_ext_fused_kernel), K11
// (on K4's structure, csrc/ext.cuh) base_extend_sum; and the lift, the
// first half of the conversion alone (y_i and alpha), which K5 and K6
// launch before their staged form (ext_lift, modarith.cuh; no TPU kernel
// of its own: it is the first half of the conversion inside
// ntt_pallas.py::ext_ntt_u32 and ::tensor_mul4_u32).
//
// out_j = sum_i y_i * (S/s_i) - alpha * S  (mod d_j),
//   y_i = x_i * (S/s_i)^-1 mod s_i,
//   alpha = (sum_i y_i * floor(2^59/s_i) [+ 2^58 centered]) >> 59,
// with the optional epilogue out_j = (w_j - out_j) * c_j mod d_j (the BFV
// t/Q scaling and the hybrid relinearization's P-division).
//
// K4's layout: the op is fully per coefficient.  One instance per source
// count LS = 1 .. 31 keeps the y_i of a thread in LS registers (fully
// unrolled: no run-time-indexed array, so no local memory); this unit holds
// the entry points and the counts 1 .. 15, csrc/ext_wide_cuda.cu the counts
// 16 .. 31, and csrc/ext.cuh the kernels.  In its vector
// form (VEC, when the coefficient count is a multiple of 4 and x, w and out
// are 16-byte aligned) a thread owns 4 consecutive coefficients: one uint4
// load from each of the LS source rows and the Ld rows of w, one uint4 store
// to each of the Ld output rows, and each constant read once for the 4; the
// word form (any count and alignment) owns one coefficient, lanes on
// consecutive words.  Each block first stages the packed table (at most
// 5 (Ls + Ld) + 2 Ls Ld words) into shared memory, so no constant is read
// from device memory per coefficient.  What bounds it: Ls words in (and Ld
// of w) and Ld out per coefficient against ~(Ls * Ld) Shoup products, about
// 5 instructions a byte at Ls = 4, Ld = 5 where the H100 issues 10 for each
// byte its memory moves: the bytes.
// The arithmetic is ext_coeff's of modarith.cuh (Shoup products, the 64-bit
// alpha; 2^58 added to its sum when centered, still below 2^64 at 31
// sources), bit for bit.

#include <cstdint>

#include "ext.cuh"

namespace fhe {
namespace {

// The packed table fits the 48 KB of dynamic shared memory a block gets
// without opting in, and the vector form's operands are 4-word rows on
// 16-byte boundaries.
bool bad_shape(int Ls, int Ld, long long total) {
  return Ls < 1 || Ls > kMaxSrc || Ld < 1 || total < 1 ||
         sizeof(uint32_t) * ext_words(Ls, Ld) > 48 * 1024;
}

bool bad_vec(long long total, const void* a, const void* b, const void* c) {
  return total % kExtVec != 0 || misaligned(a) || misaligned(b) ||
         (c != nullptr && misaligned(c));
}

}  // namespace

int ext_lift(const LiftIn& in, int ops, uint32_t* lift, const uint32_t* ext,
             int Ls, int B, int n, int centered, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * n;
  if (Ls < 1 || Ls > kMaxSrc || ops < 1 || ops > 4 || B < 1 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bool vec = n % kExtVec == 0 && !misaligned(lift);
  for (int o = 0; o < ops; ++o) {
    vec = vec && !misaligned(in.x[o]) && in.sl[o] % kExtVec == 0 &&
          in.sb[o] % kExtVec == 0;
  }
  const size_t smem = sizeof(uint32_t) * ext_words(Ls, 0);
  const dim3 grid(grid_for(vec ? total / kExtVec : total),
                  static_cast<unsigned>(ops));
  if (vec) {
    ext_lift_kernel<1><<<grid, kThreads, smem, stream>>>(in, lift, ext, Ls, B,
                                                          n, centered);
  } else {
    ext_lift_kernel<0><<<grid, kThreads, smem, stream>>>(in, lift, ext, Ls, B,
                                                          n, centered);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fhe

using namespace fhe;

// vec: the vector form (total % 4 == 0 and x, w, out 16-byte aligned, as
// ops/ext_cuda.py::_ext_vec decides); refused otherwise.
extern "C" int fhe_base_extend(const uint32_t* x, const uint32_t* w,
                               uint32_t* out, const uint32_t* ext, int Ls,
                               int Ld, long long total, int centered, int vec,
                               cudaStream_t stream) {
  if (bad_shape(Ls, Ld, total) || (vec && bad_vec(total, x, out, w))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Ls > kNarrowSrc) {
    return base_extend_wide(x, w, out, ext, Ls, Ld, total, centered, vec,
                            stream);
  }
  return base_extend_counts<1, kNarrowSrc>(x, w, out, ext, Ls, Ld, total,
                                           centered, vec, stream);
}

// vec: as fhe_base_extend's, on ys, alpha and out.
extern "C" int fhe_base_extend_sum(const uint32_t* ys, const uint32_t* alpha,
                                   uint32_t* out, const uint32_t* ext, int Ls,
                                   int Ld, long long total, int vec,
                                   cudaStream_t stream) {
  if (bad_shape(Ls, Ld, total) || (vec && bad_vec(total, ys, alpha, out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Ls > kNarrowSrc) {
    return base_extend_sum_wide(ys, alpha, out, ext, Ls, Ld, total, vec,
                                stream);
  }
  return base_extend_sum_counts<1, kNarrowSrc>(ys, alpha, out, ext, Ls, Ld,
                                               total, vec, stream);
}

// The lift alone on contiguous x [Ls, B, n] into lift [Ls + 1, B, n] (row
// Ls alpha): ext_lift's vector form where n % 4 == 0 and x and lift are
// 16-byte aligned, its word form otherwise.
extern "C" int fhe_ext_lift(const uint32_t* x, uint32_t* lift,
                            const uint32_t* ext, int Ls, int B, int n,
                            int centered, cudaStream_t stream) {
  return ext_lift(lift_in(x, B, n), 1, lift, ext, Ls, B, n, centered,
                  stream);
}

extern "C" const char* fhe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
