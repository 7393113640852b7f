// Hopper kernels of the RNS fast base extension (HPS conversion): K4 replaces
// fhe_study_tpu/ops/ext_pallas.py::base_extend_fused (_ext_fused_kernel), K11
// (further down) base_extend_sum.
//
// out_j = sum_i y_i * (S/s_i) - alpha * S  (mod d_j),
//   y_i = x_i * (S/s_i)^-1 mod s_i,
//   alpha = (sum_i y_i * floor(2^59/s_i) [+ 2^58 centered]) >> 59,
// with the optional epilogue out_j = (w_j - out_j) * c_j mod d_j (the BFV
// t/Q scaling and the hybrid relinearization's P-division).
//
// Layout: the op is fully per coefficient, so one thread owns one
// coefficient: it reads its Ls source residues (neighbouring threads read
// neighbouring words of each source row — coalesced), keeps the y_i in
// registers, forms the 64-bit alpha natively and writes its Ld outputs.
// What bounds it: (Ls + Ld) words in and Ld (+ Ld of w) out per
// coefficient against ~(Ls * Ld) Shoup products, about 10 integer ops per
// byte at Ls = 4, Ld = 5 — near the card's memory/issue balance point; the
// conversion is one pass over device memory with no intermediate arrays.

#include "modarith.cuh"

namespace fhe {
namespace {

__global__ void base_extend_kernel(const uint32_t* __restrict__ x,
                                   const uint32_t* __restrict__ w,
                                   uint32_t* __restrict__ out,
                                   const uint32_t* __restrict__ ext, int Ls,
                                   int Ld, long long total, int centered) {
  const ExtTable e{ext, Ls, Ld};
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       c < total; c += step) {
    uint32_t ys[kMaxSrc];
    const uint32_t alpha = ext_lift(x + c, total, e, centered != 0, ys);
    for (int j = 0; j < Ld; ++j) {
      uint32_t v = ext_to(ys, alpha, j, e);
      if (w != nullptr) {
        const uint32_t d = e.dst(j, 0);
        v = shoup_mul(submod(w[j * total + c], v, d), e.dst(j, 3),
                      e.dst(j, 4), d);
      }
      out[j * total + c] = v;
    }
  }
}

// K11 — replaces ext_pallas.py::base_extend_sum (_ext_kernel): the second
// half of the conversion alone, for a caller that holds (ys, alpha) already:
// out_j = sum_i ys_i * (S/s_i) - alpha * S  (mod d_j).  Same layout as above
// (one thread per coefficient, the Ls words in registers) and the same packed
// table; Ls + 1 words in and Ld out per coefficient against Ls * Ld Shoup
// products, so bytes bound it while Ld stays small.
__global__ void base_extend_sum_kernel(const uint32_t* __restrict__ ys,
                                       const uint32_t* __restrict__ alpha,
                                       uint32_t* __restrict__ out,
                                       const uint32_t* __restrict__ ext,
                                       int Ls, int Ld, long long total) {
  const ExtTable e{ext, Ls, Ld};
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       c < total; c += step) {
    uint32_t y[kMaxSrc];
    for (int i = 0; i < Ls; ++i) y[i] = ys[i * total + c];
    const uint32_t al = alpha[c];
    for (int j = 0; j < Ld; ++j) out[j * total + c] = ext_to(y, al, j, e);
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // grid-stride beyond this

unsigned grid_for(long long total) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace
}  // namespace fhe

using namespace fhe;

extern "C" int fhe_base_extend(const uint32_t* x, const uint32_t* w,
                               uint32_t* out, const uint32_t* ext, int Ls,
                               int Ld, long long total, int centered,
                               cudaStream_t stream) {
  if (Ls < 1 || Ls > kMaxSrc || total < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  base_extend_kernel<<<grid_for(total), kThreads, 0, stream>>>(
      x, w, out, ext, Ls, Ld, total, centered);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fhe_base_extend_sum(const uint32_t* ys, const uint32_t* alpha,
                                   uint32_t* out, const uint32_t* ext, int Ls,
                                   int Ld, long long total,
                                   cudaStream_t stream) {
  if (Ls < 1 || Ls > kMaxSrc || total < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  base_extend_sum_kernel<<<grid_for(total), kThreads, 0, stream>>>(
      ys, alpha, out, ext, Ls, Ld, total);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fhe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
