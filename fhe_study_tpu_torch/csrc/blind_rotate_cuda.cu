// Hopper kernel of the whole TFHE blind rotation — replaces
// fhe_study_tpu/ops/blind_rotate_pallas.py::blind_rotate_fused (_br_kernel,
// _br_one_step).
//
//   acc <- acc + BSK_j [x] (acc * X^-h_j - acc)      for j = 0 .. steps-1
//
// in ONE launch: negacyclic rotation by h_j in [0, 2N), wrapping 64-bit
// subtract, base-2^w gadget digits MSB-first, forward NTT of the C*l digit
// polynomials under both CRT primes, Shoup contraction against the
// eval-domain key limbs, C*2 inverse NTTs per prime, exact CRT recombination
// mod 2^64 and the wrapping add — every value equal to the step-by-step
// chain (models/tfhe/tggsw.py::cmux_evals).
//
// Layout: the chain is sequential in j and independent across ciphertexts,
// so one thread block owns one ciphertext and loops over the steps.  Its
// accumulator (C*N 64-bit words), the digit polynomials of both primes
// (2*C*l*N words) and the contracted columns (2*C*2*N words) stay in shared
// memory for the whole chain: 80 KB at N = 1024, C = 2, l = 2.  The rotation
// is an indexed read of the accumulator, out[k] = +-acc[(k + h) mod N].  The
// two primes' chains run side by side in one stage loop, so a step costs
// 2 log N barriers for its transforms instead of 4 log N.  The number of
// polynomials side by side (C*l forward, C*2 inverse; 4 and 4, or 6 and 4)
// is a run-time loop bound, not a template parameter: one compiled kernel
// serves every (C, l), and the only cost is the shift and compare that pick
// a butterfly's polynomial and prime.  The step's key slice (4 planes of
// C*l*C*2*N words) is read straight from device memory, each word once per
// block per step; all blocks walk the key in the same order, so L2 serves
// most of it.
//
// What bounds it: per step and ciphertext about 2*(C*l + 2C)*(N/2)*log N
// butterflies and 2*2C*C*l*N Shoup products — roughly 1.2 M integer
// operations at N = 1024, C = 2, l = 2 — against 256 KB of key that all
// blocks share, so it is bound by integer throughput, shared-memory traffic and
// the ~25 barriers of a step, not by device memory.  One block per
// ciphertext leaves SMs idle when the batch is below the SM count (64
// blocks on 132 SMs); splitting one ciphertext over a cluster is later
// work.

#include "modarith.cuh"

namespace fhe {
namespace {

// One block of 1,024 threads per SM: without the second launch bound ptxas
// keeps the kernel to 32 registers (room for two blocks an SM) and spills;
// with it the kernel takes 48 and ran 23% faster, and 512 threads ran 33%
// slower, in a side-by-side trial at N = 1024, 64 ciphertexts.
constexpr int kBrThreads = 1024;

// Forward chains of `polys` polynomials per prime, both primes side by
// side: a holds [2][polys][n] words (prime 0 first), w/wsh [2][n] root
// tables.  Stage schedule and butterflies as forward_chain; ends with a
// barrier.
__device__ inline void forward_chain_pair(uint32_t* a, int polys, int logn,
                                          const uint32_t* w,
                                          const uint32_t* wsh, uint32_t q0,
                                          uint32_t q1) {
  const int half = 1 << (logn - 1);
  const int total = 2 * polys * half;
  for (int s = 0; s < logn; ++s) {
    const int lt = logn - 1 - s;
    const int t = 1 << lt;
    const int m = 1 << s;
    for (int kk = threadIdx.x; kk < total; kk += blockDim.x) {
      const int k = kk & (half - 1);
      const int pi = kk >> (logn - 1);
      const int pr = pi >= polys ? 1 : 0;
      const uint32_t q = pr ? q1 : q0;
      uint32_t* poly = a + (static_cast<size_t>(pi) << logn);
      const int i = k >> lt;
      const int idx = (i << (lt + 1)) | (k & (t - 1));
      const int ti = (pr << logn) + m + i;
      const uint32_t u = poly[idx];
      const uint32_t v = shoup_mul(poly[idx + t], w[ti], wsh[ti], q);
      poly[idx] = addmod(u, v, q);
      poly[idx + t] = submod(u, v, q);
    }
    __syncthreads();
  }
}

// Inverse chains (without n^-1) in the same layout; as inverse_chain.
__device__ inline void inverse_chain_pair(uint32_t* a, int polys, int logn,
                                          const uint32_t* winv,
                                          const uint32_t* winvsh, uint32_t q0,
                                          uint32_t q1) {
  const int half = 1 << (logn - 1);
  const int total = 2 * polys * half;
  for (int s = 0; s < logn; ++s) {
    const int lt = s;
    const int t = 1 << lt;
    const int m = half >> s;
    for (int kk = threadIdx.x; kk < total; kk += blockDim.x) {
      const int k = kk & (half - 1);
      const int pi = kk >> (logn - 1);
      const int pr = pi >= polys ? 1 : 0;
      const uint32_t q = pr ? q1 : q0;
      uint32_t* poly = a + (static_cast<size_t>(pi) << logn);
      const int i = k >> lt;
      const int idx = (i << (lt + 1)) | (k & (t - 1));
      const int ti = (pr << logn) + m + i;
      const uint32_t u = poly[idx];
      const uint32_t v = poly[idx + t];
      poly[idx] = addmod(u, v, q);
      poly[idx + t] = shoup_mul(submod(u, v, q), winv[ti], winvsh[ti], q);
    }
    __syncthreads();
  }
}

// K10.  shifts [steps, B]; acc0/out [B, C, n] 64-bit; ev1/ev2 and their
// Shoup companions [steps, C, l, C, 2, n]; tw/twinv [2][n] tables of the two
// primes; cons three rows: (q0, -, n^-1, sh), (q1, -, n^-1, sh) and
// (q1, -, q0^-1 mod q1, sh).
__global__ void __launch_bounds__(kBrThreads, 1)
blind_rotate_kernel(const int* __restrict__ shifts,
                    const unsigned long long* __restrict__ acc0,
                    const uint32_t* __restrict__ ev1,
                    const uint32_t* __restrict__ ev1s,
                    const uint32_t* __restrict__ ev2,
                    const uint32_t* __restrict__ ev2s,
                    unsigned long long* __restrict__ out,
                    const uint32_t* __restrict__ tw,
                    const uint32_t* __restrict__ tw_sh,
                    const uint32_t* __restrict__ twinv,
                    const uint32_t* __restrict__ twinv_sh,
                    const uint32_t* __restrict__ cons, int steps, int B, int C,
                    int l, int w, int logn) {
  extern __shared__ unsigned long long smem[];
  const int n = 1 << logn;
  const int cn = C << logn;              // accumulator words
  const int fw = (C * l) << logn;        // digit words of one prime
  const int rw = (2 * C) << logn;        // contracted words of one prime
  unsigned long long* acc = smem;
  uint32_t* work = reinterpret_cast<uint32_t*>(smem + cn);
  uint32_t* res = work + 2 * fw;
  const int b = blockIdx.x;
  const PrimeRow c0 = prime_row(cons, 0);
  const PrimeRow c1 = prime_row(cons, 1);
  const PrimeRow cr = prime_row(cons, 2);
  const uint32_t q0 = c0.q, q1 = c1.q;
  const unsigned long long m12 = static_cast<unsigned long long>(q0) * q1;
  const unsigned long long half12 = m12 >> 1;
  const uint32_t mask = (1u << w) - 1u;     // w <= 31
  const size_t base = static_cast<size_t>(b) * cn;
  const size_t key_step = (static_cast<size_t>(C) * l * 2 * C) << logn;

  for (int i = threadIdx.x; i < cn; i += blockDim.x) acc[i] = acc0[base + i];
  __syncthreads();

  for (int j = 0; j < steps; ++j) {
    const int h = shifts[static_cast<size_t>(j) * B + b] & (2 * n - 1);
    // digits of acc * X^-h - acc, the same for both primes (digit < 2^w
    // is canonical under either)
    for (int idx = threadIdx.x; idx < cn; idx += blockDim.x) {
      const int k = idx & (n - 1);
      const int src = k + h;             // in [0, 3n)
      unsigned long long r = acc[(idx - k) + (src & (n - 1))];
      if ((src >> logn) & 1) r = 0ull - r;
      const unsigned long long d = r - acc[idx];
      const int c = idx >> logn;
      for (int i = 0; i < l; ++i) {
        const uint32_t dg =
            static_cast<uint32_t>(d >> (64 - w * (i + 1))) & mask;
        const int at = ((c * l + i) << logn) + k;
        work[at] = dg;
        work[fw + at] = dg;
      }
    }
    __syncthreads();
    forward_chain_pair(work, C * l, logn, tw, tw_sh, q0, q1);
    // res[pr][c][limb][k] = sum over (r, i) of digit evals times key
    const size_t kj = static_cast<size_t>(j) * key_step;
    for (int o = threadIdx.x; o < 2 * rw; o += blockDim.x) {
      const int k = o & (n - 1);
      const int col = o >> logn;
      const int pr = col >= 2 * C ? 1 : 0;
      const int cl = col - pr * 2 * C;
      const uint32_t q = pr ? q1 : q0;
      const uint32_t* ev = pr ? ev2 : ev1;
      const uint32_t* evs = pr ? ev2s : ev1s;
      const uint32_t* e = work + pr * fw + k;
      uint32_t s = 0;
      for (int ri = 0; ri < C * l; ++ri) {
        const size_t at =
            kj + (static_cast<size_t>(ri * 2 * C + cl) << logn) + k;
        s = addmod(s, shoup_mul(e[ri << logn], ev[at], evs[at], q), q);
      }
      res[o] = s;
    }
    __syncthreads();
    inverse_chain_pair(res, 2 * C, logn, twinv, twinv_sh, q0, q1);
    // n^-1, exact CRT lift to the centered integer, recombine the two
    // 32-bit key limbs mod 2^64, accumulate
    for (int idx = threadIdx.x; idx < cn; idx += blockDim.x) {
      const int k = idx & (n - 1);
      const int c = idx >> logn;
      unsigned long long val = 0;
      for (int limb = 0; limb < 2; ++limb) {
        const int at = ((c * 2 + limb) << logn) + k;
        const uint32_t r1 = shoup_mul(res[at], c0.fin, c0.fin_sh, q0);
        const uint32_t r2 = shoup_mul(res[rw + at], c1.fin, c1.fin_sh, q1);
        const uint32_t r1p2 = r1 >= q1 ? r1 - q1 : r1;   // q0 < 2 * q1
        const uint32_t dm =
            shoup_mul(submod(r2, r1p2, q1), cr.fin, cr.fin_sh, q1);
        unsigned long long g = r1 + static_cast<unsigned long long>(q0) * dm;
        if (g > half12) g -= m12;
        val += g << (32 * limb);
      }
      acc[idx] += val;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < cn; i += blockDim.x) out[base + i] = acc[i];
}

}  // namespace
}  // namespace fhe

using namespace fhe;

extern "C" int fhe_blind_rotate(
    const int* shifts, const unsigned long long* acc0, const uint32_t* ev1,
    const uint32_t* ev1s, const uint32_t* ev2, const uint32_t* ev2s,
    unsigned long long* out, const uint32_t* tw, const uint32_t* tw_sh,
    const uint32_t* twinv, const uint32_t* twinv_sh, const uint32_t* cons,
    int steps, int B, int C, int l, int w, int logn, cudaStream_t stream) {
  if (logn < kMinLogN || logn > kMaxLogN || steps < 1 || B < 1 || C < 2 ||
      l < 1 || w < 1 || w > 31 || w * l > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t n = static_cast<size_t>(1) << logn;
  const size_t smem = C * n * sizeof(unsigned long long) +
                      (2 * C * l + 4 * C) * n * sizeof(uint32_t);
  cudaError_t err = allow_smem(blind_rotate_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  blind_rotate_kernel<<<B, kBrThreads, smem, stream>>>(
      shifts, acc0, ev1, ev1s, ev2, ev2s, out, tw, tw_sh, twinv, twinv_sh,
      cons, steps, B, C, l, w, logn);
  return static_cast<int>(cudaGetLastError());
}
