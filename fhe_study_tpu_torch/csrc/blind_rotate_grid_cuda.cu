// K10's third layout: the whole TFHE blind rotation past one block's
// polynomial — replaces, with csrc/blind_rotate_cuda.cu and csrc/
// blind_rotate_dm_cuda.cu, fhe_study_tpu/ops/blind_rotate_pallas.py::
// blind_rotate_fused at n = 2^16 .. 2^22 (ops/blind_rotate_cuda.py::_plan
// takes it past 2^15, where 256 KB of one polynomial's words outgrow the
// 227 KB of shared memory a block can have; 2^22 is the end of the
// reference's gate: the CRT pair's 2n-th roots).
//
//   acc <- acc + BSK_j [x] (acc * X^-h_j - acc)      for j = 0 .. steps-1
//
// computed exactly as the other layouts and the step-by-step chain
// (models/tfhe/tggsw.py::cmux_evals): the digits of the rotated difference,
// forward NTTs of the C*l digit polynomials under both CRT primes, the
// Shoup contraction against the step's key planes, 2C inverse NTTs per
// prime with n^-1, the exact centred CRT lift, the two 32-bit key limbs
// recombined mod 2^64 and the wrapping add.  Each transform runs across
// blocks as csrc/ntt_chunks.cuh runs K1's and K9's past 2^15, in the same
// order and butterflies, with the scheme's steps folded into its first and
// last passes.  A step is these launches on the caller's stream, all queued
// by the one C call for the whole chain:
//
//   top forward    the forward's top passes over each digit polynomial
//                  (ciphertext, prime, digit) of tmp [B, 2, F, n]; the first
//                  forms its 2^K words a thread from the rotated accumulator
//                  (br_digit);
//   chunk forward  one block a chunk of 2^15 words from tmp into dig
//                  [B, 2, F, n] (ntt_chunk_kernel, K1's chain);
//   chunk inverse  one block a chunk of each output column (ciphertext,
//                  prime, column): the contraction of the F digit rows'
//                  chunk against the key chunk in the first inverse pass
//                  (br_contract_pass), the chain, the words into col (tmp's
//                  words again: [B, 2, 2C, n]) without n^-1;
//   top inverse    the inverse's top passes over each column, the last one a
//                  thread per (ciphertext, component) and word set: both
//                  limb columns under both primes, n^-1, the CRT lift, the
//                  limbs recombined and added to the accumulator (each word
//                  by one thread: no atomics).
//
// What bounds it: the butterflies and Shoup products, as the other layouts
// (utils/kernel_check.py::cmux_step_ops), beside a device-memory traffic a
// step that grows by a read and a write of the digit evaluations and of the
// columns per top pass (utils/kernel_check.py::cmux_step_bytes).

#include <climits>
#include <cstdint>

#include "blind_rotate.cuh"
#include "modarith.cuh"
#include "ntt_chunks.cuh"
#include "radix_chain.cuh"

namespace fhe {
namespace {

constexpr int kGridPrimes = 2;     // the CRT primes

// Step j, forward top pass over bits [lo, lo + K) of every digit polynomial
// (b * 2 + p) * F + f of tmp [B, 2, F, n] (digit f = c l + i of component c
// under prime p); FIRST forms the words from the rotated accumulator acc
// [B, C, n].  tw / tw_sh: the forward chunk tables [2, 2^s, 2^15].
template <int K, bool FIRST>
__global__ void __launch_bounds__(kTopThreads)
    brg_top_forward_kernel(const int* __restrict__ shifts,
                           const unsigned long long* __restrict__ acc,
                           uint32_t* tmp, const uint32_t* __restrict__ tw,
                           const uint32_t* __restrict__ tw_sh,
                           const uint32_t* __restrict__ cons, int j, int B,
                           int C, int l, int w, int logn, int lo) {
  const int per = (1 << (logn - K)) / kTopThreads;
  const int poly = blockIdx.x / per;
  const int v = (blockIdx.x - poly * per) * kTopThreads + threadIdx.x;
  const int F = C * l;
  const int bp = poly / F;                   // b * 2 + p
  const int p = bp & 1;
  const size_t n = static_cast<size_t>(1) << logn;
  const int base = top_base(v, lo, K);
  uint32_t* row = tmp + poly * n + base;
  uint32_t x[1 << K];
  if constexpr (FIRST) {
    const int b = bp >> 1;
    const int f = poly - bp * F;
    const int cc = f / l;
    const int shift = 64 - w * (f - cc * l + 1);
    const uint32_t mask = (1u << w) - 1u;    // w <= 31
    const int h = shifts[static_cast<size_t>(j) * B + b] &
                  static_cast<int>(2 * n - 1);
    const unsigned long long* ac = acc + (static_cast<size_t>(b) * C + cc) * n;
#pragma unroll
    for (int k = 0; k < (1 << K); ++k) {
      x[k] = br_digit(ac, base + (k << lo), h, logn, shift, mask);
    }
  } else {
#pragma unroll
    for (int k = 0; k < (1 << K); ++k) x[k] = row[static_cast<size_t>(k) << lo];
  }
  top_stages<K, false>(x, base, lo, logn, tw + p * n, tw_sh + p * n,
                       prime_row(cons, p).q);
#pragma unroll
  for (int k = 0; k < (1 << K); ++k) row[static_cast<size_t>(k) << lo] = x[k];
}

// Step j, the contraction and the inverse chain of chunk r of output column
// o (= 2 c' + limb) of ciphertext b under prime p: block ((b * 2 + p) * 2C +
// o) 2^s + r.  dig [B, 2, F, n]; ev1/ev2 (values) and ev1s/ev2s (Shoup
// companions) [steps, F, 2C, n]; col [B, 2, 2C, n]; twinv / twinv_sh the
// inverse chunk tables [2, 2^s, 2^15].
__global__ void __launch_bounds__(OneBuffer<kChunkLogN>::threads,
                                  OneBuffer<kChunkLogN>::blocks)
    brg_chunk_inverse_kernel(const uint32_t* __restrict__ dig,
                             const uint32_t* __restrict__ ev1,
                             const uint32_t* __restrict__ ev1s,
                             const uint32_t* __restrict__ ev2,
                             const uint32_t* __restrict__ ev2s,
                             uint32_t* __restrict__ col,
                             const uint32_t* __restrict__ twinv,
                             const uint32_t* __restrict__ twinv_sh,
                             const uint32_t* __restrict__ cons, int j, int C,
                             int l, int s, int vec) {
  using S = typename OneBuffer<kChunkLogN>::Shape;
  constexpr int c = S::n;
  constexpr int last = S::passes - 1;
  constexpr int cl = S::inv_c(last);
  extern __shared__ uint32_t a[];
  const int F = C * l;
  const int cols = 2 * C;
  const int ro = blockIdx.x >> s;            // (b * 2 + p) * cols + o
  const int r = blockIdx.x & ((1 << s) - 1);
  const int bp = ro / cols;
  const int o = ro - bp * cols;
  const int p = bp & 1;
  const size_t n = static_cast<size_t>(c) << s;
  const uint32_t q = prime_row(cons, p).q;
  const size_t chunk = static_cast<size_t>(r) * c;
  const uint32_t* iw = twinv + p * n + chunk;
  const uint32_t* iwsh = twinv_sh + p * n + chunk;
  const size_t kj = static_cast<size_t>(j) * F * cols;
  const uint32_t* kv = (p ? ev2 : ev1) + (kj + o) * n + chunk;
  const uint32_t* ks = (p ? ev2s : ev1s) + (kj + o) * n + chunk;
  const uint32_t* dr = dig + static_cast<size_t>(bp) * F * n + chunk;
  br_contract_pass<kChunkLogN>(a, dr, static_cast<int>(n), kv, ks,
                               static_cast<int>(cols * n), F, q, iw, iwsh,
                               vec);
  __syncthreads();
  RadixPasses<kChunkLogN, 1, last, true, S::threads>::run(a, iw, iwsh, q);
  uint32_t* out = col + static_cast<size_t>(ro) * n + chunk;
#pragma unroll 1
  for (int g = 0; g < S::groups; ++g) {
    const int base = radix_base(threadIdx.x + g * S::threads, cl);
    uint32_t x[kRadix];
    radix_load<cl>(x, a, base);
    radix_pass<kChunkLogN, last, true>(x, base, iw, iwsh, q);
#pragma unroll
    for (int k = 0; k < kRadix; ++k) out[base + (k << cl)] = x[k];
  }
}

// An inverse top pass over bits [lo, lo + K) of every column (b * 2 + p) *
// 2C + o of col [B, 2, 2C, n], in place; not the last.
template <int K>
__global__ void __launch_bounds__(kTopThreads)
    brg_top_inverse_kernel(uint32_t* col, const uint32_t* __restrict__ twinv,
                           const uint32_t* __restrict__ twinv_sh,
                           const uint32_t* __restrict__ cons, int cols,
                           int logn, int lo) {
  const int per = (1 << (logn - K)) / kTopThreads;
  const int poly = blockIdx.x / per;
  const int v = (blockIdx.x - poly * per) * kTopThreads + threadIdx.x;
  const int p = (poly / cols) & 1;
  const size_t n = static_cast<size_t>(1) << logn;
  const int base = top_base(v, lo, K);
  uint32_t* row = col + poly * n + base;
  uint32_t x[1 << K];
#pragma unroll
  for (int k = 0; k < (1 << K); ++k) x[k] = row[static_cast<size_t>(k) << lo];
  top_stages<K, true>(x, base, lo, logn, twinv + p * n, twinv_sh + p * n,
                      prime_row(cons, p).q);
#pragma unroll
  for (int k = 0; k < (1 << K); ++k) row[static_cast<size_t>(k) << lo] = x[k];
}

// The last inverse top pass, bits [lo, lo + K) up to log n - 1, with the
// step's end: per component c' of ciphertext b (polynomial b C + c'), both
// limb columns 2 c' + limb under both primes, n^-1, the CRT lift, the limbs
// recombined mod 2^64 and added to the accumulator acc [B, C, n].  cons rows
// (q0, -, n^-1, sh), (q1, -, n^-1, sh), (q1, -, q0^-1 mod q1, sh).
template <int K>
__global__ void __launch_bounds__(kTopThreads)
    brg_top_last_kernel(const uint32_t* __restrict__ col,
                        unsigned long long* __restrict__ acc,
                        const uint32_t* __restrict__ twinv,
                        const uint32_t* __restrict__ twinv_sh,
                        const uint32_t* __restrict__ cons, int C, int logn,
                        int lo) {
  const int per = (1 << (logn - K)) / kTopThreads;
  const int poly = blockIdx.x / per;         // b * C + c'
  const int v = (blockIdx.x - poly * per) * kTopThreads + threadIdx.x;
  const int b = poly / C;
  const int cc = poly - b * C;
  const int cols = 2 * C;
  const size_t n = static_cast<size_t>(1) << logn;
  const int base = top_base(v, lo, K);
  const PrimeRow c0 = prime_row(cons, 0), c1 = prime_row(cons, 1);
  const PrimeRow crt = prime_row(cons, 2);
  unsigned long long sum[1 << K];
#pragma unroll
  for (int k = 0; k < (1 << K); ++k) sum[k] = 0;
#pragma unroll 1
  for (int limb = 0; limb < 2; ++limb) {
    const int o = 2 * cc + limb;
    const uint32_t* r0w =
        col + (static_cast<size_t>(b * kGridPrimes) * cols + o) * n + base;
    const uint32_t* r1w = r0w + cols * n;
    uint32_t x0[1 << K], x1[1 << K];
#pragma unroll
    for (int k = 0; k < (1 << K); ++k) {
      x0[k] = __ldg(r0w + (static_cast<size_t>(k) << lo));
      x1[k] = __ldg(r1w + (static_cast<size_t>(k) << lo));
    }
    top_stages<K, true>(x0, base, lo, logn, twinv, twinv_sh, c0.q);
    top_stages<K, true>(x1, base, lo, logn, twinv + n, twinv_sh + n, c1.q);
#pragma unroll
    for (int k = 0; k < (1 << K); ++k) {
      const uint32_t r0 = shoup_mul(x0[k], c0.fin, c0.fin_sh, c0.q);
      const uint32_t r1 = shoup_mul(x1[k], c1.fin, c1.fin_sh, c1.q);
      sum[k] += br_lift(r0, r1, c0.q, c1.q, crt) << (32 * limb);
    }
  }
  unsigned long long* ac = acc + static_cast<size_t>(poly) * n + base;
#pragma unroll
  for (int k = 0; k < (1 << K); ++k) ac[static_cast<size_t>(k) << lo] += sum[k];
}

template <bool FIRST>
struct TopForward {
  template <int K>
  static auto kernel() { return &brg_top_forward_kernel<K, FIRST>; }
};

struct TopInverse {
  template <int K>
  static auto kernel() { return &brg_top_inverse_kernel<K>; }
};

struct TopLast {
  template <int K>
  static auto kernel() { return &brg_top_last_kernel<K>; }
};

}  // namespace

// The grid layout of K10, called by fhe_blind_rotate (csrc/
// blind_rotate_cuda.cu) for the plan's layout 2 at n = 2^16 .. 2^22:
// threads and smem a chunk's one-buffer shape (ops/blind_rotate_cuda.py::
// _plan), tw .. twinv_sh the chunk tables of both primes, scratch [B, 2,
// F + max(F, 2C), n] 32-bit words (16-byte aligned): the digit evaluations
// dig, then tmp (the forward's top passes, then the columns), vec the key
// planes' 16-byte alignment.
int blind_rotate_grid(const int* shifts, const unsigned long long* acc0,
                      const uint32_t* ev1, const uint32_t* ev1s,
                      const uint32_t* ev2, const uint32_t* ev2s,
                      unsigned long long* out, uint32_t* scratch,
                      const uint32_t* tw, const uint32_t* tw_sh,
                      const uint32_t* twinv, const uint32_t* twinv_sh,
                      const uint32_t* cons, int steps, int B, int C, int l,
                      int w, int logn, int threads, int smem, int vec,
                      cudaStream_t stream) {
  using S = typename OneBuffer<kChunkLogN>::Shape;
  if (logn <= kChunkLogN || logn > kChunkLogN + 7 || scratch == nullptr ||
      misaligned(scratch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (threads != S::threads ||
      smem != S::n * static_cast<int>(sizeof(uint32_t))) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int s = logn - kChunkLogN;
  const int F = C * l, cols = 2 * C;
  const size_t n = static_cast<size_t>(1) << logn;
  const long long dig_polys = static_cast<long long>(B) * kGridPrimes * F;
  const long long col_polys = static_cast<long long>(B) * kGridPrimes * cols;
  const int passes = top_passes(logn);
  // every launch's grid within reach (the widest: a top pass of one stage
  // over the digit polynomials, and the chunk chains), and the
  // contraction's 32-bit offsets (F 2C n words of a step's key slice)
  if (static_cast<long long>(F) * cols << logn > INT_MAX ||
      top_blocks(dig_polys, logn, 1) > INT_MAX ||
      top_blocks(col_polys, logn, 1) > INT_MAX ||
      (dig_polys << s) > INT_MAX || (col_polys << s) > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  uint32_t* dig = scratch;
  uint32_t* tmp = scratch + static_cast<size_t>(dig_polys) * n;
  cudaError_t err = allow_smem(&brg_chunk_inverse_kernel, smem);
  if (err == cudaSuccess) {
    err = allow_smem(&ntt_chunk_kernel<0, uint32_t, uint32_t>, smem);
  }
  if (err == cudaSuccess) {
    err = cudaMemcpyAsync(out, acc0,
                          sizeof(unsigned long long) * B * C * n,
                          cudaMemcpyDeviceToDevice, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int last_K = top_bits(logn, 0), last_lo = top_lo(logn, 0);
  int e = 0;
#pragma unroll 1
  for (int j = 0; j < steps && e == 0; ++j) {
    for (int t = 0; t < passes && e == 0; ++t) {
      const int K = top_bits(logn, t), lo = top_lo(logn, t);
      const long long blocks = top_blocks(dig_polys, logn, K);
      e = t == 0 ? top_pass_launch<TopForward<true>>(
                       K, blocks, stream, shifts, out, tmp, tw, tw_sh, cons,
                       j, B, C, l, w, logn, lo)
                 : top_pass_launch<TopForward<false>>(
                       K, blocks, stream, shifts, out, tmp, tw, tw_sh, cons,
                       j, B, C, l, w, logn, lo);
    }
    if (e != 0) break;
    ntt_chunk_kernel<0, uint32_t, uint32_t>
        <<<static_cast<unsigned>(dig_polys << s), threads, smem, stream>>>(
            tmp, dig, tw, tw_sh, cons, F, kGridPrimes, s, 0, 1);
    brg_chunk_inverse_kernel<<<static_cast<unsigned>(col_polys << s),
                               threads, smem, stream>>>(
        dig, ev1, ev1s, ev2, ev2s, tmp, twinv, twinv_sh, cons, j, C, l, s,
        vec);
    e = static_cast<int>(cudaGetLastError());
    for (int t = passes - 1; t >= 1 && e == 0; --t) {
      const int K = top_bits(logn, t), lo = top_lo(logn, t);
      e = top_pass_launch<TopInverse>(K, top_blocks(col_polys, logn, K),
                                      stream, tmp, twinv, twinv_sh, cons,
                                      cols, logn, lo);
    }
    if (e == 0) {
      e = top_pass_launch<TopLast>(
          last_K, top_blocks(static_cast<long long>(B) * C, logn, last_K),
          stream, tmp, out, twinv, twinv_sh, cons, C, logn, last_lo);
    }
  }
  if (e != 0) return e;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fhe
