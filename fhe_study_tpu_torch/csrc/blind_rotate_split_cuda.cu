// K10's fourth layout: the whole TFHE blind rotation at n = 2^16, each
// polynomial split over the shared memory of the blocks of a cluster —
// replaces, with csrc/blind_rotate_cuda.cu, blind_rotate_dm_cuda.cu and
// blind_rotate_grid_cuda.cu, fhe_study_tpu/ops/blind_rotate_pallas.py::
// blind_rotate_fused at n = 2^16 (ops/blind_rotate_cuda.py::_plan takes it
// there from the shape alone; the grid layout stays past it).
//
//   acc <- acc + BSK_j [x] (acc * X^-h_j - acc)      for j = 0 .. steps-1
//
// computed exactly as the other layouts and the step-by-step chain
// (models/tfhe/tggsw.py::cmux_evals): the digits of the rotated difference,
// forward NTTs of the C*l digit polynomials under both CRT primes, the
// contraction against the step's key planes, 2C inverse NTTs per
// prime with n^-1, the exact centred CRT lift, the two 32-bit key limbs
// recombined mod 2^64 and the wrapping add.  Each transform is the chunked
// schedule of csrc/ntt_chunks.cuh at one top stage (bit 15) and two chunks
// of 2^15 words, the halves r = 0, 1 (radix_chain.cuh's Split on one
// buffer), in the same order and butterflies, under the chunk tables at
// n = 2^16, which are the split's: row (prime, r) holds the roots of half r's
// chain and, at word 0, the top stage's.  State in device memory: the
// accumulator [B, C, n] of 64-bit words (the output tensor, a copy of acc0
// first) and the digit scratch [B, 2, C*l, n] of the device-memory and grid
// layouts (same order: the key planes of tggsw.precompute_evals serve all
// three).  A step is two launches on the caller's stream, which orders them:
//
//   forward  one block per (ciphertext, digit polynomial, prime, half), 4 B C
//            l blocks at OneBuffer<15>'s shape (512 threads, 128 KB, one
//            block an SM), numbered so that the 4 l blocks that read one
//            accumulator component (its digits, primes and halves) run side
//            by side: the first pass forms the 16 words of half r after the
//            top stage (split_word) from the digits at i and i + 2^15 of the
//            rotated accumulator, the chain of 2^15 words runs under row
//            (p, r), and the evaluations leave in coalesced 16-byte stores to
//            the scratch row's half r (forming each digit in both blocks of
//            its prime, with no cluster, measured faster than one block a
//            half forming its own digits and the top stage through
//            distributed shared memory between two cluster barriers);
//   inverse  one cluster of four blocks per (ciphertext, output column
//            o = 2 c' + limb), block (p, r) on prime p and half r, 4 B 2C
//            blocks: the contraction of half r of the F digit rows against
//            the key's values by Montgomery products (the Shoup planes are
//            not read: a third fewer bytes, the contraction's L2 traffic
//            being what holds this launch back) in the first inverse pass,
//            the chain of 2^15 words (without n^-1), then the top inverse
//            stage with n^-1 2^32 (the host's final multiplier) between
//            the two halves of prime p through distributed shared memory
//            (split_top_stage: the result in the blocks' own shared memory),
//            a cluster barrier, and block (p, r) lifts quarter p of half r of
//            the column, reading the other prime's words through distributed
//            shared memory, and adds the limb-shifted integer into the
//            accumulator by 64-bit atomics (the two limb columns of a
//            component add into the same words: exact in any order); a last
//            cluster barrier keeps every block's shared memory alive until
//            its peers have read it.
//
// What bounds it: the butterflies and Shoup products, as the other layouts
// (utils/kernel_check.py::cmux_step_ops), the issue rate; device memory
// moves the device-memory layout's bytes a step (cmux_step_bytes: the
// scratch written and read back once, the accumulator read and added to,
// the key slice's values once), not the grid layout's round trip of the
// digit polynomials and columns through a top pass.  The launches' reads
// go through L2: the accumulator component, read by the 4 l neighbouring
// forward blocks (at i and i + 2^15: each digit formed by the two blocks
// of its prime), and
// the key slice, by every ciphertext's inverse clusters (the four columns
// of a ciphertext side by side, sharing its digit rows).  Clusters of four
// one-block-an-SM blocks leave the SMs of a GPC that four does not divide
// idle in the inverse launch (fhe_blind_rotate_split_clusters).

#include <climits>
#include <cstdint>

#include "blind_rotate.cuh"
#include "modarith.cuh"
#include "radix_chain.cuh"

namespace fhe {
namespace {

constexpr int kSplitLogN = kWideLogN + 1;  // n = 2^16, halves of 2^15
constexpr int kSplitPrimes = 2;            // the CRT primes
constexpr int kSplitCluster = 4;           // inverse: two primes, two halves
using Half = OneBuffer<kWideLogN>;

// Step j's forward blocks: block ((b * F + f) * 2 + p) * 2 + r takes half r
// of digit polynomial f = c * l + i of ciphertext b under prime p.  acc
// [B, C, n]; dig [B, 2, F, n]; tw / tw_sh the forward chunk tables [2, 2,
// 2^15]; cons as the cluster layout's.
__global__ void __launch_bounds__(Half::threads, Half::blocks)
    brs_forward_kernel(const int* __restrict__ shifts,
                       const unsigned long long* __restrict__ acc,
                       uint32_t* __restrict__ dig,
                       const uint32_t* __restrict__ tw,
                       const uint32_t* __restrict__ tw_sh,
                       const uint32_t* __restrict__ cons, int j, int B, int C,
                       int l, int w) {
  using S = Half::Shape;
  constexpr int h = S::n;
  constexpr int n = 2 * h;
  constexpr int c0 = S::fwd_c(0);
  extern __shared__ __align__(16) uint32_t a[];
  const int F = C * l;
  const int r = blockIdx.x & 1;
  const int p = (blockIdx.x >> 1) & 1;
  const int bf = blockIdx.x >> 2;            // b * F + f
  const int b = bf / F;
  const int f = bf - b * F;
  const int cc = f / l;
  const int shift = 64 - w * (f - cc * l + 1);
  const uint32_t mask = (1u << w) - 1u;      // w <= 31
  const PrimeRow pr = prime_row(cons, p);
  const size_t trow = static_cast<size_t>(p * 2 + r) * h;
  const uint32_t* fw = tw + trow;
  const uint32_t* fwsh = tw_sh + trow;
  const uint32_t w1 = __ldg(fw), w1sh = __ldg(fwsh);   // the top stage's
  const int hs = shifts[static_cast<size_t>(j) * B + b] & (2 * n - 1);
  const unsigned long long* ac = acc + (static_cast<size_t>(b) * C + cc) * n;
  const auto digit = [&](int e) {
    return br_digit(ac, e, hs, kSplitLogN, shift, mask);
  };
  // pass 0 from the rotated accumulator: virtual thread v holds elements
  // v + (k << c0) of half r after the top stage
#pragma unroll 1
  for (int g = 0; g < S::groups; ++g) {
    const int v = threadIdx.x + g * S::threads;   // radix_base(v, c0)
    uint32_t x[kRadix];
#pragma unroll
    for (int k = 0; k < kRadix; ++k) {
      x[k] = split_word(digit, v + (k << c0), h, r, w1, w1sh, pr.q);
    }
    radix_pass<kWideLogN, 0, false>(x, v, fw, fwsh, pr.q);
    radix_store<c0>(a, x, v);
  }
  __syncthreads();
  RadixPasses<kWideLogN, 1, S::passes, false, S::threads>::run(
      a, radix_opaque(fw), radix_opaque(fwsh), pr.q);
  // half r of the evaluations in natural order, lane i storing 4i .. 4i + 3
  uint4* row = reinterpret_cast<uint4*>(
      dig + ((static_cast<size_t>(b) * kSplitPrimes + p) * F + f) * n +
      static_cast<size_t>(r) * h);
  for (int i = threadIdx.x; i < h / 4; i += S::threads) {
    const int sw = radix_swizzle(4 * i);
    row[i] = make_uint4(a[sw], a[sw ^ 1], a[sw ^ 2], a[sw ^ 3]);
  }
}

// Step j's inverse blocks, in clusters of four: cluster b * 2C + o takes
// output column o = 2 c' + limb of ciphertext b, its block of rank
// p * 2 + r prime p and half r.  ev1/ev2 (values) and ev1s/ev2s (Shoup
// companions, unread here) [steps, F, 2C, n]; acc [B, C, n] accumulated in
// place; twinv / twinv_sh the inverse chunk tables [2, 2, 2^15]; cons rows
// (q0, -q0^-1 mod 2^32, n^-1 2^32, sh), (q1, -q1^-1 mod 2^32, n^-1 2^32,
// sh), (q1, -, q0^-1 mod q1, sh).
__global__ void __launch_bounds__(Half::threads, Half::blocks)
    brs_inverse_kernel(const uint32_t* __restrict__ dig,
                       const uint32_t* __restrict__ ev1,
                       const uint32_t* __restrict__ ev1s,
                       const uint32_t* __restrict__ ev2,
                       const uint32_t* __restrict__ ev2s,
                       unsigned long long* __restrict__ acc,
                       const uint32_t* __restrict__ twinv,
                       const uint32_t* __restrict__ twinv_sh,
                       const uint32_t* __restrict__ cons, int j, int C, int l,
                       int vec) {
  using S = Half::Shape;
  constexpr int h = S::n;
  constexpr int n = 2 * h;
  extern __shared__ __align__(16) uint32_t a[];
  const int F = C * l;
  const int cols = 2 * C;
  const int rank = blockIdx.x & (kSplitCluster - 1);
  const int p = rank >> 1;
  const int r = rank & 1;
  const int bo = blockIdx.x / kSplitCluster;   // b * cols + o
  const int b = bo / cols;
  const int o = bo - b * cols;
  const PrimeRow pr = prime_row(cons, p);
  const uint32_t q = pr.q;
  const size_t trow = static_cast<size_t>(p * 2 + r) * h;
  const uint32_t* iw = twinv + trow;
  const uint32_t* iwsh = twinv_sh + trow;
  const size_t kj = static_cast<size_t>(j) * F * cols;
  const size_t half = static_cast<size_t>(r) * h;
  const uint32_t* kv = (p ? ev2 : ev1) + (kj + o) * n + half;
  const uint32_t* dr =
      dig + (static_cast<size_t>(b) * kSplitPrimes + p) * F * n + half;
  // the contraction in the first inverse pass's registers (Montgomery
  // products: a factor 2^-32 that fin takes back), then the chain of half
  // r, fin left to the top stage
  br_contract_pass<kWideLogN, true>(a, dr, n, kv, nullptr, cols * n, F, q,
                                    iw, iwsh, vec, pr.nq);
  __syncthreads();
  RadixPasses<kWideLogN, 1, S::passes, true, S::threads>::run(a, iw, iwsh,
                                                               q);
  const uint32_t t = __ldg(iw), tsh = __ldg(iwsh);   // the top stage's
  // both halves of prime p are through their chains
  cluster_sync();
  split_top_stage<kWideLogN, S::threads, true>(
      a, r, cluster_addr(a, rank ^ 1), t, tsh, pr.fin, pr.fin_sh, q);
  // both primes' columns are complete and visible to the cluster
  cluster_sync();
  const uint32_t other = cluster_addr(a, rank ^ 2);   // prime p ^ 1, half r
  const uint32_t q0 = prime_row(cons, 0).q, q1 = prime_row(cons, 1).q;
  const PrimeRow crt = prime_row(cons, 2);
  const int limb = o & 1;
  unsigned long long* ac =
      acc + (static_cast<size_t>(b) * C + (o >> 1)) * n + half;
  // exact CRT lift of (r_0, r_1) to the centred integer, shifted to its
  // limb, added mod 2^64: elements p h/2 .. (p + 1) h/2 - 1 of half r
#pragma unroll 1
  for (int i = p * (h / 2) + threadIdx.x; i < (p + 1) * (h / 2);
       i += S::threads) {
    const int sw = radix_swizzle(i);
    const uint32_t own = a[sw];
    const uint32_t peer = cluster_load(other + 4u * sw);
    const uint32_t r0 = p ? peer : own;
    const uint32_t r1 = p ? own : peer;
    atomicAdd(ac + i, br_lift(r0, r1, q0, q1, crt) << (32 * limb));
  }
  // the peers have read this block's words before any block exits
  cluster_sync();
}

}  // namespace

// The split layout of K10, called by fhe_blind_rotate (csrc/
// blind_rotate_cuda.cu) for the plan's layout 3 at n = 2^16: threads and
// smem a half's one-buffer shape (ops/blind_rotate_cuda.py::_plan), tw ..
// twinv_sh the chunk tables of both primes at 2^16, cons with the final
// multiplier n^-1 2^32 (the Montgomery contraction's), dig the scratch of
// [B, 2, C*l, n] words (16-byte aligned), vec the key planes' 16-byte
// alignment.
int blind_rotate_split(const int* shifts, const unsigned long long* acc0,
                       const uint32_t* ev1, const uint32_t* ev1s,
                       const uint32_t* ev2, const uint32_t* ev2s,
                       unsigned long long* out, uint32_t* dig,
                       const uint32_t* tw, const uint32_t* tw_sh,
                       const uint32_t* twinv, const uint32_t* twinv_sh,
                       const uint32_t* cons, int steps, int B, int C, int l,
                       int w, int logn, int threads, int smem, int vec,
                       cudaStream_t stream) {
  using S = Half::Shape;
  const long long fwd_blocks = 4LL * B * C * l;
  const long long inv_blocks = 4LL * B * 2 * C;
  // the grids within reach, and the contraction's 32-bit offsets (F 2C n
  // words of a step's key slice)
  if (logn != kSplitLogN || dig == nullptr || misaligned(dig) ||
      fwd_blocks > INT_MAX || inv_blocks > INT_MAX ||
      2LL * C * C * l << logn > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (threads != S::threads ||
      smem != S::n * static_cast<int>(sizeof(uint32_t))) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  auto fwd = &brs_forward_kernel;
  auto inv = &brs_inverse_kernel;
  cudaError_t err = allow_smem(fwd, smem);
  if (err == cudaSuccess) err = allow_smem(inv, smem);
  if (err == cudaSuccess) {
    err = cudaMemcpyAsync(out, acc0,
                          sizeof(unsigned long long) * B * C * (2 * S::n),
                          cudaMemcpyDeviceToDevice, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
#pragma unroll 1
  for (int j = 0; j < steps; ++j) {
    fwd<<<static_cast<unsigned>(fwd_blocks), threads, smem, stream>>>(
        shifts, out, dig, tw, tw_sh, cons, j, B, C, l, w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cluster_launch(inv, inv_blocks, kSplitCluster, threads, smem,
                         stream, dig, ev1, ev1s, ev2, ev2s, out, twinv,
                         twinv_sh, cons, j, C, l, vec);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fhe

using namespace fhe;

// The inverse launch's clusters of four that the card in use runs at once.
extern "C" int fhe_blind_rotate_split_clusters(int* clusters) {
  return cluster_occupancy(&brs_inverse_kernel, kSplitCluster,
                           Half::Shape::threads,
                           Half::Shape::n * static_cast<int>(sizeof(uint32_t)),
                           clusters);
}
