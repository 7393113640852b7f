// K10's fifth layout: the whole TFHE blind rotation at n = 2^17, each
// polynomial split in four quarters over the shared memory of the blocks of
// a cluster — replaces, with csrc/blind_rotate_cuda.cu,
// blind_rotate_dm_cuda.cu, blind_rotate_split_cuda.cu and
// blind_rotate_grid_cuda.cu, fhe_study_tpu/ops/blind_rotate_pallas.py::
// blind_rotate_fused at n = 2^17 (ops/blind_rotate_cuda.py::_plan takes it
// there from the shape alone; the grid layout stays past it).
//
//   acc <- acc + BSK_j [x] (acc * X^-h_j - acc)      for j = 0 .. steps-1
//
// computed exactly as the other layouts and the step-by-step chain
// (models/tfhe/tggsw.py::cmux_evals): the digits of the rotated difference,
// forward NTTs of the C*l digit polynomials under both CRT primes, the
// contraction against the step's key planes, 2C inverse NTTs per prime
// with n^-1, the exact centred CRT lift, the two 32-bit key limbs
// recombined mod 2^64 and the wrapping add.  Each transform is the chunked
// schedule of csrc/ntt_chunks.cuh at n = 2^17: two top stages (bits 16 and
// 15) and four chunks of 2^15 words, the quarters r = 0 .. 3 (r = 2 b16 +
// b15), in the same order and butterflies, under the chunk tables at 2^17:
// row (prime, r) holds the roots of quarter r's chain, and word 0 of rows
// 1, 2 and 3 the top stages' roots 1 (bit 16) and 2, 3 (bit 15 of the
// halves b16 = 0, 1).  The top stages never touch device memory.  State in
// device memory: the accumulator [B, C, n] of 64-bit words (the output
// tensor, a copy of acc0 first) and the digit scratch [B, 2, C*l, n] of
// the other layouts (same order: the key planes of tggsw.precompute_evals
// serve them all).  A step is two launches on the caller's stream, which
// orders them:
//
//   forward  one cluster of four blocks per (ciphertext, digit polynomial,
//            prime), block r on quarter r, 8 B C l blocks at OneBuffer<15>'s
//            shape (512 threads, 128 KB and the quarter's digits, a byte
//            each, beside it: one block an SM), numbered so that the 8 l
//            blocks that read one accumulator component run side by side:
//            block r forms the digits of its own elements r h + i of the
//            rotated accumulator, byte 16 v + k holding element r h + v +
//            (k << c0) (virtual thread v of pass 0 holds those 16: one
//            16-byte word), a cluster barrier; then each block reads its
//            virtual threads' 16-byte words of the four quarters (three
//            through distributed shared memory), forms its own quarter after
//            both top stages (quarter_top) and runs pass 0 in registers, a
//            cluster barrier; the chain's other passes of 2^15 words under
//            row (p, r), and the evaluations leave in coalesced 16-byte
//            stores to the scratch row's quarter r;
//   inverse  one cluster of eight blocks per (ciphertext, output column
//            o = 2 c' + limb), block rank p * 4 + r on prime p and quarter
//            r, 8 B 2C blocks: the contraction of quarter r of the F digit
//            rows against the key's values by Montgomery products (a factor
//            2^-32 that the final multiplier takes back; the Shoup planes
//            are not read), lanes on consecutive 16-byte words with one
//            row's digit and key words in flight ahead, its sums into shared
//            memory; the chain of 2^15 words from pass 0 (without n^-1);
//            then the two top inverse stages between the quarters of prime
//            p as one radix-4 exchange with n^-1 2^32 (quarter_stages), a
//            cluster barrier before and after; block (p, r) lifts half p of
//            quarter r of the column, reading the other prime's words through
//            distributed shared memory, four a thread at a time, lanes on
//            consecutive words, and adds the limb-shifted integer into the
//            accumulator by 64-bit atomics (the two limb columns of a
//            component add into the same words: exact in any order); a last
//            cluster barrier keeps every block's shared memory alive until
//            its peers have read it.
//
// What bounds it: the butterflies and products, as the other layouts
// (utils/kernel_check.py::cmux_step_ops), the issue rate; device memory
// moves the split layout's bytes a step (cmux_step_bytes): the scratch
// written and read back once, the accumulator read and added to, the key
// slice's values once.  Through L2 the contraction reads each ciphertext's
// digit rows once a column and the key slice once a ciphertext (the
// inverse clusters are numbered ciphertext-major: the 2C columns of a
// ciphertext side by side); utils/k10_phases.py --quarter measures it.
//
// Measured against this design and dropped (utils/k10_phases.py
// --quarter, PERF.md): each forward block forming its first-pass words from
// the digits at i, i + h, i + 2h and i + 3h (four times the accumulator's
// reads through L2), the forward's top stages as a radix-4 exchange of
// words through distributed shared memory or folded into pass 0, the
// inverse's top stages as two radix-2 exchanges, 16-byte groups in the
// CRT's reads (a warp's atomics over four times the sectors), the inverse
// clusters column-major, two rows of the contraction in flight.

#include <climits>
#include <cstdint>

#include "blind_rotate.cuh"
#include "modarith.cuh"
#include "radix_chain.cuh"

namespace fhe {
namespace {

constexpr int kQuarterLogN = kWideLogN + 2;  // n = 2^17, quarters of 2^15
constexpr int kQuarters = 4;
constexpr int kQuarterPrimes = 2;            // the CRT primes
constexpr int kQuarterCluster = kQuarterPrimes * kQuarters;
// The CRT's words a thread in flight (the device-memory layout's
// kDmCrtWords): each waits for a read of the other prime's shared memory.
// Lanes stay on consecutive words: read as 16-byte groups, a warp's 64-bit
// atomics spread over four times the sectors and the lift ran 3.7 times
// longer (utils/k10_phases.py --quarter, PERF.md).
constexpr int kQuarterCrtWords = 4;
using Quarter = OneBuffer<kWideLogN>;
// The forward blocks' digits of their quarter, a byte each, beside its
// words.
constexpr int kQuarterDigitBytes = Quarter::Shape::n;
static_assert((Quarter::Shape::n / 2) %
                  (kQuarterCrtWords * Quarter::Shape::threads) == 0,
              "whole rounds of the CRT's words");

// Quarter r = 2 b + c (b, c: the element's top two bits) of an element of
// a polynomial of 4h words after the forward chain's two top stages, from
// its words x0 .. x3 at i, i + h, i + 2h, i + 3h: the first stage (root w1)
// pairs element i with i + 2h, the second (root w2, half b's) element i of
// half b with its i + h.
__device__ __forceinline__ uint32_t quarter_top(uint32_t x0, uint32_t x1,
                                                uint32_t x2, uint32_t x3,
                                                int r, uint32_t w1,
                                                uint32_t w1sh, uint32_t w2,
                                                uint32_t w2sh, uint32_t q) {
  const uint32_t v0 = shoup_mul(x2, w1, w1sh, q);
  const uint32_t v1 = shoup_mul(x3, w1, w1sh, q);
  const uint32_t lo = (r >> 1) != 0 ? submod(x0, v0, q) : addmod(x0, v0, q);
  const uint32_t hi = (r >> 1) != 0 ? submod(x1, v1, q) : addmod(x1, v1, q);
  const uint32_t v = shoup_mul(hi, w2, w2sh, q);
  return (r & 1) != 0 ? submod(lo, v, q) : addmod(lo, v, q);
}

// The words of four consecutive elements 4 v .. 4 v + 3 of a swizzled
// buffer (radix_swizzle) lie in one 16-byte word group: from word
// swizzle(4 v) & ~3, element 4 v + (j ^ s) at lane j, s = swizzle(4 v) & 3.
__device__ __forceinline__ int quad_word(int v) {
  return radix_swizzle(4 * v) & ~3;
}

// The two top inverse stages of one word across the four quarters x[0..3]
// (bits 15 and 16 of its element): bit 15 with root r2[b] of half b, then
// bit 16 with r1, and fin on every word.
__device__ __forceinline__ void quarter_butterfly(
    uint32_t (&v)[kQuarters], uint32_t r1, uint32_t r1sh,
    const uint32_t (&r2)[2], const uint32_t (&r2sh)[2], uint32_t fin,
    uint32_t fin_sh, uint32_t q) {
#pragma unroll
  for (int b = 0; b < 2; ++b) {        // bit 15, half b: (2b, 2b + 1)
    const uint32_t s = addmod(v[2 * b], v[2 * b + 1], q);
    v[2 * b + 1] = shoup_mul(submod(v[2 * b], v[2 * b + 1], q), r2[b],
                             r2sh[b], q);
    v[2 * b] = s;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {        // bit 16: (k, k + 2), then fin
    const uint32_t s = addmod(v[k], v[k + 2], q);
    const uint32_t d = shoup_mul(submod(v[k], v[k + 2], q), r1, r1sh, q);
    v[k] = shoup_mul(s, fin, fin_sh, q);
    v[k + 2] = shoup_mul(d, fin, fin_sh, q);
  }
}

// The two top inverse stages (bits 15 and 16) of a polynomial of 4h words
// whose quarters k < 4 stay swizzled in the shared memory of the blocks of
// cluster ranks base + k, in place, as one radix-4 butterfly a word
// (quarter_butterfly): the block of quarter `own` takes the elements of
// [own h/4, (own + 1) h/4), four consecutive ones (a 16-byte word group,
// quad_word) of each quarter a load and a store (its own quarter's in its
// own shared memory, the others' through distributed shared memory), kIn
// groups a thread at a time, so 4 kIn vector reads are in flight.  Every lane of a group holds
// the same element in the four quarters, so the butterflies need not know
// which.  The caller brackets it with cluster barriers (the quarters are
// final before; the writes visible after).
__device__ __forceinline__ void quarter_stages(
    uint32_t* a, int base, int own, uint32_t r1, uint32_t r1sh,
    const uint32_t (&r2)[2], const uint32_t (&r2sh)[2], uint32_t fin,
    uint32_t fin_sh, uint32_t q) {
  using S = Quarter::Shape;
  constexpr int kIn = 4;
  constexpr int quads = S::n / 4 / 4;      // a block's groups of 4 words
  static_assert(quads % (kIn * S::threads) == 0, "whole rounds of groups");
  uint32_t at[kQuarters];
#pragma unroll
  for (int k = 0; k < kQuarters; ++k) at[k] = cluster_addr(a, base + k);
  const int from = own * quads;
#pragma unroll 1
  for (int v0 = from + threadIdx.x; v0 < from + quads;
       v0 += kIn * S::threads) {
    uint32_t x[kIn][kQuarters][4];
#pragma unroll
    for (int u = 0; u < kIn; ++u) {
      const int wd = quad_word(v0 + u * S::threads);
#pragma unroll
      for (int k = 0; k < kQuarters; ++k) {
        if (k == own) {
          const uint4 m = reinterpret_cast<const uint4*>(a)[wd / 4];
          x[u][k][0] = m.x;
          x[u][k][1] = m.y;
          x[u][k][2] = m.z;
          x[u][k][3] = m.w;
        } else {
          cluster_load4(at[k] + 4u * wd, x[u][k]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kIn; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t v[kQuarters];
#pragma unroll
        for (int k = 0; k < kQuarters; ++k) v[k] = x[u][k][e];
        quarter_butterfly(v, r1, r1sh, r2, r2sh, fin, fin_sh, q);
#pragma unroll
        for (int k = 0; k < kQuarters; ++k) x[u][k][e] = v[k];
      }
      const int wd = quad_word(v0 + u * S::threads);
#pragma unroll
      for (int k = 0; k < kQuarters; ++k) {
        if (k == own) {
          reinterpret_cast<uint4*>(a)[wd / 4] =
              make_uint4(x[u][k][0], x[u][k][1], x[u][k][2], x[u][k][3]);
        } else {
          cluster_store4(at[k] + 4u * wd, x[u][k]);
        }
      }
    }
  }
}

// Step j's forward blocks: block ((b * F + f) * 2 + p) * 4 + r takes
// quarter r of digit polynomial f = c * l + i of ciphertext b under prime
// p.  acc [B, C, n]; dig [B, 2, F, n]; tw / tw_sh the forward chunk tables
// [2, 4, 2^15]; cons as the cluster layout's.
__global__ void __launch_bounds__(Quarter::threads, Quarter::blocks)
    brq_forward_kernel(const int* __restrict__ shifts,
                       const unsigned long long* __restrict__ acc,
                       uint32_t* __restrict__ dig,
                       const uint32_t* __restrict__ tw,
                       const uint32_t* __restrict__ tw_sh,
                       const uint32_t* __restrict__ cons, int j, int B, int C,
                       int l, int w) {
  using S = Quarter::Shape;
  constexpr int h = S::n;
  constexpr int n = kQuarters * h;
  constexpr int c0 = S::fwd_c(0);
  extern __shared__ __align__(16) uint32_t a[];
  const int F = C * l;
  const int r = blockIdx.x & (kQuarters - 1);
  const int p = (blockIdx.x >> 2) & 1;
  const int bf = blockIdx.x >> 3;            // b * F + f
  const int b = bf / F;
  const int f = bf - b * F;
  const int cc = f / l;
  const int shift = 64 - w * (f - cc * l + 1);
  const uint32_t mask = (1u << w) - 1u;      // w <= 31
  const PrimeRow pr = prime_row(cons, p);
  const uint32_t* ptw = tw + static_cast<size_t>(p) * n;
  const uint32_t* ptwsh = tw_sh + static_cast<size_t>(p) * n;
  const uint32_t* fw = ptw + r * h;
  const uint32_t* fwsh = ptwsh + r * h;
  // the top stages' roots: 1 (bit 16) and 2 + b16 (bit 15)
  const uint32_t w1 = __ldg(ptw + h), w1sh = __ldg(ptwsh + h);
  const int hs = shifts[static_cast<size_t>(j) * B + b] & (2 * n - 1);
  const unsigned long long* ac = acc + (static_cast<size_t>(b) * C + cc) * n;
  const auto digit = [&](int e) {
    return br_digit(ac, e, hs, kQuarterLogN, shift, mask);
  };
  const uint32_t w2 = __ldg(ptw + (2 + (r >> 1)) * h);
  const uint32_t w2sh = __ldg(ptwsh + (2 + (r >> 1)) * h);
  // the four quarters of the digit polynomial on a cluster: block r forms
  // the digits of its own quarter's elements, a byte each (w <= 8 at
  // 2^17), into the byte buffer beside the words, element r h + v + (k <<
  // c0) at byte 16 v + k (the 16 elements that virtual thread v of pass 0
  // holds, one 16-byte word; lanes on consecutive v read consecutive
  // accumulator words); then every block reads the four quarters' bytes of
  // its virtual threads (the others' through distributed shared memory),
  // forms its own quarter after both top stages (quarter_top) and runs
  // pass 0 in registers
  uint4* dbytes = reinterpret_cast<uint4*>(a + h);
#pragma unroll 1
  for (int g = 0; g < S::groups; ++g) {
    const int v = threadIdx.x + g * S::threads;   // radix_base(v, c0)
    uint32_t x[kRadix];
#pragma unroll
    for (int k = 0; k < kRadix; ++k) x[k] = digit(r * h + v + (k << c0));
    dbytes[v] = make_uint4(x[0] | x[1] << 8 | x[2] << 16 | x[3] << 24,
                           x[4] | x[5] << 8 | x[6] << 16 | x[7] << 24,
                           x[8] | x[9] << 8 | x[10] << 16 | x[11] << 24,
                           x[12] | x[13] << 8 | x[14] << 16 | x[15] << 24);
  }
  // every quarter's digits are formed and visible to the cluster
  cluster_sync();
  uint32_t peer[kQuarters];
#pragma unroll
  for (int k = 0; k < kQuarters; ++k) peer[k] = cluster_addr(dbytes, k);
#pragma unroll 1
  for (int g = 0; g < S::groups; ++g) {
    const int v = threadIdx.x + g * S::threads;
    uint32_t d[kQuarters][4];
#pragma unroll
    for (int k = 0; k < kQuarters; ++k) {
      if (k == r) {
        const uint4 m = dbytes[v];
        d[k][0] = m.x;
        d[k][1] = m.y;
        d[k][2] = m.z;
        d[k][3] = m.w;
      } else {
        cluster_load4(peer[k] + 16u * v, d[k]);
      }
    }
    uint32_t x[kRadix];
#pragma unroll
    for (int k = 0; k < kRadix; ++k) {
      const int sh = 8 * (k & 3);
      x[k] = quarter_top((d[0][k >> 2] >> sh) & 0xffu,
                         (d[1][k >> 2] >> sh) & 0xffu,
                         (d[2][k >> 2] >> sh) & 0xffu,
                         (d[3][k >> 2] >> sh) & 0xffu, r, w1, w1sh, w2, w2sh,
                         pr.q);
    }
    radix_pass<kWideLogN, 0, false>(x, v, fw, fwsh, pr.q);
    radix_store<c0>(a, x, v);
  }
  // the peers have read this block's bytes (and pass 0's words are in)
  cluster_sync();
  RadixPasses<kWideLogN, 1, S::passes, false, S::threads>::run(
      a, radix_opaque(fw), radix_opaque(fwsh), pr.q);
  // quarter r of the evaluations in natural order, lane i storing 4i .. 4i
  // + 3
  uint4* row = reinterpret_cast<uint4*>(
      dig + ((static_cast<size_t>(b) * kQuarterPrimes + p) * F + f) * n +
      static_cast<size_t>(r) * h);
  for (int i = threadIdx.x; i < h / 4; i += S::threads) {
    const int sw = radix_swizzle(4 * i);
    row[i] = make_uint4(a[sw], a[sw ^ 1], a[sw ^ 2], a[sw ^ 3]);
  }
}

// Step j's inverse blocks, in clusters of eight: cluster b * 2C + o takes
// output column o = 2 c' + limb of ciphertext b, its block of rank p * 4 +
// r prime p and quarter r.  ev1/ev2 (values) [steps, F, 2C, n]; acc [B, C,
// n] accumulated in place; twinv / twinv_sh the inverse chunk tables [2,
// 4, 2^15]; cons rows (q0, -q0^-1 mod 2^32, n^-1 2^32, sh), (q1, -q1^-1
// mod 2^32, n^-1 2^32, sh), (q1, -, q0^-1 mod q1, sh).
__global__ void __launch_bounds__(Quarter::threads, Quarter::blocks)
    brq_inverse_kernel(const uint32_t* __restrict__ dig,
                       const uint32_t* __restrict__ ev1,
                       const uint32_t* __restrict__ ev2,
                       unsigned long long* __restrict__ acc,
                       const uint32_t* __restrict__ twinv,
                       const uint32_t* __restrict__ twinv_sh,
                       const uint32_t* __restrict__ cons, int j, int C, int l,
                       int vec) {
  using S = Quarter::Shape;
  constexpr int h = S::n;
  constexpr int n = kQuarters * h;
  constexpr int cw = S::threads * kRadix;    // a group's words
  constexpr int vecs = cw / (4 * S::threads);   // 4: 16 words a thread
  extern __shared__ __align__(16) uint32_t a[];
  const int F = C * l;
  const int cols = 2 * C;
  const int rank = blockIdx.x & (kQuarterCluster - 1);
  const int p = rank >> 2;
  const int r = rank & (kQuarters - 1);
  const int cid = blockIdx.x / kQuarterCluster;
  const int b = cid / cols;
  const int o = cid - b * cols;
  const PrimeRow pr = prime_row(cons, p);
  const uint32_t q = pr.q;
  const uint32_t* ptw = twinv + static_cast<size_t>(p) * n;
  const uint32_t* ptwsh = twinv_sh + static_cast<size_t>(p) * n;
  const uint32_t* iw = ptw + r * h;
  const uint32_t* iwsh = ptwsh + r * h;
  const size_t quarter = static_cast<size_t>(r) * h;
  const uint32_t* kv = (p ? ev2 : ev1) +
                       (static_cast<size_t>(j) * F * cols + o) * n + quarter;
  const uint32_t* dr =
      dig + (static_cast<size_t>(b) * kQuarterPrimes + p) * F * n + quarter;
  // the contraction (Montgomery products against the values), lanes on
  // consecutive 16-byte words of the digit and key rows: thread t takes
  // words 4 (u T + t) .. + 3 of each group's cw, u < 4; the group's sums
  // leave for the shared buffer as the forward's read-out does, and the
  // chain runs from pass 0 there
#pragma unroll 1
  for (int gi = 0; gi < S::groups; ++gi) {
    const uint32_t* dg = dr + gi * cw;
    const uint32_t* kg = kv + gi * cw;
    // the digit and key words of row ri, one row ahead of the products
    const auto words = [&](uint32_t (&D)[kRadix], uint32_t (&K)[kRadix],
                           int ri) {
      const uint32_t* d = dg + static_cast<size_t>(ri) * n;
      const uint32_t* kr = kg + static_cast<size_t>(ri) * cols * n;
#pragma unroll
      for (int u = 0; u < vecs; ++u) {
        const int at = 4 * (u * S::threads + threadIdx.x);
        uint32_t t[4];
        operand_words(t, d + at, true);
#pragma unroll
        for (int i = 0; i < 4; ++i) D[4 * u + i] = t[i];
        operand_words(t, kr + at, vec != 0);
#pragma unroll
        for (int i = 0; i < 4; ++i) K[4 * u + i] = t[i];
      }
    };
    uint32_t x[kRadix], nd[kRadix], nk[kRadix];
#pragma unroll
    for (int k = 0; k < kRadix; ++k) x[k] = 0;
    words(nd, nk, 0);
#pragma unroll 1
    for (int ri = 0; ri < F; ++ri) {
      uint32_t D[kRadix], K[kRadix];
#pragma unroll
      for (int k = 0; k < kRadix; ++k) {
        D[k] = nd[k];
        K[k] = nk[k];
      }
      if (ri + 1 < F) words(nd, nk, ri + 1);
#pragma unroll
      for (int i = 0; i < kRadix; ++i) {
        x[i] = addmod(x[i], mont_mul(D[i], K[i], q, pr.nq), q);
      }
    }
#pragma unroll
    for (int u = 0; u < vecs; ++u) {
      const int sw = radix_swizzle(gi * cw + 4 * (u * S::threads +
                                                  threadIdx.x));
#pragma unroll
      for (int i = 0; i < 4; ++i) a[sw ^ i] = x[4 * u + i];
    }
  }
  __syncthreads();
  RadixPasses<kWideLogN, 0, S::passes, true, S::threads>::run(
      a, radix_opaque(iw), radix_opaque(iwsh), q);
  // the top stages' inverse roots: 2 + b16 (bit 15) and 1 (bit 16)
  const uint32_t t1 = __ldg(ptw + h), t1sh = __ldg(ptwsh + h);
  const uint32_t t2[2] = {__ldg(ptw + 2 * h), __ldg(ptw + 3 * h)};
  const uint32_t t2sh[2] = {__ldg(ptwsh + 2 * h), __ldg(ptwsh + 3 * h)};
  // the quarters of prime p are through their chains
  cluster_sync();
  quarter_stages(a, rank & ~(kQuarters - 1), r, t1, t1sh, t2, t2sh, pr.fin,
                 pr.fin_sh, q);
  // both primes' columns are complete and visible to the cluster
  cluster_sync();
  const uint32_t other = cluster_addr(a, rank ^ kQuarters);   // prime p ^ 1
  const uint32_t q0 = prime_row(cons, 0).q, q1 = prime_row(cons, 1).q;
  const PrimeRow crt = prime_row(cons, 2);
  const int limb = o & 1;
  unsigned long long* ac =
      acc + (static_cast<size_t>(b) * C + (o >> 1)) * n + quarter;
  // exact CRT lift of (r_0, r_1) to the centred integer, shifted to its
  // limb, added mod 2^64: elements p h/2 .. (p + 1) h/2 - 1 of quarter r,
  // lanes on consecutive elements (each warp's 64-bit atomics on 32
  // consecutive words), kQuarterCrtWords a thread at a time
#pragma unroll 1
  for (int i0 = p * (h / 2) + threadIdx.x; i0 < (p + 1) * (h / 2);
       i0 += kQuarterCrtWords * S::threads) {
    uint32_t own[kQuarterCrtWords], peer[kQuarterCrtWords];
#pragma unroll
    for (int u = 0; u < kQuarterCrtWords; ++u) {
      const int sw = radix_swizzle(i0 + u * S::threads);
      own[u] = a[sw];
      peer[u] = cluster_load(other + 4u * sw);
    }
#pragma unroll
    for (int u = 0; u < kQuarterCrtWords; ++u) {
      const uint32_t r0 = p ? peer[u] : own[u];
      const uint32_t r1 = p ? own[u] : peer[u];
      atomicAdd(ac + i0 + u * S::threads,
                br_lift(r0, r1, q0, q1, crt) << (32 * limb));
    }
  }
  // the peers have read this block's words before any block exits
  cluster_sync();
}

}  // namespace

// The quarter layout of K10, called by fhe_blind_rotate (csrc/
// blind_rotate_cuda.cu) for the plan's layout 4 at n = 2^17: threads and
// smem a quarter's one-buffer shape (ops/blind_rotate_cuda.py::_plan), tw ..
// twinv_sh the chunk tables of both primes at 2^17, cons the rows of
// brq_inverse_kernel (the final multiplier n^-1 2^32: the Montgomery
// contraction's), dig the scratch of [B, 2, C*l, n] words (16-byte
// aligned), vec the key planes' 16-byte alignment.  The forward launch
// takes kQuarterDigitBytes more shared memory (its digit bytes: w <= 8,
// as the reference's gate gives at 2^17, C l n 2^w < 2^26).  The Shoup
// planes ev1s, ev2s are not read.  A cluster launch the card cannot run
// returns its error: nothing falls back to another layout.
int blind_rotate_quarter(const int* shifts, const unsigned long long* acc0,
                         const uint32_t* ev1, const uint32_t* ev1s,
                         const uint32_t* ev2, const uint32_t* ev2s,
                         unsigned long long* out, uint32_t* dig,
                         const uint32_t* tw, const uint32_t* tw_sh,
                         const uint32_t* twinv, const uint32_t* twinv_sh,
                         const uint32_t* cons, int steps, int B, int C, int l,
                         int w, int logn, int threads, int smem, int vec,
                         cudaStream_t stream) {
  using S = Quarter::Shape;
  (void)ev1s;
  (void)ev2s;
  const long long fwd_blocks = 8LL * B * C * l;
  const long long inv_blocks = 8LL * B * 2 * C;
  if (logn != kQuarterLogN || dig == nullptr || misaligned(dig) ||
      fwd_blocks > INT_MAX || inv_blocks > INT_MAX || w > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (threads != S::threads ||
      smem != S::n * static_cast<int>(sizeof(uint32_t))) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  auto fwd = &brq_forward_kernel;
  auto inv = &brq_inverse_kernel;
  const int fwd_smem = smem + kQuarterDigitBytes;
  cudaError_t err = allow_smem(fwd, fwd_smem);
  if (err == cudaSuccess) err = allow_smem(inv, smem);
  if (err == cudaSuccess) {
    err = cudaMemcpyAsync(out, acc0,
                          sizeof(unsigned long long) * B * C *
                              (static_cast<size_t>(kQuarters) * S::n),
                          cudaMemcpyDeviceToDevice, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
#pragma unroll 1
  for (int j = 0; j < steps; ++j) {
    err = cluster_launch(fwd, fwd_blocks, kQuarters, threads, fwd_smem,
                         stream, shifts,
                         static_cast<const unsigned long long*>(out), dig, tw,
                         tw_sh, cons, j, B, C, l, w);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cluster_launch(inv, inv_blocks, kQuarterCluster, threads, smem,
                         stream, static_cast<const uint32_t*>(dig), ev1, ev2,
                         out, twinv, twinv_sh, cons, j, C, l, vec);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fhe

using namespace fhe;

// The inverse launch's clusters of eight that the card in use runs at once.
extern "C" int fhe_blind_rotate_quarter_clusters(int* clusters) {
  return cluster_occupancy(&brq_inverse_kernel, kQuarterCluster,
                           Quarter::Shape::threads,
                           Quarter::Shape::n * static_cast<int>(sizeof(uint32_t)),
                           clusters);
}
