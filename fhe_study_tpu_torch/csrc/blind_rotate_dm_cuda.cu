// K10's second layout: the whole TFHE blind rotation with its working set in
// device memory — replaces, with csrc/blind_rotate_cuda.cu, fhe_study_tpu/
// ops/blind_rotate_pallas.py::blind_rotate_fused at the shapes whose working
// set does not fit one block's shared memory (ops/blind_rotate_cuda.py::
// _plan picks the layout from C, l and n alone): every n from 2^12 at C = 2,
// larger l or C below, and n = 2^15.
//
//   acc <- acc + BSK_j [x] (acc * X^-h_j - acc)      for j = 0 .. steps-1
//
// computed exactly as the cluster layout and the step-by-step chain
// (models/tfhe/tggsw.py::cmux_evals) compute it: negacyclic rotation by h_j
// in [0, 2N), wrapping 64-bit subtract, base-2^w digits MSB-first (the top
// w * l bits, as arith/tn.py::decompose_base_pow2), forward NTTs of the C*l
// digit polynomials under both CRT primes, the contraction against the
// step's eval-domain key (Montgomery products against the value planes,
// the factor 2^-32 taken back by the final multiplier n^-1 2^32), 2C
// inverse NTTs per prime, the exact centred CRT lift mod p_0 p_1, the two
// 32-bit key limbs recombined mod 2^64 and the wrapping add.
//
// State in device memory: the accumulator [B, C, n] of 64-bit words (the
// output tensor, a copy of acc0 first) and a scratch of digit evaluations
// [B, 2, C*l, n] of 32-bit words that the wrapper allocates.  A step is two
// launches on the caller's stream, which orders them:
//
//   forward  one block per (ciphertext, digit polynomial, prime), 2 B C l
//            blocks at radix_chain.cuh's one-buffer shape (OneBuffer: 256
//            threads below 2^15, 512 and 128 KB at 2^15, as K1): the first
//            pass forms its 16 words from the rotated accumulator in device
//            memory (lanes on consecutive words), the chain runs in shared
//            memory, and the evaluations leave in coalesced 16-byte stores
//            to the scratch row;
//   inverse  one cluster of two blocks per (ciphertext, output column),
//            one CRT prime a block, 4 B C blocks: the contraction of the
//            scratch rows of the block's prime against the column's key
//            under the prime, lanes on consecutive 16-byte words and one
//            row's words ahead, its sums into shared memory as the
//            forward's read-out leaves it, the inverse chain from pass 0
//            there, n^-1 2^32 in the last pass; then, after a cluster
//            barrier, block p lifts the elements of half p of the column
//            from its own words and the peer's (distributed shared memory,
//            kDmCrtWords reads in flight) and adds the lifted limb, shifted
//            to its place, into the accumulator by a 64-bit atomic add (the
//            two limb columns of a component add into the same words:
//            addition mod 2^64 is exact in any order).
//
// The kernel boundaries order everything a step needs: the forward blocks of
// step j read the accumulator that step j - 1's inverse blocks wrote, and the
// inverse blocks of step j read the scratch that step j's forward blocks
// wrote.  The whole chain is one call of the C entry (2 * steps launches
// queued back to back; no grid-wide barrier, so no co-residency to size).
//
// What bounds it: the butterflies and modular products (about 83 M counted
// instructions a step and ciphertext at N = 2^15, C = 2, l = 3: utils/
// kernel_check.py::cmux_step_ops), the issue rate; its device-memory
// traffic a step (utils/kernel_check.py::cmux_step_bytes: the scratch
// written and read back, the accumulator read and added to, the key's
// values once, as L2 serves them) stays under the issue time at every
// shape the layout takes.  What held the contraction back was the way it
// read: each lane's 16 contiguous words (64-byte strides across a warp)
// and the Shoup planes beside the values; read as consecutive 16-byte
// words, values alone, it runs near L2's rate (utils/k10_phases.py
// --device, PERF.md).

#include <climits>
#include <cstdint>

#include "blind_rotate.cuh"
#include "modarith.cuh"
#include "radix_chain.cuh"

namespace fhe {
namespace {

constexpr int kDmPrimes = 2;      // CRT primes: the inverse cluster's blocks
// Inverse blocks an SM at most: the contraction beside the 16 words and the
// CRT's 64-bit words take more than the 80 registers a thread that three
// 256-thread blocks would leave (ptxas spilled at 2^13 and 2^14), so two,
// with up to 128 (one 512-thread block at 2^15, as OneBuffer).
constexpr int kDmInverseBlocks = 2;

// Programmatic dependent launch below 2^15 (kDmPdlLogN), where a step is
// tens of microseconds and the seams between launches a twentieth of it
// (utils/k10_phases.py --device): each launch lets the next one's blocks
// start once all of its own have (launch_dependents), and a block waits
// for the whole previous launch, its writes visible (wait), before it
// touches the accumulator or the scratch; what comes before the wait (the
// blocks' start and their operands' addresses) overlaps the previous
// launch's tail.  Without the launch attribute both are no-ops.
constexpr int kDmPdlLogN = kWideLogN;
// The CRT's words a thread in flight: each waits for a read of the peer's
// shared memory, which one word at a time left the loop at that latency
// (utils/k10_phases.py --device).
constexpr int kDmCrtWords = 4;
static_assert((1 << 6) % (kDmCrtWords * OneBuffer<7>::Shape::threads) == 0,
              "the CRT's words a thread divide a block's half at 2^7");

__device__ __forceinline__ void dm_grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void dm_grid_release() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Step j's forward blocks: block (b * F + f) * 2 + p takes digit polynomial
// f = c * l + i of ciphertext b under prime p.  acc [B, C, n]; dig
// [B, 2, F, n]; tw/tw_sh [2][n] forward root tables; cons as the cluster
// layout's.
template <int LOGN>
__global__ void __launch_bounds__(OneBuffer<LOGN>::threads,
                                  OneBuffer<LOGN>::blocks)
    br_forward_kernel(const int* __restrict__ shifts,
                      const unsigned long long* __restrict__ acc,
                      uint32_t* __restrict__ dig,
                      const uint32_t* __restrict__ tw,
                      const uint32_t* __restrict__ tw_sh,
                      const uint32_t* __restrict__ cons, int j, int B, int C,
                      int l, int w) {
  using S = typename OneBuffer<LOGN>::Shape;
  constexpr int n = S::n;
  constexpr int c0 = S::fwd_c(0);
  extern __shared__ __align__(16) uint32_t a[];
  const int F = C * l;
  const int p = blockIdx.x & 1;
  const int bf = blockIdx.x >> 1;            // b * F + f
  const int b = bf / F;
  const int f = bf - b * F;
  const int cc = f / l;
  const int shift = 64 - w * (f - cc * l + 1);
  const uint32_t mask = (1u << w) - 1u;      // w <= 31
  const PrimeRow pr = prime_row(cons, p);
  const uint32_t* fw = tw + p * n;
  const uint32_t* fwsh = tw_sh + p * n;
  const int h = shifts[static_cast<size_t>(j) * B + b] & (2 * n - 1);
  const unsigned long long* ac = acc + (static_cast<size_t>(b) * C + cc) * n;
  // the previous step's inverse launch has added into acc and read dig
  dm_grid_wait();
  dm_grid_release();
  // pass 0 from the rotated accumulator: virtual thread v holds elements
  // v + (k << c0), digit i of acc * X^-h - acc
#pragma unroll 1
  for (int g = 0; g < S::groups; ++g) {
    const int v = threadIdx.x + g * S::threads;   // radix_base(v, c0)
    uint32_t x[kRadix];
#pragma unroll
    for (int k = 0; k < kRadix; ++k) {
      x[k] = br_digit(ac, v + (k << c0), h, LOGN, shift, mask);
    }
    radix_pass<LOGN, 0, false>(x, v, fw, fwsh, pr.q);
    radix_store<c0>(a, x, v);
  }
  __syncthreads();
  RadixPasses<LOGN, 1, S::passes, false, S::threads>::run(
      a, radix_opaque(fw), radix_opaque(fwsh), pr.q);
  // the evaluations in natural order, lane i storing words 4i .. 4i + 3
  uint4* row = reinterpret_cast<uint4*>(
      dig + ((static_cast<size_t>(b) * kDmPrimes + p) * F + f) * n);
  for (int i = threadIdx.x; i < n / 4; i += S::threads) {
    const int sw = radix_swizzle(4 * i);
    row[i] = make_uint4(a[sw], a[sw ^ 1], a[sw ^ 2], a[sw ^ 3]);
  }
}

// Step j's inverse blocks, in clusters of two: cluster b * 2C + o takes
// output column o = 2 c' + limb of ciphertext b, its block of rank p the
// column under prime p.  ev1/ev2 (values) [steps, F, 2C, n]; acc [B, C, n]
// accumulated in place; cons rows (q0, -q0^-1 mod 2^32, n^-1 2^32, sh),
// (q1, ...), (q1, -, q0^-1 mod q1, sh).
template <int LOGN>
__global__ void __launch_bounds__(OneBuffer<LOGN>::threads,
                                  radix_min(OneBuffer<LOGN>::blocks,
                                            kDmInverseBlocks))
    br_inverse_kernel(const uint32_t* __restrict__ dig,
                      const uint32_t* __restrict__ ev1,
                      const uint32_t* __restrict__ ev2,
                      unsigned long long* __restrict__ acc,
                      const uint32_t* __restrict__ twinv,
                      const uint32_t* __restrict__ twinv_sh,
                      const uint32_t* __restrict__ cons, int j, int C, int l,
                      int vec) {
  using S = typename OneBuffer<LOGN>::Shape;
  constexpr int n = S::n;
  constexpr int last = S::passes - 1;
  constexpr int cl = S::inv_c(last);
  constexpr int cw = S::threads * kRadix;    // a group's words
  extern __shared__ __align__(16) uint32_t a[];
  const int F = C * l;
  const int cols = 2 * C;
  const int p = cluster_rank();
  const int cid = blockIdx.x / kDmPrimes;    // b * cols + o
  const int b = cid / cols;
  const int o = cid - b * cols;
  const PrimeRow pr = prime_row(cons, p);
  const uint32_t q = pr.q;
  const uint32_t* iw = twinv + p * n;
  const uint32_t* iwsh = twinv_sh + p * n;
  const uint32_t* kv =
      (p ? ev2 : ev1) + ((static_cast<size_t>(j) * F * cols + o) << LOGN);
  const uint32_t* dr =
      dig + (static_cast<size_t>(b) * kDmPrimes + p) * F * n;
  // this step's forward launch has written dig (and the previous inverse
  // launch added into acc)
  dm_grid_wait();
  dm_grid_release();
  // the contraction (Montgomery products against the values: a factor
  // 2^-32 that fin takes back), lanes on consecutive 16-byte words of the
  // digit and key rows: thread t takes words 4 (u T + t) .. + 3 of each
  // group's cw, u < 4; the group's sums leave for the shared buffer as the
  // forward's read-out does, and the chain runs from pass 0 there
  constexpr int vecs = cw / (4 * S::threads);   // 4: 16 words a thread
#pragma unroll 1
  for (int gi = 0; gi < S::groups; ++gi) {
    const uint32_t* dg = dr + gi * cw;
    const uint32_t* kg = kv + gi * cw;
    // the digit and key words of row ri, one row ahead of the products, so
    // that two rows' device-memory reads are in flight
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
  RadixPasses<LOGN, 0, last, true, S::threads>::run(
      a, radix_opaque(iw), radix_opaque(iwsh), q);
#pragma unroll 1
  for (int gi = 0; gi < S::groups; ++gi) {
    const int base = radix_base(threadIdx.x + gi * S::threads, cl);
    uint32_t x[kRadix];
    radix_load<cl>(x, a, base);
    radix_pass<LOGN, last, true>(x, base, iw, iwsh, q);
#pragma unroll
    for (int k = 0; k < kRadix; ++k) {
      x[k] = shoup_mul(x[k], pr.fin, pr.fin_sh, q);
    }
    radix_store<cl>(a, x, base);
  }
  // both primes' columns are complete and visible to the cluster
  cluster_sync();
  const uint32_t peer = cluster_addr(a, p ^ 1);
  const uint32_t q0 = prime_row(cons, 0).q, q1 = prime_row(cons, 1).q;
  const PrimeRow crt = prime_row(cons, 2);
  const int limb = o & 1;
  unsigned long long* ac = acc + (static_cast<size_t>(b) * C + (o >> 1)) * n;
  // exact CRT lift of (r_0, r_1) to the centred integer, shifted to its
  // limb, added mod 2^64; block p takes elements p n/2 .. (p + 1) n/2 - 1,
  // kDmCrtWords a thread at a time, so that as many reads of the peer's
  // words are in flight (n/2 is a multiple of kDmCrtWords threads at every
  // n)
#pragma unroll 1
  for (int i0 = p * (n / 2) + threadIdx.x; i0 < (p + 1) * (n / 2);
       i0 += kDmCrtWords * S::threads) {
    uint32_t own[kDmCrtWords], other[kDmCrtWords];
#pragma unroll
    for (int u = 0; u < kDmCrtWords; ++u) {
      const int sw = radix_swizzle(i0 + u * S::threads);
      own[u] = a[sw];
      other[u] = cluster_load(peer + 4u * sw);
    }
#pragma unroll
    for (int u = 0; u < kDmCrtWords; ++u) {
      const uint32_t r0 = p ? other[u] : own[u];
      const uint32_t r1 = p ? own[u] : other[u];
      atomicAdd(ac + i0 + u * S::threads,
                br_lift(r0, r1, q0, q1, crt) << (32 * limb));
    }
  }
  // the peer has read this block's words before any block exits
  cluster_sync();
}

struct BlindRotateDmLaunch {
  template <int LOGN>
  static int run(int threads, int smem, int B, cudaStream_t stream,
                 const int* shifts, const unsigned long long* acc0,
                 const uint32_t* ev1, const uint32_t* ev2,
                 unsigned long long* out, uint32_t* dig, const uint32_t* tw,
                 const uint32_t* tw_sh, const uint32_t* twinv,
                 const uint32_t* twinv_sh, const uint32_t* cons, int steps,
                 int C, int l, int w, int vec) {
    using S = typename OneBuffer<LOGN>::Shape;
    if (threads != S::threads ||
        smem != S::n * static_cast<int>(sizeof(uint32_t))) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    const long long fwd_blocks = 2LL * B * C * l;
    const long long inv_blocks = 4LL * B * C;
    if (fwd_blocks > INT_MAX || inv_blocks > INT_MAX) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    auto fwd = &br_forward_kernel<LOGN>;
    auto inv = &br_inverse_kernel<LOGN>;
    cudaError_t err = allow_smem(fwd, smem);
    if (err == cudaSuccess) err = allow_smem(inv, smem);
    if (err == cudaSuccess) {
      err = cudaMemcpyAsync(out, acc0,
                            sizeof(unsigned long long) * B * C * S::n,
                            cudaMemcpyDeviceToDevice, stream);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    // the forward launch: no cluster; the inverse launch: clusters of two;
    // both programmatic below 2^15
    constexpr bool pdl = LOGN < kDmPdlLogN;
    cudaLaunchAttribute cluster[1], attr[2];
    cudaLaunchConfig_t icfg = cluster_config(cluster, inv_blocks, kDmPrimes,
                                             threads, smem, stream);
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    attr[1] = cluster[0];
    icfg.attrs = pdl ? attr : cluster;
    icfg.numAttrs = pdl ? 2 : 1;
    cudaLaunchConfig_t fcfg = icfg;
    fcfg.gridDim = dim3(static_cast<unsigned>(fwd_blocks));
    fcfg.attrs = attr;
    fcfg.numAttrs = pdl ? 1 : 0;
#pragma unroll 1
    for (int j = 0; j < steps; ++j) {
      err = cudaLaunchKernelEx(&fcfg, fwd, shifts,
                               static_cast<const unsigned long long*>(out),
                               dig, tw, tw_sh, cons, j, B, C, l, w);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = cudaLaunchKernelEx(&icfg, inv,
                               static_cast<const uint32_t*>(dig), ev1, ev2,
                               out, twinv, twinv_sh, cons, j, C, l, vec);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// The device-memory layout of K10, called by fhe_blind_rotate
// (csrc/blind_rotate_cuda.cu) for the plan's layout 1: threads and smem the
// one-buffer shape of 2^logn (ops/blind_rotate_cuda.py::_plan), dig the
// scratch of [B, 2, C*l, n] words (16-byte aligned), vec the key planes'
// 16-byte alignment.  The Shoup planes ev1s, ev2s are not read.
int blind_rotate_dm(const int* shifts, const unsigned long long* acc0,
                    const uint32_t* ev1, const uint32_t* ev1s,
                    const uint32_t* ev2, const uint32_t* ev2s,
                    unsigned long long* out, uint32_t* dig,
                    const uint32_t* tw, const uint32_t* tw_sh,
                    const uint32_t* twinv, const uint32_t* twinv_sh,
                    const uint32_t* cons, int steps, int B, int C, int l,
                    int w, int logn, int threads, int smem, int vec,
                    cudaStream_t stream) {
  (void)ev1s;
  (void)ev2s;
  // the contraction's 32-bit offsets: F 2C n words of a step's key slice
  if (dig == nullptr || misaligned(dig) || logn > kWideLogN ||
      2LL * C * C * l << logn > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return by_logn_wide<BlindRotateDmLaunch>(
      logn, threads, smem, B, stream, shifts, acc0, ev1, ev2, out, dig, tw,
      tw_sh, twinv, twinv_sh, cons, steps, C, l, w, vec);
}

}  // namespace fhe
