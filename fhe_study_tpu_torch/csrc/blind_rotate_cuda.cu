// K10: the Hopper kernel of the whole TFHE blind rotation — replaces
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
// This file holds K10's cluster layout, which keeps a ciphertext's working
// set in shared memory; ops/blind_rotate_cuda.py::_plan takes it wherever
// that fits (br_smem_bytes), the device-memory layout of
// csrc/blind_rotate_dm_cuda.cu elsewhere up to 2^15, at 2^16 the split
// layout of csrc/blind_rotate_split_cuda.cu and past it the grid layout of
// csrc/blind_rotate_grid_cuda.cu, through the one entry below.
//
// Layout: one cluster of two blocks per ciphertext, one CRT prime per block
// (the block's rank in the cluster picks the prime, its root tables and its
// key planes), so a batch of 64 fills 128 SMs.  Each block keeps its own copy
// of the 64-bit accumulator (C*N words) in shared memory; both copies stay
// equal because both blocks add the same CRT result.  A step of one block:
//
//   forward   C*l digit polynomials on the register-resident chain of
//             radix_chain.cuh, side by side on the block's threads (virtual
//             thread t of the pass loop takes polynomial t / (N/16)); the
//             first pass forms its 16 words from the rotated accumulator
//             (digit i of component c of out[k] = +-acc[(k + h) mod N] -
//             acc[k]), so no digit buffer is written before it;
//   contract  in the first inverse pass's registers, as K3: the 2C output
//             columns, each from the C*l digit evaluations at the virtual
//             thread's 16 contiguous words and the step's key words, read
//             in a lane-rotated chunk order that keeps the 16-byte key reads
//             free of bank conflicts;
//   inverse   2C columns, n^-1 folded into the last pass, which stores its
//             words into the block's own buffer and, through distributed
//             shared memory, into the peer's exchange buffer with
//             asynchronous stores (st.async) that count down the peer's
//             mbarrier;
//   crt       once the peer's words are in (an mbarrier wait, no cluster
//             barrier), each block lifts (r_0, r_1) exactly to the centred
//             integer mod p_0 p_1, recombines the two 32-bit key limbs mod
//             2^64 and adds into its accumulator, from its own shared
//             memory alone.  The exchange buffers alternate between steps: a
//             block stores into the peer's buffer of step j + 2 only after
//             its wait for the peer's step j + 1, which the peer sends after
//             its step j CRT has read that buffer.
//
// 7 block barriers and one mbarrier wait a step at N = 1024 (3 forward
// passes, 3 inverse, the accumulator update).  A cluster barrier (release/acquire at cluster scope)
// in place of the mbarrier cost more than a whole pass on the H100, the most
// while a key copy was in flight.
//
// The key: a step reads 2 planes (values and Shoup companions) of C*l*2C*N
// words for its prime, 128 KB at N = 1024, C = 2, l = 2.  Where they fit
// beside the working set (STAGED), thread 0 copies step j+1's planes into
// shared memory with two bulk asynchronous copies (cp.async.bulk, completing
// on an mbarrier) as soon as step j's contraction has consumed the buffer,
// so the copy runs under step j's inverse passes and CRT and step j+1's
// forward passes.  Elsewhere (larger N or l, or planes not 16-byte aligned)
// the contraction reads them from device memory, 16-byte words where
// aligned.
//
// What bounds it: per step and ciphertext about 2 (C*l + 2C) (N/2) log N
// butterflies and 2*2C*C*l*N Shoup products (1.5 M counted instructions at
// N = 1024, C = 2, l = 2: utils/kernel_check.py::cmux_step_ops) against a key
// slice that every ciphertext shares: the issue rate.  A block holds 8 warps
// (4 polynomials x 64 virtual threads is all the parallel work of a pass),
// one block an SM (208 KB of shared memory), and takes 2-3x the counted
// issue time in every phase (utils/k10_phases.py); the key copies keep up
// (the contraction waits about 200 cycles a step for them).

#include <cooperative_groups.h>

#include "modarith.cuh"
#include "radix_chain.cuh"

namespace cg = cooperative_groups;

namespace fhe {
namespace {

// the block (mirrored by ops/blind_rotate_cuda.py::_plan)
constexpr int kBrThreads = 256;
constexpr int kBrCluster = 2;
constexpr int kBrBarrierBytes = 32;        // three mbarriers, padded
constexpr int kCrtWords = 8;               // CRT words a thread takes at once
// The largest log n at which a ciphertext's working set fits a block
// (br_smem_bytes at C = 1); past it the plan takes the device-memory layout.
constexpr int kBrMaxLogN = 12;

// Shared-memory bytes of a block: the mbarriers, the accumulator, the digit
// evaluations, the 2C columns, two exchange buffers of 2C columns (the
// peer's) and, when staged, the two key planes of one step.
__host__ __device__ constexpr long long br_smem_bytes(int C, int l, int logn,
                                                      bool staged) {
  const long long n = 1LL << logn;
  return kBrBarrierBytes + 8 * C * n + 4LL * C * l * n + 3 * 4LL * 2 * C * n +
         (staged ? 2 * 4LL * C * l * 2 * C * n : 0);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Wait for the phase of the given parity to complete; acquire at cluster
// scope, so the peer's stores that completed it are visible.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// An asynchronous store of one word into the peer's shared memory that
// completes 4 bytes of the transaction count of the peer's mbarrier.
__device__ __forceinline__ void st_peer(uint32_t addr, uint32_t v,
                                        uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(v), "r"(bar)
      : "memory");
}

// One thread: expect `bytes` on the barrier, then copy the two planes of
// `words` words each from device memory into shared memory.
__device__ __forceinline__ void stage_key(uint32_t* dst, const uint32_t* src,
                                          const uint32_t* src_sh,
                                          uint32_t words, uint64_t* bar) {
  const uint32_t bytes = words * 4u;
  mbar_expect(bar, 2 * bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst + words)),
      "l"(src_sh), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Passes P .. END - 1 of `polys` polynomials at buf + p * n, side by side:
// virtual thread t of the loop takes polynomial t >> (LOGN - 4); each pass
// ends with a barrier.
template <int LOGN, int P, int END, bool INV>
struct BrPasses {
  __device__ __forceinline__ static void run(uint32_t* buf, int polys,
                                             const uint32_t* w,
                                             const uint32_t* wsh, uint32_t q) {
    if constexpr (P < END) {
      using S = RadixShape<LOGN>;
      constexpr int c = INV ? S::inv_c(P) : S::fwd_c(P);
#pragma unroll 1
      for (int t = threadIdx.x; t < polys * S::vthreads; t += kBrThreads) {
        uint32_t* a = buf + ((t >> (LOGN - kRadixBits)) << LOGN);
        const int base = radix_base(t & (S::vthreads - 1), c);
        uint32_t x[kRadix];
        radix_load<c>(x, a, base);
        radix_pass<LOGN, P, INV>(x, base, w, wsh, q);
        radix_store<c>(a, x, base);
      }
      __syncthreads();
      BrPasses<LOGN, P + 1, END, INV>::run(buf, polys, w, wsh, q);
    }
  }
};

// shifts [steps, B]; acc0/out [B, C, n] 64-bit; ev1/ev2 and their Shoup
// companions [steps, C, l, C, 2, n]; tw/twinv [2][n] tables of the two
// primes; cons three rows: (q0, -, n^-1, sh), (q1, -, n^-1, sh) and
// (q1, -, q0^-1 mod q1, sh).  Grid: 2B blocks, clusters of 2.
template <int LOGN, bool STAGED>
__global__ void __cluster_dims__(kBrCluster, 1, 1)
    __launch_bounds__(kBrThreads, 1)
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
                        const uint32_t* __restrict__ cons, int steps, int B,
                        int C, int l, int w, int vec) {
  using S = RadixShape<LOGN>;
  constexpr int n = S::n;
  constexpr int V = S::vthreads;             // virtual threads a polynomial
  constexpr int last = S::passes - 1;
  constexpr int c0 = S::fwd_c(0);
  constexpr int cl = S::inv_c(last);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kBrCluster;
  const int fwd = C * l;                     // digit polynomials
  const int cols = 2 * C;                    // contracted columns
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);   // key copies
  uint64_t* xbar = bar + 1;                  // [2]: the peer's columns
  unsigned long long* acc =
      reinterpret_cast<unsigned long long*>(smem_raw + kBrBarrierBytes);
  uint32_t* dig = reinterpret_cast<uint32_t*>(acc + C * n);
  uint32_t* res = dig + fwd * n;             // [cols][n]
  uint32_t* xch = res + cols * n;            // [2][cols][n], the peer's
  uint32_t* kbuf = xch + 2 * cols * n;       // [2][fwd * cols * n] if STAGED
  const PrimeRow pr = prime_row(cons, rank);
  const uint32_t q = pr.q;
  const uint32_t* fw = tw + rank * n;
  const uint32_t* fwsh = tw_sh + rank * n;
  const uint32_t* iw = twinv + rank * n;
  const uint32_t* iwsh = twinv_sh + rank * n;
  const uint32_t* ev = rank ? ev2 : ev1;
  const uint32_t* evs = rank ? ev2s : ev1s;
  const PrimeRow c0r = prime_row(cons, 0);
  const PrimeRow c1r = prime_row(cons, 1);
  const PrimeRow crt = prime_row(cons, 2);
  const uint32_t q0 = c0r.q, q1 = c1r.q;
  const unsigned long long m12 = static_cast<unsigned long long>(q0) * q1;
  const unsigned long long half12 = m12 >> 1;
  const uint32_t mask = (1u << w) - 1u;      // w <= 31
  const size_t base_b = static_cast<size_t>(b) * C * n;
  const uint32_t kwords = static_cast<uint32_t>(fwd * cols) << LOGN;

  if (threadIdx.x == 0) {
    mbar_init(xbar, 1);
    mbar_init(xbar + 1, 1);
    if constexpr (STAGED) {
      mbar_init(bar, 1);
      stage_key(kbuf, ev, evs, kwords, bar);
    }
  }
  for (int i = threadIdx.x; i < C * n; i += kBrThreads) {
    acc[i] = acc0[base_b + i];
  }
  // both blocks run and their barriers are set up before any store to the
  // peer
  cluster.sync();
  const uint32_t peer_xch = cluster_addr(xch, rank ^ 1);
  const uint32_t peer_xbar = cluster_addr(xbar, rank ^ 1);

  int h_next = shifts[b];
#pragma unroll 1
  for (int j = 0; j < steps; ++j) {
    // the next step's shift is read a step ahead, off the critical path
    const int h = h_next & (2 * n - 1);
    if (j + 1 < steps) h_next = shifts[static_cast<size_t>(j + 1) * B + b];
    // forward pass 0 from the rotated accumulator: virtual thread v of
    // polynomial p = c * l + i holds elements v + (k << c0), digit i of
    // component c of acc * X^-h - acc (a digit < 2^w is canonical under
    // either prime)
#pragma unroll 1
    for (int t = threadIdx.x; t < fwd * V; t += kBrThreads) {
      const int p = t >> (LOGN - kRadixBits);
      const int v = t & (V - 1);
      const int cc = p / l;
      const int shift = 64 - w * (p - cc * l + 1);
      const unsigned long long* ac = acc + cc * n;
      uint32_t x[kRadix];
#pragma unroll
      for (int k = 0; k < kRadix; ++k) {
        const int a = v + (k << c0);
        const int src = a + h;               // in [0, 3n)
        unsigned long long r = ac[src & (n - 1)];
        if ((src >> LOGN) & 1) r = 0ull - r;
        x[k] = static_cast<uint32_t>((r - ac[a]) >> shift) & mask;
      }
      radix_pass<LOGN, 0, false>(x, v, fw, fwsh, q);
      radix_store<c0>(dig + (p << LOGN), x, v);
    }
    __syncthreads();
    BrPasses<LOGN, 1, S::passes, false>::run(dig, fwd, radix_opaque(fw),
                                             radix_opaque(fwsh), q);
    // the contraction in the first inverse pass's registers: column o at
    // the 16 contiguous words of virtual thread v
    const uint32_t* kv;
    const uint32_t* ks;
    if constexpr (STAGED) {
      mbar_wait(bar, static_cast<uint32_t>(j & 1));
      kv = kbuf;
      ks = kbuf + kwords;
    } else {
      const size_t kj = static_cast<size_t>(j) * kwords;
      kv = ev + kj;
      ks = evs + kj;
    }
    uint32_t* rb = res;
#pragma unroll 1
    for (int t = threadIdx.x; t < cols * V; t += kBrThreads) {
      const int o = t >> (LOGN - kRadixBits);
      const int v = t & (V - 1);
      const int base = v << kRadixBits;
      // lane v takes its four 4-word chunks starting at chunk rot: the 16-
      // byte key reads of 8 lanes then fall on 8 distinct bank groups, and
      // the digit reads stay conflict-free (tests/test_torch_blind_rotate_
      // plan.py checks both); x holds chunk (u + rot) & 3 at 4u
      const int rot = (v >> 1) & 3;
      const int sb = radix_swizzle(base);
      uint32_t x[kRadix];
#pragma unroll
      for (int k = 0; k < kRadix; ++k) x[k] = 0;
#pragma unroll 2
      for (int ri = 0; ri < fwd; ++ri) {
        const uint32_t* d = dig + (ri << LOGN);
        const size_t at = (static_cast<size_t>(ri * cols + o) << LOGN) + base;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int ch = ((u + rot) & 3) << 2;
          uint32_t K[4], KS[4];
          if constexpr (STAGED) {
            const uint4 a = *reinterpret_cast<const uint4*>(kv + at + ch);
            const uint4 s = *reinterpret_cast<const uint4*>(ks + at + ch);
            K[0] = a.x; K[1] = a.y; K[2] = a.z; K[3] = a.w;
            KS[0] = s.x; KS[1] = s.y; KS[2] = s.z; KS[3] = s.w;
          } else {
            operand_words(K, kv + at + ch, vec != 0);
            operand_words(KS, ks + at + ch, vec != 0);
          }
          const int db = sb ^ ch;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            x[4 * u + i] = addmod(
                x[4 * u + i], shoup_mul(d[db ^ i], K[i], KS[i], q), q);
          }
        }
      }
      // back to chunk order: rotate by rot's two bits in turn
      if (rot & 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t y = x[12 + i];
          x[12 + i] = x[8 + i];
          x[8 + i] = x[4 + i];
          x[4 + i] = x[i];
          x[i] = y;
        }
      }
      if (rot & 2) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint32_t y = x[i];
          x[i] = x[8 + i];
          x[8 + i] = y;
        }
      }
      radix_pass<LOGN, 0, true>(x, base, radix_opaque(iw),
                                radix_opaque(iwsh), q);
      radix_store<0>(rb + (o << LOGN), x, base);
    }
    __syncthreads();
    if constexpr (STAGED) {
      // the buffer is consumed: step j+1's key planes come in under the rest
      // of this step and the next step's forward passes
      if (threadIdx.x == 0 && j + 1 < steps) {
        const size_t kj = static_cast<size_t>(j + 1) * kwords;
        stage_key(kbuf, ev + kj, evs + kj, kwords, bar);
      }
    }
    BrPasses<LOGN, 1, last, true>::run(rb, cols, iw, iwsh, q);
    // the last inverse pass, times n^-1, into this block's columns and,
    // by asynchronous stores that count down the peer's mbarrier, into the
    // peer's exchange buffer of this step's parity
    const int par = j & 1;
    const uint32_t px = peer_xch + ((par * cols) << (LOGN + 2));
    const uint32_t pb = peer_xbar + 8 * par;
#pragma unroll 1
    for (int t = threadIdx.x; t < cols * V; t += kBrThreads) {
      const int off = (t >> (LOGN - kRadixBits)) << LOGN;
      const int base = radix_base(t & (V - 1), cl);
      uint32_t x[kRadix];
      radix_load<cl>(x, rb + off, base);
      radix_pass<LOGN, last, true>(x, base, iw, iwsh, q);
#pragma unroll
      for (int k = 0; k < kRadix; ++k) {
        x[k] = shoup_mul(x[k], pr.fin, pr.fin_sh, q);
      }
      radix_store<cl>(rb + off, x, base);
      const int sb = radix_swizzle(base);
#define FHE_PUSH(K) \
  st_peer(px + 4 * (off + radix_word<cl, K>(sb)), x[K], pb);
      FHE_PUSH(0) FHE_PUSH(1) FHE_PUSH(2) FHE_PUSH(3) FHE_PUSH(4)
      FHE_PUSH(5) FHE_PUSH(6) FHE_PUSH(7) FHE_PUSH(8) FHE_PUSH(9)
      FHE_PUSH(10) FHE_PUSH(11) FHE_PUSH(12) FHE_PUSH(13) FHE_PUSH(14)
      FHE_PUSH(15)
#undef FHE_PUSH
    }
    // this block's columns, and the peer's once all their bytes are in
    if (threadIdx.x == 0) {
      mbar_expect(xbar + par, static_cast<uint32_t>(cols * 4) << LOGN);
    }
    __syncthreads();
    mbar_wait(xbar + par, static_cast<uint32_t>((j >> 1) & 1));
    // exact CRT lift of (r_0, r_1) to the centred integer, the two 32-bit
    // key limbs recombined mod 2^64, accumulated
    const uint32_t* peer = xch + ((par * cols) << LOGN);
    const uint32_t* r0 = rank ? peer : rb;
    const uint32_t* r1 = rank ? rb : peer;
#pragma unroll 1
    for (int i0 = threadIdx.x; i0 < C * n; i0 += kCrtWords * kBrThreads) {
      uint32_t a0[kCrtWords][2], a1[kCrtWords][2];
#pragma unroll
      for (int u = 0; u < kCrtWords; ++u) {
        const int idx = i0 + u * kBrThreads;
        if (idx < C * n) {
          const int at = ((idx >> LOGN) << (LOGN + 1)) +
                         radix_swizzle(idx & (n - 1));
          a0[u][0] = r0[at];
          a1[u][0] = r1[at];
          a0[u][1] = r0[at + n];
          a1[u][1] = r1[at + n];
        }
      }
#pragma unroll
      for (int u = 0; u < kCrtWords; ++u) {
        const int idx = i0 + u * kBrThreads;
        if (idx < C * n) {
          unsigned long long val = 0;
#pragma unroll
          for (int limb = 0; limb < 2; ++limb) {
            const uint32_t r = a0[u][limb];
            const uint32_t rp = r >= q1 ? r - q1 : r;    // q0 < 2 * q1
            const uint32_t dm =
                shoup_mul(submod(a1[u][limb], rp, q1), crt.fin, crt.fin_sh,
                          q1);
            unsigned long long g = r + static_cast<unsigned long long>(q0) * dm;
            if (g > half12) g -= m12;
            val += g << (32 * limb);
          }
          acc[idx] += val;
        }
      }
    }
    __syncthreads();
  }
  // no store to the peer is left in flight when either block exits; each
  // block writes out half of the (equal) accumulators
  cluster.sync();
  const int half = (C * n) / kBrCluster;
  for (int i = rank * half + threadIdx.x; i < (rank + 1) * half;
       i += kBrThreads) {
    out[base_b + i] = acc[i];
  }
}

struct BlindRotateLaunch {
  template <int LOGN>
  static int run(int threads, int smem, int staged, int B, cudaStream_t stream,
                 const int* shifts, const unsigned long long* acc0,
                 const uint32_t* ev1, const uint32_t* ev1s,
                 const uint32_t* ev2, const uint32_t* ev2s,
                 unsigned long long* out, const uint32_t* tw,
                 const uint32_t* tw_sh, const uint32_t* twinv,
                 const uint32_t* twinv_sh, const uint32_t* cons, int steps,
                 int C, int l, int w, int vec) {
    if (threads != kBrThreads ||
        smem != br_smem_bytes(C, l, LOGN, staged != 0)) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    auto kernel = &blind_rotate_kernel<LOGN, false>;
    if (staged) kernel = &blind_rotate_kernel<LOGN, true>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<kBrCluster * B, kBrThreads, smem, stream>>>(
        shifts, acc0, ev1, ev1s, ev2, ev2s, out, tw, tw_sh, twinv, twinv_sh,
        cons, steps, B, C, l, w, vec);
    return static_cast<int>(cudaGetLastError());
  }
};

// BlindRotateLaunch at the degrees whose working set can fit a block: no
// instance past 2^kBrMaxLogN is built.
struct ClusterDegrees {
  template <int LOGN, typename... Args>
  static int run(Args... args) {
    if constexpr (LOGN <= kBrMaxLogN) {
      return BlindRotateLaunch::run<LOGN>(args...);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
};

}  // namespace
}  // namespace fhe

using namespace fhe;

namespace fhe {
// K10's device-memory layout (csrc/blind_rotate_dm_cuda.cu).
int blind_rotate_dm(const int* shifts, const unsigned long long* acc0,
                    const uint32_t* ev1, const uint32_t* ev1s,
                    const uint32_t* ev2, const uint32_t* ev2s,
                    unsigned long long* out, uint32_t* dig,
                    const uint32_t* tw, const uint32_t* tw_sh,
                    const uint32_t* twinv, const uint32_t* twinv_sh,
                    const uint32_t* cons, int steps, int B, int C, int l,
                    int w, int logn, int threads, int smem, int vec,
                    cudaStream_t stream);
// K10's grid layout past one block (csrc/blind_rotate_grid_cuda.cu).
int blind_rotate_grid(const int* shifts, const unsigned long long* acc0,
                      const uint32_t* ev1, const uint32_t* ev1s,
                      const uint32_t* ev2, const uint32_t* ev2s,
                      unsigned long long* out, uint32_t* scratch,
                      const uint32_t* tw, const uint32_t* tw_sh,
                      const uint32_t* twinv, const uint32_t* twinv_sh,
                      const uint32_t* cons, int steps, int B, int C, int l,
                      int w, int logn, int threads, int smem, int vec,
                      cudaStream_t stream);
// K10's split layout at n = 2^16 (csrc/blind_rotate_split_cuda.cu).
int blind_rotate_split(const int* shifts, const unsigned long long* acc0,
                       const uint32_t* ev1, const uint32_t* ev1s,
                       const uint32_t* ev2, const uint32_t* ev2s,
                       unsigned long long* out, uint32_t* dig,
                       const uint32_t* tw, const uint32_t* tw_sh,
                       const uint32_t* twinv, const uint32_t* twinv_sh,
                       const uint32_t* cons, int steps, int B, int C, int l,
                       int w, int logn, int threads, int smem, int vec,
                       cudaStream_t stream);
// K10's quarter layout at n = 2^17 (csrc/blind_rotate_quarter_cuda.cu).
int blind_rotate_quarter(const int* shifts, const unsigned long long* acc0,
                         const uint32_t* ev1, const uint32_t* ev1s,
                         const uint32_t* ev2, const uint32_t* ev2s,
                         unsigned long long* out, uint32_t* dig,
                         const uint32_t* tw, const uint32_t* tw_sh,
                         const uint32_t* twinv, const uint32_t* twinv_sh,
                         const uint32_t* cons, int steps, int B, int C, int l,
                         int w, int logn, int threads, int smem, int vec,
                         cudaStream_t stream);
}  // namespace fhe

// threads, smem, staged and layout: the host's plan (ops/blind_rotate_cuda.py
// ::_plan), which must be this build's.  layout 0: the two-block clusters of
// this file, one a ciphertext, n = 2^7 .. 2^14; staged: the key planes are
// copied into shared memory by bulk copies (ev1, ev1s, ev2, ev2s 16-byte
// aligned); otherwise the contraction reads them from device memory, as
// 16-byte words where they are aligned.  layout 1: the working set in device
// memory (csrc/blind_rotate_dm_cuda.cu), n = 2^7 .. 2^15, scratch the digit
// evaluations [B, 2, C*l, n]; staged must be 0.  layout 2: that past one
// block (csrc/blind_rotate_grid_cuda.cu), n = 2^16 .. 2^22, the tables the
// chunk tables, scratch [B, 2, C*l + max(C*l, 2C), n]; staged must be 0.
// layout 3: each polynomial split over a cluster's shared memory at
// n = 2^16 (csrc/blind_rotate_split_cuda.cu), the tables the chunk tables,
// scratch the digit evaluations [B, 2, C*l, n]; staged must be 0.
// layout 4: each polynomial in quarters over a cluster's shared memory at
// n = 2^17 (csrc/blind_rotate_quarter_cuda.cu), the tables the chunk
// tables, cons five rows, scratch as layout 3's; staged must be 0.
extern "C" int fhe_blind_rotate(
    const int* shifts, const unsigned long long* acc0, const uint32_t* ev1,
    const uint32_t* ev1s, const uint32_t* ev2, const uint32_t* ev2s,
    unsigned long long* out, const uint32_t* tw, const uint32_t* tw_sh,
    const uint32_t* twinv, const uint32_t* twinv_sh, const uint32_t* cons,
    uint32_t* scratch, int steps, int B, int C, int l, int w, int logn,
    int threads, int smem, int staged, int layout, cudaStream_t stream) {
  const bool aligned = !(misaligned(ev1) || misaligned(ev1s) ||
                         misaligned(ev2) || misaligned(ev2s));
  if (steps < 1 || B < 1 || B > (1 << 30) || C < 1 || l < 1 || w < 1 ||
      w > 31 || w * l > 64 || (staged && !aligned) ||
      (layout != 0 && (layout > 4 || staged))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (layout == 4) {
    return blind_rotate_quarter(shifts, acc0, ev1, ev1s, ev2, ev2s, out,
                                scratch, tw, tw_sh, twinv, twinv_sh, cons,
                                steps, B, C, l, w, logn, threads, smem,
                                aligned ? 1 : 0, stream);
  }
  if (layout == 3) {
    return blind_rotate_split(shifts, acc0, ev1, ev1s, ev2, ev2s, out,
                              scratch, tw, tw_sh, twinv, twinv_sh, cons,
                              steps, B, C, l, w, logn, threads, smem,
                              aligned ? 1 : 0, stream);
  }
  if (layout == 2) {
    return blind_rotate_grid(shifts, acc0, ev1, ev1s, ev2, ev2s, out,
                             scratch, tw, tw_sh, twinv, twinv_sh, cons, steps,
                             B, C, l, w, logn, threads, smem,
                             aligned ? 1 : 0, stream);
  }
  if (layout == 1) {
    return blind_rotate_dm(shifts, acc0, ev1, ev1s, ev2, ev2s, out, scratch,
                           tw, tw_sh, twinv, twinv_sh, cons, steps, B, C, l,
                           w, logn, threads, smem, aligned ? 1 : 0, stream);
  }
  if (logn > kBrMaxLogN) return static_cast<int>(cudaErrorInvalidValue);
  return by_logn<ClusterDegrees>(logn, threads, smem, staged, B, stream,
                                 shifts, acc0, ev1, ev1s, ev2, ev2s, out, tw,
                                 tw_sh, twinv, twinv_sh, cons, steps, C, l, w,
                                 aligned ? 1 : 0);
}
