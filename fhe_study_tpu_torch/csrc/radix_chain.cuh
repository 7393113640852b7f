// The stage chains of the negacyclic NTT that every kernel of the package
// runs: the forward (Cooley-Tukey) and the inverse (Gentleman-Sande, without
// n^-1) over bit-reversed root tables, butterfly for butterfly those of
// fhe_study_tpu/ops/ntt.py, grouped so that a thread runs kRadixBits stages
// on kRadix = 16 coefficients held in registers between two exchanges
// through shared memory.  K1 and K9 (ntt_multi and ntt,
// csrc/ntt_multi_cuda.cu), K2 (tensor_eval4, csrc/ntt_cuda.cu), K3
// (ks_contract, csrc/ks_contract_cuda.cu), K5 (ext_ntt, csrc/ext_ntt_cuda.cu),
// K6 (tensor_mul4 and tensor_mul, csrc/tensor_mul4_cuda.cu), K7 and K8
// (ks_fused and ks_fused_eval, csrc/ks_fused.cuh), K10 (blind_rotate,
// csrc/blind_rotate_cuda.cu) and the measuring loop K12 (ntt_smem_ceiling,
// csrc/bench_cuda.cu) run them.
//
// Element a of the polynomial has log n bits.  A pass holds bits
// [c, c + 4) of a in registers: virtual thread v owns the 16 elements
// base(v, c) | (k << c), k < 16, where base spreads v's bits over the other
// bits in ascending order, so lanes of a warp differ in the lowest bits
// outside [c, c + 4).  The pass runs the stages whose bits lie in
// [c, c + 4) and that no earlier pass ran: the forward chain walks the bits
// from log n - 1 down to 0 (passes at c = log n - 4, log n - 8, ..., the last
// at c = 0 over the bits left), the inverse chain from 0 up (c = 0, 4, ...,
// the last at c = log n - 4 over the bits left), so every log n from 7 to 15
// takes ceil(log n / 4) passes and ceil(log n / 4) - 1 exchanges, against the
// log n barriers of a chain that runs one stage between two.  The forward
// chain's last pass and the inverse chain's first both hold bits 0..3, so a
// virtual thread owns the same 16 elements in the two (K6 forms its products
// there, in registers).
//
// Twiddles: stage bit j of either chain multiplies by w[(n >> (j + 1)) +
// (a >> (j + 1))] of the bit-reversed [L, n] table (roots or inverse roots,
// with Shoup companions), so the 2^(3 - u) twiddles of stage u of a pass lie
// side by side and aligned: one uint4, uint2 or word load each of the root
// and its companion, 15 pairs a pass against 2 loads a butterfly before.
//
// Shared memory holds the n words under a XOR swizzle of the low 5 bits by
// bits 5..8 (radix_swizzle); every access of every pass, and the coalesced
// read-out of the forward chains of K1, K5, K9 and K12, then hits 32
// distinct banks (ops/ntt_cuda.py::_radix_plan and its CPU test check the
// maps; the swizzle is a bijection on every aligned block of 512 words).
//
// The butterfly stays the fully reduced one of modarith.cuh (shoup_mul,
// addmod, submod on canonical residues), so every output equals the plain
// versions' bit for bit, whatever the grouping of the stages.
#pragma once

#include "modarith.cuh"

namespace fhe {

constexpr int kRadixBits = 4;
constexpr int kRadix = 1 << kRadixBits;
// A block runs at most kRadixThreads threads, each playing n / (16 *
// threads) virtual threads one after the other (4 at n = 2^14), so that only
// 16 coefficients are live in its registers at a time; kRadixBlocks such
// blocks fit an SM (3 x 64 KB of shared memory at n = 2^14, and up to 85
// registers a thread, which K5's conversion needs beside its 16 words).  A
// kernel that holds more polynomials on chip (K6, K7 and K8: three buffers,
// 192 KB at n = 2^14, one block an SM) names its own thread count in
// RadixShape.
constexpr int kRadixThreads = 256;
constexpr int kRadixBlocks = 3;
// The kernels that hold one polynomial in shared memory (K1-K3, K5, K9 and
// K12) also take n = 2^kWideLogN = 2^15, where the polynomial alone takes
// 128 KB: one block an SM.  There a block runs kWideThreads threads, each
// playing 4 virtual threads with up to 128 registers, so that the SM keeps
// 16 warps in flight where kRadixThreads would leave it 8 (OneBuffer).  The
// kernels with three buffers (K6, K7, K8: 384 KB at 2^15) take 2^15 on a
// cluster of two blocks, each holding one half of every buffer (Split); K10's
// cluster layout stops at 2^14 (by_logn), its device-memory layout runs the
// one-buffer shape up to 2^15.  Every kernel starts at 2^7.
constexpr int kWideLogN = 15;
constexpr int kWideThreads = 512;

__host__ __device__ constexpr int radix_min(int a, int b) {
  return a < b ? a : b;
}

__host__ __device__ constexpr int radix_max(int a, int b) {
  return a > b ? a : b;
}

// The pass structure at n = 2^LOGN on blocks of at most THREADS threads
// (mirrored by ops/ntt_cuda.py::_radix_plan).
template <int LOGN, int THREADS = kRadixThreads>
struct RadixShape {
  static constexpr int n = 1 << LOGN;
  static constexpr int passes = (LOGN + kRadixBits - 1) / kRadixBits;
  static constexpr int vthreads = n >> kRadixBits;
  static constexpr int threads = radix_min(vthreads, THREADS);
  static constexpr int groups = vthreads / threads;
  // forward pass p: register bits [c, c + 4), stages u = uhi, ..., 0
  __host__ __device__ static constexpr int fwd_c(int p) {
    return radix_max(LOGN - kRadixBits * (p + 1), 0);
  }
  __host__ __device__ static constexpr int fwd_uhi(int p) {
    return LOGN - kRadixBits * p - 1 - fwd_c(p);
  }
  // inverse pass p: register bits [c, c + 4), stages u = ulo, ..., 3
  __host__ __device__ static constexpr int inv_c(int p) {
    return radix_min(kRadixBits * p, LOGN - kRadixBits);
  }
  __host__ __device__ static constexpr int inv_ulo(int p) {
    return kRadixBits * p - inv_c(p);
  }
};

// Block shape of a one-buffer kernel at n = 2^LOGN: its threads, blocks an
// SM (__launch_bounds__) and pass structure (mirrored by the default
// max_threads of ops/ntt_cuda.py::_radix_plan).
template <int LOGN>
struct OneBuffer {
  static constexpr int threads =
      LOGN < kWideLogN ? kRadixThreads : kWideThreads;
  static constexpr int blocks = LOGN < kWideLogN ? kRadixBlocks : 1;
  using Shape = RadixShape<LOGN, threads>;
};

// A kernel with three buffers at n = 2^LOGN: at kWideLogN on a cluster of
// kSplitBlocks blocks split on the top bit.  Block r of the pair holds the
// elements whose bit LOGN - 1 is r, h = n / 2 words of each buffer, and runs
// the chains of 2^logh = h words: the forward chain's first stage (bit
// LOGN - 1) pairs element i with i + h, so each block forms it for its own
// half from both halves of the row in device memory (split_words), or,
// where each word costs a conversion (K6 from a source basis), converts
// only its own half and runs the stage across the cluster
// (split_top_stage); bits logh - 1 .. 0 never leave the block; the
// inverse chain's last stage reads the peer's half through distributed
// shared memory (split_inverse_out).
// The half's stage at bit j takes root (n >> (j + 1)) + (i' >> (j + 1)) of
// element i' = r h + i, which the host's split tables put at
// (h >> (j + 1)) + (i >> (j + 1)) of row (prime, r), and the top stage's
// root at word 0 of both rows (ops/ntt_cuda.py::_split_index): the chain
// code of 2^logh runs unchanged.
constexpr int kSplitBlocks = 2;

template <int LOGN>
struct Split {
  static constexpr bool on = LOGN == kWideLogN;
  static constexpr int logh = on ? LOGN - 1 : LOGN;
  static constexpr int blocks = on ? kSplitBlocks : 1;
};

// Shared-memory word of element a: bits 0..4 XORed with h ^ (h << 1),
// h = bits 5..8 (linear, so swizzle(x ^ y) = swizzle(x) ^ swizzle(y)).
__host__ __device__ constexpr int radix_swizzle(int a) {
  return a ^ ((((a >> 5) & 15) ^ (((a >> 5) & 15) << 1)) & 31);
}

// First element of virtual thread v in a pass that holds bits [c, c + 4).
__device__ __forceinline__ int radix_base(int v, int c) {
  return (v & ((1 << c) - 1)) | ((v >> c) << (c + kRadixBits));
}

// Shared-memory word of element base | (k << C), from sb = swizzle(base):
// the part of the offset above bit 4 lies in bits that are 0 in sb, so it
// is an add (an immediate of the load) and only the low bits need a XOR.
template <int C, int K>
__device__ __forceinline__ int radix_word(int sb) {
  constexpr int off = radix_swizzle(K << C);
  return (sb ^ (off & 31)) + (off & ~31);
}

template <int C>
__device__ __forceinline__ void radix_load(uint32_t (&x)[kRadix],
                                           const uint32_t* a, int base) {
  const int sb = radix_swizzle(base);
#define FHE_LD(K) x[K] = a[radix_word<C, K>(sb)];
  FHE_LD(0) FHE_LD(1) FHE_LD(2) FHE_LD(3) FHE_LD(4) FHE_LD(5) FHE_LD(6)
  FHE_LD(7) FHE_LD(8) FHE_LD(9) FHE_LD(10) FHE_LD(11) FHE_LD(12) FHE_LD(13)
  FHE_LD(14) FHE_LD(15)
#undef FHE_LD
}

template <int C>
__device__ __forceinline__ void radix_store(uint32_t* a,
                                            const uint32_t (&x)[kRadix],
                                            int base) {
  const int sb = radix_swizzle(base);
#define FHE_ST(K) a[radix_word<C, K>(sb)] = x[K];
  FHE_ST(0) FHE_ST(1) FHE_ST(2) FHE_ST(3) FHE_ST(4) FHE_ST(5) FHE_ST(6)
  FHE_ST(7) FHE_ST(8) FHE_ST(9) FHE_ST(10) FHE_ST(11) FHE_ST(12) FHE_ST(13)
  FHE_ST(14) FHE_ST(15)
#undef FHE_ST
}

// W consecutive words from p, aligned to W words, in one load.
template <int W>
__device__ __forceinline__ void radix_words(uint32_t (&d)[W],
                                            const uint32_t* p) {
  if constexpr (W == 8) {
    const uint4 lo = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 hi = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    d[0] = lo.x; d[1] = lo.y; d[2] = lo.z; d[3] = lo.w;
    d[4] = hi.x; d[5] = hi.y; d[6] = hi.z; d[7] = hi.w;
  } else if constexpr (W == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else if constexpr (W == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    d[0] = v.x; d[1] = v.y;
  } else {
    d[0] = __ldg(p);
  }
}

// Stage u of a pass: pairs (k, k | 2^u) for k without bit u; pair k takes
// twiddle k >> (u + 1) of the 2^(3 - u) at w (wsh: their Shoup companions).
template <int U, bool INV>
__device__ __forceinline__ void radix_stage(uint32_t (&x)[kRadix],
                                            const uint32_t* w,
                                            const uint32_t* wsh, uint32_t q) {
  constexpr int W = 8 >> U;
  uint32_t t[W], ts[W];
  radix_words<W>(t, w);
  radix_words<W>(ts, wsh);
#pragma unroll
  for (int k = 0; k < kRadix; ++k) {
    if (k & (1 << U)) continue;
    const int k2 = k | (1 << U);
    const int j = k >> (U + 1);
    const uint32_t u = x[k];
    if constexpr (INV) {
      const uint32_t v = x[k2];
      x[k] = addmod(u, v, q);
      x[k2] = shoup_mul(submod(u, v, q), t[j], ts[j], q);
    } else {
      const uint32_t v = shoup_mul(x[k2], t[j], ts[j], q);
      x[k] = addmod(u, v, q);
      x[k2] = submod(u, v, q);
    }
  }
}

// The stages of pass P on the registers of the virtual thread at base:
// stage u at bit c + u reads its twiddles from (n >> (c + u + 1)) +
// ((base >> (c + 4)) << (3 - u)).
template <int LOGN, int P, bool INV>
__device__ __forceinline__ void radix_pass(uint32_t (&x)[kRadix], int base,
                                           const uint32_t* w,
                                           const uint32_t* wsh, uint32_t q) {
  using S = RadixShape<LOGN>;
  constexpr int c = INV ? S::inv_c(P) : S::fwd_c(P);
  const int hb = base >> (c + kRadixBits);
#define FHE_AT(U) ((S::n >> (c + (U) + 1)) + (hb << (3 - (U))))
  if constexpr (INV) {
    constexpr int ulo = S::inv_ulo(P);
    if constexpr (ulo <= 0) radix_stage<0, true>(x, w + FHE_AT(0), wsh + FHE_AT(0), q);
    if constexpr (ulo <= 1) radix_stage<1, true>(x, w + FHE_AT(1), wsh + FHE_AT(1), q);
    if constexpr (ulo <= 2) radix_stage<2, true>(x, w + FHE_AT(2), wsh + FHE_AT(2), q);
    radix_stage<3, true>(x, w + FHE_AT(3), wsh + FHE_AT(3), q);
  } else {
    constexpr int uhi = S::fwd_uhi(P);
    if constexpr (uhi >= 3) radix_stage<3, false>(x, w + FHE_AT(3), wsh + FHE_AT(3), q);
    if constexpr (uhi >= 2) radix_stage<2, false>(x, w + FHE_AT(2), wsh + FHE_AT(2), q);
    if constexpr (uhi >= 1) radix_stage<1, false>(x, w + FHE_AT(1), wsh + FHE_AT(1), q);
    radix_stage<0, false>(x, w + FHE_AT(0), wsh + FHE_AT(0), q);
  }
#undef FHE_AT
}

// Passes P .. END - 1, each from shared memory through registers back to
// shared memory, each ending with a barrier; with NB > 1 on NB polynomials
// under the same prime, buffer i at a + i * n, one after another inside each
// pass (a run-time loop: one copy of the pass's code, which measured faster
// on K6 than the three side by side with shared twiddle loads).
template <int LOGN, int P, int END, bool INV, int THREADS = kRadixThreads,
          int NB = 1>
struct RadixPasses {
  __device__ __forceinline__ static void run(uint32_t* a, const uint32_t* w,
                                             const uint32_t* wsh, uint32_t q) {
    if constexpr (P < END) {
      using S = RadixShape<LOGN, THREADS>;
      constexpr int c = INV ? S::inv_c(P) : S::fwd_c(P);
#pragma unroll 1
      for (int g = 0; g < S::groups; ++g) {
        const int base = radix_base(threadIdx.x + g * S::threads, c);
#pragma unroll 1
        for (int i = 0; i < NB; ++i) {
          uint32_t x[kRadix];
          radix_load<c>(x, a + i * S::n, base);
          radix_pass<LOGN, P, INV>(x, base, w, wsh, q);
          radix_store<c>(a + i * S::n, x, base);
        }
      }
      __syncthreads();
      RadixPasses<LOGN, P + 1, END, INV, THREADS, NB>::run(a, w, wsh, q);
    }
  }
};

// p as a value the compiler cannot see through: loads through the result
// are neither merged with loads made before this point nor moved above it,
// so one phase's device-memory words and twiddles stay out of the registers
// of the phase before.
template <typename T>
__device__ __forceinline__ T* radix_opaque(T* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// Operand rows may be strided views: row (p, b) of operand o starts at
// p * l[o] + b * b[o] words.
struct Strides {
  long long l[4], b[4];
};

// Four consecutive operand words at p: one uint4 load when p is 16-byte
// aligned (vec), four word loads otherwise.
__device__ __forceinline__ void operand_words(uint32_t (&d)[4],
                                              const uint32_t* p, bool vec) {
  if (vec) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) d[j] = __ldg(p + j);
  }
}

// Launch of a radix-chain kernel at n = 2^LOGN on blocks of at most THREADS
// threads holding NBUF polynomials in shared memory: the host's plan
// (ops/ntt_cuda.py::_radix_plan) hands in the block size and shared-memory
// bytes, which must be this build's.
template <int LOGN, int THREADS = kRadixThreads, int NBUF = 1,
          typename Kernel, typename... Args>
int radix_launch(Kernel kernel, int threads, int smem, int blocks,
                 cudaStream_t stream, Args... args) {
  using S = RadixShape<LOGN, THREADS>;
  if (threads != S::threads ||
      smem != NBUF * S::n * static_cast<int>(sizeof(uint32_t))) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > 0) kernel<<<blocks, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The block's rank in its cluster (0 without clusters); a pure read, which
// the compiler may repeat rather than hold in a register.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of the cluster arrives and waits; the shared-memory writes
// made before it are visible to the cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A barrier in shared memory whose arrival and wait are apart (mbarrier):
// a thread arrives once its accesses before the barrier are made and goes
// on with work that touches none of the words they guard, then waits with
// the token of its arrival before it touches them again; the wait returns
// once every one of `count` threads has arrived (release at the arrival,
// acquire at the wait, as __syncthreads).  Thread 0 initialises it, and a
// block barrier must lie between that and the first arrival.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ uint64_t mbar_arrive(uint64_t* bar) {
  uint64_t token;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];\n"
               : "=l"(token)
               : "r"(smem_addr(bar))
               : "memory");
  return token;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint64_t token) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "l"(token)
      : "memory");
}

// The shared::cluster address of p in the shared memory of block `rank`
// (K10's exchange and the split's last stage).
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  const uint32_t local =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(local), "r"(rank));
  return a;
}

__device__ __forceinline__ uint32_t cluster_load(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n"
               : "=r"(v)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void cluster_store(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}

// The four words at a 16-byte aligned shared::cluster address, and their
// store (K10's quarter layout).
__device__ __forceinline__ void cluster_load4(uint32_t addr,
                                              uint32_t (&v)[4]) {
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void cluster_store4(uint32_t addr,
                                               const uint32_t (&v)[4]) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

// Element i of block r's half after the forward chain's first stage of a
// split (Split): x[i] + w1 x[i + h] (r = 0) or x[i] - w1 x[i + h] (r = 1),
// from the words f(i) and f(i + h) of the whole row (K10's split forward).
template <typename F>
__device__ __forceinline__ uint32_t split_word(F f, int i, int h, int r,
                                               uint32_t w1, uint32_t w1sh,
                                               uint32_t q) {
  const uint32_t v = shoup_mul(f(i + h), w1, w1sh, q);
  const uint32_t lo = f(i);
  return r != 0 ? submod(lo, v, q) : addmod(lo, v, q);
}

// The 16 words base + (k << C) of block r's half after the forward chain's
// first stage of a split (Split), read from the whole row src of 2h words
// (K6's over its destination basis, K7's and K8's first pass): the 32
// words of both halves issued before any arithmetic, each reduced by
// `subs` conditional subtractions, then x[k] = lo + w1 hi (r = 0) or
// lo - w1 hi (r = 1), split_word's arithmetic.
template <int C>
__device__ __forceinline__ void split_words(uint32_t (&x)[kRadix],
                                            const uint32_t* src, int base,
                                            int h, int r, int subs,
                                            uint32_t w1, uint32_t w1sh,
                                            uint32_t q) {
  uint32_t hi[kRadix];
#pragma unroll
  for (int k = 0; k < kRadix; ++k) {
    x[k] = __ldg(src + base + (k << C));
    hi[k] = __ldg(src + h + base + (k << C));
  }
#pragma unroll 1
  for (int s = 0; s < subs; ++s) {
#pragma unroll
    for (int k = 0; k < kRadix; ++k) {
      x[k] = x[k] >= q ? x[k] - q : x[k];
      hi[k] = hi[k] >= q ? hi[k] - q : hi[k];
    }
  }
#pragma unroll
  for (int k = 0; k < kRadix; ++k) {
    const uint32_t v = shoup_mul(hi[k], w1, w1sh, q);
    x[k] = r != 0 ? submod(x[k], v, q) : addmod(x[k], v, q);
  }
}

// The inverse chain's last stage of a split (Split) straight to device
// memory, once both blocks have run bits 0 .. logh - 1 of each of their
// NBUF buffers a + k h (swizzled; h = 2^LOGH): block r takes the pairs i in
// [r h/2, (r + 1) h/2), element i of both halves, one word its own and one
// the peer's through distributed shared memory, and out(k, i, v) stores
// elements i ((lo + hi) fin) and h + i ((lo - hi) t fin) of buffer k
// (lanes on consecutive i), split_top_stage's inverse
// arithmetic.  Four pairs of every buffer a thread at a time keep 4 NBUF
// remote loads in flight, and each block reads h/2 words of the peer's
// half a buffer.  Cluster barriers before (the peer's chains are done) and
// after (the peer has read this block's words: a block's shared memory
// must outlive the peer's reads).
template <int LOGH, int THREADS, int NBUF, typename Out>
__device__ __forceinline__ void split_inverse_out(const uint32_t* a, int r,
                                                  uint32_t t, uint32_t tsh,
                                                  uint32_t fin,
                                                  uint32_t fin_sh, uint32_t q,
                                                  Out out) {
  constexpr int kIn = 4;
  constexpr int h = 1 << LOGH;
  static_assert(h / 2 % (kIn * THREADS) == 0, "whole rounds of pairs");
  cluster_sync();
  const uint32_t peer = cluster_addr(a, r ^ 1);
  const int from = r * (h / 2);
#pragma unroll 1
  for (int i0 = from + threadIdx.x; i0 < from + h / 2; i0 += kIn * THREADS) {
    uint32_t mine[NBUF][kIn], other[NBUF][kIn];
#pragma unroll
    for (int u = 0; u < kIn; ++u) {
      const int sw = radix_swizzle(i0 + u * THREADS);
#pragma unroll
      for (int k = 0; k < NBUF; ++k) {
        other[k][u] = cluster_load(peer + 4u * (k * h + sw));
        mine[k][u] = a[k * h + sw];
      }
    }
#pragma unroll
    for (int k = 0; k < NBUF; ++k) {
#pragma unroll
      for (int u = 0; u < kIn; ++u) {
        const uint32_t x0 = r != 0 ? other[k][u] : mine[k][u];
        const uint32_t x1 = r != 0 ? mine[k][u] : other[k][u];
        const int i = i0 + u * THREADS;
        out(k, i, shoup_mul(addmod(x0, x1, q), fin, fin_sh, q));
        out(k, h + i, shoup_mul(shoup_mul(submod(x0, x1, q), t, tsh, q), fin,
                                fin_sh, q));
      }
    }
  }
  cluster_sync();
}

// The top stage (bit log n - 1) of a polynomial of n = 2h words whose
// halves stay in the shared memory (swizzled) of two blocks of a cluster,
// in place, for a polynomial that outlives the stage on the chip (K10's
// and K12's split at n = 2^16, csrc/blind_rotate_split_cuda.cu and
// csrc/bench_cuda.cu, and K6's forward stage from a source basis at
// n = 2^15, csrc/tensor_mul4.cuh): pair i (element i of half 0 with
// element i of half 1) is one butterfly, forward x0 + t x1, x0 - t x1 or
// inverse
// (x0 + x1) fin, (x0 - x1) t fin, and the block of half `half` takes the
// pairs i in [half h/2, (half + 1) h/2), reading and writing the word of
// its own half in its shared memory and the peer's through distributed
// shared memory (peer: the peer's shared::cluster address of a; h = 2^LOGH,
// h / 2 a multiple of four times THREADS).  No
// word is touched by both blocks, so one stage needs no exchange buffer;
// the caller brackets it with cluster barriers (the peer's words are
// final before, and the stage's writes visible to both after).  Four
// pairs a thread at a time keep four remote loads in flight.
template <int LOGH, int THREADS, bool INV>
__device__ __forceinline__ void split_top_stage(uint32_t* a, int half,
                                                uint32_t peer, uint32_t t,
                                                uint32_t tsh, uint32_t fin,
                                                uint32_t fin_sh, uint32_t q) {
  constexpr int kIn = 4;
  constexpr int h = 1 << LOGH;
  static_assert(h / 2 % (kIn * THREADS) == 0, "whole rounds of pairs");
  const int from = half * (h / 2);
#pragma unroll 1
  for (int i0 = from + threadIdx.x; i0 < from + h / 2; i0 += kIn * THREADS) {
    int sw[kIn];
    uint32_t mine[kIn], other[kIn];
#pragma unroll
    for (int u = 0; u < kIn; ++u) {
      sw[u] = radix_swizzle(i0 + u * THREADS);
      other[u] = cluster_load(peer + 4u * sw[u]);
      mine[u] = a[sw[u]];
    }
#pragma unroll
    for (int u = 0; u < kIn; ++u) {
      const uint32_t x0 = half ? other[u] : mine[u];
      const uint32_t x1 = half ? mine[u] : other[u];
      uint32_t y0, y1;
      if constexpr (INV) {
        y0 = shoup_mul(addmod(x0, x1, q), fin, fin_sh, q);
        y1 = shoup_mul(shoup_mul(submod(x0, x1, q), t, tsh, q), fin, fin_sh,
                       q);
      } else {
        const uint32_t v = shoup_mul(x1, t, tsh, q);
        y0 = addmod(x0, v, q);
        y1 = submod(x0, v, q);
      }
      a[sw[u]] = half ? y1 : y0;
      cluster_store(peer + 4u * sw[u], half ? y0 : y1);
    }
  }
}

// The launch configuration of `blocks` blocks (a multiple of `cluster`) in
// clusters of `cluster` blocks along x, on `stream`; attr holds its one
// attribute.
inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute (&attr)[1],
                                         long long blocks, int cluster,
                                         int threads, int smem,
                                         cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// kernel over `blocks` blocks in clusters of `cluster` (cluster_config).
template <typename Kernel, typename... Args>
cudaError_t cluster_launch(Kernel kernel, long long blocks, int cluster,
                           int threads, int smem, cudaStream_t stream,
                           Args... args) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(attr, blocks, cluster, threads, smem, stream);
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The clusters of `cluster` blocks of kernel (its dynamic shared memory
// allowed first) that the card in use runs at once: on GPCs of 16 or 18
// SMs a cluster of 4 one-block-an-SM blocks leaves SMs idle.
template <typename Kernel>
int cluster_occupancy(Kernel kernel, int cluster, int threads, int smem,
                      int* clusters) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(attr, cluster, cluster, threads, smem, nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, reinterpret_cast<const void*>(kernel), &cfg));
}

// radix_launch of a three-buffer kernel at n = 2^LOGN: below kWideLogN as
// it is; at kWideLogN a cluster of kSplitBlocks blocks for each of the
// `blocks` (prime, polynomial) pairs, each block on the chain of one half
// (Split), the plan's threads and bytes those of the half and SIDE words
// more.
template <int LOGN, int THREADS, int NBUF, int SIDE = 0, typename Kernel,
          typename... Args>
int split_launch(Kernel kernel, int threads, int smem, int blocks,
                 cudaStream_t stream, Args... args) {
  if constexpr (!Split<LOGN>::on) {
    return radix_launch<LOGN, THREADS, NBUF>(kernel, threads, smem, blocks,
                                             stream, args...);
  } else {
    using S = RadixShape<Split<LOGN>::logh, THREADS>;
    if (threads != S::threads ||
        smem != (NBUF * S::n + SIDE) * static_cast<int>(sizeof(uint32_t))) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    if (blocks > 0x7fffffff / kSplitBlocks) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = allow_smem(kernel, smem);
    if (err == cudaSuccess && blocks > 0) {
      err = cluster_launch(kernel, static_cast<long long>(blocks) *
                                       kSplitBlocks,
                           kSplitBlocks, threads, smem, stream, args...);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
}

// radix_launch of a one-buffer kernel at its block shape (OneBuffer).
template <int LOGN, typename Kernel, typename... Args>
int one_buffer_launch(Kernel kernel, int threads, int smem, int blocks,
                      cudaStream_t stream, Args... args) {
  return radix_launch<LOGN, OneBuffer<LOGN>::threads>(kernel, threads, smem,
                                                      blocks, stream, args...);
}

// F::run<logn>(args...) for the ring degrees that every radix-chain kernel
// takes, 2^7 .. 2^14 (K10's cluster layout).  At 2^7, the least degree of
// the reference's Pallas kernels, a polynomial is 8 virtual threads: a
// block of 8 threads (a quarter of a warp), one group, two passes of 4 and
// 3 stages, and no split (Split<7>::on is false).
template <typename F, typename... Args>
int by_logn(int logn, Args... args) {
  switch (logn) {
    case 7: return F::template run<7>(args...);
    case 8: return F::template run<8>(args...);
    case 9: return F::template run<9>(args...);
    case 10: return F::template run<10>(args...);
    case 11: return F::template run<11>(args...);
    case 12: return F::template run<12>(args...);
    case 13: return F::template run<13>(args...);
    case 14: return F::template run<14>(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// F::run<logn>(args...) for the ring degrees of the one-buffer kernels and
// of the three-buffer ones (split at kWideLogN): by_logn's and 2^kWideLogN.
template <typename F, typename... Args>
int by_logn_wide(int logn, Args... args) {
  if (logn == kWideLogN) return F::template run<kWideLogN>(args...);
  return by_logn<F>(logn, args...);
}

}  // namespace fhe
