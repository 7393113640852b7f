// Hopper kernels of the two measuring loops — replace
// fhe_study_tpu/ops/vpu_bench.py::ntt_vmem_ceiling (_ntt_repeat_kernel) and
// ::alu_rate (_alu_kernel).  Neither is on an FHE path: they measure what the
// card gives the instruction sequences that the other kernels issue.
//
//   fhe_ntt_smem_ceiling (K12): `reps` forward transforms of a polynomial
//     that stays in shared memory: one load, one store, device memory out of
//     the way.  Each transform is the forward chain of radix_chain.cuh
//     (RadixPasses over the swizzled buffer, the passes that K1-K8 run), at
//     K1's block shape (radix_chain.cuh's OneBuffer: kRadixThreads threads
//     and kRadixBlocks blocks an SM, 512 threads and one block at 2^15),
//     so its rate is the ceiling of the chain those kernels run: integer
//     issue, each pass's shared-memory words and twiddle loads, and its
//     ceil(log n / 4) barriers.  The loop over reps holds one copy of the
//     chain's code (unrolled, chains ran slower and built for minutes); its
//     body keeps every twiddle load of a transform (the SASS shows them
//     there: ptxas hoists none out of the loop), as the kernels load them.
//     Past n = 2^15 no block holds the polynomial: the entry queues `reps`
//     transforms on the chunked schedule (csrc/forward_chunks_cuda.cu), so
//     the rate there is the ceiling of that schedule; at n = 2^16 it also
//     runs split, the polynomial resident on a cluster of two blocks and
//     the top stage through distributed shared memory, the ceiling of a
//     2^16 transform on this card (K10's split layout runs its chains).
//   fhe_alu_rate (K13): each thread keeps kAluPer independent words in
//     registers and applies one operation `iters * kAluUnroll` times, each
//     round feeding the next, then stores once.  What bounds it is the issue
//     rate of the operation's instructions, which is what it measures.  An
//     empty asm statement after each round keeps the compiler from folding
//     rounds together; utils/sass_counts.py reads the loop's instructions
//     back from the built library.

#include <climits>

#include "modarith.cuh"
#include "radix_chain.cuh"

namespace fhe {
namespace {

template <int LOGN>
__global__ void __launch_bounds__(OneBuffer<LOGN>::threads,
                                  OneBuffer<LOGN>::blocks)
ntt_smem_ceiling_kernel(const uint32_t* __restrict__ x,
                        uint32_t* __restrict__ out,
                        const uint32_t* __restrict__ tw,
                        const uint32_t* __restrict__ tw_sh, uint32_t q,
                        int reps) {
  using S = typename OneBuffer<LOGN>::Shape;
  constexpr int n = S::n;
  extern __shared__ uint32_t a[];
  const uint32_t* row = x + static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += S::threads) {
    a[radix_swizzle(i)] = __ldg(row + i);
  }
  __syncthreads();
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    RadixPasses<LOGN, 0, S::passes, false, S::threads>::run(a, tw, tw_sh, q);
  }
  uint4* o4 =
      reinterpret_cast<uint4*>(out + static_cast<size_t>(blockIdx.x) * n);
  for (int i = threadIdx.x; i < n / 4; i += S::threads) {
    const int sw = radix_swizzle(4 * i);
    o4[i] = make_uint4(a[sw], a[sw ^ 1], a[sw ^ 2], a[sw ^ 3]);
  }
}

// K12 at n = 2^16 on clusters of two blocks: block r of cluster i holds half
// r of polynomial i (radix_chain.cuh's Split on one buffer) for all `reps`
// transforms.  A transform is the top stage (bit 15) between the halves
// through distributed shared memory (split_top_stage), then each half's
// chain of 2^15 words under row r of the chunk tables at 2^16, which are
// the split's (the top stage's root at word 0); a cluster barrier before
// the first stage (the peer's half is loaded), after each stage (its words
// are visible) and after each chain (the peer is through the words the
// next stage reads).
__global__ void __launch_bounds__(OneBuffer<kWideLogN>::threads,
                                  OneBuffer<kWideLogN>::blocks)
ntt_smem_ceiling_split_kernel(const uint32_t* __restrict__ x,
                              uint32_t* __restrict__ out,
                              const uint32_t* __restrict__ tw,
                              const uint32_t* __restrict__ tw_sh, uint32_t q,
                              int reps) {
  using S = typename OneBuffer<kWideLogN>::Shape;
  constexpr int h = S::n;
  extern __shared__ uint32_t a[];
  const int r = blockIdx.x & 1;
  // half r of polynomial blockIdx.x / 2: words (2i + r) h = i n + r h
  const size_t at = static_cast<size_t>(blockIdx.x) * h;
  for (int i = threadIdx.x; i < h; i += S::threads) {
    a[radix_swizzle(i)] = __ldg(x + at + i);
  }
  const uint32_t* w = tw + static_cast<size_t>(r) * h;
  const uint32_t* wsh = tw_sh + static_cast<size_t>(r) * h;
  const uint32_t t = __ldg(w), tsh = __ldg(wsh);
  const uint32_t peer = cluster_addr(a, r ^ 1);
  cluster_sync();
#pragma unroll 1
  for (int rep = 0; rep < reps; ++rep) {
    split_top_stage<kWideLogN, S::threads, false>(a, r, peer, t, tsh, 0, 0,
                                                  q);
    cluster_sync();
    RadixPasses<kWideLogN, 0, S::passes, false, S::threads>::run(a, w, wsh,
                                                                 q);
    cluster_sync();
  }
  uint4* o4 = reinterpret_cast<uint4*>(out + at);
  for (int i = threadIdx.x; i < h / 4; i += S::threads) {
    const int sw = radix_swizzle(4 * i);
    o4[i] = make_uint4(a[sw], a[sw ^ 1], a[sw ^ 2], a[sw ^ 3]);
  }
}

constexpr int kSplitCeilingLogN = kWideLogN + 1;

// The split ceiling on B polynomials of 2^16 words: B clusters of two
// blocks at a half's one-buffer shape.
int ceiling_split_launch(const uint32_t* x, uint32_t* out,
                         const uint32_t* tw, const uint32_t* tw_sh,
                         uint32_t q, int B, int reps, int threads, int smem,
                         cudaStream_t stream) {
  using S = typename OneBuffer<kWideLogN>::Shape;
  if (threads != S::threads ||
      smem != S::n * static_cast<int>(sizeof(uint32_t))) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (B > INT_MAX / kSplitBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = &ntt_smem_ceiling_split_kernel;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) {
    err = cluster_launch(kernel, static_cast<long long>(B) * kSplitBlocks,
                         kSplitBlocks, threads, smem, stream, x, out, tw,
                         tw_sh, q, reps);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

struct CeilingLaunch {
  template <int LOGN, typename... Args>
  static int run(Args... args) {
    return one_buffer_launch<LOGN>(ntt_smem_ceiling_kernel<LOGN>, args...);
  }
};

// Blocks of the ceiling kernel an SM holds at its plan's threads and shared
// memory.
struct CeilingResident {
  template <int LOGN>
  static int run(int* per_sm) {
    using S = typename OneBuffer<LOGN>::Shape;
    const int smem = S::n * static_cast<int>(sizeof(uint32_t));
    cudaError_t err = allow_smem(ntt_smem_ceiling_kernel<LOGN>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, ntt_smem_ceiling_kernel<LOGN>, S::threads, smem));
  }
};

constexpr int kAluThreads = 256;
constexpr int kAluPer = 4;      // ALU_PER_THREAD of ops/alu_bench.py
constexpr int kAluUnroll = 16;  // ALU_UNROLL of ops/alu_bench.py

enum AluOp {
  kAdd = 0,     // x + y                      (mod 2^32)
  kMul,         // x * y                      (mod 2^32)
  kAddmod,      // x + y mod q
  kShoupLazy,   // x*y - hi(x*yp)*q           (mod 2^32), in [0, 2q)
  kShoupMul,    // shoup_mul of modarith.cuh: the lazy value corrected
  kMontMul,     // mont_mul of modarith.cuh
  kButterfly,   // one forward butterfly on the word pairs (2k, 2k+1)
  kAluOps
};

template <int OP>
__device__ __forceinline__ void alu_round(uint32_t (&x)[kAluPer],
                                          const uint32_t (&y)[kAluPer],
                                          const uint32_t (&yp)[kAluPer],
                                          uint32_t q, uint32_t nq) {
  if (OP == kButterfly) {
#pragma unroll
    for (int k = 0; k < kAluPer; k += 2) {
      const uint32_t u = x[k];
      const uint32_t v = shoup_mul(x[k + 1], y[k], yp[k], q);
      x[k] = addmod(u, v, q);
      x[k + 1] = submod(u, v, q);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kAluPer; ++k) {
    if (OP == kAdd) x[k] = x[k] + y[k];
    if (OP == kMul) x[k] = x[k] * y[k];
    if (OP == kAddmod) x[k] = addmod(x[k], y[k], q);
    if (OP == kShoupLazy) x[k] = x[k] * y[k] - __umulhi(x[k], yp[k]) * q;
    if (OP == kShoupMul) x[k] = shoup_mul(x[k], y[k], yp[k], q);
    if (OP == kMontMul) x[k] = mont_mul(x[k], y[k], q, nq);
  }
}

// Word k of thread t lies at k * threads + t: neighbouring threads read
// neighbouring words.
template <int OP>
__global__ void __launch_bounds__(kAluThreads)
    alu_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
               const uint32_t* __restrict__ yp, uint32_t* __restrict__ out,
               long long threads, int iters, uint32_t q, uint32_t nq) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint32_t xs[kAluPer], ys[kAluPer], yps[kAluPer];
#pragma unroll
  for (int k = 0; k < kAluPer; ++k) {
    xs[k] = x[k * threads + t];
    ys[k] = y[k * threads + t];
    yps[k] = yp[k * threads + t];
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kAluUnroll; ++u) {
      alu_round<OP>(xs, ys, yps, q, nq);
#pragma unroll
      for (int k = 0; k < kAluPer; ++k) asm volatile("" : "+r"(xs[k]));
    }
  }
#pragma unroll
  for (int k = 0; k < kAluPer; ++k) out[k * threads + t] = xs[k];
}

using AluKernel = void (*)(const uint32_t*, const uint32_t*, const uint32_t*,
                           uint32_t*, long long, int, uint32_t, uint32_t);

AluKernel alu_entry(int op) {
  switch (op) {
    case kAdd: return alu_kernel<kAdd>;
    case kMul: return alu_kernel<kMul>;
    case kAddmod: return alu_kernel<kAddmod>;
    case kShoupLazy: return alu_kernel<kShoupLazy>;
    case kShoupMul: return alu_kernel<kShoupMul>;
    case kMontMul: return alu_kernel<kMontMul>;
    case kButterfly: return alu_kernel<kButterfly>;
    default: return nullptr;
  }
}

}  // namespace

// K12 past one block and its chunk chain's occupancy
// (csrc/forward_chunks_cuda.cu).
int ntt_smem_ceiling_chunked(const uint32_t* x, uint32_t* out, uint32_t* tmp,
                             const uint32_t* tw, const uint32_t* tw_sh,
                             const uint32_t* cons, int B, int logn, int reps,
                             int threads, int smem, cudaStream_t stream);
int ntt_chunk_resident(int* per_sm);

}  // namespace fhe

using namespace fhe;

// threads and smem: the plan of ops/ntt_cuda.py::_radix_plan; out 16-byte
// aligned (the read-out's uint4 stores).  Past n = 2^15 tw / tw_sh are the
// chunk tables, threads and smem a chunk's, cons the prime's row and tmp a
// scratch of B n words (16-byte aligned); below it neither is read.  split
// (n = 2^16 only): each polynomial resident on a two-block cluster for all
// reps, the chunk tables, neither cons nor tmp read.
extern "C" int fhe_ntt_smem_ceiling(const uint32_t* x, uint32_t* out,
                                    uint32_t* tmp, const uint32_t* tw,
                                    const uint32_t* tw_sh,
                                    const uint32_t* cons, unsigned q, int B,
                                    int logn, int reps, int threads, int smem,
                                    int split, cudaStream_t stream) {
  if (B < 1 || reps < 0 || misaligned(out) ||
      (split && logn != kSplitCeilingLogN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (split) {
    return ceiling_split_launch(x, out, tw, tw_sh, static_cast<uint32_t>(q),
                                B, reps, threads, smem, stream);
  }
  if (logn > kWideLogN) {
    return ntt_smem_ceiling_chunked(x, out, tmp, tw, tw_sh, cons, B, logn,
                                    reps, threads, smem, stream);
  }
  return by_logn_wide<CeilingLaunch>(logn, threads, smem, B, stream, x, out,
                                     tw, tw_sh, static_cast<uint32_t>(q),
                                     reps);
}

// The split ceiling's clusters of two that the card in use runs at once.
extern "C" int fhe_ceiling_split_clusters(int* clusters) {
  using S = typename OneBuffer<kWideLogN>::Shape;
  return cluster_occupancy(&ntt_smem_ceiling_split_kernel, kSplitBlocks,
                           S::threads,
                           S::n * static_cast<int>(sizeof(uint32_t)),
                           clusters);
}

// `threads` must be a multiple of kAluThreads; the wrapper sees to it.
extern "C" int fhe_alu_rate(const uint32_t* x, const uint32_t* y,
                            const uint32_t* yp, uint32_t* out,
                            long long threads, int iters, int op, unsigned q,
                            unsigned nq, cudaStream_t stream) {
  AluKernel kernel = alu_entry(op);
  if (kernel == nullptr || threads < kAluThreads ||
      threads % kAluThreads != 0 || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<static_cast<unsigned>(threads / kAluThreads), kAluThreads, 0,
           stream>>>(x, y, yp, out, threads, iters, q, nq);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of one measuring kernel that the card in use holds at once:
// op >= 0 names an alu_rate operation, op < 0 the ceiling loop at ring
// degree 2^logn (past 2^15 its chunk chain's blocks, one a chunk of 2^15
// words).  Writes blocks per SM and the SM count.
extern "C" int fhe_bench_resident(int op, int logn, int* per_sm, int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (op >= 0) {
    AluKernel kernel = alu_entry(op);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        kAluThreads, 0);
    return static_cast<int>(err);
  }
  if (logn > kWideLogN) return ntt_chunk_resident(per_sm);
  return by_logn_wide<CeilingResident>(logn, per_sm);
}
