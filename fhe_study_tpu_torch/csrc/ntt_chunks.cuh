// The negacyclic transform of one polynomial across blocks: n = 2^logn
// words, more than the c = 2^kChunkLogN that one block's chain holds (K1
// and K9 at n = 2^16 .. 2^26, csrc/ntt_multi_cuda.cu; K2, K3, K5 and K12
// there too, their own step folded into the first pass,
// csrc/tensor_eval4_chunks_cuda.cu, ks_contract_chunks_cuda.cu and
// forward_chunks_cuda.cu; K6-K8, csrc/tensor_mul4_chunks_cuda.cu and
// ks_fused_chunks_cuda.cu, with first_top.cuh's first top pass; K10's
// grid layout at 2^16 .. 2^22, csrc/blind_rotate_grid_cuda.cu), in the
// reference's order
// (Cooley-Tukey forward, natural in, bit-reversed out; ops/ntt.py::
// _stage_loop) and butterfly for butterfly its arithmetic, so the output is
// the plain version's bit for bit, in the same order.
//
// The forward chain's first s = logn - kChunkLogN stages (bits logn - 1 ..
// kChunkLogN) pair words further apart than a chunk.  They run in top
// passes through device memory, each of up to kTopBits stages on 2^K words
// a thread held in registers (top_stages), lanes on consecutive words; a
// stage at bit j takes the roots of indices below 2^s.  After them chunk r
// (words r c .. r c + c - 1) holds every pair of the stages left, and one
// block runs radix_chain.cuh's one-buffer chain of c words on it
// (ntt_rows at kChunkLogN, OneBuffer's shape: 512 threads, 128 KB) under row
// r of the chunk table: the global stage of 2^s m' groups takes root
// (2^s + r) m' + i' for chunk r's group i', which the row holds at word
// m' + i', where the chain of c words reads it (ops/ntt_cuda.py::
// _chunk_index); word 0 of row r >= 1 holds root r, where the top passes
// read the roots below 2^s, so one table of n words a prime serves both.
// The inverse runs the other way: the chunk chains first, then the top
// passes from bit kChunkLogN up, the last with the final multiplier.
//
// What bounds it: a top pass reads and writes the polynomial once more
// (8 bytes a word, against K1's 8 for the whole block-resident transform),
// so past 2^15 device memory: one pass at n <= 2^19, two to 2^23, three to
// 2^26.  A cluster of blocks sharing the top stages through distributed
// shared memory would save those passes (ROADMAP).
#pragma once

#include <climits>
#include <cstdint>

#include "modarith.cuh"
#include "radix_chain.cuh"

namespace fhe {
// Internal to each unit that includes it, as the kernels of every unit.
namespace {

constexpr int kChunkLogN = kWideLogN;   // a chunk: one block's chain
constexpr int kMaxLogN = 26;            // K1's and K9's top degree
constexpr int kTopBits = 4;             // stages a top pass runs at most
constexpr int kTopThreads = 256;

// Top passes of a transform of 2^logn words: forward pass t holds the stage
// bits top_lo .. top_hi (from logn - 1 down to kChunkLogN, kTopBits at a
// time); the inverse runs the same passes in the other order (mirrored by
// ops/ntt_cuda.py::_chunk_plan).
__host__ __device__ constexpr int top_passes(int logn) {
  return (logn - kChunkLogN + kTopBits - 1) / kTopBits;
}
__host__ __device__ constexpr int top_hi(int logn, int t) {
  return logn - 1 - kTopBits * t;
}
__host__ __device__ constexpr int top_lo(int logn, int t) {
  return radix_max(top_hi(logn, t) - kTopBits + 1, kChunkLogN);
}
__host__ __device__ constexpr int top_bits(int logn, int t) {
  return top_hi(logn, t) - top_lo(logn, t) + 1;
}

// First element of virtual thread v of a top pass over bits [lo, lo + K):
// v's bits below lo, then its others above lo + K (lanes on consecutive
// words, lo >= kChunkLogN).
__device__ __forceinline__ int top_base(int v, int lo, int K) {
  return (v & ((1 << lo) - 1)) | ((v >> lo) << (lo + K));
}

// The stages of a top pass on x[k] = element base + (k << lo), k < 2^K:
// stage bit j = lo + u pairs (k, k | 2^u) under root (n >> (j + 1)) +
// ((base + (k << lo)) >> (j + 1)) = (n >> (j + 1)) + (base >> (j + 1)) +
// (k >> (u + 1)) (base has no bit in [lo, lo + K)), which the chunk table w
// (wsh: the Shoup companions) holds at word root << kChunkLogN.  Forward:
// bits from the top down (Cooley-Tukey), inverse from the bottom up
// (Gentleman-Sande, without n^-1).
template <int K, bool INV>
__device__ __forceinline__ void top_stages(uint32_t (&x)[1 << K], int base,
                                           int lo, int logn,
                                           const uint32_t* w,
                                           const uint32_t* wsh, uint32_t q) {
#pragma unroll
  for (int st = 0; st < K; ++st) {
    const int u = INV ? st : K - 1 - st;
    const int j = lo + u;
    const int r0 = (1 << (logn - j - 1)) + (base >> (j + 1));
#pragma unroll
    for (int k = 0; k < (1 << K); ++k) {
      if (k & (1 << u)) continue;
      const int k2 = k | (1 << u);
      const size_t at = static_cast<size_t>(r0 + (k >> (u + 1)))
                        << kChunkLogN;
      const uint32_t t = __ldg(w + at), ts = __ldg(wsh + at);
      const uint32_t a = x[k];
      if constexpr (INV) {
        const uint32_t b = x[k2];
        x[k] = addmod(a, b, q);
        x[k2] = shoup_mul(submod(a, b, q), t, ts, q);
      } else {
        const uint32_t b = shoup_mul(x[k2], t, ts, q);
        x[k] = addmod(a, b, q);
        x[k2] = submod(a, b, q);
      }
    }
  }
}

// Word i of a row as a residue: an int64 word holds it in its low half,
// which is loaded alone (the card is little-endian).  Callers pass the
// thread's base into the pointer and a constant i, so the 16 loads of a
// pass take immediate offsets from one address.
template <typename Word>
__device__ __forceinline__ uint32_t row_word(const Word* row, int i) {
  if constexpr (sizeof(Word) == 8) {
    return __ldg(reinterpret_cast<const uint32_t*>(row) + 2 * i);
  } else {
    return __ldg(row + i);
  }
}

// Four consecutive words at p as residues: 16-byte loads when p is 16-byte
// aligned (vec), word loads otherwise.
template <typename Word>
__device__ __forceinline__ void row_words(uint32_t (&d)[4], const Word* p,
                                          bool vec) {
  if constexpr (sizeof(Word) == 8) {
    if (vec) {
      const uint4* v = reinterpret_cast<const uint4*>(p);
      const uint4 lo = __ldg(v);
      const uint4 hi = __ldg(v + 1);
      d[0] = lo.x; d[1] = lo.z; d[2] = hi.x; d[3] = hi.z;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) d[j] = row_word(p, j);
    }
  } else {
    operand_words(d, p, vec);
  }
}

// The forward chain of the 2^LOGN words of row, under the tables w / wsh
// (their row of the chunk or polynomial), by the block at OneBuffer<LOGN>'s
// shape: the first pass reads its 16 words straight from device memory,
// lanes on consecutive words; the result is left in shared memory a
// (swizzled), past the last pass's barrier.
template <int LOGN, typename In>
__device__ __forceinline__ void forward_to_smem(uint32_t* a, const In* row,
                                                const uint32_t* w,
                                                const uint32_t* wsh,
                                                uint32_t q) {
  using S = typename OneBuffer<LOGN>::Shape;
  constexpr int c0 = S::fwd_c(0);
#pragma unroll 1
  for (int g = 0; g < S::groups; ++g) {
    const int base = threadIdx.x + g * S::threads;  // radix_base(v, c0)
    uint32_t r[kRadix];
#pragma unroll
    for (int j = 0; j < kRadix; ++j) r[j] = row_word(row + base, j << c0);
    radix_pass<LOGN, 0, false>(r, base, w, wsh, q);
    radix_store<c0>(a, r, base);
  }
  __syncthreads();
  RadixPasses<LOGN, 1, S::passes, false, S::threads>::run(a, w, wsh, q);
}

// The transform of one row of 2^LOGN words by block blockIdx.x, on the
// register-resident chain.  Rows lie one after another in x and out; row i
// is chunk r = i mod 2^s of polynomial i >> s, whose prime is
// ((i >> s) / inner) mod L, and takes row (prime, r) of the tables (s = 0:
// a whole polynomial a block and the plain [L, n] tables).  The forward's
// first pass reads its 16 words straight from device memory, lanes on
// consecutive words; the result leaves shared memory in coalesced 16-byte
// stores with fin applied (use_fin).  The inverse's first pass reads 16
// contiguous words, in 16-byte vectors when the rows are 16-byte aligned
// (vec); its last pass stores lanes on consecutive words, fin folded in.
// In and Out are uint32_t or long long (residues in the low half).
template <int LOGN, int INV, typename In, typename Out>
__device__ __forceinline__ void ntt_rows(const In* __restrict__ x,
                                         Out* __restrict__ out,
                                         const uint32_t* __restrict__ tw,
                                         const uint32_t* __restrict__ tw_sh,
                                         const uint32_t* __restrict__ cons,
                                         int inner, int L, int s,
                                         int use_fin, int vec) {
  using S = typename OneBuffer<LOGN>::Shape;
  constexpr int n = S::n;
  extern __shared__ uint32_t a[];
  const int poly = blockIdx.x >> s;
  const int p = (poly / inner) % L;
  const PrimeRow c = prime_row(cons, p);
  const size_t trow = (static_cast<size_t>(p) << s) +
                      (blockIdx.x & ((1 << s) - 1));
  const uint32_t* w = tw + trow * n;
  const uint32_t* wsh = tw_sh + trow * n;
  const In* row = x + static_cast<size_t>(blockIdx.x) * n;
  Out* o = out + static_cast<size_t>(blockIdx.x) * n;
  if constexpr (INV != 0) {
    constexpr int last = S::passes - 1;
    constexpr int cl = S::inv_c(last);
#pragma unroll 1
    for (int g = 0; g < S::groups; ++g) {
      const int base = (threadIdx.x + g * S::threads) << kRadixBits;
      uint32_t r[kRadix];
#pragma unroll
      for (int j = 0; j < kRadix; j += 4) {
        uint32_t d[4];
        row_words(d, row + base + j, vec != 0);
#pragma unroll
        for (int i = 0; i < 4; ++i) r[j + i] = d[i];
      }
      radix_pass<LOGN, 0, true>(r, base, w, wsh, c.q);
      radix_store<0>(a, r, base);
    }
    __syncthreads();
    RadixPasses<LOGN, 1, last, true, S::threads>::run(a, w, wsh, c.q);
#pragma unroll 1
    for (int g = 0; g < S::groups; ++g) {
      const int base = radix_base(threadIdx.x + g * S::threads, cl);
      uint32_t r[kRadix];
      radix_load<cl>(r, a, base);
      radix_pass<LOGN, last, true>(r, base, w, wsh, c.q);
#pragma unroll
      for (int j = 0; j < kRadix; ++j) {
        o[base + (j << cl)] =
            use_fin ? shoup_mul(r[j], c.fin, c.fin_sh, c.q) : r[j];
      }
    }
  } else {
    forward_to_smem<LOGN>(a, row, w, wsh, c.q);
    // lane i stores the kv words from kv * i: 16 bytes
    constexpr int kv = 16 / static_cast<int>(sizeof(Out));
    for (int i = threadIdx.x; i < n / kv; i += S::threads) {
      const int sw = radix_swizzle(kv * i);
      uint32_t v[kv];
#pragma unroll
      for (int t = 0; t < kv; ++t) v[t] = a[sw ^ t];
      if (use_fin) {
#pragma unroll
        for (int t = 0; t < kv; ++t) {
          v[t] = shoup_mul(v[t], c.fin, c.fin_sh, c.q);
        }
      }
      if constexpr (kv == 4) {
        reinterpret_cast<uint4*>(o)[i] = make_uint4(v[0], v[1], v[2], v[3]);
      } else {
        reinterpret_cast<longlong2*>(o)[i] = make_longlong2(v[0], v[1]);
      }
    }
  }
}

// The chain of one chunk of a transform past a block (s > 0), or of a
// whole polynomial (s = 0), at OneBuffer<kChunkLogN>'s shape.
template <int INV, typename In, typename Out>
__global__ void __launch_bounds__(OneBuffer<kChunkLogN>::threads,
                                  OneBuffer<kChunkLogN>::blocks)
ntt_chunk_kernel(const In* __restrict__ x, Out* __restrict__ out,
                 const uint32_t* __restrict__ tw,
                 const uint32_t* __restrict__ tw_sh,
                 const uint32_t* __restrict__ cons, int inner, int L, int s,
                 int use_fin, int vec) {
  ntt_rows<kChunkLogN, INV>(x, out, tw, tw_sh, cons, inner, L, s, use_fin,
                            vec);
}

// Residue i of a row (the low half of an int64 word) and its store (an
// int64 word's high half zero).  Plain accesses: a top pass may read and
// write the same words, each thread its own.
template <typename Word>
__device__ __forceinline__ uint32_t top_load(const Word* p, size_t i) {
  if constexpr (sizeof(Word) == 8) {
    return reinterpret_cast<const uint32_t*>(p)[2 * i];
  } else {
    return p[i];
  }
}

template <typename Word>
__device__ __forceinline__ void top_store(Word* p, size_t i, uint32_t v) {
  p[i] = static_cast<Word>(v);
}

// One top pass over bits [lo, lo + K) of polynomials of 2^logn words
// (polynomial i under prime (i / inner) mod L, as ntt_rows counts them),
// from x into out (the same words, or another buffer): (1 << (logn - K)) /
// kTopThreads blocks a polynomial, virtual thread v of one holding the 2^K
// words top_base(v) + (k << lo); with use_fin the final multiplier of the
// polynomial's prime after the stages.
template <int K, bool INV, typename In, typename Out>
__global__ void __launch_bounds__(kTopThreads)
ntt_top_kernel(const In* x, Out* out, const uint32_t* __restrict__ tw,
               const uint32_t* __restrict__ tw_sh,
               const uint32_t* __restrict__ cons, int inner, int L,
               int logn, int lo, int use_fin) {
  const int per = (1 << (logn - K)) / kTopThreads;
  const int poly = blockIdx.x / per;
  const int v = (blockIdx.x - poly * per) * kTopThreads + threadIdx.x;
  const int p = (poly / inner) % L;
  const PrimeRow c = prime_row(cons, p);
  const size_t n = static_cast<size_t>(1) << logn;
  const int base = top_base(v, lo, K);
  const In* row = x + poly * n + base;
  Out* o = out + poly * n + base;
  uint32_t r[1 << K];
#pragma unroll
  for (int k = 0; k < (1 << K); ++k) {
    r[k] = top_load(row, static_cast<size_t>(k) << lo);
  }
  top_stages<K, INV>(r, base, lo, logn, tw + p * n, tw_sh + p * n, c.q);
#pragma unroll
  for (int k = 0; k < (1 << K); ++k) {
    top_store(o, static_cast<size_t>(k) << lo,
              use_fin ? shoup_mul(r[k], c.fin, c.fin_sh, c.q) : r[k]);
  }
}

// Blocks of a top pass of K stages over `polys` polynomials of 2^logn
// words (kTopThreads virtual threads a block).
inline long long top_blocks(long long polys, int logn, int K) {
  return (polys << (logn - K)) / kTopThreads;
}

// F::kernel<K>() over `blocks` blocks of kTopThreads on `stream`, for a
// run-time stage count K = 1 .. kTopBits; refuses a grid past its reach.
template <typename F, typename... Args>
int top_pass_launch(int K, long long blocks, cudaStream_t stream,
                    Args... args) {
  if (blocks < 1 || blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (K) {
#define FHE_TOP(KK)                                                         \
  case KK: {                                                                \
    auto kernel = F::template kernel<KK>();                                 \
    kernel<<<grid, kTopThreads, 0, stream>>>(args...);                      \
    break;                                                                  \
  }
    FHE_TOP(1) FHE_TOP(2) FHE_TOP(3) FHE_TOP(4)
#undef FHE_TOP
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool INV, typename In, typename Out>
struct NttTop {
  template <int K>
  static auto kernel() { return &ntt_top_kernel<K, INV, In, Out>; }
};

template <bool INV, typename In, typename Out>
int top_launch(int K, const In* x, Out* out, const uint32_t* tw,
               const uint32_t* tw_sh, const uint32_t* cons, long long polys,
               int inner, int L, int logn, int lo, int use_fin,
               cudaStream_t stream) {
  return top_pass_launch<NttTop<INV, In, Out>>(
      K, top_blocks(polys, logn, K), stream, x, out, tw, tw_sh, cons, inner,
      L, logn, lo, use_fin);
}

// The chunk chains of L * B polynomials of 2^logn words (x's rows), one
// block a chunk.
template <int INV, typename In, typename Out>
int chunk_launch(const In* x, Out* out, const uint32_t* tw,
                 const uint32_t* tw_sh, const uint32_t* cons, long long polys,
                 int inner, int L, int s, int use_fin, int vec, int threads,
                 int smem, cudaStream_t stream) {
  const long long blocks = polys << s;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = &ntt_chunk_kernel<INV, In, Out>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      x, out, tw, tw_sh, cons, inner, L, s, use_fin, vec);
  return static_cast<int>(cudaGetLastError());
}

// The forward transform past a block of rows [L, B, 2^logn] (row p B + b
// under prime p), queued on `stream`: the top passes from x into tmp
// (32-bit words, as many as x has), then the chunk chains from tmp into
// out, fin applied (use_fin); x may be out.  On a shape ntt_chunked (or
// its caller) has checked.
template <typename Word>
int chunked_forward(const Word* x, Word* out, uint32_t* tmp,
                    const uint32_t* tw, const uint32_t* tw_sh,
                    const uint32_t* cons, int L, int B, int logn, int use_fin,
                    int threads, int smem, cudaStream_t stream) {
  const long long polys = static_cast<long long>(L) * B;
  int err = 0;
  for (int t = 0; t < top_passes(logn) && err == 0; ++t) {
    const int K = top_bits(logn, t), lo = top_lo(logn, t);
    err = t == 0 ? top_launch<false>(K, x, tmp, tw, tw_sh, cons, polys, B,
                                     L, logn, lo, 0, stream)
                 : top_launch<false>(K, tmp, tmp, tw, tw_sh, cons, polys, B,
                                     L, logn, lo, 0, stream);
  }
  if (err == 0) {
    err = chunk_launch<0>(static_cast<const uint32_t*>(tmp), out, tw, tw_sh,
                          cons, polys, B, L, logn - kChunkLogN, use_fin, 1,
                          threads, smem, stream);
  }
  return err;
}

// A schedule past a block's shape: 2^kChunkLogN < 2^logn <= 2^kMaxLogN,
// and threads and smem the chunk's one-buffer shape (the host's plan).
inline int chunked_shape(int logn, int threads, int smem) {
  using S = typename OneBuffer<kChunkLogN>::Shape;
  if (logn <= kChunkLogN || logn > kMaxLogN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (threads != S::threads ||
      smem != S::n * static_cast<int>(sizeof(uint32_t))) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  return 0;
}

// The whole transform past a block of rows [L, B, 2^logn] (row p B + b
// under prime p), 2^kChunkLogN < 2^logn <= 2^kMaxLogN, queued on `stream`:
// the forward as chunked_forward; the inverse's chunk chains from x into
// tmp, then the top passes, the last from tmp into out with fin.  tw /
// tw_sh: the chunk tables [L, 2^s, c] (ops/ntt_cuda.py::_chunk_twiddles);
// threads and smem: the chunk's one-buffer shape (the host's plan),
// refused otherwise.
template <typename Word>
int ntt_chunked(const Word* x, Word* out, uint32_t* tmp, const uint32_t* tw,
                const uint32_t* tw_sh, const uint32_t* cons, int L, int B,
                int logn, int inverse, int use_fin, int vec, int threads,
                int smem, cudaStream_t stream) {
  if (tmp == nullptr || misaligned(tmp)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = chunked_shape(logn, threads, smem);
  if (err != 0) return err;
  if (!inverse) {
    return chunked_forward(x, out, tmp, tw, tw_sh, cons, L, B, logn, use_fin,
                           threads, smem, stream);
  }
  const long long polys = static_cast<long long>(L) * B;
  const int passes = top_passes(logn);
  err = chunk_launch<1>(x, tmp, tw, tw_sh, cons, polys, B, L,
                        logn - kChunkLogN, 0, vec, threads, smem, stream);
  for (int t = passes - 1; t >= 0 && err == 0; --t) {
    const int K = top_bits(logn, t), lo = top_lo(logn, t);
    err = t == 0 ? top_launch<true>(K, tmp, out, tw, tw_sh, cons, polys, B,
                                    L, logn, lo, use_fin, stream)
                 : top_launch<true>(K, tmp, tmp, tw, tw_sh, cons, polys, B,
                                    L, logn, lo, 0, stream);
  }
  return err;
}

}  // namespace
}  // namespace fhe
