// K7 ks_fused and K8 ks_fused_eval past one block's polynomial, n = 2^16
// .. 2^26 — with csrc/ks_fused_cuda.cu and csrc/ks_fused_eval_cuda.cu,
// fhe_study_tpu/ops/ntt_pallas.py::ks_fused_u32 and ks_fused_eval_u32 — on
// the chunked schedule of csrc/ntt_chunks.cuh, called by fhe_ks_fused and
// fhe_ks_fused_eval.  The one-block kernel's accumulation scheme (csrc/
// ks_fused.cuh) with the accumulators in device memory: they are the
// output's first two rows, out[0] and out[1], and each digit row's forward
// goes through a 32-bit scratch of one row, [Lp, B, n].  Queued by the one
// C call on the caller's stream, the digit rows a run-time loop:
//
//   for each digit row r = 0 .. R - 1:
//     first top     the forward's first top pass over the Lp B polynomials
//                   (p, b) of the scratch (csrc/first_top.cuh): limb r of
//                   polynomial b reduced mod p by `reps` conditional
//                   subtractions, the Lp primes' blocks side by side;
//     top passes    the forward's others, in place in the scratch;
//     chunk chains  the forward's, one block a chunk of 2^15 words, whose
//                   result is not stored: each word is multiplied by
//                   kb[r, p] and ka[r, p] (Montgomery, a factor 2^-32 each)
//                   and the products added into out[0] and out[1] at the
//                   word's own address (uint4 words), which row 0 writes
//                   instead of reading (ks_mac_chunk_kernel);
//   K8, for h = 0, 1:
//     the forward of add_h as above (its strided rows, no subtraction),
//     whose chunk chains form e_h = acc_h * 2^32 + NTT(add_h) in place in
//     out[h] (a Shoup product by 2^32 mod q);
//   the inverse: the chunk chains over the two sums (K7: in place in
//   out[0..1]; K8: from e_h in out[0..1] into out[2..3]), then the top
//   passes in place, the last times fin (K7: n^-1 * 2^32; K8: n^-1).
//
// No more than one digit row's forward is held at a time: at R = Lp = 29,
// B = 128, n = 2^16 all R rows would take 28 GiB.  What bounds it: the
// R + 2 (K8: R + 4) transforms' butterflies and the 2R Montgomery products
// a coefficient, as at 2^15, beside device memory: each transform's top
// passes (8 bytes a word each: one pass to 2^19, two to 2^23, three to
// 2^26) and the accumulators' round trip of each digit row (8 bytes a word
// of the two sums, 4 for row 0).

#include <climits>
#include <cstdint>

#include "first_top.cuh"
#include "ks_fused.cuh"
#include "modarith.cuh"
#include "ntt_chunks.cuh"
#include "radix_chain.cuh"

namespace fhe {
namespace {

// The forward chain of chunk r' of polynomial (p, b) of the scratch d
// [Lp, B, n] (block (p B + b) 2^s + r', under row (p, r') of the chunk
// tables), then for each of its words, lane i on words 4i .. 4i + 3:
//   EVAL = false  acc_h += x * key_h[r, p] (Montgomery) for h = 0, 1, the
//                 two sums out[0] and out[1] = acc [2, Lp, B, n]; r = 0
//                 writes them;
//   EVAL = true   acc_h = acc_h * 2^32 + x, acc the one row out[h]
//                 [Lp, B, n], `lift` holding 2^32 mod q as its final
//                 multiplier.
// vec: the keys are read as uint4 (kb and ka 16-byte aligned); acc is.
template <bool EVAL>
__global__ void __launch_bounds__(OneBuffer<kChunkLogN>::threads,
                                  OneBuffer<kChunkLogN>::blocks)
ks_mac_chunk_kernel(const uint32_t* __restrict__ d,
                    const uint32_t* __restrict__ kb,
                    const uint32_t* __restrict__ ka,
                    uint32_t* __restrict__ acc,
                    const uint32_t* __restrict__ tw,
                    const uint32_t* __restrict__ tw_sh,
                    const uint32_t* __restrict__ cons,
                    const uint32_t* __restrict__ lift, int r, int Lp, int B,
                    int s, int vec) {
  using S = typename OneBuffer<kChunkLogN>::Shape;
  constexpr int c = S::n;
  extern __shared__ uint32_t a[];
  const int pb = blockIdx.x >> s;            // p * B + b
  const int chunk = blockIdx.x & ((1 << s) - 1);
  const int p = pb / B;
  const PrimeRow pr = prime_row(cons, p);
  const size_t trow = (static_cast<size_t>(p) << s) + chunk;
  forward_to_smem<kChunkLogN>(a, d + static_cast<size_t>(blockIdx.x) * c,
                              tw + trow * c, tw_sh + trow * c, pr.q);
  const size_t row = static_cast<size_t>(c) << s;   // words a polynomial
  const size_t off = static_cast<size_t>(chunk) * c;
  const size_t rows = static_cast<size_t>(Lp) * B * row;   // a half's
  for (int i = threadIdx.x; i < c / 4; i += S::threads) {
    const int sw = radix_swizzle(4 * i);
    uint32_t x[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) x[t] = a[sw ^ t];
    if constexpr (EVAL) {
      const PrimeRow rl = prime_row(lift, p);
      uint4* o = reinterpret_cast<uint4*>(acc + pb * row + off) + i;
      const uint4 y = *o;
      *o = make_uint4(addmod(shoup_mul(y.x, rl.fin, rl.fin_sh, pr.q), x[0],
                             pr.q),
                      addmod(shoup_mul(y.y, rl.fin, rl.fin_sh, pr.q), x[1],
                             pr.q),
                      addmod(shoup_mul(y.z, rl.fin, rl.fin_sh, pr.q), x[2],
                             pr.q),
                      addmod(shoup_mul(y.w, rl.fin, rl.fin_sh, pr.q), x[3],
                             pr.q));
    } else {
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        const uint32_t* key = (h == 0 ? kb : ka) +
                              (static_cast<size_t>(r) * Lp + p) * row + off +
                              4 * i;
        uint32_t kw[4];
        operand_words(kw, key, vec != 0);
        uint4* o = reinterpret_cast<uint4*>(acc + h * rows + pb * row + off) +
                   i;
        uint4 y = make_uint4(0, 0, 0, 0);
        if (r > 0) y = *o;
        y.x = addmod(y.x, mont_mul(x[0], kw[0], pr.q, pr.nq), pr.q);
        y.y = addmod(y.y, mont_mul(x[1], kw[1], pr.q, pr.nq), pr.q);
        y.z = addmod(y.z, mont_mul(x[2], kw[2], pr.q, pr.nq), pr.q);
        y.w = addmod(y.w, mont_mul(x[3], kw[3], pr.q, pr.nq), pr.q);
        *o = y;
      }
    }
  }
}

template <bool EVAL>
int mac_launch(const uint32_t* d, const uint32_t* kb, const uint32_t* ka,
               uint32_t* acc, const uint32_t* tw, const uint32_t* tw_sh,
               const uint32_t* cons, const uint32_t* lift, int r, int Lp,
               int B, int s, int vec, int threads, int smem,
               cudaStream_t stream) {
  auto kernel = &ks_mac_chunk_kernel<EVAL>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (static_cast<long long>(Lp) * B) << s;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      d, kb, ka, acc, tw, tw_sh, cons, lift, r, Lp, B, s, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K7 (adds null) and K8 past one block: c the [R, B, n] limb rows (strides
// sl, sb); kb, ka [R, Lp, n]; add0, add1 K8's [Lp, B, n] rows (strides al,
// ab); out [2, Lp, B, n] (K7) or [4, Lp, B, n] (K8), 16-byte aligned; tmp
// a scratch of Lp B n words (16-byte aligned); tw / tw_sh and twinv /
// twinv_sh the forward and inverse chunk tables [Lp, 2^s, 2^15]; cons's fin
// n^-1 * 2^32 (K7) or n^-1 (K8); lift K8's rows of 2^32 mod q; threads and
// smem a chunk's one-buffer shape, refused otherwise.
int ks_fused_chunked(const uint32_t* c, long long sl, long long sb,
                     const uint32_t* kb, const uint32_t* ka,
                     const uint32_t* add0, long long al0, long long ab0,
                     const uint32_t* add1, long long al1, long long ab1,
                     uint32_t* out, uint32_t* tmp, const uint32_t* tw,
                     const uint32_t* tw_sh, const uint32_t* twinv,
                     const uint32_t* twinv_sh, const uint32_t* cons,
                     const uint32_t* lift, int R, int Lp, int B, int logn,
                     int reps, int threads, int smem, cudaStream_t stream) {
  const bool eval = add0 != nullptr;
  int err = tmp == nullptr || misaligned(tmp) || misaligned(out) ||
                    (eval && (add1 == nullptr || lift == nullptr))
                ? static_cast<int>(cudaErrorInvalidValue)
                : chunked_shape(logn, threads, smem);
  const int s = logn - kChunkLogN;
  const long long polys = static_cast<long long>(Lp) * B;
  if (err == 0 && ((2 * polys) << s) > INT_MAX) {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = ks_vec(kb, ka) ? 1 : 0;
  for (int r = 0; r < R && err == 0; ++r) {
    err = first_top_launch<kPlainSrc>(c + r * sl, 0, sb, tmp, nullptr, tw,
                                      tw_sh, cons, 0, Lp, B, logn, reps,
                                      stream);
    if (err == 0) {
      err = other_tops(tmp, tw, tw_sh, cons, polys, B, Lp, logn, stream);
    }
    if (err == 0) {
      err = mac_launch<false>(tmp, kb, ka, out, tw, tw_sh, cons, nullptr, r,
                              Lp, B, s, vec, threads, smem, stream);
    }
  }
  const size_t half = static_cast<size_t>(polys) << logn;   // a row of out
  for (int h = 0; h < 2 && eval && err == 0; ++h) {
    err = first_top_launch<kPlainSrc>(h == 0 ? add0 : add1,
                                      h == 0 ? al0 : al1, h == 0 ? ab0 : ab1,
                                      tmp, nullptr, tw, tw_sh, cons, 0, Lp, B,
                                      logn, 0, stream);
    if (err == 0) {
      err = other_tops(tmp, tw, tw_sh, cons, polys, B, Lp, logn, stream);
    }
    if (err == 0) {
      err = mac_launch<true>(tmp, nullptr, nullptr, out + h * half, tw, tw_sh,
                             cons, lift, 0, Lp, B, s, 0, threads, smem,
                             stream);
    }
  }
  // the inverse of the two rows out[0..1], into out[2..3] (K8) or in place
  uint32_t* inv = eval ? out + 2 * half : out;
  if (err == 0) {
    err = chunk_launch<1>(static_cast<const uint32_t*>(out), inv, twinv,
                          twinv_sh, cons, 2 * polys, B, Lp, s, 0, 1, threads,
                          smem, stream);
  }
  for (int t = top_passes(logn) - 1; t >= 0 && err == 0; --t) {
    err = top_launch<true>(top_bits(logn, t), inv, inv, twinv, twinv_sh,
                           cons, 2 * polys, B, Lp, logn, top_lo(logn, t),
                           t == 0 ? 1 : 0, stream);
  }
  return err;
}

}  // namespace fhe
