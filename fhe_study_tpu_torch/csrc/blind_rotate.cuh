// Device code shared by K10's device-memory layouts (csrc/
// blind_rotate_dm_cuda.cu, and csrc/blind_rotate_grid_cuda.cu past one
// block): a digit of the rotated accumulator, the contraction against the
// step's key planes in the first inverse pass, and the exact CRT lift.
#pragma once

#include <cstdint>

#include "modarith.cuh"
#include "radix_chain.cuh"

namespace fhe {

// Digit i of acc * X^-h - acc at element e (0 <= e < n = 2^logn, h in
// [0, 2n)): the rotated accumulator's word (e + h) mod n, negated where
// e + h lies in [n, 2n), less word e, wrapping in 64 bits; then the w bits
// from `shift` (64 - w (i + 1): base-2^w digits MSB-first, the top w l bits,
// as arith/tn.py::decompose_base_pow2).  A digit < 2^w is canonical under
// either CRT prime.
__device__ __forceinline__ uint32_t br_digit(const unsigned long long* ac,
                                             int e, int h, int logn,
                                             int shift, uint32_t mask) {
  const int src = e + h;                     // in [0, 3n)
  unsigned long long r = __ldg(ac + (src & ((1 << logn) - 1)));
  if ((src >> logn) & 1) r = 0ull - r;
  return static_cast<uint32_t>((r - __ldg(ac + e)) >> shift) & mask;
}

// The contraction of one output column in the first inverse pass of a
// chain of 2^LOGN words: F digit-evaluation rows at dr (row stride dstride
// words) against the key rows of the column at kv / ks (values and Shoup
// companions, row stride kstride), summed mod q into the 16 contiguous
// words from 16 v that virtual thread v holds; then the pass's stages
// (inverse tables iw / iwsh) and the store into the swizzled buffer a.
// MONT: Montgomery products against the values alone (nq = -q^-1 mod
// 2^32; ks unread), each a factor 2^-32 that the caller's final
// multiplier takes back: two thirds of the bytes a row-word.  The offsets
// are 32-bit (F kstride < 2^31: the callers check), which keeps the loop
// within 128 registers a thread at 2^15.  The caller waits on a barrier
// before the next pass.
template <int LOGN, bool MONT = false>
__device__ __forceinline__ void br_contract_pass(
    uint32_t* a, const uint32_t* dr, int dstride, const uint32_t* kv,
    const uint32_t* ks, int kstride, int F, uint32_t q, const uint32_t* iw,
    const uint32_t* iwsh, int vec, uint32_t nq = 0) {
  using S = typename OneBuffer<LOGN>::Shape;
#pragma unroll 1
  for (int g = 0; g < S::groups; ++g) {
    const int base = (threadIdx.x + g * S::threads) << kRadixBits;
    uint32_t x[kRadix];
#pragma unroll
    for (int k = 0; k < kRadix; ++k) x[k] = 0;
#pragma unroll 1
    for (int ri = 0; ri < F; ++ri) {
      const uint32_t* d = dr + (ri * dstride + base);
      const int at = ri * kstride + base;
#pragma unroll
      for (int u = 0; u < kRadix; u += 4) {
        uint32_t D[4], K[4], KS[4];
        operand_words(D, d + u, true);
        operand_words(K, kv + at + u, vec != 0);
        if constexpr (!MONT) operand_words(KS, ks + at + u, vec != 0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t prod;
          if constexpr (MONT) {
            prod = mont_mul(D[i], K[i], q, nq);
          } else {
            prod = shoup_mul(D[i], K[i], KS[i], q);
          }
          x[u + i] = addmod(x[u + i], prod, q);
        }
      }
    }
    radix_pass<LOGN, 0, true>(x, base, radix_opaque(iw), radix_opaque(iwsh),
                              q);
    radix_store<0>(a, x, base);
  }
}

// The exact CRT lift of residues (r0 mod q0, r1 mod q1), q0 < 2 q1, to the
// centred integer in (-q0 q1 / 2, q0 q1 / 2], as its 64-bit two's
// complement; crt holds q0^-1 mod q1 and its Shoup companion (fin, fin_sh).
__device__ __forceinline__ unsigned long long br_lift(uint32_t r0,
                                                      uint32_t r1,
                                                      uint32_t q0,
                                                      uint32_t q1,
                                                      const PrimeRow& crt) {
  const unsigned long long m12 = static_cast<unsigned long long>(q0) * q1;
  const uint32_t rp = r0 >= q1 ? r0 - q1 : r0;
  const uint32_t dm = shoup_mul(submod(r1, rp, q1), crt.fin, crt.fin_sh, q1);
  const unsigned long long g = r0 + static_cast<unsigned long long>(q0) * dm;
  return g > (m12 >> 1) ? g - m12 : g;
}

}  // namespace fhe
