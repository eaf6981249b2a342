// BN254 base/scalar field arithmetic for the Hopper kernels.
//
// Wire format (shared with ops/limbs.py and the JAX package): an element is
// 16 little-endian 16-bit limbs in a limb-major int32 array, limb k of
// element i at base[k * stride + i].  In registers an element is 8 x 32-bit
// words, repacked at load and unpacked at store; neighbouring threads hold
// neighbouring elements, so every limb load and store is coalesced.
//
// Semantics match pallas_mont._K exactly, limb for limb:
//   * mul: Montgomery product a*b*2^-256 with NO final subtraction.  The
//     REDC multiplier m is the unique m < 2^256 with a*b + m*p = 0 mod
//     2^256 whatever the word size, so this 32-bit CIOS gives the same
//     integer as the TPU's 16-bit column schoolbook.  Lazy domain [0, 2p)
//     in and out (4p < 2^256 for both BN254 primes).
//   * add: subtract 2p once when the sum is >= 2p.
//   * sub: add 2p (mod 2^256) on a borrow.
//   * canon: subtract p once when >= p.
#pragma once
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

// Field constants, passed by value as a kernel argument (they land in the
// kernel's constant bank).  Filled from the port's FieldOps.
struct FieldConst {
  uint32_t p[8];    // modulus
  uint32_t p2[8];   // 2 * modulus
  uint32_t one[8];  // 2^256 mod p (Montgomery one)
  uint32_t n0;      // -p^-1 mod 2^32
};

// Host side of the C entry points: the constants arrive as a uint32[25]
// buffer (ops/cuda_mont.py field_consts), one thread per element.
inline FieldConst unpack_const(const void* host) {
  FieldConst c;
  std::memcpy(&c, host, sizeof(FieldConst));
  return c;
}

inline unsigned blocks_for(long long w, int threads) {
  return (unsigned)((w + threads - 1) / threads);
}

struct Fe {
  uint32_t w[8];
};

__device__ __forceinline__ Fe fe_load(const int32_t* base, long long stride,
                                      long long idx) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t lo = (uint32_t)base[(2 * k) * stride + idx];
    uint32_t hi = (uint32_t)base[(2 * k + 1) * stride + idx];
    r.w[k] = (lo & 0xFFFFu) | (hi << 16);
  }
  return r;
}

__device__ __forceinline__ void fe_store(int32_t* base, long long stride,
                                         long long idx, const Fe& a) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    base[(2 * k) * stride + idx] = (int32_t)(a.w[k] & 0xFFFFu);
    base[(2 * k + 1) * stride + idx] = (int32_t)(a.w[k] >> 16);
  }
}

__device__ __forceinline__ Fe fe_const(const uint32_t* c) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = c[k];
  return r;
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = 0u;
  return r;
}

// r = a - b mod 2^256; returns the borrow out (1 if a < b).
__device__ __forceinline__ uint32_t sub_words(Fe& r, const Fe& a, const Fe& b) {
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint64_t t = (uint64_t)a.w[k] - (uint64_t)b.w[k] - borrow;
    r.w[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  return borrow;
}

// r = a + b mod 2^256.
__device__ __forceinline__ void add_words(Fe& r, const Fe& a, const Fe& b) {
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c += (uint64_t)a.w[k] + (uint64_t)b.w[k];
    r.w[k] = (uint32_t)c;
    c >>= 32;
  }
}

__device__ __forceinline__ Fe fe_select(bool m, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = m ? a.w[k] : b.w[k];
  return r;
}

// Subtract the constant m once if a >= m.
__device__ __forceinline__ Fe cond_sub(const Fe& a, const uint32_t* m) {
  Fe d;
  uint32_t borrow = sub_words(d, a, fe_const(m));
  return fe_select(borrow != 0, a, d);
}

__device__ __forceinline__ Fe fe_canon(const Fe& a, const FieldConst& c) {
  return cond_sub(a, c.p);
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b,
                                     const FieldConst& c) {
  Fe s;
  add_words(s, a, b);
  return cond_sub(s, c.p2);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b,
                                     const FieldConst& c) {
  Fe d;
  uint32_t borrow = sub_words(d, a, b);
  Fe r;
  add_words(r, d, borrow ? fe_const(c.p2) : fe_zero());
  return r;
}

// CIOS Montgomery product with 32x32->64-bit partial products.
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b,
                                     const FieldConst& c) {
  uint32_t t[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) t[k] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + carry;
      t[j] = (uint32_t)s;
      carry = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + carry;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * c.n0;
    s = (uint64_t)m * c.p[0] + t[0];
    carry = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)m * c.p[j] + t[j] + carry;
      t[j - 1] = (uint32_t)s;
      carry = s >> 32;
    }
    s = (uint64_t)t[8] + carry;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = t[k];
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a, const FieldConst& c) {
  Fe x = fe_canon(a, c);
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc |= x.w[k];
  return acc == 0u;
}

// ---------------------------------------------------------------------------
// Carry-chain arithmetic: fe_mul_ptx, fe_sqr_ptx, fe_add_ptx, fe_sub_ptx.
//
// The same integers as fe_mul, fe_mul(a, a), fe_add and fe_sub, computed in
// PTX carry chains (mad.lo.cc / madc.hi.cc / addc.cc / subc), so that every
// 32-bit word product is one IMAD (IMAD.HI for a high half) and every carry
// rides the carry flag instead of being rebuilt from 64-bit sums.  Hopper's
// IMAD writes no carry, so ptxas pairs each chained multiply-add with an
// IADD3.X: about two instructions per word multiply either way.
//   * product: CIOS, the reduction interleaved row by row (64 + 64 word
//     multiplies for a * b, 8 for the digits m_i, 128 for m * p);
//   * square: each cross product a_i * a_j (i < j) once, the sum doubled,
//     the squares a_i^2 added (72 word multiplies instead of 128, as
//     pallas_mont._K.sqr does with its symmetric columns), then a
//     word-by-word REDC of the 16 words (8 + 128).
// Why the result is fe_mul's: REDC with R = 2^256 and no final subtraction
// returns (t + m p) / R for the unique m < R with t + m p = 0 mod R, so the
// integer does not depend on the schedule.  Why nothing overflows: inputs
// are below 2p, so a^2 < 4p^2 and a^2 + m p < 4p^2 + R p < 2^511 -- every
// intermediate fits 16 words -- and the CIOS bounds are stated at
// fe_mul_ptx.  Each carry that a chain below drops is zero
// (tests/test_torch_mont_words.py runs these schedules word for word on
// Python integers, asserting as much, against the TPU kernel bodies).
//
// One instruction per asm statement, all volatile: the carry flag passes
// from one statement to the next, nvcc keeps volatile asm in order, and it
// emits no flag-writing instruction of its own in between.
// ---------------------------------------------------------------------------

#define PTX_OP2(name, op)                                              \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {   \
    uint32_t r;                                                        \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));       \
    return r;                                                          \
  }
#define PTX_OP3(name, op)                                                    \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b,           \
                                           uint32_t c) {                     \
    uint32_t r;                                                              \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); \
    return r;                                                                \
  }
PTX_OP2(add_cc, "add.cc.u32")
PTX_OP2(addc_cc, "addc.cc.u32")
PTX_OP2(addc, "addc.u32")
PTX_OP2(sub_cc, "sub.cc.u32")
PTX_OP2(subc_cc, "subc.cc.u32")
PTX_OP2(subc, "subc.u32")
PTX_OP3(mad_lo_cc, "mad.lo.cc.u32")
PTX_OP3(madc_lo_cc, "madc.lo.cc.u32")
PTX_OP3(mad_hi_cc, "mad.hi.cc.u32")
PTX_OP3(madc_hi_cc, "madc.hi.cc.u32")
PTX_OP3(madc_hi, "madc.hi.u32")
#undef PTX_OP2
#undef PTX_OP3

// t[0..15] = a^2.  The cross products a_i a_j (i < j) by rows: row i adds
// a_i * (a_{i+1}..a_7) at word 2i+1 in a chain of low halves over words
// 2i+1..i+7, whose carry fills the fresh word i+8, and a chain of high
// halves over words 2i+2..i+8; rows 0..i sum below 2^(256 + 32(i+1)), so
// the last high half carries nothing out.  Then one add chain doubles the
// sum and one chain adds the squares a_i^2 at words 2i, 2i+1.
__device__ __forceinline__ void sqr_wide(uint32_t t[16], const Fe& a) {
  t[0] = 0u;
#pragma unroll
  for (int j = 1; j < 8; ++j) t[j] = a.w[j] * a.w[0];
  t[2] = mad_hi_cc(a.w[1], a.w[0], t[2]);
#pragma unroll
  for (int j = 2; j < 7; ++j) t[j + 1] = madc_hi_cc(a.w[j], a.w[0], t[j + 1]);
  t[8] = madc_hi(a.w[7], a.w[0], 0u);
#pragma unroll
  for (int i = 1; i < 7; ++i) {
    t[2 * i + 1] = mad_lo_cc(a.w[i + 1], a.w[i], t[2 * i + 1]);
#pragma unroll
    for (int j = i + 2; j < 8; ++j) t[i + j] = madc_lo_cc(a.w[j], a.w[i], t[i + j]);
    t[i + 8] = addc(0u, 0u);
    if (i + 1 == 7) {
      t[14] = __umulhi(a.w[7], a.w[6]) + t[14];  // a one-term chain
    } else {
      t[2 * i + 2] = mad_hi_cc(a.w[i + 1], a.w[i], t[2 * i + 2]);
#pragma unroll
      for (int j = i + 2; j < 7; ++j)
        t[i + j + 1] = madc_hi_cc(a.w[j], a.w[i], t[i + j + 1]);
      t[i + 8] = madc_hi(a.w[7], a.w[i], t[i + 8]);
    }
  }
  t[1] = add_cc(t[1], t[1]);
#pragma unroll
  for (int k = 2; k < 15; ++k) t[k] = addc_cc(t[k], t[k]);
  t[15] = addc(0u, 0u);
  t[0] = a.w[0] * a.w[0];
  t[1] = mad_hi_cc(a.w[0], a.w[0], t[1]);
#pragma unroll
  for (int i = 1; i < 7; ++i) {
    t[2 * i] = madc_lo_cc(a.w[i], a.w[i], t[2 * i]);
    t[2 * i + 1] = madc_hi_cc(a.w[i], a.w[i], t[2 * i + 1]);
  }
  t[14] = madc_lo_cc(a.w[7], a.w[7], t[14]);
  t[15] = madc_hi(a.w[7], a.w[7], t[15]);
}

// (t + m p) / 2^256, one 32-bit digit m_i at a time.  Row i adds m_i * p at
// word i in a low chain (words i..i+7, then word i+8 with the carry still
// owed there) and a high chain (words i+1..i+8); both chains' carries out
// of word i+8 are owed to word i+9 and paid by the next row.  The last
// row's carry, owed to word 16, is zero.
__device__ __forceinline__ Fe redc_wide(uint32_t t[16], const FieldConst& c) {
  uint32_t owed = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t m = t[i] * c.n0;
    t[i] = mad_lo_cc(m, c.p[0], t[i]);  // 0; only its carry matters
#pragma unroll
    for (int j = 1; j < 8; ++j) t[i + j] = madc_lo_cc(m, c.p[j], t[i + j]);
    t[i + 8] = addc_cc(t[i + 8], owed);
    uint32_t low_out = addc(0u, 0u);
    t[i + 1] = mad_hi_cc(m, c.p[0], t[i + 1]);
#pragma unroll
    for (int j = 1; j < 8; ++j) t[i + j + 1] = madc_hi_cc(m, c.p[j], t[i + j + 1]);
    owed = addc(low_out, 0u);
  }
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = t[8 + k];
  return r;
}

// CIOS: row i adds a * b_i into t[0..8], whose word 8 is 0 when the row
// starts (a chain of low halves over words 0..7 whose carry fills word 8,
// then a chain of high halves over words 1..8), then m_i * p the same way,
// and moves t down one word.  With W = 2^32, between rows t < 3p W/(W - 1)
// < 2^256 and within a row t < 2^256 + 3p W < 2^288, so no carry leaves
// word 8.  Interleaving the reduction keeps 9 words live instead of 16,
// which made K3's register-bound step loop faster on the H100 than a
// product schoolbook into 16 words followed by redc_wide (PERF.md).
__device__ __forceinline__ Fe fe_mul_ptx(const Fe& a, const Fe& b,
                                         const FieldConst& c) {
  uint32_t t[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) t[k] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    t[0] = mad_lo_cc(a.w[0], b.w[i], t[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j) t[j] = madc_lo_cc(a.w[j], b.w[i], t[j]);
    t[8] = addc(0u, 0u);
    t[1] = mad_hi_cc(a.w[0], b.w[i], t[1]);
#pragma unroll
    for (int j = 1; j < 7; ++j) t[j + 1] = madc_hi_cc(a.w[j], b.w[i], t[j + 1]);
    t[8] = madc_hi(a.w[7], b.w[i], t[8]);
    uint32_t m = t[0] * c.n0;
    t[0] = mad_lo_cc(m, c.p[0], t[0]);  // 0; only its carry matters
#pragma unroll
    for (int j = 1; j < 8; ++j) t[j] = madc_lo_cc(m, c.p[j], t[j]);
    t[8] = addc(t[8], 0u);
    t[1] = mad_hi_cc(m, c.p[0], t[1]);
#pragma unroll
    for (int j = 1; j < 7; ++j) t[j + 1] = madc_hi_cc(m, c.p[j], t[j + 1]);
    t[8] = madc_hi(m, c.p[7], t[8]);
#pragma unroll
    for (int k = 0; k < 8; ++k) t[k] = t[k + 1];
  }
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = t[k];
  return r;
}

__device__ __forceinline__ Fe fe_sqr_ptx(const Fe& a, const FieldConst& c) {
  uint32_t t[16];
  sqr_wide(t, a);
  return redc_wide(t, c);
}

// fe_add: a + b (below 4p < 2^256), less 2p unless that borrows.
__device__ __forceinline__ Fe fe_add_ptx(const Fe& a, const Fe& b,
                                         const FieldConst& c) {
  Fe s, d;
  s.w[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < 7; ++k) s.w[k] = addc_cc(a.w[k], b.w[k]);
  s.w[7] = addc(a.w[7], b.w[7]);
  d.w[0] = sub_cc(s.w[0], c.p2[0]);
#pragma unroll
  for (int k = 1; k < 8; ++k) d.w[k] = subc_cc(s.w[k], c.p2[k]);
  uint32_t borrow = subc(0u, 0u);  // all ones when s < 2p
  return fe_select(borrow != 0u, s, d);
}

// fe_sub: a - b, plus 2p (mod 2^256) where that borrows.
__device__ __forceinline__ Fe fe_sub_ptx(const Fe& a, const Fe& b,
                                         const FieldConst& c) {
  Fe d, r;
  d.w[0] = sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < 8; ++k) d.w[k] = subc_cc(a.w[k], b.w[k]);
  uint32_t borrow = subc(0u, 0u);  // all ones on a borrow
  r.w[0] = add_cc(d.w[0], c.p2[0] & borrow);
#pragma unroll
  for (int k = 1; k < 7; ++k) r.w[k] = addc_cc(d.w[k], c.p2[k] & borrow);
  r.w[7] = addc(d.w[7], c.p2[7] & borrow);
  return r;
}
