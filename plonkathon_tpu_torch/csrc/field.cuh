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
