// Packed-row loads and the incomplete G1 adds of the msm3 kernels (K3,
// K4).  Op for op the formulas of msm3._kern_madd_inc and _kern_jadd_inc
// (a squaring where they square), so every output is the same raw words
// as the TPU kernels and the plain torch versions.
#pragma once
#include "g1.cuh"

// Packed layout of the msm3 pipeline: one 32-bit word holds two 16-bit
// limbs, low limb in the low half, i.e. row k of a packed coordinate IS
// word k of an Fe.  A packed Jacobian point is 24 rows (X, Y, Z), a packed
// affine point 16 rows (x, y).
__device__ __forceinline__ Fe fe_load_packed(const int32_t* base,
                                             long long stride, long long idx) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = (uint32_t)base[k * stride + idx];
  return r;
}

__device__ __forceinline__ void fe_store_packed(int32_t* base, long long stride,
                                                long long idx, const Fe& a) {
#pragma unroll
  for (int k = 0; k < 8; ++k) base[k * stride + idx] = (int32_t)a.w[k];
}

__device__ __forceinline__ Jac jac_load_packed(const int32_t* base, long long w,
                                               long long i) {
  Jac p;
  p.x = fe_load_packed(base, w, i);
  p.y = fe_load_packed(base + 8 * w, w, i);
  p.z = fe_load_packed(base + 16 * w, w, i);
  return p;
}

__device__ __forceinline__ void jac_store_packed(int32_t* base, long long w,
                                                 long long i, const Jac& p) {
  fe_store_packed(base, w, i, p.x);
  fe_store_packed(base + 8 * w, w, i, p.y);
  fe_store_packed(base + 16 * w, w, i, p.z);
}

// msm3._kern_madd_inc: INCOMPLETE Jacobian + affine, 8 products and 3
// squarings on the carry-chain arithmetic (field.cuh), no identity,
// doubling or cancellation branch; a fresh lane restarts at (x2, y2, 1).
// Only valid where p is not the identity and p != +-q; the msm3 pipeline
// (ops/msm3.py) says why its live lanes satisfy that and why the other
// lanes' garbage is never read.  Inlined into K3's step loop, so the
// accumulator stays in registers with no call frame; the asm chains are
// opaque to nvcc's optimizer, which keeps the inlined body compiling in
// seconds (msm3.cu alone: ~17 s on the H100 host, PERF.md).
__device__ __forceinline__ Jac jac_madd_inc(const Jac& p, const Fe& x2,
                                            const Fe& y2, bool fresh,
                                            const FieldConst& c) {
  Fe Z1Z1 = fe_sqr_ptx(p.z, c);
  Fe U2 = fe_mul_ptx(x2, Z1Z1, c);
  Fe S2 = fe_mul_ptx(y2, fe_mul_ptx(p.z, Z1Z1, c), c);
  Fe H = fe_sub_ptx(U2, p.x, c);
  Fe R = fe_sub_ptx(S2, p.y, c);
  Fe HH = fe_sqr_ptx(H, c);
  Fe HHH = fe_mul_ptx(H, HH, c);
  Fe V = fe_mul_ptx(p.x, HH, c);
  Jac r;
  r.x = fe_sub_ptx(fe_sub_ptx(fe_sqr_ptx(R, c), HHH, c), fe_add_ptx(V, V, c), c);
  r.y = fe_sub_ptx(fe_mul_ptx(R, fe_sub_ptx(V, r.x, c), c),
                   fe_mul_ptx(p.y, HHH, c), c);
  r.z = fe_mul_ptx(p.z, H, c);
  if (fresh) {
    r.x = x2;
    r.y = y2;
    r.z = fe_const(c.one);
  }
  return r;
}

// msm3._kern_jadd_inc without its fresh select, on a thread pair
// (jac_add_core_pair, g1.cuh): INCOMPLETE Jacobian + Jacobian, valid where
// neither point is the identity and p != +-q; ops/msm3.py says why the
// msm3 lanes that are read satisfy that.  The caller selects q on a fresh
// lane and the old accumulator on a dead one.  Inlined into K4's loops
// with no call frame.
__device__ __forceinline__ Jac jac_add_inc_pair(const Jac& p, const Jac& q,
                                                const FieldConst& c, bool odd,
                                                unsigned mask) {
  Fe H, R;
  return jac_add_core_pair(p, q, c, odd, mask, H, R);
}

// A pair's store of its common packed result: the even thread writes X
// and Y, the odd thread Z.
__device__ __forceinline__ void jac_store_packed_pair(int32_t* base, long long w,
                                                      long long i, const Jac& p,
                                                      bool odd) {
  if (odd) {
    fe_store_packed(base + 16 * w, w, i, p.z);
  } else {
    fe_store_packed(base, w, i, p.x);
    fe_store_packed(base + 8 * w, w, i, p.y);
  }
}
