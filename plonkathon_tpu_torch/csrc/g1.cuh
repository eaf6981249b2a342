// G1 point formulas over Fq (y^2 = x^3 + 3, a = 0) for the Hopper kernels.
//
// Jacobian (X, Y, Z) in Montgomery form; the identity is Z == 0 (X = Y =
// ONE by convention).  Op for op the formulas of pallas_mont._kern_double,
// _kern_add and _kern_madd, so every output is the same raw limbs as the
// TPU kernels and the plain torch versions.  One difference in schedule,
// none in result: the TPU computes the doubling of p on every lane and
// selects it where p == q; here a thread computes it only when its lane
// needs it (p == q is rare in the MSM), which saves 7 of ~23 products.
#pragma once
#include "field.cuh"

struct Jac {
  Fe x, y, z;
};

// Stacked [48, W] layout: X limbs at rows 0-15, Y at 16-31, Z at 32-47.
__device__ __forceinline__ Jac jac_load(const int32_t* base, long long w,
                                        long long i) {
  Jac p;
  p.x = fe_load(base, w, i);
  p.y = fe_load(base + 16 * w, w, i);
  p.z = fe_load(base + 32 * w, w, i);
  return p;
}

__device__ __forceinline__ void jac_store(int32_t* base, long long w,
                                          long long i, const Jac& p) {
  fe_store(base, w, i, p.x);
  fe_store(base + 16 * w, w, i, p.y);
  fe_store(base + 32 * w, w, i, p.z);
}

__device__ __forceinline__ Jac jac_identity(const FieldConst& c) {
  Jac p;
  p.x = fe_const(c.one);
  p.y = fe_const(c.one);
  p.z = fe_zero();
  return p;
}

// _kern_double: 5 squarings + 2 products.  Static: both sources include
// this header and link into one library.
static __device__ __noinline__ Jac jac_double(const Jac& p, const FieldConst& c) {
  Fe A = fe_mul(p.x, p.x, c);
  Fe B = fe_mul(p.y, p.y, c);
  Fe C = fe_mul(B, B, c);
  Fe xb = fe_add(p.x, B, c);
  Fe D = fe_sub(fe_mul(xb, xb, c), fe_add(A, C, c), c);
  D = fe_add(D, D, c);
  Fe E = fe_add(fe_add(A, A, c), A, c);
  Fe F = fe_mul(E, E, c);
  Jac r;
  r.x = fe_sub(F, fe_add(D, D, c), c);
  Fe C2 = fe_add(C, C, c);
  Fe C8 = fe_add(fe_add(C2, C2, c), fe_add(C2, C2, c), c);
  r.y = fe_sub(fe_mul(E, fe_sub(D, r.x, c), c), C8, c);
  r.z = fe_mul(fe_add(p.y, p.y, c), p.z, c);
  return r;
}

// _kern_add: complete Jacobian + Jacobian (identity, doubling, cancellation).
__device__ __forceinline__ Jac jac_add(const Jac& p, const Jac& q,
                                       const FieldConst& c) {
  Fe Z1Z1 = fe_mul(p.z, p.z, c);
  Fe Z2Z2 = fe_mul(q.z, q.z, c);
  Fe U1 = fe_mul(p.x, Z2Z2, c);
  Fe U2 = fe_mul(q.x, Z1Z1, c);
  Fe S1 = fe_mul(p.y, fe_mul(q.z, Z2Z2, c), c);
  Fe S2 = fe_mul(q.y, fe_mul(p.z, Z1Z1, c), c);
  Fe H = fe_sub(U2, U1, c);
  Fe R = fe_sub(S2, S1, c);
  Fe HH = fe_mul(H, H, c);
  Fe HHH = fe_mul(H, HH, c);
  Fe V = fe_mul(U1, HH, c);
  Jac r;
  r.x = fe_sub(fe_sub(fe_mul(R, R, c), HHH, c), fe_add(V, V, c), c);
  r.y = fe_sub(fe_mul(R, fe_sub(V, r.x, c), c), fe_mul(S1, HHH, c), c);
  r.z = fe_mul(fe_mul(p.z, q.z, c), H, c);

  bool p_inf = fe_is_zero(p.z, c);
  bool q_inf = fe_is_zero(q.z, c);
  bool h_zero = fe_is_zero(H, c) && !(p_inf || q_inf);
  bool r_zero = fe_is_zero(R, c);
  if (h_zero && r_zero) r = jac_double(p, c);  // p == q
  if (h_zero && !r_zero) r.z = fe_zero();       // p == -q
  if (p_inf) r = q;
  if (q_inf) r = p;
  return r;
}

// _kern_madd: complete Jacobian + affine (q never the identity).
__device__ __forceinline__ Jac jac_madd(const Jac& p, const Fe& x2,
                                        const Fe& y2, const FieldConst& c) {
  Fe Z1Z1 = fe_mul(p.z, p.z, c);
  Fe U2 = fe_mul(x2, Z1Z1, c);
  Fe S2 = fe_mul(y2, fe_mul(p.z, Z1Z1, c), c);
  Fe H = fe_sub(U2, p.x, c);
  Fe R = fe_sub(S2, p.y, c);
  Fe HH = fe_mul(H, H, c);
  Fe HHH = fe_mul(H, HH, c);
  Fe V = fe_mul(p.x, HH, c);
  Jac r;
  r.x = fe_sub(fe_sub(fe_mul(R, R, c), HHH, c), fe_add(V, V, c), c);
  r.y = fe_sub(fe_mul(R, fe_sub(V, r.x, c), c), fe_mul(p.y, HHH, c), c);
  r.z = fe_mul(p.z, H, c);

  bool p_inf = fe_is_zero(p.z, c);
  bool h_zero = fe_is_zero(H, c) && !p_inf;
  bool r_zero = fe_is_zero(R, c);
  if (h_zero && r_zero) r = jac_double(p, c);
  if (h_zero && !r_zero) r.z = fe_zero();
  if (p_inf) {
    r.x = x2;
    r.y = y2;
    r.z = fe_const(c.one);
  }
  return r;
}
