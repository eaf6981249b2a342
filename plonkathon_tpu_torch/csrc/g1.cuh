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

// A coordinate handed over as the caller's view (the elementwise point
// kernels): limb k of element i at p[k * limb + i * col], where col is 1,
// or 0 for a coordinate broadcast from [16, 1].
struct Operand {
  const int32_t* p;
  long long limb;
  long long col;
};

template <int N>
struct Operands {
  Operand c[N];
};

// The operands from their pointers and a host int64 (limb, column) pair each.
template <int N>
inline Operands<N> make_operands(const void* const (&ptrs)[N], const long long* strides) {
  Operands<N> ops;
  for (int k = 0; k < N; ++k)
    ops.c[k] = Operand{(const int32_t*)ptrs[k], strides[2 * k], strides[2 * k + 1]};
  return ops;
}

__device__ __forceinline__ Fe fe_load_op(const Operand& o, long long i) {
  const int32_t* b = o.p + i * o.col;
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t lo = (uint32_t)b[(2 * k) * o.limb];
    uint32_t hi = (uint32_t)b[(2 * k + 1) * o.limb];
    r.w[k] = (lo & 0xFFFFu) | (hi << 16);
  }
  return r;
}

// The Jacobian point of operands first .. first + 2 at element i.
template <int N>
__device__ __forceinline__ Jac jac_load_op(const Operands<N>& ops, int first, long long i) {
  Jac p;
  p.x = fe_load_op(ops.c[first], i);
  p.y = fe_load_op(ops.c[first + 1], i);
  p.z = fe_load_op(ops.c[first + 2], i);
  return p;
}

__device__ __forceinline__ Jac jac_identity(const FieldConst& c) {
  Jac p;
  p.x = fe_const(c.one);
  p.y = fe_const(c.one);
  p.z = fe_zero();
  return p;
}

// _kern_double on the carry-chain arithmetic (field.cuh), inlined: K7's
// loop keeps the point in registers.  An identity lane (Z = 0) stays one,
// since Z3 = 2Y * Z.
__device__ __forceinline__ Jac jac_double_ptx(const Jac& p, const FieldConst& c) {
  Fe A = fe_sqr_ptx(p.x, c);
  Fe B = fe_sqr_ptx(p.y, c);
  Fe C = fe_sqr_ptx(B, c);
  Fe D = fe_sub_ptx(fe_sqr_ptx(fe_add_ptx(p.x, B, c), c), fe_add_ptx(A, C, c), c);
  D = fe_add_ptx(D, D, c);
  Fe E = fe_add_ptx(fe_add_ptx(A, A, c), A, c);
  Fe F = fe_sqr_ptx(E, c);
  Jac r;
  r.x = fe_sub_ptx(F, fe_add_ptx(D, D, c), c);
  Fe C2 = fe_add_ptx(C, C, c);
  Fe C4 = fe_add_ptx(C2, C2, c);  // once: nvcc never merges volatile asm
  Fe C8 = fe_add_ptx(C4, C4, c);
  r.y = fe_sub_ptx(fe_mul_ptx(E, fe_sub_ptx(D, r.x, c), c), C8, c);
  r.z = fe_mul_ptx(fe_add_ptx(p.y, p.y, c), p.z, c);
  return r;
}

// The doubling branch of jac_add_ptx, out of line: it runs only on lanes
// where p == q, and inlined it would double the add's code.  Operands by
// value, so they travel in registers.
static __device__ __noinline__ Jac jac_double_call(Jac p, FieldConst c) {
  return jac_double_ptx(p, c);
}

// The arithmetic of _kern_add (and of msm3._kern_jadd_inc) on the carry
// chains, without the selects: 12 products and 4 squarings, with H and R
// returned for the caller's selects.  Ordered so that independent products
// stand next to each other (Z1Z1 | Z2Z2, U1 | U2, the two Z cubes,
// S1 | S2, HH | R^2, HHH | V | Z1Z2), so ptxas can interleave their carry
// chains where a lane's adds depend on each other.
__device__ __forceinline__ Jac jac_add_core_ptx(const Jac& p, const Jac& q,
                                                const FieldConst& c, Fe& H, Fe& R) {
  Fe Z1Z1 = fe_sqr_ptx(p.z, c);
  Fe Z2Z2 = fe_sqr_ptx(q.z, c);
  Fe U1 = fe_mul_ptx(p.x, Z2Z2, c);
  Fe U2 = fe_mul_ptx(q.x, Z1Z1, c);
  Fe Z2c = fe_mul_ptx(q.z, Z2Z2, c);
  Fe Z1c = fe_mul_ptx(p.z, Z1Z1, c);
  Fe S1 = fe_mul_ptx(p.y, Z2c, c);
  Fe S2 = fe_mul_ptx(q.y, Z1c, c);
  H = fe_sub_ptx(U2, U1, c);
  R = fe_sub_ptx(S2, S1, c);
  Fe HH = fe_sqr_ptx(H, c);
  Fe RR = fe_sqr_ptx(R, c);
  Fe HHH = fe_mul_ptx(H, HH, c);
  Fe V = fe_mul_ptx(U1, HH, c);
  Fe Z1Z2 = fe_mul_ptx(p.z, q.z, c);
  Jac r;
  r.z = fe_mul_ptx(Z1Z2, H, c);
  r.x = fe_sub_ptx(fe_sub_ptx(RR, HHH, c), fe_add_ptx(V, V, c), c);
  Fe S1HHH = fe_mul_ptx(S1, HHH, c);
  r.y = fe_sub_ptx(fe_mul_ptx(R, fe_sub_ptx(V, r.x, c), c), S1HHH, c);
  return r;
}

// _kern_add's selects (identity, doubling, cancellation) on the sum r of
// jac_add_core_ptx or jac_add_core_pair.
__device__ __forceinline__ Jac jac_add_selects(Jac r, const Jac& p, const Jac& q,
                                               const Fe& H, const Fe& R,
                                               const FieldConst& c) {
  bool p_inf = fe_is_zero(p.z, c);
  bool q_inf = fe_is_zero(q.z, c);
  bool h_zero = fe_is_zero(H, c) && !(p_inf || q_inf);
  bool r_zero = fe_is_zero(R, c);
  if (h_zero && r_zero) r = jac_double_call(p, c);  // p == q
  if (h_zero && !r_zero) r.z = fe_zero();            // p == -q
  if (p_inf) r = q;
  if (q_inf) r = p;
  return r;
}

// _kern_add on the carry chains, one thread per add.
__device__ __forceinline__ Jac jac_add_ptx(const Jac& p, const Jac& q,
                                           const FieldConst& c) {
  Fe H, R;
  Jac r = jac_add_core_ptx(p, q, c, H, R);
  return jac_add_selects(r, p, q, H, R, c);
}

// ---------------------------------------------------------------------------
// Two threads per add.  Where a lane's adds form a dependent chain and the
// lanes are too few to fill the SMs (K4's merge scan, the narrow levels of
// K5's suffix fold), or where an add's registers leave too few warps per
// SM to hide its latency (the elementwise K8a add), the latency of one add
// is what costs.  The threads 2k and 2k + 1 of a warp both hold p and q and
// split the 16 products of jac_add_core_ptx into four rounds, exchanging
// results by __shfl_xor_sync:
//   1. Z1^2 | Z2^2;
//   2. U1 = X1 Z2^2, S1 = Y1 (Z2 Z2^2) | U2 = X2 Z1^2, S2 = Y2 (Z1 Z1^2);
//   3. HH = H^2, HHH = H HH, V = U1 HH | R^2, Z1Z2 = Z1 Z2, Z3 = Z1Z2 H;
//   4. R (V - X3) | S1 HHH.
// Each thread computes 8 products in sequence instead of 16; both execute
// the same instructions on operands chosen by their parity (no divergence),
// and both end with the whole sum.  Every product has the operands of the
// one-thread schedule, so the words are the same.  `mask` names the lanes
// that call it (both threads of each pair).
// ---------------------------------------------------------------------------

__device__ __forceinline__ Fe fe_from_pair(const Fe& a, unsigned mask) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = __shfl_xor_sync(mask, a.w[k], 1);
  return r;
}

__device__ __forceinline__ Jac jac_add_core_pair(const Jac& p, const Jac& q,
                                                 const FieldConst& c, bool odd,
                                                 unsigned mask, Fe& H, Fe& R) {
  Fe zz = fe_sqr_ptx(fe_select(odd, q.z, p.z), c);
  Fe zz_o = fe_from_pair(zz, mask);
  Fe Z1Z1 = fe_select(odd, zz_o, zz);
  Fe Z2Z2 = fe_select(odd, zz, zz_o);
  Fe zsq = fe_select(odd, Z1Z1, Z2Z2);  // the other point's Z^2
  Fe U = fe_mul_ptx(fe_select(odd, q.x, p.x), zsq, c);
  Fe S = fe_mul_ptx(fe_select(odd, q.y, p.y),
                    fe_mul_ptx(fe_select(odd, p.z, q.z), zsq, c), c);
  Fe U_o = fe_from_pair(U, mask);
  Fe S_o = fe_from_pair(S, mask);
  Fe U1 = fe_select(odd, U_o, U);
  Fe U2 = fe_select(odd, U, U_o);
  Fe S1 = fe_select(odd, S_o, S);
  Fe S2 = fe_select(odd, S, S_o);
  H = fe_sub_ptx(U2, U1, c);
  R = fe_sub_ptx(S2, S1, c);
  Fe t1 = fe_sqr_ptx(fe_select(odd, R, H), c);                          // HH | R^2
  Fe t2 = fe_mul_ptx(fe_select(odd, p.z, H), fe_select(odd, q.z, t1), c);  // HHH | Z1Z2
  Fe t3 = fe_mul_ptx(fe_select(odd, t2, U1), fe_select(odd, H, t1), c);    // V | Z3
  Fe o1 = fe_from_pair(t1, mask);
  Fe o2 = fe_from_pair(t2, mask);
  Fe o3 = fe_from_pair(t3, mask);
  Fe RR = fe_select(odd, t1, o1);
  Fe HHH = fe_select(odd, o2, t2);
  Fe V = fe_select(odd, o3, t3);
  Jac r;
  r.z = fe_select(odd, t3, o3);
  r.x = fe_sub_ptx(fe_sub_ptx(RR, HHH, c), fe_add_ptx(V, V, c), c);
  Fe t4 = fe_mul_ptx(fe_select(odd, S1, R),
                     fe_select(odd, HHH, fe_sub_ptx(V, r.x, c)), c);  // R (V - X3) | S1 HHH
  Fe o4 = fe_from_pair(t4, mask);
  r.y = fe_sub_ptx(fe_select(odd, o4, t4), fe_select(odd, t4, o4), c);
  return r;
}

// _kern_add on a thread pair: jac_add_core_pair and _kern_add's selects.
__device__ __forceinline__ Jac jac_add_pair(const Jac& p, const Jac& q,
                                            const FieldConst& c, bool odd,
                                            unsigned mask) {
  Fe H, R;
  Jac r = jac_add_core_pair(p, q, c, odd, mask, H, R);
  return jac_add_selects(r, p, q, H, R, c);
}

// A pair's store of its common result: the even thread writes X and Y,
// the odd thread Z (stacked [48, W] limbs).
__device__ __forceinline__ void jac_store_pair(int32_t* base, long long w, long long i,
                                               const Jac& p, bool odd) {
  if (odd) {
    fe_store(base + 32 * w, w, i, p.z);
  } else {
    fe_store(base, w, i, p.x);
    fe_store(base + 16 * w, w, i, p.y);
  }
}

// ---------------------------------------------------------------------------
// _kern_madd on a thread pair (K6's run-scan).  The chain of _kern_madd is
// Z1^2 -> Z1^3 -> S2 -> R^2 -> R (V - X3): the threads 2k and 2k + 1 of a
// warp both hold p and q = (x2, y2) and split its 11 products into four
// rounds, 6 in sequence on each thread instead of 11:
//   1. Z1Z1 = Z1^2 on both;
//   2. U2 = X2 Z1Z1, HH = (U2 - X1)^2 | Z1^3 = Z1 Z1Z1, S2 = Y2 Z1^3;
//      swap U2 | S2, both form H and R;
//   3. HHH = H HH, V = X1 HH | R^2, Z3 = Z1 H; swap, both form X3;
//   4. R (V - X3) | Y1 HHH; swap, both form Y3.
// Both threads execute the same instructions on operands chosen by their
// parity, so no product diverges; the squares of rounds 2 and 3 are
// products of an element with itself, the same integer as a squaring
// (REDC with R = 2^256 is unique).  Every product has _kern_madd's
// operands, so the words are the TPU body's.  The products run on the
// carry chains (the 64-bit CIOS was no faster here: PERF.md).  `mask`
// names the lanes that call it.
// ---------------------------------------------------------------------------

__device__ __forceinline__ Jac jac_madd_core_pair(const Jac& p, const Fe& x2, const Fe& y2,
                                                  const FieldConst& c, bool odd,
                                                  unsigned mask, Fe& H, Fe& R) {
  Fe Z1Z1 = fe_sqr_ptx(p.z, c);
  Fe t = fe_mul_ptx(fe_select(odd, p.z, x2), Z1Z1, c);  // U2 | Z1^3
  Fe h = fe_sub_ptx(t, p.x, c);                         // H on the even thread
  Fe u = fe_mul_ptx(fe_select(odd, y2, h), fe_select(odd, t, h), c);  // HH | S2
  Fe o = fe_from_pair(fe_select(odd, u, t), mask);
  Fe U2 = fe_select(odd, o, t);
  Fe S2 = fe_select(odd, u, o);
  H = fe_sub_ptx(U2, p.x, c);
  R = fe_sub_ptx(S2, p.y, c);
  Fe t1 = fe_mul_ptx(fe_select(odd, R, H), fe_select(odd, R, u), c);      // HHH | R^2
  Fe t2 = fe_mul_ptx(fe_select(odd, p.z, p.x), fe_select(odd, H, u), c);  // V | Z3
  Fe o1 = fe_from_pair(t1, mask);
  Fe o2 = fe_from_pair(t2, mask);
  Fe HHH = fe_select(odd, o1, t1);
  Fe RR = fe_select(odd, t1, o1);
  Fe V = fe_select(odd, o2, t2);
  Jac r;
  r.z = fe_select(odd, t2, o2);
  r.x = fe_sub_ptx(fe_sub_ptx(RR, HHH, c), fe_add_ptx(V, V, c), c);
  Fe t4 = fe_mul_ptx(fe_select(odd, p.y, R),
                     fe_select(odd, HHH, fe_sub_ptx(V, r.x, c)), c);  // R (V - X3) | Y1 HHH
  Fe o4 = fe_from_pair(t4, mask);
  r.y = fe_sub_ptx(fe_select(odd, o4, t4), fe_select(odd, t4, o4), c);
  return r;
}

// _kern_madd's selects on the sum r of jac_madd_core_pair or
// jac_madd_core_ptx: the doubling (out of line) where p == q, Z = 0 where
// p == -q, q itself where p is the identity.
__device__ __forceinline__ Jac jac_madd_selects(Jac r, const Jac& p, const Fe& x2,
                                                const Fe& y2, const Fe& H, const Fe& R,
                                                const FieldConst& c) {
  bool p_inf = fe_is_zero(p.z, c);
  bool h_zero = fe_is_zero(H, c) && !p_inf;
  bool r_zero = fe_is_zero(R, c);
  if (h_zero && r_zero) r = jac_double_call(p, c);  // p == q
  if (h_zero && !r_zero) r.z = fe_zero();            // p == -q
  if (p_inf) {
    r.x = x2;
    r.y = y2;
    r.z = fe_const(c.one);
  }
  return r;
}

// The arithmetic of _kern_madd on the carry chains, one thread per add,
// without the selects: 8 products and 3 squarings, with H and R returned
// for jac_madd_selects.  Ordered as jac_add_core_ptx, independent products
// side by side: Z1^2; U2 | Z1^3; S2; HH | R^2; HHH | V | Z3; Y1 HHH |
// R (V - X3).  Every product has _kern_madd's operands (a square is the
// squaring of field.cuh, the same integer as the product), so the words
// are the TPU body's.
__device__ __forceinline__ Jac jac_madd_core_ptx(const Jac& p, const Fe& x2, const Fe& y2,
                                                 const FieldConst& c, Fe& H, Fe& R) {
  Fe Z1Z1 = fe_sqr_ptx(p.z, c);
  Fe U2 = fe_mul_ptx(x2, Z1Z1, c);
  Fe Z1c = fe_mul_ptx(p.z, Z1Z1, c);
  Fe S2 = fe_mul_ptx(y2, Z1c, c);
  H = fe_sub_ptx(U2, p.x, c);
  R = fe_sub_ptx(S2, p.y, c);
  Fe HH = fe_sqr_ptx(H, c);
  Fe RR = fe_sqr_ptx(R, c);
  Fe HHH = fe_mul_ptx(H, HH, c);
  Fe V = fe_mul_ptx(p.x, HH, c);
  Jac r;
  r.z = fe_mul_ptx(p.z, H, c);
  r.x = fe_sub_ptx(fe_sub_ptx(RR, HHH, c), fe_add_ptx(V, V, c), c);
  Fe Y1HHH = fe_mul_ptx(p.y, HHH, c);
  r.y = fe_sub_ptx(fe_mul_ptx(R, fe_sub_ptx(V, r.x, c), c), Y1HHH, c);
  return r;
}

// _kern_madd on the carry chains, one thread per add (K8b).
__device__ __forceinline__ Jac jac_madd_ptx(const Jac& p, const Fe& x2, const Fe& y2,
                                            const FieldConst& c) {
  Fe H, R;
  Jac r = jac_madd_core_ptx(p, x2, y2, c, H, R);
  return jac_madd_selects(r, p, x2, y2, H, R, c);
}
