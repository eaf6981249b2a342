// Elementwise field and point kernels: K1 mont_mul, K2 dif_butterfly,
// K7 jac_double_n.  Plain C entry points for ctypes; each launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
//
// Design, shared by all three: one thread per element, 16-bit limbs
// repacked into 8 x 32-bit words at load (ops/limbs.py wire format, limb-
// major so each limb row is one coalesced load), CIOS Montgomery product
// with 64-bit partial products (field.cuh).
#include "field.cuh"
#include "g1.cuh"

namespace {

constexpr int kThreads = 256;

// K1.  Replaces ops/pallas_mont.py:_mont_mul_kernel (mont_mul).
// Bound: bytes.  Per element it moves 192 bytes against 264 32-bit
// multiplies (64 + 64 word products, low and high halves, plus 8 REDC
// digits); at 3.35 TB/s and 64 multiplies per SM per clock the bytes take
// longer.  Design: the whole CIOS chain stays in registers, so memory
// traffic is exactly the two inputs and the output.
__global__ void __launch_bounds__(kThreads)
k1_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
          int32_t* __restrict__ o, long long w, FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  fe_store(o, w, i, fe_mul(fe_load(a, w, i), fe_load(b, w, i), c));
}

// K2.  Replaces ops/pallas_mont.py:_dif_butterfly_kernel (dif_butterfly):
// one constant-geometry Stockham DIF stage, (c0, c1, tw) -> (c0 + c1,
// (c0 - c1) * tw) in Fr.  Bound: bytes, like K1 (one Montgomery product
// per 320 bytes moved).  Design: the sub, the product and the add never
// leave registers, so traffic is exactly the three inputs and two outputs.
__global__ void __launch_bounds__(kThreads)
k2_kernel(const int32_t* __restrict__ c0, const int32_t* __restrict__ c1,
          const int32_t* __restrict__ tw, int32_t* __restrict__ s,
          int32_t* __restrict__ d, long long w, FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  Fe x0 = fe_load(c0, w, i);
  Fe x1 = fe_load(c1, w, i);
  Fe t = fe_load(tw, w, i);
  fe_store(s, w, i, fe_add(x0, x1, c));
  fe_store(d, w, i, fe_mul(fe_sub(x0, x1, c), t, c));
}

// K7.  Replaces ops/pallas_mont.py:_jac_double_kernel (jac_double_n).
// Bound: operations -- 7 Montgomery products per doubling, 8 doublings per
// window step, against 384 bytes moved per point.  Design: the TPU
// launches one kernel per doubling; here one launch loops n_times with the
// point in registers, so the stacked [48, W] array is read and written
// once.
__global__ void __launch_bounds__(kThreads)
k7_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
          long long w, int n_times, FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  Jac p = jac_load(in, w, i);
  for (int k = 0; k < n_times; ++k) p = jac_double(p, c);
  jac_store(out, w, i, p);
}

}  // namespace

extern "C" int k1_mont_mul(const void* a, const void* b, void* out, long long w,
                           const void* consts, void* stream) {
  if (w <= 0) return 0;
  k1_kernel<<<blocks_for(w, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)out, w,
      unpack_const(consts));
  return (int)cudaGetLastError();
}

extern "C" int k2_dif_butterfly(const void* c0, const void* c1, const void* tw,
                                void* s, void* d, long long w,
                                const void* consts, void* stream) {
  if (w <= 0) return 0;
  k2_kernel<<<blocks_for(w, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)c0, (const int32_t*)c1, (const int32_t*)tw, (int32_t*)s,
      (int32_t*)d, w, unpack_const(consts));
  return (int)cudaGetLastError();
}

extern "C" int k7_jac_double_n(const void* in, void* out, long long w,
                               int n_times, const void* consts, void* stream) {
  if (w <= 0) return 0;
  k7_kernel<<<blocks_for(w, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out, w, n_times, unpack_const(consts));
  return (int)cudaGetLastError();
}
