// Fixed-base MSM kernels: K5 jadd_stacked and K6 run_scan.  Plain C entry
// points for ctypes; each launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError().
#include "field.cuh"
#include "g1.cuh"

namespace {

// K5.  Replaces ops/msm2.py:_jadd_stacked_kernel (jadd_stacked): complete
// Jacobian + Jacobian on stacked [48, W] points (pallas_mont._kern_add).
// Bound: operations -- 16 Montgomery products (4224 32-bit multiplies)
// per 576 bytes moved.  Design: one thread per point, all of the add's
// intermediates in registers; the doubling branch runs only on the rare
// lanes where p == q.
constexpr int kAddThreads = 128;

__global__ void __launch_bounds__(kAddThreads)
k5_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
          int32_t* __restrict__ o, long long w, FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  jac_store(o, w, i, jac_add(jac_load(a, w, i), jac_load(b, w, i), c));
}

// K6.  Replaces ops/msm2.py:_scan_kernel (_scan_call): per-chunk sorted-run
// bucket accumulation.  Chunk lane ch walks its S sorted positions; at a
// step whose digit differs from the previous one the accumulator restarts
// at the identity, then a complete mixed add (_kern_madd) takes the step's
// affine base, and the running prefix is written after EVERY step.
// The TPU carries the accumulator across its sequential S grid steps in
// VMEM scratch; Hopper blocks run in no order, so here ONE thread owns one
// chunk lane and loops over the S steps itself with the accumulator in
// registers.  Inputs are step-major ([S, C] digits, [S, 32, C] bases,
// [S, 48, C] prefixes), so neighbouring threads touch neighbouring
// addresses at every step.  Bound: operations -- 11 Montgomery products
// (2904 32-bit multiplies) per step against 328 bytes moved per step; the
// chain of S dependent adds per lane also makes it latency bound when C is
// small, which is why the caller picks C large (ops/msm2.py
// _choose_chunks).
constexpr int kScanThreads = 64;

__global__ void __launch_bounds__(kScanThreads)
k6_kernel(const int32_t* __restrict__ dig, const int32_t* __restrict__ prev,
          const int32_t* __restrict__ pts, int32_t* __restrict__ out,
          long long steps, long long chunks, FieldConst c) {
  long long ch = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= chunks) return;
  Jac acc = jac_identity(c);
  for (long long s = 0; s < steps; ++s) {
    if (dig[s * chunks + ch] != prev[s * chunks + ch]) acc = jac_identity(c);
    const int32_t* base = pts + s * 32 * chunks;
    Fe x = fe_load(base, chunks, ch);
    Fe y = fe_load(base + 16 * chunks, chunks, ch);
    acc = jac_madd(acc, x, y, c);
    jac_store(out + s * 48 * chunks, chunks, ch, acc);
  }
}

}  // namespace

extern "C" int k5_jadd_stacked(const void* a, const void* b, void* out,
                               long long w, const void* consts, void* stream) {
  if (w <= 0) return 0;
  k5_kernel<<<blocks_for(w, kAddThreads), kAddThreads, 0,
              (cudaStream_t)stream>>>((const int32_t*)a, (const int32_t*)b,
                                      (int32_t*)out, w, unpack_const(consts));
  return (int)cudaGetLastError();
}

extern "C" int k6_run_scan(const void* dig, const void* prev, const void* pts,
                           void* out, long long steps, long long chunks,
                           const void* consts, void* stream) {
  if (steps <= 0 || chunks <= 0) return 0;
  k6_kernel<<<blocks_for(chunks, kScanThreads), kScanThreads, 0,
              (cudaStream_t)stream>>>((const int32_t*)dig, (const int32_t*)prev,
                                      (const int32_t*)pts, (int32_t*)out, steps,
                                      chunks, unpack_const(consts));
  return (int)cudaGetLastError();
}
