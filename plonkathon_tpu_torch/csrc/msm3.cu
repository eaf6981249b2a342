// msm3 kernels: K3 madd_packed and K4 jadd_packed, the packed incomplete
// adds of the 16-bit-window MSM pipeline (ops/msm3.py).  Plain C entry
// points for ctypes; each launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError().
//
// Both take a `steps` count: one thread owns one lane, keeps the
// accumulator in registers over the steps and writes the prefix after
// EVERY step (as K6 does), because Hopper blocks run in no order and
// cannot carry an accumulator from one launch's grid step to the next the
// way the TPU's sequential scan does.  With steps = 1 an entry point is
// exactly one application of the TPU kernel body.  Arrays are step-major
// ([S, rows, W]), so neighbouring threads touch neighbouring addresses at
// every step.  The packed rows (two 16-bit limbs per 32-bit word) are the
// 8-word Fe of field.cuh, loaded and stored with no repacking.
#include "field.cuh"
#include "g1_packed.cuh"

namespace {

constexpr int kIncThreads = 128;

// K3.  Replaces ops/msm3.py:_madd_packed_kernel (_inc_call("madd")):
// incomplete Jacobian += affine.  Mask bit 0 restarts the lane at q, bit 1
// negates q.y first (0 - y in the lazy domain, i.e. 2p - y).
// Bound: operations -- 11 Montgomery products (2904 32-bit multiplies) per
// step against 164 bytes moved per step (64 point + 4 mask read, 96
// prefix written).  The S dependent adds per lane make it latency bound
// when W is small; the plan (ops/msm3.py plan_params) keeps W wide.
__global__ void __launch_bounds__(kIncThreads)
k3_kernel(const int32_t* __restrict__ acc0, const int32_t* __restrict__ pts,
          const int32_t* __restrict__ mask, int32_t* __restrict__ out,
          long long steps, long long w, FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  Jac acc = jac_load_packed(acc0, w, i);
  for (long long s = 0; s < steps; ++s) {
    int32_t m = mask[s * w + i];
    const int32_t* base = pts + s * 16 * w;
    Fe x2 = fe_load_packed(base, w, i);
    Fe y2 = fe_load_packed(base + 8 * w, w, i);
    if (m & 2) y2 = fe_sub(fe_zero(), y2, c);
    acc = jac_madd_inc(acc, x2, y2, (m & 1) != 0, c);
    jac_store_packed(out + s * 24 * w, w, i, acc);
  }
}

// K4.  Replaces ops/msm3.py:_jadd_packed_kernel (_inc_call("jadd")):
// incomplete Jacobian += Jacobian.  Mask bit 0 restarts the lane at q,
// bit 2 keeps the accumulator as it was (a dead lane; it wins over bit 0).
// Bound: operations -- 16 Montgomery products (4224 32-bit multiplies) per
// step against 196 bytes moved per step.
__global__ void __launch_bounds__(kIncThreads)
k4_kernel(const int32_t* __restrict__ acc0, const int32_t* __restrict__ pts,
          const int32_t* __restrict__ mask, int32_t* __restrict__ out,
          long long steps, long long w, FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  Jac acc = jac_load_packed(acc0, w, i);
  for (long long s = 0; s < steps; ++s) {
    int32_t m = mask[s * w + i];
    if (!(m & 4)) {
      Jac q = jac_load_packed(pts + s * 24 * w, w, i);
      acc = jac_add_inc(acc, q, (m & 1) != 0, c);
    }
    jac_store_packed(out + s * 24 * w, w, i, acc);
  }
}

}  // namespace

extern "C" int k3_madd_packed(const void* acc, const void* pts, const void* mask,
                              void* out, long long steps, long long w,
                              const void* consts, void* stream) {
  if (steps <= 0 || w <= 0) return 0;
  k3_kernel<<<blocks_for(w, kIncThreads), kIncThreads, 0,
              (cudaStream_t)stream>>>((const int32_t*)acc, (const int32_t*)pts,
                                      (const int32_t*)mask, (int32_t*)out, steps,
                                      w, unpack_const(consts));
  return (int)cudaGetLastError();
}

extern "C" int k4_jadd_packed(const void* acc, const void* pts, const void* mask,
                              void* out, long long steps, long long w,
                              const void* consts, void* stream) {
  if (steps <= 0 || w <= 0) return 0;
  k4_kernel<<<blocks_for(w, kIncThreads), kIncThreads, 0,
              (cudaStream_t)stream>>>((const int32_t*)acc, (const int32_t*)pts,
                                      (const int32_t*)mask, (int32_t*)out, steps,
                                      w, unpack_const(consts));
  return (int)cudaGetLastError();
}
