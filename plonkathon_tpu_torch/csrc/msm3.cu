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
constexpr int kK3Threads = 256;
constexpr int kK3MinBlocks = 1;

// K3.  Replaces ops/msm3.py:_madd_packed_kernel (_inc_call("madd")):
// incomplete Jacobian += affine.  Mask bit 0 restarts the lane at q, bit 1
// negates q.y first (0 - y in the lazy domain, i.e. 2p - y).
// Bound: operations -- 8 Montgomery products and 3 squarings per step,
// 8 * 264 + 3 * 208 = 2736 32-bit multiplies, against 164 bytes moved
// (64 point + 4 mask read, 96 prefix written): 0.686 ms at the headline
// scan (S 32 x C 2^17) on an H100 (PERF.md).
// Design: the card's limit here is the integer multiply-add pipe, so the
// step is written to keep it fed: the add (g1_packed.cuh) is inlined with
// the accumulator in registers and no call frame, its products and
// squarings are PTX carry chains (field.cuh), and step s + 1's point and
// mask are loaded before step s is computed.  Threads per block and the
// minimum blocks per SM come from ptxas's register count and a sweep at
// the headline shape (scripts/sweep_k3_k7.py, PERF.md).
__global__ void __launch_bounds__(kK3Threads, kK3MinBlocks)
k3_kernel(const int32_t* __restrict__ acc0, const int32_t* __restrict__ pts,
          const int32_t* __restrict__ mask, int32_t* __restrict__ out,
          long long steps, long long w, FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  Jac acc = jac_load_packed(acc0, w, i);
  int32_t m = mask[i];
  Fe x2 = fe_load_packed(pts, w, i);
  Fe y2 = fe_load_packed(pts + 8 * w, w, i);
#pragma unroll 1
  for (long long s = 0; s < steps; ++s) {
    int32_t m_next = 0;
    Fe x2_next, y2_next;
    if (s + 1 < steps) {
      const int32_t* base = pts + (s + 1) * 16 * w;
      m_next = mask[(s + 1) * w + i];
      x2_next = fe_load_packed(base, w, i);
      y2_next = fe_load_packed(base + 8 * w, w, i);
    }
    if (m & 2) y2 = fe_sub_ptx(fe_zero(), y2, c);
    acc = jac_madd_inc(acc, x2, y2, (m & 1) != 0, c);
    jac_store_packed(out + s * 24 * w, w, i, acc);
    m = m_next;
    x2 = x2_next;
    y2 = y2_next;
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
  k3_kernel<<<blocks_for(w, kK3Threads), kK3Threads, 0,
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
