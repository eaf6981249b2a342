// The designs of K8a add and K8b that lost to csrc/mont.cu's, kept for
// scripts/sweep_k8.py to time beside it on the same operand views
// (g1.cuh Operand; the entry points take mont.cu's arguments):
//   * k8a_one_kernel: K8a add on one thread per add (jac_add_ptx), the
//     shape of the kernel before the thread pair;
//   * k8b_pair_kernel: K8b on a thread pair per add (jac_madd_core_pair,
//     the schedule of K6);
//   * k8a_staged_kernel, k8b_staged_kernel: one thread per add on a
//     persistent grid, each thread's next point copied into shared memory
//     by cp.async (two stages of its own limb rows, [stage][row][thread])
//     while it computes the current one.
// Build against the committed headers:
//   nvcc <flags of ops/cuda_lib.py> -I plonkathon_tpu_torch/csrc scripts/sweep_k8_variants.cu
#include "field.cuh"
#include "g1.cuh"

namespace {

constexpr int kOneThreads = 64;
constexpr int kOneMinBlocks = 8;
constexpr int kPairThreads = 128;
constexpr int kPairMinBlocks = 1;
constexpr int kStagedThreads = 64;
constexpr int kStagedMinBlocks = 4;

__global__ void __launch_bounds__(kOneThreads, kOneMinBlocks)
k8a_one_kernel(Operands<6> ops, int32_t* __restrict__ o, long long w, FieldConst c) {
  const long long i = (long long)blockIdx.x * kOneThreads + threadIdx.x;
  if (i >= w) return;
  jac_store(o, w, i, jac_add_ptx(jac_load_op(ops, 0, i), jac_load_op(ops, 3, i), c));
}

__global__ void __launch_bounds__(kPairThreads, kPairMinBlocks)
k8b_pair_kernel(Operands<5> ops, int32_t* __restrict__ o, long long w, FieldConst c) {
  const long long t = (long long)blockIdx.x * kPairThreads + threadIdx.x;
  const bool odd = t & 1;
  const long long i = min(t >> 1, w - 1);  // a pair past the end mirrors the last add
  Jac p = jac_load_op(ops, 0, i);
  Fe x2 = fe_load_op(ops.c[3], i);
  Fe y2 = fe_load_op(ops.c[4], i);
  Fe H, R;
  Jac r = jac_madd_core_pair(p, x2, y2, c, odd, 0xffffffffu, H, R);
  r = jac_madd_selects(r, p, x2, y2, H, R, c);
  if ((t >> 1) < w) jac_store_pair(o, w, i, r, odd);
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

// Copy the limb rows of element i of every operand into the thread's stage
// `st` (row r at st[r * kStagedThreads]) and commit them as one group.
template <int NC>
__device__ __forceinline__ void stage_point(uint32_t* st, const Operands<NC>& ops,
                                            long long i, long long w) {
  if (i < w) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int32_t* src = ops.c[c].p + i * ops.c[c].col;
#pragma unroll
      for (int k = 0; k < 16; ++k)
        cp_async4(st + (16 * c + k) * kStagedThreads, src + k * ops.c[c].limb);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ Fe fe_from_stage(const uint32_t* st, int row) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    r.w[k] = (st[(row + 2 * k) * kStagedThreads] & 0xFFFFu) |
             (st[(row + 2 * k + 1) * kStagedThreads] << 16);
  return r;
}

template <int NQ>
__device__ __forceinline__ void staged_adds(const Operands<3 + NQ>& ops, int32_t* o, long long w,
                                            const FieldConst& c) {
  constexpr int kRows = 16 * (3 + NQ);
  extern __shared__ uint32_t stages[];
  uint32_t* st = stages + threadIdx.x;  // stage s: st + s * kRows * kStagedThreads
  const long long step = (long long)gridDim.x * kStagedThreads;
  long long i = (long long)blockIdx.x * kStagedThreads + threadIdx.x;
  stage_point<3 + NQ>(st, ops, i, w);
  int s = 0;
#pragma unroll 1
  for (; i < w; i += step, s ^= 1) {
    // Refill the stage read in the previous round, then wait for this one.
    stage_point<3 + NQ>(st + (s ^ 1) * kRows * kStagedThreads, ops, i + step, w);
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    const uint32_t* cur = st + s * kRows * kStagedThreads;
    Jac p, q;
    p.x = fe_from_stage(cur, 0);
    p.y = fe_from_stage(cur, 16);
    p.z = fe_from_stage(cur, 32);
    q.x = fe_from_stage(cur, 48);
    q.y = fe_from_stage(cur, 64);
    if constexpr (NQ == 3) {
      q.z = fe_from_stage(cur, 80);
      jac_store(o, w, i, jac_add_ptx(p, q, c));
    } else {
      jac_store(o, w, i, jac_madd_ptx(p, q.x, q.y, c));
    }
  }
}

__global__ void __launch_bounds__(kStagedThreads, kStagedMinBlocks)
k8a_staged_kernel(Operands<6> ops, int32_t* __restrict__ o, long long w, FieldConst c) {
  staged_adds<3>(ops, o, w, c);
}

__global__ void __launch_bounds__(kStagedThreads, kStagedMinBlocks)
k8b_staged_kernel(Operands<5> ops, int32_t* __restrict__ o, long long w, FieldConst c) {
  staged_adds<2>(ops, o, w, c);
}

// kStagedMinBlocks blocks per SM, each with its two stages of shared memory.
template <int NC>
int staged_launch(void (*kernel)(Operands<NC>, int32_t*, long long, FieldConst),
                  const Operands<NC>& ops, void* out, long long w, const void* consts,
                  void* stream) {
  if (w <= 0) return 0;
  const int smem = 2 * 16 * NC * kStagedThreads * (int)sizeof(uint32_t);
  int dev = 0, sms = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  unsigned blocks = blocks_for(w, kStagedThreads);
  if ((long long)sms * kStagedMinBlocks < blocks) blocks = (unsigned)(sms * kStagedMinBlocks);
  kernel<<<blocks, kStagedThreads, smem, (cudaStream_t)stream>>>(ops, (int32_t*)out, w,
                                                                 unpack_const(consts));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int k8a_one(const void* x1, const void* y1, const void* z1, const void* x2,
                       const void* y2, const void* z2, const long long* strides, void* out,
                       long long w, const void* consts, void* stream) {
  if (w <= 0) return 0;
  const void* ptrs[6] = {x1, y1, z1, x2, y2, z2};
  k8a_one_kernel<<<blocks_for(w, kOneThreads), kOneThreads, 0, (cudaStream_t)stream>>>(
      make_operands<6>(ptrs, strides), (int32_t*)out, w, unpack_const(consts));
  return (int)cudaGetLastError();
}

extern "C" int k8b_pair(const void* x1, const void* y1, const void* z1, const void* x2,
                        const void* y2, const long long* strides, void* out, long long w,
                        const void* consts, void* stream) {
  if (w <= 0) return 0;
  const void* ptrs[5] = {x1, y1, z1, x2, y2};
  k8b_pair_kernel<<<blocks_for(2 * w, kPairThreads), kPairThreads, 0, (cudaStream_t)stream>>>(
      make_operands<5>(ptrs, strides), (int32_t*)out, w, unpack_const(consts));
  return (int)cudaGetLastError();
}

extern "C" int k8a_staged(const void* x1, const void* y1, const void* z1, const void* x2,
                          const void* y2, const void* z2, const long long* strides, void* out,
                          long long w, const void* consts, void* stream) {
  const void* ptrs[6] = {x1, y1, z1, x2, y2, z2};
  return staged_launch<6>(k8a_staged_kernel, make_operands<6>(ptrs, strides), out, w, consts,
                          stream);
}

extern "C" int k8b_staged(const void* x1, const void* y1, const void* z1, const void* x2,
                          const void* y2, const long long* strides, void* out, long long w,
                          const void* consts, void* stream) {
  const void* ptrs[5] = {x1, y1, z1, x2, y2};
  return staged_launch<5>(k8b_staged_kernel, make_operands<5>(ptrs, strides), out, w, consts,
                          stream);
}
