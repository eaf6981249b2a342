// Elementwise field and point kernels: K1 mont_mul, K2 dif_butterfly,
// K7 jac_double_n, K8a jac_add and Setup.generate's window sum, K8b
// jac_madd, K9 butterfly.  Plain C entry points for ctypes; each launches
// on the caller's stream, allocates nothing, and returns cudaGetLastError().
//
// Design, shared by all but the K8a add (a thread pair per add): one
// thread per element, 16-bit limbs repacked into 8 x 32-bit words at load
// (ops/limbs.py wire format, limb-major so each limb row is one coalesced
// load), CIOS Montgomery product with 64-bit partial products (field.cuh)
// -- except the point kernels K7, K8a and K8b, which run on field.cuh's
// carry-chain product and squaring.
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
// Bound: operations -- 2 Montgomery products and 5 squarings per doubling
// (2 * 264 + 5 * 208 = 1568 32-bit multiplies), 8 (msm2) or 16 (msm3)
// doublings per window step, against 384 bytes moved per point: 0.393 ms
// for 16 doublings of 2^18 points and 0.197 ms for 8 on an H100 (PERF.md).
// Design: the TPU launches one kernel per doubling; here one launch loops
// n_times with the point in registers, so the stacked [48, W] array is
// read and written once.  The doubling (g1.cuh jac_double_ptx) is inlined
// with no call frame, on the carry-chain products and squarings of
// field.cuh; threads per block come from ptxas's register count and a
// sweep at both path shapes (scripts/sweep_k3_k7.py, PERF.md).
constexpr int kK7Threads = 512;
constexpr int kK7MinBlocks = 1;

__global__ void __launch_bounds__(kK7Threads, kK7MinBlocks)
k7_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
          long long w, int n_times, FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  Jac p = jac_load(in, w, i);
#pragma unroll 1
  for (int k = 0; k < n_times; ++k) p = jac_double_ptx(p, c);
  jac_store(out, w, i, p);
}

// K8a, Setup.generate's window sum (the JAX package's jac_fold_sum of
// the window points, a level-by-level halving over _kern_add, which the
// port ran as five K8a launches over copied strided operands).  Input:
// Jacobian coordinates x, y, z, each int32 [16, W, n] (window-major: window
// k of point i at column k * n + i), W a power of two, 2 <= W <= 32; out
// [48, n] stacked, sum over the W windows of each point.  Bound:
// operations -- up to (W - 1) n adds of 12 products and 4 squarings (an add
// with an identity operand, from a digit 0, needs none): 1.95 ms for
// 31 x 2^18 adds on an H100, against 0.50 ms for the 1.61 GB read.
// Design: one thread per point walks its tree of W - 1 adds depth-first in
// ONE launch (windows 0 + 1, 2 + 3, then (0 + 1) + (2 + 3), ...), so each
// add has exactly the operands it has in the level order and the sum is
// jac_fold_sum's, word for word.  A left sibling waits in shared memory
// until its right sibling is done: at most one per level below the root
// (a binary counter), 4 x 96 bytes per thread, laid out [level][word]
// [thread] so a warp's accesses hit 32 banks.  The add is jac_add_ptx,
// one call site for leaves and carries; the window-major layout lets
// neighbouring threads read neighbouring words of every window.
constexpr int kWinThreads = 64;
constexpr int kWinMinBlocks = 8;
constexpr int kWinLevels = 4;  // pending sums; W <= 2^(kWinLevels + 1)

__device__ __forceinline__ void pend_store(uint32_t (*pend)[24][kWinThreads], int lvl,
                                           const Jac& p) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    pend[lvl][k][threadIdx.x] = p.x.w[k];
    pend[lvl][8 + k][threadIdx.x] = p.y.w[k];
    pend[lvl][16 + k][threadIdx.x] = p.z.w[k];
  }
}

__device__ __forceinline__ Jac pend_load(uint32_t (*pend)[24][kWinThreads], int lvl) {
  Jac p;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    p.x.w[k] = pend[lvl][k][threadIdx.x];
    p.y.w[k] = pend[lvl][8 + k][threadIdx.x];
    p.z.w[k] = pend[lvl][16 + k][threadIdx.x];
  }
  return p;
}

__global__ void __launch_bounds__(kWinThreads, kWinMinBlocks)
k8a_window_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                  const int32_t* __restrict__ z, int32_t* __restrict__ o,
                  long long n, int windows, FieldConst c) {
  __shared__ uint32_t pend[kWinLevels][24][kWinThreads];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long stride = windows * n;  // limb rows of [16, W, n]
  Jac acc;
  int leaf = 0;     // the next leaf pair: windows 2 leaf, 2 leaf + 1
  int lvl = 0;      // the level of the sum in acc (0: a leaf pair's)
  bool carry = false;
#pragma unroll 1
  for (int k = 0; k < windows - 1; ++k) {
    Jac p, q;
    if (carry) {  // acc is a right sibling; its left one waits at lvl
      p = pend_load(pend, lvl);
      q = acc;
      ++lvl;
    } else {
      const long long a = 2 * leaf * n + i;
      p.x = fe_load(x, stride, a);
      p.y = fe_load(y, stride, a);
      p.z = fe_load(z, stride, a);
      q.x = fe_load(x, stride, a + n);
      q.y = fe_load(y, stride, a + n);
      q.z = fe_load(z, stride, a + n);
      lvl = 0;
    }
    acc = jac_add_ptx(p, q, c);
    carry = (leaf >> lvl) & 1;  // the sum at lvl is a right child
    if (!carry) {
      if (k + 1 < windows - 1) pend_store(pend, lvl, acc);
      ++leaf;
    }
  }
  jac_store(o, n, i, acc);
}

// ---------------------------------------------------------------------------
// K8a add and K8b: elementwise complete adds.
//
// K8a add replaces ops/pallas_mont.py:445 _jac_add_kernel (jac_add):
// Jacobian + Jacobian (_kern_add).  K8b replaces ops/pallas_mont.py:454
// _jac_madd_kernel (jac_madd): Jacobian + affine (_kern_madd; q never the
// identity).  Operands: one pointer per coordinate, [16, W] int32 limbs,
// each with its own limb stride and a column stride of 1, or 0 for a
// coordinate broadcast from [16, 1] (g1.cuh Operand), so the wrapper hands
// its views over without a copy; the output is stacked [48, W].
// Bound: operations.  K8a add: 12 products and 4 squarings (4000 32-bit
// multiplies) per 576 bytes, 0.251 ms at W = 2^20 on an H100 against 0.180
// ms for the bytes; K8b: 8 and 3 (2736) per 512 bytes, 0.172 against 0.160
// ms.  What holds both back is the latency of the dependent products: an
// add's operands and temporaries fill 128 registers, so few warps share an
// SM to hide it.
// Design (scripts/sweep_k8.py, PERF.md): both on the carry chains with no
// call frame, the doubling out of line, at 256 threads x 2 blocks per SM
// (128 registers; the K8a add spills 16 bytes), which beat every other
// block size at the same 16 warps by 11-17%.  K8b runs one thread per add
// (jac_madd_ptx), the K8a add a thread pair per add (jac_add_pair: each
// thread 8 of the 16 products in sequence), each the faster of the two
// schedules for its add.  Staging each thread's next point in shared
// memory by cp.async was slower for both (scripts/sweep_k8_variants.cu):
// two stages of a thread's limb rows leave room for 8-10 warps per SM.
// ---------------------------------------------------------------------------
constexpr int kK8aThreads = 256;  // 128 adds
constexpr int kK8aMinBlocks = 2;
constexpr int kK8bThreads = 256;
constexpr int kK8bMinBlocks = 2;

// Threads 2i and 2i + 1 share add i; every lane of a warp reaches the
// pair's shuffles, so a pair past the end mirrors the last add and stores
// nothing.
__global__ void __launch_bounds__(kK8aThreads, kK8aMinBlocks)
k8a_kernel(Operands<6> ops, int32_t* __restrict__ o, long long w, FieldConst c) {
  const long long t = (long long)blockIdx.x * kK8aThreads + threadIdx.x;
  const bool odd = t & 1;
  const long long i = min(t >> 1, w - 1);
  Jac r = jac_add_pair(jac_load_op(ops, 0, i), jac_load_op(ops, 3, i), c, odd, 0xffffffffu);
  if ((t >> 1) < w) jac_store_pair(o, w, i, r, odd);
}

__global__ void __launch_bounds__(kK8bThreads, kK8bMinBlocks)
k8b_kernel(Operands<5> ops, int32_t* __restrict__ o, long long w, FieldConst c) {
  const long long i = (long long)blockIdx.x * kK8bThreads + threadIdx.x;
  if (i >= w) return;
  jac_store(o, w, i, jac_madd_ptx(jac_load_op(ops, 0, i), fe_load_op(ops.c[3], i),
                                  fe_load_op(ops.c[4], i), c));
}

// K9.  Replaces ops/pallas_mont.py:_butterfly_kernel (butterfly): the
// decimation-in-time butterfly (e, o, t) -> (e + o*t, e - o*t) in Fr.
// Bound: bytes, like K2 (one Montgomery product per 320 bytes moved).
__global__ void __launch_bounds__(kThreads)
k9_kernel(const int32_t* __restrict__ e, const int32_t* __restrict__ o,
          const int32_t* __restrict__ t, int32_t* __restrict__ lo,
          int32_t* __restrict__ hi, long long w, FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  Fe x = fe_load(e, w, i);
  Fe prod = fe_mul(fe_load(o, w, i), fe_load(t, w, i), c);
  fe_store(lo, w, i, fe_add(x, prod, c));
  fe_store(hi, w, i, fe_sub(x, prod, c));
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
  k7_kernel<<<blocks_for(w, kK7Threads), kK7Threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out, w, n_times, unpack_const(consts));
  return (int)cudaGetLastError();
}

// x, y, z: int32 [16, windows, n] each; out: int32 [48, n].  Eight blocks
// of 24.6 KB of pending sums per SM need the largest shared-memory carveout.
extern "C" int k8a_window_sum(const void* x, const void* y, const void* z, void* out,
                              long long n, int windows, const void* consts,
                              void* stream) {
  if (windows < 2 || windows > (2 << kWinLevels) || (windows & (windows - 1)))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      k8a_window_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  k8a_window_kernel<<<blocks_for(n, kWinThreads), kWinThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (int32_t*)out, n, windows,
      unpack_const(consts));
  return (int)cudaGetLastError();
}

// p = (x1, y1, z1) and q = (x2, y2[, z2]): int32 [16, w] limbs each, with
// strides: a host int64 (limb, column) pair per operand, in that order;
// out: int32 [48, w].
extern "C" int k8a_jac_add(const void* x1, const void* y1, const void* z1, const void* x2,
                           const void* y2, const void* z2, const long long* strides,
                           void* out, long long w, const void* consts, void* stream) {
  if (w <= 0) return 0;
  const void* ptrs[6] = {x1, y1, z1, x2, y2, z2};
  k8a_kernel<<<blocks_for(2 * w, kK8aThreads), kK8aThreads, 0, (cudaStream_t)stream>>>(
      make_operands<6>(ptrs, strides), (int32_t*)out, w, unpack_const(consts));
  return (int)cudaGetLastError();
}

extern "C" int k8b_jac_madd(const void* x1, const void* y1, const void* z1, const void* x2,
                            const void* y2, const long long* strides, void* out, long long w,
                            const void* consts, void* stream) {
  if (w <= 0) return 0;
  const void* ptrs[5] = {x1, y1, z1, x2, y2};
  k8b_kernel<<<blocks_for(w, kK8bThreads), kK8bThreads, 0, (cudaStream_t)stream>>>(
      make_operands<5>(ptrs, strides), (int32_t*)out, w, unpack_const(consts));
  return (int)cudaGetLastError();
}

extern "C" int k9_butterfly(const void* e, const void* o, const void* t,
                            void* lo, void* hi, long long w, const void* consts,
                            void* stream) {
  if (w <= 0) return 0;
  k9_kernel<<<blocks_for(w, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)e, (const int32_t*)o, (const int32_t*)t, (int32_t*)lo,
      (int32_t*)hi, w, unpack_const(consts));
  return (int)cudaGetLastError();
}
