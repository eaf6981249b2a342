// msm3 kernels: K3 madd_packed and K4 jadd_packed, the packed incomplete
// adds of the 16-bit-window MSM pipeline (ops/msm3.py), and K4's
// dense-bucket stage.  Plain C entry points for ctypes; each launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError().
//
// The two scans take a `steps` count: one thread owns one lane, keeps the
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
// Its caller is the merge scan, S 16 steps x 2^14 lanes on the headline
// path.  Bound: operations -- 12 Montgomery products and 4 squarings
// (12 * 264 + 4 * 208 = 4000 32-bit multiplies) per live step against 196
// bytes moved per step; at 2^14 lanes that throughput bound is out of
// reach: each step is one add that depends on the last, and one thread
// per lane gives the card 4 warps per SM.  Design for latency: TWO threads
// per lane share each add (jac_add_inc_pair: 8 products in sequence each
// instead of 16, twice the warps), inlined on the carry chains with no
// call frame; step s + 1's mask and point are loaded before step s is
// computed; 256 threads per block, one block on each of 128 SMs at the
// merge scan's 2^14 lanes, won the sweep (scripts/sweep_k4_k5.py,
// PERF.md) over smaller blocks spread over every SM.  Both
// threads of a pair compute every step, fresh and dead lanes included
// (their sums are discarded), so a warp's shuffles never diverge.
constexpr int kK4Threads = 256;

__global__ void __launch_bounds__(kK4Threads)
k4_kernel(const int32_t* __restrict__ acc0, const int32_t* __restrict__ pts,
          const int32_t* __restrict__ mask, int32_t* __restrict__ out,
          long long steps, long long w, FieldConst c) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool odd = t & 1;
  const bool in = (t >> 1) < w;
  const long long i = in ? t >> 1 : w - 1;  // a tail pair mirrors the last lane
  Jac acc = jac_load_packed(acc0, w, i);
  int32_t m = mask[i];
  Jac q = jac_load_packed(pts, w, i);
#pragma unroll 1
  for (long long s = 0; s < steps; ++s) {
    int32_t m_next = 0;
    Jac q_next;
    if (s + 1 < steps) {
      m_next = mask[(s + 1) * w + i];
      q_next = jac_load_packed(pts + (s + 1) * 24 * w, w, i);
    }
    Jac sum = jac_add_inc_pair(acc, q, c, odd, 0xffffffffu);
    if (!(m & 4)) acc = (m & 1) ? q : sum;
    if (in) jac_store_packed_pair(out + s * 24 * w, w, i, acc, odd);
    m = m_next;
    q = q_next;
  }
}

// K4's dense-bucket stage in one launch.  Replaces the J rounds of
// ops/msm3.py:_dense_buckets (the JAX package's _dense_buckets_pallas: a
// gather in XLA and one _jadd_packed_kernel call per round).  keys [T]
// ascending (bucket ids, _BIG tail), pts packed [24, T]; bucket b in 1..nb
// belongs to the thread pair 2(b - 1), 2(b - 1) + 1, which finds its
// entries [start, stop) by binary search (torch.searchsorted, left side),
// takes entry start fresh and adds the next min(stop - start, J) - 1
// entries with the incomplete add -- rounds whose entry is missing are
// dead lanes there and change nothing -- then writes the bucket sum as
// 16-bit limbs into dense [48, nb] (the identity where the bucket is
// empty).  The largest stop - start goes to *maxmult (zeroed by the
// caller) by a warp max and one atomicMax per warp.
// Bound: operations -- 16 products per add, one add per entry after a
// bucket's first (at most J - 1), against 96 bytes read per entry, T keys
// and 192 bytes written per bucket.  Design: the gather is each thread's
// own load, so the J rounds need no torch gather or where and no launch
// each; a pair shares each add as K4's scan does, the whole warp running
// as many rounds as its fullest bucket needs; the next entry is loaded
// before the current one is added; threads per block from the sweep.
constexpr int kDenseThreads = 256;

__device__ __forceinline__ long long lower_bound(const int32_t* keys, long long t,
                                                 int32_t v) {
  long long lo = 0, hi = t;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (keys[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kDenseThreads)
k4_dense_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ pts,
                int32_t* __restrict__ dense, int32_t* __restrict__ maxmult,
                long long t, long long nb, int rounds, FieldConst c) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool odd = tid & 1;
  const long long i = tid >> 1;
  long long start = 0, mult = 0;
  if (i < nb) {
    start = lower_bound(keys, t, (int32_t)(i + 1));
    mult = lower_bound(keys, t, (int32_t)(i + 2)) - start;
  }
  const unsigned full = 0xffffffffu;
  unsigned wmax = __reduce_max_sync(full, (unsigned)mult);
  if ((threadIdx.x & 31) == 0) atomicMax(maxmult, (int32_t)wmax);
  const long long n = mult < rounds ? mult : rounds;
  const long long wn = __reduce_max_sync(full, (unsigned)n);
  const long long last = t - 1;
  Jac acc = jac_identity(c);
  Jac q = jac_load_packed(pts, t, start < last ? start : last);
  if (n > 0) acc = q;
  if (wn > 1) q = jac_load_packed(pts, t, start + 1 < last ? start + 1 : last);
#pragma unroll 1
  for (long long j = 1; j < wn; ++j) {
    Jac q_next;
    if (j + 1 < wn) {
      long long k = start + j + 1;
      q_next = jac_load_packed(pts, t, k < last ? k : last);
    }
    Jac sum = jac_add_inc_pair(acc, q, c, odd, full);
    if (j < n) acc = sum;
    q = q_next;
  }
  if (i < nb) jac_store_pair(dense, nb, i, acc, odd);
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
  k4_kernel<<<blocks_for(2 * w, kK4Threads), kK4Threads, 0,
              (cudaStream_t)stream>>>((const int32_t*)acc, (const int32_t*)pts,
                                      (const int32_t*)mask, (int32_t*)out, steps,
                                      w, unpack_const(consts));
  return (int)cudaGetLastError();
}

extern "C" int k4_dense_buckets(const void* keys, const void* pts, void* dense,
                                void* maxmult, long long t, long long nb, int rounds,
                                const void* consts, void* stream) {
  if (t <= 0 || nb <= 0) return 0;
  k4_dense_kernel<<<blocks_for(2 * nb, kDenseThreads), kDenseThreads, 0,
                    (cudaStream_t)stream>>>((const int32_t*)keys, (const int32_t*)pts,
                                            (int32_t*)dense, (int32_t*)maxmult, t, nb,
                                            rounds, unpack_const(consts));
  return (int)cudaGetLastError();
}
