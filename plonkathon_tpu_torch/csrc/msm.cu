// Fixed-base MSM kernels: K5 jadd_stacked and the msm3 suffix fold, and
// K6 run_scan.  Plain C entry points for ctypes; each launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
#include <cooperative_groups.h>

#include "field.cuh"
#include "g1.cuh"

namespace cg = cooperative_groups;

namespace {

// K5.  Replaces ops/msm2.py:_jadd_stacked_kernel (jadd_stacked): complete
// Jacobian + Jacobian on stacked [48, W] points (pallas_mont._kern_add).
// Bound: operations -- 12 Montgomery products and 4 squarings (4000
// 32-bit multiplies) per 576 bytes moved.  Design: one thread per point,
// the add inlined on the carry chains (jac_add_ptx) with its intermediates
// in registers; the doubling branch is an out-of-line call taken only on
// the rare lanes where p == q.  Threads per block and the minimum blocks
// per SM come from a sweep at the msm2 fallback's widest chunk-fold level,
// 2^21 lanes (scripts/sweep_k4_k5.py, PERF.md): at 255 registers the card
// holds 8 warps per SM; 8 blocks of 64 threads cap it at 128 registers
// (an 8-byte spill) and give 16 warps to hide the carry chains' latency.
constexpr int kAddThreads = 64;
constexpr int kAddMinBlocks = 8;

__global__ void __launch_bounds__(kAddThreads, kAddMinBlocks)
k5_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
          int32_t* __restrict__ o, long long w, FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  jac_store(o, w, i, jac_add_ptx(jac_load(a, w, i), jac_load(b, w, i), c));
}

// K5, the whole msm3 suffix fold in one launch.  Replaces the 46 K5 calls
// of ops/msm3.py:_blelloch_suffix_fold (the JAX package's
// msm3._blelloch_suffix_fold over msm2.jadd_stacked): sum_b b * B_b for
// dense [48, W] (index i holds bucket b = i + 1), W a power of two.  With
// a = dense reversed (a[j] = dense[W - 1 - j]; the flips are index
// arithmetic), the levels run pair for pair, operands in the same order:
//   up-sweep    lev_k[i] = add(lev_{k-1}[2i], lev_{k-1}[2i + 1]), lev_0 = a,
//               k = 1 .. L - 1 (L = log2 W; the root, which nothing
//               reads, is not computed);
//   down-sweep  ex_1 = identity; ex_2m[2i] = ex_m[i],
//               ex_2m[2i + 1] = add(ex_m[i], lev[2i]) for widths 2m <= W/2;
//   inclusive   x = add(ex[i], a[2i]) and add(x, a[2i + 1]): the last
//               down-sweep level's add IS the inclusive add at 2i, so
//               one add's threads compute both inclusive sums of 2i, 2i + 1;
//   fold        f = the inclusive sums reversed, f[i] = add(f[i], f[i + h])
//               for h = W/2 .. 1 (msm2._fold_stacked), f[0] the result.
// Each add is the complete add (jac_add_pair), so every word equals the plain
// route's.  Scratch: up holds lev_k at columns [W/2^k, W/2^(k-1)) and
// later f at [0, W); ex holds ex_m at [m, 2m); both [48, W], stacked.
// Bound: operations -- 3.5 W - 4 adds of 16 products (0.03 ms at W = 2^15
// on an H100).  What bounds it in practice is latency: 3L dependent adds,
// most levels a few lanes wide.  Design: one cooperative launch instead of
// 46 launches and ~30 torch ops; each add shared by a thread pair
// (jac_add_pair: 8 products in sequence each instead of 16); levels of
// more adds than a block has pairs spread over the grid with a grid
// barrier after each, narrower levels run in block 0 with __syncthreads()
// only (128 threads per block won the sweep, PERF.md); the scratch
// (12.6 MB at 2^15) stays in L2.
constexpr int kFoldThreads = 128;

enum FoldKind { kUp, kDown, kLast, kFold };

__global__ void __launch_bounds__(kFoldThreads, 1)
k5_fold_kernel(const int32_t* __restrict__ dense, int32_t* up, int32_t* ex,
               int32_t* out, long long w, int levels_log2, FieldConst c) {
  cg::grid_group grid = cg::this_grid();
  const int L = levels_log2;
  const unsigned full = 0xffffffffu;
  const bool odd = threadIdx.x & 1;
  const long long pairs = (long long)gridDim.x * blockDim.x / 2;
  const long long pair = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 2;
  const long long block_pairs = blockDim.x / 2;
  bool last_wide = true;
#pragma unroll 1
  for (int lv = 0; lv < 3 * L - 1; ++lv) {
    FoldKind kind;
    long long n;  // adds (thread pairs) of this level
    if (lv < L - 1) {
      kind = kUp;
      n = w >> (lv + 1);
    } else if (lv < 2 * L - 2) {
      kind = kDown;
      n = 1LL << (lv - (L - 1));
    } else if (lv == 2 * L - 2) {
      kind = kLast;
      n = w / 2;
    } else {
      kind = kFold;
      n = w >> (lv - (2 * L - 2));
    }
    const bool wide = n > block_pairs;
    if (wide && !last_wide) grid.sync();
    last_wide = wide;
    if (wide || blockIdx.x == 0) {
      const long long first = wide ? pair : threadIdx.x / 2;
      const long long stride = wide ? pairs : block_pairs;
#pragma unroll 1
      for (long long i = first; __any_sync(full, i < n); i += stride) {
        const bool on = i < n;
        const unsigned act = __ballot_sync(full, on);
        if (!on) continue;
        Jac p, q;
        if (kind == kUp) {
          if (n == w / 2) {
            p = jac_load(dense, w, w - 1 - 2 * i);
            q = jac_load(dense, w, w - 2 - 2 * i);
          } else {
            p = jac_load(up, w, 2 * n + 2 * i);
            q = jac_load(up, w, 2 * n + 2 * i + 1);
          }
        } else if (kind == kFold) {
          p = jac_load(up, w, i);
          q = jac_load(up, w, i + n);
        } else {
          p = n == 1 ? jac_identity(c) : jac_load(ex, w, n + i);
          if (kind == kDown) {
            jac_store_pair(ex, w, 2 * n + 2 * i, p, odd);
            q = jac_load(up, w, 2 * n + 2 * i);
          } else {
            q = jac_load(dense, w, w - 1 - 2 * i);
          }
        }
        const int adds = kind == kLast ? 2 : 1;
#pragma unroll 1
        for (int r = 0; r < adds; ++r) {
          Jac s = jac_add_pair(p, q, c, odd, act);
          if (kind == kUp) {
            jac_store_pair(up, w, n + i, s, odd);
          } else if (kind == kDown) {
            jac_store_pair(ex, w, 2 * n + 2 * i + 1, s, odd);
          } else if (kind == kLast) {
            jac_store_pair(up, w, w - 1 - 2 * i - r, s, odd);
          } else if (n == 1) {
            jac_store_pair(out, 1, 0, s, odd);
          } else {
            jac_store_pair(up, w, i, s, odd);
          }
          if (r + 1 < adds) {  // kLast's second add: inc[2i] + a[2i + 1]
            p = s;
            q = jac_load(dense, w, w - 2 - 2 * i);
          }
        }
      }
    }
    if (wide) grid.sync();
    else __syncthreads();
  }
}

// K6.  Replaces ops/msm2.py:_scan_kernel (_scan_call): per-chunk sorted-run
// bucket accumulation.  Chunk lane ch walks its S sorted positions; at a
// step whose digit differs from the previous one the accumulator restarts
// at the identity, then a complete mixed add (_kern_madd) takes the step's
// affine base, and the running prefix is written after EVERY step.
// The TPU carries the accumulator across its sequential S grid steps in
// VMEM scratch; Hopper blocks run in no order, so here the threads of one
// chunk lane loop over the S steps themselves with the accumulator in
// registers.  Inputs are step-major ([S, C] digits, [S, 32, C] bases,
// [S, 48, C] prefixes), so neighbouring lanes touch neighbouring addresses
// at every step.  Bound: 328 bytes moved per step and, where the
// accumulator is not the identity, 8 Montgomery products and 3 squarings
// (2736 32-bit multiplies): on an H100 at the msm2 fallback's S 512 x
// C 2^14 the bytes take 0.82 ms and all the adds 1.37 ms; but at 2^14
// lanes one add per lane per step is a dependent chain and one thread per
// lane gives the card 4 warps per SM, so the chain's latency is the floor
// that counts (PERF.md).  Design for latency, as K4's merge scan:
// TWO threads per lane share each add (jac_madd_core_pair: 6 products in
// sequence each instead of 11, twice the warps), inlined with no call
// frame, the doubling out of line; step s + 1's digits and base are
// loaded before step s is computed; the pair stores its prefix together
// (jac_store_pair).  Both threads of a pair compute every step, and a tail
// pair past the last chunk mirrors it and stores nothing, so a warp's
// shuffles never diverge.  The threads per block come from a sweep at the
// fallback's shape (scripts/sweep_k6_k8a.py, PERF.md): at 151 registers a
// 256-thread block fills one SM's register file, so the 2^15 threads land
// as one block on each of 128 SMs; on an H100 that beat 64 and 128
// threads, 3.97 against 4.45-4.52 ms (smaller blocks may stack unevenly).
constexpr int kScanThreads = 256;
constexpr int kScanMinBlocks = 1;

__global__ void __launch_bounds__(kScanThreads, kScanMinBlocks)
k6_kernel(const int32_t* __restrict__ dig, const int32_t* __restrict__ prev,
          const int32_t* __restrict__ pts, int32_t* __restrict__ out,
          long long steps, long long chunks, FieldConst c) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool odd = t & 1;
  const bool in = (t >> 1) < chunks;
  const long long ch = in ? t >> 1 : chunks - 1;  // a tail pair mirrors the last lane
  const unsigned full = 0xffffffffu;
  Jac acc = jac_identity(c);
  bool fresh = dig[ch] != prev[ch];
  Fe x2 = fe_load(pts, chunks, ch);
  Fe y2 = fe_load(pts + 16 * chunks, chunks, ch);
#pragma unroll 1
  for (long long s = 0; s < steps; ++s) {
    bool fresh_next = false;
    Fe x2_next, y2_next;
    if (s + 1 < steps) {
      const int32_t* base = pts + (s + 1) * 32 * chunks;
      fresh_next = dig[(s + 1) * chunks + ch] != prev[(s + 1) * chunks + ch];
      x2_next = fe_load(base, chunks, ch);
      y2_next = fe_load(base + 16 * chunks, chunks, ch);
    }
    if (fresh) acc = jac_identity(c);
    Fe H, R;
    Jac r = jac_madd_core_pair(acc, x2, y2, c, odd, full, H, R);
    acc = jac_madd_selects(r, acc, x2, y2, H, R, c);
    if (in) jac_store_pair(out + s * 48 * chunks, chunks, ch, acc, odd);
    fresh = fresh_next;
    x2 = x2_next;
    y2 = y2_next;
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

// scratch: int32 [2, 48, w]; w a power of two >= 2.  The grid is no larger
// than the blocks that can be resident at once (a cooperative launch's
// condition) nor than the widest level needs.
extern "C" int k5_suffix_fold(const void* dense, void* scratch, void* out,
                              long long w, const void* consts, void* stream) {
  if (w < 2 || (w & (w - 1))) return (int)cudaErrorInvalidValue;
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k5_fold_kernel,
                                                        kFoldThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  long long need = blocks_for(w, kFoldThreads);  // a thread pair per add
  unsigned grid = (unsigned)(need < (long long)sms * per_sm ? need : (long long)sms * per_sm);
  const int32_t* d = (const int32_t*)dense;
  int32_t* up = (int32_t*)scratch;
  int32_t* ex = up + 48 * w;
  int32_t* o = (int32_t*)out;
  int levels = 0;
  while ((1LL << levels) < w) ++levels;
  FieldConst c = unpack_const(consts);
  void* args[] = {&d, &up, &ex, &o, &w, &levels, &c};
  err = cudaLaunchCooperativeKernel((const void*)k5_fold_kernel, grid, kFoldThreads, args,
                                    0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int k6_run_scan(const void* dig, const void* prev, const void* pts,
                           void* out, long long steps, long long chunks,
                           const void* consts, void* stream) {
  if (steps <= 0 || chunks <= 0) return 0;
  k6_kernel<<<blocks_for(2 * chunks, kScanThreads), kScanThreads, 0,
              (cudaStream_t)stream>>>((const int32_t*)dig, (const int32_t*)prev,
                                      (const int32_t*)pts, (int32_t*)out, steps,
                                      chunks, unpack_const(consts));
  return (int)cudaGetLastError();
}
