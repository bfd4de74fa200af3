// K21 — quarter-pel refinement costs and the bi-prediction cost of the
// sequential host walk, replacing ks265codec_tpu/ops/subpel.py::
// subpel_costs (with `_interp_cand`) and, inside bi_pred_cost,
// interp14_by_phase with the bi average and its SATD.
//
// Both read per-block windows (N, bs + 10, bs + 10) int32, whose sample
// (5, 5) is the block's integer base, and the block's source (N, bs, bs)
// int32; bs is 8 or 16. The window goes to shared memory as 8-bit samples
// and the prediction is mc.cuh's `ks_mc_sample` on it with the window as
// the "picture" (its clamps never bind: every tap lies inside), so the
// filter, its 14-bit intermediates and the rounding are K14's. The SATD is
// common.cuh's `ks_satd8` per 8x8 tile, (s + 2) >> 2, summed.
//   ks_subpel_costs    the 49 candidates (dx, dy) in -3..3 (dx fastest) of
//                      `SUBPEL_CANDS`: one thread per (candidate, 8x8
//                      tile) predicts its tile with `ks_mc_uni` and takes
//                      its SATD; tiles add into the candidate's cost in
//                      shared memory (integer, so in any order); out
//                      (N, 49);
//   ks_subpel_bi_cost  one thread per sample predicts from both lists at
//                      the block's own phases (mv & 3; the windows are
//                      based at block + (mv >> 2)) and averages them
//                      (`ks_mc_bi`); one thread per 8x8 tile takes the
//                      SATD; out (N,). The reference builds all 16 phases
//                      and then selects one; this computes one.
//
// Bound: per block and candidate the separable filter (at most 8
// multiply-adds for each of (bs + 7) x bs horizontal and bs x bs vertical
// samples) and the Hadamard (about 6 operations a sample): about 1.1 G
// integer operations per 720p call at bs 16, far above its bytes, so
// operations bound it; the bi cost is 2/49 of that per block.
#include "mc.cuh"

namespace {

constexpr int kMargin = 5;
constexpr int kCands = 49;

__device__ __forceinline__ void load_window(const int* win, uint8_t* w,
                                            int ww, size_t b) {
  for (int i = threadIdx.x; i < ww * ww; i += blockDim.x)
    w[i] = (uint8_t)win[b * ww * ww + i];
}

__global__ void subpel_costs_kernel(const int* win, const int* src, int* out,
                                    int bs) {
  __shared__ uint8_t w[26 * 26];
  __shared__ int cost[kCands];
  const int ww = bs + 2 * kMargin, nt = bs / 8, tiles = nt * nt;
  const size_t b = blockIdx.x;
  load_window(win, w, ww, b);
  if (threadIdx.x < kCands) cost[threadIdx.x] = 0;
  __syncthreads();
  if (threadIdx.x < kCands * tiles) {
    const int c = threadIdx.x / tiles, t = threadIdx.x % tiles;
    const int qx = c % 7 - 3, qy = c / 7 - 3;
    const int ty = (t / nt) * 8, tx = (t % nt) * 8;
    const int* s = src + b * bs * bs;
    int d[64];
    for (int i = 0; i < 64; i++) {
      const int y = ty + i / 8, x = tx + i % 8;
      d[i] = s[y * bs + x] -
             ks_mc_uni(ks_mc_sample(w, ww, ww, ww, kMargin, kMargin, qx, qy,
                                    true, y, x));
    }
    atomicAdd(&cost[c], ks_satd8(d));
  }
  __syncthreads();
  if (threadIdx.x < kCands) out[b * kCands + threadIdx.x] = cost[threadIdx.x];
}

__global__ void bi_cost_kernel(const int* win0, const int* win1,
                               const int* mv0, const int* mv1,
                               const int* src, int* out, int bs) {
  __shared__ uint8_t w0[26 * 26], w1[26 * 26];
  __shared__ int d[256];
  __shared__ int total;
  const int ww = bs + 2 * kMargin, nt = bs / 8;
  const size_t b = blockIdx.x;
  load_window(win0, w0, ww, b);
  load_window(win1, w1, ww, b);
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  const int fx0 = mv0[2 * b] & 3, fy0 = mv0[2 * b + 1] & 3;
  const int fx1 = mv1[2 * b] & 3, fy1 = mv1[2 * b + 1] & 3;
  for (int i = threadIdx.x; i < bs * bs; i += blockDim.x) {
    const int y = i / bs, x = i % bs;
    const int p0 = ks_mc_sample(w0, ww, ww, ww, kMargin, kMargin, fx0, fy0,
                                true, y, x);
    const int p1 = ks_mc_sample(w1, ww, ww, ww, kMargin, kMargin, fx1, fy1,
                                true, y, x);
    d[i] = src[b * bs * bs + i] - ks_mc_bi(p0, p1);
  }
  __syncthreads();
  if (threadIdx.x < nt * nt) {
    const int ty = (threadIdx.x / nt) * 8, tx = (threadIdx.x % nt) * 8;
    int t[64];
    for (int i = 0; i < 64; i++) t[i] = d[(ty + i / 8) * bs + tx + i % 8];
    atomicAdd(&total, ks_satd8(t));
  }
  __syncthreads();
  if (threadIdx.x == 0) out[b] = total;
}

}  // namespace

// win (N, bs + 10, bs + 10), src (N, bs, bs), out (N, 49), int32; bs 8 or
// 16.
extern "C" int ks_subpel_costs(const void* win, const void* src, void* out,
                               int N, int bs, void* stream) {
  if (N <= 0) return 0;
  const int threads = bs == 16 ? 256 : 64;     // 49 x (bs / 8)^2 used
  subpel_costs_kernel<<<N, threads, 0, (cudaStream_t)stream>>>(
      (const int*)win, (const int*)src, (int*)out, bs);
  return (int)cudaGetLastError();
}

// win0 / win1 (N, bs + 10, bs + 10), mv0 / mv1 (N, 2) quarter-pel (x, y),
// src (N, bs, bs), out (N,), int32; bs 8 or 16.
extern "C" int ks_subpel_bi_cost(const void* win0, const void* win1,
                                 const void* mv0, const void* mv1,
                                 const void* src, void* out, int N, int bs,
                                 void* stream) {
  if (N <= 0) return 0;
  bi_cost_kernel<<<N, bs * bs, 0, (cudaStream_t)stream>>>(
      (const int*)win0, (const int*)win1, (const int*)mv0, (const int*)mv1,
      (const int*)src, (int*)out, bs);
  return (int)cudaGetLastError();
}
