// K12 — lookahead features, replacing ks265codec_tpu/ops/lookahead.py
// (`downsample2x`, `_intra_cost`, `_inter_cost` via `_features_core`,
// `frame_features_batch`, `frame_features_first`).
//
// ks_la_downsample: one thread per half-resolution sample, the 2x2 box
// (sum + 2) >> 2.
// ks_la_features: one thread block per 8x8 block of a half plane (frame
// on blockIdx.z). The block and its 24x24 window of the previous half
// plane (edge-clamped: the reference pads by edge replication) sit in
// shared memory; thread t < 289 scores offset (t / 17 - 8, t % 17 - 8)
// and the block reduces the packed key sad * 512 + t to its minimum, which
// is the least SAD and, on ties, the first offset in raster order, as the
// reference's argmin. One warp scores the four intra modes. All sums are
// exact int32; the host casts the per-frame sums to float32 at the end.
//
// ks_la_var: one thread per 8x8 block of a half plane, the variance of
// `_block_stats` for adaptive quantisation: the integer sum gives the
// exact mean, then one float32 lane per row takes that row's squared
// deviations left to right as fused multiply-adds (`__fmaf_rn`) from 0,
// and the 8 lanes are summed by halving and scaled by 1/64 — the order
// the reference backend's vectorised loop takes (ops/lookahead.py).
//
// Bound: 289 offsets x 64 samples of |a - b| per block, about 4.2 M
// operations per 640x360 half frame against ~0.5 MB of traffic, so the
// features kernel is operations-bound; shared memory keeps every window
// read on chip. The variance reads each sample once (230 KB a 720p half
// frame) for about 3 operations a sample: bytes bound it.
#include "common.cuh"

namespace {

constexpr int kBs = 8, kSr = 8, kNsr = 2 * kSr + 1, kWin = kBs + 2 * kSr;

__global__ void la_down_kernel(const uint8_t* y, uint8_t* out, int H, int W) {
  const int h = H / 2, w = W / 2;
  const int f = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h * w) return;
  const int r = i / w, c = i % w;
  const uint8_t* p = y + (size_t)f * H * W + (size_t)(2 * r) * W + 2 * c;
  const int s = p[0] + p[1] + p[W] + p[W + 1];
  out[(size_t)f * h * w + i] = (uint8_t)((s + 2) >> 2);
}

__global__ void la_features_kernel(const uint8_t* curs, const uint8_t* prevs,
                                   int* maps, int F, int h, int w) {
  __shared__ int cur[kBs][kBs];
  __shared__ int win[kWin][kWin];
  __shared__ int trow[kBs], lcol[kBs];
  __shared__ int best;
  __shared__ int icost;
  const int nbx = w / kBs, nby = h / kBs;
  const int bx = blockIdx.x, by = blockIdx.y, f = blockIdx.z;
  const uint8_t* c = curs + (size_t)f * h * w;
  const uint8_t* p = prevs + (size_t)f * h * w;
  const int x0 = bx * kBs, y0 = by * kBs;
  for (int i = threadIdx.x; i < kWin * kWin; i += blockDim.x) {
    const int yy = ks_clip3(0, h - 1, y0 - kSr + i / kWin);
    const int xx = ks_clip3(0, w - 1, x0 - kSr + i % kWin);
    win[i / kWin][i % kWin] = p[(size_t)yy * w + xx];
  }
  for (int i = threadIdx.x; i < kBs * kBs; i += blockDim.x)
    cur[i / kBs][i % kBs] = c[(size_t)(y0 + i / kBs) * w + x0 + i % kBs];
  if (threadIdx.x < kBs) {
    const int k = threadIdx.x;
    trow[k] = c[(size_t)(y0 > 0 ? y0 - 1 : 0) * w + x0 + k];
    lcol[k] = c[(size_t)(y0 + k) * w + (x0 > 0 ? x0 - 1 : 0)];
  }
  if (threadIdx.x == 0) best = 0x7fffffff;
  __syncthreads();
  if (threadIdx.x < kNsr * kNsr) {
    const int t = threadIdx.x, dy = t / kNsr, dx = t % kNsr;
    int s = 0;
    for (int r = 0; r < kBs; r++)
      for (int q = 0; q < kBs; q++) s += abs(cur[r][q] - win[r + dy][q + dx]);
    atomicMin(&best, s * 512 + t);
  }
  if (threadIdx.x >= 320 && threadIdx.x < 352) {   // one warp: intra modes
    const int lane = threadIdx.x - 320;
    int st = 0, sl = 0;
    for (int k = 0; k < kBs; k++) { st += trow[k]; sl += lcol[k]; }
    const int dc = (st + sl + kBs) / (2 * kBs);
    int cd = 0, cv = 0, ch = 0, cp = 0;
    for (int i = lane; i < kBs * kBs; i += 32) {
      const int r = i / kBs, q = i % kBs, v = cur[r][q];
      cd += abs(v - dc);
      cv += abs(v - trow[q]);
      ch += abs(v - lcol[r]);
      cp += abs(v - (trow[q] + lcol[r]) / 2);
    }
    for (int o = 16; o > 0; o >>= 1) {
      cd += __shfl_down_sync(0xffffffffu, cd, o);
      cv += __shfl_down_sync(0xffffffffu, cv, o);
      ch += __shfl_down_sync(0xffffffffu, ch, o);
      cp += __shfl_down_sync(0xffffffffu, cp, o);
    }
    if (lane == 0) icost = min(min(cd, cv), min(ch, cp));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const size_t plane = (size_t)F * nby * nbx;
    const size_t o = ((size_t)f * nby + by) * nbx + bx;
    const int t = best & 511;
    maps[o] = icost;
    maps[plane + o] = best >> 9;
    maps[2 * plane + o] = t % kNsr - kSr;
    maps[3 * plane + o] = t / kNsr - kSr;
  }
}

__global__ void la_var_kernel(const uint8_t* curs, float* out, int F, int h,
                              int w) {
  const int nbx = w / kBs, nby = h / kBs, nb = nbx * nby;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= F * nb) return;
  const int f = i / nb, b = i % nb, by = b / nbx, bx = b % nbx;
  const uint8_t* p = curs + (size_t)f * h * w + (size_t)(by * kBs) * w +
                     bx * kBs;
  int s = 0;
  for (int r = 0; r < kBs; r++)
    for (int q = 0; q < kBs; q++) s += p[(size_t)r * w + q];
  const float mean = (float)s * 0.015625f;
  float lane[kBs];
  for (int r = 0; r < kBs; r++) {
    float acc = 0.f;
    for (int q = 0; q < kBs; q++) {
      const float d = (float)p[(size_t)r * w + q] - mean;
      acc = __fmaf_rn(d, d, acc);
    }
    lane[r] = acc;
  }
  for (int hh = kBs / 2; hh >= 1; hh >>= 1)
    for (int k = 0; k < hh; k++) lane[k] = lane[k] + lane[k + hh];
  out[i] = lane[0] * 0.015625f;
}

}  // namespace

extern "C" int ks_la_downsample(const void* y, void* out, int F, int H,
                                int W, void* stream) {
  if (F <= 0) return 0;
  const int n = (H / 2) * (W / 2);
  la_down_kernel<<<dim3((n + 255) / 256, F), 256, 0,
                   (cudaStream_t)stream>>>((const uint8_t*)y, (uint8_t*)out,
                                           H, W);
  return (int)cudaGetLastError();
}

// maps: (4, F, h/8, w/8) int32 = icost, pcost, dx, dy.
extern "C" int ks_la_features(const void* curs, const void* prevs, void* maps,
                              int F, int h, int w, void* stream) {
  if (F <= 0) return 0;
  la_features_kernel<<<dim3(w / kBs, h / kBs, F), 352, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)curs, (const uint8_t*)prevs, (int*)maps, F, h, w);
  return (int)cudaGetLastError();
}

// out: (F, h/8, w/8) float32.
extern "C" int ks_la_var(const void* curs, void* out, int F, int h, int w,
                         void* stream) {
  const int n = F * (h / kBs) * (w / kBs);
  if (n <= 0) return 0;
  la_var_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)curs, (float*)out, F, h, w);
  return (int)cudaGetLastError();
}
