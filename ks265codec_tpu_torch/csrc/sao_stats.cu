// K8 — per-CTB SAO statistics of a batch of planes.
//
// Replaces ks265codec_tpu/ops/saostats.py::sao_stats_plane_core (batched as
// in ops/wavefront.py::_fused_rows_core): for every CTB of every frame, the
// count and the sum of (source - reconstruction) of the samples in each
// edge-offset category (per EO class) and, when asked, in each of the 32
// bands (rec >> 3). A sample outside the picture (w x h) counts nowhere;
// an EO sample counts only when both of its neighbours lie in the picture.
//
// One thread block per (CTB, frame), frame on blockIdx.y. Threads stride
// over the CTB's samples and keep the EO bins in registers (the class loop
// is unrolled, so the bins never leave them); a warp sums its bins with
// shuffles and adds them into shared memory once. The 32 band bins go to
// shared memory with integer atomics. Integer sums are exact in any order.
//
// Bound: every sample is read once from each plane (and its neighbours
// again, from L1/L2), so the pass is bound by bytes at 2 bytes per sample;
// the classification is about 15 integer instructions per sample and class.
#include "common.cuh"

namespace {

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int CLASSES>
__global__ void sao_stats_kernel(const uint8_t* rec, const uint8_t* src,
                                 int H, int W, int w, int h, int cs, int bo,
                                 int* eo_cnt, int* eo_err, int* bo_cnt,
                                 int* bo_err) {
  __shared__ int s_eo[2][CLASSES][5];
  __shared__ int s_bo[2][32];
  const int nctx = W / cs, ncty = H / cs;
  const int cy = blockIdx.x / nctx, cx = blockIdx.x % nctx;
  const int f = blockIdx.y;
  for (int i = threadIdx.x; i < 2 * CLASSES * 5; i += blockDim.x)
    (&s_eo[0][0][0])[i] = 0;
  for (int i = threadIdx.x; i < 64; i += blockDim.x) (&s_bo[0][0])[i] = 0;
  __syncthreads();
  const uint8_t* r = rec + (size_t)f * H * W;
  const uint8_t* s = src + (size_t)f * H * W;
  int cnt[CLASSES][5], err[CLASSES][5];
#pragma unroll
  for (int k = 0; k < CLASSES; k++)
#pragma unroll
    for (int c = 0; c < 5; c++) cnt[k][c] = err[k][c] = 0;
  for (int p = threadIdx.x; p < cs * cs; p += blockDim.x) {
    const int y = cy * cs + p / cs, x = cx * cs + p % cs;
    if (y >= h || x >= w) continue;
    const int v = r[y * W + x];
    const int d = (int)s[y * W + x] - v;
#pragma unroll
    for (int k = 0; k < CLASSES; k++) {
      const int ay = y + ks_eo_offs[k][0], ax = x + ks_eo_offs[k][1];
      const int by = y + ks_eo_offs[k][2], bx = x + ks_eo_offs[k][3];
      if (ay < 0 || ay >= h || ax < 0 || ax >= w || by < 0 || by >= h ||
          bx < 0 || bx >= w)
        continue;
      const int cat =
          2 + ks_sgn(v - r[ay * W + ax]) + ks_sgn(v - r[by * W + bx]);
#pragma unroll
      for (int c = 0; c < 5; c++)
        if (cat == c) {
          cnt[k][c] += 1;
          err[k][c] += d;
        }
    }
    if (bo) {
      atomicAdd(&s_bo[0][v >> 3], 1);
      atomicAdd(&s_bo[1][v >> 3], d);
    }
  }
#pragma unroll
  for (int k = 0; k < CLASSES; k++)
#pragma unroll
    for (int c = 0; c < 5; c++) {
      const int a = warp_sum(cnt[k][c]), e = warp_sum(err[k][c]);
      if ((threadIdx.x & 31) == 0) {
        atomicAdd(&s_eo[0][k][c], a);
        atomicAdd(&s_eo[1][k][c], e);
      }
    }
  __syncthreads();
  const size_t plane = (size_t)ncty * nctx, at = (size_t)cy * nctx + cx;
  for (int i = threadIdx.x; i < CLASSES * 5; i += blockDim.x) {
    const size_t o = ((size_t)f * CLASSES * 5 + i) * plane + at;
    eo_cnt[o] = (&s_eo[0][0][0])[i];
    eo_err[o] = (&s_eo[1][0][0])[i];
  }
  if (bo)
    for (int i = threadIdx.x; i < 32; i += blockDim.x) {
      const size_t o = ((size_t)f * 32 + i) * plane + at;
      bo_cnt[o] = s_bo[0][i];
      bo_err[o] = s_bo[1][i];
    }
}

}  // namespace

// rec/src: (F, H, W) uint8; eo_*: (F, classes, 5, H/cs, W/cs) int32;
// bo_*: (F, 32, H/cs, W/cs) int32, unused when bo == 0. classes: 2 or 4.
extern "C" int ks_sao_stats(const void* rec, const void* src, void* eo_cnt,
                            void* eo_err, void* bo_cnt, void* bo_err, int F,
                            int H, int W, int w, int h, int cs, int classes,
                            int bo, void* stream) {
  if (F <= 0 || H <= 0 || W <= 0) return 0;
  if (classes != 2 && classes != 4) return (int)cudaErrorInvalidValue;
  const dim3 grid((H / cs) * (W / cs), F);
  const cudaStream_t st = (cudaStream_t)stream;
  if (classes == 2)
    sao_stats_kernel<2><<<grid, 256, 0, st>>>(
        (const uint8_t*)rec, (const uint8_t*)src, H, W, w, h, cs, bo,
        (int*)eo_cnt, (int*)eo_err, (int*)bo_cnt, (int*)bo_err);
  else
    sao_stats_kernel<4><<<grid, 256, 0, st>>>(
        (const uint8_t*)rec, (const uint8_t*)src, H, W, w, h, cs, bo,
        (int*)eo_cnt, (int*)eo_err, (int*)bo_cnt, (int*)bo_err);
  return (int)cudaGetLastError();
}
