// K20 — the dense SAD grid of the sequential host walk's motion search,
// replacing ks265codec_tpu/ops/me.py::full_search_grid:
//   sad[n, dy, dx] = sum_{i, j < bs} |win[n, dy + i, dx + j] - src[n, i, j]|
// for every block n and every offset (dy, dx) in (2 sr + 1)^2, from the
// block (N, bs, bs) and its window (N, bs + 2 sr, bs + 2 sr), int32 in and
// out. The walk calls it at bs 4 / 8 / 16 with sr 3 or 16.
//
// One thread block per block: the window and the block go to shared
// memory once, then one thread per offset (a loop where there are more
// offsets than threads) sums its bs x bs absolute differences. Threads of
// a warp take neighbouring dx, so their window reads are neighbouring
// words and the block's reads a broadcast.
//
// Bound: bs^2 (2 sr + 1)^2 x 3 integer operations (subtract, absolute
// value, add) per block against 4 (bs^2 + (bs + 2 sr)^2 + (2 sr + 1)^2)
// bytes of traffic: at sr 16 operations bound it, at sr 3 the bytes.
#include "common.cuh"

namespace {

__global__ void full_grid_kernel(const int* src, const int* win, int* out,
                                 int bs, int sr) {
  extern __shared__ int sh[];
  const int ww = bs + 2 * sr, n = 2 * sr + 1;
  int* w = sh;
  int* s = sh + ww * ww;
  const size_t b = blockIdx.x;
  for (int i = threadIdx.x; i < ww * ww; i += blockDim.x)
    w[i] = win[b * ww * ww + i];
  for (int i = threadIdx.x; i < bs * bs; i += blockDim.x)
    s[i] = src[b * bs * bs + i];
  __syncthreads();
  for (int o = threadIdx.x; o < n * n; o += blockDim.x) {
    const int dy = o / n, dx = o % n;
    int sad = 0;
    for (int i = 0; i < bs; i++) {
      const int* wr = w + (dy + i) * ww + dx;
      const int* sr_ = s + i * bs;
      for (int j = 0; j < bs; j++) sad += abs(wr[j] - sr_[j]);
    }
    out[b * n * n + o] = sad;
  }
}

}  // namespace

// src (N, bs, bs), win (N, bs + 2 sr, bs + 2 sr), out (N, 2 sr + 1,
// 2 sr + 1), all int32.
extern "C" int ks_me_full_grid(const void* src, const void* win, void* out,
                               int N, int bs, int sr, void* stream) {
  if (N <= 0) return 0;
  const int ww = bs + 2 * sr, n = 2 * sr + 1;
  const int threads = n * n >= 256 ? 256 : (n * n + 31) / 32 * 32;
  const size_t smem = sizeof(int) * (size_t)(ww * ww + bs * bs);
  full_grid_kernel<<<N, threads, smem, (cudaStream_t)stream>>>(
      (const int*)src, (const int*)win, (int*)out, bs, sr);
  return (int)cudaGetLastError();
}
