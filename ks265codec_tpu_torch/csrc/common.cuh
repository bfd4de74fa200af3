// Shared device helpers of the port's kernels: table offsets, integer
// transforms/quantisation and intra prediction, written for one thread
// block working on one block of samples in shared memory.
//
// The tables arrive as one int32 tensor packed by
// ks265codec_tpu_torch/interop.py::tables_from_numpy; the offsets below
// must match interop.LAYOUT.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define T_DCT4 0
#define T_DCT8 16
#define T_DCT16 80
#define T_DCT32 336
#define T_QUANT 1360
#define T_LEVEL 1366
#define T_ANGLE 1372
#define T_INVANGLE 1405
#define T_BETA 1438
#define T_TC 1490
#define T_CHROMA_QP 1544

#define KS_MAX_N 32

static __device__ __forceinline__ int ks_clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

static __device__ __forceinline__ int ks_log2(int n) { return 31 - __clz(n); }

static __device__ __forceinline__ int ks_sgn(int v) {
  return (v > 0) - (v < 0);
}

// SAO edge-offset neighbours (dy_a, dx_a, dy_b, dx_b) of EO classes 0..3:
// horizontal, vertical, 135 and 45 degrees (spec 8.7.3, table 8-13).
static __constant__ int ks_eo_offs[4][4] = {
    {0, -1, 0, 1}, {-1, 0, 1, 0}, {-1, -1, 1, 1}, {-1, 1, 1, -1}};

static __device__ __forceinline__ const int* ks_dct(const int* tab, int n) {
  return tab + (n == 4 ? T_DCT4 : n == 8 ? T_DCT8 : n == 16 ? T_DCT16
                                                                : T_DCT32);
}

// Forward DCT with the HM staged shifts (bd = 8): coef = (T res T^t)
// scaled; res, tmp, coef are n*n shared arrays. Ends synchronised.
static __device__ void ks_fwd_dct(const int* tab, int n, const int* res, int* tmp,
                           int* coef) {
  const int* T = ks_dct(tab, n);
  const int log2 = ks_log2(n);
  const int s1 = log2 - 1, s2 = log2 + 6;
  for (int p = threadIdx.x; p < n * n; p += blockDim.x) {
    const int k = p / n, c = p % n;
    int acc = 0;
    for (int j = 0; j < n; j++) acc += T[k * n + j] * res[j * n + c];
    tmp[p] = (acc + (1 << (s1 - 1))) >> s1;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n * n; p += blockDim.x) {
    const int k = p / n, l = p % n;
    int acc = 0;
    for (int j = 0; j < n; j++) acc += tmp[k * n + j] * T[l * n + j];
    coef[p] = (acc + (1 << (s2 - 1))) >> s2;
  }
  __syncthreads();
}

// Deadzone quantisation of |c| (intra rounding 171/512): a level >= 0.
static __device__ __forceinline__ int ks_quant_abs(const int* tab, int a, int qp,
                                            int log2) {
  const int qbits = 29 + qp / 6 - 8 - log2;
  const int rnd = 171 << (qbits - 9);
  const int q = (a * tab[T_QUANT + qp % 6] + rnd) >> qbits;
  return q > 32767 ? 32767 : q;
}

// Spec 8.6.3 dequantisation, flat scaling matrix, clipped to 16 bits.
static __device__ __forceinline__ int ks_dequant(const int* tab, int lev, int qp,
                                          int log2) {
  const int s = 8 + log2 - 5, p = qp / 6;
  const int tv = lev * (16 * tab[T_LEVEL + qp % 6]);
  int d;
  if (s - p >= 1)
    d = (tv + (1 << (s - p - 1))) >> (s - p);
  else
    d = tv * (1 << (p - s));
  return ks_clip3(-32768, 32767, d);
}

// Spec 8.6.4.2 inverse transform of the dequantised block d (n*n shared)
// into residual r; tmp is scratch. Ends synchronised.
static __device__ void ks_inv_dct(const int* tab, int n, const int* d, int* tmp,
                           int* r) {
  const int* T = ks_dct(tab, n);
  for (int p = threadIdx.x; p < n * n; p += blockDim.x) {
    const int i = p / n, c = p % n;
    int acc = 0;
    for (int k = 0; k < n; k++) acc += T[k * n + i] * d[k * n + c];
    tmp[p] = ks_clip3(-32768, 32767, (acc + 64) >> 7);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n * n; p += blockDim.x) {
    const int i = p / n, j = p % n;
    int acc = 0;
    for (int k = 0; k < n; k++) acc += tmp[i * n + k] * T[k * n + j];
    r[p] = ks_clip3(-32768, 32767, (acc + 2048) >> 12);
  }
  __syncthreads();
}

// Mode-dependent reference filtering flag (spec 8.4.4.2.3).
static __device__ __forceinline__ bool ks_use_filtered(int mode, int n) {
  if (mode == 1 || n == 4) return false;
  if (mode == 0) return true;
  const int d26 = abs(mode - 26), d10 = abs(mode - 10);
  const int md = d26 < d10 ? d26 : d10;
  const int thr = n == 8 ? 7 : (n == 16 ? 1 : 0);
  return md > thr;
}

// Reference sample ref[k] of the angular main direction (spec
// 8.4.4.2.6), k in [(n*angle)>>5, 2n]. r: refs in the layout
// [left top->bottom (2n) | corner | top left->right (2n)].
static __device__ __forceinline__ int ks_ang_ref(const int* r, int n, bool ver,
                                          int k, int inv) {
  if (k >= 0) return ver ? r[2 * n + k] : (k == 0 ? r[2 * n] : r[k - 1]);
  int i = ((k * inv + 128) >> 8) - 1;
  if (i > 2 * n - 1) i = 2 * n - 1;
  return ver ? r[i] : r[2 * n + 1 + i];
}

// Intra prediction of sample (y, x) of an n x n block in `mode`. ru/rf:
// unfiltered / filtered refs (chroma passes ru twice); dc: the block's DC
// value from ru.
static __device__ int ks_pred_pixel(const int* tab, int mode, int n, bool luma,
                             const int* ru, const int* rf, int dc, int y,
                             int x) {
  const int n2 = 2 * n;
  if (mode == 0) {
    const int* r = (luma && n >= 8) ? rf : ru;
    const int sh = ks_log2(n) + 1;
    return ((n - 1 - x) * r[y] + (x + 1) * r[n2 + 1 + n] +
            (n - 1 - y) * r[n2 + 1 + x] + (y + 1) * r[n] + n) >> sh;
  }
  if (mode == 1) {
    if (luma && n < 32) {
      if (y == 0 && x == 0) return (ru[0] + 2 * dc + ru[n2 + 1] + 2) >> 2;
      if (y == 0) return (ru[n2 + 1 + x] + 3 * dc + 2) >> 2;
      if (x == 0) return (ru[y] + 3 * dc + 2) >> 2;
    }
    return dc;
  }
  if (luma && n < 32) {
    if (mode == 26 && x == 0)
      return ks_clip3(0, 255, ru[n2 + 1] + ((ru[y] - ru[n2]) >> 1));
    if (mode == 10 && y == 0)
      return ks_clip3(0, 255, ru[0] + ((ru[n2 + 1 + x] - ru[n2]) >> 1));
  }
  const int* r = (luma && ks_use_filtered(mode, n)) ? rf : ru;
  const int ang = tab[T_ANGLE + mode - 2];
  const int inv = tab[T_INVANGLE + mode - 2];
  const bool ver = mode >= 18;
  const int pos = ver ? y + 1 : x + 1;
  const int off = ver ? x : y;
  const int idx = (pos * ang) >> 5, fact = (pos * ang) & 31;
  const int a = ks_ang_ref(r, n, ver, off + idx + 1, inv);
  if (fact == 0) return a;
  const int b = ks_ang_ref(r, n, ver, off + idx + 2, inv);
  return ((32 - fact) * a + fact * b + 16) >> 5;
}

// DC value (spec 8.4.4.2.5) from unfiltered refs.
static __device__ __forceinline__ int ks_dc_value(const int* ru, int n) {
  int s = n;
  for (int i = 0; i < n; i++) s += ru[i] + ru[2 * n + 1 + i];
  return s >> (ks_log2(n) + 1);
}

// [1 2 1] smoothing of the refs contour (bottom-left .. top-right), in
// the refs layout: ru -> rf. All threads; ends synchronised.
static __device__ void ks_smooth_refs(const int* ru, int* rf, int n) {
  const int n2 = 2 * n, L = 4 * n + 1;
  // contour position i -> refs index
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    auto at = [&](int c) { return c < n2 ? ru[n2 - 1 - c] : ru[c]; };
    const int v = (i == 0 || i == L - 1)
                      ? at(i)
                      : (at(i - 1) + 2 * at(i) + at(i + 1) + 2) >> 2;
    rf[i < n2 ? n2 - 1 - i : i] = v;
  }
  __syncthreads();
}

// 8x8 Hadamard SATD of d (= src - pred), HM normalisation (sum + 2) >> 2.
static __device__ int ks_satd8(int* d) {
  for (int r = 0; r < 8; r++)
    for (int h = 1; h < 8; h <<= 1)
      for (int i = 0; i < 8; i += 2 * h)
        for (int j = i; j < i + h; j++) {
          const int a = d[8 * r + j], b = d[8 * r + j + h];
          d[8 * r + j] = a + b;
          d[8 * r + j + h] = a - b;
        }
  int s = 0;
  for (int c = 0; c < 8; c++) {
    for (int h = 1; h < 8; h <<= 1)
      for (int i = 0; i < 8; i += 2 * h)
        for (int j = i; j < i + h; j++) {
          const int a = d[8 * j + c], b = d[8 * (j + h) + c];
          d[8 * j + c] = a + b;
          d[8 * (j + h) + c] = a - b;
        }
    for (int r = 0; r < 8; r++) s += abs(d[8 * r + c]);
  }
  return (s + 2) >> 2;
}

// Halving sum of 8 lanes: lanes i and i+4, then i and i+2, then 0 and 1.
static __device__ __forceinline__ float ks_tree8(const float* v) {
  const float s0 = v[0] + v[4], s1 = v[1] + v[5], s2 = v[2] + v[6],
              s3 = v[3] + v[7];
  return (s0 + s2) + (s1 + s3);
}

// float32 sum of an n x n block in the reference backend's order
// (ops/decide._block_sum).
static __device__ float ks_block_sum(const float* x, int n) {
  if (n == 4) {
    float l[4];
    for (int r = 0; r < 4; r++)
      l[r] = ((x[4 * r] + x[4 * r + 1]) + x[4 * r + 2]) + x[4 * r + 3];
    return (l[0] + l[2]) + (l[1] + l[3]);
  }
  float acc = 0.f;
  for (int r = 0; r < n; r++) {
    float v[8];
    for (int i = 0; i < 8; i++) v[i] = x[r * n + i];
    v[0] = acc + v[0];
    for (int k = 8; k < n; k += 8)
      for (int i = 0; i < 8; i++) v[i] = v[i] + x[r * n + k + i];
    acc = ks_tree8(v);
  }
  return acc;
}

// float32 sum of the level-bit terms of an n x n TU in the reference
// backend's order (ops/intercode._lane_sum): for n <= 16 lane r % 8 (r % 4
// at n = 4) takes row r's values in column order, rows in order, then the
// lanes by halving; at n = 32 the order of ks_block_sum.
static __device__ float ks_lane_sum(const float* x, int n) {
  if (n == 32) return ks_block_sum(x, n);
  const int L = n < 8 ? n : 8;
  float v[8];
  for (int i = 0; i < L; i++) {
    v[i] = x[i * n];
    for (int c = 1; c < n; c++) v[i] = v[i] + x[i * n + c];
  }
  for (int r0 = L; r0 < n; r0 += L)
    for (int i = 0; i < L; i++)
      for (int c = 0; c < n; c++) v[i] = v[i] + x[(r0 + i) * n + c];
  if (L == 4) return (v[0] + v[2]) + (v[1] + v[3]);
  return ks_tree8(v);
}

// Inter deadzone quantisation of |c| (rounding 85/512): a level >= 0.
static __device__ __forceinline__ int ks_quant_abs_inter(const int* tab, int a,
                                                         int qp, int log2) {
  const int qbits = 29 + qp / 6 - 8 - log2;
  const int rnd = 85 << (qbits - 9);
  const int q = (a * tab[T_QUANT + qp % 6] + rnd) >> qbits;
  return q > 32767 ? 32767 : q;
}
