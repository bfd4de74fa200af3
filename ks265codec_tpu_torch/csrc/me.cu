// K13 — pyramid motion estimation for 8x8 blocks, replacing
// ks265codec_tpu/ops/me2.py::_me_fused_core (`_down2`, `_dense_l2`,
// `_med3`, `_refine3`, `_subpel8`, with bi=True `_bi_cost8` and the
// direction decision, and the interpolation of ops/subpel.py::
// _interp_cand, here the MC device functions of mc.cuh).
//
// One launch per level, each one thread block per block of that level:
//   ks_me_down2     the 2x2 box downsample of the picture and the
//                   references (one thread per output sample);
//   ks_me_dense_l2  the quarter-resolution search, in two passes: the
//                   first finds each 4x4 block's least SAD over the
//                   (2 sr + 1)^2 offsets into the edge-padded plane, the
//                   second takes the median of the left, top and
//                   top-right winners as predictor and re-ranks every
//                   offset by fma(lam, rate, SAD); both recompute the
//                   SADs instead of keeping a grid in device memory;
//   ks_me_refine3   +-3 around twice the coarser winner (half, then full
//                   resolution), 49 SADs, windows clamped to the picture;
//   ks_me_subpel8   49 quarter-pel candidates: the MC filter, SATD8 and
//                   the mvd rate fma(log(1 + d), 2/ln2, ...) in float32;
//   ks_me_bi_cost8  B pictures, after the two lists' searches: one thread
//                   per sample predicts from both winners (ks_mc_sample,
//                   ks_mc_bi) into shared memory, one thread takes the
//                   SATD8 of the residual and writes dir8 / sad8 from the
//                   float32 comparison of sbi + 8 lam against the two
//                   lists' costs (one rounding: 8 lam is exact).
// Every argmin is a min-reduction of a packed (cost, index) key, so ties
// go to the first index as in the reference; float costs are >= 0, so
// their bit patterns order as integers.
//
// Bound: the dense search is 1089 offsets x 16 samples per 4x4 quarter
// block, about 67 M |a - b| per 720p picture and reference; the
// quarter-pel stage 49 x (8x8 interpolation + SATD8) per 8x8 block; all
// far above the ~2 MB of plane traffic, so operations bound it. The bi
// cost adds two 8-tap predictions and a SATD8 per 8x8 block, about 1/40
// of the quarter-pel stage.
#include "mc.cuh"

namespace {

constexpr float kTwoOverLn2 = 2.0f * 1.44269502162933349609375f;

__global__ void down2_kernel(const uint8_t* in, uint8_t* out, int h, int w) {
  const int ho = h / 2, wo = w / 2, f = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ho * wo) return;
  const int r = i / wo, c = i % wo;
  const uint8_t* p = in + (size_t)f * h * w + (size_t)(2 * r) * w + 2 * c;
  out[(size_t)f * ho * wo + i] = (uint8_t)((p[0] + p[1] + p[w] + p[w + 1] +
                                            2) >> 2);
}

__device__ __forceinline__ int quarter_sad(const uint8_t* s, const uint8_t* r,
                                           int Hq, int Wq, int by, int bx,
                                           int dy, int dx) {
  int sad = 0;
  for (int i = 0; i < 16; i++) {
    const int y = by * 4 + i / 4, x = bx * 4 + i % 4;
    const int ry = ks_clip3(0, Hq - 1, y + dy), rx = ks_clip3(0, Wq - 1, x + dx);
    sad += abs((int)s[(size_t)y * Wq + x] - (int)r[(size_t)ry * Wq + rx]);
  }
  return sad;
}

// Pass 1: the plain SAD winner of every 4x4 quarter block.
__global__ void dense_argmin_kernel(const uint8_t* quarter, int* mv1, int Hq,
                                    int Wq, int sr) {
  __shared__ unsigned best;
  const int nbx = Wq / 4, nby = Hq / 4;
  const int b = blockIdx.x, ri = blockIdx.y;
  const int by = b / nbx, bx = b % nbx;
  const uint8_t* s = quarter;
  const uint8_t* r = quarter + (size_t)(1 + ri) * Hq * Wq;
  const int n = 2 * sr + 1;
  if (threadIdx.x == 0) best = 0xffffffffu;
  __syncthreads();
  unsigned mine = 0xffffffffu;
  for (int o = threadIdx.x; o < n * n; o += blockDim.x) {
    const unsigned sad = quarter_sad(s, r, Hq, Wq, by, bx, o / n - sr,
                                     o % n - sr);
    const unsigned key = (sad << 11) | (unsigned)o;
    mine = key < mine ? key : mine;
  }
  atomicMin(&best, mine);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int o = best & 2047;
    int* m = mv1 + (((size_t)ri * nby + by) * nbx + bx) * 2;
    m[0] = o % n - sr;
    m[1] = o / n - sr;
  }
}

__device__ __forceinline__ int med3(int a, int b, int c) {
  return max(min(a, b), min(max(a, b), c));
}

// Median of the left, top and top-right cells of an edge-padded grid.
__device__ void median_pred(const int* g, int nby, int nbx, int r, int c,
                            int* out) {
  const int cl = max(c - 1, 0), rt = max(r - 1, 0), ct = min(c + 1, nbx - 1);
  for (int k = 0; k < 2; k++)
    out[k] = med3(g[((size_t)r * nbx + cl) * 2 + k],
                  g[((size_t)rt * nbx + c) * 2 + k],
                  g[((size_t)rt * nbx + ct) * 2 + k]);
}

// Pass 2: the re-rank by SAD + lam * rate around the median predictor.
__global__ void dense_rerank_kernel(const uint8_t* quarter, const int* mv1,
                                    int* mv2, const float* log2tab, int Hq,
                                    int Wq, int sr, float lam) {
  __shared__ unsigned long long best;
  const int nbx = Wq / 4, nby = Hq / 4;
  const int b = blockIdx.x, ri = blockIdx.y;
  const int by = b / nbx, bx = b % nbx;
  const uint8_t* s = quarter;
  const uint8_t* r = quarter + (size_t)(1 + ri) * Hq * Wq;
  const int n = 2 * sr + 1;
  int pred[2];
  median_pred(mv1 + (size_t)ri * nby * nbx * 2, nby, nbx, by, bx, pred);
  pred[0] = ks_clip3(-sr, sr, pred[0]);
  pred[1] = ks_clip3(-sr, sr, pred[1]);
  if (threadIdx.x == 0) best = ~0ull;
  __syncthreads();
  unsigned long long mine = ~0ull;
  for (int o = threadIdx.x; o < n * n; o += blockDim.x) {
    const int dy = o / n - sr, dx = o % n - sr;
    const int sad = quarter_sad(s, r, Hq, Wq, by, bx, dy, dx);
    const float rx = 2.0f * log2tab[1 + 4 * abs(dx - pred[0])];
    const float ry = 2.0f * log2tab[1 + 4 * abs(dy - pred[1])];
    const float cost = __fmaf_rn(lam, ry + rx, (float)sad);
    const unsigned long long key =
        ((unsigned long long)__float_as_uint(cost) << 32) | (unsigned)o;
    mine = key < mine ? key : mine;
  }
  atomicMin(&best, mine);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int o = (int)(best & 0xffffffffu);
    int* m = mv2 + (((size_t)ri * nby + by) * nbx + bx) * 2;
    m[0] = o % n - sr;
    m[1] = o / n - sr;
  }
}

// +-3 refinement of bs x bs blocks around 2 x the coarser winner;
// `shift` maps this grid onto the coarser one (1: the 16 grid of the
// quarter search, 0: the same grid).
__global__ void refine3_kernel(const uint8_t* planes, const int* coarse,
                               int* out, int H, int W, int bs, int shift,
                               int pic_w, int pic_h) {
  __shared__ unsigned best;
  const int nbx = W / bs, nby = H / bs;
  const int cnbx = nbx >> shift, cnby = nby >> shift;
  const int b = blockIdx.x, ri = blockIdx.y;
  const int by = b / nbx, bx = b % nbx;
  const uint8_t* s = planes;
  const uint8_t* r = planes + (size_t)(1 + ri) * H * W;
  const int* cg = coarse + (((size_t)ri * cnby + (by >> shift)) * cnbx +
                            (bx >> shift)) * 2;
  const int cx = cg[0] * 2, cy = cg[1] * 2;
  if (threadIdx.x == 0) best = 0xffffffffu;
  __syncthreads();
  if (threadIdx.x < 49) {
    const int dx = threadIdx.x % 7 - 3, dy = threadIdx.x / 7 - 3;
    unsigned sad = 0;
    for (int i = 0; i < bs * bs; i++) {
      const int y = by * bs + i / bs, x = bx * bs + i % bs;
      const int ry = ks_clip3(0, pic_h - 1, y + cy + dy);
      const int rx = ks_clip3(0, pic_w - 1, x + cx + dx);
      sad += abs((int)s[(size_t)y * W + x] - (int)r[(size_t)ry * W + rx]);
    }
    atomicMin(&best, (sad << 6) | threadIdx.x);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int o = best & 63;
    int* m = out + (((size_t)ri * nby + by) * nbx + bx) * 2;
    m[0] = cx + o % 7 - 3;
    m[1] = cy + o / 7 - 3;
  }
}

// 49 quarter-pel candidates around the full-pel winner: SATD8 of the
// interpolated block plus lam * mvd rate against the median predictor.
__global__ void subpel8_kernel(const uint8_t* planes, const int* mv_f,
                               int* mv_q, float* cost_out,
                               const float* logtab, int H, int W, int pic_w,
                               int pic_h, float lam) {
  __shared__ unsigned long long best;
  const int nbx = W / 8, nby = H / 8;
  const int b = blockIdx.x, ri = blockIdx.y;
  const int by = b / nbx, bx = b % nbx;
  const uint8_t* s = planes;
  const uint8_t* r = planes + (size_t)(1 + ri) * H * W;
  const int* g = mv_f + (size_t)ri * nby * nbx * 2;
  int pred[2];
  median_pred(g, nby, nbx, by, bx, pred);   // full-pel, x4 below
  const int mx0 = g[((size_t)by * nbx + bx) * 2] * 4;
  const int my0 = g[((size_t)by * nbx + bx) * 2 + 1] * 4;
  if (threadIdx.x == 0) best = ~0ull;
  __syncthreads();
  if (threadIdx.x < 49) {
    const int mx = mx0 + threadIdx.x % 7 - 3, my = my0 + threadIdx.x / 7 - 3;
    int d[64];
    for (int i = 0; i < 64; i++) {
      const int y = i / 8, x = i % 8;
      const int p = ks_mc_uni(ks_mc_sample(r, W, pic_w, pic_h, by * 8, bx * 8,
                                           mx, my, true, y, x));
      d[i] = (int)s[(size_t)(by * 8 + y) * W + bx * 8 + x] - p;
    }
    const float sat = (float)ks_satd8(d);
    const int d0 = abs(mx - pred[0] * 4), d1 = abs(my - pred[1] * 4);
    const float t = __fmaf_rn(logtab[1 + d0], kTwoOverLn2, 2.0f);
    const float rate = __fmaf_rn(logtab[1 + d1], kTwoOverLn2, t);
    const float cost = __fmaf_rn(lam, rate, sat);
    atomicMin(&best, ((unsigned long long)__float_as_uint(cost) << 32) |
                         threadIdx.x);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int o = (int)(best & 0xffffffffu);
    const size_t i = ((size_t)ri * nby + by) * nbx + bx;
    mv_q[2 * i] = mx0 + o % 7 - 3;
    mv_q[2 * i + 1] = my0 + o / 7 - 3;
    cost_out[i] = __uint_as_float((unsigned)(best >> 32));
  }
}

// The bi-prediction cost of each 8x8 block (`_bi_cost8`) and its
// direction: planes (3, H, W) = picture, L0[0], L1[0]; mv_q (2, nby, nbx,
// 2) and cost (2, nby, nbx) the two lists' winners.
__global__ void bi_cost8_kernel(const uint8_t* planes, const int* mv_q,
                                const float* cost, int8_t* dir8,
                                float* sad8, int H, int W, int pic_w,
                                int pic_h, float lam) {
  __shared__ int d[64];
  const int nbx = W / 8, nb = (H / 8) * nbx;
  const int b = blockIdx.x, by = b / nbx, bx = b % nbx;
  const int y = threadIdx.x / 8, x = threadIdx.x % 8;
  const int* m0 = mv_q + 2 * (size_t)b;
  const int* m1 = mv_q + 2 * ((size_t)nb + b);
  const size_t plane = (size_t)H * W;
  const int p0 = ks_mc_sample(planes + plane, W, pic_w, pic_h, by * 8,
                              bx * 8, m0[0], m0[1], true, y, x);
  const int p1 = ks_mc_sample(planes + 2 * plane, W, pic_w, pic_h, by * 8,
                              bx * 8, m1[0], m1[1], true, y, x);
  d[threadIdx.x] = (int)planes[(size_t)(by * 8 + y) * W + bx * 8 + x] -
                   ks_mc_bi(p0, p1);
  __syncthreads();
  if (threadIdx.x == 0) {
    const float bb = __fadd_rn((float)ks_satd8(d), __fmul_rn(lam, 8.0f));
    const float c0 = cost[b], c1 = cost[nb + b];
    const float best_uni = fminf(c0, c1);
    dir8[b] = (int8_t)(bb < best_uni ? 2 : (c1 < c0 ? 1 : 0));
    sad8[b] = fminf(best_uni, bb);
  }
}

}  // namespace

// planes (F, h, w) uint8 -> (F, h/2, w/2).
extern "C" int ks_me_down2(const void* in, void* out, int F, int h, int w,
                           void* stream) {
  if (F <= 0) return 0;
  const int n = (h / 2) * (w / 2);
  down2_kernel<<<dim3((n + 255) / 256, F), 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, h, w);
  return (int)cudaGetLastError();
}

// quarter: (R+1, Hq, Wq), picture first; mv2: (R, Hq/4, Wq/4, 2) winners;
// scratch: (R, Hq/4, Wq/4, 2) int32 for the first pass.
extern "C" int ks_me_dense_l2(const void* quarter, void* scratch, void* mv2,
                              const void* log2tab, int R, int Hq, int Wq,
                              int sr, float lam, void* stream) {
  if (R <= 0) return 0;
  const dim3 grid((Hq / 4) * (Wq / 4), R);
  dense_argmin_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)quarter, (int*)scratch, Hq, Wq, sr);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  dense_rerank_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)quarter, (const int*)scratch, (int*)mv2,
      (const float*)log2tab, Hq, Wq, sr, lam);
  return (int)cudaGetLastError();
}

// planes: (R+1, H, W) at this level, picture first; coarse: the coarser
// winners; out: (R, H/bs, W/bs, 2).
extern "C" int ks_me_refine3(const void* planes, const void* coarse,
                             void* out, int R, int H, int W, int bs,
                             int shift, int pic_w, int pic_h, void* stream) {
  if (R <= 0) return 0;
  refine3_kernel<<<dim3((H / bs) * (W / bs), R), 64, 0,
                   (cudaStream_t)stream>>>(
      (const uint8_t*)planes, (const int*)coarse, (int*)out, H, W, bs, shift,
      pic_w, pic_h);
  return (int)cudaGetLastError();
}

extern "C" int ks_me_subpel8(const void* planes, const void* mv_f, void* mv_q,
                             void* cost, int R, int H, int W, int pic_w,
                             int pic_h, float lam, const void* logtab,
                             void* stream) {
  if (R <= 0) return 0;
  subpel8_kernel<<<dim3((H / 8) * (W / 8), R), 64, 0,
                   (cudaStream_t)stream>>>(
      (const uint8_t*)planes, (const int*)mv_f, (int*)mv_q, (float*)cost,
      (const float*)logtab, H, W, pic_w, pic_h, lam);
  return (int)cudaGetLastError();
}

// planes (3, H, W): picture, L0[0], L1[0]; mv_q / cost: ks_me_subpel8's
// outputs for R = 2; dir8 (H/8, W/8) int8, sad8 float32.
extern "C" int ks_me_bi_cost8(const void* planes, const void* mv_q,
                              const void* cost, void* dir8, void* sad8,
                              int H, int W, int pic_w, int pic_h, float lam,
                              void* stream) {
  const int nb = (H / 8) * (W / 8);
  if (nb <= 0) return 0;
  bi_cost8_kernel<<<nb, 64, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)planes, (const int*)mv_q, (const float*)cost,
      (int8_t*)dir8, (float*)sad8, H, W, pic_w, pic_h, lam);
  return (int)cudaGetLastError();
}
