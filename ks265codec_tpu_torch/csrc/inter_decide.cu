// K15 — inter mode decision per CU tier, replacing
// ks265codec_tpu/ops/interdecide.py::_tier_core (via
// `decide_tiers_fused_jit` / `_tiers_fused_core`, with `_rough_cu` and
// `_rough_tu_inter`) and `_cand_sads_core` (via `snap_sads_fused_jit`).
// In B pictures (template argument kL1) every candidate and ME record
// carries both lists' slots and motions and predicts through mc.cuh's
// `ks_mc_pred` (both lists averaged, or the one list whose slot is >= 0);
// an ME record is valid where either slot is >= 0. The P instantiation
// carries no list-1 code.
//
// ks_inter_decide_tier: one thread block per CU of the tier. The block
// scores every merge candidate by the luma SAD of its MC prediction (the
// samples split over the threads, an exact integer sum), keeps the first
// least fma(lam_satd, 2 + index, SAD), then computes the rough
// rate-distortion cost of the best candidate's motion and of the motion
// search's: per TU (luma n, four 32s at 64; chroma n/2, four 16s at 32)
// the MC residual is transformed and quantised with the inter deadzone in
// shared memory, and one thread sums the squared coefficient-domain
// dequantisation errors and the level bits in the reference backend's
// order (ks_block_sum). The choice is the first least of fma(lam, bits +
// 2 + index, D), fma(lam, bits + me_bits, D) and fma(lam, 1.5, icost).
// The 64 tier (zero_only) instead finds the first valid candidate whose
// every TU quantises to zero.
// ks_inter_cand_sads: one thread block per (CU, candidate), the SAD.
//
// Bound: per CU and candidate an n x n MC (8 x 8 taps a sample, twice
// where bi-predicted) and SAD,
// per costed motion the transforms (4 n multiply-adds a sample, matrix
// form); operations bound it, not the planes' bytes.
#include "mc.cuh"

namespace {

struct Scratch {
  int res[KS_MAX_N * KS_MAX_N];
  int tmp[KS_MAX_N * KS_MAX_N];
  int coef[KS_MAX_N * KS_MAX_N];
  float sq[KS_MAX_N * KS_MAX_N];
  float bits[KS_MAX_N * KS_MAX_N];
  int isum;
  float D, R;
};

struct Planes {
  const uint8_t* src[3];
  const uint8_t* ref[3];
  int H, W, pic_w, pic_h;
};

// One motion of list 0 and (kL1) list 1.
struct Motion {
  int s0, mx0, my0, s1, mx1, my1;
};

template <bool kL1>
__device__ __forceinline__ Motion motion(const int* s0, const int* mv0,
                                         const int* s1, const int* mv1,
                                         size_t i) {
  Motion m{s0[i], mv0[2 * i], mv0[2 * i + 1], -1, 0, 0};
  if (kL1) {
    m.s1 = s1[i];
    m.mx1 = mv1[2 * i];
    m.my1 = mv1[2 * i + 1];
  }
  return m;
}

// Luma SAD of the n x n block at (x, y) predicted with motion m.
template <bool kL1>
__device__ int cand_sad(const Planes& p, const Motion& m, int x, int y,
                        int n, Scratch& s) {
  if (threadIdx.x == 0) s.isum = 0;
  __syncthreads();
  int part = 0;
  for (int q = threadIdx.x; q < n * n; q += blockDim.x) {
    const int yy = q / n, xx = q % n;
    const int pr = ks_mc_pred<kL1>(p.ref[0], (size_t)p.H * p.W, p.W,
                                   p.pic_w, p.pic_h, y, x, m.s0, m.mx0,
                                   m.my0, m.s1, m.mx1, m.my1, true, yy, xx);
    part += abs((int)p.src[0][(size_t)(y + yy) * p.W + x + xx] - pr);
  }
  atomicAdd(&s.isum, part);
  __syncthreads();
  const int v = s.isum;
  __syncthreads();
  return v;
}

// Rough cost of the t x t residual in s.res: (D, bits) into s.D / s.R (the
// caller combines them), all-zero returned.
__device__ bool rough_tu(const int* tab, const float* btab, int t, int qp,
                         Scratch& s) {
  ks_fwd_dct(tab, t, s.res, s.tmp, s.coef);
  const int log2 = ks_log2(t);
  const int sh = 8 + log2 - 5, p6 = qp / 6;
  bool nz = false;
  for (int q = threadIdx.x; q < t * t; q += blockDim.x) {
    const int a = abs(s.coef[q]);
    const int lev = ks_quant_abs_inter(tab, a, qp, log2);
    const int tv = lev * (16 * tab[T_LEVEL + qp % 6]);
    int deq = sh - p6 >= 1 ? (tv + (1 << (sh - p6 - 1))) >> (sh - p6)
                           : tv << (p6 - sh);
    deq = ks_clip3(0, 1 << 30, deq);
    const float derr = (float)(a - deq);
    s.sq[q] = derr * derr;
    s.bits[q] = btab[lev];
    nz = nz || lev > 0;
  }
  const bool any = __syncthreads_or(nz);
  if (threadIdx.x == 0) {
    s.D = ks_block_sum(s.sq, t) * ldexpf(1.f, 2 * log2 - 14);
    s.R = ks_block_sum(s.bits, t);
  }
  __syncthreads();
  return !any;
}

// Rough (D, bits, zero) of coding motion mo at CU size n.
template <bool kL1>
__device__ bool rough_cu(const Planes& p, const int* tab, const float* btab,
                         const Motion& mo, int x, int y, int n,
                         const int* qps, float* D, float* R, Scratch& s) {
  bool zero = true;
  for (int c = 0; c < 3; c++) {
    const int m = c == 0 ? n : n >> 1;
    const int t = m < (c == 0 ? 32 : 16) ? m : (c == 0 ? 32 : 16);
    const int w = c == 0 ? p.W : p.W / 2, h = c == 0 ? p.H : p.H / 2;
    const int pw = c == 0 ? p.pic_w : p.pic_w / 2;
    const int ph = c == 0 ? p.pic_h : p.pic_h / 2;
    const int ox = c == 0 ? x : x >> 1, oy = c == 0 ? y : y >> 1;
    float d = 0.f, b = 0.f;
    for (int k = 0; k < (m / t) * (m / t); k++) {
      const int ty = (k / (m / t)) * t, tx = (k % (m / t)) * t;
      for (int q = threadIdx.x; q < t * t; q += blockDim.x) {
        const int yy = ty + q / t, xx = tx + q % t;
        const int pr = ks_mc_pred<kL1>(p.ref[c], (size_t)h * w, w, pw, ph,
                                       oy, ox, mo.s0, mo.mx0, mo.my0, mo.s1,
                                       mo.mx1, mo.my1, c == 0, yy, xx);
        s.res[q] = (int)p.src[c][(size_t)(oy + yy) * w + ox + xx] - pr;
      }
      __syncthreads();
      zero = rough_tu(tab, btab, t, qps[c], s) && zero;
      d = k == 0 ? s.D : d + s.D;
      b = k == 0 ? s.R : b + s.R;
    }
    *D = c == 0 ? d : *D + d;
    *R = c == 0 ? b : *R + b;
  }
  return zero;
}

template <bool kL1>
__global__ void decide_tier_kernel(
    Planes p, const int* xs, const int* ys, const int* cs0, const int* cmv0,
    const int* cs1, const int* cmv1, const uint8_t* cvalid, const int* ms0,
    const int* mmv0, const int* ms1, const int* mmv1, const float* me_bits,
    const float* icost, const int* qp, const int* qpcb, const int* qpcr,
    const float* lam, const float* lams, int* choice, int* bidx, float* cost,
    const int* tab, const float* btab, int B, int C, int n, int zero_only) {
  __shared__ Scratch s;
  const int b = blockIdx.x;
  const int x = xs[b], y = ys[b];
  const int qps[3] = {qp[b], qpcb[b], qpcr[b]};
  if (zero_only) {
    int first = -1;
    for (int j = 0; j < C && first < 0; j++) {
      if (!cvalid[(size_t)j * B + b]) continue;
      float D, R;
      if (rough_cu<kL1>(p, tab, btab,
                        motion<kL1>(cs0, cmv0, cs1, cmv1, (size_t)j * B + b),
                        x, y, n, qps, &D, &R, s))
        first = j;
    }
    if (threadIdx.x == 0) {
      choice[b] = first >= 0;
      bidx[b] = first >= 0 ? first : 0;
    }
    return;
  }
  float best_c = INFINITY;
  int best = 0;
  bool any_valid = false;
  for (int j = 0; j < C; j++) {
    const size_t i = (size_t)j * B + b;
    const int sad =
        cand_sad<kL1>(p, motion<kL1>(cs0, cmv0, cs1, cmv1, i), x, y, n, s);
    const float c = cvalid[i] ? __fmaf_rn(lams[b], 2.0f + (float)j,
                                          (float)sad)
                              : INFINITY;
    any_valid = any_valid || cvalid[i];
    if (j == 0 || c < best_c) {
      best_c = c;
      best = j;
    }
  }
  Motion bm = motion<kL1>(cs0, cmv0, cs1, cmv1, (size_t)best * B + b);
  if (!any_valid) bm.s0 = bm.s1 = -1;
  const Motion me = motion<kL1>(ms0, mmv0, ms1, mmv1, b);
  float Dm, Rm, De, Re;
  rough_cu<kL1>(p, tab, btab, bm, x, y, n, qps, &Dm, &Rm, s);
  rough_cu<kL1>(p, tab, btab, me, x, y, n, qps, &De, &Re, s);
  if (threadIdx.x == 0) {
    const float l = lam[b];
    float costs[3];
    costs[0] = any_valid ? __fmaf_rn(l, (Rm + 2.0f) + (float)best, Dm)
                         : INFINITY;
    costs[1] = ms0[b] >= 0 || ms1[b] >= 0 ? __fmaf_rn(l, Re + me_bits[b], De)
                                          : INFINITY;
    costs[2] = icost[b] < INFINITY ? __fmaf_rn(l, 1.5f, icost[b])
                                   : INFINITY;
    int ch = 0;
    for (int k = 1; k < 3; k++)
      if (costs[k] < costs[ch]) ch = k;
    choice[b] = ch;
    bidx[b] = best;
    cost[b] = costs[ch];
  }
}

template <bool kL1>
__global__ void cand_sads_kernel(Planes p, const int* xs, const int* ys,
                                 const int* cs0, const int* cmv0,
                                 const int* cs1, const int* cmv1, float* out,
                                 int B, int n) {
  __shared__ Scratch s;
  const int b = blockIdx.x, j = blockIdx.y;
  const size_t i = (size_t)j * B + b;
  const int sad = cand_sad<kL1>(p, motion<kL1>(cs0, cmv0, cs1, cmv1, i),
                                xs[b], ys[b], n, s);
  if (threadIdx.x == 0) out[i] = (float)sad;
}

Planes make_planes(const void* sy, const void* scb, const void* scr,
                   const void* ry, const void* rcb, const void* rcr, int H,
                   int W, int pic_w, int pic_h) {
  Planes p;
  p.src[0] = (const uint8_t*)sy;
  p.src[1] = (const uint8_t*)scb;
  p.src[2] = (const uint8_t*)scr;
  p.ref[0] = (const uint8_t*)ry;
  p.ref[1] = (const uint8_t*)rcb;
  p.ref[2] = (const uint8_t*)rcr;
  p.H = H;
  p.W = W;
  p.pic_w = pic_w;
  p.pic_h = pic_h;
  return p;
}

}  // namespace

// cs1 / cmv1 / ms1 / mmv1 are read only with has_l1 (B pictures).
extern "C" int ks_inter_decide_tier(
    const void* sy, const void* scb, const void* scr, const void* ry,
    const void* rcb, const void* rcr, const void* xs, const void* ys,
    const void* cs0, const void* cmv0, const void* cs1, const void* cmv1,
    const void* cvalid, const void* ms0, const void* mmv0, const void* ms1,
    const void* mmv1, const void* me_bits, const void* icost, const void* qp,
    const void* qpcb, const void* qpcr, const void* lam, const void* lams,
    void* choice, void* bidx, void* cost, const void* tab, const void* btab,
    int B, int C, int n, int H, int W, int pic_w, int pic_h, int zero_only,
    int has_l1, void* stream) {
  if (B <= 0) return 0;
  auto kernel = has_l1 ? decide_tier_kernel<true> : decide_tier_kernel<false>;
  kernel<<<B, 256, 0, (cudaStream_t)stream>>>(
      make_planes(sy, scb, scr, ry, rcb, rcr, H, W, pic_w, pic_h),
      (const int*)xs, (const int*)ys, (const int*)cs0, (const int*)cmv0,
      (const int*)cs1, (const int*)cmv1, (const uint8_t*)cvalid,
      (const int*)ms0, (const int*)mmv0, (const int*)ms1, (const int*)mmv1,
      (const float*)me_bits, (const float*)icost, (const int*)qp,
      (const int*)qpcb, (const int*)qpcr, (const float*)lam,
      (const float*)lams, (int*)choice, (int*)bidx, (float*)cost,
      (const int*)tab, (const float*)btab, B, C, n, zero_only);
  return (int)cudaGetLastError();
}

extern "C" int ks_inter_cand_sads(const void* sy, const void* ry,
                                  const void* xs, const void* ys,
                                  const void* cs0, const void* cmv0,
                                  const void* cs1, const void* cmv1,
                                  void* out, int B, int C, int n, int H,
                                  int W, int pic_w, int pic_h, int has_l1,
                                  void* stream) {
  if (B <= 0 || C <= 0) return 0;
  auto kernel = has_l1 ? cand_sads_kernel<true> : cand_sads_kernel<false>;
  kernel<<<dim3(B, C), 256, 0, (cudaStream_t)stream>>>(
      make_planes(sy, nullptr, nullptr, ry, nullptr, nullptr, H, W, pic_w,
                  pic_h),
      (const int*)xs, (const int*)ys, (const int*)cs0, (const int*)cmv0,
      (const int*)cs1, (const int*)cmv1, (float*)out, B, n);
  return (int)cudaGetLastError();
}
