// K17 — inter coding of one P or B picture, replacing
// ks265codec_tpu/ops/intercode.py::_inter_code_core (`_code_tu_class`,
// the chroma branch, the zero-forcing gate, the final levels and recon,
// the boundary strengths, the weighted MC and `_effective_qp4`).
// The seeded intra scan and the deblocking filter are the K6 and K7
// launches of csrc/intra_scan.cu and csrc/deblock.cu.
//
//   ks_inter_mc       K14: the whole picture's prediction, one thread
//                     block per 8x8 cell (its luma and two 4x4 chroma
//                     cells) from the cell's motion in one or two lists
//                     (mc.cuh's `ks_mc_pred`, or `ks_mc_pred_wp` with
//                     explicit weights; list 1 and the weights are
//                     template arguments);
//   ks_inter_tu_class one thread block per TU of a size class: residual
//                     against the prediction, forward transform, inter
//                     deadzone quantisation and the signs through K2's
//                     functions of rdoq.cuh (with sign hiding, on the
//                     diagonal scan, where the PPS enables it),
//                     dequantisation and inverse transform in shared
//                     memory; one thread then sums
//                     d_skip, d_coded (ks_block_sum) and the level bits
//                     fma(3.1, count, 2 * sum log2) (ks_lane_sum) in the
//                     reference backend's order;
//   ks_inter_gate     one thread per CU: bits = luma + (Cb + Cr), the
//                     order of the reference's per-class scatter-adds,
//                     and drop = (d_skip - d_coded) <= lam * (bits + 10);
//   ks_inter_finish   one thread block per TU: levels (zero if dropped),
//                     recon = clip(pred + residual), the luma cbf per 4x4;
//   ks_inter_bs       one thread per 4x4 cell: spec 8.7.2.4 strengths;
//   ks_inter_eff_qp   under cu_qp_delta, the decoder's effective QP per
//                     4x4 cell (`_effective_qp4`): one thread block per
//                     CTB finds its first CU with coefficients (any plane)
//                     and the planned QP of its last in-picture cell, one
//                     warp per chain (a CTB row with WPP, else the
//                     picture) scans the CTBs with coefficients, and one
//                     thread per cell takes the predicted QP before the
//                     first coded CU, else its planned QP. Integer and
//                     exact.
//
// Bound: the transforms (4 n multiply-adds a sample, matrix form, twice)
// and the MC taps (64 a luma sample) against a few MB of planes:
// operations bound it.
#include "mc.cuh"
#include "rdoq.cuh"

namespace {

struct TuScratch {
  int res[KS_MAX_N * KS_MAX_N];
  int tmp[KS_MAX_N * KS_MAX_N];
  int coef[KS_MAX_N * KS_MAX_N];
  float f0[KS_MAX_N * KS_MAX_N];
  float f1[KS_MAX_N * KS_MAX_N];
  float f2[KS_MAX_N * KS_MAX_N];
  int rr[KS_MAX_N * KS_MAX_N];
  int flag;
};

template <bool kL1, bool kWP>
__global__ void mc_kernel(const uint8_t* ry, const uint8_t* rcb,
                          const uint8_t* rcr, const int* slot0,
                          const int* mv0, const int* slot1, const int* mv1,
                          uint8_t* py, uint8_t* pcb, uint8_t* pcr,
                          const int* wp, int R, int w8, int H, int W,
                          int pic_w, int pic_h) {
  const int cell = blockIdx.x;
  const int r = cell / w8, c = cell % w8;
  const int s0 = slot0[cell], mx0 = mv0[2 * cell], my0 = mv0[2 * cell + 1];
  const int s1 = kL1 ? slot1[cell] : -1;
  const int mx1 = kL1 ? mv1[2 * cell] : 0, my1 = kL1 ? mv1[2 * cell + 1] : 0;
  const int t = threadIdx.x;
  if (t < 64) {
    const int y = t / 8, x = t % 8;
    const size_t pl = (size_t)H * W;
    py[(size_t)(r * 8 + y) * W + c * 8 + x] = (uint8_t)(
        kWP ? ks_mc_pred_wp<kL1>(ry, pl, W, pic_w, pic_h, r * 8, c * 8, s0,
                                 mx0, my0, s1, mx1, my1, true, 0, wp, R, y,
                                 x)
            : ks_mc_pred<kL1>(ry, pl, W, pic_w, pic_h, r * 8, c * 8, s0, mx0,
                              my0, s1, mx1, my1, true, y, x));
  } else if (t < 96) {
    const int k = t - 64, pl = k / 16, y = (k % 16) / 4, x = k % 4;
    uint8_t* out = pl ? pcr : pcb;
    const uint8_t* ref = pl ? rcr : rcb;
    const size_t plane = (size_t)(H / 2) * (W / 2);
    out[(size_t)(r * 4 + y) * (W / 2) + c * 4 + x] = (uint8_t)(
        kWP ? ks_mc_pred_wp<kL1>(ref, plane, W / 2, pic_w / 2, pic_h / 2,
                                 r * 4, c * 4, s0, mx0, my0, s1, mx1, my1,
                                 false, 1 + pl, wp, R, y, x)
            : ks_mc_pred<kL1>(ref, plane, W / 2, pic_w / 2, pic_h / 2,
                              r * 4, c * 4, s0, mx0, my0, s1, mx1, my1,
                              false, y, x));
  }
}

__global__ void tu_class_kernel(const uint8_t* sy, const uint8_t* scb,
                                const uint8_t* scr, const uint8_t* py,
                                const uint8_t* pcb, const uint8_t* pcr,
                                const int* xs, const int* ys, const int* qp,
                                const int* plane, const int* valid,
                                int* lev_out, int* rr_out, float* sums,
                                const int* tab, const float* log2tab,
                                const int* rank, int stride, int n,
                                int is_luma, int sbh, int H, int W) {
  __shared__ TuScratch s;
  const int k = blockIdx.x;
  if (!valid[k]) {
    if (threadIdx.x == 0)
      sums[k] = sums[stride + k] = sums[2 * stride + k] = 0.f;
    return;
  }
  const int pl = is_luma ? 0 : 1 + plane[k];
  const uint8_t* src = pl == 0 ? sy : (pl == 1 ? scb : scr);
  const uint8_t* pred = pl == 0 ? py : (pl == 1 ? pcb : pcr);
  const int w = pl == 0 ? W : W / 2;
  const int x0 = xs[k], y0 = ys[k], q = qp[k], log2 = ks_log2(n);
  int* lev = lev_out + (size_t)k * n * n;
  int* rro = rr_out + (size_t)k * n * n;
  if (threadIdx.x == 0) s.flag = 0;
  for (int p = threadIdx.x; p < n * n; p += blockDim.x) {
    const size_t o = (size_t)(y0 + p / n) * w + x0 + p % n;
    s.res[p] = (int)src[o] - (int)pred[o];
  }
  __syncthreads();
  ks_fwd_dct(tab, n, s.res, s.tmp, s.coef);
  // signed levels into s.rr (free until the inverse transform), with sign
  // hiding on the diagonal scan where sbh is set
  ks_levels_abs(tab, s.coef, s.rr, nullptr, n, q, KS_INTER);
  __syncthreads();
  ks_group_pass(s.rr, s.coef, nullptr, n, KS_INTER | (sbh ? KS_SBH : 0),
                rank);
  __syncthreads();
  int cnt = 0;
  for (int p = threadIdx.x; p < n * n; p += blockDim.x) {
    const int l = s.rr[p];
    lev[p] = l;
    s.f2[p] = l != 0 ? log2tab[abs(l)] : 0.f;
    cnt += l != 0;
    s.tmp[p] = ks_dequant(tab, l, q, log2);
  }
  atomicAdd(&s.flag, cnt);
  __syncthreads();
  ks_inv_dct(tab, n, s.tmp, s.coef, s.rr);
  for (int p = threadIdx.x; p < n * n; p += blockDim.x) {
    rro[p] = s.rr[p];
    const float rf = (float)s.res[p], df = (float)(s.res[p] - s.rr[p]);
    s.f0[p] = rf * rf;
    s.f1[p] = df * df;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sums[k] = ks_block_sum(s.f0, n);
    sums[stride + k] = ks_block_sum(s.f1, n);
    sums[2 * stride + k] =
        __fmaf_rn(3.1f, (float)s.flag, 2.0f * ks_lane_sum(s.f2, n));
  }
}

// ctab per CU: luma class, its entry, chroma class, Cb entry, Cr entry;
// sums: (classes, 3, stride) = d_skip, d_coded, bits per TU entry.
__global__ void gate_kernel(const float* sums, const int* ctab,
                            const float* cu_lam, int* drop, int n_cu,
                            int stride) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == n_cu) drop[i] = 0;
  if (i >= n_cu) return;
  const int* t = ctab + 5 * i;
  const float* L = sums + (size_t)t[0] * 3 * stride;
  const float* C = sums + (size_t)t[2] * 3 * stride;
  const float bits = L[2 * stride + t[1]] +
                     (C[2 * stride + t[3]] + C[2 * stride + t[4]]);
  drop[i] = (L[t[1]] - L[stride + t[1]]) <= cu_lam[i] * (bits + 10.0f);
}

__global__ void finish_kernel(const uint8_t* py, const uint8_t* pcb,
                              const uint8_t* pcr, const int* xs,
                              const int* ys, const int* cid,
                              const int* plane, const int* valid,
                              const int* lev_in, const int* rr_in,
                              const int* drop, uint8_t* ry, uint8_t* rcb,
                              uint8_t* rcr, int16_t* cy, int16_t* ccb,
                              int16_t* ccr, uint8_t* cbf4, int n,
                              int is_luma, int n_cu, int H, int W) {
  const int k = blockIdx.x;
  if (!valid[k]) return;
  const int pl = is_luma ? 0 : 1 + plane[k];
  const uint8_t* pred = pl == 0 ? py : (pl == 1 ? pcb : pcr);
  uint8_t* rec = pl == 0 ? ry : (pl == 1 ? rcb : rcr);
  int16_t* coef = pl == 0 ? cy : (pl == 1 ? ccb : ccr);
  const int w = pl == 0 ? W : W / 2;
  const int x0 = xs[k], y0 = ys[k];
  const bool d = drop[min(cid[k], n_cu)] != 0;
  const int* lev = lev_in + (size_t)k * n * n;
  const int* rr = rr_in + (size_t)k * n * n;
  bool nz = false;
  for (int p = threadIdx.x; p < n * n; p += blockDim.x) {
    const size_t o = (size_t)(y0 + p / n) * w + x0 + p % n;
    const int l = d ? 0 : lev[p];
    coef[o] = (int16_t)l;
    rec[o] = (uint8_t)ks_clip3(0, 255, (int)pred[o] + (d ? 0 : rr[p]));
    nz = nz || l != 0;
  }
  if (__syncthreads_or(nz) && is_luma) {
    const int n4 = n / 4, w4 = W / 4;
    for (int p = threadIdx.x; p < n4 * n4; p += blockDim.x)
      cbf4[(size_t)(y0 / 4 + p / n4) * w4 + x0 / 4 + p % n4] = 1;
  }
}

__global__ void bs_kernel(const uint8_t* cbf4, const uint8_t* e2v,
                          const uint8_t* e2h, const uint8_t* etbv,
                          const uint8_t* etbh, const uint8_t* emvv,
                          const uint8_t* emvh, uint8_t* bs_v, uint8_t* bs_h,
                          int h4, int w4, int deblock) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h4 * w4) return;
  const int r = i / w4, c = i % w4;
  const bool cb = cbf4[i] != 0;
  const bool cl = c > 0 && cbf4[i - 1] != 0;
  const bool ct = r > 0 && cbf4[i - w4] != 0;
  int v = e2v[i] ? 2 : (etbv[i] && (cb || cl) ? 1 : emvv[i]);
  int h = e2h[i] ? 2 : (etbh[i] && (cb || ct) ? 1 : emvh[i]);
  bs_v[i] = (uint8_t)(deblock ? v : 0);
  bs_h[i] = (uint8_t)(deblock ? h : 0);
}

// One block per CTB (c4 x c4 threads): zfirst, any coded cell, the planned
// QP of the last in-picture cell in z order.
__global__ void eff_qp_ctb_kernel(const int* qp4, const int16_t* cy,
                                  const int16_t* ccb, const int16_t* ccr,
                                  const int* zin4, const int* zcu4,
                                  int* ctb, int h4, int w4, int c4,
                                  int pic_w4, int pic_h4) {
  __shared__ int zfirst, zlast, plast;
  const int nc = w4 / c4, nctb = (h4 / c4) * nc;
  const int b = blockIdx.x, ry = b / nc, rx = b % nc;
  const int t = threadIdx.x;
  if (t == 0) {
    zfirst = 1 << 30;
    zlast = -1;
  }
  __syncthreads();
  const int y4 = ry * c4 + t / c4, x4 = rx * c4 + t % c4;
  const int o = y4 * w4 + x4;
  const bool valid = x4 < pic_w4 && y4 < pic_h4;
  bool nz = false;
  const int W = w4 * 4, Wc = w4 * 2;
  for (int i = 0; i < 16; i++)
    nz |= cy[(size_t)(4 * y4 + i / 4) * W + 4 * x4 + i % 4] != 0;
  for (int i = 0; i < 4; i++) {
    const size_t co = (size_t)(2 * y4 + i / 2) * Wc + 2 * x4 + i % 2;
    nz |= ccb[co] != 0 || ccr[co] != 0;
  }
  if (valid && nz) atomicMin(&zfirst, zcu4[o]);
  if (valid) atomicMax(&zlast, zin4[o]);
  __syncthreads();
  if (valid && zin4[o] == zlast) plast = qp4[o];
  __syncthreads();
  if (t == 0) {
    ctb[b] = zfirst;
    ctb[nctb + b] = zfirst < (1 << 30);
    ctb[2 * nctb + b] = plast;
  }
}

// One warp per chain: qPY_PREV of every CTB, the planned last QP of the
// nearest earlier CTB of its chain with coefficients, else the slice QP.
__global__ void eff_qp_scan_kernel(int* ctb, int nctb, int nc, int wpp,
                                   int slice_qp) {
  const int chain = blockIdx.x, lane = threadIdx.x;
  const int len = wpp ? nc : nctb, base = wpp ? chain * nc : 0;
  int carry = -1;
  for (int k0 = 0; k0 < len; k0 += 32) {
    const int k = k0 + lane;
    int v = k < len && ctb[nctb + base + k] ? base + k : -1;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v = max(v, u);
    }
    int excl = __shfl_up_sync(0xffffffffu, v, 1);
    if (lane == 0) excl = -1;
    excl = max(excl, carry);
    if (k < len)
      ctb[3 * nctb + base + k] = excl >= 0 ? ctb[2 * nctb + excl] : slice_qp;
    carry = max(carry, __shfl_sync(0xffffffffu, v, 31));
  }
}

__global__ void eff_qp_apply_kernel(const int* qp4, const int* zin4,
                                    const int* ctb, uint8_t* out, int h4,
                                    int w4, int c4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h4 * w4) return;
  const int nc = w4 / c4, nctb = (h4 / c4) * nc;
  const int b = (i / w4 / c4) * nc + (i % w4) / c4;
  out[i] = (uint8_t)(zin4[i] < ctb[b] ? ctb[3 * nctb + b] : qp4[i]);
}

}  // namespace

// ctb: (4, nctb) int32 scratch (zfirst, any coded, planned last, qprev).
extern "C" int ks_inter_eff_qp(const void* qp4, const void* cy,
                               const void* ccb, const void* ccr,
                               const void* zin4, const void* zcu4,
                               void* ctb, void* out, int h4, int w4, int c4,
                               int pic_w, int pic_h, int slice_qp, int wpp,
                               void* stream) {
  const int nr = h4 / c4, nc = w4 / c4;
  if (nr <= 0 || nc <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  eff_qp_ctb_kernel<<<nr * nc, c4 * c4, 0, st>>>(
      (const int*)qp4, (const int16_t*)cy, (const int16_t*)ccb,
      (const int16_t*)ccr, (const int*)zin4, (const int*)zcu4, (int*)ctb, h4,
      w4, c4, pic_w >> 2, pic_h >> 2);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  eff_qp_scan_kernel<<<wpp ? nr : 1, 32, 0, st>>>((int*)ctb, nr * nc, nc, wpp,
                                                 slice_qp);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  eff_qp_apply_kernel<<<(h4 * w4 + 255) / 256, 256, 0, st>>>(
      (const int*)qp4, (const int*)zin4, (const int*)ctb, (uint8_t*)out, h4,
      w4, c4);
  return (int)cudaGetLastError();
}

// slot1 / mv1 are read only with has_l1 (a B picture) and the weight table
// wp (ops/mc.py::wp_table, R slots) only with weighted; the unweighted
// uni-predicted instantiation carries neither list-1 nor weight code.
extern "C" int ks_inter_mc(const void* ry, const void* rcb, const void* rcr,
                           const void* slot0, const void* mv0,
                           const void* slot1, const void* mv1, void* py,
                           void* pcb, void* pcr, const void* wp, int h8,
                           int w8, int H, int W, int pic_w, int pic_h,
                           int has_l1, int weighted, int R, void* stream) {
  if (h8 <= 0 || w8 <= 0) return 0;
  auto kernel = has_l1 ? (weighted ? mc_kernel<true, true>
                                   : mc_kernel<true, false>)
                       : (weighted ? mc_kernel<false, true>
                                   : mc_kernel<false, false>);
  kernel<<<h8 * w8, 96, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)ry, (const uint8_t*)rcb, (const uint8_t*)rcr,
      (const int*)slot0, (const int*)mv0, (const int*)slot1, (const int*)mv1,
      (uint8_t*)py, (uint8_t*)pcb, (uint8_t*)pcr, (const int*)wp, R, w8, H,
      W, pic_w, pic_h);
  return (int)cudaGetLastError();
}

extern "C" int ks_inter_tu_class(
    const void* sy, const void* scb, const void* scr, const void* py,
    const void* pcb, const void* pcr, const void* xs, const void* ys,
    const void* qp, const void* plane, const void* valid, void* lev,
    void* rr, void* sums, const void* tab, const void* log2tab,
    const void* rank, int K, int stride, int n, int is_luma, int sbh, int H,
    int W, void* stream) {
  if (K <= 0) return 0;
  tu_class_kernel<<<K, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)sy, (const uint8_t*)scb, (const uint8_t*)scr,
      (const uint8_t*)py, (const uint8_t*)pcb, (const uint8_t*)pcr,
      (const int*)xs, (const int*)ys, (const int*)qp, (const int*)plane,
      (const int*)valid, (int*)lev, (int*)rr, (float*)sums, (const int*)tab,
      (const float*)log2tab, (const int*)rank, stride, n, is_luma, sbh, H,
      W);
  return (int)cudaGetLastError();
}

extern "C" int ks_inter_gate(const void* sums, const void* ctab,
                             const void* cu_lam, void* drop, int n_cu,
                             int stride, void* stream) {
  gate_kernel<<<(n_cu + 1 + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)sums, (const int*)ctab, (const float*)cu_lam,
      (int*)drop, n_cu, stride);
  return (int)cudaGetLastError();
}

extern "C" int ks_inter_finish(
    const void* py, const void* pcb, const void* pcr, const void* xs,
    const void* ys, const void* cid, const void* plane, const void* valid,
    const void* lev, const void* rr, const void* drop, void* ry, void* rcb,
    void* rcr, void* cy, void* ccb, void* ccr, void* cbf4, int K, int n,
    int is_luma, int n_cu, int H, int W, void* stream) {
  if (K <= 0) return 0;
  finish_kernel<<<K, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)py, (const uint8_t*)pcb, (const uint8_t*)pcr,
      (const int*)xs, (const int*)ys, (const int*)cid, (const int*)plane,
      (const int*)valid, (const int*)lev, (const int*)rr, (const int*)drop,
      (uint8_t*)ry, (uint8_t*)rcb, (uint8_t*)rcr, (int16_t*)cy,
      (int16_t*)ccb, (int16_t*)ccr, (uint8_t*)cbf4, n, is_luma, n_cu, H, W);
  return (int)cudaGetLastError();
}

extern "C" int ks_inter_bs(const void* cbf4, const void* e2v, const void* e2h,
                           const void* etbv, const void* etbh,
                           const void* emvv, const void* emvh, void* bs_v,
                           void* bs_h, int h4, int w4, int deblock,
                           void* stream) {
  const int n = h4 * w4;
  if (n <= 0) return 0;
  bs_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)cbf4, (const uint8_t*)e2v, (const uint8_t*)e2h,
      (const uint8_t*)etbv, (const uint8_t*)etbh, (const uint8_t*)emvv,
      (const uint8_t*)emvh, (uint8_t*)bs_v, (uint8_t*)bs_h, h4, w4, deblock);
  return (int)cudaGetLastError();
}
