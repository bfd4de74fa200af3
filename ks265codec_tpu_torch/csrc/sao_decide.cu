// K16 — SAO decision: per-CTB offsets and type from K8's integer
// statistics, replacing ks265codec_tpu/ops/saodecide.py::sao_decide_core
// (with `_best_offsets`).
//
// One thread per CTB walks its planes in order, because Cr inherits Cb's
// type and EO class. Per plane: for each EO class searched (0/1 at tier 1,
// all four above) the best offset of categories 0, 1, 3, 4 and the class
// cost f32(lam * 3) + c0 + c1 + c2 + c3; the class of least cost (first
// minimum) if it beats 0; at tier >= 3 the band offsets, the window of
// least cost ((c[b] + c[b+1]) + c[b+2]) + c[b+3] over the 29 starts, and
// the band type if that cost plus f32(lam * 8) beats the best so far (for
// Cr only where Cb chose band offset).
//
// The float32 sequence is the reference backend's (see ops/saodecide.py):
// an offset's cost is __fmaf_rn(lam, |h| + 1, cnt*h*h - 2*h*err), whose
// integer part is exact, the start rintf(err / max(cnt, 1)) with an IEEE
// division, and every comparison is on float32, so ties fall as they do
// there. The build passes --fmad=false: no other contraction happens.
//
// Bound: operations, a few thousand per CTB (15 candidate offsets for each
// of up to 16 EO bins and 32 bands); the statistics are a few hundred KB.
// A few hundred CTBs make one small launch; a plain, correct kernel.
#include <math.h>

#include "common.cuh"

namespace {

struct PlaneStats {
  const int* eo_cnt;
  const int* eo_err;
  const int* bo_cnt;
  const int* bo_err;
};

// Best offset in [lo, hi] of one bin (the reference's `_best_offsets`):
// scan h = -7..7, least cost among the valid, the largest |h| among the
// exactly least; used only if its cost is below 0.
__device__ void best_offset(int cnt_i, int err_i, float lo, float hi,
                            float lam, float* h_out, float* c_out) {
  const float cnt = (float)cnt_i, err = (float)err_i;
  const float q = rintf(__fdiv_rn(err, fmaxf(cnt, 1.f)));
  const float start = fminf(fmaxf(q, lo), hi);
  float cost[15];
  bool valid[15];
  float cmin = INFINITY;
  for (int i = 0; i < 15; i++) {
    const float h = (float)(i - 7);
    cost[i] = __fmaf_rn(lam, fabsf(h) + 1.f, cnt * h * h - 2.f * h * err);
    const bool same_sign =
        (h > 0.f) == (start > 0.f) && (h < 0.f) == (start < 0.f);
    valid[i] = h != 0.f && fabsf(h) <= fabsf(start) && same_sign && h >= lo &&
               h <= hi && cnt > 0.f;
    if (valid[i] && cost[i] < cmin) cmin = cost[i];
  }
  int k = 0;
  float amin = INFINITY;
  for (int i = 0; i < 15; i++) {
    const float cv = valid[i] ? cost[i] : INFINITY;
    const float adj = cv == cmin ? -fabsf((float)(i - 7)) : INFINITY;
    if (i == 0 || adj < amin) {
      amin = adj;
      k = i;
    }
  }
  const bool use = cost[k] < 0.f && valid[k];
  *h_out = use ? (float)(k - 7) : 0.f;
  *c_out = use ? cost[k] : 0.f;
}

__constant__ int kCats[4] = {0, 1, 3, 4};
__constant__ float kLo[4] = {0.f, 0.f, -7.f, -7.f};
__constant__ float kHi[4] = {7.f, 7.f, 0.f, 0.f};

__global__ void sao_decide_kernel(PlaneStats s0, PlaneStats s1,
                                  PlaneStats s2, int8_t* type_out,
                                  int8_t* offs_out, int8_t* bpos_out,
                                  int8_t* eocl_out, int nct, int tier,
                                  float lam, float lam3, float lam8) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nct) return;
  const PlaneStats st[3] = {s0, s1, s2};
  int type[3] = {0, 0, 0}, eocl[3] = {0, 0, 0}, bpos[3] = {0, 0, 0};
  int offs[3][4] = {};
  const int planes = tier >= 3 ? 3 : 1;
  const int nclasses = tier <= 1 ? 2 : 4;
  for (int c = 0; c < planes; c++) {
    float best = 0.f;
    float eo_cost[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
    float eo_h[4][4] = {};
    for (int eo = 0; eo < nclasses; eo++) {
      float cost = lam3;
      for (int k = 0; k < 4; k++) {
        const size_t o = (size_t)(eo * 5 + kCats[k]) * nct + i;
        float h, cst;
        best_offset(st[c].eo_cnt[o], st[c].eo_err[o], kLo[k], kHi[k], lam,
                    &h, &cst);
        eo_h[eo][k] = h;
        cost = cost + cst;
      }
      eo_cost[eo] = cost;
    }
    int bcls = 0;
    float bcost = INFINITY;
    for (int e = 0; e < 4; e++) {
      const float a = c == 2 ? (type[1] == 2 && e == eocl[1] ? eo_cost[e]
                                                             : INFINITY)
                             : eo_cost[e];
      if (e == 0 || a < bcost) {
        bcost = a;
        bcls = e;
      }
    }
    if (bcost < best) {
      best = eo_cost[bcls];
      type[c] = 2;
      eocl[c] = bcls;
      for (int k = 0; k < 4; k++) offs[c][k] = (int)eo_h[bcls][k];
    }
    if (tier >= 3) {
      float bh[32], bc[32];
      for (int b = 0; b < 32; b++)
        best_offset(st[c].bo_cnt[(size_t)b * nct + i],
                    st[c].bo_err[(size_t)b * nct + i], -7.f, 7.f, lam, &bh[b],
                    &bc[b]);
      int wpos = 0;
      float wmin = INFINITY;
      for (int b = 0; b < 29; b++) {
        const float w = ((bc[b] + bc[b + 1]) + bc[b + 2]) + bc[b + 3];
        if (b == 0 || w < wmin) {
          wmin = w;
          wpos = b;
        }
      }
      if (wmin + lam8 < best && (c != 2 || type[1] == 1)) {
        type[c] = 1;
        bpos[c] = wpos;
        eocl[c] = 0;
        for (int k = 0; k < 4; k++) offs[c][k] = (int)bh[wpos + k];
      }
    }
    if (c == 1) {
      type[2] = type[1];
      eocl[2] = eocl[1];
    }
  }
  for (int c = 0; c < 3; c++) {
    const size_t o = (size_t)c * nct + i;
    type_out[o] = (int8_t)type[c];
    bpos_out[o] = (int8_t)bpos[c];
    eocl_out[o] = (int8_t)eocl[c];
    for (int k = 0; k < 4; k++) offs_out[o * 4 + k] = (int8_t)offs[c][k];
  }
}

}  // namespace

// stats: per plane (eo_cnt, eo_err, bo_cnt, bo_err) int32, EO
// (ncl, 5, nct) and band (32, nct); planes and band statistics a tier does
// not read may be any pointer. Outputs int8 (3, nct) and offs (3, nct, 4).
extern "C" int ks_sao_decide(const void* eo_cnt0, const void* eo_err0,
                             const void* bo_cnt0, const void* bo_err0,
                             const void* eo_cnt1, const void* eo_err1,
                             const void* bo_cnt1, const void* bo_err1,
                             const void* eo_cnt2, const void* eo_err2,
                             const void* bo_cnt2, const void* bo_err2,
                             void* type, void* offs, void* bpos, void* eocl,
                             int nct, int tier, float lam, float lam3,
                             float lam8, void* stream) {
  if (nct <= 0) return 0;
  const PlaneStats s0 = {(const int*)eo_cnt0, (const int*)eo_err0,
                         (const int*)bo_cnt0, (const int*)bo_err0};
  const PlaneStats s1 = {(const int*)eo_cnt1, (const int*)eo_err1,
                         (const int*)bo_cnt1, (const int*)bo_err1};
  const PlaneStats s2 = {(const int*)eo_cnt2, (const int*)eo_err2,
                         (const int*)bo_cnt2, (const int*)bo_err2};
  sao_decide_kernel<<<(nct + 63) / 64, 64, 0, (cudaStream_t)stream>>>(
      s0, s1, s2, (int8_t*)type, (int8_t*)offs, (int8_t*)bpos,
      (int8_t*)eocl, nct, tier, lam, lam3, lam8);
  return (int)cudaGetLastError();
}
