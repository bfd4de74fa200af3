// K14 — motion compensation as device functions, replacing
// ks265codec_tpu/ops/mc.py (`_interp_cells`, `_combine`, `_mc_core`):
// the 8-tap luma / 4-tap chroma separable filters of spec 8.5.4.2.2 with
// 14-bit intermediates. Phase 0 of each filter is the integer pick with
// weight 64, so one `>> 6` after the vertical pass gives every fx / fy
// case exactly, as the plain version (ops/mc.py) computes it. Reference
// samples are clamped per sample to the coded picture (pic_w x pic_h).
// The default combine of spec 8.5.4.2.5.2 (`_combine` without weights)
// takes (p + 32) >> 6 of one list or (p0 + p1 + 64) >> 7 of both. Used by
// K13 (csrc/me.cu), K15 (csrc/inter_decide.cu), K17 (csrc/inter_code.cu)
// and, through `ks_inter_mc`, K18. Explicit weighted prediction (spec
// 8.5.3.3.4.3, `_combine` with weights and `_cell_w`) is `ks_mc_pred_wp`,
// which only `ks_inter_mc`'s weighted instantiation runs: K13 and K15
// search and decide on the unweighted prediction, as the reference does.
#pragma once

#include "common.cuh"

static __constant__ int ks_luma_filter[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}};

static __constant__ int ks_chroma_filter[8][4] = {
    {0, 64, 0, 0},   {-2, 58, 10, -2}, {-4, 54, 16, -2}, {-6, 46, 28, -4},
    {-4, 36, 36, -4}, {-4, 28, 46, -6}, {-2, 16, 54, -4}, {-2, 10, 58, -2}};

// 14-bit prediction of sample (y, x) of the block at (by, bx) of plane
// `ref` (row stride `stride`) with motion (mvx, mvy): quarter-pel for luma,
// eighth-pel for chroma.
static __device__ int ks_mc_sample(const uint8_t* ref, int stride, int pic_w,
                                   int pic_h, int by, int bx, int mvx,
                                   int mvy, bool luma, int y, int x) {
  const int fb = luma ? 2 : 3, taps = luma ? 8 : 4, pad_l = luma ? 3 : 1;
  const int iy = by + (mvy >> fb) - pad_l + y;
  const int ix = bx + (mvx >> fb) - pad_l + x;
  const int fy = mvy & ((1 << fb) - 1), fx = mvx & ((1 << fb) - 1);
  int v = 0;
  for (int k = 0; k < taps; k++) {
    const uint8_t* row = ref + (size_t)ks_clip3(0, pic_h - 1, iy + k) * stride;
    int h = 0;
    for (int j = 0; j < taps; j++) {
      const int c = luma ? ks_luma_filter[fx][j] : ks_chroma_filter[fx][j];
      h += c * row[ks_clip3(0, pic_w - 1, ix + j)];
    }
    v += (luma ? ks_luma_filter[fy][k] : ks_chroma_filter[fy][k]) * h;
  }
  return v >> 6;
}

// Default uni-prediction combine of a 14-bit sample to 8 bits.
static __device__ __forceinline__ int ks_mc_uni(int p) {
  return ks_clip3(0, 255, (p + 32) >> 6);
}

// Default bi-prediction combine of two 14-bit samples to 8 bits.
static __device__ __forceinline__ int ks_mc_bi(int p0, int p1) {
  return ks_clip3(0, 255, (p0 + p1 + 64) >> 7);
}

// 8-bit prediction of sample (y, x) of the block at (by, bx) from a
// reference stack `base` (`plane` samples per reference, row stride
// `stride`) with the list 0 motion (s0, mx0, my0) and, where kL1, the list
// 1 motion (s1, mx1, my1), as `_combine` picks it: both slots >= 0 average,
// a slot >= 0 of list 0 alone is list 0's, otherwise list 1's (slot -1
// reads reference 0). Without kL1, list 0's at slot max(s0, 0).
template <bool kL1>
static __device__ __forceinline__ int ks_mc_pred(
    const uint8_t* base, size_t plane, int stride, int pic_w, int pic_h,
    int by, int bx, int s0, int mx0, int my0, int s1, int mx1, int my1,
    bool luma, int y, int x) {
  if (kL1 && s1 >= 0 && s0 >= 0)
    return ks_mc_bi(
        ks_mc_sample(base + (size_t)s0 * plane, stride, pic_w, pic_h, by, bx,
                     mx0, my0, luma, y, x),
        ks_mc_sample(base + (size_t)s1 * plane, stride, pic_w, pic_h, by, bx,
                     mx1, my1, luma, y, x));
  if (!kL1 || s0 >= 0)
    return ks_mc_uni(ks_mc_sample(base + (size_t)max(s0, 0) * plane, stride,
                                  pic_w, pic_h, by, bx, mx0, my0, luma, y,
                                  x));
  return ks_mc_uni(ks_mc_sample(base + (size_t)max(s1, 0) * plane, stride,
                                pic_w, pic_h, by, bx, mx1, my1, luma, y, x));
}

// Explicit weighted prediction of sample (y, x): `wp` is the int32 table
// of ops/mc.py::wp_table, (2, R, 3, 3) of (flag, weight, offset) per list,
// slot and component, then log2Wd per component. A list whose slot carries
// the component's flag takes its weight and offset, otherwise the spec's
// default 2^(log2Wd - 6) and 0, which reproduce the default combine (the
// reference's `_cell_w` takes 64, right only at denominator 6). Both lists: (p0 w0 + p1 w1 +
// ((o0 + o1 + 1) << lwd)) >> (lwd + 1); one: ((p w + 2^(lwd-1)) >> lwd)
// + o (p w + o at lwd 0); then the clip to 8 bits. The slots pick the
// lists as `ks_mc_pred` does.
template <bool kL1>
static __device__ __forceinline__ int ks_mc_pred_wp(
    const uint8_t* base, size_t plane, int stride, int pic_w, int pic_h,
    int by, int bx, int s0, int mx0, int my0, int s1, int mx1, int my1,
    bool luma, int comp, const int* wp, int R, int y, int x) {
  const int lwd = wp[2 * R * 9 + comp];
  auto weight = [&](int list, int s, int* w, int* o) {
    const int* e = wp + ((list * R + max(s, 0)) * 3 + comp) * 3;
    const bool f = s >= 0 && e[0] != 0;
    *w = f ? e[1] : 1 << (lwd - 6);
    *o = f ? e[2] : 0;
  };
  auto uni = [&](int p, int w, int o) {
    const int v = lwd >= 1 ? ((p * w + (1 << (lwd - 1))) >> lwd) + o
                           : p * w + o;
    return ks_clip3(0, 255, v);
  };
  int w0, o0;
  weight(0, s0, &w0, &o0);
  if (kL1 && s1 >= 0 && s0 >= 0) {
    int w1, o1;
    weight(1, s1, &w1, &o1);
    const int p0 = ks_mc_sample(base + (size_t)s0 * plane, stride, pic_w,
                                pic_h, by, bx, mx0, my0, luma, y, x);
    const int p1 = ks_mc_sample(base + (size_t)s1 * plane, stride, pic_w,
                                pic_h, by, bx, mx1, my1, luma, y, x);
    return ks_clip3(0, 255,
                    (p0 * w0 + p1 * w1 + ((o0 + o1 + 1) << lwd)) >> (lwd + 1));
  }
  if (!kL1 || s0 >= 0)
    return uni(ks_mc_sample(base + (size_t)max(s0, 0) * plane, stride, pic_w,
                            pic_h, by, bx, mx0, my0, luma, y, x),
               w0, o0);
  int w1, o1;
  weight(1, s1, &w1, &o1);
  return uni(ks_mc_sample(base + (size_t)max(s1, 0) * plane, stride, pic_w,
                          pic_h, by, bx, mx1, my1, luma, y, x),
             w1, o1);
}
