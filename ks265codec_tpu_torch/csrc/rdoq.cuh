// K2 — RDOQ-lite level choice and sign-bit hiding of one TU held in shared
// memory by one thread block, replacing
// ks265codec_tpu/encode/rdoq.py::rdoq_jnp (`_rdoq_core`) and
// ks265codec_tpu/encode/sbh.py::apply_sbh_jnp. Used inside the intra scan
// (K6, csrc/intra_scan.cu), the inter coding pass (K17,
// csrc/inter_code.cu) and the standalone launch of csrc/rdoq.cu.
//
//   ks_levels_abs  one thread per coefficient: the level |l| of |c| by
//                  RDOQ (the level among floor(f), floor(f) + 1 and 0 with
//                  the least (f - l)^2 + W * bits(l), a candidate taking
//                  over only where strictly smaller; f is kept for the
//                  group pass) or by deadzone rounding (intra or inter);
//   ks_group_pass  one thread per 4x4 group in raster group layout: RDOQ's
//                  decimation (a group whose only survivors are at most 3
//                  level-1 coefficients below f = 0.9 is zeroed), the
//                  signs, then sign hiding: where the first and last
//                  nonzero coefficients in the TU's 4x4 scan lie more than
//                  3 apart, the parity of the group's level sum must give
//                  the first one's sign, fixed by +-1 on it (toward zero
//                  where |l| > 1, away from zero where |l| == 1).
//
// The float32 steps round once each, as the reference's jitted form does:
// |c| * quantScale is int32, its conversion rounds to nearest even, the
// scale 2^-qbits is exact, and j = d*d + W*bits is two products and a sum
// (__fmul_rn / __fadd_rn, never contracted).
#pragma once

#include "common.cuh"

#define KS_RDOQ 1
#define KS_SBH 2
#define KS_INTER 4

// 4x4 scan index of a TU (the residual syntax's rule, encode/sbh.py
// scan_for): mode-dependent for 4x4 TUs and 8x8 luma TUs.
static __device__ __forceinline__ int ks_scan_idx(int mode, int log2,
                                                  int c_idx) {
  if (!(log2 == 2 || (log2 == 3 && c_idx == 0))) return 0;
  if (mode >= 6 && mode <= 14) return 2;
  if (mode >= 22 && mode <= 30) return 1;
  return 0;
}

// RDOQ level of |c| = a at this QP; *fo receives the continuous level f.
static __device__ __forceinline__ int ks_rdoq_abs(const int* tab, int a,
                                                  int qp, int log2,
                                                  float* fo) {
  const int qbits = 29 + qp / 6 - 8 - log2;
  const int t = a * tab[T_QUANT + qp % 6];
  const float f = __fmul_rn(__int2float_rn(t),
                            __int_as_float((127 - qbits) << 23));
  *fo = f;
  const int lf = (int)floorf(f);
  int best = 0;
  float best_j = __fmul_rn(f, f);
  for (int k = 0; k < 2; k++) {
    const int cand = ks_clip3(0, 32767, lf + k);
    const float d = __fsub_rn(f, (float)cand);
    const int e = cand - 2 > 1 ? cand - 2 : 1;
    const int flog = 31 - __clz(e);            // floor(log2(e)), e < 2^15
    const float bits = (cand >= 1 ? 3.5f : 0.f) + (cand >= 2 ? 1.f : 0.f) +
                       (cand >= 3 ? 1.5f + 2.f * (float)flog : 0.f);
    const float j = __fadd_rn(__fmul_rn(d, d), __fmul_rn(0.09f, bits));
    if (j < best_j) {
      best = cand;
      best_j = j;
    }
  }
  return best;
}

// Levels |l| of the n x n coefficients coef into lev (and RDOQ's f into
// fbuf); all threads, no synchronisation.
static __device__ __forceinline__ void ks_levels_abs(const int* tab,
                                                     const int* coef,
                                                     int* lev, float* fbuf,
                                                     int n, int qp,
                                                     int flags) {
  const int log2 = ks_log2(n);
  for (int p = threadIdx.x; p < n * n; p += blockDim.x) {
    const int a = abs(coef[p]);
    if (flags & KS_RDOQ)
      lev[p] = ks_rdoq_abs(tab, a, qp, log2, &fbuf[p]);
    else if (flags & KS_INTER)
      lev[p] = ks_quant_abs_inter(tab, a, qp, log2);
    else
      lev[p] = ks_quant_abs(tab, a, qp, log2);
  }
}

// Decimation (RDOQ), signs from coef, then sign hiding (scan rank table
// rank: 16 entries [y * 4 + x] of this TU's scan), in place on lev; one
// thread per 4x4 group, no synchronisation.
static __device__ __forceinline__ void ks_group_pass(int* lev,
                                                     const int* coef,
                                                     const float* fbuf,
                                                     int n, int flags,
                                                     const int* rank) {
  const int G = n / 4;
  for (int gi = threadIdx.x; gi < G * G; gi += blockDim.x) {
    const int o = (gi / G) * 4 * n + (gi % G) * 4;
    if (flags & KS_RDOQ) {
      int nz = 0;
      bool weak = true;
      for (int k = 0; k < 16; k++) {
        const int p = o + (k / 4) * n + k % 4;
        nz += lev[p] > 0;
        weak = weak && (lev[p] == 0 || (lev[p] == 1 && fbuf[p] < 0.9f));
      }
      if (nz > 0 && nz <= 3 && weak)
        for (int k = 0; k < 16; k++) lev[o + (k / 4) * n + k % 4] = 0;
    }
    for (int k = 0; k < 16; k++) {
      const int p = o + (k / 4) * n + k % 4;
      if (coef[p] < 0) lev[p] = -lev[p];
    }
    if (!(flags & KS_SBH)) continue;
    int mn = 99, mx = -1, sum = 0, hid = -1;
    for (int k = 0; k < 16; k++) {
      const int p = o + (k / 4) * n + k % 4;
      if (lev[p] == 0) continue;
      const int r = rank[k];
      if (r < mn) {
        mn = r;
        hid = p;
      }
      mx = r > mx ? r : mx;
      sum += abs(lev[p]);
    }
    if (hid < 0 || mx - mn <= 3) continue;
    const int v = lev[hid];
    if ((sum & 1) != (v < 0 ? 1 : 0))
      lev[hid] = v + (abs(v) > 1 ? -ks_sgn(v) : ks_sgn(v));
  }
}
