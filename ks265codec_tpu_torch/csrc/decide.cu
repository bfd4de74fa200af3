// K5 — intra mode and split decision of a batch of frames.
//
// Replaces ks265codec_tpu/ops/decide.py::decide_frames_jit at effort 0
// and effort 1, with its NxN tier (`_decide_one`, `_size_decision`,
// `_size4_luma`, `_chroma_and_cost`, `_rough_tu_cost`, `_mpm_lists`,
// `_source_refs`, `_filter_refs`). Per CU tier (16, then 8 and 32:
// seeded from the 16 tier's winners at effort 0, a full sweep at effort
// 1), with one thread block per CU and the frame on blockIdx.y:
//   pass A: source-pixel refs, [1 2 1] filtering, prediction of the
//           candidate modes, 8x8 Hadamard SATD, the SATD-only winner best0;
//   pass B: MPM lists from the best0 grid, the mode costs
//           satd + ls * mode_bits; the rough transform/quant cost of the
//           best one (effort 0) or of the 3 best, ties to the lower mode,
//           judged by D + lam * (R + mode_bits) (effort 1); the chroma
//           mode: DM (effort 0) or the least satd_cb + satd_cr + ls * bits
//           of planar, 26, 10, DC (34 where equal to DM) and DM (effort
//           1, SATD 4x4 for 4x4 chroma); the chroma rough cost and the
//           cost map;
// with the NxN tier (effort 1), after the 8 tier (which then also writes
// its luma-only cost cl8):
//   nxn A: one thread per 4x4 luma block, the 35 modes' 4x4 SATDs and
//          best0;
//   nxn B: one thread per 8x8 CU, its four PUs' mode and rough cost, and
//          NxN against cl8 (mode4, nxn8, and a new cost8 with NxN's cost
//          where it wins);
// then one block per frame computes the split maps and the frame cost.
//
// The costs are float32 and steer every decision, so they reproduce the
// reference backend's float32 sequence (see ops/decide.py): this file is
// built with --fmad=false and writes each fused multiply-add the
// reference forms with __fmaf_rn; the sums over a block run in one thread
// in the reference's order; argmins take the first minimum (strict <).
//
// Bound: operations — pass A predicts and Hadamard-transforms every
// candidate mode (35 x 256 samples per 16x16 CU at the 16 tier) in
// integer arithmetic; the serial float sums of pass B are small. The NxN
// tier's pass A does the same for 35 x 16 samples per 4x4 block, one
// thread each, with its refs and samples in registers.
#include "common.cuh"

namespace {

// Source-pixel ref i of block (bx, by) of size n (ops/decide._source_refs):
// raster-causal availability, refs layout [left | corner | top].
__device__ __forceinline__ int source_ref(const uint8_t* p, int h, int w,
                                          int n, int bx, int by, int i) {
  const int n2 = 2 * n;
  const bool has_l = bx > 0, has_t = by > 0;
  if (!has_l && !has_t) return 128;
  const int ty = max(by * n - 1, 0), lx = max(bx * n - 1, 0);
  const int l0 = p[min(by * n, h - 1) * w + lx];
  const int t0 = p[ty * w + min(bx * n, w - 1)];
  if (i < n2) return has_l ? p[min(by * n + i, h - 1) * w + lx] : t0;
  if (i == n2) return (has_l && has_t) ? p[ty * w + lx] : (has_t ? t0 : l0);
  return has_t ? p[ty * w + min(bx * n + i - n2 - 1, w - 1)] : l0;
}

// All 4n + 1 refs of block (bx, by), by the block's threads. Ends
// synchronised.
__device__ void source_refs(const uint8_t* p, int h, int w, int n, int bx,
                            int by, int* ru) {
  for (int i = threadIdx.x; i < 4 * n + 1; i += blockDim.x)
    ru[i] = source_ref(p, h, w, n, bx, by, i);
  __syncthreads();
}

// Candidates of a seeded tier (the parent mode, its two angular
// neighbours, planar, DC, vertical, horizontal), or all 35 modes.
__device__ __forceinline__ bool is_candidate(int m, int par, int seeded) {
  if (!seeded) return true;
  const int ang = par < 2 ? 2 : par;
  const int c1 = par >= 2 ? 2 + ((ang - 2 + 1) % 33) : 0;
  const int c2 = par >= 2 ? 2 + ((ang - 2 + 32) % 33) : 1;
  return m == par || m == c1 || m == c2 || m == 0 || m == 1 || m == 26 ||
         m == 10;
}

// Seed of block (bx, by): the 8 tier takes its 16-block's mode, the 32
// tier the mode of its top-left 16-block.
__device__ __forceinline__ int parent_mode(const int* mode16, int n, int bx,
                                           int by, int w16) {
  return n == 8 ? mode16[(by >> 1) * w16 + (bx >> 1)]
                : mode16[(2 * by) * w16 + 2 * bx];
}

struct PassA {
  int ru[4 * KS_MAX_N + 1];
  int rf[4 * KS_MAX_N + 1];
  int part[35][16];
  int sum[35];
};

__global__ void pass_a_kernel(const uint8_t* planes, const int* mode16,
                              int* satd_out, int* best0_out, const int* tab,
                              int H, int W, int n, int seeded) {
  __shared__ PassA s;
  const int f = blockIdx.y, b = blockIdx.x, nb = gridDim.x;
  const int nbx = W / n, bx = b % nbx, by = b / nbx;
  const uint8_t* p = planes + (size_t)f * H * W;
  source_refs(p, H, W, n, bx, by, s.ru);
  ks_smooth_refs(s.ru, s.rf, n);
  const int par =
      seeded ? parent_mode(mode16 + (size_t)f * (H / 16) * (W / 16), n, bx,
                           by, W / 16)
             : 0;
  const int per = n / 8, nsub = per * per;
  const int dc = ks_dc_value(s.ru, n);
  for (int t = threadIdx.x; t < 35 * nsub; t += blockDim.x) {
    const int m = t / nsub, sb = t % nsub;
    if (!is_candidate(m, par, seeded)) continue;
    const int oy = (sb / per) * 8, ox = (sb % per) * 8;
    int d[64];
    for (int k = 0; k < 64; k++) {
      const int y = oy + k / 8, x = ox + k % 8;
      d[k] = (int)p[(by * n + y) * W + bx * n + x] -
             ks_pred_pixel(tab, m, n, true, s.ru, s.rf, dc, y, x);
    }
    s.part[m][sb] = ks_satd8(d);
  }
  __syncthreads();
  for (int m = threadIdx.x; m < 35; m += blockDim.x) {
    int sum = 0;
    if (is_candidate(m, par, seeded))
      for (int sb = 0; sb < nsub; sb++) sum += s.part[m][sb];
    s.sum[m] = sum;
    satd_out[((size_t)f * nb + b) * 35 + m] = sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int best = -1;
    for (int m = 0; m < 35; m++)
      if (is_candidate(m, par, seeded) &&
          (best < 0 || s.sum[m] < s.sum[best]))
        best = m;
    best0_out[(size_t)f * nb + b] = best;
  }
}

struct PassB {
  int ru[4 * KS_MAX_N + 1];
  int rf[4 * KS_MAX_N + 1];
  int res[KS_MAX_N * KS_MAX_N];
  int tmp[KS_MAX_N * KS_MAX_N];
  int coef[KS_MAX_N * KS_MAX_N];
  float sq[KS_MAX_N * KS_MAX_N];
  float bits[KS_MAX_N * KS_MAX_N];
  float D, R, mode_bits, cmode_bits;
  int best, cmode, ncand;
  int cand[3];
  float cbits[3], cD[3], cR[3];
  int ccand[5];
  int csatd[2][5][4];             // plane, candidate, 8x8 or 4x4 sub-block
};

// Residual of plane block (bx, by) of size n against the prediction of
// `mode` from source refs (luma refs are also [1 2 1] filtered).
__device__ void source_residual(const int* tab, const uint8_t* p, int h,
                                int w, int n, int bx, int by, int mode,
                                bool luma, PassB& s) {
  source_refs(p, h, w, n, bx, by, s.ru);
  if (luma) ks_smooth_refs(s.ru, s.rf, n);
  const int* rf = luma ? s.rf : s.ru;
  const int dc = ks_dc_value(s.ru, n);
  for (int q = threadIdx.x; q < n * n; q += blockDim.x) {
    const int y = q / n, x = q % n;
    s.res[q] = (int)p[(by * n + y) * w + bx * n + x] -
               ks_pred_pixel(tab, mode, n, luma, s.ru, rf, dc, y, x);
  }
  __syncthreads();
}

// Rough RD of s.res (ops/decide._rough_tu_cost): real forward transform +
// deadzone quant, coefficient-domain dequant error as distortion, the
// level-rate table as rate. Adds (D, R) to s.D / s.R in float32.
__device__ void rough_cost(const int* tab, const float* btab, int n, int qp,
                           PassB& s) {
  ks_fwd_dct(tab, n, s.res, s.tmp, s.coef);
  const int log2 = ks_log2(n);
  for (int q = threadIdx.x; q < n * n; q += blockDim.x) {
    const int a = abs(s.coef[q]);
    const int lev = ks_quant_abs(tab, a, qp, log2);
    const float derr = (float)(a - ks_dequant(tab, lev, qp, log2));
    s.sq[q] = derr * derr;
    s.bits[q] = btab[lev];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float D = ks_block_sum(s.sq, n) * ldexpf(1.f, 2 * log2 - 14);
    const float R = ks_block_sum(s.bits, n);
    s.D = s.D + D;
    s.R = s.R + R;
  }
  __syncthreads();
}

// 4x4 Hadamard SATD of d (= src - pred), HM normalisation (sum + 1) >> 1.
static __device__ int satd4(int* d) {
  for (int r = 0; r < 4; r++)
    for (int h = 1; h < 4; h <<= 1)
      for (int i = 0; i < 4; i += 2 * h)
        for (int j = i; j < i + h; j++) {
          const int a = d[4 * r + j], b = d[4 * r + j + h];
          d[4 * r + j] = a + b;
          d[4 * r + j + h] = a - b;
        }
  int s = 0;
  for (int c = 0; c < 4; c++) {
    for (int h = 1; h < 4; h <<= 1)
      for (int i = 0; i < 4; i += 2 * h)
        for (int j = i; j < i + h; j++) {
          const int a = d[4 * j + c], b = d[4 * (j + h) + c];
          d[4 * j + c] = a + b;
          d[4 * (j + h) + c] = a - b;
        }
    for (int r = 0; r < 4; r++) s += abs(d[4 * r + c]);
  }
  return (s + 1) >> 1;
}

// SATD of the nc x nc chroma block (bx, by) of plane p against each of the
// 5 chroma candidates' predictions from its source refs (4x4 Hadamard for
// nc = 4, else 8x8 tiles), per tile into s.csatd[c]. Ends synchronised.
__device__ void chroma_satds(const int* tab, const uint8_t* p, int h, int w,
                             int nc, int bx, int by, int c, PassB& s) {
  source_refs(p, h, w, nc, bx, by, s.ru);
  const int dc = ks_dc_value(s.ru, nc);
  const int t = nc < 8 ? 4 : 8, per = nc / t, nsub = per * per;
  for (int i = threadIdx.x; i < 5 * nsub; i += blockDim.x) {
    const int k = i / nsub, sb = i % nsub;
    const int oy = (sb / per) * t, ox = (sb % per) * t;
    int d[64];
    for (int q = 0; q < t * t; q++) {
      const int y = oy + q / t, x = ox + q % t;
      d[q] = (int)p[(by * nc + y) * w + bx * nc + x] -
             ks_pred_pixel(tab, s.ccand[k], nc, false, s.ru, s.ru, dc, y, x);
    }
    s.csatd[c][k][sb] = t == 4 ? satd4(d) : ks_satd8(d);
  }
  __syncthreads();
}

// kEffort is a template argument so that the effort-0 instantiation
// carries none of the chroma search's code (registers, local arrays);
// kLumaCost (the 8 tier under the NxN tier) also writes the luma-only cost
// D + lam * ((R + mode_bits) + hdr) to cl_out, taken before chroma is
// added, as a template argument too: a run-time mode argument in this
// kernel cost time.
template <int kEffort, bool kLumaCost>
__global__ void pass_b_kernel(const uint8_t* py, const uint8_t* pcb,
                              const uint8_t* pcr, const int* satd,
                              const int* best0, const int* mode16,
                              const int* qp, const int* qpc,
                              const float* lam, const float* ls,
                              const float* btab, const int* tab,
                              int* mode_out, float* cost_out, int* cmode_out,
                              float* cl_out, int H, int W, int n,
                              int seeded) {
  __shared__ PassB s;
  const int f = blockIdx.y, b = blockIdx.x, nb = gridDim.x;
  const int nbx = W / n, bx = b % nbx, by = b / nbx;
  if (threadIdx.x == 0) {
    const int* b0 = best0 + (size_t)f * nb;
    // MPM lists (spec 8.4.2) from the best0 grid; an above neighbour in
    // another CTB row counts as DC
    const int a = bx > 0 ? b0[b - 1] : 1;
    const int c = (by > 0 && (by * n) % 64 != 0) ? b0[b - nbx] : 1;
    int m0, m1, m2;
    if (a == c) {
      m0 = a >= 2 ? a : 0;
      m1 = a >= 2 ? 2 + ((a + 29) % 32) : 1;
      m2 = a >= 2 ? 2 + ((a - 1) % 32) : 26;
    } else {
      m0 = a;
      m1 = c;
      m2 = (a != 0 && c != 0) ? 0 : ((a != 1 && c != 1) ? 1 : 26);
    }
    const int par =
        seeded ? parent_mode(mode16 + (size_t)f * (H / 16) * (W / 16), n,
                             bx, by, W / 16)
               : 0;
    const int* st = satd + ((size_t)f * nb + b) * 35;
    float j[35], mb[35];
    for (int m = 0; m < 35; m++) {
      mb[m] = m == m0 ? 2.f : ((m == m1 || m == m2) ? 3.f : 6.f);
      j[m] = __fmaf_rn(ls[f], mb[m], (float)st[m]);
    }
    // the rough-RD candidates: the K best modes in order, ties to the
    // lower mode (the reference backend's top-k)
    const int K = kEffort ? 3 : 1;
    unsigned long long taken = 0;        // 35 modes
    for (int k = 0; k < K; k++) {
      int best = -1;
      for (int m = 0; m < 35; m++) {
        if (!is_candidate(m, par, seeded) || ((taken >> m) & 1ull)) continue;
        if (best < 0 || j[m] < j[best]) best = m;
      }
      taken |= 1ull << best;
      s.cand[k] = best;
      s.cbits[k] = mb[best];
    }
    s.ncand = K;
  }
  __syncthreads();
  const uint8_t* ply = py + (size_t)f * H * W;
  for (int k = 0; k < s.ncand; k++) {
    if (threadIdx.x == 0) s.D = s.R = 0.f;
    source_residual(tab, ply, H, W, n, bx, by, s.cand[k], true, s);
    rough_cost(tab, btab, n, qp[f], s);
    if (threadIdx.x == 0) {
      s.cD[k] = s.D;
      s.cR[k] = s.R;
    }
  }
  const int Hc = H / 2, Wc = W / 2, nc = n / 2;
  const uint8_t* cps[2] = {pcb + (size_t)f * Hc * Wc,
                           pcr + (size_t)f * Hc * Wc};
  if (threadIdx.x == 0) {
    int ki = 0;
    float bj = 0.f;
    for (int k = 0; k < s.ncand; k++) {
      const float jk = __fmaf_rn(lam[f], s.cR[k] + s.cbits[k], s.cD[k]);
      if (k == 0 || jk < bj) {
        ki = k;
        bj = jk;
      }
    }
    s.best = s.cand[ki];
    s.mode_bits = s.cbits[ki];
    s.D = s.cD[ki];
    s.R = s.cR[ki];
    const int fixed[4] = {0, 26, 10, 1};
    for (int k = 0; k < 4; k++)
      s.ccand[k] = fixed[k] == s.best ? 34 : fixed[k];
    s.ccand[4] = s.best;
    s.cmode = s.best;
    s.cmode_bits = 1.f;
    if (kLumaCost) {
      const float hdr = n == 8 ? 7.f : (n == 16 ? 5.f : 4.f);
      cl_out[(size_t)f * nb + b] =
          __fmaf_rn(lam[f], (s.R + s.mode_bits) + hdr, s.D);
    }
  }
  __syncthreads();
  if (kEffort) {
    for (int c = 0; c < 2; c++)
      chroma_satds(tab, cps[c], Hc, Wc, nc, bx, by, c, s);
    if (threadIdx.x == 0) {
      const int nsub = nc < 8 ? 1 : (nc / 8) * (nc / 8);
      float bj = 0.f;
      for (int k = 0; k < 5; k++) {
        int cb = 0, cr = 0;
        for (int sb = 0; sb < nsub; sb++) {
          cb += s.csatd[0][k][sb];
          cr += s.csatd[1][k][sb];
        }
        const float bits = k < 4 ? 7.f : 1.f;
        const float cj =
            __fmaf_rn(ls[f], bits, (0.f + (float)cb) + (float)cr);
        if (k == 0 || cj < bj) {
          bj = cj;
          s.cmode = s.ccand[k];
          s.cmode_bits = bits;
        }
      }
    }
    __syncthreads();
  }
  const int cmode = s.cmode;
  for (int c = 0; c < 2; c++) {
    source_residual(tab, cps[c], Hc, Wc, nc, bx, by, cmode, false, s);
    rough_cost(tab, btab, nc, qpc[f], s);
  }
  if (threadIdx.x == 0) {
    // effort 0: the DM bit folded into the header bits, as the reference
    // does; effort 1: ((R + mode bits) + chroma bits) + header bits
    const float hdr = n == 8 ? 7.f : (n == 16 ? 5.f : 4.f);
    const float rtot = kEffort ? ((s.R + s.mode_bits) + s.cmode_bits) + hdr
                               : (s.R + s.mode_bits) + (1.f + hdr);
    mode_out[(size_t)f * nb + b] = s.best;
    cmode_out[(size_t)f * nb + b] = cmode;
    cost_out[(size_t)f * nb + b] = __fmaf_rn(lam[f], rtot, s.D);
  }
}

// The NxN tier (ops/decide._size4_luma and nxn_plain), pass A: one thread
// per 4x4 luma block predicts all 35 modes from its unsmoothed source refs
// (luma DC / H / V edge filters) and writes their 4x4 Hadamard SATDs and
// best0, the SATD-only winner (the first minimum).
__global__ void nxn_a_kernel(const uint8_t* planes, int* satd_out,
                             int* best0_out, const int* tab, int H, int W) {
  const int f = blockIdx.y, nbx = W / 4, nb = nbx * (H / 4);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const int bx = b % nbx, by = b / nbx;
  const uint8_t* p = planes + (size_t)f * H * W;
  int ru[17], src[16];
  for (int i = 0; i < 17; i++) ru[i] = source_ref(p, H, W, 4, bx, by, i);
  for (int q = 0; q < 16; q++)
    src[q] = p[(by * 4 + q / 4) * W + bx * 4 + q % 4];
  const int dc = ks_dc_value(ru, 4);
  int* out = satd_out + ((size_t)f * nb + b) * 35;
  int best = 0, best_satd = 0;
  for (int m = 0; m < 35; m++) {
    int d[16];
    for (int q = 0; q < 16; q++)
      d[q] = src[q] - ks_pred_pixel(tab, m, 4, true, ru, ru, dc, q / 4, q % 4);
    const int v = satd4(d);
    out[m] = v;
    if (m == 0 || v < best_satd) {
      best = m;
      best_satd = v;
    }
  }
  best0_out[(size_t)f * nb + b] = best;
}

// Pass B: one thread per 8x8 CU. For each of its four 4x4 PUs in raster
// order: the MPM lists from the best0 grid (an above neighbour in another
// CTB row counts as DC), the least fma(ls, mode_bits, satd), the winner's
// rough cost (4x4 DCT, deadzone quantisation, dequantisation error and
// level bits, summed in the order of ks_block_sum) and the running total
// acc = fma(lam, (R + mode_bits) + 1, acc + D), the order the reference
// backend's fused loop takes. NxN wins where acc + lam * 16 < cl8; there
// the cost becomes (cost8 - cl8) + that, elsewhere it stays cost8.
__global__ void nxn_b_kernel(const uint8_t* planes, const int* satd,
                             const int* best0, const int* qp,
                             const float* lam, const float* ls,
                             const float* btab, const int* tab,
                             const float* cl8, const float* cost8,
                             float* cost8_out, int* mode4_out,
                             uint8_t* nxn8_out, int H, int W) {
  const int f = blockIdx.y, w8 = W / 8, n8 = w8 * (H / 8);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n8) return;
  const int cx = c % w8, cy = c / w8;
  const int nbx = W / 4, nb = nbx * (H / 4);
  const uint8_t* p = planes + (size_t)f * H * W;
  const int* b0 = best0 + (size_t)f * nb;
  const int* T = tab + T_DCT4;
  const float lf = lam[f], lsf = ls[f];
  const int q = qp[f];
  float acc = 0.f;
  for (int k = 0; k < 4; k++) {
    const int bx = 2 * cx + (k & 1), by = 2 * cy + (k >> 1);
    const int b = by * nbx + bx;
    const int a = bx > 0 ? b0[b - 1] : 1;
    const int u = (by > 0 && (by * 4) % 64 != 0) ? b0[b - nbx] : 1;
    int m0, m1, m2;
    if (a == u) {
      m0 = a >= 2 ? a : 0;
      m1 = a >= 2 ? 2 + ((a + 29) % 32) : 1;
      m2 = a >= 2 ? 2 + ((a - 1) % 32) : 26;
    } else {
      m0 = a;
      m1 = u;
      m2 = (a != 0 && u != 0) ? 0 : ((a != 1 && u != 1) ? 1 : 26);
    }
    const int* st = satd + ((size_t)f * nb + b) * 35;
    int best = 0;
    float bj = 0.f, mbits = 0.f;
    for (int m = 0; m < 35; m++) {
      const float mb = m == m0 ? 2.f : ((m == m1 || m == m2) ? 3.f : 6.f);
      const float j = __fmaf_rn(lsf, mb, (float)st[m]);
      if (m == 0 || j < bj) {
        best = m;
        bj = j;
        mbits = mb;
      }
    }
    mode4_out[(size_t)f * nb + b] = best;
    int ru[17], res[16], tmp[16];
    for (int i = 0; i < 17; i++) ru[i] = source_ref(p, H, W, 4, bx, by, i);
    const int dc = ks_dc_value(ru, 4);
    for (int i = 0; i < 16; i++)
      res[i] = (int)p[(by * 4 + i / 4) * W + bx * 4 + i % 4] -
               ks_pred_pixel(tab, best, 4, true, ru, ru, dc, i / 4, i % 4);
    // forward 4x4 DCT with the HM staged shifts (1, then 8), as ks_fwd_dct
    for (int i = 0; i < 16; i++) {
      const int r = i / 4, cc = i % 4;
      int s = 0;
      for (int j = 0; j < 4; j++) s += T[r * 4 + j] * res[j * 4 + cc];
      tmp[i] = (s + 1) >> 1;
    }
    float sq[16], bits[16];
    for (int i = 0; i < 16; i++) {
      const int r = i / 4, l = i % 4;
      int s = 0;
      for (int j = 0; j < 4; j++) s += tmp[r * 4 + j] * T[l * 4 + j];
      const int av = abs((s + 128) >> 8);
      const int lev = ks_quant_abs(tab, av, q, 2);
      const float derr = (float)(av - ks_dequant(tab, lev, q, 2));
      sq[i] = derr * derr;
      bits[i] = btab[lev];
    }
    const float D = ks_block_sum(sq, 4) * ldexpf(1.f, -10);
    const float rate = (ks_block_sum(bits, 4) + mbits) + 1.f;
    acc = __fmaf_rn(lf, rate, acc + D);
  }
  const float nxn_cost = acc + lf * 16.f;
  const size_t o = (size_t)f * n8 + c;
  const bool win = nxn_cost < cl8[o];
  nxn8_out[o] = win ? 1 : 0;
  cost8_out[o] = win ? (cost8[o] - cl8[o]) + nxn_cost : cost8[o];
}

// Split maps and the frame cost of one frame (ops/decide._splits).
__global__ void split_kernel(const float* cost8, const float* cost16,
                             const float* cost32, uint8_t* split16,
                             uint8_t* split32, float* cplx, float* mins,
                             int h8, int w8) {
  const int f = blockIdx.x;
  const int h16 = h8 / 2, w16 = w8 / 2, h32 = h8 / 4, w32 = w8 / 4;
  const float* c8 = cost8 + (size_t)f * h8 * w8;
  const float* c16 = cost16 + (size_t)f * h16 * w16;
  const float* c32 = cost32 + (size_t)f * h32 * w32;
  float* mn = mins + (size_t)f * h32 * w32;
  auto sum8 = [&](int i, int j) {      // 2x2 of cost8 under 16-block (i, j)
    const float* r0 = c8 + (2 * i) * w8 + 2 * j;
    const float* r1 = r0 + w8;
    return ((r0[0] + r0[1]) + r1[0]) + r1[1];
  };
  for (int t = threadIdx.x; t < h16 * w16; t += blockDim.x)
    split16[(size_t)f * h16 * w16 + t] =
        sum8(t / w16, t % w16) < c16[t] ? 1 : 0;
  for (int t = threadIdx.x; t < h32 * w32; t += blockDim.x) {
    const int I = t / w32, J = t % w32;
    float b[4];
    for (int k = 0; k < 4; k++) {
      const int i = 2 * I + k / 2, j = 2 * J + k % 2;
      b[k] = fminf(sum8(i, j), c16[i * w16 + j]);
    }
    const float c16sum = ((b[0] + b[1]) + b[2]) + b[3];
    split32[(size_t)f * h32 * w32 + t] = c16sum < c32[t] ? 1 : 0;
    mn[t] = fminf(c16sum, c32[t]);
  }
  __syncthreads();
  __shared__ float g[1024];
  if (threadIdx.x == 0) {
    // with a side above 32, first the reference backend's tree rewrite:
    // windows of min(side, 32), padded evenly on both sides, each summed
    // in row-major order from 0; else the map itself
    const bool split = h32 > 32 || w32 > 32;
    const int wh = split && h32 > 32 ? 32 : (split ? h32 : 1);
    const int ww = split && w32 > 32 ? 32 : (split ? w32 : 1);
    const int ph = (wh - h32 % wh) % wh, pw = (ww - w32 % ww) % ww;
    const int gh = (h32 + ph) / wh, gw = (w32 + pw) / ww;
    for (int wy = 0; wy < gh; wy++)
      for (int wx = 0; wx < gw; wx++) {
        float acc = 0.f;
        for (int i = 0; i < wh; i++)
          for (int j = 0; j < ww; j++) {
            const int r = wy * wh + i - ph / 2, c = wx * ww + j - pw / 2;
            if (r >= 0 && r < h32 && c >= 0 && c < w32)
              acc = acc + mn[r * w32 + c];
          }
        g[wy * gw + wx] = acc;
      }
    // then the order of the reference backend's vectorised loop at this
    // shape (ops/decide._frame_sum)
    float rows[8];
    if (gw > 8) {
      float acc = 0.f;
      for (int r = 0; r < gh; r++) {
        for (int k = 0; k < 8; k++) rows[k] = k == 0 ? acc : 0.f;
        for (int c = 0; c < gw; c++) rows[c % 8] = rows[c % 8] + g[r * gw + c];
        for (int h = 4; h >= 1; h >>= 1)
          for (int i = 0; i < h; i++) rows[i] = rows[i] + rows[i + h];
        acc = rows[0];
      }
      rows[0] = acc;
    } else if (gh == 4 || gh == 8) {
      for (int r = 0; r < gh; r++) {
        float acc = g[r * gw];
        for (int c = 1; c < gw; c++) acc = acc + g[r * gw + c];
        rows[r] = acc;
      }
      for (int h = gh / 2; h >= 1; h >>= 1)
        for (int i = 0; i < h; i++) rows[i] = rows[i] + rows[i + h];
    } else {
      float acc = g[0];
      for (int i = 1; i < gh * gw; i++) acc = acc + g[i];
      rows[0] = acc;
    }
    cplx[f] = rows[0];
  }
}

}  // namespace

extern "C" int ks_decide_pass_a(const void* planes, const void* mode16,
                                void* satd, void* best0, const void* tab,
                                int F, int H, int W, int n, int seeded,
                                void* stream) {
  const int nb = (H / n) * (W / n);
  if (F <= 0 || nb <= 0) return 0;
  pass_a_kernel<<<dim3(nb, F), 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)planes, (const int*)mode16, (int*)satd, (int*)best0,
      (const int*)tab, H, W, n, seeded);
  return (int)cudaGetLastError();
}

// cl_out: null, or (with effort 1) where the luma-only costs go.
extern "C" int ks_decide_pass_b(const void* py, const void* pcb,
                                const void* pcr, const void* satd,
                                const void* best0, const void* mode16,
                                const void* qp, const void* qpc,
                                const void* lam, const void* ls,
                                const void* btab, const void* tab,
                                void* mode_out, void* cost_out,
                                void* cmode_out, void* cl_out, int F, int H,
                                int W, int n, int seeded, int effort,
                                void* stream) {
  const int nb = (H / n) * (W / n);
  if (F <= 0 || nb <= 0) return 0;
  if (cl_out && !effort) return (int)cudaErrorInvalidValue;
  auto kernel = cl_out ? pass_b_kernel<1, true>
                       : (effort ? pass_b_kernel<1, false>
                                 : pass_b_kernel<0, false>);
  kernel<<<dim3(nb, F), 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)py, (const uint8_t*)pcb, (const uint8_t*)pcr,
      (const int*)satd, (const int*)best0, (const int*)mode16,
      (const int*)qp, (const int*)qpc, (const float*)lam, (const float*)ls,
      (const float*)btab, (const int*)tab, (int*)mode_out, (float*)cost_out,
      (int*)cmode_out, (float*)cl_out, H, W, n, seeded);
  return (int)cudaGetLastError();
}

extern "C" int ks_decide_nxn_a(const void* planes, void* satd, void* best0,
                               const void* tab, int F, int H, int W,
                               void* stream) {
  const int nb = (H / 4) * (W / 4);
  if (F <= 0 || nb <= 0) return 0;
  nxn_a_kernel<<<dim3((nb + 127) / 128, F), 128, 0,
                 (cudaStream_t)stream>>>((const uint8_t*)planes, (int*)satd,
                                         (int*)best0, (const int*)tab, H, W);
  return (int)cudaGetLastError();
}

extern "C" int ks_decide_nxn_b(const void* planes, const void* satd,
                               const void* best0, const void* qp,
                               const void* lam, const void* ls,
                               const void* btab, const void* tab,
                               const void* cl8, const void* cost8,
                               void* cost8_out, void* mode4, void* nxn8,
                               int F, int H, int W, void* stream) {
  const int n8 = (H / 8) * (W / 8);
  if (F <= 0 || n8 <= 0) return 0;
  nxn_b_kernel<<<dim3((n8 + 127) / 128, F), 128, 0,
                 (cudaStream_t)stream>>>(
      (const uint8_t*)planes, (const int*)satd, (const int*)best0,
      (const int*)qp, (const float*)lam, (const float*)ls,
      (const float*)btab, (const int*)tab, (const float*)cl8,
      (const float*)cost8, (float*)cost8_out, (int*)mode4, (uint8_t*)nxn8,
      H, W);
  return (int)cudaGetLastError();
}

extern "C" int ks_decide_split(const void* cost8, const void* cost16,
                               const void* cost32, void* split16,
                               void* split32, void* cplx, void* mins, int F,
                               int h8, int w8, void* stream) {
  if (F <= 0) return 0;
  // one level of windows (g[] and rows[] sizes)
  if (h8 / 4 > 1024 || w8 / 4 > 1024) return (int)cudaErrorInvalidValue;
  split_kernel<<<F, 256, 0, (cudaStream_t)stream>>>(
      (const float*)cost8, (const float*)cost16, (const float*)cost32,
      (uint8_t*)split16, (uint8_t*)split32, (float*)cplx, (float*)mins, h8,
      w8);
  return (int)cudaGetLastError();
}
