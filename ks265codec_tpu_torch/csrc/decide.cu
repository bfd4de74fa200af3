// K5 — intra mode and split decision of a batch of frames.
//
// Replaces ks265codec_tpu/ops/decide.py::decide_frames_jit at effort 0
// (`_decide_one`, `_size_decision`, `_chroma_and_cost`, `_rough_tu_cost`,
// `_mpm_lists`, `_source_refs`, `_filter_refs`). Per CU tier (16, then 8
// and 32 seeded from the 16 tier's winners), with one thread block per CU
// and the frame on blockIdx.y:
//   pass A: source-pixel refs, [1 2 1] filtering, prediction of the
//           candidate modes, 8x8 Hadamard SATD, the SATD-only winner best0;
//   pass B: MPM lists from the best0 grid, the argmin of
//           satd + ls * mode_bits, the winner's rough transform/quant cost
//           (luma and DM chroma) and the cost map;
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
// integer arithmetic; the serial float sums of pass B are small.
#include "common.cuh"

namespace {

// Source-pixel refs of block (bx, by) of size n (ops/decide._source_refs):
// raster-causal availability, refs layout [left | corner | top]. Ends
// synchronised.
__device__ void source_refs(const uint8_t* p, int h, int w, int n, int bx,
                            int by, int* ru) {
  const int n2 = 2 * n;
  const bool has_l = bx > 0, has_t = by > 0;
  const int ty = max(by * n - 1, 0), lx = max(bx * n - 1, 0);
  const int l0 = p[min(by * n, h - 1) * w + lx];
  const int t0 = p[ty * w + min(bx * n, w - 1)];
  for (int i = threadIdx.x; i < 4 * n + 1; i += blockDim.x) {
    int v;
    if (!has_l && !has_t)
      v = 128;
    else if (i < n2)
      v = has_l ? p[min(by * n + i, h - 1) * w + lx] : t0;
    else if (i == n2)
      v = (has_l && has_t) ? p[ty * w + lx] : (has_t ? t0 : l0);
    else
      v = has_t ? p[ty * w + min(bx * n + i - n2 - 1, w - 1)] : l0;
    ru[i] = v;
  }
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
  float D, R, mode_bits;
  int best;
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

__global__ void pass_b_kernel(const uint8_t* py, const uint8_t* pcb,
                              const uint8_t* pcr, const int* satd,
                              const int* best0, const int* mode16,
                              const int* qp, const int* qpc,
                              const float* lam, const float* ls,
                              const float* btab, const int* tab,
                              int* mode_out, float* cost_out, int H, int W,
                              int n, int seeded) {
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
    int best = -1;
    float bj = 0.f, bbits = 0.f;
    for (int m = 0; m < 35; m++) {
      if (!is_candidate(m, par, seeded)) continue;
      const float mb = m == m0 ? 2.f : ((m == m1 || m == m2) ? 3.f : 6.f);
      const float j = __fmaf_rn(ls[f], mb, (float)st[m]);
      if (best < 0 || j < bj) {
        best = m;
        bj = j;
        bbits = mb;
      }
    }
    s.best = best;
    s.mode_bits = bbits;
    s.D = 0.f;
    s.R = 0.f;
  }
  __syncthreads();
  const int best = s.best;
  source_residual(tab, py + (size_t)f * H * W, H, W, n, bx, by, best, true,
                  s);
  rough_cost(tab, btab, n, qp[f], s);
  const int Hc = H / 2, Wc = W / 2, nc = n / 2;
  const uint8_t* cps[2] = {pcb, pcr};
  for (int c = 0; c < 2; c++) {
    source_residual(tab, cps[c] + (size_t)f * Hc * Wc, Hc, Wc, nc, bx, by,
                    best, false, s);
    rough_cost(tab, btab, nc, qpc[f], s);
  }
  if (threadIdx.x == 0) {
    // header bits + the DM chroma flag bit, folded as the reference does
    const float hdr = n == 8 ? 8.f : (n == 16 ? 6.f : 5.f);
    const float rtot = (s.R + s.mode_bits) + hdr;
    mode_out[(size_t)f * nb + b] = best;
    cost_out[(size_t)f * nb + b] = __fmaf_rn(lam[f], rtot, s.D);
  }
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
  if (threadIdx.x == 0) {
    // rows summed in order, then the row sums by halving (zero padded)
    float rows[256];
    int p2 = 1;
    while (p2 < h32) p2 <<= 1;
    for (int r = 0; r < p2; r++) {
      float acc = 0.f;
      if (r < h32) {
        acc = mn[r * w32];
        for (int c = 1; c < w32; c++) acc = acc + mn[r * w32 + c];
      }
      rows[r] = acc;
    }
    for (int h = p2 / 2; h >= 1; h >>= 1)
      for (int i = 0; i < h; i++) rows[i] = rows[i] + rows[i + h];
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

extern "C" int ks_decide_pass_b(const void* py, const void* pcb,
                                const void* pcr, const void* satd,
                                const void* best0, const void* mode16,
                                const void* qp, const void* qpc,
                                const void* lam, const void* ls,
                                const void* btab, const void* tab,
                                void* mode_out, void* cost_out, int F, int H,
                                int W, int n, int seeded, void* stream) {
  const int nb = (H / n) * (W / n);
  if (F <= 0 || nb <= 0) return 0;
  pass_b_kernel<<<dim3(nb, F), 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)py, (const uint8_t*)pcb, (const uint8_t*)pcr,
      (const int*)satd, (const int*)best0, (const int*)mode16,
      (const int*)qp, (const int*)qpc, (const float*)lam, (const float*)ls,
      (const float*)btab, (const int*)tab, (int*)mode_out, (float*)cost_out,
      H, W, n, seeded);
  return (int)cudaGetLastError();
}

extern "C" int ks_decide_split(const void* cost8, const void* cost16,
                               const void* cost32, void* split16,
                               void* split32, void* cplx, void* mins, int F,
                               int h8, int w8, void* stream) {
  if (F <= 0) return 0;
  if (h8 / 4 > 256) return (int)cudaErrorInvalidValue;   // rows[] size
  split_kernel<<<F, 256, 0, (cudaStream_t)stream>>>(
      (const float*)cost8, (const float*)cost16, (const float*)cost32,
      (uint8_t*)split16, (uint8_t*)split32, (float*)cplx, (float*)mins, h8,
      w8);
  return (int)cudaGetLastError();
}
