// K5 — intra mode and split decision of a batch of frames.
//
// Replaces ks265codec_tpu/ops/decide.py::decide_frames_jit at effort 0
// and effort 1, with its NxN tier (`_decide_one`, `_size_decision`,
// `_size4_luma`, `_chroma_and_cost`, `_rough_tu_cost`, `_mpm_lists`,
// `_source_refs`, `_filter_refs`). Per CU tier (16, then 8 and 32:
// seeded from the 16 tier's winners at effort 0, a full sweep at effort
// 1), frames on blockIdx.y:
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
// Pass A and pass B stay separate launches: pass B's MPM lists read the
// best0 of neighbours in other regions.
//
// Bound: operations — pass A predicts and Hadamard-transforms every
// candidate (35 x 256 samples per 16x16 CU at the 16 tier) in integer
// arithmetic, about 0.33 ms for a 16-frame 720p batch on an H100; pass B
// transforms the rough-RD candidates, 0.02-0.2 ms a tier; the whole pass
// about 0.59 ms at effort 0 and 1.40 ms at effort 1. The first design
// (one 256-thread block per CU, one thread running each candidate's 64
// predictions and Hadamard over a local array, most threads idle, thread
// 0 running the mode costs, the top-k and every float sum) took 39-40 ms
// and 86-87 ms: latency, not arithmetic. This design:
//   pass A: one block per 64x64 region and tier (16, 64 or 4 CUs) stages
//           the region's luma and the rows and columns its refs reach in
//           shared memory with 16-byte loads, builds refs, filtered refs
//           and DC values there, and works through a list of (CU,
//           candidate, 8x8 sub-block) items with only candidates in it
//           (7 per CU in the seeded tiers): each item is one 8x8 SATD on
//           8 lanes, a line each, the butterflies in registers and then
//           across the lanes with __shfl_xor_sync; each mode's angle,
//           reference array and the line's (idx, fact) are hoisted out of
//           the sample loop (a horizontal mode's lane takes a column);
//   pass B: a team per CU (a warp at the 8 tier, two warps at 16, eight
//           at 32), several CUs per block; refs, residuals, forward DCTs
//           and quantisation on the whole team, both chroma planes side
//           by side, the tables in shared memory; the top-k a warp argmin.
//
// The costs are float32 and steer every decision, so they reproduce the
// reference backend's float32 sequence (see ops/decide.py): this file is
// built with --fmad=false and writes each fused multiply-add the
// reference forms with __fmaf_rn; argmins take the first minimum (ties to
// the lower index); a block sum's chain through the rows stays in one
// thread, and the parts of each row that do not depend on the chain are
// computed beforehand by the team with the same additions in the same
// order (team_block_sums).
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

// The compact candidate list of a seeded CU (ops/decide.candidate_list):
// the 7 modes above in that order, a mode already listed becoming -1.
__device__ __forceinline__ void candidate_list(int par, int* out) {
  const int ang = par < 2 ? 2 : par;
  const int l[7] = {par, par >= 2 ? 2 + ((ang - 2 + 1) % 33) : 0,
                    par >= 2 ? 2 + ((ang - 2 + 32) % 33) : 1, 0, 1, 26, 10};
  for (int s = 0; s < 7; s++) {
    int m = l[s];
    for (int t = 0; t < s; t++)
      if (l[t] == l[s]) m = -1;
    out[s] = m;
  }
}

// Seed of block (bx, by): the 8 tier takes its 16-block's mode, the 32
// tier the mode of its top-left 16-block.
__device__ __forceinline__ int parent_mode(const int* mode16, int n, int bx,
                                           int by, int w16) {
  return n == 8 ? mode16[(by >> 1) * w16 + (bx >> 1)]
                : mode16[(2 * by) * w16 + 2 * bx];
}

// ------------------------------------------------------------------ pass A
//
// One thread block per 64x64 region of one frame and tier: 16 CUs at the
// 16 tier, 64 at the 8 tier, 4 at the 32 tier. The region's luma and the
// rows and columns its CUs' source refs reach (up to 2n right of and below
// each CU, clamped to the plane) are staged once in shared memory with
// 16-byte loads; the refs, their [1 2 1] filtering and the DC values are
// built there. The work is the list (CU, candidate, 8x8 sub-block) with
// only candidates in it (7 per CU in the seeded tiers); each item is one
// 8x8 SATD on an 8-lane group: a lane predicts and subtracts one line of
// 8 samples (a row, or for the horizontal angular modes 2..17 a column,
// so that each mode's angle step is constant along the lane), transforms
// it in registers and the group finishes the Hadamard across its lanes
// with __shfl_xor_sync butterflies. The SATD of a transposed block is the
// same (the 2-D Hadamard of D^T is the transpose of D's), and integer
// sums are exact in any order.
template <int N>
struct RegionA {
  static constexpr int PER = 64 / N, R = PER * PER, L = 4 * N + 1;
  static constexpr int WH = 65 + N;                      // rows Y0-1 ..
  static constexpr int WW = (80 + N + 15) / 16 * 16;     // cols X0-16 ..
};

// The region's window: rows Y0-1 .. Y0+63+N and columns X0-16 ..
// X0-16+WW-1 of plane p, coordinates clamped to the plane. W is a
// multiple of 64, so a 16-byte chunk lies wholly inside or outside it.
template <int N>
__device__ void load_window(const uint8_t* p, int H, int W, int Y0, int X0,
                            uint8_t* win) {
  using RA = RegionA<N>;
  constexpr int CH = RA::WW / 16;
  for (int t = threadIdx.x; t < RA::WH * CH; t += blockDim.x) {
    const int r = t / CH, k = t % CH;
    const int y = min(max(Y0 - 1 + r, 0), H - 1);
    const int x0 = X0 - 16 + 16 * k;
    uint4 v;
    if (x0 >= 0 && x0 + 16 <= W) {
      v = __ldg(reinterpret_cast<const uint4*>(p + (size_t)y * W + x0));
    } else {
      const uint8_t e = p[(size_t)y * W + (x0 < 0 ? 0 : W - 1)];
      const unsigned w4 = 0x01010101u * e;
      v = make_uint4(w4, w4, w4, w4);
    }
    *reinterpret_cast<uint4*>(win + r * RA::WW + 16 * k) = v;
  }
}

// source_ref on the window (plane coordinates, clamped as source_ref
// clamps them, mapped into the window).
template <int N>
__device__ __forceinline__ int window_ref(const uint8_t* win, int Y0, int X0,
                                          int h, int w, int bx, int by,
                                          int i) {
  using RA = RegionA<N>;
  auto S = [&](int y, int x) {
    return (int)win[(y - Y0 + 1) * RA::WW + (x - X0 + 16)];
  };
  constexpr int n = N, n2 = 2 * N;
  const bool has_l = bx > 0, has_t = by > 0;
  if (!has_l && !has_t) return 128;
  const int ty = max(by * n - 1, 0), lx = max(bx * n - 1, 0);
  const int l0 = S(min(by * n, h - 1), lx);
  const int t0 = S(ty, min(bx * n, w - 1));
  if (i < n2) return has_l ? S(min(by * n + i, h - 1), lx) : t0;
  if (i == n2) return (has_l && has_t) ? S(ty, lx) : (has_t ? t0 : l0);
  return has_t ? S(ty, min(bx * n + i - n2 - 1, w - 1)) : l0;
}

// [1 2 1] smoothing of refs entry i (refs layout) from ru.
__device__ __forceinline__ int smooth_ref(const int* ru, int n, int i) {
  const int n2 = 2 * n, L = 4 * n + 1;
  const int c = i < n2 ? n2 - 1 - i : i;          // contour position
  auto at = [&](int q) { return q < n2 ? ru[n2 - 1 - q] : ru[q]; };
  return (c == 0 || c == L - 1) ? at(c)
                                : (at(c - 1) + 2 * at(c) + at(c + 1) + 2) >> 2;
}

// One lane's line of an 8x8 sub-block at (oy, ox) of an N x N luma CU:
// d[j] = source - prediction of mode m along row oy + li (or, for modes
// 2..17, column ox + li), with the mode's angle, its reference array and
// the line's (idx, fact) hoisted out of the sample loop. src: the CU's
// origin in the window (stride WW).
template <int N, int WW>
__device__ __forceinline__ void lane_residual(const uint8_t* src,
                                              const int* ru, const int* rf,
                                              int dc, const int* ang,
                                              const int* inva, int m,
                                              int oy, int ox, int li,
                                              int* d) {
  constexpr int n2 = 2 * N, sh = (N == 8 ? 3 : N == 16 ? 4 : 5) + 1;
  if (m >= 2 && m < 18) {                          // horizontal: a column
    const int x = ox + li;
    const int* r = ks_use_filtered(m, N) ? rf : ru;
    const int a = ang[m - 2], inv = inva[m - 2];
    const int idx = ((x + 1) * a) >> 5, fact = ((x + 1) * a) & 31;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const int y = oy + j, k = y + idx + 1;
      int v = ks_ang_ref(r, N, false, k, inv);
      if (fact)
        v = ((32 - fact) * v + fact * ks_ang_ref(r, N, false, k + 1, inv) +
             16) >> 5;
      if (N < 32 && m == 10 && y == 0)
        v = ks_clip3(0, 255, ru[0] + ((ru[n2 + 1 + x] - ru[n2]) >> 1));
      d[j] = (int)src[y * WW + x] - v;
    }
  } else if (m >= 18) {                            // vertical: a row
    const int y = oy + li;
    const int* r = ks_use_filtered(m, N) ? rf : ru;
    const int a = ang[m - 2], inv = inva[m - 2];
    const int idx = ((y + 1) * a) >> 5, fact = ((y + 1) * a) & 31;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const int x = ox + j, k = x + idx + 1;
      int v = ks_ang_ref(r, N, true, k, inv);
      if (fact)
        v = ((32 - fact) * v + fact * ks_ang_ref(r, N, true, k + 1, inv) +
             16) >> 5;
      if (N < 32 && m == 26 && x == 0)
        v = ks_clip3(0, 255, ru[n2 + 1] + ((ru[y] - ru[n2]) >> 1));
      d[j] = (int)src[y * WW + x] - v;
    }
  } else if (m == 0) {                             // planar, filtered refs
    const int y = oy + li;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const int x = ox + j;
      const int v = ((N - 1 - x) * rf[y] + (x + 1) * rf[n2 + 1 + N] +
                     (N - 1 - y) * rf[n2 + 1 + x] + (y + 1) * rf[N] + N) >>
                    sh;
      d[j] = (int)src[y * WW + x] - v;
    }
  } else {                                         // DC with edge filters
    const int y = oy + li;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const int x = ox + j;
      int v = dc;
      if (N < 32) {
        if (y == 0 && x == 0)
          v = (ru[0] + 2 * dc + ru[n2 + 1] + 2) >> 2;
        else if (y == 0)
          v = (ru[n2 + 1 + x] + 3 * dc + 2) >> 2;
        else if (x == 0)
          v = (ru[y] + 3 * dc + 2) >> 2;
      }
      d[j] = (int)src[y * WW + x] - v;
    }
  }
}

// The 8x8 Hadamard SATD, HM normalisation (sum + 2) >> 2, of the 8 lines
// held by an 8-lane group (lane li holds line li in d): the butterflies
// along each line in registers, then across the group's lanes.
__device__ __forceinline__ int group_satd8(int* d, int li, unsigned mask) {
#pragma unroll
  for (int h = 1; h < 8; h <<= 1)
#pragma unroll
    for (int i = 0; i < 8; i += 2 * h)
#pragma unroll
      for (int j = i; j < i + h; j++) {
        const int a = d[j], b = d[j + h];
        d[j] = a + b;
        d[j + h] = a - b;
      }
#pragma unroll
  for (int h = 1; h < 8; h <<= 1)
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const int o = __shfl_xor_sync(mask, d[j], h, 8);
      d[j] = (li & h) ? o - d[j] : d[j] + o;
    }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) s += abs(d[j]);
  s += __shfl_xor_sync(mask, s, 1, 8);
  s += __shfl_xor_sync(mask, s, 2, 8);
  s += __shfl_xor_sync(mask, s, 4, 8);
  return (s + 2) >> 2;
}

template <int N, bool kSeeded>
__global__ void __launch_bounds__(256)
    pass_a_kernel(const uint8_t* planes, const int* mode16, int* satd_out,
                  int* best0_out, const int* tab, int H, int W) {
  using RA = RegionA<N>;
  constexpr int R = RA::R, L = RA::L, PER = RA::PER;
  constexpr int NS = (N / 8) * (N / 8), NC = kSeeded ? 7 : 35;
  __shared__ __align__(16) uint8_t win[RA::WH * RA::WW];
  __shared__ int ru[R][L], rf[R][L];
  __shared__ int dcv[R], par[R];
  __shared__ int cand[kSeeded ? R : 1][7];
  __shared__ int sums[R][35];
  __shared__ int ang[33], inva[33];
  const int f = blockIdx.y, nrx = W / 64;
  const int X0 = (blockIdx.x % nrx) * 64, Y0 = (blockIdx.x / nrx) * 64;
  const int nbx = W / N, nb = nbx * (H / N);
  const uint8_t* p = planes + (size_t)f * H * W;
  load_window<N>(p, H, W, Y0, X0, win);
  for (int i = threadIdx.x; i < 33; i += blockDim.x) {
    ang[i] = tab[T_ANGLE + i];
    inva[i] = tab[T_INVANGLE + i];
  }
  for (int i = threadIdx.x; i < R * 35; i += blockDim.x) (&sums[0][0])[i] = 0;
  for (int c = threadIdx.x; c < R; c += blockDim.x) {
    const int bx = X0 / N + c % PER, by = Y0 / N + c / PER;
    par[c] = kSeeded ? parent_mode(mode16 + (size_t)f * (H / 16) * (W / 16),
                                   N, bx, by, W / 16)
                     : 0;
    if (kSeeded) candidate_list(par[c], cand[c]);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < R * L; t += blockDim.x) {
    const int c = t / L, i = t % L;
    ru[c][i] = window_ref<N>(win, Y0, X0, H, W, X0 / N + c % PER,
                             Y0 / N + c / PER, i);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < R * L; t += blockDim.x)
    rf[t / L][t % L] = smooth_ref(ru[t / L], N, t % L);
  for (int c = threadIdx.x; c < R; c += blockDim.x)
    dcv[c] = ks_dc_value(ru[c], N);
  __syncthreads();
  const int lane = threadIdx.x & 31, li = lane & 7;
  const unsigned gmask = 0xFFu << (lane & 24);
  for (int it = threadIdx.x >> 3; it < R * NC * NS; it += 32) {
    const int c = it / (NC * NS), s = (it / NS) % NC, sb = it % NS;
    const int m = kSeeded ? cand[c][s] : s;
    if (m < 0) continue;                            // uniform in the group
    const int cy = (c / PER) * N, cx = (c % PER) * N;
    int d[8];
    lane_residual<N, RA::WW>(win + (1 + cy) * RA::WW + 16 + cx, ru[c], rf[c],
                             dcv[c], ang, inva, m, (sb / (N / 8)) * 8,
                             (sb % (N / 8)) * 8, li, d);
    const int v = group_satd8(d, li, gmask);
    if (li == 0) atomicAdd(&sums[c][m], v);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < R * 35; t += blockDim.x) {
    const int c = t / 35, m = t % 35;
    const int b = (Y0 / N + c / PER) * nbx + X0 / N + c % PER;
    satd_out[((size_t)f * nb + b) * 35 + m] = sums[c][m];
  }
  for (int c = threadIdx.x; c < R; c += blockDim.x) {
    int best = -1;
    for (int m = 0; m < 35; m++)
      if (is_candidate(m, par[c], kSeeded) &&
          (best < 0 || sums[c][m] < sums[c][best]))
        best = m;
    best0_out[(size_t)f * nb + (Y0 / N + c / PER) * nbx + X0 / N + c % PER] =
        best;
  }
}

// ------------------------------------------------------------------ pass B
//
// Several CUs per block, one team of threads per CU: a warp at the 8
// tier, two warps at the 16 tier, the block's 8 warps at the 32 tier. The
// refs, the residuals, the forward DCTs and the quantisation run on the
// whole team; the team's first warp takes the mode costs
// fma(ls, mode_bits, satd) and the top-K by a warp argmin on (cost, mode)
// (comparisons only: exact, ties to the lower mode); both chroma planes
// run side by side. The float32 sums keep the reference's sequence: a
// ks_block_sum's chain through the rows stays in one thread, and the team
// computes beforehand, per row, the partial sums that do not depend on
// that chain (lanes 1..7 of the row's 8-lane vector and their halving
// sums), with the same additions in the same order; two or four threads
// walk the chains of the distortion and rate sums at once.
template <int N>
struct TeamB {
  static constexpr int T = N == 8 ? 32 : (N == 16 ? 64 : 256);
  static constexpr int CUS = 256 / T;
};

template <int N>
struct ScratchB {
  int ru[4 * N + 1], rf[4 * N + 1];  // luma refs; Cb and Cr refs
  int src[N * N];                    // luma block; Cb | Cr blocks
  int res[N * N];                    // residual, then squared errors
  int tmp[N * (N + 1)];              // first DCT stage, then level bits
  int coef[N * N];
  float part[4][N][3];               // per-row parts of up to 4 sums
  float sum[4];
  int cand[3], ccand[5], csatd[2][5][4];
  float cbits[3], cD[3], cR[3];
  int best, cmode, dc[2];
  float D, R, mode_bits, cmode_bits;
};

template <int T>
__device__ __forceinline__ void team_sync(int team) {
  if (T == 32)
    __syncwarp();
  else if (T == 256)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(T) : "memory");
}

// Forward DCT with the HM staged shifts (ks_fwd_dct) of `cnt` n x n
// blocks laid side by side (block q at offset q * n * n; its first stage
// in tmp at q * n * (n + 1), rows padded by one), by a team. In the second
// stage neighbouring lanes take neighbouring rows k of the padded first
// stage and share the matrix row l: no shared-memory bank conflicts (with
// lanes along l the matrix reads M[l][j] fall in one bank, 32-way at
// n = 32).
template <int T>
__device__ void team_fwd_dct(const int* tab, int n, int cnt, const int* res,
                             int* tmp, int* coef, int tid, int team) {
  const int* M = ks_dct(tab, n);
  const int log2 = ks_log2(n), nn = n * n, np = n * (n + 1);
  const int s1 = log2 - 1, s2 = log2 + 6;
  for (int p = tid; p < cnt * nn; p += T) {
    const int q = p / nn, k = (p % nn) / n, c = p % n;
    int acc = 0;
    for (int j = 0; j < n; j++) acc += M[k * n + j] * res[q * nn + j * n + c];
    tmp[q * np + k * (n + 1) + c] = (acc + (1 << (s1 - 1))) >> s1;
  }
  team_sync<T>(team);
  for (int p = tid; p < cnt * nn; p += T) {
    const int q = p / nn, k = p % n, l = (p % nn) / n;
    const int* row = tmp + q * np + k * (n + 1);
    int acc = 0;
    for (int j = 0; j < n; j++) acc += row[j] * M[l * n + j];
    coef[q * nn + k * n + l] = (acc + (1 << (s2 - 1))) >> s2;
  }
  team_sync<T>(team);
}

// Squared dequantisation errors (into res, as float) and level bits (into
// tmp) of `cnt` quantised blocks of coef; block q at qp qps[q].
template <int T>
__device__ void team_quant(const int* tab, const float* btab, int n, int cnt,
                           const int* qps, const int* coef, float* sq,
                           float* bits, int tid) {
  const int log2 = ks_log2(n), nn = n * n;
  for (int p = tid; p < cnt * nn; p += T) {
    const int qp = qps[p / nn];
    const int a = abs(coef[p]);
    const int lev = ks_quant_abs(tab, a, qp, log2);
    const float derr = (float)(a - ks_dequant(tab, lev, qp, log2));
    sq[p] = derr * derr;
    bits[p] = __ldg(btab + lev);
  }
}

// ks_block_sum of `cnt` n x n float blocks at x[q] into out[q], by a team:
// for n >= 8 the per-row parts {v4, v2 + v6, (v1 + v5) + (v3 + v7)} of
// every block first (v_i: row lane i's chunk sum), then one thread per
// block walks the rows: v0 = (acc + x[r][0]) + x[r][8] + ...,
// acc = ((v0 + v4) + (v2 + v6)) + ((v1 + v5) + (v3 + v7)): ks_tree8's
// additions in ks_tree8's order. Ends synchronised.
template <int T, int NP>
__device__ void team_block_sums(const float* const* x, int n, int cnt,
                                float (*part)[NP][3], float* out, int tid,
                                int team) {
  if (n >= 8) {
    for (int t = tid; t < cnt * n; t += T) {
      const int q = t / n, r = t % n;
      const float* row = x[q] + r * n;
      float v[8];
      for (int i = 1; i < 8; i++) {
        v[i] = row[i];
        for (int k = 8; k < n; k += 8) v[i] = v[i] + row[k + i];
      }
      part[q][r][0] = v[4];
      part[q][r][1] = v[2] + v[6];
      part[q][r][2] = (v[1] + v[5]) + (v[3] + v[7]);
    }
    team_sync<T>(team);
  }
  if (tid < cnt) {
    const float* xq = x[tid];
    if (n == 4) {
      out[tid] = ks_block_sum(xq, 4);
    } else {
      float acc = 0.f;
      for (int r = 0; r < n; r++) {
        float v0 = acc + xq[r * n];
        for (int k = 8; k < n; k += 8) v0 = v0 + xq[r * n + k];
        acc = ((v0 + part[tid][r][0]) + part[tid][r][1]) + part[tid][r][2];
      }
      out[tid] = acc;
    }
  }
  team_sync<T>(team);
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

// The table entries pass B reads (the DCT matrices of n and n / 2, the
// quantisation and angle tables) into shared memory.
__device__ void load_tab(const int* tab, int* stab, int n) {
  const int o1 = n == 8 ? T_DCT8 : (n == 16 ? T_DCT16 : T_DCT32);
  const int o2 = n == 8 ? T_DCT4 : (n == 16 ? T_DCT8 : T_DCT16);
  for (int i = threadIdx.x; i < n * n; i += blockDim.x)
    stab[o1 + i] = tab[o1 + i];
  for (int i = threadIdx.x; i < n * n / 4; i += blockDim.x)
    stab[o2 + i] = tab[o2 + i];
  for (int i = threadIdx.x; i < T_BETA - T_QUANT; i += blockDim.x)
    stab[T_QUANT + i] = tab[T_QUANT + i];
}

// kEffort is a template argument so that the effort-0 instantiation
// carries none of the chroma search's code (registers, local arrays);
// kLumaCost (the 8 tier under the NxN tier) also writes the luma-only cost
// D + lam * ((R + mode_bits) + hdr) to cl_out, taken before chroma is
// added, as a template argument too: a run-time mode argument in this
// kernel cost time.
template <int N, int kEffort, bool kLumaCost>
__global__ void __launch_bounds__(256)
    pass_b_kernel(const uint8_t* py, const uint8_t* pcb, const uint8_t* pcr,
                  const int* satd, const int* best0, const int* mode16,
                  const int* qp, const int* qpc, const float* lam,
                  const float* ls, const float* btab, const int* tab,
                  int* mode_out, float* cost_out, int* cmode_out,
                  float* cl_out, int H, int W, int seeded) {
  using TB = TeamB<N>;
  constexpr int T = TB::T, n = N, nc = N / 2, n2 = 2 * N;
  constexpr int K = kEffort ? 3 : 1;
  __shared__ int stab[T_BETA];
  __shared__ ScratchB<N> sc[TB::CUS];
  const int team = threadIdx.x / T, tid = threadIdx.x % T;
  const int f = blockIdx.y, nbx = W / n, nb = nbx * (H / n);
  const int b = blockIdx.x * TB::CUS + team;
  load_tab(tab, stab, n);
  __syncthreads();
  if (b >= nb) return;                              // uniform in the team
  ScratchB<N>& s = sc[team];
  const int bx = b % nbx, by = b / nbx;
  const uint8_t* ply = py + (size_t)f * H * W;
  const int Hc = H / 2, Wc = W / 2;
  const uint8_t* cps[2] = {pcb + (size_t)f * Hc * Wc,
                           pcr + (size_t)f * Hc * Wc};
  const float lamf = lam[f], lsf = ls[f];
  if (tid < 32) {
    // MPM lists (spec 8.4.2) from the best0 grid; an above neighbour in
    // another CTB row counts as DC
    const int* b0 = best0 + (size_t)f * nb;
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
        seeded ? parent_mode(mode16 + (size_t)f * (H / 16) * (W / 16), n, bx,
                             by, W / 16)
               : 0;
    const int* st = satd + ((size_t)f * nb + b) * 35;
    float jv[2];
    bool ok[2];
    for (int q = 0; q < 2; q++) {
      const int m = tid + 32 * q;
      ok[q] = m < 35 && is_candidate(m, par, seeded);
      const float mb = m == m0 ? 2.f : ((m == m1 || m == m2) ? 3.f : 6.f);
      jv[q] = ok[q] ? __fmaf_rn(lsf, mb, (float)st[m]) : 0.f;
    }
    // the rough-RD candidates: the K best modes in order, ties to the
    // lower mode (the reference backend's top-k)
    for (int k = 0; k < K; k++) {
      float bj = 0.f;
      int bm = 99;
      for (int q = 0; q < 2; q++)
        if (ok[q] && (bm == 99 || jv[q] < bj)) {
          bj = jv[q];
          bm = tid + 32 * q;
        }
      for (int o = 16; o >= 1; o >>= 1) {
        const float oj = __shfl_xor_sync(0xffffffffu, bj, o);
        const int om = __shfl_xor_sync(0xffffffffu, bm, o);
        if (om != 99 && (bm == 99 || oj < bj || (oj == bj && om < bm))) {
          bj = oj;
          bm = om;
        }
      }
      if (bm == tid) ok[0] = false;
      if (bm == tid + 32) ok[1] = false;
      if (tid == 0) {
        s.cand[k] = bm;
        s.cbits[k] = bm == m0 ? 2.f : ((bm == m1 || bm == m2) ? 3.f : 6.f);
      }
    }
  }
  // luma source refs and block
  for (int i = tid; i < 4 * n + 1; i += T)
    s.ru[i] = source_ref(ply, H, W, n, bx, by, i);
  for (int q = tid; q < n * n; q += T)
    s.src[q] = ply[(by * n + q / n) * W + bx * n + q % n];
  team_sync<T>(team);
  for (int i = tid; i < 4 * n + 1; i += T) s.rf[i] = smooth_ref(s.ru, n, i);
  if (tid == 0) s.dc[0] = ks_dc_value(s.ru, n);
  team_sync<T>(team);
  const int qpl[1] = {qp[f]};
  for (int k = 0; k < K; k++) {
    const int mode = s.cand[k];
    for (int q = tid; q < n * n; q += T)
      s.res[q] = s.src[q] - ks_pred_pixel(stab, mode, n, true, s.ru, s.rf,
                                          s.dc[0], q / n, q % n);
    team_sync<T>(team);
    team_fwd_dct<T>(stab, n, 1, s.res, s.tmp, s.coef, tid, team);
    float* sq = reinterpret_cast<float*>(s.res);
    float* bits = reinterpret_cast<float*>(s.tmp);
    team_quant<T>(stab, btab, n, 1, qpl, s.coef, sq, bits, tid);
    team_sync<T>(team);
    const float* xs[2] = {sq, bits};
    team_block_sums<T>(xs, n, 2, s.part, s.sum, tid, team);
    if (tid == 0) {
      s.cD[k] = 0.f + s.sum[0] * ldexpf(1.f, 2 * ks_log2(n) - 14);
      s.cR[k] = 0.f + s.sum[1];
    }
  }
  if (tid == 0) {
    int ki = 0;
    float bj = 0.f;
    for (int k = 0; k < K; k++) {
      const float jk = __fmaf_rn(lamf, s.cR[k] + s.cbits[k], s.cD[k]);
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
          __fmaf_rn(lamf, (s.R + s.mode_bits) + hdr, s.D);
    }
  }
  // chroma source refs (Cb in ru, Cr in rf) and blocks (Cb | Cr in src)
  for (int i = tid; i < 2 * (4 * nc + 1); i += T) {
    const int c = i / (4 * nc + 1), j = i % (4 * nc + 1);
    (c ? s.rf : s.ru)[j] = source_ref(cps[c], Hc, Wc, nc, bx, by, j);
  }
  for (int q = tid; q < 2 * nc * nc; q += T) {
    const int c = q / (nc * nc), e = q % (nc * nc);
    s.src[q] = cps[c][(by * nc + e / nc) * Wc + bx * nc + e % nc];
  }
  team_sync<T>(team);
  if (tid < 2) s.dc[tid] = ks_dc_value(tid ? s.rf : s.ru, nc);
  team_sync<T>(team);
  if (kEffort) {
    // SATD of both chroma blocks against the 5 candidates' predictions:
    // 4x4 Hadamard for nc = 4, one thread a block; else 8x8 tiles, one
    // 8-lane group a tile, a row a lane (group_satd8)
    constexpr int t8 = nc < 8 ? 4 : 8, per = nc / t8, nsub = per * per;
    if constexpr (nc == 4) {
      for (int i = tid; i < 2 * 5; i += T) {
        const int c = i / 5, k = i % 5;
        const int* r = c ? s.rf : s.ru;
        int d[16];
        for (int q = 0; q < 16; q++)
          d[q] = s.src[c * 16 + q] - ks_pred_pixel(stab, s.ccand[k], 4,
                                                   false, r, r, s.dc[c],
                                                   q / 4, q % 4);
        s.csatd[c][k][0] = satd4(d);
      }
    } else {
      const int li = tid & 7;
      const unsigned gmask = 0xFFu << (threadIdx.x & 24);
      for (int i = tid >> 3; i < 2 * 5 * nsub; i += T / 8) {
        const int c = i / (5 * nsub), k = (i / nsub) % 5, sb = i % nsub;
        const int y = (sb / per) * 8 + li, ox = (sb % per) * 8;
        const int* r = c ? s.rf : s.ru;
        int d[8];
        for (int j = 0; j < 8; j++)
          d[j] = s.src[c * nc * nc + y * nc + ox + j] -
                 ks_pred_pixel(stab, s.ccand[k], nc, false, r, r, s.dc[c],
                               y, ox + j);
        const int v = group_satd8(d, li, gmask);
        if (li == 0) s.csatd[c][k][sb] = v;
      }
    }
    team_sync<T>(team);
    if (tid == 0) {
      float bj = 0.f;
      for (int k = 0; k < 5; k++) {
        int cb = 0, cr = 0;
        for (int sb = 0; sb < nsub; sb++) {
          cb += s.csatd[0][k][sb];
          cr += s.csatd[1][k][sb];
        }
        const float bits = k < 4 ? 7.f : 1.f;
        const float cj =
            __fmaf_rn(lsf, bits, (0.f + (float)cb) + (float)cr);
        if (k == 0 || cj < bj) {
          bj = cj;
          s.cmode = s.ccand[k];
          s.cmode_bits = bits;
        }
      }
    }
    team_sync<T>(team);
  }
  // the chroma rough costs of both planes side by side
  const int cmode = s.cmode;
  for (int q = tid; q < 2 * nc * nc; q += T) {
    const int c = q / (nc * nc), e = q % (nc * nc);
    const int* r = c ? s.rf : s.ru;
    s.res[q] = s.src[q] - ks_pred_pixel(stab, cmode, nc, false, r, r,
                                        s.dc[c], e / nc, e % nc);
  }
  team_sync<T>(team);
  team_fwd_dct<T>(stab, nc, 2, s.res, s.tmp, s.coef, tid, team);
  const int qpcs[2] = {qpc[f], qpc[f]};
  {
    float* sq = reinterpret_cast<float*>(s.res);
    float* bits = reinterpret_cast<float*>(s.tmp);
    team_quant<T>(stab, btab, nc, 2, qpcs, s.coef, sq, bits, tid);
    team_sync<T>(team);
    const float* xs[4] = {sq, bits, sq + nc * nc, bits + nc * nc};
    team_block_sums<T>(xs, nc, 4, s.part, s.sum, tid, team);
  }
  if (tid == 0) {
    const float sc2 = ldexpf(1.f, 2 * ks_log2(nc) - 14);
    const float D = (s.D + s.sum[0] * sc2) + s.sum[2] * sc2;
    const float R = (s.R + s.sum[1]) + s.sum[3];
    // effort 0: the DM bit folded into the header bits, as the reference
    // does; effort 1: ((R + mode bits) + chroma bits) + header bits
    const float hdr = n == 8 ? 7.f : (n == 16 ? 5.f : 4.f);
    const float rtot = kEffort ? ((R + s.mode_bits) + s.cmode_bits) + hdr
                               : (R + s.mode_bits) + (1.f + hdr);
    mode_out[(size_t)f * nb + b] = s.best;
    cmode_out[(size_t)f * nb + b] = cmode;
    cost_out[(size_t)f * nb + b] = __fmaf_rn(lamf, rtot, D);
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
  if (F <= 0 || H <= 0 || W <= 0) return 0;
  if (H % 64 || W % 64 || (n != 8 && n != 16 && n != 32) ||
      (seeded && (n == 16 || !mode16)) ||
      ((size_t)planes & 15))
    return (int)cudaErrorInvalidValue;
  auto kernel = n == 16 ? pass_a_kernel<16, false>
                : n == 8 ? (seeded ? pass_a_kernel<8, true>
                                   : pass_a_kernel<8, false>)
                         : (seeded ? pass_a_kernel<32, true>
                                   : pass_a_kernel<32, false>);
  kernel<<<dim3((H / 64) * (W / 64), F), 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)planes, (const int*)mode16, (int*)satd, (int*)best0,
      (const int*)tab, H, W);
  return (int)cudaGetLastError();
}

template <int N>
static int launch_pass_b(const void* py, const void* pcb, const void* pcr,
                         const void* satd, const void* best0,
                         const void* mode16, const void* qp, const void* qpc,
                         const void* lam, const void* ls, const void* btab,
                         const void* tab, void* mode_out, void* cost_out,
                         void* cmode_out, void* cl_out, int F, int H, int W,
                         int seeded, int effort, cudaStream_t stream) {
  auto kernel = cl_out ? pass_b_kernel<N, 1, true>
                       : (effort ? pass_b_kernel<N, 1, false>
                                 : pass_b_kernel<N, 0, false>);
  const int nb = (H / N) * (W / N), cus = TeamB<N>::CUS;
  kernel<<<dim3((nb + cus - 1) / cus, F), 256, 0, stream>>>(
      (const uint8_t*)py, (const uint8_t*)pcb, (const uint8_t*)pcr,
      (const int*)satd, (const int*)best0, (const int*)mode16,
      (const int*)qp, (const int*)qpc, (const float*)lam, (const float*)ls,
      (const float*)btab, (const int*)tab, (int*)mode_out, (float*)cost_out,
      (int*)cmode_out, (float*)cl_out, H, W, seeded);
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
  if (F <= 0 || H <= 0 || W <= 0) return 0;
  if ((cl_out && !effort) || H % 64 || W % 64 ||
      (n != 8 && n != 16 && n != 32))
    return (int)cudaErrorInvalidValue;
  auto launch = n == 8 ? launch_pass_b<8>
                : (n == 16 ? launch_pass_b<16> : launch_pass_b<32>);
  return launch(py, pcb, pcr, satd, best0, mode16, qp, qpc, lam, ls, btab,
                tab, mode_out, cost_out, cmode_out, cl_out, F, H, W, seeded,
                effort, (cudaStream_t)stream);
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
