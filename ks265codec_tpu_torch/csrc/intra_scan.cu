// K6 — intra coding scan, and K11 — intra reconstruction from parsed
// levels, one dependency level per launch.
//
// K6 replaces ks265codec_tpu/ops/wavefront.py::_code_intra_frame_core
// (`_process_class`, `_refs_from_borders`, `_fwd_quant`, `_dequant_itx`):
// for every CU the native schedule put on this level, one thread block
// builds the reference samples from the reconstruction planes (with
// availability substitution, [1 2 1] filtering and 32x32 strong
// smoothing), predicts the CU's mode, transforms and quantises the
// residual (deadzone rounding, or with the flags K2's RDOQ and sign hiding
// of rdoq.cuh, with the mode's 4x4 scan), dequantises and
// inverse-transforms it and writes the reconstruction and the levels;
// then the same for the two chroma blocks. The frame is blockIdx.y.
//
// K11 replaces ks265codec_tpu/ops/wavefront.py::_recon_intra_frame_core
// (`_recon_class`): the decoder's twin, which reads each block's levels
// from the parsed coefficient planes instead of quantising a source. Both
// kernels share the reference build and prediction (`predict_block`) and
// the dequantisation and inverse transform (`reconstruct_block`).
//
// Bound: a level has few CUs (the wavefront is at most a few hundred CUs
// wide at 720p) and each CU's blocks run one after another, so the scan is
// bound by latency — launches and the serial steps inside a block — not by
// bytes or operations. This first version keeps the arithmetic plain
// (matrix products from global tables, one substitution pass in one
// thread); capturing the level launches in a CUDA graph or a persistent
// kernel is later work.
#include "rdoq.cuh"

namespace {

enum { RX, RY, RSIZE, RMODE, RCMODE, RQP, RQPCB, RQPCR, RAL, RAC, RAT,
       RVALID, RFIELDS };

struct Scratch {
  int contour[4 * KS_MAX_N + 1];
  int ok[4 * KS_MAX_N + 1];
  int ru[4 * KS_MAX_N + 1];
  int rf[4 * KS_MAX_N + 1];
  int pred[KS_MAX_N * KS_MAX_N];
  int buf0[KS_MAX_N * KS_MAX_N];
  int buf1[KS_MAX_N * KS_MAX_N];
  int buf2[KS_MAX_N * KS_MAX_N];
  int flag;
};

// Reference samples and prediction of one n x n block of one plane into
// s.pred. rec: this frame's reconstruction plane (stride w, height h);
// (x0, y0) the block origin in the plane; expand: luma samples per plane
// sample (1 luma, 2 chroma), so that availability group g covers plane
// samples [4g/expand, 4(g+1)/expand). Ends synchronised.
__device__ void predict_block(const int* tab, const uint8_t* rec, int w,
                              int h, int x0, int y0, int n, int expand,
                              bool luma, int mode, unsigned al, unsigned ac,
                              unsigned at, bool strong, Scratch& s) {
  const int n2 = 2 * n, L = 4 * n + 1;
  // contour: bottom-left upward, corner, top left-to-right
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    int yy, xx, avail;
    if (i < n2) {
      const int j = n2 - 1 - i;
      yy = y0 + j;
      xx = x0 - 1;
      avail = (al >> ((j * expand) / 4)) & 1;
    } else if (i == n2) {
      yy = y0 - 1;
      xx = x0 - 1;
      avail = ac & 1;
    } else {
      const int k = i - n2 - 1;
      yy = y0 - 1;
      xx = x0 + k;
      avail = (at >> ((k * expand) / 4)) & 1;
    }
    avail = avail && yy >= 0 && xx >= 0 && yy < h && xx < w;
    s.ok[i] = avail;
    s.contour[i] = avail ? rec[yy * w + xx] : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {      // substitution (spec 8.4.4.2.2)
    int first = -1;
    for (int i = 0; i < L; i++)
      if (s.ok[i]) { first = i; break; }
    if (first < 0) {
      for (int i = 0; i < L; i++) s.contour[i] = 128;
    } else {
      if (!s.ok[0]) s.contour[0] = s.contour[first];
      for (int i = 1; i < L; i++)
        if (!s.ok[i]) s.contour[i] = s.contour[i - 1];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L; i += blockDim.x)
    s.ru[i < n2 ? n2 - 1 - i : i] = s.contour[i];
  __syncthreads();
  if (luma) {
    ks_smooth_refs(s.ru, s.rf, n);
    if (strong && n == 32) {
      if (threadIdx.x == 0) {
        const int c = s.ru[n2];
        const int* top = s.ru + n2 + 1;
        s.flag = abs(c + top[n2 - 1] - 2 * top[n - 1]) < 8 &&
                 abs(c + s.ru[n2 - 1] - 2 * s.ru[n - 1]) < 8;
      }
      __syncthreads();
      if (s.flag) {
        const int c = s.ru[n2];
        const int tl = s.ru[n2 + n2], ll = s.ru[n2 - 1];
        for (int k = threadIdx.x; k < n2; k += blockDim.x) {
          const int b = k + 1;
          s.rf[n2 + 1 + k] =
              k == n2 - 1 ? tl : ((64 - b) * c + b * tl + 32) >> 6;
          s.rf[k] = k == n2 - 1 ? ll : ((64 - b) * c + b * ll + 32) >> 6;
        }
        if (threadIdx.x == 0) s.rf[n2] = c;
      }
      __syncthreads();
    }
  }
  const int* rf = luma ? s.rf : s.ru;
  const int dc = ks_dc_value(s.ru, n);
  for (int p = threadIdx.x; p < n * n; p += blockDim.x)
    s.pred[p] = ks_pred_pixel(tab, mode, n, luma, s.ru, rf, dc, p / n, p % n);
  __syncthreads();
}

// Inverse transform of the dequantised block in s.buf2 and the
// reconstruction pred + residual, clipped, into rec. Ends synchronised.
__device__ void reconstruct_block(const int* tab, uint8_t* rec, int w,
                                  int x0, int y0, int n, Scratch& s) {
  ks_inv_dct(tab, n, s.buf2, s.buf1, s.buf0);
  for (int p = threadIdx.x; p < n * n; p += blockDim.x)
    rec[(y0 + p / n) * w + x0 + p % n] =
        (uint8_t)ks_clip3(0, 255, s.pred[p] + s.buf0[p]);
  __syncthreads();
}

// One n x n block of one plane, in place. K6 (kRecon false): residual of
// src against the prediction, forward transform and quantisation through
// K2's functions (deadzone rounding, or RDOQ, and sign hiding as `flags`
// select). Without K2's tools (kK2 false) each thread signs its own
// levels and the group pass with its two synchronisations is skipped:
// run at flags 0, the group pass made the ultrafast scan 6-8% slower on
// an H100. The levels go to lev. K11 (kRecon true): the levels are read
// from lev and src is unused. Both then dequantise, inverse-transform
// and reconstruct.
template <bool kRecon, bool kK2>
__device__ void run_block(const int* tab, const int* rank,
                          const uint8_t* src, uint8_t* rec, int16_t* lev,
                          int w, int h, int x0, int y0, int n, int expand,
                          int c_idx, int mode, int qp, unsigned al,
                          unsigned ac, unsigned at, bool strong, int flags,
                          Scratch& s) {
  const bool luma = c_idx == 0;
  const int log2 = ks_log2(n);
  predict_block(tab, rec, w, h, x0, y0, n, expand, luma, mode, al, ac, at,
                strong, s);
  int* coef = s.buf2;
  if (kRecon) {
    for (int p = threadIdx.x; p < n * n; p += blockDim.x)
      coef[p] = ks_dequant(tab, lev[(y0 + p / n) * w + x0 + p % n], qp, log2);
    __syncthreads();
  } else {
    int* res = s.buf0;
    for (int p = threadIdx.x; p < n * n; p += blockDim.x)
      res[p] = (int)src[(y0 + p / n) * w + x0 + p % n] - s.pred[p];
    __syncthreads();
    ks_fwd_dct(tab, n, res, s.buf1, coef);
    // K2: levels into buf0 (RDOQ's f into buf1), then per 4x4 group the
    // decimation, the signs and sign hiding (or the signs alone, each
    // thread on its own coefficients); store and dequantise in place
    float* f = reinterpret_cast<float*>(s.buf1);
    ks_levels_abs(tab, coef, s.buf0, f, n, qp, flags);
    if (kK2) {
      __syncthreads();
      ks_group_pass(s.buf0, coef, f, n, flags,
                    rank + 16 * ks_scan_idx(mode, log2, c_idx));
      __syncthreads();
    }
    for (int p = threadIdx.x; p < n * n; p += blockDim.x) {
      const int l = kK2 || coef[p] >= 0 ? s.buf0[p] : -s.buf0[p];
      lev[(y0 + p / n) * w + x0 + p % n] = (int16_t)l;
      coef[p] = ks_dequant(tab, l, qp, log2);
    }
    __syncthreads();
  }
  reconstruct_block(tab, rec, w, x0, y0, n, s);
}

template <bool kRecon, bool kK2>
__global__ void intra_level_kernel(
    const uint8_t* sy, const uint8_t* scb, const uint8_t* scr, uint8_t* ry,
    uint8_t* rcb, uint8_t* rcr, int16_t* ly, int16_t* lcb, int16_t* lcr,
    const int* recs, const int* tab, const int* rank, int kmax, int H,
    int W, int strong, int flags) {
  __shared__ Scratch s;
  const int f = blockIdx.y;
  const int* r = recs + ((size_t)f * kmax + blockIdx.x) * RFIELDS;
  if (r[RVALID] == 0) return;         // uniform over the block
  const size_t oy = (size_t)f * H * W, oc = (size_t)f * (H / 2) * (W / 2);
  const int n = r[RSIZE];
  const unsigned al = (unsigned)r[RAL], ac = (unsigned)r[RAC],
                 at = (unsigned)r[RAT];
  run_block<kRecon, kK2>(tab, rank, kRecon ? nullptr : sy + oy, ry + oy,
                         ly + oy, W, H, r[RX], r[RY], n, 1, 0, r[RMODE],
                         r[RQP], al, ac, at, strong != 0, flags, s);
  run_block<kRecon, kK2>(tab, rank, kRecon ? nullptr : scb + oc, rcb + oc,
                         lcb + oc, W / 2, H / 2, r[RX] / 2, r[RY] / 2, n / 2,
                         2, 1, r[RCMODE], r[RQPCB], al, ac, at, false, flags,
                         s);
  run_block<kRecon, kK2>(tab, rank, kRecon ? nullptr : scr + oc, rcr + oc,
                         lcr + oc, W / 2, H / 2, r[RX] / 2, r[RY] / 2, n / 2,
                         2, 2, r[RCMODE], r[RQPCR], al, ac, at, false, flags,
                         s);
}

}  // namespace

// K6: sources -> levels and reconstruction, one level of the schedule;
// flags: KS_RDOQ and KS_SBH of rdoq.cuh (rank: the 4x4 scan-rank table).
extern "C" int ks_intra_level(const void* sy, const void* scb,
                              const void* scr, void* ry, void* rcb,
                              void* rcr, void* ly, void* lcb, void* lcr,
                              const void* recs, const void* tab,
                              const void* rank, int kmax, int F, int H,
                              int W, int strong, int flags, void* stream) {
  if (kmax <= 0 || F <= 0) return 0;
  auto kernel = flags ? intra_level_kernel<false, true>
                      : intra_level_kernel<false, false>;
  kernel<<<dim3(kmax, F), 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)sy, (const uint8_t*)scb, (const uint8_t*)scr,
      (uint8_t*)ry, (uint8_t*)rcb, (uint8_t*)rcr, (int16_t*)ly,
      (int16_t*)lcb, (int16_t*)lcr, (const int*)recs, (const int*)tab,
      (const int*)rank, kmax, H, W, strong, flags);
  return (int)cudaGetLastError();
}

// K11: levels (read only) -> reconstruction, one level of the schedule.
extern "C" int ks_intra_recon_level(const void* ly, const void* lcb,
                                    const void* lcr, void* ry, void* rcb,
                                    void* rcr, const void* recs,
                                    const void* tab, int kmax, int F, int H,
                                    int W, int strong, void* stream) {
  if (kmax <= 0 || F <= 0) return 0;
  intra_level_kernel<true, false><<<dim3(kmax, F), 256, 0,
                                     (cudaStream_t)stream>>>(
      nullptr, nullptr, nullptr, (uint8_t*)ry, (uint8_t*)rcb, (uint8_t*)rcr,
      (int16_t*)ly, (int16_t*)lcb, (int16_t*)lcr, (const int*)recs,
      (const int*)tab, nullptr, kmax, H, W, strong, 0);
  return (int)cudaGetLastError();
}

extern "C" const char* ks_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
