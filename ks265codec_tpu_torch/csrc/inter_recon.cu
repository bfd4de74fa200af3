// K18 — the residual of a decoded P or B picture's inter CUs, replacing
// ks265codec_tpu/ops/wavefront.py::_dense_residual inside
// `_recon_inter_filter_core`. The rest of K18 is launches of ported
// kernels: K14 MC before (`ks_inter_mc` over one list or, in B pictures,
// both; its prediction planes this kernel updates in place), then K11
// for the intra CUs, K7 and K9.
//
// The reference inverse-transforms every aligned tile of every size class
// densely and selects per sample (gathers are slow on a TPU). Here the
// host lists the inter CUs' transform units (TU == CU: luma 8/16/32 and
// the two chroma TUs at half size), one thread block per TU: dequantise
// with the QP at the TU's origin (chroma through the PPS + slice offset
// tables, already applied to the chroma QP maps), inverse DCT in shared
// memory, add to the prediction, clip to 8 bits. A TU whose coefficients
// are all zero leaves the prediction as it is and stops after the load.
//
// Bound: bytes for the picture (the int16 coefficients read once, the
// prediction read and written once); the inverse transforms of the coded
// TUs (2 stages of n multiply-adds a sample, matrix form) are small
// against that at the QPs of the fast presets.
#include "common.cuh"

namespace {

__global__ void inter_recon_kernel(const int* tus, const int16_t* cy,
                                   const int16_t* ccb, const int16_t* ccr,
                                   uint8_t* ry, uint8_t* rcb, uint8_t* rcr,
                                   const int* qpy, const int* qpcb,
                                   const int* qpcr, const int* tab, int H,
                                   int W) {
  __shared__ int d[KS_MAX_N * KS_MAX_N];
  __shared__ int tmp[KS_MAX_N * KS_MAX_N];
  __shared__ int r[KS_MAX_N * KS_MAX_N];
  const int* t = tus + 4 * blockIdx.x;
  const int pl = t[0], x0 = t[1], y0 = t[2], n = t[3];
  const int w = pl == 0 ? W : W / 2;
  const int16_t* coef = pl == 0 ? cy : (pl == 1 ? ccb : ccr);
  uint8_t* rec = pl == 0 ? ry : (pl == 1 ? rcb : rcr);
  // QP maps: one value per 4x4 of this plane, (h / 4, w / 4)
  const int* qmap = pl == 0 ? qpy : (pl == 1 ? qpcb : qpcr);
  const int qp = qmap[(size_t)(y0 >> 2) * (w >> 2) + (x0 >> 2)];
  const int log2 = ks_log2(n);
  bool nz = false;
  for (int p = threadIdx.x; p < n * n; p += blockDim.x) {
    const int lev = coef[(size_t)(y0 + p / n) * w + x0 + p % n];
    nz = nz || lev != 0;
    d[p] = ks_dequant(tab, lev, qp, log2);
  }
  if (!__syncthreads_or(nz)) return;
  ks_inv_dct(tab, n, d, tmp, r);
  for (int p = threadIdx.x; p < n * n; p += blockDim.x) {
    const size_t o = (size_t)(y0 + p / n) * w + x0 + p % n;
    rec[o] = (uint8_t)ks_clip3(0, 255, (int)rec[o] + r[p]);
  }
}

}  // namespace

// tus: (K, 4) int32 (plane, x, y, n); coefficient planes int16 and
// reconstruction planes uint8, (H, W) and (H/2, W/2); qpy (H/4, W/4),
// qpcb / qpcr (H/8, W/8) int32.
extern "C" int ks_inter_recon(const void* tus, const void* cy,
                              const void* ccb, const void* ccr, void* ry,
                              void* rcb, void* rcr, const void* qpy,
                              const void* qpcb, const void* qpcr,
                              const void* tab, int K, int H, int W,
                              void* stream) {
  if (K <= 0) return 0;
  inter_recon_kernel<<<K, 256, 0, (cudaStream_t)stream>>>(
      (const int*)tus, (const int16_t*)cy, (const int16_t*)ccb,
      (const int16_t*)ccr, (uint8_t*)ry, (uint8_t*)rcb, (uint8_t*)rcr,
      (const int*)qpy, (const int*)qpcb, (const int*)qpcr, (const int*)tab,
      H, W);
  return (int)cudaGetLastError();
}
