// K9 — SAO application (spec 8.7.3) to one plane of a batch of frames.
//
// Replaces ks265codec_tpu/ops/saoapply.py::sao_apply_core (`_apply_plane`,
// batched by `sao_apply_batch`): every sample of the picture (w x h) takes
// its CTB's SAO type — 0 off, 1 band offset (band (rec >> 3) - band
// position, mod 32, below 4 picks an offset), 2 edge offset (category of
// the EO class from the two neighbours, categories 0, 1, 3, 4 pick offsets
// 0..3; a sample whose neighbour lies outside the picture keeps its value)
// — and is clipped to [0, 255]. Samples outside w x h are copied through.
//
// One thread per sample. Every thread reads its neighbours from the input
// plane and writes a separate output plane: SAO in place would let an edge
// neighbour be read after it was filtered.
//
// Bound: bytes (one byte read and one written per sample; the neighbours
// come from L1/L2 and the per-CTB parameters are a few KB).
#include "common.cuh"

namespace {

__global__ void sao_apply_kernel(const uint8_t* in, uint8_t* out,
                                 const int8_t* type, const int8_t* offs,
                                 const int8_t* bpos, const int8_t* eocl,
                                 int F, int H, int W, int w, int h, int cs,
                                 int c) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t plane = (size_t)H * W;
  if (i >= (size_t)F * plane) return;
  const int f = (int)(i / plane);
  const int rem = (int)(i - (size_t)f * plane);
  const int y = rem / W, x = rem % W;
  const uint8_t* p = in + (size_t)f * plane;
  const int v = p[rem];
  int o = v;
  if (y < h && x < w) {
    const int ncty = H / cs, nctx = W / cs;
    const size_t pi =
        (((size_t)f * 3 + c) * ncty + y / cs) * nctx + x / cs;
    const int t = type[pi];
    if (t == 1) {
      const int k = ((v >> 3) - bpos[pi]) & 31;
      if (k < 4) o = ks_clip3(0, 255, v + offs[pi * 4 + k]);
    } else if (t == 2) {
      const int cls = eocl[pi];
      const int ay = y + ks_eo_offs[cls][0], ax = x + ks_eo_offs[cls][1];
      const int by = y + ks_eo_offs[cls][2], bx = x + ks_eo_offs[cls][3];
      if (ay >= 0 && ay < h && ax >= 0 && ax < w && by >= 0 && by < h &&
          bx >= 0 && bx < w) {
        const int e =
            2 + ks_sgn(v - p[ay * W + ax]) + ks_sgn(v - p[by * W + bx]);
        if (e != 2) o = ks_clip3(0, 255, v + offs[pi * 4 + (e < 2 ? e : e - 1)]);
      }
    }
  }
  out[i] = (uint8_t)o;
}

}  // namespace

// in/out: (F, H, W) uint8, plane c of the frames; type/bpos/eocl:
// (F, 3, H/cs, W/cs) int8, offs: (F, 3, H/cs, W/cs, 4) int8.
extern "C" int ks_sao_apply(const void* in, void* out, const void* type,
                            const void* offs, const void* bpos,
                            const void* eocl, int F, int H, int W, int w,
                            int h, int cs, int c, void* stream) {
  const size_t n = (size_t)F * H * W;
  if (n == 0) return 0;
  sao_apply_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, (const int8_t*)type,
      (const int8_t*)offs, (const int8_t*)bpos, (const int8_t*)eocl, F, H, W,
      w, h, cs, c);
  return (int)cudaGetLastError();
}
