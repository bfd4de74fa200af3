// K6 — intra coding scan, one dependency level per launch, and K11 —
// intra reconstruction from parsed levels, every level in one launch.
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
// Bound: a level has few CUs (the wavefront is at most a few hundred CUs
// wide at 720p) and each CU's blocks run one after another, so the scan is
// bound by latency — launches and the serial steps inside a block — not by
// bytes or operations. Its arithmetic stays plain (matrix products from
// global tables, one substitution pass in one thread); its persistent
// form, K11's scheme below, is the next redesign.
//
// K11 replaces ks265codec_tpu/ops/wavefront.py::_recon_intra_frame_core
// (`_recon_class`): the decoder's twin, which reads each block's levels
// from the parsed coefficient planes instead of quantising a source. Its
// bound is operations, the inverse transforms: about 0.004 ms a 720p
// picture on an H100 (0.066 ms a 16-frame batch); what it paid was about
// 54 launches a picture, one per level (1.28 ms), and a long serial chain
// inside each CU's block. It is one persistent launch per call
// (intra_recon_persistent_kernel below): the levels follow each other
// through per-frame completion counters instead of launches, the residual
// is computed before the wait, the three planes run at once and the
// substitution is a warp ballot scan.
#include <cuda/atomic>

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

// One n x n block of one plane, in place: residual of src against the
// prediction, forward transform and quantisation through K2's functions
// (deadzone rounding, or RDOQ, and sign hiding as `flags` select).
// Without K2's tools (kK2 false) each thread signs its own levels and the
// group pass with its two synchronisations is skipped: run at flags 0,
// the group pass made the ultrafast scan 6-8% slower on an H100. The
// levels go to lev; then dequantisation, inverse transform and
// reconstruction.
template <bool kK2>
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
  reconstruct_block(tab, rec, w, x0, y0, n, s);
}

template <bool kK2>
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
  run_block<kK2>(tab, rank, sy + oy, ry + oy, ly + oy, W, H, r[RX], r[RY], n,
                 1, 0, r[RMODE], r[RQP], al, ac, at, strong != 0, flags, s);
  run_block<kK2>(tab, rank, scb + oc, rcb + oc, lcb + oc, W / 2, H / 2,
                 r[RX] / 2, r[RY] / 2, n / 2, 2, 1, r[RCMODE], r[RQPCB], al,
                 ac, at, false, flags, s);
  run_block<kK2>(tab, rank, scr + oc, rcr + oc, lcr + oc, W / 2, H / 2,
                 r[RX] / 2, r[RY] / 2, n / 2, 2, 2, r[RCMODE], r[RQPCR], al,
                 ac, at, false, flags, s);
}

// ---------------------------------------------------------------- K11
//
// The persistent reconstruction: one launch runs every level of the
// schedule. The host hands over the valid records only, in ticket order
// (level, then frame, then slot: ops/wavefront.py::ticket_order), each with
// its frame and the number of its frame's CUs of lower levels. A block
// takes the next ticket from an atomic counter, dequantises and inverse
// transforms the CU's three blocks (they read no neighbour), then waits
// until its frame's completion counter reaches that number, builds the
// refs from the published samples (read past L1), predicts, adds, stores,
// and publishes: a barrier, then thread 0's release increment of the
// frame's counter (the waiter's acquire load pairs with it). A frame's counter
// reaches the number of its CUs below level L only once all of them are
// done: a CU of level L or above completes only after its own wait, so the
// first time the counter equals that number, every completed CU lies below
// L.
//
// Why it cannot deadlock: tickets are handed out in level order and a
// block takes one only while it runs. Every CU a block waits on is of a
// lower level of the same frame, so it holds a lower ticket, already taken
// by a running block, which itself waits only on still lower tickets; the
// lowest ticket not done waits on nothing.
//
// Inside a CU, luma (warps 0-3), Cb (4-5) and Cr (6-7) read only their own
// planes and run at once, each group with its own named barrier. The
// reference substitution is a scan: each warp ballots the availability of
// 32 contour samples, and each sample takes the last available one at or
// before it (else the first available) from the ballot words. The
// transform, dequantisation and angle tables sit in shared memory, loaded
// once per block.
struct Group {
  int contour[4 * KS_MAX_N + 1];
  unsigned okw[5];
  int ru[4 * KS_MAX_N + 1];
  int rf[4 * KS_MAX_N + 1];
  int a[KS_MAX_N * KS_MAX_N];   // dequantised levels, then the residual
  int b[KS_MAX_N * KS_MAX_N];
};

enum { TFRAME = RFIELDS, TWAIT, TFIELDS };

__device__ __forceinline__ void group_sync(int g, int size) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(size) : "memory");
}

__global__ void __launch_bounds__(256)
    intra_recon_persistent_kernel(const int16_t* ly, const int16_t* lcb,
                                  const int16_t* lcr, uint8_t* ry,
                                  uint8_t* rcb, uint8_t* rcr,
                                  const int* tickets, int* counters,
                                  const int* tab, int ntickets, int H, int W,
                                  int strong) {
  __shared__ int stab[T_BETA];
  __shared__ Group grp[3];
  __shared__ int s_ticket;
  for (int i = threadIdx.x; i < T_BETA; i += blockDim.x) stab[i] = tab[i];
  // luma: threads 0-127, Cb: 128-191, Cr: 192-255
  const int g = threadIdx.x < 128 ? 0 : (threadIdx.x < 192 ? 1 : 2);
  const int gsize = g ? 64 : 128, gt = threadIdx.x - (g ? 64 + 64 * g : 0);
  const int lane = threadIdx.x & 31;
  Group& s = grp[g];
  const bool luma = g == 0;
  const int pw = luma ? W : W / 2, ph = luma ? H : H / 2;
  const int16_t* lev = g == 0 ? ly : (g == 1 ? lcb : lcr);
  uint8_t* rec = g == 0 ? ry : (g == 1 ? rcb : rcr);
  cuda::atomic_ref<int, cuda::thread_scope_device> next(counters[0]);
  for (;;) {
    __syncthreads();              // the previous CU's scratch is free
    if (threadIdx.x == 0) s_ticket = next.fetch_add(1);
    __syncthreads();
    const int t = s_ticket;
    if (t >= ntickets) break;
    const int* r = tickets + (size_t)t * TFIELDS;
    const int f = __ldg(r + TFRAME);
    const int n = luma ? __ldg(r + RSIZE) : __ldg(r + RSIZE) / 2;
    const int x0 = luma ? __ldg(r + RX) : __ldg(r + RX) / 2;
    const int y0 = luma ? __ldg(r + RY) : __ldg(r + RY) / 2;
    const int mode = __ldg(r + (luma ? RMODE : RCMODE));
    const int qp = __ldg(r + (g == 0 ? RQP : (g == 1 ? RQPCB : RQPCR)));
    const size_t po = (size_t)f * ph * pw;
    const int log2 = ks_log2(n), nn = n * n;
    // the residual first: it reads no neighbour
    const int* M = ks_dct(stab, n);
    for (int p = gt; p < nn; p += gsize)
      s.a[p] = ks_dequant(stab, __ldg(lev + po + (size_t)(y0 + p / n) * pw +
                                      x0 + p % n),
                          qp, log2);
    group_sync(g, gsize);
    for (int p = gt; p < nn; p += gsize) {
      const int i = p / n, c = p % n;
      int acc = 0;
      for (int k = 0; k < n; k++) acc += M[k * n + i] * s.a[k * n + c];
      s.b[p] = ks_clip3(-32768, 32767, (acc + 64) >> 7);
    }
    group_sync(g, gsize);
    for (int p = gt; p < nn; p += gsize) {
      const int i = p / n, j = p % n;
      int acc = 0;
      for (int k = 0; k < n; k++) acc += s.b[i * n + k] * M[k * n + j];
      s.a[p] = ks_clip3(-32768, 32767, (acc + 2048) >> 12);
    }
    // wait for every CU of a lower level of this frame
    if (threadIdx.x == 0) {
      cuda::atomic_ref<int, cuda::thread_scope_device> done(counters[1 + f]);
      const int want = __ldg(r + TWAIT);
      // a wait of seconds means broken inputs: fail the launch (the
      // wrapper's next CUDA call raises) rather than hang the card
      for (long spins = 0; done.load(cuda::memory_order_acquire) < want;
           spins++) {
        if (spins > (1L << 26)) __trap();
        __nanosleep(64);
      }
    }
    __syncthreads();
    // contour (bottom-left upward, corner, top left-to-right) from the
    // published samples, read past L1, with its availability ballots
    const int n2 = 2 * n, L = 4 * n + 1, expand = luma ? 1 : 2;
    const unsigned al = (unsigned)__ldg(r + RAL),
                   ac = (unsigned)__ldg(r + RAC),
                   at = (unsigned)__ldg(r + RAT);
    for (int i = gt; i < (L + 31) / 32 * 32; i += gsize) {
      int avail = 0;
      if (i < L) {
        int yy, xx;
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
        avail = avail && yy >= 0 && xx >= 0 && yy < ph && xx < pw;
        s.contour[i] = avail ? __ldcg(rec + po + (size_t)yy * pw + xx) : 0;
      }
      const unsigned w = __ballot_sync(0xffffffffu, avail);
      if (lane == 0) s.okw[i >> 5] = w;
    }
    group_sync(g, gsize);
    // substitution (spec 8.4.4.2.2): the last available sample at or
    // before i, else the first available one, else 128
    const int nw = (L + 31) / 32;
    for (int i = gt; i < L; i += gsize) {
      int src = -1;
      const int w = i >> 5;
      const unsigned m = s.okw[w] & (0xffffffffu >> (31 - (i & 31)));
      if (m) {
        src = (w << 5) + 31 - __clz(m);
      } else {
        for (int v = w - 1; v >= 0 && src < 0; v--)
          if (s.okw[v]) src = (v << 5) + 31 - __clz(s.okw[v]);
        for (int v = 0; v < nw && src < 0; v++)
          if (s.okw[v]) src = (v << 5) + __ffs(s.okw[v]) - 1;
      }
      s.ru[i < n2 ? n2 - 1 - i : i] = src < 0 ? 128 : s.contour[src];
    }
    group_sync(g, gsize);
    if (luma) {
      // [1 2 1] filtering, or the 32x32 strong smoothing where it applies
      const int c = s.ru[n2];
      const bool sflag = strong && n == 32 &&
                         abs(c + s.ru[n2 + n2] - 2 * s.ru[n2 + n]) < 8 &&
                         abs(c + s.ru[n2 - 1] - 2 * s.ru[n - 1]) < 8;
      for (int i = gt; i < L; i += gsize) {
        int v;
        if (!sflag) {
          const int q = i < n2 ? n2 - 1 - i : i;   // contour position
          auto at2 = [&](int u) {
            return u < n2 ? s.ru[n2 - 1 - u] : s.ru[u];
          };
          v = (q == 0 || q == L - 1)
                  ? at2(q)
                  : (at2(q - 1) + 2 * at2(q) + at2(q + 1) + 2) >> 2;
        } else if (i == n2) {
          v = c;
        } else {
          const int k = i < n2 ? i : i - n2 - 1, b = k + 1;
          const int e = i < n2 ? s.ru[n2 - 1] : s.ru[n2 + n2];
          v = k == n2 - 1 ? e : ((64 - b) * c + b * e + 32) >> 6;
        }
        s.rf[i] = v;
      }
      group_sync(g, gsize);
    }
    const int dc = mode == 1 ? ks_dc_value(s.ru, n) : 0;
    const int* rf = luma ? s.rf : s.ru;
    for (int p = gt; p < nn; p += gsize) {
      const int pred = ks_pred_pixel(stab, mode, n, luma, s.ru, rf, dc,
                                     p / n, p % n);
      rec[po + (size_t)(y0 + p / n) * pw + x0 + p % n] =
          (uint8_t)ks_clip3(0, 255, pred + s.a[p]);
    }
    // publish: the block's stores precede thread 0's release at device
    // scope through the barrier (the release is cumulative), and the
    // waiter's acquire load pairs with it
    __syncthreads();
    if (threadIdx.x == 0) {
      cuda::atomic_ref<int, cuda::thread_scope_device> done(counters[1 + f]);
      done.fetch_add(1, cuda::memory_order_release);
    }
  }
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
  auto kernel = flags ? intra_level_kernel<true>
                      : intra_level_kernel<false>;
  kernel<<<dim3(kmax, F), 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)sy, (const uint8_t*)scb, (const uint8_t*)scr,
      (uint8_t*)ry, (uint8_t*)rcb, (uint8_t*)rcr, (int16_t*)ly,
      (int16_t*)lcb, (int16_t*)lcr, (const int*)recs, (const int*)tab,
      (const int*)rank, kmax, H, W, strong, flags);
  return (int)cudaGetLastError();
}

// K11: levels (read only) -> reconstruction, every level in one launch.
// tickets: (ntickets, TFIELDS) int32 in ticket order; counters: 1 + F
// zeroed int32 (the ticket counter, then each frame's completed CUs). The
// grid is as many blocks as the card holds at once, or fewer.
extern "C" int ks_intra_recon(const void* ly, const void* lcb,
                              const void* lcr, void* ry, void* rcb,
                              void* rcr, const void* tickets, void* counters,
                              const void* tab, int ntickets, int H, int W,
                              int strong, void* stream) {
  if (ntickets <= 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, intra_recon_persistent_kernel, 256, 0);
  if (e != cudaSuccess) return (int)e;
  const int grid = min(ntickets, max(1, per_sm * sms));
  intra_recon_persistent_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int16_t*)ly, (const int16_t*)lcb, (const int16_t*)lcr,
      (uint8_t*)ry, (uint8_t*)rcb, (uint8_t*)rcr, (const int*)tickets,
      (int*)counters, (const int*)tab, ntickets, H, W, strong);
  return (int)cudaGetLastError();
}

extern "C" const char* ks_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
