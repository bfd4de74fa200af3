"""Per-CTB SAO statistics (K8) of a batch of planes, and the per-frame
wrapper the host SAO decision reads (K22).

Counterpart of ks265codec_tpu/ops/saostats.py (`sao_stats_plane_core`,
`sao_frame_stats`), batched over frames as ops/wavefront.py::
_fused_rows_core runs it: for every CTB, the count and the sum of
(source - reconstruction) of the samples in each edge-offset category of
each EO class (neighbours edge-clamped, a sample counting only when it and
both neighbours lie inside the w x h picture) and, with `bo`, in each of
the 32 bands (rec >> 3). All sums are exact int32.

CUDA: csrc/sao_stats.cu, one launch per plane batch, one thread block per
(CTB, frame). The plain version runs frame by frame, as the reference's
`lax.map` does, with one histogram per class over (CTB, category) keys.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import resolve_device
from . import _build

# EO class -> (dy_a, dx_a, dy_b, dx_b), the order of encode/sao.py
EO_OFFS = ((0, -1, 0, 1), (-1, 0, 1, 0), (-1, -1, 1, 1), (-1, 1, 1, -1))


def _shift(x, dy: int, dx: int):
    """x[:, y+dy, x+dx] with the coordinates clamped to the plane."""
    F, H, W = x.shape
    ys = (torch.arange(H, device=x.device) + dy).clamp(0, H - 1)
    xs = (torch.arange(W, device=x.device) + dx).clamp(0, W - 1)
    return x[:, ys][:, :, xs]


def _check(rec, src, cs: int):
    if rec.shape != src.shape or rec.dim() != 3:
        raise ValueError("rec and src must be (F, H, W) of one shape")
    if rec.dtype != torch.uint8 or src.dtype != torch.uint8:
        raise ValueError("rec and src must be uint8")
    if rec.shape[1] % cs or rec.shape[2] % cs:
        raise ValueError("plane dims must be multiples of the CTB size")


def sao_stats_frames_plain(rec, src, w: int, h: int, cs: int,
                           classes: int = 4, bo: bool = True):
    """Plain PyTorch version. rec/src (F, H, W) uint8 padded planes;
    w/h the picture dims and cs the CTB size in this plane's samples.
    Returns (eo_cnt, eo_err) (F, classes, 5, H/cs, W/cs) int32 and
    (bo_cnt, bo_err) (F, 32, H/cs, W/cs) int32, or None when not bo."""
    _check(rec, src, cs)
    F, H, W = rec.shape
    ncty, nctx = H // cs, W // cs
    dev = rec.device
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    inpic = (ys < h) & (xs < w)
    ctb = ((ys // cs) * nctx + xs // cs).expand(H, W)
    nct = ncty * nctx

    def hist(keys, m, vals, nbins):
        out = torch.zeros(nbins * nct, dtype=torch.int64, device=dev)
        k = (keys * nct + ctb)[m]
        cnt = out.index_add(0, k, torch.ones_like(k))
        err = out.index_add(0, k, vals[m])
        return (cnt.view(nbins, ncty, nctx).to(torch.int32),
                err.view(nbins, ncty, nctx).to(torch.int32))

    eo_cnt = torch.empty((F, classes, 5, ncty, nctx), dtype=torch.int32,
                         device=dev)
    eo_err = torch.empty_like(eo_cnt)
    bo_cnt = bo_err = None
    if bo:
        bo_cnt = torch.empty((F, 32, ncty, nctx), dtype=torch.int32,
                             device=dev)
        bo_err = torch.empty_like(bo_cnt)
    for f in range(F):
        r = rec[f:f + 1].to(torch.int64)
        diff = (src[f].to(torch.int64) - r[0])
        for k, (ay, ax, by, bx) in enumerate(EO_OFFS[:classes]):
            valid = (inpic
                     & (ys + ay >= 0) & (ys + ay < h)
                     & (xs + ax >= 0) & (xs + ax < w)
                     & (ys + by >= 0) & (ys + by < h)
                     & (xs + bx >= 0) & (xs + bx < w))
            idx = (2 + torch.sign(r - _shift(r, ay, ax))
                   + torch.sign(r - _shift(r, by, bx)))[0]
            eo_cnt[f, k], eo_err[f, k] = hist(idx, valid, diff, 5)
        if bo:
            bo_cnt[f], bo_err[f] = hist(r[0] >> 3, inpic, diff, 32)
    return eo_cnt, eo_err, bo_cnt, bo_err


def sao_stats_frames_cuda(rec, src, w: int, h: int, cs: int,
                          classes: int = 4, bo: bool = True):
    """The statistics on the card: one launch of `ks_sao_stats`."""
    _check(rec, src, cs)
    if not (rec.is_cuda and src.is_cuda):
        raise ValueError("rec and src must be CUDA tensors")
    if classes not in (2, 4):
        raise ValueError("classes must be 2 or 4")
    rec, src = rec.contiguous(), src.contiguous()
    F, H, W = rec.shape
    ncty, nctx = H // cs, W // cs
    lib = _build.kernels()
    eo_cnt = torch.empty((F, classes, 5, ncty, nctx), dtype=torch.int32,
                         device=rec.device)
    eo_err = torch.empty_like(eo_cnt)
    bo_cnt = bo_err = None
    if bo:
        bo_cnt = torch.empty((F, 32, ncty, nctx), dtype=torch.int32,
                             device=rec.device)
        bo_err = torch.empty_like(bo_cnt)
    P = _build.ptr
    bptr = (P(bo_cnt), P(bo_err)) if bo else (ctypes.c_void_p(0),) * 2
    rc = lib.ks_sao_stats(P(rec), P(src), P(eo_cnt), P(eo_err), *bptr, F,
                          H, W, w, h, cs, classes, int(bo),
                          _build.stream(rec.device))
    _build.check(rc, "ks_sao_stats")
    _build.count("sao_stats")
    return eo_cnt, eo_err, bo_cnt, bo_err


def sao_stats_frames(rec, src, w: int, h: int, cs: int, classes: int = 4,
                     bo: bool = True, reference: bool = False):
    """SAO statistics of a batch of planes. CUDA tensors launch the
    kernel; CPU tensors, or reference=True, run the plain version."""
    if rec.device.type != "cuda" or reference:
        return sao_stats_frames_plain(rec, src, w, h, cs, classes, bo)
    return sao_stats_frames_cuda(rec, src, w, h, cs, classes, bo)


def sao_frame_stats(fs, src_y, src_cb, src_cr, device=None,
                    reference: bool = False):
    """Statistics of one frame's three planes (all EO classes and the
    bands) -> per plane a tuple of numpy arrays (eo_cnt, eo_err, bo_cnt,
    bo_err), the contract encode/sao.py's host decision reads. Runs on
    CUDA unless the caller names another device; reference=True runs the
    plain version there."""
    device = resolve_device(device)
    sps = fs.sps
    cs = sps.ctb_size
    out = []
    for rec, src, shift in ((fs.y, src_y, 0), (fs.cb, src_cb, 1),
                            (fs.cr, src_cr, 1)):
        r, s = (torch.from_numpy(np.asarray(a).astype(np.uint8))[None]
                .to(device) for a in (rec, src))
        st = sao_stats_frames(r, s, sps.width >> shift, sps.height >> shift,
                              cs >> shift, reference=reference)
        out.append(tuple(a[0].cpu().numpy() for a in st))
    return out
