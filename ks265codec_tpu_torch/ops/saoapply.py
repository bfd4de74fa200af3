"""SAO application (K9, spec 8.7.3) to a batch of deblocked frames.

Counterpart of ks265codec_tpu/ops/saoapply.py (`sao_apply_core`, batched
by `sao_apply_batch`): every sample of the w x h picture takes its CTB's
type (0 off, 1 band offset, 2 edge offset), offsets, band position and EO
class; samples outside the picture are copied through. Parameters are
(F, 3, H/cs, W/cs) int8 per field and (F, 3, H/cs, W/cs, 4) int8 offsets,
one slice per plane.

CUDA: csrc/sao_apply.cu, one launch per filtered plane, one thread per
sample, reading neighbours from the unfiltered input and writing a new
plane. The plain version runs frame by frame, as the reference's
`lax.map` does.
"""

from __future__ import annotations

import torch

from . import _build
from .saostats import EO_OFFS, _shift


def _apply_plane_plain(plane, type_, offs, bpos, eocl, cs: int, w: int,
                       h: int):
    """One plane (H, W) uint8 with its params (nctY, nctX[, 4])."""
    src = plane[:h, :w].to(torch.int64)
    dev = plane.device

    def rep(a):
        return a.to(torch.int64).repeat_interleave(cs, 0) \
            .repeat_interleave(cs, 1)[:h, :w]

    t_px = rep(type_)
    offs_px = [rep(offs[..., k]) for k in range(4)]
    bidx = ((src >> 3) - rep(bpos)) & 31
    bo = torch.zeros_like(src)
    for k in range(4):
        bo = torch.where(bidx == k, offs_px[k], bo)
    out_bo = (src + bo).clamp(0, 255)
    eoc_px = rep(eocl)
    sgn_a = torch.zeros_like(src)
    sgn_b = torch.zeros_like(src)
    valid = torch.zeros(src.shape, dtype=torch.bool, device=dev)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    for cls, (ay, ax, by, bx) in enumerate(EO_OFFS):
        m = eoc_px == cls
        a = _shift(src[None], ay, ax)[0]
        b = _shift(src[None], by, bx)[0]
        sgn_a = torch.where(m, torch.sign(src - a), sgn_a)
        sgn_b = torch.where(m, torch.sign(src - b), sgn_b)
        v = ((ys + ay >= 0) & (ys + ay < h) & (ys + by >= 0)
             & (ys + by < h) & (xs + ax >= 0) & (xs + ax < w)
             & (xs + bx >= 0) & (xs + bx < w))
        valid = torch.where(m, v, valid)
    edge = 2 + sgn_a + sgn_b
    eo = torch.zeros_like(src)
    for e, k in ((0, 0), (1, 1), (3, 2), (4, 3)):
        eo = torch.where(edge == e, offs_px[k], eo)
    out_eo = torch.where(valid, (src + eo).clamp(0, 255), src)
    out = torch.where(t_px == 0, src, torch.where(t_px == 1, out_bo, out_eo))
    res = plane.clone()
    res[:h, :w] = out.to(plane.dtype)
    return res


def _check(y, cb, cr, type_, offs, bpos, eocl, cs: int):
    F, H, W = y.shape
    for p, shape in ((y, (F, H, W)), (cb, (F, H // 2, W // 2)),
                     (cr, (F, H // 2, W // 2))):
        if p.dtype != torch.uint8 or tuple(p.shape) != shape:
            raise ValueError("planes must be uint8 (F, H, W), (F, H/2, W/2)")
    grid = (F, 3, H // cs, W // cs)
    for a, shape in ((type_, grid), (bpos, grid), (eocl, grid),
                     (offs, grid + (4,))):
        if a.dtype != torch.int8 or tuple(a.shape) != shape:
            raise ValueError(f"SAO params must be int8 {shape}")


def sao_apply_frames_plain(y, cb, cr, type_, offs, bpos, eocl,
                           sao_luma: bool, sao_chroma: bool, w: int,
                           h: int, cs: int):
    """Plain PyTorch version: returns the (y, cb, cr) planes after SAO;
    a plane that is not filtered is returned as it was given."""
    _check(y, cb, cr, type_, offs, bpos, eocl, cs)
    out = []
    for c, plane, on in ((0, y, sao_luma), (1, cb, sao_chroma),
                         (2, cr, sao_chroma)):
        if not on:
            out.append(plane)
            continue
        s = 0 if c == 0 else 1
        out.append(torch.stack([
            _apply_plane_plain(plane[f], type_[f, c], offs[f, c],
                               bpos[f, c], eocl[f, c], cs >> s, w >> s,
                               h >> s)
            for f in range(plane.shape[0])]))
    return tuple(out)


def sao_apply_frames_cuda(y, cb, cr, type_, offs, bpos, eocl,
                          sao_luma: bool, sao_chroma: bool, w: int, h: int,
                          cs: int):
    """SAO on the card: one launch of `ks_sao_apply` per filtered plane,
    each into a new plane."""
    _check(y, cb, cr, type_, offs, bpos, eocl, cs)
    tensors = (y, cb, cr, type_, offs, bpos, eocl)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("planes and params must be CUDA tensors")
    lib = _build.kernels()
    P = _build.ptr
    st = _build.stream(y.device)
    prm = [t.contiguous() for t in (type_, offs, bpos, eocl)]
    out = []
    for c, plane, on in ((0, y, sao_luma), (1, cb, sao_chroma),
                         (2, cr, sao_chroma)):
        if not on:
            out.append(plane)
            continue
        s = 0 if c == 0 else 1
        src = plane.contiguous()
        dst = torch.empty_like(src)
        F, H, W = src.shape
        rc = lib.ks_sao_apply(P(src), P(dst), *(P(t) for t in prm), F, H, W,
                              w >> s, h >> s, cs >> s, c, st)
        _build.check(rc, "ks_sao_apply")
        _build.count("sao_apply")
        out.append(dst)
    return tuple(out)


def sao_apply_frames(y, cb, cr, type_, offs, bpos, eocl, sao_luma: bool,
                     sao_chroma: bool, w: int, h: int, cs: int,
                     reference: bool = False):
    """SAO for a batch of frames on their device. CUDA tensors launch the
    kernel; CPU tensors, or reference=True, run the plain version."""
    if y.device.type != "cuda" or reference:
        return sao_apply_frames_plain(y, cb, cr, type_, offs, bpos, eocl,
                                      sao_luma, sao_chroma, w, h, cs)
    return sao_apply_frames_cuda(y, cb, cr, type_, offs, bpos, eocl,
                                 sao_luma, sao_chroma, w, h, cs)
