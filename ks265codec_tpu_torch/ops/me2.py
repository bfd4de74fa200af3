"""Pyramid motion estimation (K13) for 8x8 blocks against one or more
reference pictures: a dense quarter-resolution search, +-3 refinement at
half and at full resolution, and 49 quarter-pel candidates scored by
SATD plus motion-vector rate; in B pictures (bi=True) then the cost of
bi-prediction from both winners and each block's direction.

Counterpart of ks265codec_tpu/ops/me2.py::_me_fused_core (`_down2`,
`_dense_l2`, `_med3`, `_refine3`, `_subpel8`, `_bi_cost8`; the
quarter-pel interpolation of ops/subpel.py::_interp_cand is the MC filter
of ops/mc.py). Levels, for a picture of H x W luma samples:
  * quarter resolution: the SAD of every 4x4 block (16x16 luma) over
    +-sr offsets into the edge-padded quarter plane (1089 offsets at
    merange 64), then a re-rank by SAD + lam * mv rate around the median
    of the left, top and top-right winners;
  * half resolution: +-3 around twice the quarter winner (8x8 luma per
    4x4 half-res block), SAD, first of 49 on ties;
  * full resolution: +-3 around twice the half winner;
  * quarter-pel: the 49 offsets (-3..3)^2 quarter samples around the full
    winner, SATD8 of the interpolated block plus lam * mvd rate against
    the median of the neighbours' full-pel winners;
  * bi (B pictures, references L0[0] and L1[0]): the SATD8 sbi of the
    rounded average clip((p0 + p1 + 64) >> 7) of both winners' 14-bit
    predictions; dir8 = 2 where sbi + 8 lam < min(cost0, cost1) (strict),
    else 1 where cost1 < cost0 (ties to list 0), and sad8 = min(best uni,
    sbi + 8 lam). 8 lam is exact in float32, so the sum is one rounding
    whether or not the reference backend fuses it.
Search windows read the reference clamped per sample to the coded
picture, except the quarter-resolution search, which pads the whole
quarter plane as the reference does.

The float32 costs steer the search, so both versions reproduce the
reference backend's float32 sequence (queue 3 of ROADMAP.md): `jnp.log2`
is XLA's log times float32(1/ln 2) (`_logtab.log2_table`), and the
rate sums and their scaling by lambda follow `_rate_l2` / `_rate_q`.

CUDA: csrc/me.cu, one launch per level: the quarter-resolution search
(one thread block per 4x4 quarter block, one thread per offset, SAD grid
and re-rank in shared memory), the two refinements and the quarter-pel
stage (one thread block per block); the downsamples are one launch each;
with bi, one launch of the bi cost (one thread block per 8x8 block, one
thread per sample, the SATD and the decision in one thread).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from . import cost as tcost
from ..interop import device_log_table
from .decide import fma32
from .mc import interp_cells

_INT_OFFS = np.array([(dx, dy) for dy in range(-3, 4)
                      for dx in range(-3, 4)], np.int32)
_C2 = float(2.0 * np.float32(1.0 / np.log(2.0)))


def sr_for(merange: int) -> int:
    """Quarter-resolution search range for a merange (16 at 64)."""
    return int(np.clip(max(merange, 16) // 4, 8, 16))


def _log2(x: torch.Tensor) -> torch.Tensor:
    """`jnp.log2` of integer-valued x in 1..32767, as float32."""
    return device_log_table(x.device, True)[x.long()]


# ------------------------------------------------------- plain PyTorch path

def down2(p: torch.Tensor) -> torch.Tensor:
    """(..., H, W) int32 -> (..., H/2, W/2), (sum of 2x2 + 2) >> 2."""
    return (p[..., 0::2, 0::2] + p[..., 0::2, 1::2] + p[..., 1::2, 0::2]
            + p[..., 1::2, 1::2] + 2) >> 2


def med3(a: torch.Tensor) -> torch.Tensor:
    """(nby, nbx, 2) int -> median of (left, top, top-right) per cell, the
    grid edge-padded."""
    p = torch.nn.functional.pad(a.permute(2, 0, 1)[None].float(),
                                (1, 1, 1, 1), mode="replicate")[0] \
        .permute(1, 2, 0).to(a.dtype)
    st = torch.stack([p[1:-1, :-2], p[:-2, 1:-1], p[:-2, 2:]])
    return st.sort(0).values[1]


def _rate_l2(pred: torch.Tensor, sr: int) -> torch.Tensor:
    """(nby, nbx, n*n) float32 rate 2 log2(1 + 4|dy|) + 2 log2(1 + 4|dx|)
    of every offset against the predictor (nby, nbx, 2)."""
    offs = torch.arange(-sr, sr + 1, device=pred.device)
    rx = 2.0 * _log2(1 + 4 * (offs - pred[..., 0:1]).abs())
    ry = 2.0 * _log2(1 + 4 * (offs - pred[..., 1:2]).abs())
    n = 2 * sr + 1
    return (ry[..., :, None] + rx[..., None, :]).reshape(*pred.shape[:2],
                                                          n * n)


def dense_l2(src_q: torch.Tensor, ref_q: torch.Tensor, sr: int,
             lam: torch.Tensor) -> torch.Tensor:
    """(H, W) quarter planes -> (nby, nbx, 2) full-pel winners of the
    dense +-sr search of each 4x4 block, re-ranked by SAD + lam * rate."""
    H, W = src_q.shape
    nby, nbx = H // 4, W // 4
    n = 2 * sr + 1
    pad = torch.nn.functional.pad(ref_q.float()[None, None], (sr,) * 4,
                                  mode="replicate")[0, 0].to(torch.int32)
    grid = torch.stack([
        (src_q - pad[dy:dy + H, dx:dx + W]).abs()
        .reshape(nby, 4, nbx, 4).sum((1, 3))
        for dy in range(n) for dx in range(n)], -1)       # (nby, nbx, n2)
    best1 = grid.argmin(-1)
    mv1 = torch.stack([best1 % n - sr, best1 // n - sr], -1)
    pred = med3(mv1).clamp(-sr, sr)
    cost = fma32(lam, _rate_l2(pred, sr), grid.float())
    best = cost.argmin(-1)
    return torch.stack([best % n - sr, best // n - sr], -1).to(torch.int32)


def _blocks(plane: torch.Tensor, bs: int) -> torch.Tensor:
    H, W = plane.shape
    return plane.reshape(H // bs, bs, W // bs, bs).transpose(1, 2) \
        .reshape(-1, bs, bs)


def _windows(ref: torch.Tensor, by0, bx0, win: int, pic_w: int, pic_h: int):
    d = torch.arange(win, device=ref.device)
    rows = (by0[:, None] + d).clamp(0, pic_h - 1)
    cols = (bx0[:, None] + d).clamp(0, pic_w - 1)
    return ref[rows[:, :, None], cols[:, None, :]]


def refine3(src: torch.Tensor, ref: torch.Tensor, bs: int,
            centers: torch.Tensor, pic_w: int, pic_h: int):
    """+-3 full-pel refinement of bs x bs blocks around centers
    (nby, nbx, 2). Returns (mv, sad)."""
    H, W = src.shape
    nby, nbx = H // bs, W // bs
    dev = src.device
    blocks = _blocks(src, bs)
    cy = torch.arange(nby, device=dev)[:, None] * bs
    cx = torch.arange(nbx, device=dev)[None, :] * bs
    bx0 = (cx + centers[..., 0] - 3).reshape(-1)
    by0 = (cy + centers[..., 1] - 3).reshape(-1)
    w = _windows(ref, by0, bx0, bs + 6, pic_w, pic_h)
    sads = torch.stack([
        (w[:, dy + 3:dy + 3 + bs, dx + 3:dx + 3 + bs] - blocks).abs()
        .sum((1, 2)) for dx, dy in _INT_OFFS.tolist()], 1)   # (K, 49)
    sad, best = sads.min(1)
    off = torch.as_tensor(_INT_OFFS, device=dev)
    mv = centers.reshape(-1, 2) + off[best]
    return mv.reshape(nby, nbx, 2), sad.reshape(nby, nbx)


def _rate_q(d: torch.Tensor) -> torch.Tensor:
    """float32 2 + 2 log2(1 + |dx|) + 2 log2(1 + |dy|) of (K, 2) |mvd|,
    as the reference backend contracts it: two fused multiply-adds of
    XLA's log by 2 * float32(1/ln 2)."""
    lg = device_log_table(d.device)
    c2 = torch.tensor(_C2, dtype=torch.float32, device=d.device)
    t = fma32(lg[(1 + d[:, 0]).long()], c2, torch.full_like(c2, 2.0))
    return fma32(lg[(1 + d[:, 1]).long()], c2, t)


def subpel8(src: torch.Tensor, ref: torch.Tensor, mv_full: torch.Tensor,
            lam: torch.Tensor, pic_w: int, pic_h: int):
    """Quarter-pel refinement of 8x8 integer winners (nby, nbx, 2).
    Returns (mv_q (nby, nbx, 2) int32, cost (nby, nbx) float32)."""
    H, W = src.shape
    nby, nbx = H // 8, W // 8
    dev = src.device
    blocks = _blocks(src, 8)
    K = nby * nbx
    r = torch.arange(K, device=dev) // nbx
    c = torch.arange(K, device=dev) % nbx
    pred_q = med3(mv_full * 4).reshape(-1, 2)
    mvq0 = mv_full.reshape(-1, 2) * 4
    zero = torch.zeros(K, dtype=torch.int64, device=dev)
    costs = []
    for qx, qy in _INT_OFFS.tolist():
        mx, my = mvq0[:, 0] + qx, mvq0[:, 1] + qy
        p14 = interp_cells(ref[None], zero, mx, my, 8, r * 8, c * 8, True,
                           pic_w, pic_h)
        pix = ((p14 + 32) >> 6).clamp(0, 255)
        sat = tcost.satd(pix, blocks, 8).float()
        d = (torch.stack([mx, my], 1) - pred_q).abs()
        costs.append(fma32(lam, _rate_q(d), sat))
    costs = torch.stack(costs, 1)
    cost, best = costs.min(1)
    off = torch.as_tensor(_INT_OFFS, device=dev)
    mv_q = mvq0 + off[best]
    return mv_q.reshape(nby, nbx, 2).to(torch.int32), cost.reshape(nby, nbx)


def bi_cost8(src: torch.Tensor, ref0: torch.Tensor, ref1: torch.Tensor,
             mv0q: torch.Tensor, mv1q: torch.Tensor, pic_w: int, pic_h: int):
    """The reference's `_bi_cost8`: SATD8 (nby, nbx) int32 of the rounded
    average of each 8x8 block's list-0 and list-1 quarter-pel predictions.
    src / ref0 / ref1 (H, W) int32, mv0q / mv1q (nby, nbx, 2)."""
    H, W = src.shape
    nby, nbx = H // 8, W // 8
    dev = src.device
    K = nby * nbx
    r = torch.arange(K, device=dev) // nbx
    c = torch.arange(K, device=dev) % nbx
    zero = torch.zeros(K, dtype=torch.int64, device=dev)
    p0, p1 = (interp_cells(ref[None], zero, mv.reshape(-1, 2)[:, 0],
                           mv.reshape(-1, 2)[:, 1], 8, r * 8, c * 8, True,
                           pic_w, pic_h)
              for ref, mv in ((ref0, mv0q), (ref1, mv1q)))
    bi = ((p0 + p1 + 64) >> 7).clamp(0, 255)
    return tcost.satd(bi, _blocks(src, 8), 8).reshape(nby, nbx)


def bi_decide(sbi: torch.Tensor, cost: torch.Tensor, lam):
    """(dir8 int8, sad8 float32) from the bi SATD and the two lists'
    costs (2, nby, nbx): bi where sbi + 8 lam beats the better list."""
    bb = sbi.to(torch.float32) + torch.as_tensor(lam, dtype=torch.float32,
                                                 device=sbi.device) * 8.0
    best_uni = torch.minimum(cost[0], cost[1])
    dir8 = torch.where(bb < best_uni, 2, (cost[1] < cost[0]).to(torch.int64))
    return dir8.to(torch.int8), torch.minimum(best_uni, bb)


def me_fused_plain(src_y: torch.Tensor, refs_y: torch.Tensor, lam8,
                   sr_q: int, pic_w: int, pic_h: int, bi: bool = False):
    """Plain version of the reference's `_me_fused_core`.
    src_y (H, W) uint8, refs_y (R, H, W) uint8. Returns
    (mv_q (R, H/8, W/8, 2) int32, cost (R, H/8, W/8) float32) and, with
    bi (R = 2: L0[0], L1[0]), dir8 (H/8, W/8) int8 and sad8 float32."""
    lam = torch.tensor(lam8, dtype=torch.float32, device=src_y.device)
    src = src_y.to(torch.int32)
    src_h = down2(src)
    src_q = down2(src_h)
    mvs, costs = [], []
    for ref_u8 in refs_y:
        ref = ref_u8.to(torch.int32)
        ref_h = down2(ref)
        ref_q = down2(ref_h)
        mv2 = dense_l2(src_q, ref_q, sr_q, lam)
        cen_h = (mv2 * 2).repeat_interleave(2, 0).repeat_interleave(2, 1)
        cen_h = cen_h[:src_h.shape[0] // 4, :src_h.shape[1] // 4]
        mv_h, _ = refine3(src_h, ref_h, 4, cen_h, pic_w // 2, pic_h // 2)
        mv_f, _ = refine3(src, ref, 8, mv_h * 2, pic_w, pic_h)
        mv_q, cost = subpel8(src, ref, mv_f, lam, pic_w, pic_h)
        mvs.append(mv_q)
        costs.append(cost)
    mv_q, cost = torch.stack(mvs), torch.stack(costs)
    if not bi:
        return mv_q, cost
    sbi = bi_cost8(src, refs_y[0].to(torch.int32), refs_y[1].to(torch.int32),
                   mv_q[0], mv_q[1], pic_w, pic_h)
    return (mv_q, cost) + bi_decide(sbi, cost, lam)


# ------------------------------------------------------------- CUDA kernel

def me_fused_cuda(src_y: torch.Tensor, refs_y: torch.Tensor, lam8,
                  sr_q: int, pic_w: int, pic_h: int, bi: bool = False):
    """The pyramid on the card: downsamples, then one launch per level;
    with bi, the launch of the bi cost and decision."""
    for t in (src_y, refs_y):
        if t.dtype != torch.uint8 or not t.is_cuda or not t.is_contiguous():
            raise ValueError("ME planes must be contiguous uint8 CUDA tensors")
    H, W = src_y.shape
    R = refs_y.shape[0]
    if refs_y.shape[1:] != (H, W) or H % 16 or W % 16:
        raise ValueError("ME planes must be (H, W) / (R, H, W), multiples "
                         "of 16")
    lib = _build.kernels()
    st = _build.stream(src_y.device)
    P = _build.ptr
    dev = src_y.device
    # the picture and every reference at half and quarter resolution
    planes = torch.cat([src_y[None], refs_y])              # (R+1, H, W)
    half = torch.empty((R + 1, H // 2, W // 2), dtype=torch.uint8,
                       device=dev)
    quarter = torch.empty((R + 1, H // 4, W // 4), dtype=torch.uint8,
                          device=dev)
    for a, b, h, w in ((planes, half, H, W), (half, quarter, H // 2,
                                              W // 2)):
        _build.check(lib.ks_me_down2(P(a), P(b), R + 1, h, w, st),
                     "ks_me_down2")
        _build.count("me_down2")
    lam = ctypes.c_float(float(np.float32(lam8)))
    nby8, nbx8 = H // 8, W // 8
    mv1 = torch.empty((R, H // 16, W // 16, 2), dtype=torch.int32,
                      device=dev)
    mv2 = torch.empty_like(mv1)
    _build.check(lib.ks_me_dense_l2(P(quarter), P(mv1), P(mv2),
                                    P(device_log_table(dev, True)), R,
                                    H // 4, W // 4, sr_q, lam, st),
                 "ks_me_dense_l2")
    _build.count("me_dense_l2")
    mv_h = torch.empty((R, nby8, nbx8, 2), dtype=torch.int32, device=dev)
    _build.check(lib.ks_me_refine3(P(half), P(mv2), P(mv_h), R, H // 2,
                                   W // 2, 4, 1, pic_w // 2, pic_h // 2, st),
                 "ks_me_refine3")
    _build.count("me_refine3")
    mv_f = torch.empty_like(mv_h)
    _build.check(lib.ks_me_refine3(P(planes), P(mv_h), P(mv_f), R, H, W, 8,
                                   0, pic_w, pic_h, st), "ks_me_refine3")
    _build.count("me_refine3")
    mv_q = torch.empty_like(mv_f)
    cost = torch.empty((R, nby8, nbx8), dtype=torch.float32, device=dev)
    _build.check(lib.ks_me_subpel8(P(planes), P(mv_f), P(mv_q), P(cost), R,
                                   H, W, pic_w, pic_h, lam,
                                   P(device_log_table(dev)), st),
                 "ks_me_subpel8")
    _build.count("me_subpel8")
    if not bi:
        return mv_q, cost
    dir8 = torch.empty((nby8, nbx8), dtype=torch.int8, device=dev)
    sad8 = torch.empty((nby8, nbx8), dtype=torch.float32, device=dev)
    _build.check(lib.ks_me_bi_cost8(P(planes), P(mv_q), P(cost), P(dir8),
                                    P(sad8), H, W, pic_w, pic_h, lam, st),
                 "ks_me_bi_cost8")
    _build.count("me_bi_cost8")
    return mv_q, cost, dir8, sad8


def me_fused(src_y: torch.Tensor, refs_y: torch.Tensor, merange: int,
             lam8: float, pic_w: int, pic_h: int, bi: bool = False,
             reference: bool = False):
    """Motion search of every 8x8 block of src_y (H, W) uint8 against each
    reference of refs_y (R, H, W) uint8. Returns (mv_q (R, H/8, W/8, 2)
    int32 quarter-pel, cost (R, H/8, W/8) float32) and, with bi (a B
    picture: refs_y holds L0[0] and L1[0]), (dir8 (H/8, W/8) int8 0/1/2,
    sad8 float32) after them. CUDA tensors launch the kernels; CPU
    tensors, or reference=True, run the plain version."""
    if bi and refs_y.shape[0] != 2:
        raise ValueError("the bi cost takes two references, L0[0] and "
                         "L1[0]")
    sr_q = sr_for(merange)
    if src_y.device.type != "cuda" or reference:
        return me_fused_plain(src_y, refs_y, lam8, sr_q, pic_w, pic_h, bi)
    return me_fused_cuda(src_y.contiguous(), refs_y.contiguous(), lam8,
                         sr_q, pic_w, pic_h, bi)
