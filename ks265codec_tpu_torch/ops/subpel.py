"""Quarter-pel refinement and the bi-prediction cost (K21) of the
sequential P/B host walk.

Counterpart of ks265codec_tpu/ops/subpel.py (`gather_windows`,
`_interp_cand`, `subpel_costs`, `interp14_by_phase`, `SUBPEL_CANDS`,
`refine_subpel_frame`, `bi_pred_cost`). The interpolation is the
decoder's MC filter: 8-tap luma, horizontal without a shift then
vertical >> 6, a full-pel candidate << 6, the uni combine
clip((p + 32) >> 6), the bi one clip((p0 + p1 + 64) >> 7); the SATD is
K4's 8x8 Hadamard, (s + 2) >> 2 per tile, summed.

Two device functions:
  * `subpel_costs`: the SATD of each of the 49 quarter-pel candidates of
    every block from its window (N, bs + 10, bs + 10) against its source
    (N, bs, bs), (N, 49) int32; CUDA `ks_subpel_costs`
    (csrc/subpel.cu);
  * `bi_cost`: the SATD of the bi average of each block's list-0 and
    list-1 predictions at the block's own phase, (N,) int32; CUDA
    `ks_subpel_bi_cost`. The reference (`bi_pred_cost`) builds all 16
    phases of every block with `interp14_by_phase` and then picks one, a
    static-shape device's workaround at 16 times the work; the plain
    version here does the same, the kernel computes each block's phase
    only. Both give the same SATDs.
CUDA tensors launch the kernels; CPU tensors, or reference=True, run the
plain versions. The window gathers, the float64 mvd-rate term of
`refine_subpel_frame` and its argmin stay host numpy as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..hevc.tables import LUMA_FILTER
from . import _build
from .cost import satd
from .me import blocks_of

MARGIN = 5               # window margin each side of the integer base

# full quarter-pel neighbourhood (+-0.75 pel), (dx, dy) with dx fastest
SUBPEL_CANDS = tuple((dx, dy) for dy in range(-3, 4) for dx in range(-3, 4))
ALL_PHASES = tuple((fx, fy) for fy in range(4) for fx in range(4))


def gather_windows(ref: np.ndarray, base_xy: np.ndarray, bs: int,
                   pic_w: int, pic_h: int) -> np.ndarray:
    """Per-block (bs+2*MARGIN)^2 windows at integer positions base_xy
    (N,2), edge-clamped. ref is the full (padded) plane."""
    win = bs + 2 * MARGIN
    ys = np.clip(base_xy[:, 1, None] - MARGIN + np.arange(win)[None, :],
                 0, pic_h - 1)
    xs = np.clip(base_xy[:, 0, None] - MARGIN + np.arange(win)[None, :],
                 0, pic_w - 1)
    return ref[ys[:, :, None], xs[:, None, :]].astype(np.int32)


def _interp_cand(windows: torch.Tensor, bs: int, qx: int, qy: int):
    """14-bit prediction (N, bs, bs) int32 for quarter-pel offset (qx, qy)
    relative to the window's integer base at index MARGIN."""
    fx, fy = qx & 3, qy & 3
    ix = MARGIN + (qx >> 2)
    iy = MARGIN + (qy >> 2)
    fh = LUMA_FILTER[fx]
    fv = LUMA_FILTER[fy]
    w = windows.to(torch.int32)
    if fx == 0 and fy == 0:
        return w[:, iy:iy + bs, ix:ix + bs] << 6
    if fy == 0:
        acc = torch.zeros_like(w[:, :bs, :bs])
        for k in range(8):
            c = int(fh[k])
            if c:
                acc = acc + c * w[:, iy:iy + bs, ix - 3 + k:ix - 3 + k + bs]
        return acc
    if fx == 0:
        acc = torch.zeros_like(w[:, :bs, :bs])
        for k in range(8):
            c = int(fv[k])
            if c:
                acc = acc + c * w[:, iy - 3 + k:iy - 3 + k + bs, ix:ix + bs]
        return acc
    # horizontal into rows [iy-3, iy+bs+4), then vertical >> 6
    rows = bs + 7
    tmp = torch.zeros_like(w[:, :rows, :bs])
    for k in range(8):
        c = int(fh[k])
        if c:
            tmp = tmp + c * w[:, iy - 3:iy - 3 + rows,
                              ix - 3 + k:ix - 3 + k + bs]
    acc = torch.zeros_like(w[:, :bs, :bs])
    for k in range(8):
        c = int(fv[k])
        if c:
            acc = acc + c * tmp[:, k:k + bs, :]
    return acc >> 6


def interp14_by_phase(windows: torch.Tensor, bs: int, phases: tuple):
    """14-bit predictions for a list of (qx, qy): (len, N, bs, bs) int32."""
    return torch.stack([_interp_cand(windows, bs, qx, qy)
                        for qx, qy in phases])


# ------------------------------------------------------- subpel_costs

def subpel_costs_plain(windows: torch.Tensor, src: torch.Tensor,
                       bs: int) -> torch.Tensor:
    outs = []
    for (qx, qy) in SUBPEL_CANDS:
        pix = ((_interp_cand(windows, bs, qx, qy) + 32) >> 6).clamp(0, 255)
        outs.append(satd(pix, src, 8))
    return torch.stack(outs, dim=1)


def _check(t: torch.Tensor, shape, what: str) -> None:
    if t.dtype != torch.int32 or not t.is_cuda or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected a contiguous int32 CUDA tensor "
                         f"of shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def subpel_costs_cuda(windows: torch.Tensor, src: torch.Tensor,
                      bs: int) -> torch.Tensor:
    """`ks_subpel_costs`: one thread block per block, its window in shared
    memory, one thread per (candidate, 8x8 tile)."""
    n = src.shape[0]
    if bs not in (8, 16):
        raise ValueError("subpel_costs: the kernel takes bs 8 or 16")
    _check(windows, (n, bs + 2 * MARGIN, bs + 2 * MARGIN), "subpel_costs")
    _check(src, (n, bs, bs), "subpel_costs")
    out = torch.empty((n, len(SUBPEL_CANDS)), dtype=torch.int32,
                      device=src.device)
    if n == 0:
        return out
    lib = _build.kernels()
    P = _build.ptr
    _build.check(lib.ks_subpel_costs(P(windows), P(src), P(out), n, bs,
                                     _build.stream(out.device)),
                 "ks_subpel_costs")
    _build.count("subpel_costs")
    return out


def subpel_costs(windows: torch.Tensor, src: torch.Tensor, bs: int,
                 reference: bool = False) -> torch.Tensor:
    """SATD cost of each of the 49 SUBPEL_CANDS quarter-pel offsets:
    windows (N, bs+10, bs+10), src (N, bs, bs) int32 -> (N, 49) int32."""
    if src.device.type != "cuda" or reference:
        return subpel_costs_plain(windows, src, bs)
    return subpel_costs_cuda(windows.contiguous(), src.contiguous(), bs)


# ------------------------------------------------------- bi cost

def bi_cost_plain(win0: torch.Tensor, win1: torch.Tensor,
                  mv0_q: torch.Tensor, mv1_q: torch.Tensor,
                  src: torch.Tensor, bs: int) -> torch.Tensor:
    """The reference's way: all 16 phases of every block, then each
    block's own."""
    n = src.shape[0]
    rows = torch.arange(n, device=src.device)
    preds = []
    for win, mq in ((win0, mv0_q), (win1, mv1_q)):
        p_all = interp14_by_phase(win, bs, ALL_PHASES)
        phases = (mq & 3).long()
        preds.append(p_all[phases[:, 1] * 4 + phases[:, 0], rows])
    bi = ((preds[0] + preds[1] + 64) >> 7).clamp(0, 255)
    return satd(bi, src, 8)


def bi_cost_cuda(win0: torch.Tensor, win1: torch.Tensor,
                 mv0_q: torch.Tensor, mv1_q: torch.Tensor,
                 src: torch.Tensor, bs: int) -> torch.Tensor:
    """`ks_subpel_bi_cost`: one thread block per block, both windows in
    shared memory, one thread per sample for the two predictions and
    their average, one per 8x8 tile for the SATD."""
    n = src.shape[0]
    if bs not in (8, 16):
        raise ValueError("bi_cost: the kernel takes bs 8 or 16")
    ws = (n, bs + 2 * MARGIN, bs + 2 * MARGIN)
    for t, shape in ((win0, ws), (win1, ws), (mv0_q, (n, 2)),
                     (mv1_q, (n, 2)), (src, (n, bs, bs))):
        _check(t, shape, "bi_cost")
    out = torch.empty((n,), dtype=torch.int32, device=src.device)
    if n == 0:
        return out
    lib = _build.kernels()
    P = _build.ptr
    _build.check(lib.ks_subpel_bi_cost(P(win0), P(win1), P(mv0_q),
                                       P(mv1_q), P(src), P(out), n, bs,
                                       _build.stream(out.device)),
                 "ks_subpel_bi_cost")
    _build.count("subpel_bi_cost")
    return out


def bi_cost(win0: torch.Tensor, win1: torch.Tensor, mv0_q: torch.Tensor,
            mv1_q: torch.Tensor, src: torch.Tensor, bs: int,
            reference: bool = False) -> torch.Tensor:
    """SATD (N,) int32 of clip((p0 + p1 + 64) >> 7) against src (N, bs,
    bs), p0 / p1 the 14-bit predictions at the phases mv & 3 of each
    block's quarter-pel motion mv0_q / mv1_q (N, 2), from windows
    (N, bs+10, bs+10) based at block + (mv >> 2)."""
    if src.device.type != "cuda" or reference:
        return bi_cost_plain(win0, win1, mv0_q, mv1_q, src, bs)
    return bi_cost_cuda(*(t.to(torch.int32).contiguous()
                          for t in (win0, win1, mv0_q, mv1_q, src)), bs)


# ------------------------------------------------------- host wrappers

def _up(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)


def refine_subpel_frame(src_y: np.ndarray, ref_y: np.ndarray,
                        mv_full: np.ndarray, bs: int,
                        pic_w: int | None = None, pic_h: int | None = None,
                        mv_pred_q: np.ndarray | None = None,
                        lam: float = 0.0, device=None,
                        reference: bool = False):
    """Refine a frame's per-block integer MVs (full-pel, (nby,nbx,2)) to
    quarter-pel. pic_w/pic_h: valid reference area for edge clamping
    (defaults to the plane size). With mv_pred_q (quarter-pel predictor
    field, same shape) and lam, each candidate also pays the float64
    mvd-rate term lam * (2 + 2 log2(1 + |dx|) + 2 log2(1 + |dy|)).
    Returns (mv_q, cost)."""
    h, w = src_y.shape
    pic_w = pic_w or w
    pic_h = pic_h or h
    nby, nbx = h // bs, w // bs
    blocks = blocks_of(src_y, bs)
    mvf = mv_full.reshape(-1, 2)
    bx = np.tile(np.arange(nbx) * bs, nby)
    by = np.repeat(np.arange(nby) * bs, nbx)
    base = np.stack([bx + mvf[:, 0], by + mvf[:, 1]], axis=1)
    windows = gather_windows(ref_y.astype(np.int32), base, bs, pic_w, pic_h)
    dev = resolve_device(device)
    costs = subpel_costs(_up(windows, dev), _up(blocks, dev), bs,
                         reference=reference).cpu().numpy()
    if mv_pred_q is not None and lam > 0.0:
        cand = np.asarray(SUBPEL_CANDS)                       # [49, 2]
        mvq_all = mvf[:, None, :] * 4 + cand[None]            # [N, 49, 2]
        d = np.abs(mvq_all - mv_pred_q.reshape(-1, 2)[:, None, :])
        bits = (2.0 + 2.0 * np.log2(1.0 + d[..., 0])
                + 2.0 * np.log2(1.0 + d[..., 1]))
        costs = costs + lam * bits
    bi = np.argmin(costs, axis=1)
    best = np.asarray(SUBPEL_CANDS)[bi]
    mv_q = mvf * 4 + best
    return (mv_q.reshape(nby, nbx, 2),
            costs[np.arange(len(bi)), bi].reshape(nby, nbx))


def bi_pred_cost(src_y, ref0, ref1, mv0_q, mv1_q, bs,
                 pic_w=None, pic_h=None, device=None,
                 reference: bool = False):
    """Exact bi-prediction cost (nby, nbx) int32 per block for the chosen
    quarter-pel (mv0, mv1)."""
    h, w = src_y.shape
    pic_w = pic_w or w
    pic_h = pic_h or h
    nby, nbx = h // bs, w // bs
    blocks = blocks_of(src_y, bs)
    m0 = mv0_q.reshape(-1, 2)
    m1 = mv1_q.reshape(-1, 2)
    bxs = np.tile(np.arange(nbx) * bs, nby)
    bys = np.repeat(np.arange(nby) * bs, nbx)
    wins = []
    for ref, mq in ((ref0, m0), (ref1, m1)):
        base = np.stack([bxs + (mq[:, 0] >> 2), bys + (mq[:, 1] >> 2)],
                        axis=1)
        wins.append(gather_windows(ref.astype(np.int32), base, bs, pic_w,
                                   pic_h))
    dev = resolve_device(device)
    cost = bi_cost(*(_up(a, dev) for a in (wins[0], wins[1], m0, m1,
                                            blocks)), bs,
                   reference=reference).cpu().numpy()
    return cost.reshape(nby, nbx)
