"""Motion compensation (K14): whole-frame inter prediction from motion
carried on the 8x8-cell grid, as plain PyTorch int32.

Counterpart of ks265codec_tpu/ops/mc.py (`_interp_cells`, `_combine`,
`_mc_core`): 8-tap luma and 4-tap chroma separable filters of spec
8.5.4.2.2 with 14-bit intermediates, then the uni (`(p + 32) >> 6`) or bi
(`(p0 + p1 + 64) >> 7`) combine. Reference samples are clamped per sample
to the coded picture (pic_w x pic_h), never to the CTB-aligned plane, as
the reference's clamped window starts on an edge-replicated pad read.

Phase 0 of each filter is the integer pick with weight 64, so one `>> 6`
after the vertical pass restores every fx/fy case exactly: the reference
computes the same sums as float32 matrix products, exact below 2^24. The
port computes them in int32 and does not carry the TPU's phase-expanded
matrices or 8-bit limb splits. Explicit weighted prediction is not ported.

CUDA: the same arithmetic as `__device__` functions in csrc/mc.cuh
(`ks_mc_sample`, `ks_mc_uni`, `ks_mc_bi`, `ks_mc_pred`), inlined in K13
(csrc/me.cu) and K15 (csrc/inter_decide.cu); the whole-picture
`mc_planes` launches `ks_inter_mc` (csrc/inter_code.cu, one thread block
per 8x8 cell; list 1 a template argument, so P pictures run the uni code
alone) for K17's coding pass and K18's decode.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hevc.tables import CHROMA_FILTER, LUMA_FILTER
from . import _build

_LUMA = np.asarray(LUMA_FILTER, np.int32)
_CHROMA = np.asarray(CHROMA_FILTER, np.int32)


def interp_cells(ref_stack: torch.Tensor, slot: torch.Tensor,
                 mvx: torch.Tensor, mvy: torch.Tensor, t: int,
                 base_r: torch.Tensor, base_c: torch.Tensor, luma: bool,
                 pic_w: int, pic_h: int) -> torch.Tensor:
    """14-bit prediction of K blocks of t x t samples. ref_stack (R, H, W)
    integer planes; slot (K,) reference index (>= 0); mv in quarter-pel
    (luma) or eighth-pel (chroma) units; (base_r, base_c) block origins.
    Returns (K, t, t) int32."""
    dev = ref_stack.device
    fb, taps, pad_l = (2, 8, 3) if luma else (3, 4, 1)
    filt = torch.as_tensor(_LUMA if luma else _CHROMA, device=dev)
    mvx = mvx.to(torch.int64)
    mvy = mvy.to(torch.int64)
    iy = base_r.to(torch.int64) + (mvy >> fb) - pad_l
    ix = base_c.to(torch.int64) + (mvx >> fb) - pad_l
    fy = mvy & ((1 << fb) - 1)
    fx = mvx & ((1 << fb) - 1)
    n_in = t + taps - 1
    d = torch.arange(n_in, device=dev)
    rows = (iy[:, None] + d).clamp(0, pic_h - 1)
    cols = (ix[:, None] + d).clamp(0, pic_w - 1)
    patch = ref_stack[slot.to(torch.int64)[:, None, None], rows[:, :, None],
                      cols[:, None, :]].to(torch.int32)     # (K, n_in, n_in)
    hx = filt[fx]                                           # (K, taps)
    h = sum(hx[:, k, None, None] * patch[:, :, k:k + t] for k in range(taps))
    vy = filt[fy]
    v = sum(vy[:, k, None, None] * h[:, k:k + t, :] for k in range(taps))
    return v >> 6


def combine(p0: torch.Tensor, p1: torch.Tensor, use0: torch.Tensor,
            use1: torch.Tensor) -> torch.Tensor:
    """Spec 8.5.4.2.5.2 default combine of 14-bit predictions to 8 bits;
    use0/use1 (K, 1, 1) bool."""
    bi = (p0 + p1 + 64) >> 7
    out = torch.where(use0 & use1, bi,
                      torch.where(use0, (p0 + 32) >> 6, (p1 + 32) >> 6))
    return out.clamp(0, 255)


def pred_blocks(refs: torch.Tensor, s0, v0, s1, v1, xs, ys, n: int,
                pic_w: int, pic_h: int, has_l1: bool,
                chroma: bool) -> torch.Tensor:
    """(K, n, n) 8-bit combined prediction at arbitrary origins (the
    reference's interdecide `_pred_blocks`); s1/v1 are read only with
    has_l1."""
    use0 = (s0 >= 0)[:, None, None]
    p0 = interp_cells(refs, s0.clamp(min=0), v0[:, 0], v0[:, 1], n, ys, xs,
                      not chroma, pic_w, pic_h)
    if has_l1:
        p1 = interp_cells(refs, s1.clamp(min=0), v1[:, 0], v1[:, 1], n, ys,
                          xs, not chroma, pic_w, pic_h)
        return combine(p0, p1, use0, (s1 >= 0)[:, None, None])
    return combine(p0, p0, use0, torch.zeros_like(use0))


def untile(blk: torch.Tensor, h_t: int, w_t: int) -> torch.Tensor:
    """(h_t * w_t, t, t) raster-ordered tiles -> (h_t * t, w_t * t)."""
    t = blk.shape[-1]
    return blk.reshape(h_t, w_t, t, t).transpose(1, 2).reshape(h_t * t,
                                                                w_t * t)


def mc_planes_plain(refs_y, refs_cb, refs_cr, slot0, mv0, slot1, mv1,
                    has_l1: bool, h8: int, w8: int, pic_w: int, pic_h: int):
    """Plain version of the reference's `_mc_core` without weighted
    prediction. refs_* (R, H, W) / (R, H/2, W/2) integer stacks; slot*
    (h8*w8,) int (-1: list unused), mv* (h8*w8, 2) quarter-pel [x, y].
    Returns (pred_y, pred_cb, pred_cr) uint8 planes of the stacks' size."""
    dev = refs_y.device
    K = slot0.shape[0]
    r = torch.arange(K, device=dev) // w8
    c = torch.arange(K, device=dev) % w8
    use0 = (slot0 >= 0)[:, None, None]
    s0 = slot0.clamp(min=0)
    s1 = slot1.clamp(min=0)
    use1 = (slot1 >= 0)[:, None, None]
    outs = []
    for stack, t, luma in ((refs_y, 8, True), (refs_cb, 4, False),
                           (refs_cr, 4, False)):
        cw, chh = (pic_w, pic_h) if luma else (pic_w // 2, pic_h // 2)
        p0 = interp_cells(stack, s0, mv0[:, 0], mv0[:, 1], t, r * t, c * t,
                          luma, cw, chh)
        if has_l1:
            p1 = interp_cells(stack, s1, mv1[:, 0], mv1[:, 1], t, r * t,
                              c * t, luma, cw, chh)
            blk = combine(p0, p1, use0, use1)
        else:
            blk = combine(p0, p0, use0, torch.zeros_like(use0))
        outs.append(untile(blk.to(torch.uint8), stack.shape[1] // t,
                           stack.shape[2] // t))
    return tuple(outs)


def mc_planes_cuda(refs, slot0, mv0, slot1, mv1, has_l1: bool, h8: int,
                   w8: int, pic_w: int, pic_h: int):
    """K14 on the card: the predicted planes of the (h8, w8) cell grid from
    per-cell motion (`mc_planes_plain`), one launch of `ks_inter_mc`; list
    1 (slot1, mv1) is read only with has_l1."""
    for t in refs:
        if t.dtype != torch.uint8 or not t.is_cuda or not t.is_contiguous():
            raise ValueError("reference stacks must be contiguous uint8 "
                             "CUDA tensors")
    dev = refs[0].device
    R, H, W = refs[0].shape
    if (H, W) != (8 * h8, 8 * w8):
        raise ValueError("the cell grid must cover the planes")
    slot0, slot1 = (s.to(device=dev, dtype=torch.int32).contiguous()
                    for s in (slot0, slot1))
    mv0, mv1 = (m.to(device=dev, dtype=torch.int32).contiguous()
                for m in (mv0, mv1))
    pred = tuple(torch.empty(r.shape[1:], dtype=torch.uint8, device=dev)
                 for r in refs)
    P = _build.ptr
    _build.check(_build.kernels().ks_inter_mc(
        P(refs[0]), P(refs[1]), P(refs[2]), P(slot0), P(mv0), P(slot1),
        P(mv1), P(pred[0]), P(pred[1]), P(pred[2]), h8, w8, H, W, pic_w,
        pic_h, int(has_l1), _build.stream(dev)), "ks_inter_mc")
    _build.count("inter_mc_bi" if has_l1 else "inter_mc")
    return pred


def mc_planes(refs, slot0, mv0, slot1, mv1, has_l1: bool, h8: int, w8: int,
              pic_w: int, pic_h: int, reference: bool = False):
    """Predicted (y, cb, cr) uint8 planes of the cell grid from per-cell
    motion: refs (R, H, W) uint8 stacks, slot0 / slot1 (h8*w8,) (-1: the
    list is unused), mv0 / mv1 (h8*w8, 2); list 1 only with has_l1 (uni
    callers pass slot1 = -1). CUDA stacks launch the kernel; CPU stacks,
    or reference=True, run `mc_planes_plain`."""
    if refs[0].device.type != "cuda" or reference:
        dev = refs[0].device
        return mc_planes_plain(*refs, slot0.to(dev), mv0.to(dev),
                               slot1.to(dev), mv1.to(dev), has_l1, h8, w8,
                               pic_w, pic_h)
    return mc_planes_cuda(refs, slot0, mv0, slot1, mv1, has_l1, h8, w8,
                          pic_w, pic_h)


def no_l1(slot0, mv0):
    """(slot1, mv1) of a uni-predicted picture: list 1 unused."""
    return torch.full_like(slot0, -1), torch.zeros_like(mv0)
