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
matrices or 8-bit limb splits.

Explicit weighted prediction (spec 8.5.3.3.4.3, `_combine` with weights
and `_cell_w`): per list a slot table (flag (R, 3), weight (R, 3),
offset (R, 3)) and log2Wd = denominator + 6 per component (`lwd`). A
cell whose slot carries the component's flag takes its weight and
offset, every other cell the spec's default weight 2^denominator and
offset 0, which gives the default combine exactly. Here the port differs
from the reference on purpose: `_cell_w` takes 64 for the default, right
only at denominator 6. The reference encoder writes 6 where it engages
weights, but a P slice of a weighted stream that engages none carries a
table with denominator 0, which the reference's fast-path decoder then
reconstructs wrong (its scalar walk, and the encoder, are right). One list: ((p * w + 2^(lwd - 1)) >> lwd) + o (p * w + o
at lwd 0); both: (p0 * w0 + p1 * w1 + ((o0 + o1 + 1) << lwd)) >>
(lwd + 1); then the clip to 8 bits. K13 and K15 search and decide on
the unweighted prediction, as the reference does.

CUDA: the same arithmetic as `__device__` functions in csrc/mc.cuh
(`ks_mc_sample`, `ks_mc_uni`, `ks_mc_bi`, `ks_mc_pred`, and for weighted
prediction `ks_mc_pred_wp`), inlined in K13 (csrc/me.cu) and K15
(csrc/inter_decide.cu); the whole-picture `mc_planes` launches
`ks_inter_mc` (csrc/inter_code.cu, one thread block per 8x8 cell; list 1
and the weights are template arguments, so P pictures without weights run
the uni code alone) for K17's coding pass and K18's decode.
"""

from __future__ import annotations

import ctypes

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
            use1: torch.Tensor, w0=None, w1=None) -> torch.Tensor:
    """Spec 8.5.4.2.5.2 default combine of 14-bit predictions to 8 bits,
    or with w0 / w1 (`cell_weights` of both lists) the explicit weighted
    combine of 8.5.3.3.4.3; use0/use1 (K, 1, 1) bool."""
    if w0 is None and w1 is None:
        bi = (p0 + p1 + 64) >> 7
        out = torch.where(use0 & use1, bi,
                          torch.where(use0, (p0 + 32) >> 6, (p1 + 32) >> 6))
        return out.clamp(0, 255)

    def uni(p, w):
        wg, off, lwd = w
        if lwd >= 1:
            return ((p * wg + (1 << (lwd - 1))) >> lwd) + off
        return p * wg + off

    (wa, oa, lwd), (wb, ob, _) = w0, w1
    bi = (p0 * wa + p1 * wb + ((oa + ob + 1) << lwd)) >> (lwd + 1)
    out = torch.where(use0 & use1, bi,
                      torch.where(use0, uni(p0, w0), uni(p1, w1)))
    return out.clamp(0, 255)


def wp_tables(hdr, ref_lists, slot_of, nslots):
    """The slice's explicit weighted-prediction tables per list in the
    form `cell_weights` reads (flag, weight, offset per slot and
    component, log2Wd per component), or (None, None) without weights.
    slot_of maps id(FrameState) of each reference to its slot in the
    stacks of nslots pictures; the decoder's fast path and the encoder's
    inter engine share it."""
    if hdr.weights is None:
        return None, None
    flag = np.zeros((2, nslots, 3), bool)
    wgt = np.full((2, nslots, 3), 64, np.int32)
    off = np.zeros((2, nslots, 3), np.int32)
    for l in range(2):
        wl = hdr.weights[l] if l < len(hdr.weights) else []
        for i, trip in enumerate(wl):
            if i >= len(ref_lists[l]):
                break
            s = slot_of[id(ref_lists[l][i].fs)]
            for c in range(3):
                flag[l, s, c] = bool(trip[c].flag)
                wgt[l, s, c] = trip[c].weight
                off[l, s, c] = trip[c].offset
    lwd = np.array([hdr.luma_log2_weight_denom + 6,
                    hdr.chroma_log2_weight_denom + 6,
                    hdr.chroma_log2_weight_denom + 6], np.int32)
    return ((flag[0], wgt[0], off[0], lwd), (flag[1], wgt[1], off[1], lwd))


def cell_weights(wts, slot: torch.Tensor, comp: int):
    """Per-cell (weight (K, 1, 1), offset (K, 1, 1), log2Wd) of component
    comp from one list's table wts = (flag (R, 3), weight (R, 3), offset
    (R, 3), log2Wd (3,)): the slot's weight and offset where its flag is
    set and the list is used (slot >= 0), else 2^(log2Wd - 6) and 0; None
    without a table."""
    if wts is None:
        return None
    flag, wgt, off, lwd = (torch.as_tensor(np.asarray(a), device=slot.device)
                           if not isinstance(a, torch.Tensor)
                           else a.to(slot.device) for a in wts)
    s = slot.clamp(min=0).long()
    f = flag[s, comp].bool() & (slot >= 0)
    lw = int(lwd[comp])
    w = torch.where(f, wgt[s, comp].to(torch.int32), 1 << (lw - 6))
    o = torch.where(f, off[s, comp].to(torch.int32), 0)
    return w[:, None, None], o[:, None, None], lw


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
                    has_l1: bool, h8: int, w8: int, pic_w: int, pic_h: int,
                    wts0=None, wts1=None):
    """Plain version of the reference's `_mc_core`. refs_* (R, H, W) /
    (R, H/2, W/2) integer stacks; slot* (h8*w8,) int (-1: list unused),
    mv* (h8*w8, 2) quarter-pel [x, y]; wts0 / wts1 each list's explicit
    weighted-prediction table (flag, weight, offset, log2Wd) or None (both
    or neither where has_l1). Returns (pred_y, pred_cb, pred_cr) uint8
    planes of the stacks' size."""
    dev = refs_y.device
    K = slot0.shape[0]
    r = torch.arange(K, device=dev) // w8
    c = torch.arange(K, device=dev) % w8
    use0 = (slot0 >= 0)[:, None, None]
    s0 = slot0.clamp(min=0)
    s1 = slot1.clamp(min=0)
    use1 = (slot1 >= 0)[:, None, None]
    outs = []
    for comp, (stack, t, luma) in enumerate(((refs_y, 8, True),
                                             (refs_cb, 4, False),
                                             (refs_cr, 4, False))):
        cw, chh = (pic_w, pic_h) if luma else (pic_w // 2, pic_h // 2)
        p0 = interp_cells(stack, s0, mv0[:, 0], mv0[:, 1], t, r * t, c * t,
                          luma, cw, chh)
        w0 = cell_weights(wts0, slot0, comp)
        if has_l1:
            p1 = interp_cells(stack, s1, mv1[:, 0], mv1[:, 1], t, r * t,
                              c * t, luma, cw, chh)
            blk = combine(p0, p1, use0, use1, w0,
                          cell_weights(wts1, slot1, comp))
        else:
            blk = combine(p0, p0, use0, torch.zeros_like(use0), w0, w0)
        outs.append(untile(blk.to(torch.uint8), stack.shape[1] // t,
                           stack.shape[2] // t))
    return tuple(outs)


def wp_table(wts0, wts1, R: int, device) -> torch.Tensor:
    """The kernel's weight table: int32 (2, R, 3, 3) of (flag, weight,
    offset) per list, slot and component, then the 3 log2Wd values; an
    absent list's table is the identity."""
    tab = np.zeros((2, R, 3, 3), np.int32)
    tab[..., 1] = 64
    lwd = None
    for l, w in enumerate((wts0, wts1)):
        if w is None:
            continue
        flag, wgt, off, lw = (np.asarray(a.cpu() if isinstance(a, torch.Tensor)
                                         else a) for a in w)
        tab[l, :, :, 0] = flag.astype(np.int32)
        tab[l, :, :, 1] = wgt
        tab[l, :, :, 2] = off
        lwd = lw
    flat = np.concatenate([tab.reshape(-1),
                           np.asarray(lwd, np.int32).reshape(-1)])
    return torch.from_numpy(flat).to(device)


def mc_planes_cuda(refs, slot0, mv0, slot1, mv1, has_l1: bool, h8: int,
                   w8: int, pic_w: int, pic_h: int, wts0=None, wts1=None):
    """K14 on the card: the predicted planes of the (h8, w8) cell grid from
    per-cell motion (`mc_planes_plain`), one launch of `ks_inter_mc`; list
    1 (slot1, mv1) is read only with has_l1, the weight tables (`wp_table`)
    only where wts0 or wts1 is given."""
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
    weighted = wts0 is not None or wts1 is not None
    P = _build.ptr
    # the unweighted instantiations never read the table: a null pointer
    wp = wp_table(wts0, wts1, R, dev) if weighted else None
    _build.check(_build.kernels().ks_inter_mc(
        P(refs[0]), P(refs[1]), P(refs[2]), P(slot0), P(mv0), P(slot1),
        P(mv1), P(pred[0]), P(pred[1]), P(pred[2]),
        ctypes.c_void_p() if wp is None else P(wp), h8, w8, H, W,
        pic_w, pic_h, int(has_l1), int(weighted), R, _build.stream(dev)),
        "ks_inter_mc")
    _build.count(("inter_mc_bi" if has_l1 else "inter_mc")
                 + ("_wp" if weighted else ""))
    return pred


def mc_planes(refs, slot0, mv0, slot1, mv1, has_l1: bool, h8: int, w8: int,
              pic_w: int, pic_h: int, reference: bool = False, wts0=None,
              wts1=None):
    """Predicted (y, cb, cr) uint8 planes of the cell grid from per-cell
    motion: refs (R, H, W) uint8 stacks, slot0 / slot1 (h8*w8,) (-1: the
    list is unused), mv0 / mv1 (h8*w8, 2); list 1 only with has_l1 (uni
    callers pass slot1 = -1); wts0 / wts1 the lists' explicit weighted
    prediction tables (`cell_weights`) or None. CUDA stacks launch the
    kernel; CPU stacks, or reference=True, run `mc_planes_plain`."""
    if refs[0].device.type != "cuda" or reference:
        dev = refs[0].device
        return mc_planes_plain(*refs, slot0.to(dev), mv0.to(dev),
                               slot1.to(dev), mv1.to(dev), has_l1, h8, w8,
                               pic_w, pic_h, wts0, wts1)
    return mc_planes_cuda(refs, slot0, mv0, slot1, mv1, has_l1, h8, w8,
                          pic_w, pic_h, wts0, wts1)


def no_l1(slot0, mv0):
    """(slot1, mv1) of a uni-predicted picture: list 1 unused."""
    return torch.full_like(slot0, -1), torch.zeros_like(mv0)
