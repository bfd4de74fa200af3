"""Inter prediction: motion-vector derivation (merge/AMVP/TMVP, spec 8.5.3)
and motion compensation (8-tap luma / 4-tap chroma interpolation, weighted
combine, spec 8.5.4) — NumPy bit-exact model.

This is the scalar oracle for the batched Pallas MC kernels in ops/, and the
decoder's reference path. Reference equivalents: ComInterPrediction /
ComInterpolation (interpLumaHor8to16_c family), CDecCu::{getMergeCandsForB,
getMvpForB,getTMVP,motionCompensation}, DefaultWeightedBi_c /
ExplicitWeightedBi_c (SURVEY.md 2.2/2.4).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..hevc.tables import CHROMA_FILTER as CHROMA_FILTERS
from ..hevc.tables import LUMA_FILTER as LUMA_FILTERS


# ------------------------------------------------------------ interpolation

def _gather_patch(plane: np.ndarray, x0: int, y0: int, w: int, h: int,
                  pad_l: int, pad_r: int, pic_w: int, pic_h: int) -> np.ndarray:
    """Edge-clamped patch of (h + pad_l + pad_r, w + pad_l + pad_r)."""
    rows = np.clip(np.arange(y0 - pad_l, y0 + h + pad_r), 0, pic_h - 1)
    cols = np.clip(np.arange(x0 - pad_l, x0 + w + pad_r), 0, pic_w - 1)
    return plane[np.ix_(rows, cols)].astype(np.int32)


def _filt_h(patch: np.ndarray, coeffs: np.ndarray, w: int) -> np.ndarray:
    """Horizontal FIR over the last axis; output width w."""
    ntap = len(coeffs)
    out = np.zeros((patch.shape[0], w), np.int32)
    for k in range(ntap):
        c = int(coeffs[k])
        if c:
            out += c * patch[:, k:k + w]
    return out


def _filt_v(patch: np.ndarray, coeffs: np.ndarray, h: int) -> np.ndarray:
    ntap = len(coeffs)
    out = np.zeros((h, patch.shape[1]), np.int32)
    for k in range(ntap):
        c = int(coeffs[k])
        if c:
            out += c * patch[k:k + h, :]
    return out


def interp_luma(plane: np.ndarray, x0: int, y0: int, w: int, h: int,
                mvx: int, mvy: int, pic_w: int, pic_h: int) -> np.ndarray:
    """14-bit intermediate luma prediction (spec 8.5.4.2.2.1, 8-bit input)."""
    ix, iy = x0 + (mvx >> 2), y0 + (mvy >> 2)
    fx, fy = mvx & 3, mvy & 3
    if fx == 0 and fy == 0:
        return _gather_patch(plane, ix, iy, w, h, 0, 0, pic_w, pic_h) << 6
    if fy == 0:
        patch = _gather_patch(plane, ix, iy, w, h, 3, 4, pic_w, pic_h)
        return _filt_h(patch[3:3 + h, :], LUMA_FILTERS[fx], w)
    if fx == 0:
        patch = _gather_patch(plane, ix, iy, w, h, 3, 4, pic_w, pic_h)
        return _filt_v(patch[:, 3:3 + w], LUMA_FILTERS[fy], h)
    patch = _gather_patch(plane, ix, iy, w, h, 3, 4, pic_w, pic_h)
    tmp = _filt_h(patch, LUMA_FILTERS[fx], w)          # (h+7, w), 14-bit+
    return _filt_v(tmp, LUMA_FILTERS[fy], h) >> 6


def interp_chroma(plane: np.ndarray, x0: int, y0: int, w: int, h: int,
                  mvx: int, mvy: int, pic_w: int, pic_h: int) -> np.ndarray:
    """14-bit intermediate chroma prediction; mv in 1/8-pel chroma units."""
    ix, iy = x0 + (mvx >> 3), y0 + (mvy >> 3)
    fx, fy = mvx & 7, mvy & 7
    if fx == 0 and fy == 0:
        return _gather_patch(plane, ix, iy, w, h, 0, 0, pic_w, pic_h) << 6
    if fy == 0:
        patch = _gather_patch(plane, ix, iy, w, h, 1, 2, pic_w, pic_h)
        return _filt_h(patch[1:1 + h, :], CHROMA_FILTERS[fx], w)
    if fx == 0:
        patch = _gather_patch(plane, ix, iy, w, h, 1, 2, pic_w, pic_h)
        return _filt_v(patch[:, 1:1 + w], CHROMA_FILTERS[fy], h)
    patch = _gather_patch(plane, ix, iy, w, h, 1, 2, pic_w, pic_h)
    tmp = _filt_h(patch, CHROMA_FILTERS[fx], w)
    return _filt_v(tmp, CHROMA_FILTERS[fy], h) >> 6


# ---------------------------------------------------------------- combine

def combine_uni(pred: np.ndarray, weight=None, bd: int = 8) -> np.ndarray:
    """Spec 8.5.4.2.5.2 default / .3 explicit uni-weighted sample combine."""
    maxv = (1 << bd) - 1
    if weight is None:
        return np.clip((pred + 32) >> 6, 0, maxv)
    w, o, log2wd = weight
    if log2wd >= 1:
        v = ((pred * w + (1 << (log2wd - 1))) >> log2wd) + o
    else:
        v = pred * w + o
    return np.clip(v, 0, maxv)


def combine_bi(p0: np.ndarray, p1: np.ndarray, w0=None, w1=None,
               bd: int = 8) -> np.ndarray:
    """Spec 8.5.4.2.5.2 default / .3 explicit bi-weighted sample combine."""
    maxv = (1 << bd) - 1
    if w0 is None:
        return np.clip((p0 + p1 + 64) >> 7, 0, maxv)
    (wa, oa, log2wd) = w0
    (wb, ob, _) = w1
    v = ((p0 * wa + p1 * wb + ((oa + ob + 1) << log2wd)) >> (log2wd + 1))
    return np.clip(v, 0, maxv)


# ---------------------------------------------------------- motion structs

@dataclass
class MotionInfo:
    """Per-PU motion: pred flags via ref_idx >= 0."""
    mv: list = field(default_factory=lambda: [[0, 0], [0, 0]])
    ref_idx: list = field(default_factory=lambda: [-1, -1])

    def copy(self) -> "MotionInfo":
        return MotionInfo([list(self.mv[0]), list(self.mv[1])],
                          list(self.ref_idx))

    def same_motion(self, o: "MotionInfo") -> bool:
        return self.mv == o.mv and self.ref_idx == o.ref_idx


def mv_scale(mv: tuple[int, int], cur_diff: int, col_diff: int) -> list[int]:
    """Temporal MV scaling (spec 8.5.3.2.8 eq. 8-169..172)."""
    td = min(127, max(-128, col_diff))
    tb = min(127, max(-128, cur_diff))
    if td == 0:
        return [mv[0], mv[1]]
    tx = (16384 + (abs(td) >> 1)) // td
    ds = min(4095, max(-4096, (tb * tx + 32) >> 6))
    out = []
    for c in mv:
        v = ds * c
        v = (abs(v) + 127) >> 8
        v = -v if ds * c < 0 else v
        out.append(min(32767, max(-32768, v)))
    return out


class MotionDeriver:
    """Merge + AMVP candidate derivation against the FrameState grids.

    Mirrors CDecCu::{getMergeCandsForB,getMvpForB,getTMVP} (SURVEY.md 2.4)
    re-expressed over dense per-4x4 tensor fields.
    """

    def __init__(self, fs, sps, pps, hdr, ref_lists, slice_idx: int):
        self.fs = fs
        self.sps = sps
        self.pps = pps
        self.hdr = hdr
        self.ref_lists = ref_lists           # [l0, l1] of RefPic
        self.slice_idx = slice_idx
        self.poc = hdr.poc
        # NoBackwardPredFlag: every ref in both lists has POC <= current POC
        self.no_backward = all(rp.poc <= self.poc
                               for lst in ref_lists for rp in lst)
        self.col_pic = None
        if hdr.temporal_mvp_enabled:
            lst = 0 if hdr.collocated_from_l0 else 1
            if hdr.collocated_ref_idx < len(ref_lists[lst]):
                self.col_pic = ref_lists[lst][hdr.collocated_ref_idx]

    # ------------------------------------------------------- availability
    def _avail(self, x: int, y: int) -> bool:
        """Prediction-block availability (spec 6.4.2 with checkPredModeY):
        in picture, decoded, same slice, and inter-coded."""
        if x < 0 or y < 0 or x >= self.sps.width or y >= self.sps.height:
            return False
        x4, y4 = x >> 2, y >> 2
        fs = self.fs
        return (bool(fs.mi_parsed[y4, x4])
                and fs.slice_id[y4, x4] == self.slice_idx
                and fs.pred_mode[y4, x4] == 0)      # MODE_INTER

    def _motion_at(self, x: int, y: int) -> MotionInfo | None:
        """Motion of the 4x4 covering (x,y); None if intra/unavailable."""
        fs = self.fs
        x4, y4 = x >> 2, y >> 2
        if fs.pred_mode[y4, x4] != 0:        # MODE_INTER == 0
            return None
        mi = MotionInfo()
        for l in range(2):
            ri = int(fs.ref_idx[l, y4, x4])
            mi.ref_idx[l] = ri
            if ri >= 0:
                mi.mv[l] = [int(fs.mv[l, y4, x4, 0]), int(fs.mv[l, y4, x4, 1])]
        return mi

    # ------------------------------------------------------------- merge
    def merge_candidates(self, xc, yc, ncs, xp, yp, nw, nh, part_idx,
                         part_mode) -> list[MotionInfo]:
        """Spec 8.5.3.2.1: full merge candidate list (length = max cands)."""
        plevel = self.pps.log2_parallel_merge_level
        if plevel > 2 and ncs == 8:
            # singleMCLFlag: derive as if 2Nx2N at the CU
            xp, yp, nw, nh, part_idx = xc, yc, ncs, ncs, 0
            single = True
        else:
            single = False
        is_b = len(self.ref_lists[1]) > 0 and self.hdr.slice_type == 0

        def same_mer(xn, yn):
            return (xp >> plevel == xn >> plevel and
                    yp >> plevel == yn >> plevel)

        def spatial(xn, yn) -> MotionInfo | None:
            if not self._avail(xn, yn) or same_mer(xn, yn):
                return None
            return self._motion_at(xn, yn)

        pm = part_mode if not single else 0
        # raw candidates: None when unavailable / intra / MER / part-excluded
        a1 = b1 = None
        if not (part_idx == 1 and pm in (2, 6, 7)):   # Nx2N, nLx2N, nRx2N
            a1 = spatial(xp - 1, yp + nh - 1)
        if not (part_idx == 1 and pm in (1, 4, 5)):   # 2NxN, 2NxnU, 2NxnD
            b1 = spatial(xp + nw - 1, yp - 1)
        b0 = spatial(xp + nw, yp - 1)
        a0 = spatial(xp - 1, yp + nh)
        cands: list[MotionInfo] = []
        if a1 is not None:
            cands.append(a1)
        if b1 is not None and (a1 is None or not b1.same_motion(a1)):
            cands.append(b1)
        if b0 is not None and (b1 is None or not b0.same_motion(b1)):
            cands.append(b0)
        if a0 is not None and (a1 is None or not a0.same_motion(a1)):
            cands.append(a0)
        if len(cands) < 4:
            b2 = spatial(xp - 1, yp - 1)
            if b2 is not None and \
                    (a1 is None or not b2.same_motion(a1)) and \
                    (b1 is None or not b2.same_motion(b1)):
                cands.append(b2)
        # TMVP
        max_cands = self.hdr.max_num_merge_cand
        if len(cands) < max_cands and self.hdr.temporal_mvp_enabled \
                and self.col_pic is not None:
            tm = MotionInfo()
            ok = False
            mv0 = self.tmvp(xp, yp, nw, nh, 0, 0)
            if mv0 is not None:
                tm.mv[0] = mv0
                tm.ref_idx[0] = 0
                ok = True
            if is_b:
                mv1 = self.tmvp(xp, yp, nw, nh, 1, 0)
                if mv1 is not None:
                    tm.mv[1] = mv1
                    tm.ref_idx[1] = 0
                    ok = True
            if ok:
                cands.append(tm)
        # combined bi-predictive (B only)
        if is_b and len(cands) > 1 and len(cands) < max_cands:
            l0i = (0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3)
            l1i = (1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2)
            norig = len(cands)
            for k in range(norig * (norig - 1)):
                if len(cands) >= max_cands:
                    break
                ci, cj = cands[l0i[k]], cands[l1i[k]]
                if ci.ref_idx[0] >= 0 and cj.ref_idx[1] >= 0:
                    p0 = self.ref_lists[0][ci.ref_idx[0]].poc
                    p1 = self.ref_lists[1][cj.ref_idx[1]].poc
                    if p0 != p1 or ci.mv[0] != cj.mv[1]:
                        comb = MotionInfo()
                        comb.mv[0] = list(ci.mv[0])
                        comb.ref_idx[0] = ci.ref_idx[0]
                        comb.mv[1] = list(cj.mv[1])
                        comb.ref_idx[1] = cj.ref_idx[1]
                        cands.append(comb)
        # zero candidates
        nref = (min(len(self.ref_lists[0]), len(self.ref_lists[1]))
                if is_b else len(self.ref_lists[0]))
        zi = 0
        while len(cands) < max_cands:
            z = MotionInfo()
            ridx = zi if zi < nref else 0
            z.ref_idx[0] = ridx
            if is_b:
                z.ref_idx[1] = ridx
            cands.append(z)
            zi += 1
        if nw + nh == 12:
            # 8x4/4x8 PUs must not be bi-predicted (spec 8.5.3.2.1):
            # convert bi candidates to uni L0
            for c in cands:
                if c.ref_idx[0] >= 0 and c.ref_idx[1] >= 0:
                    c.ref_idx[1] = -1
                    c.mv[1] = [0, 0]
        return cands

    # -------------------------------------------------------------- TMVP
    def tmvp(self, xp, yp, nw, nh, lst: int, ref_idx: int) -> list[int] | None:
        """Temporal MV predictor (spec 8.5.3.2.8); returns scaled mv or None."""
        col = self.col_pic
        if col is None or ref_idx >= len(self.ref_lists[lst]):
            return None
        ctb_log2 = self.sps.log2_ctb
        # bottom-right, then center
        for (cx, cy) in (((xp + nw), (yp + nh)),
                         (xp + (nw >> 1), yp + (nh >> 1))):
            if (cx, cy) == (xp + nw, yp + nh):
                if (yp >> ctb_log2) != (cy >> ctb_log2):
                    continue
                if cx >= self.sps.width or cy >= self.sps.height:
                    continue
            xr, yr = (cx >> 4) << 4, (cy >> 4) << 4
            mv = self._col_mv(col, xr, yr, lst, ref_idx)
            if mv is not None:
                return mv
        return None

    def _col_mv(self, col, x, y, lst, ref_idx) -> list[int] | None:
        """Collocated MV selection + scaling (spec 8.5.3.2.9)."""
        cfs = col.fs
        x4, y4 = x >> 2, y >> 2
        if x4 >= cfs.w4 or y4 >= cfs.h4:
            return None
        if cfs.pred_mode[y4, x4] != 0:
            return None
        r0 = int(cfs.ref_idx[0, y4, x4])
        r1 = int(cfs.ref_idx[1, y4, x4])
        if r0 < 0 and r1 < 0:
            return None
        if r0 < 0:
            use = 1
        elif r1 < 0:
            use = 0
        elif self.no_backward:
            use = lst
        else:
            # spec 8.5.3.2.9: listCol = LN with N = collocated_from_l0_flag
            use = 1 if self.hdr.collocated_from_l0 else 0
        mv_col = (int(cfs.mv[use, y4, x4, 0]), int(cfs.mv[use, y4, x4, 1]))
        col_ref_poc = int(cfs.ref_poc[use, y4, x4])
        col_lt = bool(cfs.ref_lt[use, y4, x4])
        target = self.ref_lists[lst][ref_idx]
        if col_lt != target.is_long_term:
            return None
        col_diff = col.poc - col_ref_poc
        cur_diff = self.poc - target.poc
        if col_lt or col_diff == cur_diff:
            return [mv_col[0], mv_col[1]]
        return mv_scale(mv_col, cur_diff, col_diff)

    # -------------------------------------------------------------- AMVP
    def amvp_candidates(self, xc, yc, ncs, xp, yp, nw, nh, part_idx,
                        lst: int, ref_idx: int) -> list[list[int]]:
        """Spec 8.5.3.2.6: the two motion vector predictor candidates."""
        target = self.ref_lists[lst][ref_idx]

        def check(xn, yn, scaled: bool) -> list[int] | None:
            if not self._avail(xn, yn):
                return None
            mi = self._motion_at(xn, yn)
            if mi is None:
                return None
            for ll in (lst, 1 - lst):
                ri = mi.ref_idx[ll]
                if ri < 0 or ri >= len(self.ref_lists[ll]):
                    continue
                rp = self.ref_lists[ll][ri]
                if not scaled:
                    if rp.poc == target.poc and rp.is_long_term == target.is_long_term:
                        return list(mi.mv[ll])
                else:
                    if rp.is_long_term != target.is_long_term:
                        continue
                    if rp.is_long_term:
                        return list(mi.mv[ll])
                    return mv_scale(mi.mv[ll], self.poc - target.poc,
                                    self.poc - rp.poc)
            return None

        a0 = (xp - 1, yp + nh)
        a1 = (xp - 1, yp + nh - 1)
        b0 = (xp + nw, yp - 1)
        b1 = (xp + nw - 1, yp - 1)
        b2 = (xp - 1, yp - 1)
        is_scaled = self._avail(*a0) or self._avail(*a1)
        # candidate A
        mv_a = None
        for pos in (a0, a1):
            mv_a = check(*pos, scaled=False)
            if mv_a is not None:
                break
        if mv_a is None:
            for pos in (a0, a1):
                mv_a = check(*pos, scaled=True)
                if mv_a is not None:
                    break
        # candidate B (unscaled pass)
        mv_b = None
        for pos in (b0, b1, b2):
            mv_b = check(*pos, scaled=False)
            if mv_b is not None:
                break
        if not is_scaled:
            # A0/A1 both unavailable: A takes the unscaled-B value and B is
            # re-derived from scratch allowing scaling (spec 8.5.3.2.6 / HM
            # fillMvpCand's xAddMVPCandOrder pass over B0,B1,B2)
            mv_a = mv_b
            mv_b = None
            for pos in (b0, b1, b2):
                mv_b = check(*pos, scaled=True)
                if mv_b is not None:
                    break
        cands = []
        if mv_a is not None:
            cands.append(mv_a)
        if mv_b is not None and (mv_a is None or mv_b != mv_a):
            cands.append(mv_b)
        if len(cands) < 2 and self.hdr.temporal_mvp_enabled \
                and self.col_pic is not None:
            tmv = self.tmvp(xp, yp, nw, nh, lst, ref_idx)
            if tmv is not None:
                cands.append(tmv)
        while len(cands) < 2:
            cands.append([0, 0])
        return cands[:2]


# ------------------------------------------------------- motion compensation

def motion_compensate(fs, hdr, ref_lists, xp, yp, nw, nh, mi: MotionInfo,
                      bd: int = 8) -> None:
    """Predict one PU into fs planes (luma + chroma), spec 8.5.4."""
    sps = fs.sps
    pw, ph = sps.width, sps.height
    use0 = mi.ref_idx[0] >= 0
    use1 = mi.ref_idx[1] >= 0
    wp = hdr.weights is not None

    def weights(lst, ridx, comp):
        if not wp or lst >= len(hdr.weights) or ridx >= len(hdr.weights[lst]):
            return None
        w = hdr.weights[lst][ridx][comp]
        denom = (hdr.luma_log2_weight_denom if comp == 0
                 else hdr.chroma_log2_weight_denom)
        # log2Wd = denom + shift1, shift1 = 14 - bitDepth (8.5.4.2.3):
        # predictions are 14-bit here, so the combine must also remove the
        # interpolation headroom, not just the weight denominator
        return (w.weight, w.offset, denom + (14 - bd))

    # explicit WP applies when any flag set for this PU's refs; HEVC applies
    # the weighted formula whenever the pred-weight table is present.
    planes = ((fs.y, pw, ph, 0), (fs.cb, pw >> 1, ph >> 1, 1),
              (fs.cr, pw >> 1, ph >> 1, 2))
    for dst, cw, chh, comp in planes:
        if comp == 0:
            x0, y0, w, h = xp, yp, nw, nh
        else:
            x0, y0, w, h = xp >> 1, yp >> 1, nw >> 1, nh >> 1
        preds = []
        wts = []
        for lst in (0, 1):
            if not (use0 if lst == 0 else use1):
                continue
            rp = ref_lists[lst][mi.ref_idx[lst]]
            if getattr(rp.fs, "_planes_stale", False):
                rp.fs.ensure_planes()
            src = (rp.fs.y, rp.fs.cb, rp.fs.cr)[comp]
            mvx, mvy = mi.mv[lst]
            if comp == 0:
                preds.append(interp_luma(src, x0, y0, w, h, mvx, mvy, cw, chh))
            else:
                preds.append(interp_chroma(src, x0, y0, w, h, mvx, mvy, cw, chh))
            wts.append(weights(lst, mi.ref_idx[lst], comp))
        if len(preds) == 2:
            if wp:
                blk = combine_bi(preds[0], preds[1], wts[0], wts[1], bd)
            else:
                blk = combine_bi(preds[0], preds[1], bd=bd)
        else:
            blk = combine_uni(preds[0], wts[0] if wp else None, bd)
        dst[y0:y0 + h, x0:x0 + w] = blk
