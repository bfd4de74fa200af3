"""SAO encoder: per-CTU statistics, offset derivation and RD decision.

Reference equivalents: CEncSao::{modeDecisionCtu, statBoEo01,
EoTypeDistEstimation, BoTypeDistEstimation, estIterOffset} (SURVEY.md 2.3
"In-loop filters"). Operates on the deblocked reconstruction vs the source;
classification is bit-identical to the decoder's apply (decode/filters.py
sao_frame), so encode-side estimates are exact distortions.

Slice coding is two-pass: pass 1 produces the reconstruction, SAO
parameters are decided frame-wide here, pass 2 re-codes the (identical,
deterministic) CTU decisions with the real sao() syntax interleaved.
"""

from __future__ import annotations

import numpy as np

from ..decode.slice_dec import SaoCtuParam

_EO_OFFS = {
    0: ((0, -1), (0, 1)),
    1: ((-1, 0), (1, 0)),
    2: ((-1, -1), (1, 1)),
    3: ((-1, 1), (1, -1)),
}


def _edge_categories(rec: np.ndarray, x0, y0, x1, y1, eo_class, bw, bh):
    """Edge index (0..4, 2=neutral) per pixel of the block, with picture-
    boundary validity — mirrors decode/filters.py sao_frame exactly."""
    (ay, ax), (by2, bx2) = _EO_OFFS[eo_class]
    ys, xs = np.mgrid[y0:y1, x0:x1]
    ny_a, nx_a = ys + ay, xs + ax
    ny_b, nx_b = ys + by2, xs + bx2
    valid = ((ny_a >= 0) & (ny_a < bh) & (nx_a >= 0) & (nx_a < bw)
             & (ny_b >= 0) & (ny_b < bh) & (nx_b >= 0) & (nx_b < bw))
    blk = rec[y0:y1, x0:x1]
    a = rec[np.clip(ny_a, 0, bh - 1), np.clip(nx_a, 0, bw - 1)]
    b = rec[np.clip(ny_b, 0, bh - 1), np.clip(nx_b, 0, bw - 1)]
    edge_idx = 2 + np.sign(blk - a) + np.sign(blk - b)
    return edge_idx, valid


def _best_offset(cnt: int, errsum: float, lo: int, hi: int,
                 lam: float) -> tuple[int, float]:
    """Offset in [lo,hi] minimizing N*h^2 - 2*h*E + lam*rate(|h|)."""
    if cnt == 0:
        return 0, 0.0
    best_h, best_c = 0, 0.0
    start = int(np.clip(round(errsum / cnt), lo, hi))
    # scan toward zero from the unconstrained optimum (estIterOffset style)
    step = -1 if start > 0 else 1
    h = start
    while True:
        cost = cnt * h * h - 2.0 * h * errsum + lam * (abs(h) + 1)
        if cost < best_c:
            best_c, best_h = cost, h
        if h == 0:
            break
        h += step
    return best_h, best_c


def decide_sao(fs, src_y, src_cb, src_cr, qp: int, tier: int):
    """Fill fs.sao with per-CTU decisions. tier: cfg.sao ladder value
    (1 = superfast: luma EO only; >=3: + BO + chroma).

    Production path: per-CTU count/error sums from the batched device pass
    (ops/saostats) + tiny host offset search. Fallback: the all-host loop
    (decide_sao_host), bit-identical because the sums are exact integers."""
    import os
    if not os.environ.get("KS265_SEQ_COMPUTE"):
        try:
            from ..ops.saostats import sao_frame_stats
            stats = sao_frame_stats(fs, src_y, src_cb, src_cr)
            return _decide_from_stats(fs, stats, qp, tier)
        except Exception as ex:
            from ..utils.log import log
            log(2, "device sao stats failed (%s: %s); host fallback"
                % (type(ex).__name__, ex))
    return decide_sao_host(fs, src_y, src_cb, src_cr, qp, tier)


def _best_offsets_vec(cnt, err, lo: int, hi: int, lam: float):
    """Vectorized _best_offset over arbitrary-shaped cnt/err arrays.
    Reproduces the scalar scan exactly: candidates between 0 and the
    clipped rounded optimum, strict-< (first-visited = larger |h| wins
    ties, the 0-baseline wins its ties). Returns (h, cost) arrays."""
    cnt = cnt.astype(np.float64)
    err = err.astype(np.float64)
    start = np.clip(np.round(np.divide(err, np.maximum(cnt, 1))), lo, hi)
    hs = np.arange(-7, 8, dtype=np.float64)
    shp = (1,) * cnt.ndim
    hs_b = hs.reshape(hs.shape + shp)
    cost = (cnt[None] * hs_b * hs_b - 2.0 * hs_b * err[None]
            + lam * (np.abs(hs_b) + 1.0))
    valid = ((hs_b != 0) & (np.abs(hs_b) <= np.abs(start[None]))
             & (np.sign(hs_b) == np.sign(start[None]))
             & (hs_b >= lo) & (hs_b <= hi) & (cnt[None] > 0))
    eps = 1e-9
    adj = np.where(valid, cost - eps * np.abs(hs_b), np.inf)
    # the 0-baseline carries cost 0.0 and wins ties against any h
    base = np.full(cnt.shape, -eps * 8.0)
    all_adj = np.concatenate([adj, base[None]], axis=0)
    all_h = np.concatenate([np.broadcast_to(hs_b, adj.shape),
                            np.zeros((1,) + cnt.shape)], axis=0)
    all_cost = np.concatenate([cost, np.zeros((1,) + cnt.shape)], axis=0)
    k = np.argmin(all_adj, axis=0)
    h = np.take_along_axis(all_h, k[None], axis=0)[0]
    c = np.take_along_axis(all_cost, k[None], axis=0)[0]
    c = np.where(h == 0, 0.0, c)
    return h.astype(np.int64), c


def decide_from_stats_arrays(stats, qp: int, tier: int):
    """Vectorized offset search + type decision from per-CTU stats —
    semantics identical to the scalar _decide_from_stats (property-tested)
    but whole-grid. Returns (type_, offs, bpos, eocl) arrays shaped
    (3, ncty, nctx[, 4])."""
    lam = 0.85 * 2.0 ** ((qp - 12) / 3.0)
    ncty, nctx = stats[0][0].shape[2:]
    type_ = np.zeros((3, ncty, nctx), np.int8)
    offs = np.zeros((3, ncty, nctx, 4), np.int8)
    bpos = np.zeros((3, ncty, nctx), np.int8)
    eocl = np.zeros((3, ncty, nctx), np.int8)
    eps2 = 1e-9
    cats = (0, 1, 3, 4)
    bounds = ((0, 7), (0, 7), (-7, 0), (-7, 0))
    for c in range(3):
        if c > 0 and tier < 3:
            continue
        eo_cnt, eo_err, bo_cnt, bo_err = stats[c]
        best_cost = np.zeros((ncty, nctx))
        # --- EO classes
        eo_classes = (0, 1) if tier <= 1 else (0, 1, 2, 3)
        eo_h = np.zeros((4, 4, ncty, nctx), np.int64)   # (class, cat)
        eo_cost = np.full((4, ncty, nctx), np.inf)
        for eo in eo_classes:
            cost = np.full((ncty, nctx), lam * 3.0)
            for k, cat in enumerate(cats):
                lo, hi = bounds[k]
                h, cst = _best_offsets_vec(eo_cnt[eo, cat], eo_err[eo, cat],
                                           lo, hi, lam)
                eo_h[eo, k] = h
                cost = cost + cst
            eo_cost[eo] = cost
        if c == 2:
            # chroma shares the Cb decision's type/class
            sel_t1 = type_[1]
            sel_e1 = eocl[1]
            adj = np.where(sel_t1[None] == 2,
                           np.where(np.arange(4)[:, None, None]
                                    == sel_e1[None], eo_cost, np.inf),
                           np.inf)
        else:
            adj = eo_cost - eps2 * (4.0 - np.arange(4))[:, None, None]
        bcls = np.argmin(adj, axis=0)
        bcost = np.take_along_axis(adj, bcls[None], axis=0)[0]
        use_eo = bcost < best_cost
        best_cost = np.where(use_eo, np.take_along_axis(
            eo_cost, bcls[None], axis=0)[0], best_cost)
        type_[c] = np.where(use_eo, 2, type_[c])
        eocl[c] = np.where(use_eo, bcls, eocl[c])
        for k in range(4):
            sel_h = np.take_along_axis(
                eo_h[:, k], bcls[None], axis=0)[0]
            offs[c, :, :, k] = np.where(use_eo, sel_h, offs[c, :, :, k])
        # --- BO
        do_bo = (tier >= 3 and c != 2)
        bo_allowed = None
        if c == 2 and tier >= 3:
            do_bo = True
            bo_allowed = type_[1] == 1
        if do_bo:
            bh, bc = _best_offsets_vec(bo_cnt, bo_err, -7, 7, lam)  # (32,..)
            wc = np.stack([bc[b:b + 4].sum(axis=0) for b in range(29)])
            wpos = np.argmin(wc, axis=0)
            wcost = np.take_along_axis(wc, wpos[None], axis=0)[0] + lam * 8
            use_bo = wcost < best_cost
            if bo_allowed is not None:
                use_bo &= bo_allowed
            type_[c] = np.where(use_bo, 1, type_[c])
            bpos[c] = np.where(use_bo, wpos, bpos[c])
            eocl[c] = np.where(use_bo, 0, eocl[c])
            for k in range(4):
                hk = np.take_along_axis(bh, (wpos + k)[None],
                                        axis=0)[0]
                offs[c, :, :, k] = np.where(use_bo, hk, offs[c, :, :, k])
        if c == 1:
            # Cr inherits Cb's type/class; its own pass may refine offsets
            type_[2] = type_[1]
            eocl[2] = eocl[1]
    return type_, offs, bpos, eocl


def params_from_arrays(fs, type_, offs, bpos, eocl):
    """Build the per-CTU SaoCtuParam grid from decision arrays."""
    sps = fs.sps
    for ry in range(sps.pic_height_in_ctbs):
        for rx in range(sps.pic_width_in_ctbs):
            p = SaoCtuParam()
            for c in range(3):
                p.type_idx[c] = int(type_[c, ry, rx])
                p.offsets[c] = [int(v) for v in offs[c, ry, rx]]
                p.band_pos[c] = int(bpos[c, ry, rx])
                p.eo_class[c] = int(eocl[c, ry, rx])
            fs.sao[ry][rx] = p
    return fs.sao


def _decide_from_stats(fs, stats, qp: int, tier: int):
    """Offset search + type decision from per-CTU stats (vectorized; the
    scalar mirror below is the property-test oracle)."""
    return params_from_arrays(fs, *decide_from_stats_arrays(stats, qp,
                                                            tier))


def _decide_from_stats_ref(fs, stats, qp: int, tier: int):
    """Scalar oracle, mirroring decide_sao_host's control flow exactly
    (same costs, same tie-breaks)."""
    sps = fs.sps
    lam = 0.85 * 2.0 ** ((qp - 12) / 3.0)
    for ry in range(sps.pic_height_in_ctbs):
        for rx in range(sps.pic_width_in_ctbs):
            param = SaoCtuParam()
            for c in range(3):
                if c > 0 and tier < 3:
                    continue
                if c == 2 and param.type_idx[1] == 0:
                    continue
                eo_cnt, eo_err, bo_cnt, bo_err = stats[c]
                best = (0.0, 0, None, 0, 0)
                eo_classes = (0, 1) if tier <= 1 else (0, 1, 2, 3)
                if c == 2:
                    eo_classes = (param.eo_class[1],) \
                        if param.type_idx[1] == 2 else ()
                for eo in eo_classes:
                    cost = lam * 3
                    offs = []
                    for cat, (lo, hi) in zip((0, 1, 3, 4),
                                             ((0, 7), (0, 7), (-7, 0),
                                              (-7, 0))):
                        h, cst = _best_offset(
                            int(eo_cnt[eo, cat, ry, rx]),
                            float(eo_err[eo, cat, ry, rx]), lo, hi, lam)
                        offs.append(h)
                        cost += cst
                    if cost < best[0]:
                        best = (cost, 2, offs, 0, eo)
                if tier >= 3 and c != 2 or (c == 2 and param.type_idx[1] == 1):
                    bh_ = np.zeros(32, np.int64)
                    bc_ = np.zeros(32)
                    for b in range(32):
                        bh_[b], bc_[b] = _best_offset(
                            int(bo_cnt[b, ry, rx]),
                            float(bo_err[b, ry, rx]), -7, 7, lam)
                    wcosts = np.array([bc_[b:b + 4].sum()
                                       for b in range(29)])
                    bpos = int(np.argmin(wcosts))
                    cost = float(wcosts[bpos]) + lam * 8
                    if cost < best[0]:
                        best = (cost, 1, [int(bh_[bpos + k])
                                          for k in range(4)], bpos, 0)
                if best[2] is not None:
                    param.type_idx[c] = best[1]
                    param.offsets[c] = list(best[2])
                    param.band_pos[c] = best[3]
                    param.eo_class[c] = best[4]
                    if c == 1:
                        param.type_idx[2] = best[1]
                        param.eo_class[2] = best[4]
            fs.sao[ry][rx] = param
    return fs.sao


def decide_sao_host(fs, src_y, src_cb, src_cr, qp: int, tier: int):
    """All-host oracle implementation (original per-CTU loop)."""
    sps = fs.sps
    lam = 0.85 * 2.0 ** ((qp - 12) / 3.0)
    cs = sps.ctb_size
    planes = ((fs.y, src_y, 0), (fs.cb, src_cb, 1), (fs.cr, src_cr, 2))
    for ry in range(sps.pic_height_in_ctbs):
        for rx in range(sps.pic_width_in_ctbs):
            param = SaoCtuParam()
            for rec, src, c in planes:
                if c > 0 and tier < 3:
                    continue
                shift = 0 if c == 0 else 1
                bw, bh = sps.width >> shift, sps.height >> shift
                x0, y0 = (rx * cs) >> shift, (ry * cs) >> shift
                x1, y1 = min(x0 + (cs >> shift), bw), min(y0 + (cs >> shift), bh)
                if x0 >= bw or y0 >= bh:
                    continue
                if c == 2 and param.type_idx[1] == 0:
                    # chroma shares the type; skip Cr-only search when Cb off
                    continue
                diff = (src[y0:y1, x0:x1].astype(np.int64)
                        - rec[y0:y1, x0:x1].astype(np.int64))
                best = (0.0, 0, None, 0, 0)   # cost, type, offs, band, eo
                # --- EO classes
                eo_classes = (0, 1) if tier <= 1 else (0, 1, 2, 3)
                if c == 2:
                    eo_classes = (param.eo_class[1],) \
                        if param.type_idx[1] == 2 else ()
                for eo in eo_classes:
                    idx, valid = _edge_categories(rec, x0, y0, x1, y1, eo,
                                                  bw, bh)
                    cost = lam * 3
                    offs = []
                    for cat, (lo, hi) in zip((0, 1, 3, 4),
                                             ((0, 7), (0, 7), (-7, 0),
                                              (-7, 0))):
                        m = valid & (idx == cat)
                        h, cst = _best_offset(int(m.sum()),
                                              float(diff[m].sum()), lo, hi,
                                              lam)
                        offs.append(h)
                        cost += cst
                    if cost < best[0]:
                        best = (cost, 2, offs, 0, eo)
                # --- BO (tier >= 3)
                if tier >= 3 and c != 2 or (c == 2 and param.type_idx[1] == 1):
                    band = rec[y0:y1, x0:x1] >> 3
                    cnts = np.bincount(band.ravel(), minlength=32)
                    sums = np.bincount(band.ravel(),
                                       weights=diff.ravel(), minlength=32)
                    bh_, bc_ = np.zeros(32, np.int64), np.zeros(32)
                    for b in range(32):
                        bh_[b], bc_[b] = _best_offset(int(cnts[b]),
                                                      float(sums[b]), -7, 7,
                                                      lam)
                    win = bc_[:29].copy()
                    for k in range(1, 4):
                        win += bc_[k:29 + k] if len(bc_[k:29 + k]) == 29 \
                            else 0
                    # cost of best 4-band window
                    wcosts = np.array([bc_[b:b + 4].sum()
                                       for b in range(29)])
                    bpos = int(np.argmin(wcosts))
                    cost = float(wcosts[bpos]) + lam * 8
                    if cost < best[0]:
                        best = (cost, 1, [int(bh_[bpos + k])
                                          for k in range(4)], bpos, 0)
                if best[2] is not None:
                    param.type_idx[c] = best[1]
                    param.offsets[c] = list(best[2])
                    param.band_pos[c] = best[3]
                    param.eo_class[c] = best[4]
                    if c == 1:
                        param.type_idx[2] = best[1]
                        param.eo_class[2] = best[4]
            fs.sao[ry][rx] = param
    return fs.sao
