"""Vectorized merge/AMVP candidate derivation over dense motion fields.

The decoder's per-PU derivation (decode/inter.py MotionDeriver, spec
8.5.3.2) re-expressed as whole-frame numpy tensor ops. Two uses:

1. DECISION pass: candidates from the pre-pass approximate field (dense ME
   winners) feed the device mode-decision kernel.
2. SYNTAX pass: candidates from the FINAL decided field. Key property
   making this exact: a CU's neighbors are all earlier in z-scan order and
   coded motion never changes afterwards — so reading the final field at
   z-earlier positions reproduces precisely what the decoder will derive.
   (A/B property-tested against MotionDeriver per CU.)

Reference equivalents: GetMergeCandsForB / GetMvpCandsForB / getTMVP
(SURVEY.md 2.3) — the dense-grid restructure is what removes the per-CU
host walk from the encode path.
"""

from __future__ import annotations

import numpy as np

# candidate record layout: (r0, r1, mv0x, mv0y, mv1x, mv1y)
REC = 6


def zscan_vals(h4: int, w4: int, log2_ctb: int) -> np.ndarray:
    """Per-4x4 z-scan order value: CTU raster index * cells + Morton
    interleave of the in-CTU cell coords. Any two cells of different
    aligned CUs compare exactly like their CUs' coding order."""
    c4 = log2_ctb - 2                      # cell bits per CTU axis
    y = np.arange(h4)[:, None]
    x = np.arange(w4)[None, :]
    cy, cx = y >> c4, x >> c4
    ly, lx = y & ((1 << c4) - 1), x & ((1 << c4) - 1)
    wctb = (w4 + (1 << c4) - 1) >> c4

    def spread(v):
        out = np.zeros_like(v, np.int64)
        for b in range(c4):
            out |= ((v >> b) & 1) << (2 * b)
        return out

    morton = spread(lx) + 2 * spread(ly)
    return ((cy * wctb + cx).astype(np.int64) << (2 * c4)) + morton


def field_from_fs(fs) -> dict:
    """Dense field views of a FrameState (final-field syntax use)."""
    return dict(mv=fs.mv, ref=fs.ref_idx, poc=fs.ref_poc, lt=fs.ref_lt,
                inter=(fs.pred_mode == 0))


def _motion_at(field, xs4, ys4):
    """(B, REC) records at cell coords; unused-list mvs forced to zero so
    raw record equality == MotionInfo.same_motion."""
    r0 = field["ref"][0, ys4, xs4].astype(np.int32)
    r1 = field["ref"][1, ys4, xs4].astype(np.int32)
    m0 = field["mv"][0, ys4, xs4].astype(np.int32)
    m1 = field["mv"][1, ys4, xs4].astype(np.int32)
    m0 = np.where((r0 >= 0)[:, None], m0, 0)
    m1 = np.where((r1 >= 0)[:, None], m1, 0)
    return np.stack([r0, r1, m0[:, 0], m0[:, 1], m1[:, 0], m1[:, 1]], 1)


def _same(a, b):
    return (a == b).all(axis=1)


def mv_scale_vec(mv, cur_diff, col_diff):
    """Vectorized spec 8.5.3.2.8 eq. 8-169..172 (mirror of mv_scale)."""
    td = np.clip(col_diff, -128, 127).astype(np.int64)
    tb = np.clip(cur_diff, -128, 127).astype(np.int64)
    tdnz = np.where(td == 0, 1, td)
    tx = (16384 + (np.abs(tdnz) >> 1)) // tdnz
    ds = np.clip((tb * tx + 32) >> 6, -4096, 4095)
    v = ds[:, None] * mv.astype(np.int64)
    out = np.where(v < 0, -((np.abs(v) + 127) >> 8), (np.abs(v) + 127) >> 8)
    out = np.clip(out, -32768, 32767).astype(np.int32)
    return np.where((td == 0)[:, None], mv, out)


class RefCtx:
    """Per-slice lookup tables for the vectorized derivations."""

    def __init__(self, ref_lists, hdr, sps, col_pic):
        self.hdr = hdr
        self.sps = sps
        self.poc = hdr.poc
        self.is_b = hdr.slice_type == 0 and len(ref_lists[1]) > 0
        self.nref = [len(ref_lists[0]), len(ref_lists[1])]
        mx = max(1, max(self.nref))
        self.pocs = np.zeros((2, mx), np.int32)
        self.lts = np.zeros((2, mx), bool)
        for l in range(2):
            for i, rp in enumerate(ref_lists[l]):
                self.pocs[l, i] = rp.poc
                self.lts[l, i] = rp.is_long_term
        self.no_backward = all(rp.poc <= self.poc
                               for lst in ref_lists for rp in lst)
        self.col = col_pic
        self.tmvp_on = bool(hdr.temporal_mvp_enabled) and col_pic is not None


def tmvp_vec(ctx: RefCtx, xs, ys, n: int, lst: int, ref_idx,
             pic_w: int, pic_h: int):
    """Vectorized temporal MV predictor. xs/ys (B,) block origins,
    ref_idx (B,) target index into list lst. Returns (valid, mv (B,2))."""
    B = xs.shape[0]
    if not ctx.tmvp_on:
        return np.zeros(B, bool), np.zeros((B, 2), np.int32)
    cfs = ctx.col.fs
    ctb = ctx.sps.log2_ctb
    ref_idx = np.asarray(ref_idx)
    tgt_ok = ref_idx < ctx.nref[lst]
    ri = np.clip(ref_idx, 0, max(ctx.nref[lst] - 1, 0))
    tpoc = ctx.pocs[lst][ri]
    tlt = ctx.lts[lst][ri]

    def col_at(cx, cy, pos_ok):
        xr = (cx >> 4) << 4
        yr = (cy >> 4) << 4
        x4 = np.clip(xr >> 2, 0, cfs.w4 - 1)
        y4 = np.clip(yr >> 2, 0, cfs.h4 - 1)
        inter = (cfs.pred_mode[y4, x4] == 0) & pos_ok
        r0 = cfs.ref_idx[0, y4, x4].astype(np.int32)
        r1 = cfs.ref_idx[1, y4, x4].astype(np.int32)
        ok = inter & ((r0 >= 0) | (r1 >= 0))
        use = np.where(r0 < 0, 1,
                       np.where(r1 < 0, 0,
                                lst if ctx.no_backward
                                else (1 if ctx.hdr.collocated_from_l0
                                      else 0)))
        mvc = np.where((use == 0)[:, None],
                       cfs.mv[0, y4, x4], cfs.mv[1, y4, x4]).astype(np.int32)
        cpoc = np.where(use == 0, cfs.ref_poc[0, y4, x4],
                        cfs.ref_poc[1, y4, x4]).astype(np.int32)
        clt = np.where(use == 0, cfs.ref_lt[0, y4, x4],
                       cfs.ref_lt[1, y4, x4]).astype(bool)
        ok = ok & (clt == tlt) & tgt_ok
        col_diff = ctx.col.poc - cpoc
        cur_diff = ctx.poc - tpoc
        mv = np.where((clt | (col_diff == cur_diff))[:, None], mvc,
                      mv_scale_vec(mvc, cur_diff, col_diff))
        return ok, mv

    br_ok = ((ys >> ctb) == ((ys + n) >> ctb)) \
        & (xs + n < pic_w) & (ys + n < pic_h)
    ok1, mv1 = col_at(xs + n, ys + n, br_ok)
    ok2, mv2 = col_at(xs + (n >> 1), ys + (n >> 1),
                      np.ones(B, bool))
    valid = ok1 | ok2
    mv = np.where(ok1[:, None], mv1, mv2)
    return valid, mv


# fixed combination order for combined-bi candidates (spec 8.5.3.2.4)
_L0I = (0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3)
_L1I = (1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2)


def merge_lists_vec(field, ctx: RefCtx, xs, ys, n: int,
                    zval, region4, pic_w: int, pic_h: int):
    """Full merge candidate lists for B blocks of size n at origins
    (xs, ys): returns (B, 5, REC) int32 — exactly the decoder's lists
    (spatial A1/B1/B0/A0/B2 with pruning, TMVP, combined-bi, zero fill)."""
    B = xs.shape[0]
    mx = ctx.hdr.max_num_merge_cand
    z0 = zval[ys >> 2, xs >> 2]
    rg0 = region4[ys >> 2, xs >> 2]

    def avail_motion(xn, yn):
        inb = (xn >= 0) & (yn >= 0) & (xn < pic_w) & (yn < pic_h)
        x4 = np.clip(xn >> 2, 0, zval.shape[1] - 1)
        y4 = np.clip(yn >> 2, 0, zval.shape[0] - 1)
        av = inb & (zval[y4, x4] < z0) & (region4[y4, x4] == rg0) \
            & field["inter"][y4, x4]
        return av, _motion_at(field, x4, y4)

    aA1, mA1 = avail_motion(xs - 1, ys + n - 1)
    aB1, mB1 = avail_motion(xs + n - 1, ys - 1)
    aB0, mB0 = avail_motion(xs + n, ys - 1)
    aA0, mA0 = avail_motion(xs - 1, ys + n)
    aB2, mB2 = avail_motion(xs - 1, ys - 1)
    iA1 = aA1
    iB1 = aB1 & ~(aA1 & _same(mB1, mA1))
    iB0 = aB0 & ~(aB1 & _same(mB0, mB1))
    iA0 = aA0 & ~(aA1 & _same(mA0, mA1))
    cnt4 = (iA1.astype(np.int32) + iB1 + iB0 + iA0)
    iB2 = (cnt4 < 4) & aB2 & ~(aA1 & _same(mB2, mA1)) \
        & ~(aB1 & _same(mB2, mB1))
    out = np.zeros((B, mx, REC), np.int32)
    out[:, :, 0] = -1
    out[:, :, 1] = -1
    cnt = np.zeros(B, np.int32)
    for inc, m in ((iA1, mA1), (iB1, mB1), (iB0, mB0), (iA0, mA0),
                   (iB2, mB2)):
        pos = np.where(inc, cnt, mx)
        bidx = np.arange(B)
        sel = inc & (pos < mx)
        out[bidx[sel], pos[sel]] = m[sel]
        cnt = cnt + inc
    # ---- TMVP (merge variant: target ref 0 on each list)
    if ctx.tmvp_on:
        zr = np.zeros(B, np.int32)
        v0, mv0 = tmvp_vec(ctx, xs, ys, n, 0, zr, pic_w, pic_h)
        if ctx.is_b:
            v1, mv1 = tmvp_vec(ctx, xs, ys, n, 1, zr, pic_w, pic_h)
        else:
            v1 = np.zeros(B, bool)
            mv1 = np.zeros((B, 2), np.int32)
        tok = (v0 | v1) & (cnt < mx)
        rec = np.stack([np.where(v0, 0, -1), np.where(v1, 0, -1),
                        np.where(v0, mv0[:, 0], 0),
                        np.where(v0, mv0[:, 1], 0),
                        np.where(v1, mv1[:, 0], 0),
                        np.where(v1, mv1[:, 1], 0)], 1)
        pos = np.where(tok, cnt, mx)
        bidx = np.arange(B)
        sel = tok
        out[bidx[sel], np.clip(pos, 0, mx - 1)[sel]] = rec[sel]
        cnt = cnt + tok
    # ---- combined bi-predictive (B slices)
    if ctx.is_b:
        norig = cnt.copy()
        for k in range(len(_L0I)):
            i, j = _L0I[k], _L1I[k]
            can = (norig > 1) & (norig < mx) & (cnt < mx) \
                & (k < norig * (norig - 1)) & (i < norig) & (j < norig)
            ci = out[np.arange(B), np.minimum(i, mx - 1)]
            cj = out[np.arange(B), np.minimum(j, mx - 1)]
            r0, r1 = ci[:, 0], cj[:, 1]
            can = can & (r0 >= 0) & (r1 >= 0)
            p0 = ctx.pocs[0][np.clip(r0, 0, None)]
            p1 = ctx.pocs[1][np.clip(r1, 0, None)]
            diff = (p0 != p1) | (ci[:, 2] != cj[:, 4]) \
                | (ci[:, 3] != cj[:, 5])
            can = can & diff
            rec = np.stack([r0, r1, ci[:, 2], ci[:, 3],
                            cj[:, 4], cj[:, 5]], 1)
            pos = np.where(can, cnt, mx)
            bidx = np.arange(B)
            out[bidx[can], np.clip(pos, 0, mx - 1)[can]] = rec[can]
            cnt = cnt + can
    # ---- zero candidates
    nref = min(ctx.nref[0], ctx.nref[1]) if ctx.is_b else ctx.nref[0]
    nref = max(nref, 1)
    for q in range(mx):
        need = cnt <= q
        zi = q - cnt
        ridx = np.where(zi < nref, zi, 0).astype(np.int32)
        rec = np.zeros((B, REC), np.int32)
        rec[:, 0] = ridx
        rec[:, 1] = ridx if ctx.is_b else -1
        out[need, q] = rec[need]
    return out


def amvp_vec(field, ctx: RefCtx, xs, ys, n: int, lst: int, ref_idx,
             zval, region4, pic_w: int, pic_h: int):
    """Vectorized spec 8.5.3.2.6: the two AMVP candidates per block for
    list lst / per-block ref_idx. Returns (B, 2, 2) int32 mvs."""
    B = xs.shape[0]
    z0 = zval[ys >> 2, xs >> 2]
    rg0 = region4[ys >> 2, xs >> 2]
    ref_idx = np.asarray(ref_idx)
    tpoc = ctx.pocs[lst][np.clip(ref_idx, 0, None)]
    tlt = ctx.lts[lst][np.clip(ref_idx, 0, None)]

    def avail(xn, yn):
        inb = (xn >= 0) & (yn >= 0) & (xn < pic_w) & (yn < pic_h)
        x4 = np.clip(xn >> 2, 0, zval.shape[1] - 1)
        y4 = np.clip(yn >> 2, 0, zval.shape[0] - 1)
        return (inb & (zval[y4, x4] < z0) & (region4[y4, x4] == rg0)
                & field["inter"][y4, x4]), x4, y4

    def check(xn, yn, scaled: bool):
        av, x4, y4 = avail(xn, yn)
        found = np.zeros(B, bool)
        mv = np.zeros((B, 2), np.int32)
        for ll in (lst, 1 - lst):
            ri = field["ref"][ll, y4, x4].astype(np.int32)
            ok = av & (ri >= 0) & (ri < ctx.nref[ll])
            rpoc = ctx.pocs[ll][np.clip(ri, 0, None)]
            rlt = ctx.lts[ll][np.clip(ri, 0, None)]
            mvn = field["mv"][ll, y4, x4].astype(np.int32)
            if not scaled:
                hit = ok & (rpoc == tpoc) & (rlt == tlt)
                cand = mvn
            else:
                hit = ok & (rlt == tlt)
                cand = np.where(rlt[:, None], mvn,
                                mv_scale_vec(mvn, ctx.poc - tpoc,
                                             ctx.poc - rpoc))
            take = hit & ~found
            mv = np.where(take[:, None], cand, mv)
            found = found | hit
        return found, mv

    a0 = (xs - 1, ys + n)
    a1 = (xs - 1, ys + n - 1)
    b0 = (xs + n, ys - 1)
    b1 = (xs + n - 1, ys - 1)
    b2 = (xs - 1, ys - 1)
    is_scaled = avail(*a0)[0] | avail(*a1)[0]
    fA = np.zeros(B, bool)
    mvA = np.zeros((B, 2), np.int32)
    for pos in (a0, a1):
        f, m = check(*pos, scaled=False)
        take = f & ~fA
        mvA = np.where(take[:, None], m, mvA)
        fA |= f
    for pos in (a0, a1):
        f, m = check(*pos, scaled=True)
        take = f & ~fA
        mvA = np.where(take[:, None], m, mvA)
        fA |= f
    fB = np.zeros(B, bool)
    mvB = np.zeros((B, 2), np.int32)
    for pos in (b0, b1, b2):
        f, m = check(*pos, scaled=False)
        take = f & ~fB
        mvB = np.where(take[:, None], m, mvB)
        fB |= f
    # A0/A1 both unavailable: A takes unscaled-B, B re-derived w/ scaling
    fB2 = np.zeros(B, bool)
    mvB2 = np.zeros((B, 2), np.int32)
    for pos in (b0, b1, b2):
        f, m = check(*pos, scaled=True)
        take = f & ~fB2
        mvB2 = np.where(take[:, None], m, mvB2)
        fB2 |= f
    swap = ~is_scaled
    mvA_f = np.where((swap & fB)[:, None], mvB, mvA)
    fA_f = np.where(swap, fB, fA)
    mvB_f = np.where(swap[:, None], mvB2, mvB)
    fB_f = np.where(swap, fB2, fB)
    # assemble: A, then B if != A, then TMVP, then zeros
    cands = np.zeros((B, 2, 2), np.int32)
    ccnt = np.zeros(B, np.int32)
    bidx = np.arange(B)
    selA = fA_f
    cands[bidx[selA], 0] = mvA_f[selA]
    ccnt += selA
    dup = fA_f & fB_f & (mvA_f == mvB_f).all(1)
    selB = fB_f & ~dup
    pos = np.where(selB, ccnt, 2)
    cands[bidx[selB], np.clip(pos, 0, 1)[selB]] = mvB_f[selB]
    ccnt += selB
    if ctx.tmvp_on:
        need = ccnt < 2
        v, mvT = tmvp_vec(ctx, xs, ys, n, lst, ref_idx, pic_w, pic_h)
        sel = need & v
        pos = np.where(sel, ccnt, 2)
        cands[bidx[sel], np.clip(pos, 0, 1)[sel]] = mvT[sel]
        ccnt += sel
    return cands
