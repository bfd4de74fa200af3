"""Host-side helpers of the batched all-intra path: decision maps on the
8x8 cell grid, tile region maps, and the fill of the per-4x4 syntax maps
the slice writer reads.

Copies of the numpy code of ks265codec_tpu/encode/intra_frame.py
(`tile_region_maps`, `_block_any`, `_cbf_cells8`, `decision_maps8`,
`fill_intra_maps`, `IntraFrameEncoder._pad`, `_qp_map8` (as `qp_map8`,
with the per-CTU AQ / CU-tree offsets) and the part of
`IntraFrameEncoder` that `apply_coded_planes` and the P-picture encoder
need), `decide_frame`, the one-frame call of the port's decision pass
(K5) that the inter engine and the host walk read their intra maps and
costs from (that module imports jax, so the port keeps its own), and the
sequential per-CU coders the P/B host walk runs for its intra CUs
(`compute_sequential`, `_code_cu` with the intra TU split,
`_code_intra_split`, `_predict`, `_transform_quant` with `rdoq_np`,
`_recon_residual`; the NxN and PCM branches of `_code_cu` belong to the
intra walk, which is not ported).
"""

from __future__ import annotations

import numpy as np

from ..decode.recon import dequant, forward_transform, intra_predict, \
    inverse_transform, reconstruct
from ..hevc.tables import QUANT_SCALE, chroma_qp
from ..ops.intra import build_refs_np, use_filtered_refs
from .map_writer import EncSyntax
from .rdoq import rdoq_np
from .sbh import apply_sbh_np, scan_for


def tile_region_maps(pps, sps):
    """(region map per 4x4 cell, per 8x8 cell, n_tile_cols) for the PPS's
    tile grid, or (None, None, 1) without tiles. Region ids live in
    fs.slice_id so every neighbour-availability check enforces the
    same-tile rule (spec 6.4.1)."""
    if not pps.tiles_enabled:
        return None, None, 1
    from ..hevc.params import TileGrid
    tg = getattr(pps, "_tile_grid", None)
    if tg is None:
        tg = TileGrid(pps, sps)
        pps._tile_grid = tg
    tile4 = np.repeat(np.repeat(tg.tile8, 2, 0), 2, 1).astype(np.int32)
    return tile4, tg.tile8, pps.num_tile_columns


def _block_any(plane, blk):
    """(H//blk, W//blk) bool: any nonzero in each blk x blk block."""
    h, w = plane.shape
    return (plane.reshape(h // blk, blk, w // blk, blk) != 0).any(axis=(1, 3))


def _cbf_cells8(coeff, log2m, chroma: bool):
    """Per-8x8-cell cbf of the covering CU/TU, from a coefficient plane."""
    a8 = _block_any(coeff, 4 if chroma else 8)
    a16 = np.repeat(np.repeat(_block_any(coeff, 8 if chroma else 16), 2, 0),
                    2, 1)[:a8.shape[0], :a8.shape[1]]
    a32 = np.repeat(np.repeat(_block_any(coeff, 16 if chroma else 32), 4, 0),
                    4, 1)[:a8.shape[0], :a8.shape[1]]
    return np.where(log2m == 5, a32, np.where(log2m == 4, a16, a8))


def decision_maps8(split32, split16, mode8, mode16, mode32, sps,
                   h8: int, w8: int, cm8=None, cm16=None, cm32=None):
    """Per-8x8-cell (log2 size, luma mode, chroma mode) maps from the
    batched decision pass."""
    log2m = np.full((h8, w8), 3, np.uint8)
    modes = mode8.astype(np.uint8).copy()
    cmodes = (cm8.astype(np.uint8).copy() if cm8 is not None
              else modes.copy())
    # 16-blocks are always fully inside (dims are multiples of 16)
    m16 = np.repeat(np.repeat(~split16, 2, 0), 2, 1)[:h8, :w8]
    log2m[m16] = 4
    mode16e = np.repeat(np.repeat(mode16, 2, 0), 2, 1)[:h8, :w8]
    modes[m16] = mode16e[m16].astype(np.uint8)
    if cm16 is not None:
        cm16e = np.repeat(np.repeat(cm16, 2, 0), 2, 1)[:h8, :w8]
        cmodes[m16] = cm16e[m16].astype(np.uint8)
    else:
        cmodes[m16] = mode16e[m16].astype(np.uint8)
    # 32-blocks: only where fully inside the picture
    nby32, nbx32 = split32.shape
    full_y = (np.arange(nby32) + 1) * 32 <= sps.height
    full_x = (np.arange(nbx32) + 1) * 32 <= sps.width
    pick32 = (~split32) & (full_y[:, None] & full_x[None, :])
    m32 = np.repeat(np.repeat(pick32, 4, 0), 4, 1)[:h8, :w8]
    log2m[m32] = 5
    mode32e = np.repeat(np.repeat(mode32, 4, 0), 4, 1)[:h8, :w8]
    modes[m32] = mode32e[m32].astype(np.uint8)
    if cm32 is not None:
        cm32e = np.repeat(np.repeat(cm32, 4, 0), 4, 1)[:h8, :w8]
        cmodes[m32] = cm32e[m32].astype(np.uint8)
    else:
        cmodes[m32] = mode32e[m32].astype(np.uint8)
    return log2m, modes, cmodes


def fill_intra_maps(fs, syn, log2m, modes8, cmodes8, qp_map8,
                    cy, ccb, ccr, tile4=None) -> None:
    """Vectorised FrameState/EncSyntax fill for a whole intra frame. Writes
    only the in-picture cells: stray edge flags in the padding would
    deblock across the picture border."""
    rep = lambda a: np.repeat(np.repeat(a, 2, 0), 2, 1)
    h4v, w4v = fs.sps.height >> 2, fs.sps.width >> 2
    v = (slice(0, h4v), slice(0, w4v))
    depth8 = (fs.sps.log2_ctb - log2m.astype(np.int32)).astype(np.int8)
    fs.cu_depth[v] = rep(depth8)[v]
    fs.qp[v] = rep(qp_map8.astype(np.int8))[v]
    fs.intra_mode[v] = rep(modes8.astype(np.int8))[v]
    fs.pred_mode[v] = 1
    fs.mi_parsed[v] = True
    fs.recon_done[v] = True
    if tile4 is None:
        fs.slice_id[:] = 0
    else:
        fs.slice_id[:] = tile4
    syn.chroma_mode[v] = rep(cmodes8)[v]
    # CU/PU/TU edges: a cell starts a CU when its coords align to the size
    h4, w4 = fs.h4, fs.w4
    s4 = (1 << (rep(log2m.astype(np.int32)) - 2))
    x4 = np.arange(w4)[None, :]
    y4 = np.arange(h4)[:, None]
    ev = ((x4 % s4) == 0)
    eh = ((y4 % s4) == 0)
    for g in (fs.cu_edge_v, fs.pu_edge_v, fs.tu_edge_v):
        g[v] = ev[v]
    for g in (fs.cu_edge_h, fs.pu_edge_h, fs.tu_edge_h):
        g[v] = eh[v]
    fs.cbf_luma[v] = rep(_cbf_cells8(cy, log2m, False))[v]
    syn.cbf_cb[v] = rep(_cbf_cells8(ccb, log2m, True)).astype(np.uint8)[v]
    syn.cbf_cr[v] = rep(_cbf_cells8(ccr, log2m, True)).astype(np.uint8)[v]


def qp_map8(shape, qp: int, dq=None) -> np.ndarray:
    """Per-8-cell QP map (the reference's `IntraFrameEncoder._qp_map8`):
    the base QP plus the per-CTU AQ / CU-tree offsets dq when given, a
    short offset map extended by its last row and column, clipped to 0-51."""
    qp_map = np.full(shape, qp, np.int32)
    if dq is not None:
        cty = (shape[0] + 7) // 8
        ctx = (shape[1] + 7) // 8
        d = np.zeros((cty, ctx), np.int32)
        d[:dq.shape[0], :dq.shape[1]] = dq[:cty, :ctx]
        if dq.shape[0] < cty:
            d[dq.shape[0]:] = d[dq.shape[0] - 1]
        if dq.shape[1] < ctx:
            d[:, dq.shape[1]:] = d[:, dq.shape[1] - 1:dq.shape[1]]
        qp_map = qp_map + np.repeat(np.repeat(d, 8, 0), 8, 1)[
            :shape[0], :shape[1]]
    return np.clip(qp_map, 0, 51).astype(np.uint8)


def pad_plane(plane, ph: int, pw: int) -> np.ndarray:
    """Pad a plane to (ph, pw) by edge replication (the CTB grid)."""
    h, w = plane.shape
    out = np.empty((ph, pw), np.int32)
    out[:h, :w] = plane
    out[h:, :w] = plane[h - 1:h, :]
    out[:h, w:] = plane[:, w - 1:w]
    out[h:, w:] = plane[h - 1, w - 1]
    return out


def decide_frame(src_y, src_cb, src_cr, qp: int, lam_scale: float = 1.0,
                 effort: int = 0, nxn: bool = False,
                 reference: bool = False):
    """Whole-frame intra decision of one padded frame, as the reference's
    `decide_frame`: the batched decision pass (K5) on a one-frame batch.
    Planes are uint8 tensors on the device the pass runs on; effort 0 or
    1. Returns the 13 maps (split32, mode16, mode32, cplx, split16, mode8,
    cm8, cm16, cm32, cost8, cost16, mode4, nxn8) as numpy arrays; `nxn`
    runs the NxN tier at effort 1."""
    from ..ops.decide import MAP_NAMES, decide_frames
    maps = decide_frames(src_y[None], src_cb[None], src_cr[None], [qp],
                         lam_scale, effort=effort, nxn=nxn,
                         reference=reference)
    return tuple(maps[k][0].cpu().numpy() for k in MAP_NAMES)


class IntraFrameEncoder:
    """Syntax side of one frame coded by the device path: installs the
    device pass's levels and decision maps into the FrameState and
    EncSyntax maps the slice writer reads. With source planes and a QP it
    also holds what the P-picture encoder reads: the padded sources and
    the chroma QPs."""

    def __init__(self, fs, sps, pps, hdr, src_y=None, src_cb=None,
                 src_cr=None, qp: int | None = None):
        self.fs = fs
        self.sps = sps
        self.pps = pps
        self.hdr = hdr
        self.syn = EncSyntax(fs)
        if qp is not None:
            self.qp = qp
            self.qp_cb = chroma_qp(qp + pps.cb_qp_offset + hdr.cb_qp_offset)
            self.qp_cr = chroma_qp(qp + pps.cr_qp_offset + hdr.cr_qp_offset)
        if src_y is not None:
            # pad source to the CTU grid by edge replication
            self.src_y = self._pad(src_y, fs.ph, fs.pw)
            self.src_cb = self._pad(src_cb, fs.ph // 2, fs.pw // 2)
            self.src_cr = self._pad(src_cr, fs.ph // 2, fs.pw // 2)
        self._skip_pre = False

    _pad = staticmethod(pad_plane)

    def _qp_map8(self, shape):
        """Per-8-cell QP map: base QP + per-CTU AQ offsets when set."""
        return qp_map8(shape, self.qp, getattr(self, "dqp_ctu", None))

    def apply_coded_planes(self, log2m, modes8, cmodes8, qp_map8,
                           cy, ccb, ccr) -> None:
        """The reconstruction stays on the device; only the levels and the
        maps reach the host syntax state."""
        fs, syn = self.fs, self.syn
        syn.cy[:] = cy
        syn.ccb[:] = ccb
        syn.ccr[:] = ccr
        tile4, _, _ = tile_region_maps(self.pps, self.sps)
        fill_intra_maps(fs, syn, log2m, modes8, cmodes8, qp_map8,
                        cy, ccb, ccr, tile4=tile4)

    # --------------------------------------------- the sequential host walk
    # (the reference's per-CU coders that the P/B host walk calls for its
    # intra CUs; intra pictures take the device path)

    def compute_sequential(self):
        """Decide (`_pre_analyze`) and code every CTB in raster order
        (`_code_ctu`), filling the FrameState grids, the syntax maps and
        the coefficient planes; the reconstruction lands in fs's planes."""
        fs, sps = self.fs, self.sps
        if not self._skip_pre:
            self._pre_analyze()
        wctb = sps.pic_width_in_ctbs
        nctb = wctb * sps.pic_height_in_ctbs
        tile4, _, _ = tile_region_maps(self.pps, sps)
        if tile4 is None:
            fs.slice_id[:] = 0
        else:
            fs.slice_id[:] = tile4
        for addr in range(nctb):
            rx, ry = addr % wctb, addr // wctb
            self._code_ctu(rx << sps.log2_ctb, ry << sps.log2_ctb)

    def _code_cu(self, x0, y0, log2, depth, mode, cmode=None):
        """One 2Nx2N intra CU: luma and chroma TUs the size of the CU, or,
        where the SPS allows an intra TU split at 16 and 32, the split
        tree when it wins by rough RD."""
        if cmode is None:
            cmode = mode                                  # DM
        fs, syn = self.fs, self.syn
        size = 1 << log2
        b4 = size >> 2
        x4, y4 = x0 >> 2, y0 >> 2
        cu_qp, cu_qp_cb, cu_qp_cr = self._cu_qp(x0, y0)
        fs.cu_depth[y4:y4 + b4, x4:x4 + b4] = depth
        fs.qp[y4:y4 + b4, x4:x4 + b4] = cu_qp
        fs.cu_edge_v[y4:y4 + b4, x4] = True
        fs.cu_edge_h[y4, x4:x4 + b4] = True
        fs.pu_edge_v[y4:y4 + b4, x4] = True
        fs.pu_edge_h[y4, x4:x4 + b4] = True
        fs.tu_edge_v[y4:y4 + b4, x4] = True
        fs.tu_edge_h[y4, x4:x4 + b4] = True
        fs.intra_mode[y4:y4 + b4, x4:x4 + b4] = mode
        fs.pred_mode[y4:y4 + b4, x4:x4 + b4] = 1      # MODE_INTRA
        fs.mi_parsed[y4:y4 + b4, x4:x4 + b4] = True
        syn.chroma_mode[y4:y4 + b4, x4:x4 + b4] = cmode
        # --- luma TU (same size as CU)
        pred = self._predict(0, x0, y0, size, mode)
        src = self.src_y[y0:y0 + size, x0:x0 + size]
        coeff_y = self._transform_quant(src - pred, log2, cu_qp,
                                        scan_for(log2, 0, mode))
        cbf_y = int(coeff_y.any())
        # --- chroma TUs
        c_log2 = log2 - 1
        csz = size >> 1
        cx0, cy0 = x0 >> 1, y0 >> 1
        pred_cb = self._predict(1, cx0, cy0, csz, cmode)
        pred_cr = self._predict(2, cx0, cy0, csz, cmode)
        res_cb = self.src_cb[cy0:cy0 + csz, cx0:cx0 + csz] - pred_cb
        res_cr = self.src_cr[cy0:cy0 + csz, cx0:cx0 + csz] - pred_cr
        coeff_cb = self._transform_quant(res_cb, c_log2, cu_qp_cb,
                                         scan_for(c_log2, 1, cmode))
        coeff_cr = self._transform_quant(res_cr, c_log2, cu_qp_cr,
                                         scan_for(c_log2, 2, cmode))
        cbf_cb, cbf_cr = int(coeff_cb.any()), int(coeff_cr.any())
        if (self.sps.max_transform_hierarchy_depth_intra > 0
                and log2 in (4, 5)):
            # intra TU split: code the split variant (each sub-TU predicts
            # from the progressive recon), compare it with the unsplit
            # candidates computed above (they read only outside
            # neighbours), keep the winner
            lam = 0.57 * 2.0 ** ((cu_qp - 12) / 3.0)

            def _bits_of(cf):
                a = np.abs(cf[cf != 0]).astype(np.float64)
                return (3.1 * a.size
                        + 2.0 * np.log2(np.maximum(a, 1.0)).sum()
                        if a.size else 0.0)

            ru = reconstruct(pred, self._recon_residual(
                coeff_y, log2, cu_qp) if cbf_y else None)
            rcb = reconstruct(pred_cb, self._recon_residual(
                coeff_cb, c_log2, cu_qp_cb) if cbf_cb else None)
            rcr = reconstruct(pred_cr, self._recon_residual(
                coeff_cr, c_log2, cu_qp_cr) if cbf_cr else None)
            D_u = (float(((src - ru).astype(np.int64) ** 2).sum())
                   + float(((self.src_cb[cy0:cy0 + csz, cx0:cx0 + csz]
                             - rcb).astype(np.int64) ** 2).sum())
                   + float(((self.src_cr[cy0:cy0 + csz, cx0:cx0 + csz]
                             - rcr).astype(np.int64) ** 2).sum()))
            b_u = _bits_of(coeff_y) + _bits_of(coeff_cb) \
                + _bits_of(coeff_cr)
            D_s, b_s = self._code_intra_split(x0, y0, log2, mode, cmode,
                                              cu_qp, cu_qp_cb, cu_qp_cr)
            if D_s + lam * (b_s + 8.0) < D_u + lam * b_u:
                syn.tu_split[y4:y4 + b4, x4:x4 + b4] = 1
                return
            # unsplit wins: clear the split's interior TU edges and marks
            # (the region writes below overwrite the rest)
            syn.tu_split[y4:y4 + b4, x4:x4 + b4] = 0
            fs.tu_edge_v[y4:y4 + b4, x4 + 1:x4 + b4] = False
            fs.tu_edge_h[y4 + 1:y4 + b4, x4:x4 + b4] = False
        syn.cy[y0:y0 + size, x0:x0 + size] = coeff_y
        syn.ccb[cy0:cy0 + csz, cx0:cx0 + csz] = coeff_cb
        syn.ccr[cy0:cy0 + csz, cx0:cx0 + csz] = coeff_cr
        syn.cbf_cb[y4:y4 + b4, x4:x4 + b4] = cbf_cb
        syn.cbf_cr[y4:y4 + b4, x4:x4 + b4] = cbf_cr
        # --- reconstruct (normative path, == decoder)
        fs.cbf_luma[y4:y4 + b4, x4:x4 + b4] = bool(cbf_y)
        resi_y = self._recon_residual(coeff_y, log2, cu_qp) if cbf_y \
            else None
        fs.y[y0:y0 + size, x0:x0 + size] = reconstruct(pred, resi_y)
        resi_cb = self._recon_residual(coeff_cb, c_log2, cu_qp_cb) \
            if cbf_cb else None
        resi_cr = self._recon_residual(coeff_cr, c_log2, cu_qp_cr) \
            if cbf_cr else None
        fs.cb[cy0:cy0 + csz, cx0:cx0 + csz] = reconstruct(pred_cb, resi_cb)
        fs.cr[cy0:cy0 + csz, cx0:cx0 + csz] = reconstruct(pred_cr, resi_cr)
        fs.recon_done[y4:y4 + b4, x4:x4 + b4] = True

    def _code_intra_split(self, x0, y0, log2, mode, cmode, cu_qp,
                          cu_qp_cb, cu_qp_cr):
        """Code this intra CU as four half-size TUs (depth-1 intra
        transform tree): each sub-TU predicts from the progressively
        reconstructed neighbours; chroma codes per child. Returns
        (D_pixel, bits) of the written result."""
        fs, syn = self.fs, self.syn
        size = 1 << log2
        h = size >> 1
        clog2 = log2 - 1
        D = 0.0
        bits = 0.0
        for (dx, dy) in ((0, 0), (h, 0), (0, h), (h, h)):
            xc, yc = x0 + dx, y0 + dy
            c4x, c4y, cb4 = xc >> 2, yc >> 2, h >> 2
            fs.tu_edge_v[c4y:c4y + cb4, c4x] = True
            fs.tu_edge_h[c4y, c4x:c4x + cb4] = True
            predc = self._predict(0, xc, yc, h, mode)
            srcc = self.src_y[yc:yc + h, xc:xc + h]
            cf = self._transform_quant(srcc - predc, clog2, cu_qp,
                                       scan_for(clog2, 0, mode))
            syn.cy[yc:yc + h, xc:xc + h] = cf
            fs.cbf_luma[c4y:c4y + cb4, c4x:c4x + cb4] = bool(cf.any())
            rec = reconstruct(predc, self._recon_residual(
                cf, clog2, cu_qp) if cf.any() else None)
            fs.y[yc:yc + h, xc:xc + h] = rec
            fs.recon_done[c4y:c4y + cb4, c4x:c4x + cb4] = True
            D += float(((srcc - rec).astype(np.int64) ** 2).sum())
            a = np.abs(cf[cf != 0]).astype(np.float64)
            bits += (3.1 * a.size
                     + 2.0 * np.log2(np.maximum(a, 1.0)).sum()
                     if a.size else 0.0)
            # chroma child TU
            csz2 = h >> 1
            ccx, ccy = xc >> 1, yc >> 1
            for c_idx, (srcp, dstp, cmap, qpc) in enumerate((
                    (self.src_cb, fs.cb, syn.ccb, cu_qp_cb),
                    (self.src_cr, fs.cr, syn.ccr, cu_qp_cr)), start=1):
                pch = self._predict(c_idx, ccx, ccy, csz2, cmode)
                sch = srcp[ccy:ccy + csz2, ccx:ccx + csz2]
                cfc = self._transform_quant(sch - pch, clog2 - 1, qpc,
                                            scan_for(clog2 - 1, c_idx,
                                                     cmode))
                cmap[ccy:ccy + csz2, ccx:ccx + csz2] = cfc
                (syn.cbf_cb if c_idx == 1 else syn.cbf_cr)[
                    c4y:c4y + cb4, c4x:c4x + cb4] = int(cfc.any())
                rch = reconstruct(pch, self._recon_residual(
                    cfc, clog2 - 1, qpc) if cfc.any() else None)
                dstp[ccy:ccy + csz2, ccx:ccx + csz2] = rch
                D += float(((sch - rch).astype(np.int64) ** 2).sum())
                ac = np.abs(cfc[cfc != 0]).astype(np.float64)
                bits += (3.1 * ac.size
                         + 2.0 * np.log2(np.maximum(ac, 1.0)).sum()
                         if ac.size else 0.0)
        return D, bits

    def _predict(self, c_idx, x0, y0, size, mode):
        """Normative prediction from reconstruction references."""
        fs = self.fs
        plane = (fs.y, fs.cb, fs.cr)[c_idx]
        shift = 0 if c_idx == 0 else 1
        region = fs.slice_id[(y0 << shift) >> 2, (x0 << shift) >> 2]

        def avail(x, y):
            lx, ly = x << shift, y << shift
            return bool(fs.recon_done[ly >> 2, lx >> 2]
                        and fs.slice_id[ly >> 2, lx >> 2] == region)

        refs_u, refs_f = build_refs_np(
            plane, x0, y0, size, avail, self.sps.width >> shift,
            self.sps.height >> shift,
            bool(self.sps.strong_intra_smoothing), 8, c_idx == 0)
        n2 = 2 * size
        use_f = c_idx == 0 and use_filtered_refs(mode, size)
        refs = refs_f if use_f else refs_u
        left = refs[:n2]
        corner = int(refs[n2])
        top = refs[n2 + 1:]
        return intra_predict(mode, left, corner, top, size, 8, c_idx == 0)

    def _transform_quant(self, resi, log2, qp, scan_idx=0):
        """Host forward transform, RDOQ (`rdoq_np`) or intra deadzone
        rounding, then sign hiding."""
        c = forward_transform(np.asarray(resi, np.int32), log2, False)
        if getattr(self, "rdoq", False):
            out = rdoq_np(c, qp, log2)
        else:
            qbits = 29 + qp // 6 - 8 - log2
            rnd = 171 << (qbits - 9)
            a = np.abs(c).astype(np.int64)
            q = np.minimum((a * QUANT_SCALE[qp % 6] + rnd) >> qbits, 32767)
            out = np.where(c < 0, -q, q).astype(np.int32)
        if self.pps.sign_data_hiding_enabled:
            out = apply_sbh_np(out, scan_idx)
        return out

    def _recon_residual(self, levels, log2, qp):
        return inverse_transform(dequant(levels, qp, log2), log2, False)
