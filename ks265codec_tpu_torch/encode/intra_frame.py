"""Host-side helpers of the batched all-intra path: decision maps on the
8x8 cell grid, tile region maps, and the fill of the per-4x4 syntax maps
the slice writer reads.

Copies of the numpy code of ks265codec_tpu/encode/intra_frame.py
(`tile_region_maps`, `_block_any`, `_cbf_cells8`, `decision_maps8`,
`fill_intra_maps`, `IntraFrameEncoder._pad`, `_qp_map8` (as `qp_map8`,
with the per-CTU AQ / CU-tree offsets) and the part of
`IntraFrameEncoder` that `apply_coded_planes` and the P-picture encoder
need), and `decide_frame`, the one-frame call of the port's decision pass
(K5) that the inter engine reads its intra maps and costs from; that
module imports jax, so the port keeps its own.
"""

from __future__ import annotations

import numpy as np

from ..hevc.tables import chroma_qp
from .map_writer import EncSyntax


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
