"""Intra coding scan (K6): predict -> forward DCT -> quant -> dequant ->
inverse DCT -> reconstruction for every CU of a batch of intra frames, one
dependency level at a time; its decoder twin (K11): predict -> dequant ->
inverse DCT -> reconstruction from parsed levels; and the P-picture
decode (K18, `recon_inter_filter`), which runs K11 over a picture's intra
CUs after its inter CUs are reconstructed.

Counterparts of ks265codec_tpu/ops/wavefront.py::_code_intra_frame_core
(`_process_class`, `_refs_from_borders`, `_update_bottom/_update_right`),
with RDOQ and sign hiding (K2, encode/rdoq.py and encode/sbh.py) where the
preset asks for them, and of
`_recon_intra_frame_core` (`_recon_class`). The host side is a copy of
`WavefrontIntraCoder` (native schedule build, level packing): the native
`ks_build_intra_schedule` walks every frame in z-order, records each CU's
reference availability at 4-sample-group granularity (tile walls
included) and gives it a level one above its latest neighbour. That level
schedule is the contract: a CU of level L reads only reconstruction written
at levels < L, so every CU of one level codes independently.

Unlike the JAX border-carry arrays (a TPU workaround for slow full-plane
scatters), both versions here read neighbour samples straight from the
reconstruction planes; they read the same values because the schedule
guarantees the neighbours are final.

CUDA: csrc/intra_scan.cu. K6 (`ks_intra_level`) launches once per level,
one thread block per scheduled CU (luma 8/16/32 plus its two chroma
blocks), frame on blockIdx.y. K11 (`ks_intra_recon`) is one persistent
launch per call: blocks take the CUs in ticket order (`ticket_order`:
level, then frame) from an atomic counter, and a CU starts once its
frame's completion counter shows every CU of a lower level done. The plain
versions run the same arithmetic level by level. K18's residual is
csrc/inter_recon.cu (one thread block per inter TU); see
`recon_inter_filter`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..encode.sbh import apply_sbh, scan_sel
from ..hevc.tables import chroma_qp
from . import _build
from . import intra as tintra
from .transforms import dequant_itx, fwd_quant

# record fields of one scheduled CU (int32)
X, Y, SIZE, MODE, CMODE, QP, QPCB, QPCR, AL, AC, AT, VALID = range(12)
NFIELDS = 12
# a ticket (`ticket_order`): the record, its frame, and the number of CUs
# of lower levels of that frame it waits for
FRAME, WAIT = NFIELDS, NFIELDS + 1
TFIELDS = NFIELDS + 2


def ticket_order(recs: np.ndarray, levels: list,
                 n_frames: int) -> np.ndarray:
    """The persistent K11's host inputs: the valid records of a schedule
    (the padding records dropped), in ticket order (level, then frame,
    then slot), each with its frame and its frame's count of CUs of lower
    levels, which the frame's completion counter must reach before the CU
    starts. (T, TFIELDS) int32."""
    out = [np.zeros((0, TFIELDS), np.int32)]
    below = np.zeros(n_frames, np.int64)
    for base, kmax in levels:
        lvl = recs[base:base + n_frames * kmax].reshape(n_frames, kmax,
                                                        NFIELDS)
        valid = lvl[..., VALID] == 1
        f, slot = np.nonzero(valid)               # frame, then slot
        out.append(np.concatenate([lvl[f, slot], f[:, None],
                                   below[f][:, None]], 1).astype(np.int32))
        below += valid.sum(1)
    return np.concatenate(out)


class LevelSchedule:
    """Scheduled CUs of a frame batch, grouped by level: `recs` (R, 12)
    int32 and, per level, (base, kmax): that level's records are
    recs[base : base + F*kmax] viewed as (F, kmax, 12), padded with
    VALID = 0."""

    def __init__(self, recs, levels: list, n_frames: int):
        self.recs = recs
        self.levels = levels
        self.n_frames = n_frames
        # the host copy `tickets` reads: K6 and the plain versions never
        # build tickets, and a schedule moved to the card keeps it
        self._host_recs = recs if isinstance(recs, np.ndarray) else None

    def to(self, device) -> "LevelSchedule":
        out = LevelSchedule(torch.as_tensor(self.recs, device=device),
                            self.levels, self.n_frames)
        out._host_recs = self._host_recs
        return out

    @functools.cached_property
    def tickets(self) -> np.ndarray:
        """The persistent K11's form of the schedule (`ticket_order`),
        built on first use."""
        recs = self._host_recs
        if recs is None:
            recs = self.recs.cpu().numpy()
        return ticket_order(recs, self.levels, self.n_frames)

    def level(self, i: int):
        base, kmax = self.levels[i]
        return self.recs[base:base + self.n_frames * kmax].reshape(
            self.n_frames, kmax, NFIELDS)


class WavefrontIntraCoder:
    """Host orchestration: native schedule build + level packing."""

    def __init__(self):
        from .. import native
        if not native.HAVE_NATIVE:
            raise RuntimeError("the native host library (native/cabac.c) "
                               "did not build; the intra scan needs its "
                               "schedule builder")
        self._lib = native._lib

    def build_schedule(self, log2map8: np.ndarray, width: int, height: int,
                       log2_ctb: int, log2_min_cb: int, tile8=None):
        """-> (x, y, size, level, avail_l, avail_c, avail_t) per CU."""
        lib = self._lib
        h8, w8 = log2map8.shape
        cap = w8 * h8
        m = np.ascontiguousarray(log2map8, np.uint8)
        t8 = (np.ascontiguousarray(tile8, np.int32) if tile8 is not None
              else None)
        ox = np.empty(cap, np.int32)
        oy = np.empty(cap, np.int32)
        osz = np.empty(cap, np.int32)
        olv = np.empty(cap, np.int32)
        oal = np.empty(cap, np.uint32)
        oac = np.empty(cap, np.uint8)
        oat = np.empty(cap, np.uint32)
        work = np.empty(2 * cap, np.int32)

        def p(a, ct):
            return a.ctypes.data_as(ctypes.POINTER(ct))

        lib.ks_build_intra_schedule.restype = ctypes.c_long
        count = lib.ks_build_intra_schedule(
            p(m, ctypes.c_uint8),
            p(t8, ctypes.c_int32) if t8 is not None
            else ctypes.POINTER(ctypes.c_int32)(),
            w8, h8, width, height, log2_ctb, log2_min_cb,
            p(ox, ctypes.c_int32), p(oy, ctypes.c_int32),
            p(osz, ctypes.c_int32), p(olv, ctypes.c_int32),
            p(oal, ctypes.c_uint32), p(oac, ctypes.c_uint8),
            p(oat, ctypes.c_uint32), p(work, ctypes.c_int32))
        return (ox[:count], oy[:count], osz[:count], olv[:count],
                oal[:count], oac[:count], oat[:count])

    def pack(self, items, qp_cb_off: int, qp_cr_off: int,
             sps) -> LevelSchedule:
        """Schedules of all frames of a batch as one LevelSchedule. items:
        dicts with log2m/modes8/cmodes8/qp_map8 (and tile8)."""
        per_frame = []
        for it in items:
            sched = self.build_schedule(
                it["log2m"], sps.width, sps.height, sps.log2_ctb,
                sps.log2_min_cb, tile8=it.get("tile8"))
            per_frame.append((sched, it["modes8"], it["cmodes8"],
                              it["qp_map8"]))
        return pack_records(per_frame, qp_cb_off, qp_cr_off)


def pack_records(per_frame, qp_cb_off: int, qp_cr_off: int) -> LevelSchedule:
    """One LevelSchedule from per-frame (schedule, modes8, cmodes8,
    qp_map8): schedule is (x, y, size, level, avail_l, avail_c, avail_t)
    per CU, as `build_schedule` returns it or a subset of it with levels
    of its own (the intra CUs of a P picture)."""
    cqp_cb = np.array([chroma_qp(min(q + qp_cb_off, 57))
                       for q in range(64)], np.int32)
    cqp_cr = np.array([chroma_qp(min(q + qp_cr_off, 57))
                       for q in range(64)], np.int32)
    F = len(per_frame)
    recs_f = []
    n_levels = 0
    for (ox, oy, osz, olv, oal, oac, oat), modes8, cmodes8, qp_map8 in \
            per_frame:
        r8, c8 = oy >> 3, ox >> 3
        qp = qp_map8[r8, c8].astype(np.int32)
        rec = np.stack([ox, oy, osz, modes8[r8, c8], cmodes8[r8, c8], qp,
                        cqp_cb[qp], cqp_cr[qp], oal.astype(np.int64),
                        oac, oat.astype(np.int64),
                        np.ones_like(ox)], 1).astype(np.int32)
        order = np.argsort(olv, kind="stable")
        lv = olv[order]
        slot = np.arange(len(lv)) - np.searchsorted(lv, lv)
        recs_f.append((rec[order], lv, slot))
        if len(lv):
            n_levels = max(n_levels, int(lv[-1]) + 1)
    counts = np.zeros((n_levels, F), np.int64)
    for f, (_, lv, _) in enumerate(recs_f):
        np.add.at(counts[:, f], lv, 1)
    kmax = counts.max(1) if F else np.zeros(0, np.int64)
    bases = np.concatenate([[0], np.cumsum(kmax * F)])
    recs = np.zeros((int(bases[-1]), NFIELDS), np.int32)
    for f, (rec, lv, slot) in enumerate(recs_f):
        recs[bases[lv] + f * kmax[lv] + slot] = rec
    levels = [(int(bases[i]), int(kmax[i])) for i in range(n_levels)]
    return LevelSchedule(recs, levels, F)


def intra_subset(sched, intra8: np.ndarray, zv: np.ndarray):
    """The CUs of a full schedule (`build_schedule`'s tuple) that lie on
    intra cells of an inter picture, each with a level of its own: one
    above the latest intra CU among its left and upper neighbours that
    precede it in z order, walked in z order (the intra CUs of a P
    picture read their inter neighbours' reconstruction, which exists
    before the scan starts). intra8 (h8, w8) bool; zv the z-scan order of
    each 4x4 (encode/merge_vec.zscan_vals). Returns the subset in
    `build_schedule`'s layout."""
    h8, w8 = intra8.shape
    ox, oy, osz, olv, oal, oac, oat = sched
    sel = intra8[oy >> 3, ox >> 3]
    ox, oy, osz = ox[sel], oy[sel], osz[sel]
    oal, oac, oat = oal[sel], oac[sel], oat[sel]
    order = np.argsort(zv[oy >> 2, ox >> 2], kind="stable")
    lvl8 = np.full((h8, w8), -1, np.int32)
    zv8 = zv[::2, ::2]
    olv = np.zeros(len(ox), np.int32)
    for k in order:
        r, c = int(oy[k]) >> 3, int(ox[k]) >> 3
        n8 = int(osz[k]) >> 3
        m8 = 2 * n8
        lv = 0
        z0 = zv8[r, c]
        if c > 0:
            col = lvl8[r:min(r + m8, h8), c - 1]
            zc = zv8[r:min(r + m8, h8), c - 1]
            good = col[(col >= 0) & (zc < z0)]
            if len(good):
                lv = max(lv, int(good.max()) + 1)
        if r > 0:
            c1 = max(c - 1, 0)
            row = lvl8[r - 1, c1:min(c + m8, w8)]
            zr = zv8[r - 1, c1:min(c + m8, w8)]
            good = row[(row >= 0) & (zr < z0)]
            if len(good):
                lv = max(lv, int(good.max()) + 1)
        olv[k] = lv
        lvl8[r:r + n8, c:c + n8] = lv
    return ox, oy, osz, olv, oal, oac, oat


# ------------------------------------------------------- plain PyTorch path

def _refs(plane: torch.Tensor, f, x, y, al, ac, at, n: int, expand: int,
          is_luma: bool, strong: bool):
    """Reference samples of K blocks read from the reconstruction planes
    (F, H, W): availability substitution (8.4.4.2.2), then for luma the
    [1 2 1] filter (8.4.4.2.3) or, for 32x32 with strong smoothing on, the
    bilinear strong filter. Returns (refs_u, refs_f) (K, 4n+1) int32 in
    the [left top->bottom | corner | top] layout."""
    F, H, W = plane.shape
    dev = plane.device
    n2 = 2 * n
    i = torch.arange(n2, device=dev)
    ly = (y[:, None] + i).clamp(0, H - 1)
    lx = (x - 1).clamp(0, W - 1)[:, None].expand_as(ly)
    ty = (y - 1).clamp(0, H - 1)[:, None].expand_as(ly)
    tx = (x[:, None] + i).clamp(0, W - 1)
    fk = f[:, None].expand_as(ly)
    left = plane[fk, ly, lx]                              # top -> bottom
    top = plane[fk, ty, tx]
    corner = plane[f, (y - 1).clamp(0, H - 1), (x - 1).clamp(0, W - 1)]
    # contour: bottom-left upward, corner, top left-to-right
    vals = torch.cat([left.flip(1), corner[:, None], top], 1).to(torch.int32)
    grp = (i * expand) // 4
    m_left = ((al[:, None] >> grp) & 1).flip(1)
    m_top = (at[:, None] >> grp) & 1
    mask = torch.cat([m_left, (ac & 1)[:, None], m_top], 1).bool()
    L = 4 * n + 1
    pos = torch.arange(L, device=dev).expand(len(f), L)
    last = torch.cummax(torch.where(mask, pos, -1), 1).values
    first = mask.to(torch.int8).argmax(1)
    fidx = torch.where(last >= 0, last, first[:, None])
    subst = torch.gather(vals, 1, fidx)
    subst = torch.where(mask.any(1)[:, None], subst, 128)

    def layout(c):
        return torch.cat([c[:, :n2].flip(1), c[:, n2:]], 1)

    refs_u = layout(subst)
    if not is_luma:
        return refs_u, refs_u
    sm = subst.clone()
    sm[:, 1:-1] = (subst[:, :-2] + 2 * subst[:, 1:-1] + subst[:, 2:] + 2) >> 2
    refs_f = layout(sm)
    if strong and n == 32:
        c0 = refs_u[:, n2]
        topv, leftv = refs_u[:, n2 + 1:], refs_u[:, :n2]
        cond = (((c0 + topv[:, n2 - 1] - 2 * topv[:, n - 1]).abs() < 8)
                & ((c0 + leftv[:, n2 - 1] - 2 * leftv[:, n - 1]).abs() < 8))
        k = torch.arange(1, n2 + 1, dtype=torch.int32, device=dev)
        ft = ((64 - k) * c0[:, None] + k * topv[:, n2 - 1:] + 32) >> 6
        fl = ((64 - k) * c0[:, None] + k * leftv[:, n2 - 1:] + 32) >> 6
        ft[:, n2 - 1] = topv[:, n2 - 1]
        fl[:, n2 - 1] = leftv[:, n2 - 1]
        strong_refs = torch.cat([fl, c0[:, None], ft], 1)
        refs_f = torch.where(cond[:, None], strong_refs, refs_f)
    return refs_u, refs_f


def _blocks(src, rec, lev, f, x, y, modes, qp, al, ac, at, n: int,
            c_idx: int, strong: bool, sbh: bool, rdoq: bool) -> None:
    """K blocks of plane c_idx in place, rec (F, H, W) uint8 and lev
    (F, H, W) int16. With a source plane (K6) the blocks are coded (RDOQ
    and sign hiding with the mode's scan where asked) and lev receives
    their levels; with src None (K11) their levels are read from lev. rec
    receives the reconstruction."""
    is_luma = c_idx == 0
    refs_u, refs_f = _refs(rec, f, x, y, al, ac, at, n, 1 if is_luma else 2,
                           is_luma, strong and is_luma)
    pred = tintra.predict_mode(refs_u, refs_f, modes, n, is_luma)
    d = torch.arange(n, device=rec.device)
    fy = f[:, None, None]
    yy = (y[:, None] + d)[:, :, None]
    xx = (x[:, None] + d)[:, None, :]
    if src is None:
        levels = lev[fy, yy, xx].to(torch.int32)
    else:
        levels = fwd_quant(src[fy, yy, xx].to(torch.int32) - pred, qp, n,
                           rdoq)
        if sbh:
            levels = apply_sbh(levels, scan_sel(modes, n.bit_length() - 1,
                                                c_idx), n)
        lev[fy, yy, xx] = levels.to(lev.dtype)
    r = (pred + dequant_itx(levels, qp, n)).clamp(0, 255)
    rec[fy, yy, xx] = r.to(rec.dtype)


def _scan_plain(srcs, recs, levs, sched: LevelSchedule, strong: bool,
                sbh: bool = False, rdoq: bool = False):
    """The level-by-level walk of both plain versions (srcs None: K11)."""
    F = sched.n_frames
    srcs = srcs or (None, None, None)
    for li in range(len(sched.levels)):
        lvl = sched.level(li)                             # (F, kmax, 12)
        kmax = lvl.shape[1]
        fidx = torch.arange(F, device=lvl.device)[:, None].expand(F, kmax)
        for n in (8, 16, 32):
            sel = (lvl[..., VALID] == 1) & (lvl[..., SIZE] == n)
            if not bool(sel.any()):
                continue
            r, f = lvl[sel], fidx[sel]
            _blocks(srcs[0], recs[0], levs[0], f, r[:, X], r[:, Y],
                    r[:, MODE], r[:, QP], r[:, AL], r[:, AC], r[:, AT], n, 0,
                    strong, sbh, rdoq)
            for c, qf in ((1, QPCB), (2, QPCR)):
                _blocks(srcs[c], recs[c], levs[c], f, r[:, X] >> 1,
                        r[:, Y] >> 1, r[:, CMODE], r[:, qf], r[:, AL],
                        r[:, AC], r[:, AT], n // 2, c, strong, sbh, rdoq)


def code_intra_frames_plain(src_y, src_cb, src_cr, sched: LevelSchedule,
                            strong: bool, sbh: bool = False,
                            rdoq: bool = False):
    """Plain PyTorch version of the scan. Sources (F, H, W) and
    (F, H/2, W/2) uint8 on one device; sched already on that device; sbh
    and rdoq select sign hiding and RDOQ. Returns (rec_y, rec_cb, rec_cr)
    uint8 and (lev_y, lev_cb, lev_cr) int16 planes; cells no CU covers
    stay 0."""
    srcs = (src_y, src_cb, src_cr)
    recs = [torch.zeros_like(p) for p in srcs]
    levs = [torch.zeros(p.shape, dtype=torch.int16, device=p.device)
            for p in srcs]
    _scan_plain(srcs, recs, levs, sched, strong, sbh, rdoq)
    return tuple(recs), tuple(levs)


def recon_intra_frames_plain(lev_y, lev_cb, lev_cr, sched: LevelSchedule,
                             strong: bool):
    """Plain PyTorch version of K11. Levels (F, H, W) and (F, H/2, W/2)
    int16 on one device; sched already on that device. Returns the
    (rec_y, rec_cb, rec_cr) uint8 planes; cells no CU covers stay 0."""
    levs = (lev_y, lev_cb, lev_cr)
    recs = [torch.zeros(p.shape, dtype=torch.uint8, device=p.device)
            for p in levs]
    _scan_plain(None, recs, levs, sched, strong)
    return tuple(recs)


# ------------------------------------------------------------- CUDA kernel

def code_intra_frames_cuda(src_y, src_cb, src_cr, sched: LevelSchedule,
                           strong: bool, tables: torch.Tensor,
                           sbh: bool = False, rdoq: bool = False):
    """The scan on the card: one launch of `ks_intra_level` per level."""
    recs = [torch.zeros_like(p) for p in (src_y, src_cb, src_cr)]
    levs = [torch.zeros(p.shape, dtype=torch.int16, device=p.device)
            for p in (src_y, src_cb, src_cr)]
    code_intra_frames_into_cuda((src_y, src_cb, src_cr), recs, levs, sched,
                                strong, tables, sbh, rdoq)
    return tuple(recs), tuple(levs)


def code_intra_frames_into_cuda(srcs, recs, levs, sched: LevelSchedule,
                                strong: bool, tables: torch.Tensor,
                                sbh: bool = False,
                                rdoq: bool = False) -> None:
    """`code_intra_frames_into` on the card: one launch of
    `ks_intra_level` per level, in place."""
    from ..encode.rdoq import RDOQ, SBH
    from ..interop import device_rank_table
    src_y, src_cb, src_cr = srcs
    for t in tuple(srcs) + tuple(recs):
        if t.dtype != torch.uint8 or not t.is_contiguous() or not t.is_cuda:
            raise ValueError("planes must be contiguous uint8 CUDA tensors")
    for t in levs:
        if t.dtype != torch.int16 or not t.is_contiguous() or not t.is_cuda:
            raise ValueError("level planes must be contiguous int16 CUDA")
    F, H, W = src_y.shape
    if src_cb.shape != (F, H // 2, W // 2) or src_cr.shape != src_cb.shape:
        raise ValueError("chroma planes must be (F, H/2, W/2)")
    if any(r.shape != p.shape for r, p in zip(recs, srcs)) or \
            any(lv.shape != p.shape for lv, p in zip(levs, srcs)):
        raise ValueError("reconstruction and level planes must match the "
                         "sources")
    lib = _build.kernels()
    rec_t = sched.recs.contiguous()
    st = _build.stream(src_y.device)
    P = _build.ptr
    rank = device_rank_table(src_y.device)
    flags = (RDOQ if rdoq else 0) | (SBH if sbh else 0)
    for base, kmax in sched.levels:
        rc = lib.ks_intra_level(
            P(src_y), P(src_cb), P(src_cr), P(recs[0]), P(recs[1]),
            P(recs[2]), P(levs[0]), P(levs[1]), P(levs[2]),
            ctypes.c_void_p(rec_t.data_ptr() + base * NFIELDS * 4),
            P(tables), P(rank), kmax, F, H, W, int(strong), flags, st)
        _build.check(rc, "ks_intra_level")
        _build.count("intra_level")
        if flags:
            _build.count("intra_level_k2")    # K2 inlined in this launch


def recon_intra_frames_cuda(lev_y, lev_cb, lev_cr, sched: LevelSchedule,
                            strong: bool, tables: torch.Tensor):
    """K11 on the card: one launch of `ks_intra_recon`."""
    recs = [torch.zeros(p.shape, dtype=torch.uint8, device=p.device)
            for p in (lev_y, lev_cb, lev_cr)]
    recon_intra_frames_into_cuda((lev_y, lev_cb, lev_cr), recs, sched,
                                 strong, tables)
    return tuple(recs)


def recon_intra_frames_into_cuda(levs, recs, sched: LevelSchedule,
                                 strong: bool, tables: torch.Tensor) -> None:
    """`recon_intra_frames_into` on the card: one persistent launch of
    `ks_intra_recon` over every level of the schedule, in place."""
    for t in levs:
        if t.dtype != torch.int16 or not t.is_cuda:
            raise ValueError("levels must be int16 CUDA tensors")
    for t in recs:
        if t.dtype != torch.uint8 or not t.is_contiguous() or not t.is_cuda:
            raise ValueError("planes must be contiguous uint8 CUDA tensors")
    F, H, W = levs[0].shape
    if levs[1].shape != (F, H // 2, W // 2) or levs[2].shape != levs[1].shape:
        raise ValueError("chroma planes must be (F, H/2, W/2)")
    if any(r.shape != lv.shape for r, lv in zip(recs, levs)):
        raise ValueError("reconstruction planes must match the levels")
    if sched.n_frames != F:
        raise ValueError("the schedule must cover the planes' frames")
    levs = [t.contiguous() for t in levs]
    tickets = torch.as_tensor(sched.tickets, device=levs[0].device)
    if tickets.shape[0] == 0:
        return
    tickets = tickets.to(torch.int32).contiguous()
    # the ticket counter, then each frame's count of completed CUs
    counters = torch.zeros(1 + F, dtype=torch.int32, device=levs[0].device)
    P = _build.ptr
    _build.check(_build.kernels().ks_intra_recon(
        P(levs[0]), P(levs[1]), P(levs[2]), P(recs[0]), P(recs[1]),
        P(recs[2]), P(tickets), P(counters), P(tables), tickets.shape[0], H,
        W, int(strong), _build.stream(levs[0].device)), "ks_intra_recon")
    _build.count("intra_recon")


def recon_intra_frames(lev_y, lev_cb, lev_cr, sched: LevelSchedule,
                       strong: bool, reference: bool = False):
    """Intra reconstruction of a batch from parsed levels. CUDA tensors
    launch the kernel; CPU tensors, or reference=True, run
    `recon_intra_frames_plain`."""
    sched = sched.to(lev_y.device)
    if lev_y.device.type != "cuda" or reference:
        return recon_intra_frames_plain(lev_y, lev_cb, lev_cr, sched, strong)
    from ..interop import device_tables
    return recon_intra_frames_cuda(lev_y, lev_cb, lev_cr, sched, strong,
                                   device_tables(lev_y.device))


def code_intra_frames(src_y, src_cb, src_cr, sched: LevelSchedule,
                      strong: bool, sbh: bool = False, rdoq: bool = False,
                      reference: bool = False):
    """The intra coding scan for a batch, with sign hiding and RDOQ where
    asked. CUDA tensors launch the kernel; CPU tensors, or reference=True,
    run `code_intra_frames_plain`."""
    sched = sched.to(src_y.device)
    if src_y.device.type != "cuda" or reference:
        return code_intra_frames_plain(src_y, src_cb, src_cr, sched, strong,
                                       sbh, rdoq)
    from ..interop import device_tables
    return code_intra_frames_cuda(src_y, src_cb, src_cr, sched, strong,
                                  device_tables(src_y.device), sbh, rdoq)


def code_intra_frames_into(srcs, recs, levs, sched: LevelSchedule,
                           strong: bool, sbh: bool = False,
                           rdoq: bool = False,
                           reference: bool = False) -> None:
    """The intra coding scan in place over existing planes (F, H, W):
    srcs and recs uint8, levs int16. Only the scheduled CUs are coded, and
    they read neighbours that no CU of the schedule writes from the planes
    as given (the seeded scan of the intra CUs of a P picture). CUDA
    tensors launch the kernel; CPU tensors, or reference=True, run the
    plain version."""
    sched = sched.to(srcs[0].device)
    if srcs[0].device.type != "cuda" or reference:
        _scan_plain(srcs, recs, levs, sched, strong, sbh, rdoq)
        return
    from ..interop import device_tables
    code_intra_frames_into_cuda(srcs, recs, levs, sched, strong,
                                device_tables(srcs[0].device), sbh, rdoq)


def recon_intra_frames_into(levs, recs, sched: LevelSchedule, strong: bool,
                            reference: bool = False) -> None:
    """K11 in place over existing reconstruction planes (F, H, W): levs
    int16, recs uint8. Only the scheduled CUs are reconstructed; they read
    neighbours no CU of the schedule writes from the planes as given (the
    intra CUs of a decoded P picture over its inter reconstruction). CUDA
    tensors launch the kernel; CPU tensors, or reference=True, run the
    plain version."""
    sched = sched.to(levs[0].device)
    if levs[0].device.type != "cuda" or reference:
        _scan_plain(None, recs, levs, sched, strong)
        return
    from ..interop import device_tables
    recon_intra_frames_into_cuda(levs, recs, sched, strong,
                                 device_tables(levs[0].device))


# ---------------------------------------------------------------- K18

# the reference's `_dense_residual` classes: (this plane's tile size, the
# luma CU log2 the size map carries)
_LUMA_CLASSES = ((8, 3), (16, 4), (32, 5))
_CHROMA_CLASSES = ((4, 3), (8, 4), (16, 5))


def _dense_residual(coef, qp_map, size_pix, classes):
    """The reference's dense residual: every aligned tile of each class
    dequantised and inverse transformed with the QP at its origin, each
    sample taking the class its CU has. coef (H, W) int16, qp_map one QP
    per 4 samples of this plane, size_pix (H, W) the luma CU log2."""
    H, W = coef.shape
    resid = torch.zeros((H, W), dtype=torch.int32, device=coef.device)
    for n, sel in classes:
        tiles = coef.to(torch.int32).reshape(H // n, n, W // n, n) \
            .transpose(1, 2).reshape(-1, n, n)
        step = max(n // 4, 1)
        qp = qp_map[::step, ::step].reshape(-1).to(torch.int32)
        r = dequant_itx(tiles, qp, n).reshape(H // n, W // n, n, n) \
            .transpose(1, 2).reshape(H, W)
        resid = torch.where(size_pix == sel, r, resid)
    return resid


def inter_recon_plain(refs, slot0, mv0, slot1, mv1, has_l1, coefs, log2m8,
                      qp4, qp4_cb, qp4_cr, inter8, sched, strong, width,
                      height, wts0=None, wts1=None):
    """Plain PyTorch version of K18's reconstruction (the reference's
    `_recon_inter_filter_core` before its filters): MC from one or
    (has_l1) two lists, weighted where wts0 / wts1 are given, the dense
    residual on inter cells, the seeded intra scan. See
    `recon_inter_filter`."""
    from .mc import mc_planes
    h8, w8 = log2m8.shape
    pred = mc_planes(refs, slot0, mv0, slot1, mv1, has_l1, h8, w8, width,
                     height, reference=True, wts0=wts0, wts1=wts1)
    size = log2m8.to(torch.int32).repeat_interleave(8, 0) \
        .repeat_interleave(8, 1)
    inter = inter8.bool().repeat_interleave(8, 0).repeat_interleave(8, 1)
    recs = []
    for c, (p, coef) in enumerate(zip(pred, coefs)):
        sub = slice(None, None, 1 if c == 0 else 2)
        r = _dense_residual(coef, (qp4, qp4_cb, qp4_cr)[c], size[sub, sub],
                            _LUMA_CLASSES if c == 0 else _CHROMA_CLASSES)
        recs.append((p.to(torch.int32)
                     + torch.where(inter[sub, sub], r, 0)).clamp(0, 255)
                    .to(torch.uint8)[None])
    if sched is not None:
        recon_intra_frames_into([c[None] for c in coefs], recs, sched, strong,
                                reference=True)
    return recs


def inter_tu_list(log2m8: np.ndarray, inter8: np.ndarray) -> np.ndarray:
    """(K, 4) int32 records (plane, x, y, n) of the transform units of the
    inter CUs (TU == CU, 8 to 32 luma samples; a 64 CU carries no residual
    on this path): the luma TU and its two chroma TUs at half size."""
    h8, w8 = log2m8.shape
    r, c = np.mgrid[0:h8, 0:w8]
    lg = log2m8.astype(np.int32)
    n8 = 1 << np.clip(lg - 3, 0, 3)
    origin = inter8 & (lg >= 3) & (lg <= 5) & (r % n8 == 0) & (c % n8 == 0)
    rr, cc = r[origin], c[origin]
    n = (8 * n8[origin]).astype(np.int32)
    luma = np.stack([np.zeros_like(n), 8 * cc, 8 * rr, n], 1)
    chroma = [np.stack([np.full_like(n, pl), 4 * cc, 4 * rr, n // 2], 1)
              for pl in (1, 2)]
    return np.concatenate([luma] + chroma).astype(np.int32)


def inter_recon_cuda(refs, slot0, mv0, slot1, mv1, has_l1, coefs, log2m8,
                     qp4, qp4_cb, qp4_cr, inter8, sched, strong, width,
                     height, wts0=None, wts1=None):
    """K18's reconstruction on the card: K14 (`ks_inter_mc`) into the
    reconstruction planes, one launch of `ks_inter_recon` over the inter
    TUs and K11 over the intra CUs, both in place."""
    from ..interop import device_tables
    from .mc import mc_planes_cuda
    for t in coefs:
        if t.dtype != torch.int16 or not t.is_cuda or not t.is_contiguous():
            raise ValueError("coefficient planes must be contiguous int16 "
                             "CUDA tensors")
    dev = coefs[0].device
    H, W = coefs[0].shape
    h8, w8 = log2m8.shape
    tab = device_tables(dev)
    recs = mc_planes_cuda(refs, slot0, mv0, slot1, mv1, has_l1, h8, w8,
                          width, height, wts0, wts1)
    tus = torch.from_numpy(inter_tu_list(
        log2m8.cpu().numpy(), inter8.cpu().numpy().astype(bool))).to(dev)
    qps = [q.to(device=dev, dtype=torch.int32).contiguous()
           for q in (qp4, qp4_cb, qp4_cr)]
    P = _build.ptr
    _build.check(_build.kernels().ks_inter_recon(
        P(tus), P(coefs[0]), P(coefs[1]), P(coefs[2]), P(recs[0]),
        P(recs[1]), P(recs[2]), P(qps[0]), P(qps[1]), P(qps[2]), P(tab),
        tus.shape[0], H, W, _build.stream(dev)), "ks_inter_recon")
    _build.count("inter_recon" if wts0 is None and wts1 is None
                 else "inter_recon_wp")
    recs = [r[None] for r in recs]
    if sched is not None:
        recon_intra_frames_into([c[None] for c in coefs], recs, sched, strong)
    return recs


def recon_inter_filter(refs, slot0, mv0, coefs, log2m8, qp4, qp4_cb, qp4_cr,
                       inter8, sched: LevelSchedule | None, bs_v, bs_h,
                       sao_params, strong: bool, deblock: bool,
                       sao_chroma: bool, boff: int, toff: int, cbo: int,
                       cro: int, width: int, height: int, cs: int,
                       reference: bool = False, slot1=None, mv1=None,
                       has_l1: bool = False, wts0=None, wts1=None):
    """Reconstruction of one parsed P or B picture (K18): MC from the
    per-8x8-cell motion of one list or, with has_l1 (a B picture), two,
    with the slice's explicit weights where wts0 / wts1 (the lists' tables,
    ops/mc.py::cell_weights) are given,
    the dequantised, inverse-transformed residual
    of the inter CUs' TUs (TU == CU) added and clipped, the intra CUs
    reconstructed over it from their levels (the seeded K11 scan), then
    deblocking (K7) and SAO (K9).

    refs (R, H, W) / (R, H/2, W/2) uint8 stacks; slot0 / slot1 (h8*w8,)
    slots (-1: the list is unused; slot0 is 0 where neither list is
    used), mv0 / mv1 (h8*w8, 2) quarter-pel (list 1 read only with
    has_l1); coefs (y, cb, cr) int16 planes;
    log2m8 (h8, w8) CU log2 per cell; qp4 (H/4, W/4) luma QP, qp4_cb/qp4_cr
    (H/8, W/8) chroma QPs with the PPS and slice offsets; inter8 (h8, w8)
    bool, the parsed inter cells; sched the intra CUs' schedule or None;
    bs_v/bs_h (H/4, W/4) strengths; sao_params (type, offs, bpos, eocl)
    int8 or None; cbo/cro the PPS chroma offsets deblocking uses.
    Returns the (y, cb, cr) uint8 planes. CUDA coefficient planes launch
    the kernels; CPU planes, or reference=True, run the plain versions."""
    from ..utils.trace import stage
    from .deblock import deblock_frames
    from .saoapply import sao_apply_frames
    from .mc import no_l1
    dev = coefs[0].device
    plain = dev.type != "cuda" or reference
    if sched is not None:
        sched = sched.to(dev)
    l1 = (slot1, mv1) if has_l1 else no_l1(slot0, mv0)
    with stage("dec.inter_recon"):
        if plain:
            planes = inter_recon_plain(
                refs, slot0.to(dev), mv0.to(dev), *(t.to(dev) for t in l1),
                has_l1, coefs, log2m8.to(dev), qp4.to(dev), qp4_cb.to(dev),
                qp4_cr.to(dev), inter8.to(dev), sched, strong, width, height,
                wts0, wts1)
        else:
            # the TU list is built on the host from the host maps
            planes = inter_recon_cuda(refs, slot0, mv0, *l1, has_l1, coefs,
                                      log2m8, qp4, qp4_cb, qp4_cr, inter8,
                                      sched, strong, width, height, wts0,
                                      wts1)
    if deblock:
        with stage("dec.deblock"):
            planes = deblock_frames(
                *planes, bs_v.to(dev, torch.uint8)[None],
                bs_h.to(dev, torch.uint8)[None],
                qp4.to(dev, torch.uint8)[None], boff, toff, cbo, cro, width,
                height, reference=reference)
    if sao_params is not None:
        with stage("dec.sao"):
            planes = sao_apply_frames(
                *planes, *(a.to(dev)[None] for a in sao_params), True,
                sao_chroma, width, height, cs, reference=reference)
    return tuple(p[0] for p in planes)
