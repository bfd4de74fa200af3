"""P- and B-picture encoders: the batched device inter engine
(encode/inter_engine.py) and the sequential per-CU host walk, on the
port's kernels.

The port's counterpart of ks265codec_tpu/encode/inter_frame.py.
`PFrameEncoder.compute` takes the device engine where `_engine_ok` holds
(no tiles, dependent slices, inter partitions, inter TU split, PCM or
noise reduction), and the reference's host walk where it does not: the
`slower`, `veryslow` and `placebo` presets (partitions, the inter TU
split), with any number of L0 references. A failure inside the engine
raises; it never falls back to the walk.

The walk (`_pre_analyze`, then `compute_sequential` over the CTBs in
raster order) is the reference's, with its host numpy decisions copied:
  * pre-analysis: K5 (ops/decide.py) for the intra modes and costs, then
    per reference the dense SAD grids of K20 (ops/me.py: the hierarchical
    route at me >= 2 with merange > 16) and the quarter-pel refinement of
    K21 (ops/subpel.py), the float64 mvd-rate terms on the host; in B
    pictures both lists and K21's bi cost, and each block's direction;
    the split16 and 32x32 decisions (`interp_luma`, unweighted);
  * per CTB: the 64x64 skip probe, the 32/16/8 CU quadtree, per CU the
    merge candidates and AMVP (the decoder's MotionDeriver), weighted MC
    (`motion_compensate`), rough-RD costs with the Precise bit counter
    (encode/bitcounter.py), 2NxN/Nx2N and at partitions=2 AMP PUs, the
    inter TU split, intra CUs through `IntraFrameEncoder._code_cu`, host
    transforms and quantisation (`rdoq_np`, `apply_sbh_np`) and the
    normative reconstruction into the FrameState.
The encoder then deblocks, decides SAO (K22's statistics) and applies it
on the host, as the reference does for its host-path pictures.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..decode.inter import MotionDeriver, MotionInfo, interp_luma, \
    motion_compensate
from ..decode.recon import forward_transform as fwd
from ..hevc.tables import LEVEL_SCALE, QUANT_SCALE, chroma_qp
from ..ops import me as tme
from ..ops.subpel import bi_pred_cost, refine_subpel_frame
from .bitcounter import PreciseBitCounter
from .intra_frame import IntraFrameEncoder, decide_frame
from .map_writer import amp_pu_geometry
from .sbh import apply_sbh_np

MODE_INTER = 0


def mv_pred_field(mv_q: np.ndarray) -> np.ndarray:
    """Median-of-neighbors (left/top/top-right) predictor field for a
    dense per-block MV grid — the pre-pass stand-in for AMVP (which
    needs final neighbor decisions that don't exist yet). Units follow
    the input (quarter-pel here)."""
    left = np.empty_like(mv_q)
    left[:, 1:] = mv_q[:, :-1]
    left[:, :1] = mv_q[:, :1]
    top = np.empty_like(mv_q)
    top[1:] = mv_q[:-1]
    top[:1] = mv_q[:1]
    tr = np.empty_like(mv_q)
    tr[1:, :-1] = mv_q[:-1, 1:]
    tr[:1] = mv_q[:1]
    tr[1:, -1:] = mv_q[:-1, -1:]
    return np.median(np.stack([left, top, tr]), axis=0).astype(mv_q.dtype)


class PFrameEncoder(IntraFrameEncoder):
    """Codes one P picture (single slice): the device engine, or the host
    walk (16x16 and 8x8 CUs from the ME fields, 32x32 and whole-CTB skip
    CUs, rectangular and AMP PUs, the inter TU split)."""

    def __init__(self, fs, sps, pps, hdr, src_y, src_cb, src_cr, qp,
                 ref_lists, subme: int = 1, device=None,
                 reference: bool = False):
        super().__init__(fs, sps, pps, hdr, src_y, src_cb, src_cr, qp)
        self.ref_lists = ref_lists
        self.subme = subme
        self.device = device
        self.reference = bool(reference)
        self.md = MotionDeriver(fs, sps, pps, hdr, ref_lists, 0)
        self.lam = 0.85 * 2.0 ** ((qp - 12) / 3.0)
        self.lam_satd = float(np.sqrt(self.lam))

    def _apply_lam_scale(self):
        sc = getattr(self, "lam_scale", 1.0)
        self.lam = 0.85 * sc * 2.0 ** ((self.qp - 12) / 3.0)
        self.lam_satd = float(np.sqrt(self.lam))

    def _engine_ok(self) -> bool:
        return (not self.pps.tiles_enabled
                and not self.pps.dependent_slice_segments_enabled
                and int(getattr(self, "partitions", 0)) == 0
                and int(getattr(self, "inter_tu_depth", 0)) == 0
                and not self.sps.pcm_enabled
                and not int(getattr(self, "noise_reduction", 0)))

    def compute(self):
        """The batched device inter engine where it covers the
        configuration (one decision pass per iteration over the CU tiers
        and one coding pass), else the sequential host walk."""
        if self._engine_ok():
            self.use_device_engine = True
            from .inter_engine import engine_pre_analysis, run_engine
            engine_pre_analysis(self)
            run_engine(self)
            return
        self.use_device_engine = False
        # the walk reads reference pixels on the host; device-path
        # pictures keep them on the device until asked
        for lst in self.ref_lists:
            for rp in lst:
                rp.fs.ensure_planes()
        self.compute_sequential()

    def _dev_kw(self) -> dict:
        """Where the walk's device functions (K5, K20, K21) run."""
        return dict(device=self.device, reference=self.reference)

    def _walk_src_dev(self):
        """The padded source planes as uint8 tensors on the device (K5's
        input for the walk)."""
        dev = resolve_device(self.device)
        return tuple(
            torch.from_numpy(np.ascontiguousarray(a, np.uint8)).to(dev)
            for a in (self.src_y, self.src_cb, self.src_cr))

    def _decide_intra(self) -> None:
        """K5 on the picture (the reference's `decide_frame` call at its
        default lam_scale 1.0): the intra modes and rough costs the walk
        reads."""
        (_, self.mode16, _, _, _, self.mode8, self.cmode8, self.cmode16,
         _, self.icost8, self.icost16, self.mode4,
         self.nxn8) = decide_frame(
            *self._walk_src_dev(), self.qp,
            effort=getattr(self, "decide_effort", 1),
            reference=self.reference)

    def _pre_analyze(self) -> None:
        """Intra analysis (K5) and the motion search of every 16x16 and 8x8
        block against each L0 reference (K20: the hierarchical route at
        me >= 2 with merange > 16, or for a reference more than 2 pictures
        away; K21: the quarter-pel refinement), keeping per block the
        reference with the least SAD + ref-index bias; then the split16
        and 32x32 decisions."""
        self._apply_lam_scale()
        self._decide_intra()
        pw, ph = self.sps.width, self.sps.height
        kw = self._dev_kw()
        merange = int(getattr(self, "merange", 12))
        # wide-range hierarchical search on the UMH/EPZS tiers (me >= 2)
        # and always for distant references
        hier_all = merange > 16 and int(getattr(self, "me_method", 1)) >= 2
        best16 = best8 = None
        for ri, rp in enumerate(self.ref_lists[0]):
            ref_y = np.asarray(rp.fs.y)
            dist = abs(int(getattr(self.hdr, "poc", 0)) - int(rp.poc))
            hier = hier_all or (merange > 16 and dist > 2)
            if hier:
                mv16, _, sad16 = tme.motion_search_frame_hier(
                    self.src_y, ref_y, 16, merange, self.lam_satd, **kw)
                mv8, _, sad8 = tme.motion_search_frame_hier(
                    self.src_y, ref_y, 8, merange, 0.5 * self.lam_satd, **kw)
            else:
                mv16, _, sad16 = tme.motion_search_frame(
                    self.src_y, ref_y, 16, min(merange, 16),
                    self.lam_satd, **kw)
                mv8, _, sad8 = tme.motion_search_frame(
                    self.src_y, ref_y, 8, min(merange, 16),
                    0.5 * self.lam_satd, **kw)
            if self.subme:
                mv16, sad16 = refine_subpel_frame(
                    self.src_y, ref_y, mv16 >> 2, 16, pw, ph,
                    mv_pred_q=mv_pred_field(mv16), lam=self.lam_satd, **kw)
                mv8, sad8 = refine_subpel_frame(
                    self.src_y, ref_y, mv8 >> 2, 8, pw, ph,
                    mv_pred_q=mv_pred_field(mv8), lam=0.5 * self.lam_satd,
                    **kw)
            # ref-idx rate bias: TU bins, ~ri extra bins
            c16 = sad16 + self.lam_satd * 2.0 * ri
            c8 = sad8 + self.lam_satd * 2.0 * ri
            if best16 is None:
                best16 = [mv16, sad16, c16,
                          np.zeros_like(sad16, np.int8)]
                best8 = [mv8, sad8, c8, np.zeros_like(sad8, np.int8)]
            else:
                m = c16 < best16[2]
                best16[0] = np.where(m[..., None], mv16, best16[0])
                best16[1] = np.where(m, sad16, best16[1])
                best16[2] = np.where(m, c16, best16[2])
                best16[3] = np.where(m, ri, best16[3]).astype(np.int8)
                m = c8 < best8[2]
                best8[0] = np.where(m[..., None], mv8, best8[0])
                best8[1] = np.where(m, sad8, best8[1])
                best8[2] = np.where(m, c8, best8[2])
                best8[3] = np.where(m, ri, best8[3]).astype(np.int8)
        self.mv16, self.sad16, _, self.ref16 = best16
        self.mv8, self.sad8, _, self.ref8 = best8
        self.frame_cplx = float(self.sad16.sum())
        self._decide_split16()
        self._decide_cu32()

    def _decide_split16(self):
        """Per-16 block: code as four 8x8 inter CUs when the children's
        prediction gain beats their extra header cost (the reference's
        goDownJudge at the 16->8 tier; 8x8 PUs are where most of its
        inter RD advantage on mixed-motion content comes from)."""
        h16, w16 = self.sad16.shape
        s8sum = self.sad8[:2 * h16, :2 * w16] \
            .reshape(h16, 2, w16, 2).sum(axis=(1, 3))
        self.split16 = s8sum + self.lam_satd * 20.0 < self.sad16

    def _code_ctu(self, x0: int, y0: int) -> None:
        self._code_ctu_p(x0, y0)


    # ----------------------------------------------- large-CU (32) decision
    def _decide_cu32(self):
        """Per-32x32 block: take the minimum-cost child's motion and score
        it over the whole block; prefer the large CU when it beats the sum
        of the children plus their per-CU header overhead (the reference's
        goUp/goDownJudge analog at a coarse tier)."""
        sps = self.sps
        h4 = self.sad16.shape[0] // 2 * 2
        w4 = self.sad16.shape[1] // 2 * 2
        nby, nbx = h4 // 2, w4 // 2
        self.use32 = np.zeros((self.sad16.shape[0] // 2 + 1,
                               self.sad16.shape[1] // 2 + 1), bool)
        self.sad32 = np.zeros_like(self.use32, np.int64)
        self.mi32 = [[None] * self.use32.shape[1]
                     for _ in range(self.use32.shape[0])]
        hdr_bits = 14.0
        pw, ph = sps.width, sps.height
        for by in range(nby):
            for bx in range(nbx):
                x0, y0 = bx * 32, by * 32
                if x0 + 32 > pw or y0 + 32 > ph:
                    continue
                subs = [(int(self.sad16[2 * by + dy, 2 * bx + dx]),
                         2 * by + dy, 2 * bx + dx)
                        for dy in (0, 1) for dx in (0, 1)]
                child_sum = sum(ssad for ssad, _, _ in subs)
                best = min(subs)
                mi, _ = self._block_mi(best[1], best[2])
                # SAD of the whole 32 block with this motion (luma only)
                preds = []
                for l in range(2):
                    if mi.ref_idx[l] < 0:
                        continue
                    ref = self.ref_lists[l][mi.ref_idx[l]].fs.y
                    preds.append(interp_luma(np.asarray(ref), x0, y0, 32, 32,
                                             mi.mv[l][0], mi.mv[l][1],
                                             pw, ph))
                if len(preds) == 2:
                    pred = np.clip((preds[0] + preds[1] + 64) >> 7, 0, 255)
                else:
                    pred = np.clip((preds[0] + 32) >> 6, 0, 255)
                src = self.src_y[y0:y0 + 32, x0:x0 + 32]
                s32 = int(np.abs(src - pred).sum())
                if s32 <= child_sum + 3 * hdr_bits * self.lam_satd:
                    self.use32[by, bx] = True
                    self.sad32[by, bx] = s32
                    self.mi32[by][bx] = mi


    # --------------------------------------------------- 64x64 skip probe
    def _try_skip64(self, x0, y0, depth0=0) -> bool:
        """Code a whole-CTB SKIP CU when some merge candidate yields an
        all-zero quantized residual (the dominant coding mode on static
        content; the reference reaches it via do64 + skipFastDecision)."""
        fs, sps = self.fs, self.sps
        if x0 + 64 > sps.width or y0 + 64 > sps.height:
            return False
        cands = self.md.merge_candidates(x0, y0, 64, x0, y0, 64, 64, 0, 0)
        src = self.src_y[y0:y0 + 64, x0:x0 + 64]
        tried = set()
        for idx, mi in enumerate(cands):
            used = tuple((l, mi.ref_idx[l], tuple(mi.mv[l]))
                         for l in range(2) if mi.ref_idx[l] >= 0)
            if not used or used in tried:
                continue
            tried.add(used)
            motion_compensate(fs, self.hdr, self.ref_lists, x0, y0, 64, 64,
                              mi)
            pred = fs.y[y0:y0 + 64, x0:x0 + 64]
            # cheap gate: skip candidates with visibly large luma error
            if np.abs(src - pred).sum() > 64 * 64 * 4:
                continue
            zero = True
            for dy in (0, 32):
                for dx in (0, 32):
                    r = src[dy:dy + 32, dx:dx + 32] \
                        - pred[dy:dy + 32, dx:dx + 32]
                    if self._transform_quant_inter(r, 5, self.qp).any():
                        zero = False
                        break
                if not zero:
                    break
            if zero:
                cx0, cy0 = x0 >> 1, y0 >> 1
                for plane, srcc, qpc in (
                        (fs.cb, self.src_cb, self.qp_cb),
                        (fs.cr, self.src_cr, self.qp_cr)):
                    r = srcc[cy0:cy0 + 32, cx0:cx0 + 32] \
                        - plane[cy0:cy0 + 32, cx0:cx0 + 32]
                    if self._transform_quant_inter(r, 5, qpc).any():
                        zero = False
                        break
            if not zero:
                continue
            # --- record it (SKIP CU covering the whole CTB)
            x4, y4 = x0 >> 2, y0 >> 2
            fs.cu_depth[y4:y4 + 16, x4:x4 + 16] = depth0
            fs.qp[y4:y4 + 16, x4:x4 + 16] = self.qp
            for g in (fs.cu_edge_v, fs.pu_edge_v, fs.tu_edge_v):
                g[y4:y4 + 16, x4] = True
            for g in (fs.cu_edge_h, fs.pu_edge_h, fs.tu_edge_h):
                g[y4, x4:x4 + 16] = True
            fs.skip[y4:y4 + 16, x4:x4 + 16] = True
            self.syn.merge_flag[y4:y4 + 16, x4:x4 + 16] = 1
            self.syn.merge_idx[y4:y4 + 16, x4:x4 + 16] = idx
            self._store_motion(x0, y0, 64, mi)
            fs.cbf_luma[y4:y4 + 16, x4:x4 + 16] = False
            fs.recon_done[y4:y4 + 16, x4:x4 + 16] = True
            return True
        return False

    # --------------------------------------------------------------- CTU
    def _set_ctu_qp(self, x0, y0) -> None:
        """Per-CTU QP from the lookahead AQ/CU-tree offsets (dqp_ctu):
        switch qp / chroma qps / lambdas for the CTU being coded; the
        map-writer's cu_qp_delta chain serializes the differences."""
        dq = getattr(self, "dqp_ctu", None)
        if dq is None:
            return
        if not hasattr(self, "_base_qp"):
            self._base_qp = self.qp
        cs = 1 << self.sps.log2_ctb
        d = int(dq[min(y0 // cs, dq.shape[0] - 1),
                   min(x0 // cs, dq.shape[1] - 1)])
        self.qp = int(np.clip(self._base_qp + d, 0, 51))
        pps, hdr = self.pps, self.hdr
        self.qp_cb = chroma_qp(self.qp + pps.cb_qp_offset
                               + hdr.cb_qp_offset)
        self.qp_cr = chroma_qp(self.qp + pps.cr_qp_offset
                               + hdr.cr_qp_offset)
        self._apply_lam_scale()

    def _cu_qp(self, x0: int, y0: int):
        # P/B frames: _set_ctu_qp already applied the per-CTU offset to
        # self.qp — the base-class version would add it a second time
        # for intra CUs inside inter frames (found as an encoder/decoder
        # QP mismatch on cutree B frames)
        return self.qp, self.qp_cb, self.qp_cr

    def _bitcounter(self):
        """Per-frame Precise (CABAC-state) bit counter for the sequential
        walk's motion-syntax arbitration — the CBitCounterPrecise tier
        (SURVEY.md 2.3). Decisions happen in coding order here, so
        adapting its states with each chosen CU's syntax tracks the real
        writer's context evolution; residual bins stay on the Rough
        closed-form model (counted by _rough_inter_cost)."""
        pbc = getattr(self, "_pbc", None)
        if pbc is None:
            pbc = PreciseBitCounter(self.hdr.slice_type,
                                    int(self.hdr.slice_qp),
                                    int(getattr(self.hdr,
                                                "cabac_init_flag", 0)))
            self._pbc = pbc
        return pbc

    def _code_ctu_p(self, x0, y0):
        """Quadtree walk: whole-CTB skip probe first, then 32/16 CUs."""
        self._set_ctu_qp(x0, y0)
        if self._try_skip64(x0, y0):
            return
        self._split_to_16(x0, y0, self.sps.log2_ctb, 0)

    def _split_to_16(self, x0, y0, log2, depth):
        sps = self.sps
        size = 1 << log2
        if log2 == 5 and x0 + 32 <= sps.width and y0 + 32 <= sps.height \
                and self.use32 is not None \
                and self.use32[y0 >> 5, x0 >> 5]:
            mi = self.mi32[y0 >> 5][x0 >> 5]
            self._code_inter_cu(x0, y0, 5, depth, mi,
                                int(self.sad32[y0 >> 5, x0 >> 5]), None)
            return
        if log2 > 4:
            h = size >> 1
            for dx, dy in ((0, 0), (h, 0), (0, h), (h, h)):
                x1, y1 = x0 + dx, y0 + dy
                if x1 < sps.width and y1 < sps.height:
                    self._split_to_16(x1, y1, log2 - 1, depth + 1)
            return
        self._code_cu_p(x0, y0, log2, depth)

    # ---------------------------------------------------------------- CU
    def _code_cu_p(self, x0, y0, log2, depth):
        by, bx = y0 >> 4, x0 >> 4
        sps = self.sps
        if self.split16[by, bx] and x0 + 16 <= sps.width \
                and y0 + 16 <= sps.height:
            for dx, dy in ((0, 0), (8, 0), (0, 8), (8, 8)):
                b8y, b8x = (y0 + dy) >> 3, (x0 + dx) >> 3
                mi, sad = self._block_mi8(b8y, b8x)
                self._code_inter_cu(x0 + dx, y0 + dy, 3, depth + 1, mi,
                                    sad, int(self.mode8[b8y, b8x]))
            return
        mi, inter_sad = self._block_mi(by, bx)
        intra_mode = int(self.mode16[by, bx])
        if getattr(self, "partitions", 0) and log2 == 4 \
                and int(getattr(self.hdr, "temporal_id", 0)) <= 1:
            # deep-B frames (high QP cascade) quantize away the prediction
            # gain while still paying the PU header bits — measured net
            # negative there, so rectangular PUs stay on ref-ish layers
            part, pu_mis = self._choose_partition(x0, y0, mi, inter_sad)
            if part:
                self._code_inter_cu_part(x0, y0, log2, depth, part,
                                         pu_mis)
                return
        self._code_inter_cu(x0, y0, log2, depth, mi, inter_sad, intra_mode)

    # --------------------------------------- rectangular partitions (PUs)
    def _pu_pred(self, xp, yp, nw, nh, mi):
        """Luma prediction block for one PU candidate (uni or bi)."""
        pw, ph = self.sps.width, self.sps.height
        preds = []
        for l in range(2):
            if mi.ref_idx[l] < 0:
                continue
            ref = np.asarray(self.ref_lists[l][mi.ref_idx[l]].fs.y)
            preds.append(interp_luma(ref, xp, yp, nw, nh, mi.mv[l][0],
                                     mi.mv[l][1], pw, ph))
        if len(preds) == 2:
            return np.clip((preds[0] + preds[1] + 64) >> 7, 0, 255)
        return np.clip((preds[0] + 32) >> 6, 0, 255)

    def _choose_partition(self, x0, y0, mi2n, sad2n):
        """2NxN / Nx2N probe (the -partitions ladder flag,
        qy265enc.h InterPartMode): per PU, candidate motion comes from
        the covering 8-blocks' field winners plus the 2Nx2N motion; the
        partition wins when its summed PU SAD beats 2Nx2N by more than
        the extra PU header cost."""
        src = self.src_y
        best_part, best_mis = 0, None
        best_cost = sad2n + self.lam_satd * 4.0
        shapes = [(1, ((x0, y0, 16, 8), (x0, y0 + 8, 16, 8))),
                  (2, ((x0, y0, 8, 16), (x0 + 8, y0, 8, 16)))]
        if int(getattr(self, "partitions", 0)) >= 2:
            # AMP (asymmetric motion partitions, the placebo tier)
            shapes += [(p, tuple(amp_pu_geometry(x0, y0, 16, p)))
                       for p in (4, 5, 6, 7)]
        for part, pus in shapes:
            tot = 0.0
            mis = []
            for (xp, yp, nw, nh) in pus:
                cands = [mi2n]
                for (bx8, by8) in ((xp >> 3, yp >> 3),
                                   (max(xp + nw - 8, 0) >> 3,
                                    max(yp + nh - 8, 0) >> 3)):
                    c, _ = self._block_mi8(by8, bx8)
                    cands.append(c)
                bsad, bmi = None, None
                for c in cands:
                    p = self._pu_pred(xp, yp, nw, nh, c)
                    sad = int(np.abs(
                        src[yp:yp + nh, xp:xp + nw] - p).sum())
                    if bsad is None or sad < bsad:
                        bsad, bmi = sad, c
                tot += bsad
                mis.append(bmi)
            cost = tot + self.lam_satd * 14.0   # extra PU + part bins
            if cost < best_cost:
                best_part, best_mis, best_cost = part, mis, cost
        return best_part, best_mis

    def _code_inter_cu_part(self, x0, y0, log2, depth, part, pu_mis):
        """Code a 2NxN / Nx2N inter CU: per-PU merge-or-AMVP, MC, then
        the IMPLICIT depth-0 TU split (four quadrant TUs, spec 7.3.8.8 —
        mirrored by map_writer._write_inter_cu_part)."""
        fs, syn = self.fs, self.syn
        size = 1 << log2
        b4 = size >> 2
        x4, y4 = x0 >> 2, y0 >> 2
        fs.cu_depth[y4:y4 + b4, x4:x4 + b4] = depth
        fs.qp[y4:y4 + b4, x4:x4 + b4] = self.qp
        for g in (fs.cu_edge_v, fs.tu_edge_v):
            g[y4:y4 + b4, x4] = True
        for g in (fs.cu_edge_h, fs.tu_edge_h):
            g[y4, x4:x4 + b4] = True
        fs.skip[y4:y4 + b4, x4:x4 + b4] = False
        syn.part[y4:y4 + b4, x4:x4 + b4] = part
        h = size >> 1
        # implicit TU split: internal TU edges for deblocking
        fs.tu_edge_v[y4:y4 + b4, x4 + (b4 >> 1)] = True
        fs.tu_edge_h[y4 + (b4 >> 1), x4:x4 + b4] = True
        pus = amp_pu_geometry(x0, y0, size, part)
        src = self.src_y
        for pidx, (xp, yp, nw, nh) in enumerate(pus):
            px4, py4 = xp >> 2, yp >> 2
            fs.pu_edge_v[py4:py4 + (nh >> 2), px4] = True
            fs.pu_edge_h[py4, px4:px4 + (nw >> 2)] = True
            mi = pu_mis[pidx]
            # merge evaluation with decoder-identical candidates
            cands = self.md.merge_candidates(x0, y0, size, xp, yp, nw, nh,
                                             pidx, part)
            best_i, best_cost, best_c = -1, float("inf"), None
            seen = set()
            for i, c in enumerate(cands):
                key = tuple((l, c.ref_idx[l], tuple(c.mv[l]))
                            for l in range(2) if c.ref_idx[l] >= 0)
                if not key or key in seen:
                    continue
                seen.add(key)
                p = self._pu_pred(xp, yp, nw, nh, c)
                sad = int(np.abs(src[yp:yp + nh, xp:xp + nw] - p).sum())
                cost = sad + self.lam_satd \
                    * self._bitcounter().merge_idx_bits(
                        i, int(self.hdr.max_num_merge_cand))
                if cost < best_cost:
                    best_i, best_cost, best_c = i, cost, c
            used = [l for l in range(2) if mi.ref_idx[l] >= 0]
            mvds, mvp_flags = {}, {}
            for l in used:
                amvp = self.md.amvp_candidates(x0, y0, size, xp, yp, nw,
                                               nh, pidx, l, mi.ref_idx[l])
                d0 = [mi.mv[l][0] - amvp[0][0], mi.mv[l][1] - amvp[0][1]]
                d1 = [mi.mv[l][0] - amvp[1][0], mi.mv[l][1] - amvp[1][1]]
                f = 0 if (abs(d0[0]) + abs(d0[1])
                          <= abs(d1[0]) + abs(d1[1])) else 1
                mvp_flags[l] = f
                mvds[l] = d0 if f == 0 else d1
            nrf = [int(self.hdr.num_ref_idx[l]) if self.hdr.num_ref_idx
                   else 1 for l in range(2)]
            me_bits = self._bitcounter().amvp_bits(
                used, mi.ref_idx, mvds, mvp_flags, nrf,
                self.hdr.slice_type == 0)
            p = self._pu_pred(xp, yp, nw, nh, mi)
            me_cost = int(np.abs(src[yp:yp + nh, xp:xp + nw] - p).sum()) \
                + self.lam_satd * me_bits
            if best_c is not None and best_cost <= me_cost:
                mi = best_c
                syn.merge_flag[py4:py4 + (nh >> 2),
                               px4:px4 + (nw >> 2)] = 1
                syn.merge_idx[py4:py4 + (nh >> 2),
                              px4:px4 + (nw >> 2)] = best_i
            else:
                syn.merge_flag[py4:py4 + (nh >> 2),
                               px4:px4 + (nw >> 2)] = 0
                used = [l for l in range(2) if mi.ref_idx[l] >= 0]
                inter_dir = 2 if len(used) == 2 else used[0]
                syn.inter_dir[py4:py4 + (nh >> 2),
                              px4:px4 + (nw >> 2)] = inter_dir
                for l in used:
                    (syn.ref0 if l == 0 else syn.ref1)[
                        py4:py4 + (nh >> 2), px4:px4 + (nw >> 2)] = \
                        mi.ref_idx[l]
                    mvd_map = syn.mvd0 if l == 0 else syn.mvd1
                    mvd_map[py4:py4 + (nh >> 2), px4:px4 + (nw >> 2),
                            0] = mvds[l][0]
                    mvd_map[py4:py4 + (nh >> 2), px4:px4 + (nw >> 2),
                            1] = mvds[l][1]
                    (syn.mvp0 if l == 0 else syn.mvp1)[
                        py4:py4 + (nh >> 2), px4:px4 + (nw >> 2)] = \
                        mvp_flags[l]
            self._store_motion_rect(xp, yp, nw, nh, mi)
            motion_compensate(fs, self.hdr, self.ref_lists, xp, yp, nw,
                              nh, mi)
        # residuals: four quadrant TUs (split tree), chroma per child
        self._code_quadrant_tus(x0, y0, log2)
        fs.recon_done[y4:y4 + b4, x4:x4 + b4] = True

    def _code_quadrant_tus(self, x0, y0, log2):
        """Quantize + store + reconstruct the four child TUs of a
        split inter transform tree (prediction already in fs
        planes)."""
        fs, syn = self.fs, self.syn
        src = self.src_y
        size = 1 << log2
        q = size >> 1
        c_log2 = log2 - 1
        for (dx, dy) in ((0, 0), (q, 0), (0, q), (q, q)):
            xq, yq = x0 + dx, y0 + dy
            q4x, q4y = xq >> 2, yq >> 2
            qb4 = q >> 2
            ry = src[yq:yq + q, xq:xq + q] \
                - fs.y[yq:yq + q, xq:xq + q]
            cyq = self._transform_quant_inter(ry, c_log2, self.qp)
            csz = q >> 1
            cxq, cyq0 = xq >> 1, yq >> 1
            rcb = self.src_cb[cyq0:cyq0 + csz, cxq:cxq + csz] \
                - fs.cb[cyq0:cyq0 + csz, cxq:cxq + csz]
            rcr = self.src_cr[cyq0:cyq0 + csz, cxq:cxq + csz] \
                - fs.cr[cyq0:cyq0 + csz, cxq:cxq + csz]
            ccbq = self._transform_quant_inter(rcb, c_log2 - 1,
                                               self.qp_cb)
            ccrq = self._transform_quant_inter(rcr, c_log2 - 1,
                                               self.qp_cr)
            syn.cy[yq:yq + q, xq:xq + q] = cyq
            syn.ccb[cyq0:cyq0 + csz, cxq:cxq + csz] = ccbq
            syn.ccr[cyq0:cyq0 + csz, cxq:cxq + csz] = ccrq
            fs.cbf_luma[q4y:q4y + qb4, q4x:q4x + qb4] = bool(cyq.any())
            syn.cbf_cb[q4y:q4y + qb4, q4x:q4x + qb4] = int(ccbq.any())
            syn.cbf_cr[q4y:q4y + qb4, q4x:q4x + qb4] = int(ccrq.any())
            fs.tu_edge_v[q4y:q4y + qb4, q4x] = True
            fs.tu_edge_h[q4y, q4x:q4x + qb4] = True
            if cyq.any():
                r = self._recon_residual(cyq, c_log2, self.qp)
                fs.y[yq:yq + q, xq:xq + q] = np.clip(
                    fs.y[yq:yq + q, xq:xq + q] + r, 0, 255)
            if ccbq.any():
                r = self._recon_residual(ccbq, c_log2 - 1, self.qp_cb)
                fs.cb[cyq0:cyq0 + csz, cxq:cxq + csz] = np.clip(
                    fs.cb[cyq0:cyq0 + csz, cxq:cxq + csz] + r, 0, 255)
            if ccrq.any():
                r = self._recon_residual(ccrq, c_log2 - 1, self.qp_cr)
                fs.cr[cyq0:cyq0 + csz, cxq:cxq + csz] = np.clip(
                    fs.cr[cyq0:cyq0 + csz, cxq:cxq + csz] + r, 0, 255)

    def _code_inter_cu(self, x0, y0, log2, depth, mi, inter_sad,
                       intra_mode):
        fs = self.fs
        size = 1 << log2
        b4 = size >> 2
        x4, y4 = x0 >> 2, y0 >> 2
        fs.cu_depth[y4:y4 + b4, x4:x4 + b4] = depth
        fs.qp[y4:y4 + b4, x4:x4 + b4] = self.qp
        for g in (fs.cu_edge_v, fs.pu_edge_v, fs.tu_edge_v):
            g[y4:y4 + b4, x4] = True
        for g in (fs.cu_edge_h, fs.pu_edge_h, fs.tu_edge_h):
            g[y4, x4:x4 + b4] = True
        src = self.src_y[y0:y0 + size, x0:x0 + size]
        # merge candidates (decoder-identical derivation): SAD narrows the
        # field, then the finalists are judged by rough-RD — real
        # transform+quant of the actual MC residual, closed-form CABAC-bit
        # estimate (the reference's CBitCounterRough tier for inter md) —
        # in the same D + lambda*R units as the batched intra decision.
        cands = self.md.merge_candidates(x0, y0, size, x0, y0, size, size,
                                         0, 0)
        best_merge, merge_sad = -1, float("inf")
        seen = set()
        for i, c in enumerate(cands):
            key = tuple((l, c.ref_idx[l], tuple(c.mv[l]))
                        for l in range(2) if c.ref_idx[l] >= 0)
            if not key or key in seen:
                continue
            seen.add(key)
            motion_compensate(fs, self.hdr, self.ref_lists, x0, y0, size,
                              size, c)
            sad = int(np.abs(src - fs.y[y0:y0 + size,
                                        x0:x0 + size]).sum()) \
                + self.lam_satd * self._bitcounter().merge_idx_bits(
                    i, int(self.hdr.max_num_merge_cand))
            if sad < merge_sad:
                best_merge, merge_sad = i, sad
        merge_cost = float("inf")
        if best_merge >= 0:
            motion_compensate(fs, self.hdr, self.ref_lists, x0, y0, size,
                              size, cands[best_merge])
            D, bits = self._rough_inter_cost(x0, y0, log2)
            merge_cost = D + self.lam * (
                bits + self._bitcounter().merge_idx_bits(
                    best_merge, int(self.hdr.max_num_merge_cand)))
        # ME/AMVP candidate: true mvd against the derived predictors
        used = [l for l in range(2) if mi.ref_idx[l] >= 0]
        mvds, mvp_flags = {}, {}
        for l in used:
            amvp = self.md.amvp_candidates(x0, y0, size, x0, y0, size, size,
                                           0, l, mi.ref_idx[l])
            d0 = [mi.mv[l][0] - amvp[0][0], mi.mv[l][1] - amvp[0][1]]
            d1 = [mi.mv[l][0] - amvp[1][0], mi.mv[l][1] - amvp[1][1]]
            f = 0 if (abs(d0[0]) + abs(d0[1])
                      <= abs(d1[0]) + abs(d1[1])) else 1
            mvp_flags[l] = f
            mvds[l] = d0 if f == 0 else d1
        nrf = [int(self.hdr.num_ref_idx[l]) if self.hdr.num_ref_idx
               else 1 for l in range(2)]
        me_bits = self._bitcounter().amvp_bits(
            used, mi.ref_idx, mvds, mvp_flags, nrf,
            self.hdr.slice_type == 0, depth)
        me_cost = float("inf")
        me_same_as_merge = (best_merge >= 0 and used and all(
            cands[best_merge].ref_idx[l] == mi.ref_idx[l]
            and (mi.ref_idx[l] < 0
                 or cands[best_merge].mv[l] == mi.mv[l])
            for l in range(2)))
        if used and not me_same_as_merge:
            motion_compensate(fs, self.hdr, self.ref_lists, x0, y0, size,
                              size, mi)
            D, bits = self._rough_inter_cost(x0, y0, log2)
            me_cost = D + self.lam * (bits + me_bits)
        intra_cost = float("inf")
        if intra_mode is not None:
            # the batched decision pass already rough-RD-costed this block
            # as intra (same units); +pred_mode/part overhead
            imap = self.icost8 if log2 == 3 else self.icost16
            intra_cost = (float(imap[y0 >> log2, x0 >> log2])
                          + self.lam * 1.5)
        if intra_cost < min(merge_cost, me_cost):
            fs.skip[y4:y4 + b4, x4:x4 + b4] = False
            cmode = (int(self.cmode8[y0 >> 3, x0 >> 3]) if log2 == 3
                     else int(self.cmode16[y0 >> 4, x0 >> 4]))
            self._code_cu(x0, y0, log2, depth, intra_mode, cmode)
            return
        merge_idx = -1
        if merge_cost <= me_cost:
            merge_idx = best_merge
            mi = cands[best_merge]
            used = [l for l in range(2) if mi.ref_idx[l] >= 0]
        else:
            # the ME motion may still coincide with a merge candidate
            for i, c in enumerate(cands):
                if c.ref_idx == mi.ref_idx and \
                        all(c.mv[l] == mi.mv[l] for l in used):
                    merge_idx = i
                    break
        # adapt the Precise counter's states with the CHOSEN syntax so
        # later CUs are costed against evolved contexts (coding order)
        if merge_idx >= 0:
            self._bitcounter().merge_idx_bits(
                merge_idx, int(self.hdr.max_num_merge_cand), update=True)
        elif used:
            nrf = [int(self.hdr.num_ref_idx[l]) if self.hdr.num_ref_idx
                   else 1 for l in range(2)]
            self._bitcounter().amvp_bits(
                used, mi.ref_idx, mvds, mvp_flags, nrf,
                self.hdr.slice_type == 0, depth, update=True)
        syn = self.syn
        # --- inter: predict via MC, residual decision
        self._store_motion(x0, y0, size, mi)
        motion_compensate(fs, self.hdr, self.ref_lists, x0, y0, size, size,
                          mi)
        coeff_y, coeff_cb, coeff_cr = self._inter_residuals(x0, y0, log2)
        cbf_any = bool(coeff_y.any() or coeff_cb.any() or coeff_cr.any())
        if cbf_any:
            # zero-forcing: drop the residual when its distortion gain is
            # not worth its (estimated) rate — legal for merge (-> SKIP)
            # and for AMVP (-> rqt_root_cbf 0); tuDecisionSkipMerge analog
            ry = self._recon_residual(coeff_y, log2, self.qp) \
                if coeff_y.any() else 0
            rec = np.clip(fs.y[y0:y0 + size, x0:x0 + size] + ry, 0, 255)
            d_coded = float(np.sum((src - rec).astype(np.int64) ** 2))
            d_skip = float(np.sum(
                (src - fs.y[y0:y0 + size, x0:x0 + size])
                .astype(np.int64) ** 2))
            bits_est = 10.0
            for cf in (coeff_y, coeff_cb, coeff_cr):
                a = np.abs(cf[cf != 0]).astype(np.float64)
                if a.size:
                    bits_est += 3.1 * a.size + 2.0 * np.log2(a).sum()
            if d_skip - d_coded <= self.lam * bits_est:
                coeff_y = np.zeros_like(coeff_y)
                coeff_cb = np.zeros_like(coeff_cb)
                coeff_cr = np.zeros_like(coeff_cr)
                cbf_any = False
        if merge_idx >= 0 and not cbf_any:
            # SKIP CU
            fs.skip[y4:y4 + b4, x4:x4 + b4] = True
            syn.merge_flag[y4:y4 + b4, x4:x4 + b4] = 1
            syn.merge_idx[y4:y4 + b4, x4:x4 + b4] = merge_idx
            fs.cbf_luma[y4:y4 + b4, x4:x4 + b4] = False
            fs.recon_done[y4:y4 + b4, x4:x4 + b4] = True
            return
        fs.skip[y4:y4 + b4, x4:x4 + b4] = False
        if merge_idx >= 0:
            syn.merge_flag[y4:y4 + b4, x4:x4 + b4] = 1
            syn.merge_idx[y4:y4 + b4, x4:x4 + b4] = merge_idx
        else:
            syn.merge_flag[y4:y4 + b4, x4:x4 + b4] = 0
            inter_dir = 2 if len(used) == 2 else used[0]
            syn.inter_dir[y4:y4 + b4, x4:x4 + b4] = inter_dir
            for l in used:
                (syn.ref0 if l == 0 else syn.ref1)[y4:y4 + b4,
                                                   x4:x4 + b4] = \
                    mi.ref_idx[l]
                mvd_map = syn.mvd0 if l == 0 else syn.mvd1
                mvd_map[y4:y4 + b4, x4:x4 + b4, 0] = mvds[l][0]
                mvd_map[y4:y4 + b4, x4:x4 + b4, 1] = mvds[l][1]
                (syn.mvp0 if l == 0 else syn.mvp1)[y4:y4 + b4,
                                                   x4:x4 + b4] = mvp_flags[l]
        cbf_y = int(coeff_y.any())
        cbf_cb = int(coeff_cb.any())
        cbf_cr = int(coeff_cr.any())
        if not cbf_any and merge_idx < 0:
            fs.cbf_luma[y4:y4 + b4, x4:x4 + b4] = False
            fs.recon_done[y4:y4 + b4, x4:x4 + b4] = True
            return
        if (cbf_any and log2 == 4 and merge_idx < 0
                and getattr(self, "inter_tu_depth", 0) > 0):
            # TU-split search (-intertu, the reference's inter TU
            # decision): rough-RD of one 16 TU vs four 8 TUs. Non-merge
            # only: a merge CU whose split children all quantize to zero
            # would need rqt_root_cbf=0, which 2Nx2N merge cannot code
            src16 = self.src_y[y0:y0 + size, x0:x0 + size]
            ry16 = src16 - fs.y[y0:y0 + size, x0:x0 + size]
            D1, b1 = self._rough_resi_cost(ry16, self.qp, log2)
            D2 = b2 = 0.0
            h2 = size >> 1
            for (dx, dy) in ((0, 0), (h2, 0), (0, h2), (h2, h2)):
                Dq, bq = self._rough_resi_cost(
                    ry16[dy:dy + h2, dx:dx + h2], self.qp, log2 - 1)
                D2 += Dq
                b2 += bq
            if D2 + self.lam * (b2 + 6.0) < D1 + self.lam * b1:
                syn.tu_split[y4:y4 + b4, x4:x4 + b4] = 1
                self._code_quadrant_tus(x0, y0, log2)
                fs.recon_done[y4:y4 + b4, x4:x4 + b4] = True
                return
        csz = size >> 1
        cx0, cy0 = x0 >> 1, y0 >> 1
        syn.cy[y0:y0 + size, x0:x0 + size] = coeff_y
        syn.ccb[cy0:cy0 + csz, cx0:cx0 + csz] = coeff_cb
        syn.ccr[cy0:cy0 + csz, cx0:cx0 + csz] = coeff_cr
        syn.cbf_cb[y4:y4 + b4, x4:x4 + b4] = cbf_cb
        syn.cbf_cr[y4:y4 + b4, x4:x4 + b4] = cbf_cr
        self._recon_inter(x0, y0, log2, coeff_y if cbf_y else None,
                          coeff_cb if cbf_cb else None,
                          coeff_cr if cbf_cr else None)
        fs.cbf_luma[y4:y4 + b4, x4:x4 + b4] = bool(cbf_y)
        fs.recon_done[y4:y4 + b4, x4:x4 + b4] = True

    # ------------------------------------------------------------ helpers
    def _block_mi(self, by, bx):
        """(MotionInfo, cost) of this block's chosen prediction."""
        mi = MotionInfo()
        mi.ref_idx[0] = int(self.ref16[by, bx])
        mi.mv[0] = [int(self.mv16[by, bx, 0]), int(self.mv16[by, bx, 1])]
        return mi, int(self.sad16[by, bx])

    def _block_mi8(self, by, bx):
        mi = MotionInfo()
        mi.ref_idx[0] = int(self.ref8[by, bx])
        mi.mv[0] = [int(self.mv8[by, bx, 0]), int(self.mv8[by, bx, 1])]
        return mi, int(self.sad8[by, bx])

    def _rough_resi_cost(self, resi, qp, lg):
        """(D_pix, bits) of one residual block at qp/log2 (inter
        deadzone quant, coefficient-domain SSE, closed-form bits)."""
        c = fwd(np.asarray(resi, np.int32), lg, False)
        qbits = 29 + qp // 6 - 8 - lg
        rnd = 85 << (qbits - 9)
        a = np.abs(c).astype(np.int64)
        lev = np.minimum((a * QUANT_SCALE[qp % 6] + rnd) >> qbits, 32767)
        sshift = 8 + lg - 5
        per = qp // 6
        tv = lev * (16 * LEVEL_SCALE[qp % 6])
        sp = max(sshift - per, 0)
        ps = max(per - sshift, 0)
        drnd = (1 << (sshift - per - 1)) if sshift - per >= 1 else 0
        deq = np.clip((tv + drnd) >> sp << ps, 0, 1 << 30)
        derr = (a - deq).astype(np.float64)
        D = float((derr * derr).sum()) * 4.0 ** (lg - 7)
        nz = lev > 0
        bits = 0.0
        if nz.any():
            bits = float(3.1 * nz.sum()
                         + 2.0 * np.log2(np.maximum(lev[nz], 1)).sum())
        return D, bits

    def _rough_inter_cost(self, x0, y0, log2):
        """Rough-RD of coding the CURRENT fs prediction's residual at this
        CU (luma + chroma): real fwd transform + inter deadzone quant,
        dequantized coefficient-domain SSE as pixel distortion (Parseval),
        closed-form bit estimate — the host twin of ops/decide's
        _rough_tu_cost."""
        fs = self.fs
        size = 1 << log2
        csz = size >> 1
        cx0, cy0 = x0 >> 1, y0 >> 1
        D = 0.0
        bits = 0.0
        for resi, qp, lg in (
                (self.src_y[y0:y0 + size, x0:x0 + size]
                 - fs.y[y0:y0 + size, x0:x0 + size], self.qp, log2),
                (self.src_cb[cy0:cy0 + csz, cx0:cx0 + csz]
                 - fs.cb[cy0:cy0 + csz, cx0:cx0 + csz], self.qp_cb,
                 log2 - 1),
                (self.src_cr[cy0:cy0 + csz, cx0:cx0 + csz]
                 - fs.cr[cy0:cy0 + csz, cx0:cx0 + csz], self.qp_cr,
                 log2 - 1)):
            c = fwd(np.asarray(resi, np.int32), lg, False)
            qbits = 29 + qp // 6 - 8 - lg
            rnd = 85 << (qbits - 9)
            a = np.abs(c).astype(np.int64)
            lev = np.minimum((a * QUANT_SCALE[qp % 6] + rnd) >> qbits, 32767)
            sshift = 8 + lg - 5
            per = qp // 6
            tv = lev * (16 * LEVEL_SCALE[qp % 6])
            sp = max(sshift - per, 0)
            ps = max(per - sshift, 0)
            drnd = (1 << (sshift - per - 1)) if sshift - per >= 1 else 0
            deq = np.clip((tv + drnd) >> sp << ps, 0, 1 << 30)
            derr = (a - deq).astype(np.float64)
            D += float((derr * derr).sum()) * 4.0 ** (lg - 7)
            nz = lev > 0
            if nz.any():
                bits += float(3.1 * nz.sum()
                              + 2.0 * np.log2(np.maximum(lev[nz], 1))
                              .sum())
        return D, bits

    def _store_motion(self, xp, yp, size, mi: MotionInfo):
        self._store_motion_rect(xp, yp, size, size, mi)

    def _store_motion_rect(self, xp, yp, nw, nh, mi: MotionInfo):
        fs = self.fs
        x4, y4 = xp >> 2, yp >> 2
        w4, h4 = nw >> 2, nh >> 2
        fs.pred_mode[y4:y4 + h4, x4:x4 + w4] = MODE_INTER
        for l in range(2):
            ri = mi.ref_idx[l]
            fs.ref_idx[l, y4:y4 + h4, x4:x4 + w4] = ri
            if 0 <= ri < len(self.ref_lists[l]):
                fs.mv[l, y4:y4 + h4, x4:x4 + w4, 0] = mi.mv[l][0]
                fs.mv[l, y4:y4 + h4, x4:x4 + w4, 1] = mi.mv[l][1]
                rp = self.ref_lists[l][ri]
                fs.ref_poc[l, y4:y4 + h4, x4:x4 + w4] = rp.poc
                fs.ref_lt[l, y4:y4 + h4, x4:x4 + w4] = rp.is_long_term
        fs.mi_parsed[y4:y4 + h4, x4:x4 + w4] = True

    def _inter_residuals(self, x0, y0, log2):
        fs = self.fs
        size = 1 << log2
        csz = size >> 1
        cx0, cy0 = x0 >> 1, y0 >> 1
        ry = self.src_y[y0:y0 + size, x0:x0 + size] \
            - fs.y[y0:y0 + size, x0:x0 + size]
        rcb = self.src_cb[cy0:cy0 + csz, cx0:cx0 + csz] \
            - fs.cb[cy0:cy0 + csz, cx0:cx0 + csz]
        rcr = self.src_cr[cy0:cy0 + csz, cx0:cx0 + csz] \
            - fs.cr[cy0:cy0 + csz, cx0:cx0 + csz]
        cy = self._transform_quant_inter(ry, log2, self.qp)
        ccb = self._transform_quant_inter(rcb, log2 - 1, self.qp_cb)
        ccr = self._transform_quant_inter(rcr, log2 - 1, self.qp_cr)
        return cy, ccb, ccr

    def _transform_quant_inter(self, resi, log2, qp):
        c = fwd(np.asarray(resi, np.int32), log2, False)
        qbits = 29 + qp // 6 - 8 - log2
        rnd = 85 << (qbits - 9)      # inter rounding
        a = np.abs(c).astype(np.int64)
        q = np.minimum((a * QUANT_SCALE[qp % 6] + rnd) >> qbits, 32767)
        out = np.where(c < 0, -q, q).astype(np.int32)
        if self.pps.sign_data_hiding_enabled:
            out = apply_sbh_np(out, 0)     # inter TUs always diag scan
        return out

    def _recon_inter(self, x0, y0, log2, cy, ccb, ccr):
        fs = self.fs
        size = 1 << log2
        csz = size >> 1
        cx0, cy0 = x0 >> 1, y0 >> 1
        if cy is not None:
            r = self._recon_residual(cy, log2, self.qp)
            fs.y[y0:y0 + size, x0:x0 + size] = np.clip(
                fs.y[y0:y0 + size, x0:x0 + size] + r, 0, 255)
        if ccb is not None:
            r = self._recon_residual(ccb, log2 - 1, self.qp_cb)
            fs.cb[cy0:cy0 + csz, cx0:cx0 + csz] = np.clip(
                fs.cb[cy0:cy0 + csz, cx0:cx0 + csz] + r, 0, 255)
        if ccr is not None:
            r = self._recon_residual(ccr, log2 - 1, self.qp_cr)
            fs.cr[cy0:cy0 + csz, cx0:cx0 + csz] = np.clip(
                fs.cr[cy0:cy0 + csz, cx0:cx0 + csz] + r, 0, 255)


class BFrameEncoder(PFrameEncoder):
    """Codes one B picture (single slice): the device engine over L0 and
    L1 (its `is_b` branches), or the host walk with the motion search of
    L0[0] and L1[0], the bi-prediction cost and each block's direction
    (uni from either list, or bi)."""

    def _pre_analyze(self) -> None:
        """Intra analysis (K5), the motion search of every 16x16 and 8x8
        block against L0[0] and L1[0] (K20, K21), the bi-prediction cost
        of both winners (K21) and each block's direction; then the split16
        and 32x32 decisions. The direction compares float64 costs on the
        host, as the reference does."""
        self._apply_lam_scale()
        self._decide_intra()
        kw = self._dev_kw()
        ref0 = np.asarray(self.ref_lists[0][0].fs.y)
        ref1 = np.asarray(self.ref_lists[1][0].fs.y)
        merange = int(getattr(self, "merange", 12))
        poc = int(getattr(self.hdr, "poc", 0))

        def search(ref, rp, bs, lam):
            dist = abs(poc - int(rp.poc))
            if merange > 16 and (dist > 2 or int(getattr(
                    self, "me_method", 1)) >= 2):
                return tme.motion_search_frame_hier(self.src_y, ref, bs,
                                                    merange, lam, **kw)
            return tme.motion_search_frame(self.src_y, ref, bs,
                                           min(merange, 16), lam, **kw)

        mv0, c0, s0 = search(ref0, self.ref_lists[0][0], 16, self.lam_satd)
        mv1, c1, s1 = search(ref1, self.ref_lists[1][0], 16, self.lam_satd)
        mv0_8, _, s0_8 = search(ref0, self.ref_lists[0][0], 8,
                                0.5 * self.lam_satd)
        mv1_8, _, s1_8 = search(ref1, self.ref_lists[1][0], 8,
                                0.5 * self.lam_satd)
        pw, ph = self.sps.width, self.sps.height
        if self.subme:
            mv0, s0 = refine_subpel_frame(self.src_y, ref0, mv0 >> 2, 16,
                                          pw, ph,
                                          mv_pred_q=mv_pred_field(mv0),
                                          lam=self.lam_satd, **kw)
            mv1, s1 = refine_subpel_frame(self.src_y, ref1, mv1 >> 2, 16,
                                          pw, ph,
                                          mv_pred_q=mv_pred_field(mv1),
                                          lam=self.lam_satd, **kw)
            mv0_8, s0_8 = refine_subpel_frame(self.src_y, ref0, mv0_8 >> 2,
                                              8, pw, ph,
                                              mv_pred_q=mv_pred_field(mv0_8),
                                              lam=0.5 * self.lam_satd, **kw)
            mv1_8, s1_8 = refine_subpel_frame(self.src_y, ref1, mv1_8 >> 2,
                                              8, pw, ph,
                                              mv_pred_q=mv_pred_field(mv1_8),
                                              lam=0.5 * self.lam_satd, **kw)
            sbi = bi_pred_cost(self.src_y, ref0, ref1, mv0, mv1, 16, pw, ph,
                               **kw)
            bi_bias = self.lam_satd * 8          # extra mvd/refidx bits
            best_uni = np.minimum(s0, s1)
            self.dir16 = np.where(sbi + bi_bias < best_uni, 2,
                                  (s1 < s0).astype(np.int8)).astype(np.int8)
            self.sad16 = np.minimum(best_uni, sbi + bi_bias)
            # bi at 8x8 too (2Nx2N 8x8 PUs may be bi in HEVC; only 8x4 /
            # 4x8 are restricted)
            sbi8 = bi_pred_cost(self.src_y, ref0, ref1, mv0_8, mv1_8, 8,
                                pw, ph, **kw)
            bi_bias8 = 0.5 * self.lam_satd * 8
            best_uni8 = np.minimum(s0_8, s1_8)
            self.dir8 = np.where(
                sbi8 + bi_bias8 < best_uni8, 2,
                (s1_8 < s0_8).astype(np.int8)).astype(np.int8)
            self.sad8 = np.minimum(best_uni8, sbi8 + bi_bias8)
        else:
            self.dir16 = (c1 < c0).astype(np.int8)
            self.sad16 = np.where(self.dir16 == 1, s1, s0)
            self.dir8 = (s1_8 < s0_8).astype(np.int8)
            self.sad8 = np.where(self.dir8 == 1, s1_8, s0_8)
        self.mv0q, self.mv1q = mv0, mv1
        self.mv0q8, self.mv1q8 = mv0_8, mv1_8
        self.frame_cplx = float(self.sad16.sum())
        self._decide_split16()
        self._decide_cu32()

    def _block_mi(self, by, bx):
        mi = MotionInfo()
        d = int(self.dir16[by, bx])
        if d in (0, 2):
            mi.ref_idx[0] = 0
            mi.mv[0] = [int(self.mv0q[by, bx, 0]), int(self.mv0q[by, bx, 1])]
        if d in (1, 2):
            mi.ref_idx[1] = 0
            mi.mv[1] = [int(self.mv1q[by, bx, 0]), int(self.mv1q[by, bx, 1])]
        return mi, int(self.sad16[by, bx])

    def _block_mi8(self, by, bx):
        mi = MotionInfo()
        d = int(self.dir8[by, bx])
        if d in (0, 2):
            mi.ref_idx[0] = 0
            mi.mv[0] = [int(self.mv0q8[by, bx, 0]),
                        int(self.mv0q8[by, bx, 1])]
        if d in (1, 2):
            mi.ref_idx[1] = 0
            mi.mv[1] = [int(self.mv1q8[by, bx, 0]),
                        int(self.mv1q8[by, bx, 1])]
        return mi, int(self.sad8[by, bx])
