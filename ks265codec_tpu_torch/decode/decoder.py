"""Decoder top: NAL dispatch, parameter-set activation, POC derivation,
DPB + POC-ordered output, per-frame decode orchestration.

The port's rewrite of ks265codec_tpu/decode/decoder.py, keeping its names.
Everything but the device methods is the reference's code. The intra fast
path (`_materialize_fast`) runs on the port's kernels: the parse-only walk
fills the decision maps and dense level planes, then
  1. ops/wavefront.py   reconstruction from the parsed levels (K11),
  2. ops/deblock.py     deblocking with the parsed bS and QP maps (K7),
  3. ops/saoapply.py    SAO with the parsed per-CTB parameters (K9),
on the decoder's device; the planes stay there until a consumer reads them.
The inter fast path (`_materialize_fast_inter`) reconstructs a parsed P
or B picture the same way through K18 (decode/interfast.py,
ops/wavefront.py::recon_inter_filter: K14 MC from one or both lists,
with the slice's explicit weights, the inter TUs' residual, K11 over the
intra CUs, K7, K9; under cu_qp_delta the parse's effective QPs). Pictures
outside the fast paths' coverage take the scalar walk and the host
filters (decode/filters.py), except on the card: there no picture is
decoded on the host. An I, P or B picture outside the fast paths'
geometry, any picture whose fast parse aborts on syntax outside them
(NxN, a TU split, a PU under 8x8) and every slice after a picture's first
raise NotImplementedError naming what is missing. Unlike the reference,
each CRA's RASL pictures follow its own NoRaslOutputFlag
(`_compute_poc`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device

from ..bitstream.nal import (NalType, is_idr, is_irap, is_rasl, is_vcl,
                             parse_nals)
from ..hevc.params import PPS, SPS, parse_pps, parse_sps, parse_vps
from ..hevc.slicehdr import I_SLICE, SliceHeader, parse_slice_header
from ..utils.yuv import YUVFrame
from .filters import deblock_frame, sao_frame
from .slice_dec import FrameState, SliceDecoder


@dataclass
class RefPic:
    """A picture in the DPB."""
    fs: FrameState
    poc: int
    used_for_ref: bool = True
    is_long_term: bool = False
    needed_for_output: bool = True


class _HostView:
    """A device plane as FrameState.ensure_planes reads it: np.asarray
    fetches it to the host."""

    def __init__(self, t: torch.Tensor):
        self.t = t

    def __array__(self, dtype=None, copy=None):
        a = self.t.cpu().numpy()
        return a if dtype is None else a.astype(dtype)


def _sao_arrays(fs, sps):
    """The parsed per-CTB SAO parameters as (type, offs, bpos, eocl) int8
    arrays (3, ncty, nctx[, 4])."""
    ncty, nctx = sps.pic_height_in_ctbs, sps.pic_width_in_ctbs
    type_ = np.zeros((3, ncty, nctx), np.int8)
    offs_ = np.zeros((3, ncty, nctx, 4), np.int8)
    bpos_ = np.zeros((3, ncty, nctx), np.int8)
    eocl_ = np.zeros((3, ncty, nctx), np.int8)
    for ry in range(ncty):
        for rx in range(nctx):
            p = fs.sao[ry][rx]
            for c in range(3):
                type_[c, ry, rx] = p.type_idx[c]
                offs_[c, ry, rx] = p.offsets[c]
                bpos_[c, ry, rx] = p.band_pos[c]
                eocl_[c, ry, rx] = p.eo_class[c]
    return type_, offs_, bpos_, eocl_


class DecodeError(Exception):
    """Maps to QY_BITSTREAM_ERROR-style recoverable failures."""


class HevcDecoder:
    """QY265Decoder-shaped API: feed annex-B data, pull decoded frames.

    Mirrors the contract of qy265dec.h (QY265DecodeFrame /
    QY265DecoderGetDecodedFrame / QY265DecodeFlush): decode() accepts any
    chunk of annex-B bytes (whole stream or per-AU), get_frame() returns
    POC-ordered frames, flush() drains.
    """

    def __init__(self, threads: int = 0, skip_mode: bool = False,
                 device=None, reference: bool = False):
        # device: CUDA unless the caller names another device (the plain
        # PyTorch versions run on the CPU); reference=True runs the plain
        # versions of the kernels on that device
        self.device = resolve_device(device)
        self.reference = bool(reference)
        self.fast_pictures = 0       # pictures reconstructed AND filtered
        #                              on the device path
        # threads: 0/auto and >1 keep the decode PIPELINE (the batched
        # recon dispatch runs asynchronously while the host parses the
        # next picture; output planes fetch lazily); 1 forces fully
        # synchronous single-threaded decode (recon materializes before
        # the next picture parses) — the ST/MT strategy split of
        # CDecTaskManage{ST,MT} mapped onto the dataflow pipeline.
        self.threads = int(threads)
        self.vps_map: dict[int, object] = {}
        self.sps_map: dict[int, SPS] = {}
        self.pps_map: dict[int, PPS] = {}
        from ..utils.pool import FramePool
        self.frame_pool = FramePool()
        self.dpb: list[RefPic] = []
        self.out_queue: list[RefPic] = []
        self.cur: FrameState | None = None
        self.cur_hdr: SliceHeader | None = None
        self.cur_slice_idx = 0
        self.prev_tid0_poc = 0
        self.first_pic = True
        self.skip_mode = skip_mode
        self.frames_out: list[YUVFrame] = []
        self.md5_log: list[str] = []
        self.illegal_stream = False      # qy265dec.h:35 bIllegalStream
        self.sei_messages = []
        self._pending_hash = None
        self.hash_mismatches = 0         # decoded_picture_hash failures

    # ------------------------------------------------------------- public
    def decode(self, data: bytes) -> list[YUVFrame]:
        """Decode a chunk of annex-B bytes; returns frames ready for output."""
        for nal in parse_nals(data):
            self._decode_nal(nal)
        return self._drain_ready()

    def flush(self) -> list[YUVFrame]:
        """End of stream: finish current picture and output everything."""
        self._finish_current_picture()
        out = list(self.frames_out)
        self.frames_out.clear()
        pend = sorted(self.out_queue, key=lambda r: r.poc)
        self.out_queue.clear()
        for rp in pend:
            out.append(self._wrap_output(rp))
            self._release_if_dead(rp)
        return out

    def decode_all(self, data: bytes) -> list[YUVFrame]:
        return self.decode(data) + self.flush()

    def dump_vui_parameters(self, sps_id: int = 0) -> str:
        """QY265DumpVUIParameters analog (qy265dec.h:85): human-readable
        dump of the active SPS's VUI fields; empty string when the SPS
        (or its VUI) is absent."""
        sps = self.sps_map.get(sps_id)
        if sps is None or getattr(sps, "vui", None) is None:
            return ""
        v = sps.vui
        lines = [f"VUI (sps {sps_id}):"]
        if v.aspect_ratio_idc:
            lines.append(f"  aspect_ratio_idc {v.aspect_ratio_idc}"
                         f" sar {v.sar_width}x{v.sar_height}")
        if v.video_signal_type_present:
            lines.append(f"  video_format {v.video_format}"
                         f" full_range {v.video_full_range_flag}")
        if v.colour_description_present:
            lines.append(f"  primaries {v.colour_primaries}"
                         f" transfer {v.transfer_characteristics}"
                         f" matrix {v.matrix_coeffs}")
        if v.timing_info_present and v.num_units_in_tick:
            lines.append(f"  timing {v.time_scale}/{v.num_units_in_tick}"
                         f" ({v.time_scale / v.num_units_in_tick:.3f} fps)")
        lines.append(f"  frame_field_info {v.frame_field_info_present}")
        return "\n".join(lines)

    # ------------------------------------------------------------ internal
    def _decode_nal(self, nal) -> None:
        t = nal.nal_type
        if t in (NalType.VPS, NalType.SPS, NalType.PPS):
            # corrupt parameter sets must not sink the stream: log, flag,
            # and keep searching (QY_BITSTREAM_ERROR semantics,
            # qy265def.h:15-20)
            try:
                if t == NalType.VPS:
                    v = parse_vps(nal.rbsp)
                    self.vps_map[v.vps_id] = v
                elif t == NalType.SPS:
                    s = parse_sps(nal.rbsp)
                    self.sps_map[s.sps_id] = s
                else:
                    p = parse_pps(nal.rbsp)
                    self.pps_map[p.pps_id] = p
            except Exception as ex:
                from ..utils.log import log
                log(2, "parameter set parse error (%s: %s); skipping NAL"
                    % (type(ex).__name__, ex))
                self.illegal_stream = True
        elif t in (NalType.PREFIX_SEI, NalType.SUFFIX_SEI):
            from ..hevc.sei import parse_sei_rbsp
            try:
                msgs = parse_sei_rbsp(nal.rbsp)
            except Exception:
                msgs = []
            self.sei_messages.extend(msgs)
            for m in msgs:
                if m.payload_type == 132 and m.md5:
                    # decoded_picture_hash: verify once the current picture
                    # finishes (post-filter recon)
                    self._pending_hash = m.md5
        elif t in (NalType.AUD, NalType.FD, NalType.EOS, NalType.EOB):
            pass
        elif is_vcl(t):
            # RASL pictures associated with a CRA that OPENED the stream
            # (NoRaslOutputFlag = 1) reference pictures from before the
            # access point and must be discarded (spec 8.1); the flag
            # clears at the first non-RASL picture after that CRA, and
            # each later CRA clears it (`_compute_poc`)
            if is_rasl(t):
                if getattr(self, "_discard_rasl", False):
                    return
            elif getattr(self, "_discard_rasl", False) \
                    and t != NalType.CRA_NUT:
                self._discard_rasl = False
            self._decode_slice_nal(nal)

    def _decode_slice_nal(self, nal) -> None:
        try:
            hdr, sps, pps, reader = parse_slice_header(
                nal.rbsp, nal.nal_type, nal.temporal_id, self.sps_map,
                self.pps_map)
        except (KeyError, IndexError, AssertionError, ValueError):
            # undecodable slice (missing/garbled parameter sets): skip and
            # keep searching for an access point — the reference's
            # QY_SEARCHING_ACCESS_POINT behavior (qy265def.h:15-20)
            return
        if hdr.dependent_slice_segment:
            # inherit the whole header body from the preceding segment
            # (7.3.6.1); CABAC ctx + qPY_PREV continue (9.3.1); same
            # slice region id (availability crosses segment boundaries)
            prev = getattr(self, "_seg_state", None)
            if prev is None or self.cur is None:
                return      # orphan dependent segment: skip
            ihdr, ref_lists, ctx_end, qp_end, sidx = prev
            self._no_host_walk("a dependent slice segment")
            # dependent segments share the slice region: their prediction
            # may reference the first segment's pixels — materialize the
            # batched fast path's reconstruction first
            self._materialize_fast()
            for f in ("slice_type", "slice_qp", "sao_luma", "sao_chroma",
                      "num_ref_idx", "cb_qp_offset", "cr_qp_offset",
                      "deblocking_filter_disabled", "beta_offset_div2",
                      "tc_offset_div2", "loop_filter_across_slices",
                      "max_num_merge_cand", "temporal_mvp_enabled",
                      "collocated_from_l0", "collocated_ref_idx",
                      "cabac_init_flag", "poc", "mvd_l1_zero",
                      "luma_log2_weight_denom",
                      "chroma_log2_weight_denom", "weights"):
                setattr(hdr, f, getattr(ihdr, f))
            if self.skip_mode:
                return
            sd = SliceDecoder(self.cur, sps, pps, hdr, nal.rbsp,
                              reader.pos // 8, sidx, ref_lists,
                              epb_pos=nal.epb_pos, init_ctx=ctx_end,
                              qp_prev=qp_end)
            try:
                sd.decode()
            except Exception as ex:
                from ..utils.log import log
                log(2, "dependent segment decode error (%s: %s); "
                    "concealing" % (type(ex).__name__, ex))
                self.illegal_stream = True
                self._conceal(self.cur, ref_lists)
                return
            self._seg_state = (ihdr, ref_lists, bytes(sd.cabac.ctx),
                               sd.qp_cur, sidx)
            return
        poc = self._compute_poc(hdr, sps)
        hdr.poc = poc
        if hdr.first_slice_in_pic:
            self._finish_current_picture()
            self._start_picture(hdr, sps)
        assert self.cur is not None
        if self.skip_mode:
            return
        ref_lists = self._build_ref_lists(hdr, sps)
        if not hdr.first_slice_in_pic:
            # a further slice joins the picture: the batched fast path is
            # per-slice-causal only — materialize what was parsed so far;
            # the slice itself takes the scalar walk, which the card's
            # decoder does not run
            self._no_host_walk("a picture's second or later slice")
            self._materialize_fast(sps, pps)
        if hdr.first_slice_in_pic and self._fast_eligible(sps, pps, hdr):
            # snapshot the scan-ahead parse state: an aborted attempt
            # leaves recon_done/slice_id marks on cells AHEAD of the
            # redo's walk, which would corrupt its availability checks.
            # INVARIANT: the snapshot is deliberately PARTIAL. The
            # aborted parse also dirtied fs.qp/intra_mode/cu_depth/
            # cbf_luma/fs.sao and the dec_coef_* planes; that is safe
            # only because (a) the scalar redo re-parses the whole slice
            # and rewrites every cell the fast parse touched, and (b)
            # _fast_pending stays None on abort so the dirty coefficient
            # planes are never materialized. Any change that materializes
            # despite an abort, or lets the redo skip cells, must widen
            # this snapshot.
            fs0 = self.cur
            snap = (fs0.recon_done.copy(), fs0.mi_parsed.copy(),
                    fs0.slice_id.copy())
            sd = SliceDecoder(self.cur, sps, pps, hdr, nal.rbsp,
                              reader.pos // 8, self.cur_slice_idx,
                              ref_lists, epb_pos=nal.epb_pos,
                              parse_only=True)
            try:
                sd.decode()
                self._fast_pending = (sps, pps, hdr, ref_lists)
                self._seg_state = (hdr, ref_lists, bytes(sd.cabac.ctx),
                                   sd.qp_cur, self.cur_slice_idx)
                self.cur_slice_idx += 1
                return
            except Exception as ex:
                # outside fast-path coverage (or corrupt): redo this slice
                # with the interleaved scalar path from the same bits,
                # except an abort on the card (_check_fast_abort)
                from ..utils.log import log
                from .slice_dec import FastPathAbort
                self._check_fast_abort(hdr, ex)
                lvl = -1 if isinstance(ex, FastPathAbort) else 0
                log(lvl, "decode fast path off for slice (%s: %s)"
                    % (type(ex).__name__, ex))
                self._fast_pending = None
                fs0.recon_done[:] = snap[0]
                fs0.mi_parsed[:] = snap[1]
                fs0.slice_id[:] = snap[2]
        sd = SliceDecoder(self.cur, sps, pps, hdr, nal.rbsp,
                          reader.pos // 8, self.cur_slice_idx, ref_lists,
                          epb_pos=nal.epb_pos)
        try:
            sd.decode()
        except Exception as ex:
            # mid-slice parse failure (truncated/corrupt payload): conceal
            # the un-reconstructed area and keep decoding — the reference
            # logs, conceals, and continues (handleFrameError analog,
            # qy265dec.h bIllegalStream semantics / SURVEY.md 4.9)
            from ..utils.log import log
            log(2, "slice decode error (%s: %s); concealing"
                % (type(ex).__name__, ex))
            self.illegal_stream = True
            self._conceal(self.cur, ref_lists)
            self.cur_slice_idx += 1
            self._seg_state = None
            return
        # continuation state for a possible dependent segment that follows
        self._seg_state = (hdr, ref_lists, bytes(sd.cabac.ctx),
                           sd.qp_cur, self.cur_slice_idx)
        self.cur_slice_idx += 1

    @staticmethod
    def _conceal(fs: FrameState, ref_lists) -> None:
        """Fill cells never reconstructed: copy from the first L0 reference
        (zero-motion concealment) or mid-grey when no reference exists."""
        import numpy as np
        missing = ~fs.recon_done
        if not missing.any():
            return
        ref = ref_lists[0][0].fs if ref_lists and ref_lists[0] else None
        if ref is not None:
            ref.ensure_planes()
        m_y = np.repeat(np.repeat(missing, 4, 0), 4, 1)
        m_c = m_y[::2, ::2]
        for plane, src, m in (
                (fs.y, ref.y if ref else None, m_y),
                (fs.cb, ref.cb if ref else None, m_c),
                (fs.cr, ref.cr if ref else None, m_c)):
            plane[m] = src[m] if src is not None else 128
        fs.recon_done[missing] = True

    # ---------------------------------------------------------------- POC
    def _compute_poc(self, hdr: SliceHeader, sps: SPS) -> int:
        if hdr.is_idr:
            poc = 0
        else:
            max_lsb = sps.max_poc_lsb
            prev = self.prev_tid0_poc
            prev_lsb = prev & (max_lsb - 1)
            prev_msb = prev - prev_lsb
            lsb = hdr.pic_order_cnt_lsb
            no_rasl_out = is_irap(hdr.nal_type) and self.first_pic
            if hdr.nal_type == NalType.CRA_NUT and hdr.first_slice_in_pic:
                # each CRA's NoRaslOutputFlag decides its own RASL
                # pictures (spec 8.1): discarded after the CRA that opens
                # the stream, decoded and output after any later CRA
                self._discard_rasl = no_rasl_out
            if no_rasl_out:
                msb = 0
                poc = lsb
            else:
                if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
                    msb = prev_msb + max_lsb
                elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
                    msb = prev_msb - max_lsb
                else:
                    msb = prev_msb
                poc = msb + lsb
        if hdr.temporal_id == 0 and not is_rasl(hdr.nal_type):
            self.prev_tid0_poc = poc
        self.first_pic = False
        return poc

    # ----------------------------------------------------------- pictures
    def _start_picture(self, hdr: SliceHeader, sps: SPS) -> None:
        if hdr.is_idr:
            # IDR: all prior pics unused for reference
            for rp in self.dpb:
                rp.used_for_ref = False
            self._bump_all()
        else:
            self._apply_rps(hdr, sps)
        fs = self.frame_pool.acquire(sps)
        fs.poc = hdr.poc
        self.cur = fs
        self.cur_hdr = hdr
        self.cur_slice_idx = 0

    def _apply_rps(self, hdr: SliceHeader, sps: SPS) -> None:
        """Mark DPB pics per the active RPS (spec 8.3.2 simplified: short-term
        + long-term by POC)."""
        if hdr.st_rps is None:
            return
        keep_pocs = set(hdr.poc + d for d in hdr.st_rps.delta_pocs)
        lt_pocs = set()
        for i in range(hdr.num_lt_pics):
            lsb = hdr.lt_poc[i]
            if hdr.lt_msb_present[i]:
                msb_cycles = hdr.lt_delta_poc_msb[i]
                poc_lt = (hdr.poc - ((hdr.poc & (sps.max_poc_lsb - 1)) - lsb)
                          - msb_cycles * sps.max_poc_lsb)
            else:
                # match by lsb
                poc_lt = None
                for rp in self.dpb:
                    if (rp.poc & (sps.max_poc_lsb - 1)) == lsb:
                        poc_lt = rp.poc
                        break
            if poc_lt is not None:
                lt_pocs.add(poc_lt)
        for rp in self.dpb:
            if rp.poc in lt_pocs:
                rp.used_for_ref = True
                rp.is_long_term = True
            elif rp.poc in keep_pocs:
                rp.used_for_ref = True
            else:
                rp.used_for_ref = False

    def _build_ref_lists(self, hdr: SliceHeader, sps: SPS):
        """Reference list construction (spec 8.3.4)."""
        if hdr.slice_type == I_SLICE or hdr.st_rps is None:
            return [[], []]
        by_poc = {rp.poc: rp for rp in self.dpb}
        st_before, st_after, lt = [], [], []
        rps = hdr.st_rps
        for i in range(rps.num_negative):
            if rps.used[i]:
                p = hdr.poc + rps.delta_pocs[i]
                if p in by_poc:
                    st_before.append(by_poc[p])
        for i in range(rps.num_positive):
            if rps.used[rps.num_negative + i]:
                p = hdr.poc + rps.delta_pocs[rps.num_negative + i]
                if p in by_poc:
                    st_after.append(by_poc[p])
        for i in range(hdr.num_lt_pics):
            if hdr.lt_used[i]:
                for rp in self.dpb:
                    if (rp.poc & (sps.max_poc_lsb - 1)) == hdr.lt_poc[i]:
                        lt.append(rp)
                        break
        tmp0 = st_before + st_after + lt
        tmp1 = st_after + st_before + lt
        l0 = [tmp0[i % len(tmp0)] for i in range(hdr.num_ref_idx[0])] if tmp0 else []
        l1 = [tmp1[i % len(tmp1)] for i in range(hdr.num_ref_idx[1])] if tmp1 else []
        if hdr.ref_list_modification:
            if hdr.ref_list_modification[0]:
                l0 = [tmp0[i] for i in hdr.ref_list_modification[0]]
            if hdr.ref_list_modification[1]:
                l1 = [tmp1[i] for i in hdr.ref_list_modification[1]]
        return [l0, l1]

    def _no_host_walk(self, what: str) -> None:
        """Slices that only the scalar walk decodes (a picture's later
        slices and dependent segments) raise NotImplementedError on any
        device but the CPU: the card's decoder decodes no picture on the
        host."""
        if self.device.type != "cpu":
            raise NotImplementedError(
                "%s on the card (slice 10); HevcDecoder(device='cpu') "
                "decodes it with the scalar walk" % what)

    def _check_fast_abort(self, hdr, ex) -> None:
        """A slice whose fast parse aborted on syntax outside the fast
        paths (NxN, an intra or inter TU split, a PU under 8x8) raises
        NotImplementedError naming it on any device but the CPU: the card's
        decoder decodes no picture on the host. The CPU decoder takes the
        scalar walk."""
        from .slice_dec import FastPathAbort
        if isinstance(ex, FastPathAbort) and self.device.type != "cpu":
            raise NotImplementedError(
                "%s in %s picture on the card (slice 8); "
                "HevcDecoder(device='cpu') decodes it with the scalar walk"
                % (ex, "an I" if hdr.slice_type == I_SLICE else "a P/B")
            ) from ex

    def _fast_eligible(self, sps, pps, hdr) -> bool:
        """Batched-recon fast path coverage: TU == CU intra TUs (the SPS
        may allow one intra split level, as the port's and the reference's
        streams with the intra TU-split flag do: a TU that really splits
        aborts in the parse) with the standard 64/8 CTB geometry, no
        PCM/scaling/TS/bypass/CIP. Syntax outside coverage aborts per-CU
        (`_check_fast_abort`). Without the native host library the coder
        raises RuntimeError, as the encoder's does: the fast path is the
        device path. A slice outside the fast paths' coverage (for P and B
        slices also tiles and quantization groups under 16 samples) raises
        NotImplementedError naming the gaps on any device but the CPU,
        whose decoder takes the scalar walk: the card's decoder decodes no
        picture on the host."""
        if getattr(self, "_wf_coder", None) is None:
            from ..ops.wavefront import WavefrontIntraCoder
            self._wf_coder = WavefrontIntraCoder()
        intra = hdr.slice_type == I_SLICE
        kind = "I pictures" if intra else "P/B pictures"
        gaps = [name for bad, name in (
            (sps.max_transform_hierarchy_depth_intra > 1,
             "more than one intra TU split level"),
            (sps.log2_ctb != 6 or sps.log2_min_cb != 3
             or sps.log2_max_tb != 5,
             "CTB, CU or TB sizes other than 64, 8 and 32"),
            (sps.bit_depth_luma != 8, "a bit depth other than 8"),
            (sps.pcm_enabled, "PCM"),
            (sps.scaling_list_enabled or pps.scaling_list_data_present,
             "scaling lists"),
            (pps.transform_skip_enabled, "transform skip"),
            (pps.transquant_bypass_enabled, "transquant bypass"),
            (pps.constrained_intra_pred, "constrained intra prediction"))
            if bad]
        if not intra:
            # P/B coverage (the reference's gates): single-tile pictures;
            # the chroma residual reads one QP per 4x4 chroma tile, so
            # quantization groups must be >= 16 luma samples. PU/TU shapes
            # outside the fast path abort per slice during the parse.
            gaps += [name for bad, name in (
                (pps.tiles_enabled, "tiles"),
                (pps.cu_qp_delta_enabled
                 and sps.log2_ctb - pps.diff_cu_qp_delta_depth < 4,
                 "quantization groups < 16")) if bad]
        if gaps and self.device.type != "cpu":
            raise NotImplementedError(
                "; ".join(g + " in " + kind for g in gaps) + " on the card "
                "(slice 8); HevcDecoder(device='cpu') decodes them with the "
                "scalar walk")
        return not gaps

    def _materialize_fast(self, sps=None, pps=None,
                          final: bool = False) -> None:
        """Run the batched wavefront reconstruction (K11) for a parse-only
        picture, in place of the per-TU host loop. With final=True (whole
        picture was fast) deblocking (K7) and SAO (K9) follow on the
        device and the planes stay there until a consumer reads them."""
        pend = getattr(self, "_fast_pending", None)
        if pend is None or self.cur is None:
            return
        self._fast_pending = None
        fs = self.cur
        sps, pps, hdr, ref_lists = pend
        if hdr.slice_type != I_SLICE:
            self._materialize_fast_inter(fs, sps, pps, hdr, ref_lists, final)
            return
        from ..ops.wavefront import recon_intra_frames
        from ..utils.trace import stage
        dev = self.device
        # cells never parsed (multi-slice pictures, CTB padding) default to
        # 8x8/DC placeholders: they compute throwaway pixels that later
        # slices overwrite, and scan-order causality keeps them out of the
        # parsed region's reference samples
        parsed8 = fs.mi_parsed[::2, ::2]
        log2m8 = np.where(
            parsed8,
            sps.log2_ctb - fs.cu_depth[::2, ::2].astype(np.int32),
            3).astype(np.uint8)
        modes8 = np.where(parsed8, fs.intra_mode[::2, ::2],
                          1).astype(np.int32)
        qp_map8 = np.clip(fs.qp[::2, ::2], 0, 51).astype(np.int32)
        tile8 = None
        if pps.tiles_enabled:
            from ..hevc.params import TileGrid
            tg = getattr(pps, "_tile_grid", None) or TileGrid(pps, sps)
            tile8 = np.repeat(np.repeat(
                tg.tile_of_ctb.astype(np.int32), 8, 0), 8, 1)[
                    :fs.ph >> 3, :fs.pw >> 3]
        cbo = pps.cb_qp_offset + hdr.cb_qp_offset
        cro = pps.cr_qp_offset + hdr.cr_qp_offset
        deblock_ok = (final and bool(pps.loop_filter_across_tiles)
                      and bool(hdr.loop_filter_across_slices
                               if hasattr(hdr, "loop_filter_across_slices")
                               else True))
        with stage("dec.recon"):
            sched = self._wf_coder.pack(
                [dict(log2m=log2m8, modes8=modes8, cmodes8=fs.dec_cmode8,
                      qp_map8=qp_map8, tile8=tile8)], cbo, cro, sps)
            # the levels are copied to the device: the parse planes belong
            # to the FrameState, which the pool recycles
            levels = [torch.tensor(np.asarray(a, np.int16))[None].to(dev)
                      for a in (fs.dec_coef_y, fs.dec_coef_cb,
                                fs.dec_coef_cr)]
            planes = recon_intra_frames(*levels, sched,
                                        bool(sps.strong_intra_smoothing),
                                        reference=self.reference)
        if not deblock_ok:
            ry, rcb, rcr = (p[0].cpu().numpy() for p in planes)
            fs.y[:] = ry
            fs.cb[:] = rcb
            fs.cr[:] = rcr
            return
        if not hdr.deblocking_filter_disabled:
            from ..ops.deblock import deblock_frames
            from .filters import compute_bs
            with stage("dec.deblock"):
                maps = [torch.from_numpy(np.asarray(m, np.uint8)[None])
                        .to(dev) for m in (compute_bs(fs, True),
                                           compute_bs(fs, False),
                                           np.clip(fs.qp, 0, 51))]
                # recon chroma QPs take the PPS + slice offsets,
                # deblocking the PPS offsets only (ref ops/wavefront.py
                # recon_filter_frame)
                planes = deblock_frames(
                    *planes, *maps, hdr.beta_offset_div2,
                    hdr.tc_offset_div2, pps.cb_qp_offset, pps.cr_qp_offset,
                    sps.width, sps.height, reference=self.reference)
        if hdr.sao_luma or hdr.sao_chroma:
            from ..ops.saoapply import sao_apply_frames
            prm = [torch.from_numpy(a[None]).to(dev)
                   for a in _sao_arrays(fs, sps)]
            # luma always, as the reference's fast path does (a slice with
            # sao_luma off parses type 0 for luma)
            with stage("dec.sao"):
                planes = sao_apply_frames(
                    *planes, *prm, True, bool(hdr.sao_chroma), sps.width,
                    sps.height, sps.ctb_size, reference=self.reference)
        fs.attach_device_planes([_HostView(p[0]) for p in planes])
        fs._fast_filtered = True
        self.fast_pictures += 1
        if self.threads == 1:
            fs.ensure_planes()     # ST strategy: no pipeline overlap

    def _materialize_fast_inter(self, fs, sps, pps, hdr, ref_lists,
                                final: bool) -> None:
        """P/B twin of _materialize_fast: K18 on the decoder's device. With
        the whole picture fast-parsed (final) the filters run there too
        and the planes stay on the device; a partial picture (another
        slice joins) reconstructs without in-loop filters and lands in the
        host planes for the scalar continuation."""
        from .interfast import recon_inter_picture
        deblock_ok = final and bool(
            hdr.loop_filter_across_slices
            if hasattr(hdr, "loop_filter_across_slices") else True)
        if deblock_ok:
            sao_params = (_sao_arrays(fs, sps)
                          if hdr.sao_luma or hdr.sao_chroma else None)
            planes = recon_inter_picture(self._wf_coder, fs, sps, pps, hdr,
                                         ref_lists, sao_params, self.device,
                                         self.reference)
            fs.attach_device_planes([_HostView(p) for p in planes])
            fs._fast_filtered = True
            self.fast_pictures += 1
            if self.threads == 1:
                fs.ensure_planes()     # ST strategy: no pipeline overlap
            return
        import copy
        hdr_nf = copy.copy(hdr)
        hdr_nf.sao_luma = 0
        hdr_nf.sao_chroma = 0
        hdr_nf.deblocking_filter_disabled = 1
        planes = recon_inter_picture(self._wf_coder, fs, sps, pps, hdr_nf,
                                     ref_lists, None, self.device,
                                     self.reference)
        fs.y[:], fs.cb[:], fs.cr[:] = (p.cpu().numpy() for p in planes)

    def _finish_current_picture(self) -> None:
        if self.cur is None:
            return
        fs, hdr = self.cur, self.cur_hdr
        self._materialize_fast(final=True)
        # in-loop filters at frame level (fast-path pictures filtered on
        # device inside the recon dispatch)
        if not getattr(fs, "_fast_filtered", False):
            deblock_frame(fs, hdr.beta_offset_div2, hdr.tc_offset_div2,
                          bool(hdr.deblocking_filter_disabled),
                          self.pps_map[hdr.pps_id].cb_qp_offset,
                          self.pps_map[hdr.pps_id].cr_qp_offset)
            sao_frame(fs, bool(hdr.sao_luma), bool(hdr.sao_chroma))
        if self._pending_hash is not None:
            from ..hevc.sei import plane_md5
            want = self._pending_hash
            self._pending_hash = None
            got = tuple(plane_md5(p) for p in
                        (lambda f: (f.y, f.u, f.v))(self._wrap_output(
                            RefPic(fs, fs.poc))))
            if got != tuple(want):
                self.hash_mismatches += 1
                from ..utils.log import log
                log(1, "decoded_picture_hash mismatch at POC %d" % fs.poc)
        rp = RefPic(fs, fs.poc, needed_for_output=bool(hdr.pic_output_flag))
        self.dpb.append(rp)
        self.out_queue.append(rp)
        self.cur = None
        self.cur_hdr = None
        # bumping (spec C.5.2.2): emit in POC order once more than
        # num_reorder_pics are waiting — at picture granularity so the DPB
        # never holds output-blocked pictures hostage
        reorder = fs.sps.num_reorder_pics[-1]
        self.out_queue.sort(key=lambda r: r.poc)
        while len(self.out_queue) > reorder:
            rp0 = self.out_queue.pop(0)
            self.frames_out.append(self._wrap_output(rp0))
            self._release_if_dead(rp0)
        self._cleanup_dpb(fs.sps)

    def _cleanup_dpb(self, sps: SPS) -> None:
        # a picture leaves the DPB only when it is no longer used for
        # reference AND already output (never evict live refs)
        dead = [rp for rp in self.dpb
                if not (rp.used_for_ref or rp in self.out_queue)]
        self.dpb = [rp for rp in self.dpb
                    if rp.used_for_ref or rp in self.out_queue]
        for rp in dead:
            self._release_if_dead(rp)

    def _release_if_dead(self, rp: RefPic) -> None:
        """Recycle a picture's storage once nothing references it (left
        both the DPB and the output queue, and is not mid-decode)."""
        if rp in self.dpb or rp in self.out_queue:
            return
        if self.cur is rp.fs:
            return
        self.frame_pool.release(rp.fs)

    def _bump_all(self) -> None:
        self.out_queue.sort(key=lambda r: r.poc)
        pend = self.out_queue[:]
        self.out_queue.clear()
        for rp in pend:
            self.frames_out.append(self._wrap_output(rp))
            self._release_if_dead(rp)

    def _drain_ready(self) -> list[YUVFrame]:
        """Output pictures per the bumping rule (num_reorder_pics)."""
        out = list(self.frames_out)
        self.frames_out.clear()
        if self.cur is not None or not self.out_queue:
            pass
        sps = next(iter(self.sps_map.values())) if self.sps_map else None
        if sps is None:
            return out
        reorder = sps.num_reorder_pics[-1]
        self.out_queue.sort(key=lambda r: r.poc)
        while len(self.out_queue) > reorder:
            rp0 = self.out_queue.pop(0)
            out.append(self._wrap_output(rp0))
            self._release_if_dead(rp0)
        return out

    def _wrap_output(self, rp: RefPic) -> YUVFrame:
        rp.fs.ensure_planes()     # fast-path recon is device-resident
        sps = rp.fs.sps
        l, r, t, b = sps.conf_win
        # conformance window offsets are in chroma units for 4:2:0
        x0, x1 = 2 * l, sps.width - 2 * r
        y0, y1 = 2 * t, sps.height - 2 * b
        y = rp.fs.y[y0:y1, x0:x1].astype(np.uint8)
        cb = rp.fs.cb[y0 // 2:y1 // 2, x0 // 2:x1 // 2].astype(np.uint8)
        cr = rp.fs.cr[y0 // 2:y1 // 2, x0 // 2:x1 // 2].astype(np.uint8)
        return YUVFrame(y, cb, cr, poc=rp.poc)
