"""HEVC encoder on the port's device path: the entry point of
ks265codec_tpu_torch.

Same configuration (`EncoderConfig`), the same `encode_frame` / `flush`
contract and the same `EncodedFrame` as ks265codec_tpu/encode/encoder.py,
for the configurations the port covers (`unsupported` lists the rest):
fixed QP, the decision tiers (effort 0, and 1 for any nonzero effort, as
in the reference), RDOQ and sign-bit hiding, and either all-intra
(`intra_period=1`, SAO at any tier: every preset from ultrafast to
placebo) or inter coding (SAO at any tier): low-delay P (zerolatency or
`bframes == 0`) or the hierarchical B GOPs (GOP-8 at `bframes=7`,
offline; GOP-4 at `livestreaming`/`netvideo`, whose bframes is 3), with
one reference per list on the device inter engine (ultrafast to slow, so
the default `EncoderConfig`, medium) and any number of L0 references on
the per-CU host walk (slower, veryslow, placebo: partitions, the inter
TU split). Where the reference would take its host walk for intra pictures
(`host_only`: inter streams, AQ, CU-tree) its NxN decision tier runs on
the IDRs and all-intra AQ batches, and the SPS raises
max_transform_hierarchy_depth_intra with `intra_tu_depth`, as the
reference does; every CU is still coded 2Nx2N with TU == CU.

With `aq_mode` or `cutree` the PPS enables cu_qp_delta (quantization
group = CTB): the lookahead's per-CTB offsets (K12 with the 8x8
variance; CU-tree propagation) set the QP of every CU of every picture,
the deblocking filter reads the decoder's effective QPs (K17's chain in
P and B pictures, the host walk `map_writer.apply_effective_qp` in intra
ones), and the slice writer gets them from that host walk; with CU-tree
an inter stream's drain waits for the lookahead window. With `weightp`
each P slice fits explicit weights on the host (`decide_weightp`, its
reference's luma fetched from the device) and K17's MC applies them.

Inter streams follow the reference's `_drain` inter branches and the
inter branch of `_encode_picture`: every frame is pushed to the lookahead
(K12, ops/lookahead.py), whose scene cuts turn a picture into an IDR; an
IDR goes through the all-intra kernels below as a one-frame batch and
its device reconstruction enters the device DPB directly. Low delay codes
one P picture per step with the previous picture as its reference and the
+3/+2/+3/+1 QP cascade. The B GOPs wait until a GOP's frames are queued,
let b-adapt (the median of the lookahead's pcost/icost over the GOP)
keep the pyramid, cut it to GOP-4 or code plain P, and code the GOP in
its plan's order (8,4,2,1,3,6,5,7) with each plan entry's RPS, lists, QP
offset and temporal layer; an approaching IDR or scene cut, and the
flush, code the frames left as plain P pictures. Each P or B picture is
coded by the inter engine (encode/inter_engine.py: K5, K13, K15, K17
with K14 and the seeded K6 scan, K7, and with SAO on the device K8 ->
K16 -> K9, whose parameters the slice writes; the host float64 decision
of encode/sao.py is not run for these pictures, as the reference does
not run it there), or, where the engine does not cover the
configuration, by the per-CU host walk (encode/inter_frame.py: K5, K20,
K21 on the device, the rest on the host), whose reconstruction the host
deblocks, whose SAO the host decides on K22's statistics and applies,
and whose planes the device DPB uploads on first reference use (the
reference's branch without `device_post`).

All-intra follows the reference's batched all-intra path (`_drain`'s
all-intra branch, `_dispatch_intra_batch`, `_collect_intra_batch` and the
IDR branch of `_encode_picture`):
  1. ops/decide.py      decision maps for the batch (K5, the preset's
                        effort),
  2. ops/wavefront.py   the level-scheduled intra coding scan (K6, with
                        RDOQ and sign hiding, K2, where the preset has them),
  3. ops/deblock.py     deblocking of the reconstruction (K7),
  4. ops/saostats.py    per-CTB SAO statistics against the sources (K8),
  5. encode/sao.py      the SAO decision on the host (exact, float64),
  6. ops/saoapply.py    SAO applied to the deblocked batch (K9),
  7. the native CABAC slice writer on the host.
Batches of 16/8/4/2/1 frames; the next batch is dispatched before the
current one is entropy-coded, so the card codes batch N+1 while the host
writes batch N. A one-frame batch goes through the same kernels. The
reconstruction stays on the device until a caller reads
`EncodedFrame.recon`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

from .. import resolve_device
from ..bitstream.nal import NalType, epb_insert_positions, write_nal
from ..decode.slice_dec import FrameState
from ..hevc.params import PPS, SPS, VPS, VUI, ProfileTierLevel, \
    ShortTermRPS, write_pps, write_sps, write_vps
from ..hevc.slicehdr import B_SLICE, I_SLICE, P_SLICE, SliceHeader, \
    write_slice_header
from ..ops.deblock import deblock_frames, intra_bs_maps
from ..ops.decide import decide_frames
from ..ops.saoapply import sao_apply_frames
from ..ops.saostats import sao_stats_frames
from ..ops.wavefront import WavefrontIntraCoder, code_intra_frames
from ..utils.log import log
from ..utils.pool import FramePool
from ..utils.trace import stage
from ..utils.yuv import LazyYUV, YUVFrame
from .config import RC_FIXQP, EncoderConfig, resolve_preset, tile_dims
from .intra_frame import IntraFrameEncoder, decision_maps8, pad_plane, \
    qp_map8, tile_region_maps
from .map_writer import write_slice_data
from .sao import decide_from_stats_arrays, params_from_arrays


@dataclass
class EncodedFrame:
    """One output AU: annex-B bytes + reconstruction + stats."""
    data: bytes
    recon: YUVFrame
    poc: int
    qp: int
    bits: int
    slice_type: str = "I"
    psnr: tuple[float, float, float] | None = None
    ssim: tuple[float, float, float] | None = None
    display_idx: int = -1
    pts: int = 0
    dts: int = 0
    temporal_id: int = 0


def decide_weightp(src_y, ref_lumas):
    """Explicit weighted prediction of a P slice, the reference's
    `decide_weightp`: per L0 reference a least-squares (gain, offset) fit
    of the source luma against the reference's on 4x-subsampled planes,
    kept only when it is clearly non-identity and lowers the plain SAD by
    more than 3%. ref_lumas: each L0 reference's luma plane on the host
    (the port keeps reconstructions on the device, so the caller fetches
    them). Returns per reference [luma, cb, cr] PredWeight triples (chroma
    identity), or None when every reference is identity."""
    from ..hevc.slicehdr import PredWeight
    s = np.asarray(src_y, np.float64)[::4, ::4]
    sh = s.shape
    out = []
    any_flag = False
    for ry in ref_lumas:
        r = np.asarray(ry, np.float64)[:src_y.shape[0],
                                       :src_y.shape[1]][::4, ::4]
        r = r[:sh[0], :sh[1]]
        use, wq, oq = False, 64, 0
        vr = float(r.var())
        if vr > 1e-3:
            cov = float(((s - s.mean()) * (r - r.mean())).mean())
            wr = min(max(cov / vr, 0.25), 2.0)     # |delta_w| <= 127
            wq = int(np.clip(round(wr * 64), 1, 191))
            oq = int(np.clip(round(s.mean() - wq / 64.0 * r.mean()),
                             -128, 127))
            if abs(wq - 64) > 2 or abs(oq) > 3:
                pred = np.clip(r * (wq / 64.0) + oq, 0, 255)
                # a clear win only: motion search runs on the unweighted
                # reference
                if (np.abs(s - pred).sum()
                        < 0.97 * np.abs(s - r).sum()):
                    use = True
        if not use:
            wq, oq = 64, 0
        out.append([PredWeight(1 if use else 0, wq, oq),
                    PredWeight(0, 64, 0), PredWeight(0, 64, 0)])
        any_flag = any_flag or use
    return out if any_flag else None


def host_only(cfg: EncoderConfig) -> bool:
    """Where the reference's intra pictures would take its per-CU host walk
    (inter streams, AQ, CU-tree; PCM is not ported): there it turns on the
    NxN decision tier and the intra TU-split SPS flag. Its wavefront, which
    the port's device scan follows, still codes every intra CU 2Nx2N with
    TU == CU, so the tier only moves split16 and the flag only adds the
    split_transform_flag bins."""
    return cfg.intra_period != 1 or bool(cfg.aq_mode) or bool(cfg.cutree)


def unsupported(cfg: EncoderConfig) -> list[str]:
    """The parts of a resolved configuration this port does not cover yet
    (empty when it covers all of them)."""
    out = []
    inter = cfg.intra_period != 1
    # the reference's host walk codes P and B pictures where the device
    # engine does not cover the configuration (partitions, inter TU
    # split); it handles several L0 references
    walk = inter and (cfg.partitions != 0 or cfg.inter_tu_depth != 0)
    checks = [
        (inter and not walk and cfg.refs > 1,
         "multiple reference pictures (refs > 1) on the device inter "
         "engine"),
        (inter and tile_dims(cfg) != (1, 1), "tiles with inter coding"),
        (inter and bool(cfg.noise_reduction), "noise reduction"),
        (inter and bool(cfg.long_term_ref), "long-term references"),
        (inter and bool(cfg.open_gop), "open GOP (CRA pictures)"),
        (cfg.rc != RC_FIXQP, "rate control other than fixed QP"),
        (cfg.pass_num != 0, "two-pass rate control"),
        (bool(cfg.pcm), "PCM"),
        (cfg.slices > 1, "multiple slices"),
        (not cfg.fpp, "the per-frame path (fpp=False)"),
        (bool(cfg.ssim), "SSIM reporting"),
    ]
    return [what for bad, what in checks if bad]


class HevcEncoder:
    """All-intra encoder on the port's kernels. `device` defaults to CUDA
    (raises when absent); `reference=True` runs the plain PyTorch versions
    of the kernels on that device instead (the reference the kernels are
    held against)."""

    def __init__(self, cfg: EncoderConfig, device=None,
                 reference: bool = False):
        cfg = resolve_preset(cfg)
        missing = unsupported(cfg)
        if missing:
            raise NotImplementedError(
                "ks265codec_tpu_torch does not port yet: " + "; ".join(missing))
        if cfg.width <= 0 or cfg.height <= 0:
            raise ValueError("width and height must be positive")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.reference = bool(reference)
        self.sps = self._make_sps(cfg)
        self.pps = self._make_pps(cfg)
        self.vps = self._make_vps(cfg)
        self.frame_idx = 0
        self.headers_written = False
        self.queue: list[tuple[int, YUVFrame]] = []
        self._pending = None
        self._coded_count = 0
        self._coder = WavefrontIntraCoder()
        self._fs = FrameState(self.sps)
        self._inter = cfg.intra_period != 1
        self.gop_base = 0
        self.dpb: list = []             # encoder-side reference pictures
        self._last_recon = None
        from .devdpb import DeviceDPB
        from .lookahead import Lookahead
        from .rc import RateControl
        self.rc = RateControl(cfg)
        self.la = Lookahead(cfg, self.device, self.reference)
        self.dev_dpb = DeviceDPB(self.device)   # device reference planes
        self.frame_pool = FramePool()           # host FrameState recycling
        if cfg.latency == "offline":
            # batch size scales inversely with pixel count (decide
            # intermediates of the plain version grow with the batch)
            max_b = max(1, (16 * 1280 * 720) // max(cfg.width * cfg.height, 1))
            self._sizes = [b for b in (16, 8, 4, 2, 1) if b <= max_b]
        else:
            self._sizes = [1]      # low-latency modes answer every frame

    # -------------------------------------------------------- parameter sets
    @staticmethod
    def _make_ptl() -> ProfileTierLevel:
        return ProfileTierLevel(
            general_profile_idc=1,
            general_profile_compatibility_flags=1 << 30,
            general_progressive_source_flag=1,
            general_frame_only_constraint_flag=1,
            general_level_idc=120,
        )

    @staticmethod
    def _dpb_params(cfg: EncoderConfig) -> tuple[int, int]:
        """(max_dec_pic_buffering, num_reorder_pics) for the GOP shape:
        low delay or all-intra reorder nothing; a B pyramid reorders as
        deep as its coding order (3 for GOP-8, 2 for GOP-4)."""
        if cfg.latency == "zerolatency" or cfg.bframes == 0 \
                or cfg.intra_period == 1:
            return max(2, int(cfg.refs) + 1), 0
        from .gop import gop_plan, reorder_depth
        return 6, reorder_depth(gop_plan(cfg.latency, cfg.bframes))

    def _make_vps(self, cfg: EncoderConfig) -> VPS:
        v = VPS()
        v.vps_id = 0
        v.ptl = self._make_ptl()
        dpb, reorder = self._dpb_params(cfg)
        v.max_dec_pic_buffering = [dpb]
        v.num_reorder_pics = [reorder]
        v.max_latency_increase = [0]
        return v

    def _make_sps(self, cfg: EncoderConfig) -> SPS:
        s = SPS()
        s.sps_id = 0
        s.vps_id = 0
        s.ptl = self._make_ptl()
        s.chroma_format_idc = 1
        # pad dimensions to the min-CU grid via the conformance window
        align = 16
        s.width = (cfg.width + align - 1) // align * align
        s.height = (cfg.height + align - 1) // align * align
        s.conf_win = (0, (s.width - cfg.width) // 2,
                      0, (s.height - cfg.height) // 2)
        s.bit_depth_luma = s.bit_depth_chroma = 8
        s.log2_max_poc_lsb = 8
        dpb, reorder = self._dpb_params(cfg)
        s.max_dec_pic_buffering = [dpb]
        s.num_reorder_pics = [reorder]
        s.max_latency_increase = [0]
        s.log2_min_cb = 3
        s.log2_ctb = 6
        s.log2_min_tb = 2
        s.log2_max_tb = 5
        s.max_transform_hierarchy_depth_inter = \
            1 if cfg.inter_tu_depth > 0 else 0
        # the reference's rule: raised where its host walk would run,
        # although the device scan codes TU == CU (every flag is 0)
        s.max_transform_hierarchy_depth_intra = \
            1 if (cfg.intra_tu_depth > 0 and host_only(cfg)) else 0
        s.scaling_list_enabled = 0
        s.amp_enabled = 1 if cfg.partitions >= 2 else 0
        s.sao_enabled = 1 if cfg.sao > 0 else 0
        s.pcm_enabled = 0
        s.long_term_ref_pics_present = 1 if cfg.long_term_ref else 0
        s.temporal_mvp_enabled = 1 if cfg.tmvp else 0
        s.strong_intra_smoothing = 1 if cfg.strong_intra_smoothing else 0
        s.st_rps = []
        s.lt_ref_pic_poc_lsb = []
        fr = Fraction(cfg.frame_rate).limit_denominator(1001)
        s.vui = VUI(timing_info_present=1,
                    num_units_in_tick=fr.denominator,
                    time_scale=fr.numerator,
                    frame_field_info_present=1 if cfg.pic_timing_sei
                    else 0)
        return s

    def _make_pps(self, cfg: EncoderConfig) -> PPS:
        p = PPS()
        p.pps_id = 0
        p.sps_id = 0
        p.sign_data_hiding_enabled = 1 if cfg.sign_bit_hiding else 0
        p.cabac_init_present = 0
        p.num_ref_idx_l0_default = 1
        p.num_ref_idx_l1_default = 1
        p.init_qp = 26
        p.constrained_intra_pred = 0
        p.transform_skip_enabled = 1 if cfg.transform_skip else 0
        p.cu_qp_delta_enabled = 1 if (cfg.aq_mode or cfg.cutree) else 0
        p.diff_cu_qp_delta_depth = 0
        p.cb_qp_offset = int(np.clip(cfg.chroma_qp_offset, -12, 12))
        p.cr_qp_offset = int(np.clip(cfg.chroma_qp_offset, -12, 12))
        p.weighted_pred = 1 if cfg.weightp else 0
        p.weighted_bipred = 0
        p.transquant_bypass_enabled = 0
        tc, tr = tile_dims(cfg)
        if tc > 1 or tr > 1:
            p.tiles_enabled = 1
            p.num_tile_columns = tc
            p.num_tile_rows = tr
            p.uniform_spacing = 1
            p.loop_filter_across_tiles = 1
        else:
            p.tiles_enabled = 0
        p.dependent_slice_segments_enabled = 0
        p.entropy_coding_sync_enabled = \
            1 if (cfg.wpp and not p.tiles_enabled) else 0
        p.loop_filter_across_slices = 1
        p.deblocking_filter_control_present = 1
        p.deblocking_filter_override_enabled = 0
        p.deblocking_filter_disabled = 0 if cfg.deblock else 1
        p.beta_offset_div2 = int(np.clip(cfg.deblock_beta, -6, 6))
        p.tc_offset_div2 = int(np.clip(cfg.deblock_tc, -6, 6))
        p.scaling_list_data_present = 0
        p.lists_modification_present = 0
        p.log2_parallel_merge_level = 2
        p.slice_segment_header_extension_present = 0
        return p

    def encode_headers(self) -> bytes:
        """VPS+SPS+PPS(+user-data SEI) annex-B block."""
        out = b""
        out += write_nal(NalType.VPS, write_vps(self.vps))
        out += write_nal(NalType.SPS, write_sps(self.sps))
        out += write_nal(NalType.PPS, write_pps(self.pps))
        from ..hevc.sei import user_data_payload, write_sei_rbsp
        # the same banner as the reference encoder, so streams compare
        info = ("ks265codec_tpu - preset %s tune %s latency %s"
                % (self.cfg.preset, self.cfg.tune,
                   self.cfg.latency)).encode()
        out += write_nal(NalType.PREFIX_SEI,
                         write_sei_rbsp([(5, user_data_payload(info))]))
        self.headers_written = True
        return out

    # --------------------------------------------------------------- frames
    def encode_frame(self, frame: YUVFrame) -> list[EncodedFrame]:
        """Push one input frame; returns 0+ coded pictures in coding order
        (frames wait until a batch is full)."""
        self.queue.append((self.frame_idx, frame))
        if self._inter or self.cfg.aq_mode:
            with stage("la.push"):
                self.la.push(self.frame_idx, np.asarray(frame.y, np.uint8))
        self.frame_idx += 1
        return self._drain(False)

    def flush(self) -> list[EncodedFrame]:
        """Code every queued picture."""
        return self._drain(True)

    delayed_frames = flush

    def _take(self):
        n = next(b for b in self._sizes if len(self.queue) >= b)
        items, self.queue = self.queue[:n], self.queue[n:]
        return self._dispatch(items)

    def _drain(self, flushing: bool) -> list[EncodedFrame]:
        if self._inter:
            return self._drain_inter(flushing)
        out: list[EncodedFrame] = []
        full = self._sizes[0]
        while self.queue or self._pending is not None:
            if self._pending is not None:
                ctx, self._pending = self._pending, None
            elif flushing or len(self.queue) >= full:
                ctx = self._take()
            else:
                break               # wait for a full batch
            # pipeline: dispatch the NEXT batch before writing this one
            if self.queue and (flushing or len(self.queue) >= full):
                self._pending = self._take()
            out += self._collect(ctx)
        return out

    def _drain_inter(self, flushing: bool) -> list[EncodedFrame]:
        """The reference `_drain`'s inter branches: an IDR at the intra
        period or a scene cut; low delay (GOP size 1) one P picture per
        step; otherwise a GOP of B pictures in its coding order once its
        frames are queued (b-adapt may cut it to GOP-4 or plain P), plain
        P pictures up to an approaching IDR or scene cut, and on the flush
        plain P pictures for the frames left."""
        from .gop import LDP, gop_plan, gop_size
        out: list[EncodedFrame] = []
        cfg = self.cfg
        iper = cfg.intra_period
        gop_n = gop_size(cfg.latency, cfg.bframes)
        while self.queue:
            idx0 = self.queue[0][0]
            if idx0 == 0 or (iper > 0 and idx0 % iper == 0):
                out.append(self._encode_idr(*self.queue.pop(0)))
                continue
            with stage("la.features"):
                fa0 = self.la.get(idx0, force=flushing)
            if fa0 is not None and fa0.scenecut:
                # lookahead scene cut -> start a new IDR here
                self.la.analyses[idx0].scenecut = False
                out.append(self._encode_idr(*self.queue.pop(0)))
                continue
            till_idr = (iper - (idx0 % iper)) if iper > 0 else 1 << 30
            # a scene cut inside the upcoming GOP shortens it the same way
            # an approaching IDR does
            for k in range(1, min(gop_n, len(self.queue))):
                fa = self.la.get(idx0 + k, force=flushing)
                if fa is not None and fa.scenecut:
                    till_idr = min(till_idr, k)
                    break
            if gop_n == 1:
                ldp = gop_plan(cfg.latency, cfg.bframes, cfg.refs)
                di, f = self.queue.pop(0)
                if self.dpb and self.rc.should_skip("P"):
                    # VBV nearly empty: emit no NAL, repeat the last
                    # reference
                    self.rc.skipped()
                    ef = EncodedFrame(
                        data=b"", recon=self._wrap_recon(self.dpb[-1].fs),
                        poc=self.dpb[-1].poc, qp=0, bits=0,
                        slice_type="skip")
                    ef.display_idx = di
                    ef.pts = di
                    out.append(ef)
                    continue
                out.append(self._encode_inter(f, di,
                                              ldp[self.gop_base % len(ldp)]))
                self.gop_base += 1
                continue
            if till_idr >= gop_n and len(self.queue) >= gop_n:
                # with CU-tree, coding waits for a full lookahead window,
                # so propagation depth follows -lookahead
                la_depth = min(int(cfg.lookahead or 0), 64)
                if (not flushing and cfg.cutree and la_depth > gop_n
                        and len(self.queue) < la_depth):
                    break
                use_n = self._b_adapt(idx0, gop_n)
                if use_n == 1:
                    di, f = self.queue.pop(0)
                    out.append(self._encode_inter(
                        f, di, LDP[self.gop_base % len(LDP)]))
                    self.gop_base += 1
                    continue
                plans = gop_plan(cfg.latency, cfg.bframes if use_n == gop_n
                                 else use_n - 1)
                batch, self.queue = self.queue[:use_n], self.queue[use_n:]
                for plan in plans:
                    di, f = batch[plan.poc_in_gop - 1]
                    out.append(self._encode_inter(f, di, plan))
                self.gop_base += use_n
                continue
            if till_idr < gop_n and len(self.queue) >= till_idr:
                # closed GOP: plain P pictures up to the boundary
                for _ in range(till_idr):
                    di, f = self.queue.pop(0)
                    out.append(self._encode_inter(
                        f, di, LDP[self.gop_base % len(LDP)]))
                    self.gop_base += 1
                continue
            if flushing:
                while self.queue:
                    di, f = self.queue.pop(0)
                    out.append(self._encode_inter(
                        f, di, LDP[self.gop_base % len(LDP)]))
                    self.gop_base += 1
                continue
            break
        return out

    def _b_adapt(self, idx0: int, gop_n: int) -> int:
        """Pictures of the next GOP: b-adapt's median inter/intra cost
        ratio of its frames above 0.80 gives plain P (1), above 0.55 the
        shallow GOP-4 (from GOP-8), else the full GOP."""
        if not self.cfg.b_adapt or gop_n <= 2:
            return gop_n
        rs = []
        for k in range(gop_n):
            # coding-time read: the window is queued, so the pending
            # analysis batch is forced
            with stage("la.features"):
                fa = self.la.get(idx0 + k, force=True)
            if fa is None or fa.icost <= 0:
                break
            rs.append(fa.pcost / max(fa.icost, 1.0))
        if len(rs) == gop_n:
            m = float(np.median(rs))
            if m > 0.80:
                return 1
            if m > 0.55 and gop_n > 4:
                return 4
        return gop_n

    def _encode_idr(self, display_idx: int, frame) -> EncodedFrame:
        """An IDR of a low-delay stream: the all-intra kernels on a
        one-frame batch; its device reconstruction enters the device DPB."""
        self.gop_base = 0
        for rp in self.dpb:
            self.frame_pool.release(rp.fs)
        self.dpb.clear()
        fs = self.frame_pool.acquire(self.sps)
        fs.poc = 0
        ef = self._collect(self._dispatch([(display_idx, frame)]), fs)[0]
        from ..decode.decoder import RefPic, _HostView
        planes = tuple(p[0] for p in self._last_recon)
        fs.attach_device_planes([_HostView(p) for p in planes])
        self.dpb.append(RefPic(fs, 0))
        self.dev_dpb.put(fs, planes)
        self.dev_dpb.trim({rp.fs.serial for rp in self.dpb})
        self._rc_update(ef, 0, 1e5)
        return ef

    def _encode_inter(self, frame, display_idx: int, plan) -> EncodedFrame:
        """One P or B picture of a GOP plan (the reference
        `_encode_picture`'s inter branch): RPS trimmed to the DPB (entries
        with used_by_curr 0 stay named, so their pictures stay in both
        DPBs), L0 and L1 from the plan's deltas (a B picture with an empty
        list degrades to P), TMVP from L0[0], the QP of the plan's cascade
        entry, the inter engine, the slice, then the DPB and device-DPB
        update."""
        from ..decode.decoder import RefPic
        from .inter_frame import BFrameEncoder, PFrameEncoder
        cfg, sps, pps = self.cfg, self.sps, self.pps
        poc = self.gop_base + plan.poc_in_gop
        tid = plan.tid
        slice_type = P_SLICE if plan.slice_type == "P" else B_SLICE
        qp = int(np.clip(cfg.qp + plan.qp_offset, 0, 51))
        hdr = SliceHeader(nal_type=NalType.TRAIL_R, temporal_id=tid,
                          first_slice_in_pic=1, pps_id=0,
                          slice_type=slice_type, slice_qp=qp,
                          pic_order_cnt_lsb=poc & 0xFF)
        hdr.poc = poc
        hdr.deblocking_filter_disabled = pps.deblocking_filter_disabled
        hdr.beta_offset_div2 = pps.beta_offset_div2
        hdr.tc_offset_div2 = pps.tc_offset_div2
        if sps.sao_enabled:
            hdr.sao_luma = 1
            hdr.sao_chroma = 1
        by_poc = {rp.poc: rp for rp in self.dpb}
        # trim RPS entries to pictures actually in the DPB
        pairs = [(d, u) for d, u in zip(plan.ref_deltas, plan.ref_used)
                 if poc + d in by_poc]
        if not pairs:
            pairs = [(plan.ref_deltas[0], 1)]
        deltas = [d for d, _ in pairs]
        hdr.st_rps = ShortTermRPS(
            delta_pocs=deltas, used=[u for _, u in pairs],
            num_negative=sum(1 for d in deltas if d < 0),
            num_positive=sum(1 for d in deltas if d > 0))
        hdr.st_rps_idx = -1
        l0 = [by_poc[poc + d] for d in plan.l0 if poc + d in by_poc]
        l1 = [by_poc[poc + d] for d in plan.l1 if poc + d in by_poc]
        if slice_type == B_SLICE and (not l0 or not l1):
            # a missing reference: the picture degrades to P
            slice_type = hdr.slice_type = P_SLICE
            l0 = l0 or [self.dpb[-1]]
            l1 = []
        hdr.num_ref_idx = [max(1, len(l0)),
                           len(l1) if slice_type == B_SLICE else 0]
        if sps.temporal_mvp_enabled:
            # collocated picture = L0[0]
            hdr.temporal_mvp_enabled = 1
            hdr.collocated_from_l0 = 1
            hdr.collocated_ref_idx = 0
        if cfg.weightp and slice_type == P_SLICE and l0:
            # explicit weighted prediction (fades): the fit reads each L0
            # reference's host luma, fetched first where the picture was
            # reconstructed on the device
            with stage("enc.weightp"):
                for rp in l0:
                    rp.fs.ensure_planes()
                wt = decide_weightp(frame.y, [rp.fs.y for rp in l0])
            if wt is not None:
                log(0, "weightp engaged poc %d: %s" % (
                    poc, [(c[0].weight, c[0].offset) for c in wt]))
                hdr.luma_log2_weight_denom = 6
                hdr.chroma_log2_weight_denom = 6
                hdr.weights = [wt, []]
        fs = self.frame_pool.acquire(sps)
        fs.poc = poc
        cls = BFrameEncoder if slice_type == B_SLICE else PFrameEncoder
        enc = cls(fs, sps, pps, hdr, frame.y.astype(np.int32),
                  frame.u.astype(np.int32), frame.v.astype(np.int32), qp,
                  [l0, l1], subme=cfg.subme, device=self.device,
                  reference=self.reference)
        enc.lam_scale = cfg.lambda_scale
        enc.rdoq = bool(cfg.rdoq)
        enc.decide_effort = int(cfg.decide_effort)
        enc.merange = int(cfg.merange)
        enc.me_method = int(cfg.me)
        enc.partitions = int(cfg.partitions)
        enc.inter_tu_depth = int(cfg.inter_tu_depth)
        enc.dev_dpb = self.dev_dpb
        enc.sao_tier = max(int(cfg.sao), 1)
        dqp = self._dqp_ctu(display_idx)
        if dqp is not None:
            enc.dqp_ctu = dqp
        with stage("enc.compute"):
            enc.compute()
        if pps.cu_qp_delta_enabled:
            # the slice writer predicts each CU's QP as the decoder does
            from .map_writer import apply_effective_qp
            with stage("enc.effective_qp"):
                apply_effective_qp(fs, enc.syn, sps, pps, hdr)
        if enc.use_device_engine:
            recon_dev = enc.device_post["recon_dev"]
            # SAO was decided and applied on the device inside the coding
            # pass; its parameters come back for the slice's sao() syntax
            sao_arrays = enc.device_post["sao_arrays"]
            sao_params = (None if sao_arrays is None
                          else params_from_arrays(fs, *sao_arrays))
        else:
            # the host walk reconstructed into fs: the host deblocking
            # filter, then the SAO decision on K22's statistics of the
            # deblocked planes (applied below, after the slice is written)
            recon_dev = None
            sao_params = self._host_post(fs, enc, hdr, qp)
        rbsp = self._slice_rbsp(fs, enc.syn, hdr, sao_params)
        data = b""
        if cfg.pic_timing_sei:
            from ..hevc.sei import pic_timing_payload, write_sei_rbsp
            data += write_nal(NalType.PREFIX_SEI,
                              write_sei_rbsp([(1, pic_timing_payload())]),
                              temporal_id=tid)
        data += write_nal(hdr.nal_type, rbsp, temporal_id=tid)
        if recon_dev is not None:
            rec = self._lazy_recon(tuple(p[None] for p in recon_dev), 0, poc)
        else:
            if sao_params is not None:
                from ..decode.filters import sao_frame
                with stage("enc.sao_apply_host"):
                    sao_frame(fs, bool(hdr.sao_luma), bool(hdr.sao_chroma))
            rec = self._wrap_recon(fs)
        if cfg.md5:
            from ..hevc.sei import picture_hash_payload, write_sei_rbsp
            data += write_nal(
                NalType.SUFFIX_SEI,
                write_sei_rbsp([(132, picture_hash_payload(
                    rec.y, rec.u, rec.v))]), temporal_id=tid)
        # DPB update: keep the pictures this RPS names, plus this one
        keep = {poc + d for d in hdr.st_rps.delta_pocs}
        for rp in self.dpb:
            if rp.poc not in keep:
                self.frame_pool.release(rp.fs)
        self.dpb = [rp for rp in self.dpb if rp.poc in keep]
        self.dpb.append(RefPic(fs, poc))
        if recon_dev is not None:
            # a host-path picture's planes are uploaded on first reference
            # use (DeviceDPB.get_or_upload)
            self.dev_dpb.put(fs, recon_dev)
        self.dev_dpb.trim({rp.fs.serial for rp in self.dpb})
        ftype = "P" if slice_type == P_SLICE else "B"
        log(-1, "enc poc %d %s qp %d bits %d" % (poc, ftype, qp,
                                                 len(data) * 8))
        ef = EncodedFrame(data=data, recon=rec, poc=poc, qp=qp,
                          bits=len(data) * 8, slice_type=ftype)
        ef.display_idx = display_idx
        ef.temporal_id = tid
        ef.pts = display_idx
        ef.dts = self._coded_count - sps.num_reorder_pics[-1]
        self._coded_count += 1
        if cfg.psnr:
            ef.psnr = _psnr(frame, rec)
        self._rc_update(ef, tid, getattr(enc, "frame_cplx", 1e5))
        return ef

    def _host_post(self, fs, enc, hdr, qp: int):
        """Post-processing of a picture the host walk coded (the
        reference's branch without `device_post`): the host deblocking
        filter on fs, then with SAO on the per-CTB statistics of the
        deblocked planes against the sources (K22) and the host decision.
        Returns the SAO parameters (None without SAO)."""
        from ..decode.filters import deblock_frame
        from ..ops.saostats import sao_frame_stats
        from .sao import _decide_from_stats
        pps = self.pps
        with stage("enc.deblock_host"):
            deblock_frame(fs, hdr.beta_offset_div2, hdr.tc_offset_div2,
                          bool(pps.deblocking_filter_disabled),
                          pps.cb_qp_offset, pps.cr_qp_offset)
        if not self.sps.sao_enabled:
            return None
        with stage("enc.sao_stats"):
            stats = sao_frame_stats(fs, enc.src_y, enc.src_cb, enc.src_cr,
                                    device=self.device,
                                    reference=self.reference)
        with stage("enc.sao_decide_host"):
            return _decide_from_stats(fs, stats, qp, max(self.cfg.sao, 1))

    def _rc_update(self, ef: EncodedFrame, tid: int, cplx: float) -> None:
        """Rate-control feedback with the lookahead cost where there is
        one (the reference reads the lookahead here too)."""
        fa = self.la.get(ef.display_idx)
        self.rc.update(ef.slice_type, tid, ef.qp, ef.bits,
                       fa.cost if fa is not None else cplx)

    def _wrap_recon(self, fs) -> YUVFrame:
        fs.ensure_planes()
        l, r, t, b = self.sps.conf_win
        x0, x1 = 2 * l, self.sps.width - 2 * r
        y0, y1 = 2 * t, self.sps.height - 2 * b
        return YUVFrame(
            fs.y[y0:y1, x0:x1].astype(np.uint8),
            fs.cb[y0 // 2:y1 // 2, x0 // 2:x1 // 2].astype(np.uint8),
            fs.cr[y0 // 2:y1 // 2, x0 // 2:x1 // 2].astype(np.uint8),
            poc=fs.poc)

    def _dqp_ctu(self, display_idx: int):
        """The lookahead's per-CTB AQ / CU-tree QP offsets of a picture, or
        None without cu_qp_delta."""
        if not self.pps.cu_qp_delta_enabled:
            return None
        with stage("la.features"):
            fa = self.la.get(display_idx)
        return None if fa is None else fa.dqp_ctu

    def _dispatch(self, items):
        """Decide, code and deblock a batch on the device and take its SAO
        statistics; the levels and statistics are fetched in `_collect`.
        Under cu_qp_delta (AQ) each picture's CTBs take the lookahead's QP
        offsets, and the deblocking filter reads the decoder's effective
        QPs, which need the levels on the host first."""
        sps, pps, cfg = self.sps, self.pps, self.cfg
        dev = self.device
        ph = sps.pic_height_in_ctbs * sps.ctb_size
        pw = sps.pic_width_in_ctbs * sps.ctb_size
        qp = int(np.clip(cfg.qp, 0, 51))
        qps = [qp] * len(items)
        with stage("ai.upload"):
            src = [torch.from_numpy(np.stack([
                pad_plane(getattr(f, c), h, w).astype(np.uint8)
                for _, f in items])).to(dev)
                for c, h, w in (("y", ph, pw), ("u", ph // 2, pw // 2),
                                ("v", ph // 2, pw // 2))]
        with stage("ai.decide"):
            dec = decide_frames(*src, qps, cfg.lambda_scale,
                                effort=int(cfg.decide_effort),
                                nxn=bool(cfg.intra_nxn) and host_only(cfg),
                                reference=self.reference)
            maps = {k: dec[k].cpu().numpy() for k in
                    ("split32", "split16", "mode8", "mode16", "mode32",
                     "cm8", "cm16", "cm32")}
        _, tile8, _ = tile_region_maps(pps, sps)
        batch = []
        for f, (di, _) in enumerate(items):
            log2m, modes8, cmodes8 = decision_maps8(
                maps["split32"][f], maps["split16"][f], maps["mode8"][f],
                maps["mode16"][f], maps["mode32"][f], sps, ph >> 3,
                pw >> 3, maps["cm8"][f], maps["cm16"][f], maps["cm32"][f])
            batch.append(dict(log2m=log2m, modes8=modes8, cmodes8=cmodes8,
                              qp_map8=qp_map8(log2m.shape, qp,
                                              self._dqp_ctu(di)),
                              tile8=tile8))
        with stage("ai.code"):
            sched = self._coder.pack(batch, pps.cb_qp_offset,
                                     pps.cr_qp_offset, sps)
            recon, levels = code_intra_frames(
                *src, sched, bool(sps.strong_intra_smoothing),
                sbh=bool(pps.sign_data_hiding_enabled), rdoq=bool(cfg.rdoq),
                reference=self.reference)
        if pps.cu_qp_delta_enabled:
            with stage("ai.fetch_levels"):
                levels = tuple(lv.cpu().numpy() for lv in levels)
            with stage("ai.effective_qp"):
                for f, it in enumerate(batch):
                    it["qp4"] = self._intra_effective_qp4(
                        it, *(lv[f] for lv in levels), qp)
        with stage("ai.deblock"):
            bs = [intra_bs_maps(it["log2m"]) for it in batch]
            bs_v = np.stack([b[0] for b in bs]).astype(np.uint8)
            bs_h = np.stack([b[1] for b in bs]).astype(np.uint8)
            if pps.deblocking_filter_disabled:
                bs_v[:] = 0
                bs_h[:] = 0
            qp4 = np.stack([it["qp4"] if "qp4" in it else
                            np.repeat(np.repeat(it["qp_map8"], 2, 0), 2, 1)
                            for it in batch])
            recon = deblock_frames(
                *recon, *(torch.from_numpy(a).to(dev)
                          for a in (bs_v, bs_h, qp4)),
                pps.beta_offset_div2, pps.tc_offset_div2, pps.cb_qp_offset,
                pps.cr_qp_offset, sps.width, sps.height,
                reference=self.reference)
        stats = None
        if sps.sao_enabled:
            # the preset's SAO tier caps what the decision can pick (ref
            # ops/wavefront.py:825-842): tier <= 1 luma EO classes 0/1,
            # tier 2 all luma EO classes, tier >= 3 adds band offset and
            # both chroma planes
            tier = max(int(cfg.sao), 1)
            ncl, use_bo = (2 if tier <= 1 else 4), tier >= 3
            planes = list(zip(recon, src, (0, 1, 1)))[:3 if use_bo else 1]
            with stage("ai.sao_stats"):
                stats = [sao_stats_frames(
                    rec, s, sps.width >> sh, sps.height >> sh,
                    sps.ctb_size >> sh, classes=ncl, bo=use_bo,
                    reference=self.reference) for rec, s, sh in planes]
        return items, qp, batch, levels, recon, stats

    def _intra_effective_qp4(self, maps, cy, ccb, ccr, qp: int):
        """The decoder's QP per 4x4 cell of an intra picture coded under
        cu_qp_delta (`map_writer.apply_effective_qp`, tiles and WPP rows
        included) on the CTB grid, for the deblocking filter."""
        from .map_writer import apply_effective_qp
        sps = self.sps
        fs = self._fs
        fs.reset(sps)
        hdr = SliceHeader(slice_type=I_SLICE, slice_qp=qp)
        enc = IntraFrameEncoder(fs, sps, self.pps, hdr)
        enc.apply_coded_planes(maps["log2m"], maps["modes8"],
                               maps["cmodes8"], maps["qp_map8"], cy, ccb,
                               ccr)
        apply_effective_qp(fs, enc.syn, sps, self.pps, hdr)
        qp4 = np.repeat(np.repeat(maps["qp_map8"], 2, 0), 2, 1)
        h4, w4 = sps.height >> 2, sps.width >> 2
        qp4[:h4, :w4] = fs.qp[:h4, :w4]
        return qp4

    def _collect(self, ctx, fs=None) -> list[EncodedFrame]:
        items, qp, batch, levels, recon, stats = ctx
        sps = self.sps
        with stage("ai.fetch_levels"):
            cy, ccb, ccr = (lv if isinstance(lv, np.ndarray)
                            else lv.cpu().numpy() for lv in levels)
        sao_arr = [None] * len(items)
        if stats is not None:
            with stage("ai.sao_decide_host"):
                sao_arr = sao_decisions(stats, qp, max(self.cfg.sao, 1))
            with stage("ai.sao_apply"):
                prm = [torch.from_numpy(np.stack([a[k] for a in sao_arr]))
                       .to(self.device) for k in range(4)]
                recon = sao_apply_frames(
                    *recon, *prm, True, True, sps.width, sps.height,
                    sps.ctb_size, reference=self.reference)
        self._last_recon = recon
        return [self._encode_picture(frame, di, qp, batch[f], cy[f], ccb[f],
                                     ccr[f], recon, f, sao_arr[f], fs)
                for f, (di, frame) in enumerate(items)]

    def _encode_picture(self, frame, display_idx: int, qp: int, maps,
                        cy, ccb, ccr, recon, fidx: int,
                        sao_arrays=None, fs=None) -> EncodedFrame:
        """Entropy-code one IDR picture from its maps and levels; fs is the
        picture's FrameState (the encoder's own when it keeps no DPB)."""
        cfg, sps, pps = self.cfg, self.sps, self.pps
        hdr = SliceHeader(nal_type=NalType.IDR_W_RADL, temporal_id=0,
                          first_slice_in_pic=1, pps_id=0,
                          slice_type=I_SLICE, slice_qp=qp,
                          pic_order_cnt_lsb=0)
        hdr.poc = 0
        hdr.deblocking_filter_disabled = pps.deblocking_filter_disabled
        hdr.beta_offset_div2 = pps.beta_offset_div2
        hdr.tc_offset_div2 = pps.tc_offset_div2
        if sps.sao_enabled:
            hdr.sao_luma = 1
            hdr.sao_chroma = 1
        if fs is None:
            fs = self._fs
            fs.reset(sps)
        enc = IntraFrameEncoder(fs, sps, pps, hdr)
        enc.apply_coded_planes(maps["log2m"], maps["modes8"],
                               maps["cmodes8"], maps["qp_map8"], cy, ccb,
                               ccr)
        if "qp4" in maps:
            # the decoder's QPs (`_intra_effective_qp4`), for the writer
            h4, w4 = sps.height >> 2, sps.width >> 2
            fs.qp[:h4, :w4] = maps["qp4"][:h4, :w4]
        # the decision arrays were applied on the device in _collect; the
        # slice writer codes them as each CTB's sao() syntax
        sao_params = (None if sao_arrays is None
                      else params_from_arrays(fs, *sao_arrays))
        rbsp = self._slice_rbsp(fs, enc.syn, hdr, sao_params)
        data = b""
        if not self.headers_written or cfg.headers_before_keyframe:
            data += self.encode_headers()
        if cfg.pic_timing_sei:
            from ..hevc.sei import pic_timing_payload, write_sei_rbsp
            data += write_nal(NalType.PREFIX_SEI,
                              write_sei_rbsp([(1, pic_timing_payload())]))
        data += write_nal(hdr.nal_type, rbsp)
        rec = self._lazy_recon(recon, fidx)
        if cfg.md5:
            from ..hevc.sei import picture_hash_payload, write_sei_rbsp
            data += write_nal(
                NalType.SUFFIX_SEI,
                write_sei_rbsp([(132, picture_hash_payload(
                    rec.y, rec.u, rec.v))]))
        ef = EncodedFrame(data=data, recon=rec, poc=0, qp=qp,
                          bits=len(data) * 8, slice_type="I")
        ef.display_idx = display_idx
        ef.pts = display_idx
        ef.dts = self._coded_count - sps.num_reorder_pics[-1]
        self._coded_count += 1
        if cfg.psnr:
            ef.psnr = _psnr(frame, rec)
        return ef

    def _slice_rbsp(self, fs, syn, hdr, sao_params) -> bytes:
        """The slice NAL's RBSP: header plus the native CABAC slice data,
        entry points counted after emulation prevention."""
        cfg, sps, pps = self.cfg, self.sps, self.pps
        nthreads = (cfg.threads if cfg.threads > 0
                    else min(os.cpu_count() or 1, 8))
        with stage("enc.write_slice"):
            slice_data, raw_entries = write_slice_data(
                fs, syn, sps, pps, hdr, sao_params, threads=nthreads)
        if pps.entropy_coding_sync_enabled or pps.tiles_enabled:
            hdr.num_entry_points = len(raw_entries)
            hdr.entry_points = list(raw_entries)
        # entry_point_offsets count bytes as coded in the NAL, after
        # emulation prevention (7.4.7.1); iterate because the adjusted
        # values may change the header length and so the EPB positions
        for _ in range(8):
            bw = write_slice_header(hdr, sps, pps)
            if not bw.byte_aligned():
                raise RuntimeError("slice header is not byte aligned")
            rbsp = bytearray(bw.getvalue())
            data_start = len(rbsp)
            rbsp += slice_data
            if not raw_entries:
                break
            ins = epb_insert_positions(bytes(rbsp))
            adjusted = []
            b_prev = data_start
            for raw in raw_entries:
                b_k = b_prev + raw
                adjusted.append(raw + sum(1 for i in ins
                                          if b_prev < i <= b_k))
                b_prev = b_k
            if adjusted == hdr.entry_points:
                break
            hdr.entry_points = adjusted
        return bytes(rbsp)

    def _lazy_recon(self, planes, fidx: int, poc: int = 0) -> LazyYUV:
        """Device-resident recon -> lazily fetched YUV view cropped to the
        conformance window."""
        l, r, t, b = self.sps.conf_win
        x0, x1 = 2 * l, self.sps.width - 2 * r
        y0, y1 = 2 * t, self.sps.height - 2 * b

        def fetch():
            y, u, v = (p[fidx].cpu().numpy() for p in planes)
            return (y[y0:y1, x0:x1], u[y0 // 2:y1 // 2, x0 // 2:x1 // 2],
                    v[y0 // 2:y1 // 2, x0 // 2:x1 // 2])

        return LazyYUV(fetch, poc=poc)


def sao_decisions(stats, qp: int, tier: int) -> list:
    """The host SAO decision for each frame of a batch: stats holds, per
    plane that was measured (luma, or all three from tier 3 on), the K8
    tensors (eo_cnt, eo_err, bo_cnt, bo_err) of the batch. Returns per
    frame the (type, offsets, band position, EO class) arrays of
    encode/sao.py::decide_from_stats_arrays."""
    host = [[None if a is None else a.cpu().numpy() for a in st]
            for st in stats]
    n = len(host[0][0])
    pad = [None] * (3 - len(host))        # planes the tier never reads
    return [decide_from_stats_arrays(
        [tuple(None if a is None else a[f] for a in st) for st in host] + pad,
        qp, tier) for f in range(n)]


def _psnr(a: YUVFrame, b) -> tuple[float, float, float]:
    out = []
    for pa, pb in ((a.y, b.y), (a.u, b.u), (a.v, b.v)):
        mse = np.mean((pa.astype(np.float64) - pb.astype(np.float64)) ** 2)
        out.append(99.99 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse))
    return tuple(out)


def encode_sequence(frames: list[YUVFrame], cfg: EncoderConfig,
                    device=None, reference: bool = False):
    """Encode a list of frames. Returns (annex-B bytes in coding order,
    recons in display order)."""
    enc = HevcEncoder(cfg, device=device, reference=reference)
    efs: list[EncodedFrame] = []
    for f in frames:
        efs += enc.encode_frame(f)
    efs += enc.flush()
    stream = b"".join(e.data for e in efs)
    efs.sort(key=lambda e: e.display_idx)
    return stream, [e.recon for e in efs]
