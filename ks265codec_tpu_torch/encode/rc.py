"""Rate control: fixed-QP / CRF / ABR / CBR+VBV, x264-lineage qscale model.

Mirrors the reference's CEncRCBase/CEncRcAbr surface (createRC, getInitQp,
rateEstimateQscale, updateVbv, judgeSkipFrame — SURVEY.md 2.3 "Rate
control"): a complexity-driven qscale model with ABR feedback and a VBV
leaky bucket; frame-type/temporal-layer offsets from the GOP plan.

Frame complexity comes from the device decision pass (SATD sums) of the
PREVIOUS frame of the same type — the lookahead pass replaces this with
true per-frame costs when it lands.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .config import RC_ABR, RC_CBR, RC_CRF, RC_CVBR, RC_CVQ, \
    RC_FIXQP, EncoderConfig


def qp_to_qscale(qp: float) -> float:
    return 0.85 * 2.0 ** ((qp - 12.0) / 6.0)


def qscale_to_qp(qs: float) -> float:
    return 12.0 + 6.0 * math.log2(qs / 0.85)


@dataclass
class FrameStats:
    poc: int
    ftype: str
    qp: int
    bits: int
    cplx: float


class RateControl:
    """Per-frame QP decisions + post-frame feedback."""

    IP_OFFSET = -3          # I frames below P (x264 ipratio ~1.4)
    QCOMP = 0.6

    def __init__(self, cfg: EncoderConfig):
        self.cfg = cfg
        self.mode = cfg.rc
        self.fps = max(cfg.frame_rate, 1e-3)
        self.target_bps = cfg.bitrate_kbps * 1000.0
        self.bits_total = 0.0
        self.frames_done = 0
        self.cplx_sum = 1e-6
        self.cplx_count = 1e-6
        self.short_err = 0.0
        # CRF: rate factor fixed from the constant
        self.crf_qscale = qp_to_qscale(cfg.crf)
        # ABR: rate factor adapted so bits match target
        self.rate_factor = None
        # VBV
        self.vbv_max = cfg.vbv_maxrate_kbps * 1000.0
        self.vbv_size = cfg.vbv_bufsize_kbits * 1000.0
        if self.mode == RC_CBR and self.vbv_max <= 0:
            self.vbv_max = self.target_bps
        if self.mode == RC_CBR and self.vbv_size <= 0:
            self.vbv_size = self.target_bps  # 1 second
        if self.mode == RC_CVBR:
            # constrained VBR (qy265enc.h:74): ABR machinery with a
            # mandatory VBV cap above the mean rate
            if self.vbv_max <= 0:
                self.vbv_max = 1.5 * self.target_bps
            if self.vbv_size <= 0:
                self.vbv_size = 2.0 * self.target_bps
        self.vbv_fill = self.vbv_size * 0.9
        # bits predictor per type: bits ~= coeff * cplx / qscale
        self.pred = {"I": 1.0, "P": 1.0, "B": 1.0}
        self.pred_n = {"I": 0.1, "P": 0.1, "B": 0.1}
        self.last_cplx = {"I": None, "P": None, "B": None}

    # ------------------------------------------------------------- decide
    def frame_qp(self, ftype: str, tid: int, cplx: float | None) -> int:
        """QP for the next frame. cplx: SATD-ish complexity if known."""
        cfg = self.cfg
        if self.mode == RC_FIXQP:
            qp = cfg.qp
            qp += self._type_offset(ftype, tid, explicit=True)
            return self._clip(qp)
        c = cplx if cplx is not None else self.last_cplx.get(ftype) or 1e5
        blur = c ** (1.0 - self.QCOMP)
        if self.mode in (RC_CRF, RC_CVQ):
            qs = self.crf_qscale * blur / max(
                (self.cplx_sum / self.cplx_count) ** (1.0 - self.QCOMP), 1e-6)
            if self.mode == RC_CVQ and self.target_bps > 0 \
                    and self.frames_done > 0:
                # constrained quality: CRF until the running rate exceeds
                # the target, then one-sided ABR-style pressure upward
                wanted = self.target_bps * self.frames_done / self.fps
                overflow = (self.bits_total - wanted) / max(wanted, 1.0)
                if overflow > 0:
                    qs *= min(2.5, 1.0 + overflow * 1.2)
        else:                    # ABR / CBR / CVBR
            if self.rate_factor is None:
                # bootstrap: aim qscale so predicted bits hit per-frame target
                tgt = self.target_bps / self.fps
                coeff = self.pred[ftype] / self.pred_n[ftype]
                qs = max(coeff * c / max(tgt, 1.0), 0.1)
            else:
                qs = blur / self.rate_factor
            # ABR feedback on accumulated error (full-strength gain: the
            # soft 0.5 gain left a persistent 13-17% undershoot)
            if self.frames_done > 0:
                wanted = self.target_bps * self.frames_done / self.fps
                overflow = (self.bits_total - wanted) / max(wanted, 1.0)
                qs *= max(0.4, min(2.5, 1.0 + overflow * 1.2))
        qp = qscale_to_qp(max(qs, 0.1))
        qp += self._type_offset(ftype, tid)
        if self.vbv_size > 0:
            qp = self._vbv_clip(qp, ftype, c)
        return self._clip(qp)

    def _type_offset(self, ftype, tid, explicit=False):
        if ftype == "I":
            return self.IP_OFFSET if not explicit else 0
        if ftype == "B":
            return 1 + tid
        return 0 if not explicit else 0

    def _vbv_clip(self, qp: float, ftype: str, cplx: float) -> float:
        """Raise QP until the predicted frame fits the buffer headroom."""
        coeff = self.pred[ftype] / self.pred_n[ftype]
        inflow = self.vbv_max / self.fps
        for _ in range(16):
            pred_bits = coeff * cplx / qp_to_qscale(qp)
            room = self.vbv_fill + inflow
            if pred_bits <= room * 0.9 or qp >= self.cfg.qp_max:
                break
            qp += 1
        return qp

    def should_skip(self, ftype: str) -> bool:
        """judgeSkipFrame analog: with frame-skip enabled, drop a non-ref-
        critical picture when the VBV buffer is nearly empty (the next
        frame's inflow cannot cover even a minimal coded picture)."""
        if not self.cfg.frame_skip or ftype == "I" or self.vbv_size <= 0:
            return False
        inflow = self.vbv_max / self.fps
        return self.vbv_fill < 0.3 * inflow

    def skipped(self) -> None:
        """Feedback for a skipped (uncoded) frame: only inflow."""
        if self.vbv_size > 0:
            self.vbv_fill = min(self.vbv_fill + self.vbv_max / self.fps,
                                self.vbv_size)
        self.frames_done += 1

    # ------------------------------------------------------------ feedback
    def update(self, ftype: str, tid: int, qp: int, bits: int,
               cplx: float) -> None:
        self.bits_total += bits
        self.frames_done += 1
        self.cplx_sum += cplx
        self.cplx_count += 1
        self.last_cplx[ftype] = cplx
        qs = qp_to_qscale(qp - self._type_offset(ftype, tid))
        self.pred[ftype] += bits * qs / max(cplx, 1.0)
        self.pred_n[ftype] += 1
        if self.mode in (RC_ABR, RC_CBR, RC_CVBR):
            blur = cplx ** (1.0 - self.QCOMP)
            # rate factor EMA toward achieving target bits
            inst_rf = blur * qs ** -1.0
            tgt = self.target_bps / self.fps
            scale = bits / max(tgt, 1.0)
            rf = blur / (qs * scale)     # rf that would have hit target
            self.rate_factor = (rf if self.rate_factor is None
                                else 0.9 * self.rate_factor + 0.1 * rf)
        if self.vbv_size > 0:
            self.vbv_fill += self.vbv_max / self.fps - bits
            self.vbv_fill = max(0.0, min(self.vbv_fill, self.vbv_size))

    def _clip(self, qp: float) -> int:
        return int(round(max(self.cfg.qp_min, min(self.cfg.qp_max, qp))))


class TwoPassStats:
    """2-pass RC stats file (reference analog: writeRateControlFrameStats /
    initPass2 with qy_rename atomic replace — SURVEY.md 5.4).

    Pass 1 (cfg.pass_num == 1) appends one line per coded picture; pass 2
    (cfg.pass_num == 2) reads them and scales per-frame QPs so complex
    frames get the bits (x264 2-pass qcomp reallocation, simplified).
    """

    def __init__(self, path: str):
        self.path = path
        self.rows: list[dict] = []

    def add(self, poc: int, ftype: str, qp: int, bits: int,
            cplx: float) -> None:
        self.rows.append(dict(poc=poc, type=ftype, qp=qp, bits=bits,
                              cplx=cplx))

    def write(self) -> None:
        import os
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for r in self.rows:
                f.write(f"{r['poc']} {r['type']} {r['qp']} {r['bits']} "
                        f"{r['cplx']:.1f}\n")
        os.replace(tmp, self.path)      # atomic (qy_rename analog)

    @classmethod
    def read(cls, path: str) -> "TwoPassStats":
        st = cls(path)
        with open(path) as f:
            for line in f:
                p, t, q, b, c = line.split()
                st.add(int(p), t, int(q), int(b), float(c))
        return st

    def qp_offsets(self, target_bps: float, fps: float) -> dict[int, int]:
        """Display-index -> QP delta for pass 2: spend bits where pass 1
        found complexity, under the sequence bit budget."""
        import math
        if not self.rows:
            return {}
        total_target = target_bps * len(self.rows) / max(fps, 1e-3)
        total_p1 = sum(r["bits"] for r in self.rows) or 1
        # global shift to hit the target
        global_dqp = 6.0 * math.log2(total_p1 / max(total_target, 1.0))
        mean_cplx = (sum(r["cplx"] for r in self.rows)
                     / len(self.rows)) or 1.0
        out = {}
        for i, r in enumerate(self.rows):
            rel = 0.4 * 6.0 * math.log2(max(r["cplx"], 1.0) / mean_cplx)
            out[i] = int(round(global_dqp - rel))
        return out
