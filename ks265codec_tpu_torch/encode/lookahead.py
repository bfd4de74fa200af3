"""Lookahead / pre-analysis host orchestration (EncPreAnalyze analog:
CInputPicManage + scenecut + calcFrameAdaptQuant, SURVEY.md 2.3).

The port's copy of ks265codec_tpu/encode/lookahead.py: only the two
device calls (the downsample in `push`, the batched features in `ensure`)
go to the port's K12 (ops/lookahead.py) on the encoder's device; the host
logic is unchanged.

Per pushed frame, one device pass (ops/lookahead.frame_features) yields
per-8x8-half-res-block intra cost, inter cost and variance. From those:

- frame cost: sum(min(icost, pcost)) — fed to rate control BEFORE the
  frame is coded (the reference's rateEstimateQscale input; previously RC
  extrapolated from the previous frame of the same type, i.e. was blind)
- scene-cut detection (x264 rule shape): a frame whose inter cost is no
  better than bias * intra cost starts a new scene -> force an IDR
- adaptive-quant offsets (aq_mode 1): per-CTU QP deltas from log2 block
  energy relative to the frame average (strength-scaled, clamped) —
  consumed once cu_qp_delta writing is enabled
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SCENECUT_BIAS = 0.85      # cut when pcost >= bias * icost (inter useless)
SCENECUT_MIN_GAP = 2      # frames; avoids IDR storms on flashes


@dataclass
class FrameAnalysis:
    display_idx: int
    icost: float            # summed intra cost (half-res SAD units)
    pcost: float            # summed inter cost vs previous frame
    cost: float             # min-combined frame cost for RC
    scenecut: bool
    dqp_ctu: np.ndarray | None    # (cty, ctx) int8 AQ(+tree) offsets or None


CUTREE_STRENGTH = 2.0     # x264: 5 * (1 - qcomp), qcomp 0.6


class Lookahead:
    """Feed frames in display order; read analyses keyed by display idx."""

    def __init__(self, cfg, device=None, reference: bool = False):
        self.cfg = cfg
        self.device = device
        self.reference = bool(reference)
        self.prev_half = None
        self.analyses: dict[int, FrameAnalysis] = {}
        self._last_cut = -(1 << 30)
        self._pending: list[tuple[int, object]] = []   # (idx, device half)
        self._first_done = False
        # batch floor: probes (scenecut peeks) must not force 1-frame
        # flushes — CU-tree propagation only sees blocks within one
        # flush window, and single-frame windows propagate nothing. The
        # reorder depth (bframes) is the floor; with CU-tree enabled the
        # window honors -lookahead (qy265enc.h:121) so propagation depth
        # follows the flag, not the caller's push/read pattern.
        self._min_flush = max(1, int(getattr(cfg, "bframes", 0) or 0))
        if getattr(cfg, "cutree", 0) and getattr(cfg, "lookahead", 0):
            self._min_flush = max(self._min_flush,
                                  min(int(cfg.lookahead), 64))

    def push(self, display_idx: int, y: np.ndarray) -> None:
        """Buffer the frame (downsample stays on device). Features are
        computed lazily in ONE batched dispatch when analyses are read —
        per-frame dispatch/fetch round-trips dominated the cost."""
        import torch

        from ..ops.lookahead import downsample2x
        h, w = y.shape
        # pad to a 16-multiple so the half plane blocks evenly
        ph, pw = (h + 15) // 16 * 16, (w + 15) // 16 * 16
        if (ph, pw) != (h, w):
            yp = np.empty((ph, pw), np.uint8)
            yp[:h, :w] = y
            yp[h:, :w] = y[h - 1:]
            yp[:, w:] = yp[:, w - 1:w]
            y = yp
        dev = torch.tensor(np.ascontiguousarray(y, np.uint8),
                           device=self.device)
        self._pending.append((display_idx, downsample2x(
            dev[None], reference=self.reference)[0]))

    def ensure(self, force: bool = True) -> None:
        """Run the batched feature pass over every buffered frame.
        With force=False (probes), waits for _min_flush frames."""
        if not self._pending:
            return
        if not force and len(self._pending) < self._min_flush:
            return
        import torch

        from ..ops.lookahead import (frame_features_batch,
                                     frame_features_first)
        want_var = bool(self.cfg.aq_mode)
        want_tree = bool(getattr(self.cfg, "cutree", 0))
        idxs = [i for i, _ in self._pending]
        halves = [h for _, h in self._pending]
        prevs = ([self.prev_half] if self.prev_half is not None
                 else [halves[0]]) + halves[:-1]
        packed = frame_features_batch(
            torch.stack(halves), torch.stack(prevs), want_var, want_tree,
            reference=self.reference).cpu().numpy()
        if not self._first_done:
            # recompute frame 0 without an inter reference
            packed0 = frame_features_first(
                halves[0], want_var, want_tree,
                reference=self.reference).cpu().numpy()
            packed[0] = packed0[0]
        self.prev_half = halves[-1]
        self._pending.clear()
        hh, hw = self.prev_half.shape
        nb = (hh // 8) * (hw // 8)
        from ..utils.trace import stage
        with stage("la.cutree"):
            tree_dqps = (self._cutree(packed, want_var, hh // 8, hw // 8)
                         if want_tree else [None] * len(idxs))
        for k, di in enumerate(idxs):
            first = not self._first_done
            row = packed[k].astype(np.float64)
            icost = float(row[0])
            pcost = float(row[1]) if not first else icost
            cost = float(row[2]) if not first else icost
            var = None
            mean8 = None
            if want_var:
                var = row[3:3 + nb].reshape(hh // 8, hw // 8)
                if int(self.cfg.aq_mode) >= 3:
                    # dark-bias needs block means: fetch this frame's
                    # half-res plane (aq 3 is opt-in; the extra D2H is
                    # its documented cost)
                    hplane = halves[k].cpu().numpy().astype(np.float64)
                    mean8 = hplane[:(hh // 8) * 8, :(hw // 8) * 8] \
                        .reshape(hh // 8, 8, hw // 8, 8).mean((1, 3))
            cut = False
            if not first and di - self._last_cut >= SCENECUT_MIN_GAP:
                cut = pcost >= SCENECUT_BIAS * max(icost, 1.0) \
                    and pcost > 1.5 * self._typical_pcost()
            if cut or first:
                self._last_cut = di
                if cut:
                    from ..utils.log import log
                    log(0, "scenecut at display %d (pcost %.0f icost %.0f)"
                        % (di, pcost, icost))
            with stage("la.aq_offsets"):
                dqp = self._aq_offsets(var, mean8) if want_var else None
            if tree_dqps[k] is not None:
                dqp = (tree_dqps[k] if dqp is None
                       else np.clip(dqp.astype(np.int32)
                                    + tree_dqps[k], -9, 9).astype(np.int8))
            fa = FrameAnalysis(di, icost, pcost, cost, cut, dqp)
            self.analyses[di] = fa
            if len(self.analyses) > 256:
                self.analyses.pop(min(self.analyses), None)
            self._pcosts = getattr(self, "_pcosts", [])
            if not first:
                self._pcosts.append(pcost)
                if len(self._pcosts) > 32:
                    self._pcosts.pop(0)
            self._first_done = True

    def get(self, display_idx: int, force: bool = True):
        """force=True (coding-time reads) flushes whatever is pending;
        force=False (probes ahead of coding) respects the batch floor so
        CU-tree windows stay wide."""
        self.ensure(force)
        return self.analyses.get(display_idx)

    def _typical_pcost(self) -> float:
        pc = getattr(self, "_pcosts", [])
        return float(np.median(pc)) if pc else 0.0

    def _aq_offsets(self, var: np.ndarray,
                    mean8: np.ndarray | None = None) -> np.ndarray:
        """CTU-granular dQP from relative block energy
        (calcFrameAdaptQuant analog; qy265enc.h:145 aq modes):
          1: variance AQ (x264 shape) — offsets from log2 energy vs the
             frame average;
          2: auto-variance — offsets z-normalized by the frame's energy
             SPREAD, so flat and busy content get comparable dynamics;
          3: auto-variance with a dark-area bias (extra rate for blocks
             whose mean luma is low, where banding is most visible).
        var is per-8x8 block of the HALF plane -> a CTU covers 4x4."""
        mode = int(self.cfg.aq_mode)
        strength = 1.0 * float(self.cfg.aq_strength)
        e = np.log2(1.0 + var)
        cty, ctx = e.shape[0] // 4, e.shape[1] // 4
        ectu = e[:cty * 4, :ctx * 4].reshape(cty, 4, ctx, 4).mean((1, 3))
        if mode >= 2:
            spread = max(float(ectu.std()), 0.5)
            dqp = -strength * 2.0 * (ectu - ectu.mean()) / spread
        else:
            dqp = -strength * 1.5 * (ectu - ectu.mean())
        if mode >= 3 and mean8 is not None:
            mctu = mean8[:cty * 4, :ctx * 4].reshape(cty, 4, ctx, 4) \
                .mean((1, 3))
            dqp = dqp - np.where(mctu < 60.0, 2.0,
                                 np.where(mctu < 90.0, 1.0, 0.0))
        return np.clip(np.round(dqp), -6, 6).astype(np.int8)

    def _cutree(self, packed, want_var: bool, nby: int, nbx: int):
        """CU-tree propagation (cuTreePropagate analog, x264 shape):
        walk the flushed window BACKWARD, pushing each block's future
        importance (intra cost + accumulated propagate-in, scaled by how
        predictable the block is) onto the previous-frame blocks its
        lookahead MV points at (bilinear area splat). The accumulated
        propagate-in then lowers QP where the content feeds many future
        frames: dqp = -strength * log2(1 + propagate/intra).

        Window = one lazy-flush batch (a GOP-ish chunk); propagation does
        not cross flush boundaries, which truncates chains at most once
        per batch (the reference's sliding lookahead has the same horizon
        at its lookahead depth)."""
        nb = nby * nbx
        off = 3 + (nb if want_var else 0)
        F = packed.shape[0]
        ics, pcs, dxs, dys = [], [], [], []
        for k in range(F):
            row = packed[k].astype(np.float64)
            ics.append(row[off:off + nb].reshape(nby, nbx))
            pcs.append(row[off + nb:off + 2 * nb].reshape(nby, nbx))
            dxs.append(row[off + 2 * nb:off + 3 * nb].reshape(nby, nbx))
            dys.append(row[off + 3 * nb:off + 4 * nb].reshape(nby, nbx))
        prop = [np.zeros((nby, nbx)) for _ in range(F)]
        bx = np.tile(np.arange(nbx) * 8, nby).astype(np.float64)
        by = np.repeat(np.arange(nby) * 8, nbx).astype(np.float64)
        for k in range(F - 1, 0, -1):
            ic, pc = ics[k], pcs[k]
            fraction = np.clip(1.0 - pc / np.maximum(ic, 1.0), 0.0, 1.0)
            amount = ((ic + prop[k]) * fraction).reshape(-1)
            # splat at mv-shifted positions into frame k-1 (area weights)
            tx = bx + dxs[k].reshape(-1)
            ty = by + dys[k].reshape(-1)
            bx0 = np.floor(tx / 8.0).astype(np.int64)
            by0 = np.floor(ty / 8.0).astype(np.int64)
            fx = tx / 8.0 - bx0
            fy = ty / 8.0 - by0
            tgt = prop[k - 1]
            for (ox, oy, w) in ((0, 0, (1 - fx) * (1 - fy)),
                                (1, 0, fx * (1 - fy)),
                                (0, 1, (1 - fx) * fy),
                                (1, 1, fx * fy)):
                cx = np.clip(bx0 + ox, 0, nbx - 1)
                cy = np.clip(by0 + oy, 0, nby - 1)
                np.add.at(tgt, (cy, cx), amount * w)
        out = []
        for k in range(F):
            ratio = np.log2(1.0 + prop[k] / np.maximum(ics[k], 1.0))
            # zero-mean per frame: cutree discriminates WITHIN the frame
            # (referenced content vs dead-end content); frame-level QP is
            # the GOP cascade / RC's job, and one-sided offsets under
            # fixed QP just buy bits below the RD curve (measured)
            dqp = -CUTREE_STRENGTH * (ratio - float(ratio.mean()))
            # CTU aggregation: half-res 8-blocks are 16 luma; CTU 64 = 4x4
            cty, ctx = nby // 4, nbx // 4
            dctu = dqp[:cty * 4, :ctx * 4].reshape(cty, 4, ctx, 4) \
                .mean((1, 3))
            out.append(np.clip(np.round(dctu), -9, 9).astype(np.int8))
        return out

    def pop(self, display_idx: int) -> FrameAnalysis | None:
        return self.analyses.pop(display_idx, None)
