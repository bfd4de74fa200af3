"""P- and B-picture encoders: the batched device inter engine
(encode/inter_engine.py) on the port's kernels.

The port's counterpart of ks265codec_tpu/encode/inter_frame.py:
`PFrameEncoder` with its lambda set-up, `_engine_ok` and `mv_pred_field`
(which the engine imports) are the reference's, and `BFrameEncoder` is
the reference's subclass for B pictures, whose lists L0 and L1 the engine
reads (its `is_b` branches). `compute` runs the engine and nothing else:
the reference's sequential host walk (and with it ops/me.py and
ops/subpel.py, K20 and K21) is not ported, so a configuration the engine
does not cover raises NotImplementedError, and a failure inside the
engine raises instead of falling back.
"""

from __future__ import annotations

import numpy as np

from .intra_frame import IntraFrameEncoder


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
    """Codes one P picture (single slice) through the device engine."""

    def __init__(self, fs, sps, pps, hdr, src_y, src_cb, src_cr, qp,
                 ref_lists, subme: int = 1, device=None,
                 reference: bool = False):
        super().__init__(fs, sps, pps, hdr, src_y, src_cb, src_cr, qp)
        self.ref_lists = ref_lists
        self.subme = subme
        self.device = device
        self.reference = bool(reference)
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
        """The batched device inter engine: one decision pass per
        iteration over the CU tiers and one coding pass."""
        if not self._engine_ok():
            raise NotImplementedError(
                "the device inter engine does not cover this configuration "
                "(tiles, slices, partitions, inter TU split, PCM or noise "
                "reduction) and the host walk is not ported")
        self.use_device_engine = True
        from .inter_engine import engine_pre_analysis, run_engine
        engine_pre_analysis(self)
        run_engine(self)


class BFrameEncoder(PFrameEncoder):
    """Codes one B picture (single slice) through the device engine: the
    motion search of L0[0] and L1[0] with the bi-prediction cost (K13),
    then the decisions and the coding pass over both lists. The
    reference's host pre-analysis of B pictures belongs to its host walk,
    which is not ported."""
