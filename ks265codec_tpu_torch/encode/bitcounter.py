"""Precise (CABAC-state) bit counter — the CBitCounterPrecise analog
(SURVEY.md 2.3: the reference's RDO keeps a Rough closed-form tier and a
Precise tier that loads real context states and accumulates fractional
entropy bits per bin).

The fractional-bit tables are DERIVED from this repo's own normative
RANGE_TAB_LPS (spec table 9-46): for probability state s the LPS
probability is estimated as E_q[rangeTabLps[s][q]] / E_q[R_mid(q)] over
the four range quantization bins, and bits(b) = -log2(p(b)). States
evolve with the normative 9-47 transitions, so counting a syntax
element's bins through this class tracks exactly the adaptation the real
encoder will experience when it codes the same decisions in the same
order — which the sequential CTU walk does (decisions are made in coding
order), making this a faithful Precise tier for that path. The batched
device engine keeps the Rough tier (closed-form; no sequential state).

Fixed-point: bits are accumulated in 1/32768 units (`FRAC_ONE`)."""

from __future__ import annotations

import math

from ..hevc.cabac_tables import (CTX_OFFSET, NEXT_STATE_LPS,
                                 NEXT_STATE_MPS, RANGE_TAB_LPS,
                                 init_contexts)

FRAC_ONE = 1 << 15

# E[R] midpoint per range-quantizer bin q = (R >> 6) & 3, R in [256, 510]
_R_MID = (288.0, 352.0, 416.0, 480.0)


def _build_bits():
    mps = [0] * 64
    lps = [0] * 64
    for s in range(64):
        p = (sum(RANGE_TAB_LPS[s][q] / _R_MID[q] for q in range(4)) / 4.0)
        p = min(max(p, 1e-6), 0.5)
        lps[s] = int(round(-math.log2(p) * FRAC_ONE))
        mps[s] = int(round(-math.log2(1.0 - p) * FRAC_ONE))
    return mps, lps


_BITS_MPS, _BITS_LPS = _build_bits()


class PreciseBitCounter:
    """Counts fractional bits of context-coded + bypass bins while
    evolving a private context-state array (normative transitions).

    One instance per coded frame/slice of the sequential walk: seed from
    the slice's initial contexts, then query costs in coding order so
    states adapt the same way the real writer's will."""

    __slots__ = ("ctx", "frac")

    def __init__(self, slice_type: int, slice_qp: int,
                 cabac_init_flag: int = 0):
        self.ctx = bytearray(init_contexts(slice_type, slice_qp,
                                           cabac_init_flag))
        self.frac = 0

    # ---- engine-shaped primitives
    def bin_bits(self, bin_val: int, ctx_idx: int,
                 update: bool = True) -> int:
        state = self.ctx[ctx_idx]
        if bin_val == (state & 1):
            b = _BITS_MPS[state >> 1]
            if update:
                self.ctx[ctx_idx] = NEXT_STATE_MPS[state]
        else:
            b = _BITS_LPS[state >> 1]
            if update:
                self.ctx[ctx_idx] = NEXT_STATE_LPS[state]
        if update:
            self.frac += b
        return b

    @staticmethod
    def bypass_bits(n: int) -> int:
        return n * FRAC_ONE

    # ---- syntax-element costs (bins mirror encode/sbac.py's writer)
    def merge_idx_bits(self, idx: int, max_cand: int,
                       update: bool = False) -> float:
        """merge_flag=1 + merge_idx (first bin ctx-coded, rest bypass,
        truncated unary against max_cand-1). Returns float bits."""
        b = self.bin_bits(1, CTX_OFFSET["merge_flag"], update)
        if max_cand > 1:
            b += self.bin_bits(1 if idx > 0 else 0,
                               CTX_OFFSET["merge_idx"], update)
            if idx > 0:
                n = min(idx - 1, max_cand - 2) + (idx < max_cand - 1)
                b += self.bypass_bits(max(n, 0))
        return b / FRAC_ONE

    def amvp_bits(self, used_lists, ref_idx, mvds, mvp_flags,
                  num_ref, slice_type_b: bool, depth: int = 0,
                  update: bool = False) -> float:
        """merge_flag=0 + inter_dir (B) + per-list ref_idx + mvd + mvp."""
        b = self.bin_bits(0, CTX_OFFSET["merge_flag"], update)
        if slice_type_b:
            bi = len(used_lists) == 2
            b += self.bin_bits(1 if bi else 0,
                               CTX_OFFSET["inter_dir"] + depth, update)
            if not bi:
                b += self.bin_bits(1 if used_lists[0] == 1 else 0,
                                   CTX_OFFSET["inter_dir"] + 4, update)
        for l in used_lists:
            nr = num_ref[l]
            ri = ref_idx[l]
            if nr > 1:
                b += self.bin_bits(1 if ri > 0 else 0,
                                   CTX_OFFSET["ref_idx"], update)
                if ri > 0 and nr > 2:
                    b += self.bin_bits(1 if ri > 1 else 0,
                                       CTX_OFFSET["ref_idx"] + 1, update)
                    if ri > 1:
                        b += self.bypass_bits(min(ri - 2, nr - 3)
                                              + (ri < nr - 1))
            b += self._mvd_bits(mvds[l], update)
            b += self.bin_bits(mvp_flags[l], CTX_OFFSET["mvp_idx"],
                               update)
        return b / FRAC_ONE

    def _mvd_bits(self, mvd, update: bool) -> int:
        b = 0
        ax, ay = abs(int(mvd[0])), abs(int(mvd[1]))
        b += self.bin_bits(1 if ax > 0 else 0, CTX_OFFSET["mvd"], update)
        b += self.bin_bits(1 if ay > 0 else 0, CTX_OFFSET["mvd"], update)
        for a in (ax, ay):
            if a > 0:
                b += self.bin_bits(1 if a > 1 else 0,
                                   CTX_OFFSET["mvd"] + 1, update)
                if a > 1:
                    # EG1 remainder + sign
                    v = a - 2
                    k = 1
                    while v >= (1 << k):
                        v -= 1 << k
                        k += 1
                    b += self.bypass_bits(2 * k)   # k-1 prefix+stop+k-1... EG1
                b += self.bypass_bits(1)           # sign
        return b

    def part_mode_bits(self, part: int, log2: int, min_cb: bool,
                       amp: bool, update: bool = False) -> float:
        """part_mode for inter CUs (9.3.3.7 bin pattern)."""
        base = CTX_OFFSET["part_size"]
        if part == 0:
            return self.bin_bits(1, base, update) / FRAC_ONE
        b = self.bin_bits(0, base, update)
        hor = part in (1, 4, 5)
        b += self.bin_bits(1 if hor else 0, base + 1, update)
        if amp and not min_cb:
            sym = part in (1, 2)
            b += self.bin_bits(1 if sym else 0, base + 3, update)
            if not sym:
                b += self.bypass_bits(1)
        return b / FRAC_ONE
