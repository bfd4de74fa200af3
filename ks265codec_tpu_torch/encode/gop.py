"""GOP structure planner: hierarchical-B GOP-8 (offline), low-delay
IPPP (zerolatency), with RPS / ref-list / temporal-layer / QP-offset tables.

Mirrors the reference's GopStructure::{init,fillRpsInGop,fillPicFeatureInGop}
(SURVEY.md 2.3) and its run-captured behavior: offline medium = GOP-8
hierarchical-B coded 8,4,2,1,3,6,5,7 with QP cascade +1/+2/+4 and the RPS
patterns observed in the reference's own streams (SURVEY.md 5.6).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PicPlan:
    """Coding plan for one picture inside a GOP."""
    poc_in_gop: int              # display offset from GOP start (1..gop)
    slice_type: str              # "P" or "B"
    tid: int
    qp_offset: int
    ref_deltas: list[int]        # RPS delta POCs (negatives first)
    ref_used: list[int]          # used_by_curr flags
    l0: list[int]                # delta POCs forming list 0
    l1: list[int]                # delta POCs forming list 1


# run-captured reference GOP-8 (SURVEY.md 5.6; verified against the
# reference encoder's own slice headers)
GOP8: list[PicPlan] = [
    PicPlan(8, "P", 0, 1, [-8], [1], [-8], []),
    PicPlan(4, "B", 0, 2, [-4, 4], [1, 1], [-4], [4]),
    PicPlan(2, "B", 1, 4, [-2, 2, 6], [1, 1, 0], [-2], [2]),
    PicPlan(1, "B", 2, 4, [-1, 1, 3, 7], [1, 1, 0, 0], [-1], [1]),
    PicPlan(3, "B", 2, 4, [-1, -3, 1, 5], [1, 0, 1, 0], [-1], [1]),
    PicPlan(6, "B", 1, 4, [-2, -6, 2], [1, 0, 1], [-2], [2]),
    PicPlan(5, "B", 2, 4, [-1, -5, 1, 3], [1, 0, 1, 0], [-1], [1]),
    PicPlan(7, "B", 2, 4, [-1, -3, -7, 1], [1, 0, 0, 1], [-1], [1]),
]

# low-delay P: every frame refs the previous one; period-4 QP cascade
# +3/+2/+3/+1 (run-captured from the reference at zerolatency rc 0 —
# the +1 entry is the periodic "refresh" P that arrests LDP drift)
LDP: list[PicPlan] = [
    PicPlan(1, "P", 0, 3, [-1], [1], [-1], []),
    PicPlan(1, "P", 0, 2, [-1], [1], [-1], []),
    PicPlan(1, "P", 0, 3, [-1], [1], [-1], []),
    PicPlan(1, "P", 0, 1, [-1], [1], [-1], []),
]

# mini-GOP shapes for -bframes < 7 (the reference's fillRpsByPrediction
# produces equivalent pyramids; livestreaming resolves bframes=3 -> GOP4,
# cutting reorder latency from 4 to 2 — qy265enc.h latency axis)
GOP4: list[PicPlan] = [
    PicPlan(4, "P", 0, 1, [-4], [1], [-4], []),
    PicPlan(2, "B", 1, 2, [-2, 2], [1, 1], [-2], [2]),
    PicPlan(1, "B", 2, 4, [-1, 1, 3], [1, 1, 0], [-1], [1]),
    PicPlan(3, "B", 2, 4, [-1, -3, 1], [1, 0, 1], [-1], [1]),
]

GOP3: list[PicPlan] = [
    PicPlan(3, "P", 0, 1, [-3], [1], [-3], []),
    PicPlan(1, "B", 1, 3, [-1, 2], [1, 1], [-1], [2]),
    PicPlan(2, "B", 2, 4, [-1, -2, 1], [1, 0, 1], [-1], [1]),
]

GOP2: list[PicPlan] = [
    PicPlan(2, "P", 0, 1, [-2], [1], [-2], []),
    PicPlan(1, "B", 1, 3, [-1, 1], [1, 1], [-1], [1]),
]


def gop_plan(latency: str, bframes: int, refs: int = 1) -> list[PicPlan]:
    if latency == "zerolatency" or bframes == 0:
        if refs <= 1:
            return LDP
        return ldp_plans(refs)
    if bframes == 1:
        return GOP2
    if bframes == 2:
        return GOP3
    if bframes < 7:
        return GOP4
    return GOP8


def ldp_plans(refs: int) -> list[PicPlan]:
    """Low-delay P with a multi-reference window (-ref N,
    qy265enc.h:141): each P references the previous `refs` pictures;
    same +3/+2/+3/+1 QP cascade as LDP."""
    refs = max(1, min(int(refs), 4))
    deltas = [-(k + 1) for k in range(refs)]
    used = [1] * refs
    return [PicPlan(1, "P", 0, off, list(deltas), list(used),
                    list(deltas), [])
            for off in (3, 2, 3, 1)]


def gop_size(latency: str, bframes: int) -> int:
    """Pictures per GOP step. LDP is 1 (its plan list holds alternate QP
    cascade entries for the SAME single-picture step, not a batch)."""
    if latency == "zerolatency" or bframes == 0:
        return 1
    return len(gop_plan(latency, bframes))


def reorder_depth(plans: list[PicPlan]) -> int:
    """num_reorder_pics for a GOP shape: max count of earlier-decoded
    pictures that display later than a given picture."""
    depth = 0
    for i, p in enumerate(plans):
        depth = max(depth, sum(1 for q in plans[:i]
                               if q.poc_in_gop > p.poc_in_gop))
    return depth
