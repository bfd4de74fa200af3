"""SAO decision (K16): per-CTB offsets and type from K8's integer
statistics, on the device, so that only the chosen parameters (a few KB
a picture) travel to the host for the slice syntax.

Counterpart of ks265codec_tpu/ops/saodecide.py (`_best_offsets`,
`sao_decide_core`): for each CTB and each plane the tier allows, the best
offset of each of the four edge-offset categories (0, 1, 3, 4 of K8's five
bins) scanning from the clipped rounded optimum toward zero, the EO class
of least cost (first minimum), at tier >= 3 the band-offset window of
least cost over the 29 start positions, and Cr inheriting Cb's type and
class. Costs are float32, in the reference backend's sequence (ROADMAP.md
queue 3), because a tie is decided by `==` and one ulp changes a
parameter:
  - an offset's cost is fma(lam, |h| + 1, cnt*h*h - 2*h*err) with lam the
    float32 rounding of the double lambda; the integer part is exact;
  - the start is rint(err / max(cnt, 1)) (IEEE division, half to even);
  - an EO class's cost is f32(lam * 3) + c0 + c1 + c2 + c3 in that order;
  - a band window's cost is ((c[b] + c[b+1]) + c[b+2]) + c[b+3], and the
    chosen window's cost adds f32(lam * 8) after the choice.

CUDA: csrc/sao_decide.cu, one launch, one thread per CTB walking its three
planes in order (Cr reads Cb's choice). The plain version computes every
CTB at once, as the reference does.
"""

from __future__ import annotations

import torch

from . import _build
from .decide import fma32

CATS = (0, 1, 3, 4)
BOUNDS = ((0.0, 7.0), (0.0, 7.0), (-7.0, 0.0), (-7.0, 0.0))


def sao_lambda(qp: int) -> float:
    """The reference's SAO lambda, a double."""
    return float(0.85 * 2.0 ** ((qp - 12) / 3.0))


def _f32(x: float, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=dev)


def best_offsets(cnt, err, lo: float, hi: float, lam: float):
    """Offset in [lo, hi] minimising cnt*h^2 - 2*h*err + lam*(|h|+1) per
    element (the larger |h| wins a tie; the do-nothing 0 wins its ties).
    cnt/err int32 of any shape. Returns (h, cost) float32."""
    dev = cnt.device
    cnt = cnt.to(torch.float32)
    err = err.to(torch.float32)
    start = torch.round(err / cnt.clamp(min=1.0)).clamp(lo, hi)
    hs = torch.arange(-7, 8, dtype=torch.float32, device=dev).reshape(
        (15,) + (1,) * cnt.dim())
    base = cnt[None] * hs * hs - 2.0 * hs * err[None]
    cost = fma32(_f32(lam, dev), hs.abs() + 1.0, base)
    valid = ((hs != 0) & (hs.abs() <= start.abs()[None])
             & (torch.sign(hs) == torch.sign(start)[None])
             & (hs >= lo) & (hs <= hi) & (cnt[None] > 0))
    inf = torch.tensor(float("inf"), device=dev)
    cost_v = torch.where(valid, cost, inf)
    cmin = cost_v.min(0).values
    adj = torch.where(cost_v == cmin[None], -hs.abs(), inf)
    k = torch.argmin(adj, 0)[None]
    h = torch.gather(hs.expand_as(cost), 0, k)[0]
    c = torch.gather(cost, 0, k)[0]
    use = (c < 0.0) & torch.gather(valid, 0, k)[0]
    zero = torch.zeros((), device=dev)
    return torch.where(use, h, zero), torch.where(use, c, zero)


def _check(stats, tier: int):
    if tier not in (1, 2, 3, 4):
        raise ValueError("tier must be 1-4")
    planes = 3 if tier >= 3 else 1
    if len(stats) < planes:
        raise ValueError(f"tier {tier} needs statistics of {planes} plane(s)")
    ncl = 2 if tier <= 1 else 4
    for c in range(planes):
        eo_cnt, eo_err, bo_cnt, bo_err = stats[c]
        if eo_cnt.dim() != 4 or eo_cnt.shape[:2] != (ncl, 5) or \
                eo_err.shape != eo_cnt.shape:
            raise ValueError(f"EO statistics must be ({ncl}, 5, ncty, nctx)")
        if tier >= 3 and (bo_cnt is None or bo_err is None
                          or bo_cnt.shape != (32,) + eo_cnt.shape[2:]
                          or bo_err.shape != bo_cnt.shape):
            raise ValueError("tier >= 3 needs band statistics "
                             "(32, ncty, nctx)")
    return planes


def sao_decide_plain(stats, qp: int, tier: int):
    """Plain PyTorch version. stats: per plane (eo_cnt (ncl, 5, ncty,
    nctx), eo_err, bo_cnt (32, ncty, nctx) or None, bo_err) int32, for
    luma only below tier 3. Returns (type_, offs, bpos, eocl) int8
    (3, ncty, nctx[, 4])."""
    planes = _check(stats, tier)
    lam = sao_lambda(qp)
    dev = stats[0][0].device
    ncty, nctx = stats[0][0].shape[2:]
    f32, i8 = torch.float32, torch.int8
    inf = torch.tensor(float("inf"), device=dev)
    type_ = torch.zeros((3, ncty, nctx), dtype=i8, device=dev)
    offs = torch.zeros((3, ncty, nctx, 4), dtype=i8, device=dev)
    bpos = torch.zeros_like(type_)
    eocl = torch.zeros_like(type_)
    for c in range(planes):
        eo_cnt, eo_err, bo_cnt, bo_err = stats[c]
        best = torch.zeros((ncty, nctx), dtype=f32, device=dev)
        classes = (0, 1) if tier <= 1 else range(eo_cnt.shape[0])
        eo_h = torch.zeros((4, 4, ncty, nctx), dtype=f32, device=dev)
        eo_cost = torch.full((4, ncty, nctx), float("inf"), dtype=f32,
                             device=dev)
        for eo in classes:
            cost = _f32(lam * 3.0, dev).expand(ncty, nctx)
            for k, cat in enumerate(CATS):
                h, cst = best_offsets(eo_cnt[eo, cat], eo_err[eo, cat],
                                      *BOUNDS[k], lam)
                eo_h[eo, k] = h
                cost = cost + cst
            eo_cost[eo] = cost
        if c == 2:
            # Cr inherits Cb's type and class; only that class is searched
            cls = torch.arange(4, device=dev)[:, None, None]
            adj = torch.where((type_[1] == 2)[None]
                              & (cls == eocl[1].long()[None]), eo_cost, inf)
        else:
            adj = eo_cost
        bcls = torch.argmin(adj, 0)
        bcost = torch.gather(adj, 0, bcls[None])[0]
        use_eo = bcost < best
        best = torch.where(use_eo, torch.gather(eo_cost, 0, bcls[None])[0],
                           best)
        type_[c] = torch.where(use_eo, 2, type_[c])
        eocl[c] = torch.where(use_eo, bcls.to(i8), eocl[c])
        sel = torch.gather(eo_h, 0, bcls[None, None].expand(1, 4, -1, -1))[0]
        offs[c] = torch.where(use_eo[..., None], sel.permute(1, 2, 0).to(i8),
                              offs[c])
        if tier >= 3:
            bh, bc = best_offsets(bo_cnt, bo_err, -7.0, 7.0, lam)
            wc = torch.stack([((bc[b] + bc[b + 1]) + bc[b + 2]) + bc[b + 3]
                              for b in range(29)])
            wpos = torch.argmin(wc, 0)
            wcost = torch.gather(wc, 0, wpos[None])[0] + _f32(lam * 8.0, dev)
            use_bo = wcost < best
            if c == 2:
                use_bo = use_bo & (type_[1] == 1)
            type_[c] = torch.where(use_bo, 1, type_[c])
            bpos[c] = torch.where(use_bo, wpos.to(i8), bpos[c])
            eocl[c] = torch.where(use_bo, 0, eocl[c])
            win = torch.gather(bh, 0, (wpos[None] + torch.arange(
                4, device=dev)[:, None, None]))
            offs[c] = torch.where(use_bo[..., None],
                                  win.permute(1, 2, 0).to(i8), offs[c])
        if c == 1:
            type_[2] = type_[1]
            eocl[2] = eocl[1]
    return type_, offs, bpos, eocl


def sao_decide_cuda(stats, qp: int, tier: int):
    """The decision on the card: one launch of `ks_sao_decide`."""
    planes = _check(stats, tier)
    dev = stats[0][0].device
    ncty, nctx = stats[0][0].shape[2:]
    null = torch.zeros(1, dtype=torch.int32, device=dev)
    ptrs = []
    for c in range(3):
        st = tuple(stats[c]) if c < planes else (None,) * 4
        for a in st[:2] + (st[2:] if tier >= 3 else (None, None)):
            if a is None:
                ptrs.append(null)
            elif not a.is_cuda or a.dtype != torch.int32:
                raise ValueError("statistics must be int32 CUDA tensors")
            else:
                ptrs.append(a.contiguous())
    type_ = torch.empty((3, ncty, nctx), dtype=torch.int8, device=dev)
    offs = torch.empty((3, ncty, nctx, 4), dtype=torch.int8, device=dev)
    bpos = torch.empty_like(type_)
    eocl = torch.empty_like(type_)
    lam = sao_lambda(qp)
    P = _build.ptr
    rc = _build.kernels().ks_sao_decide(
        *(P(t) for t in ptrs), P(type_), P(offs), P(bpos), P(eocl),
        ncty * nctx, tier, float(lam),
        float(lam * 3.0), float(lam * 8.0), _build.stream(dev))
    _build.check(rc, "ks_sao_decide")
    _build.count("sao_decide")
    return type_, offs, bpos, eocl


def sao_decide(stats, qp: int, tier: int, reference: bool = False):
    """SAO parameters of one picture from its statistics. CUDA tensors
    launch the kernel; CPU tensors, or reference=True, run the plain
    version."""
    if stats[0][0].device.type != "cuda" or reference:
        return sao_decide_plain(stats, qp, tier)
    return sao_decide_cuda(stats, qp, tier)
