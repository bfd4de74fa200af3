"""Inter mode decision (K15): for every CU of a tier, the merge
candidates' luma SAD, the rough rate-distortion cost of the best merge
candidate, of the motion-search candidate and of intra, and the choice;
and the candidate SADs of the merge snap.

Counterpart of ks265codec_tpu/ops/interdecide.py: `_tier_core` via
`decide_tiers_fused_jit` (`_tiers_fused_core`), with `_rough_cu` and
`_rough_tu_inter`, and `snap_sads_fused_jit` (`_snap_sads_core`,
`_cand_sads_core`). With has_l1 (B pictures) every candidate and ME
record carries both lists' slots and motions: it is bi-predicted where
both slots are >= 0 and list 1's alone where only that one is
(`_pred_blocks` with `s1`/`v1`), and an ME record is valid where either
list is. The per-tier results come back as typed tensors, not as the
reference's packed row.

The rough cost of a motion is the real forward transform and inter
deadzone quantisation (rounding 85/512) of its MC residual, luma at n and
both chroma planes at n/2: distortion is the coefficient-domain squared
dequantisation error scaled by 4^(log2 n - 7), rate the closed-form
level bits 3.1 + 2 log2(level). The float32 sums follow the reference
backend's vectorised order (`decide._block_sum`), the level bits its
contracted form (`decide.bits_table`), and every `x + lam * y` is one
fused multiply-add, as that backend computes them.

CUDA: csrc/inter_decide.cu, one launch per tier (one thread block per
CU: the candidates' SADs, the best merge candidate, then the rough cost of
merge and ME motion, each TU transformed in shared memory, the sums in
one thread in the reference's order) and one per snap tier; list 1 is a
template argument of both kernels, so P pictures run the uni code alone.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hevc.tables import LEVEL_SCALE
from ..interop import device_bits_table, device_tables
from . import _build
from .decide import _block_sum, fma32
from .mc import pred_blocks
from .transforms import forward_transform, quantize

# per-tier decision inputs, in the reference's order
TIER_FIELDS = ("xs", "ys", "cs0", "cmv0", "cs1", "cmv1", "cvalid", "ms0",
               "mmv0", "ms1", "mmv1", "me_bits", "icost", "qp", "qpcb",
               "qpcr", "lam", "lams")


def _take(plane: torch.Tensor, xs, ys, n: int) -> torch.Tensor:
    d = torch.arange(n, device=plane.device)
    return plane[(ys[:, None] + d)[:, :, None], (xs[:, None] + d)[:, None, :]]


# ------------------------------------------------------- plain PyTorch path

def rough_tu_inter(res: torch.Tensor, qp: torch.Tensor, n: int,
                   btab: torch.Tensor):
    """(D, bits, all_zero) of a batch of inter TUs res (K, n, n) int32."""
    log2 = n.bit_length() - 1
    a = forward_transform(res, log2).abs()
    lev = quantize(a, qp, log2, intra=False)
    q = qp.reshape(-1, 1, 1).to(torch.int32)
    s = 8 + log2 - 5
    p = q // 6
    scale = torch.as_tensor(LEVEL_SCALE, dtype=torch.int32,
                            device=res.device)[q % 6]
    tv = lev * (16 * scale)
    sp = (s - p).clamp(min=0)
    ps = (p - s).clamp(min=0)
    drnd = torch.where(s - p >= 1, torch.ones_like(sp) << (s - p - 1)
                       .clamp(min=0), 0)
    deq = (((tv + drnd) >> sp) << ps).clamp(0, 1 << 30)
    derr = (a - deq).to(torch.float32)
    D = _block_sum(derr * derr) * np.float32(4.0 ** (log2 - 7))
    bits = _block_sum(btab[lev.long()])
    return D, bits, ~(lev > 0).any(-1).any(-1)


def rough_cu(src, refs, s0, v0, s1, v1, xs, ys, n: int, qp, qpcb, qpcr,
             pic_w: int, pic_h: int, btab, has_l1: bool):
    """Rough (D, bits, zero) of coding motion (s0, v0) and, with has_l1,
    (s1, v1) at CU size n: luma TU n (four 32s at 64) plus both chroma
    planes at n/2 (four 16s at 32). src / refs: (y, cb, cr) int32 planes
    / stacks."""
    D = bits = zero = None
    for c, (plane, stack, q) in enumerate(zip(src, refs, (qp, qpcb, qpcr))):
        m = n if c == 0 else n >> 1
        ox, oy = (xs, ys) if c == 0 else (xs >> 1, ys >> 1)
        pw, ph = (pic_w, pic_h) if c == 0 else (pic_w // 2, pic_h // 2)
        pred = pred_blocks(stack, s0, v0, s1, v1, ox, oy, m, pw, ph, has_l1,
                           c > 0)
        r = _take(plane, ox, oy, m) - pred
        t = min(m, 32 if c == 0 else 16)
        if t < m:
            B = r.shape[0]
            r = r.reshape(B, 2, t, 2, t).transpose(2, 3).reshape(B * 4, t, t)
            d, b, z = rough_tu_inter(r, q.repeat_interleave(4), t, btab)
            d = d.reshape(B, 4).sum(1)
            b = b.reshape(B, 4).sum(1)
            z = z.reshape(B, 4).all(1)
        else:
            d, b, z = rough_tu_inter(r, q, t, btab)
        if D is None:
            D, bits, zero = d, b, z
        else:
            D, bits, zero = D + d, bits + b, zero & z
    return D, bits, zero


def _cand_sads(src_y, refs_y, xs, ys, cs0, cmv0, cs1, cmv1, n, pic_w,
               pic_h, has_l1: bool):
    """(C, B) float32 luma SAD of every candidate."""
    blk = _take(src_y, xs, ys, n)
    return torch.stack([
        (blk - pred_blocks(refs_y, cs0[j], cmv0[j], cs1[j], cmv1[j], xs, ys,
                           n, pic_w, pic_h, has_l1, False)).abs().sum((1, 2))
        for j in range(cs0.shape[0])]).to(torch.float32)


def tier_plain(src, refs, ta: dict, n: int, pic_w: int, pic_h: int,
               zero_only: bool, has_l1: bool = False):
    """One tier of `_tier_core`. src / refs: (y, cb, cr) int32 planes /
    (R, ...) stacks; ta: the TIER_FIELDS tensors (list 1's read only with
    has_l1). Returns (choice int8, bidx int64, cost float32) or,
    zero_only, (has_zero bool, first int32)."""
    btab = device_bits_table(src[0].device)
    xs, ys = ta["xs"].long(), ta["ys"].long()
    cs0, cmv0, cvalid = ta["cs0"].long(), ta["cmv0"].long(), ta["cvalid"]
    cs1, cmv1 = ta["cs1"].long(), ta["cmv1"].long()
    C = cs0.shape[0]
    lams = ta["lams"]
    sads = _cand_sads(src[0], refs[0], xs, ys, cs0, cmv0, cs1, cmv1, n,
                      pic_w, pic_h, has_l1)
    cidx = 2.0 + torch.arange(C, dtype=torch.float32,
                              device=sads.device)[:, None]
    csel = fma32(lams[None, :], cidx, sads)
    csel = torch.where(cvalid, csel, torch.inf)
    best = csel.argmin(0)
    gi = best[None, :, None].expand(1, -1, 2)
    any_valid = cvalid.any(0)
    bs0 = torch.where(any_valid, cs0.gather(0, best[None])[0], -1)
    bs1 = torch.where(any_valid, cs1.gather(0, best[None])[0], -1)
    bmv0, bmv1 = cmv0.gather(0, gi)[0], cmv1.gather(0, gi)[0]
    qp, qpcb, qpcr = (ta[k].long() for k in ("qp", "qpcb", "qpcr"))
    if zero_only:
        zall = torch.stack([
            rough_cu(src, refs, cs0[j], cmv0[j], cs1[j], cmv1[j], xs, ys, n,
                     qp, qpcb, qpcr, pic_w, pic_h, btab, has_l1)[2]
            for j in range(C)]) & cvalid
        return zall.any(0), zall.to(torch.int8).argmax(0).to(torch.int32)
    lam = ta["lam"]
    Dm, bm, _ = rough_cu(src, refs, bs0, bmv0, bs1, bmv1, xs, ys, n, qp,
                         qpcb, qpcr, pic_w, pic_h, btab, has_l1)
    merge_cost = torch.where(
        any_valid, fma32(lam, (bm + 2.0) + best.to(torch.float32), Dm),
        torch.inf)
    ms0, mmv0 = ta["ms0"].long(), ta["mmv0"].long()
    ms1, mmv1 = ta["ms1"].long(), ta["mmv1"].long()
    Dme, bme, _ = rough_cu(src, refs, ms0, mmv0, ms1, mmv1, xs, ys, n, qp,
                           qpcb, qpcr, pic_w, pic_h, btab, has_l1)
    me_valid = (ms0 >= 0) | (ms1 >= 0)
    me_cost = torch.where(me_valid, fma32(lam, bme + ta["me_bits"], Dme),
                          torch.inf)
    icost = ta["icost"]
    intra_cost = torch.where(icost < torch.inf,
                             fma32(lam, torch.full_like(lam, 1.5), icost),
                             torch.inf)
    costs = torch.stack([merge_cost, me_cost, intra_cost])
    cost, choice = costs.min(0)
    return choice.to(torch.int8), best, cost


# ------------------------------------------------------------- CUDA kernel

def _planes_ok(src, refs):
    for t in tuple(src) + tuple(refs):
        if t.dtype != torch.uint8 or not t.is_cuda or not t.is_contiguous():
            raise ValueError("planes must be contiguous uint8 CUDA tensors")


def tier_cuda(src, refs, ta: dict, n: int, pic_w: int, pic_h: int,
              zero_only: bool, has_l1: bool = False):
    """`tier_plain` on the card: one launch of `ks_inter_decide_tier`."""
    _planes_ok(src, refs)
    dev = src[0].device
    B = ta["xs"].shape[0]
    C = ta["cs0"].shape[0]
    i32 = {k: ta[k].to(device=dev, dtype=torch.int32).contiguous()
           for k in ("xs", "ys", "cs0", "cmv0", "cs1", "cmv1", "ms0", "mmv0",
                     "ms1", "mmv1", "qp", "qpcb", "qpcr")}
    valid = ta["cvalid"].to(device=dev, dtype=torch.uint8).contiguous()
    f32 = {k: ta[k].to(device=dev, dtype=torch.float32).contiguous()
           for k in ("me_bits", "icost", "lam", "lams")}
    choice = torch.empty(B, dtype=torch.int32, device=dev)
    bidx = torch.empty(B, dtype=torch.int32, device=dev)
    cost = torch.empty(B, dtype=torch.float32, device=dev)
    R, H, W = refs[0].shape
    P = _build.ptr
    rc = _build.kernels().ks_inter_decide_tier(
        P(src[0]), P(src[1]), P(src[2]), P(refs[0]), P(refs[1]), P(refs[2]),
        P(i32["xs"]), P(i32["ys"]), P(i32["cs0"]), P(i32["cmv0"]),
        P(i32["cs1"]), P(i32["cmv1"]), P(valid), P(i32["ms0"]),
        P(i32["mmv0"]), P(i32["ms1"]), P(i32["mmv1"]), P(f32["me_bits"]),
        P(f32["icost"]), P(i32["qp"]), P(i32["qpcb"]), P(i32["qpcr"]),
        P(f32["lam"]), P(f32["lams"]), P(choice), P(bidx), P(cost),
        P(device_tables(dev)), P(device_bits_table(dev)), B, C, n, H, W, pic_w,
        pic_h, int(zero_only), int(has_l1), _build.stream(dev))
    _build.check(rc, "ks_inter_decide_tier")
    _build.count("inter_decide")
    if zero_only:
        return choice.bool(), bidx
    return choice.to(torch.int8), bidx.long(), cost


def cand_sads_cuda(src_y, refs_y, xs, ys, cs0, cmv0, cs1, cmv1, n, pic_w,
                   pic_h, has_l1: bool = False):
    _planes_ok((src_y,), (refs_y,))
    dev = src_y.device
    C, B = cs0.shape
    xs, ys, cs0, cmv0, cs1, cmv1 = (
        a.to(device=dev, dtype=torch.int32).contiguous()
        for a in (xs, ys, cs0, cmv0, cs1, cmv1))
    out = torch.empty((C, B), dtype=torch.float32, device=dev)
    R, H, W = refs_y.shape
    P = _build.ptr
    rc = _build.kernels().ks_inter_cand_sads(
        P(src_y), P(refs_y), P(xs), P(ys), P(cs0), P(cmv0), P(cs1), P(cmv1),
        P(out), B, C, n, H, W, pic_w, pic_h, int(has_l1), _build.stream(dev))
    _build.check(rc, "ks_inter_cand_sads")
    _build.count("inter_cand_sads")
    return out


# ------------------------------------------------------------- entry points

def decide_tiers(src, refs, tier_args, meta, pic_w: int, pic_h: int,
                 has_l1: bool = False, reference: bool = False):
    """Every tier's decision. src (y, cb, cr) uint8 planes and refs
    (R, ...) uint8 stacks on one device; tier_args: per tier a dict of
    TIER_FIELDS tensors; meta: per tier (n, zero_only). Returns per tier
    (choice int8, bidx int64, cost float32) or (has_zero bool, first
    int32). has_l1: B pictures (list 1 read). CUDA planes launch the
    kernel; CPU planes, or reference=True, run the plain version."""
    dev = src[0].device
    plain = dev.type != "cuda" or reference
    if plain:
        src = tuple(p.to(torch.int32) for p in src)
        refs = tuple(p.to(torch.int32) for p in refs)
    out = []
    for (n, zero_only), ta in zip(meta, tier_args):
        ta = {k: v.to(dev) for k, v in ta.items()}
        fn = tier_plain if plain else tier_cuda
        out.append(fn(src, refs, ta, n, pic_w, pic_h, zero_only, has_l1))
    return out


def snap_sads(src_y, refs_y, tier_args, meta, pic_w: int, pic_h: int,
              has_l1: bool = False, reference: bool = False):
    """Candidate SADs (C, K) float32 of several tiers (the reference's
    `snap_sads_fused_jit`): tier_args per tier (xs, ys, cs0, cmv0, cs1,
    cmv1); meta: per tier n; has_l1: B pictures (list 1 read)."""
    dev = src_y.device
    plain = dev.type != "cuda" or reference
    out = []
    for n, ta in zip(meta, tier_args):
        xs, ys, cs0, cmv0, cs1, cmv1 = (a.to(dev) for a in ta[:6])
        if plain:
            out.append(_cand_sads(src_y.to(torch.int32),
                                  refs_y.to(torch.int32), xs.long(),
                                  ys.long(), cs0.long(), cmv0.long(),
                                  cs1.long(), cmv1.long(), n, pic_w, pic_h,
                                  has_l1))
        else:
            out.append(cand_sads_cuda(src_y, refs_y, xs, ys, cs0, cmv0, cs1,
                                      cmv1, n, pic_w, pic_h, has_l1))
    return out

