"""Whole-frame intra decision (K5): source-pixel references, 35-mode
prediction, SATD + lambda*bits mode costs, the rough rate-distortion cost
of each winner and the split maps, for a batch of frames.

Counterpart of ks265codec_tpu/ops/decide.py::decide_frames_jit at both of
its efforts, with its NxN tier:
  * effort 0 (ultrafast, superfast): the full 35-mode sweep at the 16
    tier, then the 8 and 32 tiers searching only the candidates seeded
    from the 16 tier's winners, one rough-RD candidate, DM-only chroma;
  * effort 1 (veryfast and slower): the full sweep at every tier, the
    three best modes by `satd + ls * mode_bits` (ties to the lower mode,
    as the reference backend's top-k) each judged by its rough RD cost
    `D + lam * (R + mode_bits)` (the first minimum in rank order), and the
    five chroma candidates (planar, 26, 10, DC, DM; one equal to DM
    becomes 34) by `satd_cb + satd_cr + ls * bits` (SATD 4x4 below 8x8);
  * the NxN tier (effort 1, where the caller asks for it: the reference
    turns it on for IDRs of inter streams and for AQ streams): per 4x4
    luma block the 35 modes by 4x4 SATD plus MPM mode bits, the winner's
    rough cost, and NxN at an 8x8 CU where its four blocks plus lam * 16
    beat the CU's luma-only cost; there NxN's cost replaces that part of
    cost8 (which moves split16) and nxn8 is set. The stream never codes
    NxN: the device scan codes 2Nx2N (the reference's behaviour, kept
    for byte identity).
The 13 per-frame maps come back directly as tensors (no packed transfer
row, no striping).

The costs are float32 and steer every decision, so both versions here
reproduce the reference's float32 sequence on its CPU backend exactly:
  * the reference backend contracts `a + s * b` into one fused
    multiply-add where both sit in one fusion: the mode cost
    `satd + ls * mode_bits`, the chroma cost, the candidate cost and the
    final `D + lam * R`; `fma32` below (and `__fmaf_rn` in the kernel)
    does the same;
  * its sums over a transform block follow the vectorised order of
    `_block_sum`; sums of 2x2 cost cells are sequential in raster order;
  * the rate sum of the final cost is (R + mode_bits) + (1 + hdr) at
    effort 0 (the constant DM bit folded into the header bits) and
    ((R + mode_bits) + chroma_bits) + hdr at effort 1;
  * the frame total `cplx` follows `_frame_sum`: above 32 rows or
    columns of 32-blocks the reference backend's tree rewrite (windows of
    32, each summed in row-major order), then the order its vectorised
    loop takes at the map's shape (read off its optimised code at
    1280x768, 320x256, 192x320, 128x96 and the tests' maps);
  * `3.1 + 2 * log2(level)` is a table (`bits_table`) built from the
    reference backend's float32 log (`_logtab`) and the same contraction;
  * the NxN tier's sum of four 4x4 costs is the running total
    fma(lam, rate, acc + D), read off the reference backend's fused loop
    (`nxn_plain`), and the replaced cost is (cost8 - cl8) + nxn_cost.
The CUDA kernels (csrc/decide.cu: pass A one block per 64x64 region over
compact candidate lists, pass B a team of warps per CU) run the same
sequence, each float32 chain in one thread, and are held against
`decide_frames_plain` and pass A against `pass_a_plain`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..hevc.tables import chroma_qp
from . import _build
from . import cost as tcost
from . import intra as tintra
from .transforms import dequantize, forward_transform, quantize
from ._logtab import ONE_ULP_DOWN, ONE_ULP_UP

_HDR_BITS = {8: 7.0, 16: 5.0, 32: 4.0}
# at effort 0 the chroma bits are the DM flag's constant 1.0, which the
# reference backend folds into the header bits: `(x + 1.0) + hdr` becomes
# `x + (1.0 + hdr)`
_HDR_PLUS_DM = {n: 1.0 + h for n, h in _HDR_BITS.items()}
_BITS_MPM0, _BITS_MPM12, _BITS_REM = 2.0, 3.0, 6.0
# chroma candidate bits: four explicit modes, then DM
_BITS_CHROMA, _BITS_DM = 7.0, 1.0

MAP_NAMES = ("split32", "mode16", "mode32", "cplx", "split16", "mode8",
             "cm8", "cm16", "cm32", "cost8", "cost16", "mode4", "nxn8")


def bits_table() -> np.ndarray:
    """float32 (32768,): rate term of one coefficient level,
    fma(log(l), 2/ln2, 3.1) in float32 as the reference computes it; 0 at
    level 0 (zero levels cost nothing)."""
    lv = np.arange(1, 32768)
    lg = np.log(lv.astype(np.float64)).astype(np.float32)
    bits = lg.view(np.int32)
    bits[np.asarray(ONE_ULP_UP) - 1] += 1
    bits[np.asarray(ONE_ULP_DOWN) - 1] -= 1
    two_over_ln2 = 2.0 * float(np.float32(1.0 / math.log(2.0)))
    t = (lg.astype(np.float64) * two_over_ln2
         + float(np.float32(3.1))).astype(np.float32)
    return np.concatenate([np.zeros(1, np.float32), t])


def frame_lambdas(qps, lam_scale: float = 1.0):
    """(qp, qpc, lam, ls) per frame as the reference computes them: lambda
    in float64 on the host, then float32."""
    qpa = np.asarray(qps, np.int32)
    lam = 0.57 * lam_scale * 2.0 ** ((qpa.astype(np.float64) - 12) / 3.0)
    ls = np.sqrt(lam)
    qpc = np.asarray([chroma_qp(int(q)) for q in qpa], np.int32)
    return qpa, qpc, lam.astype(np.float32), ls.astype(np.float32)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add a * b + c with one rounding. The float64
    product of two float32 values is exact, and the float64 sum rounds
    only where a float32 rounding follows anyway."""
    return (a.double() * b.double() + c.double()).float()


def _tree(v: torch.Tensor) -> torch.Tensor:
    """Horizontal sum of the last axis by halving (lanes i and i+h)."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _block_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the trailing (n, n) axes in the reference backend's
    vectorised order. n = 4: one lane per row, summed along the row, then
    the 4 lanes by halving. n >= 8: a running scalar enters lane 0 of an
    8-lane vector that takes each row's 8-column chunks in turn, and the
    row's vector is reduced by halving into the running scalar."""
    n = x.shape[-1]
    if n == 4:
        lanes = x[..., 0]
        for c in range(1, 4):
            lanes = lanes + x[..., c]
        return _tree(lanes)
    acc = torch.zeros(x.shape[:-2], dtype=torch.float32, device=x.device)
    for r in range(n):
        v = x[..., r, 0:8].clone()
        v[..., 0] = acc + v[..., 0]
        for k in range(8, n, 8):
            v = v + x[..., r, k:k + 8]
        acc = _tree(v)
    return acc


def _sum2x2(m: torch.Tensor) -> torch.Tensor:
    """(F, 2h, 2w) -> (F, h, w): ((a00 + a01) + a10) + a11."""
    return ((m[:, 0::2, 0::2] + m[:, 0::2, 1::2]) + m[:, 1::2, 0::2]) \
        + m[:, 1::2, 1::2]


def _window_sum(m: torch.Tensor) -> torch.Tensor:
    """The reference backend's tree rewrite of a reduction whose reduced
    dimensions exceed 32: each dimension in windows of min(size, 32),
    zero-padded evenly on both sides to a multiple of the window, every
    window summed in row-major order from 0. (F, h, w) -> the (F, h', w')
    window sums."""
    F, h, w = m.shape
    wh, ww = min(h, 32), min(w, 32)
    ph, pw = -h % wh, -w % ww
    p = torch.nn.functional.pad(m, (pw // 2, pw - pw // 2,
                                    ph // 2, ph - ph // 2))
    H, W = p.shape[1:]
    win = p.reshape(F, H // wh, wh, W // ww, ww).permute(0, 1, 3, 2, 4) \
        .reshape(F, H // wh, W // ww, wh * ww)
    acc = torch.zeros(win.shape[:-1], dtype=m.dtype, device=m.device)
    for i in range(wh * ww):
        acc = acc + win[..., i]
    return acc


def _frame_sum(m: torch.Tensor) -> torch.Tensor:
    """(F, h, w) -> (F,): the frame total in the reference backend's order.
    With a dimension above 32, the window sums of `_window_sum` first.
    Then, as its vectorised loop takes the map: with more than 8 columns a
    running total enters lane 0 of an 8-lane vector that takes each row's
    8-column chunks in turn (a short last chunk in the first lanes) and is
    reduced by halving at the row's end (maps of 8 x 10, 6 x 10, 2 x 12);
    with at most 8 columns and 4 or 8 rows each row summed in order and
    the rows by halving (4 x 4, 4 x 6, 8 x 8); otherwise row-major in
    order (3 x 4, 10 x 6, and the window sums at 1280x768). Other shapes
    are not held against the reference (the total feeds only rate
    control)."""
    while max(m.shape[1:]) > 32:
        m = _window_sum(m)
    F, h, w = m.shape
    if w > 8:
        acc = torch.zeros((F,), dtype=m.dtype, device=m.device)
        for r in range(h):
            v = torch.zeros((F, 8), dtype=m.dtype, device=m.device)
            v[:, 0] = acc
            for k in range(0, w, 8):
                ch = m[:, r, k:k + 8]
                v[:, :ch.shape[1]] = v[:, :ch.shape[1]] + ch
            acc = _tree(v)
        return acc
    if h in (4, 8):
        acc = m[:, :, 0]
        for c in range(1, w):
            acc = acc + m[:, :, c]
        return _tree(acc)
    acc = m[:, 0, 0]
    for i in range(1, h * w):
        acc = acc + m[:, i // w, i % w]
    return acc


def _source_refs(plane: torch.Tensor, n: int) -> torch.Tensor:
    """(F, h, w) int32 -> (F, nby*nbx, 4n+1) refs from source pixels,
    raster-causal availability (left/top of the picture edge missing)."""
    F, h, w = plane.shape
    dev = plane.device
    nby, nbx = h // n, w // n
    by = torch.arange(nby, device=dev)[:, None, None]
    bx = torch.arange(nbx, device=dev)[None, :, None]
    i = torch.arange(2 * n, device=dev)[None, None, :]
    ly = torch.minimum(by * n + i, torch.tensor(h - 1, device=dev))
    lx = (bx * n - 1).clamp(min=0)
    ly, lx = torch.broadcast_tensors(ly, lx)
    left = plane[:, ly, lx]                                 # (F,nby,nbx,2n)
    ty = (by * n - 1).clamp(min=0)
    tx = torch.minimum(bx * n + i, torch.tensor(w - 1, device=dev))
    ty, tx = torch.broadcast_tensors(ty, tx)
    top = plane[:, ty, tx]
    corner = plane[:, (by[..., 0] * n - 1).clamp(min=0),
                   (bx[..., 0] * n - 1).clamp(min=0)]       # (F,nby,nbx)
    has_l = (torch.arange(nbx, device=dev) > 0)[None, :].expand(nby, nbx)
    has_t = (torch.arange(nby, device=dev) > 0)[:, None].expand(nby, nbx)
    l0, t0 = left[..., :1], top[..., :1]
    left = torch.where(has_l[..., None], left, t0)
    top = torch.where(has_t[..., None], top, l0)
    corner = torch.where(has_l & has_t, corner,
                         torch.where(has_t, t0[..., 0],
                                     torch.where(has_l, l0[..., 0], 0)))
    refs = torch.cat([left, corner[..., None], top], -1)
    refs = torch.where((has_l | has_t)[..., None], refs, 128)
    return refs.reshape(F, nby * nbx, 4 * n + 1).to(torch.int32)


def _filter_refs(refs: torch.Tensor, n: int) -> torch.Tensor:
    """[1 2 1] smoothing over the bottom-left..top-right contour."""
    n2 = 2 * n
    ext = torch.cat([refs[..., :n2].flip(-1), refs[..., n2:]], -1)
    sm = ext.clone()
    sm[..., 1:-1] = (ext[..., :-2] + 2 * ext[..., 1:-1] + ext[..., 2:] + 2) >> 2
    return torch.cat([sm[..., :n2].flip(-1), sm[..., n2:]], -1)


def _blocks(plane: torch.Tensor, n: int) -> torch.Tensor:
    """(F, h, w) -> (F, nby*nbx, n, n) raster blocks."""
    F, h, w = plane.shape
    return plane.reshape(F, h // n, n, w // n, n).transpose(2, 3) \
        .reshape(F, -1, n, n)


def _mpm_bits(best0: torch.Tensor, n: int, nby: int, nbx: int):
    """(F, B) first-round modes -> (F, B, 35) float32 mode bits from the
    MPM lists (spec 8.4.2) of the same-size neighbour grid; an above
    neighbour in another CTB row counts as DC."""
    F = best0.shape[0]
    m = best0.reshape(F, nby, nbx).to(torch.int32)
    one = torch.ones_like(m[:, :, :1])
    a = torch.cat([one, m[:, :, :-1]], 2)
    b = torch.cat([torch.ones_like(m[:, :1]), m[:, :-1]], 1)
    same_row = ((torch.arange(nby, device=m.device) * n) % 64 != 0)
    b = torch.where(same_row[None, :, None], b, 1)
    eq, ang = a == b, a >= 2
    m0 = torch.where(eq, torch.where(ang, a, 0), a)
    m1 = torch.where(eq, torch.where(ang, 2 + ((a + 29) % 32), 1), b)
    third = torch.where((a != 0) & (b != 0), 0,
                        torch.where((a != 1) & (b != 1), 1, 26))
    m2 = torch.where(eq, torch.where(ang, 2 + ((a - 1) % 32), 26), third)
    allm = torch.arange(35, device=m.device)
    m0, m1, m2 = (x.reshape(F, -1, 1) for x in (m0, m1, m2))
    return torch.where(allm == m0, _BITS_MPM0,
                       torch.where((allm == m1) | (allm == m2), _BITS_MPM12,
                                   _BITS_REM)).to(torch.float32)


def _rough_tu_cost(res: torch.Tensor, qp: torch.Tensor, n: int,
                   btab: torch.Tensor):
    """Rough RD of a batch of TUs: real forward transform + deadzone quant,
    coefficient-domain dequant error as distortion, the closed-form level
    rate. res (..., n, n) int32, qp of shape res.shape[:-2].
    Returns (D_pix, bits) float32 of shape res.shape[:-2]."""
    log2 = n.bit_length() - 1
    q = qp.reshape(-1)
    a = forward_transform(res.reshape(-1, n, n), log2).abs()
    lev = quantize(a, q, log2)
    derr = (a - dequantize(lev, q, log2)).to(torch.float32)
    lead = res.shape[:-2]
    D = _block_sum(derr * derr).reshape(lead) * 4.0 ** (log2 - 7)
    bits = _block_sum(btab[lev.long()]).reshape(lead)
    return D, bits


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (F, B, M, ...) at idx (F, B, K) along dim 2 -> (F, B, K, ...)."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 3))
    return torch.gather(x, 2, idx.expand(idx.shape[:3] + x.shape[3:]))


def candidate_list(seed: torch.Tensor) -> torch.Tensor:
    """The seeded tiers' compact candidate lists, as pass A's kernel builds
    them: per CU its parent mode, the parent's two angular neighbours,
    planar, DC, 26 and 10, in that order, a mode already listed becoming
    -1. seed (...) parent modes -> (..., 7) int64."""
    par = seed.to(torch.int64)
    ang = par.clamp(min=2)
    cand = torch.stack([
        par, torch.where(par >= 2, 2 + ((ang - 2 + 1) % 33), 0),
        torch.where(par >= 2, 2 + ((ang - 2 + 32) % 33), 1),
        torch.zeros_like(par), torch.ones_like(par),
        torch.full_like(par, 26), torch.full_like(par, 10)], -1)
    dup = (cand[..., :, None] == cand[..., None, :]).tril(-1).any(-1)
    return torch.where(dup, -1, cand)


def _parents(mode16: torch.Tensor, n: int) -> torch.Tensor:
    """A seeded tier's parent modes from the 16 tier's (F, h16, w16) mode
    map: the 8 tier takes its 16-block's mode, the 32 tier the mode of its
    top-left 16-block."""
    if n == 8:
        return mode16.repeat_interleave(2, 1).repeat_interleave(2, 2)
    return mode16[:, ::2, ::2]


def _pass_a(planes, n: int, seed=None):
    """Pass A of one tier: every mode's prediction from the source refs,
    the 8x8-Hadamard SATDs, the candidates (all 35, or the seed's
    `candidate_list`) and best0, the SATD-only winner among them. planes
    (F, h, w) int32, seed (F, h/n, w/n) parent modes or None. Returns
    (preds (F, B, 35, n, n), blocks (F, B, n, n), satd (F, B, 35), in_cand
    (F, B, 35) bool or None, best0 (F, B))."""
    F = planes.shape[0]
    refs = _source_refs(planes, n).reshape(-1, 4 * n + 1)
    refs_f = _filter_refs(refs, n)
    blocks = _blocks(planes, n)                              # (F, B, n, n)
    B = blocks.shape[1]
    preds = tintra.predict_all_modes(refs, refs_f, n, True).reshape(
        F, B, 35, n, n)
    costs = tcost.satd(preds, blocks[:, :, None], 8)
    if seed is None:
        return preds, blocks, costs, None, costs.argmin(-1)
    cand = candidate_list(seed.reshape(F, B))
    in_cand = (cand[..., None] == torch.arange(35, device=planes.device)) \
        .any(-2)                                             # (F, B, 35)
    big = torch.iinfo(costs.dtype).max
    return preds, blocks, costs, in_cand, \
        torch.where(in_cand, costs, big).argmin(-1)


def pass_a_plain(planes: torch.Tensor, n: int, seed16=None):
    """Plain version of `decide_pass_a_cuda`: planes (F, H, W) uint8,
    seed16 the 16 tier's (F, H/16, W/16) modes or None. Returns (satd
    (F, B, 35) int32, 0 at non-candidates; best0 (F, B) int32)."""
    seed = _parents(seed16, n) if seed16 is not None else None
    _, _, costs, in_cand, best0 = _pass_a(planes.to(torch.int32), n, seed)
    if in_cand is not None:
        costs = torch.where(in_cand, costs, 0)
    return costs.to(torch.int32), best0.to(torch.int32)


def _tier(planes, cbs, crs, qp, qpc, lam, ls, n: int, btab, seed=None,
          effort: int = 0, luma_cost: bool = False):
    """Mode, chroma mode and rough-RD cost maps of one CU size for all
    frames. planes (F, h, w), chroma (F, h/2, w/2) int32; qp/qpc (F,)
    int32; lam/ls (F,) float32; seed (F, nby, nbx) parent modes or None
    (full 35-mode search); effort 1 judges the top 3 modes by rough RD and
    searches the 5 chroma candidates. Returns (mode, cost, chroma mode) as
    (F, nby, nbx), and with luma_cost also the luma-only cost
    D + lam * ((R + mode_bits) + hdr), taken before chroma is added (the
    NxN tier compares with it)."""
    F, h, w = planes.shape
    nby, nbx = h // n, w // n
    dev = planes.device
    preds, blocks, costs, in_cand, best0 = _pass_a(planes, n, seed)
    B = blocks.shape[1]
    costs = costs.to(torch.float32)
    inf = torch.tensor(float("inf"), device=dev)
    mbits = _mpm_bits(best0, n, nby, nbx)
    j = fma32(ls[:, None, None], mbits, costs)
    if in_cand is not None:
        j = torch.where(in_cand, j, inf)
    # the rough-RD candidates: the best mode, or the 3 best with ties to
    # the lower mode; the first minimum of their rough cost in rank order
    K = 3 if effort else 1
    cand_idx = torch.sort(j, stable=True).indices[..., :K]      # (F, B, K)
    pred_k = _gather(preds, cand_idx)                     # (F, B, K, n, n)
    Dk, rbk = _rough_tu_cost(blocks[:, :, None] - pred_k,
                             qp[:, None, None].expand(F, B, K), n, btab)
    mb_k = torch.gather(mbits, 2, cand_idx)
    ki = fma32(lam[:, None, None], rbk + mb_k, Dk).argmin(-1)[..., None]
    best = torch.gather(cand_idx, 2, ki)[..., 0]                 # (F, B)
    mode_bits, D, rbits = (torch.gather(x, 2, ki)[..., 0]
                           for x in (mb_k, Dk, rbk))
    if luma_cost:
        cl = fma32(lam[:, None], (rbits + mode_bits) + _HDR_BITS[n], D)
    nc = n // 2
    qpcb = qpc[:, None].expand(F, B)
    crefs = [_source_refs(cp, nc).reshape(-1, 4 * nc + 1) for cp in (cbs,
                                                                     crs)]
    cblocks = [_blocks(cp, nc) for cp in (cbs, crs)]
    if effort:
        # chroma candidates: planar, 26, 10, DC (34 where equal to DM), DM
        fixed = torch.tensor([0, 26, 10, 1], device=dev)
        cands = torch.cat([torch.where(fixed == best[..., None], 34, fixed),
                           best[..., None]], -1)                  # (F, B, 5)
        cbits = torch.tensor([_BITS_CHROMA] * 4 + [_BITS_DM],
                             dtype=torch.float32, device=dev)
        csatd = torch.zeros(cands.shape, dtype=torch.float32, device=dev)
        for cr_, cb_ in zip(crefs, cblocks):
            cpreds = tintra.predict_all_modes(cr_, cr_, nc, False).reshape(
                F, B, 35, nc, nc)
            sat = tcost.satd(cpreds, cb_[:, :, None], 8).to(torch.float32)
            csatd = csatd + torch.gather(sat, 2, cands)
        ci = fma32(ls[:, None, None], cbits, csatd).argmin(-1)[..., None]
        cmode = torch.gather(cands, 2, ci)[..., 0]
        cmode_bits = cbits[ci[..., 0]]
    else:
        cmode = best
    for cr_, cb_ in zip(crefs, cblocks):
        cpred = tintra.predict_mode(cr_, cr_, cmode.reshape(-1), nc,
                                    False).reshape(F, B, nc, nc)
        Dc, rbc = _rough_tu_cost(cb_ - cpred, qpcb, nc, btab)
        D = D + Dc
        rbits = rbits + rbc
    if effort:
        rtot = ((rbits + mode_bits) + cmode_bits) + _HDR_BITS[n]
    else:
        rtot = (rbits + mode_bits) + _HDR_PLUS_DM[n]
    cost = fma32(lam[:, None], rtot, D)
    shape = (F, nby, nbx)
    out = (best.reshape(shape).to(torch.int32), cost.reshape(shape),
           cmode.reshape(shape).to(torch.int32))
    return out + (cl.reshape(shape),) if luma_cost else out


def _size4_luma(planes, qp, lam, ls, btab):
    """The NxN tier's 4x4 luma decision (reference `_size4_luma`): all 35
    modes from unsmoothed source refs (HEVC never smooths 4x4 luma refs)
    by 4x4 SATD, MPM lists from the SATD-only winners, the least
    `satd + ls * mode_bits`, and the winner's rough RD terms: D and the
    rate (R + mode_bits) + 1 (one cbf_luma bin per PU; the rough transform
    is the 4x4 DCT, as in the reference). planes (F, h, w) int32. Returns
    (mode4, D, rate) as (F, h/4, w/4)."""
    F, h, w = planes.shape
    nby, nbx = h // 4, w // 4
    refs = _source_refs(planes, 4).reshape(-1, 17)
    blocks = _blocks(planes, 4)                              # (F, B, 4, 4)
    B = blocks.shape[1]
    preds = tintra.predict_all_modes(refs, refs, 4, True).reshape(
        F, B, 35, 4, 4)
    costs = tcost.satd(preds, blocks[:, :, None], 4).to(torch.float32)
    mbits = _mpm_bits(costs.argmin(-1), 4, nby, nbx)
    ki = fma32(ls[:, None, None], mbits, costs).argmin(-1)[..., None]
    pred = _gather(preds, ki)[:, :, 0]
    D, rbits = _rough_tu_cost(blocks - pred, qp[:, None].expand(F, B), 4,
                              btab)
    rate = (rbits + torch.gather(mbits, 2, ki)[..., 0]) + 1.0
    shape = (F, nby, nbx)
    return (ki[..., 0].reshape(shape).to(torch.int32), D.reshape(shape),
            rate.reshape(shape))


def nxn_plain(planes, qp, lam, ls, cl8, cost8, btab):
    """The NxN tier at the 8x8 CU (reference `_decide_one`'s `nxn`
    branch): the four 4x4 PUs' cost plus lam * 16 against the 8x8 CU's
    luma-only cost `cl8`; where NxN wins, its cost takes the luma part's
    place: (cost8 - cl8) + nxn_cost. The reference backend computes each
    PU's cost D + lam * rate inside the loop of the 2x2 sum and contracts
    it with the running total: acc = fma(lam, rate, acc + D) in raster
    order. Arguments as `nxn_cuda`'s, planes of any integer type, and
    `btab` the rough cost's bits table (`bits_table()` on the planes'
    device). Returns (mode4, nxn8, cost8)."""
    mode4, D, rate = _size4_luma(planes.to(torch.int32), qp, lam, ls, btab)
    lam3 = lam[:, None, None]
    acc = torch.zeros_like(cost8)
    for dy in (0, 1):
        for dx in (0, 1):
            acc = fma32(lam3, rate[:, dy::2, dx::2], acc + D[:, dy::2, dx::2])
    nxn_cost = acc + lam3 * 16.0
    nxn8 = nxn_cost < cl8
    return mode4, nxn8, torch.where(nxn8, (cost8 - cl8) + nxn_cost, cost8)


def decide_frames_plain(planes: torch.Tensor, cbs: torch.Tensor,
                        crs: torch.Tensor, qp: torch.Tensor,
                        qpc: torch.Tensor, lam: torch.Tensor,
                        ls: torch.Tensor, effort: int = 0,
                        nxn: bool = False) -> dict:
    """Plain PyTorch version of the decision pass. planes (F, ph, pw)
    uint8, chroma (F, ph/2, pw/2) uint8, per-frame qp/qpc int32 and
    lam/ls float32 (`frame_lambdas`), effort 0 or 1. Returns the 13 maps
    of MAP_NAMES as (F, ...) tensors. The NxN tier runs where `nxn` and
    effort 1; otherwise mode4 and nxn8 are zero, as the reference returns
    them."""
    y, cb, cr = (p.to(torch.int32) for p in (planes, cbs, crs))
    btab = torch.as_tensor(bits_table(), device=planes.device)
    args = (y, cb, cr, qp, qpc, lam, ls)
    t16 = _tier(*args, 16, btab, effort=effort)
    nxn_maps = None
    if effort:
        t8 = _tier(*args, 8, btab, effort=1, luma_cost=nxn)
        if nxn:
            mode8, cost8, cm8, cl8 = t8
            mode4, nxn8, cost8 = nxn_plain(y, qp, lam, ls, cl8, cost8, btab)
            t8, nxn_maps = (mode8, cost8, cm8), (mode4, nxn8)
        t32 = _tier(*args, 32, btab, effort=1)
    else:
        mode16 = t16[0]
        t8 = _tier(*args, 8, btab, _parents(mode16, 8))
        t32 = _tier(*args, 32, btab, _parents(mode16, 32))
    return _splits(t8, t16, t32, nxn_maps)


def _splits(t8, t16, t32, nxn_maps=None) -> dict:
    """The split maps and the frame total from the (mode, cost, chroma
    mode) maps of the three tiers."""
    (mode8, cost8, cm8), (mode16, cost16, cm16), (mode32, cost32, cm32) = \
        t8, t16, t32
    c8sum = _sum2x2(cost8)
    split16 = c8sum < cost16
    c16sum = _sum2x2(torch.minimum(c8sum, cost16))
    split32 = c16sum < cost32
    cplx = _frame_sum(torch.minimum(c16sum, cost32))
    return _maps(split32, split16, cplx, t8, t16, t32, nxn_maps)


def _maps(split32, split16, cplx, t8, t16, t32, nxn_maps=None) -> dict:
    """The 13 maps by name; without the NxN tier's (mode4 (F, ph/4, pw/4)
    int32, nxn8 (F, ph/8, pw/8)) mode4 and nxn8 are zero."""
    (mode8, cost8, cm8), (mode16, cost16, cm16), (mode32, _, cm32) = \
        t8, t16, t32
    F, h8, w8 = mode8.shape
    dev = mode8.device
    if nxn_maps is None:
        nxn_maps = (torch.zeros((F, 2 * h8, 2 * w8), dtype=torch.int32,
                                device=dev),
                    torch.zeros((F, h8, w8), dtype=torch.bool, device=dev))
    return dict(split32=split32.bool(), mode16=mode16, mode32=mode32,
                cplx=cplx, split16=split16.bool(), mode8=mode8,
                cm8=cm8, cm16=cm16, cm32=cm32, cost8=cost8, cost16=cost16,
                mode4=nxn_maps[0], nxn8=nxn_maps[1].bool())


def decide_frames(planes: torch.Tensor, cbs: torch.Tensor,
                  crs: torch.Tensor, qps, lam_scale: float = 1.0,
                  effort: int = 0, nxn: bool = False,
                  reference: bool = False) -> dict:
    """The decision pass for a batch of padded frames on their device. Any
    nonzero effort is effort 1, as in the reference (`ops/decide.py`
    tests `if effort`); the NxN tier runs where `nxn` and effort 1. CUDA
    tensors launch the kernels (csrc/decide.cu); CPU tensors, or
    reference=True, run `decide_frames_plain`."""
    effort = 1 if effort else 0
    nxn = bool(nxn) and effort == 1
    qpa, qpca, lam, ls = frame_lambdas(qps, lam_scale)
    dev = planes.device
    args = (torch.as_tensor(qpa, device=dev), torch.as_tensor(qpca, device=dev),
            torch.as_tensor(lam, device=dev), torch.as_tensor(ls, device=dev))
    if dev.type != "cuda" or reference:
        return decide_frames_plain(planes, cbs, crs, *args, effort=effort,
                                   nxn=nxn)
    return decide_frames_cuda(planes, cbs, crs, *args, effort=effort,
                              nxn=nxn)


def _check_planes(planes, *chroma) -> None:
    """planes (F, H, W) and any chroma planes (F, H/2, W/2): contiguous
    uint8 CUDA tensors, padded to the 64x64 CTB grid."""
    F, H, W = planes.shape
    for t, shape in ((planes, (F, H, W)),) + tuple(
            (c, (F, H // 2, W // 2)) for c in chroma):
        if (t.dtype != torch.uint8 or tuple(t.shape) != shape
                or not t.is_cuda or not t.is_contiguous()):
            raise ValueError("planes must be contiguous uint8 CUDA tensors "
                             "(F, H, W) and (F, H/2, W/2)")
    if H % 64 or W % 64:
        raise ValueError("planes must be padded to the 64x64 CTB grid")


def decide_pass_a_cuda(planes, n: int, seed16=None):
    """Pass A of the n tier on the card (`ks_decide_pass_a`): per CU the
    8x8-Hadamard SATD of every candidate mode (all 35, or with seed16, the
    (F, H/16, W/16) 16 tier's modes, the 7 seeded candidates) and best0,
    the SATD-only winner. planes (F, H, W) uint8 CUDA, padded to 64.
    Returns (satd (F, B, 35) int32, 0 at non-candidates; best0 (F, B)
    int32), B the tier's CUs in raster order."""
    from ..interop import device_tables
    _check_planes(planes)
    F, H, W = planes.shape
    dev = planes.device
    nb = (H // n) * (W // n)
    satd = torch.empty((F, nb, 35), dtype=torch.int32, device=dev)
    best0 = torch.empty((F, nb), dtype=torch.int32, device=dev)
    P = _build.ptr
    _build.check(_build.kernels().ks_decide_pass_a(
        P(planes), P(seed16) if seed16 is not None else None, P(satd),
        P(best0), P(device_tables(dev)), F, H, W, n, int(seed16 is not None),
        _build.stream(dev)), "ks_decide_pass_a")
    _build.count("decide_pass_a")
    return satd, best0


def decide_pass_b_cuda(planes, cbs, crs, satd, best0, seed16, qp, qpc, lam,
                       ls, n: int, effort: int, luma_cost: bool = False):
    """Pass B of the n tier on the card (`ks_decide_pass_b`) from pass A's
    satd and best0: MPM lists, the rough-RD candidates, the chroma mode and
    the cost. qp/qpc, lam/ls: per-frame (F,) tensors on the card.
    Returns (mode, cost, cmode, cl) as (F, H/n, W/n) maps; cl, the
    luma-only cost, with luma_cost (effort 1) only, else None."""
    from ..interop import device_bits_table, device_tables
    _check_planes(planes, cbs, crs)
    F, H, W = planes.shape
    dev = planes.device
    qp, qpc = qp.to(torch.int32).contiguous(), qpc.to(torch.int32).contiguous()
    lam, ls = lam.float().contiguous(), ls.float().contiguous()
    mode, cmode = (torch.empty((F, H // n, W // n), dtype=torch.int32,
                               device=dev) for _ in range(2))
    cost = torch.empty((F, H // n, W // n), dtype=torch.float32, device=dev)
    cl = torch.empty_like(cost) if luma_cost else None
    P = _build.ptr
    opt = (lambda t: P(t) if t is not None else None)
    _build.check(_build.kernels().ks_decide_pass_b(
        P(planes), P(cbs), P(crs), P(satd), P(best0), opt(seed16), P(qp),
        P(qpc), P(lam), P(ls), P(device_bits_table(dev)),
        P(device_tables(dev)), P(mode), P(cost), P(cmode), opt(cl), F, H, W,
        n, int(seed16 is not None), int(effort), _build.stream(dev)),
        "ks_decide_pass_b")
    _build.count("decide_pass_b")
    return mode, cost, cmode, cl


def decide_frames_cuda(planes, cbs, crs, qp, qpc, lam, ls,
                       effort: int = 0, nxn: bool = False) -> dict:
    """The decision pass on the card: `decide_pass_a_cuda` and
    `decide_pass_b_cuda` per tier (16, then 8 and 32, seeded from the 16
    tier at effort 0), with `nxn` (effort 1) the NxN tier's
    `ks_decide_nxn_a` and `ks_decide_nxn_b` after the 8 tier, then
    `ks_decide_split` per frame."""
    if nxn and not effort:
        raise ValueError("the NxN tier runs at effort 1 only")
    F, H, W = planes.shape
    dev = planes.device
    lib = _build.kernels()
    qp, qpc = qp.to(torch.int32).contiguous(), qpc.to(torch.int32).contiguous()
    lam, ls = lam.float().contiguous(), ls.float().contiguous()
    P, st = _build.ptr, _build.stream(dev)
    tiers = {}
    cl8 = None
    for n in (16, 8, 32):
        seed = tiers[16][0] if n != 16 and not effort else None
        satd, best0 = decide_pass_a_cuda(planes, n, seed)
        mode, cost, cmode, cl = decide_pass_b_cuda(
            planes, cbs, crs, satd, best0, seed, qp, qpc, lam, ls, n, effort,
            luma_cost=nxn and n == 8)
        if cl is not None:
            cl8 = cl
        tiers[n] = (mode, cost, cmode)
    h8, w8 = H // 8, W // 8
    nxn_maps = None
    if nxn:
        mode4, nxn8, cost8 = nxn_cuda(planes, qp, lam, ls, cl8, tiers[8][1])
        tiers[8] = (tiers[8][0], cost8, tiers[8][2])
        nxn_maps = (mode4, nxn8)
    split16 = torch.empty((F, h8 // 2, w8 // 2), dtype=torch.uint8,
                          device=dev)
    split32 = torch.empty((F, h8 // 4, w8 // 4), dtype=torch.uint8,
                          device=dev)
    cplx = torch.empty((F,), dtype=torch.float32, device=dev)
    mins = torch.empty((F, h8 // 4, w8 // 4), dtype=torch.float32,
                       device=dev)
    _build.check(lib.ks_decide_split(
        P(tiers[8][1]), P(tiers[16][1]), P(tiers[32][1]), P(split16),
        P(split32), P(cplx), P(mins), F, h8, w8, st), "ks_decide_split")
    _build.count("decide_split")
    return _maps(split32, split16, cplx, tiers[8], tiers[16], tiers[32],
                 nxn_maps)


def nxn_cuda(planes, qp, lam, ls, cl8, cost8):
    """The NxN tier on the card (`nxn_plain` is its plain version):
    `ks_decide_nxn_a` (35 modes' 4x4 SATDs and best0 per 4x4 block), then
    `ks_decide_nxn_b` (per 8x8 CU the PUs' modes and costs against cl8).
    planes (F, H, W) uint8 CUDA, qp int32 / lam, ls float32 (F,), cl8 and
    cost8 (F, H/8, W/8) float32. Returns (mode4 (F, H/4, W/4) int32, nxn8
    (F, H/8, W/8) uint8, the new cost8)."""
    from ..interop import device_bits_table, device_tables
    F, H, W = planes.shape
    dev = planes.device
    for t in (cl8, cost8):
        if (t.dtype != torch.float32 or tuple(t.shape) != (F, H // 8, W // 8)
                or not t.is_contiguous() or t.device != dev):
            raise ValueError("cl8 and cost8 must be contiguous float32 "
                             "(F, H/8, W/8) tensors on the planes' device")
    lib = _build.kernels()
    tab, btab = device_tables(dev), device_bits_table(dev)
    P, st = _build.ptr, _build.stream(dev)
    nb4 = (H // 4) * (W // 4)
    satd4 = torch.empty((F, nb4, 35), dtype=torch.int32, device=dev)
    best04 = torch.empty((F, nb4), dtype=torch.int32, device=dev)
    _build.check(lib.ks_decide_nxn_a(P(planes), P(satd4), P(best04), P(tab),
                                     F, H, W, st), "ks_decide_nxn_a")
    _build.count("decide_nxn_a")
    mode4 = torch.empty((F, H // 4, W // 4), dtype=torch.int32, device=dev)
    nxn8 = torch.empty((F, H // 8, W // 8), dtype=torch.uint8, device=dev)
    out = torch.empty_like(cost8)
    _build.check(lib.ks_decide_nxn_b(
        P(planes), P(satd4), P(best04), P(qp), P(lam), P(ls), P(btab),
        P(tab), P(cl8), P(cost8), P(out), P(mode4), P(nxn8), F, H, W, st),
        "ks_decide_nxn_b")
    _build.count("decide_nxn_b")
    return mode4, nxn8, out
