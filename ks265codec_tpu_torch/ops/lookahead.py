"""Lookahead features (K12): the 2x2 box downsample of the luma and, per
8x8 block of the half-resolution plane, a 4-mode intra cost and a +-8
full-search inter cost against the previous half-resolution frame.

Counterpart of ks265codec_tpu/ops/lookahead.py (`downsample2x`,
`_intra_cost`, `_inter_cost`, `_features_core`, `frame_features_batch`,
`frame_features_first`). Every cost is an exact int32 sum; the per-frame
head [sum icost, sum pcost, sum min(icost, pcost)] is summed in int32 and
cast to float32 only at the end, as the reference does, so the order of
the sums does not matter. The winning inter offset is the first of the
289 in (dy, dx) raster order on ties. The 8x8 variance map (adaptive
quantisation) is not ported: AQ is outside the port's envelope.

CUDA: csrc/lookahead.cu, one launch for the downsample (one thread per
half-res sample) and one for the features (one thread block per 8x8
half-res block: one thread per inter offset, a packed (SAD, index)
min-reduction in shared memory, the intra modes in one warp).
"""

from __future__ import annotations

import torch

from . import _build

BS = 8          # feature block size on the half-res plane
SR = 8          # inter search range (half-res samples)
NSR = 2 * SR + 1


def _check(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.uint8 or t.dim() != 3:
        raise ValueError(f"{what} must be (F, H, W) uint8")


# ------------------------------------------------------- plain PyTorch path

def downsample2x_plain(y: torch.Tensor) -> torch.Tensor:
    """(F, H, W) uint8 -> (F, H/2, W/2) uint8, (sum of 2x2 + 2) >> 2."""
    F, H, W = y.shape
    a = y.to(torch.int32).reshape(F, H // 2, 2, W // 2, 2).sum((2, 4))
    return ((a + 2) >> 2).to(torch.uint8)


def _blk(a: torch.Tensor) -> torch.Tensor:
    F, h, w = a.shape
    return a.reshape(F, h // BS, BS, w // BS, BS).transpose(2, 3)


def intra_cost_plain(p: torch.Tensor) -> torch.Tensor:
    """(F, h, w) half planes -> (F, nby, nbx) int32 min of the DC,
    vertical, horizontal and planar-ish SAD from the block's border."""
    x = p.to(torch.int32)
    top = torch.cat([x[:, :1], x[:, :-1]], 1)
    left = torch.cat([x[:, :, :1], x[:, :, :-1]], 2)
    b = _blk(x)
    trow = _blk(top)[..., 0:1, :]
    lcol = _blk(left)[..., :, 0:1]
    dc = torch.div(trow.sum(-1, keepdim=True) + lcol.sum(-2, keepdim=True)
                   + BS, 2 * BS, rounding_mode="floor")
    costs = [(b - m).abs().sum((-2, -1))
             for m in (dc, trow, lcol, torch.div(trow + lcol, 2,
                                                 rounding_mode="floor"))]
    return torch.minimum(torch.minimum(costs[0], costs[1]),
                         torch.minimum(costs[2], costs[3]))


def inter_cost_plain(cur: torch.Tensor, prev: torch.Tensor):
    """(F, h, w) half planes -> (cost, dx, dy), each (F, nby, nbx) int32:
    the least 8x8 SAD over the +-8 offsets into the edge-padded previous
    plane, first offset in (dy, dx) raster order on ties."""
    F, h, w = cur.shape
    c = cur.to(torch.int32)
    pad = torch.nn.functional.pad(prev.to(torch.float32)[:, None],
                                  (SR, SR, SR, SR), mode="replicate")[:, 0]
    pad = pad.to(torch.int32)
    sads = torch.stack([
        _blk((c - pad[:, dy:dy + h, dx:dx + w]).abs()).sum((-2, -1))
        for dy in range(NSR) for dx in range(NSR)], -1)
    best, ai = sads.min(-1)
    return best, ai % NSR - SR, ai // NSR - SR


def block_var_plain(curs: torch.Tensor) -> torch.Tensor:
    """(F, h, w) uint8 half planes -> (F, nby, nbx) float32 8x8 variance in
    the reference backend's order (see the module note). Each fused
    multiply-add is exact in float64 and rounded once to float32."""
    b = _blk(curs.to(torch.float64))
    mean = (b.sum((-2, -1)) * 0.015625)[..., None, None]
    d = b - mean                                   # exact
    lanes = torch.zeros(b.shape[:-1], dtype=torch.float64, device=b.device)
    for c in range(BS):
        lanes = (d[..., c] * d[..., c] + lanes).to(torch.float32) \
            .to(torch.float64)
    return _tree32(lanes.to(torch.float32)) * 0.015625


def _tree32(v: torch.Tensor) -> torch.Tensor:
    """float32 sum of the last axis by halving (lanes i and i + h)."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _pack(ic, pc, dx, dy, want_tree: bool, first: bool,
          var=None) -> torch.Tensor:
    """Packed float32 rows [icost_sum, pcost_sum, min_sum (+ variance map)
    (+ tree maps)]."""
    F = ic.shape[0]
    s_i = ic.reshape(F, -1).sum(1, dtype=torch.int32)
    if first:
        head = torch.stack([s_i.float(), torch.full_like(s_i.float(), 1e18),
                            s_i.float()], 1)
    else:
        s_p = pc.reshape(F, -1).sum(1, dtype=torch.int32)
        s_m = torch.minimum(ic, pc).reshape(F, -1).sum(1, dtype=torch.int32)
        head = torch.stack([s_i, s_p, s_m], 1).float()
    parts = [head]
    if var is not None:
        parts.append(var.reshape(F, -1).to(head.device))
    if want_tree:
        parts += [a.reshape(F, -1).float() for a in (ic, pc, dx, dy)]
    return torch.cat(parts, 1)


def features_plain(curs: torch.Tensor, prevs: torch.Tensor):
    """(ic, pc, dx, dy) maps of a batch of half planes against their
    previous half planes."""
    pc, dx, dy = inter_cost_plain(curs, prevs)
    return intra_cost_plain(curs), pc, dx, dy


# ------------------------------------------------------------- CUDA kernel

def downsample2x_cuda(y: torch.Tensor) -> torch.Tensor:
    _check(y, "luma")
    if not y.is_cuda or not y.is_contiguous():
        raise ValueError("luma must be a contiguous CUDA tensor")
    F, H, W = y.shape
    out = torch.empty((F, H // 2, W // 2), dtype=torch.uint8,
                      device=y.device)
    rc = _build.kernels().ks_la_downsample(_build.ptr(y), _build.ptr(out),
                                           F, H, W, _build.stream(y.device))
    _build.check(rc, "ks_la_downsample")
    _build.count("la_downsample")
    return out


def features_cuda(curs: torch.Tensor, prevs: torch.Tensor):
    for t, what in ((curs, "current"), (prevs, "previous")):
        _check(t, what + " half planes")
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(what + " half planes must be contiguous CUDA")
    if curs.shape != prevs.shape:
        raise ValueError("current and previous half planes differ in shape")
    F, h, w = curs.shape
    if h % BS or w % BS:
        raise ValueError("half planes must be multiples of 8")
    nby, nbx = h // BS, w // BS
    maps = torch.empty((4, F, nby, nbx), dtype=torch.int32,
                       device=curs.device)
    rc = _build.kernels().ks_la_features(
        _build.ptr(curs), _build.ptr(prevs), _build.ptr(maps), F, h, w,
        _build.stream(curs.device))
    _build.check(rc, "ks_la_features")
    _build.count("la_features")
    return maps[0], maps[1], maps[2], maps[3]


def block_var_cuda(curs: torch.Tensor) -> torch.Tensor:
    _check(curs, "half planes")
    if not curs.is_cuda or not curs.is_contiguous():
        raise ValueError("half planes must be contiguous CUDA")
    F, h, w = curs.shape
    if h % BS or w % BS:
        raise ValueError("half planes must be multiples of 8")
    out = torch.empty((F, h // BS, w // BS), dtype=torch.float32,
                      device=curs.device)
    rc = _build.kernels().ks_la_var(_build.ptr(curs), _build.ptr(out), F, h,
                                    w, _build.stream(curs.device))
    _build.check(rc, "ks_la_var")
    _build.count("la_var")
    return out


# ------------------------------------------------------------- entry points

def _use_plain(t: torch.Tensor, reference: bool) -> bool:
    return t.device.type != "cuda" or reference


def downsample2x(y: torch.Tensor, reference: bool = False) -> torch.Tensor:
    """(F, H, W) uint8 -> (F, H/2, W/2) uint8."""
    if _use_plain(y, reference):
        return downsample2x_plain(y)
    return downsample2x_cuda(y.contiguous())


def _features(curs, prevs, reference):
    if _use_plain(curs, reference):
        return features_plain(curs, prevs)
    return features_cuda(curs.contiguous(), prevs.contiguous())


def block_var(curs: torch.Tensor, reference: bool = False) -> torch.Tensor:
    """(F, h, w) uint8 half planes -> (F, h/8, w/8) float32 8x8 variance
    (`_block_stats`)."""
    if _use_plain(curs, reference):
        return block_var_plain(curs)
    return block_var_cuda(curs.contiguous())


def frame_features_batch(curs: torch.Tensor, prevs: torch.Tensor,
                         want_var: bool = False, want_tree: bool = False,
                         reference: bool = False) -> torch.Tensor:
    """(F, h, w) half planes against their previous half planes ->
    (F, 3 [+ nb] [+ 4 nb]) float32 packed rows (the variance map with
    want_var, the tree maps with want_tree). CUDA tensors launch the
    kernels; CPU tensors, or reference=True, run the plain versions."""
    ic, pc, dx, dy = _features(curs, prevs, reference)
    var = block_var(curs, reference) if want_var else None
    return _pack(ic, pc, dx, dy, want_tree, first=False, var=var)


def frame_features_first(half_cur: torch.Tensor, want_var: bool = False,
                         want_tree: bool = False,
                         reference: bool = False) -> torch.Tensor:
    """The first frame of a stream (no inter reference): (1, 3 [+ nb]
    [+ 4 nb]) with pcost 1e18 (and pcost map 1e9, zero offsets with
    want_tree)."""
    cur = half_cur[None] if half_cur.dim() == 2 else half_cur
    ic, _, _, _ = _features(cur, cur, reference)
    var = block_var(cur, reference) if want_var else None
    z = torch.zeros_like(ic)
    out = _pack(ic, z, z, z, want_tree, first=True, var=var)
    if want_tree:
        nb = ic[0].numel()
        off = 3 + (nb if want_var else 0)
        out[:, off + nb:off + 2 * nb] = 1e9
    return out
