"""Full-search motion estimation (K20) of the sequential P/B host walk:
the dense SAD grid of every block over its candidate window, and the
host searches that read it.

Counterpart of ks265codec_tpu/ops/me.py (`extract_patches`,
`full_search_grid`, `motion_search_frame`, `refine_around`, `_down2`,
`motion_search_frame_hier`; `full_search` has no caller there and is not
ported). The device function is `full_search_grid`:
sad[n, dy, dx] = sum |win[n, dy + i, dx + j] - src[n, i, j]| over the
bs x bs block, for the (2 sr + 1)^2 offsets of each block's window
(N, bs + 2 sr, bs + 2 sr). CUDA tensors launch `ks_me_full_grid`
(csrc/me_full.cu); CPU tensors, or reference=True, run the plain version.

The host searches keep the reference's numpy arithmetic: the window
gathers, the round-1 argmin, the median predictor, the float64 round-2
rate and its `(lam * rate).astype(np.int64)` truncation, the window
clamps of `refine_around`, and `np.argmin`'s first-index ties. Each
uploads its blocks and windows to `device` (CUDA unless the caller names
another) and fetches the grid.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from . import _build


def extract_patches(ref: np.ndarray, bs: int, sr: int) -> np.ndarray:
    """Host helper: per-block padded search windows.

    ref: (H, W) int, the (edge-padded to block grid) reference plane.
    Returns (nby*nbx, bs+2sr, bs+2sr) windows centred on each block,
    edge-clamped at picture borders."""
    h, w = ref.shape
    pad = np.pad(ref, sr, mode="edge")
    nby, nbx = h // bs, w // bs
    win = bs + 2 * sr
    out = np.empty((nby * nbx, win, win), ref.dtype)
    k = 0
    for by in range(nby):
        for bx in range(nbx):
            y0, x0 = by * bs, bx * bs   # +sr offset cancels with pad
            out[k] = pad[y0:y0 + win, x0:x0 + win]
            k += 1
    return out


# ------------------------------------------------------- the device function

def full_search_grid_plain(src_blocks: torch.Tensor, windows: torch.Tensor,
                           bs: int, sr: int) -> torch.Tensor:
    """Plain version: one window row offset dy at a time, the bs-wide
    sliding windows along x (`unfold`), |.| summed in int32."""
    n_off = 2 * sr + 1
    src = src_blocks.to(torch.int32)
    win = windows.to(torch.int32)
    out = torch.empty((src.shape[0], n_off, n_off), dtype=torch.int32,
                      device=src.device)
    for dy in range(n_off):
        rows = win[:, dy:dy + bs, :].unfold(2, bs, 1)    # (N, bs, n, bs)
        out[:, dy] = (rows - src[:, :, None, :]).abs().sum(
            (1, 3), dtype=torch.int32)
    return out


def full_search_grid_cuda(src_blocks: torch.Tensor, windows: torch.Tensor,
                          bs: int, sr: int) -> torch.Tensor:
    """`ks_me_full_grid`: one thread block per block, its window and
    block in shared memory, one thread per offset."""
    n, win = src_blocks.shape[0], bs + 2 * sr
    for t, shape in ((src_blocks, (n, bs, bs)), (windows, (n, win, win))):
        if t.dtype != torch.int32 or not t.is_cuda or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(f"full_search_grid: expected a contiguous int32 "
                             f"CUDA tensor of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    n_off = 2 * sr + 1
    out = torch.empty((n, n_off, n_off), dtype=torch.int32,
                      device=src_blocks.device)
    if n == 0:
        return out
    lib = _build.kernels()
    P = _build.ptr
    _build.check(lib.ks_me_full_grid(P(src_blocks), P(windows), P(out), n,
                                     bs, sr, _build.stream(out.device)),
                 "ks_me_full_grid")
    _build.count("me_full_grid")
    return out


def full_search_grid(src_blocks: torch.Tensor, windows: torch.Tensor,
                     bs: int, sr: int, reference: bool = False):
    """Dense SAD grid over all offsets: (N, 2sr+1, 2sr+1) int32 from
    src_blocks (N, bs, bs) and windows (N, bs+2sr, bs+2sr) int32. CUDA
    tensors launch the kernel; CPU tensors, or reference=True, run the
    plain version."""
    if src_blocks.device.type != "cuda" or reference:
        return full_search_grid_plain(src_blocks, windows, bs, sr)
    return full_search_grid_cuda(src_blocks.contiguous(),
                                 windows.contiguous(), bs, sr)


def _grid(blocks: np.ndarray, windows: np.ndarray, bs: int, sr: int,
          device, reference: bool) -> np.ndarray:
    """Upload, run `full_search_grid` and fetch its grid as numpy."""
    dev = resolve_device(device)
    t = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
         for a in (blocks, windows)]
    return full_search_grid(*t, bs, sr, reference=reference).cpu().numpy()


def blocks_of(src_y: np.ndarray, bs: int) -> np.ndarray:
    """(nby * nbx, bs, bs) int32 blocks of a plane in raster order."""
    h, w = src_y.shape
    nby, nbx = h // bs, w // bs
    return (src_y.astype(np.int32)
            .reshape(nby, bs, nbx, bs).swapaxes(1, 2)
            .reshape(-1, bs, bs))


# ------------------------------------------------------------ host searches

def motion_search_frame(src_y: np.ndarray, ref_y: np.ndarray, bs: int,
                        sr: int, lam: float, device=None,
                        reference: bool = False):
    """Blocks + windows -> per-block integer MVs (quarter-pel scaled) and
    costs. Shapes: planes padded to the block grid.

    Two rounds, as in the reference: round 1 takes the unbiased SAD
    argmin per block; round 2 re-ranks the whole grid with the mvd rate
    against the median of the round-1 neighbour MVs."""
    h, w = src_y.shape
    nby, nbx = h // bs, w // bs
    blocks = blocks_of(src_y, bs)
    windows = extract_patches(ref_y.astype(np.int32), bs, sr)
    sad = _grid(blocks, windows, bs, sr, device, reference)
    n_off = 2 * sr + 1
    flat = sad.reshape(-1, n_off * n_off)
    best1 = np.argmin(flat, axis=1)
    mv1y = (best1 // n_off - sr).reshape(nby, nbx)
    mv1x = (best1 % n_off - sr).reshape(nby, nbx)

    def med3(a):
        p = np.pad(a, 1, mode="edge")
        return np.median(np.stack([p[1:-1, :-2], p[:-2, 1:-1],
                                   p[:-2, 2:]]), axis=0).astype(np.int32)

    px = np.clip(med3(mv1x), -sr, sr).reshape(-1)
    py = np.clip(med3(mv1y), -sr, sr).reshape(-1)
    offs = np.arange(n_off) - sr
    rx = 2.0 * np.log2(1.0 + 4 * np.abs(offs[None, :] - px[:, None]))
    ry = 2.0 * np.log2(1.0 + 4 * np.abs(offs[None, :] - py[:, None]))
    rate = ry[:, :, None] + rx[:, None, :]            # (N, dy, dx)
    cost = sad + (lam * rate).astype(np.int64)
    flatc = cost.reshape(-1, n_off * n_off)
    best = np.argmin(flatc, axis=1)
    mv = np.stack([best % n_off - sr, best // n_off - sr], axis=1) * 4
    bsad = np.take_along_axis(flat, best[:, None], axis=1)[:, 0]
    bcost = np.take_along_axis(flatc, best[:, None], axis=1)[:, 0]
    return (mv.astype(np.int32).reshape(nby, nbx, 2),
            bcost.reshape(nby, nbx), bsad.reshape(nby, nbx))


def refine_around(src_y: np.ndarray, ref_y: np.ndarray, bs: int,
                  centers: np.ndarray, rr: int, device=None,
                  reference: bool = False):
    """+-rr full-pel dense refinement around per-block centres
    (nby, nbx, 2) full-pel (dx, dy); the windows are clamped to stay in
    the edge pad. Returns (mv full-pel (nby, nbx, 2), sad (nby, nbx))."""
    h, w = src_y.shape
    nby, nbx = h // bs, w // bs
    win = bs + 2 * rr
    pad = np.pad(np.asarray(ref_y, np.int32), rr + 1, mode="edge")
    cy = (np.arange(nby) * bs)[:, None] + np.zeros((1, nbx), np.intp)
    cx = (np.arange(nbx) * bs)[None, :] + np.zeros((nby, 1), np.intp)
    oy = np.clip(centers[..., 1], -cy, h - cy - bs)  # windows stay in pad
    ox = np.clip(centers[..., 0], -cx, w - cx - bs)
    y0 = (cy + oy + 1).astype(np.intp)
    x0 = (cx + ox + 1).astype(np.intp)
    wins = pad[y0.reshape(-1)[:, None, None]
               + np.arange(win)[None, :, None],
               x0.reshape(-1)[:, None, None]
               + np.arange(win)[None, None, :]]
    sad = _grid(blocks_of(src_y, bs), wins, bs, rr, device, reference)
    n_off = 2 * rr + 1
    flat = sad.reshape(-1, n_off * n_off)
    best = np.argmin(flat, axis=1)
    dy = best // n_off - rr
    dx = best % n_off - rr
    mv = np.stack([ox.reshape(-1) + dx, oy.reshape(-1) + dy],
                  axis=1).astype(np.int32)
    bsad = np.take_along_axis(flat, best[:, None], axis=1)[:, 0]
    return mv.reshape(nby, nbx, 2), bsad.reshape(nby, nbx)


def down2(p):
    """2x2 box downsample with rounding, (sum + 2) >> 2, in int32."""
    p = np.asarray(p, np.int32)
    return (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2]
            + p[1::2, 1::2] + 2) >> 2


def motion_search_frame_hier(src_y: np.ndarray, ref_y: np.ndarray,
                             bs: int, merange: int, lam: float, device=None,
                             reference: bool = False):
    """Wide-range pyramid search: dense full search at quarter resolution
    (+-clip(merange / 4, 8, 16)), then +-3 refinements at half and full
    resolution. Returns quarter-pel MVs like motion_search_frame."""
    h, w = src_y.shape
    nby, nbx = h // bs, w // bs
    hs, hr = down2(src_y), down2(ref_y)
    qs, qr = down2(hs), down2(hr)
    sr_q = int(np.clip(merange // 4, 8, 16))
    bq = max(bs // 4, 4)
    mv_q, _, _ = motion_search_frame(qs, qr, bq, sr_q, lam, device,
                                     reference)
    # quarter-level blocks may be coarser than bs/4: replicate to grid
    mv_q = (np.asarray(mv_q) >> 2)                   # full-pel @ quarter
    qby, qbx = mv_q.shape[:2]
    ry = max(1, nby // qby)
    rx = max(1, nbx // qbx)
    cen_h = np.repeat(np.repeat(mv_q * 2, ry, 0), rx, 1)[:nby, :nbx]
    mv_h, _ = refine_around(hs, hr, max(bs // 2, 4), cen_h, 3, device,
                            reference)
    cen_f = mv_h * 2
    mv_f, sad = refine_around(src_y, ref_y, bs, cen_f, 3, device, reference)
    return mv_f * 4, sad.astype(np.int64).copy(), sad
