"""Intra prediction as plain PyTorch: all 35 modes for a batch of blocks,
and one chosen mode per block; and `build_refs_np`, the host reference
construction of one block that the sequential host walk predicts from
(the reference's numpy function, copied).

Counterpart of ks265codec_tpu/ops/intra.py (`predict_all_modes`, the static
angular tables) and of `_predict_dyn_gather` in ops/wavefront.py. The
angular projection (spec 8.4.4.2.6) is precomputed per (mode, size) as
index/factor tables; the CUDA kernels compute the same projection directly
from the angle tables.

refs layout per block: [left[0..2n-1] (top->bottom) | corner | top[0..2n-1]]
(length 4n+1), one unfiltered and one filtered copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hevc.tables import intra_inv_angle, intra_pred_angle

# mode-dependent reference filtering (spec 8.4.4.2.3): filterFlag per size
_FILTER_THRESH = {4: 10, 8: 7, 16: 1, 32: 0}


def use_filtered_refs(mode: int, n: int) -> bool:
    if mode == 1 or n == 4:
        return False
    if mode == 0:
        return n >= 8
    min_dist = min(abs(mode - 26), abs(mode - 10))
    return min_dist > _FILTER_THRESH[n]


def _build_tables(n: int):
    """(33, 3n+2) ext-gather index, (33, n, n) pred index + factor, and the
    per-mode filtered-refs flag, for angular modes 2..34."""
    ext_idx = np.zeros((33, 3 * n + 2), np.int64)
    g = np.zeros((33, n, n), np.int64)
    f = np.zeros((33, n, n), np.int64)
    for mi, mode in enumerate(range(2, 35)):
        ang = intra_pred_angle(mode)
        ver = mode >= 18
        # refs indices: left[i] = i, corner = 2n, top[i] = 2n+1+i
        main = (lambda i: 2 * n + 1 + i) if ver else (lambda i: i)
        side = (lambda i: i) if ver else (lambda i: 2 * n + 1 + i)
        ext = np.zeros(3 * n + 2, np.int64)
        ext[n] = 2 * n
        for i in range(2 * n):
            ext[n + 1 + i] = main(i)
        if ang < 0:
            inv = intra_inv_angle(mode)
            for xx in range(-1, ((n * ang) >> 5) - 1, -1):
                ext[n + xx] = side(min(((xx * inv + 128) >> 8) - 1, 2 * n - 1))
        ext_idx[mi] = ext
        dist = np.arange(1, n + 1, dtype=np.int64)
        pos = n + 1 + ((dist * ang) >> 5)
        fact = (dist * ang) & 31
        off = np.arange(n)
        if ver:                          # P[y, x] along x
            g[mi] = pos[:, None] + off[None, :]
            f[mi] = np.broadcast_to(fact[:, None], (n, n))
        else:                            # transposed: P[y, x] = pred_t[x, y]
            g[mi] = pos[None, :] + off[:, None]
            f[mi] = np.broadcast_to(fact[None, :], (n, n))
    filt = np.array([1 if use_filtered_refs(m, n) else 0
                     for m in range(2, 35)], np.int64)
    return ext_idx, g, f, filt


_TABLES = {n: _build_tables(n) for n in (4, 8, 16, 32)}
_PLANAR_FILT = {n: int(use_filtered_refs(0, n)) for n in (4, 8, 16, 32)}


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(a, device=device)


def _planar_dc(refs_u, refs_f, n: int, is_luma: bool):
    """Planar (K, n, n), DC (K, n, n) with the luma edge filter, and the
    pure vertical / horizontal edge columns (K, n) for modes 26 / 10."""
    K = refs_u.shape[0]
    dev = refs_u.device
    pl = refs_f if (is_luma and _PLANAR_FILT[n]) else refs_u
    left, top = pl[:, :2 * n], pl[:, 2 * n + 1:]
    x = torch.arange(n, dtype=torch.int32, device=dev)
    tr = top[:, n][:, None, None]
    bl = left[:, n][:, None, None]
    planar = ((n - 1 - x)[None, None, :] * left[:, :n, None]
              + (x + 1)[None, None, :] * tr
              + (n - 1 - x)[None, :, None] * top[:, None, :n]
              + (x + 1)[None, :, None] * bl + n) >> n.bit_length()
    lu, tu, cu = refs_u[:, :2 * n], refs_u[:, 2 * n + 1:], refs_u[:, 2 * n]
    dc = (lu[:, :n].sum(1, dtype=torch.int32)
          + tu[:, :n].sum(1, dtype=torch.int32) + n) >> n.bit_length()
    dcp = dc[:, None, None].expand(K, n, n).clone()
    v26 = h10 = None
    if is_luma and n < 32:
        dcp[:, 0, :] = (tu[:, :n] + 3 * dc[:, None] + 2) >> 2
        dcp[:, 1:, 0] = ((lu[:, :n] + 3 * dc[:, None] + 2) >> 2)[:, 1:]
        dcp[:, 0, 0] = (lu[:, 0] + 2 * dc + tu[:, 0] + 2) >> 2
        v26 = (tu[:, :1] + ((lu[:, :n] - cu[:, None]) >> 1)).clamp(0, 255)
        h10 = (lu[:, :1] + ((tu[:, :n] - cu[:, None]) >> 1)).clamp(0, 255)
    return planar, dcp, v26, h10


def predict_all_modes(refs_u: torch.Tensor, refs_f: torch.Tensor, n: int,
                      is_luma: bool = True) -> torch.Tensor:
    """All 35 intra predictions for a batch: refs (K, 4n+1) int32 ->
    (K, 35, n, n) int32. Chroma passes refs_f = refs_u."""
    ext_idx, g, f, filt = (_t(a, refs_u.device) for a in _TABLES[n])
    K = refs_u.shape[0]
    both = torch.stack([refs_u, refs_f], 1)                  # (K, 2, L)
    sel = filt if is_luma else torch.zeros_like(filt)
    e = both[:, sel[:, None], ext_idx]                        # (K, 33, 3n+2)
    m_ix = torch.arange(33, device=refs_u.device)[:, None, None]
    p1 = e[:, m_ix, g]
    p2 = e[:, m_ix, g + 1]
    ang = ((32 - f) * p1 + f * p2 + 16) >> 5                  # (K, 33, n, n)
    planar, dcp, v26, h10 = _planar_dc(refs_u, refs_f, n, is_luma)
    if v26 is not None:
        ang[:, 26 - 2, :, 0] = v26
        ang[:, 10 - 2, 0, :] = h10
    return torch.cat([planar[:, None], dcp[:, None], ang], 1).to(torch.int32)


def predict_mode(refs_u: torch.Tensor, refs_f: torch.Tensor,
                 modes: torch.Tensor, n: int, is_luma: bool) -> torch.Tensor:
    """Prediction of each block's own mode: refs (K, 4n+1), modes (K,) ->
    (K, n, n) int32 (ops/wavefront._predict_dyn_gather)."""
    ext_idx, g, f, filt = (_t(a, refs_u.device) for a in _TABLES[n])
    K = refs_u.shape[0]
    am = (modes.long() - 2).clamp(0, 32)
    use_f = (filt[am] == 1) if is_luma else torch.zeros_like(am, dtype=torch.bool)
    refs_sel = torch.where(use_f[:, None], refs_f, refs_u)
    e = torch.gather(refs_sel, 1, ext_idx[am])                # (K, 3n+2)
    gm, fm = g[am].reshape(K, -1), f[am]
    p1 = torch.gather(e, 1, gm).reshape(K, n, n)
    p2 = torch.gather(e, 1, gm + 1).reshape(K, n, n)
    ang = ((32 - fm) * p1 + fm * p2 + 16) >> 5
    planar, dcp, v26, h10 = _planar_dc(refs_u, refs_f, n, is_luma)
    if v26 is not None:
        m = modes.long()
        a26 = ang.clone()
        a26[:, :, 0] = v26
        ang = torch.where((m == 26)[:, None, None], a26, ang)
        a10 = ang.clone()
        a10[:, 0, :] = h10
        ang = torch.where((m == 10)[:, None, None], a10, ang)
    m = modes.long()[:, None, None]
    pred = torch.where(m == 0, planar, torch.where(m == 1, dcp, ang))
    return pred.to(torch.int32)


def build_refs_np(plane: np.ndarray, x0: int, y0: int, n: int,
                  avail_fn, pic_w: int, pic_h: int,
                  strong: bool, bd: int = 8, is_luma: bool = True):
    """Host-side reference construction + substitution (spec 8.4.4.2.2) and
    filtering (8.4.4.2.3) for one block. Returns (refs_u, refs_f) (4n+1,).

    avail_fn(x, y) -> bool: sample availability in plane-local coords.
    """
    n2 = 2 * n
    vals = np.zeros(2 * n2 + 1, np.int64)
    ok = np.zeros(2 * n2 + 1, bool)

    def avail(x, y):
        if x < 0 or y < 0 or x >= pic_w or y >= pic_h:
            return False
        return bool(avail_fn(x, y))

    for i in range(n2):          # bottom-left upward
        yy = y0 + n2 - 1 - i
        if avail(x0 - 1, yy):
            vals[i] = plane[yy, x0 - 1]
            ok[i] = True
    if avail(x0 - 1, y0 - 1):
        vals[n2] = plane[y0 - 1, x0 - 1]
        ok[n2] = True
    for i in range(n2):
        xx = x0 + i
        if avail(xx, y0 - 1):
            vals[n2 + 1 + i] = plane[y0 - 1, xx]
            ok[n2 + 1 + i] = True
    if not ok.any():
        vals[:] = 1 << (bd - 1)
    else:
        if not ok[0]:
            vals[0] = vals[np.argmax(ok)]
            ok[0] = True
        for i in range(1, 2 * n2 + 1):
            if not ok[i]:
                vals[i] = vals[i - 1]
    left = vals[:n2][::-1]       # top -> bottom
    corner = vals[n2]
    top = vals[n2 + 1:]
    refs_u = np.concatenate([left, [corner], top]).astype(np.int32)
    if not is_luma:
        return refs_u, refs_u
    # 3-tap [1 2 1] smoothing over bottom-left..top-right, or strong bilinear
    if (strong and n == 32 and
            abs(int(corner) + int(top[n2 - 1]) - 2 * int(top[n - 1])) < (1 << (bd - 5)) and
            abs(int(corner) + int(left[n2 - 1]) - 2 * int(left[n - 1])) < (1 << (bd - 5))):
        idx = np.arange(1, n2 + 1, dtype=np.int64)
        ft = ((64 - idx) * corner + idx * int(top[n2 - 1]) + 32) >> 6
        fl = ((64 - idx) * corner + idx * int(left[n2 - 1]) + 32) >> 6
        ft[n2 - 1] = top[n2 - 1]
        fl[n2 - 1] = left[n2 - 1]
        refs_f = np.concatenate([fl, [corner], ft]).astype(np.int32)
        return refs_u, refs_f
    ext = vals                  # bottom-left..corner..top-right
    sm = ext.copy()
    sm[1:-1] = (ext[:-2] + 2 * ext[1:-1] + ext[2:] + 2) >> 2
    fl = sm[:n2][::-1]
    fc = sm[n2]
    ft = sm[n2 + 1:]
    refs_f = np.concatenate([fl, [fc], ft]).astype(np.int32)
    return refs_u, refs_f
