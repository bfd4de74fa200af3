"""Sign-bit hiding on the encoder side (part of K2).

Per 4x4 coefficient group, when the scan distance between the first and
the last nonzero coefficient exceeds 3, the sign of the first coefficient
in scan order is not coded: the decoder infers it from the parity of the
group's absolute level sum (spec 7.4.9.11). The encoder forces that parity
by +-1 on the hidden coefficient: toward zero where |c| > 1, away from zero
where |c| == 1, so the coefficient stays nonzero.

Counterpart of ks265codec_tpu/encode/sbh.py (`scan_for`, the rank table,
`apply_sbh_jnp`) as plain PyTorch on int32 tensors, and `apply_sbh_np`,
the numpy twin for one TU that the per-CU host walk runs. The CUDA version is
`ks_sbh_group` in csrc/rdoq.cuh, one thread per 4x4 group, run inside the
intra scan (K6), the inter coding pass (K17) and the standalone
`ks_rdoq_sbh` launch (encode/rdoq.py::rdoq_sbh).
"""

from __future__ import annotations

import numpy as np
import torch

from ..hevc.cabac_tables import SCAN_4x4

# RANK[s][y, x] = index of (x, y) in 4x4 scan order s (0 diagonal,
# 1 horizontal, 2 vertical)
RANK = np.zeros((3, 4, 4), np.int32)
for _s in range(3):
    for _r, (_x, _y) in enumerate(SCAN_4x4[_s]):
        RANK[_s, _y, _x] = _r


def scan_for(log2: int, c_idx: int, intra_mode) -> int:
    """scan_idx of a TU (the residual writer's and parser's rule)."""
    if intra_mode is not None and (log2 == 2 or (log2 == 3 and c_idx == 0)):
        if 6 <= intra_mode <= 14:
            return 2
        if 22 <= intra_mode <= 30:
            return 1
    return 0


def scan_sel(modes: torch.Tensor, log2: int, c_idx: int) -> torch.Tensor:
    """`scan_for` over a batch of intra modes (ops/wavefront._scan_sel of
    the reference): mode-dependent only for 4x4 TUs and 8x8 luma TUs."""
    if not (log2 == 2 or (log2 == 3 and c_idx == 0)):
        return torch.zeros_like(modes)
    return torch.where((modes >= 6) & (modes <= 14), 2,
                       torch.where((modes >= 22) & (modes <= 30), 1, 0))


def apply_sbh(lev: torch.Tensor, scan: torch.Tensor, n: int) -> torch.Tensor:
    """Parity fix-up of a batch of TUs: lev (K, n, n) signed int32 levels,
    scan (K,) scan index of each TU. Returns the adjusted levels."""
    K = lev.shape[0]
    g = lev.reshape(K, n // 4, 4, n // 4, 4).transpose(2, 3)   # (K,gy,gx,4,4)
    rank = torch.as_tensor(RANK, device=lev.device)[scan.long()][:, None,
                                                                 None]
    nz = g != 0
    any_nz = nz.any(-1).any(-1)
    mn = torch.where(nz, rank, 99).amin((-2, -1))
    mx = torch.where(nz, rank, -1).amax((-2, -1))
    cond = any_nz & (mx - mn > 3)
    parity = g.abs().sum((-2, -1)) & 1
    hid = nz & (rank == mn[..., None, None])
    hid_val = (g * hid).sum((-2, -1))
    fix = cond & (parity != (hid_val < 0).to(parity.dtype))
    sign = torch.sign(hid_val)
    delta = torch.where(hid_val.abs() > 1, -sign, sign)
    adj = g + torch.where(fix[..., None, None] & hid, delta[..., None, None],
                          0)
    return adj.transpose(2, 3).reshape(K, n, n).to(torch.int32)


def apply_sbh_np(lev: np.ndarray, scan_idx: int) -> np.ndarray:
    """Adjust one TU's levels (n, n) in place-compatible copy."""
    n = lev.shape[0]
    g = lev.reshape(n // 4, 4, n // 4, 4).transpose(0, 2, 1, 3)  # (gy,gx,4,4)
    rank = RANK[scan_idx]
    nz = g != 0
    any_nz = nz.any(axis=(2, 3))
    rk = np.where(nz, rank[None, None], 99)
    mn = rk.min(axis=(2, 3))
    rk2 = np.where(nz, rank[None, None], -1)
    mx = rk2.max(axis=(2, 3))
    cond = any_nz & (mx - mn > 3)
    parity = (np.abs(g).sum(axis=(2, 3)) & 1).astype(np.int32)
    # hidden coefficient = the one whose rank equals mn
    hid_mask = nz & (rank[None, None] == mn[:, :, None, None])
    hid_val = (g * hid_mask).sum(axis=(2, 3))       # unique per group
    want = (hid_val < 0).astype(np.int32)
    fix = cond & (parity != want)
    # |c| > 1 -> toward zero, else away from zero (stays nonzero, parity flips)
    sign = np.sign(hid_val)
    delta = np.where(np.abs(hid_val) > 1, -sign, sign)
    adj = g + np.where((fix[:, :, None, None] & hid_mask), 1, 0) \
        * delta[:, :, None, None]
    return adj.transpose(0, 2, 1, 3).reshape(n, n)
