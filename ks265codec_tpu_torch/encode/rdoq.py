"""RDOQ-lite: the rate-distortion level choice of the `fast` and slower
presets (K2 with sign-bit hiding, encode/sbh.py).

Counterpart of ks265codec_tpu/encode/rdoq.py (`_rdoq_core`, `rdoq_jnp`).
Per coefficient, with f = |c| * quantScale / 2^qbits the continuous level,
the level among {0, floor(f), floor(f) + 1} that minimises
(f - l)^2 + W * bits(l) in float32, with a context-free bit model; then a
4x4 group (raster group layout) whose only survivors are at most three
level-1 coefficients below f = 0.9 is dropped. Every step is elementwise
float32 or integer, so the plain version here, the reference and the
kernel agree exactly when each float32 operation rounds once:
  * |c| * quantScale is int32 and its conversion to float32 rounds to
    nearest even; the scale 2^-qbits is exact;
  * j = d*d + W*bits is two roundings (the reference's jitted form; its
    fused forms choose the same levels on every input probed);
  * a candidate replaces the best only where its j is strictly smaller.

`rdoq_np` is the reference's numpy twin for one TU, which the per-CU
host walk runs (encode/intra_frame.py, encode/inter_frame.py).
`rdoq_sbh` is one quantisation step of a batch of TUs as the coding
passes run it (RDOQ or deadzone rounding, then sign hiding); CUDA tensors
launch `ks_rdoq_sbh` (csrc/rdoq.cu), CPU tensors run `rdoq_sbh_plain`.
The intra scan (K6) and the inter coding pass (K17) inline the same
device functions (csrc/rdoq.cuh).
"""

from __future__ import annotations

import numpy as np
import torch

from ..hevc.tables import QUANT_SCALE

W_RATE = 0.09           # lambda / qstep^2, QP-independent
B1 = 3.5                # bits of a level-1 coefficient
B2D = 1.0               # bits(2) - bits(1)
BESC = 1.5              # escape base of levels >= 3
DEC_F = 0.9             # group decimation: level-1 survivors below this f
DEC_N = 3               # ... and at most this many of them

RDOQ, SBH, INTER = 1, 2, 4      # `ks_rdoq_sbh` flag bits

# 2^-qbits, exact in float32, for every qbits a QP can give
_POW2 = torch.from_numpy(np.ldexp(np.float32(1.0), -np.arange(64))
                         .astype(np.float32))


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def rdoq(c: torch.Tensor, qp: torch.Tensor, n: int, log2: int) -> torch.Tensor:
    """RDOQ levels of a batch of TUs: c (K, n, n) signed int32 transform
    coefficients, qp (K,) int32. Returns signed int32 levels."""
    q = torch.as_tensor(qp, dtype=torch.int32, device=c.device).reshape(-1,
                                                                       1, 1)
    qbits = 29 + q // 6 - 8 - log2
    scale = torch.as_tensor(QUANT_SCALE, dtype=torch.int32,
                            device=c.device)[q.long() % 6]
    t = c.abs().to(torch.int32) * scale
    f = t.to(torch.float32) * _POW2.to(c.device)[qbits.long()]
    lf = torch.floor(f).to(torch.int32)
    best_l = torch.zeros_like(lf)
    best_j = f * f
    w, b1, b2, besc = (_f32(v, f) for v in (W_RATE, B1, B2D, BESC))
    zero = _f32(0.0, f)
    for cand in (lf, lf + 1):
        cand = cand.clamp(0, 32767)
        d = f - cand.to(torch.float32)
        e = (cand - 2).clamp(min=1)
        flog = torch.zeros_like(e)
        for k in range(1, 15):
            flog = flog + ((e >> k) > 0).to(torch.int32)
        bits = (torch.where(cand >= 1, b1, zero)
                + torch.where(cand >= 2, b2, zero)
                + torch.where(cand >= 3, besc + 2.0 * flog.to(torch.float32),
                              zero))
        j = d * d + w * bits
        take = j < best_j
        best_l = torch.where(take, cand, best_l)
        best_j = torch.where(take, j, best_j)
    # group decimation over 4x4 groups in raster group layout
    K = c.shape[0]
    g = best_l.reshape(K, n // 4, 4, n // 4, 4)
    gf = f.reshape(K, n // 4, 4, n // 4, 4)
    nz = (g > 0).sum((2, 4))
    weak = ((g == 0) | ((g == 1) & (gf < _f32(DEC_F, f)))).all(4).all(2)
    drop = ((nz > 0) & (nz <= DEC_N) & weak)[:, :, None, :, None]
    lev = torch.where(drop, 0, g).reshape(K, n, n)
    return torch.where(c < 0, -lev, lev).to(torch.int32)


def rdoq_sbh_plain(c: torch.Tensor, qp: torch.Tensor, scan: torch.Tensor,
                   n: int, flags: int) -> torch.Tensor:
    """Levels of a batch of TUs from their transform coefficients c
    (K, n, n) int32: RDOQ where `flags & RDOQ`, else deadzone rounding
    (inter 85/512 where `flags & INTER`, intra 171/512), then sign hiding
    with each TU's scan index where `flags & SBH`."""
    from ..ops.transforms import quantize
    from .sbh import apply_sbh
    log2 = n.bit_length() - 1
    if flags & RDOQ:
        lev = rdoq(c, qp, n, log2)
    else:
        lev = quantize(c, qp, log2, intra=not flags & INTER)
    if flags & SBH:
        lev = apply_sbh(lev, scan, n)
    return lev.to(torch.int32)


def rdoq_sbh_cuda(c: torch.Tensor, qp: torch.Tensor, scan: torch.Tensor,
                  n: int, flags: int) -> torch.Tensor:
    """`rdoq_sbh_plain` on the card: one launch of `ks_rdoq_sbh`, one
    thread block per TU."""
    from ..interop import device_rank_table, device_tables
    from ..ops import _build
    if c.dtype != torch.int32 or not c.is_cuda or c.dim() != 3 \
            or tuple(c.shape[1:]) != (n, n):
        raise ValueError("coefficients must be an int32 CUDA tensor "
                         "(K, n, n)")
    dev = c.device
    c = c.contiguous()
    qp = qp.to(device=dev, dtype=torch.int32).contiguous()
    scan = scan.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(c)
    P = _build.ptr
    _build.check(_build.kernels().ks_rdoq_sbh(
        P(c), P(qp), P(scan), P(device_rank_table(dev)),
        P(device_tables(dev)), P(out), c.shape[0], n, int(flags),
        _build.stream(dev)), "ks_rdoq_sbh")
    _build.count("rdoq_sbh")
    return out


def rdoq_sbh(c: torch.Tensor, qp: torch.Tensor, scan: torch.Tensor, n: int,
             flags: int, reference: bool = False) -> torch.Tensor:
    """Quantise a batch of TUs (see `rdoq_sbh_plain`). CUDA tensors launch
    the kernel; CPU tensors, or reference=True, run the plain version."""
    if c.device.type != "cuda" or reference:
        return rdoq_sbh_plain(c, qp.to(c.device), scan.to(c.device), n,
                              flags)
    return rdoq_sbh_cuda(c, qp, scan, n, flags)


# ------------------------------------------- host copy for the host walk

def _rdoq_core_np(c: np.ndarray, f: np.ndarray) -> np.ndarray:
    """The reference's `_rdoq_core` with numpy as its backend, for one TU:
    c signed int coefficients (n, n), f = |continuous level| float32.
    Returns signed int32 levels."""
    f32 = np.float32
    lf = np.floor(f).astype(np.int32)
    best_l = np.zeros_like(lf)
    best_j = f * f
    for cand in (lf, lf + 1):
        cand = np.clip(cand, 0, 32767)
        d = f - cand.astype(f32)
        # floor(log2(cand-2)) via integer compares (no transcendental)
        e = np.maximum(cand - 2, 1)
        flog = np.zeros(e.shape, np.int32)
        for k in range(1, 15):
            flog = flog + ((e >> k) > 0).astype(np.int32)
        bits = (np.where(cand >= 1, f32(B1), f32(0))
                + np.where(cand >= 2, f32(B2D), f32(0))
                + np.where(cand >= 3, f32(BESC) + f32(2.0) * flog.astype(f32),
                           f32(0)))
        j = d * d + f32(W_RATE) * bits
        take = j < best_j
        best_l = np.where(take, cand, best_l)
        best_j = np.where(take, j, best_j)
    # group decimation (integer/boolean exact): per 4x4 group
    n = best_l.shape[-1]
    g = best_l.reshape(n // 4, 4, n // 4, 4)
    gf = f.reshape(n // 4, 4, n // 4, 4)
    nz = (g > 0).sum(axis=(-3, -1))
    weak = (g == 0) | ((g == 1) & (gf < f32(DEC_F)))
    drop = ((nz > 0) & (nz <= DEC_N)
            & weak.all(axis=(-3, -1)))[..., :, None, :, None]
    lev = np.where(drop, 0, g).reshape(n, n)
    return np.where(c < 0, -lev, lev).astype(np.int32)


def rdoq_np(c: np.ndarray, qp: int, log2: int) -> np.ndarray:
    """RDOQ levels of one TU's signed transform coefficients (n, n) on the
    host (the reference's `rdoq_np`, which its sequential walk runs)."""
    qbits = 29 + qp // 6 - 8 - log2
    t = np.abs(c).astype(np.int64) * QUANT_SCALE[qp % 6]
    # 2^-qbits is exact in float32
    f = t.astype(np.float32) * np.float32(np.ldexp(1.0, -qbits))
    return _rdoq_core_np(c, f)
