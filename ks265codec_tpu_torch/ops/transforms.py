"""HEVC transforms and quantization as plain PyTorch on int32 tensors.

Counterpart of ks265codec_tpu/ops/transforms.py (forward/inverse DCT 4-32,
DST 4x4, quant/dequant) and of the inlined `_fwd_quant`/`_dequant_itx` of
ops/wavefront.py. The matrix products run in float64, which is exact here:
|residual or coefficient| < 2^16 and |T| <= 90, so every product and every
sum of at most 32 of them stays below 2^53. The CUDA kernels (csrc/) inline
the same integer arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hevc.tables import DCT, DST4, LEVEL_SCALE, QUANT_SCALE

_T = {n: np.asarray(DCT[n], np.int32) for n in (4, 8, 16, 32)}
_TDST = np.asarray(DST4, np.int32)


def _mat(n: int, device, is_dst: bool = False) -> torch.Tensor:
    return torch.as_tensor(_TDST if is_dst else _T[n], dtype=torch.float64,
                           device=device)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int-valued tensors (see module note)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def _clip16(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(-32768, 32767)


def forward_transform(resi: torch.Tensor, log2: int, is_dst: bool = False,
                      bd: int = 8) -> torch.Tensor:
    """Encoder forward transform (HM staged shifts), batch (N, n, n) int32."""
    t = _mat(1 << log2, resi.device, is_dst)
    shift1 = log2 + bd - 9
    shift2 = log2 + 6
    e = _mm(t, resi)
    if shift1 > 0:
        e = (e + (1 << (shift1 - 1))) >> shift1
    return (_mm(e, t.T) + (1 << (shift2 - 1))) >> shift2


def inverse_transform(coeffs: torch.Tensor, log2: int, is_dst: bool = False,
                      bd: int = 8) -> torch.Tensor:
    """Spec 8.6.4.2 two-stage inverse transform, batch (N, n, n) int32."""
    t = _mat(1 << log2, coeffs.device, is_dst)
    e = _clip16((_mm(t.T, coeffs) + 64) >> 7)
    shift2 = 20 - bd
    return _clip16((_mm(e, t) + (1 << (shift2 - 1))) >> shift2)


def _qp_col(qp, like: torch.Tensor) -> torch.Tensor:
    """qp as an int32 tensor broadcastable over (N, n, n)."""
    q = torch.as_tensor(qp, dtype=torch.int32, device=like.device)
    return q.reshape(-1, 1, 1) if q.ndim else q


def quantize(coeffs: torch.Tensor, qp, log2: int, bd: int = 8,
             intra: bool = True) -> torch.Tensor:
    """Deadzone quantization, batch (N, n, n); qp scalar or (N,)."""
    q = _qp_col(qp, coeffs)
    qbits = 29 + q // 6 - bd - log2
    scale = torch.as_tensor(QUANT_SCALE, dtype=torch.int32,
                            device=coeffs.device)[q % 6]
    rnd = torch.bitwise_left_shift(torch.full_like(qbits, 171 if intra else 85),
                                   qbits - 9)
    lev = ((coeffs.abs() * scale + rnd) >> qbits).clamp(0, 32767)
    return torch.where(coeffs < 0, -lev, lev)


def dequantize(levels: torch.Tensor, qp, log2: int,
               bd: int = 8) -> torch.Tensor:
    """Spec 8.6.3 dequant with the flat scaling matrix, batch (N, n, n)."""
    q = _qp_col(qp, levels)
    s = bd + log2 - 5
    p = q // 6
    scale = torch.as_tensor(LEVEL_SCALE, dtype=torch.int32,
                            device=levels.device)[q % 6]
    tv = levels * (16 * scale)
    sp = (s - p).clamp(min=0)
    ps = (p - s).clamp(min=0)
    one = torch.ones_like(sp)
    rnd = torch.where(s - p >= 1, one << (s - p - 1).clamp(min=0), 0)
    return _clip16(((tv + rnd) >> sp) << ps)


def fwd_quant(resi: torch.Tensor, qp, n: int,
              rdoq: bool = False) -> torch.Tensor:
    """Forward DCT, then RDOQ (encode/rdoq.py) or intra deadzone
    quantization (ops/wavefront._fwd_quant of an intra block)."""
    log2 = n.bit_length() - 1
    c = forward_transform(resi, log2)
    if rdoq:
        from ..encode.rdoq import rdoq as rdoq_levels
        return rdoq_levels(c, qp, n, log2)
    return quantize(c, qp, log2)


def dequant_itx(levels: torch.Tensor, qp, n: int) -> torch.Tensor:
    """Dequant + inverse DCT (ops/wavefront._dequant_itx)."""
    log2 = n.bit_length() - 1
    return inverse_transform(dequantize(levels, qp, log2), log2)
