"""Constant tables the kernels read, built from numpy arrays.

A codec carries no learned weights; what crosses from the reference is the
constant tables (DCT matrices, quant/dequant scales, intra angles, deblock
beta/tc, the chroma QP map). `tables_from_numpy` packs them into the one
int32 device tensor the CUDA kernels take; the offsets below are the ones
csrc/tables.cuh names. `device_tables` builds it from the port's own copy
of hevc/tables.py, once per device.
"""

from __future__ import annotations

import numpy as np
import torch

# name -> (offset, length); keep in step with csrc/tables.cuh
LAYOUT = {
    "dct4": (0, 16), "dct8": (16, 64), "dct16": (80, 256),
    "dct32": (336, 1024), "quant_scale": (1360, 6), "level_scale": (1366, 6),
    "pred_angle": (1372, 33), "inv_angle": (1405, 33), "beta": (1438, 52),
    "tc": (1490, 54), "chroma_qp": (1544, 80),
}
SIZE = 1624


def tables_from_numpy(dct: dict, quant_scale, level_scale, pred_angle,
                      inv_angle, beta, tc, chroma_qp_map) -> np.ndarray:
    """Pack the tables into one int32 vector. dct: {4, 8, 16, 32} -> (n, n)
    matrices; pred_angle: intraPredAngle of modes 2..34; inv_angle:
    invAngle of modes 11..25; chroma_qp_map: QpC for qPi = 0..79."""
    out = np.zeros(SIZE, np.int32)

    def put(name, vals):
        off, n = LAYOUT[name]
        v = np.asarray(vals, np.int32).reshape(-1)
        if v.size != n:
            raise ValueError(f"{name}: expected {n} values, got {v.size}")
        out[off:off + n] = v

    for n in (4, 8, 16, 32):
        put(f"dct{n}", dct[n])
    put("quant_scale", quant_scale)
    put("level_scale", level_scale)
    put("pred_angle", pred_angle)
    inv = np.zeros(33, np.int32)
    inv[11 - 2:25 - 2 + 1] = np.asarray(inv_angle, np.int32)
    put("inv_angle", inv)
    put("beta", beta)
    put("tc", tc)
    put("chroma_qp", chroma_qp_map)
    return out


def port_tables() -> np.ndarray:
    """The packed tables from the port's copy of hevc/tables.py."""
    from .hevc import tables as T
    return tables_from_numpy(T.DCT, T.QUANT_SCALE, T.LEVEL_SCALE,
                             T.INTRA_PRED_ANGLE, T.INV_ANGLE, T.BETA_TABLE,
                             T.TC_TABLE, [T.chroma_qp(i) for i in range(80)])


_cache: dict = {}


def device_tables(device) -> torch.Tensor:
    """`port_tables()` as an int32 tensor on `device` (cached)."""
    key = ("int", str(device))
    if key not in _cache:
        _cache[key] = torch.as_tensor(port_tables(), device=device)
    return _cache[key]


def device_log_table(device, base2: bool = False) -> torch.Tensor:
    """The reference backend's float32 log (or `jnp.log2` with base2) of
    the integers 0..32767 on `device` (cached; ops/_logtab.py)."""
    key = ("log2" if base2 else "log", str(device))
    if key not in _cache:
        from .ops._logtab import log2_table, log_table
        _cache[key] = torch.as_tensor(log2_table() if base2
                                      else log_table(), device=device)
    return _cache[key]


def device_bits_table(device) -> torch.Tensor:
    """The decision pass's float32 level-rate table on `device` (cached)."""
    key = ("bits", str(device))
    if key not in _cache:
        from .ops.decide import bits_table
        _cache[key] = torch.as_tensor(bits_table(), device=device)
    return _cache[key]


def device_rank_table(device) -> torch.Tensor:
    """The 4x4 scan-rank table of sign hiding (encode/sbh.py::RANK, 3 x 16
    int32, [scan][y * 4 + x]) on `device` (cached)."""
    key = ("rank", str(device))
    if key not in _cache:
        from .encode.sbh import RANK
        _cache[key] = torch.as_tensor(RANK.reshape(-1), device=device)
    return _cache[key]
