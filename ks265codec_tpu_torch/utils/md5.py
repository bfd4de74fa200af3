"""Per-plane MD5 hashing for conformance checks.

Matches the reference decoder's `-md5 1` output format:
`POC n MD5 <y_hex>,<u_hex>,<v_hex>` (SURVEY.md 2.1 libmd5 / run-verified).
"""

from __future__ import annotations

import hashlib

import numpy as np

from .yuv import YUVFrame


def md5_plane(plane: np.ndarray) -> str:
    return hashlib.md5(np.ascontiguousarray(plane).tobytes()).hexdigest()


def frame_md5(frame: YUVFrame) -> tuple[str, str, str]:
    return md5_plane(frame.y), md5_plane(frame.u), md5_plane(frame.v)


def format_md5_line(frame: YUVFrame) -> str:
    y, u, v = frame_md5(frame)
    return f"POC {frame.poc} MD5 {y},{u},{v}"
