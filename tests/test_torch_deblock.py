"""K7: the port's plain deblocking against the JAX package's
deblock_frame_device, on the cases tests/test_device_filters.py uses:
exact equality of all three planes."""

import numpy as np
import pytest
import torch

from ks265codec_tpu.ops.deblock import deblock_frame_device
from ks265codec_tpu.ops.deblock import intra_bs_maps as jax_bs_maps
from ks265codec_tpu_torch.ops import deblock as tdb
from _torch_shared import release_after_module  # noqa: F401


def _random_log2m(rng, h8, w8):
    """Quadtree-consistent CU-size map on the 8-cell grid (32/16/8 per
    aligned 32-block)."""
    log2m = np.full((h8, w8), 3, np.uint8)
    for y0 in range(0, h8, 4):
        for x0 in range(0, w8, 4):
            c = rng.randint(0, 3)
            if c == 0:
                log2m[y0:y0 + 4, x0:x0 + 4] = 5
            elif c == 1:
                for yy in range(0, 4, 2):
                    for xx in range(0, 4, 2):
                        log2m[y0 + yy:y0 + yy + 2, x0 + xx:x0 + xx + 2] = \
                            4 if rng.randint(2) else 3
    return log2m


def _blocky(rng, h, w):
    """Smooth content with a random offset per 8x8 block: block edges the
    filters act on, next to flat areas they leave alone."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 40 * np.sin(xx / 13.0) * np.cos(yy / 17.0)
    steps = np.repeat(np.repeat(rng.randint(-8, 9, (h // 8, w // 8)), 8, 0),
                      8, 1)
    return np.clip(base + steps + rng.randint(-2, 3, (h, w)), 0, 255) \
        .astype(np.int32)


@pytest.mark.parametrize("dims,qp,offs", [
    ((192, 128), 32, (0, 0, 0, 0)),
    ((176, 144), 24, (1, -1, 2, -2)),   # non-aligned + nonzero offsets
    ((64, 64), 45, (0, 0, -3, 3)),
])
def test_deblock_matches_jax(dims, qp, offs):
    rng = np.random.RandomState(11)
    w, h = dims
    boff, toff, cbo, cro = offs
    sw, sh = (w + 15) // 16 * 16, (h + 15) // 16 * 16
    ph, pw = (sh + 63) // 64 * 64, (sw + 63) // 64 * 64
    y, cb, cr = (_blocky(rng, hh, ww) for hh, ww in
                 ((ph, pw), (ph // 2, pw // 2), (ph // 2, pw // 2)))
    log2m = _random_log2m(rng, ph // 8, pw // 8)
    bs_v, bs_h = tdb.intra_bs_maps(log2m)
    # per-8-cell QPs around qp so that qp_p != qp_q at some edges
    qp8 = np.clip(qp + rng.randint(-3, 4, (ph // 8, pw // 8)), 0, 51)
    qp4 = np.repeat(np.repeat(qp8, 2, 0), 2, 1).astype(np.uint8)
    want = deblock_frame_device(y, cb, cr, bs_v, bs_h, qp4, boff, toff,
                                cbo, cro, sw, sh)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))[None]
    got = tdb.deblock_frames(t(y.astype(np.uint8)), t(cb.astype(np.uint8)),
                             t(cr.astype(np.uint8)),
                             t(bs_v.astype(np.uint8)),
                             t(bs_h.astype(np.uint8)), t(qp4), boff, toff,
                             cbo, cro, sw, sh)
    for name, g, w_ in zip(("y", "cb", "cr"), got, want):
        assert np.array_equal(g[0].numpy(), np.asarray(w_)), name
    assert not np.array_equal(got[0][0].numpy(), y.astype(np.uint8))


def test_intra_bs_maps_copy_matches():
    rng = np.random.RandomState(5)
    log2m = _random_log2m(rng, 16, 24)
    for a, b in zip(tdb.intra_bs_maps(log2m), jax_bs_maps(log2m)):
        assert np.array_equal(a, b)
