"""K5: the port's plain decision pass against the JAX package's
decide_frames_jit at effort 0 (ultrafast, superfast) and effort 1 (the
`fast` preset and slower), all 13 maps, on a 3-frame batch at QP 22 / 27 /
37, and on one bench-like 1280x768 frame (the padded 720p shape, where the
reference backend sums the frame total `cplx` in windows): exact
equality, float32 cost maps and the frame total included."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ks265codec_tpu.ops.decide import decide_frames as jax_decide
from ks265codec_tpu_torch.ops import decide as tdec
from _torch_shared import release_after_module  # noqa: F401

W, H = 192, 128
QPS = (22, 27, 37)


def _frames(seed=3):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    ys, us, vs = [], [], []
    for t in range(len(QPS)):
        y = 128 + 60 * np.sin((xx + 3 * t) / 23.0) \
            + 40 * np.cos((yy - 2 * t) / 17.0)
        y[30:70, 40 + 6 * t:80 + 6 * t] = 220 - 3 * t
        y = y + rng.randn(H, W) * (3 + 10 * t)
        u = 128 + 30 * np.sin((xx[::2, ::2] + t) / 31.0) \
            + rng.randn(H // 2, W // 2) * 4
        v = 128 + 30 * np.cos((yy[::2, ::2] - t) / 29.0) \
            + rng.randn(H // 2, W // 2) * 4
        for lst, p in ((ys, y), (us, u), (vs, v)):
            lst.append(np.clip(p, 0, 255).astype(np.uint8))
    return np.stack(ys), np.stack(us), np.stack(vs)


@pytest.fixture(scope="module", params=[0, 1], ids=["effort0", "effort1"])
def both(request):
    y, u, v = _frames()
    ref = jax_decide(y, u, v, list(QPS), 1.0, effort=request.param,
                     want_costs=True)
    got = tdec.decide_frames(torch.from_numpy(y), torch.from_numpy(u),
                             torch.from_numpy(v), list(QPS),
                             effort=request.param)
    return ref, got


@pytest.mark.parametrize("idx,name", list(enumerate(tdec.MAP_NAMES)))
def test_decide_map_equal(both, idx, name):
    ref, got = both
    g = got[name].numpy()
    for f, qp in enumerate(QPS):
        want = np.asarray(ref[f][idx])
        assert g[f].shape == want.shape, (name, qp)
        assert np.array_equal(g[f], want.astype(g.dtype)), (name, qp)


def test_bits_table_matches_reference_log():
    """The level-rate table equals the reference backend's in-pass value
    fma(log(l), 2/ln2, 3.1) for every level 1..32767."""
    lv = np.arange(1, 32768, dtype=np.float32)
    lg = np.asarray(jax.jit(jnp.log)(lv)).astype(np.float64)
    two_r = 2.0 * float(np.float32(1.0 / math.log(2.0)))
    want = (lg * two_r + float(np.float32(3.1))).astype(np.float32)
    got = tdec.bits_table()
    assert got[0] == 0.0
    assert np.array_equal(got[1:], want)


def test_bits_table_is_the_in_pass_rate():
    """One nonzero level per block: the reference's rough rate of the block
    is exactly the table entry."""
    lev = np.zeros((512, 8, 8), np.int32)
    lvals = np.random.RandomState(1).randint(1, 32768, 512)
    lev[np.arange(512), 3, 5] = lvals

    @jax.jit
    def rate(lev):
        lf = lev.astype(jnp.float32)
        return jnp.where(lf > 0, 3.1 + 2.0 * jnp.log2(jnp.maximum(lf, 1.0)),
                         0.0).sum(axis=(1, 2))

    assert np.array_equal(np.asarray(rate(lev)), tdec.bits_table()[lvals])


def _frame720():
    """One frame of bench.py's synthetic 720p content (moving disc over
    gradients, seed 9), padded to the 64x64 CTB grid by edge replication."""
    from ks265codec_tpu_torch.encode.intra_frame import pad_plane
    h, w = 720, 1280
    rng = np.random.RandomState(9)
    yy, xx = np.mgrid[0:h, 0:w]
    y = 128 + 60 * np.sin(xx / 37.0) + 40 * np.cos(yy / 29.0)
    y[(yy - 300) ** 2 + (xx - 400) ** 2 < 90 ** 2] = 210
    y = np.clip(y + rng.randn(h, w) * 3, 0, 255)
    u = np.clip(128 + 30 * np.sin(xx[::2, ::2] / 41.0), 0, 255)
    v = np.clip(128 + 30 * np.cos(yy[::2, ::2] / 43.0), 0, 255)
    return tuple(pad_plane(p.astype(np.uint8), ph, pw).astype(np.uint8)[None]
                 for p, ph, pw in ((y, 768, 1280), (u, 384, 640),
                                   (v, 384, 640)))


@pytest.mark.parametrize("w,h", [(320, 256), (192, 320)])
def test_frame_total_matches_reference(w, h):
    """The frame total `cplx` at 320x256 (a map of 8 x 10 32-blocks: the
    reference backend's 8-lane vector over each row's columns) and at
    192x320 (10 x 6: its rows in order), on a 2-frame batch."""
    rng = np.random.RandomState(w + h)
    yy, xx = np.mgrid[0:h, 0:w]
    ys, us, vs = [], [], []
    for t in range(2):
        y = 128 + 60 * np.sin((xx + 3 * t) / (13.0 + t)) \
            + 40 * np.cos((yy - 2 * t) / 17.0) + rng.randn(h, w) * (3 + 7 * t)
        ys.append(np.clip(y, 0, 255).astype(np.uint8))
        for lst in (us, vs):
            lst.append(np.clip(128 + rng.randn(h // 2, w // 2) * 9, 0,
                               255).astype(np.uint8))
    y, u, v = np.stack(ys), np.stack(us), np.stack(vs)
    ref = jax_decide(y, u, v, [27, 32], 1.0, effort=1, want_costs=True)
    got = tdec.decide_frames(torch.from_numpy(y), torch.from_numpy(u),
                             torch.from_numpy(v), [27, 32], effort=1)
    assert got["cplx"].numpy().tolist() == [np.float32(r[3]) for r in ref]


@pytest.mark.parametrize("effort", [0, 1])
def test_frame_total_matches_reference_at_720p(effort):
    """At 1280x768 the map of 32-blocks is 24 x 40: the reference backend
    sums the frame total over two zero-padded 24 x 32 windows, and the
    port must give the same float32 `cplx` (and the other 12 maps)."""
    y, u, v = _frame720()
    ref = jax_decide(y, u, v, [27], 1.0, effort=effort, want_costs=True)[0]
    got = tdec.decide_frames(torch.from_numpy(y), torch.from_numpy(u),
                             torch.from_numpy(v), [27], effort=effort)
    assert np.float32(got["cplx"][0].item()) == np.float32(ref[3])
    for idx, name in enumerate(tdec.MAP_NAMES):
        g = got[name][0].numpy()
        assert np.array_equal(g, np.asarray(ref[idx]).astype(g.dtype)), name
