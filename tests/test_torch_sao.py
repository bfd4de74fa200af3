"""SAO on the port: K8 (statistics), K9 (application) and K22 (the
per-frame statistics wrapper) in their plain PyTorch versions against the
JAX package's functions on the same numpy inputs, and the encoder with
SAO on, whose 2-frame streams must equal ks265codec_tpu's byte for byte.
Equality is exact everywhere."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ks265codec_tpu.encode.config import EncoderConfig as JaxConfig
from ks265codec_tpu.encode.encoder import encode_sequence as jax_encode
from ks265codec_tpu.ops.saoapply import sao_apply_core
from ks265codec_tpu.ops.saostats import sao_frame_stats as jax_frame_stats
from ks265codec_tpu.ops.saostats import sao_stats_plane_core
from ks265codec_tpu.utils.yuv import YUVFrame as JaxFrame
from ks265codec_tpu_torch.encode.config import EncoderConfig
from ks265codec_tpu_torch.encode.encoder import HevcEncoder
from ks265codec_tpu_torch.ops.saoapply import sao_apply_frames
from ks265codec_tpu_torch.ops.saostats import (sao_frame_stats,
                                               sao_stats_frames)
from ks265codec_tpu_torch.utils.yuv import YUVFrame
from test_torch_decoder import _frames
from _torch_shared import release_after_module  # noqa: F401

H, W, PIC_W, PIC_H = 128, 192, 176, 112


def _plane(rng, h, w):
    """Smooth content with flat steps and noise: every EO category and
    many bands occur."""
    yy, xx = np.mgrid[0:h, 0:w]
    p = 128 + 70 * np.sin(xx / 13.0) * np.cos(yy / 11.0)
    p = np.round(p / 6) * 6 + rng.randint(-3, 4, (h, w))
    return np.clip(p, 0, 255).astype(np.uint8)


def _pair(seed, h=H, w=W):
    rng = np.random.RandomState(seed)
    rec = _plane(rng, h, w)
    src = np.clip(rec.astype(int) + rng.randint(-9, 10, (h, w)), 0, 255)
    return rec, src.astype(np.uint8)


@pytest.mark.parametrize("classes,bo", [(2, False), (4, False), (4, True)])
def test_stats_plain_matches_reference(classes, bo):
    rec, src = _pair(1)
    want = sao_stats_plane_core(rec.astype(np.int32), src.astype(np.int32),
                                PIC_W, PIC_H, 64, classes=classes, bo=bo)
    got = sao_stats_frames(torch.from_numpy(rec)[None],
                           torch.from_numpy(src)[None], PIC_W, PIC_H, 64,
                           classes, bo)
    for name, a, b in zip(("eo_cnt", "eo_err", "bo_cnt", "bo_err"), want,
                          got):
        if a is None:
            assert b is None, name
            continue
        assert b.dtype == torch.int32, name
        assert np.array_equal(b[0].numpy(), np.asarray(a)), name


def test_frame_stats_matches_reference():
    """K22: the per-frame wrapper, all three planes, full statistics."""
    enc = HevcEncoder(EncoderConfig(width=PIC_W, height=PIC_H,
                                    preset="ultrafast", intra_period=1),
                      device="cpu")
    fs = types.SimpleNamespace(sps=enc.sps)
    fs.y, src_y = (a.astype(np.int32) for a in _pair(2))
    fs.cb, src_cb = (a.astype(np.int32) for a in _pair(3, H // 2, W // 2))
    fs.cr, src_cr = (a.astype(np.int32) for a in _pair(4, H // 2, W // 2))
    want = jax_frame_stats(fs, src_y, src_cb, src_cr)
    got = sao_frame_stats(fs, src_y, src_cb, src_cr, device="cpu")
    assert len(got) == 3
    for wp, gp in zip(want, got):
        for a, b in zip(wp, gp):
            assert np.array_equal(b, np.asarray(a))


def _params(seed, ncty, nctx):
    """Random SAO params covering every type, EO class, band position and
    offset in -7..7."""
    rng = np.random.RandomState(seed)
    n = 3 * ncty * nctx
    type_ = rng.permutation(np.arange(n) % 3).reshape(3, ncty, nctx)
    eocl = rng.permutation(np.arange(n) % 4).reshape(3, ncty, nctx)
    bpos = rng.permutation(np.arange(n) % 32).reshape(3, ncty, nctx)
    offs = rng.randint(-7, 8, (3, ncty, nctx, 4))
    out = [a.astype(np.int8) for a in (type_, offs, bpos, eocl)]
    assert set(np.unique(out[0])) == {0, 1, 2}
    assert set(np.unique(out[3])) == set(range(4))
    assert set(np.unique(out[2])) == set(range(32))
    assert set(np.unique(out[1])) == set(range(-7, 8))
    return out


@pytest.mark.parametrize("sao_luma,sao_chroma",
                         [(True, True), (True, False), (False, True),
                          (False, False)])
def test_apply_plain_matches_reference(sao_luma, sao_chroma):
    cs = 16                 # small CTBs: many parameter sets per plane
    y = _pair(5)[0]
    cb = _pair(6, H // 2, W // 2)[0]
    cr = _pair(7, H // 2, W // 2)[0]
    prm = _params(8, H // cs, W // cs)
    want = sao_apply_core(*(jnp.asarray(a) for a in (y, cb, cr, *prm)),
                          sao_luma, sao_chroma, PIC_W, PIC_H, cs)
    got = sao_apply_frames(*(torch.from_numpy(a)[None]
                             for a in (y, cb, cr, *prm)),
                           sao_luma, sao_chroma, PIC_W, PIC_H, cs)
    for a, b in zip(want, got):
        assert np.array_equal(b[0].numpy(), np.asarray(a))
    # a plane that is filtered changes somewhere; one that is not, nowhere
    assert np.array_equal(got[0][0].numpy(), y) != sao_luma
    assert np.array_equal(got[1][0].numpy(), cb) != sao_chroma


@pytest.mark.parametrize("kw", [dict(sao=1, tiles="2x2"), dict(sao=4)],
                         ids=["sao1_tiles_2x2", "sao4"])
def test_sao_stream_byte_identical(kw):
    """2 frames at 128x128, ultrafast QP 27 with SAO tier 1 (luma EO
    classes 0/1) and tiles, and tier 4 (all classes, band offset, chroma):
    the port's stream equals the reference's."""
    planes = _frames()
    cfg = dict(width=128, height=128, preset="ultrafast", qp=27,
               intra_period=1, **kw)
    ref, _ = jax_encode([JaxFrame(*p, poc=i) for i, p in enumerate(planes)],
                        JaxConfig(**cfg))
    enc = HevcEncoder(EncoderConfig(**cfg), device="cpu")
    assert enc.sps.sao_enabled == 1
    efs = []
    for i, p in enumerate(planes):
        efs += enc.encode_frame(YUVFrame(*p, poc=i))
    efs += enc.flush()
    got = b"".join(e.data for e in efs)
    assert got == ref
