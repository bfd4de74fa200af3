"""K6: the port's plain intra coding scan against the JAX package's
WavefrontIntraCoder (vmapped `_code_intra_frame_core`) on the same
decisions, with tiles on and off, and with K2 inside it (RDOQ and sign
hiding without tiles, sign hiding alone with tiles 2x2): recon and levels
exactly equal."""

import numpy as np
import pytest
import torch

from ks265codec_tpu.encode.config import EncoderConfig as JaxConfig
from ks265codec_tpu.encode.encoder import HevcEncoder as JaxEncoder
from ks265codec_tpu.encode.intra_frame import tile_region_maps as jax_tiles
from ks265codec_tpu.ops.wavefront import WavefrontIntraCoder as JaxCoder
from ks265codec_tpu_torch.encode.intra_frame import decision_maps8, pad_plane
from ks265codec_tpu_torch.ops import decide as tdec
from ks265codec_tpu_torch.ops import wavefront as twf
from _torch_shared import release_after_module  # noqa: F401

W, H = 192, 128
QPS = (27, 37)
PLANES = ("rec_y", "rec_cb", "rec_cr", "lev_y", "lev_cb", "lev_cr")


def _frames():
    rng = np.random.RandomState(8)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for t in range(len(QPS)):
        y = 120 + 70 * np.sin((xx + 5 * t) / 19.0) * np.cos(yy / 23.0)
        y = np.clip(y + rng.randn(H, W) * 6, 0, 255).astype(np.uint8)
        u = np.clip(128 + rng.randn(H // 2, W // 2) * 12, 0, 255) \
            .astype(np.uint8)
        v = np.clip(100 + 40 * np.cos(xx[::2, ::2] / 11.0), 0, 255) \
            .astype(np.uint8)
        out.append((y, u, v))
    return out


@pytest.fixture(scope="module", params=[
    ("", False, False), ("2x2", False, False), ("", True, True),
    ("2x2", True, False)], ids=["no_tiles", "tiles_2x2", "no_tiles_rdoq_sbh",
                                "tiles_2x2_sbh"])
def both(request):
    tiles, sbh, rdoq = request.param
    je = JaxEncoder(JaxConfig(width=W, height=H, preset="ultrafast",
                              intra_period=1, sao=0, tiles=tiles))
    sps, pps = je.sps, je.pps
    ph = sps.pic_height_in_ctbs * sps.ctb_size
    pw = sps.pic_width_in_ctbs * sps.ctb_size
    frames = _frames()
    src = [np.stack([pad_plane(f[c], h, w) for f in frames])
           for c, h, w in ((0, ph, pw), (1, ph // 2, pw // 2),
                           (2, ph // 2, pw // 2))]
    dec = tdec.decide_frames(*(torch.from_numpy(a.astype(np.uint8))
                               for a in src), list(QPS))
    maps = {k: v.numpy() for k, v in dec.items()}
    _, tile8, ntc = jax_tiles(pps, sps)
    items = []
    for f, qp in enumerate(QPS):
        log2m, modes8, cmodes8 = decision_maps8(
            maps["split32"][f], maps["split16"][f], maps["mode8"][f],
            maps["mode16"][f], maps["mode32"][f], sps, ph >> 3, pw >> 3,
            maps["cm8"][f], maps["cm16"][f], maps["cm32"][f])
        items.append(dict(src_y=src[0][f], src_cb=src[1][f],
                          src_cr=src[2][f], log2m=log2m, modes8=modes8,
                          cmodes8=cmodes8,
                          qp_map8=np.full(log2m.shape, qp, np.uint8),
                          tile8=tile8, n_tile_cols=ntc))
    ref = JaxCoder().code_frames(items, pps.cb_qp_offset, pps.cr_qp_offset,
                                 sps, sbh=sbh, rdoq=rdoq)
    sched = twf.WavefrontIntraCoder().pack(items, pps.cb_qp_offset,
                                           pps.cr_qp_offset, sps)
    recs, levs = twf.code_intra_frames(
        *(torch.from_numpy(a.astype(np.uint8)) for a in src), sched,
        bool(sps.strong_intra_smoothing), sbh=sbh, rdoq=rdoq)
    return ref, tuple(p.numpy() for p in recs + levs), sched


@pytest.mark.parametrize("pi,name", list(enumerate(PLANES)))
def test_scan_plane_equal(both, pi, name):
    ref, got, _ = both
    for f in range(len(QPS)):
        want = np.asarray(ref[f][pi])
        assert got[pi][f].shape == want.shape, name
        assert np.array_equal(got[pi][f], want.astype(got[pi].dtype)), \
            (name, f)


def test_schedule_levels_cover_every_cu_once(both):
    """Every scheduled CU sits in exactly one level slot, frames apart."""
    _, _, sched = both
    seen = set()
    for li in range(len(sched.levels)):
        lvl = sched.level(li)
        for f in range(lvl.shape[0]):
            for r in lvl[f][lvl[f][:, twf.VALID] == 1]:
                key = (f, int(r[twf.X]), int(r[twf.Y]))
                assert key not in seen
                seen.add(key)
    assert len(seen) == int((sched.recs[:, twf.VALID] == 1).sum())
