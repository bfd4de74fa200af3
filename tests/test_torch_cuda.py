"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes chip_smoke.py does not cover (odd picture sizes, QP 0 and
51, deblock offsets, SAO on chroma only, sparse random levels), the
low-delay P kernels (K12, K13, K15, K17 with K14) on a 128x96 IPPP
encode's inputs, the `fast` preset's (K2 alone, K5 at effort 1, K6 with
RDOQ and sign hiding, K17 with sign hiding), the B pictures' (K13 with
the bi cost, K14 with both lists, K15 and K17 with list 1 on a 128x96
GOP-8 encode's inputs, K18 with both lists on its decode), cu_qp_delta
and weighted prediction's (K12's variance, K17's effective-QP chain,
weighted K14, and the AQ / CU-tree / weighted encodes and their decodes),
the medium preset's (K5's NxN tier at 128x96 and 256x128, the default
EncoderConfig and medium all-intra AQ encoded and decoded), the host
walk's (K20's SAD grid and K21's quarter-pel and bi costs on seeded
windows; the slower, slower low-delay with refs=2 and placebo streams,
decoded on the CPU), and the encoder and decoder on the kernels against
themselves on the plain versions. Marked `cuda`: they skip where torch
finds no CUDA device. On the card (no jax needed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ks265codec_tpu_torch.decode.decoder import HevcDecoder
from ks265codec_tpu_torch.encode.config import EncoderConfig
from ks265codec_tpu_torch.encode.encoder import HevcEncoder, encode_sequence
from ks265codec_tpu_torch.encode.intra_frame import (decision_maps8,
                                                     pad_plane,
                                                     tile_region_maps)
from ks265codec_tpu_torch.interop import device_tables
from ks265codec_tpu_torch.ops import deblock as tdb
from ks265codec_tpu_torch.ops import decide as tdec
from ks265codec_tpu_torch.ops import saoapply as tsa
from ks265codec_tpu_torch.ops import saostats as tss
from ks265codec_tpu_torch.ops import wavefront as twf
from ks265codec_tpu_torch.utils.md5 import frame_md5
from ks265codec_tpu_torch.utils.yuv import YUVFrame

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _frames(n, w, h, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        y = 120 + 70 * np.sin((xx + 7 * t) / 15.0) * np.cos(yy / 21.0)
        y = y + rng.randn(h, w) * (2 + 8 * t)
        u = 128 + 30 * np.cos(xx[::2, ::2] / 9.0) + rng.randn(h // 2, w // 2)
        v = 128 + rng.randn(h // 2, w // 2) * 10
        out.append(tuple(np.clip(p, 0, 255).astype(np.uint8)
                         for p in (y, u, v)))
    return out


def _padded(frames, sps, dev):
    ph = sps.pic_height_in_ctbs * sps.ctb_size
    pw = sps.pic_width_in_ctbs * sps.ctb_size
    return [torch.from_numpy(np.stack([pad_plane(f[c], h, w).astype(np.uint8)
                                       for f in frames])).to(dev)
            for c, h, w in ((0, ph, pw), (1, ph // 2, pw // 2),
                            (2, ph // 2, pw // 2))]


@pytest.mark.parametrize("qps", [(0, 22), (37, 51)])
def test_decide_kernel_matches_plain(dev, qps):
    enc = HevcEncoder(EncoderConfig(width=200, height=120, preset="ultrafast",
                                    intra_period=1, sao=0), device=dev)
    src = _padded(_frames(2, 200, 120, sum(qps)), enc.sps, dev)
    args = [torch.as_tensor(a, device=dev)
            for a in tdec.frame_lambdas(list(qps))]
    got = tdec.decide_frames_cuda(*src, *args)
    want = tdec.decide_frames_plain(*src, *args)
    for name in tdec.MAP_NAMES:
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("tiles", ["", "3x2"])
def test_intra_scan_kernel_matches_plain(dev, tiles):
    enc = HevcEncoder(EncoderConfig(width=200, height=120, preset="ultrafast",
                                    intra_period=1, sao=0, tiles=tiles),
                      device=dev)
    sps, pps = enc.sps, enc.pps
    src = _padded(_frames(2, 200, 120, 4), sps, dev)
    qps = [22, 45]
    dec = tdec.decide_frames(*src, qps)
    maps = {k: v.cpu().numpy() for k, v in dec.items()}
    _, tile8, _ = tile_region_maps(pps, sps)
    ph, pw = src[0].shape[1:]
    batch = []
    for f, qp in enumerate(qps):
        log2m, modes8, cmodes8 = decision_maps8(
            maps["split32"][f], maps["split16"][f], maps["mode8"][f],
            maps["mode16"][f], maps["mode32"][f], sps, ph >> 3, pw >> 3,
            maps["cm8"][f], maps["cm16"][f], maps["cm32"][f])
        batch.append(dict(log2m=log2m, modes8=modes8, cmodes8=cmodes8,
                          qp_map8=np.full(log2m.shape, qp, np.uint8),
                          tile8=tile8))
    sched = twf.WavefrontIntraCoder().pack(batch, 0, 0, sps).to(dev)
    got = twf.code_intra_frames_cuda(*src, sched, True, device_tables(dev))
    want = twf.code_intra_frames_plain(*src, sched, True)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("offs", [(0, 0, 0, 0), (2, -3, 4, -5), (-6, 6, 0, 0)])
def test_deblock_kernel_matches_plain(dev, offs):
    rng = np.random.RandomState(3)
    F, H, W = 2, 128, 192
    yy, xx = np.mgrid[0:H, 0:W]
    y = (128 + 50 * np.sin(xx / 9.0)
         + np.repeat(np.repeat(rng.randint(-9, 10, (H // 8, W // 8)), 8, 0),
                     8, 1))
    planes = [torch.from_numpy(np.stack([np.clip(p, 0, 255).astype(np.uint8)]
                                        * F)).to(dev)
              for p in (y, y[::2, ::2], y[1::2, 1::2])]
    log2m = rng.choice([3, 4, 5], (H // 8, W // 8)).astype(np.uint8)
    bs_v, bs_h = tdb.intra_bs_maps(log2m)
    qp4 = rng.randint(20, 45, (F, H // 4, W // 4)).astype(np.uint8)
    maps = [torch.from_numpy(np.stack([b.astype(np.uint8)] * F)).to(dev)
            for b in (bs_v, bs_h)] + [torch.from_numpy(qp4).to(dev)]
    boff, toff, cbo, cro = offs
    args = (*maps, boff, toff, cbo, cro, 184, 120)
    got = tdb.deblock_frames_cuda(*planes, *args, device_tables(dev))
    want = tdb.deblock_frames_plain(*planes, *args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_encoder_kernels_match_plain(dev):
    frames = [YUVFrame(*f, poc=i) for i, f in enumerate(_frames(3, 200, 120,
                                                                9))]
    cfg = dict(width=200, height=120, preset="ultrafast", qp=32,
               intra_period=1, sao=0, tiles="2x1")
    a, _ = encode_sequence(frames, EncoderConfig(**cfg), device=dev)
    b, _ = encode_sequence(frames, EncoderConfig(**cfg), device=dev,
                           reference=True)
    assert a == b


def _planes(rng, F, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    p = 128 + 70 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    p = np.round(p / 6) * 6 + rng.randint(-3, 4, (F, h, w))
    return np.clip(p, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("classes,bo", [(2, False), (4, True)])
@pytest.mark.parametrize("plane", ["luma", "chroma"])
def test_sao_stats_kernel_matches_plain(dev, classes, bo, plane):
    """A 200x120 picture on a 256x128 CTB grid (padded planes), so the
    right CTB column is mostly outside the picture."""
    rng = np.random.RandomState(classes + len(plane))
    s = 0 if plane == "luma" else 1
    rec = _planes(rng, 3, 128 >> s, 256 >> s)
    src = np.clip(rec.astype(int) + rng.randint(-9, 10, rec.shape), 0, 255)
    r, x = (torch.from_numpy(a.astype(np.uint8)).to(dev) for a in (rec, src))
    args = (200 >> s, 120 >> s, 64 >> s, classes, bo)
    got = tss.sao_stats_frames_cuda(r, x, *args)
    want = tss.sao_stats_frames_plain(r, x, *args)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


@pytest.mark.parametrize("sao_luma,sao_chroma", [(True, True), (False, True),
                                                 (True, False)])
def test_sao_apply_kernel_matches_plain(dev, sao_luma, sao_chroma):
    rng = np.random.RandomState(5)
    F, H, W = 2, 128, 256
    planes = [torch.from_numpy(_planes(rng, F, h, w)).to(dev)
              for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    grid = (F, 3, H // 64, W // 64)
    prm = [torch.from_numpy(a.astype(np.int8)).to(dev) for a in (
        rng.randint(0, 3, grid), rng.randint(-7, 8, grid + (4,)),
        rng.randint(0, 32, grid), rng.randint(0, 4, grid))]
    args = (sao_luma, sao_chroma, 200, 120, 64)
    got = tsa.sao_apply_frames_cuda(*planes, *prm, *args)
    want = tsa.sao_apply_frames_plain(*planes, *prm, *args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _random_recon_case(dev, w, h, tiles, F, qp, seed):
    """A random K11 batch of F pictures: CU maps, modes, per-frame
    schedules packed as the encoder packs them, sparse random levels."""
    enc = HevcEncoder(EncoderConfig(width=w, height=h, preset="ultrafast",
                                    intra_period=1, tiles=tiles), device=dev)
    sps, pps = enc.sps, enc.pps
    rng = np.random.RandomState(seed)
    ph = sps.pic_height_in_ctbs * sps.ctb_size
    pw = sps.pic_width_in_ctbs * sps.ctb_size
    h8, w8 = ph >> 3, pw >> 3
    _, tile8, _ = tile_region_maps(pps, sps)
    batch = []
    for f in range(F):
        log2m, modes8, cmodes8 = decision_maps8(
            rng.rand(ph // 32, pw // 32) < 0.5,
            rng.rand(ph // 16, pw // 16) < 0.5, rng.randint(0, 35, (h8, w8)),
            rng.randint(0, 35, (ph // 16, pw // 16)),
            rng.randint(0, 35, (ph // 32, pw // 32)), sps, h8, w8)
        batch.append(dict(log2m=log2m, modes8=modes8, cmodes8=cmodes8,
                          qp_map8=np.full(log2m.shape, qp, np.uint8),
                          tile8=tile8))
    sched = twf.WavefrontIntraCoder().pack(batch, 3, -2, sps)

    def lev(hh, ww):
        mag = rng.geometric(0.3, (F, hh, ww)) * rng.choice([-1, 1],
                                                           (F, hh, ww))
        return torch.from_numpy(np.where(rng.rand(F, hh, ww) < 0.05, mag, 0)
                                .astype(np.int16)).to(dev)

    return sched, (lev(ph, pw), lev(ph // 2, pw // 2), lev(ph // 2, pw // 2))


@pytest.mark.parametrize("w,h,tiles,F,qp", [
    (200, 120, "", 2, 0), (200, 120, "3x2", 2, 0), (200, 120, "", 2, 51),
    (200, 120, "3x2", 2, 51), (64, 64, "", 1, 30), (64, 64, "", 16, 30),
    (512, 384, "", 1, 30), (512, 384, "", 16, 30), (512, 384, "8x6", 1, 30),
    (512, 384, "8x6", 16, 30)])
def test_intra_recon_kernel_matches_plain(dev, w, h, tiles, F, qp):
    """K11 from sparse random levels at QP 0, 30 and 51, with and without
    tiles, at F = 1 (as the decoder runs it), 2 and 16: equal to the plain
    version, one persistent `intra_recon` launch a call."""
    from ks265codec_tpu_torch.ops import _build
    sched, levels = _random_recon_case(dev, w, h, tiles, F, qp,
                                       qp + len(tiles))
    sched = sched.to(dev)
    before = _build.launches.get("intra_recon", 0)
    got = twf.recon_intra_frames_cuda(*levels, sched, True, device_tables(dev))
    assert _build.launches["intra_recon"] == before + 1
    want = twf.recon_intra_frames_plain(*levels, sched, True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_intra_recon_persistent_seeded_matches_plain(dev):
    """K11 in its seeded P-picture form: the intra CUs of a random intra
    mask (`intra_subset`) reconstructed in place over random inter
    samples, against the plain version."""
    enc = HevcEncoder(EncoderConfig(width=320, height=192,
                                    preset="ultrafast", intra_period=1),
                      device=dev)
    from ks265codec_tpu_torch.encode.merge_vec import zscan_vals
    sps = enc.sps
    rng = np.random.RandomState(7)
    ph = sps.pic_height_in_ctbs * sps.ctb_size
    pw = sps.pic_width_in_ctbs * sps.ctb_size
    h8, w8 = ph >> 3, pw >> 3
    log2m, modes8, cmodes8 = decision_maps8(
        rng.rand(ph // 32, pw // 32) < 0.5, rng.rand(ph // 16, pw // 16) < 0.5,
        rng.randint(0, 35, (h8, w8)), rng.randint(0, 35, (ph // 16, pw // 16)),
        rng.randint(0, 35, (ph // 32, pw // 32)), sps, h8, w8)
    coder = twf.WavefrontIntraCoder()
    full = coder.build_schedule(log2m, sps.width, sps.height, sps.log2_ctb,
                                sps.log2_min_cb)
    intra8 = np.repeat(np.repeat(rng.rand(h8 // 4, w8 // 4) < 0.4, 4, 0), 4,
                       1)[:h8, :w8]
    sub = twf.intra_subset(full, intra8,
                           zscan_vals(ph >> 2, pw >> 2, sps.log2_ctb))
    assert len(sub[0]) > 0
    sched = twf.pack_records([(sub, modes8, cmodes8,
                               np.full((h8, w8), 27, np.int32))], 0, 0)
    sched = sched.to(dev)
    levels = [torch.from_numpy(np.where(rng.rand(1, hh, ww) < 0.05,
                                        rng.randint(-9, 10, (1, hh, ww)), 0)
                               .astype(np.int16)).to(dev)
              for hh, ww in ((ph, pw), (ph // 2, pw // 2), (ph // 2, pw // 2))]
    base = [torch.from_numpy(rng.randint(0, 256, tuple(lv.shape))
                             .astype(np.uint8)).to(dev) for lv in levels]
    got = [b.clone() for b in base]
    want = [b.clone() for b in base]
    twf.recon_intra_frames_into(levels, got, sched, True)
    twf.recon_intra_frames_into(levels, want, sched, True, reference=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("effort,nxn", [(0, False), (1, False), (1, True)])
@pytest.mark.parametrize("F", [1, 16])
@pytest.mark.parametrize("w,h", [(1280, 768), (320, 256), (192, 320)])
def test_decide_redesign_matches_plain(dev, w, h, F, effort, nxn):
    """K5's region pass A and team pass B at both efforts, with and
    without the NxN tier, on one frame and 16: pass A's SATDs and best0 of
    every tier against `pass_a_plain`, and all 13 maps (the costs and the
    frame total bit for bit) against `decide_frames_plain`."""
    rng = np.random.RandomState(w + F + effort)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.stack([np.clip(128 + 60 * np.sin((xx + 5 * t) / (9.0 + t))
                          * np.cos(yy / 13.0) + rng.randn(h, w) * 6, 0, 255)
                  for t in range(F)]).astype(np.uint8)
    c = [np.clip(128 + rng.randn(F, h // 2, w // 2) * k, 0, 255)
         .astype(np.uint8) for k in (8, 20)]
    src = [torch.from_numpy(p).to(dev).contiguous() for p in [y] + c]
    qps = [22 + 3 * (f % 8) for f in range(F)]
    args = [torch.as_tensor(a, device=dev) for a in tdec.frame_lambdas(qps)]
    got = tdec.decide_frames_cuda(*src, *args, effort=effort, nxn=nxn)
    want = tdec.decide_frames_plain(*src, *args, effort=effort, nxn=nxn)
    for name in tdec.MAP_NAMES:
        assert torch.equal(got[name], want[name]), name
    for n in (16, 8, 32):
        seed = want["mode16"] if n != 16 and not effort else None
        ka = tdec.decide_pass_a_cuda(src[0], n, seed)
        pa = tdec.pass_a_plain(src[0], n, seed)
        for a, b in zip(ka, pa):
            assert torch.equal(a, b), n


def test_sao_encode_and_decode_kernels_match_plain(dev):
    """SAO tier 4 without tiles: the kernels' stream equals the plain
    versions', and the card's decoder reproduces the encoder's recon with
    every picture through its fast path, as the plain decoder does."""
    frames = [YUVFrame(*f, poc=i) for i, f in enumerate(_frames(3, 200, 120,
                                                                13))]
    cfg = dict(width=200, height=120, preset="ultrafast", qp=30,
               intra_period=1, sao=4)
    a, recons = encode_sequence(frames, EncoderConfig(**cfg), device=dev)
    b, _ = encode_sequence(frames, EncoderConfig(**cfg), device=dev,
                           reference=True)
    assert a == b
    want = [frame_md5(r) for r in recons]
    for reference in (False, True):
        dec = HevcDecoder(device=dev, reference=reference)
        assert [frame_md5(f) for f in dec.decode_all(a)] == want
        assert dec.fast_pictures == len(frames)


# ------------------------------------------------ the low-delay P path

def _ippp_cfg(**over):
    return EncoderConfig(**dict(dict(
        width=128, height=96, preset="ultrafast", latency="zerolatency",
        rc=0, qp=30, intra_period=0, sao=0), **over))


def _moving(n, w, h, seed):
    """Moving content with a block of fresh noise from the second half on,
    so that P pictures hold intra CUs."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        y = (120 + 55 * np.sin((xx + 5 * t) / 29.0)
             + 35 * np.cos((yy - 3 * t) / 23.0))
        disc = (yy - h // 2) ** 2 + (xx - w // 3 - 7 * t) ** 2
        y[disc < (h // 5) ** 2] = 215
        if t >= n // 2:
            y[:h // 4, :w // 4] = rng.randint(0, 255, (h // 4, w // 4))
        y = np.clip(y + rng.randn(h, w) * 2.5, 0, 255).astype(np.uint8)
        u = np.clip(128 + 27 * np.sin((xx[::2, ::2] + 3 * t) / 37.0), 0, 255)
        v = np.clip(128 + 27 * np.cos((yy[::2, ::2] - 2 * t) / 41.0), 0, 255)
        out.append(YUVFrame(y, u.astype(np.uint8), v.astype(np.uint8),
                            poc=t))
    return out


def test_lookahead_kernel_matches_plain(dev):
    from ks265codec_tpu_torch.ops import lookahead as tla
    rng = np.random.RandomState(2)
    y = torch.from_numpy(_planes(rng, 3, 144, 256)).to(dev)
    half = tla.downsample2x(y)
    assert torch.equal(half, tla.downsample2x(y, reference=True))
    cur, prev = half[1:].contiguous(), half[:-1].contiguous()
    for want_tree in (False, True):
        got = tla.frame_features_batch(cur, prev, want_tree=want_tree)
        want = tla.frame_features_batch(cur, prev, want_tree=want_tree,
                                        reference=True)
        assert torch.equal(got, want)
    assert torch.equal(tla.frame_features_first(half[0]),
                       tla.frame_features_first(half[0], reference=True))


@pytest.mark.parametrize("pic_h", [128, 112])
def test_motion_search_kernel_matches_plain(dev, pic_h):
    from ks265codec_tpu_torch.ops import me2
    f = _moving(2, 192, 128, 3)
    src = torch.from_numpy(f[1].y).to(dev)
    refs = torch.from_numpy(f[0].y[None].copy()).to(dev)
    for lam in (2.3, 9.1):
        got = me2.me_fused(src, refs, 64, lam, 192, pic_h)
        want = me2.me_fused(src, refs, 64, lam, 192, pic_h, reference=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _record_inter_ops(frames, dev):
    """Encode on the plain versions on the card, recording the arguments
    of every K15 and K17 call."""
    from ks265codec_tpu_torch.ops import intercode, interdecide
    calls = {"decide": [], "snap": [], "code": []}
    orig = (interdecide.decide_tiers, interdecide.snap_sads,
            intercode.code_inter_frame)

    def spy(key, fn):
        def g(*a, **k):
            calls[key].append((a, dict(k)))
            return fn(*a, **k)
        return g

    interdecide.decide_tiers = spy("decide", orig[0])
    interdecide.snap_sads = spy("snap", orig[1])
    intercode.code_inter_frame = spy("code", orig[2])
    try:
        encode_sequence(frames, _ippp_cfg(), device=dev, reference=True)
    finally:
        (interdecide.decide_tiers, interdecide.snap_sads,
         intercode.code_inter_frame) = orig
    return calls


def test_inter_decide_and_code_kernels_match_plain(dev):
    """K15 (tier decisions and snap SADs) and K17 (with K14's prediction)
    on the inputs of a 6-frame 128x96 IPPP encode."""
    from ks265codec_tpu_torch.ops import intercode, interdecide
    from ks265codec_tpu_torch.ops.mc import mc_planes_plain
    calls = _record_inter_ops(_moving(6, 128, 96, 4), dev)
    assert calls["decide"] and calls["code"]
    for a, k in calls["decide"]:
        got = interdecide.decide_tiers(*a, **dict(k, reference=False))
        want = interdecide.decide_tiers(*a, **dict(k, reference=True))
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                assert torch.equal(x.cpu(), y.cpu())
    for a, k in calls["snap"]:
        got = interdecide.snap_sads(*a, **dict(k, reference=False))
        want = interdecide.snap_sads(*a, **dict(k, reference=True))
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    n_intra = 0
    for a, k in calls["code"]:
        got = intercode.code_inter_frame(*a, **dict(k, reference=False),
                                         want_pred=True)
        want = intercode.code_inter_frame(*a, **dict(k, reference=True),
                                          want_pred=True)
        for x, y in zip(got[0] + got[1] + got[3], want[0] + want[1]
                        + want[3]):
            assert torch.equal(x, y)
        src, refs, slot0, mv0 = a[:4]
        h8, w8, pic_w, pic_h = a[10:14]
        mc = mc_planes_plain(*refs, slot0.to(dev), mv0.to(dev),
                             torch.full_like(slot0, -1).to(dev),
                             torch.zeros_like(mv0).to(dev), False, h8, w8,
                             pic_w, pic_h)
        for x, y in zip(got[3], mc):
            assert torch.equal(x, y)
        n_intra += a[6] is not None
    assert n_intra > 0


def test_ippp_encode_kernels_match_plain(dev):
    frames = _moving(4, 128, 96, 5)
    a, ra = encode_sequence(frames, _ippp_cfg(), device=dev)
    b, rb = encode_sequence(frames, _ippp_cfg(), device=dev, reference=True)
    assert a == b
    assert [frame_md5(r) for r in ra] == [frame_md5(r) for r in rb]


@pytest.mark.parametrize("tier", [1, 4])
def test_sao_decide_kernel_matches_plain(dev, tier):
    """K16 on K8's statistics of a noisy reconstruction against its
    source, and on random statistics with ties."""
    from ks265codec_tpu_torch.ops import saodecide as tsd
    rng = np.random.RandomState(tier)
    ncl, bo = (2 if tier <= 1 else 4), tier >= 3
    src = [torch.from_numpy(rng.randint(0, 256, (1, 128 >> s, 192 >> s))
                            .astype(np.uint8)).to(dev) for s in (0, 1, 1)]
    rec = [(s.int() + torch.from_numpy(rng.randint(-6, 7, s.shape))
            .to(dev)).clamp(0, 255).to(torch.uint8) for s in src]
    stats = []
    for r, s, sh in list(zip(rec, src, (0, 1, 1)))[:3 if bo else 1]:
        st = tss.sao_stats_frames(r, s, 176 >> sh, 120 >> sh, 64 >> sh, ncl,
                                  bo)
        stats.append(tuple(a[0] if a is not None else None for a in st))
    tied = [tuple(torch.from_numpy(rng.randint(-2, 3, a.shape) * 4)
                  .abs().int().to(dev) if a is not None else None
                  for a in st) for st in stats]
    for st in (stats, tied):
        for qp in (22, 30, 37):
            got = tsd.sao_decide(st, qp, tier)
            want = tsd.sao_decide(st, qp, tier, reference=True)
            for a, b in zip(got, want):
                assert torch.equal(a, b)


def test_inter_decode_kernel_matches_plain(dev):
    """K18 on every P picture of a card decode of a 6-frame SAO-on IPPP
    stream (some hold intra CUs)."""
    from ks265codec_tpu_torch.ops import wavefront as wf
    data, _ = encode_sequence(_moving(6, 128, 96, 6), _ippp_cfg(sao=1),
                              device=dev)
    calls = []
    orig = wf.recon_inter_filter

    def spy(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    wf.recon_inter_filter = spy
    try:
        HevcDecoder(device=dev).decode_all(data)
    finally:
        wf.recon_inter_filter = orig
    assert calls and any(a[9] is not None for a, _ in calls)
    for a, k in calls:
        got = wf.recon_inter_filter(*a, **dict(k, reference=False))
        want = wf.recon_inter_filter(*a, **dict(k, reference=True))
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def test_sao_ippp_encode_and_decode_on_the_card(dev):
    """A 4-frame SAO-on IPPP encode on the kernels == on the plain
    versions, and the card's decode of it == the encoder's recon."""
    frames, cfg = _moving(4, 128, 96, 6), _ippp_cfg(sao=1)
    a, ra = encode_sequence(frames, cfg, device=dev)
    b, rb = encode_sequence(frames, cfg, device=dev, reference=True)
    assert a == b
    want = [frame_md5(r) for r in ra]
    assert want == [frame_md5(r) for r in rb]
    dec = HevcDecoder(device=dev)
    got = [frame_md5(f) for f in dec.decode_all(a)]
    assert got == want and dec.fast_pictures == len(frames)


# ------------------------------------------------ the fast preset (K2)

@pytest.mark.parametrize("flags", [1, 2, 3, 6])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_rdoq_sbh_kernel_matches_plain(dev, n, flags):
    """K2 alone: RDOQ (1), sign hiding after intra (2) or inter (6)
    deadzone rounding, both (3), on random coefficients at QP 0..51 with
    every scan."""
    from ks265codec_tpu_torch.encode import rdoq as trdoq
    rng = np.random.RandomState(n + flags)
    K = 300
    mag = np.exp(rng.uniform(0, 10.4, (K, n, n)))
    c = np.where(rng.rand(K, n, n) < 0.4, mag, 0) * rng.choice([-1, 1],
                                                            (K, n, n))
    c = torch.from_numpy(np.clip(c, -32767, 32767).astype(np.int32)).to(dev)
    qp = torch.from_numpy(rng.randint(0, 52, K).astype(np.int32)).to(dev)
    scan = torch.from_numpy((np.arange(K) % 3).astype(np.int32)).to(dev)
    got = trdoq.rdoq_sbh(c, qp, scan, n, flags)
    want = trdoq.rdoq_sbh(c, qp, scan, n, flags, reference=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("qps", [(0, 22), (37, 51)])
def test_decide_effort1_kernel_matches_plain(dev, qps):
    enc = HevcEncoder(EncoderConfig(width=200, height=120, preset="fast",
                                    intra_period=1, sao=0), device=dev)
    src = _padded(_frames(2, 200, 120, 3 + sum(qps)), enc.sps, dev)
    args = [torch.as_tensor(a, device=dev)
            for a in tdec.frame_lambdas(list(qps))]
    got = tdec.decide_frames_cuda(*src, *args, effort=1)
    want = tdec.decide_frames_plain(*src, *args, effort=1)
    for name in tdec.MAP_NAMES:
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("w,h,qps", [(128, 96, (22, 37)),
                                     (256, 128, (26, 45))])
def test_decide_nxn_kernel_matches_plain(dev, w, h, qps):
    """K5 at effort 1 with the NxN tier: all 13 maps equal, NxN taken
    somewhere."""
    enc = HevcEncoder(EncoderConfig(width=w, height=h, preset="fast",
                                    intra_period=1, sao=0), device=dev)
    src = _padded(_frames(2, w, h, 5 + sum(qps)), enc.sps, dev)
    args = [torch.as_tensor(a, device=dev)
            for a in tdec.frame_lambdas(list(qps))]
    got = tdec.decide_frames_cuda(*src, *args, effort=1, nxn=True)
    want = tdec.decide_frames_plain(*src, *args, effort=1, nxn=True)
    for name in tdec.MAP_NAMES:
        assert torch.equal(got[name], want[name]), name
    assert bool(want["nxn8"].any())


@pytest.mark.parametrize("tiles,sbh,rdoq", [("", True, True),
                                            ("3x2", True, False)])
def test_intra_scan_rdoq_sbh_kernel_matches_plain(dev, tiles, sbh, rdoq):
    enc = HevcEncoder(EncoderConfig(width=200, height=120, preset="fast",
                                    intra_period=1, sao=0, tiles=tiles),
                      device=dev)
    sps, pps = enc.sps, enc.pps
    src = _padded(_frames(2, 200, 120, 6), sps, dev)
    qps = [0, 33]
    dec = tdec.decide_frames(*src, qps, effort=1)
    maps = {k: v.cpu().numpy() for k, v in dec.items()}
    _, tile8, _ = tile_region_maps(pps, sps)
    ph, pw = src[0].shape[1:]
    batch = []
    for f, qp in enumerate(qps):
        log2m, modes8, cmodes8 = decision_maps8(
            maps["split32"][f], maps["split16"][f], maps["mode8"][f],
            maps["mode16"][f], maps["mode32"][f], sps, ph >> 3, pw >> 3,
            maps["cm8"][f], maps["cm16"][f], maps["cm32"][f])
        batch.append(dict(log2m=log2m, modes8=modes8, cmodes8=cmodes8,
                          qp_map8=np.full(log2m.shape, qp, np.uint8),
                          tile8=tile8))
    sched = twf.WavefrontIntraCoder().pack(batch, 0, 0, sps).to(dev)
    got = twf.code_intra_frames_cuda(*src, sched, True, device_tables(dev),
                                     sbh, rdoq)
    want = twf.code_intra_frames_plain(*src, sched, True, sbh, rdoq)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)


def _fast_ippp_cfg(**over):
    """bench.py's inter leg at 128x96: fast, zerolatency, QP 30, the
    preset's SAO (tier 3)."""
    return EncoderConfig(**dict(dict(
        width=128, height=96, preset="fast", latency="zerolatency", rc=0,
        qp=30, intra_period=0), **over))


def test_inter_code_sbh_kernel_matches_plain(dev):
    """K17 with sign hiding (the `fast` preset's P pictures, SAO tier 3)
    on the inputs of a 6-frame 128x96 encode on the plain versions."""
    from ks265codec_tpu_torch.ops import intercode
    calls = []
    orig = intercode.code_inter_frame

    def spy(*a, **k):
        calls.append((a, dict(k)))
        return orig(*a, **k)

    intercode.code_inter_frame = spy
    try:
        encode_sequence(_moving(6, 128, 96, 8), _fast_ippp_cfg(), device=dev,
                        reference=True)
    finally:
        intercode.code_inter_frame = orig
    assert calls and all(k["sbh"] for _, k in calls)
    assert any(a[6] is not None for a, _ in calls)
    for a, k in calls:
        got = intercode.code_inter_frame(*a, **dict(k, reference=False))
        want = intercode.code_inter_frame(*a, **dict(k, reference=True))
        for x, y in zip(got[0] + got[1] + got[2], want[0] + want[1]
                        + want[2]):
            assert torch.equal(x, y)


def test_fast_ippp_encode_and_decode_on_the_card(dev):
    """A 4-frame `fast` IPPP encode on the kernels equals its plain encode,
    and the card's decoder reproduces its recon through the fast paths."""
    frames = _moving(4, 128, 96, 9)
    a, ra = encode_sequence(frames, _fast_ippp_cfg(), device=dev)
    b, rb = encode_sequence(frames, _fast_ippp_cfg(), device=dev,
                            reference=True)
    assert a == b
    want = [frame_md5(r) for r in ra]
    assert [frame_md5(r) for r in rb] == want
    dec = HevcDecoder(device=dev)
    assert [frame_md5(f) for f in dec.decode_all(a)] == want
    assert dec.fast_pictures == len(frames)


# ------------------------------------------------ B pictures (list 1)

def _b_cfg(**over):
    return EncoderConfig(**dict(dict(
        width=128, height=96, preset="fast", latency="offline", rc=0,
        qp=30), **over))


def _slow(n, w, h, seed):
    """Slowly moving content (b-adapt keeps the GOP-8) with fresh noise
    in one frame, so that B pictures hold intra CUs."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        y = (120 + 55 * np.sin((xx + 2 * t) / 29.0)
             + 35 * np.cos((yy - t) / 23.0))
        y[(yy - h // 2) ** 2 + (xx - w // 3 - 3 * t) ** 2
          < (h // 5) ** 2] = 215
        if t == 6:
            y[:h // 4, :w // 4] = rng.randint(0, 255, (h // 4, w // 4))
        y = np.clip(y + rng.randn(h, w) * 2.0, 0, 255).astype(np.uint8)
        u = np.clip(128 + 27 * np.sin((xx[::2, ::2] + 3 * t) / 37.0), 0, 255)
        v = np.clip(128 + 27 * np.cos((yy[::2, ::2] - 2 * t) / 41.0), 0, 255)
        out.append(YUVFrame(y, u.astype(np.uint8), v.astype(np.uint8),
                            poc=t))
    return out


@pytest.fixture(scope="module")
def b_calls():
    """The K13, K15 and K17 calls of a 9-frame GOP-8 encode on the plain
    versions on the card (the IDR and one GOP-8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ks265codec_tpu_torch.ops import intercode, interdecide, me2
    calls = {"me": [], "decide": [], "snap": [], "code": []}
    spied = [(me2, "me_fused", "me"), (interdecide, "decide_tiers", "decide"),
             (interdecide, "snap_sads", "snap"),
             (intercode, "code_inter_frame", "code")]
    saved = [(m, name, getattr(m, name)) for m, name, _ in spied]

    def spy(key, fn):
        def g(*a, **k):
            calls[key].append((a, dict(k)))
            return fn(*a, **k)
        return g

    for m, name, key in spied:
        setattr(m, name, spy(key, getattr(m, name)))
    try:
        encode_sequence(_slow(9, 128, 96, 8), _b_cfg(), device="cuda",
                        reference=True)
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
    return calls


def test_bi_motion_search_kernel_matches_plain(dev, b_calls):
    """K13 with the bi cost: motion, costs, directions and merged costs of
    the GOP's B pictures."""
    from ks265codec_tpu_torch.ops import me2
    calls = [(a, k) for a, k in b_calls["me"] if k.get("bi")]
    assert len(calls) == 7
    for a, k in calls:
        got = me2.me_fused(*a, **dict(k, reference=False))
        want = me2.me_fused(*a, **dict(k, reference=True))
        assert len(got) == 4
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def test_inter_mc_bi_kernel_matches_plain(dev):
    """K14 with both lists: list-0-only, list-1-only and bi cells, motion
    reaching past the picture's edges."""
    from ks265codec_tpu_torch.ops.mc import mc_planes_cuda, mc_planes_plain
    rng = np.random.RandomState(12)
    R, ph, pw, pic_w, pic_h = 3, 128, 192, 176, 120
    refs = [torch.from_numpy(rng.randint(0, 256, (R, ph >> s, pw >> s))
                             .astype(np.uint8)).to(dev) for s in (0, 1, 1)]
    h8, w8 = ph // 8, pw // 8
    kind = rng.randint(0, 3, h8 * w8)
    slot0 = np.where(kind == 1, -1, rng.randint(0, R, h8 * w8))
    slot1 = np.where(kind == 0, -1, rng.randint(0, R, h8 * w8))
    mv0, mv1 = (rng.randint(-90, 90, (h8 * w8, 2)) for _ in range(2))
    args = [torch.from_numpy(a.astype(np.int32)).to(dev)
            for a in (slot0, mv0, slot1, mv1)]
    got = mc_planes_cuda(refs, *args, True, h8, w8, pic_w, pic_h)
    want = mc_planes_plain(*refs, *args, True, h8, w8, pic_w, pic_h)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_inter_decide_list1_kernel_matches_plain(dev, b_calls):
    """K15 on the B pictures' decision and snap calls; their ME records
    include list-1-only ones (ms0 < 0 <= ms1), which are valid."""
    from ks265codec_tpu_torch.ops import interdecide
    calls = [(a, k) for a, k in b_calls["decide"] if k.get("has_l1")]
    assert calls
    l1_only = 0
    for a, k in calls:
        for ta in a[2]:
            l1_only += int(((ta["ms0"] < 0) & (ta["ms1"] >= 0)).sum())
        got = interdecide.decide_tiers(*a, **dict(k, reference=False))
        want = interdecide.decide_tiers(*a, **dict(k, reference=True))
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                assert torch.equal(x.cpu(), y.cpu())
    assert l1_only > 0
    snaps = [(a, k) for a, k in b_calls["snap"] if k.get("has_l1")]
    assert snaps
    for a, k in snaps:
        got = interdecide.snap_sads(*a, **dict(k, reference=False))
        want = interdecide.snap_sads(*a, **dict(k, reference=True))
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def test_inter_code_list1_kernel_matches_plain(dev, b_calls):
    """K17 with list 1 on the B pictures: planes, levels, SAO parameters
    and K14's bi prediction."""
    from ks265codec_tpu_torch.ops import intercode
    calls = [(a, k) for a, k in b_calls["code"] if k.get("has_l1")]
    assert len(calls) == 7 and any(a[6] is not None for a, _ in calls)
    for a, k in calls:
        got = intercode.code_inter_frame(*a, **dict(k, reference=False),
                                         want_pred=True)
        want = intercode.code_inter_frame(*a, **dict(k, reference=True),
                                          want_pred=True)
        for x, y in zip(got[0] + got[1] + got[2] + got[3],
                        want[0] + want[1] + want[2] + want[3]):
            assert torch.equal(x, y)


def test_gop8_encode_and_decode_on_the_card(dev):
    """A 9-frame GOP-8 stream on the kernels == on the plain versions;
    the card's decode of it takes every picture through the fast paths
    with the encoder's md5s, and K18 with both lists equals its plain
    version on every B picture."""
    from ks265codec_tpu_torch.ops import wavefront as wf
    frames = _slow(9, 128, 96, 8)
    a, ra = encode_sequence(frames, _b_cfg(), device=dev)
    b, rb = encode_sequence(frames, _b_cfg(), device=dev, reference=True)
    assert a == b
    want = [frame_md5(r) for r in ra]
    assert want == [frame_md5(r) for r in rb]
    calls = []
    orig = wf.recon_inter_filter

    def spy(*args, **k):
        calls.append((args, k))
        return orig(*args, **k)

    wf.recon_inter_filter = spy
    try:
        dec = HevcDecoder(device=dev)
        got = [frame_md5(f) for f in dec.decode_all(a)]
    finally:
        wf.recon_inter_filter = orig
    assert got == want and dec.fast_pictures == len(frames)
    bcalls = [(x, k) for x, k in calls if k.get("has_l1")]
    assert len(bcalls) == 7
    for x, k in bcalls:
        g = wf.recon_inter_filter(*x, **dict(k, reference=False))
        w = wf.recon_inter_filter(*x, **dict(k, reference=True))
        for p, q in zip(g, w):
            assert torch.equal(p, q)


@pytest.mark.parametrize("kind", ["random", "two_level"])
def test_lookahead_variance_kernel_matches_plain(dev, kind):
    """K12's 8x8 variance (aq): random blocks and two-level blocks, whose
    squared deviations tie; the packed rows with variance and tree maps."""
    from ks265codec_tpu_torch.ops import lookahead as tla
    rng = np.random.RandomState(21)
    if kind == "random":
        half = rng.randint(0, 256, (4, 72, 128))
    else:
        half = np.where(rng.rand(4, 72, 128) < 0.5, 17, 200)
    half = torch.from_numpy(half.astype(np.uint8)).to(dev)
    assert torch.equal(tla.block_var(half), tla.block_var(half,
                                                          reference=True))
    cur, prev = half[1:].contiguous(), half[:-1].contiguous()
    got = tla.frame_features_batch(cur, prev, True, True)
    want = tla.frame_features_batch(cur, prev, True, True, reference=True)
    assert torch.equal(got, want)
    assert torch.equal(tla.frame_features_first(half[0], True, True),
                       tla.frame_features_first(half[0], True, True,
                                                reference=True))


@pytest.mark.parametrize("wpp", [False, True], ids=["no_wpp", "wpp"])
def test_effective_qp_kernel_matches_plain(dev, wpp):
    """K17's effective-QP chain on random per-CTB QPs, CU trees and sparse
    levels of a 200x136 picture (edge CTBs partly outside)."""
    from ks265codec_tpu_torch.encode.merge_vec import zscan_vals
    from ks265codec_tpu_torch.ops import intercode
    rng = np.random.RandomState(22 + wpp)
    pic_w, pic_h, ph, pw = 200, 136, 192, 256
    h4, w4 = ph // 4, pw // 4
    lg = np.full((h4, w4), 3 + rng.randint(0, 4), np.int32)
    lg[:, : w4 // 2] = 4
    s4 = 1 << (lg - 2)
    zloc = (zscan_vals(h4, w4, 6) & 255).astype(np.int32)
    zcu = zloc[np.arange(h4)[:, None] & ~(s4 - 1),
               np.arange(w4)[None, :] & ~(s4 - 1)]
    qp4 = np.repeat(np.repeat(rng.randint(20, 40, (3, 4)), 16, 0), 16, 1)
    coef = [np.where(rng.rand(ph >> s, pw >> s) < 0.002,
                     rng.randint(-3, 4, (ph >> s, pw >> s)), 0)
            for s in (0, 1, 1)]
    coef = [torch.from_numpy(c.astype(np.int16)).to(dev) for c in coef]
    args = (torch.from_numpy(qp4.astype(np.int32)).to(dev), coef,
            torch.from_numpy(zloc).to(dev), torch.from_numpy(zcu).to(dev),
            30, wpp, 64, pic_w, pic_h)
    got = intercode.effective_qp4(*args)
    want = intercode.effective_qp4(*args, reference=True)
    assert torch.equal(got.int(), want.int())
    assert bool((want.cpu() != torch.from_numpy(qp4)).any())


@pytest.mark.parametrize("bi", [False, True], ids=["uni", "bi"])
def test_inter_mc_weighted_kernel_matches_plain(dev, bi):
    """K14 with explicit weights (flags per slot and component, negative
    offsets, log2Wd 12 and 7), one or both lists."""
    from ks265codec_tpu_torch.ops.mc import mc_planes_cuda, mc_planes_plain
    rng = np.random.RandomState(23 + bi)
    R, ph, pw, pic_w, pic_h = 3, 128, 192, 176, 120
    refs = [torch.from_numpy(rng.randint(0, 256, (R, ph >> s, pw >> s))
                             .astype(np.uint8)).to(dev) for s in (0, 1, 1)]
    h8, w8 = ph // 8, pw // 8
    kind = rng.randint(0, 3, h8 * w8) if bi else np.zeros(h8 * w8, int)
    slot0 = np.where(kind == 1, -1, rng.randint(0, R, h8 * w8))
    slot1 = np.where(kind == 0, -1, rng.randint(0, R, h8 * w8))
    mv0, mv1 = (rng.randint(-90, 90, (h8 * w8, 2)) for _ in range(2))
    args = [torch.from_numpy(a.astype(np.int32)).to(dev)
            for a in (slot0, mv0, slot1, mv1)]

    def wts(lwd):
        flag = rng.rand(R, 3) < 0.7
        return (flag, rng.randint(20, 120, (R, 3)).astype(np.int32),
                rng.randint(-30, 30, (R, 3)).astype(np.int32),
                np.array([lwd, lwd - 1, lwd - 1], np.int32))

    for lwd in (12, 7):
        w0, w1 = wts(lwd), (wts(lwd) if bi else None)
        got = mc_planes_cuda(refs, *args, bi, h8, w8, pic_w, pic_h, w0, w1)
        want = mc_planes_plain(*refs, *args, bi, h8, w8, pic_w, pic_h, w0,
                               w1)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def _fade(n, w, h):
    frames = _frames(n, w, h, 24)
    return [YUVFrame(np.clip(np.rint(y * 0.95 ** t), 0, 255)
                     .astype(np.uint8), u, v, poc=t)
            for t, (y, u, v) in enumerate(frames)]


@pytest.mark.parametrize("over", [
    dict(preset="fast", qp=27, cutree=1, aq_mode=2, weightp=True),
    dict(preset="fast", latency="zerolatency", intra_period=0, qp=30,
         aq_mode=1, weightp=True),
    dict(preset="fast", qp=27, intra_period=1, tiles="2x2", aq_mode=1)],
    ids=["vod", "live", "intra"])
def test_aq_wp_encode_and_decode_on_the_card(dev, over):
    """AQ, CU-tree and weighted prediction on a fade: the stream on the
    kernels == on the plain versions; the card's decode (K18 with weights
    and cu_qp_delta QPs) gives the encoder's md5s; K18 equals its plain
    version on every weighted picture."""
    from ks265codec_tpu_torch.ops import wavefront as wf
    frames = _fade(9, 128, 96)
    cfg = EncoderConfig(width=128, height=96, rc=0, frame_rate=30, **over)
    a, ra = encode_sequence(frames, cfg, device=dev)
    cfg = EncoderConfig(width=128, height=96, rc=0, frame_rate=30, **over)
    b, rb = encode_sequence(frames, cfg, device=dev, reference=True)
    assert a == b
    want = [frame_md5(r) for r in ra]
    assert want == [frame_md5(r) for r in rb]
    calls = []
    orig = wf.recon_inter_filter

    def spy(*args, **k):
        calls.append((args, k))
        return orig(*args, **k)

    wf.recon_inter_filter = spy
    try:
        dec = HevcDecoder(device=dev)
        got = [frame_md5(f) for f in dec.decode_all(a)]
    finally:
        wf.recon_inter_filter = orig
    assert got == want and dec.fast_pictures == len(frames)
    for x, k in calls:
        if k.get("wts0") is None:
            continue
        g = wf.recon_inter_filter(*x, **dict(k, reference=False))
        w = wf.recon_inter_filter(*x, **dict(k, reference=True))
        for p, q in zip(g, w):
            assert torch.equal(p, q)


@pytest.mark.parametrize("over", [dict(), dict(intra_period=1, aq_mode=1)],
                         ids=["medium", "medium_intra_aq"])
def test_medium_encode_and_decode_on_the_card(dev, over):
    """The default EncoderConfig (medium: the NxN tier on the IDR, the
    intra TU-split flag) and medium all-intra AQ (the tier on every
    frame): the stream on the kernels == on the plain versions, and the
    card's decode gives the encoder's md5s on the fast paths."""
    frames = _fade(9 if not over else 2, 128, 96)
    a, ra = encode_sequence(frames, EncoderConfig(width=128, height=96,
                                                  **over), device=dev)
    b, rb = encode_sequence(frames, EncoderConfig(width=128, height=96,
                                                  **over), device=dev,
                            reference=True)
    assert a == b
    want = [frame_md5(r) for r in ra]
    assert want == [frame_md5(r) for r in rb]
    dec = HevcDecoder(device=dev)
    assert [frame_md5(f) for f in dec.decode_all(a)] == want
    assert dec.fast_pictures == len(frames)


@pytest.mark.parametrize("bs,sr", [(16, 16), (8, 16), (4, 16), (16, 3),
                                   (8, 3), (4, 3)])
def test_full_search_grid_kernel_matches_plain(dev, bs, sr):
    """K20 on seeded random blocks and windows (odd block count, values
    over the whole 8-bit range)."""
    from ks265codec_tpu_torch.ops import me as tme
    rng = np.random.RandomState(bs * 100 + sr)
    n = 37
    src = torch.from_numpy(rng.randint(0, 256, (n, bs, bs)).astype(np.int32))
    win = torch.from_numpy(rng.randint(0, 256, (n, bs + 2 * sr, bs + 2 * sr))
                           .astype(np.int32))
    got = tme.full_search_grid(src.to(dev), win.to(dev), bs, sr)
    want = tme.full_search_grid(src, win, bs, sr)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("bs", [8, 16])
def test_subpel_kernels_match_plain(dev, bs):
    """K21: the 49 quarter-pel candidates' SATDs and the bi cost at every
    phase pair, on seeded random windows."""
    from ks265codec_tpu_torch.ops import subpel as tsp
    rng = np.random.RandomState(bs)
    n, ww = 53, bs + 2 * tsp.MARGIN
    win0, win1 = (torch.from_numpy(rng.randint(0, 256, (n, ww, ww))
                                   .astype(np.int32)) for _ in range(2))
    src = torch.from_numpy(rng.randint(0, 256, (n, bs, bs)).astype(np.int32))
    mv0, mv1 = (torch.from_numpy(rng.randint(-40, 40, (n, 2))
                                 .astype(np.int32)) for _ in range(2))
    got = tsp.subpel_costs(win0.to(dev), src.to(dev), bs)
    assert torch.equal(got.cpu(), tsp.subpel_costs(win0, src, bs))
    got = tsp.bi_cost(*(t.to(dev) for t in (win0, win1, mv0, mv1, src)), bs)
    assert torch.equal(got.cpu(), tsp.bi_cost(win0, win1, mv0, mv1, src, bs))


@pytest.mark.parametrize("over,n,w,h", [
    (dict(preset="slower"), 9, 128, 96),
    (dict(preset="slower", latency="zerolatency", refs=2), 4, 128, 96),
    (dict(preset="placebo", latency="zerolatency"), 3, 64, 64)],
    ids=["slower", "slower_ldp_refs2", "placebo"])
def test_walk_encode_on_the_card(dev, over, n, w, h):
    """The host walk's presets (K5, K20, K21 and K22 on the card): the
    stream on the kernels == on the plain versions, the K20 and K21
    kernels launched, and the decoder on the CPU (the card's fast parse
    does not take inter TU splits) gives the encoder's md5s."""
    from ks265codec_tpu_torch.ops import _build
    frames = _slow(n, w, h, 5)
    cfg = EncoderConfig(width=w, height=h, qp=27, **over)
    _build.reset_launches()
    a, ra = encode_sequence(frames, cfg, device=dev)
    need = ["me_full_grid", "subpel_costs", "sao_stats"]
    if "latency" not in over:
        need.append("subpel_bi_cost")          # the GOP-8's B pictures
    for k in need:
        assert _build.launches.get(k, 0) > 0, k
    b, rb = encode_sequence(frames, cfg, device=dev, reference=True)
    assert a == b
    want = [frame_md5(r) for r in ra]
    assert want == [frame_md5(r) for r in rb]
    dec = HevcDecoder(device="cpu")
    assert [frame_md5(f) for f in dec.decode_all(a)] == want
