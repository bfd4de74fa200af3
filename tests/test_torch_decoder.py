"""The intra decode on the port: K11 (reconstruction from parsed levels) in
its plain PyTorch version against the JAX package's
`WavefrontIntraCoder.recon_frame`, and the port's HevcDecoder on the CPU
against the JAX package's decoder and the encoders' reconstructions.
Equality is exact everywhere.

Streams: the port's 2-frame SAO streams (tier 1 with tiles, tier 4), and
two JAX-encoded streams the port cannot write yet: two slices per picture
(the recon-only fast path, then the host filters) and preset veryfast
(sign-bit hiding, SAO tier 3). The JAX decoder runs its scalar walk
(KS265_DECODE_FAST=0), the oracle its fast path is held against, which
needs no XLA compile."""

import copy
import types

import numpy as np
import pytest
import torch

from ks265codec_tpu.decode.decoder import HevcDecoder as JaxDecoder
from ks265codec_tpu.encode.config import EncoderConfig as JaxConfig
from ks265codec_tpu.encode.encoder import encode_sequence as jax_encode
from ks265codec_tpu.ops.wavefront import WavefrontIntraCoder as JaxCoder
from ks265codec_tpu.utils.md5 import frame_md5 as jax_md5
from ks265codec_tpu.utils.yuv import YUVFrame as JaxFrame
from ks265codec_tpu_torch.decode.decoder import HevcDecoder
from ks265codec_tpu_torch.encode.config import EncoderConfig
from ks265codec_tpu_torch.encode.encoder import HevcEncoder, encode_sequence
from ks265codec_tpu_torch.encode.intra_frame import (decision_maps8,
                                                     pad_plane,
                                                     tile_region_maps)
from ks265codec_tpu_torch.hevc.slicehdr import B_SLICE, I_SLICE, P_SLICE
from ks265codec_tpu_torch.ops import decide as tdec
from ks265codec_tpu_torch.ops import wavefront as twf
from ks265codec_tpu_torch.utils.md5 import frame_md5
from ks265codec_tpu_torch.utils.yuv import YUVFrame
from _torch_shared import release_after_module  # noqa: F401

W = H = 128


def _frames(n=2, w=W, h=H, seed=5):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        y = 128 + 60 * np.sin((xx + 3 * t) / 23.0) \
            + 40 * np.cos((yy - 2 * t) / 17.0)
        y[30:70, 40 + 6 * t:80 + 6 * t] = 220 - 3 * t
        y = np.clip(y + rng.randn(h, w) * 3, 0, 255).astype(np.uint8)
        u = np.clip(128 + 30 * np.sin((xx[::2, ::2] + t) / 31.0), 0, 255) \
            .astype(np.uint8)
        v = np.clip(128 + 30 * np.cos((yy[::2, ::2] - t) / 29.0), 0, 255) \
            .astype(np.uint8)
        out.append((y, u, v))
    return out


# ------------------------------------------------------------------- K11

def _encoded_levels(enc, qp):
    """Decision maps and levels of one frame coded by the port (K5, K6
    plain versions), plus K6's reconstruction."""
    sps, pps = enc.sps, enc.pps
    ph = sps.pic_height_in_ctbs * sps.ctb_size
    pw = sps.pic_width_in_ctbs * sps.ctb_size
    src = [torch.from_numpy(pad_plane(p, h, w).astype(np.uint8))[None]
           for p, h, w in zip(_frames(1)[0], (ph, ph // 2, ph // 2),
                              (pw, pw // 2, pw // 2))]
    maps = {k: v[0].numpy() for k, v in tdec.decide_frames(*src, [qp]).items()}
    log2m, modes8, cmodes8 = decision_maps8(
        maps["split32"], maps["split16"], maps["mode8"], maps["mode16"],
        maps["mode32"], sps, ph >> 3, pw >> 3, maps["cm8"], maps["cm16"],
        maps["cm32"])
    qp_map8 = np.full(log2m.shape, qp, np.int32)
    item = dict(log2m=log2m, modes8=modes8, cmodes8=cmodes8, qp_map8=qp_map8,
                tile8=tile_region_maps(pps, sps)[1])
    sched = twf.WavefrontIntraCoder().pack([item], 0, 0, sps)
    recon, levels = twf.code_intra_frames(*src, sched,
                                          bool(sps.strong_intra_smoothing))
    return item, [lv[0].numpy() for lv in levels], [r[0] for r in recon]


def _random_levels(enc, seed):
    """A random CU map, random modes, per-CTB QPs over 0..51 and sparse
    random levels (about 4% nonzero, mostly small)."""
    sps, pps = enc.sps, enc.pps
    rng = np.random.RandomState(seed)
    ph = sps.pic_height_in_ctbs * sps.ctb_size
    pw = sps.pic_width_in_ctbs * sps.ctb_size
    h8, w8 = ph >> 3, pw >> 3
    log2m, modes8, cmodes8 = decision_maps8(
        rng.rand(ph // 32, pw // 32) < 0.5, rng.rand(ph // 16, pw // 16) < 0.5,
        rng.randint(0, 35, (h8, w8)), rng.randint(0, 35, (ph // 16, pw // 16)),
        rng.randint(0, 35, (ph // 32, pw // 32)), sps, h8, w8,
        rng.choice([0, 1, 10, 26, 34], (h8, w8)),
        rng.choice([0, 1, 10, 26, 34], (ph // 16, pw // 16)),
        rng.choice([0, 1, 10, 26, 34], (ph // 32, pw // 32)))
    qp_ctb = rng.randint(0, 52, (sps.pic_height_in_ctbs, sps.pic_width_in_ctbs))
    qp_map8 = np.repeat(np.repeat(qp_ctb, 8, 0), 8, 1).astype(np.int32)

    def lev(h, w):
        mag = rng.geometric(0.5, (h, w)) * rng.choice([-1, 1], (h, w))
        return np.where(rng.rand(h, w) < 0.04, mag, 0).astype(np.int16)

    item = dict(log2m=log2m, modes8=modes8, cmodes8=cmodes8, qp_map8=qp_map8,
                tile8=tile_region_maps(pps, sps)[1])
    return item, [lev(ph, pw), lev(ph // 2, pw // 2), lev(ph // 2, pw // 2)]


def test_recon_plain_matches_reference():
    """Random levels with per-CTB QPs, chroma QP offsets and tiles 2x2: the
    cases the decoder's streams do not reach. One XLA compile of the
    reference's schedule (about 15 s on one core)."""
    enc = HevcEncoder(EncoderConfig(width=W, height=H, preset="ultrafast",
                                    intra_period=1, tiles="2x2", qp=30),
                      device="cpu")
    sps = enc.sps
    item, levels = _random_levels(enc, 11)
    want = JaxCoder().recon_frame(
        *levels, item["log2m"], item["modes8"], item["cmodes8"],
        item["qp_map8"], 2, -3, sps, tile8=item["tile8"])
    sched = twf.WavefrontIntraCoder().pack([item], 2, -3, sps)
    got = twf.recon_intra_frames(*(torch.from_numpy(a)[None] for a in levels),
                                 sched, bool(sps.strong_intra_smoothing))
    for a, b in zip(want, got):
        assert np.array_equal(b[0].numpy(), np.asarray(a))


def test_recon_of_k6_levels_is_k6_recon():
    """K11 of the levels K6 wrote, with K6's schedule, is K6's
    reconstruction (plain versions, no JAX run)."""
    enc = HevcEncoder(EncoderConfig(width=W, height=H, preset="ultrafast",
                                    intra_period=1, qp=30), device="cpu")
    item, levels, k6_recon = _encoded_levels(enc, 30)
    sched = twf.WavefrontIntraCoder().pack([item], 0, 0, enc.sps)
    got = twf.recon_intra_frames(*(torch.from_numpy(a)[None] for a in levels),
                                 sched, bool(enc.sps.strong_intra_smoothing))
    for a, b in zip(k6_recon, got):
        assert torch.equal(a, b[0])


# --------------------------------------------------------------- decoder

def _port_stream(kw):
    planes = _frames()
    cfg = dict(width=W, height=H, preset="ultrafast", qp=27, intra_period=1,
               **kw)
    data, recons = encode_sequence(
        [YUVFrame(*p, poc=i) for i, p in enumerate(planes)],
        EncoderConfig(**cfg), device="cpu")
    return data, [frame_md5(r) for r in recons]


_JAX_STREAMS = {}


def _jax_stream(kw):
    """The JAX encoder's stream of `_frames()` and its recon md5s, encoded
    once per process for each configuration."""
    key = tuple(sorted(kw.items()))
    if key not in _JAX_STREAMS:
        _JAX_STREAMS[key] = _jax_encode(kw)
    return _JAX_STREAMS[key]


def _jax_encode(kw):
    planes = _frames()
    cfg = dict(width=W, height=H, qp=27, intra_period=1, preset="ultrafast")
    cfg.update(kw)
    data, recons = jax_encode(
        [JaxFrame(*p, poc=i) for i, p in enumerate(planes)], JaxConfig(**cfg))
    return data, [jax_md5(r) for r in recons]


STREAMS = {
    "port_sao1_tiles_2x2": (_port_stream, dict(sao=1, tiles="2x2"), 2),
    "port_sao4": (_port_stream, dict(sao=4), 2),
    "jax_slices2": (_jax_stream, dict(slices=2), 0),
    "jax_veryfast": (_jax_stream, dict(preset="veryfast"), 2),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_decoder_matches_reference_decoder(name, monkeypatch):
    """md5 of every decoded frame: the port's decoder on the CPU == the
    JAX decoder == the encoder's reconstruction; the pictures that the
    fast path can take whole are reconstructed and filtered there."""
    make, kw, n_fast = STREAMS[name]
    data, enc_md5 = make(kw)
    dec = HevcDecoder(device="cpu")
    got = [frame_md5(f) for f in dec.decode_all(data)]
    assert dec.fast_pictures == n_fast
    with monkeypatch.context() as m:
        m.setenv("KS265_DECODE_FAST", "0")
        want = [jax_md5(f) for f in JaxDecoder().decode_all(data)]
    assert len(got) == 2
    assert got == want == enc_md5


def test_card_decoder_raises_on_a_later_slice():
    """A picture's second slice (the reference writes it as a dependent
    segment) takes the scalar walk: the card's decoder raises on it
    (before any launch) where it used to decode it on the host; the CPU
    decoder decodes the stream to the encoder's md5s."""
    data, enc_md5 = _jax_stream(dict(slices=2))
    card = HevcDecoder(device="cpu")
    card.device = torch.device("cuda")
    with pytest.raises(NotImplementedError,
                       match="dependent slice segment on the card"):
        card.decode_all(data)
    cpu = HevcDecoder(device="cpu")
    assert [frame_md5(f) for f in cpu.decode_all(data)] == enc_md5


def test_b_slices_are_eligible_weighted_prediction_raises():
    """B slices take the inter fast path as P slices do, and so do slices
    with explicit weighted prediction, which the fast path now covers
    (the name is kept from when they raised)."""
    dec = HevcDecoder(device="cpu")
    enc = HevcEncoder(EncoderConfig(width=W, height=H, preset="ultrafast",
                                    intra_period=1), device="cpu")
    b = types.SimpleNamespace(slice_type=B_SLICE, weights=None)
    assert dec._fast_eligible(enc.sps, enc.pps, b)
    wp = types.SimpleNamespace(slice_type=B_SLICE, weights=[[], []])
    assert dec._fast_eligible(enc.sps, enc.pps, wp)
    wp = types.SimpleNamespace(slice_type=P_SLICE, weights=[[], []])
    assert dec._fast_eligible(enc.sps, enc.pps, wp)
    p = types.SimpleNamespace(slice_type=P_SLICE, weights=None)
    assert dec._fast_eligible(enc.sps, enc.pps, p)


def test_later_cra_outputs_its_rasl_pictures():
    """An open-GOP stream joined at a CRA (spec 8.1): the RASL pictures of
    the CRA that opens the stream are discarded (NoRaslOutputFlag = 1),
    those of every later CRA are decoded and output. The reference's
    64x64 stream with intra_period 4 codes every inter picture as a RASL
    lead (I0, CRA4 with RASL 1-3, CRA8 with RASL 5-7); the stream starts
    at CRA4, so POCs 4-8 are the output, with the encoder's md5s. (The
    JAX decoder outputs only 4 and 8 here: its flag is not cleared by a
    later CRA; the port does not carry that fault.)"""
    rng = np.random.RandomState(4)
    yy, xx = np.mgrid[0:64, 0:64]
    frames = []
    for t in range(9):
        y = np.clip(120 + 50 * np.sin((xx + 2 * t) / 11.0)
                    + 30 * np.cos((yy - t) / 9.0) + rng.randn(64, 64) * 2,
                    0, 255).astype(np.uint8)
        frames.append(JaxFrame(y, np.full((32, 32), 128, np.uint8),
                               np.full((32, 32), 120, np.uint8), poc=t))
    from ks265codec_tpu.encode.encoder import HevcEncoder as JaxEncoder
    enc = JaxEncoder(JaxConfig(width=64, height=64, preset="ultrafast",
                               qp=30, rc=0, open_gop=True, intra_period=4,
                               frame_rate=30))
    efs = []
    for f in frames:
        efs += enc.encode_frame(f)
    efs += enc.flush()
    assert [(e.poc, e.slice_type) for e in efs] == [
        (0, "I"), (4, "I"), (1, "B"), (2, "B"), (3, "B"), (8, "I"),
        (5, "B"), (6, "B"), (7, "B")]
    want = {e.display_idx: jax_md5(e.recon) for e in efs}
    got = HevcDecoder(device="cpu").decode_all(b"".join(e.data
                                                        for e in efs[1:]))
    assert [f.poc for f in got] == [4, 5, 6, 7, 8]
    assert [frame_md5(f) for f in got] == [want[f.poc] for f in got]


def test_p_slices_outside_coverage_raise_on_the_card():
    """A P slice outside the P fast path (tiles, quantization groups
    under 16 samples) takes the scalar walk on a CPU decoder and raises
    on any other device, so the card is never bypassed silently."""
    enc = HevcEncoder(EncoderConfig(width=W, height=H, preset="ultrafast",
                                    intra_period=1), device="cpu")
    p = types.SimpleNamespace(slice_type=P_SLICE, weights=None)
    tiles = copy.copy(enc.pps)
    tiles.tiles_enabled = 1
    small_qg = copy.copy(enc.pps)
    small_qg.cu_qp_delta_enabled = 1
    small_qg.diff_cu_qp_delta_depth = 3
    cpu, card = HevcDecoder(device="cpu"), HevcDecoder(device="cpu")
    card.device = torch.device("cuda")      # no launch happens here
    for pps, gap in ((tiles, "tiles"), (small_qg, "quantization groups")):
        assert not cpu._fast_eligible(enc.sps, pps, p)
        with pytest.raises(NotImplementedError, match=gap):
            card._fast_eligible(enc.sps, pps, p)
    assert card._fast_eligible(enc.sps, enc.pps, p)


def test_fast_path_needs_the_native_library(monkeypatch):
    """Without the native schedule builder the decoder raises, as the
    encoder does, instead of leaving the device path for the host walk."""
    from ks265codec_tpu_torch import native
    enc = HevcEncoder(EncoderConfig(width=W, height=H, preset="ultrafast",
                                    intra_period=1), device="cpu")
    monkeypatch.setattr(native, "HAVE_NATIVE", False)
    hdr = types.SimpleNamespace(slice_type=I_SLICE)
    with pytest.raises(RuntimeError, match="native"):
        HevcDecoder(device="cpu")._fast_eligible(enc.sps, enc.pps, hdr)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert HevcDecoder().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            HevcDecoder()
