"""The `medium` preset on the CPU, exact against ks265codec_tpu: K5's NxN
tier, the intra TU-split SPS flag and the decode of such streams.

Reference encodes at 128x96, once per test run (under pytest-xdist the
medium encode, the all-intra ones and the port's encodes are three
tasks that the first free workers take, and the others read the
results; tests/_torch_shared.py):
  medium  the default EncoderConfig (medium, offline GOP-8 with b-adapt,
          QP 26: NxN on the IDR, the TU-split flag, CU-tree, weightp,
          SAO tier 4, RDOQ, sign hiding) on 9 frames of a luma fade with
          a striped quarter, its IDR's decision call (`decide_frames` with
          nxn=True) recorded;
  intra   medium all-intra, aq_mode 1, 2 frames (the tier on every frame);
  screen  tune="screen" all-intra, aq_mode 1, 2 frames (transform skip in
          its PPS: both decoders take the scalar walk);
  nxn     medium all-intra on one 64x64 frame through the reference's
          sequential host walk, which codes NxN partitions for real.
Each stream is decoded by the JAX decoder (the medium ones leave its fast
path: it takes no stream whose SPS allows an intra TU split).

The port's plain K5 with nxn=True must equal the reference on the
recorded call and on a textured 2-frame batch against the jitted
`decide_frames_jit(..., effort=1, nxn=True)` (all 13 maps, float32 costs
and the frame total bit for bit), with NxN taken and split16 moved. The
port's HevcEncoder(device="cpu") must write the three streams byte for
byte with the same reconstructions (its `slow` stream equals its `medium`
one), and its HevcDecoder(device="cpu") must give the JAX decoder's md5s,
every picture of the medium streams on the fast paths. The NxN tier's
cost moves split16 while the CU is still coded 2Nx2N: that is parity with
the reference, not the behaviour of a correct NxN coder."""

import os

import numpy as np
import pytest
import torch

import ks265codec_tpu.ops.decide as jdec
from ks265codec_tpu.decode.decoder import HevcDecoder as JaxDecoder
from ks265codec_tpu.encode.config import EncoderConfig as JaxConfig
from ks265codec_tpu.encode.encoder import HevcEncoder as JaxEncoder
from ks265codec_tpu.utils.md5 import frame_md5 as jax_md5
from ks265codec_tpu.utils.yuv import YUVFrame as JaxFrame
from ks265codec_tpu_torch.bitstream.nal import is_vcl, split_annexb
from ks265codec_tpu_torch.decode.decoder import HevcDecoder
from ks265codec_tpu_torch.decode.slice_dec import FastPathAbort
from ks265codec_tpu_torch.encode.config import EncoderConfig, resolve_preset
from ks265codec_tpu_torch.encode.encoder import HevcEncoder, encode_sequence, \
    unsupported
from ks265codec_tpu_torch.hevc.slicehdr import B_SLICE, I_SLICE, P_SLICE, \
    SliceHeader
from ks265codec_tpu_torch.ops import decide as tdec
from ks265codec_tpu_torch.utils.md5 import frame_md5
from ks265codec_tpu_torch.utils.yuv import YUVFrame
from _torch_shared import release_after_module, shared  # noqa: F401
from test_torch_aqwp import fade, flat_left

W, H = 128, 96


def striped_fade(n, w=W, h=H):
    """The luma fade of test_torch_aqwp with diagonal stripes of period 4 in
    its lower-left quarter (fading with it): 4x4 detail where the NxN tier
    wins and moves split16 on the IDR."""
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.RandomState(3)
    stripes = 128 + 40 * np.sin((xx + yy) * np.pi / 2) \
        + rng.randn(h, w) * 2
    quarter = (yy >= h // 2) & (xx < w // 2)
    out = []
    for t, (y, u, v) in enumerate(fade(n, w, h)):
        y = np.where(quarter, np.clip(stripes * 0.95 ** t, 0, 255), y)
        out.append((y.astype(np.uint8), u, v))
    return out


STREAMS = {
    "medium": (dict(), 9, "IPBBBBBBB"),
    "intra": (dict(intra_period=1, aq_mode=1), 2, "II"),
    "screen": (dict(intra_period=1, aq_mode=1, tune="screen"), 2, "II"),
}
FRAMES = {"medium": striped_fade, "intra": flat_left,
          "screen": flat_left}


def cfg(name, **over):
    return dict(width=W, height=H, **STREAMS[name][0], **over)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread while this module runs (its plain versions are
    many small operations; a thread per core oversubscribes xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _encode(enc_cls, frame_cls, config, planes):
    enc = enc_cls(config)
    efs = []
    for i, p in enumerate(planes):
        efs += enc.encode_frame(frame_cls(*p, poc=i))
    efs += enc.flush()
    return efs


def _reference_stream(name):
    """The reference encode of one stream and the JAX decoder's md5s."""
    _, n, _ = STREAMS[name]
    efs = _encode(JaxEncoder, JaxFrame, JaxConfig(**cfg(name)),
                  FRAMES[name](n))
    bs = b"".join(e.data for e in efs)
    return dict(bs=bs, types="".join(e.slice_type for e in efs),
                recons=[(e.recon.y, e.recon.u, e.recon.v) for e in efs],
                md5=[jax_md5(f) for f in JaxDecoder().decode_all(bs)])


def _reference_medium():
    """The medium stream, with its NxN decision calls recorded."""
    calls = []
    orig = jdec.decide_frames

    def spy(*a, **k):
        out = orig(*a, **k)
        if k.get("nxn"):
            calls.append(([np.array(x) if hasattr(x, "shape") else x
                           for x in a], dict(k),
                          [tuple(np.array(m) for m in f) for f in out]))
        return out

    jdec.decide_frames = spy
    try:
        return dict(medium=_reference_stream("medium"), calls=calls)
    finally:
        jdec.decide_frames = orig


def _reference_intra():
    """The two all-intra AQ streams, and one frame through the reference's
    sequential host walk, which codes NxN for real."""
    out = {name: _reference_stream(name) for name in ("intra", "screen")}
    os.environ["KS265_SEQ_COMPUTE"] = "1"
    try:
        efs = _encode(JaxEncoder, JaxFrame,
                      JaxConfig(width=64, height=64, intra_period=1, qp=22),
                      fade(1, 64, 64))
    finally:
        del os.environ["KS265_SEQ_COMPUTE"]
    out["nxn"] = dict(bs=efs[0].data, md5=[jax_md5(efs[0].recon)])
    return out


def _port():
    """The port's encodes of the three streams and of `slow`."""
    out = {}
    for name, (_, n, _) in STREAMS.items():
        efs = _encode(lambda c: HevcEncoder(c, device="cpu"), YUVFrame,
                      EncoderConfig(**cfg(name)), FRAMES[name](n))
        out[name] = dict(
            bs=b"".join(e.data for e in efs),
            types="".join(e.slice_type for e in efs),
            recons=[(e.recon.y, e.recon.u, e.recon.v) for e in efs])
    efs = _encode(lambda c: HevcEncoder(c, device="cpu"), YUVFrame,
                  EncoderConfig(**cfg("medium", preset="slow")),
                  FRAMES["medium"](9))
    out["slow"] = b"".join(e.data for e in efs)
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return shared(tmp_path_factory,
                  {"torch_medium_ref": _reference_medium,
                   "torch_medium_ref_intra": _reference_intra,
                   "torch_medium_port": _port})


@pytest.fixture(scope="module")
def ref(both):
    return dict(both["torch_medium_ref"], **both["torch_medium_ref_intra"])


@pytest.fixture(scope="module")
def port(both):
    return both["torch_medium_port"]


# ------------------------------------------------------ K5's NxN tier

def _plain(y, u, v, qps, lam_scale=1.0, nxn=True):
    return tdec.decide_frames(*(torch.from_numpy(np.ascontiguousarray(a))
                                for a in (y, u, v)), list(qps), lam_scale,
                              effort=1, nxn=nxn)


def _assert_maps_equal(got, want_frames):
    for f, want in enumerate(want_frames):
        for i, name in enumerate(tdec.MAP_NAMES):
            g = got[name][f].numpy()
            w = np.asarray(want[i])
            assert g.shape == w.shape, name
            assert np.array_equal(g, w.astype(g.dtype)), (name, f)


def test_nxn_plain_matches_recorded_idr_decision(ref):
    """The medium IDR's decision call: the plain pass with nxn=True gives
    the reference's 13 maps; NxN wins somewhere and moves split16."""
    assert len(ref["calls"]) == 1          # the IDR only: P/B never run it
    (y, u, v, qps, lam_scale), k, want = ref["calls"][0]
    assert k["effort"] == 1
    got = _plain(y, u, v, qps, lam_scale)
    _assert_maps_equal(got, want)
    assert bool(got["nxn8"].any())
    off = _plain(y, u, v, qps, lam_scale, nxn=False)
    assert bool((got["split16"] != off["split16"]).any())


def _textured(seed=3, w=128, h=64, F=2):
    """Sinusoids, a bright rectangle and noise rising with the frame: 4x4
    detail where NxN beats 8x8 CUs."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ys, us, vs = [], [], []
    for t in range(F):
        y = 128 + 60 * np.sin((xx + 3 * t) / 7.0) \
            + 40 * np.cos((yy - 2 * t) / 5.0)
        y[10:40, 20 + 6 * t:50 + 6 * t] = 220 - 3 * t
        y = y + rng.randn(h, w) * (3 + 10 * t)
        u = 128 + 30 * np.sin((xx[::2, ::2] + t) / 31.0) \
            + rng.randn(h // 2, w // 2) * 4
        v = 128 + 30 * np.cos((yy[::2, ::2] - t) / 29.0) \
            + rng.randn(h // 2, w // 2) * 4
        for lst, p in ((ys, y), (us, u), (vs, v)):
            lst.append(np.clip(p, 0, 255).astype(np.uint8))
    return np.stack(ys), np.stack(us), np.stack(vs)


TEXTURED_QPS = (22, 37)


@pytest.fixture(scope="module")
def textured():
    y, u, v = _textured()
    want = jdec.decide_frames(y, u, v, list(TEXTURED_QPS), 1.0, effort=1,
                              nxn=True, want_costs=True)
    return (_plain(y, u, v, TEXTURED_QPS), want,
            _plain(y, u, v, TEXTURED_QPS, nxn=False))


@pytest.mark.parametrize("idx,name", list(enumerate(tdec.MAP_NAMES)))
def test_nxn_plain_matches_jitted_reference(textured, idx, name):
    """A textured 2-frame 128x64 batch at QPs 22 and 37 against the jitted
    reference with nxn=True: each map equal, floats bit for bit."""
    got, want, _ = textured
    for f in range(len(TEXTURED_QPS)):
        g = got[name][f].numpy()
        w = np.asarray(want[f][idx])
        assert g.shape == w.shape
        assert np.array_equal(g, w.astype(g.dtype)), f


def test_nxn_tier_engages_on_the_textured_batch(textured):
    got, _, off = textured
    assert all(bool(got["nxn8"][f].any()) for f in range(2))
    assert bool((got["split16"] != off["split16"]).any())
    assert not bool(off["nxn8"].any()) and not bool(off["mode4"].any())


def test_nxn_needs_effort_one():
    """The tier runs only at effort 1, as the reference's `effort >= 1 and
    nxn`: at effort 0 nxn=True changes nothing and mode4 and nxn8 stay
    zero."""
    y, u, v = _textured(F=1)
    src = [torch.from_numpy(a) for a in (y, u, v)]
    got = tdec.decide_frames(*src, [22], effort=0, nxn=True)
    want = tdec.decide_frames(*src, [22], effort=0)
    for name in tdec.MAP_NAMES:
        assert torch.equal(got[name], want[name]), name
    assert not bool(got["nxn8"].any()) and not bool(got["mode4"].any())


# --------------------------------------------------------- the streams

@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_byte_identical(ref, port, name):
    assert port[name]["types"] == ref[name]["types"] == STREAMS[name][2]
    assert port[name]["bs"] == ref[name]["bs"]


@pytest.mark.parametrize("name", list(STREAMS))
def test_recons_equal_reference(ref, port, name):
    assert len(port[name]["recons"]) == len(ref[name]["recons"])
    for got, want in zip(port[name]["recons"], ref[name]["recons"]):
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_gives_jax_decoder_md5s(ref, name):
    """The port's CPU decoder gives the JAX decoder's md5s; every picture of
    the medium streams takes the fast paths, the screen stream (transform
    skip in its PPS) none, as in the reference."""
    dec = HevcDecoder(device="cpu")
    frames = dec.decode_all(ref[name]["bs"])
    assert [frame_md5(f) for f in frames] == ref[name]["md5"]
    assert dec.fast_pictures == (0 if name == "screen" else len(frames))


def _nal_units(bs):
    """Annex-B stream -> NAL units (without start codes)."""
    starts = [i for i in range(len(bs) - 2) if bs[i:i + 3] == b"\0\0\1"]
    return [bs[a + 3:b].rstrip(b"\0")
            for a, b in zip(starts, starts[1:] + [len(bs)])]


def test_slow_stream_equals_medium(port):
    """`slow` differs from `medium` only in the motion search method, which
    the reference reads only in its host walk: every NAL unit is the same
    but the user-data SEI, which names the preset."""
    slow, medium = _nal_units(port["slow"]), _nal_units(port["medium"]["bs"])
    assert len(slow) == len(medium)
    differ = [(a[0] >> 1) for a, b in zip(slow, medium) if a != b]
    assert differ == [39]                   # PREFIX_SEI
    assert b"preset slow" in port["slow"]


def test_real_nxn_stream_leaves_the_fast_path(ref):
    """A stream that codes NxN (the reference's sequential walk) aborts the
    fast parse and decodes on the scalar walk to the reference's recon."""
    dec = HevcDecoder(device="cpu")
    frames = dec.decode_all(ref["nxn"]["bs"])
    assert [frame_md5(f) for f in frames] == ref["nxn"]["md5"]
    assert dec.fast_pictures == 0


# ---------------------------------------------------- the TU-split flag

@pytest.mark.parametrize("over", [
    dict(),
    dict(intra_period=1),
    dict(intra_period=1, aq_mode=1),
    dict(intra_period=1, tune="screen"),
    dict(intra_period=1, aq_mode=2, tune="screen"),
    dict(preset="fast"),
    dict(preset="fast", intra_tu_depth=1),
    dict(preset="fast", intra_tu_depth=1, intra_period=1),
    dict(preset="slow", latency="zerolatency", intra_period=0),
    dict(preset="placebo", intra_period=1),
    dict(preset="placebo", intra_period=1, aq_mode=3),
])
def test_sps_intra_hierarchy_depth_matches_reference(over):
    """max_transform_hierarchy_depth_intra equals the reference encoder's
    (1 where `intra_tu_depth` meets inter coding, AQ or CU-tree)."""
    kw = dict(width=W, height=H, **over)
    want = JaxEncoder(JaxConfig(**kw)).sps.max_transform_hierarchy_depth_intra
    got = HevcEncoder(EncoderConfig(**kw),
                      device="cpu").sps.max_transform_hierarchy_depth_intra
    assert got == want


@pytest.mark.parametrize("over", [dict(), dict(preset="slow"),
                                  dict(intra_period=1, aq_mode=1),
                                  dict(intra_period=1, aq_mode=1,
                                       tune="screen")])
def test_medium_configurations_are_supported(over):
    c = resolve_preset(EncoderConfig(width=W, height=H, **over))
    assert c.intra_nxn and unsupported(c) == []


# ------------------------------------------ no host redo on the card

@pytest.mark.parametrize("what", ["NxN", "TU split", "sub-8 PU"])
@pytest.mark.parametrize("slice_type", [P_SLICE, B_SLICE])
def test_card_decoder_raises_on_a_p_b_fast_parse_abort(what, slice_type):
    """On the card a P or B slice whose fast parse aborts raises
    NotImplementedError naming the syntax instead of a host redo."""
    dec = HevcDecoder(device="cpu")
    dec.device = torch.device("cuda")
    with pytest.raises(NotImplementedError, match=what):
        dec._check_fast_abort(SliceHeader(slice_type=slice_type),
                              FastPathAbort(what))


@pytest.mark.parametrize("what", ["NxN", "TU split"])
def test_card_decoder_raises_on_an_i_fast_parse_abort(what):
    """On the card an I slice whose fast parse aborts (a stream that codes
    NxN or splits an intra TU for real) raises too: no host redo."""
    dec = HevcDecoder(device="cpu")
    dec.device = torch.device("cuda")
    with pytest.raises(NotImplementedError, match=what + " in an I"):
        dec._check_fast_abort(SliceHeader(slice_type=I_SLICE),
                              FastPathAbort(what))


@pytest.mark.parametrize("device,slice_type,exc", [
    ("cpu", P_SLICE, FastPathAbort("NxN")),
    ("cpu", B_SLICE, FastPathAbort("TU split")),
    ("cpu", I_SLICE, FastPathAbort("NxN")),
    ("cuda", P_SLICE, ValueError("corrupt payload")),
])
def test_scalar_walk_kept_elsewhere(device, slice_type, exc):
    """The CPU decoder, for every slice type, and parse errors other than
    an abort on the card keep the scalar redo."""
    dec = HevcDecoder(device="cpu")
    dec.device = torch.device(device)
    assert dec._check_fast_abort(SliceHeader(slice_type=slice_type),
                                 exc) is None


@pytest.mark.parametrize("depth,ok", [(0, True), (1, True), (2, False)])
@pytest.mark.parametrize("slice_type", [I_SLICE, P_SLICE, B_SLICE])
def test_fast_path_admits_one_intra_split_level(depth, ok, slice_type):
    """An SPS that allows one intra TU split level keeps I, P and B
    pictures on the fast paths (a TU that splits aborts in the parse);
    deeper ones leave it, and on the card any picture then raises."""
    import copy
    enc = HevcEncoder(EncoderConfig(width=W, height=H, preset="fast",
                                    intra_period=1), device="cpu")
    sps = copy.copy(enc.sps)
    sps.max_transform_hierarchy_depth_intra = depth
    hdr = SliceHeader(slice_type=slice_type)
    assert HevcDecoder(device="cpu")._fast_eligible(sps, enc.pps, hdr) == ok
    card = HevcDecoder(device="cpu")
    card.device = torch.device("cuda")
    if ok:
        assert card._fast_eligible(sps, enc.pps, hdr) == ok
    else:
        with pytest.raises(NotImplementedError, match="intra TU split"):
            card._fast_eligible(sps, enc.pps, hdr)


def _outside_geometry(enc, gap):
    """(sps, pps) of `enc` with one I-picture gap of the fast path."""
    import copy
    sps, pps = copy.copy(enc.sps), copy.copy(enc.pps)
    if gap == "PCM":
        sps.pcm_enabled = 1
    elif gap == "transform skip":
        pps.transform_skip_enabled = 1
    else:
        sps.max_transform_hierarchy_depth_intra = 2
    return sps, pps


@pytest.mark.parametrize("gap", ["PCM", "transform skip", "intra TU split"])
def test_card_decoder_raises_on_an_i_slice_outside_the_fast_path(gap):
    """An I slice outside the fast path's geometry raises on the card,
    naming the gap as the P/B branch does, where it used to be decoded on
    the host scalar walk; the CPU decoder still takes that walk."""
    enc = HevcEncoder(EncoderConfig(width=W, height=H, preset="fast",
                                    intra_period=1), device="cpu")
    sps, pps = _outside_geometry(enc, gap)
    hdr = SliceHeader(slice_type=I_SLICE)
    assert HevcDecoder(device="cpu")._fast_eligible(sps, pps, hdr) is False
    card = HevcDecoder(device="cpu")
    card.device = torch.device("cuda")      # no launch happens here
    with pytest.raises(NotImplementedError, match=gap + ".* in I pictures"):
        card._fast_eligible(sps, pps, hdr)


def _one_slice_stream():
    """The port's one-picture all-intra stream of `flat_left`, with the
    picture's slice NAL written a second time after it."""
    (y, u, v), = flat_left(1)
    data, _ = encode_sequence(
        [YUVFrame(y, u, v, poc=0)],
        EncoderConfig(width=W, height=H, preset="ultrafast", intra_period=1),
        device="cpu")
    s, e = next((s, e) for s, e in split_annexb(data)
                if is_vcl((data[s] >> 1) & 63))
    return data + b"\x00\x00\x01" + data[s:e]


@pytest.mark.parametrize("what", ["a picture's second or later slice",
                                  "a dependent slice segment"])
def test_card_decoder_raises_on_a_later_slice(what, monkeypatch):
    """A slice after a picture's first (or a dependent segment) takes the
    scalar walk, so the card's decoder raises on it before any launch; the
    CPU decoder decodes it. The second copy of the picture's slice is read
    as an independent later slice at CTB 0 or as a dependent segment."""
    import ks265codec_tpu_torch.decode.decoder as decoder_mod
    data = _one_slice_stream()
    parse = decoder_mod.parse_slice_header
    seen = []

    def later_slice(*args, **kw):
        hdr, sps, pps, reader = parse(*args, **kw)
        seen.append(hdr)
        if len(seen) == 2:
            if what.startswith("a dependent"):
                hdr.dependent_slice_segment = 1
            else:
                hdr.first_slice_in_pic = 0
        return hdr, sps, pps, reader

    monkeypatch.setattr(decoder_mod, "parse_slice_header", later_slice)
    card = HevcDecoder(device="cpu")
    card.device = torch.device("cuda")      # the raise comes before a launch
    with pytest.raises(NotImplementedError, match=what + " on the card"):
        card.decode_all(data)
    assert len(seen) == 2
    seen.clear()
    out = HevcDecoder(device="cpu").decode_all(data)
    assert len(seen) == 2 and len(out) == 1
    assert out[0].y.shape == (H, W)
