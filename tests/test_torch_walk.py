"""The sequential P/B host walk on the CPU, exact against ks265codec_tpu:
K20 (ops/me.py, the dense SAD grid and the searches that read it), K21
(ops/subpel.py, the quarter-pel costs and the bi cost), the walk's
pre-analysis and the streams of the presets that take the walk.

Kernel level, on seeded numpy inputs: the port's plain K20 equals the
jitted `full_search_grid` at every (bs, sr) the walk runs; its
`motion_search_frame`, `refine_around` and `motion_search_frame_hier`
equal the reference's on planes whose motion points off the picture; the
plain K21 (`subpel_costs`, `interp14_by_phase`, `refine_subpel_frame`
with and without its float64 rate term, `bi_pred_cost`) equals the
reference's with motion pointing off the picture. All exact.

Streams, 128x96 unless named (one reference task and one port task per
test run under pytest-xdist, tests/_torch_shared.py):
  slower   EncoderConfig(preset="slower") offline, QP 27, 9 frames
           (I P 7B; the P picture weighted): me 2 / merange 64 (the
           hierarchical route), partitions 1, the inter TU split,
           CU-tree, SAO tier 4;
  ldp      slower zerolatency with refs=2, 4 frames (two L0 references
           from the third picture on);
  placebo  placebo zerolatency, 3 frames at 64x64 (AMP PUs, subme 2).
The walk's pre-analysis of the offline stream's P picture, its first B
picture and the low-delay stream's first two-reference P picture are
recorded on both sides; their inputs must be equal and then their
outputs (mv16/sad16/ref16, mv8/sad8/ref8 or the B fields with dir16 /
dir8, split16, use32/sad32). Each port stream (HevcEncoder with
device="cpu") must equal the reference's byte for byte with the same
reconstructions, and the port's decoder with device="cpu" (its scalar
walk: the fast parse aborts on TU splits and sub-8 PUs) must give the
encoder's md5s.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ks265codec_tpu.encode.inter_frame as jif
import ks265codec_tpu.ops.me as jme
import ks265codec_tpu.ops.subpel as jsp
from ks265codec_tpu.encode.config import EncoderConfig as JaxConfig
from ks265codec_tpu.encode.encoder import HevcEncoder as JaxEncoder
from ks265codec_tpu.utils.yuv import YUVFrame as JaxFrame
import ks265codec_tpu_torch.encode.inter_frame as tif
from ks265codec_tpu_torch.decode.decoder import HevcDecoder
from ks265codec_tpu_torch.encode.config import EncoderConfig, resolve_preset
from ks265codec_tpu_torch.encode.encoder import HevcEncoder, unsupported
from ks265codec_tpu_torch.ops import me as tme
from ks265codec_tpu_torch.ops import subpel as tsp
from ks265codec_tpu_torch.utils.yuv import YUVFrame
from _torch_shared import release_after_module, shared  # noqa: F401

W, H = 128, 96
STREAMS = {
    "slower": (dict(preset="slower"), 9, W, H),
    "ldp": (dict(preset="slower", latency="zerolatency", refs=2), 4, W, H),
    "placebo": (dict(preset="placebo", latency="zerolatency"), 3, 64, 64),
}
# the pre-analyses recorded: (stream, slice type, POC)
RECORDED = [("slower", "P", 8), ("slower", "B", 4), ("ldp", "P", 2)]
P_OUT = ("mv16", "sad16", "ref16", "mv8", "sad8", "ref8", "split16",
         "use32", "sad32", "mode16", "mode8", "icost16")
B_OUT = ("mv0q", "mv1q", "mv0q8", "mv1q8", "dir16", "dir8", "sad16",
         "sad8", "split16", "use32", "sad32", "mode16", "mode8")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread while this module runs (a thread per core
    oversubscribes xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def clip(n, w, h):
    """A moving bright disc and four small squares moving their own ways
    over drifting sinusoids with noise (seed 9): b-adapt keeps the GOP-8,
    the disc's motion reaches past the picture edge, and the squares give
    residuals that the inter TU split codes."""
    rng = np.random.RandomState(9)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        y = 128 + 60 * np.sin((xx + 3 * t) / 17.0) \
            + 40 * np.cos((yy - 2 * t) / 13.0)
        y[(yy - 40) ** 2 + (xx - 50 - 4 * t) ** 2 < 20 ** 2] = 210
        for k in range(4):
            y0, x0 = 6 + 22 * k + 3 * t * (k % 2), 10 + 29 * k - 2 * t
            y[(yy >= y0) & (yy < y0 + 5) & (xx >= x0) & (xx < x0 + 5)] = \
                20 + 60 * k
        y = np.clip(y + rng.randn(h, w) * 3, 0, 255).astype(np.uint8)
        u = np.clip(128 + 30 * np.sin((xx[::2, ::2] + t) / 11.0), 0, 255)
        v = np.clip(128 + 30 * np.cos((yy[::2, ::2] - t) / 13.0), 0, 255)
        out.append((y, u.astype(np.uint8), v.astype(np.uint8)))
    return out


def _md5(f):
    return tuple(hashlib.md5(np.ascontiguousarray(p).tobytes()).hexdigest()
                 for p in (f.y, f.u, f.v))


def _spy(module, store, names_p, names_b):
    """Wrap both encoders' `_pre_analyze` in `module` to record, per
    picture, the inputs (source, reference planes and POCs) and the
    outputs. Returns the undo function."""
    saved = []
    for cls, names in ((module.PFrameEncoder, names_p),
                       (module.BFrameEncoder, names_b)):
        orig = cls.__dict__["_pre_analyze"]

        def spy(self, orig=orig, names=names):
            kind = "B" if self.hdr.slice_type == 0 else "P"
            inp = dict(src=np.array(self.src_y), qp=self.qp,
                       refs=[[(int(rp.poc), np.array(rp.fs.y))
                              for rp in lst] for lst in self.ref_lists])
            orig(self)
            out = {k: np.array(getattr(self, k)) for k in names}
            store.append((kind, int(self.hdr.poc), inp, out))

        setattr(cls, "_pre_analyze", spy)
        saved.append((cls, orig))

    def undo():
        for cls, orig in saved:
            setattr(cls, "_pre_analyze", orig)
    return undo


def _encode(make, frame_cls, name):
    over, n, w, h = STREAMS[name]
    enc = make(dict(width=w, height=h, qp=27, **over))
    efs = []
    for i, p in enumerate(clip(n, w, h)):
        efs += enc.encode_frame(frame_cls(*p, poc=i))
    efs += enc.flush()
    return dict(bs=b"".join(e.data for e in efs),
                types="".join(e.slice_type for e in efs),
                md5=[_md5(e.recon) for e in efs])


def _record(module, encode):
    """encode(name) for every stream with the pre-analyses recorded:
    (streams, {stream: [(kind, poc, inputs, outputs), ...]})."""
    pre, by_stream, out = [], {}, {}
    undo = _spy(module, pre, P_OUT, B_OUT)
    try:
        for name in STREAMS:
            start = len(pre)
            out[name] = encode(name)
            by_stream[name] = pre[start:]
    finally:
        undo()
    return out, by_stream


def _reference():
    out, pre = _record(jif, lambda name: _encode(
        lambda c: JaxEncoder(JaxConfig(**c)), JaxFrame, name))
    return dict(streams=out, pre=pre)


def _port():
    walked = []
    orig = tif.PFrameEncoder.compute_sequential

    def seq(self):
        orig(self)
        v = (slice(0, self.sps.height >> 2), slice(0, self.sps.width >> 2))
        walked.append(dict(part=set(np.unique(self.syn.part[v]).tolist()),
                           tu_split=bool(self.syn.tu_split[v].any()),
                           ref1=bool((self.fs.ref_idx[0][v] > 0).any()),
                           intra=bool((self.fs.pred_mode[v] == 1).any())))

    tif.PFrameEncoder.compute_sequential = seq
    try:
        out, pre = _record(tif, lambda name: _encode(
            lambda c: HevcEncoder(EncoderConfig(**c), device="cpu"),
            YUVFrame, name))
    finally:
        tif.PFrameEncoder.compute_sequential = orig
    for st in out.values():
        dec = HevcDecoder(device="cpu")
        st["decoded"] = [_md5(f) for f in dec.decode_all(st["bs"])]
    return dict(streams=out, pre=pre, walked=walked)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return shared(tmp_path_factory, {"torch_walk_ref": _reference,
                                     "torch_walk_port": _port})


# ------------------------------------------------------------------ K20

def _rand(rng, shape, hi=256):
    return rng.randint(0, hi, shape).astype(np.int32)


@pytest.mark.parametrize("bs,sr", [(16, 16), (8, 16), (4, 16), (8, 3),
                                   (4, 3)])
def test_full_search_grid_plain_matches_reference(bs, sr):
    rng = np.random.RandomState(bs + sr)
    blocks = _rand(rng, (23, bs, bs))
    wins = _rand(rng, (23, bs + 2 * sr, bs + 2 * sr))
    want = np.asarray(jme.full_search_grid(jnp.asarray(blocks),
                                           jnp.asarray(wins), bs, sr))
    got = tme.full_search_grid(torch.from_numpy(blocks),
                               torch.from_numpy(wins), bs, sr).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _planes(seed, w=64, h=48, shift=(5, -3)):
    """A textured source and a reference moved by `shift` (x, y) with
    noise: the winners near the edges point off the picture."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h + 32, 0:w + 32]
    base = 128 + 70 * np.sin(xx / 5.0) * np.cos(yy / 7.0) \
        + rng.randn(h + 32, w + 32) * 6
    src = base[16:16 + h, 16:16 + w]
    ref = base[16 + shift[1]:16 + shift[1] + h,
               16 + shift[0]:16 + shift[0] + w]
    ref = ref + rng.randn(h, w) * 2
    return (np.clip(src, 0, 255).astype(np.int32),
            np.clip(ref, 0, 255).astype(np.int32))


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.array_equal(g, w)


@pytest.mark.parametrize("bs", [16, 8])
def test_motion_search_frame_matches_reference(bs):
    src, ref = _planes(bs)
    lam = 3.7 if bs == 16 else 1.85
    _equal(tme.motion_search_frame(src, ref, bs, 16, lam, device="cpu"),
           jme.motion_search_frame(src, ref, bs, 16, lam))


@pytest.mark.parametrize("bs", [16, 8])
def test_refine_around_matches_reference(bs):
    src, ref = _planes(bs + 1)
    rng = np.random.RandomState(bs)
    cen = rng.randint(-20, 21, (48 // bs, 64 // bs, 2))
    got = tme.refine_around(src, ref, bs, cen, 3, device="cpu")
    _equal(got, jme.refine_around(src, ref, bs, cen, 3))
    # some windows were clamped into the pad
    assert (got[0] != cen).any()


@pytest.mark.parametrize("bs", [16, 8])
def test_motion_search_frame_hier_matches_reference(bs):
    src, ref = _planes(bs + 2, w=128, h=64, shift=(13, -9))
    lam = 3.7 if bs == 16 else 1.85
    _equal(tme.motion_search_frame_hier(src, ref, bs, 64, lam,
                                        device="cpu"),
           jme.motion_search_frame_hier(src, ref, bs, 64, lam))
    assert np.array_equal(tme.down2(src), jme._down2(src))


# ------------------------------------------------------------------ K21

@pytest.mark.parametrize("bs", [16, 8])
def test_subpel_costs_matches_reference(bs):
    rng = np.random.RandomState(bs)
    wins = _rand(rng, (19, bs + 10, bs + 10))
    src = _rand(rng, (19, bs, bs))
    want = np.asarray(jsp.subpel_costs(jnp.asarray(wins), jnp.asarray(src),
                                       bs, jsp.SUBPEL_CANDS))
    got = tsp.subpel_costs(torch.from_numpy(wins), torch.from_numpy(src),
                           bs).numpy()
    assert tsp.SUBPEL_CANDS == jsp.SUBPEL_CANDS
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("bs", [16, 8])
def test_interp14_by_phase_matches_reference(bs):
    rng = np.random.RandomState(bs + 1)
    wins = _rand(rng, (11, bs + 10, bs + 10))
    phases = tuple((fx, fy) for fy in range(4) for fx in range(4)) \
        + ((-3, 2), (3, -1))
    want = np.asarray(jsp.interp14_by_phase(jnp.asarray(wins), bs, phases))
    got = tsp.interp14_by_phase(torch.from_numpy(wins), bs, phases).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("rate", [False, True], ids=["sad", "rate"])
@pytest.mark.parametrize("bs", [16, 8])
def test_refine_subpel_frame_matches_reference(bs, rate):
    src, ref = _planes(bs + 3)
    rng = np.random.RandomState(bs + 7)
    mv_full = rng.randint(-12, 13, (48 // bs, 64 // bs, 2))
    kw = {}
    if rate:
        kw = dict(mv_pred_q=rng.randint(-40, 41, mv_full.shape), lam=2.9)
    _equal(tsp.refine_subpel_frame(src, ref, mv_full, bs, 60, 40,
                                   device="cpu", **kw),
           jsp.refine_subpel_frame(src, ref, mv_full, bs, 60, 40, **kw))


@pytest.mark.parametrize("bs", [16, 8])
def test_bi_pred_cost_matches_reference(bs):
    src, ref0 = _planes(bs + 4)
    _, ref1 = _planes(bs + 5, shift=(-4, 6))
    rng = np.random.RandomState(bs + 9)
    m0 = rng.randint(-50, 51, (48 // bs, 64 // bs, 2))
    m1 = rng.randint(-50, 51, (48 // bs, 64 // bs, 2))
    got = tsp.bi_pred_cost(src, ref0, ref1, m0, m1, bs, 60, 40, device="cpu")
    want = jsp.bi_pred_cost(src, ref0, ref1, m0, m1, bs, 60, 40)
    assert got.dtype == want.dtype and np.array_equal(got, want)


# ------------------------------------------------------- the walk's modules

@pytest.mark.parametrize("rec", RECORDED, ids=lambda r: f"{r[0]}-{r[1]}{r[2]}")
def test_pre_analysis_matches_reference(both, rec):
    """The walk's `_pre_analyze` (K5, K20, K21 and the host decisions) on
    the same recorded input: the port's outputs equal the reference's."""
    name, kind, poc = rec

    def pick(side):
        return next((i, o) for k, p, i, o in both[side]["pre"][name]
                    if k == kind and p == poc)

    ri, ro = pick("torch_walk_ref")
    pi, po = pick("torch_walk_port")
    assert np.array_equal(pi["src"], ri["src"]) and pi["qp"] == ri["qp"]
    assert [[p for p, _ in lst] for lst in pi["refs"]] == \
        [[p for p, _ in lst] for lst in ri["refs"]]
    for a, b in zip(sum(pi["refs"], []), sum(ri["refs"], [])):
        assert np.array_equal(a[1], b[1])
    if name == "ldp":
        assert len(ri["refs"][0]) == 2
    assert set(po) == set(ro)
    for k in ro:
        assert po[k].shape == ro[k].shape, k
        assert np.array_equal(po[k], ro[k]), k


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_byte_identical(both, name):
    got = both["torch_walk_port"]["streams"][name]
    want = both["torch_walk_ref"]["streams"][name]
    assert got["types"] == want["types"]
    assert got["bs"] == want["bs"]


@pytest.mark.parametrize("name", list(STREAMS))
def test_recons_equal_reference(both, name):
    assert both["torch_walk_port"]["streams"][name]["md5"] == \
        both["torch_walk_ref"]["streams"][name]["md5"]


@pytest.mark.parametrize("name", list(STREAMS))
def test_cpu_decode_gives_encoder_md5s(both, name):
    st = both["torch_walk_port"]["streams"][name]
    assert sorted(st["decoded"]) == sorted(st["md5"])
    assert len(st["decoded"]) == len(st["md5"])


def test_streams_exercise_the_walk(both):
    """The streams reach the walk's syntax: B pictures, rectangular and
    AMP PUs, inter TU splits, a second L0 reference and intra CUs."""
    types = {n: s["types"]
             for n, s in both["torch_walk_port"]["streams"].items()}
    assert types == {"slower": "IPBBBBBBB", "ldp": "IPPP",
                     "placebo": "IPP"}
    w = both["torch_walk_port"]["walked"]
    assert len(w) == 8 + 3 + 2
    parts = set().union(*(x["part"] for x in w))
    assert parts & {1, 2} and parts & {4, 5, 6, 7}
    assert any(x["tu_split"] for x in w)
    assert any(x["ref1"] for x in w[8:11])
    assert any(x["intra"] for x in w)


@pytest.mark.parametrize("preset", ["slower", "veryslow", "placebo"])
def test_walk_presets_are_supported(preset):
    """The presets whose P and B pictures take the walk run at -rc 0 in
    every latency mode, whatever their refs."""
    for latency in ("offline", "zerolatency", "livestreaming"):
        cfg = resolve_preset(EncoderConfig(preset=preset, latency=latency,
                                           rc=0))
        assert cfg.partitions != 0 and cfg.refs > 1
        assert unsupported(cfg) == []
