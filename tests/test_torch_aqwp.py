"""cu_qp_delta (adaptive quantisation from K12's 8x8 variance, CU-tree, K17's
effective-QP chain) and explicit weighted prediction (K14 inside K17 and
K18) on the CPU, exact against ks265codec_tpu.

Two reference encodes at 128x96, each once per test run (under
pytest-xdist one worker computes them and the others read the result;
tests/_torch_shared.py):
  A  a 9-frame luma fade (the synthetic content of bench.py at this size,
     seed 9, luma 5% darker each frame) at the `fast` preset, QP 27,
     `cutree=1`, `aq_mode=2`, `weightp=True`, offline (the default GOP-8
     with b-adapt: coded I P B B B B B B B), with K12, the lookahead's
     `_aq_offsets` / `_cutree` and `code_inter_frame_jit` recorded
     (inputs copied at the call);
  C  2 frames all-intra at `fast`, `aq_mode=1`, tiles 2x2, of the fade
     with a smooth left half (so that AQ's offsets are not all 0).
The port's HevcEncoder(device="cpu") must write both streams byte for
byte with the same reconstructions, and its HevcDecoder(device="cpu")
must give the reference encoder's md5s through the fast paths. Kernel
level: the plain K12 variance, `_aq_offsets` / `_cutree`, the
effective-QP chain (against the jitted `_effective_qp4` and the host
`apply_effective_qp`), weighted K14 (against `mc_planes`), K17 with the
chain and weights on the recorded calls, and K18 with weights and
cu_qp_delta on the decoded weighted P picture (against
`recon_inter_filter_jit`). Every comparison is exact equality."""

import types

import numpy as np
import pytest
import torch

import ks265codec_tpu.encode.lookahead as jlh
import ks265codec_tpu.ops.intercode as jic
import ks265codec_tpu.ops.lookahead as jla
import ks265codec_tpu.ops.wavefront as jwf
from ks265codec_tpu.decode.interfast import _intra_segs_dec
from ks265codec_tpu.encode.config import EncoderConfig as JaxConfig
from ks265codec_tpu.encode.encoder import HevcEncoder as JaxEncoder
from ks265codec_tpu.encode.inter_engine import _unpack_row
from ks265codec_tpu.ops.mc import mc_planes
from ks265codec_tpu.utils.md5 import frame_md5 as jax_md5
from ks265codec_tpu.utils.yuv import YUVFrame as JaxFrame
from ks265codec_tpu_torch.decode import interfast as tif
from ks265codec_tpu_torch.decode.decoder import HevcDecoder
from ks265codec_tpu_torch.decode.slice_dec import FrameState
from ks265codec_tpu_torch.encode import encoder as tenc
from ks265codec_tpu_torch.encode.config import EncoderConfig
from ks265codec_tpu_torch.encode.encoder import HevcEncoder, unsupported
from ks265codec_tpu_torch.encode.lookahead import Lookahead
from ks265codec_tpu_torch.encode.map_writer import EncSyntax, \
    apply_effective_qp
from ks265codec_tpu_torch.encode.merge_vec import zscan_vals
from ks265codec_tpu_torch.hevc.params import PPS, SPS
from ks265codec_tpu_torch.hevc.slicehdr import SliceHeader
from ks265codec_tpu_torch.ops import intercode as tic
from ks265codec_tpu_torch.ops import lookahead as tla
from ks265codec_tpu_torch.ops import wavefront as twf
from ks265codec_tpu_torch.ops.mc import mc_planes_plain
from ks265codec_tpu_torch.utils.md5 import frame_md5
from ks265codec_tpu_torch.utils.yuv import YUVFrame
from _torch_shared import release_after_module, shared  # noqa: F401
from test_torch_inter import sched_from_segs

W, H = 128, 96
PATHS = {
    "A": (dict(preset="fast", qp=27, cutree=1, aq_mode=2, weightp=True), 9,
          "IPBBBBBBB"),
    "C": (dict(preset="fast", qp=27, aq_mode=1, intra_period=1,
               tiles="2x2"), 2, "II"),
}


def cfg(name):
    return dict(width=W, height=H, rc=0, frame_rate=30, **PATHS[name][0])


def fade(n, w=W, h=H):
    """bench.py's synthetic frames (moving disc over gradients, seed 9) at
    w x h, the luma 5% darker each frame."""
    rng = np.random.RandomState(9)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        y = 128 + 60 * np.sin((xx + 3 * t) / 37.0) \
            + 40 * np.cos((yy - 2 * t) / 29.0)
        y[(yy - 0.4 * h) ** 2 + (xx - 0.3 * w - 2 * t) ** 2
          < (0.12 * h) ** 2] = 210
        y = np.clip(y * 0.95 ** t + rng.randn(h, w) * 3, 0,
                    255).astype(np.uint8)
        u = np.clip(128 + 30 * np.sin((xx[::2, ::2] + t) / 41.0), 0,
                    255).astype(np.uint8)
        v = np.clip(128 + 30 * np.cos((yy[::2, ::2] - t) / 43.0), 0,
                    255).astype(np.uint8)
        out.append((y, u, v))
    return out


def flat_left(n, w=W, h=H):
    """The fade with a smooth left half: the CTBs' 8x8 variances differ
    enough for AQ to give them nonzero offsets at this size."""
    out = []
    for y, u, v in fade(n, w, h):
        y = y.copy()
        y[:, : w // 2] = 100 + np.arange(w // 2)[None, :] // 8
        out.append((y, u, v))
    return out


FRAMES = {"A": fade, "C": flat_left}


def T(a):
    return torch.from_numpy(np.array(a))


def _copied(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_copied(a) for a in x)
    if isinstance(x, dict):
        return {k: _copied(v) for k, v in x.items()}
    return np.array(x) if hasattr(x, "shape") else x


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread while this module runs (its plain versions are
    many small operations; a thread per core oversubscribes xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference():
    """The reference encodes of paths A and C; A records K12 (with the
    variance), the lookahead's offsets and K17."""
    rec = {k: [] for k in ("la", "la_first", "aq", "tree", "code")}
    saved = [(jla, "frame_features_batch"), (jla, "frame_features_first"),
             (jic, "code_inter_frame_jit"),
             (jlh.Lookahead, "_aq_offsets"), (jlh.Lookahead, "_cutree")]
    orig = {name: getattr(m, name) for m, name in saved}

    def wrap(fn, key, method=False):
        def g(*a, **k):
            args = _copied(a[1:] if method else a)
            out = fn(*a, **k)
            rec[key].append((args, dict(k), _copied(out)))
            return out
        return g

    jla.frame_features_batch = wrap(orig["frame_features_batch"], "la")
    jla.frame_features_first = wrap(orig["frame_features_first"],
                                    "la_first")
    jic.code_inter_frame_jit = wrap(orig["code_inter_frame_jit"], "code")
    jlh.Lookahead._aq_offsets = wrap(orig["_aq_offsets"], "aq", True)
    jlh.Lookahead._cutree = wrap(orig["_cutree"], "tree", True)
    streams = {}
    try:
        for name, (_, n, _) in PATHS.items():
            planes = FRAMES[name](n)
            enc = JaxEncoder(JaxConfig(**cfg(name)))
            efs = []
            for i, p in enumerate(planes):
                efs += enc.encode_frame(JaxFrame(*p, poc=i))
            efs += enc.flush()
            disp = sorted(efs, key=lambda e: e.display_idx)
            streams[name] = dict(
                planes=planes, bs=b"".join(e.data for e in efs),
                types="".join(e.slice_type for e in efs),
                recons=[(e.recon.y, e.recon.u, e.recon.v) for e in efs],
                md5=[jax_md5(e.recon) for e in disp])
            if name == "A":
                streams["rec"] = {k: list(v) for k, v in rec.items()}
    finally:
        for m, name in saved:
            setattr(m, name, orig[name])
    return streams


def _port():
    """The port's encodes of both paths on the CPU, with what each engaged:
    pictures whose slice carries weights, CTBs with a nonzero lookahead
    offset, and 4x4 cells K17's chain moved off their planned QP."""
    out = {}
    orig_wp, orig_chain = tenc.decide_weightp, tic.effective_qp4
    for name, (_, n, _) in PATHS.items():
        seen = dict(weighted=0, moved=0)

        def wp(*a):
            w = orig_wp(*a)
            seen["weighted"] += w is not None
            return w

        def chain(qp4, *a, **k):
            out = orig_chain(qp4, *a, **k)         # the QPs K7 reads
            seen["moved"] += int((out.to(torch.int32)
                                  != qp4.to(torch.int32)).sum())
            return out

        tenc.decide_weightp, tic.effective_qp4 = wp, chain
        try:
            enc = HevcEncoder(EncoderConfig(**cfg(name)), device="cpu")
            efs = []
            for i, p in enumerate(FRAMES[name](n)):
                efs += enc.encode_frame(YUVFrame(*p, poc=i))
            efs += enc.flush()
        finally:
            tenc.decide_weightp, tic.effective_qp4 = orig_wp, orig_chain
        dqp = [fa.dqp_ctu for fa in enc.la.analyses.values()
               if fa.dqp_ctu is not None]
        out[name] = dict(
            bs=b"".join(e.data for e in efs),
            types="".join(e.slice_type for e in efs),
            recons=[(e.recon.y, e.recon.u, e.recon.v) for e in efs],
            cu_qp_delta=enc.pps.cu_qp_delta_enabled,
            nonzero_dqp=int(sum((d != 0).sum() for d in dqp)), **seen)
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return shared(tmp_path_factory, {"torch_aqwp_ref": _reference,
                                     "torch_aqwp_port": _port})


@pytest.fixture(scope="module")
def ref(both):
    return both["torch_aqwp_ref"]


@pytest.fixture(scope="module")
def port(both):
    return both["torch_aqwp_port"]


# ------------------------------------------------------- K12's variance

def _halves(kind, F=3, h=48, w=64):
    """Half planes: random, two-level (ties in the squared deviations) or
    flat blocks next to one-sample outliers."""
    rng = np.random.RandomState({"random": 1, "two_level": 2,
                                 "flat": 3}[kind])
    if kind == "random":
        return rng.randint(0, 256, (F, h, w)).astype(np.uint8)
    if kind == "two_level":
        return np.where(rng.rand(F, h, w) < 0.5, 17, 200).astype(np.uint8)
    a = np.full((F, h, w), 90, np.uint8)
    a[:, ::8, ::16] = rng.randint(0, 256, a[:, ::8, ::16].shape)
    return a


@pytest.mark.parametrize("kind", ["random", "two_level", "flat"])
@pytest.mark.parametrize("tree", [False, True], ids=["var", "var_tree"])
def test_lookahead_variance_plain_matches_reference(kind, tree):
    """K12 with want_var: the packed rows of the batched and the first-
    frame entries equal the jitted reference's."""
    import jax.numpy as jnp
    curs, prevs = _halves(kind), _halves("random")[::-1].copy()
    want = np.asarray(jla.frame_features_batch(
        jnp.asarray(curs), jnp.asarray(prevs), want_var=True,
        want_tree=tree))
    got = tla.frame_features_batch(T(curs), T(prevs), True, tree)
    assert np.array_equal(got.numpy(), want)
    want1 = np.asarray(jla.frame_features_first(jnp.asarray(curs[0]),
                                                want_var=True,
                                                want_tree=tree))
    got1 = tla.frame_features_first(T(curs[0]), True, tree)
    assert np.array_equal(got1.numpy()[0], want1)


def test_lookahead_rows_of_the_fade_match_reference(ref):
    """K12 on the recorded halves of path A (variance and tree maps)."""
    assert ref["rec"]["la"] and ref["rec"]["la_first"]
    for (curs, prevs, want_var, want_tree), _, want in ref["rec"]["la"]:
        assert want_var and want_tree
        got = tla.frame_features_batch(T(curs), T(prevs), want_var,
                                       want_tree)
        assert np.array_equal(got.numpy(), want)
    for (half, want_var, want_tree), _, want in ref["rec"]["la_first"]:
        got = tla.frame_features_first(T(half), want_var, want_tree)
        assert np.array_equal(got.numpy()[0], want)


def test_aq_offsets_and_cutree_match_reference(ref):
    """encode/lookahead.py's `_aq_offsets` (mode 2) and `_cutree` on the
    reference's recorded inputs; some offsets are nonzero."""
    la = Lookahead(EncoderConfig(**cfg("A")), device="cpu")
    assert ref["rec"]["aq"] and ref["rec"]["tree"]
    nonzero = 0
    for a, k, want in ref["rec"]["aq"]:
        got = la._aq_offsets(*a, **k)
        assert np.array_equal(got, want)
        nonzero += int((want != 0).sum())
    for a, k, want in ref["rec"]["tree"]:
        got = la._cutree(*a, **k)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    assert nonzero > 0


@pytest.mark.parametrize("mode", [1, 3])
def test_aq_offsets_other_modes_match_reference(mode):
    """Modes 1 and 3 (mode 3 reads the half-plane block means) on random
    variances and means."""
    rng = np.random.RandomState(mode)
    var = rng.gamma(1.5, 200.0, (12, 20))
    mean8 = rng.uniform(20, 200, (12, 20))
    kw = dict(cfg("A"), aq_mode=mode)
    want = jlh.Lookahead(JaxConfig(**kw))._aq_offsets(var, mean8)
    got = Lookahead(EncoderConfig(**kw), device="cpu")._aq_offsets(var,
                                                                   mean8)
    assert np.array_equal(got, want) and (want != 0).any()


# ------------------------------------------------- K17's effective QPs

def _random_cu_maps(rng, h4, w4, pic_w4, pic_h4, log2_ctb=6):
    """A random CU quadtree per CTB (log2 CU size per 4x4 cell); CUs that
    cross the picture's edge split, as the encoder's do."""
    lg = np.zeros((h4, w4), np.int32)
    c4 = 1 << (log2_ctb - 2)

    def split(y, x, log2):
        n = 1 << (log2 - 2)
        inside = y + n <= pic_h4 and x + n <= pic_w4
        if log2 > 3 and (not inside or rng.rand() < 0.6):
            h = n >> 1
            for dy, dx in ((0, 0), (0, h), (h, 0), (h, h)):
                split(y + dy, x + dx, log2 - 1)
        else:
            lg[y:y + n, x:x + n] = log2

    for y in range(0, h4, c4):
        for x in range(0, w4, c4):
            split(y, x, log2_ctb)
    return lg


def _chain_inputs(seed, wpp, pic_w=200, pic_h=136):
    """Random planned QPs per CTB, CU maps and coefficient flags per CU on
    a picture whose size is not a multiple of the 64 CTB."""
    rng = np.random.RandomState(seed)
    ph, pw = -(-pic_h // 64) * 64, -(-pic_w // 64) * 64
    h4, w4 = ph // 4, pw // 4
    lg = _random_cu_maps(rng, h4, w4, pic_w >> 2, pic_h >> 2)
    qctb = rng.randint(20, 40, (ph // 64, pw // 64))
    qp4 = np.repeat(np.repeat(qctb, 16, 0), 16, 1).astype(np.int32)
    s4 = 1 << (lg - 2)
    oy = np.arange(h4)[:, None] & ~(s4 - 1)
    ox = np.arange(w4)[None, :] & ~(s4 - 1)
    coded_cu = rng.rand(h4, w4) < 0.3
    cbf4 = coded_cu[oy, ox]
    cbf4[:16, 16:32] = False            # a CTB without coefficients
    zloc = (zscan_vals(h4, w4, 6) & 255).astype(np.int32)
    return dict(qp4=qp4, cbf4=cbf4, zin4=zloc, zcu4=zloc[oy, ox], lg=lg,
                pic_w=pic_w, pic_h=pic_h, wpp=wpp, slice_qp=30)


@pytest.mark.parametrize("wpp", [False, True], ids=["no_wpp", "wpp"])
@pytest.mark.parametrize("seed", [0, 1])
def test_effective_qp4_plain_matches_reference(seed, wpp):
    import jax
    import jax.numpy as jnp
    d = _chain_inputs(seed, wpp)
    fn = jax.jit(jic._effective_qp4, static_argnames=(
        "slice_qp", "wpp", "cs", "pic_w", "pic_h"))
    want = np.asarray(fn(*(jnp.asarray(d[k]) for k in
                           ("qp4", "cbf4", "zin4", "zcu4")),
                         slice_qp=d["slice_qp"], wpp=wpp, cs=64,
                         pic_w=d["pic_w"], pic_h=d["pic_h"]))
    got = tic.effective_qp4_plain(*(T(d[k]) for k in
                                    ("qp4", "cbf4", "zin4", "zcu4")),
                                  d["slice_qp"], wpp, 64, d["pic_w"],
                                  d["pic_h"])
    assert np.array_equal(got.numpy(), want)
    assert (want != d["qp4"]).any()


@pytest.mark.parametrize("wpp", [False, True], ids=["no_wpp", "wpp"])
def test_effective_qp4_plain_matches_host_walk(wpp):
    """The chain against the host copy `apply_effective_qp` on the same
    CU tree, planned QPs and coefficient flags (in-picture cells)."""
    d = _chain_inputs(5, wpp)
    sps = SPS()
    sps.width, sps.height = d["pic_w"], d["pic_h"]
    sps.log2_min_cb, sps.log2_ctb, sps.log2_min_tb, sps.log2_max_tb = \
        3, 6, 2, 5
    sps.chroma_format_idc = 1
    pps = PPS()
    pps.entropy_coding_sync_enabled = int(wpp)
    pps.tiles_enabled = 0
    fs = FrameState(sps)
    syn = EncSyntax(fs)
    h4, w4 = fs.cu_depth.shape
    fs.cu_depth[:] = (6 - d["lg"][:h4, :w4]).astype(fs.cu_depth.dtype)
    fs.qp[:] = d["qp4"][:h4, :w4]
    fs.cbf_luma[:] = d["cbf4"][:h4, :w4]
    syn.cbf_cb[:] = 0
    syn.cbf_cr[:] = 0
    hdr = SliceHeader(slice_qp=d["slice_qp"])
    apply_effective_qp(fs, syn, sps, pps, hdr)
    got = tic.effective_qp4_plain(*(T(d[k]) for k in
                                    ("qp4", "cbf4", "zin4", "zcu4")),
                                  d["slice_qp"], wpp, 64, d["pic_w"],
                                  d["pic_h"]).numpy()
    v = (slice(0, d["pic_h"] >> 2), slice(0, d["pic_w"] >> 2))
    assert np.array_equal(got[v], fs.qp[v].astype(np.int32))
    assert (got[v] != d["qp4"][v]).any()


# ------------------------------------------------------ weighted K14

def _weights(rng, R):
    flag = rng.rand(R, 3) < 0.7
    flag[0, 0] = True
    wgt = rng.randint(30, 100, (R, 3)).astype(np.int32)
    off = rng.randint(-20, 20, (R, 3)).astype(np.int32)
    return flag, wgt, off, np.array([12, 12, 12], np.int32)


@pytest.mark.parametrize("bi", [False, True], ids=["uni", "bi"])
def test_weighted_mc_plain_matches_reference(bi):
    import jax.numpy as jnp
    rng = np.random.RandomState(17 + bi)
    R, ph, pw, pic_w, pic_h = 2, 64, 64, 56, 48
    refs = [rng.randint(0, 256, (R, ph >> s, pw >> s)).astype(np.uint8)
            for s in (0, 1, 1)]
    h8, w8 = ph // 8, pw // 8
    slot0 = rng.randint(-1 if bi else 0, R, (h8, w8)).astype(np.int32)
    slot1 = rng.randint(-1, R, (h8, w8)).astype(np.int32)
    slot0[(slot0 < 0) & (slot1 < 0)] = 0
    mv0 = rng.randint(-80, 80, (h8, w8, 2)).astype(np.int32)
    mv1 = rng.randint(-80, 80, (h8, w8, 2)).astype(np.int32)
    w0, w1 = _weights(rng, R), _weights(rng, R)
    J = lambda w: tuple(jnp.asarray(a) for a in w)
    want = mc_planes(*refs, slot0, mv0, *((slot1, mv1) if bi else ()),
                     wts0=J(w0), wts1=J(w1) if bi else None, pic_w=pic_w,
                     pic_h=pic_h)
    if not bi:
        slot1 = np.full_like(slot0, -1)
    got = mc_planes_plain(*(T(r) for r in refs), T(slot0.reshape(-1)),
                          T(mv0.reshape(-1, 2)), T(slot1.reshape(-1)),
                          T(mv1.reshape(-1, 2)), bi, h8, w8, pic_w, pic_h,
                          w0, w1 if bi else None)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    plain = mc_planes_plain(*(T(r) for r in refs), T(slot0.reshape(-1)),
                            T(mv0.reshape(-1, 2)), T(slot1.reshape(-1)),
                            T(mv1.reshape(-1, 2)), bi, h8, w8, pic_w, pic_h)
    assert not np.array_equal(plain[0].numpy(), want[0])


def test_unflagged_weight_is_the_spec_default():
    """A cell whose slot carries no flag takes weight 2^denominator (spec
    8.5.3.3.4.3), so a table without flags gives the default combine at
    any denominator. The reference's `_cell_w` takes 64, right only at
    denominator 6; the port does not carry that."""
    rng = np.random.RandomState(31)
    R, ph, pw = 2, 32, 48
    refs = [T(rng.randint(0, 256, (R, ph >> s, pw >> s)).astype(np.uint8))
            for s in (0, 1, 1)]
    h8, w8 = ph // 8, pw // 8
    slot0 = T(rng.randint(0, R, h8 * w8).astype(np.int32))
    mv0 = T(rng.randint(-40, 40, (h8 * w8, 2)).astype(np.int32))
    slot1, mv1 = torch.full_like(slot0, -1), torch.zeros_like(mv0)
    want = mc_planes_plain(*refs, slot0, mv0, slot1, mv1, False, h8, w8,
                           pw, ph)
    for denom in (0, 3, 6, 7):
        w0 = (np.zeros((R, 3), bool), np.full((R, 3), 1 << denom, np.int32),
              np.zeros((R, 3), np.int32), np.full(3, denom + 6, np.int32))
        got = mc_planes_plain(*refs, slot0, mv0, slot1, mv1, False, h8, w8,
                              pw, ph, w0, None)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_live_weighted_stream_decodes_to_the_encoders_recon():
    """The live configuration (fast, zerolatency, QP 30, intra_period 0,
    aq_mode 1, weightp) on the fade: its first P picture engages no
    weights and carries a table with denominator 0, the others weights;
    the port's CPU decoder gives the encoder's reconstruction for each."""
    kw = dict(width=W, height=H, rc=0, frame_rate=30, preset="fast",
              latency="zerolatency", qp=30, intra_period=0, aq_mode=1,
              weightp=True)
    enc = HevcEncoder(EncoderConfig(**kw), device="cpu")
    efs = []
    for i, p in enumerate(fade(5)):
        efs += enc.encode_frame(YUVFrame(*p, poc=i))
    efs += enc.flush()
    assert "".join(e.slice_type for e in efs) == "IPPPP"
    dec = HevcDecoder(device="cpu")
    got = dec.decode_all(b"".join(e.data for e in efs))
    assert dec.fast_pictures == 5
    assert [frame_md5(f) for f in got] == [frame_md5(e.recon) for e in efs]


# ------------------------------------------------ K17 with dqp and WP

def test_inter_code_dqp_wp_plain_matches_reference(ref):
    """K17 on every recorded picture of path A (cu_qp_delta on, WPP rows,
    SAO tier 3, sign hiding; the P picture with weights): planes, levels
    and SAO parameters equal."""
    calls = ref["rec"]["code"]
    assert len(calls) == 8
    assert all(k["dqp"] and k["wpp"] for _, k, _ in calls)
    assert any(a[10] is not None and a[10][0].any() for a, _, _ in calls)
    for a, k, out in calls:
        (sy, scb, scr, ry, rcb, rcr, slot0, mv0, slot1, mv1, w0, w1, packs,
         cu_lam, segs, _, e2v, e2h, etbv, etbh, emvv, emvh, qp4, zin4,
         zcu4) = a
        planes, coef, sao = tic.code_inter_frame(
            tuple(T(p) for p in (sy, scb, scr)),
            tuple(T(p) for p in (ry, rcb, rcr)), T(slot0), T(mv0),
            {key: tuple(T(v) for v in val) for key, val in packs.items()},
            T(cu_lam), sched_from_segs(segs) if segs is not None else None,
            tuple(T(x) for x in (e2v, e2h, etbv, etbh, emvv, emvh)), T(qp4),
            k["n_cu"], k["h8"], k["w8"], k["pic_w"], k["pic_h"], k["boff"],
            k["toff"], k["cbo"], k["cro"], k["deblock"], k["strong"],
            sao=(k["sao_tier"], k["slice_qp"], k["cs"]), sbh=k["sbh"],
            slot1=T(slot1), mv1=T(mv1), has_l1=k["has_l1"], wts0=w0,
            wts1=w1, dqp=(T(zin4), T(zcu4), k["slice_qp"], k["wpp"],
                          k["cs"]))
        for got, want in zip(planes + coef, out[1:7]):
            assert np.array_equal(got.numpy(), want)
        sps = types.SimpleNamespace(sao_enabled=1, ctb_size=k["cs"])
        _, want_sao = _unpack_row(out[0], *sy.shape, sps, k["esc_cap"],
                                  out[4:7])
        for got, want in zip(sao, want_sao):
            assert np.array_equal(got.numpy(), want)


# --------------------------------------------------- streams and decode

@pytest.mark.parametrize("name", list(PATHS))
def test_stream_byte_identical(ref, port, name):
    assert ref[name]["types"] == port[name]["types"] == PATHS[name][2]
    assert port[name]["cu_qp_delta"] == 1
    assert port[name]["bs"] == ref[name]["bs"]


@pytest.mark.parametrize("name", list(PATHS))
def test_recons_equal_reference(ref, port, name):
    assert len(port[name]["recons"]) == len(ref[name]["recons"])
    for got, want in zip(port[name]["recons"], ref[name]["recons"]):
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def test_weights_dqp_and_chain_engaged(port):
    """Path A carries weights in its P picture, nonzero CTB offsets and
    cells the chain moved; path C nonzero offsets."""
    a = port["A"]
    assert a["weighted"] >= 1 and a["nonzero_dqp"] > 0 and a["moved"] > 0
    assert port["C"]["nonzero_dqp"] > 0


@pytest.fixture(scope="module")
def decoded(ref):
    """The port's CPU decode of path A's stream, recording K18's inputs
    and, per picture, the reference's intra segments of the same
    FrameState."""
    from ks265codec_tpu.ops.wavefront import WavefrontIntraCoder as JaxCoder
    calls, segs = [], []
    jcoder = JaxCoder()
    orig_k18, orig_sched = twf.recon_inter_filter, tif._intra_sched

    def k18(*a, **k):
        cp = lambda x: x.clone() if isinstance(x, torch.Tensor) else x
        out = orig_k18(*a, **k)
        calls.append((tuple(cp(x) if not isinstance(x, tuple)
                            else tuple(cp(y) for y in x) for x in a),
                      {key: cp(v) for key, v in k.items()}, out))
        return out

    def sched(coder, fs, sps, pps, hdr, log2m8, intra8):
        segs.append(_intra_segs_dec(jcoder, fs, sps, pps, hdr, log2m8,
                                    intra8))
        return orig_sched(coder, fs, sps, pps, hdr, log2m8, intra8)

    twf.recon_inter_filter, tif._intra_sched = k18, sched
    try:
        dec = HevcDecoder(device="cpu")
        frames = dec.decode_all(ref["A"]["bs"])
    finally:
        twf.recon_inter_filter, tif._intra_sched = orig_k18, orig_sched
    return dict(dec=dec, frames=frames, calls=calls, segs=segs)


def test_path_a_decodes_on_the_fast_paths(ref, decoded):
    dec, frames = decoded["dec"], decoded["frames"]
    assert [f.poc for f in frames] == list(range(PATHS["A"][1]))
    assert dec.fast_pictures == PATHS["A"][1]
    assert [frame_md5(f) for f in frames] == ref["A"]["md5"]


def test_path_c_decodes_with_reference_md5(ref):
    dec = HevcDecoder(device="cpu")
    frames = dec.decode_all(ref["C"]["bs"])
    assert [frame_md5(f) for f in frames] == ref["C"]["md5"]


def test_inter_recon_wp_plain_matches_reference(decoded):
    """K18's plain version on the decoded P picture with weights (its
    QPs the parse's effective ones) against the JAX
    `recon_inter_filter_jit` on the same inputs."""
    import jax.numpy as jnp
    picks = [i for i, (a, k, _) in enumerate(decoded["calls"])
             if k["wts0"] is not None and k["wts0"][0].any()]
    assert picks
    i = picks[0]
    a, k, got = decoded["calls"][i]
    (refs, slot0, mv0, coefs, log2m8, qp4, qcb, qcr, inter8, _, bs_v, bs_h,
     sp, strong, deblock, sao_chroma, boff, toff, cbo, cro, width, height,
     cs) = a
    inter_pix = np.repeat(np.repeat(inter8.numpy(), 8, 0), 8, 1)
    J = lambda t: jnp.asarray(t.numpy())
    Jw = lambda w: None if w is None else tuple(jnp.asarray(x) for x in w)
    want = jwf.recon_inter_filter_jit(
        *(jnp.asarray(r.numpy().astype(np.int32)) for r in refs), J(slot0),
        J(mv0), J(k["slot1"]), J(k["mv1"]), Jw(k["wts0"]), Jw(k["wts1"]),
        *(J(c) for c in coefs), J(log2m8), J(qp4), J(qcb), J(qcr),
        jnp.asarray(inter_pix), decoded["segs"][i], J(bs_v), J(bs_h),
        None if sp is None else tuple(J(x) for x in sp),
        has_l1=bool(k["has_l1"]), strong=strong, deblock=deblock,
        sao=sp is not None, sao_chroma=sao_chroma, boff=boff, toff=toff,
        cbo=cbo, cro=cro, width=width, height=height, cs=cs)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert len(np.unique(qp4.numpy())) > 1      # per-CTB QPs


# ------------------------------------------------------------ coverage

@pytest.mark.parametrize("over,named", [
    (dict(aq_mode=1), None),
    (dict(aq_mode=3, cutree=1), None),
    (dict(weightp=True), None),
    (dict(intra_nxn=True), None),
    (dict(intra_tu_depth=1), None),
    (dict(refs=2), "refs > 1"),
    (dict(intra_period=1, aq_mode=1), None),
    (dict(preset="medium", intra_period=1), None),
    (dict(preset="medium", intra_period=1, aq_mode=1), None),
    (dict(preset="slower"), None),
    (dict(intra_period=1, aq_mode=1, tune="screen"), None),
])
def test_unsupported_names(over, named):
    """`unsupported()` names neither AQ, CU-tree and weighted prediction nor
    NxN and the intra TU split (inter streams, and all-intra streams with
    AQ, where the reference turns both on), nor the slower preset (its P
    and B pictures take the host walk), and still names multiple
    references on the device engine."""
    from ks265codec_tpu_torch.encode.config import resolve_preset
    kw = dict(width=W, height=H, preset="fast", qp=27)
    kw.update(over)
    c = resolve_preset(EncoderConfig(**kw))
    missing = unsupported(c)
    assert not any(w in m for m in missing
                   for w in ("adaptive", "CU-tree", "weighted"))
    if named is None:
        assert missing == []
    else:
        assert any(named in m for m in missing)
