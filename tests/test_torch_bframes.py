"""B pictures at fixed QP on the CPU, exact against ks265codec_tpu.

ONE reference encode of a 10-frame 128x96 clip at the `fast` preset,
offline latency, QP 30 and the default 7 B frames (the IDR, one
hierarchical GOP-8 coded 8,4,2,1,3,6,5,7 and a plain-P tail), with
`me_fused_jit`, `decide_tiers_fused_jit`, `snap_sads_fused_jit` and
`code_inter_frame_jit` wrapped to record their inputs (copied at the call)
and outputs; then, with the same compiled functions, a 6-frame
`livestreaming` stream of the same preset and shape (GOP-4 and a P tail).
The port's plain K13 with the bi cost, K15 with list 1, K17 with list 1
and K14 bi must equal the reference on those inputs; the port's
HevcEncoder(device="cpu") must write both streams byte for byte with the
same reconstructions; its HevcDecoder(device="cpu") must take every
picture through the fast paths and give the reference encoder's md5s;
and its plain K18 on a B picture of that decode must equal the JAX
`recon_inter_filter_jit` on the same inputs. The clip moves slowly
enough for b-adapt to keep the GOP-8, and fresh noise in one frame puts
intra CUs into B pictures. Under pytest-xdist the reference encodes
and the port's encodes run once per test run, each in the first worker
free to take it, and reach the others through files in the run's
temporary directory (tests/_torch_shared.py): every worker holding one
of these tests would otherwise repeat the port's encodes, and wait idle
while another computes the reference's."""

import types

import numpy as np
import pytest
import torch

import ks265codec_tpu.ops.interdecide as jid
import ks265codec_tpu.ops.intercode as jic
import ks265codec_tpu.ops.me2 as jme
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
from ks265codec_tpu_torch.encode.config import EncoderConfig
from ks265codec_tpu_torch.encode.encoder import HevcEncoder
from ks265codec_tpu_torch.ops import intercode as tic
from ks265codec_tpu_torch.ops import interdecide as tid
from ks265codec_tpu_torch.ops import me2 as tme
from ks265codec_tpu_torch.ops import wavefront as twf
from ks265codec_tpu_torch.ops.mc import mc_planes_plain
from ks265codec_tpu_torch.utils.md5 import frame_md5
from ks265codec_tpu_torch.utils.yuv import YUVFrame
from _torch_shared import release_after_module, shared  # noqa: F401
from test_torch_inter import _unpack_tiers, sched_from_segs

W, H = 128, 96
STREAMS = {"gop8": ("offline", 10, "IPBBBBBBBP"),
           "gop4": ("livestreaming", 6, "IPBBBP")}


def cfg(latency):
    return dict(width=W, height=H, preset="fast", latency=latency, rc=0,
                qp=30, frame_rate=30)


def synth(w, h, n, seed=11):
    """Slow motion (2 samples a frame of the background, 3 of a disc), so
    the pyramid's distant references still predict; frame 6 carries fresh
    noise in its top-left corner, which B pictures code as intra CUs."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        y = (120 + 55 * np.sin((xx + 2 * t) / 29.0)
             + 35 * np.cos((yy - t) / 23.0))
        y[(yy - h // 2) ** 2 + (xx - w // 3 - 3 * t) ** 2
          < (h // 5) ** 2] = 215
        if t == 6:
            fresh = np.random.RandomState(100 + t)
            y[: h // 4, : w // 4] = fresh.randint(0, 255, (h // 4, w // 4))
        y = np.clip(y + rng.randn(h, w) * 2.0, 0, 255).astype(np.uint8)
        u = np.clip(128 + 27 * np.sin((xx[::2, ::2] + 3 * t) / 37.0),
                    0, 255).astype(np.uint8)
        v = np.clip(128 + 27 * np.cos((yy[::2, ::2] - 2 * t) / 41.0),
                    0, 255).astype(np.uint8)
        out.append((y, u, v))
    return out


def _copied(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_copied(a) for a in x)
    if isinstance(x, dict):
        return {k: _copied(v) for k, v in x.items()}
    return np.array(x) if hasattr(x, "shape") else x


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread while this module runs: its plain versions are
    many small operations, and under pytest-xdist every worker's default
    of one thread per core oversubscribes the machine, where the threads'
    barriers then take most of the time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference encodes (`_reference`) and the port's (`_port`), each
    once per run."""
    return shared(tmp_path_factory, {"torch_bframes_ref": _reference,
                                     "torch_bframes_port": _port})


@pytest.fixture(scope="module")
def ref(both):
    return both["torch_bframes_ref"]


@pytest.fixture(scope="module")
def port(both):
    return both["torch_bframes_port"]


def _reference():
    """The two reference encodes; the GOP-8 one records its device
    functions' I/O."""
    rec = {k: [] for k in ("me", "decide", "snap", "code")}
    recording = [True]
    targets = [(jme, "me_fused_jit", "me"),
               (jid, "decide_tiers_fused_jit", "decide"),
               (jid, "snap_sads_fused_jit", "snap"),
               (jic, "code_inter_frame_jit", "code")]
    saved = [(m, name, getattr(m, name)) for m, name, _ in targets]

    def wrap(fn, key):
        def g(*a, **k):
            args = _copied(a) if recording[0] else None
            out = fn(*a, **k)
            if recording[0]:
                rec[key].append((args, k, _copied(out)))
            return out
        return g

    for (m, name, key), (_, _, fn) in zip(targets, saved):
        setattr(m, name, wrap(fn, key))
    streams = {}
    try:
        for name, (latency, n, _) in STREAMS.items():
            planes = synth(W, H, n)
            enc = JaxEncoder(JaxConfig(**cfg(latency)))
            efs = []
            for i, p in enumerate(planes):
                efs += enc.encode_frame(JaxFrame(*p, poc=i))
            efs += enc.flush()
            recording[0] = False
            disp = sorted(efs, key=lambda e: e.display_idx)
            streams[name] = dict(
                planes=planes, bs=b"".join(e.data for e in efs),
                types="".join(e.slice_type for e in efs),
                recons=[(e.recon.y, e.recon.u, e.recon.v) for e in efs],
                md5=[jax_md5(e.recon) for e in disp],
                reorder=enc.sps.num_reorder_pics[-1])
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
    return dict(rec=rec, **streams)


def _port():
    """The port's encodes of both streams on the CPU: per stream the
    declared reorder depth, the coded slice types, the bytes and the
    reconstructions in coding order."""
    out = {}
    for name, (latency, n, _) in STREAMS.items():
        enc = HevcEncoder(EncoderConfig(**cfg(latency)), device="cpu")
        efs = []
        for i, p in enumerate(synth(W, H, n)):
            efs += enc.encode_frame(YUVFrame(*p, poc=i))
        efs += enc.flush()
        out[name] = dict(
            reorder=enc.sps.num_reorder_pics[-1],
            types="".join(e.slice_type for e in efs),
            bs=b"".join(e.data for e in efs),
            recons=[(e.recon.y, e.recon.u, e.recon.v) for e in efs])
    return out


@pytest.fixture(scope="module")
def decoded(ref):
    """The port's CPU decode of the GOP-8 stream, recording K18's inputs
    (copied) and, for each picture with intra CUs, the reference's
    intra segments of the same FrameState."""
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
        frames = dec.decode_all(ref["gop8"]["bs"])
    finally:
        twf.recon_inter_filter, tif._intra_sched = orig_k18, orig_sched
    return dict(dec=dec, frames=frames, calls=calls, segs=segs)


@pytest.mark.parametrize("name", list(STREAMS))
def test_coded_slice_types(ref, port, name):
    """The GOP-8 stream codes I P B B B B B B B P and the livestreaming
    one I P B B B P, in the reference and the port alike."""
    want = STREAMS[name][2]
    assert ref[name]["types"] == want
    assert port[name]["types"] == want


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_byte_identical(ref, port, name):
    assert port[name]["reorder"] == ref[name]["reorder"] \
        == {"gop8": 3, "gop4": 2}[name]
    assert port[name]["bs"] == ref[name]["bs"]


@pytest.mark.parametrize("name", list(STREAMS))
def test_recons_equal_reference(ref, port, name):
    recons = port[name]["recons"]
    assert len(recons) == len(ref[name]["recons"]) == STREAMS[name][1]
    for got, want in zip(recons, ref[name]["recons"]):
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def test_gop8_decodes_on_the_fast_paths(ref, decoded):
    """Every picture through the fast paths (the B pictures through K18
    with both lists), in display order, with the reference encoder's md5
    for each."""
    dec, frames = decoded["dec"], decoded["frames"]
    assert [f.poc for f in frames] == list(range(10))
    assert dec.fast_pictures == 10
    assert [frame_md5(f) for f in frames] == ref["gop8"]["md5"]
    assert sum(bool(k["has_l1"]) for _, k, _ in decoded["calls"]) == 7


def test_gop4_decodes_on_the_fast_paths(ref):
    dec = HevcDecoder(device="cpu")
    frames = dec.decode_all(ref["gop4"]["bs"])
    assert [f.poc for f in frames] == list(range(6))
    assert dec.fast_pictures == 6
    assert [frame_md5(f) for f in frames] == ref["gop4"]["md5"]


def test_bi_motion_search_plain_matches_reference(ref):
    """K13 with the bi cost: motion, costs, directions and merged costs of
    every B picture equal; some blocks choose bi-prediction."""
    calls = [c for c in ref["rec"]["me"] if c[1]["bi"]]
    assert len(calls) == 7
    dirs = []
    for a, k, out in calls:
        src, stack, lam = a
        got = tme.me_fused_plain(T(src), T(stack), float(lam), k["sr_q"],
                                 k["pic_w"], k["pic_h"], bi=True)
        assert len(got) == len(out) == 4
        for g, w in zip(got, out):
            assert np.array_equal(g.numpy(), w)
        dirs.append(out[2])
    assert all((np.concatenate([d.ravel() for d in dirs]) == v).any()
               for v in (0, 1, 2))


def test_inter_decide_plain_matches_reference(ref):
    """K15 with list 1 on every recorded decision call of the B pictures
    (both iterations) and of the P pictures."""
    calls = ref["rec"]["decide"]
    assert sum(k["has_l1"] for _, k, _ in calls) >= 14
    for a, k, buf in calls:
        src, refs, targs = a[:3], a[3:6], a[6]
        tiers = [{f: T(v) for f, v in zip(tid.TIER_FIELDS, t)}
                 for t in targs]
        got = tid.decide_tiers(tuple(T(p) for p in src),
                               tuple(T(p) for p in refs), tiers, k["meta"],
                               k["pic_w"], k["pic_h"], has_l1=k["has_l1"])
        want = _unpack_tiers(buf, k["meta"], [len(t[0]) for t in targs])
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                assert np.array_equal(x.numpy().astype(y.dtype), y)


def test_snap_sads_plain_matches_reference(ref):
    calls = ref["rec"]["snap"]
    assert any(k["has_l1"] for _, k, _ in calls)
    for a, k, buf in calls:
        got = tid.snap_sads(T(a[0]), T(a[1]),
                            [tuple(T(x) for x in t) for t in a[2]],
                            k["meta"], k["pic_w"], k["pic_h"],
                            has_l1=k["has_l1"])
        flat = np.concatenate([g.numpy().reshape(-1) for g in got])
        assert np.array_equal(flat, np.frombuffer(buf, np.float32))


def test_inter_code_plain_matches_reference(ref):
    """K17 with list 1 (SAO tier 3, sign hiding) on every recorded
    picture: post-SAO planes, levels and SAO parameters equal; B pictures
    with intra CUs are among them."""
    calls = ref["rec"]["code"]
    assert sum(k["has_l1"] for _, k, _ in calls) == 7
    assert any(k["has_l1"] and a[14] is not None for a, k, _ in calls)
    for a, k, out in calls:
        assert k["sao"] and k["sao_tier"] == 3 and k["sbh"]
        (sy, scb, scr, ry, rcb, rcr, slot0, mv0, slot1, mv1, w0, w1, packs,
         cu_lam, segs, _, e2v, e2h, etbv, etbh, emvv, emvh, qp4, _, _) = a
        assert w0 is None and w1 is None
        planes, coef, sao = tic.code_inter_frame(
            tuple(T(p) for p in (sy, scb, scr)),
            tuple(T(p) for p in (ry, rcb, rcr)), T(slot0), T(mv0),
            {key: tuple(T(v) for v in val) for key, val in packs.items()},
            T(cu_lam), sched_from_segs(segs) if segs is not None else None,
            tuple(T(x) for x in (e2v, e2h, etbv, etbh, emvv, emvh)), T(qp4),
            k["n_cu"], k["h8"], k["w8"], k["pic_w"], k["pic_h"], k["boff"],
            k["toff"], k["cbo"], k["cro"], k["deblock"], k["strong"],
            sao=(k["sao_tier"], k["slice_qp"], k["cs"]), sbh=k["sbh"],
            slot1=T(slot1), mv1=T(mv1), has_l1=k["has_l1"])
        for got, want in zip(planes + coef, out[1:7]):
            assert np.array_equal(got.numpy(), want)
        sps = types.SimpleNamespace(sao_enabled=1, ctb_size=k["cs"])
        _, want_sao = _unpack_row(out[0], *sy.shape, sps, k["esc_cap"],
                                  out[4:7])
        for got, want in zip(sao, want_sao):
            assert np.array_equal(got.numpy(), want)


def test_mc_bi_plain_matches_reference(ref):
    """K14 with both lists against the JAX `mc_planes` on the final motion
    of a recorded B picture holding list-0-only, list-1-only and bi cells."""
    def kinds(a):
        s0, s1 = a[6], a[8]
        return ((s0 >= 0) & (s1 < 0)).sum(), ((s0 < 0) & (s1 >= 0)).sum(), \
            ((s0 >= 0) & (s1 >= 0)).sum()

    calls = [(a, k) for a, k, _ in ref["rec"]["code"]
             if k["has_l1"] and min(kinds(a)) > 0]
    assert calls
    a, k = calls[0]
    ry, rcb, rcr, slot0, mv0, slot1, mv1 = a[3:10]
    h8, w8 = k["h8"], k["w8"]
    want = mc_planes(ry, rcb, rcr, slot0.reshape(h8, w8),
                     mv0.reshape(h8, w8, 2), slot1.reshape(h8, w8),
                     mv1.reshape(h8, w8, 2), pic_w=k["pic_w"],
                     pic_h=k["pic_h"])
    got = mc_planes_plain(T(ry), T(rcb), T(rcr), T(slot0), T(mv0),
                          T(slot1), T(mv1), True, h8, w8, k["pic_w"],
                          k["pic_h"])
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def test_inter_decode_bi_plain_matches_reference(decoded):
    """K18's plain version on the decoded B picture with the most intra
    CUs against the JAX `recon_inter_filter_jit` on the same inputs."""
    import jax.numpy as jnp
    picks = [(int((np.asarray(a[9].recs)[:, twf.VALID] == 1).sum()), i)
             for i, (a, k, _) in enumerate(decoded["calls"])
             if k["has_l1"] and a[9] is not None]
    assert picks
    _, i = max(picks)
    a, k, got = decoded["calls"][i]
    segs = decoded["segs"][i]
    assert segs is not None and a[12] is not None       # intra CUs, SAO
    (refs, slot0, mv0, coefs, log2m8, qp4, qcb, qcr, inter8, _, bs_v, bs_h,
     sp, strong, deblock, sao_chroma, boff, toff, cbo, cro, width, height,
     cs) = a
    inter_pix = np.repeat(np.repeat(inter8.numpy(), 8, 0), 8, 1)
    J = lambda t: jnp.asarray(t.numpy())
    want = jwf.recon_inter_filter_jit(
        *(jnp.asarray(r.numpy().astype(np.int32)) for r in refs), J(slot0), J(mv0), J(k["slot1"]), J(k["mv1"]),
        None, None, *(J(c) for c in coefs), J(log2m8), J(qp4), J(qcb),
        J(qcr), jnp.asarray(inter_pix), segs, J(bs_v), J(bs_h),
        tuple(J(x) for x in sp), has_l1=True, strong=strong,
        deblock=deblock, sao=True, sao_chroma=sao_chroma, boff=boff,
        toff=toff, cbo=cbo, cro=cro, width=width, height=height, cs=cs)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
