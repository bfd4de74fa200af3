"""The low-delay P encode end to end on the CPU: a 6-frame 128x96 IPPP clip
(ultrafast, zerolatency, fixed QP 30, SAO off) through ks265codec_tpu's
HevcEncoder, once, with its device functions wrapped to record their
inputs and outputs; the port's plain versions must equal them on those
inputs (K12 lookahead, K13 motion search, K15 inter decision and merge-snap
SADs, K17 inter coding), its MC (K14) must equal the reference's
`mc_planes`, and the port's HevcEncoder(device="cpu") must write the same
bytes and the same reconstructions. Half the clip uncovers fresh content,
so that P pictures hold intra CUs and the seeded intra scan runs. Also:
the configurations outside the port's envelope raise NotImplementedError
naming what is missing, and a failure inside the engine raises."""

import numpy as np
import pytest
import torch

import ks265codec_tpu.ops.interdecide as jid
import ks265codec_tpu.ops.intercode as jic
import ks265codec_tpu.ops.lookahead as jla
import ks265codec_tpu.ops.me2 as jme
from ks265codec_tpu.encode.config import EncoderConfig as JaxConfig
from ks265codec_tpu.encode.encoder import HevcEncoder as JaxEncoder
from ks265codec_tpu.ops.mc import mc_planes
from ks265codec_tpu.utils.yuv import YUVFrame as JaxFrame
from ks265codec_tpu_torch.encode.config import EncoderConfig
from ks265codec_tpu_torch.encode.encoder import HevcEncoder
from ks265codec_tpu_torch.ops import intercode as tic
from ks265codec_tpu_torch.ops import interdecide as tid
from ks265codec_tpu_torch.ops import lookahead as tla
from ks265codec_tpu_torch.ops import me2 as tme
from ks265codec_tpu_torch.ops.mc import mc_planes_plain
from ks265codec_tpu_torch.ops.wavefront import NFIELDS, LevelSchedule
from ks265codec_tpu_torch.utils.yuv import YUVFrame
from _torch_shared import release_after_module  # noqa: F401

W, H, N = 128, 96, 6
CFG = dict(width=W, height=H, preset="ultrafast", latency="zerolatency",
           rc=0, qp=30, intra_period=0, frame_rate=30, sao=0)


def synth(w, h, n, seed=11):
    """Moving content (tests/test_inter_engine.py::synth with newobj): from
    the second half on, fresh noise in the top-left third forces intra CUs
    inside P pictures."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        y = (120 + 55 * np.sin((xx + 5 * t) / 29.0)
             + 35 * np.cos((yy - 3 * t) / 23.0))
        y[(yy - h // 2) ** 2 + (xx - w // 3 - 7 * t) ** 2
          < (h // 5) ** 2] = 215
        if t >= n // 2:
            rng2 = np.random.RandomState(100 + t)
            y[: h // 3, : w // 3] = rng2.randint(0, 255, (h // 3, w // 3))
        y = np.clip(y + rng.randn(h, w) * 2.5, 0, 255).astype(np.uint8)
        u = np.clip(128 + 27 * np.sin((xx[::2, ::2] + 3 * t) / 37.0),
                    0, 255).astype(np.uint8)
        v = np.clip(128 + 27 * np.cos((yy[::2, ::2] - 2 * t) / 41.0),
                    0, 255).astype(np.uint8)
        out.append((y, u, v))
    return out


def _np(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_np(a) for a in x)
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return np.asarray(x) if hasattr(x, "shape") else x


@pytest.fixture(scope="module")
def ref():
    """One reference encode, recording its device functions' I/O."""
    rec = {k: [] for k in ("la_batch", "la_first", "me", "decide", "snap",
                           "code")}
    targets = [(jla, "frame_features_batch", "la_batch"),
               (jla, "frame_features_first", "la_first"),
               (jme, "me_fused_jit", "me"),
               (jid, "decide_tiers_fused_jit", "decide"),
               (jid, "snap_sads_fused_jit", "snap"),
               (jic, "code_inter_frame_jit", "code")]
    saved = [(m, name, getattr(m, name)) for m, name, _ in targets]

    def wrap(fn, key):
        def g(*a, **k):
            out = fn(*a, **k)
            rec[key].append((_np(a), k, _np(out)))
            return out
        return g

    for (m, name, key), (_, _, fn) in zip(targets, saved):
        setattr(m, name, wrap(fn, key))
    planes = synth(W, H, N)
    try:
        enc = JaxEncoder(JaxConfig(**CFG))
        efs = []
        for i, p in enumerate(planes):
            efs += enc.encode_frame(JaxFrame(*p, poc=i))
        efs += enc.flush()
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
    return dict(rec=rec, planes=planes, bs=b"".join(e.data for e in efs),
                types=[e.slice_type for e in efs],
                recons=[(e.recon.y, e.recon.u, e.recon.v) for e in efs])


@pytest.fixture(scope="module")
def port(ref):
    enc = HevcEncoder(EncoderConfig(**CFG), device="cpu")
    efs = []
    for i, p in enumerate(ref["planes"]):
        efs += enc.encode_frame(YUVFrame(*p, poc=i))
    efs += enc.flush()
    return efs


def T(a):
    return torch.from_numpy(np.array(a))


def test_lookahead_plain_matches_reference(ref):
    calls = ref["rec"]["la_batch"] + ref["rec"]["la_first"]
    assert ref["rec"]["la_batch"] and ref["rec"]["la_first"]
    for a, k, out in ref["rec"]["la_batch"]:
        got = tla.frame_features_batch(T(a[0]), T(a[1]), *a[2:], **k)
        assert np.array_equal(got.numpy(), out)
    for a, k, out in ref["rec"]["la_first"]:
        got = tla.frame_features_first(T(a[0]), *a[1:], **k)
        assert np.array_equal(got.numpy()[0], out)
    assert len(calls) >= N


def test_downsample_plain_matches_reference():
    import jax.numpy as jnp
    y = np.random.RandomState(0).randint(0, 256, (64, 96)).astype(np.uint8)
    want = np.asarray(jla.downsample2x(jnp.asarray(y)))
    assert np.array_equal(tla.downsample2x(T(y)[None])[0].numpy(), want)


def test_motion_search_plain_matches_reference(ref):
    assert ref["rec"]["me"]
    for a, k, out in ref["rec"]["me"]:
        src, stack, lam = a
        mv, cost = tme.me_fused_plain(T(src), T(stack), float(lam),
                                      k["sr_q"], k["pic_w"], k["pic_h"])
        assert np.array_equal(mv.numpy(), out[0])
        assert np.array_equal(cost.numpy(), out[1])


def _unpack_tiers(buf, meta, sizes):
    off, out = 0, []

    def take(dt, nel):
        nonlocal off
        a = np.frombuffer(buf, dt, nel, off)
        off += nel * np.dtype(dt).itemsize
        return a

    for (n, zero_only), B in zip(meta, sizes):
        if zero_only:
            out.append((take(np.uint8, B).astype(bool),
                        take(np.uint8, B).astype(np.int32)))
        else:
            out.append((take(np.uint8, B).astype(np.int8),
                        take(np.uint8, B).astype(np.int64),
                        take(np.float32, B)))
    assert off == buf.size
    return out


def test_inter_decide_plain_matches_reference(ref):
    assert ref["rec"]["decide"]
    for a, k, buf in ref["rec"]["decide"]:
        src, refs, targs = a[:3], a[3:6], a[6]
        tiers = [{f: T(v) for f, v in zip(tid.TIER_FIELDS, t)}
                 for t in targs]
        got = tid.decide_tiers(tuple(T(p) for p in src),
                               tuple(T(p) for p in refs), tiers, k["meta"],
                               k["pic_w"], k["pic_h"])
        want = _unpack_tiers(buf, k["meta"], [len(t[0]) for t in targs])
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                assert np.array_equal(x.numpy().astype(y.dtype), y)


def test_snap_sads_plain_matches_reference(ref):
    assert ref["rec"]["snap"]
    for a, k, buf in ref["rec"]["snap"]:
        got = tid.snap_sads(T(a[0]), T(a[1]),
                            [tuple(T(x) for x in t) for t in a[2]],
                            k["meta"], k["pic_w"], k["pic_h"])
        flat = np.concatenate([g.numpy().reshape(-1) for g in got])
        assert np.array_equal(flat, np.frombuffer(buf, np.float32))


def sched_from_segs(segs) -> LevelSchedule:
    """The reference's segmented per-size level packs as one schedule."""
    recs, l0 = [], 0
    for seg in segs:
        ls = seg[0][0].shape[0]
        for si, pack in enumerate(seg):
            x, y, mode, cmode, qp, qpcb, qpcr, al, ac, at, valid = pack
            for li, k in zip(*np.nonzero(valid)):
                recs.append((l0 + li, [x[li, k], y[li, k], 8 << si,
                                       mode[li, k], cmode[li, k], qp[li, k],
                                       qpcb[li, k], qpcr[li, k],
                                       int(al[li, k]), int(ac[li, k]),
                                       int(at[li, k]), 1]))
        l0 += ls
    recs.sort(key=lambda r: r[0])
    lv = np.array([r[0] for r in recs])
    rows = np.array([r[1] for r in recs], np.int64).astype(np.int32)
    levels, out, base = [], [], 0
    for level in sorted(set(lv.tolist())):
        m = rows[lv == level]
        levels.append((base, len(m)))
        out.append(m)
        base += len(m)
    return LevelSchedule(np.concatenate(out) if out
                         else np.zeros((0, NFIELDS), np.int32), levels, 1)


def test_inter_code_plain_matches_reference(ref):
    """K17 on the recorded inputs: deblocked planes and levels equal; every
    recorded picture codes intra CUs (the seeded scan ran)."""
    assert ref["rec"]["code"]
    for a, k, out in ref["rec"]["code"]:
        (sy, scb, scr, ry, rcb, rcr, slot0, mv0, _, _, _, _, packs, cu_lam,
         segs, _, e2v, e2h, etbv, etbh, emvv, emvh, qp4, _, _) = a
        assert segs is not None
        planes, coef, sao = tic.code_inter_frame(
            tuple(T(p) for p in (sy, scb, scr)),
            tuple(T(p) for p in (ry, rcb, rcr)), T(slot0), T(mv0),
            {key: tuple(T(v) for v in val) for key, val in packs.items()},
            T(cu_lam), sched_from_segs(segs),
            tuple(T(x) for x in (e2v, e2h, etbv, etbh, emvv, emvh)), T(qp4),
            k["n_cu"], k["h8"], k["w8"], k["pic_w"], k["pic_h"], k["boff"],
            k["toff"], k["cbo"], k["cro"], k["deblock"], k["strong"])
        for got, want in zip(planes + coef, out[1:7]):
            assert np.array_equal(got.numpy(), want)
        assert sao is None


@pytest.mark.parametrize("bi", [False, True], ids=["uni", "bi"])
def test_mc_plain_matches_reference(bi):
    rng = np.random.RandomState(7 + bi)
    R, ph, pw, pic_w, pic_h = 2, 64, 64, 56, 48
    refs = [rng.randint(0, 256, (R, ph >> s, pw >> s)).astype(np.uint8)
            for s in (0, 1, 1)]
    h8, w8 = ph // 8, pw // 8
    slot0 = rng.randint(-1 if bi else 0, R, (h8, w8)).astype(np.int32)
    slot1 = rng.randint(-1, R, (h8, w8)).astype(np.int32)
    slot0[(slot0 < 0) & (slot1 < 0)] = 0
    mv0 = rng.randint(-80, 80, (h8, w8, 2)).astype(np.int32)
    mv1 = rng.randint(-80, 80, (h8, w8, 2)).astype(np.int32)
    want = mc_planes(*refs, slot0, mv0, *((slot1, mv1) if bi else ()),
                     pic_w=pic_w, pic_h=pic_h)
    if not bi:
        slot1 = np.full_like(slot0, -1)
    got = mc_planes_plain(*(T(r) for r in refs), T(slot0.reshape(-1)),
                          T(mv0.reshape(-1, 2)), T(slot1.reshape(-1)),
                          T(mv1.reshape(-1, 2)), bi, h8, w8, pic_w, pic_h)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def test_stream_byte_identical(ref, port):
    got = b"".join(e.data for e in port)
    assert got == ref["bs"]


def test_recons_equal_reference(ref, port):
    assert len(port) == len(ref["recons"]) == N
    for e, want in zip(port, ref["recons"]):
        for got, w in zip((e.recon.y, e.recon.u, e.recon.v), want):
            assert np.array_equal(got, w)


def test_stream_holds_p_pictures_with_intra_cus(ref, port):
    types = [e.slice_type for e in port]
    assert types == ref["types"]
    assert types[0] == "I" and types.count("P") >= 3
    segs = [a[14] for a, _, _ in ref["rec"]["code"]]
    assert len(segs) == types.count("P")
    assert any(s is not None for s in segs)


@pytest.mark.parametrize("over,what", [
    (dict(noise_reduction=1), "noise reduction"),
    (dict(pcm=True), "PCM"),
    (dict(refs=2), "refs > 1"),
    (dict(tiles="2x1"), "tiles with inter coding"),
    (dict(preset="slower", tiles="2x1"), "tiles with inter coding"),
    (dict(rc=1, bitrate_kbps=500), "rate control"),
])
def test_outside_the_envelope_raises(over, what):
    with pytest.raises(NotImplementedError, match=what):
        HevcEncoder(EncoderConfig(**dict(CFG, **over)), device="cpu")


def test_engine_failure_raises_without_fallback(monkeypatch):
    """A fault in a device function of the engine reaches the caller: no
    sequential host walk runs instead."""
    from ks265codec_tpu_torch.ops import interdecide

    def boom(*a, **k):
        raise RuntimeError("decision kernel failed")

    monkeypatch.setattr(interdecide, "decide_tiers", boom)
    enc = HevcEncoder(EncoderConfig(**dict(CFG, width=64, height=64)),
                      device="cpu")
    planes = synth(64, 64, 2)
    enc.encode_frame(YUVFrame(*planes[0], poc=0))
    with pytest.raises(RuntimeError, match="decision kernel failed"):
        enc.encode_frame(YUVFrame(*planes[1], poc=1))
