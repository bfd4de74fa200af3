"""SAO in P pictures (K16 in K17) and the P-picture decode (K18) on the CPU,
exact against ks265codec_tpu.

K16's plain version against the jitted `sao_decide_core` on seeded random
and tie-heavy statistics at tiers 1, 3 and 4, on the 720p CTB grid (12 x
20) at QP 30 and on 2 x 2 at QP 33. Then ONE reference encode of the
6-frame 128x96 IPPP clip of tests/test_torch_inter.py with the preset's
SAO (ultrafast: tier 1), recording `code_inter_frame_jit`, and ONE
reference decode of its stream, recording `recon_inter_filter_jit`
(inputs copied at the call: on the CPU the reference uploads the
decoder's parse planes without a copy, and the pool recycles them
later). The port's plain K17 must give the recorded planes, levels and
SAO parameters, its plain K18 the recorded planes on every P picture
(some hold intra CUs), its HevcEncoder(device="cpu") the reference's
bytes and reconstructions, and its HevcDecoder(device="cpu") every P
picture through the fast path with the reference encoder's
reconstruction md5 for every frame. A second, unrecorded reference
encode of the clip in two slices a picture takes the decoder's
partial-picture P branch."""

import types

import jax
import numpy as np
import pytest
import torch

import ks265codec_tpu.ops.intercode as jic
import ks265codec_tpu.ops.wavefront as jwf
from ks265codec_tpu.decode.decoder import HevcDecoder as JaxDecoder
from ks265codec_tpu.encode.config import EncoderConfig as JaxConfig
from ks265codec_tpu.encode.encoder import HevcEncoder as JaxEncoder
from ks265codec_tpu.encode.inter_engine import _unpack_row
from ks265codec_tpu.ops.saodecide import sao_decide_core
from ks265codec_tpu.utils.md5 import frame_md5 as jax_md5
from ks265codec_tpu.utils.yuv import YUVFrame as JaxFrame
from ks265codec_tpu_torch.decode.decoder import HevcDecoder
from ks265codec_tpu_torch.encode.config import EncoderConfig
from ks265codec_tpu_torch.encode.encoder import HevcEncoder
from ks265codec_tpu_torch.ops import intercode as tic
from ks265codec_tpu_torch.ops import saodecide as tsd
from ks265codec_tpu_torch.ops import wavefront as twf
from ks265codec_tpu_torch.utils.md5 import frame_md5
from ks265codec_tpu_torch.utils.yuv import YUVFrame
from test_torch_inter import sched_from_segs, synth
from _torch_shared import release_after_module  # noqa: F401

W, H, N = 128, 96, 6
CFG = dict(width=W, height=H, preset="ultrafast", latency="zerolatency",
           rc=0, qp=30, intra_period=0, frame_rate=30)


def T(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------- K16

def _stats(rng, ncty, nctx, ncl, ties: bool):
    """Per plane (eo_cnt, eo_err, bo_cnt, bo_err) int32 of the sizes a
    64x64 CTB gives; with ties, few small values, EO classes 0 and 1
    equal and a band pattern repeating every 4 bands."""
    out = []
    for c in range(3):
        n = 4096 if c == 0 else 1024
        if ties:
            cnt = rng.randint(0, 4, (ncl, 5, ncty, nctx)) \
                * rng.randint(0, 3, (1, 1, ncty, nctx))
            err = cnt * rng.randint(-3, 4, cnt.shape) \
                + rng.randint(-1, 2, cnt.shape) * (cnt > 0)
            cnt[1], err[1] = cnt[0], err[0]
            bcnt = np.tile(rng.randint(0, 3, (4, ncty, nctx)), (8, 1, 1))
            berr = bcnt * rng.randint(-2, 3, bcnt.shape)
        else:
            cnt = rng.randint(0, n // 4, (ncl, 5, ncty, nctx))
            err = (cnt * rng.uniform(-9, 9, cnt.shape)).astype(np.int64)
            bcnt = rng.randint(0, n // 16, (32, ncty, nctx)) \
                * (rng.rand(32, ncty, nctx) < 0.4)
            berr = (bcnt * rng.uniform(-9, 9, bcnt.shape)).astype(np.int64)
        out.append(tuple(a.astype(np.int32) for a in (cnt, err, bcnt, berr)))
    return out


_JIT_DECIDE = jax.jit(sao_decide_core, static_argnums=(1, 2))


@pytest.mark.parametrize("grid,qp", [((12, 20), 30), ((2, 2), 33)],
                         ids=["720p", "2x2"])
@pytest.mark.parametrize("tier", [1, 3, 4])
def test_sao_decide_plain_matches_reference(tier, grid, qp):
    """One QP a grid: the reference's jit has qp and tier static, and each
    pair is a compile of its own."""
    import jax.numpy as jnp
    ncl = 2 if tier <= 1 else 4
    for seed in range(4):
        rng = np.random.RandomState(100 * tier + seed)
        st = _stats(rng, *grid, ncl, ties=seed % 2 == 1)
        if tier < 3:
            # below tier 3 the reference reads luma only
            jst = [(jnp.asarray(st[0][0]), jnp.asarray(st[0][1]), None,
                    None)] * 3
            tst = [(T(st[0][0]), T(st[0][1]), None, None)]
        else:
            jst = [tuple(jnp.asarray(a) for a in s) for s in st]
            tst = [tuple(T(a) for a in s) for s in st]
        want = _JIT_DECIDE(jst, qp, tier)
        got = tsd.sao_decide_plain(tst, qp, tier)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------ the IPPP stream

def _copied(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_copied(a) for a in x)
    if isinstance(x, dict):
        return {k: _copied(v) for k, v in x.items()}
    return np.array(x) if hasattr(x, "shape") else x


@pytest.fixture(scope="module")
def ref():
    """One reference encode and one reference decode, recording K17 and
    K18 with their inputs copied at the call."""
    rec = {"code": [], "k18": []}
    targets = [(jic, "code_inter_frame_jit", "code"),
               (jwf, "recon_inter_filter_jit", "k18")]
    saved = [(m, name, getattr(m, name)) for m, name, _ in targets]

    def wrap(fn, key):
        def g(*a, **k):
            args = _copied(a)
            out = fn(*a, **k)
            rec[key].append((args, k, _copied(out)))
            return out
        return g

    for (m, name, key), (_, _, fn) in zip(targets, saved):
        setattr(m, name, wrap(fn, key))
    def encode(**extra):
        enc = JaxEncoder(JaxConfig(**CFG, **extra))
        efs = []
        for i, p in enumerate(planes):
            efs += enc.encode_frame(JaxFrame(*p, poc=i))
        return efs + enc.flush()

    planes = synth(W, H, N)
    try:
        efs = encode()
        bs = b"".join(e.data for e in efs)
        decoded = JaxDecoder().decode_all(bs)
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
    # the same clip in two slices a picture (one CTB row each), unrecorded:
    # its functions are those of the first encode, compiled already
    efs2 = encode(slices=2)
    return dict(rec=rec, planes=planes, bs=bs,
                types=[e.slice_type for e in efs],
                md5=[jax_md5(e.recon) for e in efs],
                dec_md5=[jax_md5(f) for f in decoded],
                recons=[(e.recon.y, e.recon.u, e.recon.v) for e in efs],
                bs2=b"".join(e.data for e in efs2),
                types2=[e.slice_type for e in efs2],
                md5_2=[jax_md5(e.recon) for e in efs2])


@pytest.fixture(scope="module")
def port(ref):
    enc = HevcEncoder(EncoderConfig(**CFG), device="cpu")
    efs = []
    for i, p in enumerate(ref["planes"]):
        efs += enc.encode_frame(YUVFrame(*p, poc=i))
    efs += enc.flush()
    return efs


def test_sao_ippp_stream_byte_identical(ref, port):
    """The preset's SAO is on, and the port writes the reference's bytes."""
    assert HevcEncoder(EncoderConfig(**CFG), device="cpu").sps.sao_enabled
    assert b"".join(e.data for e in port) == ref["bs"]
    assert ref["types"].count("P") >= 3


def test_sao_ippp_recons_equal_reference(ref, port):
    assert len(port) == N
    for e, want in zip(port, ref["recons"]):
        for got, w in zip((e.recon.y, e.recon.u, e.recon.v), want):
            assert np.array_equal(got, w)


def test_inter_code_sao_matches_reference(ref):
    """K17 with SAO on the recorded inputs: the post-SAO planes, the
    levels and the four SAO parameter arrays of the packed row."""
    assert ref["rec"]["code"]
    for a, k, out in ref["rec"]["code"]:
        assert k["sao"] and k["sao_tier"] == 1
        (sy, scb, scr, ry, rcb, rcr, slot0, mv0, _, _, _, _, packs, cu_lam,
         segs, _, e2v, e2h, etbv, etbh, emvv, emvh, qp4, _, _) = a
        planes, coef, sao = tic.code_inter_frame(
            tuple(T(p) for p in (sy, scb, scr)),
            tuple(T(p) for p in (ry, rcb, rcr)), T(slot0), T(mv0),
            {key: tuple(T(v) for v in val) for key, val in packs.items()},
            T(cu_lam), sched_from_segs(segs) if segs is not None else None,
            tuple(T(x) for x in (e2v, e2h, etbv, etbh, emvv, emvh)), T(qp4),
            k["n_cu"], k["h8"], k["w8"], k["pic_w"], k["pic_h"], k["boff"],
            k["toff"], k["cbo"], k["cro"], k["deblock"], k["strong"],
            sao=(k["sao_tier"], k["slice_qp"], k["cs"]))
        for got, want in zip(planes + coef, out[1:7]):
            assert np.array_equal(got.numpy(), want)
        ph, pw = sy.shape
        sps = types.SimpleNamespace(sao_enabled=1, ctb_size=k["cs"])
        _, want_sao = _unpack_row(out[0], ph, pw, sps, k["esc_cap"], out[4:7])
        for got, want in zip(sao, want_sao):
            assert np.array_equal(got.numpy(), want)


def test_inter_decode_plain_matches_reference(ref):
    """K18's plain version on every recorded P picture of the reference
    decode; at least one holds intra CUs (the seeded K11 scan runs)."""
    calls = ref["rec"]["k18"]
    assert len(calls) == ref["types"].count("P")
    assert any(a[17] is not None for a, _, _ in calls)
    for a, k, out in calls:
        (ry, rcb, rcr, slot0, mv0, slot1, _, w0, w1, cy, ccb, ccr, log2m8,
         qp4, qcb, qcr, inter_pix, segs, bs_v, bs_h, sp) = a
        assert not k["has_l1"] and w0 is None and w1 is None
        assert (slot1 < 0).all()
        got = twf.recon_inter_filter(
            tuple(T(r).to(torch.uint8) for r in (ry, rcb, rcr)), T(slot0),
            T(mv0), tuple(T(c) for c in (cy, ccb, ccr)), T(log2m8), T(qp4),
            T(qcb), T(qcr), T(inter_pix[::8, ::8]),
            sched_from_segs(segs) if segs is not None else None, T(bs_v),
            T(bs_h), tuple(T(x) for x in sp) if k["sao"] else None,
            k["strong"], k["deblock"], k["sao_chroma"], k["boff"],
            k["toff"], k["cbo"], k["cro"], k["width"], k["height"], k["cs"])
        for g, w in zip(got, out):
            assert np.array_equal(g.numpy(), w)


def test_decoder_decodes_the_sao_ippp_stream(ref):
    """The port's decoder on the CPU: every picture through the fast path
    (the P pictures through K18), md5 equal to the reference encoder's
    recon and to the reference decoder's output."""
    dec = HevcDecoder(device="cpu")
    frames = dec.decode_all(ref["bs"])
    assert len(frames) == N and dec.fast_pictures == N
    got = [frame_md5(f) for f in frames]
    assert got == ref["md5"] == ref["dec_md5"]


def test_decoder_decodes_two_slice_p_pictures(ref, monkeypatch):
    """A P picture of two slices: the first slice's K18 runs without the
    in-loop filters and lands in the host planes, the second takes the
    scalar walk, and the host filters finish the picture; every frame
    gives the reference encoder's recon md5."""
    finals = []
    orig = HevcDecoder._materialize_fast_inter

    def spy(self, fs, sps, pps, hdr, ref_lists, final):
        finals.append(final)
        return orig(self, fs, sps, pps, hdr, ref_lists, final)

    monkeypatch.setattr(HevcDecoder, "_materialize_fast_inter", spy)
    dec = HevcDecoder(device="cpu")
    frames = dec.decode_all(ref["bs2"])
    assert finals == [False] * ref["types2"].count("P") and finals
    assert dec.fast_pictures == 0
    assert [frame_md5(f) for f in frames] == ref["md5_2"]
