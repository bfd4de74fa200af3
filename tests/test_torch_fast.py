"""The `fast` preset on the CPU, exact against ks265codec_tpu: RDOQ-lite and
sign-bit hiding (K2) in the intra scan and sign hiding in the inter coding
pass, with the effort-1 decision tier (K5).

Two reference encodes at 128x96 set the file's time: an all-intra `fast`
encode of 2 frames at QP 27 (the bytes must be identical, and the JAX
decoder's md5s must equal the port's reconstruction; the same 2 frames at
`medium` and `placebo`, SAO tier 4 with the NxN and intra TU split options
that the all-intra device path leaves to the host path, reuse its
compiled functions and must give identical bytes too), and the configuration of bench.py's
inter leg (`fast`, zerolatency, QP 30, `intra_period=0`) on 5 frames of
the clip of tests/test_torch_inter.py, with `code_inter_frame_jit` (K17)
wrapped to record its inputs and outputs: the port's HevcEncoder
(device="cpu") must write the same bytes and reconstructions, a P picture
must hold intra CUs, the port's plain K17 with sign hiding must give the
recorded planes, levels and SAO parameters, and the port's
HevcDecoder(device="cpu") must decode every picture through its fast
paths to the reference's md5s. Also, without a reference run: which
configurations the port covers now, and the PPS flag."""

import types

import numpy as np
import pytest
import torch

import ks265codec_tpu.ops.intercode as jic
from ks265codec_tpu.decode.decoder import HevcDecoder as JaxDecoder
from ks265codec_tpu.encode.config import EncoderConfig as JaxConfig
from ks265codec_tpu.encode.encoder import HevcEncoder as JaxEncoder
from ks265codec_tpu.encode.inter_engine import _unpack_row
from ks265codec_tpu.utils.md5 import frame_md5 as jax_md5
from ks265codec_tpu.utils.yuv import YUVFrame as JaxFrame
from ks265codec_tpu_torch.decode.decoder import HevcDecoder
from ks265codec_tpu_torch.encode.config import (PRESETS, EncoderConfig,
                                                resolve_preset)
from ks265codec_tpu_torch.encode.encoder import HevcEncoder, unsupported
from ks265codec_tpu_torch.ops import intercode as tic
from ks265codec_tpu_torch.utils.md5 import frame_md5
from ks265codec_tpu_torch.utils.yuv import YUVFrame
from test_torch_inter import sched_from_segs, synth
from _torch_shared import release_after_module  # noqa: F401

W, H = 128, 96
INTRA = dict(width=W, height=H, preset="fast", qp=27, intra_period=1)
INTER = dict(width=W, height=H, preset="fast", latency="zerolatency",
             qp=30, intra_period=0, frame_rate=30)
N_INTRA, N_INTER = 2, 5
SLOW_PRESETS = ("medium", "placebo")


def T(a):
    return torch.from_numpy(np.array(a))


def _copied(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_copied(a) for a in x)
    if isinstance(x, dict):
        return {k: _copied(v) for k, v in x.items()}
    return np.array(x) if hasattr(x, "shape") else x


def _encode(enc, planes, frame_cls):
    efs = []
    for i, p in enumerate(planes):
        efs += enc.encode_frame(frame_cls(*p, poc=i))
    return efs + enc.flush()


# ------------------------------------------------------------ all-intra

@pytest.fixture(scope="module")
def intra():
    planes = synth(W, H, N_INTRA, seed=23)
    ref = _encode(JaxEncoder(JaxConfig(**INTRA)), planes, JaxFrame)
    got = _encode(HevcEncoder(EncoderConfig(**INTRA), device="cpu"), planes,
                  YUVFrame)
    slow = {}
    for preset in SLOW_PRESETS:
        cfg = dict(INTRA, preset=preset)
        slow[preset] = tuple(
            b"".join(e.data for e in _encode(enc, planes, cls))
            for enc, cls in ((JaxEncoder(JaxConfig(**cfg)), JaxFrame),
                             (HevcEncoder(EncoderConfig(**cfg), device="cpu"),
                              YUVFrame)))
    return b"".join(e.data for e in ref), got, slow


def test_fast_intra_stream_byte_identical(intra):
    ref, got, _ = intra
    assert b"".join(e.data for e in got) == ref


@pytest.mark.parametrize("preset", SLOW_PRESETS)
def test_slow_intra_preset_stream_byte_identical(intra, preset):
    ref, got = intra[2][preset]
    assert got == ref and ref != intra[0]


def test_fast_intra_reference_decoder_matches_port_recon(intra):
    ref, got, _ = intra
    frames = JaxDecoder().decode_all(b"".join(e.data for e in got))
    assert len(frames) == N_INTRA
    assert [jax_md5(f) for f in frames] == [frame_md5(e.recon) for e in got]


# ----------------------------------------------------- low-delay P, fast

@pytest.fixture(scope="module")
def inter():
    """One reference encode of the IPPP clip, recording K17 with its
    inputs copied at the call."""
    calls = []
    fn = jic.code_inter_frame_jit

    def spy(*a, **k):
        args = _copied(a)
        out = fn(*a, **k)
        calls.append((args, k, _copied(out)))
        return out

    planes = synth(W, H, N_INTER)
    jic.code_inter_frame_jit = spy
    try:
        ref = _encode(JaxEncoder(JaxConfig(**INTER)), planes, JaxFrame)
    finally:
        jic.code_inter_frame_jit = fn
    got = _encode(HevcEncoder(EncoderConfig(**INTER), device="cpu"), planes,
                  YUVFrame)
    return dict(calls=calls, bs=b"".join(e.data for e in ref),
                types=[e.slice_type for e in ref],
                md5=[jax_md5(e.recon) for e in ref],
                recons=[(e.recon.y, e.recon.u, e.recon.v) for e in ref],
                got=got)


def test_fast_ippp_stream_byte_identical(inter):
    assert b"".join(e.data for e in inter["got"]) == inter["bs"]
    assert inter["types"][0] == "I" and inter["types"].count("P") >= 3


def test_fast_ippp_recons_equal_reference(inter):
    assert len(inter["got"]) == N_INTER
    for e, want in zip(inter["got"], inter["recons"]):
        for got, w in zip((e.recon.y, e.recon.u, e.recon.v), want):
            assert np.array_equal(got, w)


def test_fast_ippp_p_pictures_hold_intra_cus(inter):
    calls = inter["calls"]
    assert len(calls) == inter["types"].count("P")
    assert all(k["sbh"] for _, k, _ in calls)
    assert any(a[14] is not None for a, _, _ in calls)


def test_fast_inter_code_plain_matches_reference(inter):
    """K17 with sign hiding (and the preset's SAO, tier 3) on the recorded
    inputs: the post-SAO planes, the levels and the SAO parameters."""
    for a, k, out in inter["calls"]:
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
            sao=(k["sao_tier"], k["slice_qp"], k["cs"]), sbh=k["sbh"])
        for got, want in zip(planes + coef, out[1:7]):
            assert np.array_equal(got.numpy(), want)
        ph, pw = sy.shape
        sps = types.SimpleNamespace(sao_enabled=1, ctb_size=k["cs"])
        _, want_sao = _unpack_row(out[0], ph, pw, sps, k["esc_cap"], out[4:7])
        for got, want in zip(sao, want_sao):
            assert np.array_equal(got.numpy(), want)


def test_fast_ippp_decoder_all_fast(inter):
    """The port's decoder on the CPU: every picture through the fast paths
    (sign hiding inferred in the parse), the reference's md5s."""
    dec = HevcDecoder(device="cpu")
    frames = dec.decode_all(inter["bs"])
    assert len(frames) == N_INTER and dec.fast_pictures == N_INTER
    assert [frame_md5(f) for f in frames] == inter["md5"]


# ------------------------------------------------------ the covered set

def test_bench_inter_configuration_is_covered():
    """bench.py's inter leg: 1280x720, fast, zerolatency, QP 30,
    intra_period 0, 30 fps; sign hiding is on in its PPS."""
    cfg = EncoderConfig(width=1280, height=720, preset="fast",
                        latency="zerolatency", qp=30, intra_period=0,
                        frame_rate=30)
    assert unsupported(resolve_preset(cfg)) == []
    enc = HevcEncoder(cfg, device="cpu")
    assert enc.pps.sign_data_hiding_enabled == 1
    assert enc.cfg.rdoq and enc.cfg.decide_effort == 1


@pytest.mark.parametrize("preset", PRESETS)
def test_every_all_intra_preset_is_covered(preset):
    cfg = EncoderConfig(width=W, height=H, preset=preset, intra_period=1)
    assert unsupported(resolve_preset(cfg)) == []
