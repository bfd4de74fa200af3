"""The all-intra encode end to end: 4 frames at 192x128 (ultrafast, QP 27,
SAO off; tests/test_torch_sao.py covers SAO on) through the port's
HevcEncoder on the CPU must give the same bitstream as ks265codec_tpu's
HevcEncoder, byte for byte, with and without tiles; the JAX decoder must
decode the port's stream to frames whose md5 equals the port's
reconstruction."""

import numpy as np
import pytest

from ks265codec_tpu.decode.decoder import HevcDecoder
from ks265codec_tpu.encode.config import EncoderConfig as JaxConfig
from ks265codec_tpu.encode.encoder import encode_sequence as jax_encode
from ks265codec_tpu.utils.md5 import frame_md5
from ks265codec_tpu.utils.yuv import YUVFrame as JaxFrame
from ks265codec_tpu_torch.encode.config import EncoderConfig
from ks265codec_tpu_torch.encode.encoder import HevcEncoder, encode_sequence
from ks265codec_tpu_torch.utils.yuv import YUVFrame
from _torch_shared import release_after_module  # noqa: F401

W, H, N = 192, 128, 4


def _planes():
    rng = np.random.RandomState(5)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for t in range(N):
        y = 128 + 60 * np.sin((xx + 3 * t) / 23.0) \
            + 40 * np.cos((yy - 2 * t) / 17.0)
        y[30:70, 40 + 6 * t:80 + 6 * t] = 220 - 3 * t
        y = np.clip(y + rng.randn(H, W) * 3, 0, 255).astype(np.uint8)
        u = np.clip(128 + 30 * np.sin((xx[::2, ::2] + t) / 31.0), 0, 255) \
            .astype(np.uint8)
        v = np.clip(128 + 30 * np.cos((yy[::2, ::2] - t) / 29.0), 0, 255) \
            .astype(np.uint8)
        out.append((y, u, v))
    return out


def _cfg(tiles):
    return dict(width=W, height=H, preset="ultrafast", qp=27,
                intra_period=1, sao=0, tiles=tiles)


@pytest.fixture(scope="module", params=["", "2x2"], ids=["no_tiles",
                                                         "tiles_2x2"])
def streams(request):
    planes = _planes()
    kw = _cfg(request.param)
    ref, _ = jax_encode([JaxFrame(*p, poc=i) for i, p in enumerate(planes)],
                        JaxConfig(**kw))
    got, recons = encode_sequence(
        [YUVFrame(*p, poc=i) for i, p in enumerate(planes)],
        EncoderConfig(**kw), device="cpu")
    return ref, got, recons, planes


def test_stream_byte_identical(streams):
    ref, got, _, _ = streams
    assert len(got) > 0
    assert got == ref


def test_reference_decoder_matches_port_recon(streams):
    _, got, recons, planes = streams
    frames = HevcDecoder().decode_all(got)
    assert len(frames) == N
    for dec, rec in zip(frames, recons):
        assert frame_md5(dec) == frame_md5(rec)
    # and the recon is a faithful picture of the source
    mse = np.mean([(r.y.astype(float) - p[0]) ** 2
                   for r, p in zip(recons, planes)])
    assert 10 * np.log10(255 ** 2 / mse) > 30


def test_batches_and_pipelining_do_not_change_bytes():
    """Five frames pushed one by one (a batch of 4, then the last frame
    dispatched before the first batch is written) give the bytes of five
    separate one-frame encodes."""
    planes = _planes()
    planes = planes + planes[:1]
    frames = [YUVFrame(*p, poc=i) for i, p in enumerate(planes)]
    enc = HevcEncoder(EncoderConfig(**_cfg("")), device="cpu")
    out = []
    for f in frames:
        out += enc.encode_frame(f)
    assert out == []                 # waiting for a full batch
    out += enc.flush()
    assert [e.display_idx for e in out] == list(range(len(frames)))
    single = b"".join(encode_sequence([f], EncoderConfig(**_cfg("")),
                                      device="cpu")[0] for f in frames)
    assert b"".join(e.data for e in out) == single


@pytest.mark.parametrize("overrides,missing", [
    (dict(intra_period=32), "inter coding"),
    (dict(rc=1, bitrate_kbps=500), "rate control"),
    (dict(ssim=1), "SSIM"),
    (dict(pass_num=1), "two-pass"),
    (dict(pcm=True), "PCM"),
    (dict(slices=2, tiles=""), "multiple slices"),
    (dict(fpp=False), "per-frame path"),
    (dict(refs=2, intra_period=0, latency="zerolatency", tiles=""),
     "refs > 1"),
    (dict(preset="medium", intra_period=32), "tiles with inter coding"),
])
def test_unported_configurations_raise(overrides, missing):
    kw = _cfg("2x2")
    kw.update(overrides)
    with pytest.raises(NotImplementedError, match=missing):
        HevcEncoder(EncoderConfig(**kw), device="cpu")


def test_default_device_is_cuda():
    """Without a device argument the encoder runs on CUDA, and raises where
    there is none instead of moving to the CPU."""
    import torch
    if torch.cuda.is_available():
        assert HevcEncoder(EncoderConfig(**_cfg(""))).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            HevcEncoder(EncoderConfig(**_cfg("")))


def test_decide_effort_above_one_is_effort_one():
    """decide_effort 2 is accepted and codes as effort 1, as in the
    reference (any nonzero effort takes the effort-1 tier); the field
    stays as configured."""
    frames = [YUVFrame(*p, poc=i) for i, p in enumerate(_planes()[:2])]
    streams = []
    for effort in (1, 2):
        kw = dict(_cfg(""), preset="veryfast", decide_effort=effort)
        enc = HevcEncoder(EncoderConfig(**kw), device="cpu")
        assert enc.cfg.decide_effort == effort
        streams.append(encode_sequence(frames, EncoderConfig(**kw),
                                       device="cpu")[0])
    assert streams[0] == streams[1]
