"""The port's CLIs on the CPU (`-device cpu`): app_encoder writes the bytes
of `encode_sequence` for the same configuration and prints the md5 of
each reconstruction; app_decoder's `-md5 1` lines give the same md5s. No
JAX run: the port's encoder is held against the reference elsewhere."""

import numpy as np

from ks265codec_tpu_torch.cli import app_decoder, app_encoder
from ks265codec_tpu_torch.encode.encoder import HevcEncoder, encode_sequence
from ks265codec_tpu_torch.utils.md5 import frame_md5
from ks265codec_tpu_torch.utils.yuv import YUVFrame

W, H, N = 96, 64, 3


def _frames():
    rng = np.random.RandomState(21)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for t in range(N):
        y = np.clip(120 + 60 * np.sin((xx + 4 * t) / 9.0)
                    + rng.randn(H, W) * 4, 0, 255).astype(np.uint8)
        u = np.clip(128 + rng.randn(H // 2, W // 2) * 9, 0, 255) \
            .astype(np.uint8)
        v = np.clip(110 + 20 * np.cos(yy[::2, ::2] / 7.0), 0, 255) \
            .astype(np.uint8)
        out.append(YUVFrame(y, u, v, poc=t))
    return out


def test_cli_round_trip_on_cpu(tmp_path, capsys):
    frames = _frames()
    yuv = tmp_path / "in.yuv"
    yuv.write_bytes(b"".join(f.tobytes() for f in frames))
    bs = tmp_path / "out.265"
    argv = ["-i", str(yuv), "-wdt", str(W), "-hgt", str(H), "-frms", str(N),
            "-b", str(bs), "-preset", "ultrafast", "-qp", "30", "-iper", "1",
            "-rdoq", "0", "-md5", "1", "-device", "cpu"]
    rc = app_encoder.main(argv)
    out = capsys.readouterr().out
    assert rc == 0
    # the CLI's flag defaults (frame rate, WPP, PSNR, ...) form its config
    cfg = app_encoder.cfg_from_args(app_encoder.build_parser()
                                    .parse_args(argv))
    assert (cfg.width, cfg.height, cfg.qp, cfg.intra_period) == (W, H, 30, 1)
    want, recons = encode_sequence(frames, cfg, device="cpu")
    assert bs.read_bytes() == want
    md5s = [tuple(ln.split()[1].split(",")) for ln in out.splitlines()
            if ln.startswith("  MD5 ")]
    assert md5s == [frame_md5(r) for r in recons]
    assert "H265 encoder passed!!!" in out

    rc = app_decoder.main(["-b", str(bs), "-md5", "1", "-device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    lines = [ln for ln in out.splitlines() if ln.startswith("POC ")]
    # every all-intra picture is an IDR, so every POC is 0
    assert lines == ["POC 0 MD5 " + ",".join(frame_md5(r)) for r in recons]
    assert "QianYi H265 decoder passed" in out


def test_cli_ippp_round_trip_on_cpu(tmp_path, capsys):
    """The low-delay P configuration with the preset's SAO (BASELINE.json
    config 2's flags): app_encoder writes encode_sequence's bytes and
    app_decoder's md5 lines are the reconstructions'."""
    frames = _frames()
    yuv = tmp_path / "in.yuv"
    yuv.write_bytes(b"".join(f.tobytes() for f in frames))
    bs = tmp_path / "ippp.265"
    argv = ["-i", str(yuv), "-wdt", str(W), "-hgt", str(H), "-frms", str(N),
            "-b", str(bs), "-preset", "ultrafast", "-latency", "zerolatency",
            "-iper", "0", "-qp", "30", "-rdoq", "0", "-fr", "30",
            "-device", "cpu"]
    assert app_encoder.main(argv) == 0
    cfg = app_encoder.cfg_from_args(app_encoder.build_parser()
                                    .parse_args(argv))
    assert cfg.sao == 1 and cfg.intra_period == 0
    want, recons = encode_sequence(frames, cfg, device="cpu")
    assert bs.read_bytes() == want
    capsys.readouterr()
    rc = app_decoder.main(["-b", str(bs), "-md5", "1", "-device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    lines = [ln.split()[3] for ln in out.splitlines() if ln.startswith("POC ")]
    assert lines == [",".join(frame_md5(r)) for r in recons]


def test_cli_fast_preset_default_rdoq_on_cpu(tmp_path):
    """`-preset fast -iper 1` with the flag defaults (`-rdoq 1`): RDOQ,
    sign hiding and the effort-1 decision run, and app_encoder writes
    HevcEncoder's bytes for its configuration."""
    frames = _frames()
    yuv = tmp_path / "in.yuv"
    yuv.write_bytes(b"".join(f.tobytes() for f in frames))
    bs = tmp_path / "fast.265"
    argv = ["-i", str(yuv), "-wdt", str(W), "-hgt", str(H), "-frms", str(N),
            "-b", str(bs), "-preset", "fast", "-qp", "30", "-iper", "1",
            "-device", "cpu"]
    assert app_encoder.main(argv) == 0
    def cfg():
        return app_encoder.cfg_from_args(app_encoder.build_parser()
                                         .parse_args(argv))

    run = HevcEncoder(cfg(), device="cpu").cfg
    assert run.rdoq and run.sign_bit_hiding and run.decide_effort == 1
    want, _ = encode_sequence(frames, cfg(), device="cpu")
    assert bs.read_bytes() == want
