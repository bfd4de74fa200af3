"""AppEncoder-compatible CLI front-end.

Flag surface mirrors the reference appencoder (SURVEY.md 2.5: -i -b -o -wdt
-hgt -fr -frms plus RC/GOP/tools/diagnostics flags; run-captured help), and
the per-frame "poc slice bits psnr qp" stat rows + summary line match the
reference's run-verified output format (SURVEY.md 5.1/5.5) so existing
tooling that parses them keeps working.

A copy of ks265codec_tpu/cli/app_encoder.py on the port's HevcEncoder,
with one addition: `-device` (default: the CUDA card; `-device cpu` runs
the plain PyTorch versions on the CPU). Configurations the port does not
cover yet raise NotImplementedError naming what is missing. The flag
defaults (`-preset medium -latency offline -bframes 7 -iper 64 -rc 0
-qp 26`) run: hierarchical GOP-8 B pictures with CU-tree, weighted
prediction and the NxN decision tier on the IDR. At the presets
ultrafast to slow `-latency livestreaming` encodes GOP-4, `-latency
zerolatency -iper 0` low-delay P; `-iper 1` encodes all-intra at any
preset and tune; the default `-rdoq 1` runs RDOQ; `-aq 1..3` (adaptive
quantisation, cu_qp_delta) runs in every one of these structures.
`-preset slower`, `veryslow` and `placebo` at `-rc 0` run in every
latency mode: their P and B pictures take the sequential host walk
(partitions, AMP at placebo, the inter TU split, several L0 references
with `-ref`), whose streams `app_decoder -device cpu` decodes.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..encode.config import (LATENCIES, PRESETS, EncoderConfig,
                             parse_config_string)
from ..encode.encoder import HevcEncoder
from ..utils.md5 import frame_md5
from ..utils.yuv import YUVFrame, frame_size_bytes


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="app_encoder", description="ks265codec_tpu encoder",
        epilog="Presets ultrafast to slow run on the device inter engine; "
               "slower, veryslow and placebo (-rc 0) run their P and B "
               "pictures through the host walk (partitions, the inter TU "
               "split, -ref > 1); decode those streams with app_decoder "
               "-device cpu.",
        add_help=True)
    p.add_argument("-i", dest="input", required=True, help="input YUV (I420)")
    p.add_argument("-b", dest="bitstream", required=True, help="output .265")
    p.add_argument("-o", dest="recon", default=None, help="recon YUV out")
    p.add_argument("-wdt", dest="width", type=int, required=True)
    p.add_argument("-hgt", dest="height", type=int, required=True)
    p.add_argument("-fr", dest="frame_rate", type=float, default=30.0)
    p.add_argument("-frms", dest="frames", type=int, default=0)
    p.add_argument("-threads", type=int, default=0)
    p.add_argument("-preset", default="medium", choices=PRESETS)
    p.add_argument("-tune", default="default")
    p.add_argument("-latency", default="offline", choices=LATENCIES)
    p.add_argument("-profileid", type=int, default=1)
    # rate control
    p.add_argument("-rc", type=int, default=0)
    p.add_argument("-br", dest="bitrate_kbps", type=int, default=0)
    p.add_argument("-qp", type=int, default=26)
    p.add_argument("-crf", type=float, default=23.0)
    p.add_argument("-vbv-maxrate", dest="vbv_maxrate_kbps", type=int, default=0)
    p.add_argument("-vbv-bufsize", dest="vbv_bufsize_kbits", type=int, default=0)
    p.add_argument("-qpmin", type=int, default=0)
    p.add_argument("-qpmax", type=int, default=51)
    p.add_argument("-frameskip", type=int, default=0)
    p.add_argument("-pass", dest="pass_num", type=int, default=0)
    # GOP
    p.add_argument("-iper", dest="intra_period", type=int, default=64)
    p.add_argument("-imin", dest="intra_min", type=int, default=0)
    p.add_argument("-bframes", type=int, default=7)
    p.add_argument("-lookahead", type=int, default=40)
    p.add_argument("-tlayer", dest="temporal_layers", type=int, default=3)
    p.add_argument("-hbk", dest="headers_before_keyframe", type=int, default=1)
    # tools
    p.add_argument("-me", type=int, default=1)
    p.add_argument("-subme", type=int, default=1)
    p.add_argument("-merange", type=int, default=64)
    p.add_argument("-ref", dest="refs", type=int, default=1)
    p.add_argument("-intertu", dest="inter_tu_depth", type=int, default=0)
    p.add_argument("-ts", dest="transform_skip", type=int, default=0)
    p.add_argument("-part", dest="partitions", type=int, default=0)
    p.add_argument("-df", dest="deblock", type=int, default=1)
    p.add_argument("-sao", type=int, default=1)
    p.add_argument("-sis", dest="strong_intra_smoothing", type=int, default=1)
    p.add_argument("-rdoq", type=int, default=1)
    p.add_argument("-do64", type=int, default=1)
    p.add_argument("-slices", type=int, default=1)
    p.add_argument("-wpp", type=int, default=1)
    p.add_argument("-fpp", type=int, default=1)
    p.add_argument("-aq", dest="aq_mode", type=int, default=0)
    # diagnostics
    p.add_argument("-psnr", type=int, default=1)
    p.add_argument("-ssim", type=int, default=0)
    p.add_argument("-md5", dest="md5", type=int, default=0)
    p.add_argument("-log", dest="log_level", type=int, default=1)
    p.add_argument("-opts", default="", help="k=v:k=v config string")
    p.add_argument("-c", dest="config_file", default=None,
                   help="config file: 'key = value' lines (# comments); "
                        "keys are EncoderConfig fields; -opts wins")
    p.add_argument("-v", action="store_true", dest="version")
    p.add_argument("-device", default=None,
                   help="torch device to run on (default: the CUDA card)")
    return p


def read_config_file(path: str) -> str:
    """-c FILE -> a k=v:k=v opts string (HM-style 'Key : value' or
    'key = value' lines, '#' comments). Bad keys/values surface as the
    same BAD_NAME/BAD_VALUE errors the -opts parser raises."""
    pairs = []
    with open(path) as f:
        for ln in f:
            ln = ln.split("#", 1)[0].strip()
            if not ln:
                continue
            for sep in ("=", ":"):
                if sep in ln:
                    k, v = ln.split(sep, 1)
                    pairs.append(f"{k.strip()}={v.strip()}")
                    break
            else:
                raise ValueError(f"BAD_NAME: {ln}")
    return ":".join(pairs)


def cfg_from_args(a) -> EncoderConfig:
    cfg = EncoderConfig(
        width=a.width, height=a.height, frame_rate=a.frame_rate,
        preset=a.preset, latency=a.latency, rc=a.rc, qp=a.qp, crf=a.crf,
        bitrate_kbps=a.bitrate_kbps, vbv_maxrate_kbps=a.vbv_maxrate_kbps,
        vbv_bufsize_kbits=a.vbv_bufsize_kbits, qp_min=a.qpmin, qp_max=a.qpmax,
        intra_period=a.intra_period, bframes=a.bframes, lookahead=a.lookahead,
        temporal_layers=a.temporal_layers,
        headers_before_keyframe=bool(a.headers_before_keyframe),
        me=a.me, subme=a.subme, merange=a.merange, refs=a.refs,
        inter_tu_depth=a.inter_tu_depth, transform_skip=bool(a.transform_skip),
        partitions=a.partitions, deblock=bool(a.deblock), sao=a.sao,
        strong_intra_smoothing=bool(a.strong_intra_smoothing),
        rdoq=bool(a.rdoq), do64=bool(a.do64), wpp=bool(a.wpp),
        slices=a.slices,
        fpp=bool(a.fpp), aq_mode=a.aq_mode, threads=a.threads,
        psnr=a.psnr, ssim=a.ssim, md5=bool(a.md5), log_level=a.log_level,
        pass_num=a.pass_num,
    )
    if a.config_file:
        # precedence: flag defaults < -c file < -opts
        parse_config_string(cfg, read_config_file(a.config_file))
    if a.opts:
        parse_config_string(cfg, a.opts)
    return cfg


def read_frames(path: str, w: int, h: int, limit: int):
    fsz = frame_size_bytes(w, h)
    with open(path, "rb") as f:
        i = 0
        while limit <= 0 or i < limit:
            buf = f.read(fsz)
            if len(buf) < fsz:
                return
            y = np.frombuffer(buf[:w * h], np.uint8).reshape(h, w)
            u = np.frombuffer(buf[w * h:w * h + w * h // 4],
                              np.uint8).reshape(h // 2, w // 2)
            v = np.frombuffer(buf[w * h + w * h // 4:],
                              np.uint8).reshape(h // 2, w // 2)
            yield YUVFrame(y, u, v, poc=i)
            i += 1


def main(argv=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if "-seqlist" in argv:
        # multi-sequence batch mode (AppEncCfg::prepareToTestMoreSeq
        # analog, run-verified "QY265Test: Sequence Idx:" banner): each
        # line of the list file holds extra CLI args layered over the
        # base command; one process sweeps all sequences.
        i = argv.index("-seqlist")
        listfile = argv[i + 1]
        base = argv[:i] + argv[i + 2:]
        rc = 0
        with open(listfile) as f:
            lines = [ln.split() for ln in f
                     if ln.strip() and not ln.strip().startswith("#")]
        for k, extra in enumerate(lines):
            print(f"QY265Test: Sequence Idx: {k}")
            try:
                rc |= main(base + extra)
            except SystemExit:
                # a bad per-sequence arg must not abort the sweep
                rc |= 1
        return rc
    a = build_parser().parse_args(argv)
    if a.version:
        print("ks265codec_tpu encoder v0.1")
        return 0
    cfg = cfg_from_args(a)
    enc = HevcEncoder(cfg, device=a.device)
    bs = open(a.bitstream, "wb")
    total_bits = 0
    psnrs = []
    recons = []
    n = 0
    t0 = time.time()

    def emit(efs):
        nonlocal total_bits, n
        for ef in efs:
            bs.write(ef.data)
            recons.append(ef)
            total_bits += ef.bits
            if ef.psnr:
                psnrs.append(ef.psnr)
                print(f"poc {ef.poc:4d} ( {ef.slice_type}-SLICE, QP {ef.qp} )"
                      f" {ef.bits:8d} bits [Y {ef.psnr[0]:.4f} dB  "
                      f"U {ef.psnr[1]:.4f} dB  V {ef.psnr[2]:.4f} dB]")
            else:
                print(f"poc {ef.poc:4d} ( {ef.slice_type}-SLICE, QP {ef.qp} )"
                      f" {ef.bits:8d} bits")
            if a.md5:
                print("  MD5 " + ",".join(frame_md5(ef.recon)))
            n += 1

    for frame in read_frames(a.input, a.width, a.height, a.frames):
        emit(enc.encode_frame(frame))
    emit(enc.flush())
    dt = time.time() - t0
    bs.close()
    if a.recon:
        recons.sort(key=lambda e: e.display_idx)
        with open(a.recon, "wb") as rec:
            for ef in recons:
                rec.write(ef.recon.tobytes())
    if n:
        kbps = total_bits * cfg.frame_rate / max(n, 1) / 1000.0
        line = f"Total Frames: {n}, pure encoding time {dt:.3f} sec, {n / dt:.2f} fps"
        print(line)
        if psnrs:
            m = np.mean(np.array(psnrs), axis=0)
            print(f"bitrate, psnr: {kbps:.2f} kbps, "
                  f"[Y {m[0]:.4f} dB U {m[1]:.4f} dB V {m[2]:.4f} dB]")
        print("H265 encoder passed!!!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
