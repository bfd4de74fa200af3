"""AppDecoder-compatible CLI front-end (SURVEY.md 2.5: -b -o -frms -threads
-md5 -log flags; per-frame "POC n MD5 y,u,v" lines match the reference
decoder's run-verified output format).

A copy of ks265codec_tpu/cli/app_decoder.py on the port's HevcDecoder,
with one addition: `-device` (default: the CUDA card; `-device cpu` runs
the plain PyTorch versions on the CPU)."""

from __future__ import annotations

import argparse
import sys
import time

from ..decode.decoder import HevcDecoder
from ..utils.md5 import frame_md5


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="app_decoder",
                                description="ks265codec_tpu decoder")
    p.add_argument("-b", dest="bitstream", required=True)
    p.add_argument("-o", dest="output", default=None)
    p.add_argument("-frms", dest="frames", type=int, default=0)
    p.add_argument("-threads", type=int, default=0)
    p.add_argument("-md5", dest="md5", type=int, default=0)
    p.add_argument("-log", dest="log_level", type=int, default=1)
    p.add_argument("-p", dest="skip", type=int, default=0,
                   help="decode-skip mode (headers only)")
    p.add_argument("-v", action="store_true", dest="version")
    p.add_argument("-device", default=None,
                   help="torch device to run on (default: the CUDA card)")
    return p


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    if a.version:
        print("ks265codec_tpu decoder v0.1")
        return 0
    data = open(a.bitstream, "rb").read()
    dec = HevcDecoder(threads=a.threads, skip_mode=bool(a.skip),
                      device=a.device)
    out = open(a.output, "wb") if a.output else None
    t0 = time.time()
    frames = dec.decode_all(data)
    dt = time.time() - t0
    for i, f in enumerate(frames):
        if a.frames and i >= a.frames:
            break
        if out:
            out.write(f.tobytes())
        if a.md5:
            print(f"POC {f.poc} MD5 " + ",".join(frame_md5(f)))
    if out:
        out.close()
    n = len(frames)
    if n:
        print(f"Total Frames: {n}, decoding time {dt:.3f} sec, "
              f"{n / dt:.2f} fps")
    print("QianYi H265 decoder passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
