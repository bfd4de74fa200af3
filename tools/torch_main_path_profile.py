"""Where the time of the port's main path goes, on one CUDA card.

Fourteen runs, each profiled the same way after a warm-up: the encode of the
chip_smoke.py main path (bench.py's configuration: 1280x720, ultrafast,
QP 27, all-intra, tiles 8x6, SAO from the preset, 32 synthetic frames),
the decode of the stream it writes, the low-delay P encode of
chip_smoke.py's inter path (BASELINE.json config 2: 1280x720, ultrafast,
zerolatency, QP 30, intra_period 0, SAO from the preset, 24 synthetic
frames: one IDR, then P pictures), the decode of that IPPP stream, and
bench.py's inter leg (the same with the fast preset: RDOQ and sign
hiding, the effort-1 decision, SAO tier 3), and chip_smoke.py's fast
all-intra encode (the main path's configuration with the fast preset, 16
frames), then chip_smoke.py's B path (1280x720, fast, offline, QP 27, the
default hierarchical GOP-8, 25 frames: one IDR, three GOP-8s) and the
decode of its stream, then chip_smoke.py's cu_qp_delta and weighted
prediction legs on its luma fade: the VOD encode (the B configuration
with CU-tree, aq_mode 2 and weightp, 17 frames), its decode, and the
live encode (bench.py's inter leg with aq_mode 1 and weightp, 16
frames), whose host stages add `enc.weightp` (the weight fit and its
luma fetch), `enc.effective_qp` (the host walk of the decoder's QPs),
`la.aq_offsets` and `la.cutree`, then chip_smoke.py's medium leg
(EncoderConfig's defaults on the 17 fade frames: the NxN tier on the
IDR) and its decode, then chip_smoke.py's `slower` leg (1280x720,
slower, offline, QP 27, 9 synthetic frames: its P and B pictures take the
host walk, whose stages are `enc.compute` (the walk: K5, K20, K21 and the
per-CU host decisions), `enc.deblock_host`, `enc.sao_stats` (K22),
`enc.sao_decide_host` and `enc.sao_apply_host`).
Each is run once plain for the fps, once with the stage trace on (host
wall time per stage: for the all-intra encode upload, decide, code,
deblock, SAO statistics, the host SAO decision, SAO apply, level fetch
and slice writing; for the decode the reconstruction, deblocking and SAO
of the fast path; for the P encode the inter engine's stages `inter.*`
and slice writing (B pictures too, with `la.features` the lookahead's
batched reads); for the P and B decodes the fast path's preparation, its
reconstruction `dec.inter_recon` (K14, the inter TUs' residual, K11),
`dec.deblock` and `dec.sao`), once under
torch.profiler for the device time of every kernel and the device's busy
share of the wall time, and once under cProfile for the host functions
that take the wall time (cProfile slows Python calls, so its times are
shares, not the plain run's). Each profiled run also sums the device time
of K5's passes (`pass_a_kernel`, `pass_b_kernel`, the NxN tier, the
split), K6 (`intra_level_kernel`) and K11's persistent
`intra_recon_persistent_kernel`, or says that none was recorded. Each
profiled session starts with a burst of small synchronised kernels,
left out of the sums: after the longer runs a session lost its first
device records (the fast all-intra batch's uploads and K5 launches).
Run from the repository root:

    python3 tools/torch_main_path_profile.py
"""

from __future__ import annotations

import cProfile
import io
import os
import pstats
import subprocess
import sys
import time
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (AQWP_LIVE, AQWP_VOD, MEDIUM, SLOWER,  # noqa: E402
                        SLOWER_FRAMES, fade_frames, synth_frames)
from ks265codec_tpu_torch.decode.decoder import HevcDecoder  # noqa: E402
from ks265codec_tpu_torch.encode.config import EncoderConfig  # noqa: E402
from ks265codec_tpu_torch.encode.encoder import HevcEncoder  # noqa: E402
from ks265codec_tpu_torch.utils import trace  # noqa: E402
from ks265codec_tpu_torch.utils.yuv import YUVFrame  # noqa: E402


def encode(frames, preset: str = "ultrafast"):
    enc = HevcEncoder(EncoderConfig(width=1280, height=720, preset=preset,
                                    qp=27, intra_period=1, tiles="8x6"))
    out = []
    for f in frames:
        out += enc.encode_frame(f)
    out += enc.flush()
    torch.cuda.synchronize()
    return out


def encode_ippp(frames, preset: str = "ultrafast"):
    enc = HevcEncoder(EncoderConfig(width=1280, height=720, preset=preset,
                                    latency="zerolatency", rc=0, qp=30,
                                    intra_period=0, frame_rate=30))
    out = []
    for f in frames:
        out += enc.encode_frame(f)
    out += enc.flush()
    torch.cuda.synchronize()
    return out


def encode_b(frames):
    enc = HevcEncoder(EncoderConfig(width=1280, height=720, preset="fast",
                                    latency="offline", rc=0, qp=27,
                                    frame_rate=30))
    out = []
    for f in frames:
        out += enc.encode_frame(f)
    out += enc.flush()
    torch.cuda.synchronize()
    return out


def encode_cfg(frames, cfg: dict):
    enc = HevcEncoder(EncoderConfig(**cfg))
    out = []
    for f in frames:
        out += enc.encode_frame(f)
    out += enc.flush()
    torch.cuda.synchronize()
    return out


def decode(stream):
    out = HevcDecoder().decode_all(stream)
    torch.cuda.synchronize()
    return out


# device kernel names (symbol substrings) of the redesigned K5 and K11 and
# of K6, summed per row under these labels in every profiled run
KERNEL_ROWS = (("K5 pass A", "pass_a_kernel"), ("K5 pass B", "pass_b_kernel"),
               ("K5 NxN tier", "nxn_"), ("K5 split", "split_kernel"),
               ("K6 intra scan", "intra_level_kernel"),
               ("K11 intra recon", "intra_recon_persistent_kernel"))


# After the longer profiled runs, a profiler session on this card lost the
# first device records of the next session: the fast all-intra batch's
# uploads and K5 launches (PR 5, PR 11). Each session therefore starts
# with a burst of small synchronised kernels whose records may be lost
# instead, and which the sums leave out by name.
ABSORB_NAMES: set = set()


def absorb() -> None:
    for _ in range(32):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()


def absorb_names() -> set:
    """The device record names of `absorb`'s kernels."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        absorb()
    return {ev.name for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA}


def profile(label: str, fn, n: int) -> None:
    """Plain, traced, torch.profiler and cProfile runs of fn() (which
    handles n frames); fn() has been called once to warm up."""
    t0 = time.perf_counter()
    fn()
    wall = time.perf_counter() - t0
    print(f"{label} plain run: {n} frames in {wall:.3f} s = "
          f"{n / wall:.3f} fps")

    trace.enabled = True
    trace.reset()
    t0 = time.perf_counter()
    fn()
    traced = time.perf_counter() - t0
    trace.enabled = False
    print(f"{label} traced run: {traced:.3f} s wall; host stage totals "
          "(s, count):")
    for line in trace.report().splitlines():
        print("  " + line)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        absorb()
        t0 = time.perf_counter()
        fn()
        prof_wall = time.perf_counter() - t0
    per_kernel = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.name not in ABSORB_NAMES):
            per_kernel[ev.name][0] += ev.device_time_total / 1e3   # ms
            per_kernel[ev.name][1] += 1
    busy = sum(v[0] for v in per_kernel.values())
    print(f"{label} profiled run: {prof_wall:.3f} s wall, device busy "
          f"{busy:.3f} ms ({100 * busy / 1e3 / prof_wall:.2f}% of wall; "
          "idle share is the rest); device time by kernel (ms, launches):")
    for name, (ms, k) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:10.3f}  {k:5d}  {name[:90]}")
    if not per_kernel:
        print("  no device events recorded: device time not measured")
    for row, key in KERNEL_ROWS:
        ms = sum(v[0] for k, v in per_kernel.items() if key in k)
        k = sum(v[1] for name, v in per_kernel.items() if key in name)
        print(f"  {row}: {ms:.3f} ms over {k} launches" if k else
              f"  {row}: no device events")

    prof_host = cProfile.Profile()
    prof_host.enable()
    fn()
    prof_host.disable()
    buf = io.StringIO()
    pstats.Stats(prof_host, stream=buf).sort_stats("tottime").print_stats(15)
    print(f"{label} cProfile run, top 15 host functions by own time:")
    print(buf.getvalue().split("\n", 4)[-1].rstrip())


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    ABSORB_NAMES.update(absorb_names())
    frames = [YUVFrame(y, u, v, poc=i)
              for i, (y, u, v) in enumerate(synth_frames(32))]
    stream = b"".join(e.data for e in encode(frames))   # warm-up + build
    profile("encode", lambda: encode(frames), len(frames))
    decode(stream)                                      # warm-up
    profile("decode", lambda: decode(stream), len(frames))
    ippp = frames[:24]
    encode_ippp(ippp[:4])                               # warm-up
    profile("P encode", lambda: encode_ippp(ippp), len(ippp))
    istream = b"".join(e.data for e in encode_ippp(ippp))
    decode(istream)                                     # warm-up
    profile("P decode", lambda: decode(istream), len(ippp))
    encode_ippp(ippp[:4], "fast")                       # warm-up
    profile("fast P encode", lambda: encode_ippp(ippp, "fast"), len(ippp))
    fast16 = frames[:16]
    encode(fast16, "fast")                              # warm-up
    profile("fast encode", lambda: encode(fast16, "fast"), len(fast16))
    bclip = frames[:25]
    encode_b(frames[:9])                                # warm-up
    profile("B encode", lambda: encode_b(bclip), len(bclip))
    bstream = b"".join(e.data for e in encode_b(bclip))
    decode(bstream)                                     # warm-up
    profile("B decode", lambda: decode(bstream), len(bclip))
    fade = fade_frames(frames, 17)
    encode_cfg(fade[:9], AQWP_VOD)                      # warm-up
    profile("AQ/WP VOD encode", lambda: encode_cfg(fade, AQWP_VOD),
            len(fade))
    vstream = b"".join(e.data for e in encode_cfg(fade, AQWP_VOD))
    decode(vstream)                                     # warm-up
    profile("AQ/WP VOD decode", lambda: decode(vstream), len(fade))
    encode_cfg(fade[:4], AQWP_LIVE)                     # warm-up
    profile("AQ/WP live encode", lambda: encode_cfg(fade[:16], AQWP_LIVE),
            16)
    encode_cfg(fade[:9], MEDIUM)                        # warm-up
    profile("medium encode", lambda: encode_cfg(fade, MEDIUM), len(fade))
    mstream = b"".join(e.data for e in encode_cfg(fade, MEDIUM))
    decode(mstream)                                     # warm-up
    profile("medium decode", lambda: decode(mstream), len(fade))
    slower = frames[:SLOWER_FRAMES]
    encode_cfg(frames[:2], SLOWER)                      # warm-up
    profile("slower encode", lambda: encode_cfg(slower, SLOWER),
            len(slower))
    return 0


if __name__ == "__main__":
    sys.exit(main())
