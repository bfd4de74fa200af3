"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root: `python3 chip_smoke.py`. It needs one CUDA
device and exits non-zero (printing no result) without one, or when the
port's package is not beside it. Phases, each printed as one line:
  1. the card's name and power limit;
  2. build of the port's CUDA kernels (csrc/*.cu) and its seconds;
  3. each kernel against its plain PyTorch version on the card, at
     1280x720 on a batch of synthetic content as large as the main path's
     batches (16 frames): K5 decide (all 13 maps equal; then pass A and
     pass B of each tier timed apart at effort 0, and at effort 1 below,
     each beside its bound, pass A held against `pass_a_plain`), K6 intra scan
     (recon + levels equal, tiles 8x6 and none), K7 deblock (equal), K8
     SAO statistics of the deblocked batch against the sources at tier 1
     (the main path's: luma, EO classes 0/1) and tier 4 (all classes, band
     offset, chroma), K22 (K8's per-frame wrapper) on frame 0, K9 SAO
     applied with the host decision's parameters at both tiers, K11
     reconstruction from K6's levels (equal to the plain version AND to
     K6's reconstruction, tiles 8x6 and none; then per picture at F = 1,
     as the decoder runs it, with its launches and bound), with
     CUDA-event medians of the kernel and of the plain version and the
     least time the card could take (bound); then, on the inputs the
     low-delay P path gives them for its first P picture (frame 1
     against the IDR of frame 0, recorded by wrapping the op functions
     during a 2-frame encode): K12 lookahead (downsample, the four
     feature maps and the packed head), K13 motion search (motion and
     costs), K15 inter decision (both decision iterations and every
     merge-snap call), K14 MC (equal to the plain version and to the
     prediction K17 builds), K17 inter coding (recon, levels, SAO
     parameters and prediction, with the seeded K6 scan, K7 and SAO) and
     K16 SAO decision on K8's statistics of its deblocked planes at tier
     1 (the path's) and tier 4; then the `fast` preset's kernels: K5 at
     effort 1 on the 16-frame batch (all 13 maps, the frame total cplx
     among them), K6 with RDOQ and sign hiding (tiles 8x6) on its
     decisions, K2 alone (RDOQ / sign hiding, csrc/rdoq.cu) on seeded
     random coefficients at every TU size, scan and flag combination, as
     many TUs of each size as that batch's schedule holds, and K17 with
     sign hiding on the first P picture of bench.py's inter leg; K5's
     NxN tier on the 16-frame batch (the pass with nxn=True, all 13 maps,
     NxN taken and split16 moved; the tier's two kernels alone, timed);
  4. the main path: HevcEncoder with bench.py's configuration (1280x720,
     ultrafast, QP 27, all-intra, tiles 8x6, SAO from the preset) on 32
     frames, once to warm up and once timed with the launch counts reset
     just before; every encode kernel must have launched, the recon luma
     PSNR must exceed 30 dB, and the timed stream must equal the same
     encode on the plain versions byte for byte, as must a 2-frame encode
     (the batch-of-2 path);
  5. the decode path: HevcDecoder on the card decodes the timed stream
     (warm-up on its first pictures, then timed with the launch counts
     reset): every picture through the fast path, every frame's md5 equal
     to the encoder's reconstruction, K11 launched once a picture, K7 and
     K9 launched; the first 4 pictures decode the same with
     reference=True (every later decode leg checks K11's launches too: one
     for each I picture, at most one for each P or B picture);
  6. the SAO-off encode (4 frames): K5, K6 and K7 launched, kernel
     stream == plain stream;
  7. the low-delay P path (BASELINE.json config 2: ultrafast,
     zerolatency, QP 30, intra_period 0, SAO from the preset, tier 1):
     the SAO-off P path on 4 frames gives the plain versions' stream; 8
     frames on the kernels give the plain versions' stream and recons;
     then, after a warm-up, one timed 24-frame encode (bench.py's
     INTER_FRAMES) with the launch counts reset just before: K5, K6, K7,
     K8, K9, K12, K13, K15, K14, K17 and K16 must have launched, luma
     PSNR > 30 dB;
  8. the P decode: HevcDecoder on the card decodes the timed IPPP stream
     once recording K18's inputs, then once timed with the launch counts
     reset: all 24 pictures through the fast path, every frame's md5 equal
     to the encoder's reconstruction, K14, K18, K7 and K9 launched; the
     first 4 pictures decode the same with reference=True; then K18
     against its plain version on the recorded P picture with the most
     intra CUs;
  9. the CLIs: app_encoder on 8 frames of a .yuv launches every encode
     kernel and writes HevcEncoder's bytes, app_decoder -md5 1 launches
     K11, K7 and K9 and prints the encoder's md5s, app_encoder with
     -latency zerolatency -iper 0 on 4 frames launches the inter kernels
     and K16 and writes HevcEncoder's bytes, and app_decoder -md5 1 on
     that stream launches K18 and prints the encoder's md5s;
 10. bench.py's inter leg (fast, zerolatency, QP 30, intra_period 0, SAO
     tier 3): 8 frames on the kernels give the plain versions' stream and
     recons; then, after a warm-up, one timed 24-frame encode with the
     launch counts reset just before: K5 (effort 1), K6 with K2 inside
     (the IDR's RDOQ and sign hiding, the seeded scan's sign hiding), K7,
     K8, K9, K12, K13, K15, K14, K17 with K2's sign hiding and K16 must
     have launched, luma PSNR > 30 dB;
 11. the card decode of that stream, timed with the counts reset: all 24
     pictures through the fast paths, md5s equal to the encoder's recon,
     the first 4 equal with reference=True;
 12. a 16-frame fast all-intra encode (QP 27, tiles 8x6), timed after a
     warm-up with the counts reset, equal to its plain-version encode and decoded on the
     card to the encoder's md5s;
 13. app_encoder -preset fast -iper 1 with the default -rdoq on 4 frames
     writes HevcEncoder's bytes, and app_decoder -md5 1 prints its md5s;
 14. the B pictures (fast, offline, QP 27, EncoderConfig's default GOP-8):
     (a) a 9-frame encode on the kernels (the IDR and one GOP-8) records
     the op functions' inputs; K13 with the bi cost (motion, costs, dir8
     and sad8), K14 with both lists (equal to the plain version and to
     K17's prediction), K15 (both decision iterations and every snap
     call) and K17 (SAO tier 3, sign hiding) are held against their
     plain versions on its first B picture (POC 4) and timed; (b) the
     same 9 frames on the plain versions give the same stream and
     recons, then 25 frames are encoded with the launch counts reset
     (K5 effort 1, K6 with K2, K7, K8, K9, K12, K13 with the bi cost,
     K15, K14 uni and bi, K17, K16 must launch), at least 7 B pictures,
     luma PSNR > 30 dB, b-adapt's GOP sizes printed; (c) the card
     decodes that stream once recording K18's inputs and once timed:
     all 25 pictures through the fast paths in display order with the
     encoder's md5s, the first 4 in decode order equal with
     reference=True, then K18 with both lists against its plain version
     on the B picture with the most intra CUs; (d) app_encoder -preset
     fast -latency offline on 10 frames writes HevcEncoder's bytes and
     app_decoder -md5 1 prints its md5s;
 15. cu_qp_delta and explicit weighted prediction on a luma fade (the
     synthetic frames, luma 5% darker a frame): (a) a 9-frame encode of
     the VOD configuration (fast, offline GOP-8, QP 27, cutree, aq_mode 2,
     weightp) records the inputs of K12 and K17; K12 with the 8x8
     variance, K17 with the effective-QP chain and weights and K14
     weighted on the first P picture with weights, the chain alone on its
     levels, and K17 on the first B picture under cu_qp_delta are held
     against their plain versions; (b) the same 9 frames on the plain
     versions give the same stream and recons, and the pictures with
     weights, the CTBs with a nonzero offset and the cells the chain
     moved are printed (each must be above 0); (c) 17 frames timed with
     the counts reset, decoded on the card (timed) with the encoder's
     md5s, and K18 weighted (with cu_qp_delta QPs) against its plain
     version; (d) the live configuration (fast, zerolatency, QP 30,
     intra_period 0, aq_mode 1, weightp) on 16 frames timed and decoded;
     (e) all-intra AQ (fast, aq_mode 1, tiles 8x6) on 4 frames against the
     plain versions and decoded; (f) app_encoder -preset fast -aq 2 and
     app_decoder -md5 1;
 16. the medium preset, EncoderConfig's defaults (offline GOP-8, QP 26,
     the NxN tier on the IDR, the intra TU-split flag, CU-tree, weightp,
     SAO tier 4, RDOQ, sign hiding), on the luma fade: (a) 9 frames on the
     kernels give the plain versions' stream and recons; (b) 17 frames
     timed with the launch counts reset (the NxN kernels must launch);
     (c) the card's decode of that stream, timed: every picture through
     the fast paths, the encoder's md5s; (d) medium all-intra AQ on 4
     frames (the tier on every frame) against the plain versions and
     decoded; (e) app_encoder with its defaults (no -preset, no -rc) on 10
     frames and app_decoder -md5 1 on the card, the encoder's recon md5s;
 17. the host walk (the slower presets' P and B pictures): (a) K20's SAD
     grid on every grid of the hierarchical route (me 2, merange 64) and
     of the +-16 full-resolution route at bs 16 and 8, and K21's
     quarter-pel costs and bi cost at bs 16 and 8, on the 720p inputs the
     walk gives them for frame 1 (against frame 0; frame 2 as the second
     list), against their plain versions (and K20 against `unfold` +
     `cdist(p=1)`, timed as its library call); (b) the `slower` leg
     (1280x720, QP 27, offline, 9 frames) timed with the launch counts
     reset (K20, K21 and its bi cost must launch), luma PSNR > 30 dB, and
     decoded by the CPU decoder (the host scalar decode: the card's fast
     parse aborts on inter TU splits) to the encoder's md5s; (c) the
     `slower_ldp` leg (zerolatency, refs=2, 5 frames) timed; (d) both at
     416x240 on the kernels against the plain versions (stream and
     recons), decoded on the CPU to the encoder's md5s.
K2 runs inlined in K6 and K17: its launches are those of the K6 and K17
kernels that ran its code (`intra_level_k2`, `inter_tu_class_k2`).
The line before the last is the JSON kernel table with the fps of every
timed leg; the last line is the device JSON. Nothing here imports jax or
ks265codec_tpu.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import shutil
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

W, H, FRAMES = 1280, 720, 32
INTER_FRAMES = 24       # bench.py's inter leg
# bench.py's inter leg: bench_ours_inter's configuration
FAST_INTER = dict(width=1280, height=720, preset="fast",
                  latency="zerolatency", qp=30, intra_period=0,
                  frame_rate=30)
INTER_ROWS = ("lookahead", "motion_search", "inter_decide", "inter_mc",
              "inter_code", "sao_decide")
FAST_ROWS = ("rdoq_sbh", "decide_effort1", "intra_scan_rdoq_sbh",
             "inter_code_sbh")
BFRAMES = 25
# the offline hierarchical-B configuration: EncoderConfig's defaults
# (bframes 7, b_adapt 1, lookahead 40, intra_period 64) at the fast preset
BFRAME = dict(width=1280, height=720, preset="fast", latency="offline",
              rc=0, qp=27, frame_rate=30)
B_ROWS = ("me_bi", "inter_mc_bi", "inter_decide_bi", "inter_code_bi",
          "inter_recon_bi")
# cu_qp_delta and explicit weighted prediction on a luma fade: the VOD
# configuration (the B one with CU-tree, aq_mode 2 and weightp), the live
# one (bench.py's inter leg with aq_mode 1 and weightp) and all-intra AQ
AQWP_FRAMES, AQWP_LIVE_FRAMES = 17, 16
AQWP_VOD = dict(BFRAME, cutree=1, aq_mode=2, weightp=True)
AQWP_LIVE = dict(FAST_INTER, rc=0, aq_mode=1, weightp=True)
AQWP_INTRA = dict(width=1280, height=720, preset="fast", rc=0, qp=27,
                  intra_period=1, tiles="8x6", aq_mode=1, frame_rate=30)
AQWP_ROWS = ("lookahead_var", "inter_code_dqp_wp", "inter_mc_wp",
             "inter_recon_wp")
# the medium preset: EncoderConfig's defaults (offline GOP-8 with b-adapt,
# QP 26, the NxN tier on the IDR, the intra TU-split flag, CU-tree,
# weightp, SAO tier 4, RDOQ, sign hiding) at 720p, and its all-intra AQ
MEDIUM_FRAMES = 17
MEDIUM = dict(width=1280, height=720, frame_rate=30)
MEDIUM_INTRA = dict(MEDIUM, intra_period=1, aq_mode=1)
MEDIUM_ROWS = ("decide_nxn",)
# the presets whose P and B pictures take the host walk: slower offline
# (the GOP-8 with b-adapt, QP 27) and slower low-delay with two L0
# references, on bench.py's synthetic frames; their stream identity at
# 416x240
SLOWER_FRAMES, SLOWER_LDP_FRAMES = 9, 5
SLOWER = dict(width=1280, height=720, preset="slower", rc=0, qp=27,
              frame_rate=30)
SLOWER_LDP = dict(SLOWER, latency="zerolatency", intra_period=0, refs=2)
WALK_W, WALK_H = 416, 240
WALK_ROWS = ("me_full_grid", "subpel_costs", "subpel_bi_cost")
# the three launches of K17's effective-QP chain (`ks_inter_eff_qp`)
EFF_QP = ["inter_eff_qp_ctb", "inter_eff_qp_scan", "inter_eff_qp_apply"]
# H100 SXM figures. HBM rate: NVIDIA's data sheet. INT32 issue rate: 132
# SMs x 64 INT32 lanes per SM (Hopper SM) x 1.98 GHz boost clock, the clock
# behind the data sheet's 67 TFLOP/s FP32. FP32 rate: 132 SMs x 128 FP32
# lanes x 1.98 GHz (that data sheet figure with an FMA counted as one).
# Most of the kernels' work is int32: a multiply-add is one IMAD and
# counts as one. K16's is float32 (an FFMA counts as one).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FP32_OPS_PER_S = 132 * 128 * 1.98e9


def synth_frames(n: int):
    """The synthetic 720p content of bench.py::synth_frames (seed 9)."""
    rng = np.random.RandomState(9)
    out = []
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(n):
        y = (128 + 60 * np.sin((xx + 3 * t) / 37.0)
             + 40 * np.cos((yy - 2 * t) / 29.0))
        y[(yy - 300) ** 2 + (xx - 400 - 20 * t) ** 2 < 90 ** 2] = 210
        y = np.clip(y + rng.randn(H, W) * 3, 0, 255).astype(np.uint8)
        u = np.clip(128 + 30 * np.sin((xx[::2, ::2] + t) / 41.0),
                    0, 255).astype(np.uint8)
        v = np.clip(128 + 30 * np.cos((yy[::2, ::2] - t) / 43.0),
                    0, 255).astype(np.uint8)
        out.append((y, u, v))
    return out


def md5s(frames) -> list:
    return [tuple(hashlib.md5(np.ascontiguousarray(p).tobytes()).hexdigest()
                  for p in (f.y, f.u, f.v)) for f in frames]


def cuda_ms(fn, reps: int = 5, warm: bool = True) -> float:
    """Median CUDA-event time of fn() in ms, after one warm-up call unless
    the caller has just made one (`warm=False`)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float,
             fp_ops: float = 0.0) -> tuple[float, str]:
    """Least time in ms: the bytes over the HBM rate, or the operations
    over the instruction rates, whichever is larger. ops are int32, fp_ops
    float32; an SM runs 128 lanes a cycle, of which 64 can be int32, so
    mixed work takes at least (ops + fp_ops) at the FP32 rate and its
    int32 part at least ops at the INT32 rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = max(ops / INT32_OPS_PER_S, (ops + fp_ops) / FP32_OPS_PER_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_abs_err(a, b) -> float:
    pairs = zip(a, b) if isinstance(a, (tuple, list)) else [(a, b)]
    err = 0.0
    for x, y in pairs:
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        x, y = x.detach().cpu().double(), y.detach().cpu().double()
        d = torch.where(x == y, 0.0, (x - y).abs())     # equal infinities
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def mc_ops(mv, n: int, luma: bool):
    """Multiply-adds that separable MC of an n x n block needs for motion
    mv (..., 2) [x, y] (quarter-pel luma, eighth-pel chroma): the
    horizontal pass covers the taps - 1 extra rows the vertical pass reads
    only where the vertical phase is fractional, and a pass at phase 0 is a
    pick, one operation a sample. Returns a tensor of mv's leading shape."""
    taps, frac = (8, 3) if luma else (4, 7)
    mv = mv.detach().cpu().long()
    fx, fy = (mv[..., 0] & frac) > 0, (mv[..., 1] & frac) > 0
    return ((n + (taps - 1) * fy.long()) * n * torch.where(fx, taps, 1)
            + n * n * torch.where(fy, taps, 1))


def mc3_ops(mv, n: int):
    """MC operations of an n x n luma block and its two n/2 chroma blocks
    (mc_ops)."""
    return mc_ops(mv, n, True) + 2 * mc_ops(mv, n // 2, False)


def uses(s0, s1):
    """(list 0, list 1) masks of the motions a prediction reads (K14's
    `_combine`): both where both slots are >= 0, list 1 alone where only
    its slot is, list 0 otherwise; s1 None: list 0 everywhere."""
    s0 = s0.detach().cpu()
    if s1 is None:
        return torch.ones_like(s0, dtype=torch.bool), None
    s1 = s1.detach().cpu()
    return (s0 >= 0) | (s1 < 0), s1 >= 0


def pred_ops(n: int, mv0, s0, mv1=None, s1=None, chroma: bool = True):
    """MC operations of predicting n x n blocks (with chroma: and their
    two n/2 chroma blocks) from motion mv0 / mv1 with slots s0 / s1: one
    separable filter per list read, two where a block is bi-predicted,
    and 3 a sample for the rounding combine."""
    f = (lambda mv: mc3_ops(mv, n)) if chroma else \
        (lambda mv: mc_ops(mv, n, True))
    u0, u1 = uses(s0, s1)
    ops = torch.where(u0, f(mv0), 0)
    if u1 is not None:
        ops = ops + torch.where(u1, f(mv1), 0)
    return ops + 3 * n * n * (1.5 if chroma else 1)


def rough_ops(mv, n: int, s0=None, mv1=None, s1=None):
    """Operations of one motion's rough cost at CU size n (K15's
    `rough_cu`): luma and both chroma MC (pred_ops; both lists where a B
    picture's motion is bi-predicted), then per sample the residual, the
    forward transform (2 stages of t multiply-adds, matrix form, t the TU
    size) and about 10 for quantisation, dequantisation, error and level
    bits."""
    t, tc = min(n, 32), min(n // 2, 16)
    if s0 is None:
        s0 = torch.zeros(mv.shape[:-1], dtype=torch.int64)
    return (pred_ops(n, mv, s0, mv1, s1) - 3 * n * n * 1.5
            + n * n * (2 * t + 11) + 2 * (n // 2) ** 2 * (2 * tc + 11))


def planes_mc_ops(slot0, mv0, slot1=None, mv1=None) -> float:
    """MC operations of a whole picture's prediction from per-8x8-cell
    motion (K14): pred_ops of each cell."""
    return float(pred_ops(8, mv0.cpu(), slot0.cpu(),
                          None if mv1 is None else mv1.cpu(),
                          None if slot1 is None else slot1.cpu()).sum())


def table_row(rows: dict, name: str, source: str, replaces: str, err, ms,
              plain, nbytes, ops, counters, required=None, fp_ops=0.0):
    """Put kernel `name`'s row in `rows` (source under csrc/, the replaced
    reference function, the comparison's error, the kernel's and the plain
    version's ms, the bound from nbytes / ops / fp_ops, the launch counters
    and those the main path must launch). Returns (bound ms, bound by)."""
    bnd, by = bound_ms(nbytes, ops, fp_ops)
    rows[name] = dict(name=name, route="cuda",
                      source=f"ks265codec_tpu_torch/csrc/{source}",
                      replaces=f"ks265codec_tpu/{replaces}",
                      max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                      bound_by=by, library_ms=None, counters=counters,
                      required=required or counters)
    return bnd, by


def inter_kernel_phases(calls: dict, yuv, dev, card: str) -> dict:
    """K12, K13, K15, K17 and K14 against their plain versions on the
    recorded inputs of the first P picture; returns their table rows."""
    from ks265codec_tpu_torch.ops import intercode as tic
    from ks265codec_tpu_torch.ops import interdecide as tid
    from ks265codec_tpu_torch.ops import lookahead as tla
    from ks265codec_tpu_torch.ops import me2
    from ks265codec_tpu_torch.ops import saodecide as tsd
    from ks265codec_tpu_torch.ops import saostats as sst
    from ks265codec_tpu_torch.ops.mc import mc_planes_cuda, mc_planes_plain
    rows = {}

    def row(*a, **k):
        return table_row(rows, *a, **k)

    # K12: the downsample of frame 1 and its features against frame 0
    cur, prev = calls["frame_features_batch"][-1][0][:2]
    y1 = torch.from_numpy(np.ascontiguousarray(yuv[1].y)).to(dev)[None]
    dk, dp = tla.downsample2x_cuda(y1), tla.downsample2x_plain(y1)
    fk = tla.features_cuda(cur, prev)
    fp = tla.features_plain(cur, prev)
    torch.cuda.synchronize()
    if not torch.equal(dk, dp) or not all(torch.equal(a, b)
                                          for a, b in zip(fk, fp)):
        raise AssertionError("K12 lookahead: kernel and plain differ")
    pk = tla.frame_features_batch(cur, prev)
    pp = tla.frame_features_batch(cur, prev, reference=True)
    if not torch.equal(pk, pp):
        raise AssertionError("K12 lookahead: packed heads differ")
    ms = cuda_ms(lambda: (tla.downsample2x_cuda(y1),
                          tla.features_cuda(cur, prev)))
    plain = cuda_ms(lambda: (tla.downsample2x_plain(y1),
                             tla.features_plain(cur, prev)), warm=False)
    nb = cur[0].numel() // 64
    # bytes: the frame in, the half frame out, both half planes and the 4
    # maps; operations: 289 offsets x 64 samples x 3 (sub, abs, add) and
    # the 4 intra modes, per 8x8 half-res block, and 4 per downsampled
    # sample
    bnd, by = row("lookahead", "lookahead.cu", "ops/lookahead.py:99",
                  max(max_abs_err(dk, dp), max_abs_err(list(fk), list(fp))),
                  ms, plain, y1.numel() * 1.25 + 2 * cur.numel()
                  + 16 * nb, nb * (289 * 64 * 3 + 4 * 64 * 3)
                  + dk.numel() * 4, ["la_downsample", "la_features"])
    print(f"phase K12 lookahead (frame 1 vs 0, {tuple(cur.shape)} half "
          f"planes): maps and head equal, kernel {ms:.3f} ms, plain "
          f"{plain:.3f} ms, bound {bnd:.4f} ms ({by})", flush=True)

    # K13: the motion search of frame 1 against the IDR
    a, k = calls["me_fused"][-1]
    gk = me2.me_fused(*a, **dict(k, reference=False))
    gp = me2.me_fused(*a, **dict(k, reference=True))
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(gk, gp)):
        raise AssertionError("K13 motion search: kernel and plain differ")
    ms = cuda_ms(lambda: me2.me_fused(*a, **dict(k, reference=False)))
    plain = cuda_ms(lambda: me2.me_fused(*a, **dict(k, reference=True)),
                    reps=3, warm=False)
    src = a[0]
    Hs, Ws = src.shape
    sr = me2.sr_for(a[2])
    nq, n8 = (Hs // 16) * (Ws // 16), (Hs // 8) * (Ws // 8)
    # operations: the quarter search ((2 sr + 1)^2 offsets x 16 samples x
    # 3, once), the two +-3 refinements (49 x 16 and 49 x 64 samples x 3),
    # and per quarter-pel candidate the separable 8-tap filter (15 x 8 + 8 x
    # 8 rows of 8 multiply-adds), the SATD8 (about 6 x 64) and the rate;
    # bytes: the picture and the reference read once, the motion written
    ops = (nq * (2 * sr + 1) ** 2 * 16 * 3 + n8 * 49 * (16 + 64) * 3
           + n8 * 49 * ((15 * 8 + 8 * 8) * 8 + 6 * 64 + 20))
    bnd, by = row("motion_search", "me.cu", "ops/me2.py:207",
                  max_abs_err(list(gk), list(gp)), ms, plain,
                  2.0 * src.numel() + 12 * n8, ops,
                  ["me_down2", "me_dense_l2", "me_refine3", "me_subpel8"])
    print(f"phase K13 motion search ({Ws}x{Hs}, +-{sr} quarter-res, "
          f"{n8} blocks): motion and costs equal, kernel {ms:.3f} ms, "
          f"plain {plain:.3f} ms, bound {bnd:.4f} ms ({by})", flush=True)

    # K15: every decision call (both iterations) and every snap call
    err, first = 0.0, None
    for a, k in calls["decide_tiers"]:
        gk = tid.decide_tiers(*a, **dict(k, reference=False))
        gp = tid.decide_tiers(*a, **dict(k, reference=True))
        torch.cuda.synchronize()
        if first is None:
            first = gp
        for (n, _), x, y in zip(a[3], gk, gp):
            if not all(torch.equal(u.cpu(), v.cpu()) for u, v in zip(x, y)):
                raise AssertionError(f"K15 decide tier {n}: kernel and "
                                     "plain differ")
            err = max(err, max_abs_err(list(x), list(y)))
    for a, k in calls.get("snap_sads", []):
        gk = tid.snap_sads(*a, **dict(k, reference=False))
        gp = tid.snap_sads(*a, **dict(k, reference=True))
        if not all(torch.equal(x, y) for x, y in zip(gk, gp)):
            raise AssertionError("K15 snap SADs: kernel and plain differ")
        err = max(err, max_abs_err(list(gk), list(gp)))
    a, k = calls["decide_tiers"][0]
    ms = cuda_ms(lambda: tid.decide_tiers(*a, **dict(k, reference=False)))
    plain = cuda_ms(lambda: tid.decide_tiers(*a, **dict(k, reference=True)),
                    reps=3, warm=False)
    ops, nbytes, ncu = decide_call_ops(a, first, False)
    bnd, by = row("inter_decide", "inter_decide.cu", "ops/interdecide.py:157",
                  err, ms, plain, nbytes, ops,
                  ["inter_decide", "inter_cand_sads"], ["inter_decide"])
    print(f"phase K15 inter decide ({len(calls['decide_tiers'])} decision "
          f"and {len(calls.get('snap_sads', []))} snap calls, {ncu} CUs in "
          f"the first): equal, kernel {ms:.3f} ms, plain {plain:.3f} ms "
          f"(first call), bound {bnd:.4f} ms ({by})", flush=True)

    # K17 (with the seeded K6, K7 and SAO: K8 -> K16 -> K9) and K14
    # inside it
    a, k = calls["code_inter_frame"][-1]
    if k.get("sao") is None:
        raise AssertionError("the P path ran K17 without SAO")
    gk, gp = k17_outputs(a, k, "K17 inter code")
    src, refs, slot0, mv0 = a[:4]
    h8, w8, pic_w, pic_h = a[10:14]
    mca = (refs, slot0.to(dev), mv0.to(dev),
           torch.full_like(slot0, -1).to(dev), torch.zeros_like(mv0).to(dev),
           False, h8, w8, pic_w, pic_h)
    mk = mc_planes_cuda(*mca)

    def mc_plain():
        return mc_planes_plain(*refs, *mca[1:])

    mp = mc_plain()
    for c, u, v, w in zip("YUV", mk, mp, gk[3]):
        if not torch.equal(u, v) or not torch.equal(u, w):
            raise AssertionError(f"K14 MC: plane {c} differs")
    ms = cuda_ms(lambda: mc_planes_cuda(*mca))
    plain = cuda_ms(mc_plain, warm=False)
    npx = src[0].numel() * 1.5
    # operations: the separable filters this run's motion needs (mc_ops)
    # and the rounding combine (3 a sample); bytes: the reference read and
    # the prediction written once, the motion read
    bnd, by = row("inter_mc", "inter_code.cu", "ops/mc.py:180",
                  max_abs_err(mk, mp), ms, plain, 2 * npx + 12 * h8 * w8,
                  planes_mc_ops(slot0, mv0), ["inter_mc"])
    print(f"phase K14 MC ({h8 * w8} cells): kernel planes == plain == K17's "
          f"prediction, kernel {ms:.3f} ms, plain {plain:.3f} ms, bound "
          f"{bnd:.4f} ms ({by})", flush=True)
    rows["inter_code"], sao_stats = inter_code_phase(
        a, k, gk, gp, "inter_code", ["inter_tu_class", "inter_gate",
                                     "inter_finish", "inter_bs"])
    tier, qp, cs = k["sao"]

    # K16 on those statistics: tier 1 (the path's) and tier 4 (all
    # classes, band offset, chroma)
    for tier in (1, 4):
        stats = sao_stats(tier)
        dk = tsd.sao_decide_cuda(stats, qp, tier)
        dp = tsd.sao_decide_plain(stats, qp, tier)
        torch.cuda.synchronize()
        for name, x, y in zip(("type", "offs", "bpos", "eocl"), dk, dp):
            if not torch.equal(x, y):
                raise AssertionError(f"K16 SAO decide (tier {tier}): {name} "
                                     "differs")
        ms = cuda_ms(lambda: tsd.sao_decide_cuda(stats, qp, tier))
        plain = cuda_ms(lambda: tsd.sao_decide_plain(stats, qp, tier),
                        warm=False)
        # bytes: the statistics read once, the parameters written once;
        # operations: decide_ops of these statistics, float32
        nbytes = sum(t.numel() * 4 for st in stats for t in st
                     if t is not None) + sum(t.numel() for t in dk)
        fp_ops = decide_ops(stats, tier, dp)
        if tier == 1:
            bnd, by = row("sao_decide", "sao_decide.cu",
                          "ops/saodecide.py:54", max_abs_err(dk, dp), ms,
                          plain, nbytes, 0.0, ["sao_decide"], fp_ops=fp_ops)
        else:
            bnd, by = bound_ms(nbytes, 0.0, fp_ops)
        print(f"phase K16 SAO decide (tier {tier}, {dk[0].shape[1]}x"
              f"{dk[0].shape[2]} CTBs, {int((dk[0] != 0).sum())} SAO-on "
              f"CTB planes, {fp_ops:.0f} float32 operations): equal, kernel "
              f"{ms:.3f} ms, plain {plain:.3f} ms, bound {bnd:.5f} ms "
              f"({by})", flush=True)
    return rows


def k17_outputs(a, k, what: str):
    """K17 on one recorded P picture, kernel and plain version: recon,
    levels, SAO parameters and prediction must be equal."""
    from ks265codec_tpu_torch.ops import intercode as tic
    gk = tic.code_inter_frame(*a, **dict(k, reference=False),
                              want_pred=True)
    gp = tic.code_inter_frame(*a, **dict(k, reference=True), want_pred=True)
    torch.cuda.synchronize()
    for part, x, y in zip(("recon", "levels", "SAO parameters",
                           "prediction"), gk, gp):
        for c, u, v in zip(range(4), x, y):
            if not torch.equal(u, v):
                raise AssertionError(f"{what}: {part} {c} differs")
    return gk, gp


def fast_kernel_phases(src, dargs, batch_tiled, yuv, dev) -> dict:
    """The `fast` preset's kernels against their plain versions on the
    card: K2 alone (every TU size, scan and flag combination), K5 at
    effort 1 and K6 with RDOQ and sign hiding (tiles 8x6) on the main
    path's 16-frame 720p batch, K17 with sign hiding on the first P
    picture of bench.py's inter leg. Returns their table rows."""
    from ks265codec_tpu_torch.encode import rdoq as trdoq
    from ks265codec_tpu_torch.encode.config import EncoderConfig
    from ks265codec_tpu_torch.encode.encoder import HevcEncoder
    from ks265codec_tpu_torch.encode.intra_frame import decision_maps8
    from ks265codec_tpu_torch.interop import device_tables
    from ks265codec_tpu_torch.ops import decide as dcd
    from ks265codec_tpu_torch.ops import intercode as tic
    from ks265codec_tpu_torch.ops import wavefront as wf
    rows = {}
    F, ph, pw = src[0].shape

    # K5 at effort 1: the full 35-mode sweep at every tier, the top-3
    # rough-RD candidates, the 5-candidate chroma search; all 13 maps,
    # the frame total cplx among them
    got = dcd.decide_frames_cuda(*src, *dargs, effort=1)
    want = dcd.decide_frames_plain(*src, *dargs, effort=1)
    torch.cuda.synchronize()
    for name in dcd.MAP_NAMES:
        if not torch.equal(got[name], want[name]):
            raise AssertionError(f"K5 decide (effort 1): map {name} differs")
    err = max(max_abs_err(got[k].to(torch.float64), want[k].to(torch.float64))
              for k in dcd.MAP_NAMES)
    ms = cuda_ms(lambda: dcd.decide_frames_cuda(*src, *dargs, effort=1))
    plain = cuda_ms(lambda: dcd.decide_frames_plain(*src, *dargs, effort=1),
                    reps=3, warm=False)
    # operations: every mode's prediction + 8x8 Hadamard (about 10 integer
    # ops per sample and mode) at all three tiers; the 3 candidates' rough
    # cost (the forward transform only: 2 stages of n multiply-adds per
    # sample, matrix form);
    # the 5 chroma candidates' prediction + Hadamard on both planes; the
    # winner's chroma rough cost; bytes: the sources and the maps once
    ops = 0.0
    for n in (16, 8, 32):
        nb = F * (ph // n) * (pw // n)
        nc = n // 2
        ops += nb * (35 * n * n * 10 + 3 * n * n * 2 * n
                     + 2 * 5 * nc * nc * 10 + 2 * nc * nc * 2 * nc)
    nbytes = F * ph * pw * 1.5 + sum(
        v.numel() * v.element_size() for v in got.values())
    bnd, by = bound_ms(nbytes, ops)
    rows["decide_effort1"] = dict(
        name="decide_effort1", route="cuda",
        source="ks265codec_tpu_torch/csrc/decide.cu",
        replaces="ks265codec_tpu/ops/decide.py:397", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None,
        counters=["decide_pass_a", "decide_pass_b", "decide_split"])
    print(f"phase K5 decide (effort 1): 13 maps equal (cplx "
          f"{float(got['cplx'].sum()):.1f} over {F} frames), kernel "
          f"{ms:.3f} ms, plain {plain:.3f} ms, bound {bnd:.4f} ms ({by})",
          flush=True)
    rows["decide_effort1"]["tiers"] = k5_tier_phase(src, dargs, 1)
    rows["decide_nxn"] = nxn_phase(src, dargs, got)

    # K6 with RDOQ and sign hiding on those decisions, tiles 8x6
    maps = {k: v.cpu().numpy() for k, v in got.items()}
    sps = batch_tiled["sps"]
    batch = []
    for f in range(F):
        log2m, modes8, cmodes8 = decision_maps8(
            maps["split32"][f], maps["split16"][f], maps["mode8"][f],
            maps["mode16"][f], maps["mode32"][f], sps, ph >> 3, pw >> 3,
            maps["cm8"][f], maps["cm16"][f], maps["cm32"][f])
        batch.append(dict(log2m=log2m, modes8=modes8, cmodes8=cmodes8,
                          qp_map8=np.full(log2m.shape, 27, np.uint8),
                          tile8=batch_tiled["tile8"]))
    pps = batch_tiled["pps"]
    sched = wf.WavefrontIntraCoder().pack(
        batch, pps.cb_qp_offset, pps.cr_qp_offset, sps).to(dev)
    tab = device_tables(dev)
    strong = bool(sps.strong_intra_smoothing)
    gk = wf.code_intra_frames_cuda(*src, sched, strong, tab, True, True)
    gp = wf.code_intra_frames_plain(*src, sched, strong, True, True)
    torch.cuda.synchronize()
    for part, x, y in (("recon", gk[0], gp[0]), ("levels", gk[1], gp[1])):
        for c, u, v in zip("YUV", x, y):
            if not torch.equal(u, v):
                raise AssertionError(f"K6 intra scan (RDOQ and sign hiding):"
                                     f" {part} plane {c} differs")
    ms = cuda_ms(lambda: wf.code_intra_frames_cuda(*src, sched, strong, tab,
                                                   True, True))
    plain = cuda_ms(lambda: wf.code_intra_frames_plain(*src, sched, strong,
                                                       True, True),
                    reps=3, warm=False)
    recs = sched.recs.cpu().numpy()
    sizes = recs[recs[:, wf.VALID] == 1, wf.SIZE].astype(np.float64)
    # operations: K6's (4 transform stages of n multiply-adds per sample,
    # matrix form) and K2's per coefficient (about 20 integer and 18
    # float32: the two candidates' costs, the group pass); bytes: sources
    # in, recon and int16 levels out
    ncoef = float(np.sum(sizes ** 2 * 1.5))
    bnd, by = bound_ms(F * ph * pw * 1.5 * (1 + 1 + 2),
                       float(np.sum(sizes ** 2 * 4 * sizes
                                    + 2 * (sizes / 2) ** 2 * 4 * (sizes / 2)))
                       + 20 * ncoef, 18 * ncoef)
    rows["intra_scan_rdoq_sbh"] = dict(
        name="intra_scan_rdoq_sbh", route="cuda",
        source="ks265codec_tpu_torch/csrc/intra_scan.cu",
        replaces="ks265codec_tpu/ops/wavefront.py:647",
        max_abs_err=max(max_abs_err(gk[0], gp[0]), max_abs_err(gk[1], gp[1])),
        ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None,
        counters=["intra_level_k2"])
    print(f"phase K6 intra scan (RDOQ and sign hiding, tiles 8x6): recon and "
          f"levels equal, {len(sched.levels)} levels, kernel {ms:.3f} ms, "
          f"plain {plain:.3f} ms, bound {bnd:.4f} ms ({by})", flush=True)

    # K2 alone: per TU size as many TUs as this batch's schedule holds
    # (luma, and two chroma TUs at half size), seeded random coefficients
    # (sparse, log-uniform magnitudes up to the escape levels), mixed
    # scans; every flag combination is held against the plain version,
    # RDOQ with sign hiding (the intra path's) is timed
    rng = np.random.RandomState(5)
    counts = {n: 0 for n in (4, 8, 16, 32)}
    for n in (8, 16, 32):
        counts[n] += int((sizes == n).sum())
        counts[n // 2] += 2 * int((sizes == n).sum())
    cases = {}
    for n, K in counts.items():
        mag = np.exp(rng.uniform(0, 10.4, (K, n, n)))
        c = np.where(rng.rand(K, n, n) < 0.3, mag, 0) * rng.choice(
            [-1, 1], (K, n, n))
        cases[n] = tuple(torch.from_numpy(a).to(dev) for a in (
            np.clip(c, -32767, 32767).astype(np.int32),
            np.full(K, 27, np.int32), rng.randint(0, 3, K).astype(np.int32)))
    err = 0.0
    for n, (c, q, sc) in cases.items():
        for flags in (1, 2, 3, 6):
            a = trdoq.rdoq_sbh_cuda(c, q, sc, n, flags)
            b = trdoq.rdoq_sbh_plain(c, q, sc, n, flags)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(f"K2 RDOQ/SBH (n {n}, flags {flags}): "
                                     "kernel and plain differ")
            err = max(err, max_abs_err(a, b))

    def run(fn):
        return [fn(c, q, sc, n, 3) for n, (c, q, sc) in cases.items()]

    ms = cuda_ms(lambda: run(trdoq.rdoq_sbh_cuda))
    plain = cuda_ms(lambda: run(trdoq.rdoq_sbh_plain), reps=3, warm=False)
    ncoef = float(sum(K * n * n for n, K in counts.items()))
    # bytes: the int32 coefficients in, the int32 levels out, qp and scan;
    # operations per coefficient as in K6's row: about 20 integer, 18
    # float32
    bnd, by = bound_ms(ncoef * 8 + 8 * sum(counts.values()), 20 * ncoef,
                       18 * ncoef)
    rows["rdoq_sbh"] = dict(
        name="rdoq_sbh", route="cuda",
        source="ks265codec_tpu_torch/csrc/rdoq.cuh",
        replaces="ks265codec_tpu/encode/rdoq.py:100", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None,
        counters=["intra_level_k2", "inter_tu_class_k2"])
    tus = ", ".join(f"{K} TUs of {n}" for n, K in counts.items())
    print(f"phase K2 RDOQ/SBH alone ({tus}; flags RDOQ, SBH, both, SBH "
          f"after inter rounding): equal, kernel "
          f"{ms:.3f} ms (RDOQ and SBH, all sizes), plain {plain:.3f} ms, "
          f"bound {bnd:.4f} ms ({by})", flush=True)

    # K17 with sign hiding on the first P picture of bench.py's inter leg
    calls = []
    fn = tic.code_inter_frame

    def spy(*a, **k):
        calls.append((a, k))
        return fn(*a, **k)

    tic.code_inter_frame = spy
    try:
        enc = HevcEncoder(EncoderConfig(**FAST_INTER))
        for fr in yuv[:2]:
            enc.encode_frame(fr)
        enc.flush()
    finally:
        tic.code_inter_frame = fn
    a, k = calls[-1]
    if not k.get("sbh") or k.get("sao") is None:
        raise AssertionError("the fast P path ran K17 without sign hiding "
                             "or SAO")
    gk, gp = k17_outputs(a, k, "K17 inter code (sign hiding)")
    rows["inter_code_sbh"], _ = inter_code_phase(
        a, k, gk, gp, "inter_code_sbh", ["inter_tu_class_k2", "inter_gate",
                                         "inter_finish", "inter_bs"])
    return rows


def nxn_phase(src, dargs, off: dict) -> dict:
    """K5's NxN tier on the main path's 16-frame 720p batch at effort 1:
    the whole pass with nxn=True on the kernels against its plain version
    (all 13 maps, floats and cplx bit for bit), with NxN taken and split16
    moved against the nxn=False maps `off`; then the tier's two kernels
    alone (`nxn_cuda`) against `nxn_plain` on the plain 8 tier's costs,
    timed. Returns the table row."""
    from ks265codec_tpu_torch.interop import device_bits_table
    from ks265codec_tpu_torch.ops import decide as dcd
    got = dcd.decide_frames_cuda(*src, *dargs, effort=1, nxn=True)
    want = dcd.decide_frames_plain(*src, *dargs, effort=1, nxn=True)
    torch.cuda.synchronize()
    for name in dcd.MAP_NAMES:
        if not torch.equal(got[name], want[name]):
            raise AssertionError(f"K5 decide (NxN): map {name} differs")
    err = max(max_abs_err(got[k].to(torch.float64), want[k].to(torch.float64))
              for k in dcd.MAP_NAMES)
    n_nxn = int(got["nxn8"].sum())
    moved = int((got["split16"] != off["split16"]).sum())
    if not (n_nxn > 0 and moved > 0):
        raise AssertionError(f"the NxN tier took {n_nxn} CUs and moved "
                             f"{moved} split16 cells")
    qp, qpc, lam, ls = dargs
    dev = src[0].device
    btab = device_bits_table(dev)
    _, cost8, _, cl8 = dcd._tier(*(p.to(torch.int32) for p in src), qp, qpc,
                                 lam, ls, 8, btab, effort=1, luma_cost=True)
    tk = dcd.nxn_cuda(src[0], qp, lam, ls, cl8, cost8)
    tp = dcd.nxn_plain(src[0], qp, lam, ls, cl8, cost8, btab)
    torch.cuda.synchronize()
    for what, a, b in zip(("mode4", "nxn8", "cost8"), tk, tp):
        if not torch.equal(a, b.to(a.dtype)):
            raise AssertionError(f"K5 NxN tier: {what} differs")
    err = max(err, max_abs_err([t.double() for t in tk],
                               [t.double() for t in tp]))
    ms = cuda_ms(lambda: dcd.nxn_cuda(src[0], qp, lam, ls, cl8, cost8))
    plain = cuda_ms(lambda: dcd.nxn_plain(src[0], qp, lam, ls, cl8, cost8,
                                          btab), reps=3, warm=False)
    # operations: per 4x4 luma block the 35 modes' prediction and 4x4
    # Hadamard (about 10 integer ops per sample and mode, as K5's rows
    # count) and the winner's forward transform (2 stages of 4
    # multiply-adds per sample, matrix form); bytes: the luma planes, cl8
    # and cost8 read once, mode4 (int32), nxn8 and cost8 written
    F, ph, pw = src[0].shape
    nb4 = F * (ph // 4) * (pw // 4)
    ops = nb4 * (35 * 16 * 10 + 16 * 2 * 4)
    nbytes = F * ph * pw + sum(t.numel() * t.element_size()
                               for t in (cl8, cost8) + tuple(tk))
    bnd, by = bound_ms(nbytes, ops)
    print(f"phase K5 NxN (effort 1, {F} frames): 13 maps of the pass equal, "
          f"{n_nxn} CUs NxN, {moved} split16 cells moved against nxn=False; "
          f"the tier alone: kernels {ms:.3f} ms, plain {plain:.3f} ms, bound "
          f"{bnd:.4f} ms ({by})", flush=True)
    return dict(name="decide_nxn", route="cuda",
                source="ks265codec_tpu_torch/csrc/decide.cu",
                replaces="ks265codec_tpu/ops/decide.py:315",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=None,
                counters=["decide_nxn_a", "decide_nxn_b"])


def inter_code_phase(a, k, gk, gp, name: str, counters: list):
    """K17's table row on one recorded P picture whose kernel (gk) and
    plain (gp) outputs were compared equal: its time and its plain
    version's, and its bound. Returns the row and the picture's K8
    statistics at a tier (a function of the tier)."""
    from ks265codec_tpu_torch.ops import intercode as tic
    from ks265codec_tpu_torch.ops import saostats as sst
    src, mv0 = a[0], a[3]
    pic_w, pic_h = a[12:14]
    ms = cuda_ms(lambda: tic.code_inter_frame(*a, **dict(k,
                                                          reference=False)))
    plain = cuda_ms(lambda: tic.code_inter_frame(*a, **dict(k,
                                                            reference=True)),
                    reps=3, warm=False)
    # K8's statistics of the P picture's deblocked planes (K17 without
    # SAO) against its sources, at a tier; K17's SAO input at the path's
    # tier, and K16's
    tier, qp, cs = k["sao"]
    deb, _, _ = tic.code_inter_frame(*a, **dict(k, sao=None))

    def sao_stats(tier):
        ncl, bo = (2 if tier <= 1 else 4), tier >= 3
        stats = []
        for r, x, sh in list(zip(deb, src, (0, 1, 1)))[:3 if bo else 1]:
            st = sst.sao_stats_frames(r[None], x[None], pic_w >> sh,
                                      pic_h >> sh, cs >> sh, ncl, bo)
            stats.append(tuple(t[0] if t is not None else None for t in st))
        return stats

    # operations: MC as K14's row counts it (the separable filters this
    # run's motion needs, 3 a sample to combine), per coded TU sample the
    # forward and inverse transforms (4 stages of n multiply-adds, matrix
    # form) and about 10 for residual, quantisation, dequantisation and
    # reconstruction (with sign hiding about 8 more for K2's group pass),
    # and SAO as K8's, K16's and K9's rows count it (this run's tier,
    # statistics and type maps; K16's at the FP32 rate); bytes: the
    # picture, the reference, the recon and the int16 levels once each
    npx = src[0].numel() * 1.5
    mc_total = planes_mc_ops(a[2], mv0, k.get("slot1"), k.get("mv1"))
    per = 10 + (8 if k.get("sbh") else 0)
    tu_ops = sum(int(p[4].sum()) * n * n * (4 * n + per)
                 for (_, n), p in a[4].items())
    ncl = 2 if tier <= 1 else 4
    sao_ops = (src[0].numel() * 15.0 * ncl
               + 12.0 * int((gk[2][0][0] != 0).sum()) * cs * cs)
    nref = 2 if k.get("has_l1") else 1
    bnd, by = bound_ms(npx * (nref + 1 + 1 + 2), mc_total + tu_ops + sao_ops,
                       decide_ops(sao_stats(tier), tier, gk[2]))
    print(f"phase K17 inter code{' with sign hiding' if k.get('sbh') else ''}"
          f" (seeded intra scan "
          f"{'with' if a[6] is not None else 'without'} intra CUs, SAO tier "
          f"{tier}): recon, levels, SAO parameters and prediction equal, "
          f"kernel {ms:.3f} ms (with K14, the seeded K6, K7, K8, K16 and "
          f"K9), plain {plain:.3f} ms, bound {bnd:.4f} ms ({by})",
          flush=True)
    row = dict(name=name, route="cuda",
               source="ks265codec_tpu_torch/csrc/inter_code.cu",
               replaces="ks265codec_tpu/ops/intercode.py:141",
               max_abs_err=max(max_abs_err(gk[0], gp[0]),
                               max_abs_err(gk[1], gp[1]),
                               max_abs_err(gk[2], gp[2])),
               ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
               library_ms=None, counters=counters, required=counters)
    return row, sao_stats


def k18_phase(calls: list, card: str, bi: bool = False,
              wp: bool = False) -> dict:
    """K18 (`recon_inter_filter`: K14, `ks_inter_recon`, the seeded K11, K7,
    K9) against its plain version on the recorded P picture (bi: B picture,
    both lists) of the stream with the most intra CUs, or (wp) on the
    decoded P picture with explicit weights with the most intra CUs;
    returns its table row."""
    from ks265codec_tpu_torch.ops import wavefront as wf
    kind = "weighted P" if wp else ("B" if bi else "P")

    def n_intra(c):
        sched = c[0][9]
        return 0 if sched is None else \
            int((np.asarray(sched.recs)[:, wf.VALID] == 1).sum())

    if wp:
        with_intra = [(n_intra(c), i) for i, c in enumerate(calls)
                      if c[1].get("wts0") is not None
                      and np.asarray(c[1]["wts0"][0]).any()]
    else:
        with_intra = [(n_intra(c), i) for i, c in enumerate(calls)
                      if c[0][9] is not None
                      and bool(c[1].get("has_l1")) == bi]
    if not with_intra:
        raise AssertionError(f"no decoded {kind} picture holds "
                             f"{'weights' if wp else 'intra CUs'}")
    n_intra, i = max(with_intra)
    a, k = calls[i]
    gk = wf.recon_inter_filter(*a, **dict(k, reference=False))
    gp = wf.recon_inter_filter(*a, **dict(k, reference=True))
    torch.cuda.synchronize()
    for c, x, y in zip("YUV", gk, gp):
        if not torch.equal(x, y):
            raise AssertionError(f"K18 inter recon: plane {c} differs")
    ms = cuda_ms(lambda: wf.recon_inter_filter(*a, **dict(k,
                                                          reference=False)))
    plain = cuda_ms(lambda: wf.recon_inter_filter(*a, **dict(k,
                                                             reference=True)),
                    reps=3, warm=False)
    (refs, slot0, mv0, coefs, log2m8, qp4, _, _, inter8, sched, bs_v, bs_h,
     sao_params) = a[:13]
    # operations, from this picture's data: the separable MC its motion
    # needs and the rounding (3 a sample); per inter TU with a coded
    # coefficient the inverse transform (2 stages of n multiply-adds,
    # matrix form) and about 4 a sample (dequantise, add, clip); per intra
    # CU the same with about 10 a sample for the prediction; deblocking
    # and SAO as the K7 and K9 rows count them; bytes: the reference, the
    # int16 levels and the planes written once each
    npx = coefs[0].numel() * 1.5
    ops = planes_mc_ops(slot0, mv0, k.get("slot1"), k.get("mv1"))
    cf = [c.cpu() for c in coefs]
    for pl, x, y, n in wf.inter_tu_list(log2m8.numpy(),
                                        inter8.numpy().astype(bool)):
        if bool(cf[pl][y:y + n, x:x + n].any()):
            ops += n * n * (2 * n + 4)
    if sched is not None:
        recs = np.asarray(sched.recs)
        sizes = recs[recs[:, wf.VALID] == 1, wf.SIZE].astype(np.float64)
        ops += float(np.sum(sizes ** 2 * (2 * sizes + 10)
                            + 2 * (sizes / 2) ** 2 * (sizes + 10)))
    if a[14]:                                  # deblock
        seg = int((bs_v > 0).sum() + (bs_h > 0).sum())
        seg16 = int((bs_v[:, ::4] == 2).sum() + (bs_h[::4, :] == 2).sum())
        ops += 160.0 * seg + 40.0 * seg16
    if sao_params is not None:
        cs = a[22]
        ops += 12.0 * int((sao_params[0] != 0).sum()) * cs * cs
    bnd, by = bound_ms(refs[0][0].numel() * 1.5 * (2 if bi else 1)
                       + 2 * npx + npx, ops)
    print(f"phase K18 inter recon ({kind} picture {i} of the decode, "
          f"{n_intra} "
          f"intra CUs): planes equal, kernel {ms:.3f} ms (K14, ks_inter_recon,"
          f" the seeded K11, K7 and K9), plain {plain:.3f} ms, bound "
          f"{bnd:.4f} ms ({by})", flush=True)
    return dict(name=("inter_recon_wp" if wp else
                      "inter_recon_bi" if bi else "inter_recon"),
                route="cuda",
                source="ks265codec_tpu_torch/csrc/inter_recon.cu",
                replaces="ks265codec_tpu/ops/wavefront.py:549",
                max_abs_err=max_abs_err(gk, gp), ms=ms, plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=None,
                counters=["inter_recon_wp" if wp else "inter_recon"])


def decide_ops(stats, tier: int, prm) -> float:
    """Float32 operations of the SAO decision (K16) that these statistics
    need: per bin the start (two casts, the max, the division, rint and
    the clamp: 8) and, where the bin has samples, about 6 for each of its
    |start| candidates (three products, a subtraction, the fma, the
    compare with the minimum); per EO class the sum of its four costs and
    the class compare (5); from tier 3 per plane the 29 band windows of
    three additions and a compare, and the window's lambda and compare
    (2). EO classes 0/1 at tier 1 and all four above; luma below tier 3,
    all three planes from it, Cr only in the mode and class Cb chose
    (prm: the decision's (type, offs, bpos, eocl))."""
    from ks265codec_tpu_torch.ops.saodecide import BOUNDS, CATS

    def bins(cnt, err, lo, hi):
        c, e = cnt.detach().cpu().float(), err.detach().cpu().float()
        start = torch.round(e / c.clamp(min=1.0)).clamp(lo, hi)
        return 8.0 + 6.0 * torch.where(c > 0, start.abs(), 0.0)

    type_, eocl = prm[0].cpu().long(), prm[3].cpu().long()
    total = 0.0
    for c, (eo_cnt, eo_err, bo_cnt, bo_err) in enumerate(
            stats[:3 if tier >= 3 else 1]):
        eo = torch.stack([
            sum(bins(eo_cnt[k, cat], eo_err[k, cat], *BOUNDS[j])
                for j, cat in enumerate(CATS)) + 5.0
            for k in range(2 if tier <= 1 else eo_cnt.shape[0])])
        bo = (bins(bo_cnt, bo_err, -7.0, 7.0).sum(0) + 29 * 4 + 2
              if tier >= 3 else torch.zeros(()))
        if c == 2:
            eo = torch.where(type_[1] == 2,
                             eo.gather(0, eocl[1][None])[0], 0.0)
            bo = torch.where(type_[1] == 1, bo, 0.0)
        total += float(eo.sum() + bo.sum())
    return total


def decide_call_ops(a, first, l1: bool) -> tuple[float, float, int]:
    """Operations and bytes K15 needs for one decision call (per tier,
    from its inputs and the plain version's output `first`), and its CUs:
    per valid candidate its luma MC (both lists where bi-predicted) and
    SAD; per CU the rough cost (rough_ops) of the best merge candidate
    and of the ME motion where they exist, or, at the zero-only tier, of
    every valid candidate; bytes: the picture and the references read
    once, the results written."""
    ops, nbytes, ncu = 0.0, 1.5 * a[0][0].numel() * (1 + a[1][0].shape[0]), 0
    for (n, zero_only), ta, out in zip(a[3], a[2], first):
        cv = ta["cvalid"].cpu().bool()
        cs0, cmv0 = ta["cs0"].cpu(), ta["cmv0"].cpu().long()
        cs1, cmv1 = ta["cs1"].cpu(), ta["cmv1"].cpu().long()
        lists = (cmv1, cs1) if l1 else (None, None)
        ncu += cv.shape[1]
        nbytes += cv.shape[1] * 9
        if zero_only:
            ops += float(rough_ops(cmv0, n, cs0, lists[0], lists[1])[cv]
                         .sum())
            continue
        ops += float(pred_ops(n, cmv0, cs0, *lists, chroma=False)[cv].sum())
        best = out[1].cpu().long()

        def pick(t):
            return t.gather(0, best[None, :, None].expand(1, -1, 2))[0] \
                if t.dim() == 3 else t.gather(0, best[None])[0]

        bl = (pick(cmv1), pick(cs1)) if l1 else (None, None)
        ops += float(rough_ops(pick(cmv0), n, pick(cs0), *bl)[cv.any(0)]
                     .sum())
        ms0, ms1 = ta["ms0"].cpu(), ta["ms1"].cpu()
        ml = (ta["mmv1"].cpu().long(), ms1) if l1 else (None, None)
        valid = (ms0 >= 0) | ((ms1 >= 0) if l1 else False)
        ops += float(rough_ops(ta["mmv0"].cpu().long(), n, ms0, *ml)[valid]
                     .sum())
    return ops, nbytes, ncu


def bframe_path(yuv, card: str, check_counts, rows: dict) -> dict:
    """Phase 14, the B pictures (the offline hierarchical GOP-8 at the fast
    preset, QP 27): (a) a 9-frame encode on the kernels (the IDR and one
    GOP-8) records the inputs of K13, K15 and K17, and K13 with the bi
    cost, K14 with both lists, K15 and K17 of its first B picture (POC 4)
    are held against their plain versions and timed; (b) the same 9
    frames on the plain versions give the same stream and recons, then a
    25-frame encode is timed with the launch counts reset; (c) the card's
    decode of that stream, timed, every picture through the fast paths
    with the encoder's md5s, then K18 with both lists against its plain
    version; (d) app_encoder -preset fast -latency offline on 10 frames
    and app_decoder -md5 1 on its stream. Adds the B rows to `rows` and
    returns the legs' fps."""
    from ks265codec_tpu_torch.cli import app_decoder, app_encoder
    from ks265codec_tpu_torch.decode.decoder import HevcDecoder
    from ks265codec_tpu_torch.encode.config import EncoderConfig
    from ks265codec_tpu_torch.encode.encoder import HevcEncoder
    from ks265codec_tpu_torch.ops import _build
    from ks265codec_tpu_torch.ops import intercode as tic
    from ks265codec_tpu_torch.ops import interdecide as tid
    from ks265codec_tpu_torch.ops import me2
    from ks265codec_tpu_torch.ops import wavefront as wf
    from ks265codec_tpu_torch.ops.mc import mc_planes_cuda, mc_planes_plain

    def bencode(frames_in, reference=False, gops=None):
        enc = HevcEncoder(EncoderConfig(**BFRAME), reference=reference)
        if gops is not None:
            adapt = enc._b_adapt

            def spy(idx0, gop_n):
                gops.append(adapt(idx0, gop_n))
                return gops[-1]
            enc._b_adapt = spy
        efs = []
        for fr in frames_in:
            efs += enc.encode_frame(fr)
        efs += enc.flush()
        return efs

    def row(*a, **k):
        return table_row(rows, *a, **k)

    # ---- 14a: the B kernels on the inputs of the GOP's first B picture,
    # recorded during the 9-frame kernel encode (each call tagged with the
    # number of pictures coded before it)
    calls = {}
    spied = [(me2, "me_fused"), (tid, "decide_tiers"), (tid, "snap_sads"),
             (tic, "code_inter_frame")]
    saved = [(m, name, getattr(m, name)) for m, name in spied]

    def spy(name, fn):
        def g(*a, **k):
            pic = len(calls.get("code_inter_frame", []))
            calls.setdefault(name, []).append((a, k, pic))
            return fn(*a, **k)
        return g

    for m, name, fn in saved:
        setattr(m, name, spy(name, fn))
    try:
        ka = bencode(yuv[:9])
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
    torch.cuda.synchronize()
    code = [c for c in calls["code_inter_frame"] if c[1].get("has_l1")]
    if len(code) != 7:
        raise AssertionError(f"the 9-frame GOP coded {len(code)} B pictures")
    bpic = code[0][2]                  # POC 4, coded after the P of POC 8

    # K13 with the bi cost: the pyramid against L0[0] and L1[0], then the
    # bi cost and the direction
    a, k, _ = next(c for c in calls["me_fused"] if c[2] == bpic)
    if not k.get("bi"):
        raise AssertionError("the first B picture's search ran without bi")
    gk = me2.me_fused(*a, **dict(k, reference=False))
    gp = me2.me_fused(*a, **dict(k, reference=True))
    torch.cuda.synchronize()
    for name, x, y in zip(("mv_q", "cost", "dir8", "sad8"), gk, gp):
        if not torch.equal(x, y):
            raise AssertionError(f"K13 bi: {name} differs")
    ms = cuda_ms(lambda: me2.me_fused(*a, **dict(k, reference=False)))
    ms_uni = cuda_ms(lambda: me2.me_fused(*a, **dict(k, bi=False,
                                                     reference=False)))
    plain = cuda_ms(lambda: me2.me_fused(*a, **dict(k, reference=True)),
                    reps=3, warm=False)
    src = a[0]
    Hs, Ws = src.shape
    sr = me2.sr_for(a[2])
    nq, n8 = (Hs // 16) * (Ws // 16), (Hs // 8) * (Ws // 8)
    # operations: K13's row per reference (two here), and the bi cost per
    # 8x8 block: both quarter-pel predictions (mc_ops), the combine (3 a
    # sample), the SATD8 (about 6 x 64) and the decision; bytes: the
    # picture and both references read once, motion, costs, dir8 and sad8
    # written
    ops = 2 * (nq * (2 * sr + 1) ** 2 * 16 * 3 + n8 * 49 * (16 + 64) * 3
               + n8 * 49 * ((15 * 8 + 8 * 8) * 8 + 6 * 64 + 20))
    ops += float((mc_ops(gk[0][0], 8, True) + mc_ops(gk[0][1], 8, True))
                 .sum()) + n8 * (3 * 64 + 6 * 64 + 10)
    nbi = int((gk[2] == 2).sum())
    bnd, by = row("me_bi", "me.cu", "ops/me2.py:181",
                  max_abs_err(list(gk), list(gp)), ms, plain,
                  3.0 * src.numel() + 29 * n8, ops,
                  ["me_down2", "me_dense_l2", "me_refine3", "me_subpel8",
                   "me_bi_cost8"], ["me_bi_cost8"])
    print(f"phase K13 bi (B picture POC 4, {Ws}x{Hs}, {n8} blocks, {nbi} "
          f"bi-predicted): motion, costs, dir8 and sad8 equal, kernel "
          f"{ms:.3f} ms (both lists' pyramids and the bi cost; "
          f"{ms - ms_uni:.3f} ms over the two searches alone, {ms_uni:.3f} "
          f"ms), plain {plain:.3f} ms, bound {bnd:.4f} ms ({by})",
          flush=True)

    # K17 with list 1 (SAO tier 3, sign hiding) and K14 with both lists
    # inside it, on the same picture
    a, k, _ = code[0]
    if not (k.get("sbh") and k.get("sao") and k["sao"][0] == 3):
        raise AssertionError("the B picture ran K17 without sign hiding or "
                             "SAO tier 3")
    gk, gp = k17_outputs(a, k, "K17 inter code (B)")
    refs, slot0, mv0 = a[1:4]
    slot1, mv1 = k["slot1"], k["mv1"]
    h8, w8, pic_w, pic_h = a[10:14]
    dev = refs[0].device
    mca = (refs, slot0.to(dev), mv0.to(dev), slot1.to(dev), mv1.to(dev),
           True, h8, w8, pic_w, pic_h)
    mk = mc_planes_cuda(*mca)
    mp = mc_planes_plain(*refs, *mca[1:])
    for c, u, v, w in zip("YUV", mk, mp, gk[3]):
        if not torch.equal(u, v) or not torch.equal(u, w):
            raise AssertionError(f"K14 bi: plane {c} differs")
    ms = cuda_ms(lambda: mc_planes_cuda(*mca))
    plain = cuda_ms(lambda: mc_planes_plain(*refs, *mca[1:]), warm=False)
    u0, u1 = uses(slot0, slot1)
    npx = a[0][0].numel() * 1.5
    # operations: the separable filters of every list each cell reads
    # (two where bi-predicted), the combine (3 a sample); bytes: both
    # references read, the prediction written, both motions read
    bnd, by = row("inter_mc_bi", "inter_code.cu", "ops/mc.py:141",
                  max_abs_err(mk, mp), ms, plain,
                  3 * npx + 24 * h8 * w8,
                  planes_mc_ops(slot0, mv0, slot1, mv1), ["inter_mc_bi"])
    print(f"phase K14 bi ({h8 * w8} cells: {int((u0 & ~u1).sum())} list 0, "
          f"{int((~u0 & u1).sum())} list 1, {int((u0 & u1).sum())} bi): "
          f"kernel planes == plain == K17's prediction, kernel {ms:.3f} ms, "
          f"plain {plain:.3f} ms, bound {bnd:.4f} ms ({by})", flush=True)
    rows["inter_code_bi"], _ = inter_code_phase(
        a, k, gk, gp, "inter_code_bi", ["inter_tu_class_k2", "inter_gate",
                                        "inter_finish", "inter_bs"])

    # K15: the picture's two decision calls and every snap call
    err, dec_calls = 0.0, [c for c in calls["decide_tiers"] if c[2] == bpic]
    for a, k, _ in dec_calls:
        if not k.get("has_l1"):
            raise AssertionError("the B picture's decision ran without "
                                 "list 1")
        gk = tid.decide_tiers(*a, **dict(k, reference=False))
        gp = tid.decide_tiers(*a, **dict(k, reference=True))
        torch.cuda.synchronize()
        for (n, _), x, y in zip(a[3], gk, gp):
            if not all(torch.equal(u.cpu(), v.cpu()) for u, v in zip(x, y)):
                raise AssertionError(f"K15 (B) decide tier {n}: kernel and "
                                     "plain differ")
            err = max(err, max_abs_err(list(x), list(y)))
        if a is dec_calls[0][0]:
            first = gp
    snaps = [c for c in calls.get("snap_sads", []) if c[2] == bpic]
    for a, k, _ in snaps:
        gk = tid.snap_sads(*a, **dict(k, reference=False))
        gp = tid.snap_sads(*a, **dict(k, reference=True))
        if not all(torch.equal(x, y) for x, y in zip(gk, gp)):
            raise AssertionError("K15 (B) snap SADs: kernel and plain differ")
        err = max(err, max_abs_err(list(gk), list(gp)))
    a, k, _ = dec_calls[0]
    ms = cuda_ms(lambda: tid.decide_tiers(*a, **dict(k, reference=False)))
    plain = cuda_ms(lambda: tid.decide_tiers(*a, **dict(k, reference=True)),
                    reps=3, warm=False)
    ops, nbytes, ncu = decide_call_ops(a, first, True)
    bnd, by = row("inter_decide_bi", "inter_decide.cu",
                  "ops/interdecide.py:157", err, ms, plain, nbytes, ops,
                  ["inter_decide", "inter_cand_sads"], ["inter_decide"])
    print(f"phase K15 inter decide (B picture POC 4: {len(dec_calls)} "
          f"decision and {len(snaps)} snap calls, {ncu} CUs in the first): "
          f"equal, kernel {ms:.3f} ms, plain {plain:.3f} ms (first call), "
          f"bound {bnd:.4f} ms ({by})", flush=True)

    # ---- 14b: the same 9 frames on the plain versions, then the timed
    # 25-frame encode (the 9-frame kernel encode above was its warm-up)
    kb = bencode(yuv[:9], reference=True)
    if b"".join(e.data for e in ka) != b"".join(e.data for e in kb) or \
            md5s(e.recon for e in ka) != md5s(e.recon for e in kb):
        raise AssertionError("9-frame GOP-8 stream or recon: kernels and "
                             "plain versions differ")
    print(f"phase B kernels vs plain stream: 9 frames "
          f"({sum(len(e.data) for e in ka)} bytes, slice types "
          f"{''.join(e.slice_type for e in ka)}) identical, recon md5s "
          "equal", flush=True)
    gops = []
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    befs = bencode(yuv[:BFRAMES], gops=gops)
    torch.cuda.synchronize()
    bsecs = time.perf_counter() - t0
    bcounts = dict(_build.launches)
    for key in ("decide_effort1", "intra_scan_rdoq_sbh", "deblock",
                "sao_stats", "sao_apply", "lookahead", "motion_search",
                "inter_decide", "inter_mc", "inter_code_sbh", "sao_decide",
                "me_bi", "inter_mc_bi", "inter_decide_bi", "inter_code_bi"):
        n_launch = check_counts(rows[key].get("required",
                                              rows[key]["counters"]),
                                bcounts, "B path")
        if key in ("me_bi", "inter_mc_bi", "inter_decide_bi",
                   "inter_code_bi"):
            rows[key]["launches"] = n_launch
    btypes = "".join(e.slice_type for e in befs)
    if btypes.count("B") < 7:
        raise AssertionError(f"the B path coded too few B pictures: {btypes}")
    bstream = b"".join(e.data for e in befs)
    brec = sorted(befs, key=lambda e: e.display_idx)
    bmse = np.mean([np.mean((e.recon.y.astype(np.float64)
                             - f.y.astype(np.float64)) ** 2)
                    for e, f in zip(brec, yuv)])
    bpsnr = 10 * np.log10(255.0 ** 2 / bmse)
    if not bpsnr > 30.0:
        raise AssertionError(f"B path luma PSNR {bpsnr:.2f} dB <= 30 dB")
    bframe_fps = len(befs) / bsecs
    print(f"phase B path: {len(befs)} frames {W}x{H} (fast offline QP 27, "
          f"SAO tier 3, GOP sizes {gops}) in {bsecs:.3f} s = "
          f"{bframe_fps:.3f} fps on {card}; stream {len(bstream)} bytes md5 "
          f"{hashlib.md5(bstream).hexdigest()}; luma PSNR {bpsnr:.3f} dB; "
          f"slice types {btypes}; launches {bcounts}", flush=True)

    # ---- 14c: the card decode: a first decode records K18's inputs, then
    # a timed decode with the launch counts reset just before
    benc_md5 = md5s(e.recon for e in brec)
    k18_calls = []
    k18_fn = wf.recon_inter_filter

    def k18_spy(*a, **k):
        k18_calls.append((a, k))
        return k18_fn(*a, **k)

    wf.recon_inter_filter = k18_spy
    try:
        HevcDecoder().decode_all(bstream)
    finally:
        wf.recon_inter_filter = k18_fn
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    bdec = HevcDecoder()
    bdecoded = bdec.decode_all(bstream)
    torch.cuda.synchronize()
    bdsecs = time.perf_counter() - t0
    bdcounts = dict(_build.launches)
    bframe_decode_fps = len(bdecoded) / bdsecs
    if bdec.fast_pictures != BFRAMES or len(bdecoded) != BFRAMES or \
            [f.poc for f in bdecoded] != sorted(e.poc for e in befs):
        raise AssertionError(f"B decode: {bdec.fast_pictures} of "
                             f"{len(bdecoded)} pictures took the fast "
                             "paths, or the output is out of display order")
    check_k11_launches(bdcounts, BFRAMES, 1, "B decode")
    if md5s(bdecoded) != benc_md5:
        bad = [i for i, (x, y) in enumerate(zip(md5s(bdecoded), benc_md5))
               if x != y]
        raise AssertionError(f"B decode: frames {bad} differ from the "
                             "encoder's reconstruction")
    check_counts(["inter_mc_bi", "inter_recon", "intra_recon",
                  "deblock_edges", "sao_apply"], bdcounts, "B decode path")
    first4 = HevcDecoder(reference=True).decode_all(
        b"".join(e.data for e in befs[:4]))
    want4 = {e.poc: m for e, m in zip(brec, benc_md5)}
    if md5s(first4) != [want4[f.poc] for f in first4] or len(first4) != 4:
        raise AssertionError("B decode: reference=True differs on the first "
                             "4 pictures in decode order")
    print(f"phase B decode: {len(bdecoded)} frames {W}x{H} in "
          f"{bdsecs:.3f} s = {bframe_decode_fps:.3f} fps on {card}; all "
          f"{bdec.fast_pictures} through the fast paths in display order, "
          f"md5 equal to the encoder's recon, first 4 in decode order "
          f"(POC {[f.poc for f in first4]}) equal with reference=True; "
          f"launches {bdcounts}", flush=True)
    rows["inter_recon_bi"] = k18_phase(k18_calls, card, bi=True)
    rows["inter_recon_bi"]["launches"] = bdcounts["inter_recon"]

    # ---- 14d: the CLIs on the offline GOP-8 path
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
    work.mkdir(parents=True, exist_ok=True)
    try:
        (work / "in.yuv").write_bytes(b"".join(f.tobytes()
                                               for f in yuv[:10]))
        argv = ["-i", str(work / "in.yuv"), "-wdt", str(W), "-hgt", str(H),
                "-frms", "10", "-b", str(work / "gop8.265"), "-preset",
                "fast", "-latency", "offline", "-qp", "27", "-fr", "30"]
        _build.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = app_encoder.main(argv)
        check_counts(rows["me_bi"]["required"]
                     + rows["inter_mc_bi"]["required"], _build.launches,
                     "app_encoder (offline)")
        ccfg = app_encoder.cfg_from_args(
            app_encoder.build_parser().parse_args(argv))
        enc = HevcEncoder(ccfg)
        cefs = []
        for fr in yuv[:10]:
            cefs += enc.encode_frame(fr)
        cefs += enc.flush()
        want = b"".join(e.data for e in cefs)
        if rc != 0 or (work / "gop8.265").read_bytes() != want:
            raise AssertionError("app_encoder -latency offline: bytes differ "
                                 "from HevcEncoder's")
        want_md5 = [",".join(m) for m in md5s(
            e.recon for e in sorted(cefs, key=lambda e: e.display_idx))]
        _build.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = app_decoder.main(["-b", str(work / "gop8.265"), "-md5", "1"])
        check_counts(["inter_mc_bi", "inter_recon"], _build.launches,
                     "app_decoder (offline)")
        dec_lines = [ln.split()[3] for ln in out.getvalue().splitlines()
                     if ln.startswith("POC ")]
        if rc != 0 or dec_lines != want_md5:
            raise AssertionError("app_decoder -md5 1 (offline): lines differ "
                                 "from the encoder's md5s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase CLI B: app_encoder -preset fast -latency offline 10 frames "
          f"({len(want)} bytes, slice types "
          f"{''.join(e.slice_type for e in cefs)}) == HevcEncoder, "
          "app_decoder -md5 1 == encoder md5s", flush=True)
    return dict(bframe_fps=bframe_fps, bframe_decode_fps=bframe_decode_fps)


def fade_frames(yuv, n: int) -> list:
    """bench.py's synthetic frames with the luma 5% darker each frame, a
    fade that explicit weighted prediction codes."""
    from ks265codec_tpu_torch.utils.yuv import YUVFrame
    return [YUVFrame(np.clip(np.rint(f.y * 0.95 ** t), 0, 255)
                     .astype(np.uint8), f.u, f.v, poc=t)
            for t, f in enumerate(yuv[:n])]


def aqwp_path(yuv, card: str, check_counts, rows: dict) -> dict:
    """Phase 15, cu_qp_delta (AQ, CU-tree, K17's effective-QP chain) and
    explicit weighted prediction on a luma fade: (a) a 9-frame encode of
    the VOD configuration (fast, offline GOP-8, QP 27, cutree, aq_mode 2,
    weightp) on the kernels records the lookahead's and K17's inputs; K12
    with the variance, K17 with the chain and weights and K14 weighted on
    the first P picture with weights, the chain alone on its levels and
    K17 on the first B picture under cu_qp_delta are held against their
    plain versions; (b) the same 9 frames on the plain versions give the
    same stream and recons; (c) 17 frames timed with the launch counts
    reset, then the card's decode of that stream, timed, with the
    encoder's md5s, and K18 weighted against its plain version; (d) the
    live configuration (fast, zerolatency, QP 30, intra_period 0,
    aq_mode 1, weightp) on 16 frames, timed, and decoded; (e) all-intra
    AQ (fast, aq_mode 1, tiles 8x6) on 4 frames against the plain
    versions and decoded; (f) app_encoder -preset fast -aq 2 and
    app_decoder. Adds the rows to `rows`; returns the legs' fps."""
    from ks265codec_tpu_torch.cli import app_decoder, app_encoder
    from ks265codec_tpu_torch.decode.decoder import HevcDecoder
    from ks265codec_tpu_torch.encode import encoder as tenc
    from ks265codec_tpu_torch.encode.config import EncoderConfig
    from ks265codec_tpu_torch.encode.encoder import HevcEncoder
    from ks265codec_tpu_torch.ops import _build
    from ks265codec_tpu_torch.ops import intercode as tic
    from ks265codec_tpu_torch.ops import lookahead as tla
    from ks265codec_tpu_torch.ops import wavefront as wf
    from ks265codec_tpu_torch.ops.mc import (mc_planes_cuda, mc_planes_plain,
                                             no_l1)
    fade = fade_frames(yuv, AQWP_FRAMES)
    seen = {"weighted": 0}
    wp_fn = tenc.decide_weightp

    def wp_spy(*a):
        w = wp_fn(*a)
        seen["weighted"] += w is not None
        return w

    def encode(cfg, frames_in, reference=False):
        enc = HevcEncoder(EncoderConfig(**cfg), reference=reference)
        efs = []
        for fr in frames_in:
            efs += enc.encode_frame(fr)
        efs += enc.flush()
        seen["enc"] = enc
        return efs

    def nonzero_dqp(enc):
        return int(sum((fa.dqp_ctu != 0).sum()
                       for fa in enc.la.analyses.values()
                       if fa.dqp_ctu is not None))

    def row(*a, **k):
        return table_row(rows, *a, **k)

    def decode(stream, n, what, enc_md5):
        """A recording decode (K18's inputs), then the timed one."""
        k18_calls, k18_fn = [], wf.recon_inter_filter

        def k18_spy(*a, **k):
            k18_calls.append((a, k))
            return k18_fn(*a, **k)

        wf.recon_inter_filter = k18_spy
        try:
            HevcDecoder().decode_all(stream)
        finally:
            wf.recon_inter_filter = k18_fn
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        dec = HevcDecoder()
        out = dec.decode_all(stream)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(_build.launches)
        if dec.fast_pictures != n or len(out) != n:
            raise AssertionError(f"{what} decode: {dec.fast_pictures} of "
                                 f"{len(out)} pictures took the fast paths")
        check_k11_launches(counts, n, 1, f"{what} decode")
        if md5s(out) != enc_md5:
            raise AssertionError(f"{what} decode: frames differ from the "
                                 "encoder's reconstruction")
        return n / secs, counts, k18_calls

    # ---- 15a: the kernels on the inputs the 9-frame VOD encode gives them
    calls = {}
    spied = [(tla, "frame_features_batch"), (tic, "code_inter_frame"),
             (tic, "effective_qp4")]
    saved = [(m, name, getattr(m, name)) for m, name in spied]

    def spy(name, fn):
        def g(*a, **k):
            out = fn(*a, **k)
            # the chain's output too: the QPs K7 read
            calls.setdefault(name, []).append(
                (a, k, out) if name == "effective_qp4" else (a, k))
            return out
        return g

    for m, name, fn in saved:
        setattr(m, name, spy(name, fn))
    tenc.decide_weightp = wp_spy
    try:
        ka = encode(AQWP_VOD, fade[:9])
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
        tenc.decide_weightp = wp_fn
    torch.cuda.synchronize()
    weighted9, dqp9 = seen["weighted"], nonzero_dqp(seen["enc"])
    code = calls["code_inter_frame"]
    moved9 = sum(int((out.cpu().int() != a[0].cpu().int()).sum())
                 for a, _, out in calls["effective_qp4"])

    # K12 with the variance, on the lookahead's largest batch
    a, k = max(calls["frame_features_batch"], key=lambda c: c[0][0].shape[0])
    curs, prevs, want_var, want_tree = a
    if not (want_var and want_tree):
        raise AssertionError("the VOD lookahead ran without the variance or "
                             "the tree maps")
    vk, vp = tla.block_var_cuda(curs), tla.block_var_plain(curs)
    pk = tla.frame_features_batch(curs, prevs, True, True)
    pp = tla.frame_features_batch(curs, prevs, True, True, reference=True)
    torch.cuda.synchronize()
    if not torch.equal(vk.cpu(), vp.cpu()) or not torch.equal(pk.cpu(),
                                                              pp.cpu()):
        raise AssertionError("K12 variance: kernel and plain differ")
    ms = cuda_ms(lambda: tla.block_var_cuda(curs))
    plain = cuda_ms(lambda: tla.block_var_plain(curs), warm=False)
    nb = curs.numel() // 64
    # bytes: the half planes in, the float32 map out; operations: per
    # sample the integer sum (int32), the float32 subtraction and fused
    # multiply-add, and per block the 7 lane additions and the scaling
    bnd, by = row("lookahead_var", "lookahead.cu", "ops/lookahead.py:33",
                  max_abs_err(vk, vp), ms, plain, curs.numel() + 4 * nb,
                  curs.numel(), ["la_var"], fp_ops=2 * curs.numel() + 9 * nb)
    print(f"phase K12 variance ({tuple(curs.shape)} half planes, {nb} "
          f"blocks): map and packed rows equal, kernel {ms:.3f} ms, plain "
          f"{plain:.3f} ms, bound {bnd:.4f} ms ({by})", flush=True)

    # K17 with the chain and weights, on the first P picture with weights
    wpi = [(a, k) for a, k in code if k.get("wts0") is not None
           and np.asarray(k["wts0"][0]).any()]
    if not wpi:
        raise AssertionError("no P picture of the VOD fade carried weights")
    a, k = wpi[0]
    if k.get("dqp") is None:
        raise AssertionError("the weighted P picture ran without the chain")
    gk, gp = k17_outputs(a, k, "K17 inter code (weights, cu_qp_delta)")
    qp4 = a[8]
    pic_w, pic_h = a[12:14]
    zin4, zcu4, sqp, wpp, cs = k["dqp"]
    ek = tic.effective_qp4_cuda(qp4, gk[1], zin4, zcu4, sqp, wpp, cs, pic_w,
                                pic_h)
    ep = tic.effective_qp4(qp4, gp[1], zin4, zcu4, sqp, wpp, cs, pic_w,
                           pic_h, reference=True)
    if not torch.equal(ek.cpu().int(), ep.cpu().int()):
        raise AssertionError("K17's effective-QP chain: kernel and plain "
                             "differ")
    moved = int((ep.cpu().int() != qp4.cpu().int()).sum())
    rows["inter_code_dqp_wp"], _ = inter_code_phase(
        a, k, gk, gp, "inter_code_dqp_wp",
        EFF_QP + ["inter_tu_class_k2", "inter_gate", "inter_finish",
                  "inter_bs"])
    rows["inter_code_dqp_wp"]["required"] = EFF_QP
    refs, slot0, mv0 = a[1:4]
    h8, w8 = a[10:12]
    dev = refs[0].device
    mca = (refs, slot0.to(dev), mv0.to(dev), *no_l1(slot0.to(dev),
                                                    mv0.to(dev)),
           False, h8, w8, pic_w, pic_h, k["wts0"], k["wts1"])
    mk = mc_planes_cuda(*mca)
    mp = mc_planes_plain(*refs, *mca[1:])
    for c, u, v, w in zip("YUV", mk, mp, gk[3]):
        if not torch.equal(u, v) or not torch.equal(u, w):
            raise AssertionError(f"K14 weighted: plane {c} differs")
    ms = cuda_ms(lambda: mc_planes_cuda(*mca))
    plain = cuda_ms(lambda: mc_planes_plain(*refs, *mca[1:]), warm=False)
    npx = a[0][0].numel() * 1.5
    # operations: the separable filters this motion needs, and about 6 a
    # sample for the weighted combine (multiply, round, shift, offset,
    # clip); bytes: the reference read, the prediction written, the motion
    bnd, by = row("inter_mc_wp", "inter_code.cu", "ops/mc.py:141",
                  max_abs_err(mk, mp), ms, plain, 2 * npx + 12 * h8 * w8,
                  planes_mc_ops(slot0, mv0) + 3 * npx, ["inter_mc_wp"])
    flags = np.asarray(k["wts0"][0])
    print(f"phase K14 weighted ({h8 * w8} cells, weights "
          f"{np.asarray(k['wts0'][1])[flags].tolist()} offsets "
          f"{np.asarray(k['wts0'][2])[flags].tolist()}): kernel planes == "
          f"plain == K17's prediction, kernel {ms:.3f} ms, plain "
          f"{plain:.3f} ms, bound {bnd:.4f} ms ({by}); K17's chain equal, "
          f"{moved} cells off their planned QP", flush=True)
    bq = [(a, k) for a, k in code if k.get("has_l1")
          and k.get("dqp") is not None]
    if not bq:
        raise AssertionError("no B picture ran under cu_qp_delta")
    k17_outputs(*bq[0], "K17 inter code (B, cu_qp_delta)")
    print("phase K17 (B, cu_qp_delta): recon, levels, SAO parameters and "
          "prediction of the first B picture equal", flush=True)

    # ---- 15b: the same 9 frames on the plain versions
    kb = encode(AQWP_VOD, fade[:9], reference=True)
    if b"".join(e.data for e in ka) != b"".join(e.data for e in kb) or \
            md5s(e.recon for e in ka) != md5s(e.recon for e in kb):
        raise AssertionError("9-frame VOD fade stream or recon: kernels and "
                             "plain versions differ")
    print(f"phase AQ/WP kernels vs plain stream: 9 frames "
          f"({sum(len(e.data) for e in ka)} bytes, slice types "
          f"{''.join(e.slice_type for e in ka)}) identical, recon md5s "
          f"equal; {weighted9} pictures with weights, {dqp9} CTBs with a "
          f"nonzero offset, {moved9} cells moved by the chain", flush=True)
    if not (weighted9 > 0 and dqp9 > 0 and moved9 > 0):
        raise AssertionError("the VOD fade engaged no weights, no offsets or "
                             "no chain move")

    # ---- 15c: the timed VOD leg (the 9-frame encode was its warm-up), then
    # its decode on the card
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    aefs = encode(AQWP_VOD, fade)
    torch.cuda.synchronize()
    asecs = time.perf_counter() - t0
    acounts = dict(_build.launches)
    for key in ("lookahead_var", "inter_code_dqp_wp", "inter_mc_wp"):
        rows[key]["launches"] = check_counts(rows[key]["required"], acounts,
                                             "AQ/WP VOD path")
    check_counts(["decide_pass_a", "intra_level_k2", "deblock_edges",
                  "sao_stats", "sao_apply", "la_features", "me_bi_cost8",
                  "inter_decide", "inter_mc_bi", "sao_decide"], acounts,
                 "AQ/WP VOD path")
    arec = sorted(aefs, key=lambda e: e.display_idx)
    astream = b"".join(e.data for e in aefs)
    aq_wp_bframe_fps = len(aefs) / asecs
    print(f"phase AQ/WP VOD path: {len(aefs)} frames {W}x{H} (fast offline "
          f"QP 27, cutree, aq_mode 2, weightp, luma fade) in {asecs:.3f} s "
          f"= {aq_wp_bframe_fps:.3f} fps on {card}; stream {len(astream)} "
          f"bytes; slice types {''.join(e.slice_type for e in aefs)}; "
          f"launches {acounts}", flush=True)
    fps_d, dcounts, k18_calls = decode(astream, AQWP_FRAMES, "AQ/WP VOD",
                                       md5s(e.recon for e in arec))
    check_counts(["inter_mc_wp", "inter_mc_bi", "inter_recon",
                  "inter_recon_wp"], dcounts,
                 "AQ/WP VOD decode")
    print(f"phase AQ/WP VOD decode: {AQWP_FRAMES} frames in "
          f"{AQWP_FRAMES / fps_d:.3f} s = {fps_d:.3f} fps on {card}; all "
          f"through the fast paths, md5 equal to the encoder's recon; "
          f"launches {dcounts}", flush=True)
    rows["inter_recon_wp"] = k18_phase(k18_calls, card, wp=True)
    rows["inter_recon_wp"]["launches"] = dcounts["inter_recon_wp"]

    # ---- 15d: the live leg (low-delay P, aq_mode 1, weightp)
    encode(AQWP_LIVE, fade[:4])                          # warm-up
    seen["weighted"] = 0
    tenc.decide_weightp = wp_spy
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    try:
        befs = encode(AQWP_LIVE, fade[:AQWP_LIVE_FRAMES])
    finally:
        tenc.decide_weightp = wp_fn
    torch.cuda.synchronize()
    bsecs = time.perf_counter() - t0
    bcounts = dict(_build.launches)
    check_counts(["la_var", "inter_mc_wp"] + EFF_QP, bcounts,
                 "AQ/WP live path")
    weighted_b, dqp_b = seen["weighted"], nonzero_dqp(seen["enc"])
    bstream = b"".join(e.data for e in befs)
    aq_wp_ippp_fps = len(befs) / bsecs
    print(f"phase AQ/WP live path: {len(befs)} frames {W}x{H} (fast "
          f"zerolatency QP 30, aq_mode 1, weightp, luma fade) in "
          f"{bsecs:.3f} s = {aq_wp_ippp_fps:.3f} fps on {card}; stream "
          f"{len(bstream)} bytes; {weighted_b} pictures with weights, "
          f"{dqp_b} CTBs with a nonzero offset; launches {bcounts}",
          flush=True)
    if not (weighted_b > 0 and dqp_b > 0):
        raise AssertionError("the live fade engaged no weights or offsets")
    fps_bd, bdcounts, _ = decode(bstream, AQWP_LIVE_FRAMES, "AQ/WP live",
                                 md5s(e.recon for e in befs))
    check_counts(["inter_mc_wp", "inter_recon_wp"], bdcounts, "AQ/WP live "
                 "decode")
    print(f"phase AQ/WP live decode: {AQWP_LIVE_FRAMES} frames = "
          f"{fps_bd:.3f} fps on {card}, md5 equal to the encoder's recon; "
          f"launches {bdcounts}", flush=True)

    # ---- 15e: all-intra AQ (the batch path with per-CTB QPs and the
    # effective QPs of the host walk), against the plain versions
    _build.reset_launches()
    cefs = encode(AQWP_INTRA, fade[:4])
    ccounts = dict(_build.launches)
    check_counts(["la_var", "decide_pass_a", "intra_level_k2"], ccounts,
                 "AQ all-intra")
    dqp_c = nonzero_dqp(seen["enc"])
    cp = encode(AQWP_INTRA, fade[:4], reference=True)
    cstream = b"".join(e.data for e in cefs)
    if cstream != b"".join(e.data for e in cp) or \
            md5s(e.recon for e in cefs) != md5s(e.recon for e in cp):
        raise AssertionError("all-intra AQ: kernels and plain versions "
                             "differ")
    cdec = HevcDecoder()
    if md5s(cdec.decode_all(cstream)) != md5s(e.recon for e in cefs) or \
            cdec.fast_pictures != 4:
        raise AssertionError("all-intra AQ decode: md5s differ from the "
                             "encoder's")
    print(f"phase AQ all-intra: 4 frames (fast, aq_mode 1, tiles 8x6, "
          f"{len(cstream)} bytes, {dqp_c} CTBs with a nonzero offset) "
          f"kernel stream == plain, decoded on the card with the encoder's "
          f"md5s", flush=True)
    if dqp_c <= 0:
        raise AssertionError("all-intra AQ engaged no offsets")

    # ---- 15f: the CLIs with -aq 2
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
    work.mkdir(parents=True, exist_ok=True)
    try:
        (work / "in.yuv").write_bytes(b"".join(f.tobytes()
                                               for f in fade[:4]))
        argv = ["-i", str(work / "in.yuv"), "-wdt", str(W), "-hgt", str(H),
                "-frms", "4", "-b", str(work / "aq.265"), "-preset", "fast",
                "-aq", "2", "-qp", "27", "-fr", "30"]
        _build.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = app_encoder.main(argv)
        check_counts(["la_var"] + EFF_QP, _build.launches,
                     "app_encoder -aq 2")
        ccfg = app_encoder.cfg_from_args(
            app_encoder.build_parser().parse_args(argv))
        enc = HevcEncoder(ccfg)
        if not enc.pps.cu_qp_delta_enabled:
            raise AssertionError("app_encoder -aq 2: cu_qp_delta off")
        qefs = []
        for fr in fade[:4]:
            qefs += enc.encode_frame(fr)
        qefs += enc.flush()
        want = b"".join(e.data for e in qefs)
        if rc != 0 or (work / "aq.265").read_bytes() != want:
            raise AssertionError("app_encoder -aq 2: bytes differ from "
                                 "HevcEncoder's")
        want_md5 = [",".join(m) for m in md5s(
            e.recon for e in sorted(qefs, key=lambda e: e.display_idx))]
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = app_decoder.main(["-b", str(work / "aq.265"), "-md5", "1"])
        dec_lines = [ln.split()[3] for ln in out.getvalue().splitlines()
                     if ln.startswith("POC ")]
        if rc != 0 or dec_lines != want_md5:
            raise AssertionError("app_decoder -md5 1 (-aq 2): lines differ "
                                 "from the encoder's md5s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase CLI AQ: app_encoder -preset fast -aq 2 4 frames "
          f"({len(want)} bytes) == HevcEncoder, app_decoder -md5 1 == "
          "encoder md5s", flush=True)
    return dict(aq_wp_bframe_fps=aq_wp_bframe_fps,
                aq_wp_bframe_decode_fps=fps_d,
                aq_wp_ippp_fps=aq_wp_ippp_fps,
                aq_wp_ippp_decode_fps=fps_bd)


def medium_path(yuv, card: str, check_counts, rows: dict) -> dict:
    """Phase 16, the medium preset (EncoderConfig's defaults) on the luma
    fade: (a) 9 frames on the kernels against the plain versions (stream
    and recons); (b) 17 frames timed with the launch counts reset (the
    NxN tier on the IDR); (c) the card's decode of that stream, timed:
    every picture through the fast paths, the encoder's md5s; (d) medium
    all-intra AQ on 4 frames (the tier on every frame) against the plain
    versions and decoded on the card; (e) app_encoder with its defaults
    (no -preset, no -rc) on 10 frames and app_decoder -md5 1 on the card.
    Returns the legs' fps."""
    from ks265codec_tpu_torch.cli import app_decoder, app_encoder
    from ks265codec_tpu_torch.decode.decoder import HevcDecoder
    from ks265codec_tpu_torch.encode.config import EncoderConfig
    from ks265codec_tpu_torch.encode.encoder import HevcEncoder
    from ks265codec_tpu_torch.ops import _build
    fade = fade_frames(yuv, MEDIUM_FRAMES)

    def encode(cfg, frames_in, reference=False):
        enc = HevcEncoder(EncoderConfig(**cfg), reference=reference)
        efs = []
        for fr in frames_in:
            efs += enc.encode_frame(fr)
        return efs + enc.flush(), enc

    # ---- 16a: 9 frames on the kernels (the warm-up) and on the plain
    # versions
    ka, enc = encode(MEDIUM, fade[:9])
    if not (enc.cfg.preset == "medium" and enc.cfg.intra_nxn
            and enc.sps.max_transform_hierarchy_depth_intra == 1):
        raise AssertionError("EncoderConfig's defaults: not medium with NxN "
                             "and the intra TU-split flag")
    kb, _ = encode(MEDIUM, fade[:9], reference=True)
    if b"".join(e.data for e in ka) != b"".join(e.data for e in kb) or \
            md5s(e.recon for e in ka) != md5s(e.recon for e in kb):
        raise AssertionError("9-frame medium stream or recon: kernels and "
                             "plain versions differ")
    print(f"phase medium kernels vs plain stream: 9 frames "
          f"({sum(len(e.data) for e in ka)} bytes, slice types "
          f"{''.join(e.slice_type for e in ka)}) identical, recon md5s "
          "equal", flush=True)

    # ---- 16b: the timed encode
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    mefs, _ = encode(MEDIUM, fade)
    torch.cuda.synchronize()
    msecs = time.perf_counter() - t0
    mcounts = dict(_build.launches)
    rows["decide_nxn"]["launches"] = check_counts(
        rows["decide_nxn"]["counters"], mcounts, "medium path")
    check_counts(["decide_pass_a", "intra_level_k2", "deblock_edges",
                  "sao_stats", "sao_apply", "la_features", "me_bi_cost8",
                  "inter_decide", "inter_mc_bi", "sao_decide"] + EFF_QP,
                 mcounts, "medium path")
    mstream = b"".join(e.data for e in mefs)
    mrec = sorted(mefs, key=lambda e: e.display_idx)
    medium_fps = len(mefs) / msecs
    print(f"phase medium path: {len(mefs)} frames {W}x{H} (EncoderConfig's "
          f"defaults: medium offline QP 26, luma fade) in {msecs:.3f} s = "
          f"{medium_fps:.3f} fps on {card}; stream {len(mstream)} bytes; "
          f"slice types {''.join(e.slice_type for e in mefs)}; launches "
          f"{mcounts}", flush=True)

    # ---- 16c: the card decode
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    dec = HevcDecoder()
    out = dec.decode_all(mstream)
    torch.cuda.synchronize()
    dsecs = time.perf_counter() - t0
    dcounts = dict(_build.launches)
    if dec.fast_pictures != MEDIUM_FRAMES or len(out) != MEDIUM_FRAMES:
        raise AssertionError(f"medium decode: {dec.fast_pictures} of "
                             f"{len(out)} pictures took the fast paths")
    check_k11_launches(dcounts, MEDIUM_FRAMES, 1, "medium decode")
    if md5s(out) != md5s(e.recon for e in mrec):
        raise AssertionError("medium decode: frames differ from the "
                             "encoder's reconstruction")
    check_counts(["intra_recon", "inter_recon", "inter_mc_bi",
                  "deblock_edges", "sao_apply"], dcounts, "medium decode")
    medium_decode_fps = MEDIUM_FRAMES / dsecs
    print(f"phase medium decode: {MEDIUM_FRAMES} frames in {dsecs:.3f} s = "
          f"{medium_decode_fps:.3f} fps on {card}; all "
          f"{dec.fast_pictures} through the fast paths, md5 equal to the "
          f"encoder's recon; launches {dcounts}", flush=True)

    # ---- 16d: medium all-intra AQ (the NxN tier on every frame)
    _build.reset_launches()
    cefs, _ = encode(MEDIUM_INTRA, fade[:4])
    ccounts = dict(_build.launches)
    check_counts(["la_var", "decide_nxn_a", "decide_nxn_b",
                  "intra_level_k2"], ccounts, "medium all-intra AQ")
    cp, _ = encode(MEDIUM_INTRA, fade[:4], reference=True)
    cstream = b"".join(e.data for e in cefs)
    if cstream != b"".join(e.data for e in cp) or \
            md5s(e.recon for e in cefs) != md5s(e.recon for e in cp):
        raise AssertionError("medium all-intra AQ: kernels and plain "
                             "versions differ")
    cdec = HevcDecoder()
    if md5s(cdec.decode_all(cstream)) != md5s(e.recon for e in cefs) or \
            cdec.fast_pictures != 4:
        raise AssertionError("medium all-intra AQ decode: md5s differ from "
                             "the encoder's or left the fast path")
    print(f"phase medium all-intra AQ: 4 frames ({len(cstream)} bytes, NxN "
          f"tier launches {ccounts['decide_nxn_b']}) kernel stream == plain, "
          "decoded on the card through the fast path with the encoder's "
          "md5s", flush=True)

    # ---- 16e: the CLIs at their defaults (medium, fixed QP 26)
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
    work.mkdir(parents=True, exist_ok=True)
    try:
        (work / "in.yuv").write_bytes(b"".join(f.tobytes()
                                               for f in fade[:10]))
        argv = ["-i", str(work / "in.yuv"), "-wdt", str(W), "-hgt", str(H),
                "-frms", "10", "-b", str(work / "medium.265"), "-o",
                str(work / "rec.yuv")]
        _build.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = app_encoder.main(argv)
        check_counts(["decide_nxn_a", "decide_nxn_b", "me_bi_cost8",
                      "inter_mc_bi"], _build.launches, "app_encoder defaults")
        rec = np.fromfile(work / "rec.yuv", np.uint8).reshape(10, -1)
        n_y = W * H
        want_md5 = [",".join(hashlib.md5(p.tobytes()).hexdigest()
                             for p in (r[:n_y], r[n_y:n_y * 5 // 4],
                                       r[n_y * 5 // 4:])) for r in rec]
        _build.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc_d = app_decoder.main(["-b", str(work / "medium.265"), "-md5",
                                     "1"])
        check_counts(["intra_recon", "inter_recon"], _build.launches,
                     "app_decoder (medium)")
        dec_lines = [ln.split()[3] for ln in out.getvalue().splitlines()
                     if ln.startswith("POC ")]
        if rc != 0 or rc_d != 0 or dec_lines != want_md5:
            raise AssertionError("app_encoder defaults / app_decoder -md5 1: "
                                 "md5 lines differ from the encoder's recon")
        nbytes = (work / "medium.265").stat().st_size
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase CLI medium: app_encoder with its defaults (medium, -rc 0, "
          f"QP 26) 10 frames ({nbytes} bytes), app_decoder -md5 1 on the "
          "card == the encoder's recon md5s", flush=True)
    return dict(medium_fps=medium_fps, medium_decode_fps=medium_decode_fps)


def _recording(module, name: str, calls: list):
    """Wrap module.name so that each call's tensor arguments (cloned) and
    keyword arguments are appended to `calls`; returns the undo."""
    orig = getattr(module, name)

    def spy(*a, **k):
        calls.append(([x.clone() if torch.is_tensor(x) else x for x in a],
                      dict(k)))
        return orig(*a, **k)

    setattr(module, name, spy)
    return lambda: setattr(module, name, orig)


def crop_frames(yuv, n: int, w: int, h: int) -> list:
    """A w x h window of bench.py's synthetic frames over the moving
    disc's path."""
    from ks265codec_tpu_torch.utils.yuv import YUVFrame
    y0 = min(200, yuv[0].y.shape[0] - h)
    x0 = min(240, yuv[0].y.shape[1] - w)
    return [YUVFrame(f.y[y0:y0 + h, x0:x0 + w].copy(),
                     f.u[y0 // 2:(y0 + h) // 2, x0 // 2:(x0 + w) // 2].copy(),
                     f.v[y0 // 2:(y0 + h) // 2, x0 // 2:(x0 + w) // 2].copy(),
                     poc=i) for i, f in enumerate(yuv[:n])]


def grid_cost(calls) -> tuple[float, float]:
    """(bytes, int32 operations) of K20 calls: blocks, windows read and
    the grid written once; per offset and sample a subtract, an absolute
    value and an add."""
    nbytes = ops = 0.0
    for (src, win, bs, sr), _ in calls:
        n, n_off = src.shape[0], 2 * sr + 1
        nbytes += 4 * n * (bs * bs + win.shape[1] * win.shape[2]
                           + n_off * n_off)
        ops += 3.0 * n * n_off * n_off * bs * bs
    return nbytes, ops


def satd_pred_ops(mv, bs: int) -> float:
    """Operations of one bs x bs prediction at quarter-pel motion mv (the
    separable filter this phase needs, mc_ops) and its SATD against the
    source (the rounding combine 3, the difference 1, the 8x8 Hadamard
    about 6, a sample)."""
    return float(mc_ops(mv, bs, True).sum()) + 10.0 * bs * bs * mv.shape[0]


def walk_kernel_phases(yuv, dev, card: str) -> dict:
    """K20 and K21 against their plain versions at 720p on the inputs the
    `slower` walk gives them for frame 1 (against frame 0; frame 2 as the
    second list of the bi cost): every grid of the hierarchical route
    (me 2, merange 64) and of the +-16 full-resolution route at bs 16
    and 8, the 49 quarter-pel candidates and the bi cost at bs 16 and 8.
    Returns their table rows."""
    from ks265codec_tpu_torch.encode.inter_frame import mv_pred_field
    from ks265codec_tpu_torch.encode.intra_frame import pad_plane
    from ks265codec_tpu_torch.ops import me as tme
    from ks265codec_tpu_torch.ops import subpel as tsp
    rows: dict = {}
    h, w = yuv[0].y.shape
    ph, pw = (h + 63) // 64 * 64, (w + 63) // 64 * 64
    src, ref0, ref1 = (pad_plane(yuv[i].y, ph, pw) for i in (1, 0, 2))
    lam = float(np.sqrt(0.85 * 2.0 ** ((27 - 12) / 3.0)))   # QP 27
    kw = dict(device=dev)

    # ---- K20: the grids of both routes, recorded from the searches
    routes = {}
    for route, run in (
            ("hier", lambda bs: tme.motion_search_frame_hier(
                src, ref0, bs, 64, lam if bs == 16 else 0.5 * lam, **kw)),
            ("sr16", lambda bs: tme.motion_search_frame(
                src, ref0, bs, 16, lam if bs == 16 else 0.5 * lam, **kw))):
        calls: list = []
        undo = _recording(tme, "full_search_grid", calls)
        try:
            res = {bs: run(bs) for bs in (16, 8)}
        finally:
            undo()
        routes[route] = (calls, res)
    err, tk, tp, tl = 0.0, 0.0, 0.0, 0.0
    lib_err = 0.0
    per_route = {}
    for route, (calls, _) in routes.items():
        rk = rp = rl = 0.0
        for (s, win, bs, sr), _ in calls:
            got = tme.full_search_grid(s, win, bs, sr)
            want = tme.full_search_grid(s, win, bs, sr, reference=True)
            err = max(err, max_abs_err(got, want))

            def library(s=s, win=win, bs=bs):
                patches = torch.nn.functional.unfold(
                    win[:, None].float(), bs).transpose(1, 2)
                return torch.cdist(patches, s.reshape(s.shape[0], 1, -1)
                                   .float(), p=1)

            lib_err = max(lib_err, max_abs_err(
                library().reshape(got.shape).round().to(torch.int32), got))
            rk += cuda_ms(lambda: tme.full_search_grid(s, win, bs, sr))
            rp += cuda_ms(lambda: tme.full_search_grid(s, win, bs, sr,
                                                       reference=True),
                          reps=3)
            rl += cuda_ms(library, reps=3)
        per_route[route] = (rk, rp, rl, grid_cost(calls), len(calls))
    hk, hp, hl, (hb, ho), hn = per_route["hier"]
    sk, sp, sl, (sb, so), sn = per_route["sr16"]
    if err or lib_err:
        raise AssertionError(f"K20: kernel / library differ from the plain "
                             f"version ({err}, {lib_err})")
    bnd, by = table_row(rows, "me_full_grid", "me_full.cu",
                        "ops/me.py:122", err, hk, hp, hb, ho,
                        ["me_full_grid"])
    rows["me_full_grid"]["library_ms"] = hl
    sbnd, sby = bound_ms(sb, so)
    print(f"phase K20 full-search grid ({w}x{h} frame 1 vs 0, QP 27): the "
          f"hierarchical route's {hn} grids (bs 16 and 8: quarter "
          f"resolution +-16, half and full resolution +-3) equal the plain "
          f"version and the library's unfold + cdist(p=1) (max err "
          f"{err}, {lib_err}); kernel {hk:.3f} ms (bound {bnd:.4f} ms, "
          f"{by}), plain {hp:.3f} ms, unfold + cdist {hl:.3f} ms; the "
          f"+-16 full-resolution route's {sn} grids: kernel {sk:.3f} ms "
          f"(bound {sbnd:.4f} ms, {sby}), plain {sp:.3f} ms, unfold + "
          f"cdist {sl:.3f} ms; on {card}", flush=True)

    # ---- K21: quarter-pel costs at bs 16 and 8 on each list's winners,
    # and the bi cost of both lists' refined motion
    mv = {}
    calls = []
    undo = _recording(tsp, "subpel_costs", calls)
    try:
        for li, ref in ((0, ref0), (1, ref1)):
            for bs in (16, 8):
                m, _, _ = (routes["hier"][1][bs] if li == 0 else
                           tme.motion_search_frame_hier(
                               src, ref, bs, 64,
                               lam if bs == 16 else 0.5 * lam, **kw))
                mv[li, bs], _ = tsp.refine_subpel_frame(
                    src, ref, m >> 2, bs, w, h,
                    mv_pred_q=mv_pred_field(m),
                    lam=lam if bs == 16 else 0.5 * lam, **kw)
    finally:
        undo()
    bcalls: list = []
    undo = _recording(tsp, "bi_cost", bcalls)
    try:
        for bs in (16, 8):
            tsp.bi_pred_cost(src, ref0, ref1, mv[0, bs], mv[1, bs], bs, w, h,
                             **kw)
    finally:
        undo()
    serr = berr = 0.0
    sk = sp = bk = bp = 0.0
    s_ops = s_bytes = b_ops = b_bytes = 0.0
    for (win, s, bs), _ in calls[:2]:     # list 0, bs 16 and 8
        serr = max(serr, max_abs_err(tsp.subpel_costs(win, s, bs),
                                     tsp.subpel_costs(win, s, bs,
                                                      reference=True)))
        sk += cuda_ms(lambda: tsp.subpel_costs(win, s, bs))
        sp += cuda_ms(lambda: tsp.subpel_costs(win, s, bs, reference=True),
                      reps=3)
        n = s.shape[0]
        cand = torch.as_tensor(tsp.SUBPEL_CANDS).repeat(n, 1)
        s_ops += satd_pred_ops(cand, bs)
        s_bytes += 4 * n * (win.shape[1] * win.shape[2] + bs * bs + 49)
    for (w0, w1, m0, m1, s, bs), _ in bcalls:
        berr = max(berr, max_abs_err(
            tsp.bi_cost(w0, w1, m0, m1, s, bs),
            tsp.bi_cost(w0, w1, m0, m1, s, bs, reference=True)))
        bk += cuda_ms(lambda: tsp.bi_cost(w0, w1, m0, m1, s, bs))
        bp += cuda_ms(lambda: tsp.bi_cost(w0, w1, m0, m1, s, bs,
                                          reference=True), reps=3)
        # both lists' filters, then one combine and SATD a sample
        b_ops += satd_pred_ops(m0, bs) + float(mc_ops(m1, bs, True).sum())
        n = s.shape[0]
        b_bytes += 4 * n * (2 * w0.shape[1] * w0.shape[2] + 4 + bs * bs + 1)
    if serr or berr:
        raise AssertionError(f"K21: kernel differs from the plain version "
                             f"({serr}, {berr})")
    sbnd, sby = table_row(rows, "subpel_costs", "subpel.cu",
                          "ops/subpel.py:85", serr, sk, sp, s_bytes, s_ops,
                          ["subpel_costs"])
    bbnd, bby = table_row(rows, "subpel_bi_cost", "subpel.cu",
                          "ops/subpel.py:98", berr, bk, bp, b_bytes, b_ops,
                          ["subpel_bi_cost"])
    print(f"phase K21 quarter-pel ({w}x{h} frame 1 vs 0, bs 16 + 8, "
          f"{calls[0][0][1].shape[0]} + {calls[1][0][1].shape[0]} blocks x "
          f"49 candidates): kernel == plain, {sk:.3f} ms (bound "
          f"{sbnd:.4f} ms, {sby}), plain {sp:.3f} ms; bi cost (frame 0 and "
          f"2, bs 16 + 8): kernel == plain, {bk:.3f} ms (bound {bbnd:.4f} "
          f"ms, {bby}), plain {bp:.3f} ms; on {card}", flush=True)
    return rows


def walk_path(yuv, card: str, check_counts, rows: dict) -> dict:
    """Phase 17, the presets whose P and B pictures take the host walk:
    (a) K20 and K21 against their plain versions at 720p; (b) the
    `slower` leg (1280x720, QP 27, offline, 9 frames) timed with the
    launch counts reset, luma PSNR > 30 dB, decoded on the CPU (the host
    scalar decode: the card's fast parse aborts on inter TU splits) to
    the encoder's md5s; (c) the `slower_ldp` leg (zerolatency, refs=2, 5
    frames) timed; (d) both configurations at 416x240 on the kernels
    against the plain versions, stream and recons, decoded on the CPU.
    Returns the legs' fps."""
    from ks265codec_tpu_torch.decode.decoder import HevcDecoder
    from ks265codec_tpu_torch.encode.config import EncoderConfig
    from ks265codec_tpu_torch.encode.encoder import HevcEncoder
    from ks265codec_tpu_torch.ops import _build
    dev = torch.device("cuda")
    rows.update(walk_kernel_phases(yuv, dev, card))

    def encode(cfg, frames_in, reference=False):
        enc = HevcEncoder(EncoderConfig(**cfg), reference=reference)
        efs = []
        for fr in frames_in:
            efs += enc.encode_frame(fr)
        return efs + enc.flush()

    def psnr_y(efs, frames_in):
        mse = np.mean([np.mean((e.recon.y.astype(np.float64)
                                - frames_in[e.display_idx].y) ** 2)
                       for e in efs])
        return 10 * np.log10(255.0 ** 2 / mse)

    out = {}
    for leg, cfg, n in (("slower", SLOWER, SLOWER_FRAMES),
                        ("slower_ldp", SLOWER_LDP, SLOWER_LDP_FRAMES)):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        efs = encode(cfg, yuv[:n])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(_build.launches)
        need = ["me_full_grid", "subpel_costs", "decide_pass_b", "sao_stats"]
        if leg == "slower":
            need.append("subpel_bi_cost")
            for key in WALK_ROWS:
                rows[key]["launches"] = check_counts(
                    rows[key]["counters"], counts, "slower path")
        check_counts(need, counts, f"{leg} path")
        psnr = psnr_y(efs, yuv)
        if psnr <= 30.0:
            raise AssertionError(f"{leg}: luma PSNR {psnr:.2f} dB")
        stream = b"".join(e.data for e in efs)
        out[f"{leg}_fps"] = len(efs) / secs
        line = (f"phase {leg} path: {len(efs)} frames {W}x{H} "
                f"({cfg['preset']} {cfg.get('latency', 'offline')} QP 27"
                f"{', refs 2' if leg == 'slower_ldp' else ''}) in "
                f"{secs:.3f} s = {len(efs) / secs:.3f} fps on {card}; "
                f"stream {len(stream)} bytes; slice types "
                f"{''.join(e.slice_type for e in efs)}; luma PSNR "
                f"{psnr:.2f} dB; launches {counts}")
        if leg == "slower":
            t0 = time.perf_counter()
            dec = HevcDecoder(device="cpu")
            dec_md5 = md5s(dec.decode_all(stream))
            dsecs = time.perf_counter() - t0
            if dec_md5 != md5s(e.recon for e in sorted(
                    efs, key=lambda e: e.display_idx)):
                raise AssertionError("slower: the CPU decode differs from "
                                     "the encoder's recon")
            line += (f"; host scalar decode (the CPU decoder, "
                     f"{dec.fast_pictures} of {len(efs)} pictures on its "
                     f"fast path) in {dsecs:.3f} s, md5s equal to the "
                     "encoder's recon")
        print(line, flush=True)

    # ---- 17d: stream identity at 416x240, kernels against plain versions
    small = crop_frames(yuv, SLOWER_FRAMES, WALK_W, WALK_H)
    for leg, cfg, n in (("slower", SLOWER, SLOWER_FRAMES),
                        ("slower_ldp", SLOWER_LDP, SLOWER_LDP_FRAMES)):
        c = dict(cfg, width=WALK_W, height=WALK_H)
        a = encode(c, small[:n])
        b = encode(c, small[:n], reference=True)
        sa = b"".join(e.data for e in a)
        if sa != b"".join(e.data for e in b) or \
                md5s(e.recon for e in a) != md5s(e.recon for e in b):
            raise AssertionError(f"{leg} {WALK_W}x{WALK_H}: kernels and "
                                 "plain versions differ")
        dec = HevcDecoder(device="cpu")
        if md5s(dec.decode_all(sa)) != md5s(
                e.recon for e in sorted(a, key=lambda e: e.display_idx)):
            raise AssertionError(f"{leg} {WALK_W}x{WALK_H}: the CPU decode "
                                 "differs from the encoder's recon")
        print(f"phase {leg} kernels vs plain stream: {n} frames "
              f"{WALK_W}x{WALK_H} ({len(sa)} bytes, slice types "
              f"{''.join(e.slice_type for e in a)}) identical, recon md5s "
              "equal, CPU decode == encoder md5s", flush=True)
    return out


def check_k11_launches(counts: dict, pictures: int, intra_pictures: int,
                       what: str) -> None:
    """K11 is one launch per decoded picture that holds intra CUs: exactly
    one for each I picture, at most one for each P or B picture."""
    k = counts.get("intra_recon", 0)
    if not intra_pictures <= k <= pictures:
        raise AssertionError(f"{what}: {k} K11 launches for {pictures} "
                             f"pictures ({intra_pictures} I), not one a "
                             "picture")


def k5_tier_phase(src, dargs, effort: int) -> list:
    """K5's pass A and pass B of each tier (16, then 8 and 32, seeded from
    the 16 tier at effort 0) timed apart with CUDA events on the 16-frame
    720p batch at `effort`, each beside its bound. Returns one dict per
    tier and pass."""
    from ks265codec_tpu_torch.ops import decide as dcd
    F, ph, pw = src[0].shape
    qp, qpc, lam, ls = dargs
    out, mode16 = [], None
    for n in (16, 8, 32):
        seed = mode16 if n != 16 and not effort else None
        nb = F * (ph // n) * (pw // n)
        nc, cands = n // 2, (7 if seed is not None else 35)
        satd, best0 = dcd.decide_pass_a_cuda(src[0], n, seed)
        for what, a, b in zip(("satd", "best0"), (satd, best0),
                              dcd.pass_a_plain(src[0], n, seed)):
            if not torch.equal(a, b):
                raise AssertionError(f"K5 pass A (tier {n}, effort "
                                     f"{effort}): {what} differs from "
                                     "pass_a_plain")
        ta = cuda_ms(lambda: dcd.decide_pass_a_cuda(src[0], n, seed))
        res = dcd.decide_pass_b_cuda(*src, satd, best0, seed, *dargs, n,
                                     effort)
        tb = cuda_ms(lambda: dcd.decide_pass_b_cuda(*src, satd, best0, seed,
                                                    *dargs, n, effort))
        if n == 16:
            mode16 = res[0]
        # pass A: every candidate's prediction + 8x8 Hadamard (about 10
        # integer ops per sample and mode); bytes: the luma planes (and
        # the seed map) in, satd and best0 out. Pass B: the K candidates'
        # and the chroma blocks' forward transforms (2 stages of n
        # multiply-adds per sample, matrix form), at effort 1 the 5 chroma
        # candidates' prediction + Hadamard on both planes; bytes: the
        # planes, satd and best0 in, the three maps out
        a_ops = nb * cands * n * n * 10.0
        a_bytes = F * ph * pw + (satd.numel() + best0.numel()) * 4 + (
            seed.numel() * 4 if seed is not None else 0)
        k = 3 if effort else 1
        b_ops = nb * (k * n * n * 2 * n + 2 * nc * nc * 2 * nc
                      + (2 * 5 * nc * nc * 10 if effort else 0))
        b_bytes = F * ph * pw * 1.5 + (satd.numel() + best0.numel()) * 4 \
            + 3 * 4 * nb
        for what, ms, (bnd, by) in (("A", ta, bound_ms(a_bytes, a_ops)),
                                    ("B", tb, bound_ms(b_bytes, b_ops))):
            out.append(dict(tier=n, effort=effort, pass_=what, ms=ms,
                            bound_ms=bnd, bound_by=by))
        ba, bb = out[-2], out[-1]
        print(f"phase K5 tier {n} (effort {effort}, {F} frames): pass A "
              f"equal to pass_a_plain, {ta:.3f} ms (bound "
              f"{ba['bound_ms']:.4f}, {ba['bound_by']}), pass B {tb:.3f} ms "
              f"(bound {bb['bound_ms']:.4f}, {bb['bound_by']})", flush=True)
    return out


def k11_picture_phase(batch, sps, pps, levels, recon, tab) -> dict:
    """K11 per picture at F = 1, as the decoder runs it: each frame of the
    16-frame batch (`batch`, K6's decisions and `levels`) reconstructed
    alone through `recon_intra_frames_cuda`, equal to K6's reconstruction
    `recon` of that frame (and to the plain version on frame 0); the mean
    time and launches per picture and the per-picture bound."""
    from ks265codec_tpu_torch.ops import _build
    from ks265codec_tpu_torch.ops import wavefront as wf
    dev = levels[0].device
    strong = bool(sps.strong_intra_smoothing)
    coder = wf.WavefrontIntraCoder()
    pics = [(coder.pack([item], pps.cb_qp_offset, pps.cr_qp_offset,
                        sps).to(dev),
             [lv[f:f + 1].contiguous() for lv in levels])
            for f, item in enumerate(batch)]
    before = _build.launches.get("intra_recon", 0)
    outs = [wf.recon_intra_frames_cuda(*levs, sched, strong, tab)
            for sched, levs in pics]
    launches = (_build.launches["intra_recon"] - before) / len(pics)
    plain0 = wf.recon_intra_frames_plain(*pics[0][1], pics[0][0], strong)
    torch.cuda.synchronize()
    for f, got in enumerate(outs):
        for c, x, y in zip("YUV", got, recon):
            if not torch.equal(x[0], y[f]):
                raise AssertionError(f"K11 at F = 1: frame {f} plane {c} "
                                     "differs from K6's reconstruction")
    for c, x, y in zip("YUV", outs[0], plain0):
        if not torch.equal(x, y):
            raise AssertionError(f"K11 at F = 1: plane {c} differs from its "
                                 "plain version")

    def run():
        for sched, levs in pics:
            wf.recon_intra_frames_cuda(*levs, sched, strong, tab)

    ms = cuda_ms(run) / len(pics)
    # per picture, as the batch row counts it: the 2 inverse-transform
    # stages of n multiply-adds per sample (matrix form), luma and both
    # chroma blocks; bytes: int16 levels in, recon out
    _, ph, pw = levels[0].shape
    bnds = []
    for sched, _ in pics:
        recs = sched.recs.cpu().numpy()
        sizes = recs[recs[:, wf.VALID] == 1, wf.SIZE].astype(np.float64)
        ops = float(np.sum(sizes ** 2 * 2 * sizes
                           + 2 * (sizes / 2) ** 2 * 2 * (sizes / 2)))
        bnds.append(bound_ms(ph * pw * 1.5 * (2 + 1), ops))
    bnd = float(np.mean([b for b, _ in bnds]))
    by = bnds[0][1]
    print(f"phase K11 per picture (F = 1, {len(pics)} pictures, tiles "
          f"8x6): equal to K6's recon, {ms:.4f} ms and {launches:.2f} "
          f"launches a picture, bound {bnd:.5f} ms ({by})", flush=True)
    return dict(picture_ms=ms, picture_launches=launches,
                picture_bound_ms=bnd, picture_bound_by=by)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from ks265codec_tpu_torch.cli import app_decoder, app_encoder
    from ks265codec_tpu_torch.decode.decoder import HevcDecoder
    from ks265codec_tpu_torch.encode.config import EncoderConfig
    from ks265codec_tpu_torch.encode.encoder import HevcEncoder, sao_decisions
    from ks265codec_tpu_torch.encode.intra_frame import (decision_maps8,
                                                         pad_plane,
                                                         tile_region_maps)
    from ks265codec_tpu_torch.interop import (device_bits_table,
                                              device_tables)
    from ks265codec_tpu_torch.ops import _build
    from ks265codec_tpu_torch.ops import deblock as dbk
    from ks265codec_tpu_torch.ops import decide as dcd
    from ks265codec_tpu_torch.ops import intercode as tic
    from ks265codec_tpu_torch.ops import interdecide as tid
    from ks265codec_tpu_torch.ops import lookahead as tla
    from ks265codec_tpu_torch.ops import me2
    from ks265codec_tpu_torch.ops import saoapply as sap
    from ks265codec_tpu_torch.ops import saostats as sst
    from ks265codec_tpu_torch.ops import wavefront as wf
    from ks265codec_tpu_torch.utils.yuv import YUVFrame

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = f"{smi} ({torch.cuda.get_device_name(0)})"
    print(f"phase card: {card}", flush=True)
    dev = torch.device("cuda")

    t0 = time.time()
    _build.kernels()
    print(f"phase build: {time.time() - t0:.1f} s", flush=True)

    # ---- phase 3: every kernel against its plain version on the card, on
    # inputs built as HevcEncoder._dispatch builds them, at its batch size
    frames = synth_frames(FRAMES)
    cfg_tiles = dict(width=W, height=H, preset="ultrafast", qp=27,
                     intra_period=1)
    enc_t = HevcEncoder(EncoderConfig(tiles="8x6", **cfg_tiles))
    enc_n = HevcEncoder(EncoderConfig(**cfg_tiles))
    F = enc_t._sizes[0]                 # the main path's batch: 16 frames
    sps, pps = enc_t.sps, enc_t.pps
    ph = sps.pic_height_in_ctbs * sps.ctb_size
    pw = sps.pic_width_in_ctbs * sps.ctb_size
    cs = sps.ctb_size
    src = [torch.from_numpy(np.stack([
        pad_plane(fr[c], h, w).astype(np.uint8) for fr in frames[:F]]))
        .to(dev).contiguous()
        for c, h, w in ((0, ph, pw), (1, ph // 2, pw // 2),
                        (2, ph // 2, pw // 2))]
    qps = [27] * F
    qpa, qpca, lam, ls = dcd.frame_lambdas(qps)
    dargs = [torch.as_tensor(a, device=dev) for a in (qpa, qpca, lam, ls)]
    device_tables(dev)
    device_bits_table(dev)
    rows = {}

    got = dcd.decide_frames_cuda(*src, *dargs)
    want = dcd.decide_frames_plain(*src, *dargs)
    torch.cuda.synchronize()
    for name in dcd.MAP_NAMES:
        if not torch.equal(got[name], want[name]):
            raise AssertionError(f"K5 decide: map {name} differs")
    err = max(max_abs_err(got[k].to(torch.float64), want[k].to(torch.float64))
              for k in dcd.MAP_NAMES)
    ms = cuda_ms(lambda: dcd.decide_frames_cuda(*src, *dargs))
    plain = cuda_ms(lambda: dcd.decide_frames_plain(*src, *dargs),
                    warm=False)
    # bytes: the source planes once, the maps once; operations: every
    # candidate prediction + 8x8 Hadamard (about 10 integer ops per sample
    # and mode) and the winners' rough cost, luma and chroma (the forward
    # transform only: 2 stages of n multiply-adds per sample, in the matrix
    # form the kernel computes; a butterfly needs fewer)
    ops = 0.0
    for n, cands in ((16, 35), (8, 7), (32, 7)):
        nb = F * (ph // n) * (pw // n)
        ops += nb * cands * n * n * 10
        ops += nb * (n * n * 2 * n + 2 * (n // 2) ** 2 * 2 * (n // 2))
    nbytes = F * ph * pw * 1.5 + sum(
        v.numel() * v.element_size() for v in got.values())
    bnd, by = bound_ms(nbytes, ops)
    rows["decide"] = dict(name="decide", route="cuda",
                          source="ks265codec_tpu_torch/csrc/decide.cu",
                          replaces="ks265codec_tpu/ops/decide.py:397",
                          max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bnd, bound_by=by, library_ms=None,
                          counters=["decide_pass_a", "decide_pass_b",
                                    "decide_split"])
    print(f"phase K5 decide: 13 maps equal, kernel {ms:.3f} ms, plain "
          f"{plain:.3f} ms, bound {bnd:.4f} ms ({by})", flush=True)
    rows["decide"]["tiers"] = k5_tier_phase(src, dargs, 0)

    maps = {k: v.cpu().numpy() for k, v in got.items()}
    scans = {}
    strong = bool(sps.strong_intra_smoothing)
    tab = device_tables(dev)
    for tag, enc in (("tiles 8x6", enc_t), ("no tiles", enc_n)):
        _, tile8, _ = tile_region_maps(enc.pps, enc.sps)
        batch = []
        for f in range(F):
            log2m, modes8, cmodes8 = decision_maps8(
                maps["split32"][f], maps["split16"][f], maps["mode8"][f],
                maps["mode16"][f], maps["mode32"][f], sps, ph >> 3, pw >> 3,
                maps["cm8"][f], maps["cm16"][f], maps["cm32"][f])
            batch.append(dict(log2m=log2m, modes8=modes8, cmodes8=cmodes8,
                              qp_map8=np.full(log2m.shape, 27, np.uint8),
                              tile8=tile8))
        sched = wf.WavefrontIntraCoder().pack(
            batch, pps.cb_qp_offset, pps.cr_qp_offset, sps).to(dev)
        gk = wf.code_intra_frames_cuda(*src, sched, strong, tab)
        gp = wf.code_intra_frames_plain(*src, sched, strong)
        torch.cuda.synchronize()
        for part, a, b in (("recon", gk[0], gp[0]), ("levels", gk[1], gp[1])):
            for c, x, y in zip("YUV", a, b):
                if not torch.equal(x, y):
                    raise AssertionError(f"K6 intra scan ({tag}): {part} "
                                         f"plane {c} differs")
        ms = cuda_ms(lambda: wf.code_intra_frames_cuda(*src, sched, strong,
                                                       tab))
        plain = cuda_ms(lambda: wf.code_intra_frames_plain(*src, sched,
                                                           strong),
                        reps=3, warm=False)
        err = max(max_abs_err(gk[0], gp[0]), max_abs_err(gk[1], gp[1]))
        scans[tag] = (sched, gk, batch)
        recs = sched.recs.cpu().numpy()
        sizes = recs[recs[:, wf.VALID] == 1, wf.SIZE].astype(np.float64)
        if tag == "tiles 8x6":
            # operations: 4 transform stages of n multiply-adds per sample
            # (matrix form, as the kernel computes them), luma and both
            # chroma blocks; bytes: sources in, recon and int16 levels out
            ops = float(np.sum(sizes ** 2 * 4 * sizes
                               + 2 * (sizes / 2) ** 2 * 4 * (sizes / 2)))
            nbytes = F * ph * pw * 1.5 * (1 + 1 + 2)
            bnd, by = bound_ms(nbytes, ops)
            rows["intra_scan"] = dict(
                name="intra_scan", route="cuda",
                source="ks265codec_tpu_torch/csrc/intra_scan.cu",
                replaces="ks265codec_tpu/ops/wavefront.py:647",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=None, counters=["intra_level"])
        print(f"phase K6 intra scan ({tag}): recon and levels equal, "
              f"{len(sched.levels)} levels, kernel {ms:.3f} ms, plain "
              f"{plain:.3f} ms", flush=True)

    sched, gk, batch = scans["tiles 8x6"]
    recon = gk[0]
    bs = [dbk.intra_bs_maps(it["log2m"]) for it in batch]
    bs_v = torch.from_numpy(np.stack([b[0] for b in bs]).astype(np.uint8)).to(dev)
    bs_h = torch.from_numpy(np.stack([b[1] for b in bs]).astype(np.uint8)).to(dev)
    qp4 = torch.full(bs_v.shape, 27, dtype=torch.uint8, device=dev)
    dba = (bs_v, bs_h, qp4, pps.beta_offset_div2, pps.tc_offset_div2,
           pps.cb_qp_offset, pps.cr_qp_offset, sps.width, sps.height)
    dk = dbk.deblock_frames_cuda(*recon, *dba, tab)
    dp = dbk.deblock_frames_plain(*recon, *dba)
    torch.cuda.synchronize()
    for c, x, y in zip("YUV", dk, dp):
        if not torch.equal(x, y):
            raise AssertionError(f"K7 deblock: plane {c} differs")
    ms = cuda_ms(lambda: dbk.deblock_frames_cuda(*recon, *dba, tab))
    plain = cuda_ms(lambda: dbk.deblock_frames_plain(*recon, *dba),
                    warm=False)
    # bytes: the planes in and out once, bS and qp maps in; operations, an
    # estimate from this run's bS maps: about 160 int32 instructions per
    # luma edge segment with bS > 0 (decision over 2 lines, filter over 4),
    # and about 10 per chroma line (2 lines, 2 planes) on the 16-luma grid
    nbytes = F * ph * pw * 1.5 * 2 + 3 * bs_v.numel()
    seg = int((bs_v > 0).sum() + (bs_h > 0).sum())
    seg16 = int((bs_v[:, :, ::4] == 2).sum() + (bs_h[:, ::4, :] == 2).sum())
    bnd, by = bound_ms(nbytes, 160.0 * seg + 40.0 * seg16)
    rows["deblock"] = dict(name="deblock", route="cuda",
                           source="ks265codec_tpu_torch/csrc/deblock.cu",
                           replaces="ks265codec_tpu/ops/deblock.py:133",
                           max_abs_err=max_abs_err(dk, dp), ms=ms,
                           plain_ms=plain, bound_ms=bnd, bound_by=by,
                           library_ms=None, counters=["deblock_edges"])
    print(f"phase K7 deblock: equal, kernel {ms:.3f} ms, plain "
          f"{plain:.3f} ms, bound {bnd:.4f} ms ({by})", flush=True)

    # K8 on the deblocked batch against the sources, at the main path's
    # tier (1) and the full tier (4), as HevcEncoder._dispatch gates it
    sao_params = {}
    for tier in (1, 4):
        ncl, use_bo = (2 if tier <= 1 else 4), tier >= 3
        planes = list(zip(dk, src, (0, 1, 1)))[:3 if use_bo else 1]

        def stats(fn, planes=planes, ncl=ncl, use_bo=use_bo):
            return [fn(r, s, sps.width >> sh, sps.height >> sh, cs >> sh,
                       ncl, use_bo) for r, s, sh in planes]

        sk = stats(sst.sao_stats_frames_cuda)
        sp = stats(sst.sao_stats_frames_plain)
        torch.cuda.synchronize()
        for c, (a, b) in enumerate(zip(sk, sp)):
            for name, x, y in zip(("eo_cnt", "eo_err", "bo_cnt", "bo_err"),
                                  a, b):
                if (x is None) != (y is None) or (
                        x is not None and not torch.equal(x, y)):
                    raise AssertionError(f"K8 SAO stats (tier {tier}): "
                                         f"plane {c} {name} differs")
        ms = cuda_ms(lambda: stats(sst.sao_stats_frames_cuda))
        plain = cuda_ms(lambda: stats(sst.sao_stats_frames_plain),
                        warm=False)
        # bytes: rec and src read once, the bins written once; operations:
        # about 15 int32 instructions per sample and EO class (two
        # neighbour loads, two compares, the category and its bin) and 4
        # per sample for the band, over the planes of this tier
        nsamp = sum(r.numel() for r, _, _ in planes)
        nbytes = 2.0 * nsamp + sum(x.numel() * 4 for st in sk for x in st
                                   if x is not None)
        bnd, by = bound_ms(nbytes, nsamp * (15.0 * ncl + (4 if use_bo
                                                          else 0)))
        if tier == 1:
            rows["sao_stats"] = dict(
                name="sao_stats", route="cuda",
                source="ks265codec_tpu_torch/csrc/sao_stats.cu",
                replaces="ks265codec_tpu/ops/saostats.py:32",
                max_abs_err=max(max_abs_err([x for x in a if x is not None],
                                            [y for y in b if y is not None])
                                for a, b in zip(sk, sp)),
                ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=None, counters=["sao_stats"])
        print(f"phase K8 SAO stats (tier {tier}, {len(planes)} plane(s), "
              f"{ncl} EO classes, band {use_bo}): equal, kernel {ms:.3f} ms,"
              f" plain {plain:.3f} ms, bound {bnd:.4f} ms ({by})",
              flush=True)
        arrs = sao_decisions(sk, 27, tier)
        sao_params[tier] = [torch.from_numpy(np.stack([a[k] for a in arrs]))
                            .to(dev) for k in range(4)]

    # K22: K8's per-frame wrapper (all EO classes, band offset, three
    # planes from host arrays to host arrays) on frame 0, against the plain
    # statistics of the same planes on the card
    fs0 = types.SimpleNamespace(sps=sps, y=dk[0][0].cpu().numpy(),
                                cb=dk[1][0].cpu().numpy(),
                                cr=dk[2][0].cpu().numpy())
    src0 = [s[0].cpu().numpy() for s in src]
    planes0 = [(d[:1], s[:1], sh) for d, s, sh in zip(dk, src, (0, 1, 1))]

    def plain0():
        return [sst.sao_stats_frames_plain(r, s, sps.width >> sh,
                                           sps.height >> sh, cs >> sh)
                for r, s, sh in planes0]

    got = sst.sao_frame_stats(fs0, *src0)
    for c, (a, b) in enumerate(zip(got, plain0())):
        if not all(np.array_equal(x, y[0].cpu().numpy())
                   for x, y in zip(a, b)):
            raise AssertionError(f"K22 frame stats: plane {c} differs")
    ms = cuda_ms(lambda: sst.sao_frame_stats(fs0, *src0))
    plain = cuda_ms(plain0, warm=False)
    # counted as K8 at tier 4, on one frame
    nsamp = sum(r.numel() for r, _, _ in planes0)
    bnd, by = bound_ms(2.0 * nsamp + sum(x.nbytes for st in got for x in st),
                       nsamp * (15.0 * 4 + 4))
    print(f"phase K22 frame stats (frame 0, 3 planes, 4 EO classes, band): "
          f"equal, wrapper {ms:.3f} ms (3 K8 launches with the host "
          f"copies), plain {plain:.3f} ms, bound {bnd:.4f} ms ({by})",
          flush=True)

    for tier in (1, 4):
        prm = sao_params[tier]
        sa = (*dk, *prm, True, True, sps.width, sps.height, cs)
        ak = sap.sao_apply_frames_cuda(*sa)
        ap = sap.sao_apply_frames_plain(*sa)
        torch.cuda.synchronize()
        for c, x, y in zip("YUV", ak, ap):
            if not torch.equal(x, y):
                raise AssertionError(f"K9 SAO apply (tier {tier}): plane "
                                     f"{c} differs")
        changed = int(sum((x != d).sum() for x, d in zip(ak, dk)))
        ms = cuda_ms(lambda: sap.sao_apply_frames_cuda(*sa))
        plain = cuda_ms(lambda: sap.sao_apply_frames_plain(*sa), warm=False)
        # bytes: every plane read and written once, the parameters read;
        # operations, counted from this run's type maps: about 12 int32
        # instructions per sample of a band- or edge-offset CTB in the
        # picture (CTB index, type, band or two neighbour compares, clip);
        # a sample of an SAO-off CTB is a copy, counted in bytes only
        nsamp = sum(x.numel() for x in dk)
        nbytes = 2.0 * nsamp + sum(x.numel() for x in prm)
        nsao = 0
        for c in range(3):
            n, sh = cs >> (c > 0), int(c > 0)
            on = (prm[0][:, c] != 0).to(torch.int32)
            nsao += int(on.repeat_interleave(n, 1).repeat_interleave(n, 2)[
                :, :sps.height >> sh, :sps.width >> sh].sum())
        bnd, by = bound_ms(nbytes, 12.0 * nsao)
        if tier == 1:
            rows["sao_apply"] = dict(
                name="sao_apply", route="cuda",
                source="ks265codec_tpu_torch/csrc/sao_apply.cu",
                replaces="ks265codec_tpu/ops/saoapply.py:61",
                max_abs_err=max_abs_err(ak, ap), ms=ms, plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=None,
                counters=["sao_apply"])
        print(f"phase K9 SAO apply (tier {tier}): equal, {nsao} samples in "
              f"SAO-on CTBs, {changed} changed, kernel {ms:.3f} ms, plain "
              f"{plain:.3f} ms, bound {bnd:.4f} ms ({by})", flush=True)

    # K11 from the levels K6 wrote, with K6's schedule
    for tag, (sched, gk, _) in scans.items():
        rk = wf.recon_intra_frames_cuda(*gk[1], sched, strong, tab)
        rp = wf.recon_intra_frames_plain(*gk[1], sched, strong)
        torch.cuda.synchronize()
        for c, x, y, z in zip("YUV", rk, rp, gk[0]):
            if not torch.equal(x, y):
                raise AssertionError(f"K11 intra recon ({tag}): plane {c} "
                                     "differs from its plain version")
            if not torch.equal(x, z):
                raise AssertionError(f"K11 intra recon ({tag}): plane {c} "
                                     "differs from K6's reconstruction")
        ms = cuda_ms(lambda: wf.recon_intra_frames_cuda(*gk[1], sched,
                                                        strong, tab))
        plain = cuda_ms(lambda: wf.recon_intra_frames_plain(*gk[1], sched,
                                                            strong),
                        reps=3, warm=False)
        if tag == "tiles 8x6":
            recs = sched.recs.cpu().numpy()
            sizes = recs[recs[:, wf.VALID] == 1, wf.SIZE].astype(np.float64)
            # operations: the 2 inverse-transform stages of n multiply-adds
            # per sample (matrix form), luma and both chroma blocks; bytes:
            # int16 levels in, recon out
            ops = float(np.sum(sizes ** 2 * 2 * sizes
                               + 2 * (sizes / 2) ** 2 * 2 * (sizes / 2)))
            bnd, by = bound_ms(F * ph * pw * 1.5 * (2 + 1), ops)
            rows["intra_recon"] = dict(
                name="intra_recon", route="cuda",
                source="ks265codec_tpu_torch/csrc/intra_scan.cu",
                replaces="ks265codec_tpu/ops/wavefront.py:433",
                max_abs_err=max_abs_err(rk, rp), ms=ms, plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=None,
                counters=["intra_recon"])
        print(f"phase K11 intra recon ({tag}): equal to its plain version "
              f"and to K6's recon, {len(sched.levels)} levels in one launch, "
              f"kernel {ms:.3f} ms, plain {plain:.3f} ms", flush=True)
    sched, gk, batch = scans["tiles 8x6"]
    rows["intra_recon"].update(k11_picture_phase(batch, sps, pps, gk[1],
                                                 gk[0], tab))

    # K12, K13, K15, K17 and K14 on the low-delay P path's first P picture
    # (frame 1 against the IDR of frame 0), on the inputs the encoder gives
    # them, recorded by wrapping the op functions during a 2-frame encode
    yuv = [YUVFrame(y, u, v, poc=i) for i, (y, u, v) in enumerate(frames)]
    # BASELINE.json config 2, SAO from the preset (ultrafast: tier 1)
    icfg = dict(width=W, height=H, preset="ultrafast", latency="zerolatency",
                rc=0, qp=30, intra_period=0, frame_rate=30)
    calls = {}
    spied = [(tla, "frame_features_batch"), (me2, "me_fused"),
             (tid, "decide_tiers"), (tid, "snap_sads"),
             (tic, "code_inter_frame")]
    saved = [(m, name, getattr(m, name)) for m, name in spied]

    def spy(name, fn):
        def g(*a, **k):
            calls.setdefault(name, []).append((a, k))
            return fn(*a, **k)
        return g

    for m, name, fn in saved:
        setattr(m, name, spy(name, fn))
    try:
        enc = HevcEncoder(EncoderConfig(**icfg))
        for fr in yuv[:2]:
            enc.encode_frame(fr)
        enc.flush()
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
    torch.cuda.synchronize()
    rows.update(inter_kernel_phases(calls, yuv, dev, card))
    # the fast preset's kernels: K2, K5 at effort 1, K6 with RDOQ and
    # sign hiding (on the batch above, tiles 8x6), K17 with sign hiding
    _, tile8, _ = tile_region_maps(pps, sps)
    rows.update(fast_kernel_phases(src, dargs, dict(sps=sps, pps=pps,
                                                    tile8=tile8), yuv, dev))

    # ---- phase 4: the main path through the encoder's entry points, in
    # bench.py's configuration (SAO from the preset: ultrafast = tier 1)
    cfg = dict(width=W, height=H, preset="ultrafast", qp=27, intra_period=1,
               tiles="8x6")

    def encode(frames_in, reference=False, **over):
        enc = HevcEncoder(EncoderConfig(**dict(cfg, **over)),
                          reference=reference)
        efs = []
        for fr in frames_in:
            efs += enc.encode_frame(fr)
        efs += enc.flush()
        return efs

    def check_counts(names, counts, path):
        missing = [c for c in names if counts.get(c, 0) == 0]
        if missing:
            raise AssertionError(f"{path} never launched {missing}")
        return sum(counts[c] for c in names)

    for key in ("decide", "intra_scan", "deblock", "sao_stats", "sao_apply"):
        rows[key]["required"] = rows[key]["counters"]
    encode(yuv)                                  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    efs = encode(yuv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(_build.launches)
    for key in ("decide", "intra_scan", "deblock", "sao_stats", "sao_apply"):
        rows[key]["launches"] = check_counts(rows[key]["counters"], counts,
                                             "main path")
    stream = b"".join(e.data for e in efs)
    recons = sorted(efs, key=lambda e: e.display_idx)
    mse = np.mean([np.mean((e.recon.y.astype(np.float64)
                            - f.y.astype(np.float64)) ** 2)
                   for e, f in zip(recons, yuv)])
    psnr = 10 * np.log10(255.0 ** 2 / mse)
    if not psnr > 30.0:
        raise AssertionError(f"recon luma PSNR {psnr:.2f} dB <= 30 dB")
    fps = len(efs) / secs
    print(f"phase main path: {len(efs)} frames {W}x{H} (SAO tier 1) in "
          f"{secs:.3f} s = {fps:.3f} fps on {card}; stream {len(stream)} "
          f"bytes md5 {hashlib.md5(stream).hexdigest()}; luma PSNR "
          f"{psnr:.3f} dB; launches {counts}", flush=True)
    plain_stream = b"".join(e.data for e in encode(yuv, reference=True))
    if plain_stream != stream:
        raise AssertionError(f"{FRAMES}-frame stream: kernels and plain "
                             "versions differ")
    a = b"".join(e.data for e in encode(yuv[:2]))
    b = b"".join(e.data for e in encode(yuv[:2], reference=True))
    if a != b:
        raise AssertionError("2-frame stream: kernels and plain versions "
                             "differ")
    print(f"phase kernels vs plain stream: {FRAMES} frames ({len(stream)} "
          f"bytes) and 2 frames ({len(a)} bytes) identical", flush=True)

    # ---- phase 5: the decode path, HevcDecoder on the card
    enc_md5 = md5s(e.recon for e in recons)
    aus = [e.data for e in efs]                 # coding order = display
    HevcDecoder().decode_all(b"".join(aus[:2]))  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    dec = HevcDecoder()
    decoded = dec.decode_all(stream)
    torch.cuda.synchronize()
    dsecs = time.perf_counter() - t0
    dcounts = dict(_build.launches)
    dec_md5 = md5s(decoded)
    decode_fps = len(decoded) / dsecs
    if dec.fast_pictures != FRAMES or len(decoded) != FRAMES:
        raise AssertionError(f"decode: {dec.fast_pictures} of "
                             f"{len(decoded)} pictures took the fast path")
    if dec_md5 != enc_md5:
        bad = [i for i, (x, y) in enumerate(zip(dec_md5, enc_md5)) if x != y]
        raise AssertionError(f"decode: frames {bad} differ from the "
                             "encoder's reconstruction")
    check_counts(["intra_recon", "deblock_edges", "sao_apply"], dcounts,
                 "decode path")
    check_k11_launches(dcounts, FRAMES, FRAMES, "decode")
    rows["intra_recon"]["launches"] = dcounts["intra_recon"]
    ref4 = md5s(HevcDecoder(reference=True).decode_all(b"".join(aus[:4])))
    if ref4 != dec_md5[:4]:
        raise AssertionError("decode: reference=True differs on the first "
                             "4 pictures")
    print(f"phase decode: {len(decoded)} frames {W}x{H} in {dsecs:.3f} s = "
          f"{decode_fps:.3f} fps on {card}; all {dec.fast_pictures} through "
          "the fast path, md5 equal to the encoder's recon, first 4 equal "
          f"with reference=True; launches {dcounts}", flush=True)

    # ---- phase 6: the SAO-off encode (the previous slice's path)
    _build.reset_launches()
    a = b"".join(e.data for e in encode(yuv[:4], sao=0))
    torch.cuda.synchronize()
    for key in ("decide", "intra_scan", "deblock"):
        check_counts(rows[key]["counters"], _build.launches, "SAO-off path")
    b = b"".join(e.data for e in encode(yuv[:4], reference=True, sao=0))
    if a != b:
        raise AssertionError("SAO-off stream: kernels and plain versions "
                             "differ")
    print(f"phase SAO off: 4 frames ({len(a)} bytes) kernel stream == plain "
          "stream", flush=True)

    # ---- phase 7: the low-delay P path (BASELINE.json config 2, SAO tier
    # 1): 8 frames on the kernels == on the plain versions, then a timed
    # 24-frame encode after a warm-up; the SAO-off P path on 4 frames
    def iencode(frames_in, reference=False, **over):
        enc = HevcEncoder(EncoderConfig(**dict(icfg, **over)),
                          reference=reference)
        efs = []
        for fr in frames_in:
            efs += enc.encode_frame(fr)
        efs += enc.flush()
        return efs

    a = b"".join(e.data for e in iencode(yuv[:4], sao=0))
    b = b"".join(e.data for e in iencode(yuv[:4], reference=True, sao=0))
    if a != b:
        raise AssertionError("SAO-off IPPP stream: kernels and plain "
                             "versions differ")
    print(f"phase inter SAO off: 4 frames ({len(a)} bytes) kernel stream == "
          "plain stream", flush=True)

    ka = iencode(yuv[:8])
    kb = iencode(yuv[:8], reference=True)
    if b"".join(e.data for e in ka) != b"".join(e.data for e in kb) or \
            md5s(e.recon for e in ka) != md5s(e.recon for e in kb):
        raise AssertionError("8-frame IPPP stream or recon: kernels and "
                             "plain versions differ")
    print(f"phase inter kernels vs plain stream: 8 frames "
          f"({sum(len(e.data) for e in ka)} bytes, slice types "
          f"{''.join(e.slice_type for e in ka)}) identical, recon md5s "
          "equal", flush=True)
    iencode(yuv[:4])                             # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    iefs = iencode(yuv[:INTER_FRAMES])
    torch.cuda.synchronize()
    isecs = time.perf_counter() - t0
    icounts = dict(_build.launches)
    for key in ("decide", "intra_scan", "deblock", "sao_stats", "sao_apply",
                "lookahead", "motion_search", "inter_decide", "inter_mc",
                "inter_code", "sao_decide"):
        check_counts(rows[key]["required"], icounts, "low-delay P path")
        if key in INTER_ROWS:
            rows[key]["launches"] = sum(icounts.get(c, 0)
                                        for c in rows[key]["counters"])
    istream = b"".join(e.data for e in iefs)
    irec = sorted(iefs, key=lambda e: e.display_idx)
    imse = np.mean([np.mean((e.recon.y.astype(np.float64)
                             - f.y.astype(np.float64)) ** 2)
                    for e, f in zip(irec, yuv)])
    ipsnr = 10 * np.log10(255.0 ** 2 / imse)
    if not ipsnr > 30.0:
        raise AssertionError(f"IPPP recon luma PSNR {ipsnr:.2f} dB <= 30 dB")
    inter_fps = len(iefs) / isecs
    slice_types = "".join(e.slice_type for e in iefs)
    if slice_types.count("P") < INTER_FRAMES // 2:
        raise AssertionError("IPPP stream holds too few P pictures: "
                             + slice_types)
    print(f"phase inter path: {len(iefs)} frames {W}x{H} (ultrafast "
          f"zerolatency QP 30 SAO tier 1) in {isecs:.3f} s = {inter_fps:.3f} "
          f"fps on {card}; stream {len(istream)} bytes md5 "
          f"{hashlib.md5(istream).hexdigest()}; luma PSNR {ipsnr:.3f} dB; "
          f"slice types {slice_types}; launches {icounts}", flush=True)

    # ---- phase 8: the P decode, HevcDecoder on the card decodes the timed
    # IPPP stream: a first decode records K18's inputs, then a timed decode
    # with the launch counts reset just before
    ienc_md5 = md5s(e.recon for e in irec)
    k18_calls = []
    k18_fn = wf.recon_inter_filter

    def k18_spy(*a, **k):
        k18_calls.append((a, k))
        return k18_fn(*a, **k)

    wf.recon_inter_filter = k18_spy
    try:
        HevcDecoder().decode_all(istream)
    finally:
        wf.recon_inter_filter = k18_fn
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    idec = HevcDecoder()
    idecoded = idec.decode_all(istream)
    torch.cuda.synchronize()
    idsecs = time.perf_counter() - t0
    idcounts = dict(_build.launches)
    inter_decode_fps = len(idecoded) / idsecs
    if idec.fast_pictures != INTER_FRAMES or len(idecoded) != INTER_FRAMES:
        raise AssertionError(f"P decode: {idec.fast_pictures} of "
                             f"{len(idecoded)} pictures took the fast path")
    check_k11_launches(idcounts, INTER_FRAMES, 1, "P decode")
    idec_md5 = md5s(idecoded)
    if idec_md5 != ienc_md5:
        bad = [i for i, (x, y) in enumerate(zip(idec_md5, ienc_md5))
               if x != y]
        raise AssertionError(f"P decode: frames {bad} differ from the "
                             "encoder's reconstruction")
    check_counts(["inter_mc", "inter_recon", "deblock_edges", "sao_apply"],
                 idcounts, "P decode path")
    ref4 = md5s(HevcDecoder(reference=True).decode_all(
        b"".join(e.data for e in iefs[:4])))
    if ref4 != idec_md5[:4]:
        raise AssertionError("P decode: reference=True differs on the first "
                             "4 pictures")
    print(f"phase inter decode: {len(idecoded)} frames {W}x{H} in "
          f"{idsecs:.3f} s = {inter_decode_fps:.3f} fps on {card}; all "
          f"{idec.fast_pictures} through the fast path, md5 equal to the "
          f"encoder's recon, first 4 equal with reference=True; launches "
          f"{idcounts}", flush=True)
    rows["inter_recon"] = k18_phase(k18_calls, card)
    rows["inter_recon"]["launches"] = idcounts["inter_recon"]

    # ---- phase 9: the CLIs on the card
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        (work / "in.yuv").write_bytes(b"".join(f.tobytes() for f in yuv[:8]))
        argv = ["-i", str(work / "in.yuv"), "-wdt", str(W), "-hgt", str(H),
                "-frms", "8", "-b", str(work / "out.265"), "-preset",
                "ultrafast", "-qp", "27", "-iper", "1", "-rdoq", "0",
                "-md5", "1", "-opts", "tiles=8x6"]
        _build.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = app_encoder.main(argv)
        for key in ("decide", "intra_scan", "deblock", "sao_stats",
                    "sao_apply"):
            check_counts(rows[key]["counters"], _build.launches,
                         "app_encoder")
        ccfg = app_encoder.cfg_from_args(
            app_encoder.build_parser().parse_args(argv))
        enc = HevcEncoder(ccfg)
        cefs = []
        for fr in yuv[:8]:
            cefs += enc.encode_frame(fr)
        cefs += enc.flush()
        want = b"".join(e.data for e in cefs)
        if rc != 0 or (work / "out.265").read_bytes() != want:
            raise AssertionError("app_encoder: bytes differ from "
                                 "HevcEncoder's")
        cli_md5 = [ln.split()[1] for ln in out.getvalue().splitlines()
                   if ln.startswith("  MD5 ")]
        want_md5 = [",".join(m) for m in md5s(e.recon for e in cefs)]
        _build.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = app_decoder.main(["-b", str(work / "out.265"), "-md5", "1"])
        check_counts(["intra_recon", "deblock_edges", "sao_apply"],
                     _build.launches, "app_decoder")
        dec_lines = [ln.split()[3] for ln in out.getvalue().splitlines()
                     if ln.startswith("POC ")]
        if rc != 0 or not cli_md5 == dec_lines == want_md5:
            raise AssertionError("app_decoder -md5 1: lines differ from the "
                                 "encoder's md5s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase CLI: app_encoder 8 frames ({len(want)} bytes) == "
          "HevcEncoder, app_decoder -md5 1 == encoder md5s", flush=True)
    work.mkdir(parents=True)
    try:
        (work / "in.yuv").write_bytes(b"".join(f.tobytes() for f in yuv[:4]))
        argv = ["-i", str(work / "in.yuv"), "-wdt", str(W), "-hgt", str(H),
                "-frms", "4", "-b", str(work / "ippp.265"), "-preset",
                "ultrafast", "-latency", "zerolatency", "-iper", "0",
                "-qp", "30", "-rdoq", "0", "-fr", "30"]
        _build.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = app_encoder.main(argv)
        for key in ("lookahead", "motion_search", "inter_decide",
                    "inter_code", "sao_decide"):
            check_counts(rows[key]["required"], _build.launches,
                         "app_encoder (IPPP)")
        ccfg = app_encoder.cfg_from_args(
            app_encoder.build_parser().parse_args(argv))
        enc = HevcEncoder(ccfg)
        cefs = []
        for fr in yuv[:4]:
            cefs += enc.encode_frame(fr)
        cefs += enc.flush()
        want = b"".join(e.data for e in cefs)
        if rc != 0 or (work / "ippp.265").read_bytes() != want:
            raise AssertionError("app_encoder -latency zerolatency -iper 0: "
                                 "bytes differ from HevcEncoder's")
        want_md5 = [",".join(m) for m in md5s(e.recon for e in cefs)]
        _build.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = app_decoder.main(["-b", str(work / "ippp.265"), "-md5", "1"])
        check_counts(["inter_mc", "inter_recon", "deblock_edges",
                      "sao_apply"], _build.launches, "app_decoder (IPPP)")
        dec_lines = [ln.split()[3] for ln in out.getvalue().splitlines()
                     if ln.startswith("POC ")]
        if rc != 0 or dec_lines != want_md5:
            raise AssertionError("app_decoder -md5 1 (IPPP): lines differ "
                                 "from the encoder's md5s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase CLI IPPP: app_encoder -latency zerolatency -iper 0 4 "
          f"frames ({len(want)} bytes, slice types "
          f"{''.join(e.slice_type for e in cefs)}) == HevcEncoder, "
          "app_decoder -md5 1 == encoder md5s", flush=True)

    # ---- phase 10: bench.py's inter leg (fast, zerolatency, QP 30,
    # intra_period 0: RDOQ and sign hiding in the IDR, sign hiding in the
    # P pictures, the effort-1 decision, SAO tier 3): 8 frames on the
    # kernels == on the plain versions, then a timed 24-frame encode after
    # a warm-up, with the launch counts reset just before
    def fencode(frames_in, reference=False, **over):
        enc = HevcEncoder(EncoderConfig(**dict(FAST_INTER, **over)),
                          reference=reference)
        efs = []
        for fr in frames_in:
            efs += enc.encode_frame(fr)
        efs += enc.flush()
        return efs

    ka = fencode(yuv[:8])
    kb = fencode(yuv[:8], reference=True)
    if b"".join(e.data for e in ka) != b"".join(e.data for e in kb) or \
            md5s(e.recon for e in ka) != md5s(e.recon for e in kb):
        raise AssertionError("8-frame fast IPPP stream or recon: kernels and "
                             "plain versions differ")
    print(f"phase fast inter kernels vs plain stream: 8 frames "
          f"({sum(len(e.data) for e in ka)} bytes, slice types "
          f"{''.join(e.slice_type for e in ka)}) identical, recon md5s "
          "equal", flush=True)
    fencode(yuv[:4])                             # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    fefs = fencode(yuv[:INTER_FRAMES])
    torch.cuda.synchronize()
    fsecs = time.perf_counter() - t0
    fcounts = dict(_build.launches)
    for key in ("decide_effort1", "intra_scan", "intra_scan_rdoq_sbh",
                "rdoq_sbh", "deblock", "sao_stats", "sao_apply",
                "lookahead", "motion_search", "inter_decide", "inter_mc",
                "inter_code_sbh", "sao_decide"):
        n_launch = check_counts(rows[key].get("required",
                                              rows[key]["counters"]),
                                fcounts, "fast low-delay P path")
        if key in ("decide_effort1", "intra_scan_rdoq_sbh", "rdoq_sbh",
                   "inter_code_sbh"):
            rows[key]["launches"] = n_launch
    fstream = b"".join(e.data for e in fefs)
    frec = sorted(fefs, key=lambda e: e.display_idx)
    fmse = np.mean([np.mean((e.recon.y.astype(np.float64)
                             - f.y.astype(np.float64)) ** 2)
                    for e, f in zip(frec, yuv)])
    fpsnr = 10 * np.log10(255.0 ** 2 / fmse)
    if not fpsnr > 30.0:
        raise AssertionError(f"fast IPPP luma PSNR {fpsnr:.2f} dB <= 30 dB")
    fast_inter_fps = len(fefs) / fsecs
    ftypes = "".join(e.slice_type for e in fefs)
    if ftypes.count("P") < INTER_FRAMES // 2:
        raise AssertionError("fast IPPP stream holds too few P pictures: "
                             + ftypes)
    print(f"phase fast inter path: {len(fefs)} frames {W}x{H} (fast "
          f"zerolatency QP 30, SAO tier 3) in {fsecs:.3f} s = "
          f"{fast_inter_fps:.3f} fps on {card}; stream {len(fstream)} bytes "
          f"md5 {hashlib.md5(fstream).hexdigest()}; luma PSNR {fpsnr:.3f} "
          f"dB; slice types {ftypes}; launches {fcounts}", flush=True)

    # ---- phase 11: the card decode of that leg (sign hiding inferred in
    # the parse), timed with the launch counts reset just before
    fenc_md5 = md5s(e.recon for e in frec)
    _build.reset_launches()
    t0 = time.perf_counter()
    fdec = HevcDecoder()
    fdecoded = fdec.decode_all(fstream)
    torch.cuda.synchronize()
    fdsecs = time.perf_counter() - t0
    fdcounts = dict(_build.launches)
    fast_inter_decode_fps = len(fdecoded) / fdsecs
    if fdec.fast_pictures != INTER_FRAMES or len(fdecoded) != INTER_FRAMES:
        raise AssertionError(f"fast P decode: {fdec.fast_pictures} of "
                             f"{len(fdecoded)} pictures took the fast path")
    check_k11_launches(fdcounts, INTER_FRAMES, 1, "fast P decode")
    if md5s(fdecoded) != fenc_md5:
        raise AssertionError("fast P decode: frames differ from the "
                             "encoder's reconstruction")
    check_counts(["inter_mc", "inter_recon", "deblock_edges", "sao_apply"],
                 fdcounts, "fast P decode path")
    ref4 = md5s(HevcDecoder(reference=True).decode_all(
        b"".join(e.data for e in fefs[:4])))
    if ref4 != fenc_md5[:4]:
        raise AssertionError("fast P decode: reference=True differs on the "
                             "first 4 pictures")
    print(f"phase fast inter decode: {len(fdecoded)} frames {W}x{H} in "
          f"{fdsecs:.3f} s = {fast_inter_decode_fps:.3f} fps on {card}; all "
          f"{fdec.fast_pictures} through the fast paths, md5 equal to the "
          f"encoder's recon, first 4 equal with reference=True; launches "
          f"{fdcounts}", flush=True)

    # ---- phase 12: the fast all-intra encode (effort 1, RDOQ and sign
    # hiding, SAO tier 3, tiles 8x6), one 16-frame batch timed after a
    # warm-up with the launch counts reset just before, against its
    # plain-version encode, and its card decode
    fi = dict(preset="fast")
    encode(yuv[:16], **fi)                       # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    iefs_f = encode(yuv[:16], **fi)
    torch.cuda.synchronize()
    fisecs = time.perf_counter() - t0
    for key in ("decide_effort1", "intra_scan_rdoq_sbh", "deblock",
                "sao_stats", "sao_apply"):
        check_counts(rows[key]["counters"], _build.launches,
                     "fast all-intra path")
    fistream = b"".join(e.data for e in iefs_f)
    if b"".join(e.data for e in encode(yuv[:16], reference=True,
                                       **fi)) != fistream:
        raise AssertionError("16-frame fast all-intra stream: kernels and "
                             "plain versions differ")
    fidec = HevcDecoder()
    _build.reset_launches()
    if md5s(fidec.decode_all(fistream)) != md5s(e.recon for e in iefs_f) \
            or fidec.fast_pictures != 16:
        raise AssertionError("fast all-intra decode: frames differ from the "
                             "encoder's reconstruction or left the fast path")
    check_k11_launches(_build.launches, 16, 16, "fast all-intra decode")
    fast_intra_fps = 16 / fisecs
    print(f"phase fast all-intra: 16 frames {W}x{H} (fast QP 27 tiles 8x6, "
          f"SAO tier 3) in {fisecs:.3f} s = {fast_intra_fps:.3f} fps on "
          f"{card} (one batch, after a warm-up); stream "
          f"{len(fistream)} bytes == plain versions'; card decode all fast, "
          "md5 equal to the encoder's recon", flush=True)

    # ---- phase 13: app_encoder with the default -rdoq (1) at the fast
    # preset, all-intra, and app_decoder on its stream
    work.mkdir(parents=True)
    try:
        (work / "in.yuv").write_bytes(b"".join(f.tobytes() for f in yuv[:4]))
        argv = ["-i", str(work / "in.yuv"), "-wdt", str(W), "-hgt", str(H),
                "-frms", "4", "-b", str(work / "fast.265"), "-preset",
                "fast", "-qp", "27", "-iper", "1", "-md5", "1"]
        _build.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = app_encoder.main(argv)
        check_counts(rows["decide_effort1"]["counters"] + ["intra_level_k2"],
                     _build.launches, "app_encoder (fast)")
        ccfg = app_encoder.cfg_from_args(
            app_encoder.build_parser().parse_args(argv))
        enc = HevcEncoder(ccfg)
        if not (enc.cfg.rdoq and enc.pps.sign_data_hiding_enabled):
            raise AssertionError("app_encoder -preset fast: RDOQ or sign "
                                 "hiding off")
        cefs = []
        for fr in yuv[:4]:
            cefs += enc.encode_frame(fr)
        cefs += enc.flush()
        want = b"".join(e.data for e in cefs)
        if rc != 0 or (work / "fast.265").read_bytes() != want:
            raise AssertionError("app_encoder -preset fast: bytes differ "
                                 "from HevcEncoder's")
        want_md5 = [",".join(m) for m in md5s(e.recon for e in cefs)]
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = app_decoder.main(["-b", str(work / "fast.265"), "-md5", "1"])
        dec_lines = [ln.split()[3] for ln in out.getvalue().splitlines()
                     if ln.startswith("POC ")]
        if rc != 0 or dec_lines != want_md5:
            raise AssertionError("app_decoder -md5 1 (fast): lines differ "
                                 "from the encoder's md5s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase CLI fast: app_encoder -preset fast -iper 1 (default -rdoq)"
          f" 4 frames ({len(want)} bytes) == HevcEncoder, app_decoder -md5 1"
          " == encoder md5s", flush=True)

    # ---- phase 14: B pictures (the offline GOP-8, fast, QP 27)
    bfps = bframe_path(yuv, card, check_counts, rows)

    # ---- phase 15: cu_qp_delta and explicit weighted prediction
    bfps.update(aqwp_path(yuv, card, check_counts, rows))

    # ---- phase 16: the medium preset, EncoderConfig's defaults
    bfps.update(medium_path(yuv, card, check_counts, rows))

    # ---- phase 17: the host walk (slower, K20 and K21)
    bfps.update(walk_path(yuv, card, check_counts, rows))

    table = []
    for key in ("decide", "intra_scan", "deblock", "sao_stats", "sao_apply",
                "intra_recon") + INTER_ROWS + ("inter_recon",) + FAST_ROWS \
            + B_ROWS + AQWP_ROWS + MEDIUM_ROWS + WALK_ROWS:
        r = rows[key]
        r.pop("counters")
        r.pop("required", None)
        table.append(r)
    print(smi)
    print(json.dumps({"kernels": table, "main_path_fps": fps,
                      "decode_fps": decode_fps,
                      "inter_path_fps": inter_fps,
                      "inter_decode_fps": inter_decode_fps,
                      "fast_inter_fps": fast_inter_fps,
                      "fast_inter_decode_fps": fast_inter_decode_fps,
                      "fast_intra_fps": fast_intra_fps, **bfps}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
