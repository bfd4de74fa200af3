"""Inter coding of one P or B picture (K17, with K14 inside): MC, the
residual of every transform unit by TU class, the CU zero-forcing gate,
the final levels and reconstruction, the seeded intra scan of the
picture's intra CUs, the boundary strengths, the deblocking filter and,
when the sequence has it, SAO (K8 statistics -> K16 decision -> K9).

Counterpart of ks265codec_tpu/ops/intercode.py::_inter_code_core (with
`_code_tu_class`, the chroma branch, `_effective_qp4` and
`code_inter_frame_jit`). List 1 (`has_l1`, B pictures) and the explicit
weighted-prediction tables (`wts0`, `wts1`) reach only the MC: K14
averages or weights the two lists' predictions, and everything after it
reads the prediction planes. Under cu_qp_delta (quantization group = CTB)
the TUs carry their CU's QP (the per-CTB AQ / CU-tree offsets) and the
deblocking filter reads the decoder's effective QP per 4x4 cell
(`effective_qp4`): the cells of the CUs before a CTB's first CU with
coefficients take the predicted QP, the last planned QP of the nearest
earlier CTB with coefficients (per CTB row with WPP), else the slice QP. Sign
hiding (K2's encode/sbh.py), where the PPS enables it, runs on every
inter TU with the diagonal scan, before the TU's sums, and in the seeded
intra scan; the reference runs no RDOQ in P or B pictures, and neither
does the port. The coefficient planes come back dense; the reference's
sparse packing is a transfer workaround and is not ported.

The gate `(d_skip - d_coded) <= cu_lam * (bits + 10)` decides which
residuals are dropped, so its float32 inputs follow the reference
backend's sequence (ROADMAP.md queue 3): d_skip and d_coded are sums of
squares in `decide._block_sum` order; a TU's bits are
fma(3.1, count, 2 * S) with S the sum of `jnp.log2(level)` in
`_lane_sum` order (one lane per row modulo 8 for n <= 16, `_block_sum`
at 32); a CU's sums are its luma TU's plus (Cb + Cr) bits, the order in
which the reference's per-class scatter-adds reach them.

CUDA: csrc/inter_code.cu: one MC launch (one thread block per 8x8 cell),
one launch per TU class (one thread block per TU: transform, quantise,
dequantise, inverse transform, the three sums in one thread), one gate
launch (one thread per CU), one launch per TU class for the final levels
and reconstruction; then the intra scan's level launches (csrc/
intra_scan.cu), one launch for the boundary strengths, under cu_qp_delta
the effective-QP chain (`ks_inter_eff_qp`: one thread block per CTB for
its first coded CU and last planned QP, one warp per chain for the
prefix scan, one thread per 4x4 cell for the result), and the two
deblocking launches (csrc/deblock.cu); with SAO, the K8, K16 and K9
launches (csrc/sao_stats.cu, sao_decide.cu, sao_apply.cu).
"""

from __future__ import annotations

import numpy as np
import torch

from ..encode.sbh import apply_sbh
from ..interop import device_log_table, device_rank_table, device_tables
from . import _build
from .decide import _block_sum, _tree, fma32
from .deblock import deblock_frames
from .mc import mc_planes, no_l1
from .saoapply import sao_apply_frames
from .saodecide import sao_decide
from .saostats import sao_stats_frames
from .transforms import dequant_itx, forward_transform, quantize
from .wavefront import LevelSchedule, code_intra_frames_into

# the reference's class order: luma n, then its chroma n/2
CLASS_ORDER = ((True, 8), (False, 4), (True, 16), (False, 8), (True, 32),
               (False, 16))


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the trailing (n, n) axes in the reference
    backend's order for the level-bit sums: for n <= 16 lane r % 8 (r % 4
    at n = 4) takes row r's samples in column order, rows in order, then
    the lanes by halving; at n = 32, `_block_sum`."""
    n = x.shape[-1]
    if n == 32:
        return _block_sum(x)
    L = min(n, 8)
    acc = x[..., 0:L, 0]
    for c in range(1, n):
        acc = acc + x[..., 0:L, c]
    for r0 in range(L, n, L):
        for c in range(n):
            acc = acc + x[..., r0:r0 + L, c]
    return _tree(acc)


def _take(plane: torch.Tensor, xs, ys, n: int) -> torch.Tensor:
    d = torch.arange(n, device=plane.device)
    return plane[(ys[:, None] + d)[:, :, None], (xs[:, None] + d)[:, None, :]]


def _put(plane: torch.Tensor, blocks, xs, ys, n: int) -> None:
    d = torch.arange(n, device=plane.device)
    plane[(ys[:, None] + d)[:, :, None], (xs[:, None] + d)[:, None, :]] = \
        blocks.to(plane.dtype)


def tu_sums(resi: torch.Tensor, rr: torch.Tensor, lev: torch.Tensor):
    """(d_skip, d_coded, bits) float32 of TUs: residual, reconstructed
    residual and levels, each (K, n, n) int32."""
    rf = resi.to(torch.float32)
    df = (resi - rr).to(torch.float32)
    a = lev.abs()
    nz = a > 0
    lg = device_log_table(lev.device, True)[a.clamp(min=1).long()]
    S = _lane_sum(torch.where(nz, lg, 0.0))
    cnt = nz.sum((-2, -1)).to(torch.float32)
    bits = fma32(torch.tensor(3.1, dtype=torch.float32, device=a.device),
                 cnt, 2.0 * S)
    return _block_sum(rf * rf), _block_sum(df * df), bits


def _code_class(src, pred, xs, ys, qp, n: int, sbh: bool):
    """Levels, reconstructed residual and the three sums of one class."""
    log2 = n.bit_length() - 1
    resi = _take(src, xs, ys, n) - _take(pred, xs, ys, n)
    lev = quantize(forward_transform(resi, log2), qp, log2, intra=False)
    if sbh:
        lev = apply_sbh(lev, torch.zeros_like(qp), n)   # diagonal scan
    rr = dequant_itx(lev, qp, n)
    return lev, rr, tu_sums(resi, rr, lev)


def cu_table(tu_packs: dict, n_cu: int) -> np.ndarray:
    """(n_cu, 5) int32 per CU: its luma class (index in CLASS_ORDER), its
    entry there, its chroma class and its Cb and Cr entries."""
    tab = np.zeros((n_cu, 5), np.int32)
    for ci, key in enumerate(CLASS_ORDER):
        pack = tu_packs.get(key)
        if pack is None:
            continue
        cid = np.asarray(pack[3])
        valid = np.asarray(pack[4]).astype(bool)
        if key[0]:
            e = np.nonzero(valid)[0]
            tab[cid[e], 0] = ci
            tab[cid[e], 1] = e
        else:
            plane = np.asarray(pack[5])
            for pl, col in ((0, 3), (1, 4)):
                e = np.nonzero(valid & (plane == pl))[0]
                tab[cid[e], 2] = ci
                tab[cid[e], col] = e
    return tab


def bs_maps(cbf4, e2_v, e2_h, etb_v, etb_h, emv_v, emv_h, deblock: bool):
    """Spec 8.7.2.4 boundary strengths from the final maps and the luma
    cbf per 4x4: 2 across intra edges, 1 across TU edges with a coded
    side, else the motion strength."""
    cbf_l = torch.nn.functional.pad(cbf4, (1, 0))[:, :-1]
    cbf_t = torch.nn.functional.pad(cbf4, (0, 0, 1, 0))[:-1, :]
    bs_v = torch.where(e2_v, 2, torch.where(etb_v & (cbf4 | cbf_l), 1,
                                            emv_v.to(torch.int64)))
    bs_h = torch.where(e2_h, 2, torch.where(etb_h & (cbf4 | cbf_t), 1,
                                            emv_h.to(torch.int64)))
    if not deblock:
        bs_v, bs_h = torch.zeros_like(bs_v), torch.zeros_like(bs_h)
    return bs_v.to(torch.uint8), bs_h.to(torch.uint8)


# ------------------------------------------------------- plain PyTorch path

def cu_sums(si, pi, tu_packs: dict, n_cu: int, sbh: bool):
    """Per-CU float32 (d_skip, d_coded, bits) (3, n_cu + 1) of the plain
    path, and each class's (xs, ys, cid, valid, plane, lev, rr). si / pi:
    (y, cb, cr) int32 source and prediction planes; sbh: sign hiding."""
    dev = si[0].device
    results = {}
    acc = torch.zeros((3, n_cu + 1), dtype=torch.float32, device=dev)
    for key in CLASS_ORDER:
        pack = tu_packs.get(key)
        if pack is None:
            continue
        is_luma, n = key
        xs, ys, qp, cid, valid = (a.to(dev) for a in pack[:5])
        xs, ys, qp, cid = xs.long(), ys.long(), qp.to(torch.int32), \
            cid.long()
        valid = valid.bool()
        a = torch.zeros_like(acc)
        if is_luma:
            lev, rr, sums = _code_class(si[0], pi[0], xs, ys, qp, n, sbh)
            for i in range(3):
                a[i, cid[valid]] = sums[i][valid]
            plane = None
        else:
            plane = pack[5].to(dev).long()
            lev = torch.zeros((len(xs), n, n), dtype=torch.int32,
                              device=dev)
            rr = torch.zeros_like(lev)
            bits = torch.zeros(len(xs), dtype=torch.float32, device=dev)
            for pl in (0, 1):
                m = plane == pl
                lv, r2, sums = _code_class(si[1 + pl], pi[1 + pl], xs[m],
                                           ys[m], qp[m], n, sbh)
                lev[m], rr[m], bits[m] = lv, r2, sums[2]
            # chroma adds rate, not distortion; Cb then Cr per CU
            for pl in (0, 1):
                m = valid & (plane == pl)
                a[2, cid[m]] = a[2, cid[m]] + bits[m]
        acc = acc + a
        results[key] = (xs, ys, cid, valid, plane, lev, rr)
    return acc, results



def code_inter_frame_plain(src, refs, slot0, mv0, l1, tu_packs, cu_lam,
                           intra_sched, n_cu: int, h8: int, w8: int,
                           pic_w: int, pic_h: int, strong: bool, sbh: bool,
                           wts=(None, None)):
    """Steps 1-5 on the plain path: returns (pred, rec, coef, cbf4), each
    plane set a (y, cb, cr) tuple; rec is pre-deblocking. l1: list 1's
    (slot1, mv1), or None; wts: the two lists' weight tables or Nones."""
    dev = src[0].device
    si = [p.to(torch.int32) for p in src]
    pred = mc_planes(refs, slot0, mv0, *(l1 or no_l1(slot0, mv0)),
                     l1 is not None, h8, w8, pic_w, pic_h, reference=True,
                     wts0=wts[0], wts1=wts[1])
    pi = [p.to(torch.int32) for p in pred]
    acc, results = cu_sums(si, pi, tu_packs, n_cu, sbh)
    d_skip, d_coded, bits = acc
    drop = (d_skip - d_coded) <= cu_lam.to(dev) * (bits + 10.0)
    rec = [p.clone() for p in pi]
    coef = [torch.zeros(p.shape, dtype=torch.int16, device=dev)
            for p in src]
    cbf4 = torch.zeros((src[0].shape[0] // 4, src[0].shape[1] // 4),
                       dtype=torch.bool, device=dev)
    for key in CLASS_ORDER:
        if key not in results:
            continue
        is_luma, n = key
        xs, ys, cid, valid, plane, lev, rr = results[key]
        dcu = drop[cid.clamp(0, n_cu)][:, None, None]
        lev = torch.where(dcu, 0, lev)
        for pl in ((0,) if is_luma else (1, 2)):
            m = valid if is_luma else valid & (plane == pl - 1)
            r = (_take(pi[pl], xs[m], ys[m], n)
                 + torch.where(dcu[m], 0, rr[m])).clamp(0, 255)
            _put(rec[pl], r, xs[m], ys[m], n)
            _put(coef[pl], lev[m], xs[m], ys[m], n)
        if is_luma:
            nz = (lev != 0).any(-1).any(-1) & valid
            n4 = n // 4
            for k in torch.nonzero(nz)[:, 0].tolist():
                y4, x4 = int(ys[k]) >> 2, int(xs[k]) >> 2
                cbf4[y4:y4 + n4, x4:x4 + n4] = True
    rec = [r.to(torch.uint8) for r in rec]
    return pred, rec, coef, cbf4


# ------------------------------------------------------------- CUDA kernel

def _i32(a, dev):
    return a.to(device=dev, dtype=torch.int32).contiguous()


def code_inter_frame_cuda(src, refs, slot0, mv0, l1, tu_packs, cu_lam,
                          intra_sched, n_cu: int, h8: int, w8: int,
                          pic_w: int, pic_h: int, strong: bool, sbh: bool,
                          wts=(None, None)):
    """Steps 1-5 on the card (see the module note)."""
    for t in tuple(src) + tuple(refs):
        if t.dtype != torch.uint8 or not t.is_cuda or not t.is_contiguous():
            raise ValueError("planes must be contiguous uint8 CUDA tensors")
    dev = src[0].device
    lib = _build.kernels()
    st = _build.stream(dev)
    P = _build.ptr
    tab = device_tables(dev)
    R, H, W = refs[0].shape
    pred = mc_planes(refs, slot0, mv0, *(l1 or no_l1(slot0, mv0)),
                     l1 is not None, h8, w8, pic_w, pic_h, wts0=wts[0],
                     wts1=wts[1])
    ctab = torch.as_tensor(cu_table(tu_packs, n_cu), device=dev)
    cls = []
    sums = torch.zeros((len(CLASS_ORDER), 3, max(
        [len(p[0]) for p in tu_packs.values()] + [1])),
        dtype=torch.float32, device=dev)
    for ci, key in enumerate(CLASS_ORDER):
        pack = tu_packs.get(key)
        if pack is None:
            cls.append(None)
            continue
        is_luma, n = key
        K = len(pack[0])
        f = [_i32(a, dev) for a in pack[:5]]
        plane = _i32(pack[5], dev) if not is_luma else \
            torch.zeros(K, dtype=torch.int32, device=dev)
        lev = torch.empty((K, n, n), dtype=torch.int32, device=dev)
        rr = torch.empty_like(lev)
        _build.check(lib.ks_inter_tu_class(
            P(src[0]), P(src[1]), P(src[2]), P(pred[0]), P(pred[1]),
            P(pred[2]), P(f[0]), P(f[1]), P(f[2]), P(plane), P(f[4]),
            P(lev), P(rr), P(sums[ci]), P(tab),
            P(device_log_table(dev, True)), P(device_rank_table(dev)), K,
            sums.shape[2], n, int(is_luma), int(sbh), H, W, st),
            "ks_inter_tu_class")
        _build.count("inter_tu_class")
        if sbh:
            _build.count("inter_tu_class_k2")   # K2's sign hiding inlined
        cls.append((f, plane, lev, rr, K))
    drop = torch.empty(n_cu + 1, dtype=torch.int32, device=dev)
    _build.check(lib.ks_inter_gate(P(sums), P(ctab), P(_f32(cu_lam, dev)),
                                   P(drop), n_cu, sums.shape[2], st),
                 "ks_inter_gate")
    _build.count("inter_gate")
    rec = [p.clone() for p in pred]
    coef = [torch.zeros(p.shape, dtype=torch.int16, device=dev)
            for p in src]
    cbf4 = torch.zeros((H // 4, W // 4), dtype=torch.uint8, device=dev)
    for key, c in zip(CLASS_ORDER, cls):
        if c is None:
            continue
        is_luma, n = key
        f, plane, lev, rr, K = c
        _build.check(lib.ks_inter_finish(
            P(pred[0]), P(pred[1]), P(pred[2]), P(f[0]), P(f[1]), P(f[3]),
            P(plane), P(f[4]), P(lev), P(rr), P(drop), P(rec[0]),
            P(rec[1]), P(rec[2]), P(coef[0]), P(coef[1]), P(coef[2]),
            P(cbf4), K, n, int(is_luma), n_cu, H, W, st), "ks_inter_finish")
        _build.count("inter_finish")
    return pred, rec, coef, cbf4.bool()


def _f32(a, dev):
    return a.to(device=dev, dtype=torch.float32).contiguous()


def bs_maps_cuda(cbf4, e2_v, e2_h, etb_v, etb_h, emv_v, emv_h,
                 deblock: bool):
    dev = cbf4.device
    h4, w4 = cbf4.shape
    u8 = [a.to(device=dev, dtype=torch.uint8).contiguous()
          for a in (cbf4, e2_v, e2_h, etb_v, etb_h, emv_v, emv_h)]
    bs_v = torch.empty((h4, w4), dtype=torch.uint8, device=dev)
    bs_h = torch.empty_like(bs_v)
    P = _build.ptr
    _build.check(_build.kernels().ks_inter_bs(
        *(P(a) for a in u8), P(bs_v), P(bs_h), h4, w4, int(deblock),
        _build.stream(dev)), "ks_inter_bs")
    _build.count("inter_bs")
    return bs_v, bs_h


# ------------------------------------------------- the effective-QP chain

def coded4(coef) -> torch.Tensor:
    """(H/4, W/4) bool: any nonzero level of any plane in each 4x4 luma
    cell (its 2x2 chroma cells)."""
    y, cb, cr = coef
    h4, w4 = y.shape[0] // 4, y.shape[1] // 4
    nz = lambda c, k: (c.reshape(h4, k, w4, k) != 0).any(3).any(1)
    return nz(y, 4) | nz(cb, 2) | nz(cr, 2)


def effective_qp4_plain(qp4, cbf4, zin4, zcu4, slice_qp: int, wpp: bool,
                        cs: int, pic_w: int, pic_h: int) -> torch.Tensor:
    """The reference's `_effective_qp4`: qp4 (H/4, W/4) planned QPs, cbf4
    per-cell coefficients (`coded4`), zin4 each cell's z value inside its
    CTB, zcu4 the z value of its CU's origin. Returns the int32 QPs the
    decoder derives."""
    dev = qp4.device
    c4 = cs >> 2
    h4, w4 = qp4.shape
    nr, nc = h4 // c4, w4 // c4

    def blk(a):
        return a.reshape(nr, c4, nc, c4).transpose(1, 2).reshape(nr, nc, -1)

    y4 = torch.arange(h4, device=dev)[:, None]
    x4 = torch.arange(w4, device=dev)[None, :]
    valid = (x4 < (pic_w >> 2)) & (y4 < (pic_h >> 2))
    zin4, zcu4 = (z.to(dev, torch.int64).expand(h4, w4) for z in (zin4, zcu4))
    cb = blk(cbf4.to(dev).bool() & valid)
    zfirst = torch.where(cb, blk(zcu4), 1 << 30).min(-1).values
    anyc = cb.any(-1)
    zlast = torch.where(blk(valid.expand(h4, w4)), blk(zin4), -1)
    li = zlast.argmax(-1, keepdim=True)
    planned_last = blk(qp4.to(dev, torch.int64)).gather(-1, li)[..., 0]
    if wpp:
        idx = torch.where(anyc, torch.arange(nc, device=dev)[None, :], -1)
        excl = torch.cat([torch.full((nr, 1), -1, device=dev), idx[:, :-1]],
                         1)
        last = excl.cummax(1).values
        qprev = torch.where(last >= 0,
                            planned_last.gather(1, last.clamp(min=0)),
                            slice_qp)
    else:
        idx = torch.where(anyc.reshape(-1),
                          torch.arange(nr * nc, device=dev), -1)
        excl = torch.cat([torch.full((1,), -1, device=dev), idx[:-1]])
        last = excl.cummax(0).values
        qprev = torch.where(last >= 0,
                            planned_last.reshape(-1)[last.clamp(min=0)],
                            slice_qp).reshape(nr, nc)
    up = lambda a: a.repeat_interleave(c4, 0).repeat_interleave(c4, 1)
    before = zin4 < up(zfirst)
    return torch.where(before, up(qprev), qp4.to(dev, torch.int64)) \
        .to(torch.int32)


def effective_qp4_cuda(qp4, coef, zin4, zcu4, slice_qp: int, wpp: bool,
                       cs: int, pic_w: int, pic_h: int) -> torch.Tensor:
    """`effective_qp4_plain` on the card, the per-cell coefficient flags
    taken from the (y, cb, cr) int16 level planes; returns uint8 QPs."""
    dev = coef[0].device
    h4, w4 = qp4.shape
    c4 = cs >> 2
    if h4 % c4 or w4 % c4 or c4 * c4 > 1024:
        raise ValueError("the 4x4 grid must cover whole CTBs")
    nctb = (h4 // c4) * (w4 // c4)
    i32 = [a.to(device=dev, dtype=torch.int32).contiguous()
           for a in (qp4, zin4.expand(h4, w4), zcu4.expand(h4, w4))]
    for c in coef:
        if c.dtype != torch.int16 or not c.is_contiguous():
            raise ValueError("level planes must be contiguous int16")
    scratch = torch.empty((4, nctb), dtype=torch.int32, device=dev)
    out = torch.empty((h4, w4), dtype=torch.uint8, device=dev)
    P = _build.ptr
    _build.check(_build.kernels().ks_inter_eff_qp(
        P(i32[0]), P(coef[0]), P(coef[1]), P(coef[2]), P(i32[1]),
        P(i32[2]), P(scratch), P(out), h4, w4, c4, pic_w, pic_h, slice_qp,
        int(wpp), _build.stream(dev)), "ks_inter_eff_qp")
    for step in ("ctb", "scan", "apply"):       # its three launches
        _build.count("inter_eff_qp_" + step)
    return out


def effective_qp4(qp4, coef, zin4, zcu4, slice_qp: int, wpp: bool, cs: int,
                  pic_w: int, pic_h: int, reference: bool = False):
    """The decoder's effective QP per 4x4 cell under cu_qp_delta from the
    final level planes coef (y, cb, cr). CUDA planes launch the kernel;
    CPU planes, or reference=True, run `effective_qp4_plain`."""
    dev = coef[0].device
    if dev.type != "cuda" or reference:
        return effective_qp4_plain(qp4.to(dev), coded4(coef), zin4, zcu4,
                                   slice_qp, wpp, cs, pic_w, pic_h)
    return effective_qp4_cuda(qp4, coef, zin4, zcu4, slice_qp, wpp, cs,
                              pic_w, pic_h)


# ------------------------------------------------------------- entry point

def sao_picture(rec, src, tier: int, qp: int, pic_w: int, pic_h: int,
                cs: int, reference: bool = False):
    """SAO of one deblocked picture as the reference's inter coding pass
    runs it: K8 statistics against the sources (EO classes 0/1 at tier 1,
    all four above; band offset and chroma from tier 3), the K16 decision
    and K9 (luma always, chroma from tier 3). rec/src (y, cb, cr) uint8
    planes. Returns the filtered planes and the (type, offs, bpos, eocl)
    int8 parameters."""
    ncl, bo = (2 if tier <= 1 else 4), tier >= 3
    stats = []
    for r, s, sh in list(zip(rec, src, (0, 1, 1)))[:3 if bo else 1]:
        st = sao_stats_frames(r[None], s[None], pic_w >> sh, pic_h >> sh,
                              cs >> sh, ncl, bo, reference=reference)
        stats.append(tuple(a[0] if a is not None else None for a in st))
    prm = sao_decide(stats, qp, tier, reference=reference)
    out = sao_apply_frames(*(r[None] for r in rec), *(p[None] for p in prm),
                           True, bo, pic_w, pic_h, cs, reference=reference)
    return tuple(o[0] for o in out), prm


def code_inter_frame(src, refs, slot0, mv0, tu_packs: dict, cu_lam,
                     intra_sched: LevelSchedule | None, bs_in, qp4,
                     n_cu: int, h8: int, w8: int, pic_w: int, pic_h: int,
                     boff: int, toff: int, cbo: int, cro: int,
                     deblock: bool, strong: bool, reference: bool = False,
                     want_pred: bool = False, sao=None, sbh: bool = False,
                     slot1=None, mv1=None, has_l1: bool = False,
                     wts0=None, wts1=None, dqp=None):
    """Code one P or B picture. src (y, cb, cr) uint8 planes, refs (R, ...)
    uint8 stacks; slot0 (h8*w8,), mv0 (h8*w8, 2) per-cell motion, and
    with has_l1 (a B picture) list 1's slot1 / mv1 (slot -1: the list is
    unused; a cell with neither list, an intra cell, carries slot0 = 0);
    tu_packs:
    {(is_luma, n): (xs, ys, qp, cu_id, valid[, plane])}; cu_lam
    (n_cu + 1,) float32; intra_sched: the intra CUs' schedule or None;
    bs_in: (e2_v, e2_h, etb_v, etb_h, emv_v, emv_h) per 4x4; qp4 per 4x4;
    sao: None, or (tier, slice_qp, ctb_size) to run `sao_picture`; sbh:
    sign hiding (the PPS's sign_data_hiding_enabled); wts0 / wts1: the
    lists' explicit weighted-prediction tables (ops/mc.py::cell_weights)
    or None; dqp: None, or under cu_qp_delta (zin4, zcu4, slice_qp, wpp,
    ctb_size) for `effective_qp4`, whose QPs the deblocking filter then
    reads.
    Returns ((y, cb, cr) deblocked (and SAO-filtered) uint8 planes,
    (y, cb, cr) int16 levels, the SAO parameters or None[, (y, cb, cr) MC
    prediction]). CUDA planes launch the kernels; CPU planes, or
    reference=True, run the plain version."""
    dev = src[0].device
    plain = dev.type != "cuda" or reference
    fn = code_inter_frame_plain if plain else code_inter_frame_cuda
    l1 = (slot1.to(dev), mv1.to(dev)) if has_l1 else None
    pred, rec, coef, cbf4 = fn(src, refs, slot0.to(dev), mv0.to(dev), l1,
                               tu_packs, cu_lam, intra_sched, n_cu, h8, w8,
                               pic_w, pic_h, strong, sbh, (wts0, wts1))
    if intra_sched is not None:
        rec = [r[None].contiguous() for r in rec]
        coef = [c[None].contiguous() for c in coef]
        code_intra_frames_into(tuple(s[None].contiguous() for s in src),
                               rec, coef, intra_sched, strong, sbh=sbh,
                               rdoq=False, reference=reference)
        rec = [r[0] for r in rec]
        coef = [c[0] for c in coef]
    bs_in = [a.to(dev) for a in bs_in]
    bs_fn = bs_maps if plain else bs_maps_cuda
    bs_v, bs_h = bs_fn(cbf4, *bs_in, deblock)
    if dqp is not None:
        zin4, zcu4, slice_qp, wpp, cs = dqp
        qp4 = effective_qp4(qp4, coef, zin4, zcu4, slice_qp, wpp, cs,
                            pic_w, pic_h, reference=reference)
    out = deblock_frames(*(r[None] for r in rec), bs_v[None], bs_h[None],
                         qp4.to(device=dev, dtype=torch.uint8)[None], boff,
                         toff, cbo, cro, pic_w, pic_h, reference=reference)
    planes = tuple(o[0] for o in out)
    prm = None
    if sao is not None:
        tier, qp, cs = sao
        planes, prm = sao_picture(planes, src, tier, qp, pic_w, pic_h, cs,
                                  reference=reference)
    if want_pred:
        return planes, tuple(coef), prm, tuple(pred)
    return planes, tuple(coef), prm
