"""Decoder fast path for P and B pictures: host-side assembly around K18
(ops/wavefront.py::recon_inter_filter).

The port's rewrite of ks265codec_tpu/decode/interfast.py. For streams
inside the fast path's coverage (TU == CU, PUs of at least 8x8 per
dimension, checked by slice_dec's FastPathAbort gates; everything the
encoder writes) the whole picture reconstructs on the decoder's device
from the parsed fields: K14 MC from the per-8x8-cell motion of one or
both lists (with the slice's explicit weighted-prediction tables where it
carries them), the inter TUs' residual, the intra CUs over it (K11), K7
and K9, with the parse's QPs, which under cu_qp_delta are the effective
ones.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hevc.tables import chroma_qp


def _slot_tables(ref_lists):
    """Unique reference FrameStates -> plane-stack slot per list entry."""
    uniq = []
    slot_of = {}
    for lst in ref_lists:
        for rp in lst:
            if id(rp.fs) not in slot_of:
                slot_of[id(rp.fs)] = len(uniq)
                uniq.append(rp.fs)
    return uniq, slot_of


def _ref_stacks(uniq, dev):
    """(refs_y, refs_cb, refs_cr) uint8 stacks on dev. A reference whose
    reconstruction is still on the device (an earlier fast-path picture)
    stays there; host planes are COPIED before the upload, since
    torch.from_numpy aliases numpy memory and a reference frame can leave
    the DPB and be recycled (FrameState.reset refills its buffers) while
    this picture's computation still reads it."""
    stacks = ([], [], [])
    for fs in uniq:
        dev_planes = getattr(fs, "_dev_planes", None)
        if dev_planes is not None and getattr(fs, "_planes_stale", False):
            planes = [p.t.to(dev) for p in dev_planes]
        else:
            planes = [torch.from_numpy(np.array(p, np.uint8)).to(dev)
                      for p in (fs.y, fs.cb, fs.cr)]
        for s, p in zip(stacks, planes):
            s.append(p)
    return tuple(torch.stack(s).contiguous() for s in stacks)


def _intra_sched(coder, fs, sps, pps, hdr, log2m8, intra8):
    """The level schedule of the picture's intra CUs (or None)."""
    from ..encode.merge_vec import zscan_vals
    from ..ops.wavefront import intra_subset, pack_records
    if not intra8.any():
        return None
    sched = coder.build_schedule(log2m8, sps.width, sps.height,
                                 sps.log2_ctb, sps.log2_min_cb)
    sub = intra_subset(sched, intra8,
                       zscan_vals(fs.ph >> 2, fs.pw >> 2, sps.log2_ctb))
    modes8 = np.where(intra8, fs.intra_mode[::2, ::2], 1).astype(np.int32)
    cmodes8 = np.asarray(fs.dec_cmode8, np.int32)
    qp_map8 = np.clip(fs.qp[::2, ::2], 0, 51).astype(np.int32)
    return pack_records([(sub, modes8, cmodes8, qp_map8)],
                        pps.cb_qp_offset + hdr.cb_qp_offset,
                        pps.cr_qp_offset + hdr.cr_qp_offset)


def recon_inter_picture(wf_coder, fs, sps, pps, hdr, ref_lists, sao_params,
                        dev, reference: bool = False):
    """Reconstruction of a parse-only P or B picture on dev (K18). sao_params:
    (type, offs, bpos, eocl) int8 numpy arrays, or None for no SAO.
    Returns the (y, cb, cr) uint8 planes on dev."""
    from ..ops.mc import wp_tables
    from ..ops.wavefront import recon_inter_filter
    from ..utils.trace import stage
    from .filters import compute_bs
    parsed8 = fs.mi_parsed[::2, ::2]
    log2m8 = np.where(parsed8,
                      sps.log2_ctb - fs.cu_depth[::2, ::2].astype(np.int32),
                      3).astype(np.uint8)
    intra8 = parsed8 & (fs.pred_mode[::2, ::2] == 1)
    inter8 = parsed8 & (fs.pred_mode[::2, ::2] == 0)
    uniq, slot_of = _slot_tables(ref_lists)
    wts0, wts1 = wp_tables(hdr, ref_lists, slot_of, len(uniq))
    # per-8x8-cell motion (uniform per cell by the sub-8-PU parse gate):
    # slot -1 where a list is unused; intra and unparsed cells (neither
    # list) predict throwaway samples from slot 0 of list 0
    ref8 = fs.ref_idx[:, ::2, ::2].astype(np.int32)
    slots = []
    for l in range(2):
        tab = np.array([slot_of[id(rp.fs)] for rp in ref_lists[l]] + [0],
                       np.int32)
        slots.append(np.where(ref8[l] >= 0,
                              tab[np.clip(ref8[l], 0, len(tab) - 1)], -1)
                     .astype(np.int32).reshape(-1))
    slot0, slot1 = slots
    slot0 = np.where((slot0 < 0) & (slot1 < 0), 0, slot0)
    has_l1 = bool((ref8[1] >= 0).any())
    mv0, mv1 = (np.ascontiguousarray(fs.mv[l, ::2, ::2].reshape(-1, 2),
                                     np.int32) for l in range(2))
    qp4 = np.clip(fs.qp, 0, 51).astype(np.int32)
    cqps = [np.array([chroma_qp(min(q + po + so, 57)) for q in range(64)],
                     np.int32)[qp4][::2, ::2]
            for po, so in ((pps.cb_qp_offset, hdr.cb_qp_offset),
                           (pps.cr_qp_offset, hdr.cr_qp_offset))]
    T = torch.from_numpy
    with stage("dec.inter_prep"):
        sched = _intra_sched(wf_coder, fs, sps, pps, hdr, log2m8, intra8)
        refs = _ref_stacks(uniq, dev)
        # the levels are copied: the parse planes belong to the
        # FrameState, which the pool recycles
        coefs = tuple(T(np.array(a, np.int16)).to(dev)
                      for a in (fs.dec_coef_y, fs.dec_coef_cb,
                                fs.dec_coef_cr))
        sp = None
        if sao_params is not None:
            sp = tuple(T(np.asarray(a, np.int8)).to(dev) for a in sao_params)
        bs = [T(np.asarray(compute_bs(fs, v), np.uint8)) for v in (True,
                                                                   False)]
    return recon_inter_filter(
        refs, T(slot0), T(mv0), coefs, T(log2m8), T(qp4),
        T(cqps[0]), T(cqps[1]), T(inter8), sched, *bs, sp,
        bool(sps.strong_intra_smoothing),
        not bool(hdr.deblocking_filter_disabled), bool(hdr.sao_chroma),
        hdr.beta_offset_div2, hdr.tc_offset_div2, pps.cb_qp_offset,
        pps.cr_qp_offset, sps.width, sps.height, sps.ctb_size,
        reference=reference, slot1=T(slot1), mv1=T(mv1), has_l1=has_l1,
        wts0=wts0, wts1=wts1)
