"""What the redesigned K5 and K11 kernels read, on the CPU, exact against
ks265codec_tpu.

K11 is one persistent launch per call: blocks take the CUs of
`LevelSchedule.tickets` (`ops/wavefront.py::ticket_order`: the valid
records in level, then frame order, each with its frame and its frame's
count of lower-level CUs) from a counter, and a CU starts once its
frame's completion counter reaches that count. A plain walk of that
scheme here, with a few simulated blocks that take tickets in order and
finish out of order, must reconstruct every CU only once the counters
allow it, never stall, and give the planes of `recon_intra_frames_plain`
and of the JAX package's `recon_frame` (tiles 2x2 and none; two XLA
compiles, about 15 s each on one core, once per test run), and of the
seeded form over a P picture's intra CUs (`intra_subset`).

K5's pass A works on compact candidate lists (`candidate_list`) in the
seeded tiers: they must hold the reference's seeded set, and
`pass_a_plain` (the kernel's plain version: SATDs at the candidates,
best0) must equal the JAX package's own source refs, predictions and
SATDs at 128x96 for every tier.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ks265codec_tpu.ops import cost as jcost
from ks265codec_tpu.ops import decide as jdec
from ks265codec_tpu.ops import intra as jintra
from ks265codec_tpu.ops.wavefront import WavefrontIntraCoder as JaxCoder
from ks265codec_tpu_torch.encode.config import EncoderConfig
from ks265codec_tpu_torch.encode.encoder import HevcEncoder
from ks265codec_tpu_torch.encode.intra_frame import (decision_maps8,
                                                     tile_region_maps)
from ks265codec_tpu_torch.encode.merge_vec import zscan_vals
from ks265codec_tpu_torch.ops import decide as tdec
from ks265codec_tpu_torch.ops import wavefront as twf
from _torch_shared import release_after_module, shared  # noqa: F401

W, H = 128, 96


def _case(tiles: str, F: int, seed: int):
    """F random pictures at 128x96: CU maps, modes, per-CTB QPs, chroma
    QP offsets, sparse random levels; the encoder's SPS and tile map."""
    enc = HevcEncoder(EncoderConfig(width=W, height=H, preset="ultrafast",
                                    intra_period=1, tiles=tiles, qp=30),
                      device="cpu")
    sps, pps = enc.sps, enc.pps
    rng = np.random.RandomState(seed)
    ph = sps.pic_height_in_ctbs * sps.ctb_size
    pw = sps.pic_width_in_ctbs * sps.ctb_size
    h8, w8 = ph >> 3, pw >> 3
    tile8 = tile_region_maps(pps, sps)[1]
    items, levels = [], []
    for _ in range(F):
        log2m, modes8, cmodes8 = decision_maps8(
            rng.rand(ph // 32, pw // 32) < 0.5,
            rng.rand(ph // 16, pw // 16) < 0.5, rng.randint(0, 35, (h8, w8)),
            rng.randint(0, 35, (ph // 16, pw // 16)),
            rng.randint(0, 35, (ph // 32, pw // 32)), sps, h8, w8,
            rng.choice([0, 1, 10, 26, 34], (h8, w8)),
            rng.choice([0, 1, 10, 26, 34], (ph // 16, pw // 16)),
            rng.choice([0, 1, 10, 26, 34], (ph // 32, pw // 32)))
        qp_ctb = rng.randint(0, 52, (sps.pic_height_in_ctbs,
                                     sps.pic_width_in_ctbs))
        items.append(dict(log2m=log2m, modes8=modes8, cmodes8=cmodes8,
                          qp_map8=np.repeat(np.repeat(qp_ctb, 8, 0), 8, 1)
                          .astype(np.int32), tile8=tile8))

        def lev(h, w):
            mag = rng.geometric(0.5, (h, w)) * rng.choice([-1, 1], (h, w))
            return np.where(rng.rand(h, w) < 0.04, mag, 0).astype(np.int16)

        levels.append([lev(ph, pw), lev(ph // 2, pw // 2),
                       lev(ph // 2, pw // 2)])
    return sps, items, levels


def _jax_recons():
    out = {}
    for tiles in ("", "2x2"):
        sps, items, levels = _case(tiles, 2, 11)
        out[tiles] = [[np.asarray(p) for p in JaxCoder().recon_frame(
            *lv, it["log2m"], it["modes8"], it["cmodes8"], it["qp_map8"], 2,
            -3, sps, tile8=it["tile8"])] for it, lv in zip(items, levels)]
    return out


@pytest.fixture(scope="module")
def jax_recons(tmp_path_factory):
    return shared(tmp_path_factory, {"redesign_k11_jax": _jax_recons})[
        "redesign_k11_jax"]


def ticket_walk(levs, recs, sched, strong: bool, blocks: int):
    """Plain model of the persistent K11 in place over recs: `blocks`
    simulated blocks take tickets in order, one each; every round each
    holder whose frame's completion counter has reached its ticket's WAIT
    reconstructs its CU (the last block first, so CUs finish out of ticket
    order) and bumps the counter. Asserts that a CU starts only once every
    lower-level CU of its frame is done, and that the walk never stalls.
    Returns the tickets in the order their CUs finished."""
    T = np.asarray(sched.tickets)
    level = np.zeros(len(T), np.int64)
    start = 0
    for li, (base, kmax) in enumerate(sched.levels):
        lvl = np.asarray(sched.recs)[base:base + sched.n_frames * kmax]
        k = int((lvl[:, twf.VALID] == 1).sum())
        level[start:start + k] = li
        start += k
    done = np.zeros(sched.n_frames, np.int64)
    finished = np.zeros(len(T), bool)
    held, nxt, order = [None] * blocks, 0, []
    while len(order) < len(T):
        progress = False
        for b in range(blocks):
            if held[b] is None and nxt < len(T):
                held[b], nxt, progress = nxt, nxt + 1, True
        for b in reversed(range(blocks)):
            t = held[b]
            if t is None:
                continue
            f = int(T[t, twf.FRAME])
            if done[f] < T[t, twf.WAIT]:
                continue
            lower = (T[:, twf.FRAME] == f) & (level < level[t])
            assert finished[lower].all(), "a CU started before its level"
            r = torch.as_tensor(T[t:t + 1].astype(np.int64))
            fi = torch.tensor([f])
            twf._blocks(None, recs[0], levs[0], fi, r[:, twf.X], r[:, twf.Y],
                        r[:, twf.MODE], r[:, twf.QP], r[:, twf.AL],
                        r[:, twf.AC], r[:, twf.AT], int(r[0, twf.SIZE]), 0,
                        strong, False, False)
            for c, qf in ((1, twf.QPCB), (2, twf.QPCR)):
                twf._blocks(None, recs[c], levs[c], fi, r[:, twf.X] >> 1,
                            r[:, twf.Y] >> 1, r[:, twf.CMODE], r[:, qf],
                            r[:, twf.AL], r[:, twf.AC], r[:, twf.AT],
                            int(r[0, twf.SIZE]) // 2, c, False, False, False)
            done[f] += 1
            finished[t] = True
            held[b] = None
            order.append(t)
            progress = True
        assert progress, "the ticket walk stalled"
    return order


def test_ticket_order_compacts_and_orders():
    """The tickets are the valid records alone, in level then frame order,
    each with its frame and its frame's count of lower-level CUs."""
    sps, items, _ = _case("2x2", 3, 5)
    sched = twf.WavefrontIntraCoder().pack(items, 2, -3, sps)
    T = sched.tickets
    recs = sched.recs
    assert T.shape == (int((recs[:, twf.VALID] == 1).sum()), twf.TFIELDS)
    assert (T[:, twf.VALID] == 1).all()
    key, below = [], np.zeros(3, np.int64)
    for li, (base, kmax) in enumerate(sched.levels):
        lvl = recs[base:base + 3 * kmax].reshape(3, kmax, twf.NFIELDS)
        for f in range(3):
            rows = lvl[f][lvl[f][:, twf.VALID] == 1]
            key += [(li, f, tuple(r), below[f]) for r in rows]
        below += (lvl[..., twf.VALID] == 1).sum(1)
    assert [(tuple(t[:twf.NFIELDS]), t[twf.FRAME], t[twf.WAIT]) for t in T] \
        == [(r, f, w) for _, f, r, w in key]
    assert sched.to("cpu").tickets.shape == T.shape


@pytest.mark.parametrize("blocks", [1, 3, 8])
@pytest.mark.parametrize("tiles", ["", "2x2"])
def test_ticket_walk_matches_plain_and_reference(jax_recons, tiles, blocks):
    """The walk in ticket order over two pictures equals the level-by-level
    plain K11 and the JAX package's reconstruction of each picture."""
    sps, items, levels = _case(tiles, 2, 11)
    sched = twf.WavefrontIntraCoder().pack(items, 2, -3, sps)
    levs = [torch.from_numpy(np.stack([lv[c] for lv in levels]))
            for c in range(3)]
    recs = [torch.zeros(lv.shape, dtype=torch.uint8) for lv in levs]
    order = ticket_walk(levs, recs, sched, bool(sps.strong_intra_smoothing),
                        blocks)
    if blocks > 1:
        assert order != sorted(order)       # CUs finished out of order
    want = twf.recon_intra_frames(*levs, sched,
                                  bool(sps.strong_intra_smoothing))
    for a, b in zip(recs, want):
        assert torch.equal(a, b)
    for f in range(2):
        for c in range(3):
            assert np.array_equal(recs[c][f].numpy(), jax_recons[tiles][f][c])


@pytest.mark.parametrize("blocks", [1, 4])
def test_ticket_walk_over_a_p_pictures_intra_cus(blocks):
    """The seeded form: the intra CUs of a P picture (`intra_subset`, own
    levels) walked in ticket order in place over inter samples equal the
    plain seeded K11."""
    sps, items, levels = _case("", 1, 23)
    it = items[0]
    rng = np.random.RandomState(3)
    h8, w8 = it["log2m"].shape
    coder = twf.WavefrontIntraCoder()
    full = coder.build_schedule(it["log2m"], sps.width, sps.height,
                                sps.log2_ctb, sps.log2_min_cb)
    intra8 = np.repeat(np.repeat(rng.rand((h8 + 3) // 4, (w8 + 3) // 4)
                                 < 0.5, 4, 0), 4, 1)[:h8, :w8]
    sub = twf.intra_subset(full, intra8,
                           zscan_vals(h8 * 2, w8 * 2, sps.log2_ctb))
    assert 0 < len(sub[0]) < len(full[0])
    sched = twf.pack_records([(sub, it["modes8"], it["cmodes8"],
                               it["qp_map8"])], 1, 2)
    levs = [torch.from_numpy(lv[None]) for lv in levels[0]]
    base = [torch.from_numpy(rng.randint(0, 256, tuple(lv.shape))
                             .astype(np.uint8)) for lv in levs]
    got = [b.clone() for b in base]
    want = [b.clone() for b in base]
    ticket_walk(levs, got, sched, True, blocks)
    twf.recon_intra_frames_into(levs, want, sched, True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_candidate_list_is_the_seeded_set():
    """Each seeded CU's list holds the reference's seeded candidates
    (parent, its two angular neighbours, planar, DC, 26, 10) once each, in
    that order, a repeat becoming -1."""
    par = torch.arange(35)
    got = tdec.candidate_list(par).numpy()
    for p in range(35):
        a = max(p, 2)
        ref = [p, 2 + ((a - 2 + 1) % 33) if p >= 2 else 0,
               2 + ((a - 2 + 32) % 33) if p >= 2 else 1, 0, 1, 26, 10]
        want = [m if m not in ref[:i] else -1 for i, m in enumerate(ref)]
        assert got[p].tolist() == want


@pytest.mark.parametrize("n,seeded", [(16, False), (8, False), (32, False),
                                      (8, True), (32, True)])
def test_pass_a_plain_matches_reference(n, seeded):
    """`pass_a_plain` (pass A's SATDs at the candidates, 0 elsewhere, and
    best0) against the JAX package's source refs, [1 2 1] filter,
    35-mode prediction and 8x8 SATD on two textured 128x96 frames, the
    seeded tiers on the 16 tier's modes through the reference's
    candidate rule."""
    rng = np.random.RandomState(n + seeded)
    yy, xx = np.mgrid[0:H, 0:W]
    planes = np.stack([np.clip(128 + 60 * np.sin((xx + 9 * t) / 11.0)
                               * np.cos(yy / 7.0) + rng.randn(H, W) * 8,
                               0, 255) for t in range(2)]).astype(np.uint8)
    seed16 = (torch.from_numpy(rng.randint(0, 35, (2, H // 16, W // 16))
                               .astype(np.int32)) if seeded else None)
    satd, best0 = tdec.pass_a_plain(torch.from_numpy(planes), n, seed16)
    for f in range(2):
        p = jnp.asarray(planes[f].astype(np.int32))
        refs = jdec._source_refs(p, n).reshape(-1, 4 * n + 1)
        refs_f = jdec._filter_refs(refs, n)
        blocks = p.reshape(H // n, n, W // n, n).swapaxes(1, 2) \
            .reshape(-1, n, n)
        preds = jintra.predict_all_modes(refs, refs_f, n, True)
        costs = np.asarray(jcost.satd(preds, blocks[:, None], 8))
        if seeded:
            par = (seed16[f].repeat_interleave(2, 0).repeat_interleave(2, 1)
                   if n == 8 else seed16[f, ::2, ::2]).reshape(-1).numpy()
            a = np.maximum(par, 2)
            cand = np.stack([par, np.where(par >= 2, 2 + (a - 1) % 33, 0),
                             np.where(par >= 2, 2 + (a + 30) % 33, 1),
                             0 * par, 0 * par + 1, 0 * par + 26,
                             0 * par + 10], 1)
            in_cand = (cand[:, :, None] == np.arange(35)).any(1)
            costs = np.where(in_cand, costs, 0)
            want0 = np.where(in_cand, costs, np.iinfo(np.int32).max) \
                .argmin(1)
        else:
            want0 = costs.argmin(1)
        assert np.array_equal(satd[f].numpy(), costs)
        assert np.array_equal(best0[f].numpy(), want0)
