"""K2: the port's plain RDOQ-lite level choice (`encode/rdoq.py::rdoq`) and
sign-bit hiding (`encode/sbh.py::apply_sbh`) against the JAX package's
jitted `rdoq_jnp` and `apply_sbh_jnp`, on numpy-seeded batches of TUs at
n = 4/8/16/32 with QPs 0, 22, 30, 37 and 51 and scans 0/1/2 mixed in each
batch: exact equality. The batches are built to reach levels >= 3 (the
escape bits), groups that decimate, and hidden coefficients of +-1 and of
|c| > 1 with both parities."""

import jax
import numpy as np
import pytest
import torch

from ks265codec_tpu.encode.rdoq import rdoq_jnp
from ks265codec_tpu.encode.sbh import apply_sbh_jnp
from ks265codec_tpu.hevc.tables import QUANT_SCALE
from ks265codec_tpu.ops.transforms import quantize
from ks265codec_tpu_torch.encode import rdoq as trdoq
from ks265codec_tpu_torch.encode import sbh as tsbh
from _torch_shared import release_after_module  # noqa: F401

QPS = (0, 22, 30, 37, 51)
SIZES = (4, 8, 16, 32)
K = 60


def _coeffs(n: int, seed: int):
    """(K, n, n) transform coefficients and (K,) QPs. Per 4x4 group one of:
    empty; one to three weak level-1 candidates (f in 0.5..0.95, which
    decimate unless a stronger coefficient joins them); a dense group of
    log-uniform magnitudes reaching the escape levels."""
    rng = np.random.RandomState(seed)
    log2 = n.bit_length() - 1
    qp = np.array([QPS[k % len(QPS)] for k in range(K)], np.int32)
    qbits = 29 + qp // 6 - 8 - log2
    scale = np.asarray(QUANT_SCALE)[qp % 6]
    f = np.zeros((K, n, n))
    g = n // 4
    kind = rng.randint(0, 4, (K, g, g))
    for k in range(K):
        for gy in range(g):
            for gx in range(g):
                blk = f[k, 4 * gy:4 * gy + 4, 4 * gx:4 * gx + 4]
                if kind[k, gy, gx] == 1:
                    pos = rng.choice(16, rng.randint(1, 4), replace=False)
                    blk.flat[pos] = rng.uniform(0.5, 0.95, len(pos))
                elif kind[k, gy, gx] == 2:
                    blk[:] = np.exp(rng.uniform(-3, 4.5, (4, 4)))
                elif kind[k, gy, gx] == 3:
                    blk[:] = rng.uniform(0, 3.5, (4, 4)) * \
                        (rng.rand(4, 4) < 0.4)
    c = np.round(f * np.ldexp(1.0, qbits)[:, None, None]
                 / scale[:, None, None])
    c = np.clip(c, 0, 32767) * rng.choice([-1, 1], c.shape)
    return c.astype(np.int32), qp


@pytest.mark.parametrize("n", SIZES)
def test_rdoq_matches_reference(n):
    log2 = n.bit_length() - 1
    c, qp = _coeffs(n, n)
    want = np.asarray(jax.jit(rdoq_jnp, static_argnums=(2, 3))(
        c, qp, n, log2))
    got = trdoq.rdoq(torch.from_numpy(c), torch.from_numpy(qp), n,
                     log2).numpy()
    assert np.array_equal(got, want)
    # the batch reaches the escape levels and decimated groups
    assert (np.abs(want) >= 3).any()
    dead = (want == 0).reshape(K, n // 4, 4, n // 4, 4).all(axis=(2, 4))
    lf = np.abs(c).astype(np.float64) * np.asarray(QUANT_SCALE)[qp % 6][
        :, None, None] / np.ldexp(1.0, 29 + qp // 6 - 8 - log2)[:, None, None]
    some = (lf >= 0.75).reshape(K, n // 4, 4, n // 4, 4).any(axis=(2, 4))
    assert (dead & some).any()


def _levels(n: int, seed: int):
    rng = np.random.RandomState(100 + seed)
    mag = rng.geometric(0.45, (K, n, n))
    lev = np.where(rng.rand(K, n, n) < 0.35, mag, 0)
    lev = lev * rng.choice([-1, 1], lev.shape)
    return lev.astype(np.int32), (np.arange(K) % 3).astype(np.int32)


@pytest.mark.parametrize("n", SIZES)
def test_sbh_matches_reference(n):
    lev, scan = _levels(n, n)
    want = np.asarray(jax.jit(apply_sbh_jnp, static_argnums=(2,))(
        lev, scan, n))
    got = tsbh.apply_sbh(torch.from_numpy(lev), torch.from_numpy(scan),
                         n).numpy()
    assert np.array_equal(got, want)
    # hidden coefficients of |c| == 1 (moved away from zero) and of
    # |c| > 1 (toward zero) were both fixed
    d = want - lev
    assert ((d != 0) & (np.abs(lev) == 1)).any()
    assert ((d != 0) & (np.abs(lev) > 1)).any()


@pytest.mark.parametrize("flags", [1, 2, 3, 6])
def test_rdoq_sbh_plain_is_rdoq_then_sbh(flags):
    """The standalone step the kernel is held against: RDOQ or deadzone
    rounding (intra, or inter with flag 4), then sign hiding, against the
    JAX package's rdoq_jnp, quantize and apply_sbh_jnp."""
    n = 16
    c, qp = _coeffs(n, 7)
    scan = (np.arange(K) % 3).astype(np.int32)
    got = trdoq.rdoq_sbh(torch.from_numpy(c), torch.from_numpy(qp),
                         torch.from_numpy(scan), n, flags).numpy()
    if flags & 1:
        lev = np.asarray(rdoq_jnp(c, qp, n, 4))
    else:
        lev = np.asarray(quantize(c, qp[:, None, None], log2=4,
                                  intra=not flags & 4))
    if flags & 2:
        lev = np.asarray(apply_sbh_jnp(lev, scan, n))
    assert np.array_equal(got, lev)
