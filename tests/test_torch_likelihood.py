"""Kernel K2's decomposition and its path choice, on the CPU.

``tpunav_torch/ops/csrc/likelihood.cu`` turns each particle's distance
field into a table of the mixture's log per cell, then scores each sample
with a warp: lane l sums the compacted valid beams l, l+32, … in order, and
a xor tree adds the 32 lanes. ``_lik_mirror`` repeats that in numpy float32
and is held against the port's plain version and against ``tpunav``'s XLA
gather and Pallas kernel (interpret mode). tests/conftest.py runs jax in
x64, so every input is float32 on purpose. The kernel itself runs only on a
card, where ``chip_smoke.py`` holds it against the plain version.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunav.estimation.rbpf import grid as jg
from tpunav.ops.pallas_likelihood import _lik_pallas, _lik_xla
from tpunav_torch.estimation.rbpf import grid as tg
from tpunav_torch.ops import beams
from tpunav_torch.ops import likelihood as tl

torch.set_num_threads(1)

F32 = np.float32
SMALL = dict(resolution=0.1, num_beams=90, beam_delta=2 * math.pi / 90)
WIDE = dict(ymin=-1.2, ymax=1.2)                     # 48 rows × 80 columns
SMS, LIMIT = 132, 232448     # an H100 SXM: SMs, opt-in shared memory/block


def _lik_mirror(cfg, dists, ranges, samples):
    """K2's decomposition in numpy float32, one rounding per operation: the
    per-cell table lp = log(zh·exp((nhiv·d)·d) + floor); per sample the
    valid beams compacted in order, lane l's sequential sum of beams l,
    l+32, …, and the xor tree over the 32 lanes; 0 for an empty map."""
    p, h, w = dists.shape
    inv_res, nhiv, zh_norm, floor_p = (F32(c) for c in tl._constants(cfg))
    lut = np.log(zh_norm * np.exp(nhiv * dists * dists) + floor_p)
    table = beams.beam_table(cfg, torch.from_numpy(ranges)).numpy()
    valid = table[beams.R_MARK] >= 0.0
    rcb, rsb = table[beams.R_COS][valid], table[beams.R_SIN][valid]
    th = samples[..., 0]
    c0, s0 = np.cos(th)[..., None], np.sin(th)[..., None]
    ex = (samples[..., 1, None] + c0 * rcb) - s0 * rsb        # (P, k, V)
    ey = (samples[..., 2, None] + s0 * rcb) + c0 * rsb
    ix = np.clip(np.floor((ex - F32(cfg.xmin)) * inv_res), 0, w - 1)
    iy = np.clip(np.floor((ey - F32(cfg.ymin)) * inv_res), 0, h - 1)
    idx = iy.astype(np.int64) * w + ix.astype(np.int64)
    vals = np.take_along_axis(lut.reshape(p, 1, h * w),
                              idx.reshape(p, 1, -1), axis=2
                              ).reshape(idx.shape)
    passes = max(1, -(-vals.shape[-1] // 32))
    vals = np.concatenate(                 # absent lanes add +0: no change
        [vals, np.zeros(vals.shape[:2] + (32 * passes - vals.shape[-1],),
                        F32)], axis=-1).reshape(p, -1, passes, 32)
    acc = np.zeros((p, vals.shape[1], 32), F32)
    for j in range(passes):
        acc = acc + vals[:, :, j]
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ o]
    any_occ = (dists < F32(cfg.max_occ_dist)).reshape(p, -1).any(1)
    return np.where(any_occ[:, None], acc[..., 0], F32(0.0))


def _near_edge(cfg, samples, ranges, tol=1e-5):
    """(P, k): whether some valid beam's endpoint, taken exactly (float64
    from the float32 inputs), lies within ``tol`` cells of a cell edge,
    where one more or one fewer rounding (an XLA multiply-add) can move
    it into the next cell. 1e-5 cells at 0.05 m is two float32 ulps of an
    endpoint 2–4 m from the origin."""
    s = samples.astype(np.float64)
    table = beams.beam_table(cfg, torch.from_numpy(ranges)).numpy()
    valid = table[beams.R_MARK] >= 0.0
    rcb = table[beams.R_COS][valid].astype(np.float64)
    rsb = table[beams.R_SIN][valid].astype(np.float64)
    c0, s0 = np.cos(s[..., 0, None]), np.sin(s[..., 0, None])
    fx = (s[..., 1, None] + c0 * rcb - s0 * rsb - cfg.xmin) / cfg.resolution
    fy = (s[..., 2, None] + s0 * rcb + c0 * rsb - cfg.ymin) / cfg.resolution
    edge = lambda f: np.abs(f - np.round(f)) < tol
    return (edge(fx) | edge(fy)).any(-1)


def _inputs(cfg, p, k, seed, invalid):
    """Distance fields of random occupancy (as esdf builds them, so that
    neighbouring cells differ by at most √2·res), a scan and samples, all
    float32, for P particles × k samples; the last particle's map is empty
    when P > 1. ``invalid``: "some" beams beyond range_max and below
    range_min, "all", or "none"."""
    rng = np.random.default_rng(seed)
    occ = rng.random((p, cfg.height, cfg.width)) < 0.03
    grids = np.where(occ, F32(cfg.l_occ), F32(cfg.l_prior)).astype(F32)
    if p > 1:
        grids[-1] = cfg.l_prior                          # an empty map
    dists = tg.esdf(cfg, torch.from_numpy(grids)).numpy()
    ranges = rng.uniform(0.2, 3.0, cfg.num_beams).astype(F32)
    if invalid == "some":
        ranges[::7] = cfg.range_max + 0.5
        ranges[3::11] = 0.5 * cfg.range_min
    elif invalid == "all":
        ranges[:] = cfg.range_max
    samples = (rng.normal(size=(p, k, 3)) * 0.4).astype(F32)
    return dists, ranges, samples


@pytest.mark.parametrize("size,p,k,invalid", [
    ({}, 3, 51, "none"),                 # the course's k+1 = 51 samples
    ({}, 2, 51, "some"),
    ({}, 2, 1, "some"),                  # k = 1
    ({}, 1, 51, "some"),                 # P = 1
    (SMALL, 3, 7, "some"),               # 90 beams, not a multiple of 32
    (SMALL, 2, 5, "all"),                # no valid beam: exactly 0
    (WIDE, 2, 9, "some"),                # 48×80: H and W apart
])
def test_lik_mirror_matches_plain_and_tpunav(size, p, k, invalid):
    """The kernel's order of work gives the plain version's scores to 1e-5
    (the sums differ only in order), and tpunav's XLA gather and Pallas
    kernel to their bar in tests/test_pallas_rbpf.py (rtol 1e-5, atol
    2e-3), except where an endpoint sits on a cell edge: tpunav's XLA code
    fuses the endpoint's multiply-adds, so such a beam may land in the
    neighbouring cell. Those scores must show an endpoint within 1e-5 cells
    of an edge, and stay within the TPU gate's flip bar
    (tests_tpu/test_tpu_gate.py:257-259: each ≤ 0.05, at most 1% of
    scores)."""
    cfg, jcfg = tg.GridConfig(**size), jg.GridConfig(**size)
    dists, ranges, samples = _inputs(cfg, p, k, seed=p * k, invalid=invalid)
    got = _lik_mirror(cfg, dists, ranges, samples)
    assert got.shape == (p, k) and got.dtype == F32
    plain = tl.likelihood_field_batch(
        cfg, torch.from_numpy(dists), torch.from_numpy(ranges),
        torch.from_numpy(samples)).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5)
    args = (jnp.asarray(dists), jnp.asarray(ranges), jnp.asarray(samples))
    edge = _near_edge(cfg, samples, ranges)
    for want in (_lik_xla(jcfg, *args),
                 _lik_pallas(jcfg, *args, interpret=True)):
        want = np.asarray(want)
        flip = ~np.isclose(got, want, rtol=1e-5, atol=2e-3)
        assert np.all(edge[flip]) and flip.mean() <= 0.01
        assert np.abs(got - want).max() <= 0.05
    if p > 1:
        assert np.all(got[-1] == 0.0) and np.all(plain[-1] == 0.0)
    if invalid == "all":
        assert np.all(got == 0.0) and np.all(plain == 0.0)
    else:
        assert np.all(got[0] < 0.0)          # a real score: a sum of logs


def test_lik_mirror_sums_in_lane_order():
    """The mirror's sum is the lane-strided sum and xor tree, not the plain
    version's: on terms spread over many magnitudes the two orders round
    apart somewhere, and the mirror equals a direct Python replay of the
    kernel's order bit for bit."""
    cfg = tg.GridConfig()
    rng = np.random.default_rng(5)
    dists = (10.0 ** rng.uniform(-3, 0.2, (1, cfg.height, cfg.width))
             ).astype(F32)
    ranges = rng.uniform(0.2, 3.0, cfg.num_beams).astype(F32)
    samples = (rng.normal(size=(1, 40, 3)) * 0.3).astype(F32)
    got = _lik_mirror(cfg, dists, ranges, samples)
    plain = tl._lik_reference(cfg, torch.from_numpy(dists),
                              torch.from_numpy(ranges),
                              torch.from_numpy(samples)).numpy()
    assert np.any(got != plain)
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    # The replay: one sample, term by term, in the kernel's order.
    inv_res, nhiv, zh_norm, floor_p = (F32(c) for c in tl._constants(cfg))
    table = beams.beam_table(cfg, torch.from_numpy(ranges)).numpy()
    c0, s0 = np.cos(samples[0, 0, 0]), np.sin(samples[0, 0, 0])
    lanes = [F32(0.0)] * 32
    for b in range(cfg.num_beams):
        ex = (samples[0, 0, 1] + c0 * table[beams.R_COS, b]) \
            - s0 * table[beams.R_SIN, b]
        ey = (samples[0, 0, 2] + s0 * table[beams.R_COS, b]) \
            + c0 * table[beams.R_SIN, b]
        ix = int(min(max(np.floor((ex - F32(cfg.xmin)) * inv_res), 0),
                     cfg.width - 1))
        iy = int(min(max(np.floor((ey - F32(cfg.ymin)) * inv_res), 0),
                     cfg.height - 1))
        d = dists[0, iy, ix]
        lanes[b % 32] = lanes[b % 32] + np.log(
            zh_norm * np.exp(nhiv * d * d) + floor_p)
    for o in (16, 8, 4, 2, 1):
        lanes = [lanes[i] + lanes[i ^ o] for i in range(32)]
    assert lanes[0] == got[0, 0]


@pytest.mark.parametrize("p,k,side,path", [
    (500, 51, 80, "fused"),              # the course: one launch
    (2000, 51, 80, "fused"),
    (132, 51, 80, "fused"),              # as many particles as SMs
    (131, 51, 80, "two_pass"),
    (40, 51, 80, "two_pass"),            # most SMs would idle
    (40, 50, 160, "two_pass"),
    (500, 51, 200, "fused"),             # a 10 × 10 m room: 160 KB fits
    (16, 51, 200, "two_pass"),
    (500, 51, 320, "two_pass"),          # 400 KB: beyond shared memory
])
def test_lik_plan(p, k, side, path):
    """K2's path is a function of the shapes, the SM count and the card's
    shared-memory limit alone; the fused block fits the limit, and at the
    course's shape four blocks fit an SM's 228 KB."""
    got, launches, scratch = tl._plan(p, k, side, side, 360, SMS, LIMIT)
    assert got == path
    hw = side * side
    if path == "fused":
        assert (launches, scratch) == (1, 0)
        assert tl._fused_bytes(side, side, 360, k) <= LIMIT
    else:
        assert launches == 2
        assert scratch == p * hw + p * -(-hw // tl._TABLE_CELLS)
    if (p, side) == (500, 80):
        assert 4 * (tl._fused_bytes(80, 80, 360, 51) + 1024) <= 228 * 1024
    # With a smaller shared memory the same shape may change path only
    # toward two-pass.
    assert tl._plan(p, k, side, side, 360, SMS, 48 * 1024)[0] == (
        "fused" if path == "fused" and tl._fused_bytes(side, side, 360, k)
        <= 48 * 1024 else "two_pass")


def test_lik_cpu_path_ignores_the_plan():
    """On the CPU every shape takes the plain version, and no launch is
    counted: the plan is the card's alone."""
    cfg = tg.GridConfig(**SMALL)
    dists, ranges, samples = _inputs(cfg, 2, 3, seed=1, invalid="some")
    before = tl.LIK_LAUNCHES
    got = tl.likelihood_field_batch(cfg, torch.from_numpy(dists),
                                    torch.from_numpy(ranges),
                                    torch.from_numpy(samples))
    assert tl.LIK_LAUNCHES == before
    torch.testing.assert_close(got, tl._lik_reference(
        cfg, torch.from_numpy(dists), torch.from_numpy(ranges),
        torch.from_numpy(samples)), rtol=0, atol=0)
