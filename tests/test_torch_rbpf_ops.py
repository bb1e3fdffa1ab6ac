"""The RBPF's device math in the port against ``tpunav`` on the CPU.

The bearing polynomial, the EDT, the grid update and the plain versions of
kernels K2 (likelihood field), K3 (map update + EDT) and K4 (EDT alone)
run beside their ``tpunav`` counterparts on the same numpy-made float32
inputs. tests/conftest.py runs jax in x64, so the jax inputs are cast to
float32 explicitly. The Pallas kernels run in interpret mode, as
tests/test_pallas_rbpf.py runs them; the CUDA kernels run only on a card,
where ``chip_smoke.py`` holds them against these plain versions.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunav.estimation.rbpf import grid as jg
from tpunav.ops import trig as jtrig
from tpunav.ops.distance_transform import euclidean_distance_field as j_edt
from tpunav.ops.pallas_likelihood import _lik_pallas, _lik_xla
from tpunav.ops.pallas_map_update import edt_batch as j_edt_batch
from tpunav.ops.pallas_map_update import map_update_batch as j_map_update
from tpunav.sim import lidar as jlidar
from tpunav_torch.estimation.rbpf import grid as tg
from tpunav_torch.ops import likelihood as tl
from tpunav_torch.ops import map_update as tmu
from tpunav_torch.ops import trig as ttrig
from tpunav_torch.ops.distance_transform import euclidean_distance_field
from tpunav_torch.sim import lidar as tlidar

torch.set_num_threads(1)

F32 = jnp.float32
SMALL = dict(resolution=0.1, num_beams=90, beam_delta=2 * math.pi / 90)
BIG = dict(xmin=-4.0, xmax=4.0, ymin=-4.0, ymax=4.0)
POSES = np.array([[0.0, 0.0, 0.0], [0.3, 0.2, -0.1], [-0.7, -0.4, 0.5],
                  [2.9, 1.2, 1.1], [1.0, 0.025, -0.075]], np.float32)


def _cfgs(**kw):
    return jg.GridConfig(**kw), tg.GridConfig(**kw)


def _t(a):
    return torch.from_numpy(np.array(a))


def _world(jcfg, pose, seed=0, half=1.5):
    """A noisy box-world scan (float32) from ``pose``."""
    segs = jlidar.box_segments(-half, -half, half, half, F32)
    return np.asarray(jlidar.scan_segments(
        jnp.asarray(pose, F32), segs, num_beams=jcfg.num_beams,
        beam_delta=jcfg.beam_delta, max_range=jcfg.range_max,
        key=jax.random.PRNGKey(seed), noise_std=0.01), np.float32)


# ------------------------------------------------------------ bearings ---

def test_atan2_matches_tpunav_and_torch():
    rng = np.random.default_rng(0)
    y = rng.normal(size=4000).astype(np.float32) * 3.0
    x = rng.normal(size=4000).astype(np.float32) * 3.0
    y[:4], x[:4] = [0.0, 0.0, 1.0, -1.0], [0.0, -1.0, 0.0, 0.0]
    got = ttrig.atan2(_t(y), _t(x)).numpy()
    want = np.asarray(jtrig.atan2(jnp.asarray(y, F32), jnp.asarray(x, F32)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.arctan2(y, x), rtol=0, atol=1e-6)
    a = rng.normal(size=4000).astype(np.float32) * 20.0
    np.testing.assert_array_equal(
        ttrig.positive_mod(_t(a), 2 * math.pi).numpy(),
        np.asarray(jtrig.positive_mod(jnp.asarray(a, F32), 2 * math.pi)))
    np.testing.assert_array_equal(
        ttrig.round_half_up(_t(a)).numpy(),
        np.asarray(jtrig.round_half_up(jnp.asarray(a, F32))))


def _j_beams_xla(jcfg, pose):
    """The beam quantizer of tpunav's integrate_scan (grid.py:206-219)."""
    h, w, res = jcfg.height, jcfg.width, jcfg.resolution
    cx = jcfg.xmin + (jnp.arange(w, dtype=F32) + 0.5) * res
    cy = jcfg.ymin + (jnp.arange(h, dtype=F32) + 0.5) * res
    dx = cx[None, :] - pose[1]
    dy = cy[:, None] - pose[2]
    alpha = jtrig.positive_mod(jtrig.atan2(dy, dx) - pose[0] - jcfg.beam_min,
                               2.0 * jnp.pi)
    b = jtrig.round_half_up(alpha / jcfg.beam_delta).astype(jnp.int32)
    return np.asarray(b % jg.beams_per_revolution(jcfg))


def _j_beams_kernel(jcfg, pose):
    """The beam quantizer of tpunav's _map_kernel (pallas_map_update.py:
    70-78)."""
    h, w, res = jcfg.height, jcfg.width, jcfg.resolution
    row = jnp.arange(h, dtype=F32)[:, None]
    col = jnp.arange(w, dtype=F32)[None, :]
    dx = (jcfg.xmin + res * 0.5 - pose[1]) + res * col
    dy = (jcfg.ymin + res * 0.5 - pose[2]) + res * row
    alpha = jtrig.positive_mod(jtrig.atan2(dy, dx) - pose[0]
                               - float(jcfg.beam_min), 2.0 * jnp.pi)
    b = jtrig.round_half_up(alpha * (1.0 / jcfg.beam_delta)).astype(
        jnp.int32)
    return np.asarray(b % jg.beams_per_revolution(jcfg))


@pytest.mark.parametrize("size", [{}, BIG])
def test_beam_indices_equal_tpunav(size):
    """Both quantizers (the grid update's and the kernel's) give every cell
    of the 80² and 160² maps the same beam as tpunav, at several poses; and
    the two round apart somewhere, which is why both are kept."""
    jcfg, tcfg = _cfgs(**size)
    poses = POSES.copy()
    poses[3] = [2.9, 0.2, 0.3]                # inside both maps
    _, got_xla = tg.cell_beams(tcfg, _t(poses))
    _, got_kernel = tmu._beam_index_reference(tcfg, _t(poses))
    for i, pose in enumerate(poses):
        jpose = jnp.asarray(pose, F32)
        np.testing.assert_array_equal(got_xla[i].numpy(),
                                      _j_beams_xla(jcfg, jpose))
        np.testing.assert_array_equal(got_kernel[i].numpy(),
                                      _j_beams_kernel(jcfg, jpose))
    assert bool((got_xla != got_kernel).any())


# ----------------------------------------------------------------- EDT ---

def test_edt_matches_tpunav_and_brute_force():
    rng = np.random.default_rng(0)
    occ = rng.random((3, 24, 31)) < 0.08
    occ[:, 0, 0] = True
    got = euclidean_distance_field(_t(occ), 1.0, 1e9).numpy()
    for i in range(3):
        want = np.asarray(j_edt(jnp.asarray(occ[i]), 1.0, 1e9, dtype=F32))
        np.testing.assert_array_equal(got[i], want)
        ys, xs = np.nonzero(occ[i])
        gy, gx = np.mgrid[0:24, 0:31]
        brute = np.min(np.sqrt((gy[..., None] - ys) ** 2 +
                               (gx[..., None] - xs) ** 2), axis=-1)
        np.testing.assert_allclose(got[i], brute, rtol=0, atol=1e-5)
    capped = euclidean_distance_field(_t(occ[:1]), 0.5, 2.0).numpy()
    assert capped.max() == 2.0 and capped[0, 0, 0] == 0.0


def _grids(jcfg, scan, poses):
    """(P, H, W) float32 grids that already hold one scan (the particles'
    first update), and the poses they came from."""
    g0 = jg.grid_init(jcfg, F32)
    return np.stack([np.asarray(jg.integrate_scan(jcfg, g0, jnp.asarray(scan),
                                                  jnp.asarray(q, F32)))
                     for q in poses]).astype(np.float32)


@pytest.mark.parametrize("size", [SMALL, {}])
def test_esdf_equals_tpunav(size):
    jcfg, tcfg = _cfgs(**size)
    scan = _world(jcfg, POSES[1])
    grids = _grids(jcfg, scan, POSES[:3])
    grids[2] = jcfg.l_prior                       # an empty map
    got = tg.esdf(tcfg, _t(grids)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], np.asarray(jg.esdf(jcfg, jnp.asarray(grids[i]))))
    assert np.all(got[2] == jcfg.max_occ_dist)


# ---------------------------------------------------------- grid update ---

@pytest.mark.parametrize("size", [SMALL, {}])
def test_integrate_scan_matches_tpunav(size):
    jcfg, tcfg = _cfgs(**size)
    scan = _world(jcfg, POSES[1], seed=3)
    grids = _grids(jcfg, scan, POSES[:4])
    got = tg.integrate_scan(tcfg, _t(grids), _t(scan), _t(POSES[:4])).numpy()
    for i in range(4):
        want = np.asarray(jg.integrate_scan(jcfg, jnp.asarray(grids[i]),
                                            jnp.asarray(scan),
                                            jnp.asarray(POSES[i], F32)))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-5)
    one = tg.integrate_scan(tcfg, _t(grids[0]), _t(scan), _t(POSES[0]))
    np.testing.assert_array_equal(one.numpy(), got[0])


def test_integrate_scan_marks_free_and_occupied():
    _, cfg = _cfgs(**SMALL)
    g = tg.grid_init(cfg, torch.float64, device="cpu")
    segs = torch.tensor([[1.0, -2.0, 1.0, 2.0]], dtype=torch.float64)
    pose = torch.zeros(3, dtype=torch.float64)
    ranges = tlidar.scan_segments(pose, segs, num_beams=cfg.num_beams,
                                  beam_delta=cfg.beam_delta,
                                  max_range=cfg.range_max)
    g = tg.integrate_scan(cfg, g, ranges, pose)
    cell = lambda x, y: tg.world_to_cell(
        cfg, torch.tensor([x, y], dtype=torch.float64))
    assert float(g[cell(1.0, 0.0)]) > cfg.l_occ - 1e-6     # the wall
    assert float(g[cell(0.5, 0.0)]) < cfg.l_prior          # free
    assert np.isclose(float(g[cell(1.5, 0.0)]), cfg.l_prior)  # behind


def test_likelihood_field_log_and_occupancy_grid_match_tpunav():
    jcfg, tcfg = _cfgs(**SMALL)
    scan = _world(jcfg, POSES[0])
    grids = _grids(jcfg, scan, POSES[:2])
    dists = tg.esdf(tcfg, _t(grids))
    samples = POSES[:2, None, :] + np.random.default_rng(1).normal(
        scale=0.05, size=(2, 4, 3)).astype(np.float32)
    got = tg.likelihood_field_log(tcfg, dists[:, None], _t(scan),
                                  _t(samples)).numpy()
    for i in range(2):
        for j in range(4):
            want = float(jg.likelihood_field_log(
                jcfg, jnp.asarray(dists[i].numpy()), jnp.asarray(scan),
                jnp.asarray(samples[i, j], F32)))
            np.testing.assert_allclose(got[i, j], want, rtol=1e-5, atol=1e-3)
    assert got[0, 0] > got[0, 1:].min()          # the true pose scores best
    empty = tg.esdf(tcfg, tg.grid_init(tcfg, device="cpu"))
    assert float(tg.likelihood_field_log(tcfg, empty, _t(scan),
                                         _t(POSES[0]))) == 0.0
    np.testing.assert_array_equal(
        tg.occupancy_grid(tcfg, _t(grids)).numpy(),
        np.stack([np.asarray(jg.occupancy_grid(jcfg, jnp.asarray(g)))
                  for g in grids]))


# ------------------------------------------------------------------ K2 ---

def _lik_inputs(jcfg, p, k, seed=0):
    rng = np.random.default_rng(seed)
    dists = rng.uniform(0.0, 3.0, (p, jcfg.height, jcfg.width)
                        ).astype(np.float32)
    dists[-1] = jcfg.max_occ_dist                    # an empty-map particle
    ranges = rng.uniform(0.05, 4.0, jcfg.num_beams).astype(np.float32)
    samples = (rng.normal(size=(p, k, 3)) * 0.4).astype(np.float32)
    return dists, ranges, samples


@pytest.mark.parametrize("size,p,k", [(SMALL, 3, 7), ({}, 2, 9)])
def test_likelihood_plain_matches_tpunav(size, p, k):
    """K2's plain version against tpunav's XLA gather and its Pallas kernel
    (interpret mode), at the bar of tests/test_pallas_rbpf.py."""
    jcfg, tcfg = _cfgs(**size)
    dists, ranges, samples = _lik_inputs(jcfg, p, k)
    got = tl.likelihood_field_batch(tcfg, _t(dists), _t(ranges), _t(samples))
    assert got.shape == (p, k) and got.dtype == torch.float32
    args = (jnp.asarray(dists), jnp.asarray(ranges), jnp.asarray(samples))
    for want in (_lik_xla(jcfg, *args),
                 _lik_pallas(jcfg, *args, interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=2e-3)
    assert np.all(got[-1].numpy() == 0.0)            # empty-map early-out


# ---------------------------------------------------------------- K3/K4 ---

@pytest.mark.parametrize("size", [SMALL, {}])
def test_map_update_plain_matches_tpunav_kernel(size):
    """K3's plain version against tpunav's map_update_batch in interpret
    mode; K4's plain version is bit-equal to K3's distance field."""
    jcfg, tcfg = _cfgs(**size)
    scan = _world(jcfg, POSES[0], seed=3)
    grids = _grids(jcfg, scan, POSES[:4])
    grids[0] = jcfg.l_prior                          # a fresh map
    grids[2] += 0.3
    g_j, d_j = j_map_update(jcfg, jnp.asarray(grids), jnp.asarray(scan),
                            jnp.asarray(POSES[:4]), interpret=True)
    g_t, d_t = tmu.map_update_batch(tcfg, _t(grids), _t(scan),
                                    _t(POSES[:4]))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(tmu.edt_batch(tcfg, g_t).numpy(),
                                  d_t.numpy())
    # tpunav's EDT kernel under XLA on the CPU rounds sqrt·res to within
    # an ulp of the exact field.
    np.testing.assert_allclose(
        np.asarray(j_edt_batch(jcfg, jnp.asarray(g_t.numpy()),
                               interpret=True)), d_t.numpy(), rtol=0,
        atol=1e-5)


def test_map_update_plain_equals_integrate_scan():
    """The kernel's decomposition and tpunav's XLA formulation agree to the
    gate's bar (tests_tpu/test_tpu_gate.py:218-220)."""
    _, tcfg = _cfgs()
    jcfg = jg.GridConfig()
    scan = _t(_world(jcfg, POSES[1]))
    grids = tg.grid_init(tcfg, device="cpu").expand(5, -1, -1).contiguous()
    poses = _t(POSES)
    g_k, d_k = tmu.map_update_batch(tcfg, grids, scan, poses)
    g_x = tg.integrate_scan(tcfg, grids, scan, poses)
    torch.testing.assert_close(g_k, g_x, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(d_k, tg.esdf(tcfg, g_x), rtol=0, atol=1e-4)


# ------------------------------------------------------------ wrappers ---

def test_cpu_calls_leave_kernel_counts_unchanged():
    _, tcfg = _cfgs(**SMALL)
    jcfg = jg.GridConfig(**SMALL)
    dists, ranges, samples = _lik_inputs(jcfg, 2, 3)
    before = (tl.LIK_LAUNCHES, tmu.MAP_LAUNCHES, tmu.EDT_LAUNCHES)
    tl.likelihood_field_batch(tcfg, _t(dists), _t(ranges), _t(samples))
    g, _ = tmu.map_update_batch(tcfg, _t(dists), _t(ranges), _t(POSES[:2]))
    tmu.edt_batch(tcfg, g)
    assert (tl.LIK_LAUNCHES, tmu.MAP_LAUNCHES, tmu.EDT_LAUNCHES) == before


def test_wrappers_reject_bad_inputs():
    _, tcfg = _cfgs(**SMALL)
    jcfg = jg.GridConfig(**SMALL)
    dists, ranges, samples = (_t(a) for a in _lik_inputs(jcfg, 2, 3))
    with pytest.raises(TypeError):
        tl.likelihood_field_batch(tcfg, dists.double(), ranges, samples)
    with pytest.raises(ValueError):
        tl.likelihood_field_batch(tcfg, dists, ranges[:5], samples)
    with pytest.raises(ValueError):
        tl.likelihood_field_batch(tcfg, dists, ranges, samples[:1])
    with pytest.raises(ValueError):
        tl.likelihood_field_batch(tcfg, dists.transpose(1, 2), ranges,
                                  samples)
    poses = _t(POSES[:2])
    with pytest.raises(ValueError):
        tmu.map_update_batch(tcfg, dists, ranges, poses[:1])
    with pytest.raises(TypeError):
        tmu.map_update_batch(tcfg, dists, ranges.double(), poses)
    with pytest.raises(ValueError):
        tmu.map_update_batch(tcfg, dists, ranges, poses,
                             beam_out=torch.zeros(dists.shape,
                                                  dtype=torch.int32))
    with pytest.raises(ValueError):
        tmu.edt_batch(tcfg, dists[0])
    with pytest.raises(ValueError):
        tg.beams_per_revolution(tg.GridConfig(beam_delta=0.07))
    with pytest.raises(ValueError):
        tg.GridConfig(z_hit=0.5)


def test_one_beam_table_serves_both_wrappers():
    """A table built once (as pf_slam_step builds it) gives both wrappers the
    results they get from the scan alone; a mis-shaped table is refused."""
    from tpunav_torch.ops import beams

    jcfg, tcfg = _cfgs(**SMALL)
    dists, ranges, samples = (_t(a) for a in _lik_inputs(jcfg, 2, 3))
    table = beams.beam_table(tcfg, ranges)
    assert table.shape == (beams.ROWS, tcfg.num_beams)
    assert torch.equal(
        tl.likelihood_field_batch(tcfg, dists, ranges, samples, table),
        tl.likelihood_field_batch(tcfg, dists, ranges, samples))
    poses = _t(POSES[:2])
    for a, b in zip(tmu.map_update_batch(tcfg, dists, ranges, poses, table),
                    tmu.map_update_batch(tcfg, dists, ranges, poses)):
        assert torch.equal(a, b)
    pts, valid = tg.scan_end_points(tcfg, ranges, poses)
    assert torch.equal(valid, (ranges >= tcfg.range_min)
                       & (ranges < tcfg.range_max))
    with pytest.raises(ValueError):
        tl.likelihood_field_batch(tcfg, dists, ranges, samples, table[:3])
    with pytest.raises(ValueError):
        tmu.map_update_batch(tcfg, dists, ranges, poses, table[:, :5])
    with pytest.raises(ValueError):
        tg.GridConfig(range_min=-0.1)


def test_lidar_matches_tpunav():
    pose = np.array([0.3, 0.1, -0.2], np.float32)
    segs = np.asarray(jlidar.box_segments(-1.5, -1.2, 1.4, 1.6, F32))
    np.testing.assert_array_equal(
        tlidar.box_segments(-1.5, -1.2, 1.4, 1.6, device="cpu").numpy(), segs)
    noise = np.random.default_rng(2).normal(size=360).astype(np.float32)
    got = tlidar.scan_segments(_t(pose), _t(segs), noise_std=0.01,
                               noise=_t(noise))
    want = np.asarray(jlidar.scan_segments(jnp.asarray(pose),
                                           jnp.asarray(segs))) + 0.01 * noise
    np.testing.assert_allclose(got.numpy(), np.minimum(want, 3.5), atol=1e-5)
    centers = np.array([[1.0, 0.5], [-0.8, -0.3]], np.float32)
    radii = np.array([0.2, 0.1], np.float32)
    got = tlidar.scan_cylinders(_t(pose), _t(centers), _t(radii),
                                num_beams=90, beam_delta=2 * math.pi / 90)
    want = jlidar.scan_cylinders(jnp.asarray(pose), jnp.asarray(centers),
                                 jnp.asarray(radii), num_beams=90,
                                 beam_delta=2 * math.pi / 90)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    a = tlidar.scan_segments(_t(pose), _t(segs), generator=gen,
                             noise_std=0.01)
    assert a.shape == (360,) and not torch.equal(
        a, tlidar.scan_segments(_t(pose), _t(segs)))
