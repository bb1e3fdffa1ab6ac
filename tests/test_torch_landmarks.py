"""The port's lidar circle detector (``estimation/landmarks.py``) against
``tpunav``'s.

- The fit on the Gander/Golub/Strebel goldens (tests/test_landmarks.py:
  27-58), an exact circle, and 4-point clusters that take the σ < 1e-12
  branch, against ``tpunav`` at 1e-9 (float64).
- ``cluster_scan``'s ids equal ``tpunav``'s exactly (its ``lax.scan`` over
  the beams is one ``cummax`` here), on the test scans and on the dense
  world's scans.
- The whole detector on the dense world (examples/dense_world_slam_demo.py:
  44 cylinders of r = 0.04) from 8 poses, with and without the wall
  classifier. float64: ids and valid masks equal, centers and radii within
  1e-9. float32: ids and valid masks equal, and centers and radii within
  1e-5 m of ``tpunav``'s float64 circles. The port fits in float64
  whatever the scan's dtype (see the module); ``tpunav``'s float32 fit lies
  up to ~0.5 mm from its own float64 fit on these scans, so against it the
  port is held to that distance plus 1e-5 m.
- The behaviours of tests/test_landmarks.py (wall rejection, the
  inscribed-angle classifier, the L-corner phantom).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunav.estimation import landmarks as jl
from tpunav.sim import lidar as jlidar
from tpunav_torch.estimation import landmarks as tl
from tpunav_torch.sim import lidar as tlidar

torch.set_num_threads(1)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _fit_one(points):
    """One cluster of explicit points through both packages' fit_circles
    (float64); returns (port, tpunav) as (cx, cy, r, valid)."""
    pts = np.asarray(points, np.float64)
    n = len(pts)
    tc = tl.LandmarkConfig(max_clusters=4, radius_thresh=1e9)
    jc = jl.LandmarkConfig(max_clusters=4, radius_thresh=1e9)
    got = tl.fit_circles(tc, _t(pts), torch.zeros(n, dtype=torch.int32),
                         torch.ones(n, dtype=torch.bool))
    want = jax.jit(lambda p: jl.fit_circles(jc, p, jnp.zeros(n, jnp.int32),
                                            jnp.ones(n, bool)))(
        jnp.asarray(pts))
    return [(float(c.centers[0, 0]), float(c.centers[0, 1]),
             float(c.radii[0]), bool(c.valid[0])) for c in (got, want)]


GOLDENS = {
    # ref: test_landmarks.cpp:34-58 and :83-103.
    "ggs_1": ([[1.0, 7.0], [2.0, 6.0], [5.0, 8.0], [7.0, 7.0], [9.0, 5.0],
               [3.0, 7.0]], (4.615482, 2.807354, 4.8275)),
    "ggs_2": ([[-1.0, 0.0], [-0.3, -0.06], [0.3, 0.1], [1.0, 0.0]],
              (0.4908357, -22.15212, 22.17979)),
    "exact_circle": (np.stack([0.3 + 0.05 * np.cos(np.linspace(0, 4.71, 12)),
                               -0.2 + 0.05 * np.sin(np.linspace(0, 4.71,
                                                                12))], -1),
                     (0.3, -0.2, 0.05)),
}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_circle_fit_goldens(name):
    points, (x, y, r) = GOLDENS[name]
    got, want = _fit_one(points)
    assert got[3] and want[3]
    tol = 1e-9 if name == "exact_circle" else 1e-4
    np.testing.assert_allclose(got[:3], (x, y, r), atol=tol)
    np.testing.assert_allclose(got[:3], want[:3], rtol=0, atol=1e-9)


@pytest.mark.parametrize("points", [
    [[1.5, 0.25], [0.5, 1.25], [-0.5, 0.25], [0.5, -0.75]],
    [[0.03, 0.04], [-0.03, 0.04], [-0.03, -0.04], [0.03, -0.04]],
])
def test_rank_deficient_branch_matches_tpunav(points):
    """Four points exactly on a circle: the moment matrix is singular, its
    smallest eigenvalue is ≤ 0, so σ < 1e-12 and the fit takes the null
    vector of S (ref: landmarks.cpp:168-172)."""
    pts = np.asarray(points)
    x = pts - pts.mean(0)
    z = (x ** 2).sum(1)
    zmat = np.stack([z, x[:, 0], x[:, 1], np.ones(4)], 1)
    assert float(torch.linalg.eigvalsh(_t(zmat.T @ zmat))[0]) <= 0.0
    got, want = _fit_one(points)
    assert got[3] and want[3]
    np.testing.assert_allclose(got[:3], want[:3], rtol=0, atol=1e-9)


def _ids_both(eps, pts, valid):
    tc, jc = tl.LandmarkConfig(epsilon=eps), jl.LandmarkConfig(epsilon=eps)
    got = tl.cluster_scan(tc, _t(pts), torch.as_tensor(np.array(valid)))
    want = jax.jit(lambda p, v: jl.cluster_scan(jc, p, v))(
        jnp.asarray(pts), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return got.numpy()


def test_cluster_scan_matches_tpunav():
    """tests/test_landmarks.py:60-93: two groups, the wrap-around merge,
    an invalid beam inside a cluster; plus no valid beam at all, one valid
    beam, and a random scan with invalid runs."""
    ids = _ids_both(0.5, [[0.0, 0.0], [0.1, 0.0], [0.2, 0.0], [5.0, 0.0],
                          [5.1, 0.0]], [True] * 5)
    assert ids[0] == ids[1] == ids[2] and ids[3] == ids[4] != ids[0]
    ids = _ids_both(0.5, [[0.0, 0.0], [0.1, 0.0], [5.0, 0.0], [5.1, 0.0],
                          [0.2, 0.1]], [True] * 5)
    assert ids[4] == ids[0] and ids[2] == ids[3] != ids[0]
    ids = _ids_both(0.5, [[0.0, 0.0], [99.0, 99.0], [0.1, 0.0]],
                    [True, False, True])
    assert ids[0] == ids[2] and ids[1] == -1
    assert (_ids_both(0.5, np.zeros((4, 2)), [False] * 4) == -1).all()
    _ids_both(0.5, [[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]], [False, True, False])
    rng = np.random.default_rng(2)
    pts = np.cumsum(rng.normal(scale=0.05, size=(360, 2)), 0)
    _ids_both(0.075, pts, rng.uniform(size=360) > 0.2)


def _dense_world():
    """examples/dense_world_slam_demo.py:42-49: 24 + 20 cylinders."""
    ao = np.linspace(0.0, 2 * np.pi, 24, endpoint=False)
    ai = np.linspace(0.0, 2 * np.pi, 20, endpoint=False) + 0.13
    return np.concatenate([
        np.stack([1.55 * np.cos(ao), 1.55 * np.sin(ao)], -1),
        np.stack([0.95 * np.cos(ai), 0.95 * np.sin(ai)], -1)])


def _dense_scans():
    """float64 scans of the dense world from 8 poses on the waypoint
    ring's radius, 1 mm noise drawn from tpunav's keys."""
    lms = jnp.asarray(_dense_world())
    out = []
    for k in range(8):
        a = 2 * np.pi * k / 8
        pose = jnp.asarray([a + np.pi / 2, 1.2 * np.cos(a), 1.2 * np.sin(a)])
        out.append(np.asarray(jlidar.scan_cylinders(
            pose, lms, jnp.full((44,), 0.04), key=jax.random.PRNGKey(k),
            noise_std=1e-3)))
    return out


@pytest.fixture(scope="module")
def dense_scans():
    return _dense_scans()


@pytest.mark.parametrize("use_classify", [False, True])
def test_dense_world_detection_matches_tpunav(dense_scans, use_classify):
    kw = dict(max_clusters=32, use_classify=use_classify)
    tc, jc = tl.LandmarkConfig(**kw), jl.LandmarkConfig(**kw)
    detect = jax.jit(lambda r: jl.feature_detection(jc, r))
    found = 0
    for r64 in dense_scans:
        want64 = detect(jnp.asarray(r64))
        want32 = detect(jnp.asarray(r64, jnp.float32))
        for dtype in (torch.float64, torch.float32):
            r = _t(r64, dtype)
            pts, valid = tl.laser_end_points(tc.props, r)
            jpts, jvalid = jl.laser_end_points(jc.props, jnp.asarray(
                r.numpy()))
            if not use_classify:
                np.testing.assert_array_equal(
                    tl.cluster_scan(tc, pts, valid).numpy(),
                    np.asarray(jl.cluster_scan(jc, jpts, jvalid)))
            got = tl.feature_detection(tc, r)
            assert got.centers.dtype == dtype
            v = np.asarray(want64.valid)
            np.testing.assert_array_equal(got.valid.numpy(), v)
            c, rad = got.centers.numpy()[v], got.radii.numpy()[v]
            c64, r64v = (np.asarray(want64.centers)[v],
                         np.asarray(want64.radii)[v])
            if dtype == torch.float64:
                np.testing.assert_allclose(c, c64, rtol=0, atol=1e-9)
                np.testing.assert_allclose(rad, r64v, rtol=0, atol=1e-9)
                continue
            np.testing.assert_array_equal(np.asarray(want32.valid), v)
            np.testing.assert_allclose(c, c64, rtol=0, atol=1e-5)
            np.testing.assert_allclose(rad, r64v, rtol=0, atol=1e-5)
            c32 = np.asarray(want32.centers)[v]
            own = np.abs(c32 - c64)            # tpunav's float32 vs float64
            assert (np.abs(c - c32) <= own + 1e-5).all()
        found += int(np.asarray(want64.valid).sum())
    assert found >= 80                      # ~11 cylinders per scan


def test_feature_detection_finds_cylinders_and_rejects_walls():
    """tests/test_landmarks.py:96-129."""
    cfg = tl.LandmarkConfig()
    centers = _t([[1.0, 0.0], [0.0, 1.0], [-0.8, -0.8]])
    ranges = tlidar.scan_cylinders(torch.zeros(3, dtype=torch.float64),
                                   centers, torch.full((3,), 0.04,
                                                       dtype=torch.float64))
    circles = tl.feature_detection(cfg, ranges)
    found = circles.centers[circles.valid].numpy()
    assert found.shape[0] == 3
    for c in centers.numpy():
        assert np.min(np.linalg.norm(found - c, axis=-1)) < 5e-3
    meas = tl.circles_to_measurements(circles).numpy()
    assert meas.shape == (64, 2)
    assert (np.isnan(meas).all(1) == ~circles.valid.numpy()).all()

    n = cfg.props.num_beams
    ranges = np.full(n, cfg.props.range_max)
    for i in list(range(0, 41)) + list(range(320, 360)):
        ang = np.deg2rad(i)
        r = 1.0 / np.cos(ang if i <= 40 else ang - 2 * np.pi)
        if 0.12 <= r < 3.5:
            ranges[i] = r
    assert not bool(tl.feature_detection(cfg, _t(ranges)).valid.any())


def test_classify_circles_matches_tpunav():
    """Arc vs collinear points (tests/test_landmarks.py:132-174), each
    cluster's verdict equal to ``tpunav``'s."""
    th = np.linspace(0.3, np.pi - 0.3, 10)
    arc = np.stack([np.cos(th), np.sin(th)], -1)
    line = np.stack([np.linspace(0, 1, 10), np.zeros(10)], -1)
    t = np.linspace(0.6, 2.5, 12)
    arc2 = np.stack([0.5 + 0.2 * np.cos(t), 0.3 + 0.2 * np.sin(t)], -1)
    s = np.linspace(0.0, 0.5, 12)[:, None]
    line2 = np.concatenate([1.0 + s, 0.2 + 0.4 * s], axis=-1)
    for pts, sizes in [(np.concatenate([arc, line]), (10, 10)),
                       (np.concatenate([arc2, line2]), (12, 12))]:
        ids = np.repeat([0, 1], sizes).astype(np.int32)
        valid = np.ones(len(pts), bool)
        kw = dict(radius_thresh=1e9, max_clusters=4)
        tc, jc = tl.LandmarkConfig(**kw), jl.LandmarkConfig(**kw)
        circ = tl.fit_circles(tc, _t(pts), torch.as_tensor(ids),
                              torch.as_tensor(valid))
        got = tl.classify_circles(tc, _t(pts), torch.as_tensor(ids),
                                  torch.as_tensor(valid), circ).numpy()
        want = np.asarray(jax.jit(lambda p, i, v: jl.classify_circles(
            jc, p, i, v, jl.fit_circles(jc, p, i, v)))(
                jnp.asarray(pts), jnp.asarray(ids), jnp.asarray(valid)))
        np.testing.assert_array_equal(got, want)
        assert got[0] and not got[1]


def test_wall_rejection_closed_loop():
    """An L-corner fits a circle under a loose radius threshold and becomes
    a phantom landmark; use_classify rejects it and keeps the cylinder
    (tests/test_landmarks.py:177-218), on the same noisy scan as
    ``tpunav``'s, with the same detections."""
    base = dataclasses.replace(tl.LandmarkConfig(), radius_thresh=0.3)
    segs = np.array([[0.8, 0.0, 1.0, 0.2], [0.8, 0.0, 1.0, -0.2]])
    pose = np.array([0.2, 0.0, 0.0])
    n1 = jax.random.normal(jax.random.PRNGKey(4), (360,), jnp.float64)
    n2 = jax.random.normal(jax.random.PRNGKey(5), (360,), jnp.float64)
    r1 = tlidar.scan_cylinders(_t(pose), _t([[0.0, 0.6]]), _t([0.15]),
                               noise_std=0.002, noise=_t(n1))
    r2 = tlidar.scan_segments(_t(pose), _t(segs), noise_std=0.002,
                              noise=_t(n2))
    ranges = torch.minimum(r1, r2)
    R = np.array([[math.cos(-0.2), -math.sin(-0.2)],
                  [math.sin(-0.2), math.cos(-0.2)]])
    truth = (R @ np.array([[0.0, 0.6]]).T).T

    def counts(use_classify):
        cfg = dataclasses.replace(base, use_classify=use_classify)
        c = tl.feature_detection(cfg, ranges)
        jcfg = jl.LandmarkConfig(radius_thresh=0.3, use_classify=use_classify)
        jc = jax.jit(lambda r: jl.feature_detection(jcfg, r))(
            jnp.asarray(ranges.numpy()))
        np.testing.assert_array_equal(c.valid.numpy(), np.asarray(jc.valid))
        cn = c.centers.numpy()[c.valid.numpy()]
        d = np.linalg.norm(cn[:, None, :] - truth[None], axis=-1).min(-1)
        return int((d < 0.15).sum()), int((d >= 0.15).sum())

    hits, phantoms = counts(False)
    assert hits >= 1 and phantoms >= 1
    hits, phantoms = counts(True)
    assert hits >= 1 and phantoms == 0
