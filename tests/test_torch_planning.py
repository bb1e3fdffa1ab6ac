"""The port's planning package against ``tpunav.planning``.

Every case of ``tests/test_planning.py`` runs on the port's functions (on
the CPU), and each piece is held against ``tpunav`` on the same inputs:
the geometry primitives to 1e-12 in float64; the grid labels equal in
float64 (the tests run jax in x64 mode, so ``tpunav`` labels in float64),
with float32 labels differing only on cells within 1e-5 of a threshold;
the roadmap over ``tpunav``'s sampled nodes (``interop.roadmap_from_numpy``)
with its adjacency and Theta* path exactly; D* Lite's paths exactly; the
potential field's path to 1e-5 in float64.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunav import planning as jplan
from tpunav.planning import utilities as jutil
from tpunav_torch import interop
from tpunav_torch.planning import (
    FREE,
    INFLATED,
    OBSTACLE,
    DStarLite,
    PlanningGrid,
    PotentialField,
    PotentialFieldConfig,
    REFERENCE_MAP,
    RoadMap,
    load_obstacle_map,
    min_dist_segment_point,
    signed_min_dist,
    theta_star,
)
from tpunav_torch.planning import utilities as util

torch.set_num_threads(1)

F64 = torch.float64
# A simple 1x1 square obstacle centered at (2, 2) in a 4x4 world.
SQUARE_MAP = load_obstacle_map(
    [[[1.5, 1.5], [2.5, 1.5], [2.5, 2.5], [1.5, 2.5]]],
    bounds=[[0.0, 4.0], [0.0, 4.0]], resolution=0.1)
# The obstacle course's world (examples/obstacle_mppi_demo.py).
WALL_MAP = load_obstacle_map(
    [[[0.95, 0.7], [1.05, 0.7], [1.05, 1.3], [0.95, 1.3]]],
    bounds=[[0.0, 2.0], [0.0, 2.0]], resolution=0.05)
MAPS = {"square": SQUARE_MAP, "reference": REFERENCE_MAP, "wall": WALL_MAP}


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a), dtype=F64) for a in arrays]


# ------------------------------------------- tests/test_planning.py -----

def test_min_dist_segment_point():
    a, b = _t([0.0, 0.0], [2.0, 0.0])
    # Perpendicular case, endpoint cases.
    for p, want in [([1.0, 1.0], 1.0), ([3.0, 0.0], 1.0), ([-2.0, 0.0], 2.0)]:
        assert np.isclose(float(min_dist_segment_point(a, b, *_t(p))), want)


def test_signed_min_dist_leftward_normal():
    # Left of the edge → positive (ref convention planner_utilities.cpp).
    a, b = _t([0.0, 0.0], [1.0, 0.0])
    cp = signed_min_dist(a, b, *_t([0.5, 0.7]))
    assert float(cp.sign_d) > 0
    assert bool(cp.on_seg)
    assert float(signed_min_dist(a, b, *_t([0.5, -0.7])).sign_d) < 0
    assert not bool(signed_min_dist(a, b, *_t([2.0, 0.1])).on_seg)


def test_grid_labeling_square():
    grid = PlanningGrid(SQUARE_MAP, inflation=0.1, device="cpu")
    lab = grid.labels
    assert lab.dtype == np.int8
    iy, ix = grid.world_to_grid(np.array([2.0, 2.0]))
    assert lab[iy, ix] == OBSTACLE          # center of the square
    iy, ix = grid.world_to_grid(np.array([2.0, 2.58]))
    assert lab[iy, ix] == INFLATED          # just outside (within 0.15)
    iy, ix = grid.world_to_grid(np.array([1.0, 3.5]))
    assert lab[iy, ix] == FREE
    iy, ix = grid.world_to_grid(np.array([0.02, 2.0]))
    assert lab[iy, ix] == INFLATED          # wall inflation


def test_reference_world_grid():
    # 3.4 x 4.8 m at 0.1 m → 34 x 48 cells (ref: plan.launch:22-49).
    grid = PlanningGrid(REFERENCE_MAP, inflation=0.1, device="cpu")
    assert grid.labels.shape == (48, 34)
    assert (grid.labels == OBSTACLE).sum() > 50
    assert (grid.labels == FREE).sum() > 200


def test_prm_nodes_free_and_connected():
    rm = RoadMap(SQUARE_MAP, n_nodes=60, k_neighbors=8, clearance=0.15,
                 seed=3)
    # All sampled nodes keep clearance from the square.
    d = np.abs(rm.nodes - 2.0).max(axis=1)
    assert (d > 0.5).all(), "node inside obstacle/inflation"
    degrees = np.asarray([len(a) for a in rm.adjacency])
    assert (degrees > 0).mean() > 0.9, "roadmap mostly disconnected"


def test_theta_star_finds_path_around_obstacle():
    rm = RoadMap(SQUARE_MAP, n_nodes=80, k_neighbors=10, clearance=0.15,
                 seed=5)
    s = rm.add_node([0.5, 0.5])
    g = rm.add_node([3.5, 3.5])
    assert s is not None and g is not None
    path = theta_star(rm, s, g)
    assert path is not None
    assert np.allclose(path[0], [0.5, 0.5])
    assert np.allclose(path[-1], [3.5, 3.5])
    for i in range(len(path) - 1):
        assert rm.edge_free(path[i], path[i + 1])
    # Theta* shortcuts: around the square ≤ 6 (straight line ~4.24).
    length = np.sum(np.linalg.norm(np.diff(path, axis=0), axis=1))
    assert length < 6.0, length


def test_prm_theta_star_at_scale():
    """2,000 nodes x 20-NN on the reference world build and plan within
    ``tpunav``'s 30 s bound."""
    t0 = time.time()
    rm = RoadMap(REFERENCE_MAP, n_nodes=2000, k_neighbors=20,
                 clearance=0.1, seed=11)
    s = rm.add_node([0.3, 0.3])
    g = rm.add_node([3.0, 4.4])
    assert s is not None and g is not None
    path = theta_star(rm, s, g)
    elapsed = time.time() - t0
    assert path is not None
    for i in range(len(path) - 1):
        assert rm.edge_free(path[i], path[i + 1])
    assert elapsed < 30.0, f"PRM-at-scale took {elapsed:.1f}s"


def test_dstar_reaches_goal_and_avoids_revealed_obstacles():
    grid = PlanningGrid(SQUARE_MAP, inflation=0.1, device="cpu")
    start = grid.world_to_grid(np.array([0.5, 0.5]))
    goal = grid.world_to_grid(np.array([3.5, 3.5]))
    path = DStarLite(grid, start, goal, vis_radius=4).traverse()
    assert path is not None
    assert tuple(path[-1]) == tuple(goal)
    for iy, ix in path:
        assert grid.labels[iy, ix] != OBSTACLE, (iy, ix)


def test_dstar_blocked_world_pays_penalty():
    # A wall across the whole world: the finite 1000 edge cost into
    # obstacles yields a penalized crossing rather than failure.
    blocked = load_obstacle_map(
        [[[1.0, 0.0], [1.4, 0.0], [1.4, 4.0], [1.0, 4.0]]],
        bounds=[[0.0, 4.0], [0.0, 4.0]], resolution=0.1)
    grid = PlanningGrid(blocked, inflation=0.1, device="cpu")
    start = grid.world_to_grid(np.array([0.5, 2.0]))
    goal = grid.world_to_grid(np.array([3.5, 2.0]))
    path = DStarLite(grid, start, goal, vis_radius=50).traverse(
        max_steps=3000)
    assert path is not None
    assert tuple(path[-1]) == tuple(goal)
    assert any(grid.labels[iy, ix] != FREE for iy, ix in path)


def test_potential_field_converges():
    # Asymmetric start/goal: a symmetric head-on approach stalls in the
    # classic potential-field local minimum.
    pf = PotentialField(PotentialFieldConfig(step=0.05, qthresh=0.3),
                        SQUARE_MAP, device="cpu")
    path = pf.plan([0.5, 1.0], [3.5, 3.0], max_steps=500)
    end = path[-1].numpy()
    assert np.linalg.norm(end - [3.5, 3.0]) < 0.06, end
    for q in path:
        q = q.numpy()
        assert not (1.55 < q[0] < 2.45 and 1.55 < q[1] < 2.45), q


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_potential_field_graph_equals_eager_steps(dtype):
    """``plan``'s graph steps against the eager descent (the step function
    called on the path's last point until the goal tolerance): the same
    path bit for bit, twice from one planner (its static start and goal
    reloaded)."""
    from tpunav_torch.planning import potential_field as tpf

    pf = PotentialField(PotentialFieldConfig(step=0.05, qthresh=0.3),
                        MAPS["reference"], device="cpu", dtype=dtype)
    for start, goal in (([0.6, 0.3], [2.0, 3.7]), ([0.5, 1.0], [3.5, 3.0])):
        path = pf.plan(start, goal, max_steps=300)
        q = torch.as_tensor(start, dtype=dtype)
        g = torch.as_tensor(goal, dtype=dtype)
        want = [q]
        while len(want) <= 300 and float(
                torch.linalg.vector_norm(q - g)) >= pf.cfg.eps:
            q = tpf._one_step(pf.cfg, pf.a, pf.b, pf.valid, q, g)
            want.append(q)
        assert len(path) == len(want) > 20
        assert all(torch.equal(a, b) for a, b in zip(path, want))


def test_dstar_online_observe_reroutes():
    """An all-free belief plans straight; observing a barrier forces an
    incremental replan through the gap; advance() reaches the goal."""
    from tpunav_torch.planning.dstar import dstar_from_labels

    h = w = 30
    start, goal = (15, 2), (15, 27)
    planner = dstar_from_labels(np.full((h, w), FREE, np.int8), start, goal)
    planner.compute_shortest_path()
    p0 = planner.path_to_goal()
    assert tuple(p0[-1]) == goal
    assert len(p0) <= 27

    labels = np.full((h, w), FREE, np.int8)
    labels[:, 14] = OBSTACLE
    labels[3:6, 14] = FREE
    planner.observe(labels)
    p1 = planner.path_to_goal()
    assert tuple(p1[-1]) == goal
    rows_at_wall = [iy for iy, ix in p1 if ix == 14]
    assert rows_at_wall and all(3 <= r <= 5 for r in rows_at_wall)
    for _ in range(500):
        assert planner.advance() is not None, "goal unreachable"
        if planner.pos == goal:
            break
    assert planner.pos == goal


# ---------------------------------------------------- against tpunav ----

def _random_geometry(seed, shape=(64,)):
    rng = np.random.default_rng(seed)
    pts = [rng.uniform(-2, 2, shape + (2,)) for _ in range(4)]
    pts[1][:4] = pts[0][:4]                       # degenerate segments
    pts[2][4:8] = pts[0][4:8]                     # points on an endpoint
    pts[3][8:12] = 0.5 * (pts[0][8:12] + pts[1][8:12])   # on the segment
    return pts


@pytest.mark.parametrize("seed", [0, 1])
def test_geometry_primitives_match_tpunav(seed):
    a, b, p, q = _random_geometry(seed)
    ja, jb, jpt, jq = map(jnp.asarray, (a, b, p, q))
    ta, tb, tpt, tq = _t(a, b, p, q)
    np.testing.assert_allclose(
        min_dist_segment_point(ta, tb, tpt).numpy(),
        np.asarray(jutil.min_dist_segment_point(ja, jb, jpt)), atol=1e-12,
        rtol=0)
    cp, jcp = signed_min_dist(ta, tb, tpt), jutil.signed_min_dist(ja, jb, jpt)
    for name in ("t", "sign_d", "point"):
        np.testing.assert_allclose(getattr(cp, name).numpy(),
                                   np.asarray(getattr(jcp, name)),
                                   atol=1e-12, rtol=0)
    np.testing.assert_array_equal(cp.on_seg.numpy(), np.asarray(jcp.on_seg))
    np.testing.assert_array_equal(
        util.segments_intersect(ta, tb, tpt, tq).numpy(),
        np.asarray(jutil.segments_intersect(ja, jb, jpt, jq)))
    # Touching and collinear cases.
    seg = _t([0, 0], [2, 0], [1, 0], [1, 1], [2, 0], [3, 0], [0, 1], [2, 1])
    jseg = [jnp.asarray(s.numpy()) for s in seg]
    for i, j in [(0, 2), (0, 4), (0, 6), (2, 4)]:
        assert bool(util.segments_intersect(seg[0], seg[1], seg[i],
                                            seg[i + 1])) == bool(
            jutil.segments_intersect(jseg[0], jseg[1], jseg[i], jseg[i + 1]))


@pytest.mark.parametrize("name", sorted(MAPS))
def test_polygon_queries_match_tpunav(name):
    m = MAPS[name]
    rng = np.random.default_rng(7)
    (x0, x1), (y0, y1) = m.bounds
    pts = np.stack([rng.uniform(x0, x1, 50), rng.uniform(y0, y1, 50)], -1)
    for poly, n in zip(m.polygons, m.n_vertices):
        tpoly, = _t(poly)
        a, b, valid = util.polygon_edges(tpoly, int(n))
        ja, jb, jvalid = jutil.polygon_edges(jnp.asarray(poly), int(n))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        for p in pts:
            tp, = _t(p)
            assert bool(util.point_in_polygon(tpoly, int(n), tp)) == bool(
                jutil.point_in_polygon(jnp.asarray(poly), int(n),
                                       jnp.asarray(p)))
            np.testing.assert_allclose(
                float(util.dist_to_polygon(tpoly, int(n), tp)),
                float(jutil.dist_to_polygon(jnp.asarray(poly), int(n),
                                            jnp.asarray(p))),
                atol=1e-12, rtol=0)


def _label_margins(grid):
    """Per cell, in float64: the distance of each labelling predicate from
    its threshold (inside: the polygon's smallest edge signed distance;
    near and wall: their distance to bnd_rad)."""
    w, h, res = grid.width, grid.height, grid.resolution
    xs = grid.xmin + (np.arange(w) + 0.5) * res
    ys = grid.ymin + (np.arange(h) + 0.5) * res
    px, py = np.meshgrid(xs, ys)
    pts = torch.from_numpy(np.stack([px, py], -1).reshape(-1, 1, 2))
    margins = []
    for poly, n in zip(grid.obs.polygons, grid.obs.n_vertices):
        a, b, valid = util.polygon_edges(torch.from_numpy(poly), int(n))
        sd = util.signed_min_dist(a, b, pts).sign_d
        d = util.min_dist_segment_point(a, b, pts)
        margins.append(torch.where(valid, sd, torch.inf).amin(1).abs())
        margins.append((torch.where(valid, d, torch.inf).amin(1) -
                        grid.bnd_rad).abs())
    pts = pts[:, 0]
    wall = torch.minimum(
        torch.minimum(pts[:, 0] - grid.xmin, grid.xmax - pts[:, 0]),
        torch.minimum(pts[:, 1] - grid.ymin, grid.ymax - pts[:, 1]))
    margins.append((wall - grid.bnd_rad).abs())
    return torch.stack(margins).amin(0).reshape(h, w).numpy()


@pytest.mark.parametrize("name", sorted(MAPS))
def test_grid_labels_match_tpunav(name):
    m = MAPS[name]
    want = jplan.PlanningGrid(m, inflation=0.1).labels
    grid = PlanningGrid(m, inflation=0.1, device="cpu", dtype=F64)
    assert grid.labels.dtype == np.int8 == want.dtype
    np.testing.assert_array_equal(grid.labels, want)
    # float32, the default: cells may flip only on a threshold's edge.
    f32 = PlanningGrid(m, inflation=0.1, device="cpu").labels
    differ = f32 != grid.labels
    print(f"{name}: {int(differ.sum())} of {differ.size} float32 labels "
          "differ from float64")
    assert np.all(_label_margins(grid)[differ] < 1e-5)


@pytest.mark.parametrize("seed", [2, 3, 5])
def test_roadmap_and_theta_star_match_tpunav(seed):
    m = WALL_MAP if seed == 2 else SQUARE_MAP
    kw = dict(k_neighbors=10, clearance=0.18 if seed == 2 else 0.15)
    jrm = jplan.RoadMap(m, n_nodes=80, seed=seed, **kw)
    rm = interop.roadmap_from_numpy(m, jrm.nodes, **kw)
    assert rm.adjacency == jrm.adjacency
    ends = ([0.2, 1.0], [1.8, 1.0]) if seed == 2 else ([0.5, 0.5],
                                                       [3.5, 3.5])
    idx = [rm.add_node(p) for p in ends]
    jidx = [jrm.add_node(p) for p in ends]
    assert idx == jidx and rm.adjacency == jrm.adjacency
    path = theta_star(rm, *idx)
    np.testing.assert_array_equal(path, jplan.theta_star(jrm, *jidx))
    # The port's own draw is seeded, free and different from tpunav's.
    own = RoadMap(m, n_nodes=80, seed=seed, **kw)
    again = RoadMap(m, n_nodes=80, seed=seed, **kw)
    np.testing.assert_array_equal(own.nodes, again.nodes)
    assert own.adjacency == again.adjacency
    assert own._point_free(own.nodes).all()
    assert not np.array_equal(own.nodes, jrm.nodes)


def test_dstar_paths_match_tpunav():
    grid = PlanningGrid(SQUARE_MAP, inflation=0.1, device="cpu", dtype=F64)
    jgrid = jplan.PlanningGrid(SQUARE_MAP, inflation=0.1)
    start = grid.world_to_grid(np.array([0.5, 0.5]))
    goal = grid.world_to_grid(np.array([3.5, 3.5]))
    for vis in (2, 4, 50):
        path = DStarLite(grid, start, goal, vis_radius=vis).traverse()
        want = jplan.DStarLite(jgrid, start, goal, vis_radius=vis).traverse()
        np.testing.assert_array_equal(path, want)


@pytest.mark.parametrize("name", ["square", "reference"])
def test_potential_field_matches_tpunav(name):
    cfg_kw = dict(step=0.05, qthresh=0.3)
    start, goal = (([0.5, 1.0], [3.5, 3.0]) if name == "square"
                   else ([0.6, 0.3], [2.0, 3.7]))
    # tpunav.plan rounds start and goal to float32, then steps in float64.
    start, goal = np.float32(start), np.float32(goal)
    pf = PotentialField(PotentialFieldConfig(**cfg_kw), MAPS[name],
                        device="cpu", dtype=F64)
    jpf = jplan.PotentialField(jplan.PotentialFieldConfig(**cfg_kw),
                               MAPS[name])
    path = torch.stack(pf.plan(start, goal, max_steps=300)).numpy()
    want = np.stack([np.asarray(q) for q in jpf.plan(start, goal,
                                                     max_steps=300)])
    assert path.shape == want.shape
    np.testing.assert_allclose(path, want, atol=1e-5, rtol=0)
