"""The port's smaller demos and its fidelity-table script
(``examples_torch/``) against ``tpunav``'s (``examples/``,
``make_results.py``).

- ``rigid2d_frames_demo`` with no terminal on stdin prints ``tpunav``'s
  lines, numbers within 1e-6.
- ``planners_demo``: the three planners find paths; the PRM over
  ``tpunav``'s sampled nodes (``interop.roadmap_from_numpy``) gives
  ``tpunav``'s Theta* path.
- Shortened runs of the MPPI courses, the obstacle course, the RBPF demo
  and the stage profile finish finite on the CPU (K1–K4's plain versions);
  the live view writes its PNG.
- ``make_results``: ``tpunav``'s formatters' strings, and a one-row run
  that writes the row's heading, ``tpunav``'s line for it from RESULTS.md,
  and no TPU rate or time.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import make_results as jmr
from examples_torch import make_results as tmr
from examples_torch import mppi_waypoints_demo as tmw
from examples_torch import obstacle_mppi_demo as tob
from examples_torch import planners_demo as tpl
from examples_torch import profile_rbpf_stages as tps
from examples_torch import rbpf_slam_demo as trs
from tpunav.planning import REFERENCE_MAP as J_MAP
from tpunav.planning import RoadMap as JRoadMap
from tpunav.planning import theta_star as j_theta_star

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NUM = re.compile(r"[-+]?\d+\.\d+")


def _demo_lines(args):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          stdin=subprocess.DEVNULL, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.splitlines()


def test_rigid2d_frames_demo_prints_tpunav_lines():
    got = _demo_lines(["-m", "examples_torch.rigid2d_frames_demo"])
    want = _demo_lines(["examples/rigid2d_frames_demo.py"])
    assert len(got) == len(want) == 15
    for g, w in zip(got, want):
        assert _NUM.sub("#", g) == _NUM.sub("#", w), (g, w)
        np.testing.assert_allclose([float(v) for v in _NUM.findall(g)],
                                   [float(v) for v in _NUM.findall(w)],
                                   rtol=0, atol=1e-6)


def test_prm_over_tpunav_nodes_gives_its_path():
    jrm = JRoadMap(J_MAP, n_nodes=200, k_neighbors=10, clearance=0.12,
                   seed=42)
    nodes = np.array(jrm.nodes)
    want = j_theta_star(jrm, jrm.add_node(tpl.START), jrm.add_node(tpl.GOAL))
    rm, path, length, _ = tpl.run_prm(nodes=nodes)
    np.testing.assert_allclose(path, np.asarray(want), rtol=0, atol=1e-9)
    assert length > np.hypot(*np.subtract(tpl.GOAL, tpl.START))


def test_prm_from_its_own_draw_finds_a_path():
    rm, path, length, _ = tpl.run_prm()
    np.testing.assert_allclose(path[0], tpl.START)
    np.testing.assert_allclose(path[-1], tpl.GOAL)
    assert len(rm.nodes) == 202 and np.isfinite(length)


def test_dstar_reaches_the_goal():
    grid, traj, _ = tpl.run_dstar(device="cpu")
    goal = tuple(int(v) for v in grid.world_to_grid(tpl.GOAL))
    assert tuple(traj[-1]) == goal and len(traj) > 10


def test_potential_field_reaches_the_goal():
    path, dist, _ = tpl.run_potential_field(device="cpu")
    assert len(path) > 1 and dist < 0.1


@pytest.mark.parametrize("use_fused", [False, True])
def test_mppi_waypoints_demo_shortened(use_fused):
    out = tmw.run(use_fused, 64, max_ticks=240, verbose=False, device="cpu")
    assert out["ticks"] == 240
    assert np.isfinite(out["pose"]).all() and np.isfinite(out["d2g"]).all()
    assert out["d2g"].shape == (240,)
    assert out["visits"] >= 1                    # the first waypoint, reached
    assert np.hypot(*out["pose"][:2]) > 0.05       # and the cart drives on


def test_obstacle_mppi_demo_shortened():
    out = tob.run(rollouts=64, max_ticks=240, verbose=False, device="cpu")
    assert out["ticks"] == 240 and out["segments"] == 4
    assert np.isfinite(out["pose"]).all()
    assert out["min_clearance_m"] > 0.05
    assert out["route"].shape[1] == 3


def test_rbpf_slam_demo_shortened():
    err, occ, free, wall, n = trs.run(num_particles=8, updates=5,
                                      device="cpu")
    assert n == 5 and np.isfinite(err).all() and occ > 0 and free > 0
    assert np.hypot(*err[1:]) < 0.05


@pytest.mark.parametrize("rbpf", [False, True])
def test_live_view_demo_writes_its_png(tmp_path, rbpf):
    from examples_torch import live_view_demo

    out = str(tmp_path / "live.png")
    view, ch, path = live_view_demo.run(1.0, rbpf, out, device="cpu")
    assert path == out and os.path.getsize(out) > 0 and view.frames >= 1
    assert ch["slam_pose"].latest() is not None


def test_profile_closed_loop_shortened():
    """The eager interval's split (the replayed one is the default, held in
    tests/test_torch_examples_rbpf.py)."""
    out = tps.profile_closed_loop(num_particles=16, reps=2, rollouts=64,
                                  device="cpu", eager=True)
    assert list(out) == [*tps.STAGES, "whole scan interval (chained)"]
    stages = [out[k] for k in tps.STAGES]     # launches and syncs: card only
    assert all(v > 0 for v in stages) and np.isfinite(list(out.values())).all()
    # Marks between the stages of the chained run: the stages are the whole.
    assert sum(stages) == pytest.approx(out["whole scan interval (chained)"],
                                        rel=1e-9)


def test_stage_times_shortened():
    out = tps.stage_times(num_particles=16, reps=1, device="cpu")
    assert len(out) == 7 and all(v > 0 for v in out.values())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_results_formatters_match_tpunav(seed):
    rng = np.random.default_rng(seed)
    errs = rng.normal(scale=[0.1, 0.05, 0.05], size=(5, 3))
    assert tmr.fmt_err(errs[0]) == jmr.fmt_err(errs[0])
    assert tmr.fmt_stats(errs) == jmr.fmt_stats(errs)


def test_make_results_one_row(tmp_path):
    """Rows 2 then 1 over two runs into one file, two seeds each at 20
    steps: each row under its heading with its seed count, tpunav's line
    for it from RESULTS.md beside it, no TPU rate or time."""
    out = str(tmp_path / "R.md")
    for row in ("2", "1"):
        tmr.main(["--rows", row, "--seeds", "2", "--steps", "20",
                  "--device", "cpu", "--out", out, "--commit", "test"])
    with open(out, encoding="utf-8") as f:
        text = f.read()
    heads = [line for line in text.splitlines() if line.startswith("## ")]
    assert heads == [f"## {tmr.HEADINGS[1]}", f"## {tmr.HEADINGS[2]}"]
    assert text.count("2 seeds, 20 steps (not 400)") == 2
    for row in (1, 2):
        for line in tmr.tpunav_lines(row):
            assert line in text
    # tpunav's statistics are quoted; its rates, times and history are not.
    assert "| **SLAM** | x +0.0161 m, y +0.0051 m, yaw +0.347° |" in text
    for quoted in [line for line in text.splitlines()
                   if line.startswith("> ") or "tpunav" in line]:
        assert not tmr._RATE.search(quoted), quoted
    assert "Performance history" not in text and "vmapped" not in text


def test_tpunav_lines_quote_no_rate():
    for row in tmr.HEADINGS:
        for line in tmr.tpunav_lines(row):
            assert not tmr._RATE.search(line)
    assert tmr.tpunav_lines(6) == []
    assert "10/10" in tmr.tpunav_lines(5)[0]
