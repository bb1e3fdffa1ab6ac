"""The EKF sweep cell (``ekf_sweep_b20``) on the CPU at a small size: a
whole run through the harness reads ``correct``; each planted fault in the
program (a landmark add dropped, a Mahalanobis gate moved, the filter in
bfloat16, the detector's circles shifted inside the graph) comes out not
correct; the control (the reference in bfloat16 in the program's place)
fails a limit; the readers of its per-layer metrics; and the reference
loads nothing of the program."""

import os
import subprocess
import sys

import pytest
import torch

from navbench import harness

CELL = {c["name"]: c for c in harness.benchmark()["workloads"]}[
    "ekf_sweep_b20"]
# 3 seeds at K=64; sweeps of 40 ticks: three 12-tick chunks and a 4-tick
# tail, so the window crosses sweeps and loads them in place.
SMALL = {"seeds_per_sweep": 3, "rollouts": 64, "sweep_ticks": 40,
         "chunk_ticks": 12, "check_steps": [0, 8, 3], "seeds_checked": 2,
         "seeds_chained": 2, "sweeps": 3}
SEED = 2 ** 31 + 17


def run(seconds=8.0):
    return harness.run_cell(CELL, SEED, seconds, False, device="cpu",
                            sizes=SMALL)


def _failed_checks(out):
    return {k for k, (v, lim) in out["checks"].items() if not v <= lim}


def test_a_clean_run_is_correct_and_crosses_sweeps():
    out = run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    assert out["attempted"] >= 3 * 40 * 2          # two whole sweeps
    assert out["info"]["seed_steps_chained"] >= 3
    assert out["info"]["filter_ticks_compared"] > 0
    assert out["info"]["control_ticks"] > 0
    assert set(out["metrics"]) == {"solves_per_s", "setup_s"}


def _drop_adds(monkeypatch):
    from tpunav_torch.estimation.ekf import filter as ekff

    orig = ekff._unknown_row

    def dropped(cfg, k, carry, row):
        new = orig(cfg, k, carry, row)
        added = new[3] > carry[3]
        return tuple(torch.where(added, a, b) for a, b in zip(carry, new))

    monkeypatch.setattr(ekff, "_unknown_row", dropped)


def _moved_gate(monkeypatch):
    import dataclasses

    from tpunav_torch.estimation.ekf import filter as ekff

    orig = ekff._unknown_row

    def moved(cfg, k, carry, row):
        return orig(dataclasses.replace(cfg, dmin=cfg.dmin * 0.01), k, carry,
                    row)

    monkeypatch.setattr(ekff, "_unknown_row", moved)


def _bf16_filter(monkeypatch):
    from tpunav_torch.control import slam_loop as sl
    from tpunav_torch.estimation.ekf import EKFState

    orig = sl.slam_unknown_da_masked

    def bf16(cfg, st, meas, u):
        low = orig(cfg, EKFState(st.state.bfloat16(), st.cov.bfloat16(),
                                 st.active, st.count),
                   meas.bfloat16(), u.bfloat16())
        return EKFState(low.state.float(), low.cov.float(), low.active,
                        low.count)

    monkeypatch.setattr(sl, "slam_unknown_da_masked", bf16)


def _shifted_circles(monkeypatch):
    from tpunav_torch.sim import dense_world

    orig = dense_world.circles_to_measurements
    monkeypatch.setattr(dense_world, "circles_to_measurements",
                        lambda circles: orig(circles) + 0.01)


# The check that reads the graph's own circles, not a second run of the
# sensor chain.
_shifted_circles.check = "circle_err_m"


@pytest.mark.parametrize("fault", [_drop_adds, _moved_gate, _bf16_filter,
                                   _shifted_circles])
def test_a_planted_fault_is_caught(monkeypatch, fault):
    fault(monkeypatch)
    out = run()
    assert not out["correct"]
    assert _failed_checks(out) or out["failed"], out["checks"]
    if hasattr(fault, "check"):
        assert fault.check in _failed_checks(out), out["checks"]


def test_the_control_fails_a_limit():
    from navbench.drivers import dense_sweep

    cfg = harness.config(CELL["config"])
    mix = dict(harness.traffic(CELL["traffic"]), **SMALL)
    drv = dense_sweep.Driver(cfg, mix, SEED, torch.device("cpu"))
    while len(drv.records) < 2:
        drv.step()
    drv.release()
    program = drv.readings()
    control = drv.readings(torch.bfloat16)
    assert all(program[k] <= lim for k, lim in drv.limits.items()), program
    assert any(control[k] > lim for k, lim in drv.limits.items()), control


def test_the_sweep_bar_reads_the_sweeps_the_driver_runs():
    """``sweep_bar.end_errors`` runs a run seed's first sweeps as one
    batch; each sweep's worst end error is the one the driver reads at its
    end."""
    from navbench import sweep_bar
    from navbench.drivers import dense_sweep

    cfg = harness.config(CELL["config"])
    mix = dict(harness.traffic(CELL["traffic"]), **SMALL)
    drv = dense_sweep.Driver(cfg, mix, SEED, torch.device("cpu"))
    while len(drv.sweep_errors) < 2:
        drv.step()
    got = sweep_bar.end_errors(CELL, SEED, 2, device="cpu", sizes=SMALL)
    assert got["slam_m"] == drv.sweep_errors and got["finite"]
    assert max(got["slam_m"]) < 0.05 < min(got["odom_m"]) * 10


def test_the_readers():
    phases = {"ekf.update": {"count": 30, "missed": 0, "mean_ms": 1.5,
                             "offset_ms": 0.1},
              "slam.sense": {"count": 0, "missed": 2, "mean_ms": None,
                             "offset_ms": None}}
    ctx = {"phases": phases, "k": 2048, "n": 8, "b": 20,
           "kernels": {"mppi_rollout_partials_x": (2e-5, 2),
                       "mppi_combine_x": (1e-5, 2)},
           "profiled": {"K1": 2}, "counters": {"K1": 2}}
    assert harness.reader("ekf_update_device_ms")(ctx) == 1.5
    assert harness.reader("sense_device_ms")(ctx) is None
    assert harness.reader("sense_device_ms")({}) is None
    share = harness.reader("k1_batch_roofline_pct")(ctx)
    # 20 solves of 2,048 × 8 × 171 operations at 67 TFLOP/s over 15 µs.
    assert share == pytest.approx(100 * 20 * 2048 * 8 * 171 / 67e12 / 1.5e-5)
    assert harness.reader("k1_batch_roofline_pct")(
        dict(ctx, profiled={"K1": 0})) is None


def test_the_reference_loads_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", (
        "import sys, navbench.reference.ekf_dense\n"
        "print(sorted({m.split('.', 1)[0] for m in sys.modules}))")],
        cwd=harness.REPO, capture_output=True, text=True, check=True,
        env=dict(os.environ, USE_FLAX="0"))
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"tpunav_torch", "tpunav", "jax"}, tops
