"""BASELINE config 5: RBPF grid SLAM at 500 particles under an MPPI
exploration loop — the whole closed navigation stack in one program.

Counterpart of ``examples/rbpf_explore_demo.py``. The reference maps under
teleoperated driving (ref: bmapping/src/turtle_mapping_node.cpp:451-666,
launch defaults 40 particles); here the driver is the fused MPPI waypoint
controller (kernel K1) steering the robot round a walled box on biased
odometry, while all 500 particles carry their own occupancy grid and
distance field (kernels K2 and K3; K4 builds the first field). Per scan
interval the host loop runs 6 control ticks (a K1 solve at K=2,048 on the
odometry pose → the motor model → the plant and the drifting odometry),
one lidar raycast and one ``pf_slam_step``. Mid-run the whole state
(filter, generators and controller) is checkpointed to disk, and the run
resumes from the restored state (``runtime/checkpoint.py``); the resumed
chunk is held bit for bit against the same chunk run from the state in
memory.

    python -m examples_torch.rbpf_explore_demo [--device cpu]

No step reads the device on the host: the K1 seeds are a device zero plus
a host int, the waypoint index advances through ``torch.where``, and the
per-scan observability sample stays on the device until the run ends.
"""

from __future__ import annotations

import hashlib
import os
import statistics
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from examples_torch import device_parser, draw, out_path, synchronize
from tpunav_torch.control.mppi import MPPIConfig, init_controls
from tpunav_torch.control.waypoint_loop import _active_waypoint
from tpunav_torch.core.angles import normalize_angle_pi
from tpunav_torch.device import DEFAULT_DEVICE, resolve
from tpunav_torch.estimation.rbpf import (GridConfig, PFConfig, PFState,
                                          best_particle, pf_init, pf_slam_step)
from tpunav_torch.estimation.rbpf.icp import ICPConfig
from tpunav_torch.models.cart import CartParams, kinematic_cart
from tpunav_torch.ops.fused_mppi import mppi_solve_fused
from tpunav_torch.ops.rk4 import rk4_step
from tpunav_torch.runtime.checkpoint import load_pytree, save_pytree
from tpunav_torch.sim.lidar import box_segments, scan_segments
from tpunav_torch.sim.motor import MotorParams, track

MODEL = CartParams(0.033, 0.160)
TICKS_PER_SCAN = 6
TICK_DT = 1.0 / 60.0
# Torque-capped first-order motor lag between command and plant
# (ref: turtle_drive_plugin.cpp:226-232) — the dynamic plant, not the
# idealized kinematic one.
MOTOR = MotorParams(time_const=0.05)
# Reference-scale odometry corruption (the reference's run drifted to
# 19.5/−10.5 cm, 2.62° — bmapping/README.md:45): a common-mode wheel scale
# error (translation drift) plus a differential one (heading drift).
WHEEL_BIAS = (1.065, 1.005)
SCAN_SEED = 31
FILTER_SEED = 3

# Square exploration course inside the box (x, y, theta).
WAYPOINTS = [[0.9, 0.0, 0.0], [0.9, 0.9, 0.0], [-0.9, 0.9, 0.0],
             [-0.9, -0.9, 0.0], [0.9, -0.9, 0.0]]


class ExploreState(NamedTuple):
    """Everything a scan interval carries, and the checkpoint holds."""

    pf: PFState
    true_pose: torch.Tensor   # (3,) [theta, x, y]
    odom_pose: torch.Tensor   # (3,) [theta, x, y], biased odometry
    u: torch.Tensor           # (N, 2) nominal controls
    wheel_vel: torch.Tensor   # (2,) the motors' wheel speeds
    wpt_idx: torch.Tensor     # int32, on the device
    tick: int                 # scans so far, on the host (keys K1's seeds)
    scan_gen: torch.Generator  # the lidar's range noise


def body_twist(cur_odom, prev_odom):
    """Signed body-frame [w, vx] over the inter-scan interval (poses are
    [theta, x, y]) — wrap the heading delta, project the displacement onto
    the previous heading (ref: turtle_mapping_node.cpp:469-474 derives the
    same from wheel deltas)."""
    dth = normalize_angle_pi(cur_odom[0] - prev_odom[0])
    c, s = torch.cos(prev_odom[0]), torch.sin(prev_odom[0])
    dx = cur_odom[1] - prev_odom[1]
    dy = cur_odom[2] - prev_odom[2]
    return torch.stack([dth, c * dx + s * dy])


def _xyt(p):
    return torch.stack([p[1], p[2], p[0]])


def _txy(p):
    return torch.stack([p[2], p[0], p[1]])


def control_tick(mppi_cfg: MPPIConfig, waypoints, wheel_bias, true_pose,
                 odom_pose, u, wheel_vel, wpt_idx, seed, noise=None):
    """One 60 Hz control tick: the waypoint advance on arrival (odometry
    frame, like the reference node's odomCallBack,
    mppi_waypoints_node.cpp:231-258) → one K1 solve on the odometry pose
    (``noise``: the solve's (N, K, 2) perturbations in place of the
    in-kernel draw) → the motors track the command → the plant and the
    odometry integrate the measured wheel speeds, the odometry's biased
    by ``wheel_bias``. Returns (true_pose, odom_pose, u, wheel_vel,
    wpt_idx)."""
    n_wpts = waypoints.shape[0]
    wpt = _active_waypoint(waypoints, wpt_idx)
    d2g = torch.hypot(odom_pose[1] - wpt[0], odom_pose[2] - wpt[1])
    wpt_idx = torch.where(d2g < 0.15, (wpt_idx + 1) % n_wpts, wpt_idx)
    wpt = _active_waypoint(waypoints, wpt_idx)
    cmd, u = mppi_solve_fused(mppi_cfg, MODEL, u, seed, _xyt(odom_pose), wpt,
                              noise=noise)
    wheel_vel = track(MOTOR, wheel_vel, cmd, TICK_DT)
    f = lambda x, uu: kinematic_cart(MODEL, x, uu)  # noqa: E731
    true_pose = _txy(rk4_step(f, _xyt(true_pose), wheel_vel, TICK_DT))
    odom_pose = _txy(rk4_step(f, _xyt(odom_pose), wheel_vel * wheel_bias,
                              TICK_DT))
    return true_pose, odom_pose, u, wheel_vel, wpt_idx


def configs(num_particles=500, rollouts=2048):
    """(pf_cfg, mppi_cfg): config 5's filter and the K=2,048, N=50
    controller."""
    pf_cfg = PFConfig(num_particles=num_particles, k_samples=50,
                      sample_range=(1e-6, 1e-5, 1e-5),
                      motion_noise=(1e-6, 1e-5, 1e-5),
                      grid=GridConfig(), icp=ICPConfig(max_iter=25))
    return pf_cfg, MPPIConfig(horizon=0.5, dt=0.01, rollouts=rollouts)


def init_state(pf_cfg: PFConfig, mppi_cfg: MPPIConfig, seed=FILTER_SEED,
               device=DEFAULT_DEVICE) -> ExploreState:
    """The run's start at the origin: a fresh filter from ``seed``, the
    lidar's generator seeded 31."""
    device = resolve(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SCAN_SEED)
    z3 = torch.zeros(3, dtype=torch.float32, device=device)
    return ExploreState(
        pf=pf_init(pf_cfg, seed=seed, device=device), true_pose=z3,
        odom_pose=z3.clone(), u=init_controls(mppi_cfg, device=device),
        wheel_vel=torch.zeros(2, dtype=torch.float32, device=device),
        wpt_idx=torch.zeros((), dtype=torch.int32, device=device), tick=0,
        scan_gen=gen)


def build(num_particles=500, scans_per_chunk=20, rollouts=2048,
          device=DEFAULT_DEVICE):
    """Returns (pf_cfg, mppi_cfg, run_chunk). ``run_chunk(st, series=None,
    marks=None)`` runs ``scans_per_chunk`` scan intervals from ``st`` and
    returns the state after them; each scan appends its five-metric sample
    (SLAM |xy| and yaw error, odometry |xy| and yaw error, N_eff), a device
    tensor, to ``series`` where given. ``marks`` (an
    ``examples_torch.Marks``): one mark at the chunk's start, then three
    per scan, after the control ticks, the lidar raycast and the SLAM
    update, so consecutive marks split the chained run into its stages."""
    device = resolve(device)
    pf_cfg, mppi_cfg = configs(num_particles, rollouts)
    grid = pf_cfg.grid
    segs = box_segments(-1.8, -1.8, 1.8, 1.8, device=device)
    waypoints = torch.tensor(WAYPOINTS, dtype=torch.float32).to(device)
    wheel_bias = torch.tensor(WHEEL_BIAS, dtype=torch.float32).to(device)
    seed0 = torch.zeros((), dtype=torch.int32, device=device)

    def scan_interval(st: ExploreState, series, mark):
        prev_odom = st.odom_pose
        true_pose, odom_pose, u, wheel_vel, wpt_idx = (
            st.true_pose, st.odom_pose, st.u, st.wheel_vel, st.wpt_idx)
        for t in range(TICKS_PER_SCAN):
            true_pose, odom_pose, u, wheel_vel, wpt_idx = control_tick(
                mppi_cfg, waypoints, wheel_bias, true_pose, odom_pose, u,
                wheel_vel, wpt_idx, seed0 + (st.tick * TICKS_PER_SCAN + t))
        mark()
        scan = scan_segments(true_pose, segs, num_beams=grid.num_beams,
                             max_range=grid.range_max, generator=st.scan_gen,
                             noise_std=0.002)
        mark()
        pf = pf_slam_step(pf_cfg, st.pf, scan,
                          body_twist(odom_pose, prev_odom), odom_pose,
                          prev_odom)
        if series is not None:
            series.append(_metrics(pf, true_pose, odom_pose))
        mark()
        return ExploreState(pf, true_pose, odom_pose, u, wheel_vel, wpt_idx,
                            st.tick + 1, st.scan_gen)

    def run_chunk(st: ExploreState, series=None, marks=None) -> ExploreState:
        mark = marks.mark if marks is not None else (lambda: None)
        mark()
        for _ in range(scans_per_chunk):
            st = scan_interval(st, series, mark)
        return st

    return pf_cfg, mppi_cfg, run_chunk


def _metrics(pf: PFState, true_pose, odom_pose):
    """The per-scan observability sample (the reference's PoseError /
    rqt_plot stream, tsim/launch/trect.launch:18-21), on the device."""
    pose, _ = best_particle(pf)
    w = torch.softmax(pf.log_weights, dim=0)
    return torch.stack([
        torch.hypot(pose[1] - true_pose[1], pose[2] - true_pose[2]),
        normalize_angle_pi(pose[0] - true_pose[0]),
        torch.hypot(odom_pose[1] - true_pose[1], odom_pose[2] - true_pose[2]),
        normalize_angle_pi(odom_pose[0] - true_pose[0]),
        1.0 / torch.sum(w * w)])


def digests(st: ExploreState) -> dict:
    """sha256 of the poses, log-weights, grids and controls: equal digests
    are equal bits."""
    out = {}
    for name, t in [("poses", st.pf.poses), ("log_weights", st.pf.log_weights),
                    ("grids", st.pf.grids), ("u", st.u)]:
        out[name] = hashlib.sha256(
            t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()
    return out


def checkpoint_roundtrip(st: ExploreState, path: str) -> ExploreState:
    """``st`` saved to ``path`` and loaded back into a new state on
    ``st``'s device (its generators rebuilt from their saved states)."""
    save_pytree(path, st)
    return load_pytree(path, st)


def _errors(pose, true_pose):
    e = (pose - true_pose).cpu().numpy().astype(np.float64)
    e[0] = (e[0] + np.pi) % (2 * np.pi) - np.pi
    return e


def run_experiment(num_particles=500, scans_per_chunk=20, rollouts=2048,
                   timed_chunks=4, device=DEFAULT_DEVICE):
    """The whole exploration experiment; returns the RESULTS row (dict):
    final SLAM and odometry errors [θ, x, y], the update rate (best and
    median chunk), the scan count, and the checkpoint's resume proof.

    A warm-up chunk on a throwaway state, a timed chunk, a checkpoint of
    the whole state to disk and back; then the same chunk from the state
    in memory and from the restored state (their digests must be equal:
    ``resume_bit_equal``), and ``timed_chunks`` timed chunks from the
    restored run. Rates are chunk wall times ended by a synchronize; the
    first timed chunk and the later ones give best and median."""
    device = resolve(device)
    pf_cfg, mppi_cfg, run_chunk = build(num_particles, scans_per_chunk,
                                        rollouts, device)
    run_chunk(init_state(pf_cfg, mppi_cfg, device=device))   # warm-up
    synchronize(device)

    series = []
    t0 = time.perf_counter()
    st = run_chunk(init_state(pf_cfg, mppi_cfg, device=device), series)
    synchronize(device)
    times = [time.perf_counter() - t0]

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rbpf_explore_ckpt.npz")
        restored = checkpoint_roundtrip(st, path)
        ckpt_mb = os.path.getsize(path) / 1e6
    print(f"checkpointed and restored the state at scan {restored.tick} "
          f"({ckpt_mb:.1f} MB)", flush=True)
    # The resume proof: the chunk after the checkpoint, once from the
    # state in memory and once from the restored state (which holds its
    # own generators, so the first run does not advance them).
    in_memory = digests(run_chunk(st))
    st = run_chunk(restored, series)
    resumed = digests(st)
    synchronize(device)

    for _ in range(timed_chunks):
        t1 = time.perf_counter()
        st = run_chunk(st, series)
        synchronize(device)
        times.append(time.perf_counter() - t1)
    pose, grid_best = best_particle(st.pf)
    best, med = min(times), statistics.median(times)
    n_scans = st.tick
    return {
        "slam_err": _errors(pose, st.true_pose),
        "odom_err": _errors(st.odom_pose, st.true_pose),
        "occupied_cells": int((grid_best >= pf_cfg.grid.l_occ).sum()),
        "n_scans": n_scans,
        "updates_per_sec": scans_per_chunk / best,
        "updates_per_sec_median": scans_per_chunk / med,
        "chunk_seconds": times,
        "num_particles": pf_cfg.num_particles,
        "mppi_rollouts": mppi_cfg.rollouts,
        "mppi_solves": n_scans * TICKS_PER_SCAN,
        # All scans run, with the warm-up's and the in-memory chunk's, and
        # the filters initialised: what the kernels' counts must match.
        "scans_run": n_scans + 2 * scans_per_chunk, "pf_inits": 2,
        "checkpoint_mb": ckpt_mb,
        "resume_digests": {"in_memory": in_memory, "resumed": resumed},
        "resume_bit_equal": in_memory == resumed,
        "series": torch.stack(series).cpu().numpy(),
    }


def seed_sweep(seeds=tuple(range(20)), num_particles=500, chunks=2,
               scans_per_chunk=20, rollouts=2048, device=DEFAULT_DEVICE):
    """Final-pose-error spread over filter seeds: the same course and scan
    stream, re-run with a fresh filter generator seeded each seed; returns
    (slam_err (S, 3) [θ, x, y], odom_err (S, 3)). The stochastic element is
    the filter itself (proposal draws and resampling) — what a point
    estimate hides."""
    device = resolve(device)
    pf_cfg, mppi_cfg, run_chunk = build(num_particles, scans_per_chunk,
                                        rollouts, device)
    slam_errs, odom_errs = [], []
    for seed in seeds:
        st = init_state(pf_cfg, mppi_cfg, seed=int(seed), device=device)
        for _ in range(chunks):
            st = run_chunk(st)
        pose, _ = best_particle(st.pf)
        slam_errs.append(_errors(pose, st.true_pose))
        odom_errs.append(_errors(st.odom_pose, st.true_pose))
    return np.asarray(slam_errs), np.asarray(odom_errs)


def plot_series(series, out=None):
    """Per-scan observability time series — the framework's rqt_plot
    (ref: PoseError streaming, tsim/launch/trect.launch:18-21)."""
    from tpunav_torch.viz import plot_series as plot

    out = out or out_path("rbpf_explore_timeseries.png")
    plot({"SLAM |xy| err": series[:, 0] * 100,
          "odometry |xy| err": series[:, 2] * 100,
          "SLAM yaw err": np.degrees(series[:, 1]),
          "odometry yaw err": np.degrees(series[:, 3]),
          "N_eff": series[:, 4]},
         [("cm", ["SLAM |xy| err", "odometry |xy| err"]),
          ("deg", ["SLAM yaw err", "odometry yaw err"]),
          ("N_eff", ["N_eff"])],
         out, title="RBPF exploration: pose error + N_eff per scan",
         xlabel="scan")
    print(f"wrote {out}")


def main():
    args = device_parser(__doc__.splitlines()[0]).parse_args()
    r = run_experiment(device=args.device)
    err, odo_err = r["slam_err"], r["odom_err"]
    print(f"slam pose error (theta,x,y) = {err[0]:+.4f} {err[1]:+.4f} "
          f"{err[2]:+.4f}  (|xy| = {np.hypot(err[1], err[2]) * 100:.2f} cm)")
    print(f"odom pose error (theta,x,y) = {odo_err[0]:+.4f} "
          f"{odo_err[1]:+.4f} {odo_err[2]:+.4f} "
          f"(|xy| = {np.hypot(odo_err[1], odo_err[2]) * 100:.2f} cm)")
    print(f"occupied cells: {r['occupied_cells']}")
    print(f"{r['n_scans']} SLAM updates x {r['num_particles']} particles "
          f"(+{r['mppi_solves']} fused MPPI solves @ "
          f"K={r['mppi_rollouts']}) = {r['updates_per_sec']:.1f} updates/s "
          f"on {args.device}; resumed chunk bit-equal: "
          f"{r['resume_bit_equal']}")
    assert np.hypot(err[1], err[2]) < 0.25, "SLAM pose diverged"
    assert r["resume_bit_equal"], "the resumed run left the saved one"
    draw(plot_series, r["series"])


if __name__ == "__main__":
    main()
