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

Where ``tpunav`` jits the scan interval, :class:`ScanGraph` replays it as
one CUDA graph (``tpunav_torch/capture.py``): the six ticks, the raycast,
``PFStepper``'s update and the five-metric sample, on static tensors. The
lidar's normals and the filter's are drawn eagerly before each replay,
with the eager step's calls, so a replay gives the eager interval's bits;
K1's seeds come from a scan counter on the device. ``build`` runs the
graph unless asked for the eager interval (``eager=True``), which is the
bits reference of the tests and ``chip_smoke.py``. On the CPU the graph's
body runs without capture on the same buffers.

No step reads the device on the host: the waypoint index advances through
``torch.where``, and the per-scan observability sample stays on the
device until the run ends.
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
from tpunav_torch import capture
from tpunav_torch.control.mppi import MPPIConfig, init_controls
from tpunav_torch.control.chunks import active_waypoint
from tpunav_torch.core.angles import normalize_angle_pi
from tpunav_torch.device import DEFAULT_DEVICE, resolve
from tpunav_torch.estimation.rbpf import (GridConfig, PFConfig, PFState,
                                          best_particle, pf_init, pf_slam_step)
from tpunav_torch.estimation.rbpf.icp import ICPConfig
from tpunav_torch.estimation.rbpf.particle_filter import PFStepper
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
    wpt = active_waypoint(waypoints, wpt_idx)
    d2g = torch.hypot(odom_pose[1] - wpt[0], odom_pose[2] - wpt[1])
    wpt_idx = torch.where(d2g < 0.15, (wpt_idx + 1) % n_wpts, wpt_idx)
    wpt = active_waypoint(waypoints, wpt_idx)
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


class _World(NamedTuple):
    """The course's constants on the device: the box's walls, the
    waypoints, the odometry's wheel bias and K1's seed base."""

    segs: torch.Tensor
    waypoints: torch.Tensor
    wheel_bias: torch.Tensor
    seed0: torch.Tensor


def _world(device) -> _World:
    return _World(box_segments(-1.8, -1.8, 1.8, 1.8, device=device),
                  torch.tensor(WAYPOINTS, dtype=torch.float32).to(device),
                  torch.tensor(WHEEL_BIAS, dtype=torch.float32).to(device),
                  torch.zeros((), dtype=torch.int32, device=device))


def _control(mppi_cfg, world: _World, true_pose, odom_pose, u, wheel_vel,
             wpt_idx, tick, noise=None):
    """A scan interval's TICKS_PER_SCAN control ticks; K1's seed is
    tick · TICKS_PER_SCAN + t (``tick`` a host int or a device int32), or
    ``noise[t]`` its (N, K, 2) perturbations."""
    for t in range(TICKS_PER_SCAN):
        true_pose, odom_pose, u, wheel_vel, wpt_idx = control_tick(
            mppi_cfg, world.waypoints, world.wheel_bias, true_pose,
            odom_pose, u, wheel_vel, wpt_idx,
            world.seed0 + (tick * TICKS_PER_SCAN + t),
            None if noise is None else noise[t])
    return true_pose, odom_pose, u, wheel_vel, wpt_idx


def _sense(grid: GridConfig, world: _World, true_pose, generator=None,
           noise=None):
    """The 360-beam scan of the box, 2 mm range noise from ``generator``
    or the (B,) normals ``noise``."""
    return scan_segments(true_pose, world.segs, num_beams=grid.num_beams,
                         max_range=grid.range_max, generator=generator,
                         noise_std=0.002, noise=noise)


def _clone_generator(gen: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


class ScanGraph:
    """The scan interval as one ``capture.Graph`` step: the six control
    ticks, the raycast, ``PFStepper``'s update (K2 and K3) and the
    five-metric sample, on static tensors on ``device`` (default the card;
    raises without CUDA; ``st`` must lie there).

    ``st`` is copied into the buffers, its generators into generators of
    the runner's own. Each :meth:`step` draws the lidar's (B,) normals and
    the filter's from them eagerly (the eager interval's calls), replays,
    and advances the scan counter on the device that keys K1's seeds, so
    it gives the eager interval's bits with no host read. :meth:`load`
    copies a state (a checkpoint's, another seed's) into the buffers in
    place, generators included; :meth:`snapshot` copies them out.
    ``injected``: K1 takes its perturbations from a static (6, N, K, 2)
    tensor that each step fills (``noise=``), in place of its in-kernel
    draw, as the tests feed ``tpunav``'s."""

    def __init__(self, pf_cfg: PFConfig, mppi_cfg: MPPIConfig,
                 st: ExploreState, device=DEFAULT_DEVICE, injected=False):
        dev = capture.state_device(st.true_pose, device)
        grid = pf_cfg.grid
        world = _world(dev)
        stepper = self.stepper = PFStepper(
            pf_cfg, st.pf._replace(generator=_clone_generator(
                st.pf.generator)), dev)
        # The body holds the buffers, not self: a graph whose runner is
        # dropped is freed at once, not by the cyclic collector.
        carry = self.carry = tuple(t.clone() for t in (
            st.true_pose, st.odom_pose, st.u, st.wheel_vel, st.wpt_idx))
        tick = self.tick_dev = torch.full((), st.tick, dtype=torch.int32,
                                          device=dev)
        self.tick = st.tick
        self.scan_gen = _clone_generator(st.scan_gen)
        noise = self.scan_noise = torch.zeros(grid.num_beams, device=dev)
        k1_noise = self.k1_noise = (torch.zeros(
            (TICKS_PER_SCAN, mppi_cfg.steps, mppi_cfg.rollouts, 2),
            device=dev) if injected else None)
        sample = self.sample = torch.zeros(5, device=dev)
        state, update = stepper.state, stepper.update
        scan_in, u_in, cur_in, prev_in = stepper.inputs

        def body():
            prev_odom = carry[1]
            nxt = _control(mppi_cfg, world, *carry, tick, k1_noise)
            true_pose, odom_pose = nxt[:2]
            scan_in.copy_(_sense(grid, world, true_pose, noise=noise))
            u_in.copy_(body_twist(odom_pose, prev_odom))
            cur_in.copy_(odom_pose)
            prev_in.copy_(prev_odom)
            update()
            sample.copy_(_metrics(state, true_pose, odom_pose))
            capture.load(carry, nxt)
            tick.add_(1)

        self.graph = capture.Graph(body, dev)
        # The lidar's normals, then the filter's (the eager interval's
        # calls); injected: K1's perturbations, the scan's, the filter's.
        self.draws = capture.Draws(self.graph, (k1_noise, noise,
                                                stepper.noise)).add(
            noise, self.scan_gen)
        self.draws.slots += stepper.draws.slots

    def step(self, noise=None) -> torch.Tensor:
        """One scan interval; returns the static (5,) sample. ``noise``:
        (K1's (6, N, K, 2) perturbations, the scan's (B,) normals, the
        filter's ``PFNoise``) in place of the draws (``injected`` only)."""
        self.draw(noise)
        self.graph()
        self.tick += 1
        return self.sample

    def draw(self, noise=None) -> None:
        """The next scan's draws into the static tensors: the lidar's
        normals and the filter's from their generators, or ``noise`` (see
        :meth:`step`)."""
        if noise is not None and self.k1_noise is None:
            raise ValueError("K1's perturbations need injected=True")
        self.draws(noise)

    def load(self, st: ExploreState) -> None:
        """``st`` into the buffers and generators, in place."""
        capture.load(self.stepper.state, st.pf)
        capture.load(self.carry, (st.true_pose, st.odom_pose, st.u,
                                  st.wheel_vel, st.wpt_idx))
        self.tick_dev.fill_(st.tick)
        self.tick = st.tick
        capture.load(self.scan_gen, st.scan_gen)

    def snapshot(self) -> ExploreState:
        """The state in the buffers, copied out with generators of its
        own."""
        pf = self.stepper.state
        return ExploreState(
            PFState(*(t.clone() for t in pf[:-1]),
                    generator=_clone_generator(pf.generator)),
            *(t.clone() for t in self.carry), self.tick,
            _clone_generator(self.scan_gen))


def build(num_particles=500, scans_per_chunk=20, rollouts=2048,
          device=DEFAULT_DEVICE, eager=False):
    """Returns (pf_cfg, mppi_cfg, run_chunk). ``run_chunk(st, series=None,
    marks=None)`` runs ``scans_per_chunk`` scan intervals from ``st`` and
    returns the state after them, leaving ``st`` as it was; each scan
    appends its five-metric sample (SLAM |xy| and yaw error, odometry |xy|
    and yaw error, N_eff), a device tensor, to ``series`` where given.

    By default ``run_chunk`` loads ``st`` into one :class:`ScanGraph`
    (built at the first call) and replays it per scan. With ``eager`` it
    runs the interval's operations one by one, and ``marks`` (an
    ``examples_torch.Marks``) takes one mark at the chunk's start, then
    three per scan, after the control ticks, the lidar raycast and the
    SLAM update, so consecutive marks split the chained run into its
    stages; the graph takes one mark per scan."""
    device = resolve(device)
    pf_cfg, mppi_cfg = configs(num_particles, rollouts)
    grid = pf_cfg.grid
    world = _world(device)

    def scan_interval(st: ExploreState, series, mark):
        prev_odom = st.odom_pose
        true_pose, odom_pose, u, wheel_vel, wpt_idx = _control(
            mppi_cfg, world, st.true_pose, st.odom_pose, st.u, st.wheel_vel,
            st.wpt_idx, st.tick)
        mark()
        scan = _sense(grid, world, true_pose, generator=st.scan_gen)
        mark()
        pf = pf_slam_step(pf_cfg, st.pf, scan,
                          body_twist(odom_pose, prev_odom), odom_pose,
                          prev_odom)
        if series is not None:
            series.append(_metrics(pf, true_pose, odom_pose))
        mark()
        return ExploreState(pf, true_pose, odom_pose, u, wheel_vel, wpt_idx,
                            st.tick + 1, st.scan_gen)

    def run_eager(st: ExploreState, series=None, marks=None) -> ExploreState:
        mark = marks.mark if marks is not None else (lambda: None)
        mark()
        for _ in range(scans_per_chunk):
            st = scan_interval(st, series, mark)
        return st

    runner = []

    def run_graph(st: ExploreState, series=None, marks=None) -> ExploreState:
        if not runner:
            runner.append(ScanGraph(pf_cfg, mppi_cfg, st, device))
        graph = runner[0]
        graph.load(st)
        mark = marks.mark if marks is not None else (lambda: None)
        mark()
        for _ in range(scans_per_chunk):
            sample = graph.step()
            if series is not None:
                series.append(sample.clone())
            mark()
        return graph.snapshot()

    return pf_cfg, mppi_cfg, run_eager if eager else run_graph


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

    A warm-up chunk on a throwaway state (on the card: the graph's warm-up
    and capture), a timed chunk (its digests: ``first_chunk_digests``), a
    checkpoint of the whole state to disk and back; then the same chunk
    from the state in memory and from the restored state (their digests
    must be equal: ``resume_bit_equal``), and ``timed_chunks`` timed
    chunks from the restored run. Rates are chunk wall times ended by a
    synchronize; the first timed chunk and the later ones give best and
    median."""
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
    first = digests(st)

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
        "first_chunk_digests": first,
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
    estimate hides. One graph serves every seed: each seed's start is
    loaded into its buffers."""
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
