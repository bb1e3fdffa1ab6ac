"""The full stack in one loop: RBPF mapping → D* Lite replanning → fused
MPPI control, through initially unknown obstacles.

Counterpart of ``examples/full_stack_demo.py``. The reference runs these
as separate launches (mapping: bmapping/launch/slam.launch; global
planning on a static yaml world: planner/src/grid_planner_node.cpp:217-264
with a simulated truth reveal; local control: nuturtle_robot
mppi_waypoints.launch). Here they are one loop: every scan interval the
particle filter (kernels K2 and K3; K4 builds its first field) refines
pose and map from lidar on drifting odometry, the best particle's
occupancy grid, inflated, feeds D* Lite's belief — the planner's sensor is
the live SLAM map, not a scripted reveal — and the MPPI controller (kernel
K1) chases a lookahead point on the replanned path. The robot must find a
barrier across the straight route and drive round it through a gap that
no map showed it.

    python -m examples_torch.full_stack_demo [--device cpu]

Where ``tpunav`` jits the control chunk, the scan and the SLAM update,
:class:`ScanGraph` replays a whole scan as one CUDA graph
(``tpunav_torch/capture.py``) on static tensors: the 12 control ticks, the
scan, ``PFStepper``'s update and the gather of the outputs. D* Lite runs
on the host, as in ``tpunav``: before each replay its lookahead target is
copied in, and after it the SLAM pose, the true pose and the best grid
come to the host in one copy; nothing else is read. ``run(...,
eager=True)`` runs the stages' operations one by one instead, the bits
reference of the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from examples_torch import Marks, device_parser, draw, out_path, synchronize
from examples_torch.rbpf_explore_demo import body_twist
from tpunav_torch import capture
from tpunav_torch.control.mppi import (MPPIConfig, init_controls, mppi_solve,
                                       sample_perturbations)
from tpunav_torch.device import DEFAULT_DEVICE, resolve
from tpunav_torch.estimation.rbpf import (GridConfig, PFConfig, PFState,
                                          best_particle, pf_init, pf_slam_step)
from tpunav_torch.estimation.rbpf.icp import ICPConfig
from tpunav_torch.estimation.rbpf.particle_filter import PFStepper
from tpunav_torch.models.cart import CartParams, kinematic_cart
from tpunav_torch.ops.fused_mppi import mppi_solve_fused
from tpunav_torch.ops.rk4 import rk4_step
from tpunav_torch.planning.dstar import dstar_from_labels
from tpunav_torch.planning.grid_map import FREE, OBSTACLE
from tpunav_torch.sim.lidar import scan_segments

MODEL = CartParams(0.033, 0.160)
TICK_DT = 1.0 / 60.0
WHEEL_BIAS = (1.03, 1.0)        # odometry drift
SCAN_SEED = 97
START_XY = (-1.2, -1.2)
GOAL_XY = (1.2, -0.9)           # the straight line crosses the barrier
LOOKAHEAD = 8                   # cells (~0.4 m) ahead on the D* path


def make_world(dtype=torch.float32, device=DEFAULT_DEVICE):
    """Box arena with an unknown interior barrier: a wall across the
    middle with one gap near the top — the direct start→goal line is
    blocked. (5, 4) segments [ax, ay, bx, by]."""
    segs = [
        [-1.8, -1.8, 1.8, -1.8], [1.8, -1.8, 1.8, 1.8],
        [1.8, 1.8, -1.8, 1.8], [-1.8, 1.8, -1.8, -1.8],
        # Barrier x=0 from y=-1.8 up to y=0.9 (gap 0.9..1.8).
        [0.0, -1.8, 0.0, 0.9],
    ]
    return torch.tensor(segs, dtype=dtype).to(resolve(device))


def occupancy_to_labels(grid_cfg: GridConfig, log_odds: np.ndarray,
                        inflate_cells: int = 3) -> np.ndarray:
    """Best-particle log-odds → D* planning labels: occupied cells become
    OBSTACLE, dilated by the robot radius (the reference's C-space
    inflation, planner/src/planner/grid_map.cpp:225-437)."""
    occ = np.asarray(log_odds >= grid_cfg.l_occ)
    if inflate_cells > 0:
        h, w = occ.shape
        pad = np.zeros((h + 2 * inflate_cells, w + 2 * inflate_cells),
                       bool)
        pad[inflate_cells:-inflate_cells, inflate_cells:-inflate_cells] = occ
        acc = np.zeros_like(occ)
        for dy in range(2 * inflate_cells + 1):
            for dx in range(2 * inflate_cells + 1):
                acc |= pad[dy:dy + h, dx:dx + w]
        occ = acc
    labels = np.full(occ.shape, FREE, np.int8)
    labels[occ] = OBSTACLE
    return labels


def _xyt(p):
    return torch.stack([p[1], p[2], p[0]])


def _txy(p):
    return torch.stack([p[2], p[0], p[1]])


def configs(num_particles=500, use_fused=True, rollouts=None):
    """(pf_cfg, mppi_cfg). A wider proposal spread than the exploration
    demo: the course crosses the whole arena on drifting odometry, so the
    Gaussian proposal needs cm-scale sample diversity for the scan and
    pose likelihoods to pull the particle cloud back to the map. K=2,048
    on the fused solve, 256 on the plain one, unless ``rollouts``."""
    pf_cfg = PFConfig(num_particles=num_particles, k_samples=50,
                      sample_range=(3e-5, 3e-4, 3e-4),
                      motion_noise=(1e-5, 1e-4, 1e-4),
                      grid=GridConfig(), icp=ICPConfig(max_iter=25))
    k = rollouts or (2048 if use_fused else 256)
    return pf_cfg, MPPIConfig(horizon=0.5, dt=0.01, rollouts=k)


class Stages:
    """The loop's three stages on ``device``, with the generators they draw
    from (:func:`build` says what each stage does)."""

    def __init__(self, num_particles=500, ticks_per_scan=12, use_fused=True,
                 seed=5, rollouts=None, device=DEFAULT_DEVICE):
        device = self.device = resolve(device)
        self.pf_cfg, self.mppi_cfg = configs(num_particles, use_fused,
                                             rollouts)
        self.ticks_per_scan, self.use_fused = ticks_per_scan, use_fused
        self.segs = make_world(device=device)
        self.wheel_bias = torch.tensor(WHEEL_BIAS,
                                       dtype=torch.float32).to(device)
        self.seed0 = torch.zeros((), dtype=torch.int32, device=device)
        self.mppi_gen = torch.Generator(device=device)
        self.mppi_gen.manual_seed(seed)
        self.scan_gen = torch.Generator(device=device)
        self.scan_gen.manual_seed(SCAN_SEED)

    def control_chunk(self, true_pose, odom_pose, slam_pose, u, target, tick,
                      noise=None):
        cfg, bias = self.mppi_cfg, self.wheel_bias
        f = lambda x, uu: kinematic_cart(MODEL, x, uu)  # noqa: E731
        for t in range(self.ticks_per_scan):
            z = None if noise is None else noise[t]
            if self.use_fused:
                cmd, u = mppi_solve_fused(
                    cfg, MODEL, u,
                    self.seed0 + (tick * self.ticks_per_scan + t),
                    _xyt(slam_pose), target, noise=z)
            else:
                cmd, u = mppi_solve(cfg, MODEL, u, self.mppi_gen,
                                    _xyt(slam_pose), target,
                                    noise=None if z is None
                                    else z.transpose(0, 1))
            true_pose = _txy(rk4_step(f, _xyt(true_pose), cmd, TICK_DT))
            biased = cmd * bias
            odom_pose = _txy(rk4_step(f, _xyt(odom_pose), biased, TICK_DT))
            slam_pose = _txy(rk4_step(f, _xyt(slam_pose), biased, TICK_DT))
        return true_pose, odom_pose, slam_pose, u

    def sense(self, true_pose, noise=None):
        grid = self.pf_cfg.grid
        return scan_segments(true_pose, self.segs, num_beams=grid.num_beams,
                             max_range=grid.range_max,
                             generator=self.scan_gen, noise_std=0.002,
                             noise=noise)

    def slam_update(self, pf, scan, cur_odom, prev_odom, noise=None):
        pf = pf_slam_step(self.pf_cfg, pf, scan,
                          body_twist(cur_odom, prev_odom), cur_odom,
                          prev_odom, noise=noise)
        pose, grid_best = best_particle(pf)
        return pf, pose, grid_best


def build(num_particles=500, ticks_per_scan=12, use_fused=True, seed=5,
          rollouts=None, device=DEFAULT_DEVICE):
    """The loop's three stages on ``device``. Returns (pf_cfg, mppi_cfg,
    control_chunk, sense, slam_update):

    - ``control_chunk(true_pose, odom_pose, slam_pose, u, target, tick,
      noise=None)``: ``ticks_per_scan`` MPPI ticks chasing ``target``, the
      controller fed the SLAM pose carried forward by the odometry
      increment (the reference's map→odom · odom→base chain,
      slam_node.cpp:306-339). The fused solve seeds K1 with
      tick · ticks_per_scan + t (``tick`` a host int or a device int32);
      the plain one draws from a generator seeded ``seed``. ``noise``: per
      tick an (N, K, 2) draw in place of either.
    - ``sense(true_pose, noise=None)``: the 360-beam scan of the world,
      2 mm range noise from a generator seeded 97 (or ``noise``).
    - ``slam_update(pf, scan, cur_odom, prev_odom, noise=None)``:
      ``pf_slam_step`` (``noise``: its ``PFNoise``), then the best
      particle; returns (pf, pose, grid)."""
    s = Stages(num_particles, ticks_per_scan, use_fused, seed, rollouts,
               device)
    return s.pf_cfg, s.mppi_cfg, s.control_chunk, s.sense, s.slam_update


class ScanGraph:
    """One scan of the loop as one ``capture.Graph`` step: the control
    chunk towards the static (3,) ``target``, the scan, the SLAM update
    through ``PFStepper`` (K2 and K3) and the gather of [SLAM pose, true
    pose, best grid] into the static ``out``, on ``stages``' device
    (default the card; raises without CUDA; ``pf`` must lie there).

    ``pf`` is copied into the buffers and its generator shared; the poses
    start at ``pose0`` and the controls at ``u``. Each :meth:`scan` copies
    the target in, draws the scan's normals, the plain solver's
    perturbations (``use_fused=False``) and the filter's eagerly with the
    eager stages' calls, replays, and brings ``out`` to the host in one
    copy. K1's seeds come from a scan counter on the device (``tick``).
    ``injected``: K1 takes its perturbations from a static tensor that
    each scan fills (``noise=``), as the tests feed ``tpunav``'s."""

    def __init__(self, stages: Stages, pf: PFState, pose0, u,
                 device=DEFAULT_DEVICE, injected=False):
        dev = capture.state_device(pf.poses, device)
        self.stages = stages
        cfg, grid = stages.mppi_cfg, stages.pf_cfg.grid
        stepper = self.stepper = PFStepper(stages.pf_cfg, pf, dev)
        # The body holds the buffers, not self.
        carry = self.carry = (pose0.clone(), pose0.clone(), pose0.clone(),
                              u.clone())        # true, odom, SLAM pose; u
        tick = self.tick = torch.zeros((), dtype=torch.int32, device=dev)
        target = self.target = torch.zeros(3, device=dev)
        noise = self.scan_noise = torch.zeros(grid.num_beams, device=dev)
        # The plain solver's (K, N, 2) perturbations per tick, handed to
        # control_chunk as (N, K, 2) views that it transposes back; K1's
        # (N, K, 2) where injected.
        ticks = stages.ticks_per_scan
        perturb = self.perturb = (None if stages.use_fused else torch.zeros(
            (ticks, cfg.rollouts, cfg.steps, 2), device=dev))
        k1_noise = self.k1_noise = (torch.zeros(
            (ticks, cfg.steps, cfg.rollouts, 2), device=dev)
            if stages.use_fused and injected else None)
        chunk_noise = (k1_noise if perturb is None
                       else perturb.transpose(1, 2))
        out = self.out = torch.empty(6 + grid.height * grid.width,
                                     device=dev)
        state, update = stepper.state, stepper.update
        scan_in, u_in, cur_in, prev_in = stepper.inputs

        def body():
            odom = carry[1]
            true_pose, odom_pose, _, u_next = stages.control_chunk(
                *carry, target, tick, noise=chunk_noise)
            scan_in.copy_(stages.sense(true_pose, noise=noise))
            u_in.copy_(body_twist(odom_pose, odom))
            cur_in.copy_(odom_pose)
            prev_in.copy_(odom)
            update()
            pose, grid_best = best_particle(state)
            torch.cat([pose, true_pose, grid_best.reshape(-1)], out=out)
            capture.load(carry, (true_pose, odom_pose, pose, u_next))
            tick.add_(1)

        self.graph = capture.Graph(body, dev)
        # The scan's normals, the plain solver's perturbations, the
        # filter's (the eager stages' calls); injected: per tick the
        # solve's, the scan's, the filter's.
        self.draws = capture.Draws(self.graph, (chunk_noise, noise,
                                                stepper.noise)).add(
            noise, stages.scan_gen)
        for p in () if perturb is None else perturb:
            self.draws.add(p, stages.mppi_gen,
                           functools.partial(sample_perturbations, cfg))
        self.draws.slots += stepper.draws.slots

    def scan(self, target_xy, noise=None) -> np.ndarray:
        """One scan towards the world point ``target_xy``; returns ``out``
        on the host: [SLAM pose, true pose, the best grid flattened].
        ``noise``: (per tick the solve's (N, K, 2) perturbations, the
        scan's (B,) normals, the filter's ``PFNoise``) in place of the
        draws (K1's only where ``injected``)."""
        self.target.copy_(torch.tensor([target_xy[0], target_xy[1], 0.0]),
                          non_blocking=True)
        if noise is not None:
            if self.perturb is None and self.k1_noise is None:
                raise ValueError("K1's perturbations need injected=True")
            noise = (torch.stack(list(noise[0])), *noise[1:])
        self.draws(noise)
        self.graph()
        return self.out.to("cpu", copy=True).numpy()


def cell_of(grid_cfg: GridConfig, xy):
    """(iy, ix) of a world point, clipped to the map."""
    h, w = grid_cfg.height, grid_cfg.width
    ix = int(np.clip((xy[0] - grid_cfg.xmin) / grid_cfg.resolution, 0, w - 1))
    iy = int(np.clip((xy[1] - grid_cfg.ymin) / grid_cfg.resolution, 0, h - 1))
    return (iy, ix)


def lookahead_target(grid_cfg: GridConfig, path):
    """The world point LOOKAHEAD cells along the D* path (the goal where
    the path is a single cell)."""
    if len(path) > 1:
        cell = path[min(LOOKAHEAD, len(path) - 1)]
        return (grid_cfg.xmin + (cell[1] + 0.5) * grid_cfg.resolution,
                grid_cfg.ymin + (cell[0] + 0.5) * grid_cfg.resolution)
    return GOAL_XY


def _eager_scan(stages: Stages, pf: PFState, pose0, u, marks: Marks):
    """The eager form of :class:`ScanGraph`: ``scan(target_xy)`` runs the
    stages' operations one by one, marking the chunk's start and end and
    the update's end; returns (scan, the state's current filter)."""
    state = {"pf": pf, "poses": (pose0, pose0, pose0), "u": u, "tick": 0}
    device = pose0.device

    def scan(target_xy):
        true_pose, odom_pose, slam_pose = state["poses"]
        target = torch.tensor([target_xy[0], target_xy[1], 0.0],
                              dtype=torch.float32).to(device,
                                                      non_blocking=True)
        prev_odom = odom_pose
        marks.mark()
        true_pose, odom_pose, slam_pose, state["u"] = stages.control_chunk(
            true_pose, odom_pose, slam_pose, state["u"], target,
            state["tick"])
        marks.mark()
        state["pf"], slam_pose, grid_best = stages.slam_update(
            state["pf"], stages.sense(true_pose), odom_pose, prev_odom)
        marks.mark()
        state["poses"] = (true_pose, odom_pose, slam_pose)
        state["tick"] += 1
        # The one copy to the host per scan: both poses and the grid.
        return torch.cat([slam_pose, true_pose,
                          grid_best.reshape(-1)]).cpu().numpy()

    return scan, lambda: state["pf"]


def run(num_particles=500, max_scans=220, ticks_per_scan=12,
        use_fused=None, seed=5, verbose=True, rollouts=None,
        device=DEFAULT_DEVICE, eager=False):
    """The closed loop from the start pose until the SLAM pose is within
    0.15 m of the goal, or ``max_scans``. ``use_fused`` defaults to True on
    the card (K1 at K=2,048) and False on the CPU (the plain solver at
    K=256). Each scan's device work is one :class:`ScanGraph` replay, or
    with ``eager`` the stages' operations one by one. Returns ``tpunav``'s
    dict (reached, scans, wall_s, final_goal_err_m, slam_vs_true_m,
    trails, grid, planner, stream), each scan's D* ``targets`` and
    ``ms_per_scan``: the replay (eager: the control chunk and the SLAM
    update) on the device's clock, D* (``observe`` + ``path_to_goal``) on
    the host's, and the whole scan."""
    device = resolve(device)
    if use_fused is None:
        use_fused = device.type == "cuda"
    stages = Stages(num_particles, ticks_per_scan, use_fused, seed,
                    rollouts, device)
    grid_cfg = stages.pf_cfg.grid
    h, w = grid_cfg.height, grid_cfg.width

    pose0 = torch.tensor([0.8, START_XY[0], START_XY[1]],
                         dtype=torch.float32).to(device)
    pf = pf_init(stages.pf_cfg, pose=pose0, seed=seed, device=device)
    u = init_controls(stages.mppi_cfg, device=device)
    marks = Marks(device)
    if eager:
        scan, filter_state = _eager_scan(stages, pf, pose0, u, marks)
    else:
        runner = ScanGraph(stages, pf, pose0, u, device)

        def scan(target_xy):
            marks.mark()
            out = runner.scan(target_xy)
            marks.mark()
            return out

        filter_state = lambda: runner.stepper.state  # noqa: E731

    planner = dstar_from_labels(np.full((h, w), FREE, np.int8),
                                cell_of(grid_cfg, START_XY),
                                cell_of(grid_cfg, GOAL_XY))
    planner.compute_shortest_path()

    dstar_s = 0.0
    trail_true, trail_slam, targets = [], [], []
    stream = []       # per-scan metrics (goal dist, SLAM err, plan len)
    slam_np, true_np = pose0.cpu().numpy(), pose0.cpu().numpy()
    synchronize(device)
    t0 = time.perf_counter()
    reached = False
    for tick in range(max_scans):
        # D* belief ← live SLAM map; replan; lookahead target.
        planner.pos = cell_of(grid_cfg, (slam_np[1], slam_np[2]))
        if planner.pos == planner.goal or (
                np.hypot(slam_np[1] - GOAL_XY[0],
                         slam_np[2] - GOAL_XY[1]) < 0.15):
            reached = True
            break
        t_d = time.perf_counter()
        path = planner.path_to_goal()
        dstar_s += time.perf_counter() - t_d
        tx, ty = lookahead_target(grid_cfg, path)
        targets.append((tx, ty))

        flat = scan((tx, ty))
        slam_np, true_np = flat[:3], flat[3:6]
        grid_np = flat[6:].reshape(h, w)

        # Feed the planner the fresh map (host-side labels diff).
        t_d = time.perf_counter()
        labels = occupancy_to_labels(grid_cfg, grid_np)
        labels[planner.goal] = FREE   # goal itself never inflated shut
        planner.observe(labels)
        dstar_s += time.perf_counter() - t_d

        trail_true.append(true_np)
        trail_slam.append(slam_np)
        stream.append((np.hypot(true_np[1] - GOAL_XY[0],
                                true_np[2] - GOAL_XY[1]),
                       np.hypot(*(slam_np[1:] - true_np[1:])),
                       len(path)))
        if verbose and tick % 20 == 0:
            print(f"scan {tick:3d}: slam=({slam_np[1]:+.2f},"
                  f"{slam_np[2]:+.2f}) target=({tx:+.2f},{ty:+.2f})",
                  flush=True)
    synchronize(device)
    wall = time.perf_counter() - t0
    n = max(len(targets), 1)
    per = 3 if eager else 2            # marks per scan
    spans = [sum(marks.ms(per * i + j, per * i + j + 1)
                 for i in range(len(targets))) / n for j in range(per - 1)]
    ms = ({"control_chunk": spans[0], "slam_update": spans[1]} if eager
          else {"replay": spans[0]})
    final_err = np.hypot(true_np[1] - GOAL_XY[0], true_np[2] - GOAL_XY[1])
    return {
        "reached": reached, "scans": tick + 1, "wall_s": wall,
        "final_goal_err_m": float(final_err),
        "slam_vs_true_m": float(np.hypot(*(slam_np[1:] - true_np[1:]))),
        "trail_true": np.asarray(trail_true),
        "trail_slam": np.asarray(trail_slam),
        "targets": np.asarray(targets),
        "grid": best_particle(filter_state())[1].cpu().numpy(),
        "planner": planner,
        "stream": np.asarray(stream),
        "updates": len(targets),
        "ms_per_scan": {**ms, "dstar_host": 1e3 * dstar_s / n,
                        "whole": 1e3 * wall / n},
        "rollouts": stages.mppi_cfg.rollouts,
    }


def plot(out, grid_cfg=GridConfig(), path=None):
    """The best particle's map with the true and SLAM trails."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from tpunav_torch.viz import draw_robot

    path = path or out_path("full_stack_demo.png")
    fig, ax = plt.subplots(figsize=(6, 6))
    occ = out["grid"] >= grid_cfg.l_occ
    ax.imshow(occ, origin="lower", cmap="Greys",
              extent=[grid_cfg.xmin, grid_cfg.xmax, grid_cfg.ymin,
                      grid_cfg.ymax], alpha=0.8)
    tt, ts = out["trail_true"], out["trail_slam"]
    ax.plot(tt[:, 1], tt[:, 2], "g-", lw=1.5, label="true path")
    ax.plot(ts[:, 1], ts[:, 2], "b--", lw=1.0, label="SLAM estimate")
    draw_robot(tt[-1], ax=ax)
    ax.plot([START_XY[0]], [START_XY[1]], "go", ms=8)
    ax.plot([GOAL_XY[0]], [GOAL_XY[1]], "r*", ms=14, label="goal")
    ax.legend(loc="upper left", fontsize=8)
    ax.set_title("RBPF map -> D* Lite replanning -> MPPI (one loop)")
    fig.savefig(path, dpi=110)
    plt.close(fig)
    print(f"wrote {path}")


def plot_stream(out):
    """The per-scan observability stream (the rqt_plot analog)."""
    from tpunav_torch.viz import plot_series

    s = out["stream"]
    path = plot_series(
        {"distance to goal [m]": s[:, 0],
         "SLAM-vs-true |xy| err [cm]": s[:, 1] * 100,
         "D* path length [cells]": s[:, 2]},
        [("m", ["distance to goal [m]"]),
         ("cm", ["SLAM-vs-true |xy| err [cm]"]),
         ("cells", ["D* path length [cells]"])],
        out_path("full_stack_timeseries.png"),
        title="full stack: RBPF map → D* Lite → MPPI", xlabel="scan")
    print(f"wrote {path}", flush=True)


def main():
    args = device_parser(__doc__.splitlines()[0]).parse_args()
    out = run(device=args.device)
    ms = out["ms_per_scan"]
    print(f"reached={out['reached']} in {out['scans']} scans "
          f"({out['wall_s']:.1f}s wall); final goal error "
          f"{out['final_goal_err_m'] * 100:.1f} cm; SLAM-vs-true "
          f"{out['slam_vs_true_m'] * 100:.1f} cm; per scan: replay "
          f"{ms['replay']:.1f} ms, D* {ms['dstar_host']:.1f} ms (host), "
          f"whole {ms['whole']:.1f} ms", flush=True)
    assert out["reached"], "goal not reached"
    assert out["final_goal_err_m"] < 0.3
    draw(plot, out)
    draw(plot_stream, out)


if __name__ == "__main__":
    main()
