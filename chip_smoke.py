"""Drive the PyTorch + CUDA port (``tpunav_torch``) once on a CUDA card.

    python3 chip_smoke.py

Builds the port's kernels (``tpunav_torch/ops/csrc/``) from source with
nvcc: K1 the fused MPPI solve (with its obstacle mode), K2 the likelihood
field, K3 the map update with its distance field, K4 the distance field
alone, the port's own batched Jacobi eigensolver (``sym_eig.cu``,
where ``tpunav`` calls XLA's ``eigh``: the circle detector's fit and the
EKF's SPD repair) and its ICP scan matcher (``icp.cu``, a whole match in
one launch, where ``tpunav`` leaves ICP to XLA). Checks each against its
plain PyTorch version on the card, then drives the port's paths:

- the MPPI waypoint course (the demo's flagship configuration:
  configs/mppi_params.yaml at horizon 0.5 s and K=4,096, the pentagon of
  configs/real_waypoints.yaml) through K1;
- RBPF grid SLAM at BASELINE config 5 (P=500 particles, k=50 proposal
  samples, an 80×80 map at 0.05 m, the 360-beam LDS-01 geometry of
  configs/lds01_lidar.yaml), 120 updates of the bench's box-world course,
  through K2, K3 and K4;
- the obstacle-aware MPPI course at BASELINE config 2
  (examples/obstacle_mppi_demo.py: Theta* on an 80-node PRM around a wall,
  K=4,096, N=50, the wall's 4 segments priced in-kernel) through K1's
  obstacle mode, with the planning package's grid, roadmap and potential
  field on the card;
- EKF SLAM closing the MPPI loop through K1: BASELINE config 3
  (examples/slam_mppi_closed_loop_demo.py: the 12-cylinder block world of
  configs/block_world_landmarks.yaml, known data association, K=1,024) and
  config 4 at its stated scale (examples/dense_world_slam_demo.py: 44
  cylinders, the lidar → circle detector → unknown data association chain
  at capacity 50, K=2,048, 5,000 ticks as the demo runs it: replayed
  chunks of its scan, through K1 and the eigensolver, its first 600
  ticks held to the eager per-tick loop), with the filter held against its
  CPU run and the detector against its CPU run and itself;
- the reference's node graph (tpunav_torch/runtime/, the :class:`Graphs`
  phases), whose jitted steps replay one CUDA graph each, held bit for
  bit to their eager forms: the mppi_waypoints.launch graph on the
  virtual-time scheduler through K1 at K=4,096, the law replayed and
  eager (``node_course``); the RBPF node at config 5 through
  ``PFStepper`` (K2 and K3 in its graph), the EKF node in the MPPI loop
  at config 3 and the detector chain in config 4's world through
  ``EKFStepper`` (``slam_nodes``); ``TurtleWay``, ``MPPIController`` and
  ``PotentialField`` (``graph_wrappers``); the robot on the CPU and the
  laptop on the card in two processes over the TCP bus, lockstep and
  free-running (``two_process``); and a checkpoint of the RBPF node's
  state loaded into its graph's buffers in place (``checkpoint``);
- the sharded paths (``tpunav_torch.parallel``, the :class:`Sharded`
  phases) in spawned ranks: K-sharded MPPI through K1's partials in one
  NCCL rank and in two gloo ranks sharing the card (``sharded_mppi``),
  and P-sharded RBPF at config 5 through K2–K4 in two gloo ranks
  (``sharded_rbpf``), each held against the unsharded path; and the
  graphed sharded steppers in one NCCL rank, one replay per solve or
  update with its collectives, each the eager sharded path's bits
  (``graph_sharded``: the fused and plain solves at K=4,096, config 5's
  update with K2, K3 and K4 in its graph), refused on gloo ranks;
- the loops as CUDA graphs (``tpunav_torch/capture.py``, the
  :class:`CudaGraphs` phases), each held to its eager path bit for bit:
  the flagship and obstacle courses through ``run_course`` and
  ``run_course_chunked`` (``graph_course``), ``bench.py``'s 100 chained
  solves in one graph at K=49,152 and 4,096 (``graph_solves``), config 5's
  120 RBPF updates through ``PFStepper`` (``graph_rbpf``), config 3
  through ``run_slam_loop`` with the EKF update alone through
  ``EKFStepper``, with and without the default SPD repair
  (``graph_ekf``), the capture guard against the cyclic collector
  (``graph_gc``), and the plain MPPI backend's course and config 3's loop
  in replayed chunks, its perturbations drawn into a static tensor
  (``plain_course``); the ``course``, ``obstacle_course``, ``ekf_course`` and
  ``dense_world`` phases and the landmarks node replay graphs too, held
  ticks skip K1's work, and the launch counters count a graph's launches
  on every replay;
- the closed-loop demos (``examples_torch/``, the :class:`Demos` phases),
  each loop one CUDA-graph replay per scan or step, held first to its
  eager form bit for bit over a prefix: the RBPF exploration under K1 at
  config 5 with its checkpoint and resume loaded into the graph
  (``explore``), the full stack — RBPF map → D* Lite on the host → K1,
  all four kernels in one loop (``full_stack``), the RBPF course
  (``rbpf_demo_course``), the lidar EKF courses (``lidar_ekf``) and the EKF
  demo's arc (``ekf_demo``), each EKF graph against the masked update run
  eagerly; and the exploration loop's per-scan budget split into three
  chained stage graphs beside its one replay, and each stage of the RBPF
  update as its own graph (``rbpf_stages``);
- the seed sweeps as one program (``seed_batch``, ``tpunav``'s
  ``jax.vmap`` of a course over seeds): K1 solving 20 (and 4) problems in
  one launch, each its single launch's bits; config 4 over 20 seeds for
  5,000 ticks and the lidar EKF over 20 seeds for 400 steps, one graph
  replay per tick or step for all seeds, every seed at its course's bars
  and two seeds equal to their serial courses;

and times every kernel beside its plain version. Each phase prints one
JSON line, and ``run`` the command's seconds; any failure raises and the
script exits non-zero. It needs CUDA and has no CPU path. The last line
is {"ok": true, "device": {...}}.

Phase ``kernel_times`` (:func:`kernel_times`) times K1, K2, K3 and K4
through their public entry points only, at the shapes their designs are
judged at, and prints digests of K2's, K3's and K4's outputs. It takes the
``tpunav_torch`` that ``sys.path`` finds first, so the same code can time
another checkout's package: run ``Smoke``, ``Rbpf``, ``Obstacle`` and
``kernel_times`` from this file (``runpy.run_path``) with that checkout's
root first on ``sys.path``; equal digests mean bit-identical outputs.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from examples_torch import kernel_profile, launches_per_call, syncs_per_call

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(ROOT, "configs")
BAR = 2e-4                 # K1 vs its plain version: max |Δ| on cmd, u_next[:-1]
POSE = (0.1, -0.2, 0.3)
XD = (1.0, 1.0, 0.0)
NEAR_TIE_ULPS = 16
# The depths of the eager EKF chains (bench_ekf's course: 200 updates):
# ekf_parity's card-against-CPU chains, ekf_times' updates per trial, and
# graph_ekf's eager chain that the stepper is held to.
PARITY_UPDATES = 50
TIMES_UPDATES = 40
GRAPH_EKF_EAGER_UPDATES = 60
ROWS_KERNEL_STEPS = 6      # chained steps of ekf_rows_kernel at config 4
ROWS_TWIST = (0.04, 0.03)  # ekf_rows_kernel's twist between steps
WIDE_SLOTS = 120           # ekf_rows_kernel's capacity past shared memory
MAX_FLIP_SHARE = 0.02      # ekf_rows_kernel's near-tie unknown-DA states
# The EKF nodes' first updates that slam_nodes holds to the eager node.
EKF_NODE_EAGER = 60
# ekf_times' closed-loop ticks per trial (bench.py's bench_slam_loop: 240)
# and rbpf_profile's profiled eager updates: cut to keep the run well inside
# its time limit.
LOOP_RATE_TICKS = 100
# The eager prefixes of config 4's course (dense_world) and config 3's
# (graph_ekf) held bit for bit against the graph paths.
DENSE_EAGER_PREFIX = 600
GRAPH_EKF_EAGER_PREFIX = 600
RBPF_PROFILE_UPDATES = 8


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def run(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


class Smoke:
    def __init__(self):
        from tpunav_torch.control import mppi
        from tpunav_torch.models.cart import CartParams
        from tpunav_torch.ops import fused_mppi, philox
        from tpunav_torch.runtime import config

        self.mppi, self.fm, self.philox, self.config = (mppi, fused_mppi,
                                                        philox, config)
        self.dev = torch.device("cuda", 0)
        robot = config.load_robot_config(os.path.join(CONFIGS,
                                                      "diff_params.yaml"))
        self.model = CartParams(robot.wheel_radius, robot.wheel_base)
        self.max_err = 0.0

    def cfg(self, k, **kw):
        return self.mppi.MPPIConfig(horizon=0.5, dt=0.01, rollouts=k, **kw)

    def tensors(self, cfg, u_off=(0.0, 0.0), xd=XD, noise_seed=None):
        dev = self.dev
        u = self.mppi.init_controls(cfg, device=dev) + torch.tensor(
            u_off, device=dev)
        pose = torch.tensor(POSE, dtype=torch.float32, device=dev)
        xd = torch.tensor(xd, dtype=torch.float32, device=dev)
        noise = None
        if noise_seed is not None:
            rng = np.random.default_rng(noise_seed)
            sig = np.sqrt([cfg.ul_var, cfg.ur_var])
            noise = torch.from_numpy(
                (rng.standard_normal((cfg.steps, cfg.rollouts, 2)) * sig)
                .astype(np.float32)).to(dev)
        return u, pose, xd, noise

    def plain(self, cfg, u, seed, pose, xd, noise=None):
        """K1's plain version on the same (CUDA) tensors, then the shift."""
        seed = torch.as_tensor(seed, dtype=torch.int32, device=self.dev)
        parts = self.fm._solve_partials_reference(cfg, self.model, u, seed,
                                                  pose, xd, noise)
        u_new = self.fm._combine_reference(cfg, u, parts, False)
        return u_new[0], self.mppi.shift_controls(cfg, u_new)

    def compare(self, cfg, u, seed, pose, xd, noise=None, bar=BAR):
        """Max |Δ| of K1 against its plain version; raises above ``bar``
        (None: report only) or on non-finite or unclamped controls."""
        cmd_k, un_k = self.fm.mppi_solve_fused(cfg, self.model, u, seed, pose,
                                               xd, noise=noise)
        cmd_p, un_p = self.plain(cfg, u, seed, pose, xd, noise)
        torch.cuda.synchronize()
        for t in (cmd_k, un_k):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError("non-finite controls from the kernel")
        if float(un_k.abs().max()) > cfg.max_wheel_vel:
            raise AssertionError("controls not clamped")
        err = max(float((cmd_k - cmd_p).abs().max()),
                  float((un_k[:-1] - un_p[:-1]).abs().max()))
        if bar is not None and not err <= bar:
            raise AssertionError(f"K1 vs plain: max |Δ| {err} > {bar} at "
                                 f"K={cfg.rollouts}")
        return err

    # ── phases ──

    def build(self):
        from tpunav_torch.ops import _build

        t0 = time.perf_counter()
        _build.load()
        secs = time.perf_counter() - t0
        emit("build", seconds=secs, library=str(_build.library_path()),
             nvcc=run([_build.nvcc_path(), "--version"]).splitlines()[-1],
             torch=torch.__version__, cuda=torch.version.cuda,
             ptxas=ptxas_summary(_build.ptxas_report()))
        self.card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"]).splitlines()[0]
        emit("card", nvidia_smi=self.card)

    def injected(self):
        t0 = time.perf_counter()
        cases = []
        # K=196,608: the K that tpunav serves only through its blocked
        # path (pallas_mppi.py:373-419), one launch here.
        for k, u_off in [(4096, (0.0, 0.0)), (49152, (0.0, 0.0)),
                         (4096, (1.5, -0.5)), (196608, (0.0, 0.0))]:
            cfg = self.cfg(k)
            u, pose, xd, noise = self.tensors(cfg, u_off=u_off,
                                              noise_seed=k)
            err = self.compare(cfg, u, 0, pose, xd, noise)
            self.max_err = max(self.max_err, err)
            cases.append({"K": k, "u_off": u_off, "max_abs_err": err})
        emit("injected_noise", seconds=time.perf_counter() - t0, bar=BAR,
             cases=cases)

    def partials(self):
        t0 = time.perf_counter()
        cfg = self.cfg(49152)
        half = dataclasses.replace(cfg, rollouts=cfg.rollouts // 2)
        u, pose, xd, noise = self.tensors(cfg, u_off=(0.5, -0.2),
                                          noise_seed=11)
        h = half.rollouts
        parts = torch.stack([
            self.fm.mppi_solve_partials(
                half, self.model, u, 0, pose, xd,
                noise=noise[:, s * h:(s + 1) * h].contiguous())
            for s in range(2)])
        cmd_c, un_c = self.fm.combine_softmax_partials(
            cfg, u, parts, min_fn=lambda m: torch.amin(m, dim=0),
            sum_fn=lambda v: torch.sum(v, dim=0))
        cmd_f, un_f = self.fm.mppi_solve_fused(cfg, self.model, u, 0, pose,
                                               xd, noise=noise)
        torch.testing.assert_close(cmd_c, cmd_f, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(un_c, un_f, rtol=1e-4, atol=1e-5)
        emit("partials", seconds=time.perf_counter() - t0, K=cfg.rollouts,
             max_abs_diff=float((un_c - un_f).abs().max()),
             rtol=1e-4, atol=1e-5)

    def in_kernel_philox(self):
        t0 = time.perf_counter()
        cfg = self.cfg(49152)
        u, pose, xd, _ = self.tensors(cfg)
        errs = [self.compare(cfg, u, s, pose, xd) for s in (0, 1234567)]
        self.max_err = max(self.max_err, *errs)
        z = self.philox.mppi_noise(torch.tensor(7, device=self.dev),
                                   cfg.rollouts, cfg.steps, 1.0, 1.0)
        z = z.double().reshape(-1, 2)
        n = z.shape[0]
        mean = z.mean(0).abs().max().item()
        var = (z.var(0) - 1.0).abs().max().item()
        if not (mean < 5 / math.sqrt(n) and var < 5 * math.sqrt(2 / n)):
            raise AssertionError(f"Philox moments off: |mean| {mean}, "
                                 f"|var-1| {var} over {n} draws")
        emit("in_kernel_philox", seconds=time.perf_counter() - t0,
             K=cfg.rollouts, max_abs_err=max(errs), bar=BAR,
             moments={"draws": n, "abs_mean": mean, "abs_var_minus_1": var})

    def edge_probes(self):
        """Each probe must stay finite and clamped. Its difference from the
        plain version is reported, not gated: with a far goal the
        cost-to-go reaches ~1e11, where one float32 ulp is ~1e4 and the
        λ=0.01 softmax a hard argmin that rounding alone can flip."""
        t0 = time.perf_counter()
        probes = {"K=1": (self.cfg(1), XD), "K=200": (self.cfg(200), XD),
                  "zero_variance": (self.cfg(4096, ul_var=0.0, ur_var=0.0),
                                    XD),
                  "goal_is_pose": (self.cfg(4096), POSE),
                  "far_goal": (self.cfg(4096), (1e3, -1e3, 0.0))}
        out = {}
        for name, (cfg, xd) in probes.items():
            u, pose, xd_t, _ = self.tensors(cfg, xd=xd)
            out[name] = self.compare(cfg, u, 3, pose, xd_t, bar=None)
        emit("edge_probes", seconds=time.perf_counter() - t0,
             finite_and_clamped=True, abs_diff_vs_plain=out)

    def horizons(self):
        """K1 against its plain version where the block's layout changes:
        a horizon longer than one 64-step chunk (N=70), one longer than the
        256 steps kept in shared memory (N=300: noise and cost-to-go in the
        global scratch), and ragged 32-rollout blocks (K = 1, 33, 101), on
        injected noise; and at the shape the closed-loop demos give K1
        (K=2,048, N=50: examples_torch.rbpf_explore_demo and
        full_stack_demo), once on injected noise and once on the in-kernel
        Philox draw. Rows above BAR must be near-ties of the float64 solve
        (``gate_rows``)."""
        t0 = time.perf_counter()
        cases = []
        for k, n, philox in [(4096, 70, False), (4096, 300, False),
                             (1, 70, False), (33, 70, False),
                             (101, 300, False), (2048, 50, False),
                             (2048, 50, True)]:
            cfg = self.mppi.MPPIConfig(horizon=n * 0.01, dt=0.01, rollouts=k)
            assert cfg.steps == n
            u, pose, xd, noise = self.tensors(
                cfg, u_off=(0.5, -0.2),
                noise_seed=None if philox else k + n)
            seed = 965 if philox else 0
            cmd, un = self.fm.mppi_solve_fused(cfg, self.model, u, seed, pose,
                                               xd, noise=noise)
            cmd_p, un_p = self.plain(cfg, u, seed, pose, xd, noise)
            if philox:           # the draw both took, for the near-tie rule
                noise = self.philox.mppi_noise(
                    torch.tensor(seed, device=self.dev), k, n,
                    float(cfg.ul_var) ** 0.5, float(cfg.ur_var) ** 0.5)
            err, exempt, err_all = gate_rows(
                self.mppi, cfg, self.model, torch.cat([cmd[None], un[:-1]]),
                torch.cat([cmd_p[None], un_p[:-1]]), u, pose, xd, noise, None,
                f"K1 at K={k}, N={n}{' (Philox)' if philox else ''}")
            self.max_err = max(self.max_err, err)
            cases.append({"K": k, "N": n,
                          "noise": "philox" if philox else "injected",
                          "max_abs_err": err, "exempt_rows": exempt,
                          "max_abs_err_all_rows": err_all})
        emit("horizons", seconds=time.perf_counter() - t0, bar=BAR,
             cases=cases)

    def flagship(self):
        """The demo's flagship course: configs/mppi_params.yaml at horizon
        0.5 s and K=4,096, diff_params.yaml, the real_waypoints.yaml
        pentagon, 60 Hz ticks on the fused kernel."""
        from tpunav_torch.control.waypoint_loop import (CourseConfig,
                                                        course_init)

        cfg = self.config.load_mppi_config(
            os.path.join(CONFIGS, "mppi_params.yaml"), horizon=0.5,
            rollouts=4096)
        course = CourseConfig(goal_thresh=0.1, tick_dt=1.0 / 60.0,
                              max_ticks=20_000, use_fused=True)
        waypoints = torch.as_tensor(
            self.config.load_waypoints(os.path.join(CONFIGS,
                                                    "real_waypoints.yaml")),
            dtype=torch.float32, device=self.dev)
        st = course_init(cfg, torch.zeros(3), seed=0, device=self.dev)
        return cfg, course, waypoints, st

    def course(self):
        from tpunav_torch.control.waypoint_loop import run_course_chunked

        cfg, course, waypoints, st = self.flagship()
        chunk = 240
        marks = []

        def on_chunk(s, tel):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if tel["pose"].shape != (chunk, 3):
                raise AssertionError("bad telemetry shape")

        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        st = run_course_chunked(cfg, course, self.model, waypoints, st,
                                chunk=chunk, on_chunk=on_chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()["K1"]
        ticks = int(st.ticks)
        pose = st.pose.cpu()
        last = waypoints[-1].cpu()
        d_last = float(torch.hypot(pose[0] - last[0], pose[1] - last[1]))
        if not (bool(st.done) and int(st.visits) == len(waypoints)):
            raise AssertionError(f"course incomplete: {ticks} ticks, "
                                 f"{int(st.visits)} visits")
        if not (bool(torch.isfinite(pose).all()) and
                d_last < course.goal_thresh):
            raise AssertionError(f"bad final pose {pose.tolist()}")
        if launches != ticks:
            raise AssertionError(f"{launches} kernel solves for {ticks} "
                                 "ticks: the course did not run on K1")
        # The first chunk runs eagerly (the graph's warm-up) and the second
        # is captured: the steady rate is the replays'.
        steady = ((ticks - 2 * chunk) / (marks[-1] - marks[1])
                  if len(marks) > 2 else None)
        self.course_launches = launches
        self.steady = steady
        emit("course", seconds=wall, K=cfg.rollouts, N=cfg.steps,
             ticks=ticks, visits=int(st.visits), done=bool(st.done),
             final_pose=pose.tolist(), dist_to_last_waypoint=d_last,
             kernel_launches=launches, first_chunk_seconds=marks[0] - t0,
             steady_solves_per_s=steady)

    def times(self):
        t0 = time.perf_counter()
        rows = []
        for k in (4096, 49152, 196608):
            cfg = self.cfg(k)
            u, pose, xd, _ = self.tensors(cfg)
            seed = torch.tensor(5, dtype=torch.int32, device=self.dev)
            gen = torch.Generator(device=self.dev)
            gen.manual_seed(0)
            rows.append({
                "K": k, "N": cfg.steps,
                "kernel_ms": time_ms(lambda: self.fm.mppi_solve_fused(
                    cfg, self.model, u, seed, pose, xd)),
                "plain_ms": time_ms(lambda: self.plain(
                    cfg, u, seed, pose, xd)),
                "plain_solver_ms": time_ms(lambda: self.mppi.mppi_solve(
                    cfg, self.model, u, gen, pose, xd)),
            })
        self.timing = rows
        emit("times", seconds=time.perf_counter() - t0, reps=30,
             card=self.card, rows=rows)

    def profile(self):
        """Device time by kernel (torch.profiler) per eager tick of the
        flagship course, with the device's idle share against the same
        ticks' unprofiled time (K1 alone: ``kernel_times``; the course's
        graph: ``graph_course``)."""
        from tpunav_torch.control.waypoint_loop import course_tick

        t0 = time.perf_counter()
        cfg, course, wpts, st = self.flagship()
        box = [st]

        def tick():
            box[0] = course_tick(cfg, course, self.model, wpts, box[0])

        ticks = 120
        tick_us = wall_us(tick, ticks, warmup=10)
        kern, held = eager_window(tick, ticks)
        busy = window_us(kern, held, ticks)
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
        emit("profile", seconds=time.perf_counter() - t0,
             card=self.card, course_ticks=ticks, device_us_per_tick=busy,
             kernels_per_tick=sum(c for _, c in kern.values()) / ticks,
             unprofiled_tick_us=tick_us,
             device_idle_share=None if busy is None else 1 - busy / tick_us,
             kernel_records=held,
             top_kernels_us_per_tick={name[:60]: us / ticks
                                      for name, (us, _) in top})


class Rbpf:
    """The RBPF phases: K2, K3 and K4 against their plain versions, the
    course through them, their event times and the course's profile."""

    P, K, UPDATES, WARM = 500, 50, 120, 20

    def __init__(self, card: str):
        from tpunav_torch.estimation.rbpf import grid, particle_filter
        from tpunav_torch.estimation.rbpf.icp import ICPConfig
        from tpunav_torch.ops import likelihood, map_update
        from tpunav_torch.runtime.config import load_lidar_config
        from tpunav_torch.sim import lidar

        self.grid, self.pf, self.lik, self.mu, self.lidar = (
            grid, particle_filter, likelihood, map_update, lidar)
        self.dev = torch.device("cuda", 0)
        self.card = card
        lid = load_lidar_config(os.path.join(CONFIGS, "lds01_lidar.yaml"))
        beams = dict(num_beams=lid.num_beams, beam_min=lid.beam_min_rad,
                     beam_delta=lid.beam_delta_rad, range_min=lid.range_min,
                     range_max=lid.range_max)
        # BASELINE config 5: 4×4 m at 0.05 m (80×80); and the 8×8 m
        # 160×160 map of bench_rbpf.py's big-map entry.
        self.g80 = grid.GridConfig(resolution=0.05, **beams)
        self.g160 = grid.GridConfig(resolution=0.05, xmin=-4.0, xmax=4.0,
                                    ymin=-4.0, ymax=4.0, **beams)
        # A 4 × 2.4 m map, 48 rows × 80 columns: an exchange of H and W in a
        # kernel shows here.
        self.g48x80 = grid.GridConfig(resolution=0.05, ymin=-1.2, ymax=1.2,
                                      **beams)
        # A 10 × 10 m room (200×200) and the largest plane tpunav's map
        # kernels take, 16 × 16 m (320×320): beyond a block's shared
        # memory, where the kernels keep their planes in device memory.
        self.g200 = grid.GridConfig(resolution=0.05, xmin=-5.0, xmax=5.0,
                                    ymin=-5.0, ymax=5.0, **beams)
        self.g320 = grid.GridConfig(resolution=0.05, xmin=-8.0, xmax=8.0,
                                    ymin=-8.0, ymax=8.0, **beams)
        self.cfg = particle_filter.PFConfig(
            num_particles=self.P, k_samples=self.K,
            sample_range=(1e-6, 1e-5, 1e-5), motion_noise=(1e-6, 1e-5, 1e-5),
            grid=self.g80, icp=ICPConfig(max_iter=25))
        self.max_err = {"K2": 0.0, "K3": 0.0, "K4": 0.0}

    def world(self, gcfg, p):
        """The TPU gate's inputs (tests_tpu/test_tpu_gate.py:_make_world,
        _make_particles): a noisy scan of a ±1.5 m box from one pose, and
        p particles scattered around it whose grids hold that scan."""
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(0)
        pose = torch.tensor([0.1, 0.05, -0.02], device=self.dev)
        segs = self.lidar.box_segments(-1.5, -1.5, 1.5, 1.5, device=self.dev)
        scan = self.lidar.scan_segments(
            pose, segs, num_beams=gcfg.num_beams, beam_min=gcfg.beam_min,
            beam_delta=gcfg.beam_delta, max_range=gcfg.range_max,
            generator=gen, noise_std=0.01)
        poses = (pose + 0.05 * torch.randn((p, 3), generator=gen,
                                           device=self.dev)).contiguous()
        fresh = self.grid.grid_init(gcfg, device=self.dev).expand(p, -1, -1)
        grids = self.grid.integrate_scan(gcfg, fresh, scan, poses)
        return scan, poses, grids.contiguous(), gen

    def lik_kernel(self):
        """K2 against its plain version at the gate's bar
        (tests_tpu/test_tpu_gate.py:257-259), at the gate's shapes, at the
        course's (k+1 = 51 samples per particle), and where K2 takes its
        two-pass path: fewer particles than SMs, a 320×320 field. An empty
        map on each path scores exactly 0."""
        t0 = time.perf_counter()
        cases = []
        for gcfg, p, k in [(self.g80, 8, 12), (self.g80, 500, 50),
                           (self.g80, 500, 51), (self.g160, 40, 50),
                           (self.g80, 40, 51), (self.g320, 16, 51)]:
            scan, poses, grids, gen = self.world(gcfg, p)
            dists = self.grid.esdf(gcfg, grids)
            empty = (p, k) in ((8, 12), (500, 50))
            if empty:
                dists[-1] = gcfg.max_occ_dist          # an empty map
            samples = (poses[:, None, :] + 0.01 * torch.randn(
                (p, k, 3), generator=gen, device=self.dev)).contiguous()
            before = self.lik.LIK_LAUNCHES
            got = self.lik.likelihood_field_batch(gcfg, dists, scan, samples)
            launches = self.lik.LIK_LAUNCHES - before
            us = device_us(lambda: self.lik.likelihood_field_batch(
                gcfg, dists, scan, samples), ("likelihood_",), 10)
            want = self.lik._lik_reference(gcfg, dists, scan, samples)
            torch.cuda.synchronize()
            err = (got - want).abs()
            row = {"P": p, "k": k, "map": gcfg.height, "launches": launches,
                   "path": self.lik._plan(p, k, gcfg.height, gcfg.width,
                                          gcfg.num_beams,
                                          torch.cuda.get_device_properties(
                                              self.dev).multi_processor_count,
                                          smem_limit())[0],
                   "device_us": us["likelihood_"],
                   "max_abs_err": float(err.max()),
                   "p99_abs_err": float(torch.quantile(err.flatten(), 0.99)),
                   "share_above_1e-4": float((err > 1e-4).float().mean())}
            if not (row["p99_abs_err"] <= 1e-4 and row["max_abs_err"] <= 0.05
                    and row["share_above_1e-4"] <= 0.01
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(f"K2 vs plain out of bounds: {row}")
            if empty and not bool((got[-1] == 0.0).all()):
                raise AssertionError("K2: an empty map must score exactly 0")
            self.max_err["K2"] = max(self.max_err["K2"], row["max_abs_err"])
            cases.append(row)
        emit("lik_kernel", seconds=time.perf_counter() - t0,
             bar={"p99": 1e-4, "max": 0.05, "share_above_1e-4": 0.01},
             empty_map_exactly_zero=True, cases=cases)

    def map_kernel(self):
        """K3 against its plain version (grids atol 1e-3/rtol 1e-4, dist
        atol 1e-4: tests_tpu/test_tpu_gate.py:218-220), its beam index
        against the plain quantizer (0 mismatches), and K4 on K3's grids
        bit for bit against K3's fields, on square maps, a 48×80 one, and
        the 200×200 and 320×320 maps whose planes sit in device memory."""
        t0 = time.perf_counter()
        cases = []
        for gcfg, p in [(self.g80, 8), (self.g80, 500), (self.g160, 40),
                        (self.g48x80, 40), (self.g200, 16), (self.g320, 8)]:
            scan, poses, grids, _ = self.world(gcfg, p)
            beam = torch.empty(grids.shape, dtype=torch.int32, device=self.dev)
            g_k, d_k = self.mu.map_update_batch(gcfg, grids, scan, poses,
                                                beam_out=beam)
            g_p, d_p = self.mu._map_update_reference(gcfg, grids, scan, poses)
            _, beam_p = self.mu._beam_index_reference(gcfg, poses)
            d_alone = self.mu.edt_batch(gcfg, g_k)
            k3_us = device_us(lambda: self.mu.map_update_batch(
                gcfg, grids, scan, poses), ("map_update_kernel",), 10)
            k4_us = device_us(lambda: self.mu.edt_batch(gcfg, g_k),
                              ("edt_kernel",), 10)
            torch.cuda.synchronize()
            torch.testing.assert_close(g_k, g_p, rtol=1e-4, atol=1e-3)
            torch.testing.assert_close(d_k, d_p, rtol=0, atol=1e-4)
            row = {"P": p, "map": [gcfg.height, gcfg.width],
                   "planes": "shared" if self.mu._map_layout(
                       gcfg, smem_limit())[1] == 0 else "device memory",
                   "grid_max_abs_err": float((g_k - g_p).abs().max()),
                   "dist_max_abs_err": float((d_k - d_p).abs().max()),
                   "beam_index_mismatches": int((beam.long() != beam_p).sum()),
                   "k4_bit_identical": bool(torch.equal(d_alone, d_k)),
                   "K3_device_us": k3_us["map_update_kernel"],
                   "K4_device_us": k4_us["edt_kernel"],
                   "occupied_cells": int((g_k >= gcfg.l_occ).sum())}
            if row["beam_index_mismatches"] or not row["k4_bit_identical"]:
                raise AssertionError(f"K3/K4 checks failed: {row}")
            self.max_err["K3"] = max(self.max_err["K3"],
                                     row["grid_max_abs_err"],
                                     row["dist_max_abs_err"])
            self.max_err["K4"] = max(
                self.max_err["K4"],
                float((d_alone - self.mu._edt_reference(gcfg, g_k))
                      .abs().max()))
            cases.append(row)
        emit("map_kernel", seconds=time.perf_counter() - t0,
             bar={"grids": {"atol": 1e-3, "rtol": 1e-4}, "dist_atol": 1e-4,
                  "beam_index_mismatches": 0, "k4_vs_k3": "bit-identical"},
             cases=cases)

    def icp_kernel(self, updates=(1, 10, 11, 60, 119)):
        """ICP (``ops/csrc/icp.cu``, one launch a match) against its plain
        version (``ops/icp.py:_icp_reference``) on the course's scan pairs
        (360 beams, each scan onto the one before with the update's
        odometry guess) through ``icp_match_scans``, at the config's 25
        iterations and the benchmark's 30: where ``ops/icp.py:bit_exact``
        holds, transform, converged, inlier_frac and normal_eig bit for bit
        and rmse and delta_norm within 1e-5; elsewhere every field within
        1e-5 and normal_eig within 1e-5 + √(8·2⁻²⁵) (tests/test_torch_icp.py
        gives both bars' reasons). Then the event time of a match beside the
        plain version's, the kernel's device µs and the operations' bound
        (7·N² an iteration: the search's ~6·N² and the rank's N²)."""
        from tpunav_torch.estimation.rbpf.icp import (ICPConfig,
                                                      icp_match_scans,
                                                      scan_to_points)
        from tpunav_torch.estimation.rbpf.particle_filter import (
            _icp_init_guess)
        from tpunav_torch.ops import icp as ik

        t0 = time.perf_counter()
        g = self.g80
        n, geometry = g.num_beams, (g.range_min, g.range_max, g.beam_min,
                                    g.beam_delta)
        u, scans, odoms, prevs = self.course_inputs()
        exact = ik.bit_exact(n, self.dev)
        names = ("transform", "converged", "rmse", "inlier_frac",
                 "delta_norm", "normal_eig")
        held = ("transform", "converged", "inlier_frac", "normal_eig")
        eig_bar = 1e-5 + math.sqrt(8 * 2.0 ** -25)
        self.max_err["ICP"], rows = 0.0, []
        for cfg in (self.cfg.icp, ICPConfig(max_iter=30)):
            for i in updates:
                guess = _icp_init_guess(odoms[i], prevs[i])
                before = ik.ICP_LAUNCHES
                got = icp_match_scans(cfg, scans[i], scans[i - 1], guess,
                                      *geometry)
                launches = ik.ICP_LAUNCHES - before
                want = ik._icp_reference(
                    cfg, *scan_to_points(scans[i], *geometry),
                    *scan_to_points(scans[i - 1], *geometry), guess)
                err = {k: float(torch.max(torch.abs(a.float() - b.float())))
                       for k, a, b in zip(names, got, want, strict=True)}
                bits = {k: bool(torch.equal(a, b))
                        for k, a, b in zip(names, got, want, strict=True)}
                ok = launches == 1 and bits["converged"] and all(
                    (bits[k] if exact and k in held else
                     err[k] <= (eig_bar if k == "normal_eig" else 1e-5))
                    for k in names)
                if not ok:
                    raise AssertionError(
                        f"ICP vs plain at update {i}, {cfg.max_iter} "
                        f"iterations (bit_exact {exact}): launches "
                        f"{launches}, errors {err}, bits {bits}")
                self.max_err["ICP"] = max(self.max_err["ICP"], *err.values())
            i = updates[-1]
            guess = _icp_init_guess(odoms[i], prevs[i])
            src = scan_to_points(scans[i], *geometry)
            dst = scan_to_points(scans[i - 1], *geometry)

            def kernel(cfg=cfg, i=i, guess=guess):
                return icp_match_scans(cfg, scans[i], scans[i - 1], guess,
                                       *geometry)

            def plain(cfg=cfg, src=src, dst=dst, guess=guess):
                return ik._icp_reference(cfg, *src, *dst, guess)

            # Bytes: two scans and the guess in, seven floats and a flag out.
            bound_ms, bound_by = bound(4 * (2 * n + 3 + 7) + 1,
                                       7.0 * n * n * cfg.max_iter)
            rows.append({
                "N": n, "max_iter": cfg.max_iter,
                "plan": ik.plan(n, smem_limit())[:4],
                "ms": time_ms(kernel),
                "plain_ms": time_ms(plain, reps=5, warmup=1),
                "device_us": device_us(kernel, ("icp_kernel",),
                                       10)["icp_kernel"],
                "bound_ms": bound_ms, "bound_by": bound_by})
        self.icp_rows = rows
        emit("icp_kernel", seconds=time.perf_counter() - t0, card=self.card,
             bit_exact=exact, cuda=torch.version.cuda, updates=list(updates),
             bar=({"bits": list(held), "1e-5": ["rmse", "delta_norm"]}
                  if exact else
                  {"equal": ["converged"], "normal_eig": eig_bar,
                   "1e-5": ["transform", "rmse", "inlier_frac",
                            "delta_norm"]}),
             max_abs_err=self.max_err["ICP"], rows=rows)

    def course_inputs(self, seed: int = 7):
        """The demo's and bench's course (examples_torch.rbpf_slam_demo,
        bench.py:bench_rbpf) on config 5's 80×80 map, 120 updates, scan
        noise from a generator seeded ``seed``: (u, scans, odoms, prevs)."""
        from examples_torch.rbpf_slam_demo import course_inputs

        return course_inputs(self.g80, self.UPDATES, seed, self.dev)

    def pose_error_cm(self, seed, inputs):
        """The best particle's |xy| error in cm after the course on
        ``inputs`` (u, scans, odoms, prevs), from filter seed ``seed``."""
        u, scans, odoms, prevs = inputs
        st = self.pf.pf_init(self.cfg, seed=seed, device=self.dev)
        for i in range(len(scans)):
            st = self.pf.pf_slam_step(self.cfg, st, scans[i], u, odoms[i],
                                      prevs[i])
        e = (self.pf.best_particle(st)[0] - odoms[-1]).cpu()
        return 100 * float(torch.hypot(e[1], e[2]))

    def course(self):
        u, scans, odoms, prevs = self.course_inputs()
        self.inputs = (u, scans, odoms, prevs)
        cfg = self.cfg
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        st = self.pf.pf_init(cfg, seed=0, device=self.dev)
        for i in range(self.UPDATES):
            st = self.pf.pf_slam_step(cfg, st, scans[i], u, odoms[i],
                                      prevs[i])
            if i == self.WARM - 1:
                torch.cuda.synchronize()
                t_warm = time.perf_counter()
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        counts = read_counts()
        pose, grid = self.pf.best_particle(st)
        truth = odoms[-1]
        err = (pose - truth).cpu()
        xy_err = float(torch.hypot(err[1], err[2]))
        heading = float((err[0] + math.pi) % (2 * math.pi) - math.pi)
        for name in ("poses", "log_weights", "grids", "dists"):
            if not bool(torch.isfinite(getattr(st, name)).all()):
                raise AssertionError(f"non-finite {name} after the course")
        if not xy_err < 0.2:
            raise AssertionError(f"pose diverged: |xy| error {xy_err} m")
        want = {"K1": 0, "K1_obstacle": 0, "K2": self.UPDATES,
                "K3": self.UPDATES, "K4": 1, "EIG": 0, "ICP": self.UPDATES,
                "EKF": 0}
        if counts != want:
            raise AssertionError(f"launches {counts}, expected {want}: one "
                                 "K2 and one K3 per update, K4 in pf_init")
        steady = (self.UPDATES - self.WARM) / (t_end - t_warm)
        self.state, self.counts, self.ms_per_update = st, counts, 1e3 / steady
        # The same course from two more seeds of the filter's generator:
        # the spread of the pose error over the filter's own randomness.
        other_seeds = {}
        for seed in (1, 2):
            other_seeds[seed] = self.pose_error_cm(seed, self.inputs)
            if not other_seeds[seed] < 20.0:
                raise AssertionError(f"seed {seed}: pose diverged, "
                                     f"{other_seeds[seed]} cm")
        emit("rbpf_course", seconds=t_end - t0, P=cfg.num_particles,
             k=cfg.k_samples, map=[self.g80.height, self.g80.width],
             beams=self.g80.num_beams, icp_max_iter=cfg.icp.max_iter,
             updates=self.UPDATES, first_updates=self.WARM,
             first_updates_seconds=t_warm - t0,
             steady_updates_per_s=steady, ms_per_update=1e3 / steady,
             pose_error_cm=100 * xy_err, heading_error_rad=heading,
             pose_error_cm_other_seeds=other_seeds,
             occupied_cells_best=int((grid >= self.g80.l_occ).sum()),
             launches=counts, card=self.card)

    def work(self, scan, k):
        """Bytes and float32 operations that the functions of K2 (with k
        samples), K3 and K4 need at the course's shape, counting the valid
        beams of ``scan``."""
        g, p = self.g80, self.P
        hw, b = g.height * g.width, g.num_beams
        valid = int(((scan >= g.range_min) & (scan < g.range_max)).sum())
        # K2: per valid (sample, beam) the endpoint (8), its cell (10) and
        # the sum (1); the mixture (6) once per cell or per lookup,
        # whichever is fewer; cos and sin per sample.
        k2 = (4 * (p * hw + p * k * 3 + b + p * k),
              p * (k * (19 * valid + 2) + 6 * min(hw, k * valid)))
        # An exact EDT needs O(1) work per cell: the two row sweeps and the
        # square (5); a linear-time lower envelope down each column, where
        # each cell enters and leaves the envelope once, at most two
        # intersection tests of ~8 operations (16), and its evaluation (4);
        # sqrt·res and the cap (3).
        edt = 5 + 16 + 4 + 3
        # K3 per cell: bearing, quantizer, dilation, free test, mass and
        # update (55) then the EDT; per valid beam its endpoint cell (16).
        k3 = (4 * (3 * p * hw + 3 * p + b), p * (hw * (55 + edt) + 16 * valid))
        k4 = (4 * 2 * p * hw, p * hw * (1 + edt))
        return {"K2": k2, "K3": k3, "K4": k4}

    def times(self):
        """CUDA-event medians at the course's shape (P=500, k+1=51 samples
        as the update launches K2, 80×80, 360 beams) on the course's final
        state, each kernel beside its plain version, and each kernel's
        device time from torch.profiler."""
        t0 = time.perf_counter()
        st, g = self.state, self.g80
        scan = self.inputs[1][-1]
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(3)
        k = self.K + 1
        samples = (st.poses[:, None, :] + 0.01 * torch.randn(
            (self.P, k, 3), generator=gen, device=self.dev)).contiguous()
        fns = {
            "K2": (lambda: self.lik.likelihood_field_batch(
                       g, st.dists, scan, samples),
                   lambda: self.lik._lik_reference(g, st.dists, scan,
                                                   samples)),
            "K3": (lambda: self.mu.map_update_batch(g, st.grids, scan,
                                                    st.poses),
                   lambda: self.mu._map_update_reference(g, st.grids, scan,
                                                         st.poses)),
            "K4": (lambda: self.mu.edt_batch(g, st.grids),
                   lambda: self.mu._edt_reference(g, st.grids)),
        }
        work = self.work(scan, k)
        rows = {}
        for name, (kernel, plain) in fns.items():
            bound_ms, bound_by = bound(*work[name])
            # The kernel's own device time (the event time above also holds
            # the wrapper's table-building launches and host gaps).
            kern, held = eager_window(kernel, 10)
            rows[name] = {"ms": time_ms(kernel), "plain_ms": time_ms(plain),
                          "device_us": family_us(kern, held, name, 10),
                          "kernel_records": held,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "bytes": work[name][0], "ops": work[name][1]}
        self.timing = rows
        emit("rbpf_times", seconds=time.perf_counter() - t0, reps=30,
             P=self.P, k=k, map=g.height, card=self.card, rows=rows)

    def profile(self):
        """torch.profiler over RBPF_PROFILE_UPDATES steady updates of a
        fresh course: device µs per update by kernel, launches per update,
        and the device's idle share against the unprofiled ms per update of
        the course."""
        t0 = time.perf_counter()
        u, scans, odoms, prevs = self.inputs
        box = [self.pf.pf_init(self.cfg, seed=1, device=self.dev), 0]

        def update():
            st, i = box
            box[0] = self.pf.pf_slam_step(self.cfg, st, scans[i], u, odoms[i],
                                          prevs[i])
            box[1] = i + 1

        for _ in range(10):
            update()
        n = RBPF_PROFILE_UPDATES
        kern, held = eager_window(update, n)
        busy = window_us(kern, held, n)
        ours = {key: family_us(kern, held, key, n)
                for key in ("K2", "K3", "K4")}
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:10]
        update_us = 1e3 * self.ms_per_update
        # The scan matcher alone, as one update calls it.
        from tpunav_torch.estimation.rbpf.icp import icp_match, scan_to_points

        g = self.g80
        src, src_ok = scan_to_points(scans[11], g.range_min, g.range_max,
                                     g.beam_min, g.beam_delta)
        dst, dst_ok = scan_to_points(scans[10], g.range_min, g.range_max,
                                     g.beam_min, g.beam_delta)
        guess = torch.zeros(3, device=self.dev)
        icp, icp_held = eager_window(lambda: icp_match(
            self.cfg.icp, src, src_ok, dst, dst_ok, guess), 5)
        emit("rbpf_profile", seconds=time.perf_counter() - t0,
             card=self.card, updates=n, device_us_per_update=busy,
             kernel_device_us_per_update=ours,
             launches_per_update=sum(c for _, c in kern.values()) / n,
             icp_launches_per_match=sum(c for _, c in icp.values()) / 5,
             icp_device_us_per_match=sum(us for us, _ in icp.values()) / 5,
             unprofiled_update_us=update_us,
             device_idle_share=None if busy is None else 1 - busy / update_us,
             kernel_records=held, icp_kernel_records=icp_held,
             top_kernels_us_per_update={name[:60]: us / n
                                        for name, (us, _) in top})


class Obstacle:
    """BASELINE config 2: K1's obstacle mode against its plain version, the
    demo's obstacle course through it, the planning package on the card,
    and the mode's event times and profile."""

    U_OFF = (2.0, 2.0)     # a nominal 0.066 m/s forward, into the obstacles

    def __init__(self, smoke: Smoke):
        from examples_torch import obstacle_mppi_demo
        from tpunav_torch import planning
        from tpunav_torch.control import obstacle_cost as oc

        self.s, self.oc, self.plan = smoke, oc, planning
        self.demo_mod = obstacle_mppi_demo
        self.fm, self.dev, self.card = smoke.fm, smoke.dev, smoke.card
        self.demo = obstacle_mppi_demo.OBS_CFG
        ref = planning.REFERENCE_MAP
        polys = [p[:n].tolist() for p, n in zip(ref.polygons,
                                                ref.n_vertices)]
        circle = oc.segments_from_circles([[0.5, 0.1]], [0.05],
                                          device=self.dev)
        wall = torch.tensor([[0.3, -0.4, 0.3, 0.4, 0.0]], device=self.dev)
        # name: (segments, pose, goal, weights). The demo's wall; the
        # circle and wall of tests/test_pallas_mppi.py:85-88; the 41 edges
        # of the reference world, from inside its corridor at y = 2.9 m.
        self.sets = {
            "demo_wall": (oc.segments_from_polygons(obstacle_mppi_demo.WALL,
                                                    device=self.dev),
                          (0.75, 1.0, 0.1), (1.8, 1.0, 0.0), self.demo),
            "circle_and_wall": (torch.cat([circle, wall]), (0.0, 0.0, 0.0),
                                (1.0, 0.2, 0.0),
                                oc.SegmentCostParams(0.1, 1e6, 1e3, 0.2)),
            "reference_world": (oc.segments_from_polygons(polys,
                                                          device=self.dev),
                                (0.7, 2.9, 0.0), (2.5, 2.9, 0.0), self.demo),
        }
        self.max_err = 0.0

    def inputs(self, cfg, name, noise_seed=None):
        segs, pose, xd, params = self.sets[name]
        u, _, _, noise = self.s.tensors(cfg, u_off=self.U_OFF,
                                        noise_seed=noise_seed)
        f32 = dict(dtype=torch.float32, device=self.dev)
        return (u, torch.tensor(pose, **f32), torch.tensor(xd, **f32), noise,
                segs, params)

    def compare(self, cfg, name, seed, noise_seed=None):
        """K1's obstacle mode against its plain version on the same card
        tensors. Rows of the update (cmd, then u_next[:-1]) above BAR must
        be near-ties of the float64 solve (see ``rounding_slack``); returns
        (max |Δ| over the other rows, exempt rows, max |Δ| over all)."""
        fm = self.fm
        u, pose, xd, noise, segs, params = self.inputs(cfg, name, noise_seed)
        cmd, un = fm.mppi_solve_fused(cfg, self.s.model, u, seed, pose, xd,
                                      noise=noise, obstacles=segs,
                                      obs_cfg=params)
        table = fm.pack_obstacles(segs, params, self.dev)
        seed_t = torch.as_tensor(seed, dtype=torch.int32, device=self.dev)
        plain = fm._combine_reference(cfg, u, fm._solve_partials_reference(
            cfg, self.s.model, u, seed_t, pose, xd, noise, table), False)
        got = torch.cat([cmd[None], un[:-1]])
        if noise is None:
            noise = self.s.philox.mppi_noise(seed_t, cfg.rollouts, cfg.steps,
                                             float(cfg.ul_var) ** 0.5,
                                             float(cfg.ur_var) ** 0.5)
        cost = self.oc.make_segment_obstacle_cost(params, segs,
                                                  device=self.dev)
        return gate_rows(self.s.mppi, cfg, self.s.model, got, plain, u, pose,
                         xd, noise, cost,
                         f"K1 obstacle mode at K={cfg.rollouts} ({name})")

    def kernel(self):
        """Injected noise at K=4,096 and 49,152 on the three obstacle sets,
        in-kernel Philox at K=49,152, and O=0 through the table equal to
        the no-obstacle kernel bit for bit."""
        t0 = time.perf_counter()
        cases = []
        for k in (4096, 49152):
            for name in self.sets:
                cfg = self.s.cfg(k)
                err, exempt, err_all = self.compare(cfg, name, 0,
                                                    noise_seed=k)
                cases.append({"K": k, "obstacles": name, "noise": "injected",
                              "O": int(self.sets[name][0].shape[0]),
                              "max_abs_err": err, "exempt_rows": exempt,
                              "max_abs_err_all_rows": err_all})
        for name in ("demo_wall", "reference_world"):
            cfg = self.s.cfg(49152)
            err, exempt, err_all = self.compare(cfg, name, 1234567)
            cases.append({"K": 49152, "obstacles": name, "noise": "philox",
                          "O": int(self.sets[name][0].shape[0]),
                          "max_abs_err": err, "exempt_rows": exempt,
                          "max_abs_err_all_rows": err_all})
        self.max_err = max(c["max_abs_err"] for c in cases)
        cfg = self.s.cfg(4096)
        u, pose, xd, _, _, params = self.inputs(cfg, "demo_wall")
        none = self.fm.mppi_solve_fused(cfg, self.s.model, u, 5, pose, xd)
        empty = self.fm.mppi_solve_fused(
            cfg, self.s.model, u, 5, pose, xd,
            obstacles=torch.zeros((0, 5), device=self.dev), obs_cfg=params)
        if not all(torch.equal(a, b) for a, b in zip(none, empty)):
            raise AssertionError("O=0 differs from the no-obstacle kernel")
        emit("obstacle_kernel", seconds=time.perf_counter() - t0, bar=BAR,
             near_tie_rule="float64: two best within max(16, N-t) ulps, or "
             "the first-order move of that rounding", o0_bit_identical=True,
             cases=cases)

    def course(self):
        """The demo's course: Theta* on the port's 80-node PRM around the
        wall, K=4,096, N=50, run_course_chunked(chunk=240) with the wall's
        segments in K1's obstacle mode; the demo's own assertions."""
        from tpunav_torch.control.waypoint_loop import (CourseConfig,
                                                        course_init,
                                                        run_course_chunked)

        t_plan = time.perf_counter()
        route = self.demo_mod.plan_route()   # Theta* on the PRM, after START
        plan_s = time.perf_counter() - t_plan
        waypoints = torch.from_numpy(route).to(self.dev)
        segs = self.oc.segments_from_polygons(self.demo_mod.WALL,
                                              device=self.dev)
        cfg = self.s.mppi.MPPIConfig(horizon=0.5, dt=0.01, rollouts=4096)
        course = CourseConfig(goal_thresh=0.1, tick_dt=1.0 / 60.0,
                              max_ticks=20_000, use_fused=True)
        st = course_init(cfg, torch.tensor(self.demo_mod.START + [0.0]),
                         seed=0, device=self.dev)
        chunk, marks, clear = 240, [], [math.inf]

        def on_chunk(s, tel):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            clear[0] = min(clear[0], self.demo_mod.wall_clearance(
                tel["pose"].cpu()))

        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        st = run_course_chunked(cfg, course, self.s.model, waypoints, st,
                                chunk=chunk, obstacles=segs,
                                obs_cfg=self.demo, on_chunk=on_chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        ticks = int(st.ticks)
        pose = st.pose.cpu()
        if not bool(st.done):
            raise AssertionError(f"obstacle course incomplete: {ticks} ticks")
        if not clear[0] > 0.05:
            raise AssertionError(f"the course scraped the wall: clearance "
                                 f"{clear[0]} m")
        if counts != {"K1": ticks, "K1_obstacle": ticks, "K2": 0, "K3": 0,
                      "K4": 0, "EIG": 0, "ICP": 0, "EKF": 0}:
            raise AssertionError(f"launches {counts} for {ticks} ticks: the "
                                 "course did not run on K1's obstacle mode")
        # The first chunk runs eagerly (the graph's warm-up) and the second
        # is captured: the steady rate is the replays'.
        steady = ((ticks - 2 * chunk) / (marks[-1] - marks[1])
                  if len(marks) > 2 else None)
        self.course_cfg = (cfg, course, waypoints, segs)
        self.launches, self.steady = counts["K1"], steady
        emit("obstacle_course", seconds=wall, K=cfg.rollouts, N=cfg.steps,
             obstacles=int(segs.shape[0]),
             route=[self.demo_mod.START] +
             np.round(route[:, :2], 4).tolist(),
             plan_seconds=plan_s, ticks=ticks, done=bool(st.done),
             final_pose=pose.tolist(), min_wall_clearance_m=clear[0],
             kernel_launches=counts, first_chunk_seconds=marks[0] - t0,
             steady_solves_per_s=steady, card=self.card)

    def planning(self):
        """The grid's labels on the card equal to the CPU's; the 2,000-node
        PRM with Theta* on the reference world; the potential field on the
        card reaches its goal (tests/test_planning.py:163-175)."""
        plan = self.plan
        t0 = time.perf_counter()
        ref = plan.REFERENCE_MAP
        on_card = plan.PlanningGrid(ref, inflation=0.1, device=self.dev)
        on_cpu = plan.PlanningGrid(ref, inflation=0.1, device="cpu")
        differ = int((on_card.labels != on_cpu.labels).sum())
        if differ:
            raise AssertionError(f"{differ} grid labels differ card vs CPU")
        t_prm = time.perf_counter()
        rm = plan.RoadMap(ref, n_nodes=2000, k_neighbors=20, clearance=0.1,
                          seed=11)
        path = plan.theta_star(rm, rm.add_node([0.3, 0.3]),
                               rm.add_node([3.0, 4.4]))
        prm_s = time.perf_counter() - t_prm
        if path is None or not all(rm.edge_free(path[i], path[i + 1])
                                   for i in range(len(path) - 1)):
            raise AssertionError("the 2,000-node PRM found no free path")
        square = plan.load_obstacle_map(
            [[[1.5, 1.5], [2.5, 1.5], [2.5, 2.5], [1.5, 2.5]]],
            bounds=[[0.0, 4.0], [0.0, 4.0]], resolution=0.1)
        pf = plan.PotentialField(plan.PotentialFieldConfig(step=0.05,
                                                           qthresh=0.3),
                                 square, device=self.dev)
        t_pf = time.perf_counter()
        qs = torch.stack(pf.plan([0.5, 1.0], [3.5, 3.0],
                                 max_steps=500)).cpu().numpy()
        pf_s = time.perf_counter() - t_pf
        end = float(np.hypot(*(qs[-1] - [3.5, 3.0])))
        inside = ((qs > 1.55) & (qs < 2.45)).all(axis=1).any()
        if not end < 0.06 or inside:
            raise AssertionError(f"potential field: end {end} m from the "
                                 f"goal, through the obstacle: {inside}")
        emit("planning", seconds=time.perf_counter() - t0,
             grid_cells=int(on_card.labels.size), labels_differ=differ,
             prm_nodes=2000, prm_theta_star_host_seconds=prm_s,
             path_nodes=len(path), potential_field_steps=len(qs) - 1,
             potential_field_seconds=pf_s, potential_field_end_m=end)

    def times(self):
        """Event ms of K1 in obstacle mode beside its plain version and K1
        without obstacles (in-kernel Philox), at K=4,096 and 49,152 for O=4
        and O=41 (device µs: ``kernel_times``)."""
        t0 = time.perf_counter()
        fm, rows = self.fm, []
        for k in (4096, 49152):
            cfg = self.s.cfg(k)
            for name in ("demo_wall", "reference_world"):
                u, pose, xd, _, segs, params = self.inputs(cfg, name)
                table = fm.pack_obstacles(segs, params, self.dev)
                seed = torch.tensor(5, dtype=torch.int32, device=self.dev)

                def kern():
                    return fm.mppi_solve_fused_packed(
                        cfg, self.s.model, u, seed, pose, xd, table=table)

                def plain():
                    return fm._combine_reference(
                        cfg, u, fm._solve_partials_reference(
                            cfg, self.s.model, u, seed, pose, xd, None,
                            table), False)

                rows.append({
                    "K": k, "N": cfg.steps, "O": int(segs.shape[0]),
                    "kernel_ms": time_ms(kern),
                    "plain_ms": time_ms(plain, reps=10, warmup=2),
                    "no_obstacle_kernel_ms": time_ms(
                        lambda: fm.mppi_solve_fused(cfg, self.s.model, u,
                                                    seed, pose, xd))})
        self.timing = rows
        emit("obstacle_times", seconds=time.perf_counter() - t0, reps=30,
             card=self.card, rows=rows)

    def profile(self):
        """torch.profiler over 120 eager ticks of the obstacle course:
        device µs and launches per tick, and the device's idle share
        against the same ticks' unprofiled time (the course's graph:
        ``graph_course``)."""
        from tpunav_torch.control.waypoint_loop import (_tick, course_init)

        t0 = time.perf_counter()
        cfg, course, wpts, segs = self.course_cfg
        table = self.fm.pack_obstacles(segs, self.demo, self.dev)
        box = [course_init(cfg, torch.tensor(self.demo_mod.START + [0.0]),
                           seed=1, device=self.dev)]

        def tick():
            box[0] = _tick(cfg, course, self.s.model, wpts, box[0], None,
                           table)

        ticks = 120
        tick_us = wall_us(tick, ticks, warmup=10)
        kern, held = eager_window(tick, ticks)
        busy = window_us(kern, held, ticks)
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
        emit("obstacle_profile", seconds=time.perf_counter() - t0,
             card=self.card, course_ticks=ticks, device_us_per_tick=busy,
             kernels_per_tick=sum(c for _, c in kern.values()) / ticks,
             unprofiled_tick_us=tick_us,
             device_idle_share=None if busy is None else 1 - busy / tick_us,
             kernel_records=held,
             top_kernels_us_per_tick={name[:60]: us / ticks
                                      for name, (us, _) in top})


# bench.py:292-294: bench_slam_loop's course.
BENCH_WAYPOINTS = [[0.4, 0.0, 0.0], [0.3, 0.4, 1.57], [-0.3, 0.3, 3.0],
                   [-0.4, -0.3, -2.0], [0.2, -0.4, -0.5]]


def bench_ekf_course(n=50, n_visible=12, updates=200, seed=11):
    """bench.py:bench_ekf's course: a ring of 12 landmarks 2 m out seen
    from an arcing pose at u = (0.02, 0.01), robot-frame measurements with
    1 mm noise from a numpy seed, NaN-padded to the capacity n."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0.0, 2 * np.pi, n_visible, endpoint=False)
    lms = np.stack([2.0 * np.cos(ang), 2.0 * np.sin(ang)], -1)
    pose, out = np.zeros(3), []
    for _ in range(updates):
        th = pose[0] + 0.02
        pose = np.array([th, pose[1] + 0.01 * np.cos(th),
                         pose[2] + 0.01 * np.sin(th)])
        c, s = np.cos(pose[0]), np.sin(pose[0])
        rel = lms - pose[1:3]
        rf = np.stack([c * rel[:, 0] + s * rel[:, 1],
                       -s * rel[:, 0] + c * rel[:, 1]], -1)
        rf = rf + 1e-3 * rng.standard_normal(rf.shape)
        out.append(np.concatenate([rf, np.full((n - n_visible, 2), np.nan)]))
    return out


def wall_us(fn, reps: int, warmup: int = 3) -> float:
    """Host µs per call of ``fn`` over ``reps`` calls ending in a sync (the
    EKF update is a chain of small launches: its time is the host's)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / reps


def launches(fn, reps: int = 3) -> float:
    """Device launches per call of ``fn`` (torch.profiler), after one
    call."""
    fn()
    return launches_per_call(fn, reps)


class Ekf:
    """EKF SLAM in the MPPI loop (BASELINE configs 3 and 4): the filter on
    the card against the same functions on the CPU, K1 at the loop's
    shapes, the circle detector, both courses through K1, their rates and
    their profile."""

    def __init__(self, smoke: Smoke):
        from examples_torch import (dense_world_slam_demo,
                                    slam_mppi_closed_loop_demo)
        from tpunav_torch.control import slam_loop
        from tpunav_torch.estimation import landmarks
        from tpunav_torch.estimation.ekf import filter as ekff
        from tpunav_torch.estimation.ekf import spd
        from tpunav_torch.sim import landmark_sensor, lidar

        self.s, self.dev, self.card = smoke, smoke.dev, smoke.card
        self.sl, self.lmk, self.ekff, self.spd = (slam_loop, landmarks, ekff,
                                                  spd)
        self.sensor, self.lidar = landmark_sensor, lidar
        self.c3_demo, self.c4_demo = (slam_mppi_closed_loop_demo,
                                      dense_world_slam_demo)
        self.world = self.c4_demo.dense_world()
        self.radii = np.full(len(self.world), self.c4_demo.CYL_RADIUS,
                             np.float32)

    # ── configurations ──

    def bench_cfg(self):
        """bench.py:bench_ekf: capacity 50, the default SPD repair."""
        return self.ekff.EKFConfig(num_landmarks=50, dmin=5e1, dmax=1e4,
                                   measurement_noise=(1e-4, 1e-4))

    def config3(self):
        """Config 3 as examples_torch.slam_mppi_closed_loop_demo runs it
        (known DA, 12 slots, K=1,024), on the fused kernel."""
        demo = self.c3_demo
        mppi, ekf, loop = demo.configs(True, 12, use_fused=True)
        return (mppi, ekf, loop, self.t(demo.WAYPOINTS),
                self.t(demo.block_world()))

    def config4(self, rollouts=2048):
        """Config 4 as examples_torch.dense_world_slam_demo builds it:
        unknown DA at capacity 50 fed by lidar → detector (max_clusters
        32), 20 Hz ticks, sensing every 4th, on the fused kernel. Returns
        the configs, the waypoint ring, the world and the measurement
        chain."""
        _, (mppi, ekf, loop), ring, world, meas_fn = \
            self.c4_demo.build(rollouts=rollouts, device=self.dev)
        return mppi, ekf, loop, ring, world, meas_fn

    def t(self, a, dtype=torch.float32, device=None):
        return torch.as_tensor(np.asarray(a)).to(device or self.dev, dtype)

    # ── phases ──

    def chain(self, cfg, known, meas_seq, dtype, device):
        """The bench course's updates on ``device``; every update's state
        on the CPU."""
        step = (self.ekff.known_correspondence_slam if known
                else self.ekff.slam_unknown_da)
        u = self.t([0.02, 0.01], dtype, device)
        st = self.ekff.ekf_init(cfg, dtype=dtype, device=device)
        out = []
        for m in meas_seq:
            st = step(cfg, st, self.t(m, dtype, device), u)
            out.append(tuple(x.cpu() for x in st))
        return out

    def parity(self):
        """The known- and unknown-DA updates over bench_ekf's course
        (n=50, 12 visible, PARITY_UPDATES updates) on the card against the
        same functions on the CPU: float64 to 1e-9; float32 pose 1e-5,
        landmarks 1e-4, covariance rtol 1e-3 + 1e-7·max|Σ|; count and
        active equal on every update. The float32 card run again under
        the caller's "high" matmul precision (TF32) must give the same
        bits. K1 against its plain version at the loop's shapes."""
        t0 = time.perf_counter()
        cfg, meas = self.bench_cfg(), bench_ekf_course(updates=PARITY_UPDATES)
        rows = []
        for known in (True, False):
            for dtype in (torch.float64, torch.float32):
                card = self.chain(cfg, known, meas, dtype, self.dev)
                cpu = self.chain(cfg, known, meas, dtype, "cpu")
                f64 = dtype == torch.float64
                bars = ({"pose": 1e-9, "landmarks": 1e-9, "cov": 1e-9}
                        if f64 else {"pose": 1e-5, "landmarks": 1e-4,
                                     "cov": 1e-7})
                # cov: the excess over rtol (float32: 1e-3), in units of
                # max|Σ| for float32.
                rtol = 0.0 if f64 else 1e-3
                worst = {"pose": 0.0, "landmarks": 0.0, "cov": 0.0}
                for i, (a, b) in enumerate(zip(card, cpu)):
                    if not (torch.equal(a[2], b[2]) and torch.equal(a[3],
                                                                    b[3])):
                        raise AssertionError(
                            f"EKF card vs CPU: gate decisions differ at "
                            f"update {i} (known={known}, {dtype})")
                    worst["pose"] = max(worst["pose"], float(
                        (a[0][:3] - b[0][:3]).abs().max()))
                    worst["landmarks"] = max(worst["landmarks"], float(
                        (a[0][3:] - b[0][3:]).abs().max()))
                    excess = ((a[1] - b[1]).abs() - rtol * b[1].abs()).max()
                    scale = 1.0 if f64 else float(b[1].abs().max())
                    worst["cov"] = max(worst["cov"], float(excess) / scale)
                if any(worst[k] > bars[k] for k in bars):
                    raise AssertionError(f"EKF card vs CPU (known={known}, "
                                         f"{dtype}): {worst} over {bars}")
                row = {"known_da": known, "dtype": str(dtype)[6:],
                       "updates": len(meas), "final_count": int(card[-1][3]),
                       "max_abs_err": worst, "bar": bars}
                if not f64:
                    prev = torch.get_float32_matmul_precision()
                    torch.set_float32_matmul_precision("high")
                    try:
                        high = self.chain(cfg, known, meas[:60], dtype,
                                          self.dev)
                        restored = torch.get_float32_matmul_precision()
                    finally:
                        torch.set_float32_matmul_precision(prev)
                    same = all(all(torch.equal(x, y) for x, y in zip(h, c))
                               for h, c in zip(high, card))
                    if not same or restored != "high":
                        raise AssertionError("the EKF update under 'high' "
                                             "matmul precision differs")
                    row["tf32_high_precision_bit_identical"] = same
                rows.append(row)
        k1 = []
        for k, horizon, dt in [(1024, 0.4, 0.05), (2048, 0.4, 0.05),
                               (4096, 0.5, 0.02)]:
            cfg = self.s.mppi.MPPIConfig(horizon=horizon, dt=dt, rollouts=k,
                                         ul_var=4.0, ur_var=4.0)
            for noise_seed, seed in [(k, 0), (None, 12345)]:
                u, pose, xd, noise = self.s.tensors(cfg, u_off=(1.0, 0.5),
                                                    noise_seed=noise_seed)
                cmd, un = self.s.fm.mppi_solve_fused(cfg, self.s.model, u,
                                                     seed, pose, xd,
                                                     noise=noise)
                cmd_p, un_p = self.s.plain(cfg, u, seed, pose, xd, noise)
                if noise is None:
                    noise = self.s.philox.mppi_noise(
                        torch.tensor(seed, dtype=torch.int32,
                                     device=self.dev), k, cfg.steps,
                        2.0, 2.0)
                err, exempt, err_all = gate_rows(
                    self.s.mppi, cfg, self.s.model,
                    torch.cat([cmd[None], un[:-1]]),
                    torch.cat([cmd_p[None], un_p[:-1]]), u, pose, xd, noise,
                    None, f"K1 at K={k}, N={cfg.steps}")
                self.s.max_err = max(self.s.max_err, err)
                k1.append({"K": k, "N": cfg.steps,
                           "noise": "injected" if noise_seed else "philox",
                           "max_abs_err": err, "exempt_rows": exempt,
                           "max_abs_err_all_rows": err_all})
        emit("ekf_parity", seconds=time.perf_counter() - t0, ekf=rows,
             k1_bar=BAR, k1=k1)

    def rows_inputs(self, known, steps):
        """Config 4's shape: SEED_BATCH true poses along the waypoint ring,
        each advanced by ROWS_TWIST per step; per step the (B, 32, 2) rows
        of the dense world's lidar and circle detector on the card (unknown
        DA) or cylinder i in row i within 1.2 m (known DA)."""
        ring = self.c4_demo.waypoint_ring()
        a = np.linspace(0.0, 2 * np.pi, SEED_BATCH, endpoint=False)
        rad = np.hypot(ring[:, 0], ring[:, 1]).mean()
        poses = np.stack([a + np.pi / 2, rad * np.cos(a), rad * np.sin(a)],
                         -1)
        meas_fn = self.config4()[-1]
        out = []
        for step in range(steps):
            rows = []
            for i, (th, x, y) in enumerate(poses):
                if known:
                    rel = self.world[:32] - [x, y]
                    c, s = np.cos(th), np.sin(th)
                    rf = np.stack([c * rel[:, 0] + s * rel[:, 1],
                                   -s * rel[:, 0] + c * rel[:, 1]], -1)
                    vis = np.hypot(rel[:, 0], rel[:, 1]) < 1.2
                    rows.append(self.t(np.where(vis[:, None], rf, np.nan)))
                else:
                    gen = torch.Generator(device=self.dev).manual_seed(
                        1000 * step + i)
                    rows.append(meas_fn(self.t([th, x, y]), gen))
            out.append(torch.stack(rows).cpu().double())
            th = poses[:, 0] + ROWS_TWIST[0]
            poses = np.stack([th, poses[:, 1] + ROWS_TWIST[1] * np.cos(th),
                              poses[:, 2] + ROWS_TWIST[1] * np.sin(th)], -1)
        return out

    def gate_margin(self, cfg, st, meas, u):
        """The smallest relative distance of any valid row's float64 d*
        from dmin or dmax in one state's unknown-DA step (the PyTorch row
        chain on the CPU): a gate decision may differ only where it is
        under 1%."""
        ekff = self.ekff
        cfg = dataclasses.replace(cfg, spd_repair=False)
        st = ekff.EKFState(*(t.cpu() for t in st))
        st = st._replace(state=st.state.double(), cov=st.cov.double())
        meas, v_all, state, cov = ekff._predict(
            cfg, st, meas.cpu().double(), u.cpu().double(), None)
        valid, r_all, b_all, bn_all = ekff.ekf_rows.polar_rows(meas)
        k = ekff._update_consts(cfg, state)
        carry, margin = (state, cov, st.active, st.count), math.inf
        for i in torch.nonzero(valid).flatten().tolist():
            cov = 0.5 * (carry[1] + carry[1].T)
            row = (r_all[i], b_all[i], bn_all[i], v_all[i])
            d = ekff._maha_all(cfg, k, carry[0], cov, row[0], row[2], row[3],
                               ekff._heading(carry[0], row[3]), carry[2])
            dstar = 1e12 if int(carry[3]) == 0 else float(d.min())
            margin = min(margin, *(abs(dstar - g) / g
                                   for g in (cfg.dmin, cfg.dmax)))
            carry = ekff._unknown_row(cfg, k, carry, row)
        return margin

    def rows_kernel(self, steps=ROWS_KERNEL_STEPS):
        """``ekf_rows_kernel``: the filter step's kernel
        (``ops/csrc/ekf_rows.cu``, one launch a step for a batch of states)
        against its plain version (``ops/ekf_rows.py``, on the CPU), step by
        step from the plain version's state, at config 4's shape (SEED_BATCH
        states, capacity 50, 32 rows; :meth:`rows_inputs`) and at
        ``bench_ekf``'s (capacity 50, 12 visible of 50 rows, 1 mm noise and
        sampled noise draws) and at capacity WIDE_SLOTS, where the
        covariance lies in device memory (:func:`ops.ekf_rows.plan`), known
        and unknown DA, float32 and float64:
        known DA's ``active`` and ``count`` equal on every state (it has no
        gate); unknown DA's gate decisions equal wherever no valid row's d*
        lies within 1% of dmin or dmax (:meth:`gate_margin`), such near-tie
        states dropped from the comparison but at most MAX_FLIP_SHARE of
        the unknown-DA states compared; float64 within 1e-9; float32
        pose 1e-5, landmarks 1e-4, covariance rtol 1e-3 + 1e-7·max|Σ|.
        The batch in one launch equal, bit for bit, to each state's own
        launch. At config 4's batch (float32, unknown DA): device µs
        (profiler), event ms, the bound, the plain version's ms on the CPU
        and the PyTorch row chain's on the card (the path this kernel
        replaced, eager), and the launches per replay of an EKFStepper."""
        from tpunav_torch import batch
        from tpunav_torch.ops import ekf_rows as er

        t0 = time.perf_counter()
        ekff = self.ekff
        c4, bench = self.config4()[1], self.bench_cfg()
        rng = np.random.default_rng(3)
        cases, flips, compared, rows, finals = [], 0, 0, [], {}
        for known in (True, False):
            c4_meas = self.rows_inputs(known, steps)
            bench_meas = [torch.as_tensor(m)[None] for m in
                          bench_ekf_course(updates=2 * steps)]
            # Past the shared-memory plan (S = 243: the covariance in
            # device memory): 120 slots, a ring of 24 landmarks in view.
            wide = [torch.as_tensor(m)[None] for m in bench_ekf_course(
                n=WIDE_SLOTS, n_visible=24, updates=3)]
            cases += [("config4", c4, known, c4_meas, np.zeros(3), 0.0),
                      ("bench_ekf", bench, known, bench_meas,
                       (0.02, 0.01), 1e-3),
                      ("global", dataclasses.replace(
                          bench, num_landmarks=WIDE_SLOTS), known, wide,
                       (0.02, 0.01), 1e-3)]
        for shape, cfg, known, meas_seq, u0, noise in cases:
            for dtype in (torch.float64, torch.float32):
                f64 = dtype == torch.float64
                bars = ({"pose": 1e-9, "landmarks": 1e-9, "cov": 1e-9}
                        if f64 else {"pose": 1e-5, "landmarks": 1e-4,
                                     "cov": 1e-7})
                rtol = 0.0 if f64 else 1e-3
                b = meas_seq[0].shape[0]
                st = ekff.ekf_init(cfg, dtype=dtype, device="cpu")
                st = ekff.EKFState(*(t.expand(b, *t.shape).clone()
                                     for t in st))
                u = (torch.tensor(ROWS_TWIST if shape == "config4" else u0,
                                  dtype=dtype).expand(b, 2).contiguous())
                kw = dict(known=known, dmin=cfg.dmin, dmax=cfg.dmax,
                          motion_noise=cfg.motion_noise,
                          measurement_noise=cfg.measurement_noise)
                worst = dict.fromkeys(bars, 0.0)
                for m in meas_seq:
                    m = m.to(dtype)
                    w = torch.as_tensor(rng.normal(0, noise, (b, 3)),
                                        dtype=dtype)
                    v = torch.as_tensor(rng.normal(0, noise, m.shape),
                                        dtype=dtype)
                    args = (st.state, 0.5 * (st.cov + st.cov.transpose(1, 2)),
                            st.active, st.count, m, u, w, v)
                    want = ekff.EKFState(*er.ekf_step(*args, **kw))
                    card = tuple(a.to(self.dev) for a in args)
                    before = er.EKF_LAUNCHES
                    got = er.ekf_step(*card, **kw)
                    if er.EKF_LAUNCHES - before != 1:
                        raise AssertionError("the EKF step took "
                                             f"{er.EKF_LAUNCHES - before} "
                                             "launches for a batch")
                    single = [er.ekf_step(*(a[i] for a in card), **kw)
                              for i in range(b)]
                    if not all(torch.equal(x, torch.stack(y)) for x, y in
                               zip(got, zip(*single))):
                        raise AssertionError(f"EKF kernel ({shape}, known="
                                             f"{known}, {dtype}): the batch's "
                                             "launch differs from its states' "
                                             "own launches")
                    got = ekff.EKFState(*(x.cpu() for x in got))
                    same = torch.logical_and(
                        (got.active == want.active).all(-1),
                        got.count == want.count)
                    for i in torch.nonzero(~same).flatten().tolist():
                        if known:
                            raise AssertionError(
                                f"EKF kernel ({shape}, known DA, {dtype}): "
                                f"active or count differ for state {i}")
                        margin = self.gate_margin(
                            cfg, ekff.EKFState(*(t[i] for t in st)), m[i],
                            u[i])
                        if not margin < 0.01:
                            raise AssertionError(
                                f"EKF kernel ({shape}, known={known}, "
                                f"{dtype}): gate decisions differ for state "
                                f"{i}, d* {margin:.2%} from a gate")
                        flips += 1
                    compared += 0 if known else b
                    keep = same[:, None]
                    worst["pose"] = max(worst["pose"], float(torch.where(
                        keep, (got.state[:, :3] - want.state[:, :3]).abs(),
                        0.0).max()))
                    worst["landmarks"] = max(worst["landmarks"], float(
                        torch.where(keep, (got.state[:, 3:] -
                                           want.state[:, 3:]).abs(),
                                    0.0).max()))
                    excess = ((got.cov - want.cov).abs() -
                              rtol * want.cov.abs()).amax((1, 2))
                    scale = 1.0 if f64 else float(want.cov.abs().max())
                    worst["cov"] = max(worst["cov"], float(torch.where(
                        same, excess, 0.0).max()) / scale)
                    st = want
                if any(worst[k] > bars[k] for k in bars):
                    raise AssertionError(f"EKF kernel vs plain ({shape}, "
                                         f"known={known}, {dtype}): {worst} "
                                         f"over {bars}")
                finals[shape, known, dtype] = st
                layout = er.plan(st.state.shape[1], meas_seq[0].shape[1],
                                 dtype, smem_limit())[0]
                if (layout == "global") != (shape == "global"):
                    raise AssertionError(f"EKF kernel ({shape}, {dtype}): "
                                         f"the covariance planned {layout}")
                rows.append({"shape": shape, "B": b, "known_da": known,
                             "layout": layout,
                             "dtype": str(dtype)[6:], "steps": len(meas_seq),
                             "final_count_min": int(st.count.min()),
                             "max_abs_err": worst, "bar": bars})
        if flips > MAX_FLIP_SHARE * compared:
            raise AssertionError(f"EKF kernel: {flips} near-tie gate flips "
                                 f"in {compared} unknown-DA states")
        self.rows_err = {
            dt: {k: max(r["max_abs_err"][k] for r in rows
                        if r["dtype"] == dt) for k in ("pose", "landmarks",
                                                       "cov")}
            for dt in ("float32", "float64")}
        # Timing at config 4's batch: the last unknown-DA float32 inputs.
        cfg = c4
        st32 = finals["config4", False, torch.float32]
        m = c4_meas[-1].float()
        b, s_size = m.shape[0], st32.state.shape[1]
        u = torch.tensor(ROWS_TWIST).expand(b, 2).contiguous()
        kw = dict(known=False, dmin=cfg.dmin, dmax=cfg.dmax,
                  motion_noise=cfg.motion_noise,
                  measurement_noise=cfg.measurement_noise)
        zw, zv = torch.zeros(b, 3), torch.zeros_like(m)
        args = (st32.state, st32.cov, st32.active, st32.count, m, u, zw, zv)
        card = tuple(a.to(self.dev) for a in args)

        def kernel():
            return er.ekf_step(*card, **kw)

        t1 = time.perf_counter()
        for _ in range(3):
            er.ekf_step(*args, **kw)
        plain_cpu_ms = 1e3 * (time.perf_counter() - t1) / 3
        chain = batch.vmap(lambda x, c, a, n, mm, uu: tuple(ekff._masked(
            cfg, ekff.EKFState(x, c, a, n), mm, uu, None, False)))
        valid = int(torch.isfinite(m).all(-1).sum())
        n_lm = cfg.num_landmarks
        # Operations: the least the step needs, each valid row's gate (~150
        # a slot) and update (~12 a covariance entry: the symmetrisation,
        # the rank-2 update by K and Hσ̄ and the KΨKᵀ term; the kernel's
        # factored Joseph sums take ~28); bytes: each state's inputs read
        # and outputs written once.
        ops = valid * (150.0 * n_lm + 12.0 * s_size * s_size)
        nbytes = b * (4 * (2 * s_size * s_size + 2 * s_size + 4 * 32 + 5) +
                      2 * n_lm + 8)
        bound_ms, bound_by = bound(nbytes, ops)
        stepper = ekff.EKFStepper(cfg, ekff.EKFState(*card[:4]), 32, False,
                                  self.dev)
        for _ in range(2):
            stepper.step(card[4], card[5])
        before = er.EKF_LAUNCHES
        for _ in range(3):
            stepper.step(card[4], card[5])
        per_replay = (er.EKF_LAUNCHES - before) / 3
        timing = {
            "B": b, "S": s_size, "rows": 32, "valid_rows": valid,
            "plan": er.plan(s_size, 32, torch.float32, smem_limit()),
            "device_us": device_us(kernel, ("ekf_step_kernel",),
                                   20)["ekf_step_kernel"],
            "device_event_us": device_event_us(kernel, 20),
            "ms": time_ms(kernel),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "plain_cpu_ms": plain_cpu_ms,
            "row_chain_ms": time_ms(lambda: chain(*card[:5], card[5]),
                                    reps=3, warmup=1),
            "launches_per_replay": per_replay}
        if timing["launches_per_replay"] != 1:
            raise AssertionError(f"EKFStepper: {timing} launches per replay")
        self.rows_timing = timing
        emit("ekf_rows_kernel", seconds=time.perf_counter() - t0,
             card=self.card, rows=rows, near_tie_flips=flips,
             unknown_states_compared=compared, timing=timing)

    def scans(self, device, dtype=torch.float32):
        """Scans of the dense world from 8 poses on a 1.2 m circle, with
        1 mm noise from a numpy seed (the same draws on every device)."""
        rng = np.random.default_rng(5)
        out = []
        for i in range(8):
            a = 2 * np.pi * i / 8
            pose = self.t([a + np.pi / 2, 1.2 * np.cos(a), 1.2 * np.sin(a)],
                          dtype, device)
            noise = self.t(rng.standard_normal(360), dtype, device)
            out.append(self.lidar.scan_cylinders(
                pose, self.t(self.world, dtype, device),
                self.t(self.radii, dtype, device), noise_std=1e-3,
                noise=noise))
        return out

    def detector(self):
        """feature_detection (max_clusters 32) on the dense world's scans,
        card against CPU: cluster ids and valid masks equal, centers and
        radii within 1e-5 m; two card runs bit-identical."""
        t0 = time.perf_counter()
        cfg = self.lmk.LandmarkConfig(max_clusters=32)
        lmk = self.lmk
        worst, found, digests = 0.0, 0, []
        for card_r, cpu_r in zip(self.scans(self.dev), self.scans("cpu")):
            ids = [lmk.cluster_scan(cfg, *lmk.laser_end_points(cfg.props, r))
                   for r in (card_r, cpu_r)]
            if not torch.equal(ids[0].cpu(), ids[1]):
                raise AssertionError("detector: cluster ids differ card/CPU")
            a = lmk.feature_detection(cfg, card_r)
            again = lmk.feature_detection(cfg, card_r)
            b = lmk.feature_detection(cfg, cpu_r)
            digests.append((digest(*a), digest(*again)))
            if digests[-1][0] != digests[-1][1]:
                raise AssertionError("detector: two card runs differ")
            v = b.valid
            if not torch.equal(a.valid.cpu(), v):
                raise AssertionError("detector: valid masks differ card/CPU")
            err = max([0.0] + [float(x.abs().max()) for x in (
                a.centers.cpu()[v] - b.centers[v],
                a.radii.cpu()[v] - b.radii[v]) if x.numel()])
            worst, found = max(worst, err), found + int(v.sum())
        if not worst <= 1e-5:
            raise AssertionError(f"detector card vs CPU: {worst} m > 1e-5")
        scan = self.scans(self.dev)[0]
        self.detector_ms = time_ms(lambda: lmk.feature_detection(cfg, scan))
        emit("detector", seconds=time.perf_counter() - t0, scans=8,
             beams=360, max_clusters=32, circles=found,
             max_abs_err_m=worst, bar_m=1e-5, card_runs_bit_identical=True,
             digests=[d for d, _ in digests], ms_per_call=self.detector_ms,
             launches_per_call=launches(lambda: lmk.feature_detection(
                 cfg, scan)),
             syncs_per_call=syncs_per_call(lambda: lmk.feature_detection(
                 cfg, scan), 3))

    def sym_eig(self):
        """``sym_eig``: the eigensolver's two kernels (ops/csrc/sym_eig.cu:
        ``sym_eig_small``, one thread per matrix for S ≤ 8, and
        ``sym_eig_kernel``, one block per matrix) against their plain
        version and torch.linalg.eigh, at the detector's (32, 4, 4) batches
        from the dense world's scans (the moment matrices S and the
        symmetrized Y H⁻¹ Y of the fit, as feature_detection hands them
        over), at S = 17, 53, 103 and 203 and on both sides of every
        boundary between layouts (``sym_eig.layout_spans``: the last S of
        the register kernel, as a batch of 32, and the first of the block
        kernel; the last S of packed A in shared memory and the first in
        device memory); symmetric
        indefinite matrices from a numpy seed. Gates: bit for bit the plain
        version at every shape; eigenvalues within 1e-12 of the largest
        |eigenvalue| of the library's, V diag(w) Vᵀ within 1e-12 of the
        input (relative to the same), VᵀV within 1e-12 of I. Times:
        CUDA-event ms of the kernel and torch.linalg.eigh (the library call,
        timed here and used nowhere in the package), the plain version's
        ms on the host's clock (one call, which also gives its bits), the
        kernel's device µs (the profiler's, :func:`device_us`, and CUDA
        events behind a spin kernel, :func:`device_event_us`), its bound
        (:func:`eig_work`), and at the SPD repair's S = 53 and 103 the
        device µs of the gated call (the skip flag set: no sweep)."""
        from tpunav_torch.ops import sym_eig as se

        t0 = time.perf_counter()
        lmk, cfg = self.lmk, self.lmk.LandmarkConfig(max_clusters=32)
        seen, real = [], se.eigh

        def spy(a, skip=None):
            seen.append(a.clone())
            return real(a, skip)

        se.eigh = spy
        try:
            lmk.feature_detection(cfg, self.scans(self.dev)[0])
        finally:
            se.eigh = real
        rng = np.random.default_rng(11)
        spans = se.layout_spans(smem_limit())
        edges = sorted({s for _, first, last in spans for s in (first, last)}
                       - {1, spans[-1][2]})
        cases = [("detector_S", seen[0]), ("detector_Q", seen[1])]
        for n in sorted(set(edges) | {17, 53, 103, 203}):
            shape = (32, n, n) if n <= se.SMALL_MAX else (n, n)
            x = rng.standard_normal(shape)
            cases.append((f"S={n}", torch.from_numpy(
                x + np.swapaxes(x, -1, -2)).to(self.dev)))
        rows, self.eig_max_err = [], 0.0
        skip = torch.ones((), dtype=torch.bool, device=self.dev)
        for name, a in cases:
            n = a.shape[-1]
            w, v = se.eigh(a)
            # The plain version once (host-bound, about a second at S >= 53):
            # its bits, its sweeps (the kernels stop by its rule) and its
            # time.
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ap, up, sweeps = se._jacobi(a.reshape(-1, n, n), None)
            wp, vp = se._sorted(ap, up)
            wp, vp = wp.reshape(w.shape), vp.reshape(v.shape)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t1)
            sweeps = sweeps.reshape(a.shape[:-2])
            wl, _ = torch.linalg.eigh(a)
            scale = wl.abs().amax(-1, keepdim=True).clamp(min=1e-300)
            errs = {
                "eigenvalues_vs_plain": float(((w - wp).abs() / scale).max()),
                "eigenvalues_vs_library": float(((w - wl).abs()
                                                 / scale).max()),
                "reconstruction": float(((v @ (w[..., None] * v.transpose(
                    -1, -2)) - a).abs() / scale[..., None]).max()),
                "orthogonality": float((v.transpose(-1, -2) @ v - torch.eye(
                    n, dtype=a.dtype, device=self.dev)).abs().max())}
            if not all(e <= 1e-12 for e in errs.values()):
                raise AssertionError(f"sym_eig {name}: {errs} over 1e-12")
            bits = bool(torch.equal(w, wp) and torch.equal(v, vp))
            if not bits:
                raise AssertionError(
                    f"sym_eig {name}: not bit for bit its plain version "
                    f"(sweeps {sweeps.tolist()})")
            abs_err = max(float((w - wp).abs().max()),
                          float((v - vp).abs().max()))
            self.eig_max_err = max(self.eig_max_err, abs_err)
            big = n > 150
            reps = 5 if big else 20
            nbytes, ops = eig_work(n, a.numel() // (n * n))
            b_ms, b_by = bound(nbytes, ops, F64_OPS_PER_S)
            kind = se.layout(n, smem_limit())[0]
            batch = a.numel() // (n * n)
            row = {
                "case": name, "shape": list(a.shape), "layout": kind,
                "threads_per_matrix": (se.small_lanes(n) if n <= se.SMALL_MAX
                                       else se.BLOCK_THREADS),
                "v_phase_blocks_threads": (None if n <= se.SMALL_MAX else
                                           se.vector_blocks(n, batch)[:2]),
                "sweeps": sweeps.tolist() if sweeps.dim() else int(sweeps),
                "errors": errs, "max_abs_err_vs_plain": abs_err,
                "bits_equal_plain": bits,
                "ms": time_ms(lambda: se.eigh(a), reps=reps,
                              warmup=1 if big else 3),
                "plain_ms": plain_ms,
                "library_ms": time_ms(lambda: torch.linalg.eigh(a),
                                      reps=20, warmup=3),
                "device_us": device_us(lambda: se.eigh(a), ("sym_eig",),
                                       reps)["sym_eig"],
                "device_event_us": device_event_us(lambda: se.eigh(a), reps),
                "bound_ms": b_ms, "bound_by": b_by, "bound_ops": ops,
                "bound_bytes": nbytes}
            if n in (53, 103):
                row["gated_off_device_event_us"] = device_event_us(
                    lambda: se.eigh(a, skip=skip), 20)
            rows.append(row)
        self.eig_rows = rows
        emit("sym_eig", seconds=time.perf_counter() - t0, card=self.card,
             bar=1e-12, fp64_peak_flops=F64_OPS_PER_S, layout_spans=spans,
             rows=rows, max_abs_err_vs_plain=self.eig_max_err)

    def course(self):
        """BASELINE config 3 as the demo runs it
        (examples_torch.slam_mppi_closed_loop_demo: run_slam_loop to done
        or 6,000 ticks from seed 1, which replays chunks of held ticks as
        CUDA graphs); the demo's gates (done, EKF error < odometry error)
        and one K1 launch per tick run, the held ticks of the last chunk
        included (the launch counters count a graph's launches on every
        replay)."""
        demo = self.c3_demo
        torch.cuda.synchronize()
        reset_counts()
        out = demo.run("config 3", demo.block_world(), True, 12,
                       use_fused=True, verbose=False, device=self.dev)
        counts = read_counts()
        st, ticks, wall = out["state"], out["ticks"], out["wall_s"]
        ekf_err, odo_err = out["ekf_err_m"], out["odom_err_m"]
        if not out["done"]:
            raise AssertionError(f"config 3 incomplete after {ticks} ticks")
        if not ekf_err < odo_err:
            raise AssertionError(f"config 3: EKF error {ekf_err} m not below "
                                 f"odometry's {odo_err} m")
        mppi, ekf, loop = demo.configs(True, 12)
        chunk = self.sl.default_chunk(loop.sensor_every)
        ran = chunk * -(-ticks // chunk)
        if counts != {"K1": ran, "K1_obstacle": 0, "K2": 0, "K3": 0,
                      "K4": 0, "EIG": 0, "ICP": 0, "EKF": ran}:
            raise AssertionError(f"launches {counts} for {ran} ticks run "
                                 f"({ticks} to done): the loop did not solve "
                                 "on K1 and step the filter on its kernel "
                                 "once per tick")
        self.k1_course, self.c3_state = counts["K1"], st
        self.ekf_course = counts["EKF"]
        emit("ekf_course", seconds=wall, K=mppi.rollouts, N=mppi.steps,
             landmarks=len(demo.block_world()), slots=ekf.num_landmarks,
             known_da=True, sensor_every=loop.sensor_every, ticks=ticks,
             visits=out["visits"], done=True, ekf_error_m=ekf_err,
             odometry_error_m=odo_err,
             landmarks_tracked=int(st.ekf.count), kernel_launches=counts,
             ticks_run=ran, chunk=chunk, ticks_per_s=ticks / wall,
             card=self.card)

    def dense(self, ticks=5000, prefix=DENSE_EAGER_PREFIX):
        """BASELINE config 4 at its stated scale
        (examples_torch.dense_world_slam_demo: 5,000 ticks of the
        44-cylinder world from seed 0, K=2,048, lidar → detector → unknown
        DA at capacity 50) as the demo runs it by default:
        ``run_slam_course``'s chunks replayed as CUDA graphs (``tpunav``'s
        one ``lax.scan``) with the demo's per-tick telemetry; and its first
        ``prefix`` ticks eager per tick (:meth:`dense_eager`: the ticks
        alone timed, as ``ekf_profile``'s idle share divides the same
        tick's device time, and the demo's telemetry rows taken from the
        kept states) against the same prefix chunked. Gates: the chunked
        prefix's state, generator and telemetry rows equal to the eager
        prefix's bit for bit; the whole course's final SLAM |xy| error <
        0.5 × odometry's (tests/test_perception_loop.py:143-145), 36-50
        landmarks tracked, a finite filter; in each run one K1 launch per
        tick and two eigensolver launches per sensing tick (the counts set
        to 0 before each run). A replayed window of chunks: µs per tick,
        device µs, operations, host API calls and idle share, and the host
        syncs per tick inside the chunks."""
        sl, demo = self.sl, self.c4_demo
        course, (mppi, ekf, loop), ring, world, meas_fn = demo.build(
            ticks, device=self.dev)
        prefix_course = demo.build(prefix, device=self.dev)[0]

        def want(n):
            return {"K1": n, "K1_obstacle": 0, "K2": 0, "K3": 0, "K4": 0,
                    "EIG": 2 * -(-n // loop.sensor_every), "ICP": 0,
                    "EKF": n}

        runs = {}
        for name, n in (("eager", prefix), ("chunked_prefix", prefix),
                        ("chunked", ticks)):
            torch.cuda.synchronize()
            reset_counts()
            if name == "eager":
                out = self.dense_eager(mppi, ekf, loop, ring, world, meas_fn,
                                       n)
            else:
                out = (prefix_course if n == prefix else course)(
                    0, chunked=True)
            counts = read_counts()
            st = out["state"]
            e_s, e_o = out["ekf_err"], out["odo_err"]
            slam_xy = float(np.hypot(*e_s[1:]))
            odo_xy = float(np.hypot(*e_o[1:]))
            n_lm = out["count"]
            finite = all(bool(torch.isfinite(x).all())
                         for x in (st.ekf.state, st.ekf.cov, st.true_pose))
            if not finite or (n == ticks and not (
                    slam_xy < 0.5 * odo_xy and 36 <= n_lm <= 50)):
                raise AssertionError(f"config 4 ({name}): SLAM |xy| {slam_xy}"
                                     f" m, odometry {odo_xy} m, {n_lm} "
                                     f"landmarks, finite {finite}")
            if counts != want(n):
                raise AssertionError(f"config 4 ({name}): launches {counts} "
                                     f"for {n} ticks, expected {want(n)}")
            runs[name] = {
                "out": out, "ticks": n, "seconds": out["wall_s"],
                "us_per_tick": 1e6 * out["wall_s"] / n,
                "ticks_per_s": n / out["wall_s"],
                "slam_xy_error_m": slam_xy,
                "slam_heading_error_rad": float(e_s[0]),
                "odometry_xy_error_m": odo_xy, "landmarks_tracked": n_lm,
                "visits": out["visits"], "kernel_launches": counts}
        a = runs["eager"].pop("out")
        b = runs["chunked_prefix"].pop("out")
        full = runs["chunked"].pop("out")
        sa, sb = a["state"], b["state"]
        same = same_bits(sa, sb, ("true_pose", "odom", "u", "wpt_idx",
                                  "visits", "ticks", "done"))
        same.update({f"ekf.{k}": v for k, v in same_bits(
            sa.ekf, sb.ekf, self.ekff.EKFState._fields).items()})
        same["generator"] = bool(torch.equal(sa.generator.get_state(),
                                             sb.generator.get_state()))
        same["telemetry"] = bool(torch.equal(a["tel_t"], b["tel_t"]))
        if not all(same.values()) or sa.host_ticks != sb.host_ticks:
            raise AssertionError(f"config 4 chunked vs eager: {same}")
        self.dense_state = full["state"]
        self.c4_tick_us = runs["eager"]["us_per_tick"]
        self.k1_dense = runs["chunked"]["kernel_launches"]["K1"]
        self.ekf_dense = runs["chunked"]["kernel_launches"]["EKF"]
        self.eig_dense = runs["chunked"]["kernel_launches"]["EIG"]
        chunk = sl.default_chunk(loop.sensor_every)
        window = sl._Chunks(mppi, ekf, loop, demo.MODEL, ring, world,
                            sl.slam_loop_init(mppi, ekf, pose_xyt=[
                                1.42, 0.0, math.pi / 2], seed=2,
                                device=self.dev), chunk, None, meas_fn,
                            (360,), demo.telemetry_row)
        window.run()                            # the warm-up
        window.run()                            # the capture
        chunk_us = wall_us(window.run, 5, warmup=0)
        prof = graph_window(window.run, 2, chunk, chunk_us)
        prof["host_syncs_per_tick"] = syncs_per_call(window.run, 3) / chunk
        emit("dense_world", seconds=sum(r["seconds"] for r in runs.values()),
             K=mppi.rollouts, N=mppi.steps, cylinders=len(self.world),
             capacity=ekf.num_landmarks, beams=360, max_clusters=32,
             sensor_every=loop.sensor_every, ticks=ticks, chunk=chunk,
             eager_prefix_ticks=prefix,
             ticks_per_s=runs["eager"]["ticks_per_s"], eager=runs["eager"],
             chunked_prefix=runs["chunked_prefix"],
             chunked=runs["chunked"], bit_identical_prefix=same,
             replayed_window=prof,
             replayed_us_per_tick=chunk_us / chunk,
             replayed_ticks_per_s=1e6 * chunk / chunk_us, card=self.card)

    def dense_eager(self, mppi, ekf, loop, ring, world, meas_fn, ticks):
        """Config 4's eager course as the demo runs it (``course(0,
        chunked=False)``: ``slam_loop_tick`` per tick from seed 0), the
        ticks alone timed, as in ``course(0, telemetry=False)``. Each
        tick's state is kept, and the demo's telemetry rows are taken from
        those states after the timed loop: the same rows as the demo's
        loop takes, without their operations in the timed ticks."""
        sl, demo = self.sl, self.c4_demo
        st = sl.slam_loop_init(mppi, ekf, pose_xyt=[1.42, 0.0, math.pi / 2],
                               seed=0, device=self.dev)
        kept = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ticks):
            st = sl.slam_loop_tick(mppi, ekf, loop, demo.MODEL, ring, world,
                                   st, meas_fn=meas_fn)
            kept.append(st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tel = torch.stack([demo.telemetry_row(k) for k in kept])
        e_s, e_o = demo.errors(st)
        return {"state": st, "wall_s": wall, "tel_t": tel,
                "ekf_err": e_s.cpu().numpy(), "odo_err": e_o.cpu().numpy(),
                "count": int(st.ekf.count), "visits": int(st.visits)}

    def loop_rate(self, known, trials=2, ticks=LOOP_RATE_TICKS):
        """bench.py:bench_slam_loop: K=4,096, N=25, capacity 50, the sensor
        every tick, LOOP_RATE_TICKS ticks through K1 (bench.py: 240);
        ticks/s per trial, after a
        20-tick warm-up."""
        mppi = self.s.mppi.MPPIConfig(horizon=0.5, dt=0.02, rollouts=4096,
                                      ul_var=4.0, ur_var=4.0)
        ekf = self.ekff.EKFConfig(num_landmarks=50, dmin=5e1, dmax=1e4,
                                  spd_repair=False,
                                  motion_noise=(1e-6, 1e-6, 1e-6),
                                  measurement_noise=(1e-5, 1e-5))
        loop = self.sl.SlamLoopConfig(known_da=known, sensor_every=1,
                                      visibility=1.2, cycles=1000,
                                      use_fused=True)
        n = 12 if known else 48
        ang = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
        rad = np.where(np.arange(n) % 2 == 0, 0.9, 1.4)
        lms = self.t(np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1))
        wpts = self.t(BENCH_WAYPOINTS)
        rates = []
        for trial in range(trials + 1):
            st = self.sl.slam_loop_init(mppi, ekf, seed=0, device=self.dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ticks if trial else 20):
                st = self.sl.slam_loop_tick(mppi, ekf, loop, self.s.model,
                                            wpts, lms, st)
            torch.cuda.synchronize()
            if trial:
                rates.append(ticks / (time.perf_counter() - t0))
        da = "known" if known else "unknown"
        return {"metric": f"ekf_mppi_closed_loop_ticks_per_sec (config "
                          f"{3 if known else 4}: {da} DA, n=50 capacity, "
                          f"{n} landmarks, K=4096 MPPI solve every tick)",
                "unit": "ticks/s", "value": statistics.median(rates),
                "trials": rates}

    def step_kernel_us(self, cfg, st, meas, u, known):
        """Device µs (events) of the filter step's kernel alone on ``st``'s
        symmetrised covariance, without noise."""
        from tpunav_torch.ops import ekf_rows as er

        args = (st.state, 0.5 * (st.cov + st.cov.T), st.active, st.count,
                meas, u, torch.zeros_like(st.state[:3]),
                torch.zeros_like(meas))
        return device_event_us(lambda: er.ekf_step(
            *args, known=known, dmin=cfg.dmin, dmax=cfg.dmax,
            motion_noise=cfg.motion_noise,
            measurement_noise=cfg.measurement_noise), 20)

    def times(self):
        """bench.py's EKF lines (µs per update and updates/s at n=50, 12
        visible, float32, 3 trials of TIMES_UPDATES updates, the two DAs'
        trials interleaved) for both DAs, each update one launch of the
        filter step's kernel, and that kernel's device µs on each DA's last
        update;
        the two
        trip-count candidates at config 4's shape; the SPD repair at n=50,
        gated off and repairing, with no host sync; the closed-loop rates
        of configs 3 and 4 at bench_slam_loop's shape; ms per detector
        call."""
        from tpunav_torch.ops import ekf_rows as er

        t0 = time.perf_counter()
        ekff, cfg = self.ekff, self.bench_cfg()
        meas = [self.t(m) for m in bench_ekf_course(updates=TIMES_UPDATES)]
        u = self.t([0.02, 0.01])
        fns = {"known": ekff.known_correspondence_slam,
               "unknown": ekff.slam_unknown_da}
        rates, finals, lines = {name: [] for name in fns}, {}, {}
        # A warm-up of 20 updates each, then the trials in the order known,
        # unknown, unknown, known, known, unknown: a process's slow and
        # fast stretches (PERF.md §5) fall on both alike. Each update of
        # either DA is the same host work and one launch of the same
        # kernel, so neither rate is bound to be the higher.
        for i, name in enumerate(("known", "unknown") +
                                 ("known", "unknown", "unknown", "known") +
                                 ("known", "unknown")):
            st = ekff.ekf_init(cfg, dtype=torch.float32, device=self.dev)
            steps = meas[:20] if i < 2 else meas
            before = er.EKF_LAUNCHES
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for m in steps:
                st = fns[name](cfg, st, m, u)
            torch.cuda.synchronize()
            if er.EKF_LAUNCHES - before != len(steps):
                raise AssertionError(f"{name} DA: {er.EKF_LAUNCHES - before} "
                                     f"EKF launches over {len(steps)} "
                                     "updates")
            if i >= 2:
                rates[name].append(len(meas) / (time.perf_counter() - t1))
            finals[name] = st
        self.final_bench = finals["unknown"]
        for name, fn in fns.items():
            r, st = rates[name], finals[name]
            lines[name] = {
                "metric": f"ekf_slam{'' if name == 'known' else '_unknown_da'}"
                          f"_updates_per_sec (n=50 capacity, 12 meas/update, "
                          f"f32, {name} DA)",
                "unit": "updates/s", "value": statistics.median(r),
                "trials": r, "min": min(r), "max": max(r),
                "us_per_update": 1e6 / statistics.median(r),
                "launches_per_update": launches(
                    lambda: fn(cfg, st, meas[-1], u)),
                "kernel_device_event_us": self.step_kernel_us(
                    cfg, st, meas[-1], u, name == "known")}
        # The update's two trip counts at config 4's shape (capacity 50, 32
        # detector rows of the dense world, unknown DA) and at bench_ekf's.
        _, c4, _, _, _, meas_fn = self.config4()
        st4 = self.dense_state
        tru = st4.true_pose
        m4 = meas_fn(torch.stack([tru[2], tru[0], tru[1]]),
                     torch.Generator(device=self.dev).manual_seed(1))
        u4 = self.t([0.01, 0.02])
        trips = []
        for shape, c, st_, m, known in [
                ("config 4: 32 rows, unknown DA", c4, st4.ekf, m4, False),
                ("bench_ekf: 50 rows, known DA", cfg, self.final_bench,
                 meas[-1], True)]:
            step, masked = ((ekff.known_correspondence_slam,
                             ekff.known_correspondence_slam_masked) if known
                            else (ekff.slam_unknown_da,
                                  ekff.slam_unknown_da_masked))
            a = step(c, st_, m, u4)
            b = masked(c, st_, m, u4)
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            if not same:
                raise AssertionError(f"masked trip count differs ({shape})")
            trips.append({
                "shape": shape, "valid_rows": int(torch.isfinite(m).all(
                    -1).sum()), "rows": int(m.shape[0]),
                "dynamic_us": wall_us(lambda: step(c, st_, m, u4), 10),
                "masked_us": wall_us(lambda: masked(c, st_, m, u4), 10),
                "dynamic_launches": launches(lambda: step(c, st_, m, u4)),
                "masked_launches": launches(lambda: masked(c, st_, m, u4)),
                "dynamic_syncs": syncs_per_call(lambda: step(c, st_, m, u4), 5),
                "masked_syncs": syncs_per_call(lambda: masked(c, st_, m, u4),
                                               5),
                "bit_identical": same})
        # The SPD repair of an (S, S) = (103, 103) float32 covariance, with
        # no host read: gated off on the bench's SPD covariance (the
        # eigensolver runs no sweep), and run on the same matrix with one
        # diagonal entry made negative.
        spd, cov = self.spd, self.final_bench.cov
        bad = cov.clone()
        bad[0, 0] = -1.0
        repair = {"is_spd": bool(spd.is_spd(cov)),
                  "bad_is_spd": bool(spd.is_spd(bad)),
                  "bad_sweeps": int(jacobi_sweeps(
                      (0.5 * (bad + bad.T)).double()))}
        for tag, m, reps in (("gated", cov, 20), ("repair", bad, 5)):
            repair.update({
                f"{tag}_us": wall_us(lambda: spd.repair_if_needed(m), reps),
                f"{tag}_launches": launches(lambda: spd.repair_if_needed(m)),
                f"{tag}_syncs": syncs_per_call(
                    lambda: spd.repair_if_needed(m), 3)})
        if repair["gated_syncs"] or repair["repair_syncs"]:
            raise AssertionError(f"the SPD repair synchronizes: {repair}")
        loops = [self.loop_rate(True), self.loop_rate(False, trials=1)]
        self.timing = {"lines": lines, "trip_count": trips,
                       "spd_repair": repair, "loops": loops}
        emit("ekf_times", seconds=time.perf_counter() - t0, card=self.card,
             ekf=lines, one_kernel_launch_per_update=True, trip_count=trips,
             spd_repair=repair, closed_loop=loops,
             detector_ms_per_call=self.detector_ms)

    def profile_window(self, tick, ticks, sense_fn, tick_us):
        """Launches and device µs per tick over ``ticks`` ticks, host syncs
        per tick, and the launches of one sensing update alone."""
        kern, held = eager_window(tick, ticks)
        busy = window_us(kern, held, ticks)
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
        return {"ticks": ticks, "device_us_per_tick": busy,
                "launches_per_tick": sum(c for _, c in kern.values()) / ticks,
                "launches_per_sensing_update": launches(sense_fn),
                "host_syncs_per_tick": syncs_per_call(tick, ticks),
                "unprofiled_tick_us": tick_us,
                "device_idle_share": (None if busy is None
                                      else 1 - busy / tick_us),
                "kernel_records": held,
                "top_device_us_per_tick": {name[:60]: us / ticks
                                           for name, (us, _) in top}}

    def profile(self):
        """torch.profiler over config 3's and config 4's ticks (a window
        holding a whole number of sensing periods, after warm-up): launches
        per tick and per sensing update, device busy µs and idle share
        against the eager ticks' unprofiled time (config 3: the same window
        timed; config 4: ``dense_world``'s eager ticks, without telemetry),
        host syncs per tick, the top device operations. The graphs of the
        ticks: ``graph_ekf`` (config 3) and ``dense_world`` (config 4)."""
        t0 = time.perf_counter()
        out = {}
        mppi, ekf, loop, wpts, lms = self.config3()
        box = [self.sl.slam_loop_init(mppi, ekf, seed=2, device=self.dev)]

        def tick3():
            box[0] = self.sl.slam_loop_tick(mppi, ekf, loop, self.s.model,
                                            wpts, lms, box[0])

        tick_us = wall_us(tick3, 30, warmup=30)

        def sense3():
            st = box[0]
            tru = st.true_pose
            m = self.sensor.landmark_measurements(
                lms, torch.stack([tru[2], tru[0], tru[1]]), loop.visibility)
            self.ekff.known_correspondence_slam(ekf, st.ekf, m,
                                                self.t([0.01, 0.02]))

        out["config3"] = self.profile_window(tick3, 30, sense3, tick_us)
        mppi, ekf, loop, ring, world, meas_fn = self.config4()
        box4 = [self.sl.slam_loop_init(mppi, ekf, pose_xyt=[1.42, 0.0,
                                                            math.pi / 2],
                                       seed=2, device=self.dev)]

        def tick4():
            box4[0] = self.sl.slam_loop_tick(mppi, ekf, loop, self.s.model,
                                             ring, world, box4[0],
                                             meas_fn=meas_fn)

        for _ in range(40):
            tick4()

        def sense4():
            st = box4[0]
            tru = st.true_pose
            m = meas_fn(torch.stack([tru[2], tru[0], tru[1]]), st.generator)
            self.ekff.slam_unknown_da(ekf, st.ekf, m, self.t([0.01, 0.02]))

        out["config4"] = self.profile_window(tick4, 20, sense4,
                                             self.c4_tick_us)
        emit("ekf_profile", seconds=time.perf_counter() - t0,
             card=self.card, **out)


# ── The node graph: runtime/ on the card ──

class Graphs:
    """The reference's node graph on the card (``tpunav_torch/runtime/``):
    the mppi_waypoints.launch graph through K1, the RBPF node at BASELINE
    config 5 through K2–K4, the EKF node in the MPPI loop (config 3), the
    detector chain (config 4's world), the graphed wrappers, the
    two-process deployment over the TCP bus, and a checkpoint of the RBPF
    node's state. Each node step, law call and wrapper step that replays
    a graph is held to its eager form (the same functions called one by
    one on the same inputs) bit for bit."""

    # One scan period (0.2 s) of this twist is rbpf_course's u = (0.03 rad,
    # 0.02 m).
    RBPF_TWIST = np.array([0.15, 0.1, 0.0])
    # Config 3's plant is off the nominal wheel radius and base by the
    # size of error the reference's rotation node calibrates away, so
    # dead reckoning drifts and the landmarks must correct it.
    TRUE_WHEELS = (0.0335, 0.157)

    def __init__(self, smoke: Smoke, rbpf: Rbpf, ekf: Ekf):
        self.s, self.r, self.e = smoke, rbpf, ekf
        self.dev, self.card = smoke.dev, smoke.card
        self.params = smoke.config.load_robot_config(
            os.path.join(CONFIGS, "diff_params.yaml")).diff_drive
        self.k1_course = self.slam_counts = self.node_counts = None

    def course_graph(self, cfg, waypoints, make_law=None, record=None):
        """mppi_waypoints.launch at 60 Hz: driver → cmd_vel →
        turtle_interface → wheel_cmd → plant → encoder ticks →
        turtle_interface → joints → odometer → odom → driver, the driver on
        ``make_law`` (default the graphed ``mppi_law``; ``record`` collects
        each call's (pose, waypoint, twist)). Returns the scheduler, the
        driver, the law's profiler, the channels and a function that runs
        n more cycles."""
        from examples_torch.full_stack_two_process import mppi_law
        from tpunav_torch.runtime import Channel, Node, Scheduler, SolveProfiler
        from tpunav_torch.runtime.nodes import (OdometerNode,
                                                TurtleInterfaceNode,
                                                WaypointDriverNode)
        from tpunav_torch.sim.plant import DiffDrivePlant

        ch = {n: Channel(n) for n in ("cmd_vel", "wheel_cmd", "sensor",
                                      "joints", "odom")}
        inner = (make_law or mppi_law)(cfg, self.params, self.dev)

        def recorded(pose, wpt):
            out = inner(pose, wpt)
            record.append((np.array(pose), np.array(wpt), out))
            return out

        law = SolveProfiler(inner if record is None else recorded,
                            name="mppi_law")
        driver = WaypointDriverNode(ch["odom"], ch["cmd_vel"], waypoints, law,
                                    goal_thresh=0.1)
        driver.start()
        iface = TurtleInterfaceNode(self.params, ch["cmd_vel"],
                                    ch["wheel_cmd"], ch["sensor"],
                                    ch["joints"], device=self.dev)
        plant = DiffDrivePlant(self.params, ch["wheel_cmd"], ch["sensor"],
                               sensor_rate_hz=60.0)
        odo = OdometerNode(self.params, ch["joints"], ch["odom"],
                           device=self.dev)
        cycles = [0]

        def odometer(t):
            odo.tick(t)
            cycles[0] += 1

        s = Scheduler()
        for name, fn in [("driver", driver.tick), ("turtle_interface",
                                                   iface.tick),
                         ("plant", plant.tick), ("odometer", odometer)]:
            s.add(Node(name, 60.0, fn))

        def run_cycles(n):
            target = cycles[0] + n
            s.run(1e9, until=lambda: cycles[0] >= target)

        return s, driver, law, ch, run_cycles

    def node_course(self):
        """The mppi_waypoints.launch graph at full width on the virtual-time
        scheduler: K1 at configs/mppi_params.yaml, horizon 0.5 s, K=4,096,
        N=50, around the real_waypoints.yaml pentagon (goal_thresh 0.1),
        the waypoint node's law one replayed graph per command. Gates: one full
        cycle within 120 s of virtual time, odometry within 0.1 m of the
        last waypoint, one K1 launch per published command, and every
        command equal bit for bit to the eager law's on the same (pose,
        waypoint) sequence. Then on fresh graphs: cycles/s, device µs and
        operations, host API calls, syncs and idle share per cycle with
        the law replayed, beside the same with the eager law over a
        shorter window; and a Chrome trace of 20 cycles."""
        from tpunav_torch.runtime import trace

        t0 = time.perf_counter()
        cfg = self.s.config.load_mppi_config(
            os.path.join(CONFIGS, "mppi_params.yaml"), horizon=0.5,
            rollouts=4096)
        wpts = self.s.config.load_waypoints(
            os.path.join(CONFIGS, "real_waypoints.yaml"))
        calls = []
        s, driver, law, ch, _ = self.course_graph(cfg, wpts, record=calls)
        torch.cuda.synchronize()
        reset_counts()
        t1 = time.perf_counter()
        s.run(120.0, until=lambda: driver.done)
        wall = time.perf_counter() - t1
        counts = read_counts()
        cycles = round(s.t * 60.0) + 1
        odom = ch["odom"].latest()
        last = wpts[(driver.idx - 1) % len(wpts)]
        d_last = float(np.hypot(odom[1] - last[0], odom[2] - last[1]))
        commands = ch["cmd_vel"].seq - 1          # the last is stop()'s zero
        if not (driver.done and s.t <= 120.0):
            raise AssertionError(f"node course not done: {driver.ctr} visits "
                                 f"in {s.t} s")
        if not d_last < 0.1:
            raise AssertionError(f"odometry {odom} ends {d_last} m from the "
                                 "last waypoint")
        if counts != {"K1": commands, "K1_obstacle": 0, "K2": 0, "K3": 0,
                      "K4": 0, "EIG": 0, "ICP": 0, "EKF": 0} or \
                len(calls) != commands:
            raise AssertionError(f"launches {counts} for {commands} commands:"
                                 " the driver did not solve on K1 once each")
        self.k1_course = counts["K1"]
        law_rate, visits = law.hz(), driver.ctr
        # The eager law on the recorded (pose, waypoint) sequence.
        eager = eager_mppi_law(cfg, self.params, self.dev)
        differ = [i for i, (pose, wpt, out) in enumerate(calls)
                  if not np.array_equal(eager(pose, wpt), out)]
        if differ:
            raise AssertionError(f"the replayed law differs from the eager "
                                 f"law at {len(differ)} of {len(calls)} "
                                 f"commands, first {differ[0]}")

        # The law alone on one recorded (pose, waypoint), replayed and
        # eager, in turns: µs per call, the host copies in and out included.
        from examples_torch.full_stack_two_process import mppi_law

        pose, wpt, _ = calls[len(calls) // 2]
        laws = {"graph": mppi_law(cfg, self.params, self.dev),
                "eager": eager_mppi_law(cfg, self.params, self.dev)}
        law_turns = {"graph": [], "eager": []}
        for name in ("graph", "eager", "eager", "graph"):
            law_turns[name].append(wall_us(lambda: laws[name](pose, wpt),
                                           200))
        # Fresh graphs: the eager law 30 cycles warm, 60 timed and a window
        # of 30; the replayed law 60 warm, then 120 timed, a window of 60
        # and 20 traced.
        windows = {}
        for name, make, warm, timed in (("eager", eager_mppi_law, 30, 60),
                                        ("graph", None, 60, 120)):
            s, driver, _, _, run_cycles = self.course_graph(cfg, wpts, make)
            run_cycles(warm)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run_cycles(timed)
            torch.cuda.synchronize()
            cycle_us = 1e6 * (time.perf_counter() - t1) / timed
            windows[name] = {"cycles_per_s": 1e6 / cycle_us,
                             **node_window(lambda: run_cycles(1), timed // 2,
                                           cycle_us)}
        out = os.path.join(ROOT, "tools", "out", "node_course_trace")
        with trace(out):
            run_cycles(20)
        newest = max((os.path.join(out, f) for f in os.listdir(out)),
                     key=os.path.getmtime)
        with open(newest) as f:
            text = f.read()
        named = [k for k in ("mppi_rollout_partials", "mppi_combine")
                 if k in text]
        if len(named) != 2 or driver.done:
            raise AssertionError(f"trace {newest} names {named} of K1's two "
                                 "kernels")
        emit("node_course", seconds=time.perf_counter() - t0,
             card=self.card, K=cfg.rollouts, N=cfg.steps,
             course_virtual_seconds=round(cycles / 60.0, 4), cycles=cycles,
             visits=visits, done=True, final_odom=odom.tolist(),
             dist_to_last_waypoint=d_last, commands=commands,
             kernel_launches=counts, cycles_per_s=cycles / wall,
             law_hz=law_rate, law_bit_identical_commands=len(calls),
             law_alone_us_in_turns=law_turns,
             per_cycle_law_replayed=windows["graph"],
             per_cycle_law_eager=windows["eager"],
             trace=os.path.relpath(newest, ROOT), trace_names_k1=named)

    def rbpf_graph(self, seed=0, record=None):
        """BASELINE config 5 as a node graph: fake encoders at 30 Hz on
        RBPF_TWIST, a scan publisher at 5 Hz (the port's lidar in walls at
        ±1.8 m, 360 beams, 2 mm noise from a generator seeded 7), and the
        RbpfMappingNode (P=500, k=50, 80×80 at 0.05 m, ICP 25 iterations).
        Returns the node, the channels, and a function that runs until n
        more updates were published; ``record`` collects each update's
        inputs (the odometry the node read, the scan)."""
        from tpunav_torch.core import diff_drive as dd
        from tpunav_torch.runtime import Channel, Node, Scheduler
        from tpunav_torch.runtime.nodes import FakeDiffEncodersNode, host
        from tpunav_torch.runtime.slam_nodes import RbpfMappingNode

        r, g = self.r, self.r.g80
        ch = {n: Channel(n) for n in ("cmd_vel", "joints", "scan",
                                      "slam_pose", "grid", "map_odom",
                                      "truth")}
        segs = r.lidar.box_segments(-1.8, -1.8, 1.8, 1.8, device=self.dev)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(7)
        enc = FakeDiffEncodersNode(self.params, ch["cmd_vel"], ch["joints"],
                                   rate_hz=30.0, device=self.dev)
        node = RbpfMappingNode(r.cfg, self.params, ch["joints"], ch["scan"],
                               ch["slam_pose"], ch["grid"],
                               map_odom=ch["map_odom"], truth=ch["truth"],
                               seed=seed, device=self.dev)

        def scan(t):
            pose = dd.pose(enc.state)
            out = host(torch.cat([pose, r.lidar.scan_segments(
                pose, segs, num_beams=g.num_beams, beam_min=g.beam_min,
                beam_delta=g.beam_delta, max_range=g.range_max,
                generator=gen, noise_std=0.002)]))
            ch["truth"].publish(out[:3])
            ch["scan"].publish(out[3:])

        s = Scheduler()
        s.add(Node("cmd", 30.0, lambda t: ch["cmd_vel"].publish(
            self.RBPF_TWIST)))
        s.add(Node("encoders", 30.0, enc.tick))
        s.add(Node("scan", 5.0, scan))
        s.add(Node("slam", 5.0, node.tick if record is None else
                   recorder(node, ch["slam_pose"], record,
                            lambda: (node.drive, ch["scan"].latest()))))

        def run_updates(n):
            target = ch["slam_pose"].seq + n
            s.run(1e9, until=lambda: ch["slam_pose"].seq >= target)

        return node, ch, run_updates

    def rbpf_node(self):
        """(a) The RBPF node at BASELINE config 5 over 120 updates (24 s of
        virtual time), each one replay of its graph (the odometry, the
        PFStepper update, the estimates) and one host copy. Gates: best
        particle |xy| < 0.2 m from the truth
        (examples/rbpf_slam_demo.py:82), the grid holds 100 and 0 cells,
        map→odom published, one K2 and one K3 launch per update (K4 once,
        in pf_init), and the state after 20 updates equal in digest to an
        eager pf_slam_step chain on the same inputs with the same
        generator. Its updates/s beside rbpf_course's (eager) and
        graph_rbpf's (PFStepper alone)."""
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        reset_counts()           # K4 launches in pf_init, in the node's ctor
        inputs = []
        node, ch, run_updates = self.rbpf_graph(record=inputs)
        run_updates(Rbpf.WARM)
        at_warm = digest(node.pf.poses, node.pf.log_weights, node.pf.grids)
        torch.cuda.synchronize()
        t_warm = time.perf_counter()
        run_updates(Rbpf.UPDATES - Rbpf.WARM)
        torch.cuda.synchronize()
        steady = (Rbpf.UPDATES - Rbpf.WARM) / (time.perf_counter() - t_warm)
        counts = read_counts()
        updates = ch["slam_pose"].seq
        est, tru = ch["slam_pose"].latest(), ch["truth"].latest()
        xy = float(np.hypot(est[1] - tru[1], est[2] - tru[2]))
        grid = ch["grid"].latest()
        if not (np.isfinite(est).all() and xy < 0.2):
            raise AssertionError(f"RBPF node: best particle {xy} m off")
        if not ((grid == 100).any() and (grid == 0).any()
                and ch["map_odom"].latest() is not None):
            raise AssertionError("RBPF node: no walls or no free cells in "
                                 "the grid, or no map→odom")
        want = {"K1": 0, "K1_obstacle": 0, "K2": updates, "K3": updates,
                "K4": 1, "EIG": 0, "ICP": updates, "EKF": 0}
        if updates != Rbpf.UPDATES or counts != want:
            raise AssertionError(f"RBPF node: launches {counts} over "
                                 f"{updates} updates, expected {want}")
        st = eager_rbpf_chain(self.r, self.params, inputs[:Rbpf.WARM],
                              self.dev)
        eager = digest(st.poses, st.log_weights, st.grids)
        if eager != at_warm:
            raise AssertionError(f"RBPF node after {Rbpf.WARM} updates: "
                                 f"digest {at_warm}, eager chain {eager}")
        course = 1e3 / self.r.ms_per_update
        # Per update over 5 more of the graph (the simulated encoders and
        # scans included): device µs and operations, host API calls, syncs,
        # idle share (rbpf_profile has the eager course's); then the same
        # for the node's update alone (the last scan again: one copy in,
        # the normals' draws, one replay, one copy out).
        window = node_window(lambda: run_updates(1), 5, 1e6 / steady)
        alone = self.update_alone(node, ch["scan"], 10)
        # Host-bound rates drift within a call, so the node's cost over its
        # update is also taken in turns on the same host: 20 updates of
        # the course's inputs through a bare PFStepper, 20 node updates, 20
        # node, 20 bare (ms per update).
        u, scans, odoms, prevs = self.r.inputs
        bare_stepper = self.r.pf.PFStepper(
            self.r.cfg, self.r.pf.pf_init(self.r.cfg, seed=1,
                                          device=self.dev), self.dev)

        def bare():
            for i in range(20):
                bare_stepper.step(scans[i], u, odoms[i], prevs[i])

        for i in range(2):                    # its warm-up and capture
            bare_stepper.step(scans[i], u, odoms[i], prevs[i])
        turns = {"bare": [], "node": []}
        for name in ("bare", "node", "node", "bare"):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            bare() if name == "bare" else run_updates(20)
            torch.cuda.synchronize()
            turns[name].append(1e3 * (time.perf_counter() - t1) / 20)
        return {"seconds": time.perf_counter() - t0, "P": self.r.P,
                "k": self.r.K, "map": [self.r.g80.height, self.r.g80.width],
                "updates": updates, "steady_updates_per_s": steady,
                "steady_ms_per_update": 1e3 / steady,
                "rbpf_course_updates_per_s": course,
                "digest_after_warm_up": at_warm,
                "eager_chain_digest_equal": True,
                "eager_chain_updates": Rbpf.WARM,
                "turns_ms_per_update": turns,
                "node_over_pf_stepper_ms_per_update_in_turns":
                    statistics.mean(turns["node"])
                    - statistics.mean(turns["bare"]),
                "per_update_of_graph": window, "update_alone": alone,
                "pose_error_cm": 100 * xy,
                "occupied_cells": int((grid == 100).sum()),
                "free_cells": int((grid == 0).sum()),
                "map_odom": ch["map_odom"].latest().tolist(),
                "kernel_launches": counts}

    def ekf_node(self):
        """(b) Config 3 as a node graph: the driver on the SLAM pose with K1
        at K=1,024, N=8 around the demo's square; turtle_interface and the
        plant at 60 Hz (the plant's wheels off nominal, TRUE_WHEELS);
        EkfSlamNode (known DA, 12 slots) fed by landmark_measurements of
        the block world within 1.2 m at 10 Hz. Gates: EKF |xy| error <
        odometry's, one K1 launch per published command, and the node's
        first EKF_NODE_EAGER published poses and map→odom corrections equal
        bit for bit to its eager form's on the same inputs (the odometry,
        the dynamic known-DA update and the estimates, one by one). Per
        update of the node's graph: ms, host API calls, syncs, idle share.
        """
        from examples_torch.full_stack_two_process import mppi_law
        from tpunav_torch.core import diff_drive as dd
        from tpunav_torch.runtime import Channel, Node, Scheduler
        from tpunav_torch.runtime.nodes import (TurtleInterfaceNode,
                                                WaypointDriverNode)
        from tpunav_torch.runtime.slam_nodes import EkfSlamNode
        from tpunav_torch.sim.plant import DiffDrivePlant

        t0 = time.perf_counter()
        mppi, ekf_cfg, loop, _, _ = self.e.config3()
        centers, _ = self.s.config.load_landmarks(
            os.path.join(CONFIGS, "block_world_landmarks.yaml"))
        lms = torch.tensor(centers, dtype=torch.float32)
        ch = {n: Channel(n) for n in ("cmd_vel", "wheel_cmd", "sensor",
                                      "joints", "landmarks", "slam_pose",
                                      "odom_pose", "map_odom")}
        driver = WaypointDriverNode(ch["slam_pose"], ch["cmd_vel"],
                                    self.e.c3_demo.WAYPOINTS,
                                    mppi_law(mppi, self.params, self.dev),
                                    goal_thresh=loop.goal_thresh)
        driver.start()
        iface = TurtleInterfaceNode(self.params, ch["cmd_vel"],
                                    ch["wheel_cmd"], ch["sensor"],
                                    ch["joints"], device=self.dev)
        plant = DiffDrivePlant(dd.DiffDriveParams(*self.TRUE_WHEELS),
                               ch["wheel_cmd"], ch["sensor"],
                               sensor_rate_hz=60.0)
        ekf = EkfSlamNode(ekf_cfg, self.params, ch["joints"], ch["landmarks"],
                          ch["slam_pose"], ch["odom_pose"],
                          map_odom=ch["map_odom"], known_da=True,
                          device=self.dev)
        inputs = []
        slam = recorder(ekf, ch["slam_pose"], inputs, lambda: (
            ekf.drive, ch["landmarks"].latest(), ch["slam_pose"].latest(),
            ch["map_odom"].latest()), EKF_NODE_EAGER)

        def sense(t):
            ch["landmarks"].publish(self.e.sensor.landmark_measurements(
                lms, torch.tensor(plant.pose, dtype=torch.float32),
                loop.visibility).numpy())

        s = Scheduler()
        for name, rate, fn in [("driver", 60.0, driver.tick),
                               ("turtle_interface", 60.0, iface.tick),
                               ("plant", 60.0, plant.tick),
                               ("landmark_sensor", 10.0, sense),
                               ("slam", 60.0, slam)]:
            s.add(Node(name, rate, fn))
        torch.cuda.synchronize()
        reset_counts()
        t1 = time.perf_counter()
        s.run(90.0, until=lambda: driver.done)
        wall = time.perf_counter() - t1
        counts = read_counts()
        commands = ch["cmd_vel"].seq - int(driver.done)
        updates = ch["slam_pose"].seq
        s.run(0.5)                     # the robot stops; the filter catches up
        tru, est, odo = (plant.pose, ch["slam_pose"].latest(),
                         ch["odom_pose"].latest())
        ekf_err = float(np.hypot(est[1] - tru[1], est[2] - tru[2]))
        odo_err = float(np.hypot(odo[1] - tru[1], odo[2] - tru[2]))
        if not ekf_err < odo_err:
            raise AssertionError(f"EKF node: error {ekf_err} m not below "
                                 f"odometry's {odo_err} m")
        if counts != {"K1": commands, "K1_obstacle": 0, "K2": 0, "K3": 0,
                      "K4": 0, "EIG": 0, "ICP": 0, "EKF": updates}:
            raise AssertionError(f"EKF node: launches {counts} for {commands}"
                                 f" commands and {updates} updates")
        out = {"K": mppi.rollouts, "N": mppi.steps,
               "landmarks": len(centers), "virtual_seconds": s.t,
               "done": driver.done, "visits": driver.ctr,
               "commands": commands, "ekf_updates": ch["slam_pose"].seq,
               "ekf_error_m": ekf_err, "odometry_error_m": odo_err,
               "landmarks_tracked": int(ekf.ekf.count),
               "kernel_launches": counts,
               "graph_seconds_per_virtual_second": wall / s.t,
               "eager_bit_identical_updates": len(inputs),
               "eager_ms_per_update": self.ekf_node_against_eager(
                   ekf_cfg, True, inputs, True),
               "update_alone": self.update_alone(ekf, ch["landmarks"])}
        return {"seconds": time.perf_counter() - t0, **out}

    def ekf_node_against_eager(self, cfg, known, inputs, map_odom):
        """The EKF node's recorded updates (odometry, message, published
        pose[, map→odom]) against its eager form on the same inputs, bit
        for bit; returns the eager form's ms per update."""
        from tpunav_torch.core import diff_drive as dd
        from tpunav_torch.runtime.nodes import host, to_device
        from tpunav_torch.runtime.slam_nodes import map_to_odom

        ekff = self.e.ekff
        step = (ekff.known_correspondence_slam if known
                else ekff.slam_unknown_da)
        st = ekff.ekf_init(cfg, dtype=torch.float32, device=self.dev)
        drive = dd.init_state(device=self.dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i, (odo, meas, *published) in enumerate(inputs):
            drive, wheel_vel = dd.update_odometry(self.params, drive,
                                                  odo.left, odo.right)
            u = dd.wheels_to_twist(self.params, wheel_vel)[:2]
            st = step(cfg, st, to_device(meas, torch.float32, self.dev), u)
            pose = ekff.robot_pose(st)
            want = host(torch.cat([pose, map_to_odom(pose, dd.pose(odo))])
                        if map_odom else pose)
            if not np.array_equal(want, np.concatenate(published)):
                raise AssertionError(f"EKF node (known DA {known}) update "
                                     f"{i}: {published} against the eager "
                                     f"form's {want}")
        return 1e3 * (time.perf_counter() - t1) / len(inputs)

    def update_alone(self, node, channel, reps=20):
        """A SLAM node's update alone (``channel``'s last message again:
        one copy in, one replay, one copy out): ms, and per update device
        µs and operations, host API calls, syncs and idle share."""
        last = channel.latest()

        def update():
            channel.publish(last)
            node.tick(0.0)

        update_us = wall_us(update, reps)
        return {"ms": 1e-3 * update_us,
                **node_window(update, reps // 2, update_us)}

    def detector_node(self):
        """(c) Config 4's world: 360-beam scans (1 mm noise) at 5 Hz from a
        robot circling 1.25 m out, into LandmarksNode (max_clusters 32) and
        EkfSlamNode (unknown DA, capacity 50), 30 s of virtual time. Gates:
        the node's measurements equal feature_detection +
        circles_to_measurements on the same scans bit for bit (the node
        replays the detector as a CUDA graph), the EKF node's first
        EKF_NODE_EAGER published poses equal bit for bit to its eager
        form's (the unknown-DA update), all state finite, at least 20
        landmarks tracked, two eigensolver launches per scan. The node's
        tick (the scan in, one replay, one host copy out) timed beside the
        eager detector call (``detector``'s ms per call), and the EKF
        node's update per update."""
        from tpunav_torch.core import diff_drive as dd
        from tpunav_torch.core import se2
        from tpunav_torch.runtime import Channel, Node, Scheduler
        from tpunav_torch.runtime.nodes import FakeDiffEncodersNode, host
        from tpunav_torch.runtime.slam_nodes import EkfSlamNode, LandmarksNode

        t0 = time.perf_counter()
        _, ekf_cfg, _, _, world, _ = self.e.config4()
        radii = self.e.t(self.e.radii)
        lm_cfg = self.e.lmk.LandmarkConfig(max_clusters=32)
        ch = {n: Channel(n) for n in ("cmd_vel", "joints", "scan",
                                      "landmarks", "slam_pose", "odom_pose")}
        enc = FakeDiffEncodersNode(self.params, ch["cmd_vel"], ch["joints"],
                                   rate_hz=20.0, device=self.dev)
        start = se2.make(*self.e.t([math.pi / 2, 1.25, 0.0]))
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(4)
        lmk = LandmarksNode(lm_cfg, ch["scan"], ch["landmarks"],
                            device=self.dev)
        ekf = EkfSlamNode(ekf_cfg, self.params, ch["joints"], ch["landmarks"],
                          ch["slam_pose"], ch["odom_pose"], known_da=False,
                          device=self.dev)
        inputs, seen = [], []

        def scan(t):
            p = dd.pose(enc.state)           # in the start frame
            w = se2.compose(start, se2.make(p[0], p[1], p[2]))
            ch["scan"].publish(host(self.e.lidar.scan_cylinders(
                torch.stack([se2.theta_of(w), *se2.translation_of(w)]),
                world, radii, generator=gen, noise_std=1e-3)))

        def detect(t):
            lmk.tick(t)
            seen.append((ch["scan"].latest(), ch["landmarks"].latest()))

        torch.cuda.synchronize()
        reset_counts()
        s = Scheduler()
        s.add(Node("cmd", 20.0, lambda t: ch["cmd_vel"].publish(
            np.array([0.08, 0.1, 0.0]))))
        s.add(Node("encoders", 20.0, enc.tick))
        s.add(Node("scan", 5.0, scan))
        s.add(Node("landmarks", 5.0, detect))
        s.add(Node("slam", 20.0, recorder(
            ekf, ch["slam_pose"], inputs, lambda: (
                ekf.drive, ch["landmarks"].latest(),
                ch["slam_pose"].latest()), EKF_NODE_EAGER)))
        s.run(29.99)
        torch.cuda.synchronize()
        counts = read_counts()
        same = all(np.array_equal(
            m, host(self.e.lmk.circles_to_measurements(
                self.e.lmk.feature_detection(lm_cfg, self.e.t(r)))),
            equal_nan=True) for r, m in seen)
        finite = all(bool(torch.isfinite(x).all()) for x in ekf.ekf[:2])
        count = int(ekf.ekf.count)
        if not (same and finite and count >= 20 and len(seen) == 150 and
                counts["EIG"] == 2 * len(seen)):
            raise AssertionError(f"detector chain: measurements equal {same},"
                                 f" finite {finite}, {count} landmarks, "
                                 f"{len(seen)} scans, launches {counts}")
        last = seen[-1][0]

        def node_tick():
            ch["scan"].publish(last)
            lmk.tick(0.0)

        tick_us = wall_us(node_tick, 50)
        est = ch["slam_pose"].latest()
        odo = host(dd.pose(enc.state))
        eager_ms = self.ekf_node_against_eager(ekf_cfg, False, inputs, False)
        per_update = self.update_alone(ekf, ch["landmarks"])
        return {"seconds": time.perf_counter() - t0, "scans": len(seen),
                "beams": 360, "capacity": ekf_cfg.num_landmarks,
                "detections_per_scan": float(np.mean(
                    [np.isfinite(m).all(-1).sum() for _, m in seen])),
                "measurements_bit_identical": same, "finite": finite,
                "landmarks_tracked": count, "kernel_launches": counts,
                "node_tick_us": tick_us,
                "eager_detector_us": 1e3 * self.e.detector_ms,
                "ekf_eager_bit_identical_updates": len(inputs),
                "ekf_eager_ms_per_update": eager_ms,
                "ekf_update_alone": per_update,
                "slam_xy_error_m": float(np.hypot(est[1] - odo[1],
                                                  est[2] - odo[2]))}

    def slam_nodes(self):
        """(a) the RBPF node, (b) the EKF node in the MPPI loop, (c) the
        detector chain; the counts are set to 0 before each and read after,
        and summed into the kernels line."""
        t0 = time.perf_counter()
        rbpf = self.rbpf_node()
        ekf = self.ekf_node()
        det = self.detector_node()
        self.slam_counts = {k: rbpf["kernel_launches"][k]
                            + ekf["kernel_launches"][k]
                            + det["kernel_launches"][k] for k in
                            ("K1", "K2", "K3", "K4", "EIG", "ICP", "EKF")}
        self.node_counts = {"rbpf_node": rbpf["kernel_launches"],
                            "ekf_node": ekf["kernel_launches"],
                            "detector_chain": det["kernel_launches"],
                            "node_course": {"K1": self.k1_course}}
        emit("slam_nodes", seconds=time.perf_counter() - t0, card=self.card,
             rbpf_config5=rbpf, ekf_config3=ekf, detector_chain=det)

    def wrappers(self):
        """``graph_wrappers``: the wrappers that replay one graph per step,
        each against its eager form on the card bit for bit, with µs and
        host syncs per step both ways: TurtleWay around its pentagon
        (tests/test_sim_plant.py's, 60 Hz) to its completion tick,
        MPPIController over 200 closed-loop solves at
        configs/mppi_params.yaml (horizon 0.5 s, K=4,096, N=50; the plain
        solver, no kernel), and PotentialField.plan on the planning phase's
        square map."""
        t0 = time.perf_counter()
        out = {"turtle_way": self.turtle_way(),
               "mppi_controller": self.controller(),
               "potential_field": self.potential_field()}
        emit("graph_wrappers", seconds=time.perf_counter() - t0,
             card=self.card, **out)

    def turtle_way(self):
        from tpunav_torch.core import diff_drive as dd
        from tpunav_torch.core import waypoints as wp
        from tpunav_torch.runtime import Channel
        from tpunav_torch.runtime.nodes import host
        from tpunav_torch.sim.tsim import TurtleWay

        pts = [(3.0, 2.0), (5.0, 2.5), (5.5, 4.0), (4.0, 5.0), (2.5, 4.0)]
        tw = TurtleWay(pts, rot_vel=1.0, trans_vel=1.5, frequency=60.0,
                       pose_in=Channel(), cmd_vel=Channel(), device=self.dev)
        cmds = []
        while not tw.done and len(cmds) < 12000:
            if len(cmds) == 2:                 # after warm-up and capture
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            tw.tick(len(cmds) / 60.0)
            cmds.append(tw.cmd_vel.latest())
        graph_us = 1e6 * (time.perf_counter() - t1) / (len(cmds) - 2)
        params = wp.make_params(np.asarray(pts, np.float32), 1.0, 1.5,
                                device=self.dev)
        ws = wp.init_state(device=self.dev)
        model = dd.init_state(0.0, pts[0][0], pts[0][1], device=self.dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i, got in enumerate(cmds):
            cmd, ws = wp.next_waypoint(params, ws, dd.pose(model))
            model = dd.feedforward(dd.TURTLEBOT3, model, cmd * tw.scale)
            done = bool(ws.cycle_complete)
            if not (np.array_equal(got, np.asarray(host(cmd), float))
                    and done == (i == len(cmds) - 1)):
                raise AssertionError(f"TurtleWay tick {i}: {got}, done "
                                     f"{done}, against the eager law's "
                                     f"{host(cmd)}")
        eager_us = 1e6 * (time.perf_counter() - t1) / len(cmds)
        return {"ticks_to_done": len(cmds), "bit_identical": True,
                "graph_us_per_tick": graph_us, "eager_us_per_tick": eager_us,
                "host_syncs_per_tick": syncs_per_call(lambda: tw.tick(0.0),
                                                      20)}

    def controller(self, solves=200):
        from tpunav_torch.control import mppi
        from tpunav_torch.models.cart import kinematic_cart
        from tpunav_torch.ops.rk4 import rk4_step

        cfg = self.s.config.load_mppi_config(
            os.path.join(CONFIGS, "mppi_params.yaml"), horizon=0.5,
            rollouts=4096)
        ctl = mppi.MPPIController(cfg, self.s.model, seed=3, device=self.dev)
        ctl.set_waypoint([0.6, 0.4, 0.0])
        pose = torch.zeros(3, device=self.dev)
        poses, cmds = [], []
        f = lambda x, uu: kinematic_cart(self.s.model, x, uu)
        for i in range(solves):
            if i == 2:                          # after warm-up and capture
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            poses.append(pose)
            cmds.append(ctl.new_controls(pose))
            pose = rk4_step(f, pose, cmds[-1], 1.0 / 60.0)
        torch.cuda.synchronize()
        graph_us = 1e6 * (time.perf_counter() - t1) / (solves - 2)
        gen = torch.Generator(device=self.dev).manual_seed(3)
        u = mppi.init_controls(cfg, device=self.dev)
        xd = torch.tensor([0.6, 0.4, 0.0], device=self.dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        same = []
        for pose, got in zip(poses, cmds):
            cmd, u = mppi.mppi_solve(cfg, self.s.model, u, gen, pose, xd)
            same.append(torch.equal(cmd, got))
        torch.cuda.synchronize()
        eager_us = 1e6 * (time.perf_counter() - t1) / solves
        if not (all(same) and torch.equal(u, ctl.u)):
            raise AssertionError(f"MPPIController: {same.count(False)} of "
                                 f"{solves} commands differ from the eager "
                                 "solve's")
        moved = float(torch.linalg.vector_norm(poses[-1][:2]))
        return {"K": cfg.rollouts, "N": cfg.steps, "solves": solves,
                "bit_identical": True, "moved_m": moved,
                "graph_us_per_solve": graph_us,
                "eager_us_per_solve": eager_us,
                "host_syncs_per_solve": syncs_per_call(
                    lambda: ctl.new_controls(pose), 20)}

    def potential_field(self):
        from tpunav_torch import planning as plan
        from tpunav_torch.planning import potential_field as pfm

        square = plan.load_obstacle_map(
            [[[1.5, 1.5], [2.5, 1.5], [2.5, 2.5], [1.5, 2.5]]],
            bounds=[[0.0, 4.0], [0.0, 4.0]], resolution=0.1)
        pf = plan.PotentialField(plan.PotentialFieldConfig(step=0.05,
                                                           qthresh=0.3),
                                 square, device=self.dev)
        start, goal = [0.5, 1.0], [3.5, 3.0]
        pf.plan(start, goal, max_steps=5)             # warm-up and capture
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        path = pf.plan(start, goal, max_steps=500)
        torch.cuda.synchronize()
        graph_us = 1e6 * (time.perf_counter() - t1) / (len(path) - 1)
        q = torch.tensor(start, device=self.dev)
        g = torch.tensor(goal, device=self.dev)
        want = [q]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        while (len(want) <= 500
               and float(torch.linalg.vector_norm(q - g)) >= pf.cfg.eps):
            q = pfm._one_step(pf.cfg, pf.a, pf.b, pf.valid, q, g)
            want.append(q)
        eager_us = 1e6 * (time.perf_counter() - t1) / (len(want) - 1)
        if not (len(path) == len(want)
                and torch.equal(torch.stack(path), torch.stack(want))):
            raise AssertionError(f"potential field: {len(path)} steps, the "
                                 f"eager descent {len(want)}, or other bits")
        steps = len(path) - 1
        return {"steps": steps, "bit_identical": True,
                "graph_us_per_step": graph_us, "eager_us_per_step": eager_us,
                "host_syncs_per_step": syncs_per_call(
                    lambda: pf.plan(start, goal, max_steps=500), 1) / steps}

    def two_process(self, cycles=150, duration=10.0):
        """The two-machine deployment (examples/full_stack_two_process.py):
        the robot (plant, turtle_interface, odometer, landmark sensor) on
        the CPU in one process, the laptop (PRM + Theta* once, EKF SLAM,
        the driver with K1 at K=4,096) on the card in another, over the TCP
        bus. Lockstep: equal to the same graph in one process within 1e-9,
        the robot moves > 5 cm. Free-running on the wall clock at a
        nominal 60 Hz: joints and cmd_vel both ≥ 30 Hz."""
        import tempfile

        from examples_torch.full_stack_two_process import (run_free,
                                                           run_single,
                                                           run_two_process)

        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            truth2, slam2, steady = run_two_process(d, cycles, 4096, "cuda")
            truth1, slam1 = run_single(cycles, 4096, self.dev)
            d_truth = float(np.abs(truth2 - truth1).max())
            d_slam = float(np.abs(slam2 - slam1).max())
            moved = float(np.linalg.norm(truth2[-1][1:]))
            if not (d_truth <= 1e-9 and d_slam <= 1e-9 and moved > 0.05):
                raise AssertionError(f"two processes vs one: |Δtruth| "
                                     f"{d_truth}, |Δslam| {d_slam}, moved "
                                     f"{moved} m")
            free = run_free(d, duration, 4096, "cuda")
        if not (free["joints_rate_hz"] >= 30 and free["cmd_vel_rate_hz"] >= 30):
            raise AssertionError(f"free-running rates {free}")
        emit("two_process", seconds=time.perf_counter() - t0, card=self.card,
             K=4096, lockstep_cycles=cycles, max_abs_truth_diff=d_truth,
             max_abs_slam_diff=d_slam, bar=1e-9, moved_m=moved,
             lockstep_laptop_cycles_per_s=steady, free_seconds=duration,
             nominal_hz=60, **free)

    def checkpoint(self):
        """The RBPF node's PFState at config 5 (its CUDA generator
        included) saved after 10 updates, loaded into a fresh template and
        assigned to the node, whose setter copies it into the buffers its
        graph replays (the same tensors before and after): 10 more updates
        give the digests of an uninterrupted 20."""
        import tempfile

        from tpunav_torch.runtime import load_pytree, save_pytree

        t0 = time.perf_counter()
        node, _, run_updates = self.rbpf_graph()
        run_updates(20)
        whole = digest(node.pf.poses, node.pf.log_weights, node.pf.grids)
        node, _, run_updates = self.rbpf_graph()
        run_updates(10)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "pf.npz")
            save_pytree(path, node.pf)
            template = self.r.pf.pf_init(self.r.cfg, seed=123,
                                         device=self.dev)
            buffers = [t.data_ptr() for t in node.pf[:-1]]
            node.pf = load_pytree(path, template)
            in_place = [t.data_ptr() for t in node.pf[:-1]] == buffers
        run_updates(10)
        resumed = digest(node.pf.poses, node.pf.log_weights, node.pf.grids)
        if not (resumed == whole and in_place
                and node.pf.generator.device == self.dev):
            raise AssertionError(f"checkpoint resume {resumed} != {whole}, "
                                 f"loaded in place: {in_place}")
        emit("checkpoint", seconds=time.perf_counter() - t0, P=self.r.P,
             updates=[10, 10], generator=str(node.pf.generator.device),
             loaded_in_place=in_place,
             digest_uninterrupted=whole, digest_resumed=resumed)


# ── The sharded paths (tpunav_torch.parallel), ranks spawned on the card ──

SHARD_SOLVES = 20           # the chained solves of sharded_mppi (a)
SHARD_UPDATES = 40          # the RBPF updates of sharded_rbpf (a)


def card_noise(cfg, seed: int):
    """(N, K, 2) scaled perturbations from a card generator seeded with
    ``seed``: the same bits in every process on the card."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sig = torch.tensor([cfg.ul_var, cfg.ur_var]).sqrt().to(dev)
    return torch.randn((cfg.steps, cfg.rollouts, 2), generator=gen,
                       device=dev) * sig


def ulps_apart(a, b) -> float:
    """max |a − b| in float32 spacings at the larger magnitude."""
    a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
    spacing = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    return float((np.abs(a - b) / spacing).max())


def _shard_nccl_chain(mesh, device, solves):
    """sharded_mppi (a), on one NCCL rank: the fused sharded solve at
    K=4,096 (K1's partials, one MIN and one SUM over the group) chained
    ``solves`` times; each solve held against mppi_solve_fused on the same
    controls and seed. Counts K1 solves of the sharded calls only, all and
    those in obstacle mode."""
    import torch.distributed as dist

    from tpunav_torch.parallel import mppi_solve_fused_sharded

    smoke = Smoke()
    fm = smoke.fm
    cfg = smoke.cfg(4096)
    u, pose, xd, _ = smoke.tensors(cfg, u_off=(0.5, -0.2))
    solve = mppi_solve_fused_sharded(cfg, smoke.model, mesh)
    launches, obstacle, unequal, ulps, abs_err = 0, 0, 0, 0.0, 0.0
    for i in range(solves):
        before, before_obs = fm.KERNEL_LAUNCHES, fm.OBSTACLE_LAUNCHES
        got = solve(u, 7 + i, pose, xd)
        launches += fm.KERNEL_LAUNCHES - before
        obstacle += fm.OBSTACLE_LAUNCHES - before_obs
        want = fm.mppi_solve_fused(cfg, smoke.model, u, 7 + i, pose, xd)
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                unequal += 1
                ulps = max(ulps, ulps_apart(a, b))
                abs_err = max(abs_err, float((a - b).abs().max()))
        u = got[1]
    if not bool(torch.isfinite(u).all()):
        raise AssertionError("non-finite controls from the sharded chain")
    return {"backend": dist.get_backend(), "ranks": mesh.size,
            "k1_solves": launches, "k1_obstacle_solves": obstacle,
            "unequal_outputs": unequal,
            "max_ulps": ulps, "max_abs_diff": abs_err}


def _shard_gloo_solves(mesh, device):
    """sharded_mppi (b) and (d), on each of two gloo ranks: the fused
    sharded solve at K=196,608 (98,304 per rank) on this rank's columns of
    the global injected noise, and the plain sharded solve at K=4,096 on
    its rows. Returns the update rows (cmd, then u_next[:-1]) and the K1
    solves of each, all and those in obstacle mode."""
    from tpunav_torch.parallel import (mppi_solve_fused_sharded,
                                       mppi_solve_sharded)

    smoke = Smoke()
    out = {}
    for name, k, fused in (("k196608", 196608, True),
                           ("plain_k4096", 4096, False)):
        cfg = smoke.cfg(k)
        u, pose, xd, _ = smoke.tensors(cfg)
        z = card_noise(cfg, k)
        cols = slice(mesh.index * k // mesh.size,
                     (mesh.index + 1) * k // mesh.size)
        before = smoke.fm.KERNEL_LAUNCHES
        before_obs = smoke.fm.OBSTACLE_LAUNCHES
        if fused:
            cmd, un = mppi_solve_fused_sharded(cfg, smoke.model, mesh)(
                u, 0, pose, xd, noise=z[:, cols].contiguous())
        else:
            cmd, un = mppi_solve_sharded(cfg, smoke.model, mesh)(
                u, z[:, cols].transpose(0, 1).contiguous(), pose, xd)
        out[name] = torch.cat([cmd[None], un[:-1]]).cpu().numpy()
        out[name + "_k1_solves"] = smoke.fm.KERNEL_LAUNCHES - before
        out[name + "_k1_obstacle_solves"] = (smoke.fm.OBSTACLE_LAUNCHES
                                             - before_obs)
    out["graphed_steppers_raise"] = _graphs_refused(mesh, device, smoke)
    return out


def _graphs_refused(mesh, device, smoke):
    """Whether each graphed sharded stepper's constructor raises on this
    rank's mesh (a host-staged gloo mesh on the card)."""
    from tpunav_torch.estimation.rbpf.particle_filter import PFConfig
    from tpunav_torch.parallel import (FusedShardedStepper,
                                       PlainShardedStepper, ShardedPFStepper,
                                       pf_init_sharded)

    cfg = smoke.cfg(4096)
    u = smoke.mppi.init_controls(cfg, device=device)
    pcfg = PFConfig(num_particles=2 * mesh.size, k_samples=2)
    raised = []
    for build in (
            lambda: FusedShardedStepper(cfg, smoke.model, mesh, u, 0),
            lambda: PlainShardedStepper(cfg, smoke.model, mesh, u,
                                        torch.Generator(device=device)),
            lambda: ShardedPFStepper(pcfg, mesh, pf_init_sharded(
                pcfg, mesh, device=device))):
        try:
            build()
            raised.append(False)
        except ValueError:
            raised.append(True)
    return raised


def _shard_rbpf_course(mesh, device, updates):
    """sharded_rbpf (a), on each of two gloo ranks: config 5's course
    (Rbpf.course_inputs) through pf_slam_step_sharded at P/2 particles per
    rank, drawing from the replicated generator. Returns this rank's K1
    (all, and in obstacle mode), K2, K3 and K4 launches over the updates,
    the resampling events (an update whose previous poses are not the
    poses it started from), ms per update, the exchange's all-gather ms,
    whether the fields are K4 of the grids, a digest of the gathered state,
    and on rank 0 the gathered poses, log-weights and grids."""
    from tpunav_torch import interop
    from tpunav_torch.parallel import pf_init_sharded, pf_slam_step_sharded

    rb = Rbpf("")
    u, scans, odoms, prevs = rb.course_inputs()
    cfg = rb.cfg
    st = pf_init_sharded(cfg, mesh, seed=0, device=device)
    step = pf_slam_step_sharded(cfg, mesh)
    flags = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for i in range(updates):
        start = st.poses
        st = step(st, scans[i], u, odoms[i], prevs[i])
        flags.append((st.prev_poses != start).any())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    events = int((mesh.sum_(torch.stack(flags).to(torch.int32)) > 0).sum())
    edt = torch.equal(st.dists, rb.mu.edt_batch(cfg.grid, st.grids))
    # The exchange's one all-gather, on a buffer of its shape: the local
    # rows' [pose, previous pose, grid] side by side.
    g = cfg.grid
    packed = torch.zeros((cfg.num_particles // mesh.size,
                          6 + g.height * g.width), device=device)
    mesh.all_gather(packed)
    torch.cuda.synchronize()
    t1, reps = time.perf_counter(), 20
    for _ in range(reps):
        mesh.all_gather(packed)
    torch.cuda.synchronize()
    gather_ms = 1e3 * (time.perf_counter() - t1) / reps
    whole = interop.pf_state_gather_to_numpy(st, mesh)
    out = {"launches": counts,
           "events": events, "dists_are_edt": edt,
           "ms_per_update": 1e3 * secs / updates, "exchange_ms": gather_ms,
           "exchange_mb": 4 * cfg.num_particles * (6 + g.height * g.width)
           / 1e6,
           "digest": hashlib.sha256(b"".join(
               whole[n].tobytes() for n in sorted(whole))).hexdigest()[:16]}
    if mesh.index == 0:
        out.update({n: whole[n] for n in ("poses", "log_weights", "grids")})
    return out


def _replayed_window(step, reps: int) -> dict:
    """A graph stepper's replayed window: ms per step, host syncs per step,
    and :func:`graph_window`'s device µs, idle share and host API calls
    per step."""
    us = wall_us(step, 10, warmup=0)
    return {"ms": us / 1e3, "host_syncs": syncs_per_call(step, 3),
            **graph_window(step, reps, 1, us)}


def _shard_graph_rank(mesh, device, solves, updates):
    """graph_sharded, on one NCCL rank: the graphed sharded steppers
    (tpunav_torch.parallel) against the eager sharded functions in this
    rank. (a) FusedShardedStepper at K=4,096 over ``solves`` chained
    solves from seed 7: the eager sharded chain's bits, within 2 ulps of
    mppi_solve_fused, one K1 (partials) launch per replay. (b)
    PlainShardedStepper at K=4,096 over 5 solves drawing from a generator:
    the eager sharded solve's bits and generator. (c) ShardedPFStepper at
    config 5 over ``updates`` updates of Rbpf.course_inputs from filter
    seed 0: every leaf and the generator the eager sharded course's, the
    fields K4 of the grids, one K2, K3 and K4 launch per replay. Each with
    ms per step eager and replayed and a replayed window."""
    import torch.distributed as dist

    from tpunav_torch.parallel import (FusedShardedStepper,
                                       PlainShardedStepper, ShardedPFStepper,
                                       mppi_solve_fused_sharded,
                                       mppi_solve_sharded, pf_init_sharded,
                                       pf_slam_step_sharded)

    smoke = Smoke()
    fm, model = smoke.fm, smoke.model
    out = {"backend": dist.get_backend(), "ranks": mesh.size}

    cfg = smoke.cfg(4096)
    u0, pose, xd, _ = smoke.tensors(cfg, u_off=(0.5, -0.2))
    eager = mppi_solve_fused_sharded(cfg, model, mesh)
    eager(u0, 0, pose, xd)          # the warm-up: NCCL's communicator
    chain, u = [], u0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(solves):
        chain.append(eager(u, 7 + i, pose, xd))
        u = chain[-1][1]
    torch.cuda.synchronize()
    eager_ms = 1e3 * (time.perf_counter() - t0) / solves
    graph = FusedShardedStepper(cfg, model, mesh, u0, 7)
    reset_counts()
    got = [tuple(t.clone() for t in graph.step(pose, xd))
           for _ in range(solves)]
    counts = read_counts()
    same = all(torch.equal(a, b) for g, e in zip(got, chain)
               for a, b in zip(g, e))
    ulps, u = 0.0, u0
    for i, g in enumerate(got):
        want = fm.mppi_solve_fused(cfg, model, u, 7 + i, pose, xd)
        ulps = max([ulps] + [ulps_apart(a, b) for a, b in zip(g, want)])
        u = g[1]
    out["fused"] = {"K": cfg.rollouts, "N": cfg.steps, "solves": solves,
                    "launches": counts, "eager_bits": same,
                    "max_ulps_vs_mppi_solve_fused": ulps,
                    "seed_after": int(graph.seed),
                    "eager_ms_per_solve": eager_ms,
                    "replayed": _replayed_window(
                        lambda: graph.step(pose, xd), 5)}

    gens = []
    for _ in range(2):
        gens.append(torch.Generator(device=device))
        gens[-1].manual_seed(11)
    eager = mppi_solve_sharded(cfg, model, mesh)
    eager(u0, torch.Generator(device=device), pose, xd)     # the warm-up
    graph = PlainShardedStepper(cfg, model, mesh, u0, gens[1])
    u, same = u0, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = []
    for _ in range(5):
        want.append(eager(u, gens[0], pose, xd))
        u = want[-1][1]
    torch.cuda.synchronize()
    eager_ms = 1e3 * (time.perf_counter() - t0) / 5
    for w in want:
        same.append(all(torch.equal(a, b) for a, b in zip(
            graph.step(pose, xd), w)))
    same.append(torch.equal(gens[0].get_state(), gens[1].get_state()))
    out["plain"] = {"K": cfg.rollouts, "N": cfg.steps, "solves": 5,
                    "eager_bits": same, "eager_ms_per_solve": eager_ms,
                    "replayed": _replayed_window(
                        lambda: graph.step(pose, xd), 3)}

    rb = Rbpf("")
    u, scans, odoms, prevs = rb.course_inputs()
    pcfg = rb.cfg
    st = pf_init_sharded(pcfg, mesh, seed=0, device=device)
    graph = ShardedPFStepper(pcfg, mesh, pf_init_sharded(pcfg, mesh, seed=0,
                                                         device=device))
    step = pf_slam_step_sharded(pcfg, mesh)
    step(pf_init_sharded(pcfg, mesh, seed=1, device=device), scans[0], u,
         odoms[0], prevs[0])                                 # the warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(updates):
        st = step(st, scans[i], u, odoms[i], prevs[i])
    torch.cuda.synchronize()
    eager_ms = 1e3 * (time.perf_counter() - t0) / updates
    reset_counts()
    for i in range(updates):
        graph.step(scans[i], u, odoms[i], prevs[i])
    counts = read_counts()
    same = same_bits(graph.state, st, ("poses", "prev_poses", "log_weights",
                                       "grids", "dists", "prev_scan",
                                       "has_prev"))
    same["generator"] = torch.equal(graph.state.generator.get_state(),
                                    st.generator.get_state())
    k = [0]

    def update():
        i = k[0] % updates
        graph.step(scans[i], u, odoms[i], prevs[i])
        k[0] += 1

    out["rbpf"] = {"P": pcfg.num_particles, "updates": updates,
                   "launches": counts, "eager_bits": same,
                   "dists_are_k4_of_grids": torch.equal(
                       graph.state.dists,
                       rb.mu.edt_batch(pcfg.grid, graph.state.grids)),
                   "eager_ms_per_update": eager_ms,
                   "replayed": _replayed_window(update, 3)}
    return out


class Sharded:
    """The sharded paths on the card: ``tpunav_torch.parallel`` through
    ``runtime.distributed``, in ranks spawned by ``examples_torch.launch``.
    One NCCL rank owns the card alone; two ranks share it under gloo (NCCL
    refuses two ranks on one device), so nothing here measures scaling."""

    def __init__(self, smoke: Smoke, rbpf: Rbpf):
        self.s, self.r = smoke, rbpf
        self.launches = {}
        self.refused = None            # sharded_mppi's gloo check, once run

    def mppi(self):
        from examples_torch import launch, mppi_two_process

        t0 = time.perf_counter()
        s = self.s
        (a,) = launch(_shard_nccl_chain, (SHARD_SOLVES,), world=1,
                      device="cuda", backend="nccl", timeout=300)
        if a["k1_solves"] != SHARD_SOLVES:
            raise AssertionError(f"(a) {a['k1_solves']} K1 solves for "
                                 f"{SHARD_SOLVES} sharded solves")
        if a["unequal_outputs"] and not a["max_ulps"] <= 2.0:
            raise AssertionError(f"(a) one NCCL rank vs mppi_solve_fused: "
                                 f"{a['max_ulps']} ulps")

        ranks = launch(_shard_gloo_solves, (), world=2, device="cuda",
                       backend="gloo", timeout=300)
        self.refused = [r["graphed_steppers_raise"] for r in ranks]
        if self.refused != [[True] * 3] * 2:
            raise AssertionError(f"graphed sharded steppers on two gloo "
                                 f"ranks: raised {self.refused}")
        for key in ("k196608", "plain_k4096"):
            if not np.array_equal(ranks[0][key], ranks[1][key]):
                raise AssertionError(f"({key}) the ranks' controls differ")
        cases = {}
        for key, k, bar in (("k196608", 196608, BAR),
                            ("plain_k4096", 4096, 1e-5)):
            cfg = s.cfg(k)
            u, pose, xd, _ = s.tensors(cfg)
            z = card_noise(cfg, k)
            if key == "k196608":
                cmd, un = s.fm.mppi_solve_fused(cfg, s.model, u, 0, pose, xd,
                                                noise=z)
            else:
                cmd, un = s.mppi.mppi_solve(cfg, s.model, u, None, pose, xd,
                                            noise=z.transpose(0, 1))
            got = torch.from_numpy(ranks[0][key]).to(s.dev)
            err, exempt, err_all = gate_rows(
                s.mppi, cfg, s.model, got, torch.cat([cmd[None], un[:-1]]),
                u, pose, xd, z, None, f"sharded_mppi {key}", bar=bar)
            cases[key] = {"K": k, "bar": bar, "max_abs_err": err,
                          "exempt_rows": exempt, "max_abs_err_all": err_all,
                          "k1_solves_per_rank": [r[key + "_k1_solves"]
                                                 for r in ranks]}
        if cases["k196608"]["k1_solves_per_rank"] != [1, 1]:
            raise AssertionError(f"(b) K1 solves {cases['k196608']}")

        c = mppi_two_process.launcher("cuda", "gloo", timeout=300)
        if [r["k1_launches"] for r in c] != [SHARD_SOLVES] * 2:
            raise AssertionError(f"(c) K1 solves {[r['k1_launches'] for r in c]}")
        # K1's counts per phase and rank, all solves and those in obstacle
        # mode (no sharded phase passes obstacles: that count reads 0).
        self.launches["K1"] = {
            "sharded_mppi_nccl_1rank": [a["k1_solves"]],
            "sharded_mppi_k196608_2ranks": cases["k196608"][
                "k1_solves_per_rank"],
            "mppi_two_process_2ranks": [r["k1_launches"] for r in c]}
        self.launches["K1_obstacle"] = {
            "sharded_mppi_nccl_1rank": [a["k1_obstacle_solves"]],
            "sharded_mppi_k196608_2ranks": [
                r["k196608_k1_obstacle_solves"] for r in ranks],
            "mppi_two_process_2ranks": [r["k1_obstacle_launches"]
                                        for r in c]}
        emit("sharded_mppi", seconds=time.perf_counter() - t0, card=s.card,
             nccl_one_rank={"K": 4096, "N": 50, "solves": SHARD_SOLVES,
                            **a},
             gloo_two_ranks=cases,
             two_process_course={
                 "K": mppi_two_process.ROLLOUTS, "solves": SHARD_SOLVES,
                 "solves_per_s_per_rank": [r["solves_per_sec"] for r in c],
                 "k1_solves_per_rank": [r["k1_launches"] for r in c],
                 "ranks_bit_identical": True},
             note="two ranks share one card: no rate here is a scaling "
                  "number")

    def rbpf(self):
        from examples_torch import launch, rbpf_two_process

        t0 = time.perf_counter()
        r = self.r
        ranks = launch(_shard_rbpf_course, (SHARD_UPDATES,), world=2,
                       device="cuda", backend="gloo", timeout=400)
        if ranks[0]["digest"] != ranks[1]["digest"]:
            raise AssertionError("the ranks' gathered states differ")
        want_counts = {"K1": 0, "K1_obstacle": 0, "K2": SHARD_UPDATES,
                       "K3": SHARD_UPDATES, "K4": SHARD_UPDATES, "EIG": 0,
                       "ICP": SHARD_UPDATES, "EKF": 0}
        for rk in ranks:
            if rk["launches"] != want_counts:
                raise AssertionError(f"launches {rk['launches']}, expected "
                                     f"{want_counts} per rank")
            if not rk["dists_are_edt"]:
                raise AssertionError("fields are not K4 of the grids")

        # The unsharded filter on the same course and the same draws.
        u, scans, odoms, prevs = r.course_inputs()
        st = r.pf.pf_init(r.cfg, seed=0, device=r.dev)
        events = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(SHARD_UPDATES):
            start = st.poses
            st = r.pf.pf_slam_step(r.cfg, st, scans[i], u, odoms[i],
                                   prevs[i])
            events += int((st.prev_poses != start).any())
        one_ms = 1e3 * (time.perf_counter() - t1) / SHARD_UPDATES
        diffs = {}
        for name, bar in (("poses", 1e-4), ("log_weights", 1e-3),
                          ("grids", 1e-3)):
            d = float(np.abs(ranks[0][name] -
                             getattr(st, name).cpu().numpy()).max())
            diffs[name] = d
            if not d <= bar:
                raise AssertionError(f"sharded vs unsharded {name}: {d} > "
                                     f"{bar}")
        if ranks[0]["events"] != events:
            raise AssertionError(f"resampling events {ranks[0]['events']} "
                                 f"sharded, {events} unsharded")

        a, b = rbpf_two_process.launcher("cuda", "gloo", timeout=300)
        self.launches["K1"]["sharded_rbpf_2ranks"] = [
            rk["launches"]["K1"] for rk in ranks]
        self.launches["K1_obstacle"]["sharded_rbpf_2ranks"] = [
            rk["launches"]["K1_obstacle"] for rk in ranks]
        self.launches.update({key: {
            "sharded_rbpf_2ranks": [rk["launches"][key] for rk in ranks],
            "rbpf_two_process_2ranks": [x["launches"][i] for x in (a, b)]}
            for i, key in enumerate(("K2", "K3", "K4"))})
        self.launches["ICP"] = {"sharded_rbpf_2ranks": [
            rk["launches"]["ICP"] for rk in ranks]}
        emit("sharded_rbpf", seconds=time.perf_counter() - t0, card=r.card,
             P=r.P, per_rank=r.P // 2, k=r.K,
             map=[r.g80.height, r.g80.width], beams=r.g80.num_beams,
             updates=SHARD_UPDATES, max_abs_diff=diffs,
             bars={"poses": 1e-4, "log_weights": 1e-3, "grids": 1e-3},
             resampling_events={"sharded": ranks[0]["events"],
                                "unsharded": events},
             launches_per_rank=[rk["launches"] for rk in ranks],
             ms_per_update_per_rank=[rk["ms_per_update"] for rk in ranks],
             ms_per_update_unsharded=one_ms,
             exchange_ms_per_update=[rk["exchange_ms"] for rk in ranks],
             exchange_mb=ranks[0]["exchange_mb"],
             fields_are_k4_of_grids=True, ranks_bit_identical=True,
             forced_resample={"clones": a["clones"],
                              "particles": rbpf_two_process.P_TOTAL,
                              "ranks_bit_identical": True,
                              "launches_per_rank": [a["launches"],
                                                    b["launches"]]},
             note="two ranks share one card through gloo's host staging: "
                  "no rate here is a scaling number")


    def graph(self):
        """``graph_sharded``: the graphed sharded steppers in one NCCL rank
        (:func:`_shard_graph_rank`), each the eager sharded path's bits,
        one replay per solve or update, with one K1 (partials) launch per
        fused solve and one K2, K3 and K4 per update; and, from
        ``sharded_mppi``, that each raises on two gloo ranks."""
        from examples_torch import launch

        t0 = time.perf_counter()
        (a,) = launch(_shard_graph_rank, (SHARD_SOLVES, SHARD_UPDATES),
                      world=1, device="cuda", backend="nccl", timeout=600)
        fused, plain, rb = a["fused"], a["plain"], a["rbpf"]
        none = {"K1": 0, "K1_obstacle": 0, "K2": 0, "K3": 0, "K4": 0,
                "EIG": 0, "ICP": 0, "EKF": 0}
        want = {"fused": dict(none, K1=SHARD_SOLVES),
                "rbpf": dict(none, K2=SHARD_UPDATES, K3=SHARD_UPDATES,
                             K4=SHARD_UPDATES, ICP=SHARD_UPDATES)}
        if fused["launches"] != want["fused"] or not fused["eager_bits"]:
            raise AssertionError(f"graph_sharded (a): {fused}")
        if not fused["max_ulps_vs_mppi_solve_fused"] <= 2.0:
            raise AssertionError(f"graph_sharded (a): "
                                 f"{fused['max_ulps_vs_mppi_solve_fused']} "
                                 "ulps from mppi_solve_fused")
        if fused["seed_after"] != 7 + SHARD_SOLVES:
            raise AssertionError(f"graph_sharded (a): seed {fused}")
        if not all(plain["eager_bits"]):
            raise AssertionError(f"graph_sharded (b): {plain}")
        if (rb["launches"] != want["rbpf"] or not all(
                rb["eager_bits"].values()) or not rb["dists_are_k4_of_grids"]):
            raise AssertionError(f"graph_sharded (c): {rb}")
        for key in ("K1", "K2", "K3", "K4", "ICP"):
            self.launches.setdefault(key, {})[
                "graph_sharded_nccl_1rank"] = [
                    (fused if key == "K1" else rb)["launches"][key]]
        emit("graph_sharded", seconds=time.perf_counter() - t0,
             card=self.s.card, backend=a["backend"], ranks=a["ranks"],
             fused_chain=fused, plain_solve=plain, rbpf_config5=rb,
             gloo_two_ranks_raise=self.refused,
             note="one NCCL rank owns the card: no scaling number")


# Steps of the EKF demos' courses held bit for bit against the masked
# update run eagerly, and against the dynamic form at the float32 bars.
DEMO_EKF_PREFIX = 100
SEED_BATCH = 20             # the sweeps' seeds (make_results.N_SEEDS)
SEED_BATCH_PREFIX = 1020    # config 4's ticks compared with serial courses


class Demos:
    """The closed-loop demos (``examples_torch/``) on the card, each loop
    one CUDA-graph replay per scan or step (the demos' defaults), each held
    first to its eager form over a prefix: the RBPF exploration under K1
    with its checkpoint and resume (BASELINE config 5), the full stack
    (RBPF map → D* Lite → K1: all four kernels in one loop), the RBPF
    course, the lidar EKF courses and the EKF demo's arc, and the
    exploration loop's per-scan budget (eager). Each phase's launches are
    counted from 0 over its run; a replay adds its graph's launches."""

    def __init__(self, smoke: Smoke):
        self.s, self.dev, self.card = smoke, smoke.dev, smoke.card
        self.launches = {}

    def counted(self, name, fn):
        """``fn()`` with every launch count set to 0 before it; keeps the
        counts under ``name``."""
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        self.launches[name] = read_counts()
        return out

    @staticmethod
    def window(step, per_scan: int = 1) -> dict:
        """A replayed window of a warmed, captured ``step``: µs per step by
        the host's clock over 10, :func:`graph_window` over 5 (device µs,
        operations, host API calls and ``cudaGraphLaunch`` per step, idle
        share) and the host syncs per step over 5."""
        step_us = wall_us(step, 10, warmup=2)
        return {"us_per_step": step_us,
                "graph": graph_window(step, 5, per_scan, step_us),
                "host_syncs_per_step": syncs_per_call(step, 5)}

    def explore(self):
        """examples_torch.rbpf_explore_demo.run_experiment at P=500,
        K=2,048, 80×80, 360 beams, six K1 solves per scan, 20 scans per
        chunk, through ``ScanGraph`` (one replay per scan): a warm-up
        chunk, a timed one, the checkpoint, the chunk after it from memory
        and from disk (loaded into the graph's buffers), four timed chunks.
        First the eager interval's first chunk: its digests (poses,
        log-weights, grids, u) and its 20 samples must equal the graph's
        bit for bit. Gates: SLAM |xy| < 0.25 m (the demo's) and below
        odometry's; per scan 6 K1, 1 K2 and 1 K3 launches, one K4 per
        pf_init; the resumed chunk's digests equal the in-memory chunk's.
        Then a replayed window of a second runner."""
        from examples_torch import rbpf_explore_demo as ex

        t0 = time.perf_counter()
        pf_cfg, mppi_cfg, eager = ex.build(device=self.dev, eager=True)
        series = []
        t_eager = time.perf_counter()
        first = eager(ex.init_state(pf_cfg, mppi_cfg, device=self.dev),
                      series)
        torch.cuda.synchronize()
        eager_ms = 1e3 * (time.perf_counter() - t_eager) / len(series)
        want_digests = ex.digests(first)
        want_series = torch.stack(series).cpu().numpy()

        r = self.counted("explore", lambda: ex.run_experiment(
            device=self.dev))
        counts = self.launches["explore"]
        same = {"digests": r["first_chunk_digests"] == want_digests,
                "series": bool(np.array_equal(r["series"][:len(series)],
                                              want_series))}
        if not all(same.values()):
            raise AssertionError(f"explore: the graph left the eager "
                                 f"interval's first chunk: {same}")
        slam_xy = float(np.hypot(*r["slam_err"][1:]))
        odo_xy = float(np.hypot(*r["odom_err"][1:]))
        if not (slam_xy < 0.25 and slam_xy < odo_xy):
            raise AssertionError(f"explore: SLAM |xy| {slam_xy} m, odometry "
                                 f"{odo_xy} m")
        scans = r["scans_run"]
        want = {"K1": ex.TICKS_PER_SCAN * scans, "K2": scans, "K3": scans,
                "K4": r["pf_inits"], "K1_obstacle": 0, "EIG": 0, "ICP": scans,
                "EKF": 0}
        if counts != want:
            raise AssertionError(f"explore: launches {counts}, expected "
                                 f"{want} for {scans} scans")
        if not r["resume_bit_equal"]:
            raise AssertionError(f"explore: the resumed chunk left the "
                                 f"saved one: {r['resume_digests']}")
        runner = ex.ScanGraph(pf_cfg, mppi_cfg, ex.init_state(
            pf_cfg, mppi_cfg, device=self.dev), self.dev)
        window = self.window(runner.step)
        emit("explore", seconds=time.perf_counter() - t0, P=r["num_particles"],
             K=r["mppi_rollouts"], N=50, solves_per_scan=ex.TICKS_PER_SCAN,
             scans=r["n_scans"], scans_run=scans,
             graph_equals_eager_first_chunk=same,
             eager_ms_per_scan_first_chunk=eager_ms,
             slam_err_theta_x_y=r["slam_err"].tolist(), slam_xy_error_m=slam_xy,
             odometry_err_theta_x_y=r["odom_err"].tolist(),
             odometry_xy_error_m=odo_xy, occupied_cells=r["occupied_cells"],
             updates_per_s_best=r["updates_per_sec"],
             updates_per_s_median=r["updates_per_sec_median"],
             ms_per_scan_best=1e3 / r["updates_per_sec"],
             solves_per_s_best=ex.TICKS_PER_SCAN * r["updates_per_sec"],
             chunk_seconds=r["chunk_seconds"],
             checkpoint_mb=r["checkpoint_mb"], resume_bit_equal=True,
             resume_digest=r["resume_digests"]["resumed"]["grids"][:16],
             kernel_launches=counts, replayed_window=window, card=self.card)

    def full_stack(self):
        """examples_torch.full_stack_demo.run(seed=5) at P=500, K1 at
        K=2,048, 12 solves per scan, one ``ScanGraph`` replay and one host
        copy per scan. First 30 scans eagerly and through the graph: every
        pose of both trails, every D* target and the final grid's digest
        must be equal. Gates: the goal reached, final error < 0.3 m (the
        demo's); per scan 12 K1, 1 K2 and 1 K3 launches, one K4 in
        pf_init; finite outputs. Reports ms per scan (the replay on the
        device's clock, D* on the host's, the whole scan), D*'s share, the
        host syncs per scan over the run, and a replayed window of the
        scan's device part (target in, replay, copy out)."""
        from examples_torch import full_stack_demo as fs

        t0 = time.perf_counter()
        prefix = [fs.run(seed=5, max_scans=30, verbose=False,
                         device=self.dev, eager=eager)
                  for eager in (True, False)]
        same = {key: bool(np.array_equal(prefix[0][key], prefix[1][key]))
                for key in ("trail_true", "trail_slam", "targets")}
        same["grid_digest"] = (hashlib.sha256(prefix[0]["grid"].tobytes())
                               .hexdigest() == hashlib.sha256(
                                   prefix[1]["grid"].tobytes()).hexdigest())
        if not all(same.values()) or prefix[1]["updates"] != 30:
            raise AssertionError(f"full stack: the graph left the eager "
                                 f"loop in the first 30 scans: {same}")
        box = []
        syncs = self.counted("full_stack", lambda: syncs_per_call(
            lambda: box.append(fs.run(seed=5, verbose=False,
                                      device=self.dev)), 1))
        out = box[0]
        counts = self.launches["full_stack"]
        n = out["updates"]
        finite = all(np.isfinite(out[k]).all() for k in
                     ("trail_true", "trail_slam", "grid", "stream"))
        if not (out["reached"] and out["final_goal_err_m"] < 0.3 and finite):
            raise AssertionError(
                f"full stack: reached {out['reached']} in {out['scans']} "
                f"scans, goal error {out['final_goal_err_m']} m, finite "
                f"{finite}")
        want = {"K1": 12 * n, "K2": n, "K3": n, "K4": 1, "K1_obstacle": 0,
                "EIG": 0, "ICP": n, "EKF": 0}
        if counts != want:
            raise AssertionError(f"full stack: launches {counts}, expected "
                                 f"{want} for {n} scan updates")
        stages = fs.Stages(device=self.dev)
        pose0 = torch.tensor([0.8, *fs.START_XY]).to(self.dev)
        runner = fs.ScanGraph(
            stages, fs.pf_init(stages.pf_cfg, pose=pose0, seed=5,
                               device=self.dev), pose0,
            fs.init_controls(stages.mppi_cfg, device=self.dev), self.dev)
        window = self.window(lambda: runner.scan(fs.GOAL_XY))
        ms = out["ms_per_scan"]
        emit("full_stack", seconds=time.perf_counter() - t0, P=500,
             K=out["rollouts"], N=50, solves_per_scan=12, seed=5,
             graph_equals_eager_30_scans=same,
             eager_ms_per_scan_30_scans=prefix[0]["ms_per_scan"],
             reached=True, scans=out["scans"], updates=n,
             wall_s=out["wall_s"], final_goal_error_m=out["final_goal_err_m"],
             slam_vs_true_m=out["slam_vs_true_m"],
             ms_per_scan=ms, dstar_share=ms["dstar_host"] / ms["whole"],
             host_syncs=syncs, host_syncs_per_scan=syncs / n,
             kernel_launches=counts, replayed_window=window,
             card=self.card)

    def rbpf_course(self):
        """examples_torch.rbpf_slam_demo's course (P=40, 80×80 at 0.05 m,
        360 beams, filter seed 2): its 120 updates eagerly and through
        ``PFStepper`` (one replay each), the final state and generator bit
        for bit. Gates: the best particle within 0.2 m of the truth (the
        demo's); one K3 per update and K2's launches per update (two on its
        two-pass path, which P=40 takes below the card's SM count), one K4
        in pf_init. Then a replayed window of the stepper. Phase
        ``rbpf_demo_course`` (``rbpf_course`` is config 5's)."""
        from examples_torch import rbpf_slam_demo as rs
        from tpunav_torch.estimation.rbpf import particle_filter as pf

        t0 = time.perf_counter()
        cfg = rs.config()
        inputs = rs.course_inputs(cfg.grid, device=self.dev)
        n = len(inputs[1])
        walls = {}
        states = {}
        for name, eager in (("eager", True), ("graph", False)):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            states[name] = self.counted(f"rbpf_demo_{name}", lambda: (
                rs.course(cfg, inputs, device=self.dev, eager=eager)))
            walls[name] = time.perf_counter() - t1
        st = states["graph"]
        same = same_bits(st, states["eager"], pf.PFState._fields[:-1])
        same["generator"] = bool(torch.equal(
            st.generator.get_state(), states["eager"].generator.get_state()))
        counts = self.launches.pop("rbpf_demo_graph")
        self.launches["rbpf_demo_course"] = counts
        self.launches.pop("rbpf_demo_eager")
        e = (pf.best_particle(st)[0] - inputs[2][-1]).cpu()
        err = float(torch.hypot(e[1], e[2]))
        from tpunav_torch.ops import likelihood

        g = cfg.grid                    # K2 in two launches below the SMs
        path, per_update, _ = likelihood._plan(
            cfg.num_particles, cfg.k_samples + 1, g.height, g.width,
            g.num_beams, torch.cuda.get_device_properties(
                self.dev).multi_processor_count, smem_limit())
        want = {"K1": 0, "K1_obstacle": 0, "K2": per_update * n, "K3": n,
                "K4": 1, "EIG": 0, "ICP": n, "EKF": 0}
        if not all(same.values()) or counts != want or not err < 0.2:
            raise AssertionError(f"RBPF course: graph vs eager {same}, "
                                 f"launches {counts} (want {want}), pose "
                                 f"error {err} m")
        stepper = pf.PFStepper(cfg, pf.pf_init(cfg, seed=2,
                                               device=self.dev), self.dev)
        k = [0]

        def update():
            i = k[0] % n
            stepper.step(inputs[1][i], inputs[0], inputs[2][i],
                         inputs[3][i])
            k[0] += 1

        emit("rbpf_demo_course", seconds=time.perf_counter() - t0, P=40,
             updates=n, k2_path=path, bit_identical=same,
             pose_error_m=err,
             eager_ms_per_update=1e3 * walls["eager"] / n,
             graph_ms_per_update_with_capture=1e3 * walls["graph"] / n,
             kernel_launches=counts, replayed_window=self.window(update),
             card=self.card)

    def ekf_demo_case(self, tag, step, cfg, known, steps, make, graph,
                      least):
        """One EKF demo course: ``make(step_fn, steps, eager)`` → a course
        ``seed → (true_pose, odom, state, ...)``. The graph over
        DEMO_EKF_PREFIX steps against the masked update run eagerly (bit
        for bit, a gate) and the dynamic form (pose 1e-5, landmarks 1e-4,
        the same count: a gate); then the whole course through the graph
        (the gates: SLAM |xy| below odometry's, ``least`` landmarks), timed
        again from seed 1 without its capture, and a replayed window of
        ``graph``'s step. The eager prefixes' ms per step are reported."""
        from tpunav_torch.estimation.ekf import filter as ekff

        masked = (ekff.known_correspondence_slam_masked if known
                  else ekff.slam_unknown_da_masked)
        got = make(step, DEMO_EKF_PREFIX, False)(0)
        eager_ms = {}

        def eager(fn, name):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = make(fn, DEMO_EKF_PREFIX, True)(0)
            torch.cuda.synchronize()
            eager_ms[name] = (1e3 * (time.perf_counter() - t1)
                              / DEMO_EKF_PREFIX)
            return out

        ref, dyn = eager(masked, "masked"), eager(step, "dynamic")
        flat = lambda r: [*r[:2], *r[2], *r[3:]]  # noqa: E731
        bits = all(torch.equal(a, b) for a, b in zip(flat(got), flat(ref)))
        active = dyn[2].active.cpu()
        near = {"pose": float((got[0] - dyn[0]).abs().max()),
                "filter_pose": float((got[2].state[:3]
                                      - dyn[2].state[:3]).abs().max()),
                "landmarks": float((got[2].state[3:].view(-1, 2)
                                    - dyn[2].state[3:].view(-1, 2)
                                    ).abs().cpu()[active].max()),
                "count": [int(got[2].count), int(dyn[2].count)],
                "same_bits": all(torch.equal(a, b) for a, b in
                                 zip(flat(got), flat(dyn)))}
        near_ok = (near["pose"] <= 1e-5 and near["filter_pose"] <= 1e-5
                   and near["landmarks"] <= 1e-4
                   and near["count"][0] == near["count"][1]
                   and torch.equal(got[2].active, dyn[2].active))
        course = make(step, steps, False)
        out = self.counted(tag, lambda: course(0))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        course(1)
        torch.cuda.synchronize()
        steady_ms = 1e3 * (time.perf_counter() - t1) / steps
        true_pose, odom, st = out[:3]
        slam_xy = float(torch.hypot(*(st.state[1:3] - true_pose[1:])))
        odo_xy = float(torch.hypot(*(odom[1:3] - true_pose[1:])))
        n_lm = int(st.count)
        if not (bits and near_ok and slam_xy < odo_xy and n_lm >= least):
            raise AssertionError(
                f"{tag}: graph vs eager masked bits {bits}, vs dynamic "
                f"{near}; SLAM |xy| {slam_xy} m, odometry {odo_xy} m, "
                f"{n_lm} landmarks (need {least})")
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(2)
        return {"graph_equals_eager_masked": bits,
                "prefix_steps": DEMO_EKF_PREFIX, "vs_dynamic": near,
                "slam_err_theta_x_y": (st.state[:3] - true_pose).tolist(),
                "slam_xy_error_m": slam_xy, "odometry_xy_error_m": odo_xy,
                "landmarks_tracked": n_lm, "slots": cfg.num_landmarks,
                "steps": steps, "graph_ms_per_step": steady_ms,
                "eager_ms_per_step": eager_ms,
                "steps_per_s": 1e3 / steady_ms,
                "kernel_launches": self.launches[tag],
                "replayed_window": self.window(lambda: graph.step(gen))}

    def lidar_ekf(self, steps=400):
        """examples_torch.lidar_ekf_slam_demo's courses, known and unknown
        DA, 400 steps, seed 0, one ``StepGraph`` replay per step (the
        detector's two eigensolver launches and the masked update over its
        16 rows, the oracle's 12 for known DA) — each held first to the
        eager masked and dynamic forms (``ekf_demo_case``). Gates: SLAM
        |xy| below odometry's; 12 of 12 landmarks for known DA, at least
        10 for unknown DA (tpunav records 11.0 ± 0.0, RESULTS.md); two
        eigensolver launches per step."""
        from examples_torch import lidar_ekf_slam_demo as le

        t0 = time.perf_counter()
        rows = {}
        for tag, (step, known, cfg) in le.CONFIGS.items():
            def make(fn, n, eager):
                return le.make_sim(fn, cfg, known, n, self.dev, eager)

            rows[tag] = self.ekf_demo_case(
                f"lidar_ekf_{tag}", step, cfg, known, steps, make,
                le.make_graph(step, cfg, known, self.dev), 12 if known else 10)
            eig = rows[tag]["kernel_launches"]["EIG"]
            if eig != 2 * steps:
                raise AssertionError(f"lidar EKF ({tag} DA): {eig} "
                                     f"eigensolver launches in {steps} steps")
        emit("lidar_ekf", seconds=time.perf_counter() - t0, card=self.card,
             **rows)

    def ekf_demo(self, steps=400):
        """examples_torch.ekf_slam_demo's arc, known DA (12 slots) and
        unknown DA (capacity 20), 400 steps, seed 0, one ``StepGraph``
        replay per step with the landmark sensor's 12 rows — each held
        first to the eager masked and dynamic forms (``ekf_demo_case``).
        Gates: SLAM |xy| below odometry's; 12 of 12 landmarks for known
        DA, at least 10 for unknown DA."""
        from examples_torch import ekf_slam_demo as ek

        t0 = time.perf_counter()
        rows = {}
        for name, (step, cfg) in ek.CONFIGS.items():
            known = name.startswith("known")
            tag = "known" if known else "unknown"

            def make(fn, n, eager):
                return ek.make_course(fn, cfg, n, self.dev, eager)

            rows[tag] = self.ekf_demo_case(
                f"ekf_demo_{tag}", step, cfg, known, steps, make,
                ek.make_graph(step, cfg, self.dev), 12 if known else 10)
        emit("ekf_demo", seconds=time.perf_counter() - t0, card=self.card,
             **rows)

    def rbpf_stages(self):
        """examples_torch.profile_rbpf_stages on its replayed stages, as
        ``tpunav`` jits each: the exploration loop's ms per scan by stage
        from event marks between the three chained graphs over 5 scans,
        their sum beside the demo's one ``ScanGraph`` replay per scan over
        5 more (the profiler's cost grows with the scans it records), with
        launches and host syncs per chained scan; and each stage of one
        config-5 update as its own graph, the whole update a
        ``PFStepper`` replay."""
        from examples_torch import profile_rbpf_stages as prof

        t0 = time.perf_counter()
        loop = self.counted("rbpf_stages", lambda: prof.profile_closed_loop(
            reps=5, device=self.dev))
        stages = prof.stage_times(reps=5, device=self.dev)
        emit("rbpf_stages", seconds=time.perf_counter() - t0, P=500, K=2048,
             closed_loop_per_scan=loop, update_stages_ms=stages,
             kernel_launches=self.launches["rbpf_stages"], card=self.card)

    def seed_batch(self):
        """The seed sweeps as one program (``tpunav``'s ``jax.vmap`` of a
        course over seeds): K1 with its problem axis, then config 4 and the
        lidar EKF over SEED_BATCH seeds, each tick or step one graph replay
        for every seed. Gates: batched K1 equal to its single launches bit
        for bit and within BAR of its plain version (``gate_rows``); one K1
        launch per config-4 tick and two eigensolver launches per sensing
        tick or lidar step, whatever the batch; every seed at its serial
        course's bars; seeds 0 and SEED_BATCH - 1 equal to their serial
        courses over the compared prefix (config 4's SEED_BATCH_PREFIX
        ticks, the lidar's whole course) — where they part, the first tick
        and the largest gap are reported, and the phase raises; device
        operations per tick at B=SEED_BATCH at most 1.1 × those at B=1."""
        t0 = time.perf_counter()
        k1 = self.seed_batch_k1()
        c4 = self.seed_batch_dense()
        lidar = {tag: self.seed_batch_lidar(tag) for tag in ("known",
                                                             "unknown")}
        self.seed_k1 = k1
        emit("seed_batch", seconds=time.perf_counter() - t0, B=SEED_BATCH,
             card=self.card, k1=k1, config4=c4, lidar_ekf=lidar)

    def seed_batch_k1(self):
        """K1 over B problems in one launch at config 4's shape (B=20,
        K=2,048, N=8) and at (B=4, K=4,096, N=50), on in-kernel Philox with
        distinct controls, poses and goals, once with one seed for all
        problems (config 4 seeds every solve ``fused_seed + ticks``) and
        once with a seed per problem: the batched launch against each
        problem's single launch (bits) and its plain version (BAR); event
        ms of the batched launch, of the B single launches and of the plain
        version, device µs, and the bound of B solves."""
        from examples_torch import dense_world_slam_demo as demo

        s, fm, dev = self.s, self.s.fm, self.dev
        rows = []
        for b, cfg in ((SEED_BATCH, demo.configs(2048)[0]),
                       (4, s.cfg(4096))):
            k, n = cfg.rollouts, cfg.steps
            rng = np.random.default_rng(1000 * b + k)
            f32 = lambda a: torch.from_numpy(  # noqa: E731
                np.asarray(a, dtype=np.float32)).to(dev)
            u = f32(rng.uniform(-1.0, 1.0, (b, n, 2)))
            pose = f32(rng.uniform(-0.5, 0.5, (b, 3)))
            xd = f32(rng.uniform(-1.5, 1.5, (b, 3)))
            sig = (float(cfg.ul_var) ** 0.5, float(cfg.ur_var) ** 0.5)
            case = {"B": b, "K": k, "N": n, "blocks": b * -(-k // 32)}
            for mode, seeds in (
                    ("one_seed", torch.full((b,), 17, dtype=torch.int32,
                                            device=dev)),
                    ("seed_per_problem", torch.arange(
                        100, 100 + b, dtype=torch.int32, device=dev))):
                reset_counts()
                got = fm.mppi_solve_fused_batch(cfg, s.model, u, seeds, pose,
                                                xd)
                launched = read_counts()["K1"]
                single = torch.stack([fm._solve_update(
                    cfg, s.model, u[i], seeds[i], pose[i], xd[i])
                    for i in range(b)])
                bits = bool(torch.equal(got, single))
                errs = []
                for i in range(b):
                    plain = fm._combine_reference(
                        cfg, u[i], fm._solve_partials_reference(
                            cfg, s.model, u[i], seeds[i], pose[i], xd[i]),
                        False)
                    noise = s.philox.mppi_noise(seeds[i], k, n, *sig)
                    errs.append(gate_rows(
                        s.mppi, cfg, s.model, got[i], plain, u[i], pose[i],
                        xd[i], noise, None,
                        f"batched K1 (B={b}, K={k}, N={n}) problem {i}"))
                if not bits or launched != 1:
                    raise AssertionError(
                        f"batched K1 (B={b}, K={k}, N={n}, {mode}): equal "
                        f"to the single launches {bits}, {launched} "
                        "launches")
                case[mode] = {
                    "equals_single_launches": bits, "launches": launched,
                    "max_abs_err": max(e[0] for e in errs),
                    "exempt_rows": sum(e[1] for e in errs),
                    "max_abs_err_all_rows": max(e[2] for e in errs)}
                self.s.max_err = max(self.s.max_err, case[mode]["max_abs_err"])

            def batched():
                fm.mppi_solve_fused_batch(cfg, s.model, u, seeds, pose, xd)

            def singles():
                for i in range(b):
                    fm._solve_update(cfg, s.model, u[i], seeds[i], pose[i],
                                     xd[i])

            def plain():
                for i in range(b):
                    fm._combine_reference(
                        cfg, u[i], fm._solve_partials_reference(
                            cfg, s.model, u[i], seeds[i], pose[i], xd[i]),
                        False)

            nbytes, ops = k1_work(k, n)
            bound_ms, bound_by = bound(b * nbytes, b * ops)
            dev_us = device_us(batched, ("mppi_rollout_partials",
                                         "mppi_combine"), 10)
            case.update(
                ms=time_ms(batched), single_launches_ms=time_ms(singles),
                plain_ms=time_ms(plain, reps=3, warmup=1),
                device_us=(None if None in dev_us.values()
                           else sum(dev_us.values())),
                device_us_by_kernel=dev_us, bound_ms=bound_ms,
                bound_by=bound_by)
            rows.append(case)
        return rows

    def seed_batch_dense(self, ticks=5000):
        """Config 4 (``examples_torch.dense_world_slam_demo``) over seeds 0
        … SEED_BATCH - 1 through ``run_slam_course`` on a seed batch:
        ``ticks`` ticks with the demo's telemetry, run as SEED_BATCH_PREFIX
        ticks and then the rest from that state; every seed at config 4's bars (SLAM |xy|
        < 0.5 × odometry's, 36-50 landmarks, a finite filter), one K1
        launch per tick and two eigensolver launches per sensing tick; the
        batch after the prefix against seeds 0 and SEED_BATCH - 1 run alone
        (the demo's ``course``: state, telemetry rows, generator); and a
        replayed window of 4-tick chunks (one sensing tick, a 60-tick
        chunk's mix) at B=1 and B=SEED_BATCH: µs, device µs and operations,
        host API calls and idle share per tick."""
        from examples_torch import dense_world_slam_demo as demo
        from tpunav_torch.control import slam_loop as sl

        seeds, prefix = list(range(SEED_BATCH)), SEED_BATCH_PREFIX
        course, (mppi, ekf, loop), ring, world, meas_fn = demo.build(
            prefix, device=self.dev)
        start = [1.42, 0.0, math.pi / 2]
        sensing = lambda n: 2 * -(-n // loop.sensor_every)  # noqa: E731

        def run(st, n):
            return sl.run_slam_course(
                mppi, ekf, loop, demo.MODEL, ring, world, st, n,
                meas_fn=meas_fn, meas_shape=(360,),
                telemetry=demo.telemetry_row)

        def both():
            st, tel = run(sl.slam_batch_init(mppi, ekf, seeds, start,
                                             device=self.dev), prefix)
            kept = (sl.seed_state(st, 0), sl.seed_state(st, SEED_BATCH - 1))
            kept = [(s._replace(**{f: getattr(s, f).clone() for f in (
                "true_pose", "odom", "u", "wpt_idx", "visits", "ticks",
                "done")}, ekf=type(s.ekf)(*(t.clone() for t in s.ekf))),
                s.generator.get_state(), t.clone())
                for s, t in zip(kept, (tel[0], tel[SEED_BATCH - 1]))]
            return run(st, ticks - prefix)[0], kept

        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st, kept = self.counted("seed_batch_config4", both)
        wall = time.perf_counter() - t1
        parts = {"course": wall}
        counts = self.launches["seed_batch_config4"]
        per_seed = []
        for i in seeds:
            e_s, e_o = (e.cpu().numpy() for e in demo.errors(
                sl.seed_state(st, i)))
            slam_xy = float(np.hypot(*e_s[1:]))
            odo_xy = float(np.hypot(*e_o[1:]))
            n_lm = int(st.ekf.count[i])
            finite = all(bool(torch.isfinite(x[i]).all()) for x in (
                st.ekf.state, st.ekf.cov, st.true_pose))
            per_seed.append({"seed": i, "slam_xy_error_m": slam_xy,
                             "odometry_xy_error_m": odo_xy,
                             "landmarks_tracked": n_lm, "finite": finite})
            if not (finite and slam_xy < 0.5 * odo_xy and 36 <= n_lm <= 50):
                raise AssertionError(f"config 4 batched, seed {i}: "
                                     f"{per_seed[-1]}")
        if counts["K1"] != ticks or counts["EIG"] != sensing(ticks) or \
                counts["EKF"] != ticks:
            raise AssertionError(f"config 4 batched: launches {counts} for "
                                 f"{ticks} ticks")
        t1 = time.perf_counter()
        compared = {}
        for i, (got, gen, tel) in zip((0, SEED_BATCH - 1), kept):
            one = course(i)
            compared[str(i)] = seed_diff(got, one["state"], tel,
                                         one["tel_t"])
            compared[str(i)]["fields"]["generator"] = bool(torch.equal(
                gen, one["state"].generator.get_state()))
            compared[str(i)]["equal"] = all(
                compared[str(i)]["fields"].values())
        if not all(c["equal"] for c in compared.values()):
            raise AssertionError(f"config 4 batched vs serial: {compared}")
        parts["serial_prefixes"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        windows = {}
        chunk = loop.sensor_every
        for b in (1, SEED_BATCH):
            window = sl._Chunks(mppi, ekf, loop, demo.MODEL, ring, world,
                                sl.slam_batch_init(mppi, ekf, seeds[:b],
                                                   start, device=self.dev),
                                chunk, None, meas_fn, (360,),
                                demo.telemetry_row)
            window.run()                        # the warm-up
            window.run()                        # the capture
            chunk_us = wall_us(window.run, 15, warmup=0)
            windows[f"B={b}"] = graph_window(window.run, 3, chunk, chunk_us)
        parts["windows"] = time.perf_counter() - t1
        ops = {k: v["device_ops"] for k, v in windows.items()}
        if ops[f"B={SEED_BATCH}"] > 1.1 * ops["B=1"]:
            raise AssertionError(f"config 4: device operations per tick "
                                 f"{ops}")
        return {"ticks": ticks, "K": mppi.rollouts, "N": mppi.steps,
                "capacity": ekf.num_landmarks, "seconds": wall,
                "us_per_tick_all_seeds": 1e6 * wall / ticks,
                "kernel_launches": counts, "seeds": per_seed,
                "serial_prefix_ticks": prefix,
                "batch_vs_serial": compared, "replayed_window": windows,
                "part_seconds": parts}

    def seed_batch_lidar(self, tag, steps=400):
        """The lidar EKF course (``examples_torch.lidar_ekf_slam_demo``,
        ``tag`` DA) over seeds 0 … SEED_BATCH - 1 through
        ``make_sim_batch``: every seed at the course's bars (SLAM |xy|
        below odometry's; 12/12 landmarks known, at least 10 unknown), two
        eigensolver launches per step, seeds 0 and SEED_BATCH - 1 against
        their serial courses (``make_sim``) over all ``steps``; a replayed
        window of the batch's steps (one seed's: ``lidar_ekf``)."""
        from examples_torch import lidar_ekf_slam_demo as le

        step, known, cfg = le.CONFIGS[tag]
        seeds = list(range(SEED_BATCH))
        sim = le.make_sim_batch(step, cfg, known, SEED_BATCH, steps,
                                self.dev)
        key = f"seed_batch_lidar_{tag}"
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        true_pose, odom, st, tel = self.counted(key, lambda: sim(seeds))
        wall = time.perf_counter() - t1
        counts = self.launches[key]
        least = 12 if known else 10
        per_seed = []
        for i in seeds:
            slam_xy = float(torch.hypot(*(st.state[i, 1:3]
                                          - true_pose[i, 1:])))
            odo_xy = float(torch.hypot(*(odom[i, 1:3] - true_pose[i, 1:])))
            n_lm = int(st.count[i])
            per_seed.append({"seed": i, "slam_xy_error_m": slam_xy,
                             "odometry_xy_error_m": odo_xy,
                             "landmarks_tracked": n_lm})
            if not (slam_xy < odo_xy and n_lm >= least):
                raise AssertionError(f"lidar EKF ({tag} DA) batched, seed "
                                     f"{i}: {per_seed[-1]}")
        if counts["EIG"] != 2 * steps or counts["K1"] or \
                counts["EKF"] != steps:
            raise AssertionError(f"lidar EKF ({tag} DA) batched: launches "
                                 f"{counts} in {steps} steps")
        serial = le.make_sim(step, cfg, known, steps, self.dev)
        compared = {}
        for i in (0, SEED_BATCH - 1):
            one = serial(i)
            got = (true_pose[i], odom[i], *(t[i] for t in st))
            want = (one[0], one[1], *one[2])
            diff = {"equal": all(torch.equal(a, b)
                                 for a, b in zip(got, want))
                    and bool(torch.equal(tel[i], one[3]))}
            diff.update(tel_diff(tel[i], one[3]))
            compared[str(i)] = diff
        if not all(c["equal"] for c in compared.values()):
            raise AssertionError(f"lidar EKF ({tag} DA) batched vs serial: "
                                 f"{compared}")
        graph = le.make_graph(step, cfg, known, self.dev, SEED_BATCH)
        gens = tuple(torch.Generator(device=self.dev).manual_seed(j)
                     for j in seeds)
        window = self.window(lambda: graph.step(gens))
        return {"steps": steps, "seconds": wall,
                "ms_per_step_all_seeds": 1e3 * wall / steps,
                "kernel_launches": counts, "seeds": per_seed,
                "batch_vs_serial": compared,
                "replayed_window": {f"B={SEED_BATCH}": window}}


# ── The loops as CUDA graphs: tpunav_torch/capture.py on the card ──

def trace_window(fn, reps: int):
    """torch.profiler over ``reps`` calls of ``fn``: ({device kernel or copy:
    (device µs, count)}, {host CUDA API call: count}, {kernel: launch
    counter's change}) over those calls, the window's closing synchronize
    left out. The window opens on 32 spin kernels, which are left out too:
    a window opened straight on a course chunk's replay came out 28 device
    records and one K1 launch short, while the profiler's warm-up step
    (``schedule``) inflated the device times 2–4×."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(32):
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        before = read_counts()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        after = read_counts()
    kern, api = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.self_device_time_total > 0 and "spin" not in e.key:
                kern[e.key] = (e.self_device_time_total, e.count)
        elif e.key.startswith("cu"):
            api[e.key] = e.count
    api["cudaLaunchKernel"] = api.get("cudaLaunchKernel", 32) - 32
    api["cudaDeviceSynchronize"] = api.get("cudaDeviceSynchronize", 2) - 2
    return (kern, {k: v for k, v in api.items() if v},
            {k: after[k] - before[k] for k in after})


# The launch counter of each kernel family, and the profiler tags of the
# kernels it counts (K1's combine kernel follows its partials one for one).
COUNTED = {"K1": "mppi_rollout_partials", "K2": "likelihood_",
           "K3": "map_update_kernel", "K4": "edt_kernel", "EIG": "sym_eig",
           "ICP": "icp_kernel", "EKF": "ekf_step_kernel"}


def eager_window(fn, reps: int):
    """``kernel_profile`` over ``reps`` eager calls of ``fn``, held against
    the launch counters: ({kernel: (device µs, count)}, held), where
    ``held`` gives each counted family's launches by the counters and by
    the profiler, the share of them the profiler recorded, and the families
    it missed some of (late in a process it drops records; PERF.md §6, PR
    11)."""
    before = read_counts()
    kern = kernel_profile(fn, reps)
    after = read_counts()
    counted = {key: after[key] - before[key] for key in COUNTED}
    profiled = {key: sum(c for name, (_, c) in kern.items() if tag in name)
                for key, tag in COUNTED.items()}
    launched = sum(counted.values())
    return kern, {
        "counters": counted, "profiler": profiled,
        "recorded_share": (sum(min(profiled[k], counted[k]) for k in counted)
                           / launched if launched else None),
        "missed": [k for k in counted if profiled[k] != counted[k]]}


def window_us(kern, held, reps: int):
    """Device µs per call over an :func:`eager_window`, or None (not
    measured) where the profiler missed launches of a counted family."""
    if held["missed"]:
        return None
    return sum(us for us, _ in kern.values()) / reps


def family_us(kern, held, key: str, reps: int):
    """One counted family's device µs per call over an
    :func:`eager_window`, or None where the profiler missed some of its
    launches."""
    if key in held["missed"]:
        return None
    return sum(us for name, (us, _) in kern.items()
               if COUNTED[key] in name) / reps


def graph_window(step, reps: int, per: int, step_us: float,
                 attempts: int = 3) -> dict:
    """A replayed window of ``reps`` steps of ``per`` ticks or updates each:
    device µs, device operations and host CUDA API calls per tick, the idle
    share against the unprofiled ``step_us``, the top kernels, and each
    kernel's count beside its launch counter's change, which must agree.
    A window that disagrees is reported and profiled again, up to
    ``attempts`` windows. Late in a process the profiler loses kernel
    records (on an H100, one K1 launch of a full-stack window in every
    window of a run); it never records a launch that did not happen. A
    counter moves by its step's launches at every step, so a counter at
    fault is off by a multiple of ``reps``: after ``attempts`` windows that
    disagree, the last is held if no family has more records than launches
    and none is ``reps`` or more records short, and its device µs, idle
    share and K1 µs per launch are null (not measured); otherwise it
    raises."""
    misses = []
    for _ in range(attempts):
        kern, api, counts = trace_window(step, reps)
        profiled = {key: sum(c for name, (_, c) in kern.items()
                             if tag in name)
                    for key, tag in COUNTED.items()}
        counted = {key: counts[key] for key in profiled}
        if profiled == counted:
            break
        misses.append({"counters": counted, "profiler": profiled,
                       "device_ops": sum(c for _, c in kern.values())})
    else:
        if not all(0 <= counted[k] - profiled[k] < reps for k in counted):
            raise AssertionError(f"launch counters against the profiler's "
                                 f"kernels in {attempts} windows: {misses}")
    missed = [key for key in COUNTED if profiled[key] != counted[key]]
    n = reps * per
    busy = None if missed else sum(us for us, _ in kern.values()) / n
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:6]
    k1_us = sum(us for name, (us, _) in kern.items() if "mppi_" in name)
    return {"per_window": reps, "ticks_or_updates": n,
            "device_us": busy, "device_ops": sum(c for _, c in
                                                 kern.values()) / n,
            "host_api_calls": sum(api.values()) / n,
            "host_api_calls_by_name": {k: v / n for k, v in api.items()},
            "graph_launches": api.get("cudaGraphLaunch", 0) / n,
            "unprofiled_us": step_us / per,
            "device_idle_share": (None if busy is None
                                  else 1 - busy * per / step_us),
            "counters_equal_profiler": counted, "windows_that_disagreed": misses,
            "profiler_missed": missed,
            "k1_device_us_per_launch": (k1_us / profiled["K1"]
                                        if profiled["K1"] and "K1" not in
                                        missed else None),
            "top_device_us": {k[:60]: us / n for k, (us, _) in top}}


def node_window(fn, reps: int, step_us: float) -> dict:
    """A window of ``reps`` calls of ``fn`` on a node graph (eager
    operations and graph replays), held against the launch counters: per
    call, device µs (null where the profiler missed a counted kernel) and
    operations, host CUDA API calls and graph launches among them, the
    idle share against the unprofiled ``step_us``, and host syncs."""
    kern, api, counts = trace_window(fn, reps)
    profiled = {key: sum(c for name, (_, c) in kern.items() if tag in name)
                for key, tag in COUNTED.items()}
    missed = [key for key in COUNTED if profiled[key] != counts[key]]
    busy = None if missed else sum(us for us, _ in kern.values()) / reps
    return {"calls": reps, "unprofiled_us": step_us, "device_us": busy,
            "device_ops": sum(c for _, c in kern.values()) / reps,
            "device_idle_share": None if busy is None else 1 - busy / step_us,
            "host_api_calls": sum(api.values()) / reps,
            "graph_launches": api.get("cudaGraphLaunch", 0) / reps,
            "host_syncs": syncs_per_call(fn, reps),
            "kernel_records": {"counters": {k: counts[k] for k in COUNTED},
                               "profiler": profiled, "missed": missed}}


def recorder(node, out, record: list, snapshot, limit=None):
    """``node.tick`` that appends ``snapshot()`` to ``record`` after each
    tick that published on ``out`` (up to ``limit`` entries): the inputs a
    node's update read, for its eager form."""
    def tick(t):
        seq = out.seq
        node.tick(t)
        if out.seq != seq and (limit is None or len(record) < limit):
            record.append(snapshot())
    return tick


def eager_mppi_law(cfg, params, device):
    """``examples_torch.full_stack_two_process.mppi_law`` before its graph:
    the same fused solve keyed by seed 11 + k, seed increment and twist,
    dispatched operation by operation (the form the graph is held to)."""
    from tpunav_torch.control.mppi import init_controls
    from tpunav_torch.core import diff_drive as dd
    from tpunav_torch.models.cart import CartParams
    from tpunav_torch.ops.fused_mppi import mppi_solve_fused
    from tpunav_torch.runtime.nodes import host, to_device

    cart = CartParams(params.wheel_radius, params.wheel_base)
    state = {"u": init_controls(cfg, device=device),
             "seed": to_device(11, torch.int32, device)}

    def law(pose_xyt, wpt):
        goal = [wpt[0], wpt[1], wpt[2] if len(wpt) > 2 else 0.0]
        x = to_device(np.concatenate([pose_xyt, goal]), torch.float32, device)
        cmd, state["u"] = mppi_solve_fused(cfg, cart, state["u"],
                                           state["seed"], x[:3], x[3:])
        state["seed"] = state["seed"] + 1
        return host(dd.wheels_to_twist(params, cmd))

    return law


def eager_rbpf_chain(rbpf, params, inputs, device):
    """The RBPF node's eager form on its recorded inputs (the odometry it
    read, the scan): the filter-input odometry, the twist and
    ``pf_slam_step`` drawing from a generator seeded as the node's (0),
    one by one. Returns the state."""
    from tpunav_torch.core import diff_drive as dd
    from tpunav_torch.runtime.nodes import to_device

    st = rbpf.pf.pf_init(rbpf.cfg, seed=0, device=device)
    drive = dd.init_state(device=device)
    prev = torch.zeros(3, device=device)
    for odo, scan in inputs:
        drive, wheel_vel = dd.update_odometry(params, drive, odo.left,
                                              odo.right)
        u = dd.wheels_to_twist(params, wheel_vel)[:2]
        cur = dd.pose(odo)
        st = rbpf.pf.pf_slam_step(rbpf.cfg, st, to_device(
            scan, torch.float32, device), u, cur, prev)
        prev = cur
    return st


def same_bits(a, b, names) -> dict:
    """{name: equal bits} of the named fields of two states."""
    return {n: bool(torch.equal(getattr(a, n), getattr(b, n)))
            for n in names}


def tel_diff(got, want) -> dict:
    """Where two telemetry streams (ticks, F) part: the first row that
    differs and the largest gap, or nulls."""
    rows = (got != want).any(dim=-1).nonzero()
    return {"first_tick_apart": int(rows[0]) if len(rows) else None,
            "max_abs_gap": float((got - want).abs().max())}


def seed_diff(got, want, got_tel, want_tel) -> dict:
    """A seed of a batch against its serial course: each field's bits, the
    generator's, the telemetry's, and :func:`tel_diff`."""
    fields = ("true_pose", "odom", "u", "wpt_idx", "visits", "ticks", "done")
    same = same_bits(got, want, fields)
    same.update({f"ekf.{k}": bool(torch.equal(a, b)) for k, a, b in zip(
        got.ekf._fields, got.ekf, want.ekf)})
    same["generator"] = bool(torch.equal(got.generator.get_state(),
                                         want.generator.get_state()))
    same["telemetry"] = bool(torch.equal(got_tel, want_tel))
    return {"equal": all(same.values()), "fields": same,
            **tel_diff(got_tel, want_tel)}


class CudaGraphs:
    """The loops as CUDA graphs (``tpunav_torch/capture.py``), each held to
    its eager path bit for bit: the MPPI courses (``run_course``,
    ``run_course_chunked``), ``bench.py``'s chained solves, the RBPF
    stepper at config 5, config 3's slam loop (``run_slam_loop``) and the
    EKF stepper at ``bench_ekf``'s shape. Each reports its rate eager and
    replayed, and a replayed window's device operations, host API calls
    and idle share; a kernel's launch counter must equal the profiler's
    count of its kernel over the window."""

    COURSE_FIELDS = ("pose", "u", "wpt_idx", "visits", "ticks", "done",
                     "wheel_vel")

    def __init__(self, smoke: Smoke, rbpf: Rbpf, obst: Obstacle, ekf: Ekf):
        self.s, self.r, self.o, self.e = smoke, rbpf, obst, ekf
        self.dev, self.card = smoke.dev, smoke.card
        self.launches = {}

    def course_case(self, cfg, course, wpts, st0, segs, obs_cfg, chunk=240):
        """One course: the eager per-tick loop (one host read per tick, the
        obstacle table packed once), on past done to the chunk boundary;
        run_course (held ticks, chunks of 120) against its state at done;
        run_course_chunked against its chunks' states and telemetry; a
        replayed window of 120-tick chunks."""
        from tpunav_torch.control import waypoint_loop as wl
        from tpunav_torch.control.chunks import active_waypoint

        model, fm = self.s.model, self.s.fm
        table = fm.pack_obstacles(segs, obs_cfg, self.dev)
        kw = {} if segs is None else {"obstacles": segs, "obs_cfg": obs_cfg}
        states, st = [], st0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while not bool(st.done):
            states.append(st)
            st = wl._tick(cfg, course, model, wpts, st, None, table)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        at_done, ticks = st, len(states)
        while len(states) % chunk:
            states.append(st)
            st = wl._tick(cfg, course, model, wpts, st, None, table)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        held = wl.run_course(cfg, course, model, wpts, st0, **kw)
        torch.cuda.synchronize()
        held_s = time.perf_counter() - t0
        held_counts = read_counts()
        seen, marks = [], []

        def on_chunk(s, tel):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            seen.append((s, tel))

        chunked = wl.run_course_chunked(cfg, course, model, wpts, st0,
                                        chunk=chunk, on_chunk=on_chunk, **kw)
        same = {"run_course": same_bits(held, at_done, self.COURSE_FIELDS),
                "run_course_chunked": same_bits(chunked, st,
                                                self.COURSE_FIELDS)}
        tel_same = len(seen) * chunk == len(states)
        for i, (s, tel) in enumerate(seen):
            rows = states[i * chunk:(i + 1) * chunk]
            want = {"pose": torch.stack([r.pose for r in rows]),
                    "wpt_idx": torch.stack([r.wpt_idx for r in rows]),
                    "d2g": torch.stack([wl._dist_to_goal(
                        r.pose, active_waypoint(wpts, r.wpt_idx))
                        for r in rows])}
            tel_same &= all(torch.equal(tel[k], want[k]) for k in want)
            tel_same &= all(same_bits(s, states[(i + 1) * chunk] if
                                      (i + 1) * chunk < len(states) else st,
                                      self.COURSE_FIELDS).values())
        if not (all(same["run_course"].values()) and
                all(same["run_course_chunked"].values()) and tel_same):
            raise AssertionError(f"course graph differs from eager: {same}, "
                                 f"telemetry and chunk states {tel_same}")
        if held_counts["K1"] != -(-ticks // 120) * 120:
            raise AssertionError(f"run_course: {held_counts} launches for "
                                 f"{ticks} ticks in chunks of 120")
        steady = ((len(seen) - 2) * chunk / (marks[-1] - marks[1])
                  if len(marks) > 2 else None)
        # run_course's ticks after done, each held: K1 returns at once.
        held_win = wl._Chunks(cfg, course, model, wpts, held, None, table,
                              120, held=True, telemetry=False)
        held_win.step(course.max_ticks)         # the warm-up
        held_win.step(course.max_ticks)         # the capture
        held_us = wall_us(lambda: held_win.step(course.max_ticks), 3,
                          warmup=0)
        held_prof = graph_window(lambda: held_win.step(course.max_ticks), 1,
                                 120, held_us)
        if not all(same_bits(held_win.state, held,
                             self.COURSE_FIELDS).values()):
            raise AssertionError("held ticks moved a finished course")
        window = wl._Chunks(cfg, course, model, wpts, st0, None, table, 120,
                            held=False, telemetry=True)
        window.step(course.max_ticks)           # the warm-up
        window.step(course.max_ticks)           # the capture
        step_us = wall_us(lambda: window.step(course.max_ticks), 5, warmup=0)
        prof = graph_window(lambda: window.step(course.max_ticks), 1, 120,
                            step_us)
        return {"ticks": ticks, "chunked_ticks": int(chunked.ticks),
                "eager_us_per_tick": 1e6 * eager_s / ticks,
                "run_course_us_per_tick": 1e6 * held_s / ticks,
                "run_course_launches": held_counts,
                "chunked_steady_solves_per_s": steady,
                "replayed_us_per_tick": step_us / 120,
                "replayed_solves_per_s": 120e6 / step_us,
                "bit_identical": same, "telemetry_bit_identical": tel_same,
                "replayed_window": prof, "held_window": held_prof}

    def course(self):
        """``graph_course``: the flagship pentagon and config 2's obstacle
        course, graph against the eager per-tick run."""
        from tpunav_torch.control.waypoint_loop import course_init

        t0 = time.perf_counter()
        cfg, course, wpts, st0 = self.s.flagship()
        flagship = self.course_case(cfg, course, wpts, st0, None, None)
        cfg2, course2, wpts2, segs = self.o.course_cfg
        st2 = course_init(cfg2, torch.tensor(self.o.demo_mod.START + [0.0]),
                          seed=0, device=self.dev)
        config2 = self.course_case(cfg2, course2, wpts2, st2, segs,
                                   self.o.demo)
        self.launches["course"] = {
            "flagship": flagship["run_course_launches"]["K1"],
            "config2": config2["run_course_launches"]["K1"]}
        self.launches["obstacle"] = config2["run_course_launches"][
            "K1_obstacle"]
        emit("graph_course", seconds=time.perf_counter() - t0,
             card=self.card, K=cfg.rollouts, N=cfg.steps,
             flagship=flagship, config2=config2)

    def solves(self, solves=100, replays=8, trials=4):
        """``graph_solves``: bench.py's many_solves (bench.py:65-113) on the
        port — ``solves`` chained fused solves (each one's u feeds the
        next, seeds seed0 + i) in one graph, ``replays`` replays per trial
        and ``trials`` trials, at K=49,152 and 4,096 with N=50; one replay
        against the same chain run eagerly, bit for bit."""
        from tpunav_torch.capture import Graph
        from tpunav_torch.models.cart import CartParams

        t0 = time.perf_counter()
        fm, mppi = self.s.fm, self.s.mppi
        model = CartParams(0.033, 0.160)
        rows = []
        for k in (49152, 4096):
            cfg = self.s.cfg(k)
            pose = torch.zeros(3, device=self.dev)
            xd = torch.tensor([1.0, 1.0, 0.0], device=self.dev)
            u = mppi.init_controls(cfg, device=self.dev)
            seed = torch.zeros((), dtype=torch.int32, device=self.dev)
            cmds = torch.empty((solves, 2), device=self.dev)

            def chain(u0, s0):
                out = []
                for i in range(solves):
                    cmd, u0 = fm.mppi_solve_fused(cfg, model, u0, s0 + i,
                                                  pose, xd)
                    out.append(cmd)
                return u0, torch.stack(out)

            def body():
                u_new, c = chain(u, seed)
                u.copy_(u_new)
                cmds.copy_(c)
                seed.add_(solves)

            graph = Graph(body, self.dev)
            graph()                                  # the warm-up (seed 0)
            want_u, want_cmds = chain(u.clone(), seed.clone())
            reset_counts()
            graph()                                  # the capture, seed 100
            per_replay = read_counts()["K1"]
            same = bool(torch.equal(u, want_u) and
                        torch.equal(cmds, want_cmds))
            if not same or per_replay != solves:
                raise AssertionError(f"K={k}: chained solves graph vs eager "
                                     f"bits {same}, {per_replay} K1 launches "
                                     f"per replay")
            times = [wall_us(lambda: [graph() for _ in range(replays)], 1,
                             warmup=0) / 1e6
                     for _ in range(trials)]
            n = solves * replays
            best = n * k / min(times)
            rows.append({
                "metric": f"mppi_rollouts_per_sec_per_chip (K={k}, H="
                          f"{cfg.steps} steps, {n / min(times):.1f} solves/s,"
                          " fused CUDA graph)",
                "value": best, "unit": "rollouts/s",
                "vs_baseline": best / 2500.0,
                "median": n * k / statistics.median(times),
                "trial_seconds": times, "us_per_solve": 1e6 * min(times) / n,
                "K1_per_replay": per_replay, "bit_identical": same})
        self.launches["solves"] = {r["metric"]: r["K1_per_replay"]
                                   for r in rows}
        emit("graph_solves", seconds=time.perf_counter() - t0,
             card=self.card, solves_per_replay=solves, replays=replays,
             trials=trials, rows=rows)

    def rbpf(self):
        """``graph_rbpf``: config 5's 120 updates through ``PFStepper`` from
        ``rbpf_course``'s start (filter seed 0, the same scans), against
        that course's eager final state bit for bit, with one K2 and one
        K3 per update; a replayed window of a second stepper."""
        pf, r = self.r.pf, self.r
        t0 = time.perf_counter()
        u, scans, odoms, prevs = r.inputs
        stepper = pf.PFStepper(r.cfg, pf.pf_init(r.cfg, seed=0,
                                                 device=self.dev))
        torch.cuda.synchronize()
        reset_counts()
        for i in range(r.UPDATES):
            st = stepper.step(scans[i], u, odoms[i], prevs[i])
            if i == r.WARM - 1:
                torch.cuda.synchronize()
                t_warm = time.perf_counter()
        torch.cuda.synchronize()
        steady_ms = 1e3 * (time.perf_counter() - t_warm) / (r.UPDATES -
                                                          r.WARM)
        counts = read_counts()
        same = same_bits(st, r.state, ("poses", "log_weights", "grids",
                                       "dists", "prev_poses"))
        want = {"K1": 0, "K1_obstacle": 0, "K2": r.UPDATES,
                "K3": r.UPDATES, "K4": 0, "EIG": 0, "ICP": r.UPDATES,
                "EKF": 0}
        if not all(same.values()) or counts != want:
            raise AssertionError(f"RBPF stepper vs eager: {same}, launches "
                                 f"{counts} (want {want})")
        e = (pf.best_particle(st)[0] - odoms[-1]).cpu()
        k = [0]
        window = pf.PFStepper(r.cfg, pf.pf_init(r.cfg, seed=1,
                                                device=self.dev))

        def update():
            i = k[0] % r.UPDATES
            window.step(scans[i], u, odoms[i], prevs[i])
            k[0] += 1

        update()
        update()
        step_us = wall_us(update, 10, warmup=0)
        prof = graph_window(update, 5, 1, step_us)
        self.launches["rbpf"] = counts
        emit("graph_rbpf", seconds=time.perf_counter() - t0, card=self.card,
             P=r.P, updates=r.UPDATES, bit_identical=same, launches=counts,
             eager_ms_per_update=r.ms_per_update,
             graph_ms_per_update=steady_ms,
             graph_updates_per_s=1e3 / steady_ms,
             pose_error_cm=100 * float(torch.hypot(e[1], e[2])),
             replayed_window=prof)

    def ekf(self, prefix=GRAPH_EKF_EAGER_PREFIX):
        """``graph_ekf``: config 3 through ``run_slam_loop`` to ``prefix``
        ticks (a prefix of ``ekf_course``'s graph run) against the eager
        per-tick loop from the same start, bit for bit, the generator
        included; a replayed window of 60-tick chunks, and of held chunks
        from ``ekf_course``'s finished course (K1 returns at once); the EKF
        update alone at ``bench_ekf``'s shape (n=50, 12 visible of 50
        rows, float32) through ``EKFStepper`` without and with the default
        SPD repair (:meth:`update_alone`)."""
        sl, ekff = self.e.sl, self.e.ekff
        t0 = time.perf_counter()
        mppi, ekf, loop, wpts, lms = self.e.config3()
        model = self.e.c3_demo.MODEL
        st = sl.slam_loop_init(mppi, ekf, seed=1, device=self.dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        while st.host_ticks < prefix and not bool(st.done):
            st = sl.slam_loop_tick(mppi, ekf, loop, model, wpts, lms, st)
        torch.cuda.synchronize()
        eager_us = 1e6 * (time.perf_counter() - t1) / st.host_ticks
        g = sl.run_slam_loop(mppi, ekf, loop, model, wpts, lms,
                             sl.slam_loop_init(mppi, ekf, seed=1,
                                               device=self.dev),
                             max_ticks=prefix)
        same = same_bits(g, st, ("true_pose", "odom", "u", "wpt_idx",
                                 "visits", "ticks", "done"))
        same.update({f"ekf.{k}": v for k, v in same_bits(
            g.ekf, st.ekf, ekff.EKFState._fields).items()})
        same["generator"] = bool(torch.equal(g.generator.get_state(),
                                             st.generator.get_state()))
        if not all(same.values()) or g.host_ticks != st.host_ticks:
            raise AssertionError(f"config 3 graph vs eager: {same}")
        chunk = sl.default_chunk(loop.sensor_every)
        window = sl._Chunks(mppi, ekf, loop, model, wpts, lms,
                            sl.slam_loop_init(mppi, ekf, seed=2,
                                              device=self.dev), chunk, 10**9)
        window.step()
        window.step()
        chunk_us = wall_us(window.step, 5, warmup=0)
        prof = graph_window(window.step, 3, chunk, chunk_us)
        # Chunks of held ticks from ekf_course's finished state: K1 returns
        # at once on each.
        held = sl._Chunks(mppi, ekf, loop, model, wpts, lms,
                          self.e.c3_state, chunk, 10**9)
        held.step()
        held.step()
        held_us = wall_us(held.step, 3, warmup=0)
        held_prof = graph_window(held.step, 1, chunk, held_us)
        update = {}
        meas = [self.e.t(m) for m in bench_ekf_course()]
        u = self.e.t([0.02, 0.01])
        for repair in (False, True):
            cfg = dataclasses.replace(self.e.bench_cfg(), spd_repair=repair)
            for known in (True, False):
                update[f"{'known' if known else 'unknown'}"
                       f"{'_spd_repair' if repair else ''}"] = \
                    self.update_alone(cfg, known, meas, u)
        self.launches["ekf"] = self.e.k1_course
        self.launches["ekf_eig"] = {k: r["launches"]["EIG"]
                                    for k, r in update.items()}
        self.launches["ekf_step"] = {k: r["launches"]["EKF"]
                                     for k, r in update.items()}
        emit("graph_ekf", seconds=time.perf_counter() - t0, card=self.card,
             eager_prefix_ticks=st.host_ticks, bit_identical=same,
             eager_us_per_tick=eager_us,
             eager_ticks_per_s=1e6 / eager_us,
             graph_us_per_tick=chunk_us / chunk,
             graph_ticks_per_s=1e6 * chunk / chunk_us,
             replayed_window=prof, held_window=held_prof,
             update_alone=update)

    def update_alone(self, cfg, known, meas, u, masked_updates=20,
                     f64_updates=12):
        """The EKF update alone through ``EKFStepper`` against the eager
        update (float32, ``bench_ekf``'s 200 updates through the stepper):
        bit for bit the dynamic chain's state after its
        GRAPH_EKF_EAGER_UPDATES updates and, over the first
        ``masked_updates``, the eager masked form's; a float64 stepper over
        ``f64_updates`` within 1e-9 of the masked update on the CPU; ms per
        update both ways (after 20 warm-up updates) and a replayed window;
        the eigensolver's launches per update (the SPD repair at S = 103:
        its two kernels, gated off on an SPD covariance)."""
        ekff = self.e.ekff
        fn, masked = ((ekff.known_correspondence_slam,
                       ekff.known_correspondence_slam_masked) if known
                      else (ekff.slam_unknown_da, ekff.slam_unknown_da_masked))
        eager = meas[:GRAPH_EKF_EAGER_UPDATES]
        a = ekff.ekf_init(cfg, dtype=torch.float32, device=self.dev)
        stepper = ekff.EKFStepper(cfg, a, 50, known)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i, m in enumerate(eager):
            a = fn(cfg, a, m, u)
            if i == 19:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
        torch.cuda.synchronize()
        eager_ms = 1e3 * (time.perf_counter() - t1) / (len(eager) - 20)
        reset_counts()
        for i, m in enumerate(meas):
            b = stepper.step(m, u)
            if i == 19:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            if i == len(eager) - 1:
                at_eager = ekff.EKFState(*(t.clone() for t in b))
        torch.cuda.synchronize()
        graph_ms = 1e3 * (time.perf_counter() - t1) / (len(meas) - 20)
        counts = read_counts()
        bits = same_bits(at_eager, a, ekff.EKFState._fields)
        c = ekff.ekf_init(cfg, dtype=torch.float32, device=self.dev)
        short = ekff.EKFStepper(cfg, c, 50, known)
        for m in meas[:masked_updates]:
            c = masked(cfg, c, m, u)
            d = short.step(m, u)
        bits.update({f"masked.{k}": v for k, v in same_bits(
            d, c, ekff.EKFState._fields).items()})
        if not all(bits.values()):
            raise AssertionError(f"EKF stepper vs eager (spd_repair="
                                 f"{cfg.spd_repair}): {bits}")
        from tpunav_torch.ops import sym_eig as se

        want_eig = (len(meas) * se.kernels_per_call(a.cov.shape[-1])
                    if cfg.spd_repair else 0)
        if counts["EIG"] != want_eig:
            raise AssertionError(f"EKF stepper: {counts} launches over "
                                 f"{len(meas)} updates")
        e64 = ekff.ekf_init(cfg, dtype=torch.float64, device=self.dev)
        c64 = ekff.ekf_init(cfg, dtype=torch.float64, device="cpu")
        s64 = ekff.EKFStepper(cfg, e64, 50, known)
        for m in meas[:f64_updates]:
            got = s64.step(m.double(), u.double())
            c64 = masked(cfg, c64, m.double().cpu(), u.double().cpu())
        f64_err = max(float((x.cpu() - y).abs().max())
                      for x, y in zip(got[:2], c64[:2]))
        if not (f64_err <= 1e-9 and torch.equal(got.active.cpu(),
                                                c64.active)):
            raise AssertionError(f"EKF stepper float64 vs CPU: {f64_err}")
        step_us = wall_us(lambda: stepper.step(meas[-1], u), 5, warmup=0)
        return {"spd_repair": cfg.spd_repair,
                "eager_updates": len(eager), "graph_updates": len(meas),
                "eager_ms_per_update": eager_ms,
                "graph_ms_per_update": graph_ms,
                "graph_updates_per_s": 1e3 / graph_ms, "bit_identical": bits,
                "launches": counts, "float64_vs_cpu_max_abs_err": f64_err,
                "float64_updates": f64_updates,
                "replayed_window": graph_window(
                    lambda: stepper.step(meas[-1], u), 3, 1, step_us)}

    def plain_course(self, prefix=240, stop=210, chunk=60, window=24):
        """``plain_course``: the plain backend (control/mppi.py's solve, no
        kernel; its perturbations drawn from the state's generator into a
        static tensor before each replay) in replayed chunks. The pentagon
        at K=1,024 (examples_torch.mppi_waypoints_demo.run(False, 1024)'s
        configuration): the eager per-tick loop to ``prefix`` ticks;
        run_course_chunked in chunks of ``chunk`` (a warm-up chunk, a
        captured one, replays) to done, its first ``prefix`` ticks' state,
        telemetry and generator the eager loop's, done at ≥ 60 steady
        solves/s (the chunks after the warm-up and capture chunks);
        run_course held to ``max_ticks`` = ``stop``, mid-chunk, the eager
        loop's state and generator there; a replayed window of
        ``window``-tick chunks (the profiler records ~2,500 kernels a
        tick). Config 3 on the plain backend (slam_mppi_closed_loop_demo.
        configs(True, 12, use_fused=False)): run_slam_loop to ``prefix``
        ticks against the eager ticks bit for bit (state, filter,
        generator), then the whole course as the demo runs it: done, EKF
        error below odometry's. Nothing here launches a counted kernel;
        ``part_seconds`` holds each part's host seconds, captures
        included."""
        from tpunav_torch.control import waypoint_loop as wl
        from tpunav_torch.control.chunks import active_waypoint

        t0 = time.perf_counter()
        secs = {}

        def lap(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            secs[name] = now - lap.t
            lap.t = now

        lap.t = t0
        s, sl, ekff = self.s, self.e.sl, self.e.ekff
        cfg = s.config.load_mppi_config(
            os.path.join(CONFIGS, "mppi_params.yaml"), horizon=0.5,
            rollouts=1024)
        course = wl.CourseConfig(goal_thresh=0.1, tick_dt=1.0 / 60.0,
                                 max_ticks=20_000, use_fused=False)
        wpts = torch.as_tensor(s.config.load_waypoints(
            os.path.join(CONFIGS, "real_waypoints.yaml")),
            dtype=torch.float32, device=self.dev)
        model = s.model

        def start():
            return wl.course_init(cfg, torch.zeros(3), seed=0,
                                  device=self.dev)

        reset_counts()
        st, rows = start(), {"pose": [], "wpt_idx": [], "d2g": []}
        lap("set_up")
        for i in range(prefix):
            rows["pose"].append(st.pose)
            rows["wpt_idx"].append(st.wpt_idx)
            rows["d2g"].append(wl._dist_to_goal(
                st.pose, active_waypoint(wpts, st.wpt_idx)))
            st = wl.course_tick(cfg, course, model, wpts, st)
            if i == stop - 1:
                at_stop = (st, st.generator.get_state())
        lap("eager_ticks")
        eager_us = 1e6 * secs["eager_ticks"] / prefix
        seen, marks = [], []

        def on_chunk(a, tel):
            seen.append((a, tel, a.generator.get_state()))
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        whole = wl.run_course_chunked(cfg, course, model, wpts, start(),
                                      chunk=chunk, on_chunk=on_chunk)
        lap("run_course_chunked")
        ticks = int(whole.ticks)
        steady = (ticks - 2 * chunk) / (marks[-1] - marks[1])
        a, _, gen = seen[prefix // chunk - 1]
        same = {"chunked": same_bits(a, st, self.COURSE_FIELDS)}
        same["chunked"]["generator"] = torch.equal(gen,
                                                   st.generator.get_state())
        same["chunked"]["telemetry"] = all(
            torch.equal(torch.cat([t[k] for _, t, _ in
                                   seen[:prefix // chunk]]),
                        torch.stack(v)) for k, v in rows.items())
        got = wl.run_course(cfg, dataclasses.replace(course, max_ticks=stop),
                            model, wpts, start(), chunk=chunk)
        same["run_course"] = same_bits(got, at_stop[0], self.COURSE_FIELDS)
        same["run_course"]["generator"] = torch.equal(
            got.generator.get_state(), at_stop[1])
        lap("run_course_to_max_ticks")
        runner = wl._Chunks(cfg, course, model, wpts, start(), None, None,
                            window, held=False, telemetry=True)
        runner.step(course.max_ticks)            # the warm-up
        runner.step(course.max_ticks)            # the capture
        chunk_us = wall_us(lambda: runner.step(course.max_ticks), 5,
                           warmup=0)
        prof = graph_window(lambda: runner.step(course.max_ticks), 1, window,
                            chunk_us)
        prof["host_syncs_per_tick"] = syncs_per_call(
            lambda: runner.step(course.max_ticks), 1) / window
        lap("replayed_window")
        counts = read_counts()
        bad = {k: v for k, v in same.items() if not all(v.values())}
        done = bool(whole.done) and int(whole.visits) == len(wpts)
        if bad or not done or not steady >= 60:
            raise AssertionError(f"plain course: bits {same}, done {done}, "
                                 f"{steady} steady solves/s")
        if any(counts.values()):
            raise AssertionError(f"the plain backend launched {counts}")

        demo = self.e.c3_demo
        mppi, ekf, loop = demo.configs(True, 12, use_fused=False)
        c3w, c3l = self.e.t(demo.WAYPOINTS), self.e.t(demo.block_world())
        st = sl.slam_loop_init(mppi, ekf, seed=1, device=self.dev)
        lap("config3_set_up")
        while st.host_ticks < prefix and not bool(st.done):
            st = sl.slam_loop_tick(mppi, ekf, loop, demo.MODEL, c3w, c3l, st)
        lap("config3_eager_ticks")
        c3_eager_us = 1e6 * secs["config3_eager_ticks"] / st.host_ticks
        got = sl.run_slam_loop(mppi, ekf, loop, demo.MODEL, c3w, c3l,
                               sl.slam_loop_init(mppi, ekf, seed=1,
                                                 device=self.dev),
                               max_ticks=prefix)
        c3_same = same_bits(got, st, ("true_pose", "odom", "u", "wpt_idx",
                                      "visits", "ticks", "done"))
        c3_same.update({f"ekf.{k}": v for k, v in same_bits(
            got.ekf, st.ekf, ekff.EKFState._fields).items()})
        c3_same["generator"] = torch.equal(got.generator.get_state(),
                                           st.generator.get_state())
        lap("config3_run_slam_loop_prefix")
        c3 = demo.run("config 3", demo.block_world(), True, 12,
                      use_fused=False, verbose=False, device=self.dev)
        lap("config3_demo_course")
        if (not all(c3_same.values()) or got.host_ticks != st.host_ticks
                or not c3["done"] or not c3["ekf_err_m"] < c3["odom_err_m"]):
            raise AssertionError(f"plain config 3: bits {c3_same}, done "
                                 f"{c3['done']}, EKF {c3['ekf_err_m']} m, "
                                 f"odometry {c3['odom_err_m']} m")
        self.launches["plain_course"] = read_counts()
        emit("plain_course", seconds=time.perf_counter() - t0,
             card=self.card, part_seconds=secs, pentagon={
                 "K": cfg.rollouts, "N": cfg.steps, "ticks": ticks,
                 "done": True, "steady_solves_per_s": steady,
                 "wall_s": secs["run_course_chunked"],
                 "eager_us_per_tick": eager_us,
                 "replayed_us_per_tick": chunk_us / window,
                 "bit_identical": same, "prefix_ticks": prefix,
                 "run_course_max_ticks": stop, "chunk": chunk,
                 "window_chunk": window, "replayed_window": prof},
             config3={"K": mppi.rollouts, "N": mppi.steps,
                      "ticks": c3["ticks"], "done": True,
                      "ekf_error_m": c3["ekf_err_m"],
                      "odometry_error_m": c3["odom_err_m"],
                      "ticks_per_s_with_captures": c3["ticks_per_s"],
                      "eager_us_per_tick": c3_eager_us,
                      "bit_identical_prefix": c3_same,
                      "prefix_ticks": prefix},
             kernel_launches=self.launches["plain_course"])

    def collector(self, runners=4, chunk=30, steps=3):
        """``graph_gc``: the capture guard (``capture.Graph`` collects
        before a capture and holds the collector off during it) on the
        card. Course runners are built, warmed, captured, replayed and
        dropped inside reference cycles, which only the cyclic collector
        frees: first ``runners`` // 2, then a new runner captures at once
        (the guard's own collection frees them); then the rest, a forced
        collection, and another runner. Each new runner's state after
        ``steps`` chunks equals the eager ticks' bit for bit."""
        from tpunav_torch.control import waypoint_loop as wl

        t0 = time.perf_counter()
        cfg, course, wpts, st0 = self.s.flagship()
        model = self.s.model

        def drop(n):
            for _ in range(n):
                r = wl._Chunks(cfg, course, model, wpts, st0, None, None,
                               chunk, held=False, telemetry=False)
                r.cycle = r
                for _ in range(steps):
                    r.step(course.max_ticks)
                del r

        st = st0
        for _ in range(chunk * steps):
            st = wl._tick(cfg, course, model, wpts, st, None, None)
        rows = {}
        for tag in ("guard", "forced"):
            drop(runners // 2)
            if tag == "forced":
                gc.collect()
            r = wl._Chunks(cfg, course, model, wpts, st0, None, None, chunk,
                           held=False, telemetry=False)
            for _ in range(steps):
                r.step(course.max_ticks)
            rows[tag] = same_bits(r.state, st, self.COURSE_FIELDS)
            if not all(rows[tag].values()):
                raise AssertionError(f"graph_gc ({tag}): {rows[tag]}")
        emit("graph_gc", seconds=time.perf_counter() - t0, card=self.card,
             dropped_runners=runners, chunk=chunk, steps=steps,
             bit_identical=rows)


def kernel_times(smoke: Smoke, rbpf: Rbpf, obst: Obstacle):
    """Device µs per call (torch.profiler over 50 calls, after 5) of K1 with
    in-kernel Philox at K=4,096 and 49,152, N=50, without obstacles, with
    the demo's wall (O=4) and with the reference world's 41 edges, and at
    K=196,608 without obstacles; of K2
    (all its launches) at P=500 and 2,000 with k=51 and P=40 with k=51 on
    80×80, and P=40 with k=50 on 160×160; and of K3 and K4 at P=500 on
    80×80 and P=40 on 160×160; on the gate's world, with a sha256 of K2's
    scores, of K3's grids and fields and of K4's fields."""
    import tpunav_torch

    t0, reps = time.perf_counter(), 50
    fm, mu, dev = smoke.fm, rbpf.mu, smoke.dev
    seed = torch.tensor(5, dtype=torch.int32, device=dev)

    k1 = []
    for k, names in [(4096, (None, "demo_wall", "reference_world")),
                     (49152, (None, "demo_wall", "reference_world")),
                     (196608, (None,))]:
        cfg = smoke.cfg(k)
        for name in names:
            if name is None:
                u, pose, xd, _ = smoke.tensors(cfg)
                fn = (lambda: fm.mppi_solve_fused(cfg, smoke.model, u, seed,
                                                  pose, xd))
                n_obs = 0
            else:
                u, pose, xd, _, segs, params = obst.inputs(cfg, name)
                table = fm.pack_obstacles(segs, params, dev)
                fn = (lambda: fm.mppi_solve_fused_packed(
                    cfg, smoke.model, u, seed, pose, xd, table=table))
                n_obs = int(segs.shape[0])
            us = device_us(fn, ("mppi_rollout_partials", "mppi_combine"),
                           reps)
            k1.append({"K": k, "N": cfg.steps, "O": n_obs, "device_us": us,
                       "total_us": None if None in us.values()
                       else sum(us.values())})
    lik = []
    for gcfg, p, k in [(rbpf.g80, 500, 51), (rbpf.g80, 2000, 51),
                       (rbpf.g160, 40, 50), (rbpf.g80, 40, 51)]:
        scan, poses, grids, gen = rbpf.world(gcfg, p)
        dists = rbpf.grid.esdf(gcfg, grids)
        samples = (poses[:, None, :] + 0.01 * torch.randn(
            (p, k, 3), generator=gen, device=dev)).contiguous()
        us = device_us(lambda: rbpf.lik.likelihood_field_batch(
            gcfg, dists, scan, samples), ("likelihood_",),
            reps)["likelihood_"]
        lik.append({"P": p, "k": k, "map": [gcfg.height, gcfg.width],
                    "K2_device_us": us, "K2_sha256": digest(
                        rbpf.lik.likelihood_field_batch(gcfg, dists, scan,
                                                        samples))})
    maps = []
    for gcfg, p in [(rbpf.g80, 500), (rbpf.g160, 40)]:
        scan, poses, grids, _ = rbpf.world(gcfg, p)
        k3 = device_us(lambda: mu.map_update_batch(gcfg, grids, scan, poses),
                       ("map_update_kernel",), reps)["map_update_kernel"]
        g, d = mu.map_update_batch(gcfg, grids, scan, poses)
        k4 = device_us(lambda: mu.edt_batch(gcfg, g), ("edt_kernel",), reps)
        maps.append({"P": p, "map": [gcfg.height, gcfg.width],
                     "K3_device_us": k3, "K4_device_us": k4["edt_kernel"],
                     "K3_sha256": digest(g, d),
                     "K4_sha256": digest(mu.edt_batch(gcfg, g))})
    emit("kernel_times", seconds=time.perf_counter() - t0, card=smoke.card,
         package=os.path.dirname(tpunav_torch.__file__), reps=reps, k1=k1,
         k2=lik, maps=maps)


# The launch counter of the kernels whose names hold each profiler tag.
TAG_COUNTERS = {"mppi_rollout_partials": "K1", "mppi_combine": "K1",
                "likelihood_": "K2", "map_update_kernel": "K3",
                "edt_kernel": "K4", "sym_eig": "EIG", "icp_kernel": "ICP",
                "ekf_step_kernel": "EKF"}


def device_us(fn, tags, reps: int, attempts: int = 3) -> dict:
    """{tag: device µs per call of the kernels whose names hold tag}, from
    torch.profiler over ``reps`` calls after 5, in :func:`trace_window`
    (which opens on spin kernels). Late in a process the profiler records
    only part of a window's kernels (on an H100: 11 of 20 eigensolver
    launches, 0 of 3 at S = 203; all in a fresh process). A window whose
    count of a tag's kernels equals its launch counters' change gives the
    sum; otherwise, after ``attempts`` windows, the calls being alike, each
    recorded kernel's mean µs times its launches per call (the counter's
    change split evenly over the tag's kernel names), with the recorded
    share on stderr; None where no kernel of the tag was recorded (not
    measured)."""
    for _ in range(5):
        fn()
    out, part = dict.fromkeys(tags), {}
    for _ in range(attempts):
        kern, _, counts = trace_window(fn, reps)
        for tag in (t for t in tags if out[t] is None):
            hits = [(us, c) for key, (us, c) in kern.items() if tag in key]
            launched = counts[TAG_COUNTERS[tag]]
            recorded = sum(c for _, c in hits)
            if hits and recorded == launched:
                out[tag] = sum(us for us, _ in hits) / reps
            elif hits and launched:
                mean = sum(us / c for us, c in hits) * launched / len(hits)
                part[tag] = (mean / reps, recorded, launched)
        if all(out[t] is not None for t in tags):
            break
    for tag in (t for t in tags if out[t] is None):
        if tag in part:
            out[tag], recorded, launched = part[tag]
            print(f"device_us: {tag}: the mean of {recorded} of {launched} "
                  "kernels recorded", file=sys.stderr)
        else:
            print(f"device_us: {tag}: no kernel recorded", file=sys.stderr)
    return out


def device_event_us(fn, reps: int) -> float:
    """Median device µs of one call of ``fn``, from CUDA events recorded
    behind a spin kernel (~1 ms) that keeps the stream busy while the host
    enqueues them and the call: the interval holds the call's device work
    and none of its host time. The profiler's cross-check."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(1e3 * a.elapsed_time(b))
    return statistics.median(times)


def digest(*ts) -> str:
    """A sha256 of the tensors' bytes: equal digests, equal bits."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def gate_rows(mppi, cfg, model, got, plain, u, pose, xd, noise, cost, what,
              bar=BAR):
    """K1's update rows (cmd, then u_next[:-1]) against its plain
    version's: a row may lie above ``bar`` only where the float64 solve
    shows a near-tie (``rounding_slack``). Returns (max |Δ| over the other
    rows, exempt rows, max |Δ| over all rows); raises on a row that is
    neither."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite controls from the kernel")
    if float(got.abs().max()) > cfg.max_wheel_vel:
        raise AssertionError(f"{what}: controls not clamped")
    tie, slack = rounding_slack(mppi, cfg, model, u, pose, xd, noise, cost)
    err = (got - plain).abs().cpu().numpy()
    bad = (err > bar).any(axis=1)
    ok = tie | (err <= bar + slack).all(axis=1)
    if not ok[bad].all():
        rows = np.nonzero(bad & ~ok)[0].tolist()
        raise AssertionError(f"{what} vs plain: rows {rows} above {bar}")
    kept = err[~bad]
    return (float(kept.max()) if kept.size else 0.0, int(bad.sum()),
            float(err.max()))


def rounding_slack(mppi, cfg, model, u, pose, xd, noise, cost):
    """PR 1's near-tie rule with obstacles, from the float64 solve of the
    same inputs. Row t of the float32 cost-to-go sums N − t losses, so it
    may lie ε_t = max(NEAR_TIE_ULPS, N − t) float32 ulps from the float64
    value. Returns per row whether its two best rollouts lie within ε_t
    (rounding can swap them), and per row and column how far ε_t of every
    J moves the update to first order: (ε/λ)·Σ_k w_k·|z_k − ū|."""
    d = torch.float64
    z = noise.to(d)                                           # (N, K, 2)
    loss, _ = mppi.rollout_losses(cfg, model, pose.to(d),
                                  u.to(d)[None] + z.transpose(0, 1),
                                  xd.to(d), cost)
    j = mppi.cost_to_go(loss)                                 # (N, K)
    n = j.shape[0]
    ulps = torch.clamp(n - torch.arange(n, device=j.device, dtype=d),
                       min=NEAR_TIE_ULPS)[:, None]

    def ulp(v):           # float32 spacing at |v|, in float64
        e = torch.frexp(v.abs().to(torch.float32)).exponent
        return torch.ldexp(torch.ones_like(v), (e - 24).to(torch.int32))

    two = torch.topk(j, min(2, j.shape[1]), dim=1, largest=False).values
    # With one rollout there is no second best to tie with.
    tie = ((two[:, -1] - two[:, 0]) < ulps[:, 0] * ulp(two[:, 0])) & (
        two.shape[1] == 2)
    eps = ulps * ulp(j)
    e = torch.exp((two[:, :1] - j) / cfg.lambda_)
    w = e / e.sum(dim=1, keepdim=True)
    ubar = torch.einsum("nk,nkc->nc", w, z)
    slack = torch.einsum("nk,nkc->nc", w * eps,
                         (z - ubar[:, None]).abs()) / cfg.lambda_
    return tie.cpu().numpy(), slack.cpu().numpy()


def time_ms(fn, reps=30, warmup=5):
    """Median CUDA-event time of ``fn`` in ms over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def ptxas_summary(report: str) -> dict:
    """{kernel: "registers, shared memory, spills"} from ptxas -v."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # The eigensolver's instances: sym_eig_small<S> and
            # sym_eig_kernel<threads, layout>.
            t = re.search(r"(sym_eig_(?:kernel|small))ILi(\d+)E(?:Li(\d+)E)?",
                          m.group(1))
            name = (f"{t[1]}<{t[2]}{', ' + t[3] if t[3] else ''}>" if t else
                    next((k for k in ("mppi_combine", "mppi_rollout_partials",
                                      "likelihood_field_kernel",
                                      "likelihood_table_kernel",
                                      "likelihood_lookup_kernel",
                                      "map_update_kernel", "edt_kernel")
                          if k in m.group(1)), m.group(1)))
        elif name and ("spill" in line or "Used" in line):
            out[name] = (out.get(name, "") + " " + line.strip()).strip()
    return out


def smem_limit() -> int:
    """The dynamic shared memory a block may opt in to on this card."""
    from tpunav_torch.ops import _build

    return _build.load().tpunav_max_dynamic_smem()


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    from tpunav_torch import capture

    capture.add_counts({k: -v for k, v in capture.read_counts().items()})


def read_counts() -> dict:
    """Every kernel's launch count; "K1_obstacle" counts K1's solves in
    obstacle mode (also counted under "K1")."""
    from tpunav_torch import capture

    return capture.read_counts()


# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): HBM3 bytes/s,
# and float32 and float64 operations/s outside the tensor cores (the
# eigensolver uses none).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12


def bound(nbytes: float, ops: float, peak: float = F32_OPS_PER_S):
    """(bound_ms, bound_by): the least time for ``nbytes`` of traffic and
    ``ops`` operations at the card's peak rates (``peak`` operations/s:
    float32 by default)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def k1_work(k: int, n: int, n_obs: int = 0):
    """K1's bytes (u, pose, goal, seed and the (O+1, 5) obstacle table in,
    u_next out) and the operations its function needs: per rollout and step
    about 171 — one Philox4x32-10 draw (~100 integer operations), one
    Box-Muller pair (~8), the RK4 step with its six cos/sin (~35), the loss
    (~17), the cost-to-go add and the softmax partial (~11) — and with O
    obstacle segments about 18·O for the segment distances (projection,
    clamp, offset, norm, min) plus 8 for the hit test and the field term."""
    table = 5 * (n_obs + 1) if n_obs else 0
    ops = 171.0 + (18.0 * n_obs + 8.0 if n_obs else 0.0)
    return 4 * (2 * n + 3 + 3 + 1 + table + 2 * n), ops * k * n


def jacobi_sweeps(a):
    """The sweeps that the eigensolver runs on each matrix of (..., S, S)
    ``a``, a diagnostic: the plain version's count, which stops by the
    kernel's rule."""
    from tpunav_torch.ops import sym_eig as se

    n = a.shape[-1]
    return se._jacobi(a.reshape(-1, n, n), None)[2].reshape(a.shape[:-2])


def eig_work(n: int, batch: int):
    """The eigendecomposition's bytes (each (n, n) float64 input read once,
    w and V written once) and the FP64 operations that the function needs,
    whatever the algorithm: a LAPACK-style solve (dsyevd) reduces A to
    tridiagonal form (4/3·n³) and carries the tridiagonal's eigenvectors
    back through the reflectors (2·n³); its tridiagonal solve and the other
    n² terms are left out, so the count is a floor."""
    return 8.0 * batch * (2 * n * n + n), batch * (4.0 / 3.0 + 2.0) * n ** 3


def demo_launches(demos: Demos, key: str) -> dict:
    """One kernel's measured launches in the demo phases, for the
    ``kernels`` line."""
    return {"launches_explore": demos.launches["explore"][key],
            "launches_full_stack": demos.launches["full_stack"][key],
            "launches_demos": {
                name: counts[key] for name, counts in demos.launches.items()
                if name not in ("explore", "full_stack")}}


def seed_batch_launches(demos: Demos, key: str) -> dict:
    """One kernel's measured launches in the ``seed_batch`` phase's
    courses (all SEED_BATCH seeds at once), for the ``kernels`` line."""
    return {"launches_seed_batch": {
        name[len("seed_batch_"):]: counts[key]
        for name, counts in demos.launches.items()
        if name.startswith("seed_batch_")}}


def graph_launches(cuda_graphs: CudaGraphs, key: str) -> dict:
    """One kernel's measured launches in the CUDA-graph phases, for the
    ``kernels`` line (a graph's launches counted on every replay)."""
    g = cuda_graphs.launches
    plain = {"launches_plain_course": g["plain_course"][key]}
    if key == "K1":
        return {"launches_graph_course": g["course"],
                "launches_graph_solves": g["solves"],
                "launches_graph_ekf": g["ekf"],
                "launches_graph_rbpf": g["rbpf"]["K1"], **plain}
    if key == "K1_obstacle":
        return {"launches_graph_course": {"config2": g["obstacle"]},
                "launches_graph_rbpf": g["rbpf"]["K1_obstacle"], **plain}
    return {"launches_graph_rbpf": g["rbpf"][key], **plain}


def node_launches(graphs: Graphs, key: str) -> dict:
    """One kernel's measured launches in each node graph that replays its
    steps (the node course's law, the RBPF node, the EKF nodes), for the
    ``kernels`` line."""
    return {"launches_node_graphs": {
        name: counts.get(key, 0)
        for name, counts in graphs.node_counts.items()}}


def main() -> int:
    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's card path cannot "
              "run here", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "tpunav_torch")):
        print(f"chip_smoke.py: no tpunav_torch/ beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    smoke = Smoke()
    smoke.build()
    smoke.injected()
    smoke.partials()
    smoke.in_kernel_philox()
    smoke.edge_probes()
    smoke.horizons()
    smoke.course()
    smoke.times()
    smoke.profile()
    rbpf = Rbpf(smoke.card)
    rbpf.lik_kernel()
    rbpf.map_kernel()
    rbpf.icp_kernel()
    rbpf.course()
    rbpf.times()
    rbpf.profile()
    obst = Obstacle(smoke)
    obst.kernel()
    obst.course()
    obst.planning()
    obst.times()
    obst.profile()
    ekf = Ekf(smoke)
    ekf.parity()
    ekf.rows_kernel()
    ekf.detector()
    ekf.sym_eig()
    ekf.course()
    ekf.dense()
    ekf.times()
    ekf.profile()
    cuda_graphs = CudaGraphs(smoke, rbpf, obst, ekf)
    cuda_graphs.course()
    cuda_graphs.solves()
    cuda_graphs.rbpf()
    cuda_graphs.ekf()
    cuda_graphs.collector()
    cuda_graphs.plain_course()
    graphs = Graphs(smoke, rbpf, ekf)
    graphs.node_course()
    graphs.slam_nodes()
    graphs.wrappers()
    graphs.two_process()
    graphs.checkpoint()
    sharded = Sharded(smoke, rbpf)
    sharded.mppi()
    sharded.rbpf()
    sharded.graph()
    demos = Demos(smoke)
    demos.explore()
    demos.full_stack()
    demos.rbpf_course()
    demos.lidar_ekf()
    demos.ekf_demo()
    demos.rbpf_stages()
    demos.seed_batch()
    kernel_times(smoke, rbpf, obst)
    emit("run", seconds=time.perf_counter() - started, card=smoke.card)

    main_row = smoke.timing[0]
    k1_ms, k1_by = bound(*k1_work(main_row["K"], main_row["N"]))
    kernels = [{
        "name": "fused_mppi (K1: mppi_rollout_partials + mppi_combine)",
        "route": "cuda",
        "source": "tpunav_torch/ops/csrc/fused_mppi.cu",
        "replaces": "tpunav/ops/pallas_mppi.py:72",
        "launches": smoke.course_launches,
        "max_abs_err": smoke.max_err,
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": k1_ms, "bound_by": k1_by, "library_ms": None,
        "launches_ekf_course": ekf.k1_course,
        "launches_dense_world": ekf.k1_dense,
        "launches_node_course": graphs.k1_course,
        "launches_slam_nodes": graphs.slam_counts["K1"],
        **node_launches(graphs, "K1"),
        "launches_sharded": sharded.launches["K1"],
        **demo_launches(demos, "K1"),
        **graph_launches(cuda_graphs, "K1"),
        **seed_batch_launches(demos, "K1"),
        "seed_batch_timing": [{k: row[k] for k in (
            "B", "K", "N", "blocks", "ms", "single_launches_ms", "plain_ms",
            "device_us", "bound_ms", "bound_by")} for row in demos.seed_k1],
    }]
    for key, name, source, replaces in [
            ("K2", "likelihood_field (K2)", "likelihood.cu",
             "tpunav/ops/pallas_likelihood.py:63"),
            ("K3", "map_update (K3: grid update + EDT)", "map_update.cu",
             "tpunav/ops/pallas_map_update.py:54"),
            ("K4", "edt (K4)", "map_update.cu",
             "tpunav/ops/pallas_map_update.py:177")]:
        row = rbpf.timing[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tpunav_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": rbpf.counts[key],
            "max_abs_err": rbpf.max_err[key], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "launches_slam_nodes": graphs.slam_counts[key],
            **node_launches(graphs, key),
            "launches_sharded": sharded.launches[key],
            **demo_launches(demos, key),
            **graph_launches(cuda_graphs, key)})
    obst_row = obst.timing[0]                  # K=4,096, O=4: the course's
    ob_ms, ob_by = bound(*k1_work(obst_row["K"], obst_row["N"],
                                  obst_row["O"]))
    kernels.append({
        "name": "fused_mppi obstacle mode (K1)", "route": "cuda",
        "source": "tpunav_torch/ops/csrc/fused_mppi.cu",
        "replaces": "tpunav/ops/pallas_mppi.py:149",
        "launches": obst.launches, "max_abs_err": obst.max_err,
        "ms": obst_row["kernel_ms"], "plain_ms": obst_row["plain_ms"],
        "bound_ms": ob_ms, "bound_by": ob_by, "library_ms": None,
        "launches_sharded": sharded.launches["K1_obstacle"],
        **demo_launches(demos, "K1_obstacle"),
        **graph_launches(cuda_graphs, "K1_obstacle")})
    det = ekf.eig_rows[0]                # the detector's (32, 4, 4) batch
    kernels.append({
        "name": "sym_eig (batched Jacobi eigensolver)", "route": "cuda",
        "source": "tpunav_torch/ops/csrc/sym_eig.cu",
        "replaces": "tpunav/estimation/landmarks.py:130,146 and "
                    "tpunav/estimation/ekf/spd.py:36 (jnp.linalg.eigh, "
                    "XLA's; no Pallas kernel)",
        "launches": ekf.eig_dense, "max_abs_err": ekf.eig_max_err,
        "ms": det["ms"], "plain_ms": det["plain_ms"],
        "bound_ms": det["bound_ms"], "bound_by": det["bound_by"],
        "library_ms": det["library_ms"],
        "launches_slam_nodes": graphs.slam_counts["EIG"],
        **node_launches(graphs, "EIG"),
        "launches_graph_ekf_update_alone": cuda_graphs.launches["ekf_eig"],
        **demo_launches(demos, "EIG"),
        **seed_batch_launches(demos, "EIG"),
        "by_shape": [{k: r.get(k) for k in (
            "case", "shape", "layout", "ms", "plain_ms", "library_ms",
            "device_us", "device_event_us", "bound_ms", "bound_by",
            "gated_off_device_event_us")}
            for r in ekf.eig_rows]})
    icp = rbpf.icp_rows[0]               # the course's 25 iterations
    kernels.append({
        "name": "icp (a whole scan match in one launch)", "route": "cuda",
        "source": "tpunav_torch/ops/csrc/icp.cu",
        "replaces": "tpunav/estimation/rbpf/icp.py (XLA's lax.scan over the "
                    "iterations; no Pallas kernel)",
        "launches": rbpf.counts["ICP"], "max_abs_err": rbpf.max_err["ICP"],
        "ms": icp["ms"], "plain_ms": icp["plain_ms"],
        "bound_ms": icp["bound_ms"], "bound_by": icp["bound_by"],
        "library_ms": None,
        "launches_slam_nodes": graphs.slam_counts["ICP"],
        **node_launches(graphs, "ICP"),
        "launches_sharded": sharded.launches["ICP"],
        **demo_launches(demos, "ICP"),
        **graph_launches(cuda_graphs, "ICP"),
        "by_iterations": rbpf.icp_rows})
    rt = ekf.rows_timing                 # config 4's 20 states, unknown DA
    kernels.append({
        "name": "ekf_step (a whole filter step in one launch)",
        "route": "cuda",
        "source": "tpunav_torch/ops/csrc/ekf_rows.cu",
        "replaces": "tpunav/estimation/ekf/filter.py (XLA's; no Pallas "
                    "kernel)",
        "launches": ekf.ekf_course, "max_abs_err": ekf.rows_err,
        "ms": rt["ms"], "plain_ms": rt["row_chain_ms"],
        "plain_cpu_ms": rt["plain_cpu_ms"], "bound_ms": rt["bound_ms"],
        "bound_by": rt["bound_by"], "library_ms": None,
        "launches_dense_world": ekf.ekf_dense,
        "launches_slam_nodes": graphs.slam_counts["EKF"],
        **node_launches(graphs, "EKF"),
        "launches_graph_ekf_update_alone": cuda_graphs.launches["ekf_step"],
        **demo_launches(demos, "EKF"),
        **graph_launches(cuda_graphs, "EKF"),
        **seed_batch_launches(demos, "EKF"),
        "launches_per_replay": rt["launches_per_replay"]})
    print(json.dumps({"kernels": kernels}))
    print(smoke.card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
