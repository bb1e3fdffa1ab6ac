"""Drive the PyTorch + CUDA port (``tpunav_torch``) once on a CUDA card.

    python3 chip_smoke.py

Builds the port's kernels (``tpunav_torch/ops/csrc/``) from source with
nvcc: K1 the fused MPPI solve (with its obstacle mode), K2 the likelihood
field, K3 the map update with its distance field, K4 the distance field
alone. Checks each against its plain PyTorch version on the card, then
drives the port's three paths:

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

and times every kernel beside its plain version. Each phase prints one
JSON line; any failure raises and the script exits non-zero. It needs
CUDA and has no CPU path. The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
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

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(ROOT, "configs")
BAR = 2e-4                 # K1 vs its plain version: max |Δ| on cmd, u_next[:-1]
POSE = (0.1, -0.2, 0.3)
XD = (1.0, 1.0, 0.0)
# examples/obstacle_mppi_demo.py: the wall, the course's ends and weights.
WALL = [[[0.95, 0.7], [1.05, 0.7], [1.05, 1.3], [0.95, 1.3]]]
START, GOAL = (0.2, 1.0), (1.8, 1.0)
NEAR_TIE_ULPS = 16


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
        for k, u_off in [(4096, (0.0, 0.0)), (49152, (0.0, 0.0)),
                         (4096, (1.5, -0.5))]:
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
        steady = ((ticks - chunk) / (marks[-1] - marks[0])
                  if len(marks) > 1 else None)
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
        for k in (4096, 49152):
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
        """Device time by kernel (torch.profiler): per fused solve at each
        K, and per tick of the flagship course, with the device's idle
        share against the unprofiled steady tick time of the course."""
        from tpunav_torch.control.waypoint_loop import course_tick

        t0 = time.perf_counter()
        solves = {}
        for k in (4096, 49152):
            cfg = self.cfg(k)
            u, pose, xd, _ = self.tensors(cfg)
            seed = torch.tensor(5, dtype=torch.int32, device=self.dev)
            kern = profile_device(lambda: self.fm.mppi_solve_fused(
                cfg, self.model, u, seed, pose, xd), 20)
            solves[k] = {name: us / 20 for name, (us, _) in kern.items()
                         if "mppi_" in name}
        cfg, course, wpts, st = self.flagship()
        box = [st]

        def tick():
            box[0] = course_tick(cfg, course, self.model, wpts, box[0])

        for _ in range(10):
            tick()
        ticks = 120
        kern = profile_device(tick, ticks)
        busy = sum(us for us, _ in kern.values()) / ticks
        tick_us = 1e6 / self.steady if self.steady else None
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
        emit("profile", seconds=time.perf_counter() - t0,
             card=self.card, solve_device_us=solves,
             course_ticks=ticks, device_us_per_tick=busy,
             kernels_per_tick=sum(c for _, c in kern.values()) / ticks,
             unprofiled_tick_us=tick_us,
             device_idle_share=None if tick_us is None else 1 - busy / tick_us,
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
        (tests_tpu/test_tpu_gate.py:257-259), at the gate's shapes and at
        the course's (k+1 = 51 samples per particle)."""
        t0 = time.perf_counter()
        cases = []
        for gcfg, p, k in [(self.g80, 8, 12), (self.g80, 500, 50),
                           (self.g80, 500, 51), (self.g160, 40, 50)]:
            scan, poses, grids, gen = self.world(gcfg, p)
            dists = self.grid.esdf(gcfg, grids)
            if p == 8:
                dists[-1] = gcfg.max_occ_dist          # an empty map
            samples = (poses[:, None, :] + 0.01 * torch.randn(
                (p, k, 3), generator=gen, device=self.dev)).contiguous()
            got = self.lik.likelihood_field_batch(gcfg, dists, scan, samples)
            want = self.lik._lik_reference(gcfg, dists, scan, samples)
            torch.cuda.synchronize()
            err = (got - want).abs()
            row = {"P": p, "k": k, "map": gcfg.height,
                   "max_abs_err": float(err.max()),
                   "p99_abs_err": float(torch.quantile(err.flatten(), 0.99)),
                   "share_above_1e-4": float((err > 1e-4).float().mean())}
            if not (row["p99_abs_err"] <= 1e-4 and row["max_abs_err"] <= 0.05
                    and row["share_above_1e-4"] <= 0.01
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(f"K2 vs plain out of bounds: {row}")
            if p == 8 and not bool((got[-1] == 0.0).all()):
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
        bit for bit against K3's fields."""
        t0 = time.perf_counter()
        cases = []
        for gcfg, p in [(self.g80, 8), (self.g80, 500), (self.g160, 40)]:
            scan, poses, grids, _ = self.world(gcfg, p)
            beam = torch.empty(grids.shape, dtype=torch.int32, device=self.dev)
            g_k, d_k = self.mu.map_update_batch(gcfg, grids, scan, poses,
                                                beam_out=beam)
            g_p, d_p = self.mu._map_update_reference(gcfg, grids, scan, poses)
            _, beam_p = self.mu._beam_index_reference(gcfg, poses)
            d_alone = self.mu.edt_batch(gcfg, g_k)
            torch.cuda.synchronize()
            torch.testing.assert_close(g_k, g_p, rtol=1e-4, atol=1e-3)
            torch.testing.assert_close(d_k, d_p, rtol=0, atol=1e-4)
            row = {"P": p, "map": gcfg.height,
                   "grid_max_abs_err": float((g_k - g_p).abs().max()),
                   "dist_max_abs_err": float((d_k - d_p).abs().max()),
                   "beam_index_mismatches": int((beam.long() != beam_p).sum()),
                   "k4_bit_identical": bool(torch.equal(d_alone, d_k)),
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

    def course_inputs(self, seed: int = 7):
        """The demo's and bench's course (examples/rbpf_slam_demo.py,
        bench.py:bench_rbpf): an arc at u = (0.03 rad, 0.02 m) per update
        inside walls at ±1.8 m, 360-beam scans with 2 mm range noise drawn
        from a generator seeded with ``seed``, odometry = ground truth. Made
        up front, as scans arrive."""
        u = torch.tensor([0.03, 0.02], device=self.dev)
        segs = self.lidar.box_segments(-1.8, -1.8, 1.8, 1.8, device=self.dev)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(seed)
        g = self.g80
        pose = torch.zeros(3, device=self.dev)
        scans, odoms = [], []
        for _ in range(self.UPDATES):
            th = pose[0] + u[0]
            pose = torch.stack([th, pose[1] + u[1] * torch.cos(th),
                                pose[2] + u[1] * torch.sin(th)])
            odoms.append(pose)
            scans.append(self.lidar.scan_segments(
                pose, segs, num_beams=g.num_beams, beam_min=g.beam_min,
                beam_delta=g.beam_delta, max_range=g.range_max,
                generator=gen, noise_std=0.002))
        prevs = [torch.zeros(3, device=self.dev)] + odoms[:-1]
        return u, scans, odoms, prevs

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
        want = {"K1": 0, "K2": self.UPDATES, "K3": self.UPDATES, "K4": 1}
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
        # the mixture with its sum (7); cos and sin per sample.
        k2 = (4 * (p * hw + p * k * 3 + b + p * k), p * k * (25 * valid + 2))
        # An exact EDT needs O(1) work per cell, whatever these kernels'
        # O(H) column pass spends: the two row sweeps and the square (5);
        # a linear-time lower envelope down each column, where each cell
        # enters and leaves the envelope once, at most two intersection
        # tests of ~8 operations (16), and its evaluation (4); sqrt·res
        # and the cap (3).
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
        tags = {"K2": "likelihood_field_kernel", "K3": "map_update_kernel",
                "K4": "edt_kernel"}
        work = self.work(scan, k)
        rows = {}
        for name, (kernel, plain) in fns.items():
            bound_ms, bound_by = bound(*work[name])
            # The kernel's own device time (the event time above also holds
            # the wrapper's table-building launches and host gaps).
            kern = profile_device(kernel, 10)
            device_us = sum(us for key, (us, _) in kern.items()
                            if tags[name] in key) / 10
            rows[name] = {"ms": time_ms(kernel), "plain_ms": time_ms(plain),
                          "device_us": device_us,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "bytes": work[name][0], "ops": work[name][1]}
        self.timing = rows
        emit("rbpf_times", seconds=time.perf_counter() - t0, reps=30,
             P=self.P, k=k, map=g.height, card=self.card, rows=rows)

    def profile(self):
        """torch.profiler over 20 steady updates of a fresh course: device
        µs per update by kernel, launches per update, and the device's idle
        share against the unprofiled ms per update of the course."""
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
        n = 20
        kern = profile_device(update, n)
        busy = sum(us for us, _ in kern.values()) / n
        ours = {name: sum(us for key, (us, _) in kern.items() if tag in key)
                / n for name, tag in [("K2", "likelihood_field_kernel"),
                                      ("K3", "map_update_kernel"),
                                      ("K4", "edt_kernel")]}
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
        icp = profile_device(lambda: icp_match(self.cfg.icp, src, src_ok, dst,
                                               dst_ok, guess), 5)
        emit("rbpf_profile", seconds=time.perf_counter() - t0,
             card=self.card, updates=n, device_us_per_update=busy,
             kernel_device_us_per_update=ours,
             launches_per_update=sum(c for _, c in kern.values()) / n,
             icp_launches_per_match=sum(c for _, c in icp.values()) / 5,
             icp_device_us_per_match=sum(us for us, _ in icp.values()) / 5,
             unprofiled_update_us=update_us,
             device_idle_share=1 - busy / update_us,
             top_kernels_us_per_update={name[:60]: us / n
                                        for name, (us, _) in top})


class Obstacle:
    """BASELINE config 2: K1's obstacle mode against its plain version, the
    demo's obstacle course through it, the planning package on the card,
    and the mode's event times and profile."""

    U_OFF = (2.0, 2.0)     # a nominal 0.066 m/s forward, into the obstacles

    def __init__(self, smoke: Smoke):
        from tpunav_torch import planning
        from tpunav_torch.control import obstacle_cost as oc

        self.s, self.oc, self.plan = smoke, oc, planning
        self.fm, self.dev, self.card = smoke.fm, smoke.dev, smoke.card
        self.demo = oc.SegmentCostParams(r_safe=0.1, w_hit=1e7, w_field=2e3,
                                         sigma=0.05)
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
            "demo_wall": (oc.segments_from_polygons(WALL, device=self.dev),
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
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("non-finite controls from the kernel")
        if float(got.abs().max()) > cfg.max_wheel_vel:
            raise AssertionError("controls not clamped")
        if noise is None:
            noise = self.s.philox.mppi_noise(seed_t, cfg.rollouts, cfg.steps,
                                             float(cfg.ul_var) ** 0.5,
                                             float(cfg.ur_var) ** 0.5)
        cost = self.oc.make_segment_obstacle_cost(params, segs,
                                                  device=self.dev)
        tie, slack = rounding_slack(self.s.mppi, cfg, self.s.model, u, pose,
                                    xd, noise, cost)
        err = (got - plain).abs().cpu().numpy()
        bad = (err > BAR).any(axis=1)
        ok = tie | (err <= BAR + slack).all(axis=1)
        if not ok[bad].all():
            rows = np.nonzero(bad & ~ok)[0].tolist()
            raise AssertionError(f"K1 obstacle mode vs plain: rows {rows} "
                                 f"above {BAR} at K={cfg.rollouts} ({name})")
        kept = err[~bad]
        return (float(kept.max()) if kept.size else 0.0, int(bad.sum()),
                float(err.max()))

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

        plan, t_plan = self.plan, time.perf_counter()
        world = plan.load_obstacle_map(WALL, bounds=[[0.0, 2.0], [0.0, 2.0]],
                                       resolution=0.05)
        rm = plan.RoadMap(world, n_nodes=80, k_neighbors=10, clearance=0.18,
                          seed=2)
        route = plan.theta_star(rm, rm.add_node(START), rm.add_node(GOAL))
        if route is None:
            raise AssertionError("Theta* found no route around the wall")
        plan_s = time.perf_counter() - t_plan
        wpts = np.asarray(route, np.float32)[1:]      # skip the start node
        waypoints = torch.tensor(np.concatenate(
            [wpts, np.zeros((len(wpts), 1), np.float32)], axis=1),
            device=self.dev)
        segs = self.oc.segments_from_polygons(WALL, device=self.dev)
        cfg = self.s.mppi.MPPIConfig(horizon=0.5, dt=0.01, rollouts=4096)
        course = CourseConfig(goal_thresh=0.1, tick_dt=1.0 / 60.0,
                              max_ticks=20_000, use_fused=True)
        st = course_init(cfg, torch.tensor([START[0], START[1], 0.0]),
                         seed=0, device=self.dev)
        chunk, marks, clear = 240, [], [math.inf]

        def on_chunk(s, tel):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            clear[0] = min(clear[0], wall_clearance(tel["pose"].cpu()))

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
        if counts != {"K1": ticks, "K2": 0, "K3": 0, "K4": 0}:
            raise AssertionError(f"launches {counts} for {ticks} ticks: the "
                                 "course did not run on K1")
        steady = ((ticks - chunk) / (marks[-1] - marks[0])
                  if len(marks) > 1 else None)
        self.course_cfg = (cfg, course, waypoints, segs)
        self.launches, self.steady = counts["K1"], steady
        emit("obstacle_course", seconds=wall, K=cfg.rollouts, N=cfg.steps,
             obstacles=int(segs.shape[0]), route=np.round(route, 4).tolist(),
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
        without obstacles (in-kernel Philox), and device µs per launch from
        torch.profiler, at K=4,096 and 49,152 for O=4 and O=41."""
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

                prof = profile_device(kern, 20)
                rows.append({
                    "K": k, "N": cfg.steps, "O": int(segs.shape[0]),
                    "kernel_ms": time_ms(kern),
                    "plain_ms": time_ms(plain, reps=10, warmup=2),
                    "no_obstacle_kernel_ms": time_ms(
                        lambda: fm.mppi_solve_fused(cfg, self.s.model, u,
                                                    seed, pose, xd)),
                    "device_us": {n: us / 20 for n, (us, _) in prof.items()
                                  if "mppi_" in n}})
        self.timing = rows
        emit("obstacle_times", seconds=time.perf_counter() - t0, reps=30,
             card=self.card, rows=rows)

    def profile(self):
        """torch.profiler over 120 steady ticks of the obstacle course:
        device µs and launches per tick, and the device's idle share
        against the course's unprofiled steady tick time."""
        from tpunav_torch.control.waypoint_loop import (_tick, course_init)

        t0 = time.perf_counter()
        cfg, course, wpts, segs = self.course_cfg
        table = self.fm.pack_obstacles(segs, self.demo, self.dev)
        box = [course_init(cfg, torch.tensor([START[0], START[1], 0.0]),
                           seed=1, device=self.dev)]

        def tick():
            box[0] = _tick(cfg, course, self.s.model, wpts, box[0], None,
                           table)

        for _ in range(10):
            tick()
        ticks = 120
        kern = profile_device(tick, ticks)
        busy = sum(us for us, _ in kern.values()) / ticks
        tick_us = 1e6 / self.steady if self.steady else None
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
        emit("obstacle_profile", seconds=time.perf_counter() - t0,
             card=self.card, course_ticks=ticks, device_us_per_tick=busy,
             kernels_per_tick=sum(c for _, c in kern.values()) / ticks,
             unprofiled_tick_us=tick_us,
             device_idle_share=None if tick_us is None else 1 - busy / tick_us,
             top_kernels_us_per_tick={name[:60]: us / ticks
                                      for name, (us, _) in top})


def wall_clearance(poses) -> float:
    """The executed poses' closest approach to the demo's wall, 0 inside it
    (examples/obstacle_mppi_demo.py:61-70)."""
    p = poses.numpy()
    dx = np.clip(p[:, 0], 0.95, 1.05) - p[:, 0]
    dy = np.clip(p[:, 1], 0.7, 1.3) - p[:, 1]
    d = np.hypot(dx, dy)
    d[(np.abs(p[:, 0] - 1.0) < 0.05) & (np.abs(p[:, 1] - 1.0) < 0.3)] = 0.0
    return float(d.min())


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

    two = torch.topk(j, 2, dim=1, largest=False).values
    tie = (two[:, 1] - two[:, 0]) < ulps[:, 0] * ulp(two[:, 0])
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
            name = next((k for k in ("mppi_combine", "mppi_rollout_partials",
                                     "likelihood_field_kernel",
                                     "map_update_kernel", "edt_kernel")
                         if k in m.group(1)), m.group(1))
        elif name and ("spill" in line or "Used" in line):
            out[name] = (out.get(name, "") + " " + line.strip()).strip()
    return out


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    from tpunav_torch.ops import fused_mppi, likelihood, map_update

    fused_mppi.KERNEL_LAUNCHES = 0
    likelihood.LIK_LAUNCHES = 0
    map_update.MAP_LAUNCHES = 0
    map_update.EDT_LAUNCHES = 0


def read_counts() -> dict:
    from tpunav_torch.ops import fused_mppi, likelihood, map_update

    return {"K1": fused_mppi.KERNEL_LAUNCHES, "K2": likelihood.LIK_LAUNCHES,
            "K3": map_update.MAP_LAUNCHES, "K4": map_update.EDT_LAUNCHES}


# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): HBM3 bytes/s
# and float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the least time for ``nbytes`` of traffic and
    ``ops`` float32 operations at the card's peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def k1_work(k: int, n: int, n_obs: int = 0):
    """K1's bytes (u, pose, goal, seed and the (O+1, 5) obstacle table in,
    u_next out) and the operations its function needs: per rollout and step
    about 171 — one Philox4x32-10 draw (~100 integer operations; the
    kernel's replay of it in the reduction is its own design's cost), one
    Box-Muller pair (~8), the RK4 step with its six cos/sin (~35), the loss
    (~17), the cost-to-go add and the softmax partial (~11) — and with O
    obstacle segments about 18·O for the segment distances (projection,
    clamp, offset, norm, min) plus 8 for the hit test and the field term."""
    table = 5 * (n_obs + 1) if n_obs else 0
    ops = 171.0 + (18.0 * n_obs + 8.0 if n_obs else 0.0)
    return 4 * (2 * n + 3 + 3 + 1 + table + 2 * n), ops * k * n


def device_kernels(prof):
    """{kernel name: (device µs, launches)} from a torch.profiler run."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        if us > 0:
            out[e.key] = (us, e.count)
    return out


def profile_device(fn, reps):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return device_kernels(prof)


def main() -> int:
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
    smoke.course()
    smoke.times()
    smoke.profile()
    rbpf = Rbpf(smoke.card)
    rbpf.lik_kernel()
    rbpf.map_kernel()
    rbpf.course()
    rbpf.times()
    rbpf.profile()
    obst = Obstacle(smoke)
    obst.kernel()
    obst.course()
    obst.planning()
    obst.times()
    obst.profile()

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
            "bound_by": row["bound_by"], "library_ms": None})
    obst_row = obst.timing[0]                  # K=4,096, O=4: the course's
    ob_ms, ob_by = bound(*k1_work(obst_row["K"], obst_row["N"],
                                  obst_row["O"]))
    kernels.append({
        "name": "fused_mppi obstacle mode (K1)", "route": "cuda",
        "source": "tpunav_torch/ops/csrc/fused_mppi.cu",
        "replaces": "tpunav/ops/pallas_mppi.py:149",
        "launches": obst.launches, "max_abs_err": obst.max_err,
        "ms": obst_row["kernel_ms"], "plain_ms": obst_row["plain_ms"],
        "bound_ms": ob_ms, "bound_by": ob_by, "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smoke.card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
