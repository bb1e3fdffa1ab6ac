"""Drive the PyTorch + CUDA port (``tpunav_torch``) once on a CUDA card.

    python3 chip_smoke.py

Builds kernel K1 (the fused MPPI solve, ``tpunav_torch/ops/csrc/``) from
source with nvcc, checks it against its plain PyTorch version on the card,
then runs the MPPI waypoint course (the demo's flagship configuration:
configs/mppi_params.yaml at horizon 0.5 s and K=4,096, the pentagon of
configs/real_waypoints.yaml) through the fused kernel, and times the
kernel beside its plain version. Each phase prints one JSON line; any
failure raises and the script exits non-zero. It needs CUDA and has no
CPU path. The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
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
             torch=torch.__version__, cuda=torch.version.cuda)
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
        self.fm.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        st = run_course_chunked(cfg, course, self.model, waypoints, st,
                                chunk=chunk, on_chunk=on_chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = self.fm.KERNEL_LAUNCHES
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

    def time_ms(self, fn, reps=30, warmup=5):
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
                "kernel_ms": self.time_ms(lambda: self.fm.mppi_solve_fused(
                    cfg, self.model, u, seed, pose, xd)),
                "plain_ms": self.time_ms(lambda: self.plain(
                    cfg, u, seed, pose, xd)),
                "plain_solver_ms": self.time_ms(lambda: self.mppi.mppi_solve(
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
    main_row = smoke.timing[0]
    print(json.dumps({"kernels": [{
        "name": "fused_mppi (K1: mppi_rollout_partials + mppi_combine)",
        "route": "cuda",
        "source": "tpunav_torch/ops/csrc/fused_mppi.cu",
        "replaces": "tpunav/ops/pallas_mppi.py:72",
        "launches": smoke.course_launches,
        "max_abs_err": smoke.max_err,
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
    }]}))
    print(smoke.card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
