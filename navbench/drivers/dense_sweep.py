"""BASELINE config 4's seed sweeps through the program's public course
runner.

The system under test is ``tpunav_torch.control.slam_loop.SlamCourseRunner``
on a seed batch, built from ``tpunav_torch.sim.dense_world``: every tick
the filter's pose, the waypoint advance and the plant mapped over B seeds
around one K1 launch for the B solves, and on every sensing tick the lidar
raycast, the circle detector (its eigensolver one call for the B scans)
and the masked unknown-DA EKF. ``chunk_ticks`` ticks are captured as one
CUDA graph, the sweep's last ticks as one shorter graph; a timed step is
one replay and one host read of its telemetry rows (B × its ticks
solves). Sweeps of ``sweep_ticks`` run back to back, each of B seeds drawn
from the run's seed (the generator's seed and the tick count that keys
K1's Philox stream) and loaded into the runner's buffers in place, so
nothing is captured in the window. The tracer (``runtime.profiling``) is on
from before the capture: its phases ``slam.sense`` and ``ekf.update`` give
the per-layer device times.

The check follows the program from its own state. Each step's rows hold,
after every tick, the filter's and the plant's poses, the landmarks
tracked, the shifted nominal controls and the waypoint state, so every tick
of a sampled step's checked seeds (all of them in the first sampled step)
is held to the plain reference from the program's state before it: the
waypoint advance exactly, the float64 solve (``reference/mppi.py`` on the
frozen Philox stream) through the plant's pose beyond the first row's slack
and the shifted controls beyond their rows' slack, over the rows that are
no near-tie (two best rollouts within rounding). A closed loop of the
reference cannot be compared with the program's: at this temperature a
micrometre of pose moves a rollout's weight by a fifth, so two float32
loops part within a few ticks. The filter (``reference/ekf_dense.py``) is
chained from the step's start, driven by the program's own course (the
twist of the reference's command from the program's state; the scans at
the program's poses on the normals drawn again from the generators' saved
states), for every seed of the first sampled step and a few of each later
one (``seeds_chained``), and its pose and tracked count are held to the
program's up to its first near-tie (a solve's first row; a Mahalanobis
gate; a ray that grazes a cylinder where its other side changes which
slots hold a circle; a range at either end of the valid span); where none
came, its mean, covariance and slots in use at the step's end too, and the
share of the chained seeds whose last rows part. Each sensing tick's
circles, as the replayed graph's sensor chain handed them to the filter
(the rows carry them), are held to the reference detector's at the
program's pose on the same scan; where a ray grazes a cylinder without
changing the slots, to the nearer of the scan's two readings.

``failed`` counts the seed-ticks of a step whose row holds a value that is
not finite (the circles' empty slots, NaN by design, aside), and every
tick of a seed whose sweep ends with the filter's position more than
``sweep_bar_m`` from the truth.

``trace_info()`` hands the per-layer readers ``k``, ``n`` and ``b`` (K1's
rollouts, steps and problems a launch) and ``phases``, the tracer's
``profiling.summary()["phases"]`` over the window's replays taken without
the profiler (``slam.sense`` and ``ekf.update``: count, missed, mean_ms,
offset_ms).
"""

from __future__ import annotations

import math

import torch

from ..reference import ekf_dense as ref
from ..reference import mppi
from . import _mppi

# The telemetry row: the filter's pose [θ, x, y], the plant's [x, y, θ],
# the landmarks tracked, the nominal controls after the shift (N, 2), the
# waypoint index, the visits and the done flag; then, on a sensing tick,
# the (C, 2) circles the sensor chain handed the filter (zeros otherwise).
FILTER, PLANT, COUNT, U = slice(0, 3), slice(3, 6), 6, 7


class _Telemetry:
    """The program's sensor chain, and the telemetry row that carries its
    circles out of the graph. ``sensor`` is the deployment's ``meas_fn``
    with its output kept; ``row``, called by the program after the same
    tick's filter step (inside the mapped body), appends it to the row and
    lets it go, so a tick that sensed nothing gets zeros."""

    def __init__(self, meas_fn, clusters: int):
        self.meas_fn, self.width = meas_fn, 2 * clusters
        self.kept = None

    def sensor(self, true_txy, generator, noise=None):
        self.kept = self.meas_fn(true_txy, generator, noise=noise)
        return self.kept

    def row(self, st):
        f = torch.float32
        circles, self.kept = self.kept, None
        circles = (st.true_pose.new_zeros(self.width) if circles is None
                   else circles.flatten())
        return torch.cat([st.ekf.state[:3], st.true_pose,
                          st.ekf.count.to(f)[None], st.u.flatten(),
                          torch.stack([st.wpt_idx.to(f), st.visits.to(f),
                                       st.done.to(f)]), circles])


def _same_world(cfg: dict, dep) -> None:
    """The configuration file describes the program's deployment; both
    must agree."""
    lms, wpts = ref.world(cfg)
    mp, ekf, loop = dep.mppi, dep.ekf, dep.loop
    want = {
        "landmarks": (lms.shape[0], dep.landmarks.shape[0]),
        "world": (lms, dep.landmarks.cpu()),
        "waypoints": (wpts, dep.waypoints.cpu()),
        "start": (cfg["start"], dep.start),
        "beams": (cfg["beams"], dep.meas_shape[0]),
        "landmark_capacity": (cfg["landmark_capacity"], ekf.num_landmarks),
        "gates": ((cfg["dmin"], cfg["dmax"]), (ekf.dmin, ekf.dmax)),
        "covariances": ((cfg["pose_cov_init"], cfg["lm_cov_init"]),
                        (ekf.pose_cov_init, ekf.lm_cov_init)),
        "motion_noise": (cfg["motion_noise"], ekf.motion_noise),
        "measurement_noise": (cfg["measurement_noise"],
                              ekf.measurement_noise),
        "loop": ((cfg["goal_thresh"], cfg["cycles"], cfg["sensor_every"],
                  cfg["tick_dt"], *cfg["odom_bias"], cfg["fused_seed"]),
                 (loop.goal_thresh, loop.cycles, loop.sensor_every,
                  loop.tick_dt, *loop.odom_bias, loop.fused_seed)),
        "mppi": ((cfg["lambda"], cfg["ul_var"], cfg["ur_var"],
                  cfg["horizon"], cfg["time_step"], *cfg["Q"], *cfg["R"],
                  *cfg["P1"], cfg["max_rot_motor"], cfg["ul_init"],
                  cfg["ur_init"]),
                 (mp.lambda_, mp.ul_var, mp.ur_var, mp.horizon, mp.dt,
                  *mp.q_diag, *mp.r_diag, *mp.p1_diag, mp.max_wheel_vel,
                  *mp.u_init)),
        "cart": ((cfg["wheel_radius"], cfg["wheel_base"]),
                 (dep.model.wheel_radius, dep.model.wheel_base)),
    }
    if loop.known_da or not loop.use_fused or ekf.spd_repair:
        raise ValueError("the program's config 4 is not the unknown-DA "
                         "loop on K1 without the SPD repair")
    for key, (a, b) in want.items():
        a = torch.as_tensor(a, dtype=torch.float64).flatten()
        b = torch.as_tensor(b, dtype=torch.float64).flatten()
        if a.shape != b.shape or not torch.allclose(a, b, rtol=1e-6,
                                                    atol=1e-6):
            raise ValueError(f"configuration {key} is not the program's")


def draws(seed: int, sweeps: int, b: int, device):
    """Each sweep's B seeds (the generators' seeds, a list of lists) and
    K1 seed bases ((sweeps, B) int32), drawn from the run's seed, and the
    generator that drew them (the driver draws its samples next)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    seeds = torch.randint(0, 2 ** 62, (sweeps, b), generator=gen,
                          device=device).tolist()
    tick0 = torch.randint(0, 2 ** 30, (sweeps, b), generator=gen,
                          device=device, dtype=torch.int32)
    return seeds, tick0, gen


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        # The public runner first: a program without it fails here, at
        # once.
        from tpunav_torch.control.slam_loop import (SlamCourseRunner,
                                                    course_plan,
                                                    slam_batch_init)
        from tpunav_torch.runtime import profiling
        from tpunav_torch.sim import dense_world

        self.profiling = profiling
        self.b = mix.get("seeds_per_sweep", cfg["sweep_seeds"])
        self.k = mix.get("rollouts", cfg["rollouts"])
        self.sweep_ticks = mix.get("sweep_ticks", cfg["sweep_ticks"])
        self.c = dict(cfg, **mix["ties"])
        self.m = _mppi.plain(cfg)
        self.limits = mix["limits"]
        self.bar = mix["sweep_bar_m"]
        self.parted_m = mix["parted_m"]
        self.device = device
        dep = dense_world.deployment(self.k, device)
        _same_world(cfg, dep)

        b = self.b
        self.seeds, self.tick0, gen = draws(seed, mix["sweeps"], b, device)
        self.sampled = _mppi.sample_steps(gen, *mix["check_steps"])
        # Each sampled step: the seeds whose ticks are checked and those
        # whose filter is chained (all of them in the first).
        self.checked = {}
        for i, s in enumerate(self.sampled):
            perm = torch.randperm(b, generator=gen, device=device).tolist()
            self.checked[s] = (
                (list(range(b)),) * 2 if i == 0 else
                (sorted(perm[:mix["seeds_checked"]]),
                 sorted(perm[:mix["seeds_chained"]])))

        profiling.enable(True)
        self.st0 = slam_batch_init(dep.mppi, dep.ekf, [0] * b,
                                   pose_xyt=list(dep.start), device=device)
        chunk, tail, self.plan = course_plan(self.sweep_ticks,
                                             mix["chunk_ticks"])
        tel = _Telemetry(dep.meas_fn, cfg["max_clusters"])
        self.circles = slice(-tel.width, None)
        self.runner = SlamCourseRunner(
            dep.mppi, dep.ekf, dep.loop, dep.model, dep.waypoints,
            dep.landmarks, self.st0, chunk=chunk, tail=tail,
            meas_fn=tel.sensor, meas_shape=dep.meas_shape,
            telemetry=tel.row, device=device)
        # Each graph's warm-up (eager) and capture, then the first sweep
        # from its start on a fresh record of the tracer.
        self._load(0)
        for last in sorted(set(self.plan)):
            self.runner.run(tail=last)
            self.runner.run(tail=last)
        self._load(0)
        self.runner.rows.tolist()
        profiling.enable(True)
        self.steps = self.solves = self.failed = 0
        self.records = []
        self.sweep_errors = []      # each ended sweep's worst, in metres
        self.summary = None

    def _load(self, s: int) -> None:
        j = s % len(self.seeds)
        for g, seed in zip(self.st0.generator, self.seeds[j]):
            g.manual_seed(seed)
        self.st0.ticks.copy_(self.tick0[j])
        self.runner.load(self.st0)
        self.sweep, self.pos = s, 0

    def _snapshot(self) -> dict:
        st = self.runner.state
        out = {f: getattr(st, f).clone() for f in (
            "true_pose", "odom", "u", "wpt_idx", "visits", "ticks", "done")}
        out.update(mu=st.ekf.state.clone(), cov=st.ekf.cov.clone(),
                   active=st.ekf.active.clone(), count=st.ekf.count.clone(),
                   gens=[g.get_state() for g in st.generator],
                   host_ticks=st.host_ticks)
        return out

    def step(self) -> None:
        keep = self.steps in self.checked
        if keep:
            pre = self._snapshot()
        last = self.plan[self.pos]
        self.runner.run(tail=last)
        rows = self.runner.rows.to("cpu", copy=True)
        if keep:
            self.records.append((pre, rows, self._snapshot(),
                                 *self.checked[self.steps]))
        ticks = rows.shape[1]
        self.steps += 1
        self.solves += self.b * ticks
        self.failed += int((~torch.isfinite(
            rows[..., :self.circles.start]).all(dim=-1)).sum())
        self.pos += 1
        if self.pos == len(self.plan):
            end = rows[:, -1].double()
            err = torch.hypot(end[:, 1] - end[:, 3], end[:, 2] - end[:, 4])
            self.failed += self.sweep_ticks * int(
                (torch.isfinite(err) & (err > self.bar)).sum())
            self.sweep_errors.append(float(err.max()))
            self._load(self.sweep + 1)

    def tally(self) -> dict:
        return {"solves": self.solves, "steps": self.steps}

    def outcome(self):
        return self.solves, self.failed

    def metrics(self, window_s: float) -> dict:
        return {"solves_per_s": self.solves / window_s}

    def trace_info(self) -> dict:
        summary = self.summary or {}
        return {"k": self.k, "n": self.m["steps"], "b": self.b,
                "phases": summary.get("phases", {})}

    def release(self) -> None:
        self.summary = self.profiling.summary()
        self.profiling.enable(False)
        self.runner = None
        self.st0 = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # ── the check ──

    def readings(self, dtype=torch.float32) -> dict:
        """The compared numbers over the sampled steps: the program's own
        (``dtype`` float32), or the control's (the reference with its
        solves, plant, scan and filter in ``dtype`` and its fit in
        float32, put in the program's place)."""
        if not self.records:
            return {}
        ticks = [self._ticks(r, dtype) for r in self.records]
        out = _control(ticks, self.c)
        filt = {"filter_err": 0.0, "count_mismatches": 0.0,
                "state_err_m": 0.0, "cov_err": 0.0, "circle_err_m": 0.0,
                "circle_err_one_reading_m": 0.0, "circle_mismatches": 0.0}
        parted = checked = compared = whole = 0
        for rec, tk in zip(self.records, ticks):
            r = self._filter(rec, tk, dtype)
            for key in filt:
                filt[key] = (filt[key] + r[key] if key.endswith("mismatches")
                             else max(filt[key], r[key]))
            parted += r["parted"]
            checked += len(rec[4])
            compared += r["compared"]
            whole += r["whole"]
        out.update(filt)
        out["filter_parted_pct"] = 100.0 * parted / checked
        out["seed_steps_chained"] = float(checked)
        out["filter_ticks_compared"] = float(compared)
        out["seed_steps_whole"] = float(whole)
        # The tracer's replays beside the profiled stretch's idle share:
        # the device's idle between unprofiled replays.
        replays = (self.summary or {}).get("replays", {})
        for key in ("idle_pct", "device_ms"):
            if replays.get(key) is not None:
                out[f"replay_{key}"] = float(replays[key])
        return out

    def _ticks(self, rec, dtype) -> dict:
        """Every tick of a record's checked seeds from the program's state
        before it (the step's start, then the row of the tick before): the
        reference's waypoint advance and float64 solve with its near-ties
        and slack, and what the judged side produced: the program's rows,
        or the control's solve and plant in ``dtype`` from the same
        state."""
        pre, rows, _, seeds, _ = rec
        c, m, n = self.c, self.m, self.m["steps"]
        d = torch.float64
        got = rows[seeds][..., :self.circles.start].to(d)    # (S, L, W)
        s_n, ticks = got.shape[:2]
        first = torch.cat([
            pre["mu"][seeds].cpu().to(d)[:, :3],
            pre["true_pose"][seeds].cpu().to(d),
            pre["count"][seeds].cpu().to(d)[:, None],
            pre["u"][seeds].cpu().to(d).flatten(1),
            torch.stack([pre[f][seeds].cpu().to(d) for f in (
                "wpt_idx", "visits", "done")], 1)], 1)
        before = torch.cat([first[:, None], got[:, :-1]], 1)  # (S, L, W)
        key = (pre["ticks"][seeds].cpu().long()[:, None] +
               torch.arange(ticks)[None, :] + c["fused_seed"])
        flat = lambda t: t.reshape(s_n * ticks, *t.shape[2:])  # noqa: E731
        b, a, key = flat(before), flat(got), key.flatten()
        _, wpts = ref.world(c)
        w = wpts.to(d)
        idx = b[:, U + 2 * n].long()
        visits = b[:, U + 2 * n + 1].long()
        est = torch.stack([b[:, 1], b[:, 2], b[:, 0]], 1)
        # The advance: the distance in float32, as the program takes it.
        d2g = torch.hypot(est[:, 0].float() - wpts[idx, 0],
                          est[:, 1].float() - wpts[idx, 1]).to(d)
        arrived = d2g < c["goal_thresh"]
        goal_tie = (d2g - c["goal_thresh"]).abs() < c["tie_goal_m"]
        visits = visits + arrived.long()
        idx = torch.where(arrived, (idx + 1) % w.shape[0], idx)
        done = (b[:, U + 2 * n + 2] > 0) | (visits >= c["cycles"] *
                                            w.shape[0])
        u = b[:, U:U + 2 * n].reshape(-1, n, 2)
        dev = self.device
        parts = {"u": [], "tie": [], "slack": [], "low": []}
        block = 256
        for lo in range(0, u.shape[0], block):
            sl = slice(lo, lo + block)
            args = (m, u[sl].to(dev), key[sl].to(dev), est[sl].to(dev),
                    w[idx[sl]].to(dev))
            with ref.exact():
                u_new, tie, slack = mppi.solve_with_slack(*args, self.k)
                parts["u"].append(u_new.cpu())
                parts["tie"].append(tie.cpu())
                parts["slack"].append(slack.cpu())
                if dtype != torch.float32:
                    parts["low"].append(mppi.solve(*args, self.k,
                                                   dtype).cpu())
        u_new, tie, slack = (torch.cat(parts[k]) for k in ("u", "tie",
                                                           "slack"))
        cmd = torch.where(done[:, None], 0.0, u_new[:, 0])
        if dtype == torch.float32:
            have_u = a[:, U:U + 2 * n].reshape(-1, n, 2)
            have_plant = a[:, PLANT]
        else:
            low = torch.cat(parts["low"])
            have_u = mppi.shift(low, (c["ul_init"], c["ur_init"])).to(d)
            low_cmd = torch.where(done[:, None], 0.0, low[:, 0].float())
            have_plant = torch.where(done[:, None], b[:, PLANT], mppi.plant(
                m, b[:, PLANT].to(dtype), low_cmd.to(dtype),
                c["tick_dt"]).to(d))
        want_plant = torch.where(done[:, None], b[:, PLANT], mppi.plant(
            m, b[:, PLANT], cmd, c["tick_dt"]))
        return {"seeds": s_n, "ticks": ticks, "goal_tie": goal_tie,
                "idx": idx, "visits": visits, "done": done, "cmd": cmd,
                "tie": tie, "slack": slack, "u_new": u_new,
                "have_u": have_u, "have_plant": have_plant,
                "want_plant": want_plant, "row": a}

    def _filter(self, rec, tk, dtype) -> dict:
        """Each chained seed's filter from the step's start, driven by the
        program's own course (the twist of the reference's command from the
        program's state, the scans at the program's poses on the same
        normals), in ``dtype`` (the fit in float64, or float32 for the
        control), against the reference's in float32: the filter's pose and
        tracked count at every tick before the seed's first near-tie (a
        solve's first row, a scan's, the detector's or a gate's), and its
        mean, covariance and slots in use at the end where none came. And
        each sensing tick's circles at the program's pose on the same scan,
        the program's (or the control's) against the reference's, where the
        reference's scan and detector meet no near-tie (a circle that a
        grazing ray moves against the nearer of its two readings)."""
        pre, rows, post, checked, seeds = rec
        c = self.c
        lms, _ = ref.world(c)
        ticks = rows.shape[1]
        normals = self._normals(pre, seeds, ticks)
        program = dtype == torch.float32
        out = {"filter_err": 0.0, "count_mismatches": 0.0,
               "state_err_m": 0.0, "cov_err": 0.0, "circle_err_m": 0.0,
               "circle_err_one_reading_m": 0.0, "circle_mismatches": 0.0,
               "parted": 0, "compared": 0, "whole": 0}
        for i, s in enumerate(seeds):
            k = checked.index(s)
            at = slice(k * ticks, (k + 1) * ticks)
            cmd, done = tk["cmd"][at], tk["done"][at]
            tied = tk["tie"][at][:, 0].tolist()
            plant = rows[s][:, PLANT]
            chains = {}
            for side, (dt, fit) in {"want": (torch.float32, torch.float64),
                                    "got": (dtype, torch.float32)}.items():
                if side == "got" and program:
                    continue
                chains[side] = self._chain(
                    pre, s, cmd, done, plant, normals[i], dt, fit, lms,
                    tied)
            want, tie_at, end_w, seen = chains["want"]
            if program:
                got = rows[s].double()
                end_g = (post["mu"][s].cpu(), post["cov"][s].cpu(),
                         post["active"][s].cpu().tolist())
                have = self._circles(pre, rows[s])
            else:
                got, _, end_g, have = chains["got"]
                have = [m for m, _, _ in have]
            if tie_at:
                dpose = (got[:tie_at, FILTER] - want[:tie_at, FILTER]).abs()
                out["filter_err"] = max(out["filter_err"], float(
                    torch.nan_to_num(dpose, nan=math.inf).max()))
                out["count_mismatches"] += float(
                    (got[:tie_at, COUNT] != want[:tie_at, COUNT]).sum())
            out["compared"] += tie_at
            last = (got[-1, FILTER] - want[-1, FILTER]).abs()
            out["parted"] += int(not bool((last <= self.parted_m).all()) or
                                 bool(got[-1, COUNT] != want[-1, COUNT]))
            if tie_at == ticks:
                out["whole"] += 1
                for key, v in _ends(end_g, end_w).items():
                    out[key] = (out[key] + v if key.endswith("mismatches")
                                else max(out[key], v))
            for (want_m, tie, alt), got_m in zip(seen, have):
                if tie:
                    continue
                ok = torch.isfinite(want_m).all(dim=-1)
                found = torch.isfinite(got_m).all(dim=-1)
                both = found & ok
                if bool(both.any()):
                    # Each circle against the nearer of the scan's two
                    # readings where a ray grazes a cylinder.
                    err = (got_m[both] - want_m[both]).abs().amax(dim=-1)
                    out["circle_err_one_reading_m"] = max(
                        out["circle_err_one_reading_m"], float(err.max()))
                    if alt is not None:
                        err = torch.fmin(err, (got_m[both] - alt[both])
                                         .abs().amax(dim=-1))
                    out["circle_err_m"] = max(out["circle_err_m"],
                                              float(err.max()))
                out["circle_mismatches"] += int((found != ok).sum())
        return out

    def _chain(self, pre, s, cmd, done, plant, normals, dtype, fit, lms,
               tied):
        """One seed's filter over the step in ``dtype``: (rows (ticks, 7)
        float64 of its pose and count, the first tick with a near-tie,
        (mean, covariance, slots in use) at the end, each sensing tick's
        (measurements, near-tie, the circles had its grazing rays gone the
        other way or None))."""
        c = self.c
        every = c["sensor_every"]
        mu = pre["mu"][s].cpu().to(dtype)
        cov = pre["cov"][s].cpu().to(dtype)
        active = pre["active"][s].cpu().tolist()
        count = int(pre["count"][s])
        ticks = plant.shape[0]
        rows = torch.zeros(ticks, COUNT + 1, dtype=torch.float64)
        tie_at, seen = ticks, []
        for t in range(ticks):
            u_odom = ref.twist(c, cmd[t].to(dtype), bool(done[t]))
            meas, tie = mu.new_empty((0, 2)), tied[t]
            if (pre["host_ticks"] + t) % every == 0:
                meas, scan_tie, alt = ref.sense_either(
                    c, plant[t].to(dtype), lms, normals[t // every], fit)
                tie = tie or scan_tie
                seen.append((meas, scan_tie, alt))
            mu, cov, active, count, da_tie, _ = ref.ekf_step(
                c, mu, cov, active, count, meas, u_odom)
            if (tie or da_tie) and tie_at == ticks:
                tie_at = t
            rows[t, FILTER] = mu[:3].double()
            rows[t, COUNT] = float(count)
        return rows, tie_at, (mu, cov, active), seen

    def _normals(self, pre, seeds, ticks):
        """Each chained seed's scan normals, drawn again on the device from
        its generator's state before the step, as the runner draws them."""
        every, beams = self.c["sensor_every"], self.c["beams"]
        dev = pre["mu"].device
        out = []
        for s in seeds:
            g = torch.Generator(device=dev)
            g.set_state(pre["gens"][s])
            out.append([torch.randn((beams,), generator=g,
                                    dtype=torch.float32, device=dev).cpu()
                        for _ in range(-(-ticks // every))])
        return out

    def _circles(self, pre, rows):
        """The circles of each sensing tick of a seed's step, as the
        replayed graph's sensor chain handed them to its filter: (C, 2)
        each, NaN rows for empty slots."""
        every = self.c["sensor_every"]
        return [rows[t, self.circles].view(-1, 2)
                for t in range(rows.shape[0])
                if (pre["host_ticks"] + t) % every == 0]

def _control(ticks, c: dict) -> dict:
    """The per-tick checks of every record's ticks (:meth:`Driver._ticks`):
    ``control_excess_m``, the plant's pose beyond what the solve's first
    row's slack can move it, over the ticks whose first row is no
    near-tie; ``u_excess``, the nominal controls after the shift beyond
    their rows' slack, over the rows that are no near-tie; and
    ``waypoint_mismatches``, advances, visits and done flags off the rule
    where the distance to the goal is clear of its threshold."""
    out = {"control_excess_m": 0.0, "u_excess": 0.0,
           "waypoint_mismatches": 0.0, "control_ticks": 0.0,
           "control_exempt": 0.0}
    for tk in ticks:
        n = tk["u_new"].shape[1]
        row, slack, tie = tk["row"], tk["slack"], tk["tie"]
        clear = ~tk["goal_tie"]
        mism = ((row[:, U + 2 * n].long() != tk["idx"]) |
                (row[:, U + 2 * n + 1].long() != tk["visits"]) |
                ((row[:, U + 2 * n + 2] > 0) != tk["done"])) & clear
        out["waypoint_mismatches"] += float(mism.sum())
        free = ~tie[:, 0] & clear
        # The first row's slack moves the command, and so the pose, to
        # first order (dt·r/2 per wheel speed in x and y, dt·r/b in θ).
        s0 = slack[:, 0].sum(dim=1)
        dt, r, b = c["tick_dt"], c["wheel_radius"], c["wheel_base"]
        allow = torch.stack([dt * r / 2 * s0, dt * r / 2 * s0,
                             dt * r / b * s0], 1)
        allow = torch.where(tk["done"][:, None], 0.0, allow)
        exc = ((tk["have_plant"] - tk["want_plant"]).abs() - allow).clamp(
            min=0.0).amax(dim=1)
        exc = torch.nan_to_num(exc, nan=math.inf)
        if bool(free.any()):
            out["control_excess_m"] = max(out["control_excess_m"],
                                          float(exc[free].max()))
        u_err = ((tk["have_u"][:, :-1] - tk["u_new"][:, 1:]).abs() -
                 slack[:, 1:]).clamp(min=0.0)
        u_err = torch.where(tie[:, 1:, None], 0.0,
                            torch.nan_to_num(u_err, nan=math.inf))
        out["u_excess"] = max(out["u_excess"], float(u_err.max()))
        out["control_ticks"] += float(free.numel())
        out["control_exempt"] += float((~free).sum())
    return out


def _ends(got, want) -> dict:
    """The filter at a step's end against the reference's: ``state_err_m``
    over the pose and the slots in use, ``cov_err`` the covariance's
    largest difference over its largest entry in that block, and each slot
    in use on one side only a mismatch."""
    (mu, cov, act), (mu_w, cov_w, act_w) = got, want
    keep = torch.tensor([True] * 3 + [a for a in act_w for _ in (0, 1)])
    block = keep[:, None] & keep[None, :]
    diff = (cov.double() - cov_w.double())[block].abs().max()
    return {"count_mismatches": float(sum(a != b for a, b in zip(act,
                                                                  act_w))),
            "state_err_m": float((mu.double() - mu_w.double())[keep].abs()
                                 .max()),
            "cov_err": float(diff / cov_w.double()[block].abs().max())}
