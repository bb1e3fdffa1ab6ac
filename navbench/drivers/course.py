"""Pentagon courses back to back through the program's chunk runner.

The system under test is ``run_course_chunked``'s runner
(``tpunav_torch.control.waypoint_loop._Chunks``): ``chunk_ticks`` control
ticks (waypoint advance, one fused solve on K1, the motor and the plant)
captured as one CUDA graph and replayed, with one host read per chunk.
Each course starts from a pose and a tick count (which keys K1's Philox
stream) drawn from the seed; its start is loaded into the runner's buffers
in place, so nothing is captured in the window. A timed step is one chunk;
each of its ticks is one solve. With ``chunk_ticks`` 1 the host reads the
status after every tick, as a controller node hands each command on, and
every sampled tick is checked whole.

The check follows the program from its own state where the state is whole:
at the start of each sampled chunk. Its first tick (the solve, the
command, the plant) is held to the reference from that state; every tick's
waypoint advance and distance to the goal is held to the reference from the
pose the program reached; the last tick's plant step is held to the
reference from the chunk's last pose and the wheel speeds it ended with.
"""

from __future__ import annotations

import torch

from ..reference import mppi as ref
from . import _mppi

FIELDS = ("pose", "u", "wpt_idx", "visits", "ticks", "done", "wheel_vel")


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from tpunav_torch.control.waypoint_loop import (CourseConfig,
                                                        _Chunks, course_init)
        from tpunav_torch.sim.motor import MotorParams

        self.c = _mppi.plain(cfg)
        self.k = mix["rollouts"]
        self.chunk = mix["chunk_ticks"]
        self.max_ticks = mix["max_course_ticks"]
        self.limits = mix["limits"]
        self.block = mix.get("check_block", mix["check_steps"][2])
        mcfg, model = _mppi.program(cfg, self.k)
        course = CourseConfig(
            goal_thresh=cfg["goal_thresh"], cycles=cfg["cycles"],
            tick_dt=1.0 / cfg["tick_hz"], max_ticks=2 ** 31 - 1,
            use_fused=True, fused_seed=0,
            motor=MotorParams(time_const=cfg["motor_time_const"]))
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        n = mix["courses"]
        box = torch.tensor(mix["start_box"], device=device)   # [x, y, θ]
        self.starts = (2.0 * torch.rand((n, 3), generator=gen, device=device)
                       - 1.0) * box
        self.tick0 = torch.randint(0, 2 ** 30, (n,), generator=gen,
                                   device=device, dtype=torch.int32)
        self.sampled = set(_mppi.sample_steps(gen, *mix["check_steps"]))
        wpts = torch.tensor(cfg["waypoints"], dtype=torch.float32,
                            device=device)
        self.u0 = torch.zeros((self.c["steps"], 2), device=device) + \
            torch.tensor(self.c["u_init"], device=device)
        st = course_init(mcfg, self.starts[0], seed=0, device=device)
        self.runner = _Chunks(mcfg, course, model, wpts, st, None, None,
                              self.chunk, held=False, telemetry=True)
        self.device = device
        self.course = 0
        self._load(0)
        # The graph's warm-up (eager) and its capture, then the first
        # course from its start.
        self.runner.graph()
        self.runner.graph()
        self._load(0)
        self.runner.status.tolist()
        self.steps = self.solves = self.failed = 0
        self.course_ticks = 0
        self.records = []

    def _load(self, i: int) -> None:
        s = self.runner.state
        j = i % self.starts.shape[0]
        s.pose.copy_(self.starts[j])
        s.u.copy_(self.u0)
        s.wpt_idx.zero_()
        s.visits.zero_()
        s.ticks.copy_(self.tick0[j])
        s.done.zero_()
        s.wheel_vel.zero_()
        self.course_ticks = 0

    def _state(self):
        return {f: getattr(self.runner.state, f).clone() for f in FIELDS}

    def step(self) -> None:
        keep = self.steps in self.sampled
        if keep:
            pre = self._state()
        self.runner.graph()
        done, _ = self.runner.status.tolist()
        if keep:
            self.records.append((pre, {k: v.clone() for k, v in
                                       self.runner.tel.items()},
                                 self._state()))
        self.steps += 1
        self.solves += self.chunk
        self.course_ticks += self.chunk
        if done or self.course_ticks >= self.max_ticks:
            s = self.runner.state
            finite = bool(torch.isfinite(s.pose).all() &
                          torch.isfinite(s.u).all())
            if not (done and finite):
                self.failed += self.course_ticks
            self.course += 1
            self._load(self.course)

    def tally(self) -> dict:
        return {"solves": self.solves, "steps": self.steps}

    def outcome(self):
        return self.solves, self.failed

    def metrics(self, window_s: float) -> dict:
        return {"solves_per_s": self.solves / window_s}

    def trace_info(self) -> dict:
        return {"k": self.k, "n": self.c["steps"]}

    def release(self) -> None:
        self.runner = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # ── the check ──

    def readings(self, dtype=torch.float64) -> dict:
        """The compared numbers over the sampled chunks: the program's own
        (``dtype`` float64), or the control's (the reference in
        ``dtype`` put in the program's place)."""
        c = self.c
        d = torch.float64
        if not self.records:
            return {}
        pre = {f: torch.stack([r[0][f] for r in self.records])
               for f in FIELDS}
        tel = {f: torch.stack([r[1][f] for r in self.records])
               for f in ("pose", "wpt_idx", "d2g")}
        post = {f: torch.stack([r[2][f] for r in self.records])
                for f in FIELDS}
        dev = pre["pose"].device
        w = torch.tensor(c["waypoints"], dtype=d, device=dev)
        nw = w.shape[0]
        thresh, dt = c["goal_thresh"], c["tick_dt"]

        # The first tick from the chunk's whole state, in blocks of chunks.
        pose0 = pre["pose"].to(d)
        d0 = torch.hypot(*(pose0[:, :2] - w[pre["wpt_idx"].long(), :2]).T)
        arrived = d0 < thresh
        visits = pre["visits"] + arrived.to(torch.int32)
        idx = torch.where(arrived, (pre["wpt_idx"] + 1) % nw, pre["wpt_idx"])
        done = pre["done"] | (visits >= c["cycles"] * nw)
        xd = w[idx.long()]
        parts = {"u0": [], "tie0": [], "slack0": [], "ctl0": []}
        for a in range(0, len(self.records), self.block):
            b = slice(a, a + self.block)
            u_ref, tie, slack = ref.solve_with_slack(
                c, pre["u"][b], pre["ticks"][b], pose0[b], xd[b], self.k)
            parts["u0"].append(u_ref[:, 0])
            parts["tie0"].append(tie[:, 0])
            parts["slack0"].append(slack[:, 0])
            if dtype != d:
                parts["ctl0"].append(ref.solve(
                    c, pre["u"][b], pre["ticks"][b], pose0[b], xd[b], self.k,
                    dtype)[:, 0])
        u0, tie0, slack0 = (torch.cat(parts[k]) for k in ("u0", "tie0",
                                                          "slack0"))
        if dtype == d:
            # The pose after the first tick: the chunk's second telemetry
            # row, or for a one-tick chunk the state it ended in.
            pose1 = (tel["pose"][:, 1] if self.chunk > 1
                     else post["pose"]).to(d)
        else:
            cmd = torch.where(done[:, None], 0.0,
                              torch.cat(parts["ctl0"]).float())
            pose1 = torch.where(done[:, None], pose0, ref.plant(
                c, pose0.to(dtype), cmd.to(dtype), dt).to(d))
        cmd = torch.where(done[:, None], 0.0, u0)
        want1 = torch.where(done[:, None], pose0, ref.plant(c, pose0, cmd, dt))
        # Row 0's slack moves the command, and so the pose, to first order.
        s0 = slack0.sum(dim=1)
        allow = torch.stack([dt * c["wheel_radius"] / 2 * s0] * 2 +
                            [dt * c["wheel_radius"] / c["wheel_base"] * s0],
                            dim=1)
        exc = ((pose1 - want1).abs() - torch.where(done[:, None], 0.0, allow)
               ).clamp(min=0.0).amax(dim=1)
        usable = ~tie0 & ((d0 - thresh).abs() > 1e-6)
        first = float(exc[usable].max()) if bool(usable.any()) else 0.0

        # Every tick's distance to its goal and waypoint advance, from the
        # poses the program reached.
        tp = tel["pose"].to(d)
        ti = tel["wpt_idx"].long()
        dist = torch.hypot(tp[..., 0] - w[ti, 0], tp[..., 1] - w[ti, 1])
        if dtype == d:
            d2g = tel["d2g"].to(d)
        else:
            d2g = torch.hypot(tp[..., 0].to(dtype) - w[ti, 0].to(dtype),
                              tp[..., 1].to(dtype) - w[ti, 1].to(dtype)
                              ).to(d)
        d2g_err = float((d2g - dist).abs().max())
        nxt = torch.cat([ti[:, 1:], post["wpt_idx"].long()[:, None]], dim=1)
        rule = torch.where(dist < thresh, (ti + 1) % nw, ti)
        clear = (dist - thresh).abs() > 1e-6
        mism = int(((nxt != rule) & clear).sum())
        mism += int((tel["pose"][:, 0] != pre["pose"]).any(dim=1).sum())

        # The last tick's plant step.
        last = tp[:, -1]
        wheel = post["wheel_vel"].to(d)
        if dtype == d:
            got = post["pose"].to(d)
        else:
            got = ref.plant(c, last.to(dtype), wheel.to(dtype), dt).to(d)
        want = torch.where(post["done"][:, None], last,
                           ref.plant(c, last, wheel, dt))
        plant_err = float((got - want).abs().max())
        lim = c["max_wheel_vel"] - 1e-6
        free = usable & ~done & (u0.abs() < lim).all(dim=1)
        return {"first_tick_excess_m": first, "d2g_err_m": d2g_err,
                "waypoint_mismatches": float(mism), "plant_err_m": plant_err,
                "chunks_checked": float(usable.sum()),
                "unclamped_first_ticks": float(free.sum())}

