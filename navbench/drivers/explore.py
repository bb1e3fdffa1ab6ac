"""Config 5's exploration: the closed loop of the RBPF exploration demo,
one ``ScanGraph`` replay per scan.

The system under test is ``examples_torch.rbpf_explore_demo.ScanGraph``:
a scan interval (six control ticks with a fused solve on K1 each, the
motors and the plant, the lidar's raycast, ``PFStepper``'s update on K2
and K3) captured as one CUDA graph and replayed per scan, its normals
drawn from its generators before each replay; ``scans_per_read`` scans run
between host reads, as the demo runs them. Sessions start from states made
from the seed (a fresh filter, the K1 seed base, the lidar's and the
filter's generators) and loaded in place through ``ScanGraph.load``.

The check follows the loop scan by scan from the program's own state
(``reference/explore.py`` and ``reference/rbpf.py``). For each of
``control_steps``' sampled scans the controller's state is copied before
and after it, and the reference runs the interval's six control ticks from
it: the poses after them are held to the reference's where no near-tie can
have sent the program another way, and the share of all those scans whose
poses part from the reference's is held too, so a run whose every scan met
a near-tie still checks its solves. For each of ``check_steps``' sampled
scans the whole state is copied, and the reference runs the raycast and the
SLAM update from the program's own poses after the ticks, on the same
normals.
"""

from __future__ import annotations

import math

import torch

from ..peaks import bound_s, rbpf_work
from ..reference import explore as ref_explore
from ..reference import rbpf as ref
from . import _mppi, _scans
from .rbpf_update import compare, program_filter, reference_filter


def _same_world(world: dict, demo) -> None:
    """The traffic file describes the demo's world; both must agree."""
    want = {"ticks_per_scan": demo.TICKS_PER_SCAN, "tick_dt": demo.TICK_DT,
            "motor_time_const": demo.MOTOR.time_const,
            "motor_max_torque": demo.MOTOR.max_torque,
            "motor_inertia": demo.MOTOR.eff_inertia,
            "wheel_bias": list(demo.WHEEL_BIAS), "waypoints": demo.WAYPOINTS,
            "wheel_radius": demo.MODEL.wheel_radius,
            "wheel_base": demo.MODEL.wheel_base}
    for key, value in want.items():
        a = torch.tensor(world[key], dtype=torch.float64).flatten()
        b = torch.tensor(value, dtype=torch.float64).flatten()
        if a.shape != b.shape or not torch.allclose(a, b, rtol=1e-12,
                                                    atol=0.0):
            raise ValueError(f"traffic {key}={world[key]} is not the "
                             f"program's {value}")


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from examples_torch import rbpf_explore_demo as demo

        self.world = world = mix["world"]
        _same_world(world, demo)
        self.p = mix.get("particles", cfg["num_particles"])
        self.k = mix.get("rollouts", cfg["explore_rollouts"])
        self.pf = program_filter(cfg, self.p)
        self.f = reference_filter(dict(cfg, num_particles=self.p))
        law = dict(cfg["explore_law"], wheel_radius=world["wheel_radius"],
                   wheel_base=world["wheel_base"])
        self.c = _mppi.plain(law)
        mcfg, _ = _mppi.program(law, self.k)
        self.limits = mix["limits"]
        self.bar = mix["session_bar_m"]
        self.per_read = mix["scans_per_read"]
        self.per_session = mix["scans_per_session"]
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        n = mix["sessions"]
        self.ticks0 = torch.randint(0, 2 ** 24, (n,), generator=gen,
                                    device=device).tolist()
        self.seeds = torch.randint(0, 2 ** 62, (n, 2), generator=gen,
                                   device=device).tolist()
        self.sampled = set(_mppi.sample_steps(gen, *mix["check_steps"]))
        self.ctl_sampled = set(_mppi.sample_steps(gen,
                                                  *mix["control_steps"]))
        self.parted_m = mix["parted_m"]
        self.device = device
        self.st0 = demo.init_state(self.pf, mcfg, seed=0, device=device)
        self.graph = demo.ScanGraph(self.pf, mcfg, self.st0, device)
        g = self.f.grid
        self.bound = tuple(bound_s(*w)[0] for w in rbpf_work(
            self.p, self.pf.k_samples + 1, g.height, g.width, g.num_beams,
            g.num_beams).values())
        # The graph's warm-up (eager) and its capture, then session 0.
        self._load(0)
        self.graph.step()
        self.graph.step()
        self._load(0)
        self.graph.sample.tolist()
        self.scans = self.failed = 0
        self.session_scans = 0
        self.k2_bound = self.k3_bound = 0.0
        self.records = []
        self.ctl_records = []

    def _load(self, s: int) -> None:
        j = s % len(self.ticks0)
        st = self.st0
        st.pf.generator.manual_seed(self.seeds[j][0])
        st.scan_gen.manual_seed(self.seeds[j][1])
        self.graph.load(st._replace(tick=self.ticks0[j]))
        self.session = s
        self.session_scans = 0

    def _scan(self) -> None:
        keep = self.scans in self.sampled
        ctl = self.scans in self.ctl_sampled
        if keep:
            pre = self.graph.snapshot()
        if ctl:
            pre_c = (tuple(t.clone() for t in self.graph.carry),
                     self.graph.tick)
        self.graph.step()
        if keep:
            post = self.graph.snapshot()
            scan = self.graph.stepper.inputs[0].clone()
            self.records.append((pre, post, scan))
        if ctl:
            self.ctl_records.append(
                (*pre_c, tuple(t.clone() for t in self.graph.carry)))
        self.scans += 1
        self.session_scans += 1
        self.k2_bound += self.bound[0]
        self.k3_bound += self.bound[1]

    def step(self) -> None:
        for _ in range(self.per_read):
            self._scan()
        sample = self.graph.sample.tolist()
        if self.session_scans >= self.per_session:
            finite = all(math.isfinite(v) for v in sample)
            if not (finite and sample[0] < self.bar):
                self.failed += self.session_scans
            self._load(self.session + 1)

    def tally(self) -> dict:
        return {"updates": self.scans, "k2_bound_s": self.k2_bound,
                "k3_bound_s": self.k3_bound}

    def outcome(self):
        return self.scans, self.failed

    def metrics(self, window_s: float) -> dict:
        return {"updates_per_s": self.scans / window_s}

    def trace_info(self) -> dict:
        return {"p": self.p, "k": self.k, "n": self.c["steps"]}

    def release(self) -> None:
        self.graph = None
        self.st0 = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # ── the check ──

    def readings(self, dtype=torch.float32) -> dict:
        """The compared numbers over the sampled scans: the program's own
        (``dtype`` float32), or the control's (the reference with its
        solves and each SLAM stage in ``dtype``, put in the program's
        place)."""
        if not self.records or not self.ctl_records:
            return {}
        out = self._control(dtype)
        out.update(self._slam(dtype))
        return out

    def _control(self, dtype) -> dict:
        """Each control-sampled scan's six ticks from the state before it,
        all scans at once. ``control_err``: the poses after them, over the
        scans where the reference meets no near-tie that can reach them.
        ``control_parted_pct``: the share of all the scans whose poses part
        from the reference's by more than ``parted_m`` or reach another
        waypoint; a near-tie parts a scan only where rounding took the
        program down the other side, and a broken solve parts nearly
        every one."""
        pre = [torch.stack(t) for t in zip(*(r[0] for r in self.ctl_records))]
        post = [torch.stack(t) for t in zip(*(r[2] for r in self.ctl_records))]
        tick = torch.tensor([r[1] for r in self.ctl_records])
        args = (self.c, self.world, self.k, *pre[:4], pre[4], tick)
        want = ref_explore.control(*args)
        got = (ref_explore.control(*args, dtype=dtype)
               if dtype != torch.float32 else post)
        free = want[5] == 0
        same = got[4].long() == want[4]
        # The poses: a rounding of the controls' soft rows moves them to
        # first order by no more than the tick's travel.
        err = torch.stack([(a.double() - b).abs().amax(dim=1)
                           for a, b in zip(got[:2], want[:2])]).amax(dim=0)
        err = torch.where(same, err, torch.inf)
        checked = int(free.sum())
        parted = (err > self.parted_m).double().mean()
        return {"control_err": float(err[free].max()) if checked else 0.0,
                "control_parted_pct": 100.0 * float(parted),
                "control_chains": float(err.numel()),
                "control_exempt": float(err.numel() - checked)}

    def _slam(self, dtype) -> dict:
        """Each fully sampled scan's raycast at the program's pose after
        the ticks, and its SLAM update from the program's own poses."""
        world, g = self.world, self.f.grid
        walls = _scans.box(*world["walls"], device=self.records[0][2].device)
        out = {"scan_err": 0.0, "pose_err": 0.0, "log_weight_err": 0.0,
               "grid_off_ppm": 0.0, "dist_off_ppm": 0.0,
               "resample_mismatches": 0.0}
        for pre, post, scan in self.records:
            true_pose, odom = post.true_pose, post.odom_pose
            sgen = torch.Generator(device=scan.device)
            sgen.set_state(pre.scan_gen.get_state())
            z = torch.randn(g.num_beams, generator=sgen, device=scan.device)
            want_scan = torch.clamp(_scans.raycast(
                true_pose[None], walls, g.num_beams, g.beam_min,
                g.beam_delta)[0] + world["noise_std"] * z, max=g.range_max)
            got_scan = scan if dtype == torch.float32 else ref.to_bf16(
                want_scan)
            out["scan_err"] = max(out["scan_err"], float(
                (got_scan - want_scan).abs().max()))
            pgen = torch.Generator(device=scan.device)
            pgen.set_state(pre.pf.generator.get_state())
            normals = ref.draw(self.f, pgen, scan.device)
            st = ref.State(*pre.pf[:-1])
            args = (self.f, st, want_scan,
                    ref_explore.twist(odom, pre.odom_pose), odom,
                    pre.odom_pose, normals)
            poses, lw, grids, dists, idx = ref.update(*args)
            if dtype == torch.float32:
                have = post.pf
                have = {"poses": have.poses, "log_weights": have.log_weights,
                        "grids": have.grids, "dists": have.dists}
            else:
                q = ref.update(*args, quant=ref.to_bf16)
                have = {"poses": q[0][q[4]], "log_weights": q[1][q[4]],
                        "grids": q[2][q[4]], "dists": q[3][q[4]]}
            for name, v in compare(have, poses, lw, grids, dists,
                                   idx).items():
                out[name] = max(out[name], v)
        out["scans_checked"] = float(len(self.records))
        return out
