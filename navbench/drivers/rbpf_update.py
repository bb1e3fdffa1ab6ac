"""SLAM sessions through the program's RBPF stepper, one update per scan as
the RBPF node runs it.

The system under test is ``tpunav_torch.estimation.rbpf.PFStepper``: the
whole update (ICP, the proposal and the likelihood sweep on K2, the
weights, the map update and distance field on K3, the resample) captured as
one CUDA graph and replayed per scan, its normals drawn from the filter's
generator before each replay. After each update the host reads the best
particle's pose, which goes back to the controller: that read ends the
update's latency. Sessions of ``updates_per_session`` scans (``_scans.py``)
start from a fresh filter made in set-up, loaded into the stepper in place
with the session's start pose and filter seed.

The check follows the filter update by update from the program's own
state: each sampled update is run again by the reference
(``reference/rbpf.py``) from the state the program held before it, on the
same scan and the same normals (redrawn from the generator's saved state).
The program's particles are matched to the reference's proposals by pose,
which also reads which proposals the resample kept.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from ..peaks import bound_s, rbpf_work
from ..reference import rbpf as ref
from . import _mppi, _scans

STATE = ("poses", "prev_poses", "log_weights", "grids", "dists",
         "prev_scan", "has_prev")


def grid_config(cfg: dict) -> dict:
    keys = ("resolution", "xmin", "xmax", "ymin", "ymax", "prior",
            "prob_occ", "prob_free", "max_occ_dist", "z_hit", "z_max",
            "z_rand", "sigma_hit", "range_min", "range_max")
    out = {k: cfg[k] for k in keys}
    out["num_beams"] = int(round((cfg["beam_max"] - cfg["beam_min"]) /
                                 cfg["beam_delta"]))
    out["beam_min"] = math.radians(cfg["beam_min"])
    out["beam_delta"] = math.radians(cfg["beam_delta"])
    return out


def reference_filter(cfg: dict) -> ref.Filter:
    return ref.Filter(
        num_particles=cfg["num_particles"], k_samples=cfg["k_samples"],
        srr=cfg["srr"], srt=cfg["srt"], str_=cfg["str"], stt=cfg["stt"],
        motion_noise=tuple(cfg["motion_noise"]),
        sample_range=tuple(cfg["sample_range"]),
        scan_lik_min=cfg["scan_lik_min"], scan_lik_max=cfg["scan_lik_max"],
        pose_lik_min=cfg["pose_lik_min"], pose_lik_max=cfg["pose_lik_max"],
        grid=ref.Grid(**grid_config(cfg)),
        icp=ref.ICP(max_iter=cfg["icp_max_iter"]))


def program_filter(cfg: dict, particles: int):
    from tpunav_torch.estimation.rbpf import GridConfig, PFConfig
    from tpunav_torch.estimation.rbpf.icp import ICPConfig

    g = grid_config(cfg)
    return PFConfig(
        num_particles=particles, k_samples=cfg["k_samples"],
        srr=cfg["srr"], srt=cfg["srt"], str_=cfg["str"], stt=cfg["stt"],
        motion_noise=tuple(cfg["motion_noise"]),
        sample_range=tuple(cfg["sample_range"]),
        scan_lik_min=cfg["scan_lik_min"], scan_lik_max=cfg["scan_lik_max"],
        pose_lik_min=cfg["pose_lik_min"], pose_lik_max=cfg["pose_lik_max"],
        grid=GridConfig(z_short=cfg["z_short"], **g),
        icp=ICPConfig(max_iter=cfg["icp_max_iter"]))


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from tpunav_torch.estimation.rbpf import best_particle, pf_init
        from tpunav_torch.estimation.rbpf.particle_filter import PFStepper

        self.p = mix.get("particles", cfg["num_particles"])
        self.pf = program_filter(cfg, self.p)
        self.f = reference_filter(dict(cfg, num_particles=self.p))
        self.limits = mix["limits"]
        self.bar = mix["session_bar_m"]
        self.best = best_particle
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        g = self.f.grid
        (self.u, self.scans, self.odoms, self.prevs,
         self.starts) = _scans.sessions(mix, g, gen, device)
        self.filter_seeds = torch.randint(
            0, 2 ** 62, (mix["sessions"],), generator=gen,
            device=device).tolist()
        self.sampled = set(_mppi.sample_steps(gen, *mix["check_steps"]))
        self.updates = mix["updates_per_session"]
        self.st0 = pf_init(self.pf, seed=0, device=device)
        self.stepper = PFStepper(self.pf, self.st0, device)
        self.device = device
        # Each update's least K2 and K3 times, from its scan's valid beams.
        valid = ((self.scans >= g.range_min) & (self.scans < g.range_max)
                 ).sum(-1).tolist()
        k = self.pf.k_samples + 1
        self.bounds = [[tuple(bound_s(*w)[0] for w in rbpf_work(
            self.p, k, g.height, g.width, g.num_beams, v).values())
            for v in row] for row in valid]
        # The graph's warm-up (eager) and its capture, then session 0.
        self.session, self.i = 0, 0
        self._load(0)
        for _ in range(2):
            self.stepper.step(self.scans[0, 0], self.u, self.odoms[0, 0],
                              self.prevs[0, 0])
        self._load(0)
        self.best(self.stepper.state)[0].tolist()
        self.done_updates = self.failed = 0
        self.session_updates = 0
        self.lat = []
        self.k2_bound = self.k3_bound = 0.0
        self.records = []

    def _load(self, s: int) -> None:
        j = s % self.scans.shape[0]
        st = self.stepper.state
        self.stepper.load(self.st0)
        st.poses.copy_(self.starts[j].expand_as(st.poses))
        st.prev_poses.copy_(st.poses)
        st.generator.manual_seed(self.filter_seeds[j])
        self.session, self.i = s, 0

    def step(self) -> None:
        j = self.session % self.scans.shape[0]
        i = self.i
        scan, odom, prev = self.scans[j, i], self.odoms[j, i], self.prevs[j, i]
        keep = self.done_updates in self.sampled
        st = self.stepper.state
        if keep:
            pre = ({f: getattr(st, f).clone() for f in STATE},
                   st.generator.get_state(), (j, i))
        t0 = time.perf_counter()
        self.stepper.step(scan, self.u, odom, prev)
        pose = self.best(st)[0].tolist()
        self.lat.append(time.perf_counter() - t0)
        if keep:
            self.records.append((*pre, {f: getattr(st, f).clone()
                                        for f in STATE[:5]}))
        b2, b3 = self.bounds[j][i]
        self.k2_bound += b2
        self.k3_bound += b3
        self.done_updates += 1
        self.session_updates += 1
        self.i += 1
        if self.i == self.updates:
            truth = self.odoms[j, -1].tolist()
            err = math.hypot(pose[1] - truth[1], pose[2] - truth[2])
            if not err < self.bar:
                self.failed += self.session_updates
            self.session_updates = 0
            self._load(self.session + 1)

    def tally(self) -> dict:
        return {"updates": self.done_updates, "k2_bound_s": self.k2_bound,
                "k3_bound_s": self.k3_bound}

    def outcome(self):
        return self.done_updates, self.failed

    def metrics(self, window_s: float) -> dict:
        lat = sorted(self.lat)
        p95 = (statistics.quantiles(lat, n=20, method="inclusive")[-1]
               if len(lat) > 1 else lat[-1])
        return {"updates_per_s": self.done_updates / window_s,
                "update_p95_ms": 1e3 * p95}

    def trace_info(self) -> dict:
        return {"p": self.p}

    def release(self) -> None:
        self.stepper = None
        self.st0 = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # ── the check ──

    def readings(self, dtype=torch.float32) -> dict:
        """The compared numbers over the sampled updates: the program's own
        (``dtype`` float32), or the control's (the reference with each
        stage rounded through ``dtype`` put in the program's place)."""
        if not self.records:
            return {}
        worst = {"pose_err": 0.0, "log_weight_err": 0.0, "grid_off_ppm": 0.0,
                 "dist_off_ppm": 0.0, "resample_mismatches": 0.0}
        for pre, gen_state, (j, i), post in self.records:
            st = ref.State(**pre)
            gen = torch.Generator(device=st.poses.device)
            gen.set_state(gen_state)
            normals = ref.draw(self.f, gen, st.poses.device)
            args = (self.f, st, self.scans[j, i], self.u, self.odoms[j, i],
                    self.prevs[j, i], normals)
            poses, lw, grids, dists, idx = ref.update(*args)
            if dtype != torch.float32:
                q = ref.update(*args, quant=ref.to_bf16)
                post = {"poses": q[0][q[4]], "log_weights": q[1][q[4]],
                        "grids": q[2][q[4]], "dists": q[3][q[4]]}
            # Each program particle's nearest reference proposal.
            for name, v in compare(post, poses, lw, grids, dists,
                                   idx).items():
                worst[name] = max(worst[name], v)
        worst["updates_checked"] = float(len(self.records))
        return worst


def compare(post: dict, poses, lw, grids, dists, idx) -> dict:
    """The program's particles after an update (``post``) against the
    reference's proposals before its resample: each program particle is
    matched to the nearest proposal by pose, which reads the resample the
    program made. Returns the worst pose gap (L∞ of [θ, x, y]) and
    log-weight gap, the parts per million of grid and distance-field cells
    off by more than rounding (a beam endpoint that rounds into the next
    cell moves one cell by l_occ − l_prior), and the particles whose
    match is not the reference's own resample choice."""
    dp = post["poses"][:, None, :] - poses[None, :, :]
    dp = torch.cat([ref.wrap(dp[..., :1]), dp[..., 1:]], -1)
    gap = dp.abs().amax(-1)                                  # (P, P)
    near = gap.argmin(1)
    return {
        "pose_err": float(gap.min(1).values.max()),
        "log_weight_err": float((post["log_weights"] - lw[near]).abs().max()),
        "grid_off_ppm": 1e6 * float(((post["grids"] - grids[near]).abs()
                                     > 1e-3).float().mean()),
        "dist_off_ppm": 1e6 * float(((post["dists"] - dists[near]).abs()
                                     > 1e-4).float().mean()),
        "resample_mismatches": float((near != idx).sum())}
