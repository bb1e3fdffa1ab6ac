"""Rao-Blackwellized particle filter for grid SLAM, batched over particles.

Port of ``tpunav/estimation/rbpf/particle_filter.py`` (the reference's
``bmapping::ParticleFilter``, bmapping/src/bmapping/particle_filter.cpp).
The particle loop is a batch axis: poses (P, 3), log-weights (P,) and
per-particle maps (P, H, W); weights live in log space.

Where the two hot stages run is decided by the state's device, as for the
fused MPPI solve: on the card the P×(k+1) likelihood sweep is kernel K2
(``ops/likelihood.py``) and the per-particle map update with its distance
field is kernel K3 (``ops/map_update.py``), and ``pf_init`` builds the first
distance field with K4; on the CPU they are those kernels' plain versions.

One update makes no host round trip:

- ``tpunav``'s ``lax.cond`` between the ICP-proposal branch and the
  motion-model branch becomes both branches and a ``torch.where``. The
  motion-model pose rides K2's launch as sample k+1, so an update makes
  exactly one K2 launch and one K3 launch.
- The Gaussian proposal's Cholesky factor comes from ``cholesky_ex``.
- The conditional resample is a gather whose index is ``arange(P)`` when
  N_eff ≥ P/2.

Randomness: ``PFState.generator`` (a ``torch.Generator`` on the state's
device) replaces ``tpunav``'s key. ``noise=`` (a :class:`PFNoise` of
standard normals) replaces the draws, so a test can feed the normals that
``tpunav``'s key splits produce.

:class:`PFStepper` is the counterpart of ``tpunav``'s callers, which
dispatch one jitted ``pf_slam_step`` per scan with the state donated
(``bench.py:bench_rbpf``, ``runtime/slam_nodes.py``): the whole update
captured once as a CUDA graph and replayed per scan.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ... import capture
from ...core import se2
from ...core.angles import normalize_angle_pi
from ...device import DEFAULT_DEVICE, resolve
from ...ops.beams import beam_table
from ...ops.likelihood import likelihood_field_batch
from ...ops.map_update import edt_batch, map_update_batch
from ...runtime import profiling
from .grid import GridConfig, grid_init
from .icp import ICPConfig, icp_match_scans


@dataclasses.dataclass(frozen=True)
class PFConfig:
    """(ref: bmapping/launch/slam.launch:19-46 defaults.) The scan-matched
    proposal assumes LDS-01-like beam density (360 beams); at 90-180 beams
    ``tpunav`` itself drifts, so down-beamed configurations are smoke-level
    only."""

    num_particles: int = 40
    k_samples: int = 50              # samples per proposal mode
    srr: float = 0.1                 # odometry model alphas (Table 5.5)
    srt: float = 0.2
    str_: float = 0.1
    stt: float = 0.2
    motion_noise: Tuple[float, float, float] = (1e-10, 1e-10, 1e-10)
    sample_range: Tuple[float, float, float] = (1e-10, 1e-8, 1e-8)
    scan_lik_min: float = 1.0
    scan_lik_max: float = 20.0
    pose_lik_min: float = 1.0
    pose_lik_max: float = 10.0
    grid: GridConfig = GridConfig()
    icp: ICPConfig = ICPConfig()


class PFState(NamedTuple):
    poses: torch.Tensor        # (P, 3) [theta, x, y]
    prev_poses: torch.Tensor   # (P, 3)
    log_weights: torch.Tensor  # (P,)
    grids: torch.Tensor        # (P, H, W) log-odds
    dists: torch.Tensor        # (P, H, W) ESDF of each grid
    prev_scan: torch.Tensor    # (B,) previous ranges (ICP target)
    has_prev: torch.Tensor     # bool
    generator: torch.Generator  # the filter's random stream


# The leaves with one row per particle; a sharded state splits them over
# the shards and replicates the others.
PARTICLE_LEAVES = ("poses", "prev_poses", "log_weights", "grids", "dists")


class PFNoise(NamedTuple):
    """Standard normals for one update, in place of the state's generator:
    the proposal samples (P, k, 3), the final pose draw (P, 3), the
    motion-model draw (P, 3) and the resample offset ()."""

    samples: torch.Tensor
    pose: torch.Tensor
    motion: torch.Tensor
    resample: torch.Tensor


def pf_init(cfg: PFConfig, pose=None, seed: int = 0, dtype=torch.float32,
            device=DEFAULT_DEVICE) -> PFState:
    """P particles at ``pose`` (default the origin) with fresh maps at the
    prior, equal weights, and a generator seeded with ``seed``."""
    device = resolve(device)
    p = cfg.num_particles
    pose0 = (torch.zeros(3, dtype=dtype, device=device) if pose is None
             else torch.as_tensor(pose, dtype=dtype, device=device))
    g = grid_init(cfg.grid, dtype, device)[None]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return PFState(
        poses=pose0.expand(p, 3).clone(),
        prev_poses=pose0.expand(p, 3).clone(),
        log_weights=torch.full((p,), -math.log(float(p)), dtype=dtype,
                               device=device),
        grids=g.expand(p, -1, -1).clone(),
        dists=edt_batch(cfg.grid, g).expand(p, -1, -1).clone(),
        prev_scan=torch.zeros((cfg.grid.num_beams,), dtype=dtype,
                              device=device),
        has_prev=torch.zeros((), dtype=torch.bool, device=device),
        generator=gen)


def draw_noise(cfg: PFConfig, st: PFState) -> PFNoise:
    """One update's standard normals from the state's generator."""
    p, k = cfg.num_particles, cfg.k_samples
    kw = dict(generator=st.generator, dtype=st.poses.dtype,
              device=st.poses.device)
    return PFNoise(samples=torch.randn((p, k, 3), **kw),
                   pose=torch.randn((p, 3), **kw),
                   motion=torch.randn((p, 3), **kw),
                   resample=torch.randn((), **kw))


def _std(variances, like):
    """sqrt of a configuration triple, on ``like``'s device and dtype,
    built once per (triple, dtype, device): an update makes no
    host-to-device copy, so it can be captured (``PFStepper``)."""
    return _std_on(tuple(variances), like.dtype, like.device)


@functools.cache
def _std_on(variances, dtype, device):
    return torch.sqrt(torch.tensor(variances, dtype=dtype)).to(
        device, non_blocking=True)


def _sample_motion_model(cfg: PFConfig, pose, u, normals):
    """Unicycle propagation + sampled noise for (P, 3) poses
    (ref: sampleMotionModel particle_filter.cpp:295-322). u: (2,) [w, vx];
    normals: (P, 3) standard normals."""
    w = normals * _std(cfg.motion_noise, pose)
    om, vx = u[0], u[1]
    small = torch.abs(om) < 1e-12
    om_safe = torch.where(small, 1.0, om)
    th = normalize_angle_pi(pose[:, 0] + torch.where(small, 0.0, om)
                            + w[:, 0])
    dx = torch.where(small, vx * torch.cos(th),
                     (-vx / om_safe) * torch.sin(th) +
                     (vx / om_safe) * torch.sin(th + om)) + w[:, 1]
    dy = torch.where(small, vx * torch.sin(th),
                     (vx / om_safe) * torch.cos(th) -
                     (vx / om_safe) * torch.cos(th + om)) + w[:, 2]
    return torch.stack([th, pose[:, 1] + dx, pose[:, 2] + dy], dim=-1)


def _pdf_normal(x, var):
    return torch.exp(-0.5 * x * x / var) / torch.sqrt(2.0 * math.pi * var)


def pose_likelihood_odom(cfg: PFConfig, cur_pose, prev_pose, cur_odom,
                         prev_odom):
    """Odometry motion-model probability, rot1/trans/rot2 decomposition
    (ref: poseLikelihoodOdom particle_filter.cpp:383-437, Probabilistic
    Robotics Table 5.5). Poses and odometry are (..., 3) [theta, x, y] and
    broadcast against each other."""
    def decompose(a, b):
        rot1 = torch.atan2(b[..., 2] - a[..., 2], b[..., 1] - a[..., 1]) \
            - a[..., 0]
        trans = torch.hypot(b[..., 1] - a[..., 1], b[..., 2] - a[..., 2])
        rot2 = normalize_angle_pi(normalize_angle_pi(b[..., 0])
                                  - normalize_angle_pi(a[..., 0]) - rot1)
        return rot1, trans, rot2

    rot1, trans, rot2 = decompose(prev_odom, cur_odom)
    rot1h, transh, rot2h = decompose(prev_pose, cur_pose)

    v1 = cfg.srr * rot1h ** 2 + cfg.srt * transh ** 2
    v2 = cfg.str_ * transh ** 2 + cfg.stt * (rot1h ** 2 + rot2h ** 2)
    v3 = cfg.srr * rot2h ** 2 + cfg.srt * transh ** 2
    tiny = 1e-12
    p1 = _pdf_normal(normalize_angle_pi(
        normalize_angle_pi(rot1) - normalize_angle_pi(rot1h)),
        torch.clamp(v1, min=tiny))
    p2 = _pdf_normal(trans - transh, torch.clamp(v2, min=tiny))
    p3 = _pdf_normal(normalize_angle_pi(
        normalize_angle_pi(rot2) - normalize_angle_pi(rot2h)),
        torch.clamp(v3, min=tiny))
    return p1 * p2 * p3


def _icp_init_guess(cur_odom, prev_odom):
    """Odometry-delta initial guess for the scan matcher, rotated into the
    previous body frame (T_init = T_prev⁻¹ ∘ T_cur), as ``tpunav`` fixes
    the reference's icpInitGuess (particle_filter.cpp:602-612)."""
    dth = normalize_angle_pi(normalize_angle_pi(cur_odom[0]) -
                             normalize_angle_pi(prev_odom[0]))
    c, s = torch.cos(prev_odom[0]), torch.sin(prev_odom[0])
    dx = cur_odom[1] - prev_odom[1]
    dy = cur_odom[2] - prev_odom[2]
    return torch.stack([dth, c * dx + s * dy, -s * dx + c * dy])


def _draw_samples(cfg: PFConfig, poses, T_icp, normals):
    """(P, k, 3) proposal samples around each particle's ICP mode
    (ref: sampleMode particle_filter.cpp:504-519); normals (P, k, 3)."""
    T_x = se2.compose(poses, T_icp)                  # (P, 3) modes
    samples = T_x[:, None, :] + normals * _std(cfg.sample_range, poses)
    return torch.cat([normalize_angle_pi(samples[..., :1]),
                      samples[..., 1:]], dim=-1)


def _gaussian_from_samples(cfg: PFConfig, samples, logp_scan, poses,
                           cur_odom, prev_odom, normals):
    """Likelihood-weighted Gaussian fit + draw for every particle from its
    (k, 3) samples and their scan log-likelihoods (ref: gaussianProposal
    particle_filter.cpp:522-599). normals: (P, 3). Returns
    (new poses (P, 3), log η (P,))."""
    p_scan = torch.clamp(torch.exp(torch.clamp(logp_scan, -60.0, 60.0)),
                         cfg.scan_lik_min, cfg.scan_lik_max)
    p_pose = torch.clamp(
        pose_likelihood_odom(cfg, samples, poses[:, None, :], cur_odom,
                             prev_odom),
        cfg.pose_lik_min, cfg.pose_lik_max)
    p = p_scan * p_pose                              # (P, k)
    eta = torch.sum(p, dim=1)
    mu = torch.sum(samples * p[..., None], dim=1) / eta[:, None]
    mu = torch.cat([normalize_angle_pi(mu[:, :1]), mu[:, 1:]], dim=-1)
    diff = samples - mu[:, None, :]
    sigma = torch.einsum("pki,pkj,pk->pij", diff, diff, p) / eta[:, None,
                                                                 None]
    eye = torch.eye(3, dtype=sigma.dtype, device=sigma.device)
    # A particle whose factor fails draws NaN, as jnp.linalg.cholesky's
    # NaN factor does in tpunav (cholesky_ex's L is a finite partial one).
    fac = torch.linalg.cholesky_ex(sigma + 1e-12 * eye)
    chol = torch.where((fac.info == 0)[:, None, None], fac.L, float("nan"))
    new = mu + (chol @ normals[..., None])[..., 0]
    new = torch.cat([normalize_angle_pi(new[:, :1]), new[:, 1:]], dim=-1)
    return new, torch.log(eta)


def _resample_index(cfg: PFConfig, log_weights, normal):
    """Systematic resampling with the reference's partitioning
    (ref: lowVarianceResampling particle_filter.cpp:468-500: r a standard
    normal scaled by 1/P, strides of 1/(P-1)). Returns the (P,) index."""
    p = cfg.num_particles
    w = torch.exp(log_weights - torch.logsumexp(log_weights, 0))
    cum = torch.cumsum(w, 0)
    u_pts = normal / p + torch.arange(p, dtype=w.dtype,
                                      device=w.device) / (p - 1)
    return torch.clamp(torch.searchsorted(cum, u_pts), 0, p - 1)


def _gather(st: PFState, idx) -> PFState:
    return st._replace(poses=st.poses[idx], prev_poses=st.prev_poses[idx],
                       log_weights=st.log_weights[idx],
                       grids=st.grids[idx], dists=st.dists[idx])


def _low_variance_resample(cfg: PFConfig, st: PFState, normal) -> PFState:
    """Resample every particle's state, weights included (the selected
    particles keep their weights, as in the reference)."""
    return _gather(st, _resample_index(cfg, st.log_weights, normal))


def _propose_and_integrate(cfg: PFConfig, st: PFState, ranges, u,
                           cur_odom, prev_odom, noise: PFNoise,
                           rows=slice(None)):
    """The per-particle half of an update on the particles of ``st``, which
    are the global particles ``rows``: ICP against the previous scan →
    pose proposal (Gaussian proposal on success, motion model on failure)
    → map integration. ``noise`` is the global draw; its ``rows`` are
    used. Returns (new poses, unnormalised log-weights, grids, dists)."""
    gcfg = cfg.grid
    k = cfg.k_samples
    guess = _icp_init_guess(cur_odom, prev_odom)
    with profiling.phase("pf.icp"):
        icp = icp_match_scans(cfg.icp, ranges, st.prev_scan, guess,
                              gcfg.range_min, gcfg.range_max,
                              gcfg.beam_min, gcfg.beam_delta)
    matcher_ok = torch.logical_and(icp.converged, st.has_prev)

    # Both branches of tpunav's lax.cond; the motion-model pose is sample
    # k+1 of the one likelihood sweep. Both kernels read one beam table.
    table = beam_table(gcfg, ranges)
    samples = _draw_samples(cfg, st.poses, icp.transform, noise.samples[rows])
    motion = _sample_motion_model(cfg, st.poses, u, noise.motion[rows])
    logp = likelihood_field_batch(
        gcfg, st.dists, ranges,
        torch.cat([samples, motion[:, None, :]], dim=1), table)  # (P, k+1)
    proposed, log_eta = _gaussian_from_samples(
        cfg, samples, logp[:, :k], st.poses, cur_odom, prev_odom,
        noise.pose[rows])
    new_poses = torch.where(matcher_ok, proposed, motion)
    log_weights = st.log_weights + torch.where(matcher_ok, log_eta,
                                               logp[:, k])

    # Every particle integrates the scan into its own map (ref: :236-240).
    grids, dists = map_update_batch(gcfg, st.grids, ranges,
                                    new_poses.contiguous(), table)
    return new_poses, log_weights, grids, dists


def _normalize_and_index(cfg: PFConfig, log_weights, normal):
    """Normalize the (P,) log-weights and take N_eff (ref:
    normalizeWeights/effectiveParticles :442-465); returns them with the
    resample index: the systematic draw where N_eff < P/2, else the
    identity."""
    p = cfg.num_particles
    log_weights = log_weights - torch.logsumexp(log_weights, 0)
    w = torch.exp(log_weights)
    neff = 1.0 / torch.sum(w * w)
    idx = torch.where(neff < p / 2,
                      _resample_index(cfg, log_weights, normal),
                      torch.arange(p, device=w.device))
    return log_weights, idx


def pf_slam_step(cfg: PFConfig, st: PFState, ranges, u, cur_odom,
                 prev_odom, noise: Optional[PFNoise] = None) -> PFState:
    """One full RBPF SLAM update (ref: ParticleFilter::SLAM
    particle_filter.cpp:141-251): ICP against the previous scan (odometry
    initial guess) → per-particle pose proposal (Gaussian proposal on
    success, motion model on failure) → per-particle map integration →
    weight normalization → low-variance resampling where N_eff < P/2.

    ranges: (B,); u: (2,) [w, vx]; cur_odom, prev_odom: (3,) — all float32
    on the state's device. ``noise``: this update's normals (see
    :class:`PFNoise`); with None they are drawn from ``st.generator``."""
    if noise is None:
        noise = draw_noise(cfg, st)
    new_poses, log_weights, grids, dists = _propose_and_integrate(
        cfg, st, ranges, u, cur_odom, prev_odom, noise)
    log_weights, idx = _normalize_and_index(cfg, log_weights,
                                            noise.resample)
    st = PFState(poses=new_poses, prev_poses=st.poses,
                 log_weights=log_weights, grids=grids, dists=dists,
                 prev_scan=ranges, has_prev=torch.ones_like(st.has_prev),
                 generator=st.generator)
    return _gather(st, idx)


class PFStepper:
    """:func:`pf_slam_step` captured as one CUDA graph and replayed once per
    scan (``capture.Graph``): ICP's iterations, K2, the proposal, K3, the
    normalisation and the resample gather in one launch.

    ``st`` is copied once into the stepper's buffers on ``device`` (default
    the card; raises without CUDA; ``st`` must lie there), and its
    generator is shared. From then on the state lives in place: each
    :meth:`step` overwrites the buffers and returns them, so the state a
    step returned is consumed by the next, as ``tpunav``'s callers donate
    theirs. Each step draws its normals eagerly from the generator into
    static tensors (``draws``, a ``capture.Draws``: the calls of
    :func:`draw_noise`, so the eager step's bits), or takes ``noise``, and
    copies the scan's inputs in before the replay.

    ``inputs`` (the scan, the twist and the two odometry poses), ``noise``
    and ``update`` (the step's body on those tensors) let a caller run the
    update inside a graph of its own, as the RBPF node does.

    ``step_fn(st, ranges, u, cur_odom, prev_odom, noise=)`` is the update
    the body runs (default :func:`pf_slam_step`; the sharded stepper
    passes its sharded update), and ``error_mode`` the graph's capture
    mode (``capture.Graph``)."""

    def __init__(self, cfg: PFConfig, st: PFState, device=DEFAULT_DEVICE,
                 step_fn=None, error_mode: str = "global"):
        dev = capture.state_device(st.poses, device)
        if step_fn is None:
            step_fn = functools.partial(pf_slam_step, cfg)
        # The body holds the buffers, not self: a graph whose stepper is
        # dropped is freed at once, not by the cyclic collector.
        state = self.state = PFState(*(t.clone() for t in st[:-1]),
                                     generator=st.generator)
        like = dict(dtype=st.poses.dtype, device=dev)
        p, k = cfg.num_particles, cfg.k_samples
        inputs = self.inputs = (
            torch.zeros(cfg.grid.num_beams, **like), torch.zeros(2, **like),
            torch.zeros(3, **like), torch.zeros(3, **like))
        noise = self.noise = PFNoise(
            samples=torch.zeros((p, k, 3), **like),
            pose=torch.zeros((p, 3), **like),
            motion=torch.zeros((p, 3), **like),
            resample=torch.zeros((), **like))

        def update():
            capture.load(state, step_fn(state, *inputs, noise=noise))

        self.update = update
        self.graph = capture.Graph(update, dev, error_mode)
        # draw_noise's calls, in its order: PFNoise's fields.
        self.draws = capture.Draws(self.graph, noise)
        for t in noise:
            self.draws.add(t, st.generator)

    def draw(self, noise: Optional[PFNoise] = None) -> None:
        """The next update's normals into the static tensors: ``noise``, or
        those :func:`draw_noise` draws from the generator."""
        self.draws(noise)

    def step(self, ranges, u, cur_odom, prev_odom,
             noise: Optional[PFNoise] = None) -> PFState:
        """One update from the (B,) scan, the (2,) twist and the (3,)
        odometry poses, as :func:`pf_slam_step` takes them; returns the
        state in place."""
        self.draw(noise)
        with profiling.span("step.load", self.graph):
            capture.load(self.inputs, (ranges, u, cur_odom, prev_odom))
        self.graph()
        return self.state

    def load(self, st: PFState) -> None:
        """``st`` into the buffers in place, its generator's state into the
        stepper's generator (a state assigned to :attr:`state` instead
        would never reach the graph, which reads the buffers)."""
        capture.load(self.state, st)


def best_particle(st: PFState):
    """Highest-weight particle's (pose, grid) — the filter's estimate
    (ref: getRobotState/newMap particle_filter.cpp:255-291)."""
    i = torch.argmax(st.log_weights).reshape(1)
    return (torch.index_select(st.poses, 0, i)[0],
            torch.index_select(st.grids, 0, i)[0])
