"""End-to-end perception: lidar raycast → circle detector → EKF SLAM.

Counterpart of ``examples/lidar_ekf_slam_demo.py``. The reference's
non-debug SLAM pipeline — scan → featureDetection → TurtleMap (ref:
nuslam/src/landmarks_node.cpp:84-104) feeding the EKF node (ref:
nuslam/src/slam_node.cpp:109-123) — closed end to end with no ground-truth
landmark sensor: the robot drives a loop through the 12-cylinder block
world, and every measurement the filter sees comes from ``scan_cylinders``
raycasts through the clustering and algebraic-circle-fit detector.
Reported as the reference README's tables are (nuslam/README.md:24-50):
final SLAM pose error beside dead-reckoned odometry error, for known DA
(through the sim-side correspondence oracle) and unknown DA (Mahalanobis
gating on raw detections).

    python -m examples_torch.lidar_ekf_slam_demo [--device cpu]

The seed enters only the scan noise; the filter is deterministic
(``generator=None``). Where ``tpunav`` jits the course as one ``lax.scan``,
each step here replays one CUDA graph (:class:`StepGraph`,
``tpunav_torch/capture.py``): the sensor, the detector (two eigensolver
launches), the oracle and the EKF's masked update, whose fixed trip over
the detector's rows makes no host read. ``run_many`` runs its seeds as
``tpunav`` vmaps its course: one :class:`StepGraph` over the B seeds
(``make_sim_batch``), each replay one step of every seed, the step's body
mapped over the seeds (``tpunav_torch.batch``) with one detector and one
eigensolver call per kernel for all B scans. The eager form
(``eager=True``) calls the dynamic update, which reads its count of valid
rows on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from examples_torch import device_parser, draw, out_path, synchronize
from tpunav_torch import batch, capture
from tpunav_torch.core.angles import normalize_angle_pi
from tpunav_torch.device import DEFAULT_DEVICE, resolve
from tpunav_torch.estimation.ekf import (EKFConfig, EKFState, ekf_init,
                                         known_correspondence_slam,
                                         robot_pose, slam_unknown_da)
from tpunav_torch.estimation.ekf import filter as ekff
from tpunav_torch.estimation.ekf.filter import EKFStepper
from tpunav_torch.estimation.landmarks import (LandmarkConfig,
                                               circles_to_measurements,
                                               feature_detection)
from tpunav_torch.sim import associate_known, scan_cylinders

# Block-world cylinders (ref: nuslam/config/block_world_landmarks.yaml).
LANDMARKS = [
    [0.75, 0.1], [0.95, 0.6], [0.5, 0.8], [0.1, 0.75],
    [-0.4, 0.9], [-0.8, 0.5], [-0.9, 0.0], [-0.7, -0.55],
    [-0.2, -0.8], [0.3, -0.9], [0.8, -0.6], [1.0, -0.1]]
CYL_RADIUS = 0.04          # under the detector's radius_thresh=0.05 gate
SCAN_NOISE = 1e-3          # lidar range noise [m]
U_TRUE = (0.03, 0.015)
BIAS = (0.001, 0.0005)

# The demo's two filters: known DA at 12 slots, and BASELINE config 4's
# unknown DA at 50-landmark capacity.
CONFIGS = {
    "known": (known_correspondence_slam, True,
              EKFConfig(num_landmarks=12, spd_repair=False,
                        motion_noise=(1e-6, 1e-6, 1e-6),
                        measurement_noise=(1e-5, 1e-5))),
    "unknown": (slam_unknown_da, False,
                EKFConfig(num_landmarks=50, dmin=5e1, dmax=1e4,
                          spd_repair=False, motion_noise=(1e-5, 1e-5, 1e-5),
                          measurement_noise=(1e-5, 1e-5))),
}


# Each slam step's masked form: the DA that ``EKFStepper`` takes for it.
_KNOWN_DA = {known_correspondence_slam: True, slam_unknown_da: False,
             ekff.known_correspondence_slam_masked: True,
             ekff.slam_unknown_da_masked: False}


def known_da(slam_step) -> bool:
    """Whether ``slam_step`` (dynamic or masked) associates by known
    correspondence; raises for any other function."""
    try:
        return _KNOWN_DA[slam_step]
    except KeyError:
        raise ValueError(f"{slam_step!r} has no masked form for "
                         f"EKFStepper") from None


def telemetry(st: EKFState, true_pose, odom):
    """A step's row: SLAM |xy| and yaw error, odometry |xy| and yaw error,
    and the tracked count."""
    e_s = robot_pose(st) - true_pose
    e_o = odom[:3] - true_pose
    return torch.stack([
        torch.hypot(e_s[1], e_s[2]), normalize_angle_pi(e_s[0]),
        torch.hypot(e_o[1], e_o[2]), normalize_angle_pi(e_o[0]),
        st.count.to(torch.float32)])


class StepGraph:
    """One step of an EKF course as one ``capture.Graph`` step: the truth
    and the biased odometry through ``motion_update``, ``sense(true_pose,
    noise)`` → (n_meas, 2) robot-frame measurements (NaN rows skipped),
    ``EKFStepper``'s masked update (``known``: known DA, else unknown) and
    the :func:`telemetry` row into the static ``tel``, on ``device``
    (default the card; raises without CUDA; ``st`` must lie there).

    ``noise`` is the sensor's static normals of ``noise_shape``: each
    :meth:`step` draws them eagerly from a generator (the eager sensor's
    call) or takes them, then replays. :meth:`load` puts a course's start
    into the buffers in place, so one graph serves every seed.

    A seed batch: ``st``'s fields lead with B (``ekf_init`` states
    stacked), and every buffer with it. One replay steps all B seeds, the
    step's body mapped over them (``batch.vmap``): one sensor, detector and
    update for the batch, two eigensolver launches per step. :meth:`step`
    then takes a tuple of B generators and draws each seed's normals from
    its own."""

    def __init__(self, cfg: EKFConfig, known: bool, sense, noise_shape,
                 n_meas: int, st: EKFState, u_true, u_odom,
                 device=DEFAULT_DEVICE):
        dev = capture.state_device(st.state, device)
        f32 = dict(dtype=torch.float32, device=dev)
        lead = tuple(st.state.shape[:-1])               # (B,) for a batch
        stepper = self.stepper = EKFStepper(cfg, st, n_meas, known, dev)
        # The body holds the buffers, not self.
        carry = self.carry = (torch.zeros((*lead, 3), **f32),
                              st.state.clone())
        noise = self.noise = torch.zeros((*lead, *noise_shape), **f32)
        tel = self.tel = torch.zeros((*lead, 5), **f32)
        zero3 = torch.zeros(3, **f32)
        state, update = stepper.state, stepper.update
        meas_in, u_in = stepper.inputs
        u_in.copy_(u_odom)

        def sensed(pose, odom, z):
            true_pose = ekff.motion_update(cfg, pose, u_true, zero3)
            odom = ekff.motion_update(cfg, odom, u_odom, zero3)
            return true_pose, odom, sense(true_pose, z)

        sensed = batch.over(sensed, bool(lead))
        row = batch.over(telemetry, bool(lead))

        def body():
            true_pose, odom, meas = sensed(carry[0], carry[1], noise)
            meas_in.copy_(meas)
            update()
            tel.copy_(row(state, true_pose, odom))
            capture.load(carry, (true_pose, odom))

        self.graph = capture.Graph(body, dev)

    def load(self, true_pose, odom, st: EKFState) -> None:
        capture.load(self.carry, (true_pose, odom))
        capture.load(self.stepper.state, st)

    def step(self, generator=None, noise=None) -> torch.Tensor:
        """One step, the sensor's normals drawn from ``generator`` (a
        batch: a tuple of B generators, one draw from each) or ``noise``;
        returns the static telemetry row ((B, 5) for a batch)."""
        capture.Draws(self.graph, self.noise).add(self.noise,
                                                  generator)(noise)
        self.graph()
        return self.tel


def eager_course(slam_step, cfg: EKFConfig, sense, u_true, u_odom,
                 seed: int, steps: int, noise=None):
    """The eager form of :func:`course`: each step's operations one by one,
    ``sense(true_pose, generator, noise)`` the sensor and ``slam_step``
    itself the update (the dynamic form, or a masked one as the graph's
    bits reference)."""
    dev = u_true.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    zero3 = torch.zeros(3, dtype=torch.float32, device=dev)
    true_pose = torch.zeros(3, dtype=torch.float32, device=dev)
    st = ekf_init(cfg, dtype=torch.float32, device=dev)
    odom = st.state
    tel = []
    for i in range(steps):
        true_pose = ekff.motion_update(cfg, true_pose, u_true, zero3)
        odom = ekff.motion_update(cfg, odom, u_odom, zero3)
        meas = sense(true_pose, gen, None if noise is None else noise[i])
        st = slam_step(cfg, st, meas, u_odom)
        tel.append(telemetry(st, true_pose, odom))
    return true_pose, odom, st, torch.stack(tel)


def _start(cfg: EKFConfig, seeds, device):
    """The course's start for each of ``seeds`` (an int: one seed; a list:
    a seed batch, every field leading with B): the generators, the truth,
    and the filter (whose state is odometry's start)."""
    one = not isinstance(seeds, (list, tuple))
    gens = []
    for seed in [seeds] if one else seeds:
        gens.append(torch.Generator(device=device))
        gens[-1].manual_seed(int(seed))
    st = ekf_init(cfg, dtype=torch.float32, device=device)
    if not one:
        st = EKFState(*(t.expand(len(gens), *t.shape).clone() for t in st))
    pose = torch.zeros(st.state.shape[:-1] + (3,), dtype=torch.float32,
                       device=device)
    return gens[0] if one else tuple(gens), pose, st


def course(graph: StepGraph, cfg: EKFConfig, seed, steps: int,
           noise=None):
    """``steps`` steps of ``graph`` from the course's start, the sensor's
    normals from a generator seeded ``seed`` (or ``noise[i]``); returns
    copies of (true_pose, odom, ekf_state, telemetry (steps, 5)). On a
    seed batch's graph ``seed`` is the list of B seeds, ``noise`` (B,
    steps, ...), and every result leads with B (telemetry (B, steps, 5))."""
    gen, pose, st = _start(cfg, seed, graph.tel.device)
    graph.load(pose, st.state, st)
    axis = graph.tel.dim() - 1                      # 1 for a batch
    tel = [graph.step(gen, None if noise is None else
                      noise.select(axis, i)).clone() for i in range(steps)]
    true_pose, odom = (t.clone() for t in graph.carry)
    return (true_pose, odom, EKFState(*(t.clone() for t in
                                        graph.stepper.state)),
            torch.stack(tel, dim=axis))


def _course_parts(known: bool, device):
    """(scan, u_true, u_odom): ``scan(true_pose, generator=None,
    noise=None)`` → the detector's (16, 2) measurements of a 360-beam scan
    (the oracle's (12, 2) when ``known``), and the two twists."""
    f32 = dict(dtype=torch.float32, device=device)
    lm_cfg = LandmarkConfig(max_clusters=16)
    landmarks = torch.tensor(LANDMARKS, dtype=torch.float32).to(device)
    radii = torch.full((len(LANDMARKS),), CYL_RADIUS, **f32)
    u_true = torch.tensor(U_TRUE, dtype=torch.float32).to(device)
    u_odom = u_true + torch.tensor(BIAS, dtype=torch.float32).to(device)

    def scan(true_pose, generator=None, noise=None):
        ranges = scan_cylinders(true_pose, landmarks, radii,
                                generator=generator, noise_std=SCAN_NOISE,
                                noise=noise)
        meas = circles_to_measurements(feature_detection(lm_cfg, ranges))
        return associate_known(meas, landmarks, true_pose) if known else meas

    return scan, u_true, u_odom


def make_graph(slam_step, cfg: EKFConfig, known: bool,
               device=DEFAULT_DEVICE, seeds: int = 0) -> StepGraph:
    """The course's :class:`StepGraph`: the scan, the detector, the oracle
    when ``known``, and ``slam_step``'s masked form over the detector's 16
    rows (the oracle's 12); with ``seeds`` = B > 0, over a seed batch."""
    device = resolve(device)
    scan, u_true, u_odom = _course_parts(known, device)
    rows = len(LANDMARKS) if known else 16
    st = _start(cfg, list(range(seeds)) if seeds else 0, device)[2]
    return StepGraph(cfg, known_da(slam_step),
                     lambda pose, z: scan(pose, noise=z), (360,), rows, st,
                     u_true, u_odom, device)


def make_sim(slam_step, cfg: EKFConfig, known: bool, steps=400,
             device=DEFAULT_DEVICE, eager=False):
    """The closed-loop course ``sim(seed, noise=None) → (true_pose, odom,
    ekf_state, telemetry)`` on ``device``, in float32. Per step: truth and
    biased odometry through ``motion_update``, a 360-beam scan (range
    noise from a generator seeded ``seed``, or ``noise[i]``, the step's
    (360,) standard normals), the detector, the known-DA oracle when
    ``known``, and ``slam_step``. The telemetry (steps, 5) holds SLAM |xy|
    and yaw error, odometry |xy| and yaw error, and the tracked count.

    Each step is one replay of :func:`make_graph`'s graph; every call of
    ``sim`` loads its start into that one graph. With ``eager`` the step's
    operations run one by one, ``slam_step`` itself (the dynamic form, or
    a masked one as the graph's bits reference)."""
    device = resolve(device)
    if not eager:
        graph = make_graph(slam_step, cfg, known, device)
        return lambda seed, noise=None: course(graph, cfg, seed, steps,
                                               noise)
    parts = _course_parts(known, device)
    return lambda seed, noise=None: eager_course(slam_step, cfg, *parts,
                                                 seed, steps, noise)


def make_sim_batch(slam_step, cfg: EKFConfig, known: bool, seeds: int,
                   steps=400, device=DEFAULT_DEVICE):
    """:func:`make_sim` over a batch of ``seeds`` = B seeds, ``tpunav``'s
    ``jax.vmap`` of the course: ``sim(seeds, noise=None) → (true_pose (B,
    3), odom (B, S), ekf_state (B, ...), telemetry (B, steps, 5))`` for a
    list of B seeds, each step one replay of a seed batch's
    :class:`StepGraph` for all of them (``noise``: (B, steps, 360)). Seed i
    gives the bits of ``make_sim(...)(seeds[i])``. On ``device``, default
    the card (raises without CUDA unless ``device="cpu"``)."""
    device = resolve(device)
    graph = make_graph(slam_step, cfg, known, device, seeds)
    return lambda seed_list, noise=None: course(graph, cfg, list(seed_list),
                                                steps, noise)


def _wrapped(e):
    e = e.cpu().numpy().astype(np.float64)
    e[..., 0] = (e[..., 0] + np.pi) % (2 * np.pi) - np.pi
    return e


def errors(true_pose, odom, st: EKFState):
    """A course's end as the filter's and odometry's pose errors [θ, x, y]
    against the truth (numpy float64, θ wrapped to [-π, π)); every argument
    may lead with B (a seed batch's course)."""
    return (_wrapped(robot_pose(st) - true_pose),
            _wrapped(odom[..., :3] - true_pose))


def run(slam_step, cfg: EKFConfig, known: bool, steps=400, seed=0,
        device=DEFAULT_DEVICE):
    """One seed; returns (ekf_err [θ, x, y], odo_err, n_tracked, wall,
    steps, telemetry (steps, 5)), numpy. ``wall`` includes the graph's
    warm-up and capture."""
    device = resolve(device)
    sim = make_sim(slam_step, cfg, known, steps, device)
    synchronize(device)
    t0 = time.perf_counter()
    true_pose, odom, st, tel = sim(seed)
    synchronize(device)
    wall = time.perf_counter() - t0
    return (*errors(true_pose, odom, st), int(st.count), wall, steps,
            tel.cpu().numpy())


def run_many(slam_step, cfg: EKFConfig, known: bool, seeds, steps=400,
             device=DEFAULT_DEVICE):
    """The course over all ``seeds`` at once (:func:`make_sim_batch`, one
    replay per step for every seed); returns per-seed (ekf_err (S, 3)
    [θ, x, y], odo_err (S, 3), counts (S,)) and the wall seconds of the
    sweep, the graph's warm-up and capture included. Seed i's numbers are
    those of its own course, ``make_sim(...)(seeds[i])``."""
    device = resolve(device)
    seeds = [int(s) for s in seeds]
    synchronize(device)
    t0 = time.perf_counter()
    sim = make_sim_batch(slam_step, cfg, known, len(seeds), steps, device)
    true_pose, odom, st, _ = sim(seeds)
    ekf_err, odo_err = errors(true_pose, odom, st)
    return (ekf_err, odo_err, st.count.cpu().numpy(),
            time.perf_counter() - t0)


def plot(tel, tag):
    """The per-step stream → an rqt_plot-style panel."""
    from tpunav_torch.viz import plot_series

    out = plot_series(
        {"SLAM |xy| err [cm]": tel[:, 0] * 100,
         "odometry |xy| err [cm]": tel[:, 2] * 100,
         "SLAM yaw err [deg]": np.degrees(tel[:, 1]),
         "odometry yaw err [deg]": np.degrees(tel[:, 3]),
         "tracked landmarks": tel[:, 4]},
        [("cm", ["SLAM |xy| err [cm]", "odometry |xy| err [cm]"]),
         ("deg", ["SLAM yaw err [deg]", "odometry yaw err [deg]"]),
         ("count", ["tracked landmarks"])],
        out_path(f"lidar_ekf_{tag}_timeseries.png"),
        title=f"lidar → detector → EKF SLAM ({tag} DA)", xlabel="step")
    print(f"  wrote {out}")


def main():
    args = device_parser(__doc__.splitlines()[0]).parse_args()
    for tag, (step_fn, known, cfg) in CONFIGS.items():
        ekf_err, odo_err, n_lm, wall, steps, tel = run(step_fn, cfg, known,
                                                       device=args.device)
        print(f"lidar {tag:7s} DA: slam_err(theta,x,y)="
              f"{[f'{float(v):+.4f}' for v in ekf_err]} "
              f"odom_err={[f'{float(v):+.4f}' for v in odo_err]} "
              f"landmarks={n_lm} ({steps} steps in {wall:.1f}s on "
              f"{args.device})")
        draw(plot, tel, tag)


if __name__ == "__main__":
    main()
