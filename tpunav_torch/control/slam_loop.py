"""SLAM-in-the-loop MPPI: estimate → plan → act, with the EKF's pose (not
ground truth) closing the control loop.

Port of ``tpunav/control/slam_loop.py`` (the reference's
``roslaunch nuslam slam.launch`` feeding ``mppi_waypoints``,
nuslam/src/slam_node.cpp + nuturtle_robot/src/mppi_waypoints_node.cpp).
One tick: EKF pose → waypoint advance → MPPI solve (the fused kernel K1
with ``use_fused``, seeded with ``fused_seed + ticks`` on the device) →
plant → biased odometry → EKF update.

The sensor follows its schedule on the host. ``tpunav`` runs the sensor
chain on every tick and masks it to NaN off schedule; here the host knows
the tick count (``SlamLoopState.host_ticks``, no sync), runs the sensor
(and the lidar → detector chain of a ``meas_fn``) only on sensing ticks,
and runs the filter's prediction alone on the others, which equals the
filter's step on all-NaN rows. The waypoint index, visit count and done
flag stay on the device.

``run_slam_loop`` replays a chunk of ticks captured as one CUDA graph
(``capture.Graph``), the counterpart of ``tpunav``'s one device program,
with one host read per chunk, on either backend. The chunk is a multiple
of the sensing period and starts on a sensing tick, so the schedule inside
it is fixed; its sensing ticks take the filter's masked form (no host
read). The chunk's draws are made eagerly from the state's generator into
static tensors before each replay, with the eager loop's calls in its
order: each tick's (K, N, 2) MPPI perturbations on the plain backend
(one ``sample_perturbations`` call), then on a sensing tick the sensor's
normals. A tick whose incoming state is done or at ``max_ticks`` keeps
every field (on the fused backend its hold flag makes K1 return at once),
and the generator is set back to where the eager loop leaves it (the last
chunk's draws made again for its live ticks only), so the run ends in the
eager loop's state, which stops on the tick of ``tpunav``'s
``while_loop``.

``run_slam_course`` is ``tpunav``'s other form, a ``lax.scan`` of a fixed
number of ticks with per-tick telemetry and no stop at ``done``
(``examples/dense_world_slam_demo.py``: config 4, whose ``meas_fn`` is the
lidar → circle detector chain, ``sim/dense_world.py``). It replays
chunks of that scan with no host read; the ``meas_fn``'s noise is drawn
eagerly into static tensors through its ``noise=`` seam, with the eager
loop's calls. It runs on :class:`SlamCourseRunner`, which captures a chunk
graph (and a shorter tail) once and takes each new course's state into its
buffers in place, as a seed sweep runs course after course.

While ``runtime.profiling``'s tracer is on, a sensing tick's sensor chain
and filter step are its device phases ``slam.sense`` and ``ekf.update``
(on a seed batch once per sensing tick for all B seeds, inside the mapped
body), and a runner's eager draws and loads its ``step.draw`` and
``step.load`` spans.

``run_slam_course`` also runs that scan over a seed batch
(``slam_batch_init``: B states and B generators), ``tpunav``'s
``jax.vmap`` of the course over seeds: each replayed chunk advances every
seed, a tick's parts before and after the solve mapped over the seeds
(``tpunav_torch.batch``) around one K1 launch for the B solves, and each
seed's sensor normals drawn from its own generator in its serial order.
Seed i ends in the state, rows and generator of ``run_slam_course`` from
seed i's state.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from .. import batch, capture
from ..device import DEFAULT_DEVICE, resolve
from ..estimation.ekf import filter as ekff
from ..estimation.ekf.filter import (EKFConfig, EKFState, ekf_init,
                                     known_correspondence_slam,
                                     known_correspondence_slam_masked,
                                     robot_pose, slam_unknown_da,
                                     slam_unknown_da_masked)
from ..models.cart import CartParams, kinematic_cart
# A module import: ops.fused_mppi imports control.mppi, so a name import
# here would fail when ops.fused_mppi is imported first.
from ..ops import fused_mppi
from ..ops.rk4 import rk4_step
from ..runtime import profiling
from ..sim.landmark_sensor import landmark_measurements
from .mppi import (MPPIConfig, init_controls, mppi_solve,
                   sample_perturbations, shift_controls)
from .waypoint_loop import _active_waypoint


@dataclasses.dataclass(frozen=True)
class SlamLoopConfig:
    """Closed-loop wiring (``tpunav``'s fields and defaults): the sensor
    schedule, noise injection (the reference's analysis-node fault
    injection, nuslam/launch/landmarks.launch:43-50) and course
    semantics."""

    goal_thresh: float = 0.1
    cycles: int = 1
    tick_dt: float = 1.0 / 60.0
    sensor_every: int = 6             # landmark frames every k-th tick
    visibility: float = 1.2           # sensor range gate (NaN outside)
    meas_noise_std: float = 1e-4
    odom_bias: Tuple[float, float] = (1e-3, 5e-4)   # per-tick (w, vx) bias
    known_da: bool = True
    # Solver backend: False = the plain mppi_solve; True = the fused
    # kernel K1 seeded with fused_seed + tick.
    use_fused: bool = False
    fused_seed: int = 0


class SlamLoopState(NamedTuple):
    true_pose: torch.Tensor   # (3,) [x, y, theta] — plant ground truth
    odom: torch.Tensor        # (3,) [theta, x, y] — dead-reckoning path
    ekf: EKFState             # the filter (its pose feeds MPPI), float32
    u: torch.Tensor           # (N, 2) nominal controls
    generator: torch.Generator  # MPPI perturbations and sensor noise
    wpt_idx: torch.Tensor     # int32
    visits: torch.Tensor      # int32
    ticks: torch.Tensor       # int32 (keys the fused kernel's Philox)
    done: torch.Tensor        # bool
    host_ticks: int           # ticks, on the host: the sensor schedule


def slam_loop_init(mppi_cfg: MPPIConfig, ekf_cfg: EKFConfig, pose_xyt=None,
                   seed: int = 0, device=DEFAULT_DEVICE) -> SlamLoopState:
    """The loop's start at ``pose_xyt`` (default the origin) with a
    float32 filter, as ``tpunav``'s, on ``device`` (default the CUDA card;
    raises without CUDA unless ``device="cpu"``)."""
    device = resolve(device)
    pose = (torch.zeros(3, dtype=torch.float32, device=device)
            if pose_xyt is None else
            torch.as_tensor(pose_xyt, dtype=torch.float32).to(device))
    odom = torch.stack([pose[2], pose[0], pose[1]])
    ekf = ekf_init(ekf_cfg, dtype=torch.float32, device=device)
    ekf = ekf._replace(state=torch.cat([odom, ekf.state[3:]]))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    i32 = dict(dtype=torch.int32, device=device)
    return SlamLoopState(
        true_pose=pose, odom=odom, ekf=ekf,
        u=init_controls(mppi_cfg, device=device), generator=gen,
        wpt_idx=torch.zeros((), **i32), visits=torch.zeros((), **i32),
        ticks=torch.zeros((), **i32),
        done=torch.zeros((), dtype=torch.bool, device=device),
        host_ticks=0)


def slam_loop_tick(mppi_cfg: MPPIConfig, ekf_cfg: EKFConfig,
                   cfg: SlamLoopConfig, model: CartParams, waypoints,
                   landmarks, st: SlamLoopState, meas_fn=None,
                   noise: Optional[torch.Tensor] = None,
                   meas_noise: Optional[torch.Tensor] = None
                   ) -> SlamLoopState:
    """One tick: EKF pose → waypoint advance → MPPI solve → plant → noisy
    odometry → EKF SLAM update.

    ``waypoints`` (W, 3) and ``landmarks`` (M, 2): float32 tensors on the
    state's device. ``meas_fn(true_pose_txy, generator) -> (M', 2)``
    replaces the landmark sensor (the dense world's lidar → circle
    detector chain); it runs on sensing ticks only. Parity seams:
    ``noise``, the tick's (N, K, 2) MPPI perturbations (with None the
    plain backend draws from the state's generator and the fused backend
    uses in-kernel Philox), and ``meas_noise``, the sensor's (M, 2)
    standard normals on a sensing tick (with None they are drawn from the
    generator)."""
    slam_step = (known_correspondence_slam if cfg.known_da
                 else slam_unknown_da)
    return _tick(mppi_cfg, ekf_cfg, cfg, model, waypoints, landmarks, st,
                 st.host_ticks % cfg.sensor_every == 0, slam_step, meas_fn,
                 noise, meas_noise)


def _tick(mppi_cfg, ekf_cfg, cfg, model, waypoints, landmarks, st, sense,
          slam_step, meas_fn=None, noise=None, meas_noise=None, hold=None):
    """:func:`slam_loop_tick` with the schedule (``sense``, a host bool)
    and the filter's step given; ``hold``: a held tick's device bool for
    K1 (fused backend), or None."""
    est_xyt, wpt, aim = _aim(cfg, waypoints, st)
    if cfg.use_fused:
        seed = cfg.fused_seed + st.ticks              # int32, on the device
        cmd, u = fused_mppi.mppi_solve_fused_packed(
            mppi_cfg, model, st.u, seed, est_xyt, wpt, noise, hold=hold)
    else:
        cmd, u = mppi_solve(mppi_cfg, model, st.u, st.generator, est_xyt,
                            wpt, noise=None if noise is None
                            else noise.transpose(0, 1))
    return _act(ekf_cfg, cfg, model, landmarks, st, aim, cmd, u, sense,
                slam_step, meas_fn, meas_noise)


def _aim(cfg, waypoints, st):
    """The tick's part before the solve: the filter's pose as [x, y, θ],
    the waypoint it steers to, and (wpt_idx, visits, done) after the
    advance."""
    n_wpts = waypoints.shape[0]

    # The controller sees the FILTER's pose (ref: mppi_waypoints consumes
    # the odometer/slam estimate, never gazebo truth).
    est_txy = robot_pose(st.ekf)                       # [theta, x, y]
    est_xyt = torch.stack([est_txy[1], est_txy[2], est_txy[0]])

    wpt = _active_waypoint(waypoints, st.wpt_idx)
    d2g = torch.hypot(est_xyt[0] - wpt[0], est_xyt[1] - wpt[1])
    arrived = d2g < cfg.goal_thresh
    visits = st.visits + arrived.to(torch.int32)
    wpt_idx = torch.where(arrived, (st.wpt_idx + 1) % n_wpts, st.wpt_idx)
    done = torch.logical_or(st.done, visits >= cfg.cycles * n_wpts)
    return est_xyt, _active_waypoint(waypoints, wpt_idx), (wpt_idx, visits,
                                                           done)


def _act(ekf_cfg, cfg, model, landmarks, st, aim, cmd, u, sense, slam_step,
         meas_fn=None, meas_noise=None):
    """The tick's part after the solve (wheel command ``cmd``, shifted
    controls ``u``): plant → noisy odometry → sensor on schedule → filter.
    """
    wpt_idx, visits, done = aim
    cmd = torch.where(done, torch.zeros_like(cmd), cmd)

    # True plant (ref: fake encoders + odometer chain).
    f = lambda x, uu: kinematic_cart(model, x, uu)
    true_pose = rk4_step(f, st.true_pose, cmd, cfg.tick_dt)
    true_pose = torch.where(done, st.true_pose, true_pose)

    # Biased body displacement over the tick — what odometry reports.
    w_body = (model.wheel_radius / model.wheel_base) * (cmd[1] - cmd[0])
    v_body = 0.5 * model.wheel_radius * (cmd[0] + cmd[1])
    u_odom = torch.stack([w_body * cfg.tick_dt + cfg.odom_bias[0],
                          v_body * cfg.tick_dt + cfg.odom_bias[1]])
    u_odom = torch.where(done, torch.zeros_like(u_odom), u_odom)
    odom = ekff.motion_update(ekf_cfg, st.odom, u_odom,
                              torch.zeros_like(st.odom))

    # Landmark frame on schedule; the prediction alone off schedule. On a
    # sensing tick the sensor chain and the filter's step are the tracer's
    # device phases (no-ops while it is off or outside a graph's step).
    if sense:
        true_txy = torch.stack([true_pose[2], true_pose[0], true_pose[1]])
        with profiling.phase("slam.sense"):
            if meas_fn is None:
                meas = landmark_measurements(
                    landmarks, true_txy, cfg.visibility,
                    generator=st.generator, noise_std=cfg.meas_noise_std,
                    noise=meas_noise)
            else:
                meas = meas_fn(true_txy, st.generator)
        with profiling.phase("ekf.update"):
            ekf = slam_step(ekf_cfg, st.ekf, meas, u_odom)
    else:
        ekf = slam_step(ekf_cfg, st.ekf, st.odom.new_empty((0, 2)), u_odom)

    return st._replace(true_pose=true_pose, odom=odom, ekf=ekf, u=u,
                       wpt_idx=wpt_idx, visits=visits, ticks=st.ticks + 1,
                       done=done, host_ticks=st.host_ticks + 1)


# The fields a tick advances on the device.
_FIELDS = ("true_pose", "odom", "ekf", "u", "wpt_idx", "visits", "ticks",
           "done")


def _clone(st: SlamLoopState) -> SlamLoopState:
    """``st`` with every tensor copied (the generator shared)."""
    return st._replace(
        **{f: getattr(st, f).clone() for f in _FIELDS if f != "ekf"},
        ekf=EKFState(*(t.clone() for t in st.ekf)))


def _held(st: SlamLoopState, new: SlamLoopState, hold) -> SlamLoopState:
    """``new``, or every field of ``st`` where ``hold`` (a bool tensor)."""
    keep = {f: torch.where(hold, getattr(st, f), getattr(new, f))
            for f in _FIELDS if f != "ekf"}
    ekf = EKFState(*(torch.where(hold, a, b) for a, b in zip(st.ekf,
                                                              new.ekf)))
    return new._replace(ekf=ekf, **keep)


class _Chunks:
    """``chunk`` ticks of the loop on static state buffers (a copy of
    ``st``'s), as one ``capture.Graph`` step; each chunk starts on a
    sensing tick, so its schedule is fixed. With ``bound`` (an int) the
    ticks are held: a tick holds once the incoming state is done or its
    device tick count reaches ``bound``; with None they run on past done
    (a scan). ``status`` holds [done, ticks] after a step with ``bound``.

    The sensor is the landmark sensor, or ``meas_fn(true_txy, generator,
    noise=...)``, whose standard normals of shape ``meas_shape`` (None:
    it draws none) are injected. On the plain backend tick i takes its
    (K, N, 2) MPPI perturbations from ``perturb[i]``. :meth:`draw` makes
    the draws eagerly before each step, in the eager ticks' order.
    ``telemetry(state)`` gives a 1-D row per tick after the tick, stacked
    into ``tel`` (chunk, F).

    A seed batch ``st`` (:func:`slam_batch_init`; the fused backend, no
    ``bound``) runs each tick through :func:`_batch_tick`; ``normals`` and
    ``tel`` then lead with B, and :meth:`draw` draws each seed's normals
    from its own generator."""

    def __init__(self, mppi_cfg, ekf_cfg, cfg, model, waypoints, landmarks,
                 st, chunk: int, bound: Optional[int], meas_fn=None,
                 meas_shape=None, telemetry=None):
        dev = st.true_pose.device
        every = self.every = cfg.sensor_every
        self.bound, self.chunk, self.mppi_cfg = bound, chunk, mppi_cfg
        # A seed batch (slam_batch_init): every buffer leads with B.
        seeds = _seeds(st)
        lead = () if seeds is None else (seeds,)
        if seeds is not None and (bound is not None or not cfg.use_fused):
            raise ValueError("a seed batch runs the course form on the "
                             "fused backend only")
        # The body holds the buffers, not self: a graph whose runner is
        # dropped is freed at once, not by the cyclic collector.
        state = self.state = _clone(st)
        # One draw per sensing tick, as landmark_measurements (an (M, 2)
        # draw) or the meas_fn draws.
        shape = (tuple(landmarks.shape) if meas_fn is None else meas_shape)
        draws = (-(-chunk // every)
                 if shape is not None and (meas_fn is not None or
                                           cfg.meas_noise_std > 0.0) else 0)
        normals = self.normals = torch.zeros(
            (*lead, draws, *(shape or ())), dtype=landmarks.dtype,
            device=dev)
        perturb = self.perturb = (None if cfg.use_fused else torch.zeros(
            (chunk, mppi_cfg.rollouts, mppi_cfg.steps, 2),
            dtype=st.u.dtype, device=dev))
        status = self.status = torch.empty(2, dtype=torch.int32, device=dev)
        width = (0 if telemetry is None else
                 telemetry(st if seeds is None else seed_state(st, 0)).numel())
        tel = self.tel = (None if telemetry is None else torch.empty(
            (*lead, chunk, width), dtype=torch.float32, device=dev))
        slam_step = (known_correspondence_slam_masked if cfg.known_da
                     else slam_unknown_da_masked)

        def sensor(slot):
            return lambda txy, _: meas_fn(txy, None, noise=slot)

        def one_tick(s, i, sense, slot):
            hold = (None if bound is None else
                    torch.logical_or(s.done, s.ticks >= bound))
            # _tick takes the (N, K, 2) layout of the fused seam.
            new = _tick(mppi_cfg, ekf_cfg, cfg, model, waypoints, landmarks,
                        s, sense, slam_step,
                        meas_fn=None if meas_fn is None else sensor(slot),
                        noise=None if perturb is None
                        else perturb[i].transpose(0, 1),
                        meas_noise=None if meas_fn is not None else slot,
                        hold=hold)
            s = new if hold is None else _held(s, new, hold)
            return s, None if tel is None else telemetry(s)

        def batch_tick(s, i, sense, slot):
            return _batch_tick(mppi_cfg, ekf_cfg, cfg, model, waypoints,
                               landmarks, s, sense, slam_step, meas_fn, slot,
                               telemetry)

        tick = one_tick if seeds is None else batch_tick

        def body():
            s, rows = state, []
            for i in range(chunk):
                sense = i % every == 0
                slot = (normals.select(len(lead), i // every)
                        if sense and draws else None)
                s, row = tick(s, i, sense, slot)
                rows.append(row)
            # Stacked before the state buffers are written.
            if tel is not None:
                tel.copy_(torch.stack(rows, dim=len(lead)))
            for f in _FIELDS:
                if f != "ekf":
                    getattr(state, f).copy_(getattr(s, f))
            for buf, val in zip(state.ekf, s.ekf):
                buf.copy_(val)
            if bound is not None:
                status.copy_(torch.stack([s.done.to(torch.int32), s.ticks]))

        self.graph = capture.Graph(body, dev)

    def draw(self, n: int) -> None:
        """The draws of the chunk's first ``n`` ticks from the generator,
        in the eager ticks' order: each tick's MPPI perturbations (plain
        backend), then on a sensing tick the sensor's normals."""
        gen, normals, perturb = (self.state.generator, self.normals,
                                 self.perturb)
        if isinstance(gen, tuple):           # a seed batch: seed by seed
            for g, rows in zip(gen, normals):
                self._draw(n, g, rows, perturb)
        else:
            self._draw(n, gen, normals, perturb)

    def _draw(self, n, gen, normals, perturb):
        for i in range(n):
            if perturb is not None:
                perturb[i].copy_(sample_perturbations(
                    self.mppi_cfg, gen, dtype=perturb.dtype,
                    device=perturb.device))
            if i % self.every == 0 and i // self.every < normals.shape[0]:
                torch.randn(normals.shape[1:], generator=gen,
                            dtype=normals.dtype, device=normals.device,
                            out=normals[i // self.every])

    def run(self) -> None:
        """Draw the chunk's perturbations and normals and run it, with no
        host read."""
        with profiling.span("step.draw", self.graph):
            self.draw(self.chunk)
        self.graph()

    def step(self):
        """Draw the chunk's normals and run it: (stop, ticks after it)."""
        self.run()
        done, ticks = self.status.tolist()
        return bool(done) or ticks >= self.bound, ticks


def default_chunk(sensor_every: int) -> int:
    """:func:`run_slam_loop`'s chunk: the multiple of ``sensor_every``
    nearest at or above 60 ticks (one second at 60 Hz)."""
    return -(-60 // sensor_every) * sensor_every


def run_slam_loop(mppi_cfg: MPPIConfig, ekf_cfg: EKFConfig,
                  cfg: SlamLoopConfig, model: CartParams, waypoints,
                  landmarks, st: SlamLoopState, max_ticks: int,
                  chunk: Optional[int] = None) -> SlamLoopState:
    """Run the closed loop until the course completes or ``max_ticks``,
    ending in the state of ``tpunav``'s ``while_loop``, the generator where
    the eager per-tick loop leaves it: eager ticks to the next sensing
    tick, then ``chunk`` ticks replayed per host read (default
    :func:`default_chunk`; see the module's docstring)."""
    dev = st.true_pose.device
    waypoints = torch.as_tensor(waypoints, dtype=torch.float32).to(dev)
    landmarks = torch.as_tensor(landmarks, dtype=torch.float32).to(dev)
    every = cfg.sensor_every
    chunk = default_chunk(every) if chunk is None else chunk
    _check_chunk(chunk, every)

    def eager(until_aligned: bool):
        nonlocal st
        while st.host_ticks < max_ticks and not bool(st.done) and not (
                until_aligned and st.host_ticks % every == 0):
            st = slam_loop_tick(mppi_cfg, ekf_cfg, cfg, model, waypoints,
                                landmarks, st)

    eager(True)                       # to the next sensing tick
    if st.host_ticks >= max_ticks or bool(st.done):
        return st
    ticks0 = int(st.ticks)
    chunks = _Chunks(mppi_cfg, ekf_cfg, cfg, model, waypoints, landmarks,
                     st, chunk, max_ticks - st.host_ticks + ticks0)
    start = ticks0
    while True:
        before = st.generator.get_state()
        stop, ticks = chunks.step()
        if stop:
            break
        start = ticks
    # The eager loop draws on live ticks only: the last chunk's draws
    # again from where it began, those of its live ticks.
    st.generator.set_state(before)
    chunks.draw(ticks - start)
    return chunks.state._replace(host_ticks=st.host_ticks + ticks - ticks0)


def run_slam_course(mppi_cfg: MPPIConfig, ekf_cfg: EKFConfig,
                    cfg: SlamLoopConfig, model: CartParams, waypoints,
                    landmarks, st: SlamLoopState, ticks: int, meas_fn=None,
                    meas_shape=None, telemetry=None,
                    chunk: Optional[int] = None):
    """``ticks`` ticks of the loop from ``st``, on past ``done``
    (``tpunav``'s ``lax.scan`` of :func:`slam_loop_tick`), with
    ``telemetry(state)``'s row after every tick. Returns (state, rows
    (ticks, F) float32 or None).

    ``meas_fn(true_txy, generator, noise=None)`` replaces the landmark
    sensor as in :func:`slam_loop_tick`; ``meas_shape`` is the shape of the
    standard normals it draws from the generator on a sensing tick (None:
    none), which ``noise=`` replaces. It runs eager ticks to the next
    sensing tick, then a :class:`SlamCourseRunner`'s replays: ``chunk``
    ticks per graph step (default :func:`default_chunk`) and the rest in
    its one shorter graph, with no host read, and gives the eager per-tick
    loop's state, rows and generator bit for bit on either backend.

    A seed batch ``st`` (:func:`slam_batch_init`; the fused backend, from a
    sensing tick) runs as ``tpunav``'s ``jax.vmap`` of the course over
    seeds: each replayed chunk advances all B seeds, every tick one mapped
    body and one K1 launch for the B solves, and the detector's eigensolver
    one call for the B scans. Each seed's sensor normals are drawn eagerly
    from its own generator in its serial course's order, so seed i ends in
    the state, rows and generator of this function from ``seed_state(st,
    i)``. ``telemetry(state)`` and ``meas_fn`` are then one seed's; the
    state's fields and the rows lead with B (rows (B, ticks, F)).
    """
    dev = st.true_pose.device
    waypoints = torch.as_tensor(waypoints, dtype=torch.float32).to(dev)
    landmarks = torch.as_tensor(landmarks, dtype=torch.float32).to(dev)
    every = cfg.sensor_every
    chunk = default_chunk(every) if chunk is None else chunk
    _check_chunk(chunk, every)
    batched = _seeds(st) is not None
    if batched and st.host_ticks % every:
        raise ValueError("a seed batch's course starts on a sensing tick")
    rows, done = [], 0
    while done < ticks and st.host_ticks % every:
        st = slam_loop_tick(mppi_cfg, ekf_cfg, cfg, model, waypoints,
                            landmarks, st, meas_fn=meas_fn)
        if telemetry is not None:
            rows.append(telemetry(st)[None])
        done += 1
    length, tail, steps = course_plan(ticks - done, chunk)
    if steps:
        runner = SlamCourseRunner(
            mppi_cfg, ekf_cfg, cfg, model, waypoints, landmarks, st,
            chunk=length, tail=tail, meas_fn=meas_fn, meas_shape=meas_shape,
            telemetry=telemetry, device=dev)
        for last in steps:
            runner.run(tail=last)
            if telemetry is not None:
                rows.append(runner.rows.clone())
        st = runner.state
    return st, (torch.cat(rows, dim=int(batched)) if rows else None)


def course_plan(ticks: int, chunk: int):
    """A course of ``ticks`` from a sensing tick on a
    :class:`SlamCourseRunner`: (the runner's chunk, its tail, each step's
    ``tail`` flag). Whole chunks, then the rest in the tail graph; a
    course shorter than a chunk is one chunk of its length."""
    full, rest = divmod(ticks, chunk)
    if not full:
        return rest, 0, [False] * bool(rest)
    return chunk, rest, [False] * full + [True] * bool(rest)


def _check_chunk(chunk: int, every: int) -> None:
    if chunk < 1 or chunk % every:
        raise ValueError(f"chunk {chunk} must be a positive multiple of "
                         f"sensor_every ({every})")


def _load_state(buffers: SlamLoopState, st: SlamLoopState) -> None:
    """``st``'s fields into the state ``buffers`` in place
    (``capture.load``), the generators' states with them."""
    def flat(s):
        gens = s.generator if isinstance(s.generator, tuple) else (
            s.generator,)
        return [*(getattr(s, f) for f in _FIELDS if f != "ekf"), *s.ekf,
                *gens]

    capture.load(flat(buffers), flat(st))


class SlamCourseRunner:
    """The course form of the loop (:func:`run_slam_course`'s ticks, on
    past ``done``) as replayed graphs on static state buffers, for a serial
    state or a seed batch: ``chunk`` ticks per step (default
    :func:`default_chunk`), and where ``tail`` > 0 one shorter graph of
    ``tail`` ticks that ends a course whose length is no whole number of
    chunks. Each graph is captured once, on its second step (the first is
    the warm-up, itself a real step); a new course is loaded into the
    buffers in place (:meth:`load`), so nothing is captured again.

    ``st`` (on ``device``, default the card, which raises without CUDA)
    starts on a sensing tick and is copied into the buffers; a seed batch
    runs on the fused backend, as in :func:`run_slam_course`. Every step
    starts on a sensing tick, so a ``chunk`` that is no multiple of the
    sensing period ends the course. Each
    :meth:`run` draws its ticks' normals eagerly from the state's
    generators (a ``step.draw`` span), then replays, with no host read;
    :attr:`rows` holds the telemetry rows of the last run ((chunk, F), or
    (B, chunk, F) for a batch) and :attr:`state` the state after it."""

    def __init__(self, mppi_cfg: MPPIConfig, ekf_cfg: EKFConfig,
                 cfg: SlamLoopConfig, model: CartParams, waypoints,
                 landmarks, st: SlamLoopState, chunk: Optional[int] = None,
                 tail: int = 0, meas_fn=None, meas_shape=None,
                 telemetry=None, device=DEFAULT_DEVICE):
        capture.state_device(st.true_pose, device)
        chunk = default_chunk(cfg.sensor_every) if chunk is None else chunk
        if chunk < 1 or tail < 0:
            raise ValueError(f"chunk {chunk} must be positive and tail "
                             f"{tail} not negative")
        self.every = cfg.sensor_every
        self._aligned(st.host_ticks)

        def runner(length):
            return _Chunks(mppi_cfg, ekf_cfg, cfg, model, waypoints,
                           landmarks, st, length, None, meas_fn, meas_shape,
                           telemetry)

        self._main = self._current = runner(chunk)
        self._tail = runner(tail) if tail > 0 else None
        self.host_ticks = st.host_ticks

    @property
    def state(self) -> SlamLoopState:
        """The state after the last run (the buffers, not a copy)."""
        return self._current.state._replace(host_ticks=self.host_ticks)

    @property
    def rows(self) -> Optional[torch.Tensor]:
        """The last run's telemetry rows (a static buffer, not a copy), or
        None without ``telemetry``."""
        return self._current.tel

    def _aligned(self, host_ticks: int) -> None:
        if host_ticks % self.every:
            raise ValueError("a course runner's step starts on a sensing "
                             "tick")

    def load(self, st: SlamLoopState) -> None:
        """Start a course from ``st`` (on a sensing tick, of the runner's
        shape): its fields and its generators' states into the buffers, in
        place (a ``step.load`` span)."""
        self._aligned(st.host_ticks)
        with profiling.span("step.load", self._main.graph):
            _load_state(self._main.state, st)
        self._current = self._main
        self.host_ticks = st.host_ticks

    def run(self, tail: bool = False) -> None:
        """One step: ``chunk`` ticks, or with ``tail`` the tail graph's
        ticks, from the state the last step (or :meth:`load`) left."""
        nxt = self._tail if tail else self._main
        if nxt is None:
            raise ValueError("the runner has no tail graph")
        self._aligned(self.host_ticks)
        if nxt is not self._current:
            _load_state(nxt.state, self._current.state)
            self._current = nxt
        nxt.run()
        self.host_ticks += nxt.chunk


# ── Seed batches: ``tpunav``'s vmap of the course over seeds ──


def _seeds(st: SlamLoopState) -> Optional[int]:
    """B for a seed batch (its ``generator`` is a tuple), else None."""
    return len(st.generator) if isinstance(st.generator, tuple) else None


def stack_states(states) -> SlamLoopState:
    """Serial states of one schedule as one seed batch: every tensor field
    stacked on a leading B, ``generator`` the tuple of their generators."""
    first = states[0]
    if any(s.host_ticks != first.host_ticks for s in states):
        raise ValueError("a seed batch's states share one tick count")
    return first._replace(
        **{f: torch.stack([getattr(s, f) for s in states])
           for f in _FIELDS if f != "ekf"},
        ekf=EKFState(*(torch.stack(t) for t in zip(*(s.ekf for s in
                                                      states)))),
        generator=tuple(s.generator for s in states))


def seed_state(st: SlamLoopState, i: int) -> SlamLoopState:
    """Seed ``i`` of a batch as a serial state (views of the batch's
    tensors, and its generator)."""
    return st._replace(
        **{f: getattr(st, f)[i] for f in _FIELDS if f != "ekf"},
        ekf=EKFState(*(t[i] for t in st.ekf)), generator=st.generator[i])


def slam_batch_init(mppi_cfg: MPPIConfig, ekf_cfg: EKFConfig, seeds,
                    pose_xyt=None, device=DEFAULT_DEVICE) -> SlamLoopState:
    """The loop's start for each of ``seeds`` as one seed batch
    (:func:`stack_states` of :func:`slam_loop_init`'s states: each seed's
    generator seeded as its serial start seeds it), on ``device`` (default
    the CUDA card; raises without CUDA unless ``device="cpu"``)."""
    device = resolve(device)
    seeds = [int(s) for s in seeds]
    if not seeds:
        raise ValueError("a seed batch needs at least one seed")
    return stack_states([slam_loop_init(mppi_cfg, ekf_cfg, pose_xyt, seed=s,
                                        device=device) for s in seeds])


def _as_state(fields) -> SlamLoopState:
    """One seed's tensor fields as a state with no generator (a mapped
    body draws nothing)."""
    return SlamLoopState(generator=None, host_ticks=0,
                         **dict(zip(_FIELDS, fields)))


def _batch_tick(mppi_cfg, ekf_cfg, cfg, model, waypoints, landmarks, st,
                sense, slam_step, meas_fn, slot, telemetry):
    """One tick of every seed of the batch ``st``: the tick's parts before
    and after the solve mapped over the seeds (:mod:`tpunav_torch.batch`),
    and one K1 launch for all B solves between them. ``slot``: the sensing
    tick's (B, ...) injected normals, or None. Returns (state, the (B, F)
    telemetry rows or None)."""
    fields = tuple(getattr(st, f) for f in _FIELDS)
    est_xyt, wpt, aim = batch.vmap(
        lambda f: _aim(cfg, waypoints, _as_state(f)))(fields)
    u_new = fused_mppi.mppi_solve_fused_batch(
        mppi_cfg, model, st.u, cfg.fused_seed + st.ticks,
        est_xyt.contiguous(), wpt.contiguous())

    def act(f, aim, u_new, slot):
        sensor = (None if meas_fn is None else
                  lambda txy, _: meas_fn(txy, None, noise=slot))
        new = _act(ekf_cfg, cfg, model, landmarks, _as_state(f), aim,
                   u_new[0], shift_controls(mppi_cfg, u_new), sense,
                   slam_step, sensor, None if meas_fn is not None else slot)
        out = tuple(getattr(new, name) for name in _FIELDS)
        return out, (() if telemetry is None else telemetry(new))

    out, rows = batch.vmap(act, (0, 0, 0, None if slot is None else 0))(
        fields, aim, u_new, slot)
    return (st._replace(**dict(zip(_FIELDS, out))),
            None if telemetry is None else rows)

