"""SLAM runtime nodes: EKF landmark SLAM and RBPF grid mapping.

Port of ``tpunav/runtime/slam_nodes.py``. These complete the reference's
L4 process graph (SURVEY.md §2.3/§2.4): channel-driven node classes
wrapping the estimation functions, with the same wiring the reference
nodes use — dual odometry models (a dead-reckoning one and a filter-input
one), the map→odom frame correction Tmo = Tmr·(Tor)⁻¹, and PoseError
against ground truth.

Where ``tpunav`` jits a closure around each filter step, a node here
replays a CUDA graph (``capture.Graph``) on static tensors on ``device``
(default the CUDA card): the landmarks node its detector, the EKF node
``EKFStepper``'s update and the RBPF node ``PFStepper``'s (kernels K2 and
K3; K4 once, in ``pf_init``, outside the graph). The SLAM nodes' graphs
also advance the filter-input odometry from the dead-reckoning odometry's
latest wheel angles, copied in device to device before each replay, and
gather the estimates the node publishes. Payloads stay numpy; a message
that enters a node is copied to its device once, and the estimates it
publishes come back together in one copy. A filter's state lives in the
graph's buffers: assigning it loads them in place (``capture.load``).

ref: nuslam/src/slam_node.cpp:164-464 (EKF node),
     bmapping/src/turtle_mapping_node.cpp:203-666 (RBPF node).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import capture
from ..core import diff_drive as dd
from ..core import se2
from ..device import DEFAULT_DEVICE, resolve
from ..estimation.ekf import (EKFConfig, EKFState, ekf_init, landmark_map,
                              robot_pose)
from ..estimation.ekf.filter import EKFStepper
from ..estimation.landmarks import (LandmarkConfig, circles_to_measurements,
                                    feature_detection)
from ..estimation.rbpf import PFConfig, PFState, best_particle, pf_init
from ..estimation.rbpf.grid import occupancy_grid
from ..estimation.rbpf.particle_filter import PFStepper
from .channels import Channel
from .metrics import PoseError
from .nodes import host, to_device, to_static


def map_to_odom(slam_pose, odom_pose):
    """Frame correction Tmo = Tmr · (Tor)⁻¹ so that map→odom→base chains
    to the SLAM estimate (ref: slam_node.cpp:306-339). Poses are
    [theta, x, y] tensors (or numpy) on one device; returns the same triple
    for the map→odom transform."""
    slam_pose = torch.as_tensor(slam_pose)
    odom_pose = torch.as_tensor(odom_pose)
    tmr = se2.make(slam_pose[0], slam_pose[1], slam_pose[2])
    tor = se2.make(odom_pose[0], odom_pose[1], odom_pose[2])
    tmo = se2.compose(tmr, se2.inverse(tor))
    xy = se2.translation_of(tmo)
    return torch.stack([se2.theta_of(tmo), xy[0], xy[1]])


def _static_drive(dtype, device) -> dd.DiffDriveState:
    """A filter-input odometry model in static tensors (one per field), at
    the origin: a node's graph advances it in place."""
    return dd.DiffDriveState(*(t.clone() for t in dd.init_state(
        dtype=dtype, device=device)))


def _drive_input(dtype, device):
    """A static (7,) tensor for the dead-reckoning odometry's state (pose,
    left, right, ul, ur) and the ``DiffDriveState`` that views it: a node's
    graph reads the odometry there, copied in by :func:`_copy_drive`."""
    buf = torch.zeros(7, dtype=dtype, device=device)
    return buf, dd.DiffDriveState(buf[:3], buf[3], buf[4], buf[5], buf[6])


def _copy_drive(buf, drive: dd.DiffDriveState) -> None:
    """The odometry's current state into its static tensor, device to
    device in one launch: the eager odometry rebinds its tensors on every
    joints message, so a graph must not read them."""
    torch.cat([t.reshape(-1) for t in drive], out=buf)


class LandmarksNode:
    """Lidar feature-detection node (ref: nuslam/src/landmarks_node.cpp):
    subscribes a raw range scan, runs the clustering + circle-fit
    pipeline on ``device``, and publishes the (C, 2) NaN-masked
    robot-frame measurement array (the TurtleMap equivalent) for the EKF
    node — plus, optionally, the full (centers, radii, valid) triple for
    map drawing (ref: nuslam/src/draw_map_node.cpp:59-102).

    The detector (``feature_detection`` + ``circles_to_measurements``) is
    one ``capture.Graph`` step on a static scan buffer, built at the first
    scan: a tick copies the scan in, replays, and brings the outputs back
    in one host copy, packed as (C, 2) measurements or, with
    ``turtle_map``, (C, 6) rows [measurement, center, radius, valid].
    """

    def __init__(self, cfg: LandmarkConfig, scan: Channel,
                 landmarks: Channel, turtle_map: Optional[Channel] = None,
                 dtype=torch.float32, device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.scan = scan
        self.landmarks = landmarks
        self.turtle_map = turtle_map
        self.dtype = dtype
        self.device = resolve(device)
        self._seen_scan = 0
        self._ranges = self._out = self._graph = None

    def _build(self, shape) -> None:
        cfg, full = self.cfg, self.turtle_map is not None
        # The body holds the buffers, not self: a graph whose node is
        # dropped is freed at once, not by the cyclic collector.
        ranges = self._ranges = torch.empty(shape, dtype=self.dtype,
                                            device=self.device)
        out = self._out = torch.empty((cfg.max_clusters, 6 if full else 2),
                                      dtype=self.dtype, device=self.device)

        def body():
            circles = feature_detection(cfg, ranges)
            parts = [circles_to_measurements(circles)]
            if full:
                parts += [circles.centers, circles.radii[:, None],
                          circles.valid[:, None].to(out.dtype)]
            out.copy_(torch.cat(parts, dim=1))

        self._graph = capture.Graph(body, self.device)

    def tick(self, t: float) -> None:
        ranges, self._seen_scan = self.scan.take_new(self._seen_scan)
        if ranges is None:
            return
        ranges = np.asarray(ranges)
        if self._graph is None:
            self._build(ranges.shape)
        to_static(self._ranges, ranges)
        self._graph()
        out = host(self._out)
        self.landmarks.publish(np.ascontiguousarray(out[:, :2]))
        if self.turtle_map is not None:
            self.turtle_map.publish((np.ascontiguousarray(out[:, 2:4]),
                                     np.ascontiguousarray(out[:, 4]),
                                     out[:, 5] != 0))


class EkfSlamNode:
    """EKF landmark-SLAM node (ref: nuslam/src/slam_node.cpp).

    Subscribes wheel joint angles and robot-frame landmark measurements
    (the TurtleMap equivalent: an (M, 2) array, NaN rows invisible);
    maintains TWO odometry models exactly like the reference (:234-236) —
    ``drive`` dead-reckons continuously, ``ekf_drive`` advances only on
    measurement arrival and supplies the filter's control input; publishes
    the SLAM pose, the dead-reckoned odometry pose, the map→odom
    correction, the landmark map estimate, and PoseError vs ground truth
    when a truth channel is wired (:436-463).

    An update is one ``capture.Graph`` step, built at the first
    measurement message (and again, from the current state, when a
    message's row count changes): ``ekf_drive`` advanced to ``drive``'s
    wheel angles, its twist into :class:`EKFStepper`'s masked update, and
    [pose, map→odom, landmark map, active mask] gathered into one buffer
    that comes back in one host copy. ``ekf`` is the filter's state.
    """

    def __init__(self, cfg: EKFConfig, params: dd.DiffDriveParams,
                 joints: Channel, landmarks: Channel,
                 slam_pose: Channel, odom_pose: Channel,
                 map_odom: Optional[Channel] = None,
                 landmark_est: Optional[Channel] = None,
                 truth: Optional[Channel] = None,
                 errors: Optional[Channel] = None,
                 known_da: bool = True, dtype=torch.float32,
                 device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.params = params
        self.joints = joints
        self.landmarks = landmarks
        self.slam_pose = slam_pose
        self.odom_pose = odom_pose
        self.map_odom = map_odom
        self.landmark_est = landmark_est
        self.truth = truth
        self.errors = errors
        self.dtype = dtype
        self.device = resolve(device)
        self.known_da = known_da
        self.drive = dd.init_state(dtype=dtype, device=device)  # odometry
        self.ekf_drive = _static_drive(dtype, self.device)      # input
        self._drive_in, self._drive = _drive_input(dtype, self.device)
        self._ekf = ekf_init(cfg, dtype=dtype, device=device)
        self._stepper = self._graph = self._out = None
        self._seen_joints = 0
        self._seen_map = 0

    @property
    def ekf(self) -> EKFState:
        """The filter's state: the stepper's buffers once it is built."""
        return self._ekf if self._stepper is None else self._stepper.state

    def _build(self, n_meas: int) -> None:
        cfg, params, n = self.cfg, self.params, self.cfg.num_landmarks
        stepper = self._stepper = EKFStepper(cfg, self.ekf, n_meas,
                                             self.known_da, self.device)
        self._ekf = None
        # The body holds the buffers, not self.
        state, update, (_, u) = stepper.state, stepper.update, stepper.inputs
        drive, ekf_drive = self._drive, self.ekf_drive
        out = self._out = torch.empty(6 + 3 * n, dtype=self.dtype,
                                      device=self.device)

        def body():
            # The filter-input odometry to the latest wheel angles, its
            # body twist to the EKF (ref: :282-284).
            nxt, wheel_vel = dd.update_odometry(params, ekf_drive, drive.left,
                                                drive.right)
            u.copy_(dd.wheels_to_twist(params, wheel_vel)[:2])  # [w, vx]
            update()
            capture.load(ekf_drive, nxt)
            pose = robot_pose(state)
            centers, active = landmark_map(cfg, state)
            torch.cat([pose, map_to_odom(pose, dd.pose(drive)),
                       centers.reshape(-1), active.to(out.dtype)], out=out)

        self._graph = capture.Graph(body, self.device)

    def tick(self, t: float) -> None:
        msg, self._seen_joints = self.joints.take_new(self._seen_joints)
        if msg is not None:
            lr = to_device(msg[:2], self.dtype, self.device)
            self.drive, _ = dd.update_odometry(self.params, self.drive,
                                               lr[0], lr[1])
            self.odom_pose.publish(host(dd.pose(self.drive)))

        meas, self._seen_map = self.landmarks.take_new(self._seen_map)
        if meas is None:
            return
        meas = np.asarray(meas)
        if self._stepper is None or \
                self._stepper.inputs[0].shape[0] != meas.shape[0]:
            self._build(meas.shape[0])
        to_static(self._stepper.inputs[0], meas)
        _copy_drive(self._drive_in, self.drive)
        self._graph()
        out = host(self._out)
        pose, n = out[:3], self.cfg.num_landmarks
        self.slam_pose.publish(pose)
        if self.map_odom is not None:
            self.map_odom.publish(out[3:6])
        if self.landmark_est is not None:
            self.landmark_est.publish((out[6:6 + 2 * n].reshape(n, 2),
                                       out[6 + 2 * n:] != 0))
        if self.errors is not None and self.truth is not None \
                and self.truth.latest() is not None:
            self.errors.publish(PoseError.between(pose,
                                                  self.truth.latest()))


class RbpfMappingNode:
    """RBPF FastSLAM grid-mapping node
    (ref: bmapping/src/turtle_mapping_node.cpp:203-666).

    Runs the particle-filter SLAM update whenever a scan AND fresh
    odometry coincide (:456-487); publishes the best-particle pose, its
    occupancy grid, the map→odom correction, and PoseError vs truth.

    An update is one ``capture.Graph`` step, built at the first update:
    ``pf_drive`` advanced to ``drive``'s wheel angles, its twist and the
    two odometry poses into :class:`PFStepper`'s update (its normals drawn
    eagerly before the replay), and [best pose, map→odom, occupancy grid]
    gathered into one buffer that comes back in one host copy. ``pf`` is
    the filter's state; assigning it (a checkpoint's resume) loads the
    given state and its generator's into the buffers in place.
    """

    def __init__(self, cfg: PFConfig, params: dd.DiffDriveParams,
                 joints: Channel, scan: Channel,
                 slam_pose: Channel, grid_out: Channel,
                 odom_pose: Optional[Channel] = None,
                 map_odom: Optional[Channel] = None,
                 truth: Optional[Channel] = None,
                 errors: Optional[Channel] = None,
                 seed: int = 0, dtype=torch.float32,
                 device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.params = params
        self.joints = joints
        self.scan = scan
        self.slam_pose = slam_pose
        self.grid_out = grid_out
        self.odom_pose = odom_pose
        self.map_odom = map_odom
        self.truth = truth
        self.errors = errors
        self.dtype = dtype
        self.device = resolve(device)
        self.drive = dd.init_state(dtype=dtype, device=device)  # odometry
        self.pf_drive = _static_drive(dtype, self.device)       # input
        self.prev_odom = torch.zeros(3, dtype=dtype, device=self.device)
        self._drive_in, self._drive = _drive_input(dtype, self.device)
        self._pf = pf_init(cfg, seed=seed, dtype=dtype, device=device)
        self._stepper = self._graph = self._out = None
        self._seen_joints = 0
        self._seen_scan = 0
        self._have_odom = False

    @property
    def pf(self) -> PFState:
        """The filter's state: the stepper's buffers once it is built."""
        return self._pf if self._stepper is None else self._stepper.state

    @pf.setter
    def pf(self, st: PFState) -> None:
        capture.load(self.pf, st)

    def _build(self) -> None:
        cfg, params = self.cfg, self.params
        stepper = self._stepper = PFStepper(cfg, self._pf, self.device)
        self._pf = None
        # The body holds the buffers, not self.
        state, update = stepper.state, stepper.update
        _, u, cur_odom, prev_in = stepper.inputs
        drive, pf_drive, prev = self._drive, self.pf_drive, self.prev_odom
        out = self._out = torch.empty(6 + cfg.grid.height * cfg.grid.width,
                                      dtype=self.dtype, device=self.device)

        def body():
            # Signed body twist over the inter-scan interval: advance a
            # second odometry model (pf_drive) to the latest wheel angles
            # and convert the wrapped wheel deltas, exactly like the
            # reference's pf_drive.updateOdometry → wheelsToTwist
            # (ref: turtle_mapping_node.cpp:469-474). A pose-difference
            # twist would lose the translation sign when reversing and
            # blow up ~2π when the heading wraps across ±π.
            nxt, wheel_vel = dd.update_odometry(params, pf_drive, drive.left,
                                                drive.right)
            u.copy_(dd.wheels_to_twist(params, wheel_vel)[:2])  # [w, vx]
            cur_odom.copy_(dd.pose(drive))
            prev_in.copy_(prev)
            update()
            capture.load(pf_drive, nxt)
            prev.copy_(cur_odom)
            pose, grid = best_particle(state)
            occupancy = occupancy_grid(cfg.grid, grid).reshape(-1)
            torch.cat([pose, map_to_odom(pose, cur_odom),
                       occupancy.to(out.dtype)], out=out)

        self._graph = capture.Graph(body, self.device)

    def tick(self, t: float) -> None:
        msg, self._seen_joints = self.joints.take_new(self._seen_joints)
        if msg is not None:
            lr = to_device(msg[:2], self.dtype, self.device)
            self.drive, _ = dd.update_odometry(self.params, self.drive,
                                               lr[0], lr[1])
            self._have_odom = True
            if self.odom_pose is not None:
                self.odom_pose.publish(host(dd.pose(self.drive)))

        ranges, self._seen_scan = self.scan.take_new(self._seen_scan)
        if ranges is None or not self._have_odom:
            return
        if self._stepper is None:
            self._build()
        to_static(self._stepper.inputs[0], ranges)
        self._stepper.draw()
        _copy_drive(self._drive_in, self.drive)
        self._graph()
        out = host(self._out)
        pose, g = out[:3], self.cfg.grid
        self.slam_pose.publish(pose)
        self.grid_out.publish(out[6:].astype(np.int8).reshape(g.height,
                                                              g.width))
        if self.map_odom is not None:
            self.map_odom.publish(out[3:6])
        if self.errors is not None and self.truth is not None \
                and self.truth.latest() is not None:
            self.errors.publish(PoseError.between(pose,
                                                  self.truth.latest()))
