"""SLAM runtime nodes: EKF landmark SLAM and RBPF grid mapping.

Port of ``tpunav/runtime/slam_nodes.py``. These complete the reference's
L4 process graph (SURVEY.md §2.3/§2.4): channel-driven node classes
wrapping the estimation functions, with the same wiring the reference
nodes use — dual odometry models (a dead-reckoning one and a filter-input
one), the map→odom frame correction Tmo = Tmr·(Tor)⁻¹, and PoseError
against ground truth.

Where ``tpunav`` jits a closure around each filter step, a node here calls
the port's function on its state, which lives on ``device`` (default the
CUDA card): the RBPF update there launches kernels K2 and K3 (and K4 once,
in ``pf_init``). The landmarks node replays its detector as a CUDA graph
(``capture.Graph``), the counterpart of ``tpunav``'s jitted detector.
Payloads stay numpy; a message that enters a node is copied to its device
once, and the estimates it publishes come back together in one copy.

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
from ..estimation.ekf import (EKFConfig, ekf_init, known_correspondence_slam,
                              landmark_map, robot_pose, slam_unknown_da)
from ..estimation.landmarks import (LandmarkConfig, circles_to_measurements,
                                    feature_detection)
from ..estimation.rbpf import (PFConfig, best_particle, pf_init,
                               pf_slam_step)
from ..estimation.rbpf.grid import occupancy_grid
from .channels import Channel
from .metrics import PoseError
from .nodes import host, to_device


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
        scan = to_device(ranges, self.dtype, self.device)
        if self._graph is None:
            self._build(scan.shape)
        self._ranges.copy_(scan)
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
        self.drive = dd.init_state(dtype=dtype, device=device)  # odometry
        self.ekf_drive = dd.init_state(dtype=dtype, device=device)  # input
        self.ekf = ekf_init(cfg, dtype=dtype, device=device)
        self._step = (known_correspondence_slam if known_da
                      else slam_unknown_da)
        self._seen_joints = 0
        self._seen_map = 0

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
        # Advance the filter-input odometry to the latest wheel angles and
        # feed the resulting body twist to the EKF (ref: :282-284).
        self.ekf_drive, wheel_vel = dd.update_odometry(
            self.params, self.ekf_drive, self.drive.left, self.drive.right)
        u = dd.wheels_to_twist(self.params, wheel_vel)[:2]   # [w, vx]
        self.ekf = self._step(self.cfg, self.ekf,
                              to_device(meas, self.dtype, self.device), u)

        pose_t = robot_pose(self.ekf)
        out = [pose_t]
        if self.map_odom is not None:
            out.append(map_to_odom(pose_t, dd.pose(self.drive)))
        out = host(torch.cat(out))
        pose = out[:3]
        self.slam_pose.publish(pose)
        if self.map_odom is not None:
            self.map_odom.publish(out[3:])
        if self.landmark_est is not None:
            centers, active = landmark_map(self.cfg, self.ekf)
            self.landmark_est.publish((host(centers), host(active)))
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
        self.pf_drive = dd.init_state(dtype=dtype, device=device)  # input
        self.pf = pf_init(cfg, seed=seed, dtype=dtype, device=device)
        self.prev_odom = torch.zeros(3, dtype=dtype, device=self.device)
        self._seen_joints = 0
        self._seen_scan = 0
        self._have_odom = False

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
        cur_odom = dd.pose(self.drive)
        # Signed body twist over the inter-scan interval: advance a second
        # odometry model (pf_drive) to the latest wheel angles and convert
        # the wrapped wheel deltas, exactly like the reference's
        # pf_drive.updateOdometry → wheelsToTwist
        # (ref: turtle_mapping_node.cpp:469-474). A pose-difference twist
        # would lose the translation sign when reversing and blow up ~2π
        # when the heading wraps across ±π.
        self.pf_drive, wheel_vel = dd.update_odometry(
            self.params, self.pf_drive, self.drive.left, self.drive.right)
        u = dd.wheels_to_twist(self.params, wheel_vel)[:2]   # [w, vx]
        self.pf = pf_slam_step(self.cfg, self.pf,
                               to_device(ranges, self.dtype, self.device), u,
                               cur_odom, self.prev_odom)
        self.prev_odom = cur_odom

        pose_t, grid = best_particle(self.pf)
        out = [pose_t]
        if self.map_odom is not None:
            out.append(map_to_odom(pose_t, cur_odom))
        out = host(torch.cat(out))
        pose = out[:3]
        self.slam_pose.publish(pose)
        self.grid_out.publish(host(occupancy_grid(self.cfg.grid, grid)))
        if self.map_odom is not None:
            self.map_odom.publish(out[3:])
        if self.errors is not None and self.truth is not None \
                and self.truth.latest() is not None:
            self.errors.publish(PoseError.between(pose,
                                                  self.truth.latest()))
