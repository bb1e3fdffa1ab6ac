"""Live view of a running node graph — the rviz replacement.

Counterpart of ``examples/live_view_demo.py``. Runs the EKF SLAM node
graph (fake encoders, the landmark sensor, the EKF node, the waypoint
driver) on the wall-clock ``Scheduler`` with a ``LiveViewNode`` that
redraws ``examples_torch/out/live_view.png`` at 4 Hz while the robot
drives — open the file in any viewer that refreshes (an editor's image
tab, a browser) to watch the run, as the reference streams paths and
markers into rviz (ref: nuslam/src/slam_node.cpp:396-432,
nuslam/launch/slam.launch rviz node). ``--rbpf`` runs the RBPF variant,
whose view is the best particle's occupancy grid growing.

    python -m examples_torch.live_view_demo --seconds 8 [--device cpu]

The nodes' state lives on ``--device``; the view needs matplotlib.
"""

from __future__ import annotations

import numpy as np
import torch

from examples_torch import device_parser, out_path
from tpunav_torch.core import diff_drive as dd
from tpunav_torch.device import DEFAULT_DEVICE, resolve
from tpunav_torch.estimation.ekf import EKFConfig
from tpunav_torch.runtime.channels import Channel, Node, Scheduler
from tpunav_torch.runtime.live import LiveViewNode
from tpunav_torch.runtime.nodes import FakeDiffEncodersNode, WaypointDriverNode
from tpunav_torch.runtime.slam_nodes import EkfSlamNode
from tpunav_torch.sim.landmark_sensor import landmark_measurements

LANDMARKS = np.array([[0.6, 0.1], [0.4, 0.5], [-0.2, 0.6], [-0.5, -0.1],
                      [0.0, -0.6], [0.5, -0.4], [0.8, 0.6], [-0.6, 0.5]])
WAYPOINTS = np.array([[0.4, 0.0, 0.0], [0.3, 0.4, 1.57],
                      [-0.3, 0.3, 3.0], [-0.3, -0.3, -2.0],
                      [0.3, -0.3, -0.7]])
PARAMS = dd.DiffDriveParams(wheel_radius=0.033, wheel_base=0.16)


def p_law(pose_xyt, wpt):
    """P-controlled heading, constant drive when aligned (the reference's
    closed-loop waypoint law, waypoints.cpp:70-108)."""
    x, y, th = pose_xyt
    bearing = np.arctan2(wpt[1] - y, wpt[0] - x)
    err = (bearing - th + np.pi) % (2 * np.pi) - np.pi
    if abs(err) > 0.1:
        return np.array([np.clip(2.0 * err, -1.2, 1.2), 0.0, 0.0])
    return np.array([0.0, 0.15, 0.0])


def build(out_png, realtime=True, view_hz=4.0, device=DEFAULT_DEVICE):
    """The EKF graph; returns (scheduler, view, channels)."""
    device = resolve(device)
    ch = {n: Channel(n) for n in
          ("cmd_vel", "joints", "landmarks", "slam_pose", "odom_pose",
           "truth", "lm_est")}
    encoders = FakeDiffEncodersNode(PARAMS, ch["cmd_vel"], ch["joints"],
                                    device=device)
    ekf = EkfSlamNode(
        EKFConfig(num_landmarks=LANDMARKS.shape[0], spd_repair=False,
                  motion_noise=(1e-8, 1e-8, 1e-8),
                  measurement_noise=(1e-6, 1e-6)),
        PARAMS, ch["joints"], ch["landmarks"], ch["slam_pose"],
        ch["odom_pose"], landmark_est=ch["lm_est"], known_da=True,
        device=device)
    driver = WaypointDriverNode(ch["slam_pose"], ch["cmd_vel"], WAYPOINTS,
                                p_law, goal_thresh=0.08)
    driver.start()
    lms = torch.tensor(LANDMARKS, dtype=torch.float32)

    def sense(t):
        # Ground truth is the fake-encoder model's own pose (this demo's
        # plant); the sensor is the analysis node's equivalent.
        pose = dd.pose(encoders.state).cpu()
        ch["truth"].publish(pose.numpy())
        ch["landmarks"].publish(landmark_measurements(
            lms, pose.to(torch.float32), 1.5).numpy())

    view = LiveViewNode(out_png, slam_pose=ch["slam_pose"],
                        odom_pose=ch["odom_pose"], truth_pose=ch["truth"],
                        landmark_est=ch["lm_est"], landmarks_true=LANDMARKS,
                        waypoints=WAYPOINTS, bounds=(-1.0, 1.0, -1.0, 1.0),
                        title="EKF SLAM + waypoint driver (live)")
    sched = Scheduler(realtime=realtime)
    sched.add(Node("fake_encoders", 60.0, encoders.tick))
    sched.add(Node("landmark_sensor", 10.0, sense))
    sched.add(Node("ekf_slam", 30.0, ekf.tick))
    sched.add(Node("waypoint_driver", 30.0, driver.tick))
    sched.add(Node("live_view", view_hz, view.tick))
    return sched, view, ch


def build_rbpf(out_png, realtime=True, view_hz=2.0, num_particles=8,
               device=DEFAULT_DEVICE):
    """The RBPF graph: the view shows the best particle's occupancy grid
    growing as the robot drives a box world (the rviz OccupancyGrid
    display, ref: turtle_mapping_node's map publishing). The full LDS-01
    sensor (360 beams at 0.05 m cells): the RBPF needs the real beam
    density."""
    from tpunav_torch.estimation.rbpf import GridConfig, PFConfig
    from tpunav_torch.estimation.rbpf.icp import ICPConfig
    from tpunav_torch.runtime.slam_nodes import RbpfMappingNode
    from tpunav_torch.sim.lidar import box_segments, scan_segments

    device = resolve(device)
    grid_cfg = GridConfig(resolution=0.05, xmin=-1.5, xmax=1.5,
                          ymin=-1.5, ymax=1.5)
    pf_cfg = PFConfig(num_particles=num_particles, k_samples=10,
                      sample_range=(1e-6, 1e-5, 1e-5),
                      motion_noise=(1e-6, 1e-5, 1e-5),
                      grid=grid_cfg, icp=ICPConfig(max_iter=15))
    segs = box_segments(-1.2, -1.2, 1.2, 1.2, device="cpu")
    ch = {n: Channel(n) for n in
          ("cmd_vel", "joints", "scan", "slam_pose", "grid", "truth")}
    encoders = FakeDiffEncodersNode(PARAMS, ch["cmd_vel"], ch["joints"],
                                    rate_hz=20.0, device=device)
    rbpf = RbpfMappingNode(pf_cfg, PARAMS, ch["joints"], ch["scan"],
                           ch["slam_pose"], ch["grid"], device=device)

    def sense(t):
        pose = dd.pose(encoders.state).cpu()
        ch["truth"].publish(pose.numpy())
        ch["scan"].publish(scan_segments(
            pose.to(torch.float32), segs, num_beams=grid_cfg.num_beams,
            max_range=grid_cfg.range_max).numpy())

    def drive(t):
        # A slow arc: enough motion for the map to grow.
        ch["cmd_vel"].publish(np.array([0.25, 0.12, 0.0]))

    view = LiveViewNode(out_png, slam_pose=ch["slam_pose"],
                        truth_pose=ch["truth"], grid=ch["grid"],
                        grid_cfg=grid_cfg, bounds=(-1.5, 1.5, -1.5, 1.5),
                        title="RBPF grid SLAM (live)")
    sched = Scheduler(realtime=realtime)
    sched.add(Node("driver", 20.0, drive))
    sched.add(Node("fake_encoders", 20.0, encoders.tick))
    sched.add(Node("lidar", 5.0, sense))
    sched.add(Node("rbpf", 5.0, rbpf.tick))
    sched.add(Node("live_view", view_hz, view.tick))
    return sched, view, ch


def run(seconds=8.0, rbpf=False, out=None, device=DEFAULT_DEVICE):
    """Drive the graph for ``seconds`` of wall clock; returns (view,
    channels, the PNG's path)."""
    out = out or out_path("live_view_rbpf.png" if rbpf else "live_view.png")
    sched, view, ch = (build_rbpf if rbpf else build)(out, device=device)
    sched.run(seconds)
    return view, ch, out


def main():
    ap = device_parser(__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rbpf", action="store_true",
                    help="the RBPF grid-mapping variant (live occupancy map)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    print(f"driving for {args.seconds:.0f}s on {args.device}")
    view, ch, out = run(args.seconds, args.rbpf, args.out, args.device)
    print(f"rendered {view.frames} live frames to {out}; final slam pose "
          f"{np.round(np.asarray(ch['slam_pose'].latest()), 3)}")


if __name__ == "__main__":
    main()
