"""The node graph across two OS processes over the TCP bus.

Counterpart of ``examples/full_stack_two_process.py``. The reference's
two-machine deployment (ref: nuturtle_robot/launch/basic_remote.launch:
1-40) runs {serial_node + turtle_interface} on the turtlebot and
{odometry, SLAM, control, rviz} on the laptop, wired by ROS topics over
TCPROS. Here the same node classes as the single-process graph run in two
processes, with the cross-process topics carried by the port's bus
(``tpunav_torch.runtime.net``):

  robot process (the turtlebot, on the CPU): ``DiffDrivePlant`` (the
      truth) + ``TurtleInterfaceNode`` + ``OdometerNode`` + the landmark
      sensor (the analysis node's equivalent)
  laptop process (on ``--device``): the PRM/Theta* planner (the waypoint
      course, planned once at start-up like the reference's prm_planner
      node) + ``EkfSlamNode`` + the MPPI waypoint driver (kernel K1 on the
      card)

Topics over the bus: cmd_vel ←, joints →, landmarks →, odom → (arrows =
robot → laptop). wheel_cmd and the sensor ticks stay in the robot's
process, as the reference's serial link does.

Execution is lockstep (``wait_for_new`` on the broker's sequence numbers):
each cycle the laptop waits for the robot's sensor frame and the robot for
the laptop's command, which pins the cross-process tick order to the
single-process one, so :func:`run_single` (the same classes, in-process
channels, the same order) must give the same trajectory. :func:`run_free`
runs both sides free on the wall clock instead.

    python -m examples_torch.full_stack_two_process [--device cpu]

The spawned children import this module, so what runs at the command
line stays under ``if __name__ == "__main__"``.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

CYCLES = 150
ROLLOUTS = 4096

# The planner's world: two boxes between the start and the goal region;
# the Theta* path through the gap becomes the waypoint course.
OBSTACLES = [[[0.45, -0.3], [0.75, -0.3], [0.75, 0.25], [0.45, 0.25]],
             [[0.2, 0.5], [0.5, 0.5], [0.5, 0.8], [0.2, 0.8]]]
BOUNDS = [[-0.4, 1.6], [-0.8, 1.3]]
START, GOAL = (0.0, 0.0), (1.2, 0.8)
LANDMARKS = [[0.6, 0.1], [0.4, 0.5], [-0.1, 0.6], [0.9, -0.3],
             [1.1, 0.4], [0.2, -0.4], [1.2, 1.0], [-0.1, -0.4]]
VISIBILITY = 1.5


def robot_params():
    """The TurtleBot3's wheel radius and base."""
    from tpunav_torch.core import diff_drive as dd

    return dd.DiffDriveParams(wheel_radius=0.033, wheel_base=0.16)


def plan_waypoints():
    """The laptop's planner leg, run once at start-up
    (examples/full_stack_two_process.py:59-80): PRM + Theta* over the
    example's world from seed 4; waypoints headed toward the next vertex."""
    from tpunav_torch.planning.prm import RoadMap, theta_star
    from tpunav_torch.planning.world import load_obstacle_map

    rm = RoadMap(load_obstacle_map(OBSTACLES, bounds=BOUNDS),
                 n_nodes=80, k_neighbors=8, clearance=0.08, seed=4)
    s, g = rm.add_node(np.asarray(START)), rm.add_node(np.asarray(GOAL))
    if s is None or g is None:
        raise AssertionError("start or goal not in free space")
    path = theta_star(rm, s, g)
    if path is None or len(path) < 2:
        raise AssertionError("the planner found no path")
    wpts = []
    for i in range(1, len(path)):
        d = np.asarray(path[i]) - np.asarray(path[i - 1])
        wpts.append([path[i][0], path[i][1], float(np.arctan2(d[1], d[0]))])
    return np.asarray(wpts)


def mppi_law(cfg, params, device):
    """The examples' MPPI control law for ``WaypointDriverNode``
    (examples/full_stack_two_process.py:83-111) on K1: (pose [x, y, θ],
    waypoint) → one fused solve on ``device`` keyed by seed 11 + k on the
    k-th call → the wheel command as a body twist, in numpy. A call is one
    ``capture.Graph`` step (``tpunav``'s jitted law): the solve, the seed's
    increment and the twist on static tensors, the pose and waypoint in
    by one copy and the twist out by one."""
    from tpunav_torch import capture
    from tpunav_torch.control.mppi import init_controls
    from tpunav_torch.core import diff_drive as dd
    from tpunav_torch.models.cart import CartParams
    from tpunav_torch.ops.fused_mppi import mppi_solve_fused
    from tpunav_torch.runtime.nodes import host, to_device, to_static

    cart = CartParams(params.wheel_radius, params.wheel_base)
    u = init_controls(cfg, device=device)
    seed = to_device(11, torch.int32, device)
    x = torch.zeros(6, device=u.device)          # [pose, waypoint]
    twist = torch.zeros(3, device=u.device)

    def body():
        cmd, u_next = mppi_solve_fused(cfg, cart, u, seed, x[:3], x[3:])
        u.copy_(u_next)
        seed.add_(1)
        twist.copy_(dd.wheels_to_twist(params, cmd))

    graph = capture.Graph(body, u.device)

    def law(pose_xyt, wpt):
        goal = [wpt[0], wpt[1], wpt[2] if len(wpt) > 2 else 0.0]
        to_static(x, np.concatenate([pose_xyt, goal]))
        graph()
        return host(twist)

    return law


def mppi_config(rollouts):
    """examples/full_stack_two_process.py:92-93 at ``rollouts``."""
    from tpunav_torch.control.mppi import MPPIConfig

    return MPPIConfig(horizon=0.3, dt=0.05, rollouts=rollouts, ul_var=4.0,
                      ur_var=4.0)


def build_robot(params, ch):
    """The robot's side: the plant (truth) + turtle_interface + odometer +
    the landmark sensor, on the CPU (the turtlebot has no card). One
    lockstep cycle returns the true pose."""
    from tpunav_torch.runtime.channels import Channel
    from tpunav_torch.runtime.nodes import OdometerNode, TurtleInterfaceNode
    from tpunav_torch.sim.landmark_sensor import landmark_measurements
    from tpunav_torch.sim.plant import DiffDrivePlant

    wheel_cmd, sensor = Channel("wheel_cmd"), Channel("sensor")
    plant = DiffDrivePlant(params, wheel_cmd, sensor, sensor_rate_hz=60.0)
    iface = TurtleInterfaceNode(params, ch["cmd_vel"], wheel_cmd, sensor,
                                ch["joints"], device="cpu")
    odo = OdometerNode(params, ch["joints"], ch["odom"], device="cpu")
    lms = torch.tensor(LANDMARKS)

    def sense(t=0.0):
        ch["landmarks"].publish(landmark_measurements(
            lms, torch.tensor(plant.pose, dtype=torch.float32),
            VISIBILITY).numpy())

    def cycle(k):
        iface.tick(0.0)      # fresh cmd_vel → wheel_cmd
        plant.tick(0.0)      # advance the truth, emit encoder ticks
        iface.tick(0.0)      # fresh ticks → joints
        odo.tick(0.0)        # joints → odom
        sense()
        return plant.pose.copy()

    return cycle, (iface, plant, odo, sense)


def build_laptop(params, ch, waypoints, rollouts, device):
    """The laptop's side: EKF SLAM (known DA) + the MPPI driver on the
    SLAM pose, on ``device``. One lockstep cycle returns the SLAM pose."""
    from tpunav_torch.estimation.ekf import EKFConfig
    from tpunav_torch.runtime.channels import Channel
    from tpunav_torch.runtime.nodes import WaypointDriverNode
    from tpunav_torch.runtime.slam_nodes import EkfSlamNode

    slam_pose = Channel("slam_pose")
    ekf = EkfSlamNode(EKFConfig(num_landmarks=len(LANDMARKS),
                                spd_repair=False,
                                motion_noise=(1e-8, 1e-8, 1e-8),
                                measurement_noise=(1e-6, 1e-6)),
                      params, ch["joints"], ch["landmarks"], slam_pose,
                      Channel("odom_local"), known_da=True, device=device)
    driver = WaypointDriverNode(
        slam_pose, ch["cmd_vel"], waypoints,
        mppi_law(mppi_config(rollouts), params, device), goal_thresh=0.12)
    driver.start()

    def cycle(k):
        ekf.tick(0.0)
        prev = ch["cmd_vel"].seq
        driver.tick(0.0)
        if ch["cmd_vel"].seq == prev:
            # Keep the lockstep clock advancing after the course is done.
            ch["cmd_vel"].publish(np.zeros(3))
        p = slam_pose.latest()
        return np.zeros(3) if p is None else np.asarray(p, float).copy()

    return cycle


def run_single(cycles, rollouts, device):
    """The two-process graph in one process with the same device split and
    the same tick order. Returns (truth, slam) per cycle."""
    from tpunav_torch.runtime.channels import Channel

    params = robot_params()
    ch = {n: Channel(n) for n in ("cmd_vel", "joints", "landmarks", "odom")}
    robot, _ = build_robot(params, ch)
    laptop = build_laptop(params, ch, plan_waypoints(), rollouts, device)
    truth, slam = [], []
    for k in range(cycles):
        truth.append(robot(k))
        slam.append(laptop(k))
    return np.asarray(truth), np.asarray(slam)


def _bus_channels(client, robot: bool):
    out = {"cmd_vel": client.subscribe if robot else client.advertise}
    for name in ("joints", "landmarks", "odom"):
        out[name] = client.advertise if robot else client.subscribe
    return {name: make(name) for name, make in out.items()}


def _robot_main(port, cycles, out_path):
    from tpunav_torch.runtime.net import BusClient, wait_for_new

    torch.set_num_threads(1)
    client = BusClient("127.0.0.1", port)
    ch = _bus_channels(client, robot=True)
    robot, _ = build_robot(robot_params(), ch)
    truth, last_cmd = [], 0
    for k in range(cycles):
        if k > 0:   # lockstep: the laptop commanded on the previous frame
            _, last_cmd = wait_for_new(ch["cmd_vel"], last_cmd, timeout=120)
        truth.append(robot(k))
    np.savez(out_path, truth=np.asarray(truth))
    client.close()


def _laptop_main(port, cycles, out_path, rollouts, device):
    from tpunav_torch.runtime.net import BusClient, wait_for_new

    torch.set_num_threads(1)
    client = BusClient("127.0.0.1", port)
    ch = _bus_channels(client, robot=False)
    laptop = build_laptop(robot_params(), ch, plan_waypoints(), rollouts,
                          device)
    slam, last_j, last_m = [], 0, 0
    for k in range(cycles):
        _, last_j = wait_for_new(ch["joints"], last_j, timeout=120)
        _, last_m = wait_for_new(ch["landmarks"], last_m, timeout=120)
        slam.append(laptop(k))
        if k == 0:
            t_warm = time.perf_counter()
    steady = (cycles - 1) / (time.perf_counter() - t_warm)
    np.savez(out_path, slam=np.asarray(slam), steady=steady)
    client.close()


def run_two_process(out_dir, cycles, rollouts, device):
    """Robot and laptop in two OS processes over the TCP bus, in lockstep
    (each waits on the other's topic). Returns (truth, slam, the laptop's
    steady cycles/s over the bus)."""
    from examples_torch import spawn
    from tpunav_torch.runtime.net import BusServer

    robot_out = os.path.join(out_dir, "robot.npz")
    laptop_out = os.path.join(out_dir, "laptop.npz")
    srv = BusServer()
    try:
        spawn([(_robot_main, (srv.port, cycles, robot_out)),
               (_laptop_main, (srv.port, cycles, laptop_out, rollouts,
                                  device))], timeout=600)
    finally:
        srv.close()
    lap = np.load(laptop_out)
    return np.load(robot_out)["truth"], lap["slam"], float(lap["steady"])


def _robot_free(port, duration, out_path):
    """The robot free-running: every node at its own rate on the wall-clock
    scheduler, no lockstep."""
    from tpunav_torch.runtime.channels import Node, Scheduler
    from tpunav_torch.runtime.net import BusClient, wait_for_new

    torch.set_num_threads(1)
    client = BusClient("127.0.0.1", port)
    ch = _bus_channels(client, robot=True)
    _, (iface, plant, odo, sense) = build_robot(robot_params(), ch)
    # Bring-up handshake: one sensor frame, then wait for the laptop's
    # first command before the clock starts.
    ch["joints"].publish((0.0, 0.0, 0.0, 0.0))
    sense()
    wait_for_new(ch["cmd_vel"], 0, timeout=120)
    sched = Scheduler(realtime=True)
    sched.add(Node("turtle_interface", 60.0, iface.tick))
    sched.add(Node("plant", 60.0, plant.tick))
    sched.add(Node("odometer", 60.0, odo.tick))
    sched.add(Node("landmark_sensor", 10.0, sense))
    seq0 = ch["joints"].seq, ch["cmd_vel"].seq
    sched.run(duration)
    np.savez(out_path, truth=plant.pose,
             joints=ch["joints"].seq - seq0[0],
             cmd=ch["cmd_vel"].seq - seq0[1])
    client.close()


def _laptop_free(port, duration, out_path, rollouts, device):
    """The laptop free-running: EKF + driver as one 60 Hz node."""
    from tpunav_torch.runtime.channels import Node, Scheduler
    from tpunav_torch.runtime.net import BusClient, wait_for_new

    torch.set_num_threads(1)
    client = BusClient("127.0.0.1", port)
    ch = _bus_channels(client, robot=False)
    laptop = build_laptop(robot_params(), ch, plan_waypoints(), rollouts,
                          device)
    wait_for_new(ch["joints"], 0, timeout=120)
    wait_for_new(ch["landmarks"], 0, timeout=120)
    laptop(0)                    # the first tick pays the kernels' loading
    ticks = [0]

    def tick(t):
        laptop(ticks[0])
        ticks[0] += 1

    sched = Scheduler(realtime=True)
    sched.add(Node("slam+driver", 60.0, tick))
    sched.run(duration)
    np.savez(out_path, ticks=ticks[0])
    client.close()


def run_free(out_dir, duration, rollouts, device):
    """Both sides free-running for ``duration`` wall seconds; the joints and
    cmd_vel rates the robot saw and the laptop's ticks."""
    from examples_torch import spawn
    from tpunav_torch.runtime.net import BusServer

    robot_out = os.path.join(out_dir, "robot_free.npz")
    laptop_out = os.path.join(out_dir, "laptop_free.npz")
    srv = BusServer()
    try:
        spawn([(_robot_free, (srv.port, duration, robot_out)),
               (_laptop_free, (srv.port, duration, laptop_out, rollouts,
                                  device))], timeout=600)
    finally:
        srv.close()
    rob, lap = np.load(robot_out), np.load(laptop_out)
    return {"joints_rate_hz": float(rob["joints"]) / duration,
            "cmd_vel_rate_hz": float(rob["cmd"]) / duration,
            "laptop_ticks": int(lap["ticks"]),
            "final_truth": rob["truth"].tolist()}


def main():
    from examples_torch import device_parser

    ap = device_parser(__doc__.splitlines()[0])
    ap.add_argument("--cycles", type=int, default=CYCLES)
    ap.add_argument("--rollouts", type=int, default=ROLLOUTS)
    ap.add_argument("--free-run", type=float, default=0.0,
                    help="also run both sides free on the wall clock for "
                         "this many seconds")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        truth2, slam2, steady = run_two_process(out_dir, args.cycles,
                                                args.rollouts, args.device)
        wall = time.perf_counter() - t0
        truth1, slam1 = run_single(args.cycles, args.rollouts, args.device)
        d_truth = float(np.max(np.abs(truth2 - truth1)))
        d_slam = float(np.max(np.abs(slam2 - slam1)))
        print(f"2-process vs single-process: max |truth diff| = "
              f"{d_truth:.2e}, max |slam diff| = {d_slam:.2e}; "
              f"{args.cycles} cycles, {wall:.1f}s wall with the spawns, "
              f"steady {steady:.0f} cycles/s over the bus (lockstep: each "
              f"cycle is 2 cross-process round trips)")
        assert d_truth < 1e-9 and d_slam < 1e-9, "trajectory mismatch"
        print("PASS: identical trajectories across the process boundary")
        if args.free_run > 0:
            fr = run_free(out_dir, args.free_run, args.rollouts, args.device)
            print(f"free-run {args.free_run:.0f}s: joints "
                  f"{fr['joints_rate_hz']:.0f}/s (nominal 60), cmd_vel "
                  f"{fr['cmd_vel_rate_hz']:.0f}/s, laptop ticks "
                  f"{fr['laptop_ticks']}, truth pose "
                  f"{np.round(fr['final_truth'], 3)}")


if __name__ == "__main__":
    main()
