"""The port's host sims against ``tpunav``'s: the diff-drive plant and the
tsim rectangle controllers (numpy copies, held to exact equality), the
pentagon follower (on the port's waypoint law and diff drive), and the
hardware-in-the-loop chain twist → turtle_interface → integer wheel
commands → plant → encoder ticks → joint states → odometry.
"""

import numpy as np
import pytest
import torch

from tpunav.core import diff_drive as jdd
from tpunav.runtime.channels import Channel as JChannel
from tpunav.sim import plant as jplant
from tpunav.sim import tsim as jtsim
from tpunav_torch.core import diff_drive as dd
from tpunav_torch.runtime import Channel, Node, Scheduler
from tpunav_torch.runtime.nodes import OdometerNode, TurtleInterfaceNode
from tpunav_torch.sim.motor import MotorParams
from tpunav_torch.sim.plant import DiffDrivePlant
from tpunav_torch.sim.tsim import (TurtleRectBangBang, TurtleRectConfig,
                                   TurtleRectFeedForward, TurtleWay)

torch.set_num_threads(1)

CPU = dict(device="cpu")
PENTAGON = [(3.0, 2.0), (5.0, 2.5), (5.5, 4.0), (4.0, 5.0), (2.5, 4.0)]


@pytest.mark.parametrize("time_const", [0.0, 0.1])
def test_plant_equals_tpunav(time_const):
    """The same wheel-command stream gives the same truth pose and encoder
    ticks, with and without motor dynamics."""
    from tpunav.sim.motor import MotorParams as JMotorParams

    rng = np.random.default_rng(3)
    ours = DiffDrivePlant(dd.TURTLEBOT3, Channel(), Channel(), 60.0,
                          motor=MotorParams(time_const=time_const))
    theirs = jplant.DiffDrivePlant(jdd.TURTLEBOT3, JChannel(), JChannel(),
                                   60.0,
                                   motor=JMotorParams(time_const=time_const))
    for i in range(300):
        if i % 7 == 0:
            cmd = tuple(int(v) for v in rng.integers(-265, 266, size=2))
            ours.wheel_cmd.publish(cmd)
            theirs.wheel_cmd.publish(cmd)
        ours.tick(i / 60.0)
        theirs.tick(i / 60.0)
        assert ours.sensor.latest() == theirs.sensor.latest()
        assert np.array_equal(ours.pose, theirs.pose)


def _unicycle(pose, cmd, rate):
    w, vx = float(cmd[0]), float(cmd[1])
    return pose + np.asarray([w, vx * np.cos(pose[0]),
                              vx * np.sin(pose[0])]) / rate


def test_turtle_rect_controllers_equal_tpunav():
    """Bang-bang: the same commands, errors and lap count every tick around
    an ideal unicycle; feed-forward: the same timed twist at every tick."""
    cfg = TurtleRectConfig(x=0.0, y=0.0, width=1.0, height=1.0,
                           trans_vel=0.5, rot_vel=1.0, frequency=100.0)
    jcfg = jtsim.TurtleRectConfig(**vars(cfg))
    pose_ch, cmd = Channel(), Channel()
    jpose_ch, jcmd = JChannel(), JChannel()
    ours = TurtleRectBangBang(cfg, pose_ch, cmd)
    theirs = jtsim.TurtleRectBangBang(jcfg, jpose_ch, jcmd)
    pose = np.zeros(3)
    for i in range(4000):
        pose_ch.publish(pose)
        jpose_ch.publish(pose)
        ours.tick(i / 100.0)
        theirs.tick(i / 100.0)
        assert np.array_equal(cmd.latest(), jcmd.latest())
        assert (ours.ctr, ours.laps) == (theirs.ctr, theirs.laps)
        pose = _unicycle(pose, cmd.latest(), 100.0)
        if ours.laps >= 1:
            break
    assert ours.laps == 1
    assert ours.metrics.summary() == theirs.metrics.summary()

    ours = TurtleRectFeedForward(cfg, cmd)
    theirs = jtsim.TurtleRectFeedForward(jcfg, jcmd)
    assert ours.lap_time == theirs.lap_time
    for i in range(int(ours.lap_time * 200) + 10):
        ours.tick(i / 200.0)
        theirs.tick(i / 200.0)
        assert np.array_equal(cmd.latest(), jcmd.latest())


def test_turtle_way_pentagon_matches_tpunav():
    """The pentagon follower: commands within 1e-6 every tick and the same
    completion tick; both see a plant integrating ``tpunav``'s commands
    with the diff-drive model, so model-plant drift stays tiny."""
    pose_ch, cmd_ch = Channel("pose"), Channel("cmd_vel")
    jpose_ch, jcmd_ch = JChannel("pose"), JChannel("cmd_vel")
    ours = TurtleWay(PENTAGON, rot_vel=1.0, trans_vel=1.5, frequency=60.0,
                     pose_in=pose_ch, cmd_vel=cmd_ch, **CPU)
    theirs = jtsim.TurtleWay(PENTAGON, rot_vel=1.0, trans_vel=1.5,
                             frequency=60.0, pose_in=jpose_ch,
                             cmd_vel=jcmd_ch)
    plant = dd.init_state(0.0, PENTAGON[0][0], PENTAGON[0][1], **CPU)
    done_at = None
    for i in range(12000):
        ours.tick(i / 60.0)
        theirs.tick(i / 60.0)
        np.testing.assert_allclose(cmd_ch.latest(), jcmd_ch.latest(),
                                   rtol=0, atol=1e-6)
        plant = dd.feedforward(dd.TURTLEBOT3, plant, torch.as_tensor(
            jcmd_ch.latest(), dtype=torch.float32) / 60.0)
        pose = dd.pose(plant).numpy()
        pose_ch.publish(pose)
        jpose_ch.publish(pose)
        assert ours.done == theirs.done, f"completion differs at tick {i}"
        if theirs.done:
            done_at = i
            break
    assert done_at is not None, "pentagon cycle incomplete"
    assert done_at > 600
    s = ours.metrics.summary()
    assert s["x_error"]["p99"] < 0.05 and s["y_error"]["p99"] < 0.05


def test_turtle_way_graph_equals_eager():
    """The pentagon follower's graph step against its eager form (the
    waypoint law and the feedforward model called one by one): the same
    commands bit for bit every tick and the same completion tick, read
    from the tick's one host copy."""
    from tpunav_torch.core import waypoints as wp

    ours = TurtleWay(PENTAGON, rot_vel=1.0, trans_vel=1.5, frequency=60.0,
                     pose_in=Channel(), cmd_vel=Channel(), **CPU)
    params = wp.make_params(np.asarray(PENTAGON, np.float32), 1.0, 1.5,
                            **CPU)
    ws = wp.init_state(**CPU)
    model = dd.init_state(0.0, PENTAGON[0][0], PENTAGON[0][1], **CPU)
    for i in range(12000):
        ours.tick(i / 60.0)
        cmd, ws = wp.next_waypoint(params, ws, dd.pose(model))
        model = dd.feedforward(dd.TURTLEBOT3, model, cmd * ours.scale)
        np.testing.assert_array_equal(ours.cmd_vel.latest(),
                                      np.asarray(cmd.numpy(), float))
        assert ours.done == bool(ws.cycle_complete), i
        if ours.done:
            break
    assert i > 600 and ours.done
    for name, a, b in zip(model._fields, ours.model, model):
        assert torch.equal(a, b), name


def _hw_chain(motor=None):
    cmd_vel, wheel_cmd, sensor, joints, odom = (Channel() for _ in range(5))
    iface = TurtleInterfaceNode(dd.TURTLEBOT3, cmd_vel, wheel_cmd, sensor,
                                joints, **CPU)
    plant = DiffDrivePlant(dd.TURTLEBOT3, wheel_cmd, sensor, motor=motor)
    odometer = OdometerNode(dd.TURTLEBOT3, joints, odom, **CPU)
    s = Scheduler()
    s.add(Node("iface", 200.0, iface.tick))
    s.add(Node("plant", 200.0, plant.tick))
    s.add(Node("odometer", 200.0, odometer.tick))
    return cmd_vel, odom, plant, s


def test_hw_chain_straight_line_and_rotation():
    # 0.1 m/s for 2 s → ≈ 0.2 m (integer quantization: wheel cmd 126 →
    # 126/265·6.35495·0.033 ≈ 0.0997 m/s).
    cmd_vel, odom, plant, s = _hw_chain()
    cmd_vel.publish([0.0, 0.1, 0.0])
    s.run(2.0)
    pose = np.asarray(odom.latest())
    assert abs(pose[1] - 0.2) < 0.01 and abs(pose[2]) < 1e-3
    assert np.allclose(pose[1:], plant.pose[1:], atol=5e-3)
    # 1 rad/s for 1.5 s → heading ≈ 1.5 rad.
    cmd_vel, odom, plant, s = _hw_chain()
    cmd_vel.publish([1.0, 0.0, 0.0])
    s.run(1.5)
    pose = np.asarray(odom.latest())
    assert abs(pose[0] - 1.5) < 0.05 and np.hypot(pose[1], pose[2]) < 5e-3


def test_plant_motor_dynamics_ramp():
    """With motor dynamics the plant's wheel speed ramps instead of
    stepping, and settles on the commanded (quantized) speed."""
    cmd_vel, odom, plant, s = _hw_chain(MotorParams(time_const=0.1))
    cmd_vel.publish([0.0, 0.1, 0.0])
    s.run(0.05)
    v_early = plant._wl
    s.run(1.0)
    v_late = plant._wl
    assert 0.0 < v_early < 0.8 * v_late
    assert abs(v_late - plant._ul) < 1e-3
