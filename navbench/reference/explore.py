"""The plain scan interval of config 5's exploration: six control ticks (the
waypoint advance on the odometry pose, one MPPI solve, the motors' first-
order lag with its acceleration cap, the plant and the biased odometry),
the lidar's scan of the walls, and the twist the filter is handed.

Poses are [θ, x, y], as the filter keeps them; the solve takes [x, y, θ].
The world (walls, waypoints, wheel bias, motor, rates) comes from the
traffic file, never from the program.
"""

from __future__ import annotations

import math

import torch

from . import mppi
from .rbpf import wrap


def _xyt(p):
    return torch.stack([p[..., 1], p[..., 2], p[..., 0]], dim=-1)


def _txy(p):
    return torch.stack([p[..., 2], p[..., 0], p[..., 1]], dim=-1)


def track(world: dict, vel, cmd):
    """The motors' speeds after one tick of tracking ``cmd``."""
    dt, tau = world["tick_dt"], world["motor_time_const"]
    alpha = 1.0 - math.exp(-dt / tau)
    lim = world["motor_max_torque"] / world["motor_inertia"] * dt
    return vel + torch.clamp(alpha * (cmd - vel), -lim, lim)


def control(c: dict, world: dict, k: int, true_pose, odom_pose, u, wheel,
            idx, tick, dtype=torch.float64):
    """The interval's ticks from S states at once (poses (S, 3), u (S, N,
    2), wheel (S, 2), idx and tick (S,) integers): (true_pose, odom_pose,
    u, wheel, idx, ties), where ``ties`` (S,) counts the near-tie rows met
    on the way that can reach the poses: every row of every tick but the
    last, whose rows after the first move only the controls it leaves.
    After one, rounding may take the program down another path."""
    dev = u.device
    w = torch.tensor(world["waypoints"], dtype=torch.float64, device=dev)
    nw = w.shape[0]
    bias = torch.tensor(world["wheel_bias"], dtype=dtype, device=dev)
    true_pose, odom_pose, u, wheel = (t.to(dtype) for t in (
        true_pose, odom_pose, u, wheel))
    idx = idx.to(device=dev, dtype=torch.long)
    tick = tick.to(device=dev, dtype=torch.long)
    ticks = world["ticks_per_scan"]
    ties = torch.zeros(u.shape[0], dtype=torch.long, device=dev)
    for t in range(ticks):
        od = odom_pose.to(torch.float64)
        d = torch.hypot(od[:, 1] - w[idx, 0], od[:, 2] - w[idx, 1])
        idx = torch.where(d < world["goal_thresh"], (idx + 1) % nw, idx)
        # A distance at the threshold may round to either side.
        ties += ((d - world["goal_thresh"]).abs() < 1e-6).long()
        seed = tick * ticks + t
        xd = w[idx].to(dtype)
        pose = _xyt(odom_pose)
        if dtype == torch.float64:
            u_new, tie, _ = mppi.solve_with_slack(c, u, seed, pose, xd, k)
            ties += (tie if t < ticks - 1 else tie[:, :1]).sum(dim=1)
        else:
            u_new = mppi.solve(c, u, seed, pose, xd, k, dtype)
        cmd = u_new[:, 0]
        u = mppi.shift(u_new, c["u_init"])
        wheel = track(world, wheel, cmd)
        dt = world["tick_dt"]
        true_pose = _txy(mppi.plant(c, _xyt(true_pose), wheel, dt))
        odom_pose = _txy(mppi.plant(c, _xyt(odom_pose), wheel * bias, dt))
    return true_pose, odom_pose, u, wheel, idx, ties


def twist(cur, prev):
    """[ω, v_x]: the heading change and the displacement along the previous
    heading."""
    dth = wrap(cur[0] - prev[0])
    c, s = torch.cos(prev[0]), torch.sin(prev[0])
    return torch.stack([dth, c * (cur[1] - prev[1]) + s * (cur[2] - prev[2])])
