"""Fixed-step RK4 integration over batched states.

Port of ``tpunav/ops/rk4.py``. The state carries arbitrary leading batch
axes (all K rollouts at once); the horizon is a Python loop where
``tpunav`` has a ``lax.scan``.
"""

from __future__ import annotations

import torch


def rk4_step(f, x, u, dt):
    """One classical RK4 step with zero-order-hold control."""
    k1 = f(x, u)
    k2 = f(x + dt * 0.5 * k1, u)
    k3 = f(x + dt * 0.5 * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rk4_solve(f, x0, us, dt):
    """Integrate ``steps = us.shape[0]`` RK4 steps, returning the trajectory
    of post-step states (x_1..x_N, excluding x_0).

    x0: (..., S) initial state; us: (N, ..., C) time-major controls.
    Returns (N, ..., S).
    """
    traj = []
    x = x0
    for t in range(us.shape[0]):
        x = rk4_step(f, x, us[t], dt)
        traj.append(x)
    return torch.stack(traj)


def rk4_solve_autonomous(f, x0, steps, dt):
    """Uncontrolled variant: ``steps`` RK4 steps of x' = f(x)."""
    traj = []
    x = x0
    for _ in range(steps):
        x = rk4_step(lambda s, _u: f(s), x, None, dt)
        traj.append(x)
    return torch.stack(traj)
