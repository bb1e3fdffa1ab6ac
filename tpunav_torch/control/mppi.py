"""MPPI — model-predictive path-integral control, batched over rollouts.

Port of ``tpunav/control/mppi.py``: the plain solver, which is both the
reference of the fused kernel (``ops/fused_mppi.py``) and the course's
``use_fused=False`` backend.

- perturbations: one (K, N, 2) Gaussian draw from a ``torch.Generator``;
- rollouts: RK4 over the horizon carrying all K states (K, 3) at once;
- cost-to-go: reverse cumulative sum down the (N, K) loss matrix;
- update: per-step softmax over K (min-subtracted, +1e-8 floored), the
  importance-weighted perturbation average, clamp, receding-horizon shift.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..device import DEFAULT_DEVICE, resolve
from ..models.cart import CartParams, kinematic_cart
from ..ops.rk4 import rk4_solve

# State convention: x = (x, y, theta).


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    """Solver configuration (schema: configs/mppi_params.yaml)."""

    lambda_: float = 0.01        # temperature (yaml: lambda)
    max_wheel_vel: float = 6.35495  # clamp (diff_params.yaml max_rot_motor)
    ul_var: float = 0.9          # left-wheel perturbation variance
    ur_var: float = 0.9          # right-wheel perturbation variance
    horizon: float = 1.0         # seconds
    dt: float = 0.01             # integration step
    rollouts: int = 5            # K
    q_diag: Tuple[float, float, float] = (1e4, 1e4, 1.0)
    r_diag: Tuple[float, float] = (0.1, 0.1)
    p1_diag: Tuple[float, float, float] = (1e3, 1e3, 1e3)
    u_init: Tuple[float, float] = (0.0, 0.0)

    @property
    def steps(self) -> int:
        """N = horizon/dt."""
        return int(self.horizon / self.dt)


def init_controls(cfg: MPPIConfig, dtype=torch.float32,
                  device=DEFAULT_DEVICE) -> torch.Tensor:
    """Nominal control sequence u ∈ (N, 2), initialized to u_init."""
    u0 = torch.tensor(cfg.u_init, dtype=dtype, device=resolve(device))
    return u0.expand(cfg.steps, 2).clone()


def rollout_losses(cfg: MPPIConfig, model: CartParams, x0, u_pert, xd,
                   extra_cost=None):
    """Simulate all K rollouts and evaluate the (N, K) loss matrix.

    x0: (3,) state (x, y, theta); u_pert: (K, N, 2); xd: (3,) waypoint.
    Running loss is xᵀQx + uᵀRu with diagonal Q/R; the last row is
    OVERWRITTEN by the terminal loss xᵀP1x (it replaces, not adds).
    Returns (loss (N, K), traj (N, K, 3)).
    """
    k = u_pert.shape[0]
    us = u_pert.transpose(0, 1)  # (N, K, 2) time-major
    f = lambda x, u: kinematic_cart(model, x, u)
    traj = rk4_solve(f, x0.expand(k, 3), us, cfg.dt)  # (N, K, 3)

    q = torch.tensor(cfg.q_diag, dtype=traj.dtype, device=traj.device)
    r = torch.tensor(cfg.r_diag, dtype=traj.dtype, device=traj.device)
    p1 = torch.tensor(cfg.p1_diag, dtype=traj.dtype, device=traj.device)

    err = traj - xd
    running = torch.sum(err * err * q, dim=-1) + torch.sum(us * us * r, dim=-1)
    terminal = torch.sum(err[-1] * err[-1] * p1, dim=-1)
    loss = torch.cat([running[:-1], terminal[None]])
    if extra_cost is not None:
        # State-dependent extra running cost applied at every step,
        # including the terminal row.
        loss = loss + extra_cost(traj[..., :2])
    return loss, traj


def cost_to_go(loss):
    """Reverse cumulative sum down the rows of the (N, K) loss matrix."""
    return torch.flip(torch.cumsum(torch.flip(loss, (0,)), dim=0), (0,))


def sample_perturbations(cfg: MPPIConfig, generator: torch.Generator,
                         dtype=torch.float32, device=DEFAULT_DEVICE):
    """(K, N, 2) Gaussian control perturbations with per-wheel std."""
    device = resolve(device)
    sig = torch.tensor([cfg.ul_var, cfg.ur_var], dtype=dtype,
                       device=device).sqrt()
    return torch.randn((cfg.rollouts, cfg.steps, 2), generator=generator,
                       dtype=dtype, device=device) * sig


def update_controls(cfg: MPPIConfig, u, noise, j):
    """Softmax-weighted control update + clamp.

    u: (N, 2) nominal; noise: (K, N, 2) perturbations; j: (N, K) cost-to-go.
    """
    j = j - torch.amin(j, dim=1, keepdim=True)
    w = torch.exp(-j / cfg.lambda_) + 1e-8
    w = w / torch.sum(w, dim=1, keepdim=True)          # (N, K)
    u_new = u + torch.einsum("nk,knc->nc", w, noise)
    return torch.clamp(u_new, -cfg.max_wheel_vel, cfg.max_wheel_vel)


def shift_controls(cfg: MPPIConfig, u):
    """Receding-horizon shift: drop the executed first column, refill the
    tail with u_init."""
    u_init = torch.tensor(cfg.u_init, dtype=u.dtype, device=u.device)
    return torch.cat([u[1:], u_init[None]], dim=0)


def mppi_solve(cfg: MPPIConfig, model: CartParams, u, generator, pose_xyt,
               xd, extra_cost=None, noise: Optional[torch.Tensor] = None):
    """One full MPPI solve.

    u: (N, 2) nominal controls; generator: the ``torch.Generator`` the
    perturbations are drawn from; pose_xyt: (3,) current state
    (x, y, theta); xd: (3,) waypoint; extra_cost: optional (..., 2)
    positions → cost. ``noise`` ((K, N, 2) perturbations) replaces the
    draw, for parity tests. Returns (wheel_cmd (2,), u_next (N, 2)).
    """
    if noise is None:
        noise = sample_perturbations(cfg, generator, dtype=u.dtype,
                                     device=u.device)
    loss, _ = rollout_losses(cfg, model, pose_xyt, u[None] + noise, xd,
                             extra_cost)
    u_new = update_controls(cfg, u, noise, cost_to_go(loss))
    return u_new[0], shift_controls(cfg, u_new)


class MPPIController:
    """Host-side wrapper holding (u, generator) state around the solve."""

    def __init__(self, cfg: MPPIConfig, model: CartParams, seed: int = 0,
                 dtype=torch.float32, device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.model = model
        self.u = init_controls(cfg, dtype=dtype, device=device)
        self.generator = torch.Generator(device=self.u.device)
        self.generator.manual_seed(seed)
        self.xd = torch.zeros(3, dtype=dtype, device=self.u.device)

    def set_waypoint(self, xd):
        self.xd = torch.as_tensor(xd, dtype=self.u.dtype, device=self.u.device)

    def set_initial_controls(self, ul: float, ur: float):
        self.u = torch.tensor([ul, ur], dtype=self.u.dtype,
                              device=self.u.device).expand_as(self.u).clone()

    def new_controls(self, pose_xyt):
        """Solve and advance internal state; returns wheel velocities (2,)."""
        pose = torch.as_tensor(pose_xyt, dtype=self.u.dtype,
                               device=self.u.device)
        cmd, self.u = mppi_solve(self.cfg, self.model, self.u,
                                 self.generator, pose, self.xd)
        return cmd
