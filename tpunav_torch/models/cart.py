"""Differential-drive cart dynamics model (batched ODE).

Port of ``tpunav/models/cart.py``. The ODE is written over arbitrary
leading batch axes so one call evaluates all K rollouts' derivatives.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CartParams(NamedTuple):
    wheel_radius: float
    wheel_base: float


def kinematic_cart(params: CartParams, x: torch.Tensor,
                   u: torch.Tensor) -> torch.Tensor:
    """Diff-drive kinematic ODE.

    x: (..., 3) state [x, y, theta]; u: (..., 2) wheel velocities [uL, uR].
    Returns dx/dt of shape (..., 3):
        dx = (r/2)(uL+uR)cos(theta), dy = (r/2)(uL+uR)sin(theta),
        dtheta = (r/base)(uR-uL).
    """
    theta = x[..., 2]
    ul, ur = u.unbind(-1)
    fwd = (params.wheel_radius / 2.0) * (ul + ur)
    dtheta = (params.wheel_radius / params.wheel_base) * (ur - ul)
    return torch.stack(
        [fwd * torch.cos(theta), fwd * torch.sin(theta), dtheta], dim=-1)
