"""First-order wheel-motor dynamics with a torque/acceleration cap.

Port of ``tpunav/sim/motor.py``: the tracking law

    v' = v + (1 - exp(-dt/τ)) · (v_cmd - v),  |v' - v| ≤ a_max·dt

between the controller's command and the plant. τ = 0 disables the lag;
a_max = τ_max / I_eff caps the ramp like a motor's torque clamp.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class MotorParams:
    """τ = 0 → ideal (instant) tracking. Defaults model a TurtleBot3 Burger
    wheel: max motor torque 1.5 N·m against an effective per-wheel inertia
    of ~2.4e-3 kg·m², i.e. a_max ≈ 625 rad/s²."""

    time_const: float = 0.0          # s; 0 disables dynamics
    max_torque: float = 1.5          # N·m (diff_params.yaml)
    eff_inertia: float = 2.4e-3      # kg·m² per wheel

    @property
    def max_accel(self) -> float:
        return self.max_torque / self.eff_inertia


def track(params: MotorParams, vel: torch.Tensor, cmd: torch.Tensor,
          dt: float) -> torch.Tensor:
    """One dt of velocity tracking; vel/cmd are (2,) wheel velocities
    (elementwise for any matching shape). With time_const == 0 this is
    exactly ``cmd``."""
    if params.time_const <= 0.0:
        return cmd
    alpha = 1.0 - math.exp(-dt / params.time_const)
    dv = alpha * (cmd - vel)
    lim = params.max_accel * dt
    return vel + torch.clamp(dv, -lim, lim)
