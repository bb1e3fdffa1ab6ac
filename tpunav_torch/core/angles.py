"""Angle utilities on tensors (elementwise, branch-free).

Port of ``tpunav/core/angles.py`` (the reference's constexpr helpers,
rigid2d/include/rigid2d/rigid2d.hpp:24-138). Every function works
elementwise on a tensor of any shape and keeps its dtype; Python numbers
are turned into tensors first.
"""

from __future__ import annotations

import math

import torch

PI = math.pi
TWO_PI = 2.0 * math.pi


def deg2rad(deg):
    """Degrees → radians (ref: rigid2d.hpp:36-39)."""
    return deg * (math.pi / 180.0)


def rad2deg(rad):
    """Radians → degrees (ref: rigid2d.hpp:44-47)."""
    return rad * (180.0 / math.pi)


def normalize_angle_pi(rad):
    """Wrap angle(s) to [-pi, pi) (both +pi and -pi map to -pi).

    The reference formula exactly (ref: rigid2d.hpp:53-64):
    q = floor((rad+pi)/2pi); r = (rad+pi) - q*2pi; r += 2pi if r < 0; r - pi.
    """
    rad = torch.as_tensor(rad)
    shifted = rad + PI
    r = shifted - torch.floor(shifted / TWO_PI) * TWO_PI
    r = torch.where(r < 0, r + TWO_PI, r)
    return r - PI


def normalize_angle_2pi(rad):
    """Wrap angle(s) to [0, 2pi) (ref: rigid2d.hpp:69-104)."""
    rad = torch.as_tensor(rad)
    r = rad - torch.floor(rad / TWO_PI) * TWO_PI
    return torch.where(r < 0, r + TWO_PI, r)


def almost_equal(d1, d2, epsilon: float = 1.0e-12):
    """abs-eps comparison (ref: rigid2d.hpp:24-27). Returns a bool tensor."""
    return torch.abs(torch.as_tensor(d1) - torch.as_tensor(d2)) < epsilon
