"""The RBPF's bearing arithmetic: a polynomial ``atan2`` and its helpers.

Port of ``tpunav/ops/trig.py``. ``tpunav`` wrote this Cephes-style
``atan2`` (from +, *, / and selects) because Pallas on the TPU has no
``atan2``, and used the same function in the XLA path so that both paths
give every map cell the same covering beam. The port keeps it for the same
reason: the map-update kernel (``csrc/map_update.cu``) evaluates the same
polynomial through ``csrc/trig.cuh``, operation for operation and without
fused multiply-adds, so the kernel, its plain version and ``tpunav`` assign
the same beam to every cell. Max error ≲ 2e-7 rad in float32.
"""

from __future__ import annotations

import torch

_PI = 3.14159265358979323846
_PI_2 = _PI / 2.0
_PI_4 = _PI / 4.0
_TAN_PI_8 = 0.41421356237309503  # tan(pi/8); Cephes atanf range split


def atan_poly(t):
    """atan on t >= 0 (Cephes atanf): direct minimax polynomial below
    tan(pi/8), argument transform (t-1)/(t+1) + pi/4 above."""
    big = t > _TAN_PI_8
    tr = torch.where(big, (t - 1.0) / (t + 1.0), t)
    z = tr * tr
    r = (((8.05374449538e-2 * z - 1.38776856032e-1) * z
          + 1.99777106478e-1) * z - 3.33329491539e-1) * z * tr + tr
    return torch.where(big, r + _PI_4, r)


def atan2(y, x):
    """Four-quadrant arctangent with ``torch.atan2``'s conventions (range
    (-pi, pi]; atan2(0, 0) = 0)."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    t = lo / torch.clamp(hi, min=1e-30)
    r = atan_poly(t)
    r = torch.where(ay > ax, _PI_2 - r, r)     # reflect past pi/4
    r = torch.where(x < 0.0, _PI - r, r)       # left half-plane
    return torch.where(y < 0.0, -r, r)         # lower half-plane


def positive_mod(a, period: float):
    """a mod period into [0, period) for possibly negative a, from floor
    and multiply only."""
    q = torch.floor(a * (1.0 / period))
    m = a - q * period
    # Guard the float edge m == period (a tiny negative a can round up).
    return torch.where(m >= period, m - period, torch.clamp(m, min=0.0))


def round_half_up(a):
    """floor(a + 0.5): round half up for non-negative a (the beam
    quantizer's domain)."""
    return torch.floor(a + 0.5)
