"""Simulated 2D lidar: batched analytic raycasting.

Port of ``tpunav/sim/lidar.py`` (the replacement for the Gazebo laser
plugin; LDS-01 constants in bmapping/config/LDS_01_lidar.yaml): every beam
is a closed-form ray intersection, evaluated at once. Range noise is drawn
from a ``torch.Generator`` or injected as standard normals (``noise=``),
so a test can hand both packages the same draw.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..device import DEFAULT_DEVICE, resolve


def _rays(pose, num_beams, beam_min, beam_delta, dtype):
    theta, x, y = pose[0], pose[1], pose[2]
    angles = theta + beam_min + beam_delta * torch.arange(
        num_beams, dtype=dtype, device=pose.device)
    d = torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)  # (B, 2)
    return d, torch.stack([x, y])


def _finish(ranges, max_range, generator, noise, noise_std):
    if noise_std > 0.0 and (noise is not None or generator is not None):
        if noise is None:
            noise = torch.randn(ranges.shape, generator=generator,
                                dtype=ranges.dtype, device=ranges.device)
        ranges = ranges + noise_std * noise
    return torch.clamp(ranges, max=max_range)


def scan_cylinders(pose, centers, radii, num_beams: int = 360,
                   beam_min: float = 0.0,
                   beam_delta: float = math.pi / 180.0,
                   max_range: float = 3.5,
                   generator: Optional[torch.Generator] = None,
                   noise_std: float = 0.0,
                   noise: Optional[torch.Tensor] = None):
    """Ranges (num_beams,) from ray-circle intersections.

    pose: (3,) [theta, x, y]; centers: (M, 2); radii: (M,). Beams with no
    hit return ``max_range``. ``noise``: (num_beams,) standard normals that
    replace the draw from ``generator``; either is scaled by
    ``noise_std``."""
    d, o = _rays(pose, num_beams, beam_min, beam_delta, centers.dtype)
    oc = centers - o                                   # (M, 2)
    tc = d @ oc.T                                      # (B, M) along-ray
    # Squared perpendicular distance from each center to each ray.
    d2 = torch.sum(oc * oc, dim=-1)[None, :] - tc * tc
    disc = radii[None, :] ** 2 - d2
    hit = torch.logical_and(disc >= 0.0, tc > 0.0)
    t = tc - torch.sqrt(torch.clamp(disc, min=0.0))
    t = torch.where(torch.logical_and(hit, t > 0.0), t, math.inf)
    return _finish(torch.amin(t, dim=-1), max_range, generator, noise,
                   noise_std)


def scan_segments(pose, segments, num_beams: int = 360,
                  beam_min: float = 0.0,
                  beam_delta: float = math.pi / 180.0,
                  max_range: float = 3.5,
                  generator: Optional[torch.Generator] = None,
                  noise_std: float = 0.0,
                  noise: Optional[torch.Tensor] = None):
    """Ranges (num_beams,) from ray-segment intersections: walls and
    polygonal obstacles. pose: (3,) [theta, x, y]; segments: (S, 4) rows
    [ax, ay, bx, by]. ``generator``/``noise``/``noise_std`` as in
    :func:`scan_cylinders`."""
    d, o = _rays(pose, num_beams, beam_min, beam_delta, segments.dtype)
    a = segments[:, 0:2]                                # (S, 2)
    ab = segments[:, 2:4] - a                           # (S, 2)
    ao = a - o                                          # (S, 2)
    # Solve o + t·d = a + s·ab per (beam, segment) with 2D cross products.
    denom = d[:, None, 0] * (-ab[None, :, 1]) - \
        d[:, None, 1] * (-ab[None, :, 0])               # (B, S)
    safe = torch.where(torch.abs(denom) < 1e-12, 1.0, denom)
    t = (ao[None, :, 0] * (-ab[None, :, 1]) -
         ao[None, :, 1] * (-ab[None, :, 0])) / safe
    s = (d[:, None, 0] * ao[None, :, 1] -
         d[:, None, 1] * ao[None, :, 0]) / safe
    hit = (torch.abs(denom) >= 1e-12) & (t > 0.0) & (s >= 0.0) & (s <= 1.0)
    t = torch.where(hit, t, math.inf)
    return _finish(torch.amin(t, dim=-1), max_range, generator, noise,
                   noise_std)


def box_segments(xmin, ymin, xmax, ymax, dtype=torch.float32,
                 device=DEFAULT_DEVICE):
    """Four wall segments (4, 4) of an axis-aligned box."""
    return torch.tensor([
        [xmin, ymin, xmax, ymin],
        [xmax, ymin, xmax, ymax],
        [xmax, ymax, xmin, ymax],
        [xmin, ymax, xmin, ymin],
    ], dtype=dtype, device=resolve(device))
