"""The SLAM sessions' inputs: scans and odometry of the RBPF demo's course
(an arc at a fixed twist per update inside a walled box, odometry equal to
the truth, 360-beam scans with range noise), made on the device for many
sessions at once. Each session turns the course by its own start heading.
"""

from __future__ import annotations

import math

import torch


def box(xmin, ymin, xmax, ymax, device):
    """The four wall segments (4, 4) [ax, ay, bx, by] of a box."""
    return torch.tensor([[xmin, ymin, xmax, ymin], [xmax, ymin, xmax, ymax],
                         [xmax, ymax, xmin, ymax], [xmin, ymax, xmin, ymin]],
                        dtype=torch.float32, device=device)


def raycast(poses, segments, beams: int, beam_min: float, beam_delta: float):
    """Ranges (Q, B) from poses (Q, 3) [θ, x, y] to the nearest segment, inf
    where none is hit; a sensor adds its noise, then caps at its range."""
    ang = poses[:, 0, None] + beam_min + beam_delta * torch.arange(
        beams, dtype=poses.dtype, device=poses.device)
    dx, dy = torch.cos(ang)[..., None], torch.sin(ang)[..., None]  # (Q,B,1)
    a = segments[:, 0:2]
    ab = segments[:, 2:4] - a
    aox = a[None, None, :, 0] - poses[:, 1, None, None]            # (Q,1,S)
    aoy = a[None, None, :, 1] - poses[:, 2, None, None]
    denom = dx * (-ab[:, 1]) - dy * (-ab[:, 0])                     # (Q,B,S)
    safe = torch.where(torch.abs(denom) < 1e-12, 1.0, denom)
    t = (aox * (-ab[:, 1]) - aoy * (-ab[:, 0])) / safe
    s = (dx * aoy - dy * aox) / safe
    hit = (torch.abs(denom) >= 1e-12) & (t > 0.0) & (s >= 0.0) & (s <= 1.0)
    return torch.amin(torch.where(hit, t, math.inf), dim=-1)


def sessions(mix: dict, grid, gen, device):
    """(u (2,), scans (S, U, B), odoms (S, U, 3), prevs (S, U, 3), starts
    (S, 3)): S sessions of U updates, each from a start heading drawn from
    ``gen``, with ``noise_std`` range noise from ``gen``."""
    n, updates = mix["sessions"], mix["updates_per_session"]
    u = torch.tensor(mix["twist"], dtype=torch.float32, device=device)
    th0 = (2.0 * torch.rand(n, generator=gen, device=device) - 1.0) * math.pi
    steps = torch.arange(1, updates + 1, dtype=torch.float32, device=device)
    th = th0[:, None] + u[0] * steps                              # (S, U)
    x = torch.cumsum(u[1] * torch.cos(th), dim=1)
    y = torch.cumsum(u[1] * torch.sin(th), dim=1)
    odoms = torch.stack([th, x, y], dim=-1)
    starts = torch.stack([th0, torch.zeros_like(th0), torch.zeros_like(th0)],
                         dim=-1)
    prevs = torch.cat([starts[:, None], odoms[:, :-1]], dim=1)
    walls = box(*mix["walls"], device=device)
    ranges = raycast(odoms.reshape(-1, 3), walls, grid.num_beams,
                     grid.beam_min, grid.beam_delta)
    noise = torch.randn(ranges.shape, generator=gen, device=device)
    scans = torch.clamp(ranges + mix["noise_std"] * noise, max=grid.range_max)
    return (u, scans.reshape(n, updates, -1).contiguous(), odoms, prevs,
            starts)
