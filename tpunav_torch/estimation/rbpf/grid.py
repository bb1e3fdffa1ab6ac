"""Per-particle log-odds occupancy grids and the likelihood-field model.

Port of ``tpunav/estimation/rbpf/grid.py`` (the reference's
``bmapping::GridMapper``, bmapping/src/bmapping/grid_mapper.cpp), written
batched: every function takes any leading batch dimensions (P particles,
or P×k pose samples) where ``tpunav`` vmaps. ``.at[].max`` becomes
``scatter_reduce_(..., "amax")`` and ``.at[].add`` becomes ``index_add_``.

These are the portable formulations, ``tpunav``'s XLA path. On the card the
particle filter runs the map update and the likelihood sweep as the CUDA
kernels of ``ops/map_update.py`` and ``ops/likelihood.py``; the plain
versions of those kernels repeat the kernels' own arithmetic, which rounds
a little differently from the functions here.

A grid is a plain (H, W) log-odds tensor (or (..., H, W) for a batch).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ...device import DEFAULT_DEVICE, resolve
from ...ops import beams
from ...ops.beams import beam_table, beams_per_revolution, cell_beams
from ...ops.distance_transform import euclidean_distance_field


def _log_odds(p):
    return math.log(p / (1.0 - p))


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Map + beam-model parameters (ref: GridMapper ctor
    grid_mapper.cpp:37-63 and bmapping/launch/slam.launch:19-46)."""

    resolution: float = 0.05
    xmin: float = -2.0
    xmax: float = 2.0
    ymin: float = -2.0
    ymax: float = 2.0
    prior: float = 0.5
    prob_occ: float = 0.90
    prob_free: float = 0.35
    max_occ_dist: float = 10.0
    # Beam-model mixture (slam.launch:40-44). The reference asserts
    # z_hit+z_short+z_max+z_rand ≈ 1 (sensor_model.hpp:20-79) though its
    # likelihood field only evaluates z_hit·N(d;σ²) + z_rand/z_max.
    z_hit: float = 0.95
    z_short: float = 0.0
    z_max: float = 0.04
    z_rand: float = 0.01
    sigma_hit: float = 0.5
    # Lidar geometry (bmapping/config/LDS_01_lidar.yaml).
    num_beams: int = 360
    beam_min: float = 0.0
    beam_delta: float = math.pi / 180.0
    range_min: float = 0.12
    range_max: float = 3.5

    def __post_init__(self):
        if self.range_min < 0.0:
            raise ValueError(f"range_min={self.range_min} must be >= 0: the "
                             "map update marks an invalid beam by a "
                             "negative range")
        total = self.z_hit + self.z_short + self.z_max + self.z_rand
        if abs(total - 1.0) > 1e-6:
            raise ValueError(
                f"beam-model mixture must sum to 1 (ref: LaserProperties "
                f"ctor assert, sensor_model.hpp:20-79): z_hit={self.z_hit} "
                f"+ z_short={self.z_short} + z_max={self.z_max} + "
                f"z_rand={self.z_rand} = {total}")

    @property
    def width(self) -> int:
        return int(math.ceil((self.xmax - self.xmin) / self.resolution))

    @property
    def height(self) -> int:
        return int(math.ceil((self.ymax - self.ymin) / self.resolution))

    @property
    def l_prior(self) -> float:
        return _log_odds(self.prior)

    @property
    def l_occ(self) -> float:
        return _log_odds(self.prob_occ)

    @property
    def l_free(self) -> float:
        return _log_odds(self.prob_free)


def grid_init(cfg: GridConfig, dtype=torch.float32, device=DEFAULT_DEVICE):
    """Fresh (H, W) log-odds grid at the prior (ref: map_ init
    grid_mapper.cpp:57-58)."""
    return torch.full((cfg.height, cfg.width), cfg.l_prior, dtype=dtype,
                      device=resolve(device))


def world_to_cell(cfg: GridConfig, xy):
    """World (…, 2) → integer cell (iy, ix) as int64, clamped into the map
    (the reference throws on out-of-bounds, grid_mapper.cpp:817-825)."""
    ix = torch.floor((xy[..., 0] - cfg.xmin) / cfg.resolution).long()
    iy = torch.floor((xy[..., 1] - cfg.ymin) / cfg.resolution).long()
    return (torch.clamp(iy, 0, cfg.height - 1),
            torch.clamp(ix, 0, cfg.width - 1))


def scan_end_points(cfg: GridConfig, ranges, pose):
    """Beam endpoints in the map frame + validity mask
    (ref: LaserScanner::laserEndPoints sensor_model.cpp:43-112).
    ranges: (B,); pose: (..., 3) [theta, x, y]. Returns ((..., B, 2), (B,)).
    The pose heading enters through the angle-addition identity, as in
    ``tpunav``."""
    table = beam_table(cfg, ranges)
    r, cb, sb = table[beams.R], table[beams.COS], table[beams.SIN]
    th = pose[..., 0:1]
    c0, s0 = torch.cos(th), torch.sin(th)
    pts = torch.stack([pose[..., 1:2] + r * (c0 * cb - s0 * sb),
                       pose[..., 2:3] + r * (s0 * cb + c0 * sb)], dim=-1)
    return pts, table[beams.R_MARK] >= 0.0


def _dilate3x3(mask):
    """8-neighbour dilation of (..., H, W) with zero fill at the edges."""
    h, w = mask.shape[-2:]
    mp = torch.nn.functional.pad(mask, (1, 1, 1, 1))
    out = mask
    for dy in range(3):
        for dx in range(3):
            out = torch.maximum(out, mp[..., dy:dy + h, dx:dx + w])
    return out


def integrate_scan(cfg: GridConfig, log_odds, ranges, pose):
    """Fold one scan into grid(s): free cells along each beam get
    l_free − l_prior, each endpoint cell gets l_occ − l_prior
    (ref: GridMapper::integrateScan grid_mapper.cpp:140-182).

    log_odds: (..., H, W); ranges: (B,); pose: (..., 3). The dense per-cell
    formulation of ``tpunav``: every cell looks up the beam covering its
    bearing and is marked free when it lies more than one cell short of
    that beam's hit and outside the 3×3-dilated endpoint mask, with the
    angular-multiplicity mass m = cell / (r·Δ)."""
    h, w = cfg.height, cfg.width
    batch = log_odds.shape[:-2]
    pts, valid = scan_end_points(cfg, ranges, pose)
    eiy, eix = world_to_cell(cfg, pts)                 # (..., B)
    flat = log_odds.reshape(-1, h * w)
    p = flat.shape[0]
    eflat = (eiy * w + eix).reshape(p, -1)
    vals = valid.to(log_odds.dtype).expand(p, -1)
    em = torch.zeros_like(flat).scatter_reduce_(1, eflat, vals, "amax")
    emd = _dilate3x3(em.reshape(*batch, h, w))

    res = cfg.resolution
    r_c, b = cell_beams(cfg, pose, log_odds.dtype)
    in_fov = b < cfg.num_beams
    bi = torch.clamp(b, 0, cfg.num_beams - 1)
    # Beam range gathered per cell; invalid beams never mark free space.
    r_beam = torch.where(valid, ranges, -1.0)[bi]
    free = in_fov & (r_c < r_beam - res) & (emd < 0.5)
    # A true division (torch takes scalar / tensor as a reciprocal times
    # the scalar, which rounds differently from tpunav's division).
    m = torch.clamp(r_c.new_tensor(res) / (torch.clamp(r_c, min=0.5 * res)
                                           * cfg.beam_delta),
                    max=float(cfg.num_beams))
    kw = dict(dtype=log_odds.dtype, device=log_odds.device)
    d_free = torch.tensor(cfg.l_free - cfg.l_prior, **kw)
    d_occ = torch.tensor(cfg.l_occ - cfg.l_prior, **kw)
    out = log_odds + torch.where(free, m * d_free, 0.0)
    out = out.reshape(-1).clone()
    offs = torch.arange(p, device=out.device)[:, None] * (h * w)
    out.index_add_(0, (eflat + offs).reshape(-1),
                   torch.where(valid, d_occ, 0.0).expand(p, -1).reshape(-1))
    return out.reshape(*batch, h, w)


def esdf(cfg: GridConfig, log_odds):
    """Distance field(s) to the nearest occupied cell (meters), capped at
    max_occ_dist (ref: euclideanSignedDistanceField grid_mapper.cpp:
    333-435). A map with no occupied cell reads max_occ_dist everywhere,
    the likelihood field's "no obstacles yet" early-out
    (ref: grid_mapper.cpp:95-100)."""
    occ = log_odds >= cfg.l_occ
    d = euclidean_distance_field(occ, cfg.resolution, cfg.max_occ_dist,
                                 dtype=log_odds.dtype)
    any_occ = occ.flatten(-2).any(-1)[..., None, None]
    return torch.where(any_occ, d, cfg.max_occ_dist)


def likelihood_field_log(cfg: GridConfig, dist_field, ranges, pose,
                         any_occ=None):
    """log P(z | m, x) under the likelihood-field model
    (ref: GridMapper::likelihoodFieldModel grid_mapper.cpp:69-133): per
    valid beam p_z = z_hit·N(d; σ_hit²) + z_rand/z_max with d the field at
    the beam endpoint, summed in log space over beams.

    dist_field: (..., H, W); pose: (..., 3), whose leading dimensions may
    extend the field's (P fields, (P, k, 3) samples: pass the field as
    (P, 1, H, W)). An all-free map returns log 1 = 0 (ref: :95-100)."""
    w = cfg.width
    pts, valid = scan_end_points(cfg, ranges, pose)
    iy, ix = world_to_cell(cfg, pts)                   # (..., B)
    idx = iy * w + ix
    flat = dist_field.flatten(-2)
    flat = flat.expand(*idx.shape[:-1], flat.shape[-1])
    d = torch.gather(flat, -1, idx)
    var = cfg.sigma_hit * cfg.sigma_hit
    norm = 1.0 / math.sqrt(2.0 * math.pi * var)
    pz = cfg.z_hit * norm * torch.exp(-0.5 * d * d / var) + \
        cfg.z_rand / cfg.z_max
    logp = torch.sum(torch.where(valid, torch.log(pz), 0.0), dim=-1)
    if any_occ is None:
        any_occ = (dist_field < cfg.max_occ_dist).flatten(-2).any(-1)
    return torch.where(any_occ, logp, 0.0)


def occupancy_grid(cfg: GridConfig, log_odds):
    """Export an int8 rviz-style map: -1 unknown, 0 free, 100 occupied,
    otherwise prob·100 (ref: GridMapper::gridMap grid_mapper.cpp:185-226,
    without the rviz transpose)."""
    prob = 1.0 - 1.0 / (1.0 + torch.exp(log_odds))
    out = (prob * 100.0).to(torch.int8)
    out = torch.where(prob >= cfg.prob_occ, 100, out).to(torch.int8)
    out = torch.where(prob <= cfg.prob_free, 0, out).to(torch.int8)
    out = torch.where(torch.abs(log_odds - cfg.l_prior) < 1e-6, -1,
                      out).to(torch.int8)
    return out
