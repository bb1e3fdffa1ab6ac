"""2D ICP scan matching: masked nearest neighbours + point-to-line
Gauss-Newton.

Port of ``tpunav/estimation/rbpf/icp.py`` (the replacement for the
reference's PCL IterativeClosestPoint wrapper,
bmapping/src/bmapping/cloud_alignment.cpp). Correspondences come from a
dense (N×N) masked distance matrix; each iteration solves the 3×3 normal
equations of the point-to-line metric. ``tpunav``'s ``lax.scan`` over
``max_iter`` becomes one launch of the ICP kernel on the card
(``tpunav_torch/ops/icp.py``, ``csrc/icp.cu``) and a Python loop of
``max_iter`` iterations on the CPU (the kernel's plain version,
``ops/icp.py:_icp_reference``). Neither reads a value back to the host.

Convention as in the reference: ``icp_match(src, dst, T_init)`` returns
the SE(2) transform mapping source points into the destination cloud's
frame; with source = current scan and destination = previous scan it is
the robot's motion in the previous body frame.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ...ops import icp as icp_kernel


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """(ref: pclICP cloud_alignment.cpp:160-195.) Each iteration gates
    correspondences at max(outlier_thresh, outlier_scale·q40), the 0.4
    quantile of the gated residuals. Convergence requires the final mean
    residual ≤ converged_rmse, the last step's |(dθ,dx,dy)| ≤
    transform_eps, inlier fraction ≥ min_inlier_frac and the
    correspondence-normal spectrum's min eigenvalue ≥ min_normal_eig."""

    max_iter: int = 30
    max_corr_dist: float = 0.5
    converged_rmse: float = 0.05
    outlier_thresh: float = 0.05
    outlier_scale: float = 3.0
    transform_eps: float = 1e-3
    min_inlier_frac: float = 0.2
    min_normal_eig: float = 0.05


class ICPResult(NamedTuple):
    transform: torch.Tensor    # (3,) [theta, x, y]
    converged: torch.Tensor    # bool
    rmse: torch.Tensor         # mean inlier correspondence distance
    inlier_frac: torch.Tensor  # fraction of valid src points kept
    delta_norm: torch.Tensor   # |(dθ,dx,dy)| of the final GN step
    normal_eig: torch.Tensor   # min eigenvalue of the normal spectrum


def scan_to_points(ranges, range_min, range_max, beam_min=0.0,
                   beam_delta=math.pi / 180.0):
    """Polar scan → sensor-frame points (N, 2) + validity mask (N,)
    (ref: createPointCloud cloud_alignment.cpp:76-157)."""
    n = ranges.shape[0]
    angles = beam_min + beam_delta * torch.arange(
        n, dtype=ranges.dtype, device=ranges.device)
    valid = torch.logical_and(ranges >= range_min, ranges < range_max)
    r = torch.where(valid, ranges, range_min)
    pts = torch.stack([r * torch.cos(angles), r * torch.sin(angles)], dim=-1)
    return pts, valid


def icp_match(cfg: ICPConfig, src, src_valid, dst, dst_valid,
              T_init) -> ICPResult:
    """Align ``src`` onto ``dst``. src/dst: (N, 2) + validity masks;
    T_init: (3,) initial guess [theta, x, y]. Point-to-line metric (Censi's
    PLICP): each source point is matched to the line through its nearest
    destination point and that point's scan neighbours, and each of the
    ``max_iter`` iterations takes one Gauss-Newton step. On the card one
    launch of the ICP kernel (float32 clouds, bool masks); on the CPU its
    plain version."""
    if src.is_cuda:
        return ICPResult(*icp_kernel.icp_points(cfg, src, src_valid, dst,
                                                dst_valid, T_init))
    if src.device.type != "cpu":
        raise ValueError(f"no ICP path for device {src.device}")
    return ICPResult(*icp_kernel._icp_reference(cfg, src, src_valid, dst,
                                                dst_valid, T_init))


def icp_match_scans(cfg: ICPConfig, ranges, prev_ranges, T_init, range_min,
                    range_max, beam_min=0.0,
                    beam_delta=math.pi / 180.0) -> ICPResult:
    """:func:`icp_match` of scan ``ranges`` onto scan ``prev_ranges`` (both
    (B,)), each first turned into points by :func:`scan_to_points`. On the
    card the conversion runs inside the match's one launch."""
    if ranges.is_cuda:
        return ICPResult(*icp_kernel.icp_scans(
            cfg, ranges, prev_ranges, T_init, range_min, range_max,
            beam_min, beam_delta))
    src, src_ok = scan_to_points(ranges, range_min, range_max, beam_min,
                                 beam_delta)
    dst, dst_ok = scan_to_points(prev_ranges, range_min, range_max,
                                 beam_min, beam_delta)
    return icp_match(cfg, src, src_ok, dst, dst_ok, T_init)
