"""2D ICP scan matching: masked nearest neighbours + point-to-line
Gauss-Newton.

Port of ``tpunav/estimation/rbpf/icp.py`` (the replacement for the
reference's PCL IterativeClosestPoint wrapper,
bmapping/src/bmapping/cloud_alignment.cpp). Correspondences come from a
dense (N×N) masked distance matrix; each iteration solves the 3×3 normal
equations of the point-to-line metric. ``tpunav``'s ``lax.scan`` over
``max_iter`` becomes a Python loop of ``max_iter`` iterations. Nothing in
it reads a value back to the host: ``torch.linalg.solve_ex`` and device
indexing keep the whole match queued on the device.

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

from ...core import se2


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


def _take(v, i):
    """v[i] for a 0-dim device index, without a host read."""
    return torch.index_select(v, 0, i.reshape(1))[0]


def _iteration(cfg: ICPConfig, T, src, src_valid, dst, dst_valid,
               n_src_valid):
    """One point-to-line Gauss-Newton step from T; returns
    (T_new, rmse, |step|, inlier fraction, min normal eigenvalue)."""
    n = dst.shape[0]
    big = 1e9
    moved = se2.apply(T, src)                               # (N, 2)
    d2 = torch.sum((moved[:, None, :] - dst[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(dst_valid[None, :], d2, big)
    nn = torch.argmin(d2, dim=1)                            # first minimum
    nn_d = torch.sqrt(torch.gather(d2, 1, nn[:, None])[:, 0])
    # Correspondence rejection (PCL max_correspondence_distance).
    gate = torch.logical_and(src_valid, nn_d <= cfg.max_corr_dist)
    # Annealed residual gate at max(outlier_thresh, outlier_scale·q40).
    d_masked = torch.sort(torch.where(gate, nn_d, big)).values
    cnt = torch.sum(gate.to(torch.int64))
    med = _take(d_masked, torch.clamp((2 * cnt) // 5, min=0))
    rej = torch.clamp(cfg.outlier_scale * med, min=cfg.outlier_thresh)
    w = torch.logical_and(gate, nn_d <= rej).to(src.dtype)
    wsum = torch.clamp(torch.sum(w), min=1e-9)

    q = dst[nn]                                             # matched targets
    # Local line through the scan-adjacent neighbours of the match.
    prv = torch.clamp(nn - 1, 0, n - 1)
    nxt = torch.clamp(nn + 1, 0, n - 1)
    both_ok = torch.logical_and(dst_valid[prv], dst_valid[nxt])
    tang = torch.where(both_ok[:, None], dst[nxt] - dst[prv],
                       torch.zeros_like(q))
    tnorm = torch.linalg.norm(tang, dim=-1, keepdim=True)
    line_ok = tnorm[:, 0] > 1e-9
    tang = tang / torch.clamp(tnorm, min=1e-9)
    normal = torch.stack([-tang[:, 1], tang[:, 0]], dim=-1)
    # Fallback to the point-to-point direction for degenerate lines.
    diff = q - moved
    dnorm = torch.clamp(torch.linalg.norm(diff, dim=-1, keepdim=True),
                        min=1e-9)
    normal = torch.where(line_ok[:, None], normal, diff / dnorm)

    # Gauss-Newton on r_i = n_i · (p_i + [J p_i]θ + t − q_i), J the 90°
    # rotation. Unknowns x = (θ, tx, ty).
    jp = torch.stack([-moved[:, 1], moved[:, 0]], dim=-1)
    a = torch.stack([torch.sum(normal * jp, dim=-1),
                     normal[:, 0], normal[:, 1]], dim=-1)   # (N, 3)
    b = torch.sum(normal * (q - moved), dim=-1)             # (N,)
    aw = a * w[:, None]
    ata = aw.T @ a + 1e-9 * torch.eye(3, dtype=a.dtype, device=a.device)
    atb = aw.T @ b
    x = torch.linalg.solve_ex(ata, atb).result
    T_new = se2.compose(x, T)
    rmse = torch.sum(w * nn_d) / wsum
    # Observability: spectrum of the unit-normal outer-product sum; a
    # corridor's normals all point one way, so its min eigenvalue is ~0.
    nmat = (normal * w[:, None]).T @ normal / wsum          # (2, 2)
    tr = nmat[0, 0] + nmat[1, 1]
    det = nmat[0, 0] * nmat[1, 1] - nmat[0, 1] * nmat[1, 0]
    disc = torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    return (T_new, rmse, torch.linalg.norm(x), torch.sum(w) / n_src_valid,
            tr / 2.0 - disc)


def icp_match(cfg: ICPConfig, src, src_valid, dst, dst_valid,
              T_init) -> ICPResult:
    """Align ``src`` onto ``dst``. src/dst: (N, 2) + validity masks;
    T_init: (3,) initial guess [theta, x, y]. Point-to-line metric (Censi's
    PLICP): each source point is matched to the line through its nearest
    destination point and that point's scan neighbours, and each of the
    ``max_iter`` iterations takes one Gauss-Newton step."""
    n_src_valid = torch.clamp(torch.sum(src_valid.to(src.dtype)), min=1e-9)
    T = torch.as_tensor(T_init, dtype=src.dtype, device=src.device)
    for _ in range(cfg.max_iter):
        T, rmse, delta, inlier_frac, min_eig = _iteration(
            cfg, T, src, src_valid, dst, dst_valid, n_src_valid)
    converged = ((rmse <= cfg.converged_rmse)
                 & (delta <= cfg.transform_eps)
                 & (inlier_frac >= cfg.min_inlier_frac)
                 & (min_eig >= cfg.min_normal_eig)
                 & (torch.sum(src_valid) > 0))
    T = torch.cat([torch.atan2(torch.sin(T[:1]), torch.cos(T[:1])), T[1:]])
    return ICPResult(transform=T, converged=converged, rmse=rmse,
                     inlier_frac=inlier_frac, delta_norm=delta,
                     normal_eig=min_eig)
