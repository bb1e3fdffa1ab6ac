"""Lidar landmark detection: clustering + algebraic circle fitting.

Port of ``tpunav/estimation/landmarks.py`` (the reference's
``nuslam::Landmarks``, nuslam/include/nuslam/landmarks.hpp:99-141,
nuslam/src/nuslam/landmarks.cpp). ``tpunav`` leaves it to XLA, so it is
plain torch here, with every shape static (``max_clusters`` output slots)
and no host read of the data:

- Euclidean clustering (ref: clusterScan landmarks.cpp:354-446): a beam
  opens a cluster when it lies more than epsilon from the previous *valid*
  endpoint. ``tpunav`` carries that endpoint through a ``lax.scan`` over
  the beams; here one ``cummax`` over the valid beams' indices finds every
  beam's previous valid beam at once. The wrap-around first/last merge and
  the <4-point drop are masks.
- The "hyper-accurate" algebraic circle fit (ref: composeCircle
  landmarks.cpp:99-237) over the 4x4 moment matrix S = ZᵀZ: two batched
  4x4 eigendecompositions per scan, through the port's Jacobi kernel
  (``ops/sym_eig.py``; ``torch.linalg.eigh`` on the card reads its error
  code on the host, so the detector could not be captured in a CUDA
  graph). The fit runs in float64 whatever the scan's dtype, and its
  circles round once to that dtype: for a 4 cm cylinder,
  S spans about nine decades, and a float32 fit moves the center by up to
  ~0.5 mm from the float64 one (``tpunav``'s float32 fit as much as any),
  where the points' own float32 rounding moves it by about a micrometre. Its least-squares step A = Y⁻¹A* reuses Y's
  eigenvectors (Y = V diag(σ) Vᵀ, so A = V diag(1/σ) Vᵀ A*, with the small
  σ cut where ``jnp.linalg.lstsq``'s rcond cuts): ``torch.linalg.lstsq``
  on CUDA assumes full rank.
- Per-cluster sums are products with a one-hot (cluster, beam) matrix at
  full float32 precision: float atomics would sum in a varying order, and
  the detector must give the same circles on every run.
- Circle-vs-wall classification via inscribed-angle statistics
  (ref: classifyCircles landmarks.cpp:448-509), vectorized per cluster.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..device import constant, full_precision_matmul
from ..ops import sym_eig

# The circle fit's dtype (see the module's docstring). float64 always in
# the package; tools/detector_fit_precision.py sets float32 to measure
# what the float64 fit is worth on a course.
FIT_DTYPE = torch.float64

_SIGMA4_EPS = 1e-12   # small-singular-value branch (ref: landmarks.cpp:168)
# H⁻¹ of the hyper-accurate fit but its (3, 3) entry, −2·z̄, which the mask
# _CORNER marks.
_HINV = ((0.0, 0.0, 0.0, 0.5), (0.0, 1.0, 0.0, 0.0), (0.0, 0.0, 1.0, 0.0),
         (0.5, 0.0, 0.0, 0.0))
_CORNER = tuple(tuple(i == j == 3 for j in range(4)) for i in range(4))


@dataclasses.dataclass(frozen=True)
class LaserProps:
    """Lidar geometry (ref: nuslam::LaserProperties landmarks.hpp:20-79 and
    the LDS-01 constants of landmarks_node.cpp:68-77)."""

    beam_min: float = 0.0
    beam_delta: float = math.pi / 180.0 * 1.0   # 1 degree
    range_min: float = 0.12
    range_max: float = 3.5
    num_beams: int = 360


@dataclasses.dataclass(frozen=True)
class LandmarkConfig:
    props: LaserProps = LaserProps()
    epsilon: float = 0.075          # cluster gap (ref: landmarks_node.cpp:77)
    radius_thresh: float = 0.05     # (ref: landmarks.cpp ctor radius_thresh)
    min_points: int = 4             # (ref: num_points landmarks.cpp:253)
    max_clusters: int = 64          # static output capacity
    angle_std: float = 0.15         # (ref: classifyCircles gates)
    mu_min_deg: float = 90.0
    mu_max_deg: float = 135.0
    # Inscribed-angle circle/wall classification in featureDetection.
    # False = the reference's shipped behavior (radius filter only;
    # classifyCircles exists but is bypassed, landmarks.cpp:299-307).
    use_classify: bool = False


class Circles(NamedTuple):
    centers: torch.Tensor   # (C, 2)
    radii: torch.Tensor     # (C,)
    valid: torch.Tensor     # (C,) bool


def laser_end_points(props: LaserProps, ranges):
    """Polar scan → cartesian endpoints + validity mask
    (ref: Landmarks::laserEndPoints landmarks.cpp:314-350)."""
    angles = props.beam_min + props.beam_delta * torch.arange(
        props.num_beams, dtype=ranges.dtype, device=ranges.device)
    valid = torch.logical_and(ranges >= props.range_min,
                              ranges < props.range_max)
    pts = torch.stack([ranges * torch.cos(angles),
                       ranges * torch.sin(angles)], dim=-1)
    return pts, valid


def _norm2(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _first_valid(valid):
    """Index of the first valid beam (0 when none), as a (1,) tensor."""
    return torch.argmax(valid.to(torch.uint8)).view(1)


def _gap_flags(cfg: LandmarkConfig, pts, valid):
    """Per beam: valid and more than epsilon from the previous valid
    endpoint — the first valid beam measures against itself, as the
    reference's curr = prev = front (ref: :404-405)."""
    n = pts.shape[0]
    idx = torch.arange(n, device=pts.device)
    last_valid = torch.cummax(torch.where(valid, idx, -1), dim=0).values
    prev = torch.cat([last_valid.new_full((1,), -1), last_valid[:-1]])
    prev = torch.where(prev < 0, _first_valid(valid), prev)
    d = _norm2(pts - pts.index_select(0, prev))
    return torch.logical_and(valid, d > cfg.epsilon)


def cluster_scan(cfg: LandmarkConfig, pts, valid):
    """Assign a cluster id to every beam (invalid beams get id -1).

    Matches the reference's sequential pass over *valid* endpoints
    (ref: clusterScan landmarks.cpp:354-446): a valid point opens a new
    cluster when its distance to the previous valid point exceeds epsilon;
    afterwards the first and last clusters merge if the first and last
    valid endpoints are within epsilon (scan starting mid-cluster)."""
    n = pts.shape[0]
    ids = torch.cumsum(_gap_flags(cfg, pts, valid).to(torch.int32), dim=0,
                       dtype=torch.int32)
    ids = torch.where(valid, ids, -1)

    # Wrap-around merge (ref: :416-432).
    first = _first_valid(valid)
    last = n - 1 - torch.argmax(valid.flip(0).to(torch.uint8)).view(1)
    ends = pts.index_select(0, torch.cat([first, last]))
    wrap = torch.logical_and(valid.any(),
                             _norm2(ends[0] - ends[1]) <= cfg.epsilon)
    first_id = ids.index_select(0, first)
    last_id = ids.index_select(0, last)
    merge = torch.logical_and(torch.logical_and(wrap, first_id != last_id),
                              ids == last_id)
    return torch.where(merge, first_id, ids)


def _fit_from_moments(S, z_bar):
    """Circle parameters (a, b, R) in centroid coordinates from batched
    (C, 4, 4) moment matrices S = ZᵀZ (ref: composeCircle
    landmarks.cpp:99-237)."""
    # S = V Σ² Vᵀ replaces the reference's SVD of Z.
    s_eig, V = sym_eig.eigh(S)                 # ascending; S is symmetric
    sigma = torch.sqrt(torch.clamp(s_eig, min=0.0))   # singular values of Z

    # Branch 1: rank-deficient — the null vector of S (ref: :168-172).
    A_small = V[..., :, 0]

    # Branch 2: Y = sqrt(S), Q = Y H⁻¹ Y, smallest positive eigenvalue.
    Y = (V * sigma[..., None, :]) @ V.transpose(-1, -2)
    # H⁻¹ with its (3, 3) entry −2·z̄ per cluster, built out of place from
    # cached constants (so the fit maps over a batch of scans under
    # torch.func.vmap, and a graph capture makes no host copy).
    hinv = torch.where(constant(_CORNER, torch.bool, S.device),
                       (-2.0 * z_bar)[..., None, None],
                       constant(_HINV, S.dtype, S.device))
    Q = Y @ hinv @ Y
    # Symmetrized first, as jnp.linalg.eigh takes its input.
    q_eig, W = sym_eig.eigh(0.5 * (Q + Q.transpose(-1, -2)))
    # Smallest strictly positive eigenvalue (ref: :196-207).
    pick = torch.argmin(torch.where(q_eig > 0.0, q_eig, float("inf")),
                        dim=-1)
    a_star = torch.gather(W, -1, pick[..., None, None].expand(
        *W.shape[:-1], 1))[..., 0]
    # A = Y⁻¹ A* as jnp.linalg.lstsq takes it (ref uses a COD solve, :229):
    # Y's singular values are σ with vectors V; those below
    # max(σ)·eps·4 are cut.
    cut = torch.finfo(S.dtype).eps * 4 * torch.amax(sigma, dim=-1,
                                                    keepdim=True)
    keep = torch.logical_and(sigma > 0.0, sigma >= cut)
    s_inv = torch.where(keep, torch.ones_like(sigma) /
                        torch.where(keep, sigma, 1.0), 0.0)
    vta = (V.transpose(-1, -2) @ a_star[..., None])[..., 0]
    A_gen = (V @ (s_inv * vta)[..., None])[..., 0]

    A = torch.where((sigma[..., 0] < _SIGMA4_EPS)[..., None], A_small, A_gen)
    a = -A[..., 1] / (2.0 * A[..., 0])
    b = -A[..., 2] / (2.0 * A[..., 0])
    r2 = (A[..., 1] * A[..., 1] + A[..., 2] * A[..., 2] -
          4.0 * A[..., 0] * A[..., 3]) / (4.0 * A[..., 0] * A[..., 0])
    return a, b, torch.sqrt(torch.clamp(r2, min=0.0))


def _segments(cfg: LandmarkConfig, ids, valid, dtype):
    """(C, n) one-hot of each valid beam's cluster slot (ids past the last
    slot fold into it, as ``tpunav``'s clip) and the clipped slot per
    beam. The operands it multiplies are zeroed at invalid beams first
    (:func:`_masked`): 0 × inf would spread NaN over every cluster."""
    C = cfg.max_clusters
    slot = torch.clamp(ids, 0, C - 1)
    rows = torch.arange(C, device=ids.device)[:, None]
    onehot = torch.logical_and(rows == slot[None, :], valid[None, :])
    return onehot.to(dtype), slot.long()


def _masked(valid, v):
    return torch.where(valid.view(-1, *([1] * (v.dim() - 1))), v, 0.0)


def fit_circles(cfg: LandmarkConfig, pts, ids, valid):
    """Per-cluster circle fits from per-beam points + cluster ids. Returns
    :class:`Circles` with ``max_clusters`` slots. Per cluster (ref:
    featureDetection landmarks.cpp:269-276): centroid → centroid shift →
    moment accumulation → 4x4 algebraic fit."""
    dtype = pts.dtype
    pts = pts.to(FIT_DTYPE)
    with full_precision_matmul():
        onehot, slot = _segments(cfg, ids, valid, pts.dtype)
        count = onehot.sum(dim=1)
        sxy = onehot @ _masked(valid, pts)                  # (C, 2)
        cnt_safe = torch.clamp(count, min=1.0)
        cx, cy = sxy[:, 0] / cnt_safe, sxy[:, 1] / cnt_safe  # (ref: :43-60)

        # Shifted coordinates per point (ref: shiftCentroidToOrigin :64-95).
        x = pts[:, 0] - cx.index_select(0, slot)
        y = pts[:, 1] - cy.index_select(0, slot)
        z = x * x + y * y
        # S = ZᵀZ with Z rows [z, x, y, 1]: ten unique entries.
        prods = torch.stack([z * z, z * x, z * y, z, x * x, x * y, x,
                             y * y, y], dim=-1)
        m = onehot @ _masked(valid, prods)                   # (C, 9)
        m_zz, m_zx, m_zy, m_z, m_xx, m_xy, m_x, m_yy, m_y = m.unbind(-1)
        S = torch.stack([
            torch.stack([m_zz, m_zx, m_zy, m_z], dim=-1),
            torch.stack([m_zx, m_xx, m_xy, m_x], dim=-1),
            torch.stack([m_zy, m_xy, m_yy, m_y], dim=-1),
            torch.stack([m_z, m_x, m_y, count], dim=-1),
        ], dim=-2)                                           # (C, 4, 4)
        z_bar = m_z / cnt_safe

        ok = count >= cfg.min_points                         # (ref: :437-445)
        # Guard degenerate slots so the eigensolver never sees garbage.
        eye = torch.eye(4, dtype=S.dtype, device=S.device)
        S_safe = torch.where(ok[:, None, None], S, eye)
        a, b, r = _fit_from_moments(S_safe, z_bar)
    centers = torch.stack([cx + a, cy + b], dim=-1).to(dtype)
    r = r.to(dtype)
    ok = torch.logical_and(ok, r <= cfg.radius_thresh)    # (ref: :296-307)
    ok = torch.logical_and(ok, torch.isfinite(centers).all(dim=-1))
    return Circles(centers=centers, radii=r, valid=ok)


def classify_circles(cfg: LandmarkConfig, pts, ids, valid, circles: Circles):
    """Inscribed-angle circle/wall test per cluster
    (ref: classifyCircles landmarks.cpp:448-509): for every inner point P,
    the angle at P subtended by the cluster's endpoints; a circle has a
    mean angle in [mu_min, mu_max] degrees with std < angle_std."""
    C = cfg.max_clusters
    n = pts.shape[0]
    with full_precision_matmul():
        onehot, slot = _segments(cfg, ids, valid, pts.dtype)
        member = onehot > 0
        idx = torch.arange(n, device=pts.device)
        first = torch.where(member, idx, n + 1).amin(dim=1)
        last = torch.where(member, idx, -1).amax(dim=1)
        first = torch.clamp(first, 0, n - 1)
        last = torch.clamp(last, 0, n - 1)
        ps = pts.index_select(0, first.index_select(0, slot))
        pe = pts.index_select(0, last.index_select(0, slot))
        a = _norm2(pts - pe)
        b = _norm2(ps - pe)
        c = _norm2(pts - ps)
        # Law of cosines angle at the inner point (ref: lawCosines helper).
        cos_arg = torch.clamp((a * a + c * c - b * b) /
                              torch.clamp(2.0 * a * c, min=1e-12), -1.0, 1.0)
        ang = torch.arccos(cos_arg)

        inner = torch.logical_and(valid, torch.logical_and(
            idx != first.index_select(0, slot),
            idx != last.index_select(0, slot)))
        n_inner = onehot @ inner.to(pts.dtype)
        n_safe = torch.clamp(n_inner, min=1.0)
        mean = (onehot @ _masked(inner, ang)) / n_safe
        dev = ang - mean.index_select(0, slot)
        var = (onehot @ _masked(inner, dev * dev)) / n_safe
    std = torch.sqrt(var)
    is_circle = torch.logical_and(
        std < cfg.angle_std,
        torch.logical_and(mean >= math.radians(cfg.mu_min_deg),
                          mean <= math.radians(cfg.mu_max_deg)))
    return torch.logical_and(is_circle, torch.logical_and(circles.valid,
                                                          n_inner >= 1))


def _roll_to_cluster_boundary(cfg: LandmarkConfig, pts, valid):
    """Rotate the beam axis so index 0 falls on a cluster boundary (the
    first cluster-opening gap; a no-op when the scan is one cluster): the
    reference reorders a wrap-around cluster's points contiguously when
    merging (landmarks.cpp:416-432), and ``classify_circles``'s endpoints
    assume the same. The shift stays on the device (a gather)."""
    n = pts.shape[0]
    gaps = _gap_flags(cfg, pts, valid)
    shift = torch.where(gaps.any(), torch.argmax(gaps.to(torch.uint8)), 0)
    src = (torch.arange(n, device=pts.device) + shift) % n
    return pts.index_select(0, src), valid.index_select(0, src)


def feature_detection(cfg: LandmarkConfig, ranges) -> Circles:
    """Full pipeline: scan → endpoints → clusters → circle fits → radius
    filter, plus the inscribed-angle circle/wall classification when
    ``cfg.use_classify`` (ref: Landmarks::featureDetection
    landmarks.cpp:259-310; classifyCircles :448-509). Returns
    ``max_clusters`` fixed slots."""
    pts, valid = laser_end_points(cfg.props, ranges)
    if cfg.use_classify:
        pts, valid = _roll_to_cluster_boundary(cfg, pts, valid)
    ids = cluster_scan(cfg, pts, valid)
    circles = fit_circles(cfg, pts, ids, valid)
    if cfg.use_classify:
        circles = circles._replace(valid=classify_circles(cfg, pts, ids,
                                                          valid, circles))
    return circles


def circles_to_measurements(circles: Circles):
    """Detected circles → the EKF's measurement format: (C, 2) robot-frame
    centers with NaN rows for empty slots (the TurtleMap hand-off between
    the reference's landmarks node and slam node, ref:
    nuslam/src/landmarks_node.cpp:84-104, slam_node.cpp:109-123)."""
    return torch.where(circles.valid[:, None], circles.centers,
                       float("nan"))
