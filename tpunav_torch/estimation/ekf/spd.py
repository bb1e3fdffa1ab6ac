"""Symmetric-positive-definite covariance repair.

Port of ``tpunav/estimation/ekf/spd.py`` (the reference's SPD utilities,
nuslam/src/nuslam/ekf_filter.cpp:18-91). ``nearest_spd`` is one ``eigh``
with eigenvalue clipping (Higham 1988's nearest SPD matrix in Frobenius
norm), as in ``tpunav``.

A failed factor: ``jnp.linalg.cholesky`` returns NaN where the factor
fails, and ``tpunav`` reads that NaN. ``torch.linalg.cholesky`` raises
instead (a host sync), so ``is_spd`` takes ``cholesky_ex``'s ``info``
together with a finite factor. ``repair_if_needed`` (a ``lax.cond`` in
``tpunav``) branches on the host: one read of ``is_spd`` per call, and the
``eigh`` only when the probe fails. The alternative, a ``torch.where``
over both branches, pays an (S, S) ``eigh`` on every call, and
``torch.linalg.eigh`` on a CUDA tensor reads its error code on the host
as well: at n=50 (S=103) it took 2.6–3.2× as long on the card
(``chip_smoke.py``'s ``ekf_times``, two runs).
"""

from __future__ import annotations

import torch


def is_spd(mat):
    """True (a bool tensor) if ``mat`` is symmetric positive definite:
    symmetric within a dtype-aware tolerance, like Eigen's isApprox in the
    reference (exact comparison would flag the benign asymmetry that
    (I-KH)Σ accumulates), and with a Cholesky factor that succeeds
    (ref: ekf_filter.cpp:28-45). Like ``jnp.linalg.cholesky``, the factor
    is taken of the symmetrized matrix."""
    scale = torch.clamp(torch.amax(torch.abs(mat)), min=1.0)
    tol = 1e5 * torch.finfo(mat.dtype).eps
    sym = torch.amax(torch.abs(mat - mat.T)) <= tol * scale
    fac = torch.linalg.cholesky_ex(0.5 * (mat + mat.T))
    ok = torch.logical_and(fac.info == 0, torch.isfinite(fac.L).all())
    return torch.logical_and(sym, ok)


def nearest_spd(mat, floor: float = 0.0):
    """Nearest SPD matrix: symmetrize, then clip eigenvalues up to a small
    positive floor scaled by the largest eigenvalue's ulp
    (ref: ekf_filter.cpp:49-91, :80-86)."""
    sym = 0.5 * (mat + mat.T)
    w, v = torch.linalg.eigh(sym)
    eps = torch.finfo(mat.dtype).eps
    lo = torch.clamp(eps * torch.clamp(torch.amax(torch.abs(w)), min=1.0),
                     min=floor)
    w = torch.maximum(w, lo)
    return (v * w) @ v.T


def repair_if_needed(mat):
    """``mat`` itself when it passes :func:`is_spd`, else
    :func:`nearest_spd` (ref: ekf_filter.cpp:298-305, 330-335 apply
    nearestSPD conditionally). One host read per call."""
    return mat if bool(is_spd(mat)) else nearest_spd(mat)
