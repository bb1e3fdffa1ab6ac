"""Symmetric-positive-definite covariance repair.

Port of ``tpunav/estimation/ekf/spd.py`` (the reference's SPD utilities,
nuslam/src/nuslam/ekf_filter.cpp:18-91). ``nearest_spd`` is one
eigendecomposition with eigenvalue clipping (Higham 1988's nearest SPD
matrix in Frobenius norm), as in ``tpunav``; the eigensolver is the port's
Jacobi kernel (``ops/sym_eig.py``), in float64 whatever the matrix's
dtype, with its results rounded once to that dtype.

A failed factor: ``jnp.linalg.cholesky`` returns NaN where the factor
fails, and ``tpunav`` reads that NaN. ``torch.linalg.cholesky`` raises
instead (a host sync), so ``is_spd`` takes ``cholesky_ex``'s ``info``
together with a finite factor. ``repair_if_needed`` is a ``lax.cond`` in
``tpunav``; here it is a ``torch.where`` on ``is_spd``, whose flag also
tells the eigensolver to run no sweeps, so an SPD matrix costs no
eigendecomposition and the repair makes no host read (it can be captured
in a CUDA graph).
"""

from __future__ import annotations

from typing import Optional

import torch

from ...ops import sym_eig


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


def nearest_spd(mat, floor: float = 0.0,
                skip: Optional[torch.Tensor] = None):
    """Nearest SPD matrix: symmetrize, then clip eigenvalues up to a small
    positive floor scaled by the largest eigenvalue's ulp
    (ref: ekf_filter.cpp:49-91, :80-86). ``skip``: a bool tensor; where
    True the eigensolver runs no sweeps and the result is not the nearest
    SPD matrix (for a caller that then discards it)."""
    sym = 0.5 * (mat + mat.T)
    w, v = sym_eig.eigh(sym.to(torch.float64), skip=skip)
    w, v = w.to(mat.dtype), v.to(mat.dtype)
    eps = torch.finfo(mat.dtype).eps
    lo = torch.clamp(eps * torch.clamp(torch.amax(torch.abs(w)), min=1.0),
                     min=floor)
    w = torch.maximum(w, lo)
    return (v * w) @ v.T


def repair_if_needed(mat):
    """``mat`` itself when it passes :func:`is_spd`, else
    :func:`nearest_spd` (ref: ekf_filter.cpp:298-305, 330-335 apply
    nearestSPD conditionally), through a ``torch.where``: no host read."""
    ok = is_spd(mat)
    return torch.where(ok, mat, nearest_spd(mat, skip=ok))
