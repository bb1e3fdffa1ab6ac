"""SE(2) Lie-group operations on batched tensors.

Port of ``tpunav/core/se2.py`` (the reference's ``rigid2d::Transform2D``,
rigid2d/include/rigid2d/rigid2d.hpp:314-372,
rigid2d/src/rigid2d/rigid2d.cpp:120-303). A transform is a plain
``(..., 3)`` tensor ``[theta, x, y]``; a twist is ``(..., 3)``
``[w, vx, vy]``. ``exp_twist`` is branch-free: Taylor guards near w = 0
take the place of the reference's three-way ``almost_equal`` branch.
"""

from __future__ import annotations

import torch

from ..device import DEFAULT_DEVICE, resolve
from .angles import normalize_angle_pi

# Small-angle guard for the sinc-like terms of the SE(2) exponential.
_SMALL_W = 1e-6


def identity(dtype=torch.float32, device=DEFAULT_DEVICE):
    """Identity transform [0, 0, 0] on ``device`` (default the CUDA card;
    raises without CUDA unless ``device="cpu"``)."""
    return torch.zeros((3,), dtype=dtype, device=resolve(device))


def make(theta, x, y):
    """Build transform(s) from components; broadcasts like torch.stack."""
    theta, x, y = torch.broadcast_tensors(
        torch.as_tensor(theta), torch.as_tensor(x), torch.as_tensor(y))
    return torch.stack([theta, x, y], dim=-1)


def theta_of(T):
    return T[..., 0]


def translation_of(T):
    return T[..., 1:3]


def compose(a, b):
    """a ∘ b (ref: Transform2D::operator*= rigid2d.cpp:215-224). Angles add
    without wrapping, as in the reference."""
    ta = a[..., 0]
    ca, sa = torch.cos(ta), torch.sin(ta)
    bx, by = b[..., 1], b[..., 2]
    x = a[..., 1] + ca * bx - sa * by
    y = a[..., 2] + sa * bx + ca * by
    return torch.stack(torch.broadcast_tensors(ta + b[..., 0], x, y), dim=-1)


def inverse(T):
    """T^{-1} (ref: Transform2D::inv rigid2d.cpp:170-186)."""
    t = T[..., 0]
    c, s = torch.cos(t), torch.sin(t)
    x, y = T[..., 1], T[..., 2]
    return torch.stack([-t, -(c * x + s * y), -(-s * x + c * y)], dim=-1)


def apply(T, p):
    """Apply transform(s) to point(s) ``p`` of shape (..., 2)
    (ref: Transform2D::operator() rigid2d.cpp:160-167)."""
    t = T[..., 0]
    c, s = torch.cos(t), torch.sin(t)
    px, py = p[..., 0], p[..., 1]
    return torch.stack([T[..., 1] + c * px - s * py,
                        T[..., 2] + s * px + c * py], dim=-1)


def adjoint(T, V):
    """Change twist ``V=[w,vx,vy]`` coordinate frame by the adjoint of T
    (ref: Transform2D::operator() on Twist2D, rigid2d.cpp:189-199)."""
    t = T[..., 0]
    c, s = torch.cos(t), torch.sin(t)
    w, vx, vy = V[..., 0], V[..., 1], V[..., 2]
    x, y = T[..., 1], T[..., 2]
    return torch.stack(torch.broadcast_tensors(
        w, vx * c - vy * s + w * y, vx * s + vy * c - w * x), dim=-1)


def _sinc_terms(w):
    """A = sin(w)/w and B = (1−cos(w))/w with 5th/4th-order Taylor guards
    near w = 0."""
    small = torch.abs(w) < _SMALL_W
    w_safe = torch.where(small, torch.ones_like(w), w)
    a = torch.where(small, 1.0 - w * w / 6.0, torch.sin(w_safe) / w_safe)
    b = torch.where(small, w / 2.0 - w * w * w / 24.0,
                    (1.0 - torch.cos(w_safe)) / w_safe)
    return a, b


def exp_twist(V):
    """SE(2) exponential of a unit-time twist ``V=[w,vx,vy]`` → transform
    (ref: rigid2d.cpp:239-303): rotation w wrapped to (-pi, pi], translation
    the SE(2) V-matrix applied to [vx, vy]."""
    w, vx, vy = V[..., 0], V[..., 1], V[..., 2]
    a, b = _sinc_terms(w)
    dx = a * vx - b * vy
    dy = b * vx + a * vy
    dtheta = torch.atan2(torch.sin(w), torch.cos(w))
    return torch.stack([dtheta, dx, dy], dim=-1)


def integrate_twist(T, V):
    """T ∘ exp(V): advance transform T by one unit-time twist
    (ref: Transform2D::integrateTwist rigid2d.cpp:239-303)."""
    return compose(T, exp_twist(V))


def log_twist(T):
    """SE(2) logarithm: transform → unit-time twist ``[w,vx,vy]``, the
    inverse of :func:`exp_twist`."""
    w = normalize_angle_pi(T[..., 0])
    x, y = T[..., 1], T[..., 2]
    a, b = _sinc_terms(w)
    # Invert the 2x2 V-matrix [[A,-B],[B,A]]: det = A² + B².
    det = a * a + b * b
    return torch.stack([w, (a * x + b * y) / det, (-b * x + a * y) / det],
                       dim=-1)


def displacement(T):
    """(theta, x, y) view of the transform — the identity on this
    representation (ref: Transform2D::displacement rigid2d.cpp:227-235)."""
    return T
