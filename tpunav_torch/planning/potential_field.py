"""Potential-field gradient-descent planner.

Port of ``tpunav/planning/potential_field.py`` (a re-design of
``planner::PotentialField``, planner/src/planner/potential_field.cpp). The
same semantics:

- attractive gradient: quadratic w_att·(q − qg), switched to the conic
  form (scaled by dthresh/d) beyond dthresh (ref: :202-220);
- repulsive gradient per polygon: from the closest boundary point within
  qthresh, with the reference's weight w_rep/(qthresh − d) — the C++
  writes ``(1.0 / d*d)``, which by precedence is (1/d)·d = 1, so the
  nominal 1/d² factor is unity, as shipped (ref: :320-341);
- one normalized gradient-descent step per step (ref: :57-84).

One step is a handful of tensor ops on ``device`` over all polygons and
edges at once, replayed as one CUDA graph; :meth:`PotentialField.plan`
reads the distance to the goal on the host once per step, as ``tpunav``
does.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import capture
from ..device import DEFAULT_DEVICE, resolve
from .utilities import min_dist_segment_point
from .world import ObstacleMap


@dataclasses.dataclass(frozen=True)
class PotentialFieldConfig:
    """(ref: planner/launch/plan.launch potential-field params.)"""

    eps: float = 0.05        # goal tolerance
    step: float = 0.05       # gradient-descent step size
    dthresh: float = 0.5     # attractive conic/quadratic switch
    qthresh: float = 0.3     # repulsive influence range
    w_att: float = 1.0
    w_rep: float = 0.1


class PotentialField:
    """The planner over one obstacle map, with its polygons' edges on
    ``device`` (ref: potential_field_planner_node.cpp:193-214).

    One descent step is a ``capture.Graph`` step (``tpunav``'s jitted
    ``_one_step``) on a static ``q`` and goal: it writes the next ``q`` and
    its distance to the goal in place."""

    def __init__(self, cfg: PotentialFieldConfig, obs_map: ObstacleMap,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        self.cfg = cfg
        self.dtype = dtype
        dev = resolve(device)
        polys = torch.as_tensor(obs_map.polygons, dtype=dtype, device=dev)
        counts = torch.as_tensor(obs_map.n_vertices, dtype=torch.int64,
                                 device=dev)
        idx = torch.arange(polys.shape[1], device=dev)
        nxt = torch.where(idx + 1 >= counts[:, None], torch.zeros_like(idx),
                          idx + 1)
        a = self.a = polys                                        # (P, V, 2)
        b = self.b = torch.gather(polys, 1,
                                  nxt[..., None].expand(-1, -1, 2))
        valid = self.valid = idx < counts[:, None]                # (P, V)
        q = self._q = torch.zeros(2, dtype=dtype, device=dev)
        goal = self._goal = torch.zeros(2, dtype=dtype, device=dev)
        dist = self._dist = torch.zeros((), dtype=dtype, device=dev)

        def body():
            q.copy_(_one_step(cfg, a, b, valid, q, goal))
            dist.copy_(torch.linalg.vector_norm(q - goal))

        self._graph = capture.Graph(body, dev)

    def plan(self, start, goal, max_steps: int = 2000):
        """Run gradient descent until the goal tolerance or max_steps;
        returns the path (list of (2,) tensors). Each step reads the
        distance to the goal on the host once, as ``tpunav``'s loop does."""
        q, g, dist = self._q, self._goal, self._dist
        q.copy_(torch.as_tensor(start, dtype=self.dtype), non_blocking=True)
        g.copy_(torch.as_tensor(goal, dtype=self.dtype), non_blocking=True)
        dist.copy_(torch.linalg.vector_norm(q - g))
        path = [q.clone()]
        for _ in range(max_steps):
            if float(dist) < self.cfg.eps:
                break
            self._graph()
            path.append(q.clone())
        return path


def _one_step(cfg: PotentialFieldConfig, a, b, valid, q, goal):
    """One normalized gradient-descent step from ``q`` over the (P, V)
    edges ``a`` → ``b`` (``valid`` masks the padding)."""
    d_edge = min_dist_segment_point(a, b, q)                      # (P, V)
    d_edge = torch.where(valid, d_edge, torch.inf)
    j = torch.argmin(d_edge, dim=1, keepdim=True)                 # (P, 1)
    dmin = torch.gather(d_edge, 1, j)[:, 0]                       # (P,)
    jj = j[..., None].expand(-1, -1, 2)
    aj = torch.gather(a, 1, jj)[:, 0]                             # (P, 2)
    e = torch.gather(b, 1, jj)[:, 0] - aj
    # Closest boundary point (clamped projection on edge j).
    num = (q - aj)[:, 0] * e[:, 0] + (q - aj)[:, 1] * e[:, 1]
    den = torch.clamp(e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1], min=1e-12)
    u = torch.clamp(num / den, 0.0, 1.0)
    q0 = aj + u[:, None] * e
    # Repulsive gradient (ref: repulsiveGradient :320-341); the shipped
    # 1/d² factor reduces to 1. Weights divide as tensors: torch takes
    # ``scalar / tensor`` as a reciprocal times the scalar.
    active = dmin <= cfg.qthresh
    denom = torch.clamp(dmin, min=1e-9)
    w = torch.full_like(dmin, cfg.w_rep) / torch.clamp(cfg.qthresh - dmin,
                                                       min=1e-9)
    g = (q0 - q) / denom[:, None] * w[:, None]
    u_rep = torch.sum(torch.where(active[:, None], g, 0.0), dim=0)

    dg = torch.linalg.vector_norm(q - goal)
    u_att = cfg.w_att * (q - goal)
    u_att = torch.where(dg > cfg.dthresh,
                        u_att * cfg.dthresh / torch.clamp(dg, min=1e-12),
                        u_att)

    grad = u_rep + u_att
    dn = grad / torch.clamp(torch.linalg.vector_norm(grad), min=1e-12)
    return q - cfg.step * dn
