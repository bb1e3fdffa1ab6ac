"""What the waypoint course (``waypoint_loop.py``) and the SLAM loop
(``slam_loop.py``) share: the tick's waypoint advance and solve, and
:class:`ChunkRunner`, which replays a chunk of either loop's ticks as one
CUDA graph. No counterpart module in ``tpunav``, where each loop is one
device program.
"""

from __future__ import annotations

import functools

import torch

from .. import capture
# A module import: ops.fused_mppi imports control.mppi, so a name import
# here would fail when ops.fused_mppi is imported first.
from ..ops import fused_mppi
from .mppi import mppi_solve, sample_perturbations


def active_waypoint(waypoints, idx):
    """waypoints[idx] through a device index (no host read of idx)."""
    return torch.index_select(waypoints, 0, idx.reshape(1))[0]


def advance(cfg, waypoints, pose, st):
    """A tick's waypoint advance from ``pose`` ([x, y, ...]) and the
    state's ``wpt_idx``, ``visits`` and ``done``: on arrival within
    ``cfg.goal_thresh`` the index moves on, cyclic, and the course is done
    after ``cfg.cycles`` passes. Returns (the waypoint to steer to,
    wpt_idx, visits, done)."""
    n_wpts = waypoints.shape[0]
    wpt = active_waypoint(waypoints, st.wpt_idx)
    arrived = torch.hypot(pose[0] - wpt[0],
                          pose[1] - wpt[1]) < cfg.goal_thresh
    visits = st.visits + arrived.to(torch.int32)
    wpt_idx = torch.where(arrived, (st.wpt_idx + 1) % n_wpts, st.wpt_idx)
    done = torch.logical_or(st.done, visits >= cfg.cycles * n_wpts)
    return active_waypoint(waypoints, wpt_idx), wpt_idx, visits, done


def solve(mppi_cfg, cfg, model, st, pose, wpt, noise=None, hold=None,
          extra_cost=None, table=None):
    """A tick's MPPI solve from ``pose`` ([x, y, θ]) toward ``wpt``, on the
    state's controls: with ``cfg.use_fused`` K1, its Philox keyed by
    ``cfg.fused_seed`` + the state's device tick count, ``hold`` its
    held-tick flag and ``table`` its packed obstacles; else the plain
    solver, drawing from the state's generator, with ``extra_cost``.
    ``noise``: (N, K, 2) perturbations in place of either's draw. Returns
    (wheel command, shifted controls)."""
    if cfg.use_fused:
        seed = cfg.fused_seed + st.ticks              # int32, on the device
        return fused_mppi.mppi_solve_fused_packed(
            mppi_cfg, model, st.u, seed, pose, wpt, noise, table, hold)
    return mppi_solve(mppi_cfg, model, st.u, st.generator, pose, wpt,
                      extra_cost, noise=None if noise is None
                      else noise.transpose(0, 1))


def map_fields(fields, fn, *states) -> dict:
    """``fn`` over the named ``fields`` of ``states`` (each a tensor or a
    tuple of tensors), as keyword arguments for ``_replace``."""
    out = {}
    for f in fields:
        first, *rest = (getattr(s, f) for s in states)
        out[f] = (fn(first, *rest) if isinstance(first, torch.Tensor) else
                  type(first)(*map(fn, first, *rest)))
    return out


def clone(st, fields):
    """``st`` with the tensors of ``fields`` copied (the rest shared)."""
    return st._replace(**map_fields(fields, torch.clone, st))


class ChunkRunner:
    """``chunk`` ticks of a loop on static state buffers (a copy of
    ``st``'s ``fields``, each a tensor or a tuple of tensors; the other
    fields, such as the generator, shared) as one ``capture.Graph`` step.

    ``tick(s, i, hold, noise) -> (state, row)`` is the chunk's tick
    ``i``: ``hold`` its held-tick flag for K1 (a device bool) or None,
    ``noise`` its (N, K, 2) MPPI perturbations or None, ``row`` a dict of
    telemetry tensors, stacked along a new first axis into the buffer of
    its key in ``tel``. The draws (:attr:`draws`, a ``capture.Draws``) are
    made before each step in the eager ticks' order: with ``mppi_cfg``
    (the plain backend) tick i's (K, N, 2) perturbations into
    ``perturb[i]`` from the state's generator, as ``mppi_solve`` draws
    them, then the ``(tensor, generator[, fill])`` slots of ``slots(i)``.
    Injected noise is loaded into ``perturb`` in their place.

    With ``bound`` (an int) the ticks are held: a tick whose incoming
    state is done or at ``bound`` device ticks keeps every field
    (``tpunav``'s ``while_loop`` runs no such tick; its row is its own),
    and on the fused backend K1 returns at once (the launch is still
    counted). With ``status`` each step writes [done, ticks], which
    :meth:`step` reads: the one host read a chunk."""

    def __init__(self, st, fields, tick, chunk: int, mppi_cfg=None,
                 bound=None, slots=None, tel=None, status: bool = False):
        dev = st.ticks.device
        perturb = self.perturb = (None if mppi_cfg is None else torch.zeros(
            (chunk, mppi_cfg.rollouts, mppi_cfg.steps, 2), dtype=st.u.dtype,
            device=dev))
        # The body holds the buffers, not self: a graph whose runner is
        # dropped is freed at once, not by the cyclic collector.
        state = self.state = clone(st, fields)
        status_buf = self.status = (torch.empty(2, dtype=torch.int32,
                                                device=dev)
                                    if status else None)
        self.tel, self.chunk, self.bound = tel, chunk, bound

        def kept(hold):
            return lambda a, b: torch.where(hold, a, b)

        def body():
            s, rows = state, []
            for i in range(chunk):
                hold = (None if bound is None else
                        torch.logical_or(s.done, s.ticks >= bound))
                # The (N, K, 2) layout of the fused seam.
                new, row = tick(s, i, hold, None if perturb is None
                                else perturb[i].transpose(0, 1))
                s = (new if hold is None else
                     new._replace(**map_fields(fields, kept(hold), s, new)))
                rows.append(row)
            # Row 0 may be the state buffer itself: stack before it is
            # written.
            if tel is not None:
                for name, buf in tel.items():
                    buf.copy_(torch.stack([r[name] for r in rows]))
            map_fields(fields, torch.Tensor.copy_, state, s)
            if status_buf is not None:
                status_buf.copy_(torch.stack([s.done.to(torch.int32),
                                              s.ticks]))

        self.graph = capture.Graph(body, dev)
        self.draws = capture.Draws(self.graph, perturb)
        # _ends[n]: the slots of the chunk's first n ticks.
        self._ends = [0]
        for i in range(chunk):
            if perturb is not None:
                self.draws.add(perturb[i], st.generator, functools.partial(
                    sample_perturbations, mppi_cfg))
            for slot in (() if slots is None else slots(i)):
                self.draws.add(*slot)
            self._ends.append(len(self.draws.slots))
        self.ticks = int(st.ticks) if status else None

    def run(self, noise=None) -> None:
        """Make the chunk's draws (or load ``noise``, its (chunk, K, N, 2)
        perturbations) and replay it, with no host read."""
        self.draws(noise)
        self.graph()

    def step(self, limit=None, noise=None) -> bool:
        """:meth:`run`, then the status read: True once the state is done
        or at ``limit`` device ticks (default ``bound``). :attr:`ticks` is
        then the device tick count after the step."""
        limit = self.bound if limit is None else limit
        self._began = self.ticks
        self.run(noise)
        done, self.ticks = self.status.tolist()
        return bool(done) or self.ticks >= limit

    def rewind(self) -> None:
        """The generators set back to where the last step began, and the
        draws of its live ticks (those it counted) made again: where an
        eager loop that stops on its last live tick leaves them."""
        self.draws.rewind(self._ends[self.ticks - self._began])
