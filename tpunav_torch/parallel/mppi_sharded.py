"""MPPI with the rollout axis K sharded over the ranks of a process group.

Port of ``tpunav/parallel/mppi_sharded.py``. Each rank rolls out K/S
trajectories and the per-step softmax-weighted control update is reduced
across the shards; every rank ends with the same controls.

- :func:`mppi_solve_sharded`, the plain path: the global row-min of the
  cost-to-go is one MIN all-reduce, and the softmax's (numerator,
  denominator) pair is ONE fused SUM all-reduce of an (N, 3) tensor, as
  :func:`tpunav_torch.control.mppi.mppi_solve` computes it on one device.
- :func:`mppi_solve_fused_sharded`, the kernel path: each rank runs kernel
  K1 in its partials mode (``ops.fused_mppi.mppi_solve_partials``, two
  launches) at K/S and the merged (N, 6) partials are recombined across
  the shards by ``ops.fused_mppi.combine_softmax_partials`` with one MIN
  and one SUM all-reduce, the algebra the kernel's own combine runs over
  its blocks.

Noise: the plain path draws (K/S, N, 2) from the rank's generator or takes
it injected; the kernel path draws in-kernel Philox from a per-shard seed
(:func:`shard_seed`, ``tpunav``'s golden-ratio stride, shard 0 keeping the
caller's seed) or takes this rank's (N, K/S, 2) slice injected.

:class:`FusedShardedStepper` and :class:`PlainShardedStepper` are the
counterpart of ``tpunav``'s jitted sharded solves
(``tpunav/parallel/mppi_sharded.py:127,151``): each solve is one
``capture.Graph`` replay of the functions above on static tensors, the
collectives included. The fused stepper keeps the caller's seed in a
device int32 that the body advances, so a chain of solves takes the eager
chain's seeds; the plain one draws the rank's perturbations eagerly into
a static tensor before each replay, with :func:`sample_perturbations`'
call. A graph captures NCCL collectives and the one-shard identity's, not
a host-staged (gloo on CUDA) mesh's: the steppers raise on one, and the
eager functions stay the way to run gloo ranks on one card.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from .. import capture
from ..control.mppi import (MPPIConfig, cost_to_go, rollout_losses,
                            sample_perturbations, shift_controls)
from ..device import DEFAULT_DEVICE
from ..models.cart import CartParams
from ..ops import fused_mppi
from .mesh import ShardMesh, capturable

_SEED_STRIDE = -0x61C88647      # tpunav's int32 golden-ratio stride


def _wrap_int32(v):
    """``v`` (a Python int, or an int64 tensor) wrapped to int32's range,
    as int32 arithmetic wraps."""
    v = (v + (1 << 31)) % (1 << 32) - (1 << 31)
    return v.to(torch.int32) if isinstance(v, torch.Tensor) else v


def shard_seed(seed, index: int):
    """The in-kernel seed of shard ``index``: ``seed + index·(−0x61C88647)``
    wrapped to int32 (``tpunav/parallel/mppi_sharded.py:118``), so shard 0
    keeps ``seed``. ``seed`` is an int or an integer tensor (the result is
    then an int32 tensor on its device); the sum is formed in Python or
    int64 and wrapped explicitly."""
    if isinstance(seed, torch.Tensor):
        return _wrap_int32(seed.to(torch.int64) + index * _SEED_STRIDE)
    return _wrap_int32(int(seed) + index * _SEED_STRIDE)


def _local_config(cfg: MPPIConfig, mesh: ShardMesh) -> MPPIConfig:
    if cfg.rollouts % mesh.size != 0:
        raise ValueError(
            f"rollouts={cfg.rollouts} not divisible by axis "
            f"'{mesh.axis_name}' size {mesh.size}")
    return dataclasses.replace(cfg, rollouts=cfg.rollouts // mesh.size)


def mppi_solve_sharded(cfg: MPPIConfig, model: CartParams, mesh: ShardMesh):
    """The plain K-sharded solve: returns ``solve(u, generator_or_noise,
    pose_xyt, xd) -> (cmd (2,), u_next (N, 2))``.

    ``cfg.rollouts`` is the total K and must split evenly over the shards.
    ``generator_or_noise``: this rank's ``torch.Generator`` (it draws the
    rank's K/S rollouts) or this rank's (K/S, N, 2) perturbations. u, pose
    and xd are the same on every rank, and so are the results.
    """
    local = _local_config(cfg, mesh)

    def solve(u, generator_or_noise, pose_xyt, xd):
        noise = generator_or_noise
        if isinstance(noise, torch.Generator):
            noise = sample_perturbations(local, noise, dtype=u.dtype,
                                         device=u.device)
        loss, _ = rollout_losses(local, model, pose_xyt, u[None] + noise, xd)
        j = cost_to_go(loss)                                  # (N, K/S)
        row_min = mesh.min_(torch.amin(j, dim=1))             # (N,)
        w = torch.exp(-(j - row_min[:, None]) / cfg.lambda_) + 1e-8
        # The numerator (N, 2) and the denominator (N, 1) in ONE reduction.
        red = mesh.sum_(torch.cat([torch.einsum("nk,knc->nc", w, noise),
                                   torch.sum(w, dim=1, keepdim=True)],
                                  dim=1))                     # (N, 3)
        u_new = torch.clamp(u + red[:, :2] / red[:, 2:3],
                            -cfg.max_wheel_vel, cfg.max_wheel_vel)
        return u_new[0], shift_controls(cfg, u_new)

    return solve


def mppi_solve_fused_sharded(cfg: MPPIConfig, model: CartParams,
                             mesh: ShardMesh, obstacles=None, obs_cfg=None):
    """The K-sharded solve through kernel K1's partials: returns
    ``solve(u, seed, pose_xyt, xd, noise=None) -> (cmd, u_next)``.

    ``seed``: the caller's int32 seed (an int or a 0-dim integer tensor);
    this rank draws in-kernel Philox from :func:`shard_seed`. ``noise``:
    this rank's (N, K/S, 2) time-major slice of the perturbations, in place
    of the draw. ``obstacles`` with ``obs_cfg`` add K1's obstacle cost, as
    in ``mppi_solve_fused``; their table is packed here, once, on the
    mesh's device, so a solve makes no host copy. ``cfg.rollouts`` is the
    total K and must split evenly over the shards.
    """
    local = _local_config(cfg, mesh)
    table = fused_mppi.pack_obstacles(obstacles, obs_cfg, mesh.device)

    def solve(u, seed, pose_xyt, xd, noise=None):
        part = fused_mppi._solve_update(
            local, model, u, shard_seed(seed, mesh.index), pose_xyt, xd,
            noise, table, partial_out=True)                     # (N, 6)
        return fused_mppi.combine_softmax_partials(
            cfg, u, part, min_fn=mesh.min_, sum_fn=mesh.sum_)

    return solve


class _ShardedSolveGraph:
    """The static tensors of a graphed sharded solve on a capturable mesh:
    the controls ``u`` (a copy of the caller's, on ``device`` and the
    mesh's device), the pose, the waypoint and the command ``cmd``."""

    def __init__(self, mesh: ShardMesh, u, device):
        capturable(mesh)
        dev = capture.state_device(u, device)
        capture.state_device(u, mesh.device)
        like = dict(dtype=u.dtype, device=dev)
        self.u = u.clone()
        self.pose = torch.zeros(3, **like)
        self.xd = torch.zeros(3, **like)
        self.cmd = torch.zeros(2, **like)

    def _capture(self, run) -> None:
        """The graph of ``run(u, pose, xd) -> (cmd, u_next)`` on the
        buffers; the controls advance in place."""
        # The body holds the buffers, not self: a graph whose stepper is
        # dropped is freed at once, not by the cyclic collector.
        u, pose, xd, cmd = self.u, self.pose, self.xd, self.cmd

        def body():
            c, u_next = run(u, pose, xd)
            cmd.copy_(c)
            u.copy_(u_next)

        self.graph = capture.Graph(body, u.device, error_mode="thread_local")

    def _solve(self, pose_xyt, xd):
        capture.load((self.pose, self.xd),
                     (torch.as_tensor(pose_xyt, dtype=self.u.dtype),
                      torch.as_tensor(xd, dtype=self.u.dtype)))
        self.graph()
        return self.cmd, self.u


class FusedShardedStepper(_ShardedSolveGraph):
    """:func:`mppi_solve_fused_sharded` as one ``capture.Graph`` replay per
    solve: K1's partials at K/S, the MIN and SUM across the shards and the
    update, on static tensors on ``device`` (default the card; raises
    without CUDA; ``u`` must lie there, on the mesh's device).

    ``seed`` (the first solve's caller seed, an int) lives in the device
    int32 :attr:`seed`, which each solve passes through :func:`shard_seed`
    and then advances by one: solves 7, 8, … as the eager chain calls
    them. With ``injected`` each solve takes this rank's (N, K/S, 2)
    perturbations (``noise=``) into a static tensor, in place of the
    in-kernel draw. ``obstacles`` and ``obs_cfg`` as in
    :func:`mppi_solve_fused_sharded`. Raises on a host-staged mesh."""

    def __init__(self, cfg: MPPIConfig, model: CartParams, mesh: ShardMesh,
                 u, seed: int, obstacles=None, obs_cfg=None,
                 injected: bool = False, device=DEFAULT_DEVICE):
        super().__init__(mesh, u, device)
        solve = mppi_solve_fused_sharded(cfg, model, mesh, obstacles,
                                         obs_cfg)
        local = _local_config(cfg, mesh)
        seed_t = self.seed = torch.full((), seed, dtype=torch.int32,
                                        device=u.device)
        noise = self.noise = (torch.zeros(
            (local.steps, local.rollouts, 2), dtype=u.dtype,
            device=u.device) if injected else None)

        def run(u_, pose, xd):
            out = solve(u_, seed_t, pose, xd, noise)
            seed_t.add_(1)
            return out

        self._capture(run)

    def step(self, pose_xyt, xd, noise: Optional[torch.Tensor] = None):
        """One solve from the (3,) pose toward the (3,) waypoint; returns
        the static (cmd (2,), u (N, 2)), which the next solve overwrites.
        ``noise``: this rank's (N, K/S, 2) perturbations (``injected``
        only)."""
        if (noise is None) != (self.noise is None):
            raise ValueError("noise= goes with injected=True, and only so")
        if noise is not None:
            self.noise.copy_(noise)
        return self._solve(pose_xyt, xd)


class PlainShardedStepper(_ShardedSolveGraph):
    """:func:`mppi_solve_sharded` as one ``capture.Graph`` replay per
    solve, on static tensors on ``device`` (default the card; raises
    without CUDA; ``u`` must lie there, on the mesh's device). Each solve
    draws this rank's (K/S, N, 2) perturbations from ``generator`` eagerly
    into a static tensor (``draw(noise=None)``, a ``capture.Draws``: the
    eager solve's call, so its bits), or takes them injected. Raises on a
    host-staged mesh."""

    def __init__(self, cfg: MPPIConfig, model: CartParams, mesh: ShardMesh,
                 u, generator: torch.Generator, device=DEFAULT_DEVICE):
        super().__init__(mesh, u, device)
        solve = mppi_solve_sharded(cfg, model, mesh)
        self.local = _local_config(cfg, mesh)
        self.generator = generator
        noise = self.noise = torch.zeros(
            (self.local.rollouts, self.local.steps, 2), dtype=u.dtype,
            device=u.device)
        self._capture(lambda u_, pose, xd: solve(u_, noise, pose, xd))
        self.draw = capture.Draws(self.graph, noise).add(
            noise, generator,
            functools.partial(sample_perturbations, self.local))

    def step(self, pose_xyt, xd, noise: Optional[torch.Tensor] = None):
        """One solve from the (3,) pose toward the (3,) waypoint; returns
        the static (cmd (2,), u (N, 2)), which the next solve
        overwrites."""
        self.draw(noise)
        return self._solve(pose_xyt, xd)
