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
"""

from __future__ import annotations

import dataclasses

import torch

from ..control.mppi import (MPPIConfig, cost_to_go, rollout_losses,
                            sample_perturbations, shift_controls)
from ..models.cart import CartParams
from ..ops.fused_mppi import combine_softmax_partials, mppi_solve_partials
from .mesh import ShardMesh

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
    in ``mppi_solve_fused``. ``cfg.rollouts`` is the total K and must split
    evenly over the shards.
    """
    local = _local_config(cfg, mesh)

    def solve(u, seed, pose_xyt, xd, noise=None):
        part = mppi_solve_partials(local, model, u,
                                   shard_seed(seed, mesh.index), pose_xyt,
                                   xd, noise=noise, obstacles=obstacles,
                                   obs_cfg=obs_cfg)              # (N, 6)
        return combine_softmax_partials(cfg, u, part, min_fn=mesh.min_,
                                        sum_fn=mesh.sum_)

    return solve
