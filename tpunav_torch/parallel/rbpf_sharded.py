"""RBPF grid SLAM with the particle axis sharded over the ranks of a
process group.

Port of ``tpunav/parallel/rbpf_sharded.py``. The particle leaves — poses
(P, 3), previous poses, log-weights (P,), grids and distance fields
(P, H, W) — are split into P/S rows per rank; the previous scan, the
has-previous flag and the generator are replicated. One update runs the
unsharded ``pf_slam_step``'s own stages
(``estimation/rbpf/particle_filter.py``) and adds only the slicing, the
gathers, the exchange and K4:

- ICP runs replicated (one scan pair, particle-independent);
- the proposal and motion-model samples of the local rows go through ONE
  launch of kernel K2 over (P/S, k+1) samples, and the map update through
  ONE launch of kernel K3 over the local grids;
- the (P,) log-weights are all-gathered, and every rank normalises them,
  takes N_eff and the systematic-resample index as the unsharded step
  does, bit for bit. ``tpunav`` normalises with MAX and SUM all-reduces
  (``:133-137``); their order of rounding differs from one device's by an
  ulp or two, and on an NVIDIA H100 80GB HBM3 (700 W limit) that flipped
  one resample draw at update 38 of config 5's course (8 mm on a
  particle's pose; ``chip_smoke.py``'s ``sharded_rbpf``). One gather of 4·P
  bytes replaces three all-reduces and keeps the sharded filter on the
  unsharded one's particles;
- poses, previous poses and grids are exchanged by one all-gather and a
  gather, with the identity index where N_eff ≥ P/2, so no rank reads
  N_eff on the host;
- the distance fields are rebuilt from the exchanged local grids with
  kernel K4 (``ops.map_update.edt_batch``). ``tpunav`` rebuilds them only
  when a resample fired (a ``lax.cond``); the port has no device-side
  branch, so K4 runs on every update. Its field is bit-identical to
  K3's on the same grids, so the result is the same either way, and the
  step stays free of host reads.

Noise: every rank draws the global :class:`PFNoise` for all P particles
from its replicated generator and keeps its own rows, the port's form of
``tpunav``'s global per-particle key table sliced per shard. A sharded run
draws what the unsharded run draws, and ``noise=`` injects the same
global normals on every rank.

:class:`ShardedPFStepper` is the counterpart of ``tpunav``'s jitted
sharded update (``tpunav/parallel/rbpf_sharded.py:221``), as
``PFStepper`` is of the unsharded one: the whole update above, its
collectives and K4 included, replayed as one CUDA graph per scan on a
state held in place. It takes an NCCL mesh or the one-shard identity and
raises on a host-staged one.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import capture
from ..device import DEFAULT_DEVICE, resolve
from ..estimation.rbpf.particle_filter import (
    PARTICLE_LEAVES, PFConfig, PFNoise, PFState, PFStepper,
    _normalize_and_index, _propose_and_integrate, draw_noise, pf_init)
from ..ops.map_update import edt_batch
from .mesh import ShardMesh, capturable


def _local_rows(cfg: PFConfig, mesh: ShardMesh) -> slice:
    if cfg.num_particles % mesh.size != 0:
        raise ValueError(f"num_particles={cfg.num_particles} not divisible "
                         f"by {mesh.size} shards")
    p_local = cfg.num_particles // mesh.size
    return slice(mesh.index * p_local, (mesh.index + 1) * p_local)


def pf_init_sharded(cfg: PFConfig, mesh: ShardMesh, pose=None, seed: int = 0,
                    dtype=torch.float32, device=DEFAULT_DEVICE) -> PFState:
    """``pf_init`` with this rank's rows of the particle leaves; the
    previous scan, the flag and the seeded generator are replicated.
    ``device`` must be the mesh's."""
    device = resolve(device)
    if device != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    rows = _local_rows(cfg, mesh)
    st = pf_init(cfg, pose=pose, seed=seed, dtype=dtype, device=device)
    return st._replace(**{name: getattr(st, name)[rows].clone()
                          for name in PARTICLE_LEAVES})


def _exchange(mesh: ShardMesh, idx, *leaves):
    """Rows ``idx`` (global particle indices) of each leaf's global
    array, through ONE all-gather of the leaves' local rows packed side by
    side."""
    p_local = leaves[0].shape[0]
    widths = [x[0].numel() for x in leaves]
    packed = torch.cat([x.reshape(p_local, -1) for x in leaves], dim=1)
    rows = mesh.all_gather(packed)[idx]
    return [part.reshape((-1,) + tuple(x.shape[1:])).contiguous()
            for part, x in zip(torch.split(rows, widths, dim=1), leaves)]


def pf_slam_step_sharded(cfg: PFConfig, mesh: ShardMesh):
    """The sharded SLAM update: returns ``step(st, ranges, u, cur_odom,
    prev_odom, noise=None) -> st`` on a state from :func:`pf_init_sharded`,
    as ``pf_slam_step`` takes its arguments. ``noise``: the global
    :class:`PFNoise` of all P particles (the same on every rank), in place
    of the draw from ``st.generator``."""
    rows = _local_rows(cfg, mesh)

    def step(st: PFState, ranges, u, cur_odom, prev_odom,
             noise: PFNoise = None) -> PFState:
        if noise is None:
            noise = draw_noise(cfg, st)
        # ICP replicated; one K2 and one K3 launch on the local rows.
        new_poses, log_weights, grids, _ = _propose_and_integrate(
            cfg, st, ranges, u, cur_odom, prev_odom, noise, rows)
        # The (P,) log-weights gathered, then normalised, N_eff and the
        # systematic-resample index formed on every rank as pf_slam_step
        # forms them (tpunav's MAX and SUM all-reduces round otherwise: see
        # the module's docstring).
        lw_all, idx = _normalize_and_index(
            cfg, mesh.all_gather(log_weights), noise.resample)
        idx = idx[rows]
        poses, prev_poses, grids = _exchange(mesh, idx, new_poses, st.poses,
                                             grids)
        return PFState(poses=poses, prev_poses=prev_poses,
                       log_weights=lw_all[idx], grids=grids,
                       dists=edt_batch(cfg.grid, grids), prev_scan=ranges,
                       has_prev=torch.ones_like(st.has_prev),
                       generator=st.generator)

    return step


class ShardedPFStepper(PFStepper):
    """:func:`pf_slam_step_sharded` captured as one CUDA graph and replayed
    once per scan: ICP, this rank's K2 and K3 launches, the log-weights'
    all-gather, the resample index, the exchange's all-gather and gather,
    and K4 over the local grids, on static tensors on ``device`` (default
    the card; raises without CUDA; ``st``, from :func:`pf_init_sharded`,
    must lie there, on the mesh's device).

    As :class:`PFStepper` (whose buffers, :meth:`draw`, :meth:`step` and
    :meth:`load` it shares): ``st`` is copied once into the stepper's
    buffers and its generator shared; each step draws the global
    :class:`PFNoise` of all P particles eagerly from the replicated
    generator (or takes it injected) and copies it and the scan's inputs
    into static tensors before the replay, so a replay gives the eager
    sharded update's bits. Raises on a host-staged mesh, whose collectives
    no graph can capture."""

    def __init__(self, cfg: PFConfig, mesh: ShardMesh, st: PFState,
                 device=DEFAULT_DEVICE):
        capturable(mesh)
        capture.state_device(st.poses, device)
        capture.state_device(st.poses, mesh.device)
        if st.poses.shape[0] * mesh.size != cfg.num_particles:
            raise ValueError(f"a state of {st.poses.shape[0]} rows is not "
                             f"this rank's share of {cfg.num_particles} "
                             f"particles over {mesh.size} shards")
        super().__init__(cfg, st, device, step_fn=pf_slam_step_sharded(
            cfg, mesh), error_mode="thread_local")
