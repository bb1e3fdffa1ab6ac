"""Carries configuration and state across from ``tpunav``, as numpy.

No counterpart in ``tpunav``. No path has weights: their parameters are
the configurations (``MPPIConfig``, ``CartParams``, ``MotorParams``,
``CourseConfig``; ``SegmentCostParams`` and ``ObstacleCostConfig``;
``PFConfig`` with its ``GridConfig`` and ``ICPConfig``; ``EKFConfig``,
``SlamLoopConfig`` and ``LandmarkConfig`` with its ``LaserProps``) and
their state is ``CourseState``, ``PFState``, ``EKFState``,
``SlamLoopState`` or a planner's ``RoadMap``; a ``PFState`` also goes to
and from the shards of a process group. Nothing here imports jax:
the caller hands over plain dicts and numpy arrays.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict

import numpy as np
import torch

from .control.slam_loop import SlamLoopState
from .control.waypoint_loop import CourseState
from .device import DEFAULT_DEVICE, resolve
from .estimation.ekf.filter import EKFState
from .estimation.rbpf.particle_filter import PARTICLE_LEAVES, PFState
from .parallel.mesh import ShardMesh
from .planning.prm import RoadMap
from .planning.world import ObstacleMap

_STATE_DTYPES = {"pose": torch.float32, "u": torch.float32,
                 "wpt_idx": torch.int32, "visits": torch.int32,
                 "ticks": torch.int32, "done": torch.bool,
                 "wheel_vel": torch.float32}
_PF_DTYPES = {"poses": torch.float32, "prev_poses": torch.float32,
              "log_weights": torch.float32, "grids": torch.float32,
              "dists": torch.float32, "prev_scan": torch.float32,
              "has_prev": torch.bool}
_SLAM_DTYPES = {"true_pose": torch.float32, "odom": torch.float32,
                "u": torch.float32, "wpt_idx": torch.int32,
                "visits": torch.int32, "ticks": torch.int32,
                "done": torch.bool}


def config_from_fields(cls, fields: Dict[str, Any]):
    """Build one of the port's configurations from the fields of its
    ``tpunav`` twin: ``dataclasses.asdict(cfg)`` for a dataclass, or
    ``params._asdict()`` for a NamedTuple. Nested dataclass fields given
    as dicts (``CourseConfig.motor``, ``PFConfig.grid``, ``PFConfig.icp``
    and ``LandmarkConfig.props``) are built recursively."""
    if not dataclasses.is_dataclass(cls):
        return cls(**fields)
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for name, val in fields.items():
        sub = hints.get(name)
        if isinstance(val, dict) and dataclasses.is_dataclass(sub):
            val = config_from_fields(sub, val)
        elif isinstance(val, list):
            val = tuple(val)
        kwargs[name] = val
    return cls(**kwargs)


def course_state_from_numpy(d: Dict[str, Any], device=DEFAULT_DEVICE,
                            seed: int = 0) -> CourseState:
    """A ``CourseState`` from numpy arrays {pose, u, wpt_idx, visits, ticks,
    done, wheel_vel}. The jax PRNG key has no counterpart: the port's state
    gets a fresh ``torch.Generator`` seeded with ``seed``."""
    device = resolve(device)
    t = {name: torch.as_tensor(np.array(d[name]), device=device).to(dtype)
         for name, dtype in _STATE_DTYPES.items()}
    gen = torch.Generator(device=t["pose"].device)
    gen.manual_seed(seed)
    return CourseState(seed=seed, generator=gen, **t)


def course_state_to_numpy(st: CourseState) -> Dict[str, np.ndarray]:
    """The tensors of a ``CourseState`` as numpy arrays (the generator and
    its seed stay behind)."""
    return {name: getattr(st, name).detach().cpu().numpy()
            for name in _STATE_DTYPES}


def pf_state_from_numpy(d: Dict[str, Any], device=DEFAULT_DEVICE,
                        seed: int = 0) -> PFState:
    """A ``PFState`` from numpy arrays {poses, prev_poses, log_weights,
    grids, dists, prev_scan, has_prev}, as float32 (bool for has_prev).
    The jax PRNG key has no counterpart: the port's state gets a fresh
    ``torch.Generator`` seeded with ``seed``."""
    device = resolve(device)
    t = {name: torch.as_tensor(np.array(d[name]), device=device).to(dtype)
         for name, dtype in _PF_DTYPES.items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return PFState(generator=gen, **t)


def pf_state_to_numpy(st: PFState) -> Dict[str, np.ndarray]:
    """The tensors of a ``PFState`` as numpy arrays (the generator stays
    behind)."""
    return {name: getattr(st, name).detach().cpu().numpy()
            for name in _PF_DTYPES}


def pf_state_shard_from_numpy(d: Dict[str, Any], mesh: ShardMesh,
                              device=DEFAULT_DEVICE,
                              seed: int = 0) -> PFState:
    """This rank's shard of a ``PFState`` given whole as numpy (the arrays
    of :func:`pf_state_from_numpy`, P particles): its P/S rows of the
    particle leaves, the previous scan and the flag replicated, the state
    ``parallel.pf_slam_step_sharded`` takes."""
    p = np.asarray(d["poses"]).shape[0]
    if p % mesh.size != 0:
        raise ValueError(f"{p} particles not divisible by {mesh.size} shards")
    rows = slice(mesh.index * p // mesh.size,
                 (mesh.index + 1) * p // mesh.size)
    return pf_state_from_numpy(
        {name: np.asarray(d[name])[rows] if name in PARTICLE_LEAVES
         else d[name] for name in _PF_DTYPES}, device, seed)


def pf_state_gather_to_numpy(st: PFState,
                             mesh: ShardMesh) -> Dict[str, np.ndarray]:
    """The whole state of a sharded ``PFState`` as numpy arrays, the
    particle leaves gathered over ``mesh`` (a collective: every rank
    calls it, and every rank gets the whole state)."""
    return {name: (mesh.all_gather(getattr(st, name))
                   if name in PARTICLE_LEAVES else getattr(st, name)
                   ).detach().cpu().numpy() for name in _PF_DTYPES}


def roadmap_from_numpy(obs_map: ObstacleMap, nodes, k_neighbors: int = 10,
                       clearance: float = 0.15) -> RoadMap:
    """A ``RoadMap`` over the given (n, 2) node positions (``tpunav``'s
    sampled ``RoadMap.nodes``, say), connected by the port's own
    k-nearest-neighbour, collision-checked edges. The port draws its nodes
    from a ``torch.Generator``, so this is how a roadmap is carried
    across."""
    rm = RoadMap.__new__(RoadMap)
    rm._setup(obs_map, k_neighbors, clearance)
    rm._build(np.asarray(nodes, np.float64))
    return rm


def _tensor(value, dtype, device):
    return torch.as_tensor(np.array(value)).to(device=device, dtype=dtype)


def ekf_state_from_numpy(d: Dict[str, Any], dtype: torch.dtype,
                         device=DEFAULT_DEVICE) -> EKFState:
    """An ``EKFState`` from numpy arrays {state, cov, active, count}: state
    and covariance as ``dtype`` (float64 is ``ekf_init``'s default,
    float32 the slam loop's filter), active as bool, count as int32."""
    device = resolve(device)
    return EKFState(state=_tensor(d["state"], dtype, device),
                    cov=_tensor(d["cov"], dtype, device),
                    active=_tensor(d["active"], torch.bool, device),
                    count=_tensor(d["count"], torch.int32, device))


def ekf_state_to_numpy(st: EKFState) -> Dict[str, np.ndarray]:
    """The tensors of an ``EKFState`` as numpy arrays, dtypes kept."""
    return {name: getattr(st, name).detach().cpu().numpy()
            for name in EKFState._fields}


def slam_loop_state_from_numpy(d: Dict[str, Any], device=DEFAULT_DEVICE,
                               seed: int = 0) -> SlamLoopState:
    """A ``SlamLoopState`` from numpy arrays {true_pose, odom, u, wpt_idx,
    visits, ticks, done} and ``ekf``, a dict for
    :func:`ekf_state_from_numpy` (float32, the loop's filter). The jax PRNG
    key has no counterpart: the port's state gets a fresh
    ``torch.Generator`` seeded with ``seed``."""
    device = resolve(device)
    t = {name: _tensor(d[name], dtype, device)
         for name, dtype in _SLAM_DTYPES.items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return SlamLoopState(
        ekf=ekf_state_from_numpy(d["ekf"], torch.float32, device),
        generator=gen, host_ticks=int(np.array(d["ticks"])), **t)


def slam_loop_state_to_numpy(st: SlamLoopState) -> Dict[str, Any]:
    """The tensors of a ``SlamLoopState`` as numpy arrays, with ``ekf`` a
    dict of its own (the generator and the host tick count stay
    behind)."""
    out = {name: getattr(st, name).detach().cpu().numpy()
           for name in _SLAM_DTYPES}
    out["ekf"] = ekf_state_to_numpy(st.ekf)
    return out
