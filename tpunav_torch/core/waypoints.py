"""Waypoint-following twist generators (plain functions over tensors).

Port of ``tpunav/core/waypoints.py`` (the reference's ``rigid2d::Waypoints``,
rigid2d/include/rigid2d/waypoints.hpp:16-66,
rigid2d/src/rigid2d/waypoints.cpp). The bookkeeping the C++ class mutates
(idx, ctr, cycle_complete) is a ``WaypointState`` of device tensors,
advanced with ``torch.where`` and a device index, so a controller step
makes no host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import DEFAULT_DEVICE, resolve
from .angles import normalize_angle_pi


class WaypointParams(NamedTuple):
    pts: torch.Tensor        # (M, 2) waypoint coordinates
    rot_vel: torch.Tensor    # max |w|
    trans_vel: torch.Tensor  # forward speed
    k_rot: torch.Tensor      # P gain for closed-loop heading control
    htol: torch.Tensor       # heading tolerance (ref: waypoints.cpp:18)
    ptol: torch.Tensor       # position tolerance (ref: waypoints.cpp:19)


def make_params(pts, rot_vel, trans_vel, k_rot=0.0, htol=0.02, ptol=0.025,
                dtype=torch.float32, device=DEFAULT_DEVICE) -> WaypointParams:
    device = resolve(device)

    def f(v):
        return torch.as_tensor(v, dtype=dtype).to(device, non_blocking=True)

    return WaypointParams(f(pts), f(rot_vel), f(trans_vel), f(k_rot),
                          f(htol), f(ptol))


class WaypointState(NamedTuple):
    idx: torch.Tensor             # int32 current goal index
    ctr: torch.Tensor             # int32 waypoints visited this cycle
    cycle_complete: torch.Tensor  # bool


def init_state(device=DEFAULT_DEVICE) -> WaypointState:
    """Goal 0, nothing visited, on ``device`` (default the CUDA card)."""
    device = resolve(device)
    i32 = dict(dtype=torch.int32, device=device)
    return WaypointState(idx=torch.zeros((), **i32),
                         ctr=torch.zeros((), **i32),
                         cycle_complete=torch.zeros((), dtype=torch.bool,
                                                    device=device))


def _goal(params: WaypointParams, state: WaypointState):
    """pts[idx] through a device index (no host read of idx)."""
    return torch.index_select(params.pts, 0, state.idx.reshape(1))[0]


def _advance_if_reached(params: WaypointParams, state: WaypointState, pose):
    """Goal-reached check + cyclic increment
    (ref: Waypoints::waypointReached/incrementWaypoint waypoints.cpp:112-142).
    """
    n = params.pts.shape[0]
    goal = _goal(params, state)
    d = torch.linalg.vector_norm(goal - pose[..., 1:3], dim=-1)
    reached = d < params.ptol
    idx = torch.where(reached, (state.idx + 1) % n, state.idx)
    ctr = torch.where(reached, state.ctr + 1, state.ctr)
    done = torch.logical_or(state.cycle_complete, ctr == n + 1)
    return WaypointState(idx=idx, ctr=ctr, cycle_complete=done)


def _heading_error(params: WaypointParams, state: WaypointState, pose):
    goal = _goal(params, state)
    bearing = torch.atan2(goal[1] - pose[..., 2], goal[0] - pose[..., 1])
    return normalize_angle_pi(bearing - pose[..., 0])


def _twist(w, vx):
    return torch.stack([w, vx, torch.zeros_like(vx)], dim=-1)


def next_waypoint(params: WaypointParams, state: WaypointState, pose):
    """Bang-bang turn-then-drive controller
    (ref: Waypoints::nextWaypoint waypoints.cpp:35-67).
    Returns (cmd twist [w, vx, 0], new_state)."""
    state = _advance_if_reached(params, state, pose)
    h_err = _heading_error(params, state, pose)
    aligned = torch.abs(h_err) < params.htol
    zero = torch.zeros_like(h_err)
    w = torch.where(aligned, zero,
                    torch.where(h_err > 0, params.rot_vel, -params.rot_vel))
    vx = torch.where(aligned, params.trans_vel, zero)
    return _twist(w, vx), state


def next_waypoint_closed_loop(params: WaypointParams, state: WaypointState,
                              pose):
    """P-controlled heading, stop after one full cycle
    (ref: Waypoints::nextWaypointClosedLoop waypoints.cpp:70-108)."""
    state = _advance_if_reached(params, state, pose)
    h_err = _heading_error(params, state, pose)
    aligned = torch.abs(h_err) < params.htol
    zero = torch.zeros_like(h_err)
    w = torch.where(aligned, zero,
                    torch.clamp(params.k_rot * h_err, -params.rot_vel,
                                params.rot_vel))
    vx = torch.where(aligned, params.trans_vel, zero)
    stop = state.cycle_complete
    w = torch.where(stop, zero, w)
    vx = torch.where(stop, zero, vx)
    return _twist(w, vx), state
