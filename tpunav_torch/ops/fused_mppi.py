"""The fused MPPI solve (kernel K1): its wrapper and its plain version.

Port of ``tpunav/ops/pallas_mppi.py`` (``_solve_update``,
``mppi_solve_partials``, ``combine_softmax_partials``,
``mppi_solve_fused``, ``pack_obstacles``). The kernel is hand-written CUDA
for Hopper, ``csrc/fused_mppi.cu``; it replaces the Pallas kernel
``_mppi_kernel``, its obstacle mode included.
One solve is two launches: per-128-rollout blocks emit softmax partials
[m_l, Σe, Σe·z0, Σe·z1, Σz0, Σz1], and a combine kernel merges the blocks
with the rescaled-exponential algebra of :func:`combine_softmax_partials`
and applies the update. The kernel is bound by latency (N dependent RK4
steps per thread), not by bytes: its (N, K) f32 scratch is 0.8 MB at
K=4,096 and 9.8 MB at K=49,152 (N=50), inside the 50 MB L2.

A CPU tensor takes the plain version (``_solve_partials_reference`` then
``_combine_reference``, in the kernel's own decomposition); a CUDA tensor
launches the kernel, or raises. ``KERNEL_LAUNCHES`` counts kernel solves.

Noise: ``noise=None`` draws in-kernel Philox4x32-10 keyed by the seed (the
plain version replays the same stream from ``ops/philox.py``); an
injected ``noise`` is the time-major (N, K, 2) tensor, which is the TPU
kernel's (N, K/128, 128, 2) layout reshaped to (N, K, 2). Unlike the TPU
kernel, any K ≥ 1 is accepted: the ragged last block is masked.

Obstacles (BASELINE config 2): ``obstacles`` (O, 5) segment primitives
[ax, ay, bx, by, r] and ``obs_cfg`` (``control.obstacle_cost.
SegmentCostParams``) are packed by :func:`pack_obstacles` into ``tpunav``'s
(O+1, 5) table, whose last row carries the weights [r_safe, w_hit,
w_field, 1/σ, 0]. Every rollout step then pays the analytic obstacle cost
after the terminal-row overwrite, in the TPU kernel's association
(l + w_hit·hit) + w_field·e. A course packs once and calls
:func:`mppi_solve_fused_packed` each tick.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..control.mppi import MPPIConfig, shift_controls
from ..device import DEFAULT_DEVICE, resolve
from ..models.cart import CartParams
from . import philox
from ._build import check_launch, check_shared_memory, check_tensors, load

_BLOCK = 128                # rollouts per block of kernel A
KERNEL_LAUNCHES = 0         # kernel solves launched (one per solve)


class _KernelParams(ctypes.Structure):
    """Mirror of ``MppiParams`` in csrc/fused_mppi.cu."""

    _fields_ = [
        ("rollouts", ctypes.c_int), ("steps", ctypes.c_int),
        ("partial_out", ctypes.c_int), ("n_obs", ctypes.c_int),
        ("dt", ctypes.c_float), ("half_dt", ctypes.c_float),
        ("dt6", ctypes.c_float), ("w_scale", ctypes.c_float),
        ("fwd_scale", ctypes.c_float),
        ("sig0", ctypes.c_float), ("sig1", ctypes.c_float),
        ("q0", ctypes.c_float), ("q1", ctypes.c_float),
        ("q2", ctypes.c_float),
        ("r0", ctypes.c_float), ("r1", ctypes.c_float),
        ("p0", ctypes.c_float), ("p1", ctypes.c_float),
        ("p2", ctypes.c_float),
        ("inv_lambda", ctypes.c_float), ("floor_k", ctypes.c_float),
        ("max_wheel_vel", ctypes.c_float),
    ]


def _kernel_params(cfg: MPPIConfig, model: CartParams, partial_out: bool,
                   n_obs: int) -> _KernelParams:
    return _KernelParams(
        cfg.rollouts, cfg.steps, int(partial_out), n_obs,
        cfg.dt, 0.5 * cfg.dt, cfg.dt / 6.0,
        model.wheel_radius / model.wheel_base, 0.5 * model.wheel_radius,
        float(cfg.ul_var) ** 0.5, float(cfg.ur_var) ** 0.5,
        *cfg.q_diag, *cfg.r_diag, *cfg.p1_diag,
        1.0 / cfg.lambda_, 1e-8 * cfg.rollouts, cfg.max_wheel_vel)


def _check_inputs(cfg: MPPIConfig, u, seed, pose_xyt, xd, noise, table):
    n, k = cfg.steps, cfg.rollouts
    if k < 1 or n < 1:
        raise ValueError(f"need rollouts >= 1 and steps >= 1, got K={k} N={n}")
    dev = u.device
    named = [("u", u, (n, 2)), ("pose_xyt", pose_xyt, (3,)), ("xd", xd, (3,))]
    if noise is not None:
        named.append(("noise", noise, (n, k, 2)))
    if table is not None:
        if table.dim() != 2 or table.shape[0] < 1:
            raise ValueError("the obstacle table must be (O+1, 5), from "
                             "pack_obstacles")
        named.append(("obstacle table", table, (table.shape[0], 5)))
    check_tensors(named, dev)
    if seed.device != dev or seed.dtype != torch.int32 or seed.numel() != 1:
        raise ValueError("seed must be one int32 value on u's device")


# ── The plain version: the kernel's decomposition in plain torch ──


def _segment_constants(table):
    """Per segment of a packed table: a, b − a, r and inv = 1/max(|ab|²,
    1e-12), formed once as the kernel forms them per block; then the
    weights row [r_safe, w_hit, w_field, 1/σ, 0]."""
    seg = table[:-1]
    ax, ay = seg[:, 0], seg[:, 1]
    abx = seg[:, 2] - ax
    aby = seg[:, 3] - ay
    n2 = torch.clamp(abx * abx + aby * aby, min=1e-12)
    inv = torch.ones_like(n2) / n2      # tensor / tensor: a true division
    return ax, ay, abx, aby, seg[:, 4], inv, table[-1]


def _add_obstacle_cost(loss, x, y, consts):
    """loss (K,) plus the obstacle cost of the (K,) positions, in the
    kernel's order: d is the min over segments (exact, so its order does
    not matter), then (l + w_hit·hit) + w_field·exp(−(d − r_safe)·inv_σ)."""
    ax, ay, abx, aby, rr, inv, w = consts
    xo, yo = x[:, None], y[:, None]                          # (K, 1)
    tp = torch.clamp(((xo - ax) * abx + (yo - ay) * aby) * inv, 0.0, 1.0)
    px = xo - (ax + tp * abx)
    py = yo - (ay + tp * aby)
    d = torch.amin(torch.sqrt(px * px + py * py) - rr, dim=1)
    hit = (d <= w[0]).to(loss.dtype)
    return (loss + w[1] * hit) + w[2] * torch.exp(-(d - w[0]) * w[3])


def _solve_partials_reference(cfg: MPPIConfig, model: CartParams, u, seed,
                              pose_xyt, xd, noise=None, table=None):
    """Kernel A in plain torch: (blocks, N, 6) softmax partials
    [m_l, Σe, Σe·z0, Σe·z1, Σz0, Σz1] over each block of 128 rollouts, with
    the same RK4, loss and obstacle expressions as the kernel."""
    n, k = cfg.steps, cfg.rollouts
    consts = (None if table is None or table.shape[0] == 1
              else _segment_constants(table))
    if noise is None:
        noise = philox.mppi_noise(seed, k, n, float(cfg.ul_var) ** 0.5,
                                  float(cfg.ur_var) ** 0.5)
    z0, z1 = noise[..., 0], noise[..., 1]                    # (N, K)
    w_scale = model.wheel_radius / model.wheel_base
    fwd_scale = 0.5 * model.wheel_radius
    dt, half_dt, dt6 = cfg.dt, 0.5 * cfg.dt, cfg.dt / 6.0
    q0, q1, q2 = cfg.q_diag
    r0, r1 = cfg.r_diag
    p0, p1, p2 = cfg.p1_diag

    x = pose_xyt[0].expand(k)
    y = pose_xyt[1].expand(k)
    th = pose_xyt[2].expand(k)
    rows = []
    for t in range(n):
        ul = u[t, 0] + z0[t]
        ur = u[t, 1] + z1[t]
        w = w_scale * (ur - ul)
        fwd = fwd_scale * (ul + ur)
        k1x = fwd * torch.cos(th)
        k1y = fwd * torch.sin(th)
        th2 = th + half_dt * w
        k2x = fwd * torch.cos(th2)
        k2y = fwd * torch.sin(th2)
        th4 = th + dt * w
        k4x = fwd * torch.cos(th4)
        k4y = fwd * torch.sin(th4)
        x = x + dt6 * (k1x + 2.0 * (k2x + k2x) + k4x)
        y = y + dt6 * (k1y + 2.0 * (k2y + k2y) + k4y)
        th = th + dt6 * (w + 2.0 * (w + w) + w)
        ex, ey, et = x - xd[0], y - xd[1], th - xd[2]
        if t == n - 1:   # the terminal loss replaces the running loss
            row = p0 * ex * ex + p1 * ey * ey + p2 * et * et
        else:
            row = (q0 * ex * ex + q1 * ey * ey + q2 * et * et +
                   r0 * ul * ul + r1 * ur * ur)
        if consts is not None:
            row = _add_obstacle_cost(row, x, y, consts)
        rows.append(row)
    j = torch.flip(torch.cumsum(torch.flip(torch.stack(rows), (0,)), 0),
                   (0,))                                     # (N, K)

    # Per-block reductions; the ragged last block is masked (+inf for the
    # min, 0 for every sum).
    blocks = -(-k // _BLOCK)
    pad = blocks * _BLOCK - k
    j = torch.nn.functional.pad(j, (0, pad), value=float("inf"))
    z0 = torch.nn.functional.pad(z0, (0, pad)).reshape(n, blocks, _BLOCK)
    z1 = torch.nn.functional.pad(z1, (0, pad)).reshape(n, blocks, _BLOCK)
    j = j.reshape(n, blocks, _BLOCK)
    m = torch.amin(j, dim=-1, keepdim=True)
    e = torch.exp((m - j) * (1.0 / cfg.lambda_))             # 0 where masked
    part = torch.stack([m[..., 0], e.sum(-1), (e * z0).sum(-1),
                        (e * z1).sum(-1), z0.sum(-1), z1.sum(-1)], dim=-1)
    return part.transpose(0, 1).contiguous()                 # (blocks, N, 6)


def _combine_rows(cfg: MPPIConfig, part, min_fn, sum_fn):
    """Merge (..., N, 6) partials into (N, 6) rows in the same layout, with
    the merged min: each contribution rescales by exp((m_g − m_l)/λ)."""
    m_l = part[..., 0]
    m_g = min_fn(m_l)                                        # (N,)
    s = torch.exp((m_g - m_l) * (1.0 / cfg.lambda_))
    red = sum_fn(torch.cat([s[..., None] * part[..., 1:4], part[..., 4:6]],
                           dim=-1))                          # (N, 5)
    return torch.cat([m_g[:, None], red], dim=-1)


def _apply_rows(cfg: MPPIConfig, u, rows):
    """The softmax update from merged rows: w = e + 1e-8 over all K gives
    Σw = Σe + 1e-8·K and Σw·z = Σe·z + 1e-8·Σz; then clamp."""
    denom = rows[:, 1] + 1e-8 * cfg.rollouts
    du0 = (rows[:, 2] + 1e-8 * rows[:, 4]) / denom
    du1 = (rows[:, 3] + 1e-8 * rows[:, 5]) / denom
    u_new = u + torch.stack([du0, du1], dim=1)
    return torch.clamp(u_new, -cfg.max_wheel_vel, cfg.max_wheel_vel)


def _combine_reference(cfg: MPPIConfig, u, parts, partial_out: bool):
    """Kernel B in plain torch: (blocks, N, 6) partials → u_new (N, 2), or
    the merged (N, 6) partials with ``partial_out``."""
    rows = _combine_rows(cfg, parts, lambda m: torch.amin(m, dim=0),
                         lambda v: torch.sum(v, dim=0))
    return rows if partial_out else _apply_rows(cfg, u, rows)


# ── The kernel ──


def _launch(cfg: MPPIConfig, model: CartParams, u, seed, pose_xyt, xd,
            noise, table, partial_out: bool):
    global KERNEL_LAUNCHES
    lib = load()
    n, k = cfg.steps, cfg.rollouts
    n_obs = 0 if table is None else table.shape[0] - 1
    if n_obs:
        check_shared_memory(lib, 4 * (6 * n_obs + 4), "the obstacle table")
    blocks = -(-k // _BLOCK)
    scratch = torch.empty((n, k), dtype=torch.float32, device=u.device)
    parts = torch.empty((blocks, n, 6), dtype=torch.float32, device=u.device)
    out = torch.empty((n, 6 if partial_out else 2), dtype=torch.float32,
                      device=u.device)
    params = _kernel_params(cfg, model, partial_out, n_obs)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tpunav_mppi_solve(
            ctypes.addressof(params), u.data_ptr(), pose_xyt.data_ptr(),
            xd.data_ptr(), seed.data_ptr(),
            None if noise is None else noise.data_ptr(),
            table.data_ptr() if n_obs else None,
            scratch.data_ptr(), parts.data_ptr(), out.data_ptr(), stream)
    check_launch(lib, err, "fused MPPI")
    KERNEL_LAUNCHES += 1
    return out


def _solve_update(cfg: MPPIConfig, model: CartParams, u, seed, pose_xyt,
                  xd, noise=None, table=None, partial_out=False):
    """One fused solve; returns the updated (N, 2) controls before the
    shift, or the merged (N, 6) partials with ``partial_out``. ``table``:
    the packed obstacles of :func:`pack_obstacles`, or None."""
    seed = torch.as_tensor(seed, dtype=torch.int32, device=u.device)
    _check_inputs(cfg, u, seed, pose_xyt, xd, noise, table)
    if u.is_cuda:
        return _launch(cfg, model, u, seed, pose_xyt, xd, noise, table,
                       partial_out)
    if u.device.type != "cpu":
        raise ValueError(f"no fused MPPI path for device {u.device}")
    parts = _solve_partials_reference(cfg, model, u, seed, pose_xyt, xd,
                                      noise, table)
    return _combine_reference(cfg, u, parts, partial_out)


def pack_obstacles(obstacles, obs_cfg, device=DEFAULT_DEVICE):
    """``tpunav``'s packed obstacle table: the (O, 5) segment primitives
    [ax, ay, bx, by, r] as float32, then the row [r_safe, w_hit, w_field,
    1/σ, 0] of ``obs_cfg`` (``SegmentCostParams``), formed in double and
    rounded once to float32. Returns the (O+1, 5) table on ``device``, or
    None when both are None; raises when only one is given."""
    if obstacles is None and obs_cfg is None:
        return None
    if obstacles is None or obs_cfg is None:
        raise ValueError("pass obstacles and obs_cfg together")
    seg = torch.as_tensor(obstacles, dtype=torch.float32)
    if seg.dim() != 2 or seg.shape[1] != 5:
        raise ValueError(f"obstacles must be (O, 5) segment rows, got "
                         f"{tuple(seg.shape)}")
    row = torch.tensor([[obs_cfg.r_safe, obs_cfg.w_hit, obs_cfg.w_field,
                         1.0 / obs_cfg.sigma, 0.0]], dtype=torch.float64)
    table = torch.cat([seg.cpu(), row.to(torch.float32)])
    # A course packs once; the copy does not wait for the card's queue.
    return table.to(resolve(device), non_blocking=True)


def mppi_solve_partials(cfg: MPPIConfig, model: CartParams, u, seed,
                        pose_xyt, xd, noise=None, obstacles=None,
                        obs_cfg=None):
    """Fused solve returning the (N, 6) softmax partials
    [m_l, Σe, Σe·z0, Σe·z1, Σz0, Σz1] (e = exp((m_l−j)/λ)) of this K, for
    merging across shards with :func:`combine_softmax_partials`."""
    return _solve_update(cfg, model, u, seed, pose_xyt, xd, noise,
                         pack_obstacles(obstacles, obs_cfg, u.device),
                         partial_out=True)


def combine_softmax_partials(cfg: MPPIConfig, u, part, min_fn, sum_fn):
    """Recombine (…, N, 6) softmax partials into the updated controls.

    ``min_fn``/``sum_fn`` reduce over the shard axis (e.g. ``torch.amin``
    and ``torch.sum`` over dim 0 of stacked partials). ``cfg.rollouts`` is
    the total K over all shards. Returns (wheel_cmd (2,), u_next (N, 2)).
    """
    u_new = _apply_rows(cfg, u, _combine_rows(cfg, part, min_fn, sum_fn))
    return u_new[0], shift_controls(cfg, u_new)


def mppi_solve_fused(cfg: MPPIConfig, model: CartParams, u, seed, pose_xyt,
                     xd, noise: Optional[torch.Tensor] = None,
                     obstacles=None, obs_cfg=None):
    """Fused replacement for :func:`tpunav_torch.control.mppi.mppi_solve`.

    ``seed``: int32 scalar (an int or a 0-dim device tensor) keying the
    in-kernel Philox stream. ``noise``: optional (N, K, 2) time-major
    scaled perturbations that bypass in-kernel sampling (parity tests).
    ``obstacles`` ((O, 5) segment primitives) with ``obs_cfg``
    (``SegmentCostParams``) add the analytic obstacle cost to every rollout
    step. Returns (wheel_cmd (2,), u_next (N, 2)) like ``mppi_solve``.
    """
    return mppi_solve_fused_packed(
        cfg, model, u, seed, pose_xyt, xd, noise,
        pack_obstacles(obstacles, obs_cfg, u.device))


def mppi_solve_fused_packed(cfg: MPPIConfig, model: CartParams, u, seed,
                            pose_xyt, xd, noise=None, table=None):
    """:func:`mppi_solve_fused` on an obstacle table already packed by
    :func:`pack_obstacles` (or None), as a course calls it every tick."""
    u_new = _solve_update(cfg, model, u, seed, pose_xyt, xd, noise, table)
    return u_new[0], shift_controls(cfg, u_new)
