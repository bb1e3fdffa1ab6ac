"""The EKF SLAM filter step in one kernel launch: its wrapper and its plain
version.

No Pallas kernel in ``tpunav`` computes it: ``tpunav`` leaves the EKF to
XLA (``tpunav/estimation/ekf/filter.py``). The port's step was the
prediction and then ~100 PyTorch operations per measurement row, ~3,200
launches per sensing tick of config 4; on the card a whole step of a
state — the motion and uncertainty updates, the rows' polar form and
validity, and every row of the chain — is one thread block of
``csrc/ekf_rows.cu``, hand-written for Hopper, and a batch of B states is
one launch of B blocks.

The step, for one state (``estimation/ekf/filter.py`` holds its algebra and
its references):

- x̄ = the motion update of x by the twist u and the motion noise w; σ̄ =
  G Σ Gᵀ + Q with G's one nonzero column, on the covariance Σ that the
  caller repaired (the SPD pre-pass stays in ``filter.py``);
- each measurement row's validity (finite) and (range, bearing);
- every row in order, an invalid one an exact no-op: σ̄ ← ½(σ̄ + σ̄ᵀ); the
  slot j (known association: the row's own; unknown: the Mahalanobis gate
  against every slot, the nearest slot at d* ≤ dmin, a new one at d* ≥
  dmax while capacity is left, else the row is ignored); a new landmark
  initialised from the row; the Kalman update at j in the factored Joseph
  form (I−KH)σ̄(I−KH)ᵀ + KRKᵀ.

The plain version (:func:`_step_reference`) is the kernel's own
decomposition in plain torch: H's (2, 5) block, Ψ from the 5×5 block of σ̄
at H's columns, the five cached rows of σ̄, K, I−KH and the left factor at
H's columns, and the covariance from those alone; every sum of a few terms
is taken left to right, each operation rounded on its own, as the kernel
rounds it. It runs one state at a time with the row's decisions read on
the host, as the kernel runs a block per state with its decisions in
registers, so a state's bits do not depend on the batch it came in.

A CPU tensor given to the op takes the plain version (the filter's own CPU
steps take its PyTorch row chain, ``filter._masked``, which the plain
version is held to); a CUDA tensor launches the kernel, float32 or
float64, or raises. ``EKF_LAUNCHES`` counts launches (one per
step of a batch). :func:`plan` places the covariance from the shapes and
the card alone: in shared memory while it fits (S ≤ ~230 in float32, ~160
in float64 on an H100), else in the output tensor in device memory. The
step goes through a ``torch.library`` op (``tpunav_torch::ekf_step``)
whose batching rule folds a ``torch.func.vmap`` batch into its own: a
seed batch's filter steps all its states in one launch.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from ..core.angles import normalize_angle_pi
from ._build import check_launch, check_shared_memory, load

EKF_LAUNCHES = 0            # kernel launches (one per step of a batch)

W_EPS = 1e-12               # |ω| below it is a straight step (rigid2d.hpp)
NO_LANDMARKS = 1e12         # d* while no landmark is tracked (the sentinel)


# ── The prediction, shared with estimation/ekf/filter.py ──


def motion_update(state, u, w):
    """Unicycle odometry with exact integration and an ω≈0 branch (ref:
    EKF::motionUpdate ekf_filter.cpp:500-533): θ first, the position
    increment at the new heading. ``state`` (..., S), ``u`` (..., ≥2) =
    [ω, v], ``w`` (..., 3) the motion noise; only state[..., :3] moves."""
    om, vx = u[..., 0], u[..., 1]
    theta = state[..., 0]
    small = torch.abs(om) < W_EPS
    om_safe = torch.where(small, torch.ones_like(om), om)
    theta_new = normalize_angle_pi(
        theta + torch.where(small, torch.zeros_like(om), om) + w[..., 0])
    s_new, c_new = torch.sin(theta_new), torch.cos(theta_new)
    k = vx / om_safe
    dx_gen = (-vx / om_safe) * s_new + k * torch.sin(theta_new + om)
    dy_gen = k * c_new - k * torch.cos(theta_new + om)
    x = state[..., 1] + (torch.where(small, vx * c_new, dx_gen) + w[..., 1])
    y = state[..., 2] + (torch.where(small, vx * s_new, dy_gen) + w[..., 2])
    return torch.cat([torch.stack([theta_new, x, y], -1), state[..., 3:]],
                     -1)


def uncertainty_update(state, cov, u, q):
    """σ̄ = G Σ Gᵀ + Q with the sparse motion Jacobian G at the PRIOR
    heading (ref: EKF::uncertaintyUpdate ekf_filter.cpp:536-565); ``q`` the
    (S,) diagonal of Q. G is the identity but for g = (0, g10, g20, 0, …)
    in column 0, so G Σ adds g_i · (row 0) to row i and (G Σ) Gᵀ adds
    g_j · (column 0) to column j: the dense products' only nonzero terms,
    as elementwise operations, which round alike for one state and a batch
    of them."""
    om, vx = u[..., 0], u[..., 1]
    theta = state[..., 0]
    small = torch.abs(om) < W_EPS
    om_safe = torch.where(small, torch.ones_like(om), om)
    k = vx / om_safe
    g10 = torch.where(small, -vx * torch.sin(theta),
                      (-vx / om_safe) * torch.cos(theta) +
                      k * torch.cos(theta + om))
    g20 = torch.where(small, vx * torch.cos(theta),
                      (-vx / om_safe) * torch.sin(theta) +
                      k * torch.sin(theta + om))
    zero = torch.zeros_like(g10)[..., None]
    g = torch.cat([zero, g10[..., None], g20[..., None],
                   zero.expand(*zero.shape[:-1], cov.shape[-1] - 3)], -1)
    g_sigma = cov + g[..., :, None] * cov[..., :1, :]
    return g_sigma + g_sigma[..., :, :1] * g[..., None, :] + torch.diag_embed(q)


# ── The plain version: the kernel's decomposition in plain torch ──


def _sum(terms):
    """t0 + t1 + … left to right, as the kernel adds a few terms."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _slot_terms(lx, ly, x):
    """(d0, d1, √q) of the slot at (lx, ly) from the pose, and H's (2, 5)
    block [[0, -ex, -ey, ex, ey], [-1, fy, -fx, -fy, fx]] as lists, with
    (ex, ey) = d/√q and (fx, fy) = d/q."""
    d0, d1 = lx - x[1], ly - x[2]
    q = d0 * d0 + d1 * d1
    sq = torch.sqrt(q)
    ex, ey, fx, fy = d0 / sq, d1 / sq, d0 / q, d1 / q
    zero, one = torch.zeros_like(ex), torch.ones_like(ex)
    return d0, d1, sq, ([zero, -ex, -ey, ex, ey], [-one, fy, -fx, -fy, fx])


def _psi(bl, p5):
    """Ψ = (B σ̄₅) Bᵀ (R not added) from H's block and σ̄'s 5×5 block at H's
    columns (``p5[c][e]``), each entry a five-term sum."""
    t = [[_sum([bl[m][c] * p5[c][e] for c in range(5)]) for e in range(5)]
         for m in range(2)]
    return [[_sum([t[m][e] * bl[k][e] for e in range(5)]) for k in range(2)]
            for m in range(2)]


def _innovation(d0, d1, sq, r, b_norm, v_r, heading):
    """(r − (√q + v_r), the bearing's doubly wrapped difference) (ref:
    ekf_filter.cpp:387-394, :600-624)."""
    b_hat = normalize_angle_pi(torch.atan2(d1, d0) - heading)
    return (r - (sq + v_r),
            normalize_angle_pi(b_norm - normalize_angle_pi(b_hat)))


def _gate_reference(x, P, active, r, b_norm, v_r, heading, rdiag):
    """The Mahalanobis d² of a row to every slot (ref: the per-landmark loop
    ekf_filter.cpp:163-208): +inf for an inactive slot and for a non-finite
    or clearly negative d² (where the reference throws), a tiny negative
    clamped to 0."""
    n = active.shape[0]
    lm = x[3:].view(n, 2)
    d0, d1, sq, bl = _slot_terms(lm[:, 0], lm[:, 1], x)
    h = _slots(n, x.device)
    p5 = P[h[:, :, None], h[:, None, :]]
    psi = _psi(bl, [[p5[:, c, e] for e in range(5)] for c in range(5)])
    p00, p01, p11 = psi[0][0] + rdiag[0], psi[0][1], psi[1][1] + rdiag[1]
    dz0, dz1 = _innovation(d0, d1, sq, r, b_norm, v_r, heading)
    det = p00 * p11 - p01 * p01
    d2 = (p11 * dz0 * dz0 - 2.0 * p01 * dz0 * dz1 + p00 * dz1 * dz1) / det
    bad = torch.logical_or(~torch.isfinite(d2), d2 < -1e-6)
    return torch.where(torch.logical_or(bad, ~active), float("inf"),
                       torch.clamp(d2, min=0.0))


def _slots(n: int, device):
    """(n, 5) long: row s is [0, 1, 2, 2s + 3, 2s + 4], H's columns."""
    s = torch.arange(n, device=device)[:, None]
    return torch.cat([torch.arange(3, device=device).expand(n, 3),
                      2 * s + 3, 2 * s + 4], dim=1)


def _kalman_reference(x, P, j, lm, row, heading, rdiag):
    """The Kalman update at slot ``j`` (a landmark at ``lm`` = (lx, ly)) in
    the factored Joseph form, from the cached rows σ̄[h, :], as the kernel
    takes it; ``P`` symmetric. Returns (x, σ)."""
    r, _, b_norm, v_r, _ = row
    jx, jy = 3 + 2 * j, 4 + 2 * j
    h = [0, 1, 2, jx, jy]
    d0, d1, sq, bl = _slot_terms(lm[0], lm[1], x)
    pr = P[h]                                          # (5, S)
    p5 = [[pr[c, h[e]] for e in range(5)] for c in range(5)]
    psi = _psi(bl, p5)
    psi[0][0] = psi[0][0] + rdiag[0]
    psi[1][1] = psi[1][1] + rdiag[1]
    det = psi[0][0] * psi[1][1] - psi[0][1] * psi[1][0]
    inv = [[psi[1][1] / det, -psi[0][1] / det],
           [-psi[1][0] / det, psi[0][0] / det]]
    dz0, dz1 = _innovation(d0, d1, sq, r, b_norm, v_r, heading)
    hc = [_sum([bl[m][c] * pr[c] for c in range(5)]) for m in range(2)]
    k0 = hc[0] * inv[0][0] + hc[1] * inv[1][0]
    k1 = hc[0] * inv[0][1] + hc[1] * inv[1][1]
    x = x.clone()
    x[jx], x[jy] = lm[0], lm[1]
    x = x + (k0 * dz0 + k1 * dz1)
    idx = torch.arange(x.shape[0], device=x.device)
    ikh = [(idx == h[c]).to(x.dtype) - (k0 * bl[0][c] + k1 * bl[1][c])
           for c in range(5)]
    off = torch.ones_like(x)
    off[h] = 0.0
    lf = [_sum([ikh[c] * p5[c][e] for c in range(5)]) + off * pr[e]
          for e in range(5)]
    left = _sum([ikh[c][:, None] * pr[c][None, :] for c in range(5)]) + \
        off[:, None] * P
    krk = ((k0 * rdiag[0])[:, None] * k0[None, :] +
           (k1 * rdiag[1])[:, None] * k1[None, :])
    cov = (_sum([lf[e][:, None] * ikh[e][None, :] for e in range(5)]) +
           left * off[None, :]) + krk
    return x, cov


def polar_rows(meas):
    """Each row's validity (finite) and (r, b, b wrapped), invalid rows at
    (0, 0) (ref: EKF::measRobotToMap ekf_filter.cpp:627-648)."""
    valid = torch.isfinite(meas).all(dim=-1)
    safe = torch.where(valid[..., None], torch.nan_to_num(meas), 0.0)
    r = torch.hypot(safe[..., 0], safe[..., 1])
    b = torch.atan2(safe[..., 1], safe[..., 0])
    return valid, r, b, normalize_angle_pi(b)


def _step_reference(state, cov, active, count, meas, u, w, v, known, dmin,
                    dmax, q, rdiag):
    """One filter step of one state ((S,), (S, S), (n,), (), (M, 2), (2,),
    (3,), (M, 2)); ``q`` (S,) and ``rdiag`` (2,) on its device."""
    x = motion_update(state, u, w)
    P = uncertainty_update(state, cov, u, q)
    active = active.clone()
    valid, rr, rb, rbn = polar_rows(meas)
    n = active.shape[0]
    for i in range(meas.shape[0]):
        if not bool(valid[i]):
            continue
        P = 0.5 * (P + P.T)
        row = (rr[i], rb[i], rbn[i], v[i, 0], v[i, 1])
        heading = normalize_angle_pi(x[0] + row[4])
        if known:
            j, add = i, not bool(active[i])
        else:
            d2 = _gate_reference(x, P, active, row[0], row[2], row[3],
                                 heading, rdiag)
            dstar = (torch.tensor(NO_LANDMARKS, dtype=x.dtype)
                     if int(count) == 0 else torch.amin(d2))
            do_update = bool(dstar <= dmin)
            add = bool(dstar >= dmax) and int(count) < n
            j = int(count) if add else int(torch.argmin(d2))
            if not ((do_update or add) and (add or bool(active[j]))):
                continue
            count = count + int(add)
        jx = 3 + 2 * j
        lm = x[jx:jx + 2]
        if add:
            a = row[1] + x[0]
            lm = x[1:3] + row[0] * torch.stack([torch.cos(a), torch.sin(a)])
        active[j] = True
        x, P = _kalman_reference(x, P, j, lm, row, heading, rdiag)
    if known:
        count = active.sum(dtype=torch.int32)
    return x, P, active, torch.as_tensor(count, dtype=torch.int32)


def _reference(state, cov, active, count, meas, u, w, v, known, dmin, dmax,
               motion_noise, measurement_noise):
    """The plain version over a batch, one state at a time."""
    f = dict(dtype=state.dtype, device=state.device)
    q = torch.tensor(list(motion_noise) + [0.0] * (state.shape[-1] - 3), **f)
    rdiag = torch.tensor(list(measurement_noise), **f)
    outs = [_step_reference(*(t[b] for t in (state, cov, active, count, meas,
                                              u, w, v)),
                            known, dmin, dmax, q, rdiag)
            for b in range(state.shape[0])]
    if not outs:
        return (state.clone(), cov.clone(), active.clone(), count.clone())
    return tuple(torch.stack(parts) for parts in zip(*outs))


# ── The kernel ──

THREADS = 512               # threads per block (csrc/ekf_rows.cu: kThreads)
LAYOUTS = ("shared", "global")


class _EkfParams(ctypes.Structure):
    """Mirror of ``EkfParams`` in csrc/ekf_rows.cu."""

    _fields_ = [("batch", ctypes.c_int), ("n", ctypes.c_int),
                ("m", ctypes.c_int), ("known", ctypes.c_int),
                ("global_layout", ctypes.c_int), ("f64", ctypes.c_int),
                ("smem", ctypes.c_int),
                ("dmin", ctypes.c_double), ("dmax", ctypes.c_double),
                ("q0", ctypes.c_double), ("q1", ctypes.c_double),
                ("q2", ctypes.c_double), ("r0", ctypes.c_double),
                ("r1", ctypes.c_double)]


def shared_bytes(s: int, m: int, itemsize: int, in_shared: bool) -> int:
    """Dynamic shared memory of a block at state size ``s`` and ``m`` rows
    (csrc/ekf_rows.cu: carve): the covariance where ``in_shared``, the
    state twice, the row cache (5 rows, K, I−KH and the left factor: 17
    values an index), the rows, the warp minima, the flags."""
    n, warps = (s - 3) // 2, THREADS // 32
    values = (s * s if in_shared else 0) + 19 * s + 5 * m + 2 * warps
    return -(-(itemsize * values + 4 * 2 * warps + n + m) // 16) * 16


def plan(s: int, m: int, dtype: torch.dtype, smem_limit: int):
    """(layout, shared bytes) of a step at state size ``s`` with ``m`` rows
    on a card whose blocks may opt in to ``smem_limit`` bytes: the
    covariance in shared memory while it fits there, else (``"global"``)
    in the output tensor in device memory, with the rest in shared memory."""
    itemsize = torch.finfo(dtype).bits // 8
    need = shared_bytes(s, m, itemsize, True)
    if need <= smem_limit:
        return "shared", need
    return "global", shared_bytes(s, m, itemsize, False)


def _launch(state, cov, active, count, meas, u, w, v, known, dmin, dmax,
            motion_noise, measurement_noise):
    global EKF_LAUNCHES
    lib = load()
    batch, s = state.shape
    outs = (torch.empty_like(state), torch.empty_like(cov),
            torch.empty_like(active), torch.empty_like(count))
    if batch == 0:
        return outs
    layout, smem = plan(s, meas.shape[1], state.dtype,
                        lib.tpunav_max_dynamic_smem())
    check_shared_memory(lib, smem, f"the EKF step at S={s}")
    params = _EkfParams(batch, (s - 3) // 2, meas.shape[1], int(known),
                        LAYOUTS.index(layout),
                        int(state.dtype == torch.float64), smem, dmin, dmax,
                        *motion_noise, *measurement_noise)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tpunav_ekf_step(
            ctypes.addressof(params),
            *(t.data_ptr() for t in (state, cov, active, count, meas, u, w,
                                     v)),
            *(t.data_ptr() for t in outs), stream)
    check_launch(lib, err, "EKF step")
    EKF_LAUNCHES += 1
    return outs


def _check(state, cov, active, count, meas, u, w, v, known) -> None:
    """Raise unless the inputs are a batch of B states as the step takes
    them: contiguous, on one device, of one floating dtype (float32 or
    float64 on CUDA), with consistent shapes."""
    named = (("state", state), ("cov", cov), ("active", active),
             ("count", count), ("meas", meas), ("u", u), ("w", w), ("v", v))
    for name, t in named:
        if t.device != state.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{state.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no EKF step for device {state.device}")
    dtypes = ((torch.float32, torch.float64) if state.is_cuda
              else (state.dtype,))
    if not state.dtype.is_floating_point or state.dtype not in dtypes:
        raise TypeError(f"the EKF step takes float32 or float64, got "
                        f"{state.dtype}")
    for name, t in named:
        want = (torch.bool if name == "active" else torch.int32
                if name == "count" else state.dtype)
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if state.dim() != 2 or state.shape[1] < 5 or state.shape[1] % 2 == 0:
        raise ValueError(f"state must be (B, 3 + 2n) with n >= 1, got "
                         f"{tuple(state.shape)}")
    b, s = state.shape
    n, m = (s - 3) // 2, meas.shape[1] if meas.dim() == 3 else -1
    for name, t, shape in (("cov", cov, (b, s, s)), ("active", active, (b, n)),
                           ("count", count, (b,)), ("meas", meas, (b, m, 2)),
                           ("u", u, (b, 2)), ("w", w, (b, 3)),
                           ("v", v, (b, m, 2))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    if known and m > n:
        raise ValueError(f"known association takes at most one row per slot "
                         f"({n}), got {m}")


@torch.library.custom_op("tpunav_torch::ekf_step", mutates_args=())
def _ekf_op(state: torch.Tensor, cov: torch.Tensor, active: torch.Tensor,
            count: torch.Tensor, meas: torch.Tensor, u: torch.Tensor,
            w: torch.Tensor, v: torch.Tensor, known: bool, dmin: float,
            dmax: float, motion_noise: Sequence[float],
            measurement_noise: Sequence[float]
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    _check(state, cov, active, count, meas, u, w, v, known)
    run = _launch if state.is_cuda else _reference
    return run(state, cov, active, count, meas, u, w, v, known, dmin, dmax,
               motion_noise, measurement_noise)


@_ekf_op.register_vmap
def _ekf_vmap(info, in_dims, *args):
    """Under ``torch.func.vmap``: one call on the mapped batch folded into
    the op's own batch axis (an unmapped input repeated over it)."""
    size = info.batch_size
    folded = []
    for arg, dim in zip(args, in_dims):
        if not isinstance(arg, torch.Tensor):
            folded.append(arg)
            continue
        arg = (arg.expand(size, *arg.shape) if dim is None
               else arg.movedim(dim, 0))
        folded.append(arg.reshape(size * arg.shape[1], *arg.shape[2:])
                      .contiguous())
    outs = _ekf_op(*folded)
    return (tuple(o.view(size, -1, *o.shape[1:]) for o in outs),
            (0, 0, 0, 0))


def ekf_step(state, cov, active, count, meas, u, w, v, *, known: bool,
             dmin: float, dmax: float, motion_noise: List[float],
             measurement_noise: List[float]):
    """One filter step of one state ((S,), (S, S), (n,) bool, () int32,
    (M, 2) robot-frame measurements with NaN rows skipped, (2,) twist,
    (3,) and (M, 2) noise draws) or of a batch (each with a leading B):
    (state, cov, active, count) after it. ``cov`` is the covariance after
    the caller's repair. A CUDA tensor launches ``csrc/ekf_rows.cu`` (one
    launch for the batch); a CPU tensor takes the plain version. Under
    ``torch.func.vmap`` the mapped batch joins the op's: one launch for the
    whole batch."""
    one = state.dim() == 1
    args = (state, cov, active, count, meas, u, w, v)
    if one:
        args = tuple(t.unsqueeze(0) for t in args)
    out = _ekf_op(*args, known, float(dmin), float(dmax),
                  [float(x) for x in motion_noise],
                  [float(x) for x in measurement_noise])
    return tuple(t.squeeze(0) for t in out) if one else out
