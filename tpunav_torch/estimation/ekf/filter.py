"""EKF SLAM with known and unknown (Mahalanobis-gated) data association.

Port of ``tpunav/estimation/ekf/filter.py`` (the reference's ``nuslam::EKF``,
nuslam/include/nuslam/ekf_filter.hpp:62-155, nuslam/src/nuslam/ekf_filter.cpp).
``tpunav`` leaves this filter to XLA. On the card a whole step — the
prediction and every measurement row — is one operation,
``ops.ekf_rows.ekf_step``: one launch of a hand-written kernel
(``ops/csrc/ekf_rows.cu``) for a state or a seed batch of them. All four
steps take it there (:func:`known_correspondence_slam`,
:func:`slam_unknown_da` and their masked forms), so an eager step and a
replayed one give the same bits. A CPU tensor, and the repair of every row
(``spd_repair_per_meas``, which needs the eigensolver between rows) on any
device, take the row chain below in PyTorch (:func:`_masked`), which the
tests hold to ``tpunav``; the op's own plain version
(``ops/ekf_rows.py``) follows the kernel's decomposition and is what the
kernel is held to.

- The state is a fixed-capacity dense vector (3 + 2n,) as in the reference
  (ekf_filter.cpp:103); an ``active`` bool mask replaces the C++ ``lm_j``
  seen-ID list.
- Rows are taken in their order, the invalid ones (NaN) exact no-ops, with
  no host read, so a step can be captured as a CUDA graph
  (:class:`EKFStepper`, the slam loop's chunks), the SPD repair included
  (``spd.py``: a ``torch.where`` whose flag gates the eigensolver kernel),
  which runs before the step. The dynamic and masked names are one step;
  the row chain in PyTorch (:func:`_masked`) takes its fixed trip through
  ``torch.where``.
- The row chain's algebra (the reference form of the kernel's): every read
  and write of landmark slot j goes through a one-element device index
  (``index_select``, ``index_copy``), so no slot access reads j on the
  host. The sparse measurement Jacobian H, whose only nonzero columns are
  [0, 1, 2, jx, jy], enters as its (2, 5) block: Hσ̄, Ψ = Hσ̄Hᵀ and KH are
  products with that block.
- The covariance update is the factored Joseph sandwich (I−KH)σ̄(I−KH)ᵀ +
  KRKᵀ: the rank-2 expansion loses the 1e3 → 1e-5 collapse of a fresh
  landmark in float32. I−KH and the motion Jacobian G differ from the
  identity in five columns and one, so their products with σ̄ are written
  as those terms alone (elementwise operations and 5-term sums), not as
  dense matrix products: a library's product rounds a batch of states
  otherwise than one, and a seed batch (``batch.vmap``) gives each state
  its serial update's bits.
- Each update runs with float32 matmuls at full precision (no TF32), and
  the caller's setting is restored afterwards: reduced-precision products
  break the Mahalanobis gates.
- Noise injection is optional: a ``torch.Generator`` draws the reference's
  motion and measurement noise (ekf_filter.cpp:505, :615) before the step;
  without one the update is deterministic (the parity mode).

State convention as the reference: state[0]=theta, state[1]=x,
state[2]=y, then (lm_x, lm_y) pairs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ... import batch, capture
from ...core.angles import normalize_angle_pi
from ...device import DEFAULT_DEVICE, constant, full_precision_matmul, resolve
from ...ops import ekf_rows
from .spd import repair_if_needed


@dataclasses.dataclass(frozen=True)
class EKFConfig:
    """Filter configuration (ref: EKF ctor + initFilter,
    ekf_filter.cpp:95-106, :442-497); ``tpunav``'s fields and defaults."""

    num_landmarks: int = 25          # n — capacity
    dmax: float = 1e7                # Mahalanobis "new landmark" gate
    dmin: float = 2e4                # Mahalanobis "update" gate
    pose_cov_init: float = 1e-10
    lm_cov_init: float = 1e3
    motion_noise: Tuple[float, float, float] = (1e-10, 1e-10, 1e-10)
    measurement_noise: Tuple[float, float] = (1e-8, 1e-8)
    # One conditional nearest-SPD repair per update (the reference's
    # pre-pass, ekf_filter.cpp:298-305) and symmetrization per
    # measurement; False = symmetrization only.
    spd_repair: bool = True
    # Also repair before every measurement (ref: ekf_filter.cpp:330-335).
    spd_repair_per_meas: bool = False

    @property
    def state_size(self) -> int:
        return 3 + 2 * self.num_landmarks


class EKFState(NamedTuple):
    state: torch.Tensor   # (S,) [theta, x, y, m1x, m1y, ...]
    cov: torch.Tensor     # (S, S)
    active: torch.Tensor  # (n,) bool — replaces the C++ lm_j seen list
    count: torch.Tensor   # int32 — N, the number of tracked landmarks


def _const(values, like):
    """A configuration's small constant on ``like``'s device and dtype,
    built once per (values, dtype, device) (``device.constant``): an
    update makes no host-to-device copy, so it can be captured."""
    return constant(tuple(values), like.dtype, like.device)


def ekf_init(cfg: EKFConfig, dtype=torch.float64,
             device=DEFAULT_DEVICE) -> EKFState:
    """(ref: EKF::initFilter ekf_filter.cpp:442-497). float64 by default,
    as ``tpunav``; on ``device`` (default the CUDA card; raises without
    CUDA unless ``device="cpu"``)."""
    device = resolve(device)
    s, n = cfg.state_size, cfg.num_landmarks
    diag = torch.cat([
        torch.full((3,), cfg.pose_cov_init, dtype=dtype, device=device),
        torch.full((2 * n,), cfg.lm_cov_init, dtype=dtype, device=device)])
    return EKFState(
        state=torch.zeros((s,), dtype=dtype, device=device),
        cov=torch.diag(diag),
        active=torch.zeros((n,), dtype=torch.bool, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device))


def motion_update(cfg: EKFConfig, state, u, w):
    """Unicycle odometry propagation with exact integration and an ω≈0
    branch (ref: EKF::motionUpdate ekf_filter.cpp:500-533). ``w`` is the
    sampled (or zero) motion noise triple. As the reference: theta is
    updated first and the position increment is evaluated at the updated
    heading. Only state[:3] is read and changed."""
    return ekf_rows.motion_update(state, u, w)


def uncertainty_update(cfg: EKFConfig, state, cov, u):
    """σ̄ = G Σ Gᵀ + Q with the sparse motion Jacobian G
    (ref: EKF::uncertaintyUpdate ekf_filter.cpp:536-565; G uses the PRIOR
    heading)."""
    q = _const(tuple(cfg.motion_noise) + (0.0,) * (cfg.state_size - 3), cov)
    return ekf_rows.uncertainty_update(state, cov, u, q)


# ── Measurement model at slot j. ``idx`` is the (5,) long device index
# [0, 1, 2, jx, jy] (jx = 2j + 3, jy = 2j + 4) of H's nonzero columns, so
# idx[3:] addresses the slot's coordinates in the state. H's nonzero
# (2, 5) block is [[0, -ex, -ey, ex, ey], [-1, fy, -fx, -fy, fx]] with
# (ex, ey) = (dx, dy)/√q and (fx, fy) = (dx, dy)/q: a gather of
# [ex, ey, fx, fy] times signs plus the constant -1, all exact, so each
# entry carries the one rounding of its quotient. Every operation is a
# launch on the card, where the update is launch-bound, so the algebra is
# kept in few, whole-vector operations. ──

# Per block entry: the index into [ex, ey, fx, fy], its sign, its offset.
_BLOCK_INDEX = (0, 0, 1, 0, 1, 0, 3, 2, 3, 2)
_BLOCK_SIGN = (0.0, -1.0, -1.0, 1.0, 1.0, 0.0, 1.0, -1.0, -1.0, 1.0)
_BLOCK_OFFSET = (0.0, 0.0, 0.0, 0.0, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0)


class _Update(NamedTuple):
    """Constants of one update, made once and shared by its rows."""

    eye: torch.Tensor          # (S, S)
    r_diag: torch.Tensor       # (2,) measurement noise
    R: torch.Tensor            # (2, 2) diag(r_diag)
    h_table: torch.Tensor      # (n, 5): row j is [0, 1, 2, 2j + 3, 2j + 4]
    block_index: torch.Tensor  # (10,) long, _BLOCK_INDEX
    block_sign: torch.Tensor   # (10,) _BLOCK_SIGN
    block_offset: torch.Tensor  # (10,) _BLOCK_OFFSET


def _update_consts(cfg: EKFConfig, like) -> _Update:
    """The update's constants on ``like``'s device and dtype, built once
    per (configuration, dtype, device) and shared by every later update:
    no step makes a host-to-device copy or rebuilds them."""
    return _update_consts_on(cfg, like.dtype, like.device)


@functools.cache
def _update_consts_on(cfg: EKFConfig, dtype, dev) -> _Update:
    n = cfg.num_landmarks
    j = torch.arange(n, device=dev)[:, None]
    h_table = torch.cat([torch.arange(3, device=dev).expand(n, 3),
                         2 * j + 3, 2 * j + 4], dim=1)
    r_diag = constant(tuple(cfg.measurement_noise), dtype, dev)
    return _Update(
        eye=torch.eye(cfg.state_size, dtype=dtype, device=dev),
        r_diag=r_diag, R=torch.diag(r_diag), h_table=h_table,
        block_index=constant(_BLOCK_INDEX, torch.int64, dev),
        block_sign=constant(_BLOCK_SIGN, dtype, dev),
        block_offset=constant(_BLOCK_OFFSET, dtype, dev))


def _h_terms(state, idx):
    """(d, q, √q): d = (dx, dy) of the slot at ``idx`` relative to the
    pose and q = dx² + dy² — the only data H depends on
    (ref: ekf_filter.cpp:569-597)."""
    d = state.index_select(0, idx[3:]) - state[1:3]
    q = (d * d).sum(-1)
    return d, q, torch.sqrt(q)


def _h_block(k: _Update, terms):
    """H's nonzero (2, 5) block over columns [0, 1, 2, jx, jy] (batched
    over leading dims of the terms)."""
    d, q, sq = terms
    e = torch.cat([d / sq[..., None], d / q[..., None]], dim=-1)
    block = e[..., k.block_index] * k.block_sign + k.block_offset
    return block.view(*block.shape[:-1], 2, 5)


def _measurement_jacobian(cfg: EKFConfig, k: _Update, state, idx):
    """Dense (2, S) range-bearing Jacobian for the slot at ``idx``
    (ref: EKF::measurementJacobian ekf_filter.cpp:569-597). The readable
    reference form: the update itself never builds it (:func:`_hc`)."""
    H = torch.zeros((2, cfg.state_size), dtype=state.dtype,
                    device=state.device)
    return H.index_copy_(1, idx, _h_block(k, _h_terms(state, idx)))


def _dot(a, b):
    """a @ b for a contraction of a few terms (H's five columns, the two
    measurement components), as a product and a sum over the last axis:
    a library's matrix product of this size takes another kernel in a
    batch than alone, and the filter gives each state of a batch the bits
    of its own serial update (``batch.vmap``)."""
    return (a[..., :, None, :] * b.transpose(-1, -2)[..., None, :, :]).sum(-1)


def _hc(cov, block, idx):
    """H @ σ̄ as a (2, S) tensor without building H: H's (2, 5) block
    times the five rows [0, 1, 2, jx, jy] of σ̄."""
    return _dot(block, cov.index_select(0, idx))


def _psi_hh(hc, block, idx):
    """Ψ_hh = H σ̄ Hᵀ = (Hσ̄) Hᵀ (2, 2): H's block applied to the five
    columns of Hσ̄."""
    return _dot(hc.index_select(1, idx), block.T)


def _heading(state, v):
    """The heading the predicted bearing is taken from, with the sampled
    bearing noise folded in (ref: ekf_filter.cpp:615)."""
    return normalize_angle_pi(state[0] + v[1])


def _z_hat(terms, heading, v):
    """ẑ = (range, bearing) of the slot with additive sampled noise
    (ref: EKF::predictedMeasurement ekf_filter.cpp:600-624: v_r adds to
    the range, v_b folds into the heading), for one slot's terms or a
    batch of them."""
    d, _, sq = terms
    b_hat = normalize_angle_pi(torch.atan2(d[..., 1], d[..., 0]) - heading)
    return sq + v[0], b_hat


def _predicted_measurement(state, idx, v):
    return torch.stack(_z_hat(_h_terms(state, idx), _heading(state, v), v))


def _innovation(r, b_norm, z_hat):
    """δz with the reference's double-normalized bearing difference
    (ref: ekf_filter.cpp:387-394); ``b_norm`` is the measured bearing
    already normalized (once per update, for all rows)."""
    r_hat, b_hat = z_hat
    return (r - r_hat,
            normalize_angle_pi(b_norm - normalize_angle_pi(b_hat)))


def _inv2(m):
    """Closed-form 2x2 inverse (Ψ is always 2x2), with a true division."""
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    adj = torch.stack([m[1, 1], -m[0, 1], -m[1, 0], m[0, 0]]).view(2, 2)
    return adj / det


def _kalman_update(cfg: EKFConfig, k: _Update, state, cov, idx, r, b_norm,
                   v, heading):
    """Gain, state and covariance update at the slot at ``idx``
    (ref: ekf_filter.cpp:363-398), in the factored Joseph form
    (I−KH)σ̄(I−KH)ᵀ + KRKᵀ, PSD at any precision. K = σ̄HᵀΨ⁻¹ = (Hσ̄)ᵀΨ⁻¹
    (σ̄ symmetric, as both DA chains keep it); KH is K times H's block,
    placed in H's five columns. ``heading``: :func:`_heading` of the
    state."""
    terms = _h_terms(state, idx)
    block = _h_block(k, terms)
    hc = _hc(cov, block, idx)
    psi = _psi_hh(hc, block, idx) + k.R
    K = _dot(hc.T, _inv2(psi))                              # (S, 2)
    dz = torch.stack(_innovation(r, b_norm, _z_hat(terms, heading, v)))
    new_state = state + _dot(K, dz[:, None])[:, 0]
    # I − KH is the identity but in H's five columns: (I − KH) σ̄ sums five
    # rows of σ̄ into each row (plus the row itself off those columns), and
    # the sandwich's right factor likewise — the dense products' only
    # nonzero terms, the diagonal 1 − KH_ii kept as one factor.
    ikh = k.eye.index_select(1, idx) - _dot(K, block)       # (S, 5)
    off = torch.ones_like(state).index_fill(0, idx, 0.0)    # 0 in H's columns
    left = _dot(ikh, cov.index_select(0, idx)) + off[:, None] * cov
    new_cov = (_dot(left.index_select(1, idx), ikh.T) + left * off +
               _dot(K * k.r_diag[None, :], K.T))
    return new_state, new_cov


def _new_landmark(state, idx, r, b):
    """Initialize the slot at ``idx`` from (r, b) at the current
    estimated pose (ref: EKF::newLandmark ekf_filter.cpp:651-660)."""
    a = b + state[0]
    xy = state[1:3] + r * torch.stack([torch.cos(a), torch.sin(a)])
    return state.index_copy(0, idx[3:], xy)


def _maha_all(cfg: EKFConfig, k: _Update, state, cov, r, b_norm, v_i,
              heading, active):
    """Mahalanobis distance of measurement (r, b) to every landmark slot
    at once (ref: the per-landmark loop ekf_filter.cpp:163-208), with the
    sparse-H algebra batched over slots: each slot's Ψ = B σ̄₅ Bᵀ + R from
    its (2, 5) block B and the (5, 5) block σ̄₅ of σ̄ at its columns
    [0, 1, 2, jx, jy], gathered for all slots at once. A tiny negative d²
    (rounding of a PSD Ψ) clamps to 0; a non-finite or clearly negative one
    reads +inf — "no match" — where the reference throws
    (ekf_filter.cpp:189-192). Inactive slots read +inf."""
    n = cfg.num_landmarks
    d = state[3:].view(n, 2) - state[1:3]
    q = (d * d).sum(-1)
    terms = (d, q, torch.sqrt(q))
    B = _h_block(k, terms)                                  # (n, 2, 5)
    h = k.h_table
    psi = _dot(_dot(B, cov[h[:, :, None], h[:, None, :]]),
               B.transpose(1, 2)) + k.R
    # ẑ per slot with the measurement's sampled noise pair
    # (ref: predictedMeasurement ekf_filter.cpp:600-624).
    dz0, dz1 = _innovation(r, b_norm, _z_hat(terms, heading, v_i))
    p00, p01, p11 = psi[:, 0, 0], psi[:, 0, 1], psi[:, 1, 1]
    det = p00 * p11 - p01 * p01
    d2 = (p11 * dz0 * dz0 - 2.0 * p01 * dz0 * dz1 +
          p00 * dz1 * dz1) / det
    bad = torch.logical_or(~torch.isfinite(d2), d2 < -1e-6)
    d2 = torch.where(torch.logical_or(bad, ~active), float("inf"),
                     torch.clamp(d2, min=0.0))
    return d2


def _noise_draws(cfg: EKFConfig, generator: Optional[torch.Generator],
                 n_meas: int, like):
    """Motion-noise triple + per-measurement noise pairs.
    ``generator=None`` → zeros (the deterministic parity mode)."""
    f = dict(dtype=like.dtype, device=like.device)
    if generator is None:
        return torch.zeros((3,), **f), torch.zeros((n_meas, 2), **f)
    w = torch.randn((3,), generator=generator, **f) * torch.sqrt(
        _const(cfg.motion_noise, like))
    v = torch.randn((n_meas, 2), generator=generator, **f) * torch.sqrt(
        _const(cfg.measurement_noise, like))
    return w, v


def _full_precision(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with full_precision_matmul():
            return fn(*args, **kwargs)
    return wrapped


def _repair(cfg: EKFConfig, c):
    """The SPD repair (no host read), or symmetrization alone."""
    return repair_if_needed(c) if cfg.spd_repair else 0.5 * (c + c.T)


def _predict(cfg: EKFConfig, st: EKFState, meas_xy, u, generator):
    """The measurements in the filter's dtype (a float64 measurement would
    otherwise promote the state through K @ δz), the measurement noise,
    and the motion and uncertainty update on the repaired covariance."""
    like = st.state
    meas_xy = torch.as_tensor(meas_xy).to(like.device, like.dtype)
    u = torch.as_tensor(u).to(like.device, like.dtype)
    w, v = _noise_draws(cfg, generator, meas_xy.shape[0], like)
    state_bar = motion_update(cfg, st.state, u, w)
    # The motion Jacobian is evaluated at the PRIOR state (ref: :536-565).
    sigma_bar = uncertainty_update(cfg, st.state, _repair(cfg, st.cov), u)
    return meas_xy, v, state_bar, sigma_bar


def _known_row(cfg: EKFConfig, k: _Update, carry, j, row):
    """One measurement ``row`` = (r, b, normalized b, v) of the known-DA
    chain (ref: :341-398) at landmark slot ``j`` (a one-element long
    device index)."""
    r, b, b_norm, v_i = row
    state, cov, active = carry
    if cfg.spd_repair and cfg.spd_repair_per_meas:
        cov = _repair(cfg, cov)
    else:
        cov = 0.5 * (cov + cov.T)
    idx = k.h_table.index_select(0, j).view(5)
    # Unseen id → initialize the landmark slot (ref: :349-360).
    is_new = ~active.index_select(0, j)[0]
    state = torch.where(is_new, _new_landmark(state, idx, r, b), state)
    active = active.index_fill(0, j, True)
    state, cov = _kalman_update(cfg, k, state, cov, idx, r, b_norm, v_i,
                                _heading(state, v_i))
    return state, cov, active


def _unknown_row(cfg: EKFConfig, k: _Update, carry, row):
    """One measurement ``row`` = (r, b, normalized b, v) of the unknown-DA
    chain (ref: :163-244): distances to every slot; d* ≤ dmin updates the
    nearest, d* ≥ dmax adds a landmark (with capacity left), anything
    between is ignored."""
    r, b, b_norm, v_i = row
    state, cov, active, count = carry
    if cfg.spd_repair and cfg.spd_repair_per_meas:
        cov = _repair(cfg, cov)
    else:
        cov = 0.5 * (cov + cov.T)
    # A new landmark leaves the heading as it is: one heading serves both.
    heading = _heading(state, v_i)
    d = _maha_all(cfg, k, state, cov, r, b_norm, v_i, heading, active)
    # N == 0 → a huge sentinel so the first landmark is added (:146-157).
    dstar = torch.where(count == 0, 1e12, torch.amin(d))
    jstar = torch.argmin(d)
    do_update = dstar <= cfg.dmin
    do_add = torch.logical_and(dstar >= cfg.dmax,
                               count < cfg.num_landmarks)
    j = torch.where(do_add, count.long(), jstar).view(1)
    idx = k.h_table.index_select(0, j).view(5)
    state = torch.where(do_add, _new_landmark(state, idx, r, b), state)
    active_j = torch.logical_or(active.index_select(0, j), do_add)
    active = active.index_copy(0, j, active_j)
    count = count + do_add.to(count.dtype)
    apply = torch.logical_and(torch.logical_or(do_update, do_add),
                              active_j[0])
    new_state, new_cov = _kalman_update(cfg, k, state, cov, idx, r, b_norm,
                                        v_i, heading)
    return (torch.where(apply, new_state, state),
            torch.where(apply, new_cov, cov), active, count)


def _masked(cfg: EKFConfig, st: EKFState, meas_xy, u, generator, known):
    """The row chain in PyTorch: the prediction (:func:`_predict`), then
    every row in its order, each invalid one an exact no-op through
    ``torch.where``; no host read."""
    meas_xy, v, state, cov = _predict(cfg, st, meas_xy, u, generator)
    n_meas = meas_xy.shape[0]
    valid, r, b, b_norm = ekf_rows.polar_rows(meas_xy)
    k = _update_consts(cfg, state)
    slots = torch.arange(n_meas, device=state.device)  # known DA: row i is j
    carry = (state, cov, st.active) if known else (state, cov, st.active,
                                                   st.count)
    for i in range(n_meas):
        row = (r[i], b[i], b_norm[i], v[i])
        new = (_known_row(cfg, k, carry, slots[i:i + 1], row)
               if known else _unknown_row(cfg, k, carry, row))
        carry = tuple(torch.where(valid[i], a, c) for a, c in zip(new, carry))
    if known:
        return EKFState(*carry, count=carry[2].sum(dtype=torch.int32))
    return EKFState(*carry)


def _filter_step(cfg: EKFConfig, st: EKFState, meas_xy, u, generator,
                 known: bool) -> EKFState:
    """Every public step: on the card one ``ops.ekf_rows.ekf_step`` (one
    launch) after the noise draws and the SPD repair; on the CPU, or with
    the repair before every row, which needs the eigensolver between rows,
    the row chain in PyTorch (:func:`_masked`). Any other device raises in
    the op."""
    meas_xy = torch.as_tensor(meas_xy)
    if meas_xy.dim() != 2 or meas_xy.shape[-1] != 2:
        raise ValueError(f"measurements must be (M, 2), got "
                         f"{tuple(meas_xy.shape)}")
    if known and meas_xy.shape[0] > cfg.num_landmarks:
        raise ValueError(f"known DA takes at most one row per landmark "
                         f"slot ({cfg.num_landmarks}), got "
                         f"{meas_xy.shape[0]}")
    if (cfg.spd_repair and cfg.spd_repair_per_meas) or \
            st.state.device.type == "cpu":
        return _masked(cfg, st, meas_xy, u, generator, known)
    like = st.state
    meas_xy = meas_xy.to(like.device, like.dtype)
    u = torch.as_tensor(u).to(like.device, like.dtype)
    w, v = _noise_draws(cfg, generator, meas_xy.shape[0], like)
    return EKFState(*ekf_rows.ekf_step(
        st.state, _repair(cfg, st.cov), st.active, st.count,
        meas_xy.contiguous(), u[..., :2].contiguous(), w, v, known=known,
        dmin=cfg.dmin, dmax=cfg.dmax, motion_noise=cfg.motion_noise,
        measurement_noise=cfg.measurement_noise))


@_full_precision
def known_correspondence_slam(cfg: EKFConfig, st: EKFState, meas_xy, u,
                              generator: Optional[torch.Generator] = None
                              ) -> EKFState:
    """One SLAM step with known data association: measurement row i IS
    landmark id i (ref: EKF::knownCorrespondenceSLAM ekf_filter.cpp:298-411).

    meas_xy: (M ≤ n, 2) landmark positions in the ROBOT frame; NaN rows are
    out of visibility and skipped (ref: :341-345); with M = 0 the step is
    the prediction alone. u: (≥2,) body twist [w, vx, ...].
    ``generator``: draws the motion and measurement noise; None = none.
    """
    return _filter_step(cfg, st, meas_xy, u, generator, True)


@_full_precision
def slam_unknown_da(cfg: EKFConfig, st: EKFState, meas_xy, u,
                    generator: Optional[torch.Generator] = None) -> EKFState:
    """One SLAM step with unknown data association via Mahalanobis gating
    (ref: EKF::SLAM ekf_filter.cpp:112-294). Per valid measurement in row
    order: distances to every tracked landmark; d* ≤ dmin → update that
    landmark; d* ≥ dmax → add a new one (if capacity); in between →
    ignore (ref: :210-244). meas_xy (M, 2), u and ``generator`` as in
    :func:`known_correspondence_slam`."""
    return _filter_step(cfg, st, meas_xy, u, generator, False)


@_full_precision
def known_correspondence_slam_masked(cfg: EKFConfig, st: EKFState, meas_xy,
                                     u, generator: Optional[torch.Generator]
                                     = None) -> EKFState:
    """:func:`known_correspondence_slam`, the name the capturable callers
    use: every step is a fixed trip over all M rows with no host read."""
    return _filter_step(cfg, st, meas_xy, u, generator, True)


@_full_precision
def slam_unknown_da_masked(cfg: EKFConfig, st: EKFState, meas_xy, u,
                           generator: Optional[torch.Generator] = None
                           ) -> EKFState:
    """:func:`slam_unknown_da`, the name the capturable callers use: every
    step is a fixed trip over all M rows with no host read."""
    return _filter_step(cfg, st, meas_xy, u, generator, False)


class EKFStepper:
    """The EKF update captured as one CUDA graph and replayed once per
    update (``capture.Graph``), the counterpart of ``tpunav``'s jitted
    update: the masked form over ``n_meas`` measurement rows, known or
    unknown DA, without noise draws (the parity mode). A seed batch of B
    states (every field of ``st`` leading with B) steps as one update
    mapped over the batch (``batch.vmap``): its inputs are (B, n_meas, 2)
    and (B, 2), and each state gets the bits of its own serial update.

    ``st`` is copied once into the stepper's buffers on ``device`` (default
    the card; raises without CUDA; ``st`` must lie there). From then on the
    state lives in place: each :meth:`step` overwrites the buffers and
    returns them, so the state a step returned is consumed by the next, as
    ``tpunav``'s callers donate theirs. Every configuration is taken, the
    SPD repair (once per update, or per row with ``spd_repair_per_meas``)
    included: its eigensolver is a kernel gated by a device flag.

    ``inputs`` (the measurements and the twist) and ``update`` (the step's
    body on them) let a caller run the update inside a graph of its own,
    as the EKF node does."""

    def __init__(self, cfg: EKFConfig, st: EKFState, n_meas: int,
                 known_da: bool = True, device=DEFAULT_DEVICE):
        dev = capture.state_device(st.state, device)
        self.cfg = cfg
        # The body holds the buffers, not self: a graph whose stepper is
        # dropped is freed at once, not by the cyclic collector.
        state = self.state = EKFState(*(t.clone() for t in st))
        lead = tuple(st.state.shape[:-1])               # (B,) for a batch
        like = dict(dtype=st.state.dtype, device=dev)
        inputs = self.inputs = (torch.zeros((*lead, n_meas, 2), **like),
                                torch.zeros((*lead, 2), **like))
        masked = (known_correspondence_slam_masked if known_da
                  else slam_unknown_da_masked)
        step = batch.over(lambda s, m, u: masked(cfg, s, m, u), bool(lead))

        def update():
            capture.load(state, step(state, *inputs))

        self.update = update
        self.graph = capture.Graph(update, dev)

    def step(self, meas_xy, u) -> EKFState:
        """One update from (n_meas, 2) robot-frame measurements (NaN rows
        skipped) and the (2,) twist [w, vx] (a batch: (B, n_meas, 2) and
        (B, 2) or (2,)); returns the state in place."""
        capture.load(self.inputs, (meas_xy, u))
        self.graph()
        return self.state


def robot_pose(st: EKFState):
    """Map→robot transform [theta, x, y] ((B, 3) for a seed batch)
    (ref: EKF::getRobotState ekf_filter.cpp:414-419)."""
    return st.state[..., :3]


def landmark_map(cfg: EKFConfig, st: EKFState):
    """(n, 2) landmark estimates + active mask
    (ref: EKF::getMap ekf_filter.cpp:423-439)."""
    return st.state[3:].view(cfg.num_landmarks, 2), st.active
