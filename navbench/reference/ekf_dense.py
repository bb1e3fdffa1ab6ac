"""The plain tick of BASELINE config 4 that the EKF sweep cell is held to.

Written from the method, in plain PyTorch, one seed at a time: the
waypoint advance on the filter's pose, the plant (classical RK4 of the
kinematic cart), the biased odometry, and on a sensing tick the lidar's
raycast of the cylinders, the clustering and "hyper-accurate" algebraic
circle fit of the reference's ``nuslam::Landmarks`` (landmarks.cpp:99-237,
:354-446), and the unknown-DA EKF of its ``nuslam::EKF::SLAM``
(ekf_filter.cpp:112-294) with its Mahalanobis gates. The MPPI solve is the
caller's (``mppi.py``'s, on the frozen Philox stream), handed in as the
tick's updated controls. Nothing here imports the program.

Precision is the configuration's: the state, the scan and the filter in
``dtype`` (float32), the circle fit in ``fit`` (float64), matrix products
without TF32 (:func:`exact`). A lower ``dtype`` (bfloat16, with the fit in
float32) is the control put in the program's place.

Each step also reports its near-ties: a decision that rounding in another
order may take the other way (a distance at a gate or a threshold). After
one the program may rightly part from this reference.

Departures from the reference C++, each the configuration's or the port's
stated semantics:

- the EKF runs without its SPD repair (``spd_repair`` false): the
  covariance is symmetrized before the prediction and before each row,
  and each row's update is the Joseph form (I−KH)σ̄(I−KH)ᵀ + KRKᵀ, PSD at
  any precision, where the reference C++ takes (I−KH)σ̄;
- a Mahalanobis distance that is not finite or is below −1e-6 reads "no
  match" where the C++ throws, and a tiny negative one reads 0;
- no motion or measurement noise is drawn inside the filter (the loop's
  noise is the lidar's and the odometry's bias);
- the detector has ``max_clusters`` output slots: a cluster id past the
  last slot is fitted into it, as the port (and ``tpunav``) do; the fit
  takes the SVD of Z and solves A = Y⁻¹A* as a least-squares solve would,
  singular values under the precision's reach dropped;
- the classification by inscribed angles is off, as the reference ships
  it (landmarks.cpp:299-307): only the radius gate applies.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, NamedTuple

import torch

PI = math.pi
TWO_PI = 2.0 * math.pi


@contextlib.contextmanager
def exact():
    """Matrix products at full float32 precision (no TF32), restored
    after."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


def wrap(a):
    """Angle(s) to [-π, π): (a + π) mod 2π − π (ref: rigid2d.hpp:53-64)."""
    return torch.remainder(a + PI, TWO_PI) - PI


def world(c: dict, device="cpu"):
    """(landmarks (M, 2), waypoints (W, 3)) float32: two rings of
    cylinders and the waypoint ring that weaves between them, from the
    configuration's numbers."""
    d = torch.float64

    def ring(n, r, offset=0.0):
        a = torch.arange(n, dtype=d) * (TWO_PI / n) + offset
        return torch.stack([r * torch.cos(a), r * torch.sin(a)], dim=-1)

    lms = torch.cat([ring(c["ring_outer"], c["r_outer"]),
                     ring(c["ring_inner"], c["r_inner"], c["inner_offset"])])
    n = c["waypoint_count"]
    a = torch.arange(n, dtype=d) * (TWO_PI / n)
    r = torch.where(torch.arange(n) % 2 == 0, c["waypoint_r_out"],
                    c["waypoint_r_in"]).to(d)
    wpts = torch.stack([r * torch.cos(a), r * torch.sin(a), a + PI / 2], -1)
    return (lms.to(torch.float32).to(device),
            wpts.to(torch.float32).to(device))


class State(NamedTuple):
    """One seed's loop state: poses are [x, y, θ] (the plant) and [θ, x,
    y] (odometry and the filter); the decisions are host integers."""

    true_pose: torch.Tensor   # (3,)
    odom: torch.Tensor        # (3,)
    mu: torch.Tensor          # (3 + 2n,) filter mean
    cov: torch.Tensor         # (3 + 2n, 3 + 2n)
    active: List[bool]        # (n,) slots in use
    count: int                # landmarks added
    u: torch.Tensor           # (N, 2) nominal controls
    wpt_idx: int
    visits: int
    ticks: int                # keys the solve's Philox stream
    done: bool
    host_ticks: int           # the sensor schedule


# ── the loop ──

def aim(c: dict, st: State, waypoints):
    """The tick's part before the solve: (the filter's pose as [x, y, θ],
    the waypoint steered to (3,), wpt_idx, visits, done, near-tie: the
    distance to the goal at its threshold)."""
    est = torch.stack([st.mu[1], st.mu[2], st.mu[0]])
    w = waypoints.to(st.mu.dtype)
    nw = w.shape[0]
    d2g = torch.hypot(est[0] - w[st.wpt_idx, 0], est[1] - w[st.wpt_idx, 1])
    arrived = bool(d2g < c["goal_thresh"])
    tie = abs(float(d2g) - c["goal_thresh"]) < c["tie_goal_m"]
    visits = st.visits + int(arrived)
    idx = (st.wpt_idx + 1) % nw if arrived else st.wpt_idx
    done = st.done or visits >= c["cycles"] * nw
    return est, w[idx], idx, visits, done, tie


def plant(c: dict, pose, wheel, dt: float):
    """One classical RK4 step of the kinematic cart: [x, y, θ] under wheel
    speeds [ul, ur] (θ moves linearly, so the four stages fold into
    c1 + 4·c2 + c4)."""
    r, b = c["wheel_radius"], c["wheel_base"]
    v = (r / 2.0) * (wheel[0] + wheel[1])
    w = (r / b) * (wheel[1] - wheel[0])
    th = pose[2]
    cs = torch.cos(th) + 4.0 * torch.cos(th + 0.5 * dt * w) + torch.cos(
        th + dt * w)
    sn = torch.sin(th) + 4.0 * torch.sin(th + 0.5 * dt * w) + torch.sin(
        th + dt * w)
    return torch.stack([pose[0] + (dt / 6.0) * v * cs,
                        pose[1] + (dt / 6.0) * v * sn, th + dt * w])


def motion(pose, u):
    """Odometry's unicycle step of a [θ, x, y] pose by the twist [ω, vx],
    exact integration, θ first (ref: EKF::motionUpdate
    ekf_filter.cpp:500-533)."""
    om, vx = u[0], u[1]
    th = wrap(pose[0] + om)
    if abs(float(om)) < 1e-12:
        dx, dy = vx * torch.cos(th), vx * torch.sin(th)
    else:
        k = vx / om
        dx = -k * torch.sin(th) + k * torch.sin(th + om)
        dy = k * torch.cos(th) - k * torch.cos(th + om)
    return torch.stack([th, pose[1] + dx, pose[2] + dy])


def twist(c: dict, cmd, done: bool):
    """The odometry's twist [ω·dt + bias, v·dt + bias] of a tick that ran
    the wheel speeds ``cmd``, zero once the course is done."""
    if done:
        return torch.zeros(2, dtype=cmd.dtype, device=cmd.device)
    r, b, dt = c["wheel_radius"], c["wheel_base"], c["tick_dt"]
    bias = c["odom_bias"]
    return torch.stack([(r / b) * (cmd[1] - cmd[0]) * dt + bias[0],
                        0.5 * r * (cmd[0] + cmd[1]) * dt + bias[1]])


def sense(c: dict, true_pose, landmarks, normals, fit):
    """The sensing tick's measurements at the plant's pose [x, y, θ]: (the
    (C, 2) robot-frame circle centres, NaN rows for empty slots, the scan's
    or the detector's near-tie)."""
    meas, tie, _ = sense_either(c, true_pose, landmarks, normals, fit)
    return meas, tie


def sense_either(c: dict, true_pose, landmarks, normals, fit):
    """:func:`sense`, and the circles had every grazing ray gone the other
    way (None where no ray grazes). A grazing ray may hit or miss by
    rounding: where that changes which slots hold a circle it is a
    near-tie, and otherwise it moves a circle by up to millimetres, so
    either set of circles is the scan's."""
    txy = torch.stack([true_pose[2], true_pose[0], true_pose[1]])
    ranges, flipped, tie = scan(c, txy, landmarks, normals)
    centers, valid, fit_tie = detect(c, ranges, fit)
    alt = None
    if flipped is not None:
        alt, other, other_tie = detect(c, flipped, fit)
        tie = tie or other_tie or bool((other != valid).any())
    return (torch.where(valid[:, None], centers, math.nan),
            tie or fit_tie, alt)


def act(c: dict, st: State, aimed, u_new, normals, landmarks, fit):
    """The tick's part after the solve (``u_new`` (N, 2): the updated
    controls before the shift; ``normals``: the scan's standard normals on
    a sensing tick). Returns (state, near-tie, the tick's decisions: the
    slot each measurement row updated or added, or -1)."""
    _, _, idx, visits, done, _ = aimed
    cmd = torch.zeros_like(u_new[0]) if done else u_new[0]
    tail = torch.tensor([c["ul_init"], c["ur_init"]], dtype=u_new.dtype,
                        device=u_new.device)
    u = torch.cat([u_new[1:], tail[None]])
    true_pose = (st.true_pose if done else
                 plant(c, st.true_pose, cmd, c["tick_dt"]))
    u_odom = twist(c, cmd, done)
    odom = motion(st.odom, u_odom)
    tie = False
    meas = st.mu.new_empty((0, 2))
    if st.host_ticks % c["sensor_every"] == 0:
        meas, tie = sense(c, true_pose, landmarks, normals, fit)
    mu, cov, active, count, da_tie, rows = ekf_step(
        c, st.mu, st.cov, st.active, st.count, meas, u_odom)
    return st._replace(true_pose=true_pose, odom=odom, mu=mu, cov=cov,
                       active=active, count=count, u=u, wpt_idx=idx,
                       visits=visits, ticks=st.ticks + 1, done=done,
                       host_ticks=st.host_ticks + 1), tie or da_tie, rows


# ── the sensor ──

def scan(c: dict, pose_txy, centers, normals):
    """(ranges (beams,), the ranges with every grazing ray's hit flipped or
    None where no ray grazes, near-tie): rays from ``pose_txy`` [θ, x, y]
    to the first cylinder each meets (``range_max`` where none), plus
    ``scan_noise`` times ``normals``, clamped to ``range_max``. A ray that
    grazes a cylinder may hit or miss it by rounding; a range at either end
    of the valid span may fall on either side (the near-tie)."""
    dtype = pose_txy.dtype
    ang = pose_txy[0] + c["beam_min"] + c["beam_delta"] * torch.arange(
        c["beams"], dtype=dtype, device=pose_txy.device)
    d = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)    # (B, 2)
    oc = centers.to(dtype) - pose_txy[1:]                         # (M, 2)
    along = (d[:, None, :] * oc[None, :, :]).sum(-1)             # (B, M)
    perp2 = (oc * oc).sum(-1)[None, :] - along * along
    disc = c["cyl_radius"] ** 2 - perp2
    t = along - torch.sqrt(torch.clamp(disc, min=0.0))
    hit = (disc >= 0.0) & (along > 0.0) & (t > 0.0)
    graze = (disc.double().abs() < c["tie_disc_m2"]) & (along > 0.0)

    def ranges_of(hits):
        r = torch.where(hits, t, math.inf).amin(dim=-1)
        return torch.clamp(r + c["scan_noise"] * normals.to(dtype),
                           max=c["range_max"])

    ranges = ranges_of(hit)
    ends = ((ranges.double() - c["range_min"]).abs() < c["tie_range_m"]) | (
        (ranges.double() - c["range_max"]).abs().lt(c["tie_range_m"]) &
        (ranges < c["range_max"]))
    flipped = ranges_of(hit ^ graze) if bool(graze.any()) else None
    return ranges, flipped, bool(ends.any())


def _clusters(c: dict, pts, valid):
    """Each beam's cluster id (-1 off the valid beams) by the reference's
    sequential pass: a valid endpoint more than ``epsilon`` from the
    previous valid one opens a cluster; the last cluster joins the first
    where the scan's first and last valid endpoints lie within
    ``epsilon``. Also whether a distance lay at ``epsilon``."""
    eps, margin = c["epsilon"], c["tie_cluster_m"]
    xy = pts.double().tolist()
    ok = valid.tolist()
    ids, cur, prev, tie = [-1] * len(ok), 0, None, False
    for i, (p, v) in enumerate(zip(xy, ok)):
        if not v:
            continue
        if prev is not None:
            dist = math.hypot(p[0] - prev[0], p[1] - prev[1])
            tie |= abs(dist - eps) < margin
            cur += dist > eps
        ids[i], prev = cur, p
    on = [i for i, v in enumerate(ok) if v]
    if on:
        f, last = on[0], on[-1]
        dist = math.hypot(xy[f][0] - xy[last][0], xy[f][1] - xy[last][1])
        tie |= abs(dist - eps) < margin
        if dist <= eps and ids[f] != ids[last]:
            ids = [ids[f] if k == ids[last] else k for k in ids]
    return ids, tie


def _fit(z_rows, z_bar, dtype):
    """The hyper-accurate algebraic circle fit (ref: composeCircle
    landmarks.cpp:99-237) of a batch of point sets, each a (P, 4) matrix
    Z of rows [z, x, y, 1] (zero rows pad it, which change neither its
    singular values nor its right vectors): (a, b, R) in the centroid's
    frame."""
    _, sig, vh = torch.linalg.svd(z_rows, full_matrices=False)
    v = vh.transpose(-1, -2)                       # columns: right vectors
    a_small = v[..., :, 3]                          # the null vector
    y = (v * sig[..., None, :]) @ vh                # Y = V Σ Vᵀ
    hinv = torch.zeros(z_rows.shape[0], 4, 4, dtype=dtype)
    hinv[:, 0, 3] = hinv[:, 3, 0] = 0.5
    hinv[:, 1, 1] = hinv[:, 2, 2] = 1.0
    hinv[:, 3, 3] = -2.0 * z_bar
    q = y @ hinv @ y
    ev, w = torch.linalg.eigh(0.5 * (q + q.transpose(-1, -2)))
    pick = torch.argmin(torch.where(ev > 0.0, ev, math.inf), dim=-1)
    a_star = w[torch.arange(w.shape[0]), :, pick]
    # A = Y⁻¹A* through Y = V Σ Vᵀ, singular values under the precision's
    # reach (a least-squares solve's cut) dropped.
    cut = torch.finfo(dtype).eps * 4 * sig[..., :1]
    inv = torch.where(sig >= cut, 1.0 / sig, 0.0)
    a_gen = (v @ (inv * (vh @ a_star[..., None])[..., 0])[..., None])[..., 0]
    a = torch.where((sig[..., 3] < 1e-12)[..., None], a_small, a_gen)
    cx = -a[..., 1] / (2.0 * a[..., 0])
    cy = -a[..., 2] / (2.0 * a[..., 0])
    r2 = (a[..., 1] ** 2 + a[..., 2] ** 2 - 4.0 * a[..., 0] * a[..., 3]) / (
        4.0 * a[..., 0] ** 2)
    return cx, cy, torch.sqrt(torch.clamp(r2, min=0.0))


def detect(c: dict, ranges, fit=torch.float64):
    """The scan's circles: ((C, 2) robot-frame centres and (C,) validity
    of the ``max_clusters`` slots, near-tie). The endpoints in the scan's
    dtype, the fit in ``fit``, the centres rounded back."""
    dtype, dev = ranges.dtype, ranges.device
    ang = c["beam_min"] + c["beam_delta"] * torch.arange(
        c["beams"], dtype=dtype, device=dev)
    valid = (ranges >= c["range_min"]) & (ranges < c["range_max"])
    pts = torch.stack([ranges * torch.cos(ang), ranges * torch.sin(ang)], -1)
    ids, tie = _clusters(c, pts, valid)
    n_slots = c["max_clusters"]
    members = [[] for _ in range(n_slots)]
    for i, k in enumerate(ids):
        if k >= 0:
            members[min(k, n_slots - 1)].append(i)
    used = [j for j, m in enumerate(members) if len(m) >= c["min_points"]]
    centers = torch.full((n_slots, 2), math.nan, dtype=dtype, device=dev)
    ok = torch.zeros(n_slots, dtype=torch.bool, device=dev)
    if not used:
        return centers, ok, tie
    p64 = pts.to("cpu", fit)
    size = max(len(members[j]) for j in used)
    z_rows = torch.zeros(len(used), size, 4, dtype=fit)
    cents, z_bar = [], []
    for row, j in enumerate(used):
        p = p64[members[j]]
        cen = p.sum(dim=0) / len(members[j])
        q = p - cen
        zz = (q * q).sum(-1)
        z_rows[row, :len(members[j])] = torch.stack(
            [zz, q[:, 0], q[:, 1], torch.ones_like(zz)], -1)
        cents.append(cen)
        z_bar.append(zz.sum() / len(members[j]))
    with exact():
        a, b, r = _fit(z_rows, torch.stack(z_bar), fit)
    cen = torch.stack(cents)
    got = torch.stack([cen[:, 0] + a, cen[:, 1] + b], -1).to(dtype)
    r = r.to(dtype)
    keep = (r <= c["radius_thresh"]) & torch.isfinite(got).all(-1)
    tie |= bool(((r.double() - c["radius_thresh"]).abs()
                 < c["tie_radius_m"]).any())
    idx = torch.tensor(used, device=dev)
    centers[idx] = got.to(dev)
    ok[idx] = keep.to(dev)
    centers = torch.where(ok[:, None], centers, math.nan)
    return centers, ok, tie


# ── the filter ──

def _h(mu, slots, heading):
    """Range-bearing model at landmark ``slots`` (J,) from the heading
    ``heading``: (ẑ (J, 2) = (range, bearing), the Jacobian's nonzero
    (J, 2, 5) block, its columns (J, 5): [0, 1, 2, jx, jy])
    (ref: ekf_filter.cpp:569-624)."""
    cols = torch.tensor([[0, 1, 2, 3 + 2 * j, 4 + 2 * j] for j in slots],
                        device=mu.device)
    d = mu[cols[:, 3:]] - mu[1:3]                             # (J, 2)
    q = (d * d).sum(-1)
    sq = torch.sqrt(q)
    e, f = d / sq[:, None], d / q[:, None]
    zero = torch.zeros_like(q)
    block = torch.stack([
        torch.stack([zero, -e[:, 0], -e[:, 1], e[:, 0], e[:, 1]], -1),
        torch.stack([zero - 1.0, f[:, 1], -f[:, 0], -f[:, 1], f[:, 0]], -1),
    ], -2)
    bearing = wrap(torch.atan2(d[:, 1], d[:, 0]) - heading)
    return torch.stack([sq, bearing], -1), block, cols


def _inv2(m):
    """Inverses of (..., 2, 2) matrices, in closed form."""
    det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    adj = torch.stack([torch.stack([m[..., 1, 1], -m[..., 0, 1]], -1),
                       torch.stack([-m[..., 1, 0], m[..., 0, 0]], -1)], -2)
    return adj / det[..., None, None]


def ekf_step(c: dict, mu, cov, active, count, meas, u):
    """One SLAM step with unknown data association (ref: EKF::SLAM
    ekf_filter.cpp:112-294): the prediction by the twist ``u``, then each
    finite row of ``meas`` (M, 2) (robot-frame landmark positions) in
    order: its Mahalanobis distance to every tracked landmark; d* ≤ dmin
    updates the nearest, d* ≥ dmax adds one (with capacity left), anything
    between is ignored. Returns (μ, Σ, active, count, near-tie, each row's
    slot updated or added, -1 where ignored or invalid)."""
    e, tol = c, c["tie_gate_rel"]
    n = e["landmark_capacity"]
    active = list(active)
    with exact():
        cov = 0.5 * (cov + cov.T)
        om, vx = u[0], u[1]
        th = mu[0]
        if abs(float(om)) < 1e-12:
            g10, g20 = -vx * torch.sin(th), vx * torch.cos(th)
        else:
            k = vx / om
            g10 = -k * torch.cos(th) + k * torch.cos(th + om)
            g20 = -k * torch.sin(th) + k * torch.sin(th + om)
        g = torch.eye(mu.shape[0], dtype=mu.dtype, device=mu.device)
        g[1, 0], g[2, 0] = g10, g20
        q = torch.zeros_like(mu)
        q[:3] = torch.tensor(e["motion_noise"], dtype=mu.dtype,
                             device=mu.device)
        cov = g @ cov @ g.T + torch.diag(q)
        mu = torch.cat([motion(mu[:3], u), mu[3:]])
        r_mat = torch.diag(torch.tensor(e["measurement_noise"],
                                        dtype=mu.dtype, device=mu.device))
        eye = torch.eye(mu.shape[0], dtype=mu.dtype, device=mu.device)
        tie, rows = False, []
        valid = torch.isfinite(meas).all(dim=-1).tolist()
        ranges = torch.hypot(meas[:, 0], meas[:, 1])
        bearings = torch.atan2(meas[:, 1], meas[:, 0])
        for i, ok in enumerate(valid):
            if not ok:
                rows.append(-1)
                continue
            z = torch.stack([ranges[i], wrap(bearings[i])])
            heading = wrap(mu[0])
            cov = 0.5 * (cov + cov.T)
            d2 = [math.inf] * n
            on = [j for j in range(n) if active[j]]
            if on:
                z_hat, block, cols = _h(mu, on, heading)
                sub = cov[cols[:, :, None], cols[:, None, :]]     # (J, 5, 5)
                psi = block @ sub @ block.transpose(1, 2) + r_mat
                dz = torch.stack([z[0] - z_hat[:, 0],
                                  wrap(z[1] - z_hat[:, 1])], -1)
                v = (dz[:, None, :] @ _inv2(psi) @ dz[:, :, None])[:, 0, 0]
                for j, x in zip(on, v.tolist()):
                    d2[j] = (math.inf if not math.isfinite(x) or x < -1e-6
                             else max(x, 0.0))
            order = sorted(range(n), key=lambda k: d2[k])
            dstar = 1e12 if count == 0 else d2[order[0]]
            tie |= (abs(dstar - e["dmin"]) <= tol * e["dmin"] or
                    abs(dstar - e["dmax"]) <= tol * e["dmax"])
            if dstar <= e["dmin"]:
                j = order[0]
                tie |= d2[order[1]] - dstar <= tol * max(dstar, 1.0)
            elif dstar >= e["dmax"] and count < n:
                j = count
                a = bearings[i] + mu[0]
                mu = mu.clone()
                mu[3 + 2 * j:5 + 2 * j] = mu[1:3] + z[0] * torch.stack(
                    [torch.cos(a), torch.sin(a)])
                active[j] = True
                count += 1
            else:
                rows.append(-1)
                continue
            rows.append(j)
            z_hat, block, cols = _h(mu, [j], heading)
            h = torch.zeros(2, mu.shape[0], dtype=mu.dtype, device=mu.device)
            h[:, cols[0]] = block[0]
            psi = h @ cov @ h.T + r_mat
            gain = cov @ h.T @ _inv2(psi)
            dz = torch.stack([z[0] - z_hat[0, 0], wrap(z[1] - z_hat[0, 1])])
            mu = mu + gain @ dz
            ikh = eye - gain @ h
            cov = ikh @ cov @ ikh.T + gain @ r_mat @ gain.T
    return mu, cov, active, count, tie, rows
