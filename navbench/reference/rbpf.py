"""The plain RBPF SLAM update that the SLAM cells are held to.

One update of Rao-Blackwellized grid SLAM (the reference's
``bmapping::ParticleFilter::SLAM``): ICP between the scan and the previous
one, each particle's pose proposal (a likelihood-weighted Gaussian fit to k
samples round its ICP mode, or the motion model where ICP fails), the
likelihood-field sweep, each particle's map update with its distance field,
the weights' normalisation and the low-variance resample where N_eff <
P/2. Plain PyTorch in float32, the configuration's precision, frozen here
with the arithmetic of its first port so that the program's kernels are
held to their function and not to themselves; nothing here imports the
program.

``quant`` rounds each stage's output through a lower precision: the
control (bfloat16) puts that reference in the program's place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

PI = math.pi
TWO_PI = 2.0 * math.pi


@dataclasses.dataclass(frozen=True)
class Grid:
    resolution: float = 0.05
    xmin: float = -2.0
    xmax: float = 2.0
    ymin: float = -2.0
    ymax: float = 2.0
    prior: float = 0.5
    prob_occ: float = 0.90
    prob_free: float = 0.35
    max_occ_dist: float = 10.0
    z_hit: float = 0.95
    z_max: float = 0.04
    z_rand: float = 0.01
    sigma_hit: float = 0.5
    num_beams: int = 360
    beam_min: float = 0.0
    beam_delta: float = math.pi / 180.0
    range_min: float = 0.12
    range_max: float = 3.5

    @property
    def width(self) -> int:
        return int(math.ceil((self.xmax - self.xmin) / self.resolution))

    @property
    def height(self) -> int:
        return int(math.ceil((self.ymax - self.ymin) / self.resolution))

    def log_odds(self, p):
        return math.log(p / (1.0 - p))

    @property
    def l_prior(self):
        return self.log_odds(self.prior)

    @property
    def l_occ(self):
        return self.log_odds(self.prob_occ)

    @property
    def l_free(self):
        return self.log_odds(self.prob_free)


@dataclasses.dataclass(frozen=True)
class ICP:
    max_iter: int = 25
    max_corr_dist: float = 0.5
    converged_rmse: float = 0.05
    outlier_thresh: float = 0.05
    outlier_scale: float = 3.0
    transform_eps: float = 1e-3
    min_inlier_frac: float = 0.2
    min_normal_eig: float = 0.05


@dataclasses.dataclass(frozen=True)
class Filter:
    num_particles: int
    k_samples: int
    srr: float
    srt: float
    str_: float
    stt: float
    motion_noise: Tuple[float, float, float]
    sample_range: Tuple[float, float, float]
    scan_lik_min: float
    scan_lik_max: float
    pose_lik_min: float
    pose_lik_max: float
    grid: Grid
    icp: ICP


class State(NamedTuple):
    poses: torch.Tensor        # (P, 3) [theta, x, y]
    prev_poses: torch.Tensor
    log_weights: torch.Tensor  # (P,)
    grids: torch.Tensor        # (P, H, W) log-odds
    dists: torch.Tensor        # (P, H, W) distance field
    prev_scan: torch.Tensor    # (B,)
    has_prev: torch.Tensor     # bool


def identity(x):
    return x


def to_bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


# ── angles, SE(2) ──

def wrap(rad):
    """[-π, π), the reference's formula."""
    shifted = rad + PI
    r = shifted - torch.floor(shifted / TWO_PI) * TWO_PI
    r = torch.where(r < 0, r + TWO_PI, r)
    return r - PI


def compose(a, b):
    ta = a[..., 0]
    ca, sa = torch.cos(ta), torch.sin(ta)
    bx, by = b[..., 1], b[..., 2]
    x = a[..., 1] + ca * bx - sa * by
    y = a[..., 2] + sa * bx + ca * by
    return torch.stack(torch.broadcast_tensors(ta + b[..., 0], x, y), dim=-1)


def apply(t, p):
    c, s = torch.cos(t[..., 0]), torch.sin(t[..., 0])
    return torch.stack([t[..., 1] + c * p[..., 0] - s * p[..., 1],
                        t[..., 2] + s * p[..., 0] + c * p[..., 1]], dim=-1)


# ── ICP: masked nearest neighbours + point-to-line Gauss-Newton ──

def scan_points(g: Grid, ranges):
    n = ranges.shape[0]
    ang = g.beam_min + g.beam_delta * torch.arange(n, dtype=ranges.dtype,
                                                   device=ranges.device)
    valid = (ranges >= g.range_min) & (ranges < g.range_max)
    r = torch.where(valid, ranges, g.range_min)
    return torch.stack([r * torch.cos(ang), r * torch.sin(ang)], -1), valid


def _icp_iteration(c: ICP, T, src, src_ok, dst, dst_ok, n_src):
    n = dst.shape[0]
    big = 1e9
    moved = apply(T, src)
    d2 = torch.sum((moved[:, None, :] - dst[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(dst_ok[None, :], d2, big)
    nn = torch.argmin(d2, dim=1)
    nn_d = torch.sqrt(torch.gather(d2, 1, nn[:, None])[:, 0])
    gate = src_ok & (nn_d <= c.max_corr_dist)
    d_sorted = torch.sort(torch.where(gate, nn_d, big)).values
    cnt = torch.sum(gate.to(torch.int64))
    med = torch.index_select(d_sorted, 0,
                             torch.clamp((2 * cnt) // 5, min=0).reshape(1))[0]
    rej = torch.clamp(c.outlier_scale * med, min=c.outlier_thresh)
    w = (gate & (nn_d <= rej)).to(src.dtype)
    wsum = torch.clamp(torch.sum(w), min=1e-9)
    q = dst[nn]
    prv = torch.clamp(nn - 1, 0, n - 1)
    nxt = torch.clamp(nn + 1, 0, n - 1)
    both = dst_ok[prv] & dst_ok[nxt]
    tang = torch.where(both[:, None], dst[nxt] - dst[prv], torch.zeros_like(q))
    tnorm = torch.linalg.norm(tang, dim=-1, keepdim=True)
    line_ok = tnorm[:, 0] > 1e-9
    tang = tang / torch.clamp(tnorm, min=1e-9)
    normal = torch.stack([-tang[:, 1], tang[:, 0]], dim=-1)
    diff = q - moved
    dnorm = torch.clamp(torch.linalg.norm(diff, dim=-1, keepdim=True),
                        min=1e-9)
    normal = torch.where(line_ok[:, None], normal, diff / dnorm)
    jp = torch.stack([-moved[:, 1], moved[:, 0]], dim=-1)
    a = torch.stack([torch.sum(normal * jp, dim=-1), normal[:, 0],
                     normal[:, 1]], dim=-1)
    b = torch.sum(normal * (q - moved), dim=-1)
    aw = a * w[:, None]
    ata = aw.T @ a + 1e-9 * torch.eye(3, dtype=a.dtype, device=a.device)
    x = torch.linalg.solve_ex(ata, aw.T @ b).result
    T_new = compose(x, T)
    rmse = torch.sum(w * nn_d) / wsum
    nmat = (normal * w[:, None]).T @ normal / wsum
    tr = nmat[0, 0] + nmat[1, 1]
    det = nmat[0, 0] * nmat[1, 1] - nmat[0, 1] * nmat[1, 0]
    disc = torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    return (T_new, rmse, torch.linalg.norm(x), torch.sum(w) / n_src,
            tr / 2.0 - disc)


def icp(c: ICP, src, src_ok, dst, dst_ok, T):
    """(transform, converged) of ``src`` onto ``dst`` from ``T``."""
    n_src = torch.clamp(torch.sum(src_ok.to(src.dtype)), min=1e-9)
    for _ in range(c.max_iter):
        T, rmse, delta, frac, eig = _icp_iteration(c, T, src, src_ok, dst,
                                                   dst_ok, n_src)
    ok = ((rmse <= c.converged_rmse) & (delta <= c.transform_eps)
          & (frac >= c.min_inlier_frac) & (eig >= c.min_normal_eig)
          & (torch.sum(src_ok) > 0))
    T = torch.cat([torch.atan2(torch.sin(T[:1]), torch.cos(T[:1])), T[1:]])
    return T, ok


# ── the scan's beams and each cell's covering beam ──

def _atan(t):
    big = t > 0.41421356237309503
    tr = torch.where(big, (t - 1.0) / (t + 1.0), t)
    z = tr * tr
    r = (((8.05374449538e-2 * z - 1.38776856032e-1) * z
          + 1.99777106478e-1) * z - 3.33329491539e-1) * z * tr + tr
    return torch.where(big, r + PI / 4.0, r)


def atan2(y, x):
    ax, ay = torch.abs(x), torch.abs(y)
    t = torch.minimum(ax, ay) / torch.clamp(torch.maximum(ax, ay), min=1e-30)
    r = _atan(t)
    r = torch.where(ay > ax, PI / 2.0 - r, r)
    r = torch.where(x < 0.0, PI - r, r)
    return torch.where(y < 0.0, -r, r)


def positive_mod(a, period: float):
    q = torch.floor(a * (1.0 / period))
    m = a - q * period
    return torch.where(m >= period, m - period, torch.clamp(m, min=0.0))


def beam_table(g: Grid, ranges):
    """(6, B): range (range_min where invalid), cos, sin, range (−1 where
    invalid), range·cos, range·sin."""
    beam = g.beam_min + g.beam_delta * torch.arange(
        g.num_beams, dtype=ranges.dtype, device=ranges.device)
    valid = (ranges >= g.range_min) & (ranges < g.range_max)
    r = torch.where(valid, ranges, g.range_min)
    cb, sb = torch.cos(beam), torch.sin(beam)
    return torch.stack([r, cb, sb, torch.where(valid, ranges, -1.0),
                        r * cb, r * sb])


def cell_beams(g: Grid, pose):
    """Each cell's range from the sensor and covering beam, (P, H, W)."""
    h, w, res = g.height, g.width, g.resolution
    kw = dict(dtype=pose.dtype, device=pose.device)
    th, px, py = (pose[..., i, None, None] for i in range(3))
    dx = (g.xmin + res * 0.5 - px) + res * torch.arange(w, **kw)
    dy = (g.ymin + res * 0.5 - py) + res * torch.arange(h, **kw)[:, None]
    alpha = positive_mod(atan2(dy, dx) - th - g.beam_min, TWO_PI)
    per_rev = int(round(TWO_PI / g.beam_delta))
    b = torch.floor(alpha * (1.0 / g.beam_delta) + 0.5).long() % per_rev
    return torch.sqrt(dx * dx + dy * dy), b


# ── likelihood field, map update, distance field ──

def likelihood(g: Grid, dists, table, samples):
    """(P, k) log-likelihood of the scan at each sample pose."""
    p, h, w = dists.shape
    var = float(g.sigma_hit) ** 2
    inv_res, nhiv = 1.0 / g.resolution, -0.5 * (1.0 / var)
    zh = float(g.z_hit) / (2.0 * math.pi * var) ** 0.5
    floor_p = float(g.z_rand) / float(g.z_max)
    rm, rcb, rsb = table[3:]
    th = samples[..., 0]
    c0, s0 = torch.cos(th)[..., None], torch.sin(th)[..., None]
    ex = samples[..., 1, None] + c0 * rcb - s0 * rsb
    ey = samples[..., 2, None] + s0 * rcb + c0 * rsb
    ix = torch.clamp(torch.floor((ex - g.xmin) * inv_res), 0, w - 1)
    iy = torch.clamp(torch.floor((ey - g.ymin) * inv_res), 0, h - 1)
    idx = (iy.long() * w + ix.long()).reshape(p, -1)
    d = torch.gather(dists.reshape(p, h * w), 1, idx).reshape(ex.shape)
    pz = zh * torch.exp(nhiv * d * d) + floor_p
    lp = torch.sum(torch.where(rm >= 0.0, torch.log(pz), 0.0), dim=-1)
    any_occ = (dists < g.max_occ_dist).reshape(p, -1).any(1)
    return torch.where(any_occ[:, None], lp, 0.0)


def _dilate3x3(mask):
    h, w = mask.shape[-2:]
    mp = torch.nn.functional.pad(mask, (1, 1, 1, 1))
    out = mask
    for dy in range(3):
        for dx in range(3):
            out = torch.maximum(out, mp[..., dy:dy + h, dx:dx + w])
    return out


def distance_field(g: Grid, grids):
    """Each grid's distance to its nearest occupied cell in meters, capped
    at max_occ_dist; a grid with none reads max_occ_dist."""
    occ = grids >= g.l_occ
    h, w = occ.shape[-2:]
    big = float(h + w + 2)
    init = torch.where(occ, 0.0, big).to(grids.dtype)
    down, up = torch.empty_like(init), torch.empty_like(init)
    carry = torch.full_like(init[..., 0, :], big)
    for i in range(h):
        carry = torch.minimum(init[..., i, :], carry + 1.0)
        down[..., i, :] = carry
    carry = torch.full_like(init[..., 0, :], big)
    for i in range(h - 1, -1, -1):
        carry = torch.minimum(init[..., i, :], carry + 1.0)
        up[..., i, :] = carry
    g2 = torch.minimum(down, up) ** 2
    j = torch.arange(w, device=grids.device, dtype=grids.dtype)
    d2 = None
    for k in range(w):
        cand = (j - k) ** 2 + g2[..., k:k + 1]
        d2 = cand if d2 is None else torch.minimum(d2, cand)
    d = torch.clamp(torch.sqrt(d2.double()).to(grids.dtype) * g.resolution,
                    max=g.max_occ_dist)
    any_occ = occ.flatten(-2).any(-1)[..., None, None]
    return torch.where(any_occ, d, g.max_occ_dist)


def map_update(g: Grid, grids, table, poses):
    """Each particle's grid with the scan folded in, and its distance
    field."""
    p, h, w = grids.shape
    res = g.resolution
    r, cb, sb, rm = table[:4]
    th = poses[:, 0]
    c0, s0 = torch.cos(th)[:, None], torch.sin(th)[:, None]
    ex = poses[:, 1, None] + r * (c0 * cb - s0 * sb)
    ey = poses[:, 2, None] + r * (s0 * cb + c0 * sb)
    inv_res = 1.0 / res
    eix = torch.clamp(torch.floor((ex - g.xmin) * inv_res), 0, w - 1)
    eiy = torch.clamp(torch.floor((ey - g.ymin) * inv_res), 0, h - 1)
    cell = (eiy.long() * w + eix.long()
            + torch.arange(p, device=grids.device)[:, None] * (h * w))
    count = torch.zeros(p * h * w, dtype=torch.float32, device=grids.device)
    count.index_add_(0, cell.reshape(-1),
                     (rm >= 0.0).to(torch.float32).expand(p, -1).reshape(-1))
    count = count.reshape(p, h, w)
    near_end = _dilate3x3((count > 0.5).to(torch.float32)) > 0.5
    r_c, b = cell_beams(g, poses)
    in_fov = b < g.num_beams
    rb = rm[torch.clamp(b, max=g.num_beams - 1)]
    free = in_fov & (r_c < rb - res) & ~near_end
    m = torch.clamp(r_c.new_tensor(res) / (torch.clamp(r_c, min=0.5 * res)
                                           * g.beam_delta),
                    max=float(g.num_beams))
    gnew = (grids + torch.where(free, m * (g.l_free - g.l_prior), 0.0)
            + (g.l_occ - g.l_prior) * count)
    return gnew, distance_field(g, gnew)


# ── the filter ──

def _std(variances, like):
    return torch.sqrt(torch.tensor(variances, dtype=like.dtype)).to(
        like.device)


def _motion(f: Filter, pose, u, normals):
    w = normals * _std(f.motion_noise, pose)
    om, vx = u[0], u[1]
    small = torch.abs(om) < 1e-12
    om_safe = torch.where(small, 1.0, om)
    th = wrap(pose[:, 0] + torch.where(small, 0.0, om) + w[:, 0])
    dx = torch.where(small, vx * torch.cos(th),
                     (-vx / om_safe) * torch.sin(th) +
                     (vx / om_safe) * torch.sin(th + om)) + w[:, 1]
    dy = torch.where(small, vx * torch.sin(th),
                     (vx / om_safe) * torch.cos(th) -
                     (vx / om_safe) * torch.cos(th + om)) + w[:, 2]
    return torch.stack([th, pose[:, 1] + dx, pose[:, 2] + dy], dim=-1)


def _pdf(x, var):
    return torch.exp(-0.5 * x * x / var) / torch.sqrt(2.0 * math.pi * var)


def pose_likelihood(f: Filter, cur, prev, cur_odom, prev_odom):
    def decompose(a, b):
        rot1 = torch.atan2(b[..., 2] - a[..., 2], b[..., 1] - a[..., 1]) \
            - a[..., 0]
        trans = torch.hypot(b[..., 1] - a[..., 1], b[..., 2] - a[..., 2])
        rot2 = wrap(wrap(b[..., 0]) - wrap(a[..., 0]) - rot1)
        return rot1, trans, rot2

    rot1, trans, rot2 = decompose(prev_odom, cur_odom)
    rot1h, transh, rot2h = decompose(prev, cur)
    v1 = f.srr * rot1h ** 2 + f.srt * transh ** 2
    v2 = f.str_ * transh ** 2 + f.stt * (rot1h ** 2 + rot2h ** 2)
    v3 = f.srr * rot2h ** 2 + f.srt * transh ** 2
    tiny = 1e-12
    p1 = _pdf(wrap(wrap(rot1) - wrap(rot1h)), torch.clamp(v1, min=tiny))
    p2 = _pdf(trans - transh, torch.clamp(v2, min=tiny))
    p3 = _pdf(wrap(wrap(rot2) - wrap(rot2h)), torch.clamp(v3, min=tiny))
    return p1 * p2 * p3


def _icp_guess(cur_odom, prev_odom):
    dth = wrap(wrap(cur_odom[0]) - wrap(prev_odom[0]))
    c, s = torch.cos(prev_odom[0]), torch.sin(prev_odom[0])
    dx = cur_odom[1] - prev_odom[1]
    dy = cur_odom[2] - prev_odom[2]
    return torch.stack([dth, c * dx + s * dy, -s * dx + c * dy])


def _gaussian(f: Filter, samples, logp, poses, cur_odom, prev_odom, normals):
    p_scan = torch.clamp(torch.exp(torch.clamp(logp, -60.0, 60.0)),
                         f.scan_lik_min, f.scan_lik_max)
    p_pose = torch.clamp(pose_likelihood(f, samples, poses[:, None, :],
                                         cur_odom, prev_odom),
                         f.pose_lik_min, f.pose_lik_max)
    p = p_scan * p_pose
    eta = torch.sum(p, dim=1)
    mu = torch.sum(samples * p[..., None], dim=1) / eta[:, None]
    mu = torch.cat([wrap(mu[:, :1]), mu[:, 1:]], dim=-1)
    diff = samples - mu[:, None, :]
    sigma = torch.einsum("pki,pkj,pk->pij", diff, diff, p) / eta[:, None,
                                                                 None]
    eye = torch.eye(3, dtype=sigma.dtype, device=sigma.device)
    fac = torch.linalg.cholesky_ex(sigma + 1e-12 * eye)
    chol = torch.where((fac.info == 0)[:, None, None], fac.L, float("nan"))
    new = mu + (chol @ normals[..., None])[..., 0]
    return torch.cat([wrap(new[:, :1]), new[:, 1:]], dim=-1), torch.log(eta)


def draw(f: Filter, generator, device):
    """One update's standard normals, in the order the filter draws them:
    proposal samples (P, k, 3), final pose (P, 3), motion model (P, 3),
    resample offset ()."""
    p, k = f.num_particles, f.k_samples
    kw = dict(generator=generator, dtype=torch.float32, device=device)
    return (torch.randn((p, k, 3), **kw), torch.randn((p, 3), **kw),
            torch.randn((p, 3), **kw), torch.randn((), **kw))


def update(f: Filter, st: State, ranges, u, cur_odom, prev_odom, normals,
           quant=identity):
    """One update from ``st``: (poses, normalised log-weights, grids, dists)
    before the resample, and the resample index."""
    g = f.grid
    z_samples, z_pose, z_motion, z_resample = normals
    src, src_ok = scan_points(g, ranges)
    dst, dst_ok = scan_points(g, st.prev_scan)
    T, conv = icp(f.icp, src, src_ok, dst, dst_ok,
                  _icp_guess(cur_odom, prev_odom))
    ok = conv & st.has_prev
    table = beam_table(g, ranges)
    modes = compose(st.poses, quant(T))
    samples = modes[:, None, :] + z_samples * _std(f.sample_range, st.poses)
    samples = quant(torch.cat([wrap(samples[..., :1]), samples[..., 1:]],
                              dim=-1))
    motion = quant(_motion(f, st.poses, u, z_motion))
    logp = quant(likelihood(g, quant(st.dists), table,
                            torch.cat([samples, motion[:, None, :]], 1)))
    k = f.k_samples
    proposed, log_eta = _gaussian(f, samples, logp[:, :k], st.poses,
                                  cur_odom, prev_odom, z_pose)
    poses = quant(torch.where(ok, proposed, motion))
    lw = st.log_weights + torch.where(ok, log_eta, logp[:, k])
    grids, dists = map_update(g, quant(st.grids), table, poses)
    grids, dists = quant(grids), quant(dists)
    p = f.num_particles
    lw = quant(lw - torch.logsumexp(lw, 0))
    w = torch.exp(lw)
    neff = 1.0 / torch.sum(w * w)
    cum = torch.cumsum(w, 0)
    pts = z_resample / p + torch.arange(p, dtype=w.dtype,
                                        device=w.device) / (p - 1)
    idx = torch.clamp(torch.searchsorted(cum, pts), 0, p - 1)
    idx = torch.where(neff < p / 2, idx, torch.arange(p, device=w.device))
    return poses, lw, grids, dists, idx
