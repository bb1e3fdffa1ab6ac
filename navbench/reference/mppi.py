"""The plain MPPI solve and course tick that the MPPI cells are held to.

Written from the method (MPPI with the receding shift, the diff-drive
kinematic cart under classical RK4, the waypoint cycle of the pentagon
course) in plain PyTorch, over a batch of S independent solves, in a
chosen precision: float64 for the reference, bfloat16 for the control.
The perturbations come from the frozen Philox stream (``philox.py``), keyed
as the fused solve keys them, so the reference needs only each solve's
seed. Nothing here imports the program.

A solve's costs tell which rows a float32 program may settle otherwise.
Each cost-to-go J may lie ε from its exact value: the float32 solve's own
distance from the float64 one, three times over (a program rounds in
another order), plus max(16, N − t) float32 ulps for row t's sum of N − t
losses. A row whose two best rollouts lie within the sum of their ε is a
near-tie (rounding may swap them), and every other row may move by the
first-order slack Σ w·ε·|z − ū| / λ.
"""

from __future__ import annotations

import torch

from . import philox

NEAR_TIE_ULPS = 16


def _ulp32(v):
    """float32 spacing at |v|, in v's dtype."""
    e = torch.frexp(v.abs().to(torch.float32)).exponent
    return torch.ldexp(torch.ones_like(v), (e - 24).to(torch.int32))


def noise(c: dict, seeds, k: int, dtype=torch.float64):
    """(S, N, K, 2) perturbations of the solves keyed by ``seeds`` (S,)."""
    z = philox.mppi_noise(seeds, k, c["steps"], c["ul_var"] ** 0.5,
                          c["ur_var"] ** 0.5)
    return z.to(dtype)


def costs(c: dict, u, pose, xd, z):
    """(S, N, K) cost-to-go of every rollout: u (S, N, 2) nominal controls,
    pose and xd (S, 3) [x, y, θ], z (S, N, K, 2) perturbations; the last
    row's loss is the terminal loss, which replaces the running loss."""
    r, b = c["wheel_radius"], c["wheel_base"]
    dt, n = c["dt"], c["steps"]
    q, rr, p1 = c["Q"], c["R"], c["P1"]
    k = z.shape[2]
    x = pose[:, 0, None].expand(-1, k)
    y = pose[:, 1, None].expand(-1, k)
    th = pose[:, 2, None].expand(-1, k)
    rows = []
    for t in range(n):
        ul = u[:, t, 0, None] + z[:, t, :, 0]
        ur = u[:, t, 1, None] + z[:, t, :, 1]
        w = (r / b) * (ur - ul)
        v = (r / 2.0) * (ul + ur)
        # RK4 of x' = v cos θ, y' = v sin θ, θ' = w: θ moves linearly.
        c1, c2, c4 = (torch.cos(th), torch.cos(th + 0.5 * dt * w),
                      torch.cos(th + dt * w))
        s1, s2, s4 = (torch.sin(th), torch.sin(th + 0.5 * dt * w),
                      torch.sin(th + dt * w))
        x = x + (dt / 6.0) * v * (c1 + 4.0 * c2 + c4)
        y = y + (dt / 6.0) * v * (s1 + 4.0 * s2 + s4)
        th = th + dt * w
        ex = x - xd[:, 0, None]
        ey = y - xd[:, 1, None]
        et = th - xd[:, 2, None]
        if t == n - 1:
            loss = p1[0] * ex * ex + p1[1] * ey * ey + p1[2] * et * et
        else:
            loss = (q[0] * ex * ex + q[1] * ey * ey + q[2] * et * et +
                    rr[0] * ul * ul + rr[1] * ur * ur)
        rows.append(loss)
    loss = torch.stack(rows, dim=1)                          # (S, N, K)
    return torch.flip(torch.cumsum(torch.flip(loss, (1,)), 1), (1,))


def update(c: dict, u, z, j):
    """The softmax update and clamp: (S, N, 2) controls before the shift."""
    m = torch.amin(j, dim=2, keepdim=True)
    w = torch.exp((m - j) / c["lambda"]) + 1e-8
    w = w / torch.sum(w, dim=2, keepdim=True)
    u_new = u + torch.einsum("snk,snkc->snc", w, z)
    lim = c["max_wheel_vel"]
    return torch.clamp(u_new, -lim, lim)


def solve(c: dict, u, seeds, pose, xd, k: int, dtype=torch.float64):
    """S solves in ``dtype``: the (S, N, 2) updated controls before the
    shift (row 0 is the wheel command)."""
    z = noise(c, seeds, k, dtype)
    u, pose, xd = (t.to(dtype) for t in (u, pose, xd))
    return update(c, u, z, costs(c, u, pose, xd, z))


def solve_with_slack(c: dict, u, seeds, pose, xd, k: int):
    """S float64 solves with, per row, whether it is a near-tie (S, N) and
    the slack (S, N, 2) of every other row (the module's docstring)."""
    d = torch.float64
    z32 = noise(c, seeds, k, torch.float32)
    j32 = costs(c, u.float(), pose.float(), xd.float(), z32)
    z = z32.to(d)
    u, pose, xd = (t.to(d) for t in (u, pose, xd))
    j = costs(c, u, pose, xd, z)
    u_new = update(c, u, z, j)
    n = c["steps"]
    ulps = torch.clamp(n - torch.arange(n, device=j.device, dtype=d),
                       min=NEAR_TIE_ULPS)[None, :, None]
    eps = 3.0 * (j32.to(d) - j).abs() + ulps * _ulp32(j)
    best = torch.topk(j, min(2, j.shape[2]), dim=2, largest=False)
    two = best.values
    eps2 = torch.gather(eps, 2, best.indices).sum(dim=2)
    tie = ((two[..., -1] - two[..., 0]) < eps2) & (two.shape[2] == 2)
    e = torch.exp((two[..., :1] - j) / c["lambda"])
    w = e / e.sum(dim=2, keepdim=True)
    ubar = torch.einsum("snk,snkc->snc", w, z)
    slack = torch.einsum("snk,snkc->snc", w * eps,
                         (z - ubar[:, :, None]).abs()) / c["lambda"]
    return u_new, tie, slack


def row_excess(got, want, tie, slack):
    """Per solve, the largest amount by which a row of ``got`` lies from
    ``want`` beyond its slack, over the rows that are not near-ties
    (S,); and the near-tie rows' count."""
    err = (got.to(torch.float64) - want).abs() - slack
    err = torch.where(tie[..., None], 0.0, err).clamp(min=0.0)
    return err.amax(dim=(1, 2)), int(tie.sum())


def shift(u_new, u_init=(0.0, 0.0)):
    """The receding-horizon shift of (S, N, 2) controls."""
    tail = torch.tensor(u_init, dtype=u_new.dtype, device=u_new.device)
    return torch.cat([u_new[:, 1:], tail.expand(u_new.shape[0], 1, 2)], 1)


def plant(c: dict, pose, wheel, dt: float):
    """One classical RK4 step of the kinematic cart: (S, 3) [x, y, θ]
    poses under (S, 2) wheel speeds."""
    r, b = c["wheel_radius"], c["wheel_base"]
    v = (r / 2.0) * (wheel[:, 0] + wheel[:, 1])
    w = (r / b) * (wheel[:, 1] - wheel[:, 0])
    th = pose[:, 2]
    cs = torch.cos(th) + 4.0 * torch.cos(th + 0.5 * dt * w) + torch.cos(
        th + dt * w)
    sn = torch.sin(th) + 4.0 * torch.sin(th + 0.5 * dt * w) + torch.sin(
        th + dt * w)
    return torch.stack([pose[:, 0] + (dt / 6.0) * v * cs,
                        pose[:, 1] + (dt / 6.0) * v * sn,
                        th + dt * w], dim=1)
