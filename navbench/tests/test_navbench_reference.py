"""Each plain reference against the port at small sizes on the CPU: the
test imports both; the references import nothing of the port."""

import math

import pytest
import torch

from navbench import harness
from navbench.drivers import _mppi, _scans, rbpf_update
from navbench.reference import mppi as ref_mppi
from navbench.reference import philox as ref_philox
from navbench.reference import rbpf as ref_rbpf


@pytest.fixture(scope="module")
def mppi_cfg():
    return harness.config("mppi_pentagon")


def test_philox_stream_is_the_ports(mppi_cfg):
    from tpunav_torch.ops import philox

    for seed in (0, 7, 2 ** 31 - 5, 123456789):
        want = philox.mppi_noise(torch.tensor(seed), 96, 50, 0.9 ** 0.5,
                                 0.9 ** 0.5)
        got = ref_philox.mppi_noise(torch.tensor([seed]), 96, 50,
                                    0.9 ** 0.5, 0.9 ** 0.5)[0]
        assert torch.equal(got, want)


@pytest.mark.parametrize("k", [64, 333])
def test_mppi_solve_agrees_with_the_ports(mppi_cfg, k):
    from tpunav_torch.ops.fused_mppi import mppi_solve_fused

    c = _mppi.plain(mppi_cfg)
    mcfg, model = _mppi.program(mppi_cfg, k)
    gen = torch.Generator().manual_seed(k)
    n = c["steps"]
    u = torch.randn((3, n, 2), generator=gen) * 0.5
    pose = torch.randn((3, 3), generator=gen) * 0.3
    goal = pose + torch.tensor([0.8, -0.4, 0.5])
    seeds = torch.tensor([5, 1 << 20, 2 ** 30 + 3], dtype=torch.int32)
    got = []
    for i in range(3):
        cmd, u_next = mppi_solve_fused(mcfg, model, u[i], seeds[i], pose[i],
                                       goal[i])
        got.append(torch.cat([cmd[None], u_next[:-1]]))
    want, tie, slack = ref_mppi.solve_with_slack(c, u, seeds, pose, goal, k)
    exc, _ = ref_mppi.row_excess(torch.stack(got), want, tie, slack)
    assert float(exc.max()) < 1e-5
    ctl = ref_mppi.solve(c, u, seeds, pose, goal, k, torch.bfloat16)
    exc_ctl, _ = ref_mppi.row_excess(ctl, want, tie, slack)
    assert float(exc_ctl.max()) > 1e-2


def test_plant_agrees_with_the_ports(mppi_cfg):
    from tpunav_torch.models.cart import CartParams, kinematic_cart
    from tpunav_torch.ops.rk4 import rk4_step

    c = _mppi.plain(mppi_cfg)
    model = CartParams(c["wheel_radius"], c["wheel_base"])
    gen = torch.Generator().manual_seed(3)
    pose = torch.randn((5, 3), generator=gen, dtype=torch.float64)
    wheel = torch.randn((5, 2), generator=gen, dtype=torch.float64) * 3
    want = rk4_step(lambda x, u: kinematic_cart(model, x, u), pose, wheel,
                    1 / 60)
    got = ref_mppi.plant(c, pose, wheel, 1 / 60)
    assert torch.allclose(got, want, rtol=0, atol=1e-12)


def test_raycast_agrees_with_the_ports():
    from tpunav_torch.sim.lidar import box_segments, scan_segments

    walls = box_segments(-1.8, -1.8, 1.8, 1.8, device="cpu")
    poses = torch.tensor([[0.3, 0.1, -0.2], [-2.0, 1.0, 0.5],
                          [1.2, -0.4, 0.0]])
    got = _scans.raycast(poses, walls, 360, 0.0, math.pi / 180).clamp(
        max=3.5)
    for q in range(3):
        want = scan_segments(poses[q], walls, num_beams=360, max_range=3.5)
        assert torch.allclose(got[q], want, rtol=0, atol=2e-6)


def test_rbpf_update_agrees_with_the_ports():
    from tpunav_torch.estimation.rbpf import pf_init, pf_slam_step
    from tpunav_torch.estimation.rbpf.particle_filter import PFNoise

    cfg = harness.config("rbpf_config5")
    mix = dict(harness.traffic("rbpf_sessions"), sessions=1,
               updates_per_session=6)
    pf = rbpf_update.program_filter(cfg, 16)
    f = rbpf_update.reference_filter(dict(cfg, num_particles=16))
    gen = torch.Generator().manual_seed(11)
    u, scans, odoms, prevs, starts = _scans.sessions(mix, f.grid, gen,
                                                     torch.device("cpu"))
    st = pf_init(pf, pose=starts[0], seed=4, device="cpu")
    for i in range(6):
        normals = ref_rbpf.draw(f, gen, "cpu")
        pre = ref_rbpf.State(*(t.clone() for t in st[:-1]))
        st = pf_slam_step(pf, st, scans[0, i], u, odoms[0, i], prevs[0, i],
                          noise=PFNoise(*normals))
        poses, lw, grids, dists, idx = ref_rbpf.update(
            f, pre, scans[0, i], u, odoms[0, i], prevs[0, i], normals)
        assert torch.allclose(st.poses, poses[idx], rtol=0, atol=1e-6)
        assert torch.allclose(st.log_weights, lw[idx], rtol=0, atol=1e-4)
        assert torch.allclose(st.grids, grids[idx], rtol=0, atol=1e-4)
        assert torch.allclose(st.dists, dists[idx], rtol=0, atol=1e-6)
