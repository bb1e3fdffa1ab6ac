"""The port's P-sharded RBPF (``tpunav_torch.parallel.rbpf_sharded``)
against ``tpunav.parallel``'s on the CPU.

Two spawned gloo ranks run the port's sharded filter once; ``tpunav`` runs
its own on a 2-device submesh of the test session's 8 CPU devices
(tests/conftest.py), at tests/test_rbpf_sharded.py's configuration (P=16,
k=10, 90 beams, 0.1 m cells). Both start from ``tpunav``'s initial state
(carried to each rank's shard by ``interop``), and the ranks take the
normals that ``tpunav``'s keys draw (tests/test_torch_rbpf.py's
``_jax_noise``), so the eight updates are held to tests/
test_rbpf_sharded.py's bars: poses 1e-4, log-weights 1e-3, grids 1e-3.
On the CPU the ranks run kernels K2–K4's plain versions. Also the forced
resample's map exchange, the rebuilt fields, the ranks' agreement, the
split checks and the interop round trip.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from examples_torch import launch
from tpunav_torch import interop
from tpunav_torch.estimation.rbpf import GridConfig, PFConfig
from tpunav_torch.estimation.rbpf import particle_filter as tpf
from tpunav_torch.ops.map_update import edt_batch
from tpunav_torch.parallel import pf_init_sharded, pf_slam_step_sharded
from tpunav_torch.sim import lidar as tlidar

torch.set_num_threads(1)

SHARDS = 2
UPDATES = 8
U = [0.02, 0.01]          # [w, vx] per tick
_STATE = ("poses", "prev_poses", "log_weights", "grids", "dists",
          "prev_scan", "has_prev")


def _true_step(pose):
    th = pose[0] + U[0]
    return np.array([th, pose[1] + U[1] * math.cos(th),
                     pose[2] + U[1] * math.sin(th)], np.float32)


def _inputs():
    """The course, tpunav's initial state and its per-update normals, and
    tpunav's sharded result, as numpy. jax and tpunav are imported here,
    not at the top: the spawned ranks import this module for their target
    and need neither."""
    import jax
    import jax.numpy as jnp

    from test_torch_rbpf import _jax_noise
    from tpunav.estimation.rbpf import GridConfig as JGridConfig
    from tpunav.estimation.rbpf import PFConfig as JPFConfig
    from tpunav.estimation.rbpf.icp import ICPConfig as JICPConfig
    from tpunav.parallel.mesh import rollout_mesh
    from tpunav.parallel.rbpf_sharded import (pf_init_sharded as j_init,
                                              pf_slam_step_sharded as j_step)
    from tpunav.sim.lidar import box_segments, scan_segments

    grid = JGridConfig(resolution=0.1, xmin=-2.0, xmax=2.0, ymin=-2.0,
                       ymax=2.0, num_beams=90, beam_delta=2 * jnp.pi / 90)
    jcfg = JPFConfig(num_particles=16, k_samples=10,
                     sample_range=(1e-6, 1e-5, 1e-5),
                     motion_noise=(1e-6, 1e-5, 1e-5),
                     grid=grid, icp=JICPConfig(max_iter=20))
    mesh = rollout_mesh(jax.devices()[:SHARDS], axis_name="p")
    st = j_init(jcfg, mesh, seed=5)
    init = {name: np.asarray(getattr(st, name)) for name in _STATE}
    step = j_step(jcfg, mesh)
    segs = box_segments(-1.5, -1.5, 1.5, 1.5, jnp.float32)
    true_pose = np.zeros(3, np.float32)
    course, noises = [], []
    for _ in range(UPDATES):
        prev = true_pose
        true_pose = _true_step(true_pose)
        scan = np.array(scan_segments(
            jnp.asarray(true_pose), segs, num_beams=grid.num_beams,
            beam_delta=grid.beam_delta, max_range=grid.range_max))
        course.append((scan, true_pose, prev))
        noises.append(tuple(n.numpy() for n in _jax_noise(jcfg, st.key[0])))
        st = step(st, jnp.asarray(scan), jnp.asarray(U, jnp.float32),
                  jnp.asarray(true_pose), jnp.asarray(prev))
    want = {name: np.asarray(getattr(st, name)) for name in _STATE}
    cfg = interop.config_from_fields(PFConfig, dataclasses.asdict(jcfg))
    return {"cfg": cfg, "init": init, "course": course,
            "noises": noises}, want


def _rank_filter(mesh, device, inp):
    """On each rank: the course from tpunav's state with tpunav's normals,
    the forced resample, the split checks and the interop round trip."""
    cfg, out = inp["cfg"], {}
    u = torch.tensor(U)
    step = pf_slam_step_sharded(cfg, mesh)
    st = interop.pf_state_shard_from_numpy(inp["init"], mesh, device)
    for (scan, pose, prev), noise in zip(inp["course"], inp["noises"]):
        st = step(st, torch.from_numpy(scan), u, torch.from_numpy(pose),
                  torch.from_numpy(prev),
                  noise=tpf.PFNoise(*map(torch.from_numpy, noise)))
    out["course"] = interop.pf_state_gather_to_numpy(st, mesh)
    out["dists_are_edt"] = bool(torch.equal(st.dists,
                                            edt_batch(cfg.grid, st.grids)))

    # tests/test_rbpf_sharded.py:77-104: particle 3 takes all the weight,
    # and its grid carries +1.5, so the exchange must copy its map.
    p_local = cfg.num_particles // mesh.size
    rows = torch.arange(mesh.index * p_local, (mesh.index + 1) * p_local)
    st = pf_init_sharded(cfg, mesh, seed=1, device=device)
    st = st._replace(
        log_weights=torch.where(rows == 3, 0.0, -1e3),
        grids=st.grids + 1.5 * (rows == 3).float()[:, None, None],
        has_prev=torch.tensor(True))
    base = float(mesh.all_gather(st.grids.mean(dim=(1, 2)))[0])
    segs = tlidar.box_segments(-1.5, -1.5, 1.5, 1.5, device=device)
    pose = torch.tensor([0.0, 0.05, 0.0])
    scan = tlidar.scan_segments(pose, segs, num_beams=cfg.grid.num_beams,
                                beam_delta=cfg.grid.beam_delta,
                                max_range=cfg.grid.range_max)
    st = step(st, scan, u, pose, torch.zeros(3))
    out["resample"] = (base, mesh.all_gather(st.grids.mean(dim=(1, 2)))
                       .numpy())

    odd = dataclasses.replace(cfg, num_particles=cfg.num_particles + 1)
    raised = []
    for build in (lambda: pf_init_sharded(odd, mesh, device=device),
                  lambda: pf_slam_step_sharded(odd, mesh)):
        try:
            build()
            raised.append(False)
        except ValueError:
            raised.append(True)
    out["raised"] = raised
    out["round_trip"] = interop.pf_state_gather_to_numpy(
        interop.pf_state_shard_from_numpy(inp["init"], mesh, device), mesh)
    return out


@pytest.fixture(scope="module")
def sharded():
    inp, want = _inputs()
    got = launch(_rank_filter, (inp,), world=SHARDS, device="cpu",
                 backend="gloo", timeout=300)
    return inp, got, want


def _hold(got, want):
    np.testing.assert_allclose(got["poses"], want["poses"], atol=1e-4)
    np.testing.assert_allclose(got["log_weights"], want["log_weights"],
                               atol=1e-3)
    np.testing.assert_allclose(got["grids"], want["grids"], atol=1e-3)


def test_sharded_matches_tpunav(sharded):
    _, got, want = sharded
    _hold(got[0]["course"], want)
    np.testing.assert_array_equal(got[0]["course"]["prev_scan"],
                                  want["prev_scan"])


def test_sharded_matches_the_unsharded_port(sharded):
    """The same eight updates through pf_slam_step in this process."""
    inp, got, _ = sharded
    st = interop.pf_state_from_numpy(inp["init"], device="cpu")
    for (scan, pose, prev), noise in zip(inp["course"], inp["noises"]):
        st = tpf.pf_slam_step(inp["cfg"], st, torch.from_numpy(scan),
                              torch.tensor(U), torch.from_numpy(pose),
                              torch.from_numpy(prev),
                              noise=tpf.PFNoise(*map(torch.from_numpy,
                                                     noise)))
    _hold(got[0]["course"], interop.pf_state_to_numpy(st))


def test_rebuilt_fields_are_edt_of_the_grids(sharded):
    _, got, _ = sharded
    assert all(r["dists_are_edt"] for r in got)


def test_ranks_hold_the_same_bits(sharded):
    _, got, _ = sharded
    for name in _STATE:
        np.testing.assert_array_equal(got[0]["course"][name],
                                      got[1]["course"][name])
    np.testing.assert_array_equal(got[0]["resample"][1],
                                  got[1]["resample"][1])


def test_forced_resample_exchanges_the_map(sharded):
    """Nearly every particle descends from particle 3, whose map lives on
    rank 0: its +1.5 offset dominates the map means. (The resampler draws
    its offset from a normal, so ≥ P−2 clones, as tpunav's test.)"""
    _, got, _ = sharded
    base, means = got[0]["resample"]
    assert (means > base + 0.5).sum() >= len(means) - 2, means


def test_indivisible_particles_raise(sharded):
    _, got, _ = sharded
    assert all(r["raised"] == [True, True] for r in got)


def test_interop_shard_round_trip_is_exact(sharded):
    inp, got, _ = sharded
    for r in got:
        for name in _STATE:
            np.testing.assert_array_equal(r["round_trip"][name],
                                          inp["init"][name])


def test_sharded_entry_point_checks_the_mesh_device():
    """The one-shard identity mesh on the CPU; asking for another device
    than the mesh's raises."""
    from tpunav_torch.parallel import rollout_mesh

    cfg = PFConfig(num_particles=4, k_samples=2,
                   grid=GridConfig(resolution=0.1, num_beams=90,
                                   beam_delta=2 * math.pi / 90))
    mesh = rollout_mesh(device="cpu")
    st = pf_init_sharded(cfg, mesh, device="cpu")
    assert st.poses.shape == (4, 3) and st.grids.shape[0] == 4
    with pytest.raises(ValueError, match="not the mesh's"):
        pf_init_sharded(cfg, mesh, device="meta")
