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

The graphed sharded stepper (``ShardedPFStepper``: ``capture.Graph``'s
CPU path runs the body the card replays) over the same eight updates
gives the eager sharded filter's bits and so meets ``tpunav``'s at the
same bars; drawing from the replicated generator it leaves the eager
filter's state and generator. On one shard it gives ``PFStepper``'s
bits; a state loaded in place reaches its body, a rebound one does not,
and a host-staged mesh makes it raise.
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
from tpunav_torch.parallel import (ShardedPFStepper, ShardMesh,
                                   pf_init_sharded, pf_slam_step_sharded,
                                   rollout_mesh)
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

    # The graphed stepper: the same course and normals; then three updates
    # drawing from the replicated generator beside the eager step's.
    graph = ShardedPFStepper(cfg, mesh, interop.pf_state_shard_from_numpy(
        inp["init"], mesh, device), device=device)
    for (scan, pose, prev), noise in zip(inp["course"], inp["noises"]):
        graph.step(torch.from_numpy(scan), u, torch.from_numpy(pose),
                   torch.from_numpy(prev),
                   noise=tpf.PFNoise(*map(torch.from_numpy, noise)))
    out["graph_course"] = interop.pf_state_gather_to_numpy(graph.state, mesh)
    st = pf_init_sharded(cfg, mesh, seed=7, device=device)
    graph = ShardedPFStepper(cfg, mesh, pf_init_sharded(
        cfg, mesh, seed=7, device=device), device=device)
    for scan, pose, prev in inp["course"][:3]:
        args = (torch.from_numpy(scan), u, torch.from_numpy(pose),
                torch.from_numpy(prev))
        st = step(st, *args)
        graph.step(*args)
    out["graph_draws"] = (interop.pf_state_gather_to_numpy(st, mesh),
                          interop.pf_state_gather_to_numpy(graph.state, mesh),
                          torch.equal(st.generator.get_state(),
                                      graph.state.generator.get_state()))

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


def test_sharded_stepper_equals_the_eager_sharded_filter(sharded):
    """The eight updates through the graphed stepper with tpunav's normals,
    and three drawing from the replicated generator: the eager sharded
    filter's bits in every leaf, the generator's state included."""
    _, got, _ = sharded
    for rank in got:
        for name in _STATE:
            np.testing.assert_array_equal(rank["graph_course"][name],
                                          rank["course"][name])
        eager, graph, same_generator = rank["graph_draws"]
        for name in _STATE:
            np.testing.assert_array_equal(graph[name], eager[name])
        assert same_generator


def test_sharded_stepper_matches_tpunav(sharded):
    _, got, want = sharded
    _hold(got[0]["graph_course"], want)


def _small_filter():
    grid = GridConfig(resolution=0.1, xmin=-2.0, xmax=2.0, ymin=-2.0,
                      ymax=2.0, num_beams=90, beam_delta=2 * math.pi / 90)
    cfg = PFConfig(num_particles=8, k_samples=6,
                   sample_range=(1e-6, 1e-5, 1e-5),
                   motion_noise=(1e-6, 1e-5, 1e-5), grid=grid)
    segs = tlidar.box_segments(-1.5, -1.5, 1.5, 1.5, device="cpu")
    pose, course = np.zeros(3, np.float32), []
    for _ in range(4):
        prev, pose = pose, _true_step(pose)
        scan = tlidar.scan_segments(torch.from_numpy(pose), segs,
                                    num_beams=grid.num_beams,
                                    beam_delta=grid.beam_delta,
                                    max_range=grid.range_max)
        course.append((scan, torch.tensor(U), torch.from_numpy(pose),
                       torch.from_numpy(prev)))
    return cfg, course


def _state_equal(a, b):
    return (all(torch.equal(getattr(a, n), getattr(b, n)) for n in _STATE)
            and torch.equal(a.generator.get_state(),
                            b.generator.get_state()))


def test_one_shard_stepper_equals_pf_stepper():
    """On the one-shard identity mesh the sharded stepper (K4 rebuilding
    the fields from the grids) gives PFStepper's bits over four updates."""
    cfg, course = _small_filter()
    mesh = rollout_mesh(device="cpu")
    one = tpf.PFStepper(cfg, tpf.pf_init(cfg, seed=3, device="cpu"),
                        device="cpu")
    sharded = ShardedPFStepper(cfg, mesh, pf_init_sharded(
        cfg, mesh, seed=3, device="cpu"), device="cpu")
    for args in course:
        assert _state_equal(sharded.step(*args), one.step(*args))


def test_sharded_stepper_loads_a_state_in_place():
    """A stepper given another state through ``load`` keeps the buffers
    and the generator its graph reads, and its next two updates give the
    eager sharded chain's state after four; a stepper whose state is
    rebound instead replays its old buffers, and the check catches it."""
    cfg, course = _small_filter()
    mesh = rollout_mesh(device="cpu")
    step = pf_slam_step_sharded(cfg, mesh)
    st = pf_init_sharded(cfg, mesh, seed=1, device="cpu")
    halfway = None
    for i, args in enumerate(course):
        if i == 2:
            gen = torch.Generator()
            gen.set_state(st.generator.get_state())
            halfway = st._replace(generator=gen)
        st = step(st, *args)

    graph = ShardedPFStepper(cfg, mesh, pf_init_sharded(
        cfg, mesh, seed=9, device="cpu"), device="cpu")
    graph.step(*course[0])
    buffers = [t.data_ptr() for t in graph.state[:-1]]
    generator = graph.state.generator
    graph.load(halfway)
    assert [t.data_ptr() for t in graph.state[:-1]] == buffers
    assert graph.state.generator is generator
    for args in course[2:]:
        graph.step(*args)
    assert _state_equal(graph.state, st)

    rebound = ShardedPFStepper(cfg, mesh, pf_init_sharded(
        cfg, mesh, seed=9, device="cpu"), device="cpu")
    rebound.state = halfway
    for args in course[2:]:
        rebound.step(*args)
    assert not _state_equal(rebound.state, st)


def test_sharded_stepper_refuses_a_host_staged_mesh():
    cfg, _ = _small_filter()
    mesh = ShardMesh(None, 0, 1, torch.device("cpu"), host_staged=True)
    st = pf_init_sharded(cfg, rollout_mesh(device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="host-staged"):
        ShardedPFStepper(cfg, mesh, st, device="cpu")
