"""The port's K-sharded MPPI (``tpunav_torch.parallel.mppi_sharded``)
against ``tpunav.parallel``'s on the CPU.

Two spawned gloo ranks run the port's sharded solves once, on inputs made
here; ``tpunav`` runs its own on a 2-device submesh of the test session's
8 CPU devices (tests/conftest.py). The plain solve takes ``tpunav``'s
per-shard ``fold_in`` noise, in float64, at tests/test_mppi_sharded.py's
bar (1e-10); the fused solve (kernel K1's plain version on the CPU) takes
``tpunav``'s injected noise, held against ``tpunav``'s fused sharded
kernel in interpret mode at 1e-5. Also the per-shard seeds, the split
checks, the ranks' agreement and the one-shard identity.

The graphed steppers (``FusedShardedStepper``, ``PlainShardedStepper``:
``capture.Graph``'s CPU path runs the bodies the card replays) take the
same noise to the same bars, and in the ranks chain three solves with
the eager sharded solve's bits, the plain one drawing from the rank's
generator, the fused one advancing its device seed; on one shard the
fused stepper gives ``mppi_solve_fused``'s bits. A host-staged mesh makes
them raise, and a sharded solve packs its obstacle table once.
"""

import dataclasses

import numpy as np
import pytest
import torch

from examples_torch import launch
from tpunav_torch import interop
from tpunav_torch.control import mppi as tm
from tpunav_torch.models.cart import CartParams
from tpunav_torch.ops import fused_mppi
from tpunav_torch.control.obstacle_cost import (SegmentCostParams,
                                                segments_from_polygons)
from tpunav_torch.parallel import (FusedShardedStepper, PlainShardedStepper,
                                   ShardMesh, mppi_solve_fused_sharded,
                                   mppi_solve_sharded, rollout_mesh,
                                   shard_seed)

torch.set_num_threads(1)

SHARDS = 2
MODEL = CartParams(0.033, 0.160)
POSE = [0.1, -0.2, 0.3]
# tests/test_mppi_sharded.py's far goal (the controls saturate), and a
# near one whose update stays inside the clamp.
GOALS = {"far": [1.0, 1.0, 0.0], "near": [0.15, -0.15, 0.35]}


def _port_cfg(jcfg):
    return interop.config_from_fields(tm.MPPIConfig,
                                      dataclasses.asdict(jcfg))


def _inputs():
    """Both packages' configurations and ``tpunav``'s results, made here;
    the noise each rank takes, as numpy. jax and tpunav are imported here,
    not at the top: the spawned ranks import this module for their target
    and need neither."""
    import jax
    import jax.numpy as jnp

    from tpunav.control import mppi as jm
    from tpunav.models.cart import CartParams as JCartParams
    from tpunav.parallel import mppi_solve_fused_sharded as j_fused_sharded
    from tpunav.parallel import mppi_solve_sharded as j_sharded
    from tpunav.parallel import rollout_mesh as j_mesh

    jmodel = JCartParams(0.033, 0.160)
    mesh = j_mesh(jax.devices()[:SHARDS])
    plain = jm.MPPIConfig(rollouts=SHARDS * 8, horizon=0.2, dt=0.01)
    k_local = plain.rollouts // SHARDS
    key = jax.random.PRNGKey(11)
    sig = jnp.sqrt(jnp.asarray([plain.ul_var, plain.ur_var], jnp.float64))
    noise = [np.asarray(jax.random.normal(jax.random.fold_in(key, i),
                                          (k_local, plain.steps, 2),
                                          jnp.float64) * sig)
             for i in range(SHARDS)]
    pose = jnp.asarray(POSE, jnp.float64)
    want = {}
    for name, goal in GOALS.items():
        u = jm.init_controls(plain, dtype=jnp.float64)
        cmd, u_next = j_sharded(plain, jmodel, mesh)(
            u, key, pose, jnp.asarray(goal, jnp.float64))
        want[name] = (np.asarray(cmd), np.asarray(u_next))

    fused = jm.MPPIConfig(rollouts=SHARDS * 128, horizon=0.2, dt=0.01)
    sig32 = jnp.sqrt(jnp.asarray([fused.ul_var, fused.ur_var], jnp.float32))
    z = jax.random.normal(jax.random.PRNGKey(5),
                          (fused.steps, fused.rollouts // 128, 128, 2),
                          jnp.float32) * sig32
    fused_want = {}
    for name, goal in GOALS.items():
        solve = j_fused_sharded(fused, jmodel, mesh, with_noise=True,
                                interpret=True)
        cmd, u_next = solve(jm.init_controls(fused, dtype=jnp.float32),
                            jnp.int32(0), jnp.asarray(POSE, jnp.float32),
                            jnp.asarray(goal, jnp.float32), z)
        fused_want[name] = (np.asarray(cmd), np.asarray(u_next))
    z = np.asarray(z).reshape(fused.steps, fused.rollouts, 2)
    return ({"plain": _port_cfg(plain), "plain_noise": noise,
             "fused": _port_cfg(fused), "fused_noise": z},
            {"plain": want, "fused": fused_want})


def _rank_solves(mesh, device, inp):
    """On each rank: the plain and fused sharded solves toward each goal,
    with this rank's slice of the noise, and the split checks."""
    out = {}
    plain, fused = inp["plain"], inp["fused"]
    pose64 = torch.tensor(POSE, dtype=torch.float64)
    noise = torch.from_numpy(inp["plain_noise"][mesh.index])
    k_local = fused.rollouts // mesh.size
    z = torch.from_numpy(np.ascontiguousarray(
        inp["fused_noise"][:, mesh.index * k_local:
                           (mesh.index + 1) * k_local]))
    for name, goal in GOALS.items():
        u = tm.init_controls(plain, dtype=torch.float64, device=device)
        cmd, u_next = mppi_solve_sharded(plain, MODEL, mesh)(
            u, noise, pose64, torch.tensor(goal, dtype=torch.float64))
        out["plain", name] = (cmd.numpy(), u_next.numpy())
        cmd, u_next = mppi_solve_fused_sharded(fused, MODEL, mesh)(
            tm.init_controls(fused, device=device), 0,
            torch.tensor(POSE), torch.tensor(goal), noise=z)
        out["fused", name] = (cmd.numpy(), u_next.numpy())
        # The graphed steppers on the same noise.
        step = PlainShardedStepper(
            plain, MODEL, mesh, tm.init_controls(
                plain, dtype=torch.float64, device=device),
            torch.Generator(), device=device)
        cmd, u_next = step.step(
            pose64, torch.tensor(goal, dtype=torch.float64), noise=noise)
        out["plain_graph", name] = (cmd.numpy().copy(), u_next.numpy().copy())
        step = FusedShardedStepper(fused, MODEL, mesh, tm.init_controls(
            fused, device=device), 0, injected=True, device=device)
        cmd, u_next = step.step(torch.tensor(POSE), torch.tensor(goal),
                                noise=z)
        out["fused_graph", name] = (cmd.numpy().copy(), u_next.numpy().copy())
    out["chains"] = _chains(mesh, device, plain, fused)
    odd = dataclasses.replace(plain, rollouts=4 * mesh.size + 1)
    raised = []
    for build in (mppi_solve_sharded, mppi_solve_fused_sharded):
        try:
            build(odd, MODEL, mesh)
            raised.append(False)
        except ValueError:
            raised.append(True)
    out["raised"] = raised
    return out


def _chains(mesh, device, plain, fused):
    """Three chained solves of each graphed stepper beside the eager
    sharded solve from the same controls: per solve whether (cmd, u_next)
    are the same bits; then whether the generators (plain) or the seeds
    (fused: 7, 8, 9 taken, 10 next) end equal."""
    pose, xd = torch.tensor(POSE), torch.tensor(GOALS["near"])
    offset = torch.tensor([0.5, -0.2])
    rows = {}

    def gen():
        return torch.Generator().manual_seed(20 + mesh.index)

    u = tm.init_controls(plain, device=device) + offset
    eager, g = mppi_solve_sharded(plain, MODEL, mesh), gen()
    graph = PlainShardedStepper(plain, MODEL, mesh, u, gen(), device=device)
    rows["plain"] = []
    for _ in range(3):
        want = eager(u, g, pose, xd)
        u = want[1]
        rows["plain"].append(all(torch.equal(a, b) for a, b in zip(
            graph.step(pose, xd), want)))
    rows["plain"].append(torch.equal(g.get_state(),
                                     graph.generator.get_state()))

    u = tm.init_controls(fused, device=device) + offset
    eager = mppi_solve_fused_sharded(fused, MODEL, mesh)
    graph = FusedShardedStepper(fused, MODEL, mesh, u, 7, device=device)
    rows["fused"] = []
    for i in range(3):
        want = eager(u, 7 + i, pose, xd)
        u = want[1]
        rows["fused"].append(all(torch.equal(a, b) for a, b in zip(
            graph.step(pose, xd), want)))
    rows["fused"].append(int(graph.seed) == 10)
    return np.array(rows["plain"]), np.array(rows["fused"])


@pytest.fixture(scope="module")
def sharded():
    inp, want = _inputs()
    got = launch(_rank_solves, (inp,), world=SHARDS, device="cpu",
                 backend="gloo", timeout=300)
    return got, want


@pytest.mark.parametrize("goal", sorted(GOALS))
def test_plain_sharded_matches_tpunav_in_float64(sharded, goal):
    got, want = sharded
    cmd, u_next = got[0]["plain", goal]
    np.testing.assert_allclose(cmd, want["plain"][goal][0], atol=1e-10)
    np.testing.assert_allclose(u_next, want["plain"][goal][1], atol=1e-10)


@pytest.mark.parametrize("goal", sorted(GOALS))
def test_fused_sharded_matches_tpunav_kernel(sharded, goal):
    """K1's plain version per shard, the partials combined across the
    ranks, against tpunav's fused kernel per shard with its pmin/psum."""
    got, want = sharded
    cmd, u_next = got[0]["fused", goal]
    np.testing.assert_allclose(cmd, want["fused"][goal][0], atol=1e-5)
    np.testing.assert_allclose(u_next, want["fused"][goal][1], atol=1e-5)


def test_ranks_hold_the_same_bits(sharded):
    got, _ = sharded
    for rank in got[1:]:
        for key in [k for k in got[0] if k != "raised"]:
            for a, b in zip(got[0][key], rank[key]):
                np.testing.assert_array_equal(a, b)


def test_indivisible_rollouts_raise(sharded):
    got, _ = sharded
    assert all(r["raised"] == [True, True] for r in got)


@pytest.mark.parametrize("seed", [0, 5, 123456789, 2**31 - 3, -2**31 + 1])
def test_shard_seeds_match_tpunav(seed):
    """seed + idx·(−0x61C88647) in int32 (tpunav/parallel/
    mppi_sharded.py:118) for shards 0–7, from an int and from a tensor."""
    import jax.numpy as jnp

    for idx in range(8):
        want = int(jnp.int32(seed) + jnp.int32(idx) * jnp.int32(-0x61C88647))
        assert shard_seed(seed, idx) == want
        got = shard_seed(torch.tensor(seed, dtype=torch.int32), idx)
        assert got.dtype == torch.int32 and int(got) == want
    assert shard_seed(seed, 0) == seed


def test_one_shard_equals_the_unsharded_port():
    """On the one-shard identity mesh the fused sharded solve gives the
    bits of mppi_solve_fused (in-kernel noise and injected), and the
    plain sharded solve mppi_solve's values from the same generator."""
    mesh = rollout_mesh(device="cpu")
    cfg = tm.MPPIConfig(rollouts=96, horizon=0.2, dt=0.01)
    pose, xd = torch.tensor(POSE), torch.tensor(GOALS["near"])
    u = tm.init_controls(cfg, device="cpu") + torch.tensor([0.5, -0.2])
    z = torch.randn((cfg.steps, cfg.rollouts, 2),
                    generator=torch.Generator().manual_seed(3))
    for noise in (None, z):
        got = mppi_solve_fused_sharded(cfg, MODEL, mesh)(u, 9, pose, xd,
                                                         noise=noise)
        want = fused_mppi.mppi_solve_fused(cfg, MODEL, u, 9, pose, xd,
                                           noise=noise)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)

    u64 = u.double()
    got = mppi_solve_sharded(cfg, MODEL, mesh)(
        u64, torch.Generator().manual_seed(4), pose.double(), xd.double())
    want = tm.mppi_solve(cfg, MODEL, u64, torch.Generator().manual_seed(4),
                         pose.double(), xd.double())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("path,bar", [("plain", 1e-10), ("fused", 1e-5)])
@pytest.mark.parametrize("goal", sorted(GOALS))
def test_graphed_steppers_match_tpunav(sharded, path, goal, bar):
    """The graphed steppers over the two ranks, on tpunav's noise, at the
    eager sharded solves' bars."""
    got, want = sharded
    cmd, u_next = got[0][path + "_graph", goal]
    np.testing.assert_allclose(cmd, want[path][goal][0], atol=bar)
    np.testing.assert_allclose(u_next, want[path][goal][1], atol=bar)


def test_graphed_steppers_chain_the_eager_sharded_solves(sharded):
    """Three chained solves per stepper and rank: the eager sharded
    solve's bits, the generators and the device seed where the eager
    chain leaves them."""
    got, _ = sharded
    for rank in got:
        plain, fused = rank["chains"]
        assert plain.all() and len(plain) == 4, plain
        assert fused.all() and len(fused) == 4, fused


def test_one_shard_graphed_solve_equals_mppi_solve_fused():
    """On the one-shard identity mesh the fused stepper chains
    mppi_solve_fused's bits (seeds 9, 10, 11), in-kernel noise and
    injected."""
    mesh = rollout_mesh(device="cpu")
    cfg = tm.MPPIConfig(rollouts=96, horizon=0.2, dt=0.01)
    pose, xd = torch.tensor(POSE), torch.tensor(GOALS["near"])
    u0 = tm.init_controls(cfg, device="cpu") + torch.tensor([0.5, -0.2])
    z = torch.randn((cfg.steps, cfg.rollouts, 2),
                    generator=torch.Generator().manual_seed(3))
    for noise in (None, z):
        graph = FusedShardedStepper(cfg, MODEL, mesh, u0, 9,
                                    injected=noise is not None,
                                    device="cpu")
        u = u0
        for i in range(3):
            got = graph.step(pose, xd, noise=noise)
            want = fused_mppi.mppi_solve_fused(cfg, MODEL, u, 9 + i, pose,
                                               xd, noise=noise)
            u = want[1]
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_graphed_steppers_refuse_a_host_staged_mesh():
    """gloo on CUDA stages every collective through the host, which no
    graph captures: each stepper's constructor raises on such a mesh."""
    mesh = ShardMesh(None, 0, 1, torch.device("cpu"), host_staged=True)
    cfg = tm.MPPIConfig(rollouts=32, horizon=0.1, dt=0.01)
    u = tm.init_controls(cfg, device="cpu")
    with pytest.raises(ValueError, match="host-staged"):
        FusedShardedStepper(cfg, MODEL, mesh, u, 0, device="cpu")
    with pytest.raises(ValueError, match="host-staged"):
        PlainShardedStepper(cfg, MODEL, mesh, u, torch.Generator(),
                            device="cpu")


def test_sharded_solve_packs_the_obstacles_once(monkeypatch):
    """With obstacles, the sharded solve and the fused stepper pack the
    table when built and never per solve (a host round trip that no graph
    can capture), and solve as mppi_solve_fused does with obstacles."""
    calls = []
    pack = fused_mppi.pack_obstacles
    monkeypatch.setattr(fused_mppi, "pack_obstacles",
                        lambda *a, **k: calls.append(1) or pack(*a, **k))
    mesh = rollout_mesh(device="cpu")
    cfg = tm.MPPIConfig(rollouts=64, horizon=0.2, dt=0.01)
    segs = segments_from_polygons([[[0.2, -0.4], [0.3, -0.4], [0.3, 0.4],
                                    [0.2, 0.4]]], device="cpu")
    obs = SegmentCostParams(r_safe=0.05, w_hit=1e6, w_field=1e2,
                            sigma=0.05)
    pose, xd = torch.tensor(POSE), torch.tensor(GOALS["far"])
    u0 = tm.init_controls(cfg, device="cpu")
    solve = mppi_solve_fused_sharded(cfg, MODEL, mesh, segs, obs)
    graph = FusedShardedStepper(cfg, MODEL, mesh, u0, 4, segs, obs,
                                device="cpu")
    assert len(calls) == 2
    u = u0
    for i in range(3):
        got = solve(u, 4 + i, pose, xd)
        for a, b in zip(graph.step(pose, xd), got):
            assert torch.equal(a, b)
        u = got[1]
    assert len(calls) == 2
    want = fused_mppi.mppi_solve_fused(cfg, MODEL, u0, 4, pose, xd,
                                       obstacles=segs, obs_cfg=obs)
    first = solve(u0, 4, pose, xd)
    assert len(calls) == 3          # mppi_solve_fused packs per call
    for a, b in zip(first, want):
        assert torch.equal(a, b)
