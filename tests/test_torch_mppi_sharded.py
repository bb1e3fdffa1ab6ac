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
from tpunav_torch.parallel import (mppi_solve_fused_sharded,
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
