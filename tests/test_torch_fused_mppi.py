"""The fused MPPI solve (kernel K1) of the port against ``tpunav``.

On the CPU the wrapper runs the kernel's plain version, in the kernel's
own decomposition (32-rollout blocks of softmax partials, then the
combine). It is held against ``tpunav.ops.pallas_mppi`` in Pallas
interpret mode with injected noise, at the bars of
``tests/test_pallas_mppi.py`` (rtol 1e-4, atol 1e-5, float32); at a K
that the Pallas kernel does not take (not a multiple of its 128 lanes),
against ``tpunav``'s XLA solver on the same noise. The kernel itself runs
only on a CUDA card, where ``chip_smoke.py`` compares it with this plain
version.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunav.control import mppi as jm
from tpunav.models.cart import CartParams as JCartParams
from tpunav.ops import pallas_mppi as jp
from tpunav_torch.control import mppi as tm
from tpunav_torch.models.cart import CartParams
from tpunav_torch.ops import fused_mppi as fm
from tpunav_torch.ops import philox

torch.set_num_threads(1)

MODEL = CartParams(0.033, 0.160)
J_MODEL = JCartParams(0.033, 0.160)
F32 = jnp.float32
R = fm._BLOCK                  # rollouts per block of the kernel


def _cfgs(k, n):
    kw = dict(horizon=n * 0.01, dt=0.01, rollouts=k)
    return jm.MPPIConfig(**kw), tm.MPPIConfig(**kw)


def _inputs(cfg, seed, u_off=(0.0, 0.0), pose=(0.1, -0.2, 0.3),
            xd=(1.0, 1.0, 0.0)):
    """float32 numpy inputs; noise in the port's time-major (N, K, 2)."""
    rng = np.random.default_rng(seed)
    sig = np.sqrt([cfg.ul_var, cfg.ur_var])
    noise = (rng.standard_normal((cfg.steps, cfg.rollouts, 2)) * sig
             ).astype(np.float32)
    u = (np.zeros((cfg.steps, 2)) + u_off).astype(np.float32)
    return (u, np.asarray(pose, np.float32), np.asarray(xd, np.float32),
            noise)


def _jax_kernel_noise(noise):
    """(N, K, 2) → the TPU kernel's (N, K/128, 128, 2) layout."""
    n, k, _ = noise.shape
    return jnp.asarray(noise.reshape(n, k // 128, 128, 2), F32)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _tpunav_solve(jcfg, u, pose, xd, noise):
    """``tpunav``'s solve of the same float32 inputs: its Pallas kernel in
    interpret mode where K is a multiple of its 128 lanes, else its XLA
    solver (rollout_losses, cost_to_go, update_controls) on the noise."""
    ju, jpose, jxd = (jnp.asarray(a, F32) for a in (u, pose, xd))
    if jcfg.rollouts % 128 == 0:
        return jp.mppi_solve_fused(jcfg, J_MODEL, ju, 0, jpose, jxd,
                                   noise=_jax_kernel_noise(noise),
                                   interpret=True)
    jnoise = jnp.asarray(noise.transpose(1, 0, 2), F32)      # (K, N, 2)
    loss, _ = jm.rollout_losses(jcfg, J_MODEL, jpose, ju[None] + jnoise, jxd)
    u_new = jm.update_controls(jcfg, ju, jnoise, jm.cost_to_go(loss))
    return u_new[0], jm.shift_controls(jcfg, u_new)


@pytest.mark.parametrize("k,n", [(128, 10), (256, 25)])
def test_fused_plain_matches_tpunav_kernel(k, n):
    jcfg, cfg = _cfgs(k, n)
    u, pose, xd, noise = _inputs(cfg, seed=k, u_off=(0.8, -0.3))
    cmd_j, un_j = jp.mppi_solve_fused(
        jcfg, J_MODEL, jnp.asarray(u, F32), 0, jnp.asarray(pose, F32),
        jnp.asarray(xd, F32), noise=_jax_kernel_noise(noise), interpret=True)
    tu, tpose, txd, tnoise = _torch(u, pose, xd, noise)
    cmd, un = fm.mppi_solve_fused(cfg, MODEL, tu, 0, tpose, txd,
                                  noise=tnoise)
    assert cmd.dtype == torch.float32 and un.shape == (n, 2)
    np.testing.assert_allclose(cmd.numpy(), np.asarray(cmd_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(un.numpy(), np.asarray(un_j), rtol=1e-4,
                               atol=1e-5)


def test_partials_match_tpunav_row_for_row():
    jcfg, cfg = _cfgs(256, 15)
    u, pose, xd, noise = _inputs(cfg, seed=11, u_off=(0.5, -0.2),
                                 pose=(0.05, -0.1, 0.2), xd=(0.8, 0.4, 0.0))
    part_j = np.asarray(jp.mppi_solve_partials(
        jcfg, J_MODEL, jnp.asarray(u, F32), 0, jnp.asarray(pose, F32),
        jnp.asarray(xd, F32), noise=_jax_kernel_noise(noise),
        interpret=True))
    tu, tpose, txd, tnoise = _torch(u, pose, xd, noise)
    part = fm.mppi_solve_partials(cfg, MODEL, tu, 0, tpose, txd,
                                  noise=tnoise)
    assert part.shape == (15, 6)
    np.testing.assert_allclose(part.numpy(), part_j, rtol=1e-4, atol=1e-5)

    # The same partials through both packages' combine.
    halves = []
    for s in range(2):
        half_j = dataclasses.replace(jcfg, rollouts=128)
        halves.append(np.asarray(jp.mppi_solve_partials(
            half_j, J_MODEL, jnp.asarray(u, F32), 0, jnp.asarray(pose, F32),
            jnp.asarray(xd, F32),
            noise=_jax_kernel_noise(noise[:, 128 * s:128 * (s + 1)]),
            interpret=True)))
    stacked = np.stack(halves)
    cmd_j, un_j = jp.combine_softmax_partials(
        jcfg, jnp.asarray(u, F32), jnp.asarray(stacked, F32),
        min_fn=lambda m: jnp.min(m, axis=0),
        sum_fn=lambda x: jnp.sum(x, axis=0))
    cmd, un = fm.combine_softmax_partials(
        cfg, tu, torch.from_numpy(stacked),
        min_fn=lambda m: torch.amin(m, dim=0),
        sum_fn=lambda x: torch.sum(x, dim=0))
    np.testing.assert_allclose(cmd.numpy(), np.asarray(cmd_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(un.numpy(), np.asarray(un_j), rtol=1e-4,
                               atol=1e-5)


def test_partials_of_halves_combine_to_full_solve():
    h = 3 * R + 5                                     # ragged 32-blocks
    cfg = tm.MPPIConfig(horizon=0.2, dt=0.01, rollouts=2 * h)
    u, pose, xd, noise = _inputs(cfg, seed=5, u_off=(0.2, 0.6))
    tu, tpose, txd, tnoise = _torch(u, pose, xd, noise)
    half = dataclasses.replace(cfg, rollouts=h)
    parts = torch.stack([
        fm.mppi_solve_partials(half, MODEL, tu, 0, tpose, txd,
                               noise=tnoise[:, h * s:h * (s + 1)]
                               .contiguous())
        for s in range(2)])
    cmd, un = fm.combine_softmax_partials(
        cfg, tu, parts, min_fn=lambda m: torch.amin(m, dim=0),
        sum_fn=lambda x: torch.sum(x, dim=0))
    cmd_f, un_f = fm.mppi_solve_fused(cfg, MODEL, tu, 0, tpose, txd,
                                      noise=tnoise)
    np.testing.assert_allclose(cmd.numpy(), cmd_f.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(un.numpy(), un_f.numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("k,n", [(1, 70), (R - 1, 70), (R + 1, 70),
                                 (3 * R + 5, 70), (3 * R + 5, 12),
                                 (128, 70)])
def test_block_decomposition_matches_tpunav(k, n):
    """The plain version's 32-rollout blocks, the last one ragged and
    masked, against ``tpunav`` at K ∈ {1, R−1, R+1, 3R+5} and at 128 (its
    Pallas kernel), over a horizon longer than one of the kernel's
    64-step chunks."""
    jcfg, cfg = _cfgs(k, n)
    u, pose, xd, noise = _inputs(cfg, seed=k + n, u_off=(0.4, 0.2))
    cmd_j, un_j = _tpunav_solve(jcfg, u, pose, xd, noise)
    tu, tpose, txd, tnoise = _torch(u, pose, xd, noise)
    cmd, un = fm.mppi_solve_fused(cfg, MODEL, tu, 0, tpose, txd,
                                  noise=tnoise)
    assert fm._solve_partials_reference(
        cfg, MODEL, tu, torch.tensor(0, dtype=torch.int32), tpose, txd,
        tnoise).shape == (-(-k // R), n, 6)
    np.testing.assert_allclose(cmd.numpy(), np.asarray(cmd_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(un.numpy(), np.asarray(un_j), rtol=1e-4,
                               atol=1e-5)


def test_block_partials_merge_to_the_128_block_rows(monkeypatch):
    """The partials of 32-rollout blocks, merged by
    ``combine_softmax_partials``, give the rows and the update of the
    earlier 128-rollout blocks to float32 rounding: the rescaling
    exp((m_g − m_l)/λ) rounds its argument, 100× a cost difference."""
    cfg = tm.MPPIConfig(horizon=0.3, dt=0.01, rollouts=3 * 128 + 5)
    u, pose, xd, noise = _inputs(cfg, seed=9, u_off=(0.3, -0.1))
    tu, tpose, txd, tnoise = _torch(u, pose, xd, noise)
    seed = torch.tensor(0, dtype=torch.int32)
    merged = {}
    for block in (R, 128):
        monkeypatch.setattr(fm, "_BLOCK", block)
        parts = fm._solve_partials_reference(cfg, MODEL, tu, seed, tpose, txd,
                                             tnoise)
        assert parts.shape == (-(-cfg.rollouts // block), cfg.steps, 6)
        rows = fm._combine_rows(cfg, parts, lambda m: torch.amin(m, dim=0),
                                lambda v: torch.sum(v, dim=0))
        merged[block] = (rows, fm.combine_softmax_partials(
            cfg, tu, parts, min_fn=lambda m: torch.amin(m, dim=0),
            sum_fn=lambda v: torch.sum(v, dim=0)))
    (rows_r, (cmd_r, un_r)), (rows_128, (cmd_128, un_128)) = (
        merged[R], merged[128])
    np.testing.assert_array_equal(rows_r[:, 0].numpy(), rows_128[:, 0].numpy())
    np.testing.assert_allclose(rows_r.numpy(), rows_128.numpy(), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(cmd_r.numpy(), cmd_128.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(un_r.numpy(), un_128.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("k", [1, 200])
def test_any_k_matches_plain_solver(k):
    """K need not be a multiple of 32: the ragged block is masked, so the
    fused plain version equals the plain solver at K=1 and K=200."""
    _, cfg = _cfgs(k, 30)
    u, pose, xd, noise = _inputs(cfg, seed=k + 1, u_off=(0.3, 0.1))
    tu, tpose, txd, tnoise = _torch(u, pose, xd, noise)
    cmd_f, un_f = fm.mppi_solve_fused(cfg, MODEL, tu, 0, tpose, txd,
                                      noise=tnoise)
    cmd, un = tm.mppi_solve(cfg, MODEL, tu, None, tpose, txd,
                            noise=tnoise.transpose(0, 1))
    np.testing.assert_allclose(cmd_f.numpy(), cmd.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(un_f.numpy(), un.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert torch.isfinite(un_f).all()


def test_in_kernel_noise_is_the_philox_stream():
    """noise=None keys Philox by the seed: the same seed gives the same
    solve as the stream from ops/philox.py injected; another seed does not."""
    _, cfg = _cfgs(256, 20)
    u, pose, xd, _ = _inputs(cfg, seed=0)
    tu, tpose, txd = _torch(u, pose, xd)
    sig = (cfg.ul_var ** 0.5, cfg.ur_var ** 0.5)
    stream = philox.mppi_noise(17, cfg.rollouts, cfg.steps, *sig)
    _, un_seed = fm.mppi_solve_fused(cfg, MODEL, tu, 17, tpose, txd)
    _, un_inj = fm.mppi_solve_fused(cfg, MODEL, tu, 0, tpose, txd,
                                    noise=stream)
    _, un_other = fm.mppi_solve_fused(cfg, MODEL, tu, 18, tpose, txd)
    assert torch.equal(un_seed, un_inj)
    assert not torch.equal(un_seed, un_other)


def test_seed_tensor_equals_int_seed():
    _, cfg = _cfgs(128, 10)
    u, pose, xd, _ = _inputs(cfg, seed=0)
    tu, tpose, txd = _torch(u, pose, xd)
    a = fm.mppi_solve_fused(cfg, MODEL, tu, 5, tpose, txd)[1]
    b = fm.mppi_solve_fused(cfg, MODEL, tu, torch.tensor(5, dtype=torch.int32),
                            tpose, txd)[1]
    assert torch.equal(a, b)


def test_edge_probes_stay_finite_and_clamped():
    """Zero variance, goal == pose and a far goal (and K=1 above)."""
    _, cfg = _cfgs(128, 20)
    u, pose, _, _ = _inputs(cfg, seed=0)
    tu, tpose = _torch(u, pose)
    cases = [(dataclasses.replace(cfg, ul_var=0.0, ur_var=0.0),
              torch.tensor([1.0, 1.0, 0.0])),
             (cfg, tpose.clone()),
             (cfg, torch.tensor([1e3, -1e3, 0.0]))]
    for c, xd in cases:
        cmd, un = fm.mppi_solve_fused(c, MODEL, tu, 3, tpose, xd)
        assert torch.isfinite(un).all() and torch.isfinite(cmd).all()
        assert un.abs().max() <= c.max_wheel_vel
    zero = fm.mppi_solve_fused(cases[0][0], MODEL, tu, 3, tpose,
                               cases[0][1])[1]
    np.testing.assert_allclose(zero.numpy(), 0.0, atol=0)


def test_cpu_call_leaves_kernel_count_unchanged():
    _, cfg = _cfgs(128, 10)
    u, pose, xd, noise = _inputs(cfg, seed=2)
    before = fm.KERNEL_LAUNCHES
    fm.mppi_solve_fused(cfg, MODEL, *_torch(u), 1, *_torch(pose, xd))
    fm.mppi_solve_partials(cfg, MODEL, *_torch(u), 1, *_torch(pose, xd),
                           noise=torch.from_numpy(noise))
    assert fm.KERNEL_LAUNCHES == before


def test_wrapper_rejects_bad_inputs():
    _, cfg = _cfgs(128, 10)
    u, pose, xd, noise = _torch(*_inputs(cfg, seed=2))
    with pytest.raises(TypeError):
        fm.mppi_solve_fused(cfg, MODEL, u.double(), 0, pose, xd)
    with pytest.raises(ValueError):
        fm.mppi_solve_fused(cfg, MODEL, u[:5], 0, pose, xd)
    with pytest.raises(ValueError):
        fm.mppi_solve_fused(cfg, MODEL, u, 0, pose, xd,
                            noise=noise.transpose(0, 1))
    with pytest.raises(ValueError):
        fm.mppi_solve_fused(cfg, MODEL, u.t().contiguous().t(), 0, pose, xd)
    with pytest.raises(ValueError):     # obstacles without obs_cfg
        fm.mppi_solve_fused(cfg, MODEL, u, 0, pose, xd,
                            obstacles=torch.zeros(1, 5))
    with pytest.raises(ValueError):
        fm.pack_obstacles(torch.zeros(1, 5), None, device="cpu")


# ------------------------------------------------------------ Philox ----

def _words(*vals):
    return tuple(torch.tensor(v, dtype=torch.int64) for v in vals)


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for philox4x32-10."""
    got = philox.philox4x32_10(_words(*ctr), _words(*key))
    assert tuple(int(w) for w in got) == want


def test_philox_box_muller_moments():
    k, n = 4096, 16
    z = philox.mppi_noise(123, k, n, 1.0, 1.0).double()
    assert z.shape == (n, k, 2) and torch.isfinite(z).all()
    m = k * n
    mean = z.reshape(-1, 2).mean(0)
    var = z.reshape(-1, 2).var(0)
    # Within 5σ of their sampling errors (σ_mean = 1/√m, σ_var = √(2/m)).
    assert torch.all(mean.abs() < 5.0 / m ** 0.5)
    assert torch.all((var - 1.0).abs() < 5.0 * (2.0 / m) ** 0.5)
    # The two outputs of a pair are uncorrelated.
    corr = (z[..., 0] * z[..., 1]).mean()
    assert abs(float(corr)) < 5.0 / m ** 0.5
    # Different seeds give different streams; scales apply per wheel.
    assert not torch.equal(philox.mppi_noise(124, k, n, 1.0, 1.0).double(), z)
    scaled = philox.mppi_noise(123, k, n, 0.5, 2.0).double()
    np.testing.assert_allclose(scaled[..., 0].numpy(),
                               0.5 * z[..., 0].numpy(), rtol=1e-6)
    np.testing.assert_allclose(scaled[..., 1].numpy(),
                               2.0 * z[..., 1].numpy(), rtol=1e-6)


def test_philox_uniform_bounds():
    words = torch.tensor([0, 255, 256, 0xffffffff], dtype=torch.int64)
    u = philox.uniform01(words)
    assert u.dtype == torch.float32
    assert float(u[0]) == 2.0 ** -24 and float(u[1]) == 2.0 ** -24
    assert float(u[2]) == 2.0 ** -23 and float(u[3]) == 1.0
