"""The EKF step's op (``ops/ekf_rows.py``): the plain version that a CPU
tensor takes, its batching rule, its checks and the filter's dispatch. The
kernel (``csrc/ekf_rows.cu``) runs on the card only: ``chip_smoke.py``'s
``ekf_rows_kernel`` phase holds it to this plain version.

- The plain version against the filter's row chain in PyTorch
  (``filter._masked``) at config 4's shape: 20 states at capacity 50, 32
  rows from the dense world's lidar and circle detector (unknown DA) or
  the cylinders seen within 1.2 m (known DA), float32 and float64, three
  chained steps: gate decisions equal; float64 within 1e-9, float32 at
  ``tests/test_torch_ekf.py``'s bars (pose 1e-5, landmarks 1e-4,
  covariance rtol 1e-3 + 1e-7·max|Σ|).
- The plain version against ``tpunav``'s filter on the native courses of
  ``tests/test_torch_ekf.py`` at its bars.
- The dispatch: a CPU step takes the filter's PyTorch row chain; on the
  card a step is one launch of the kernel, but with
  ``spd_repair_per_meas``, which keeps the PyTorch row chain.
- The batching rule: a mapped batch equals the stacked serial calls, bit
  for bit.
- The checks: a wrong dtype, shape, device or a non-contiguous input
  raises; the ``"EKF"`` launch counter is registered; :func:`plan`.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ekf import COURSES, _f32_courses
from tpunav.estimation.ekf import filter as jf
from tpunav_torch import batch, capture, interop
from tpunav_torch.estimation.ekf import filter as tf
from tpunav_torch.ops import ekf_rows
from tpunav_torch.sim import dense_world

torch.set_num_threads(1)

B, STEPS = 20, 3
U = (0.04, 0.03)                       # the twist of each chained step
F32_BARS = {"pose": 1e-5, "landmarks": 1e-4, "cov": 1e-7}


def _poses():
    """20 true poses [θ, x, y] along config 4's waypoint ring."""
    ring = dense_world.waypoint_ring()
    a = np.linspace(0.0, 2 * np.pi, B, endpoint=False)
    r = np.interp(a, np.linspace(0.0, 2 * np.pi, len(ring) + 1),
                  np.append(np.hypot(ring[:, 0], ring[:, 1]),
                            np.hypot(*ring[0, :2])))
    return np.stack([a + np.pi / 2, r * np.cos(a), r * np.sin(a)], -1)


@functools.cache
def _measurements(known: bool):
    """(STEPS, B, 32, 2) float64 robot-frame rows from each state's true
    pose, the pose advanced by U between steps: the detector's circles
    (unknown DA) or cylinder i in row i within 1.2 m (known DA)."""
    lms = dense_world.dense_world()
    meas_fn = dense_world.sensor(torch.from_numpy(lms))
    poses, out = _poses(), []
    for _ in range(STEPS):
        rows = []
        for th, x, y in poses:
            if known:
                rel = lms[:32] - [x, y]
                c, s = np.cos(th), np.sin(th)
                rf = np.stack([c * rel[:, 0] + s * rel[:, 1],
                               -s * rel[:, 0] + c * rel[:, 1]], -1)
                vis = np.hypot(rel[:, 0], rel[:, 1]) < 1.2
                rows.append(np.where(vis[:, None], rf, np.nan))
            else:
                txy = torch.tensor([th, x, y], dtype=torch.float32)
                rows.append(meas_fn(txy, torch.Generator().manual_seed(0))
                            .double().numpy())
        out.append(np.stack(rows))
        th = poses[:, 0] + U[0]
        poses = np.stack([th, poses[:, 1] + U[1] * np.cos(th),
                          poses[:, 2] + U[1] * np.sin(th)], -1)
    return np.stack(out)


def _cfg():
    return dense_world.configs()[1]


def _init(cfg, dtype, n=B):
    st = tf.ekf_init(cfg, dtype=dtype, device="cpu")
    return tf.EKFState(*(t.expand(n, *t.shape).clone() for t in st))


def _worst(got, want, f64):
    """The largest pose, landmark and covariance excess (float32: over rtol
    1e-3, in units of max|Σ|) of ``got`` against ``want``."""
    rtol = 0.0 if f64 else 1e-3
    scale = 1.0 if f64 else float(want.cov.abs().max())
    return {"pose": float((got.state[..., :3] - want.state[..., :3])
                          .abs().max()),
            "landmarks": float((got.state[..., 3:] - want.state[..., 3:])
                               .abs().max()),
            "cov": float(((got.cov - want.cov).abs() -
                          rtol * want.cov.abs()).max()) / scale}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("known", [True, False])
def test_plain_matches_the_torch_row_chain_at_config4(known, dtype):
    cfg = _cfg()
    meas = torch.from_numpy(_measurements(known)).to(dtype)
    u = torch.tensor(U, dtype=dtype).expand(B, 2)
    st = ref = _init(cfg, dtype)
    bars = ({k: 1e-9 for k in F32_BARS} if dtype == torch.float64
            else F32_BARS)
    step = batch.vmap(lambda s, m, uu: tuple(tf._filter_step(
        cfg, tf.EKFState(*s), m, uu, None, known)))
    for m in meas:
        assert int(torch.isfinite(m).all(-1).sum()) >= 2 * B
        st = tf.EKFState(*step(tuple(st), m, u))
        outs = [tf._masked(cfg, tf.EKFState(*(t[b] for t in ref)), m[b],
                           u[b], None, known) for b in range(B)]
        ref = tf.EKFState(*(torch.stack(col) for col in zip(*outs)))
        assert torch.equal(st.active, ref.active)
        assert torch.equal(st.count, ref.count)
        worst = _worst(st, ref, dtype == torch.float64)
        assert all(worst[k] <= bars[k] for k in bars), worst
    assert int(st.count.min()) >= 3


def _jstep(jcfg, known):
    fn = jf.known_correspondence_slam if known else jf.slam_unknown_da
    return jax.jit(lambda st, m, u: fn(jcfg, st, m, u))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("known", [True, False])
def test_plain_matches_tpunav_on_the_native_courses(known, dtype):
    """The op's plain version, called directly on one state, against
    ``tpunav``'s filter: float64 within 1e-9, float32 at the float32
    course bars; equal gate decisions."""
    if dtype == torch.float64:
        kw, course, u = COURSES[known]
        course = course()
    else:
        kw, course, u = next((k, m, uu) for kn, k, m, uu in _f32_courses()
                             if kn == known)
    jcfg, tcfg = jf.EKFConfig(**kw), tf.EKFConfig(**kw)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jst, st = jf.ekf_init(jcfg, jdt), tf.ekf_init(tcfg, dtype, "cpu")
    jstep = _jstep(jcfg, known)
    zeros_w = torch.zeros(3, dtype=dtype)
    uu = torch.tensor(u, dtype=dtype)
    for meas in course:
        jst = jstep(jst, jnp.asarray(meas, jdt), jnp.asarray(u, jdt))
        m = torch.as_tensor(np.asarray(meas), dtype=dtype)
        st = tf.EKFState(*ekf_rows.ekf_step(
            st.state, 0.5 * (st.cov + st.cov.T), st.active, st.count, m, uu,
            zeros_w, torch.zeros_like(m), known=known, dmin=tcfg.dmin,
            dmax=tcfg.dmax, motion_noise=tcfg.motion_noise,
            measurement_noise=tcfg.measurement_noise))
        want = {k: np.asarray(getattr(jst, k)) for k in jf.EKFState._fields}
        got = interop.ekf_state_to_numpy(st)
        np.testing.assert_array_equal(got["active"], want["active"])
        assert int(got["count"]) == int(want["count"])
        want_st = tf.EKFState(*(torch.as_tensor(np.array(want[k])) for k in
                                jf.EKFState._fields))
        worst = _worst(st, want_st, dtype == torch.float64)
        bars = ({k: 1e-9 for k in F32_BARS} if dtype == torch.float64
                else F32_BARS)
        assert all(worst[k] <= bars[k] for k in bars), worst
    assert int(st.count) >= 4


STEPS_BY_NAME = {"known": tf.known_correspondence_slam,
                 "unknown": tf.slam_unknown_da,
                 "known_masked": tf.known_correspondence_slam_masked,
                 "unknown_masked": tf.slam_unknown_da_masked}


def _dispatched(monkeypatch, name, per_meas, device):
    """Two steps of ``name`` on ``device``: the calls of the PyTorch row
    chain and of the op's plain version, the kernel's launches, the state."""
    calls = {"chain": 0, "plain": 0}
    chain, plain = tf._masked, ekf_rows._reference

    def counted(key, fn):
        def call(*a):
            calls[key] += 1
            return fn(*a)
        return call

    monkeypatch.setattr(tf, "_masked", counted("chain", chain))
    monkeypatch.setattr(ekf_rows, "_reference", counted("plain", plain))
    cfg = tf.EKFConfig(num_landmarks=4, spd_repair_per_meas=per_meas)
    meas = torch.tensor([[1.0, 0.0], [np.nan, np.nan], [0.0, 2.0]],
                        dtype=torch.float64, device=device)
    u = torch.tensor([0.1, 0.02], dtype=torch.float64, device=device)
    st = tf.ekf_init(cfg, device=device)
    before = ekf_rows.EKF_LAUNCHES
    for _ in range(2):
        st = STEPS_BY_NAME[name](cfg, st, meas, u)
    assert st.active.tolist() == ([True, False, True, False]
                                  if name.startswith("known")
                                  else [True, True, False, False])
    assert int(st.count) == 2
    return calls, ekf_rows.EKF_LAUNCHES - before


@pytest.mark.parametrize("per_meas", [False, True])
@pytest.mark.parametrize("name", sorted(STEPS_BY_NAME))
def test_dispatch(monkeypatch, name, per_meas):
    """Every filter step on a CPU tensor takes the PyTorch row chain, once
    per step, with or without ``spd_repair_per_meas``; none takes the op."""
    calls, launches = _dispatched(monkeypatch, name, per_meas, "cpu")
    assert calls == {"chain": 2, "plain": 0} and launches == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the EKF step's kernel")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("per_meas", [False, True])
@pytest.mark.parametrize("name", sorted(STEPS_BY_NAME))
def test_dispatch_on_the_card(monkeypatch, card, name, per_meas):
    """On the card every filter step is one launch of the kernel; with
    ``spd_repair_per_meas`` none is, and the PyTorch row chain runs."""
    calls, launches = _dispatched(monkeypatch, name, per_meas, card)
    assert calls == {"chain": 2 if per_meas else 0, "plain": 0}
    assert launches == (0 if per_meas else 2)


@pytest.mark.parametrize("shared_u", [False, True])
@pytest.mark.parametrize("known", [True, False])
def test_vmap_rule_equals_serial_calls_bit_for_bit(known, shared_u):
    """The op under ``batch.vmap`` (folded into one call on the batch, an
    unmapped twist repeated over it) against one call per state."""
    cfg = _cfg()
    dtype = torch.float32
    meas = torch.from_numpy(_measurements(known)[0][:6]).to(dtype)
    st = _init(cfg, dtype, 6)
    u = (torch.tensor(U, dtype=dtype) if shared_u else
         torch.tensor(U, dtype=dtype) * torch.linspace(0.5, 1.5, 6)[:, None])
    gen = torch.Generator().manual_seed(3)
    w = torch.randn(6, 3, generator=gen, dtype=dtype) * 1e-3
    v = torch.randn(6, 32, 2, generator=gen, dtype=dtype) * 1e-3
    kw = dict(known=known, dmin=cfg.dmin, dmax=cfg.dmax,
              motion_noise=cfg.motion_noise,
              measurement_noise=cfg.measurement_noise)
    for _ in range(2):
        mapped = batch.vmap(
            lambda s, c, a, n, m, uu, ww, vv: ekf_rows.ekf_step(
                s, c, a, n, m, uu, ww, vv, **kw),
            (0, 0, 0, 0, 0, None if shared_u else 0, 0, 0))(
            *st, meas, u, w, v)
        serial = [ekf_rows.ekf_step(*(t[b] for t in st), meas[b],
                                    u if shared_u else u[b], w[b], v[b],
                                    **kw) for b in range(6)]
        for got, want in zip(mapped, zip(*serial)):
            assert torch.equal(got, torch.stack(want))
        st = tf.EKFState(*mapped)
    assert int(st.count.min()) >= 1


def _args(dtype=torch.float32, s=7, m=3, b=2):
    n = (s - 3) // 2
    f = dict(dtype=dtype)
    return [torch.zeros(b, s, **f), torch.eye(s, **f).expand(b, s, s).clone(),
            torch.zeros(b, n, dtype=torch.bool),
            torch.zeros(b, dtype=torch.int32), torch.ones(b, m, 2, **f),
            torch.zeros(b, 2, **f), torch.zeros(b, 3, **f),
            torch.zeros(b, m, 2, **f)]


def _bad_cases():
    def with_(i, t):
        a = _args()
        a[i] = t
        return a
    return {
        "int_state": with_(0, torch.zeros(2, 7, dtype=torch.int64)),
        "mixed_dtype": with_(1, torch.eye(7, dtype=torch.float64)
                             .expand(2, 7, 7).clone()),
        "int64_count": with_(3, torch.zeros(2, dtype=torch.int64)),
        "float_active": with_(2, torch.zeros(2, 2)),
        "cov_shape": with_(1, torch.zeros(2, 7, 6)),
        "even_state": with_(0, torch.zeros(2, 8)),
        "meas_shape": with_(4, torch.zeros(2, 3, 3)),
        "v_rows": with_(7, torch.zeros(2, 4, 2)),
        "batch": with_(5, torch.zeros(3, 2)),
        "non_contiguous": with_(1, torch.zeros(2, 7, 7).transpose(1, 2)),
        "meta_device": with_(6, torch.zeros(2, 3, device="meta")),
        "known_rows": _args(m=3, s=5),
    }


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_the_op_raises_on_what_the_kernel_does_not_take(case):
    args = _bad_cases()[case]
    with pytest.raises((TypeError, ValueError, RuntimeError,
                        NotImplementedError)):
        ekf_rows._ekf_op(*args, case == "known_rows", 50.0, 3e3,
                         [1e-5] * 3, [1e-5] * 2)


def test_the_counter_and_the_plan():
    """``"EKF"`` is a launch counter of ``capture``; the covariance lies in
    shared memory while a block may hold it (S = 103 in float32 and
    float64 on an H100's 232,448 bytes; up to 231 and 159), else in device
    memory."""
    assert capture.COUNTERS["EKF"] == ("ekf_rows", "EKF_LAUNCHES")
    assert "EKF" in capture.read_counts()
    limit = 232_448
    for dtype, largest in ((torch.float32, 231), (torch.float64, 159)):
        assert ekf_rows.plan(103, 32, dtype, limit)[0] == "shared"
        assert ekf_rows.plan(largest, 32, dtype, limit)[0] == "shared"
        layout, need = ekf_rows.plan(largest + 2, 32, dtype, limit)
        assert layout == "global" and need <= limit
    assert ekf_rows.shared_bytes(103, 32, 4, True) == math.ceil(
        (4 * (103 * 103 + 19 * 103 + 5 * 32 + 32) + 4 * 32 + 50 + 32) / 16
    ) * 16
