"""The ICP kernel's wrapper (``tpunav_torch/ops/icp.py``): on the CPU its
checks, which refuse what the kernel does not take before any launch, the
plain path the CPU takes, the launch counter, the plan of blocks and
layouts, and the rank rule that stands in for the sort; on the card (tests
marked ``cuda``, which skip without one) the kernel against its plain
version, and the SLAM step's graphs with one ICP launch a replay.

No JAX here: the card tests compare the port with itself (the CPU parity
against ``tpunav`` is ``tests/test_torch_rbpf.py``'s)."""

import math

import numpy as np
import pytest
import torch

from tpunav_torch import capture
from tpunav_torch.estimation.rbpf import pf_init, pf_slam_step
from tpunav_torch.estimation.rbpf import particle_filter as tpf
from tpunav_torch.estimation.rbpf.icp import (ICPConfig, ICPResult,
                                              icp_match, icp_match_scans,
                                              scan_to_points)
from tpunav_torch.ops import icp as icp_kernel
from tpunav_torch.sim import lidar

# Where ops/icp.py:bit_exact holds (the beam counts whose cuBLAS order the
# kernel keeps, with the toolkit and card that order was measured on) a
# match is the plain version's bits on the card but for rmse and
# delta_norm, two reductions taken in another order than torch.sum's and
# torch.linalg.norm's: within TOL. Elsewhere, or under another cuBLAS, the
# normal
# equations' sums run in another order than cuBLAS's, each iteration's step
# differs by float32 rounding (~1e-7 relative), and converged matches settle
# to the same fixed point: every field within TOL (m, rad) but normal_eig.
TOL = 1e-5
# normal_eig = tr/2 − √(tr²/4 − det), tr = 1 for unit normals. Where the two
# eigenvalues nearly agree (a box's walls) the root's argument is the
# difference of two numbers near 0.25, so the sums' rounding, an ulp or
# two of 0.25 (2⁻²⁵), comes out of the root as √(2⁻²⁵) ≈ 1.7e-4: the bar
# is 1e-5 plus the root of 8 such ulps.
EIG_TOL = TOL + math.sqrt(8 * 2.0 ** -25)
FIELDS = ("transform", "converged", "rmse", "inlier_frac", "delta_norm",
          "normal_eig")
EXACT = ("transform", "converged", "inlier_frac", "normal_eig")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ICP kernel")
    return torch.device("cuda", 0)


# ── clouds ──

def _delta(n):
    return 2 * math.pi / n


def _points(scan, n):
    return scan_to_points(scan, 0.12, 3.5, 0.0, _delta(n))


def _box(pose, n, half=1.5):
    segs = lidar.box_segments(-half, -half, half, half, device="cpu")
    return lidar.scan_segments(torch.tensor(pose, dtype=torch.float32), segs,
                               num_beams=n, beam_delta=_delta(n))


def _known(n):
    """A box seen from the origin and from a known pose."""
    return (*_points(_box([0.05, 0.08, -0.03], n), n),
            *_points(_box([0.0, 0.0, 0.0], n), n), torch.zeros(3))


def _outliers(n):
    """25% of the source points replaced by uniform garbage."""
    src, src_ok, dst, dst_ok, guess = _known(n)
    rng = np.random.default_rng(3)
    idx = rng.choice(n, size=n // 4, replace=False)
    src = src.clone()
    src[idx] = torch.from_numpy(
        rng.uniform(-1.3, 1.3, size=(n // 4, 2)).astype(np.float32))
    return src, src_ok, dst, dst_ok, guess


def _masked(n):
    """30% of the destination points masked out."""
    src, src_ok, dst, dst_ok, guess = _known(n)
    dst_ok = dst_ok.clone()
    dst_ok[: (3 * n) // 10] = False
    return src, src_ok, dst, dst_ok, guess


def _corridor(n):
    """Two parallel walls: the match cannot converge."""
    segs = torch.tensor([[-20.0, -0.5, 20.0, -0.5], [-20.0, 0.5, 20.0, 0.5]])

    def pts(pose):
        return _points(lidar.scan_segments(
            torch.tensor(pose), segs, num_beams=n, beam_delta=_delta(n)), n)
    return (*pts([0.0, 0.3, 0.0]), *pts([0.0, 0.0, 0.0]), torch.zeros(3))


def _garbage(n):
    """Uniform random clouds: no match."""
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.uniform(-2, 2, (n, 2)).astype(np.float32))
    dst = torch.from_numpy(rng.uniform(-2, 2, (n, 2)).astype(np.float32))
    ok = torch.ones(n, dtype=torch.bool)
    return src, ok, dst, ok, torch.zeros(3)


TWIST = (0.03, 0.02)        # rad and m an update: the RBPF demo's arc


def _arc(updates, n, beam_min, beam_delta, range_max, seed):
    """An arc from the origin at TWIST an update inside walls at ±1.8 m,
    odometry equal to the truth, n-beam scans with 2 mm range noise from a
    generator seeded ``seed``: (u, scans (U, n), odoms (U, 3), prevs)."""
    th = TWIST[0] * torch.arange(1, updates + 1, dtype=torch.float32)
    odoms = torch.stack([th, torch.cumsum(TWIST[1] * torch.cos(th), 0),
                         torch.cumsum(TWIST[1] * torch.sin(th), 0)], -1)
    prevs = torch.cat([torch.zeros(1, 3), odoms[:-1]])
    walls = lidar.box_segments(-1.8, -1.8, 1.8, 1.8, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    scans = torch.stack([lidar.scan_segments(
        pose, walls, num_beams=n, beam_min=beam_min, beam_delta=beam_delta,
        max_range=range_max, generator=gen, noise_std=0.002)
        for pose in odoms])
    return torch.tensor(TWIST), scans, odoms, prevs


def _session(n):
    """Two consecutive scans of the arc, the odometry guess between them."""
    _, scans, odoms, _ = _arc(4, n, 0.0, _delta(n), 3.5, seed=7)
    guess = tpf._icp_init_guess(odoms[3], odoms[2])
    return (*_points(scans[3], n), *_points(scans[2], n), guess)


CLOUDS = {"known": _known, "outliers": _outliers, "masked": _masked,
          "corridor": _corridor, "garbage": _garbage, "session": _session}


def _to(device, cloud):
    return tuple(t.to(device) for t in cloud)


def _agree(got, want, exact):
    """The kernel's ICPResult against the plain version's fields: the bits
    of EXACT where ``exact``, every field within its bar."""
    assert bool(got.converged) == bool(want[1])
    for name, w in zip(FIELDS, want, strict=True):
        g = getattr(got, name)
        if exact and name in EXACT:
            assert torch.equal(g, w), (name, g.tolist(), w.tolist())
        elif name != "converged":
            err = float(torch.max(torch.abs(g - w)))
            bar = EIG_TOL if name == "normal_eig" else TOL
            assert err <= bar, (name, g.tolist(), w.tolist())


# ── on the CPU ──

def _cloud_args(n=90):
    src, src_ok, dst, dst_ok, guess = _known(n)
    return dict(cfg=ICPConfig(max_iter=10), src=src, src_valid=src_ok,
                dst=dst, dst_valid=dst_ok, T_init=guess)


@pytest.mark.parametrize("bad,err", [
    (lambda a: a.update(src=a["src"].double()), TypeError),
    (lambda a: a.update(src_valid=a["src_valid"].float()), TypeError),
    (lambda a: a.update(dst=a["dst"][:, :1].contiguous()), ValueError),
    (lambda a: a.update(dst=a["dst"][1:], dst_valid=a["dst_valid"][1:]),
     ValueError),
    (lambda a: a.update(src=a["src"].T.contiguous().T), ValueError),
    (lambda a: a.update(cfg=ICPConfig(max_iter=0)), ValueError),
    (lambda a: None, ValueError),          # CPU tensors at the kernel entry
], ids=["dtype", "mask-dtype", "shape", "mismatched-n", "strided",
        "no-iterations", "cpu-tensor"])
def test_the_kernel_entry_refuses_without_launching(monkeypatch, bad, err):
    monkeypatch.setattr(icp_kernel, "ICP_LAUNCHES", 0)
    args = _cloud_args()
    bad(args)
    with pytest.raises(err):
        icp_kernel.icp_points(**args)
    assert icp_kernel.ICP_LAUNCHES == 0


@pytest.mark.parametrize("bad,err", [
    (lambda r, p: (r.double(), p), TypeError),
    (lambda r, p: (r, p[1:]), ValueError),
    (lambda r, p: (r[:, None], p[:, None]), ValueError),
    (lambda r, p: (r, p), ValueError),     # CPU tensors at the kernel entry
], ids=["dtype", "mismatched-n", "shape", "cpu-tensor"])
def test_the_scan_entry_refuses_without_launching(monkeypatch, bad, err):
    monkeypatch.setattr(icp_kernel, "ICP_LAUNCHES", 0)
    ranges, prev = bad(_box([0.05, 0.08, -0.03], 90), _box([0, 0, 0], 90))
    with pytest.raises(err):
        icp_kernel.icp_scans(ICPConfig(max_iter=10), ranges, prev,
                             torch.zeros(3), 0.12, 3.5, 0.0, _delta(90))
    assert icp_kernel.ICP_LAUNCHES == 0


def test_the_cpu_takes_the_plain_version_and_launches_nothing(monkeypatch):
    monkeypatch.setattr(icp_kernel, "ICP_LAUNCHES", 0)
    args = _cloud_args()
    got = icp_match(**args)
    want = icp_kernel._icp_reference(
        args["cfg"], args["src"], args["src_valid"], args["dst"],
        args["dst_valid"], args["T_init"])
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    ranges, prev = _box([0.05, 0.08, -0.03], 90), _box([0, 0, 0], 90)
    scans = icp_match_scans(args["cfg"], ranges, prev, torch.zeros(3), 0.12,
                            3.5, 0.0, _delta(90))
    for a, b in zip(scans, got, strict=True):
        assert torch.equal(a, b)
    assert bool(got.converged)
    assert icp_kernel.ICP_LAUNCHES == 0


def test_the_launch_counters_list_icp():
    assert "ICP" in capture.read_counts()
    assert capture.COUNTERS["ICP"] == ("icp", "ICP_LAUNCHES")


H100_SMEM = 232448          # the opt-in shared memory of an H100's block


@pytest.mark.parametrize("n", [1, 31, 90, 180, 360, 1000, 3000])
def test_the_plan_covers_every_row(n):
    cluster, rows, group, layout, smem = icp_kernel.plan(n, H100_SMEM)
    assert layout == "shared" and 1 <= cluster <= icp_kernel.MAX_CLUSTER
    assert cluster * rows >= n > (cluster - 1) * rows or cluster == 1
    assert group in (1, 2, 4, 8, 16, 32)
    assert group * rows <= icp_kernel.THREADS or group == 1
    assert smem == icp_kernel.cloud_bytes(n) and smem % 16 == 0
    assert smem + icp_kernel.STATIC_BYTES <= H100_SMEM


@pytest.mark.parametrize("n", [1, 7, 31, 90, 100, 180, 360, 720, 1000, 6000])
def test_the_normal_equations_runs_fit_the_kernel(n):
    chunk = icp_kernel.gemm_chunk(n)
    assert chunk >= 1 and -(-n // chunk) <= icp_kernel.MAX_RUNS
    if n in icp_kernel.CUBLAS_CHUNK:
        assert chunk == icp_kernel.CUBLAS_CHUNK[n]


# One block up to SMALL_N points, then a block per ROWS_PER_BLOCK rows, at
# most eight: the sizes the card tests reach through N alone.
PLANNED = {24: 1, 48: 1, 72: 1, 90: 1, 96: 1, 120: 5, 144: 6, 168: 7,
           180: 8, 192: 8, 360: 8}


@pytest.mark.parametrize("n", sorted(PLANNED))
def test_the_plan_takes_one_block_for_few_points_and_a_cluster_past(n):
    assert icp_kernel.plan(n, H100_SMEM)[0] == PLANNED[n]


def test_the_plan_moves_the_clouds_to_device_memory_past_shared():
    big = _first_global(H100_SMEM)
    assert icp_kernel.plan(big - 1, H100_SMEM)[3] == "shared"
    assert icp_kernel.plan(big, H100_SMEM) == (
        1, big, 1, "global", 0)


@pytest.mark.parametrize("cuda,capability,n,want", [
    ("12.8", (9, 0), 360, True), ("12.8", (9, 0), 720, True),
    ("12.8", (9, 0), 90, False), ("12.8", (9, 0), 180, False),
    ("12.9", (9, 0), 360, False), ("12.8", (8, 0), 360, False),
    (None, (9, 0), 360, False)],
    ids=["n360", "n720", "n90", "n180", "other-toolkit", "other-card",
         "no-toolkit"])
def test_the_bits_are_claimed_only_where_they_were_measured(
        monkeypatch, cuda, capability, n, want):
    monkeypatch.setattr(torch.version, "cuda", cuda)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: capability)
    assert icp_kernel.bit_exact(n, "cuda") is want


def _first_global(limit):
    n = 1
    while icp_kernel.plan(n, limit)[3] == "shared":
        n += 1
    return n


def _rank_rule(v, k):
    """The kernel's quantile: the largest v with #{u < v} <= k."""
    below = (v[None, :] < v[:, None]).sum(axis=1)
    return v[below <= k].max()


def test_the_rank_rule_picks_the_sorted_element():
    rng = np.random.default_rng(11)
    for trial in range(50):
        n = int(rng.integers(1, 60))
        v = rng.choice(rng.uniform(0, 0.5, 8), size=n)   # many ties
        v = np.where(rng.uniform(size=n) < 0.2, 1e9, v).astype(np.float32)
        cnt = int((v < 1e9).sum())
        k = (2 * cnt) // 5
        want = np.sort(v)[k]
        got = _rank_rule(v[v < 1e9], k) if cnt else np.float32(1e9)
        assert got == want, (trial, v, k)


# ── on the card ──

@pytest.mark.cuda
@pytest.mark.parametrize("max_iter", [10, 25, 30])
@pytest.mark.parametrize("n", [90, 180, 360])
@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_the_kernel_matches_its_plain_version_on_the_card(card, cloud, n,
                                                          max_iter):
    cfg = ICPConfig(max_iter=max_iter)
    args = _to(card, CLOUDS[cloud](n))
    before = icp_kernel.ICP_LAUNCHES
    got = icp_match(cfg, *args)
    assert icp_kernel.ICP_LAUNCHES == before + 1
    _agree(got, icp_kernel._icp_reference(cfg, *args),
           exact=icp_kernel.bit_exact(n, card))
    if cloud in ("known", "outliers", "masked") or (cloud, n) == ("session",
                                                                  360):
        assert bool(got.converged)
    if cloud in ("corridor", "garbage"):
        assert not bool(got.converged)


@pytest.mark.cuda
@pytest.mark.parametrize("n", sorted(PLANNED))
@pytest.mark.parametrize("cloud", ["known", "masked", "session"])
def test_every_cluster_size_matches_the_plain_version(card, cloud, n):
    """Every block count the plan takes, reached through N."""
    limit = torch.cuda.get_device_properties(card).shared_memory_per_block_optin
    assert icp_kernel.plan(n, limit)[0] == PLANNED[n]
    cfg = ICPConfig()
    args = _to(card, CLOUDS[cloud](n))
    got = ICPResult(*icp_kernel.icp_points(cfg, *args))
    _agree(got, icp_kernel._icp_reference(cfg, *args),
           exact=icp_kernel.bit_exact(n, card))


@pytest.mark.cuda
def test_the_scans_enter_the_kernel_as_scan_to_points_makes_them(card):
    """The launch that converts both scans against points made first."""
    n, cfg = 360, ICPConfig()
    ranges, prev = _box([0.05, 0.08, -0.03], n), _box([0, 0, 0], n)
    ranges, prev = ranges.to(card), prev.to(card)
    got = icp_match_scans(cfg, ranges, prev, torch.zeros(3, device=card),
                          0.12, 3.5, 0.0, _delta(n))
    want = icp_match(cfg, *_points(ranges, n), *_points(prev, n),
                     torch.zeros(3, device=card))
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_past_shared_memory_the_clouds_lie_in_device_memory(card):
    limit = torch.cuda.get_device_properties(card).shared_memory_per_block_optin
    n = _first_global(limit)
    assert icp_kernel.plan(n, limit)[3] == "global"
    cfg = ICPConfig(max_iter=10)
    args = _to(card, _known(n))
    _agree(icp_match(cfg, *args), icp_kernel._icp_reference(cfg, *args),
           exact=icp_kernel.bit_exact(n, card))


def _session_steps(cfg, updates):
    g = cfg.grid
    u, scans, odoms, prevs = _arc(updates, g.num_beams, g.beam_min,
                                  g.beam_delta, g.range_max, seed=5)
    return [tuple(t.to("cuda") for t in (scans[i], u, odoms[i], prevs[i]))
            for i in range(updates)]


@pytest.mark.cuda
def test_the_stepper_replays_the_eager_bits_with_one_icp_launch(card):
    from examples_torch import rbpf_explore_demo as demo

    cfg = demo.configs()[0]
    steps = _session_steps(cfg, 10)
    st = pf_init(cfg, seed=1, device=card)
    for x in steps:
        st = pf_slam_step(cfg, st, *x)
    stepper = tpf.PFStepper(cfg, pf_init(cfg, seed=1, device=card), card)
    before = capture.read_counts()
    for x in steps:
        stepper.step(*x)
    after = capture.read_counts()
    for name, a, b in zip(tpf.PFState._fields, stepper.state[:-1], st[:-1]):
        assert torch.equal(a, b), name
    assert stepper.graph.deltas["ICP"] == 1
    assert after["ICP"] - before["ICP"] == len(steps)
    assert capture.counted(stepper.update)["ICP"] == 1


@pytest.mark.cuda
def test_the_slam_step_is_the_plain_versions_bits(card, monkeypatch):
    """Config 5's update chain on the arc's scans, with the kernel and with
    the plain version in its place: every state leaf bit for bit where
    ops/icp.py:bit_exact holds. Under another cuBLAS the first update's
    poses within TOL (one resample apart, the chain may part later)."""
    from examples_torch import rbpf_explore_demo as demo
    from tpunav_torch.estimation.rbpf import icp as ticp

    cfg = demo.configs()[0]
    exact = icp_kernel.bit_exact(cfg.grid.num_beams, card)
    steps = _session_steps(cfg, 12 if exact else 1)

    def chain():
        st = pf_init(cfg, seed=3, device=card)
        for x in steps:
            st = pf_slam_step(cfg, st, *x)
        return st

    fast = chain()

    def plain(icfg, ranges, prev, guess, *scan):
        return ICPResult(*icp_kernel._icp_reference(
            icfg, *scan_to_points(ranges, *scan),
            *scan_to_points(prev, *scan), guess))

    monkeypatch.setattr(ticp.icp_kernel, "icp_scans", plain)
    slow = chain()
    if not exact:
        assert float(torch.max(torch.abs(fast.poses - slow.poses))) <= TOL
        return
    for name, a, b in zip(tpf.PFState._fields, fast[:-1], slow[:-1]):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_the_exploration_scan_launches_icp_once(card):
    from examples_torch import rbpf_explore_demo as demo

    pf_cfg, mppi_cfg = demo.configs()
    g = demo.ScanGraph(pf_cfg, mppi_cfg, demo.init_state(
        pf_cfg, mppi_cfg, device=card), card)
    for _ in range(4):
        g.step()
    assert g.graph.replays >= 1 and g.graph.deltas["ICP"] == 1
