"""ICP scan matching in one kernel launch: its wrapper and its plain
version.

No Pallas kernel in ``tpunav`` computes it: ``tpunav`` leaves ICP to XLA
(``tpunav/estimation/rbpf/icp.py``). The port's match was ~100 PyTorch
operations per Gauss-Newton iteration, ~3,000 launches per match; on the
card a whole match — both scans to points, every iteration, the
convergence test and the angle wrap — is one launch of
``csrc/icp.cu``, hand-written for Hopper.

A CPU tensor takes the plain version (:func:`_icp_reference`, the port's
iterations in plain torch); a CUDA tensor launches the kernel, or raises.
``ICP_LAUNCHES`` counts launches (one per match). :func:`plan` places the
work from the shapes and the card alone: the blocks of a thread-block
cluster that share the source rows, and whether the clouds fit in shared
memory or lie in a device scratch. The kernel sums the normal equations in
the order the plain version's cuBLAS calls take on the card, so at the
beam counts of ``BIT_EXACT`` a match is the plain version's bits there.
Those orders are a library's choices, measured with one toolkit on one
card (``MEASURED_ON``); :func:`bit_exact` claims the bits only there, and
with another cuBLAS the kernel is a float32 match of another summation
order (within 1e-5, ``tests/test_torch_icp.py``).

The functions take any ``cfg`` with :class:`ICPConfig`'s fields
(``tpunav_torch.estimation.rbpf.icp``, whose ``icp_match`` and
``icp_match_scans`` are the public entries) and return the six fields of
its ``ICPResult`` as a tuple.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core import se2
from ._build import check_launch, check_shared_memory, load

ICP_LAUNCHES = 0            # kernel launches (one per match on the card)


# ── The plain version ──


def _take(v, i):
    """v[i] for a 0-dim device index, without a host read."""
    return torch.index_select(v, 0, i.reshape(1))[0]


def _iteration(cfg, T, src, src_valid, dst, dst_valid, n_src_valid):
    """One point-to-line Gauss-Newton step from T; returns
    (T_new, rmse, |step|, inlier fraction, min normal eigenvalue)."""
    n = dst.shape[0]
    big = 1e9
    moved = se2.apply(T, src)                               # (N, 2)
    d2 = torch.sum((moved[:, None, :] - dst[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(dst_valid[None, :], d2, big)
    nn = torch.argmin(d2, dim=1)                            # first minimum
    nn_d = torch.sqrt(torch.gather(d2, 1, nn[:, None])[:, 0])
    # Correspondence rejection (PCL max_correspondence_distance).
    gate = torch.logical_and(src_valid, nn_d <= cfg.max_corr_dist)
    # Annealed residual gate at max(outlier_thresh, outlier_scale·q40).
    d_masked = torch.sort(torch.where(gate, nn_d, big)).values
    cnt = torch.sum(gate.to(torch.int64))
    med = _take(d_masked, torch.clamp((2 * cnt) // 5, min=0))
    rej = torch.clamp(cfg.outlier_scale * med, min=cfg.outlier_thresh)
    w = torch.logical_and(gate, nn_d <= rej).to(src.dtype)
    wsum = torch.clamp(torch.sum(w), min=1e-9)

    q = dst[nn]                                             # matched targets
    # Local line through the scan-adjacent neighbours of the match.
    prv = torch.clamp(nn - 1, 0, n - 1)
    nxt = torch.clamp(nn + 1, 0, n - 1)
    both_ok = torch.logical_and(dst_valid[prv], dst_valid[nxt])
    tang = torch.where(both_ok[:, None], dst[nxt] - dst[prv],
                       torch.zeros_like(q))
    tnorm = torch.linalg.norm(tang, dim=-1, keepdim=True)
    line_ok = tnorm[:, 0] > 1e-9
    tang = tang / torch.clamp(tnorm, min=1e-9)
    normal = torch.stack([-tang[:, 1], tang[:, 0]], dim=-1)
    # Fallback to the point-to-point direction for degenerate lines.
    diff = q - moved
    dnorm = torch.clamp(torch.linalg.norm(diff, dim=-1, keepdim=True),
                        min=1e-9)
    normal = torch.where(line_ok[:, None], normal, diff / dnorm)

    # Gauss-Newton on r_i = n_i · (p_i + [J p_i]θ + t − q_i), J the 90°
    # rotation. Unknowns x = (θ, tx, ty).
    jp = torch.stack([-moved[:, 1], moved[:, 0]], dim=-1)
    a = torch.stack([torch.sum(normal * jp, dim=-1),
                     normal[:, 0], normal[:, 1]], dim=-1)   # (N, 3)
    b = torch.sum(normal * (q - moved), dim=-1)             # (N,)
    aw = a * w[:, None]
    ata = aw.T @ a + 1e-9 * torch.eye(3, dtype=a.dtype, device=a.device)
    atb = aw.T @ b
    x = torch.linalg.solve_ex(ata, atb).result
    T_new = se2.compose(x, T)
    rmse = torch.sum(w * nn_d) / wsum
    # Observability: spectrum of the unit-normal outer-product sum; a
    # corridor's normals all point one way, so its min eigenvalue is ~0.
    nmat = (normal * w[:, None]).T @ normal / wsum          # (2, 2)
    tr = nmat[0, 0] + nmat[1, 1]
    det = nmat[0, 0] * nmat[1, 1] - nmat[0, 1] * nmat[1, 0]
    disc = torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    return (T_new, rmse, torch.linalg.norm(x), torch.sum(w) / n_src_valid,
            tr / 2.0 - disc)


def _icp_reference(cfg, src, src_valid, dst, dst_valid, T_init):
    """The match in plain torch, ``max_iter`` Python iterations: (transform,
    converged, rmse, inlier_frac, delta_norm, normal_eig). Nothing reads
    the host, so a CUDA graph can hold it."""
    n_src_valid = torch.clamp(torch.sum(src_valid.to(src.dtype)), min=1e-9)
    T = torch.as_tensor(T_init, dtype=src.dtype, device=src.device)
    for _ in range(cfg.max_iter):
        T, rmse, delta, inlier_frac, min_eig = _iteration(
            cfg, T, src, src_valid, dst, dst_valid, n_src_valid)
    converged = ((rmse <= cfg.converged_rmse)
                 & (delta <= cfg.transform_eps)
                 & (inlier_frac >= cfg.min_inlier_frac)
                 & (min_eig >= cfg.min_normal_eig)
                 & (torch.sum(src_valid) > 0))
    T = torch.cat([torch.atan2(torch.sin(T[:1]), torch.cos(T[:1])), T[1:]])
    return T, converged, rmse, inlier_frac, delta, min_eig


# ── The kernel ──

THREADS = 1024              # threads per block (csrc/icp.cu: kThreads)
MAX_CLUSTER = 8             # the portable cluster size
ROWS_PER_BLOCK = 24         # source rows a block takes (the cluster's size)
SMALL_N = 96                # up to it one block: at N=90 a cluster's barrier
                            # costs more than it spreads (PERF.md §6)
STATIC_BYTES = 4096         # the kernel's static shared memory, rounded up


class _IcpParams(ctypes.Structure):
    """Mirror of ``IcpParams`` in csrc/icp.cu."""

    _fields_ = [("n", ctypes.c_int), ("max_iter", ctypes.c_int),
                ("from_ranges", ctypes.c_int), ("cluster", ctypes.c_int),
                ("rows", ctypes.c_int), ("group", ctypes.c_int),
                ("global_layout", ctypes.c_int), ("chunk", ctypes.c_int),
                ("range_min", ctypes.c_float), ("range_max", ctypes.c_float),
                ("beam_min", ctypes.c_float), ("beam_delta", ctypes.c_float),
                ("max_corr_dist", ctypes.c_float),
                ("converged_rmse", ctypes.c_float),
                ("outlier_thresh", ctypes.c_float),
                ("outlier_scale", ctypes.c_float),
                ("transform_eps", ctypes.c_float),
                ("min_inlier_frac", ctypes.c_float),
                ("min_normal_eig", ctypes.c_float)]


MAX_RUNS = 64               # runs of AᵀWA's chains (csrc/icp.cu: kMaxRuns)
# The toolkit (torch.version.cuda, whose cuBLAS the wheel carries) and the
# compute capability on which the two tables below were measured (an H100).
MEASURED_ON = ("12.8", (9, 0))
# The rows per run of the split-K GEMM that cuBLAS takes for ``aw.T @ a``
# at K rows there, measured.
CUBLAS_CHUNK = {90: 90, 180: 8, 360: 12, 720: 20}
# The beam counts at which cuBLAS's GEMV for ``aw.T @ b`` is also the
# kernel's order (32 lanes over rows l, l+32, …, a halving tree): there a
# match is the plain version's bits on the card (tests/test_torch_icp.py).
BIT_EXACT = (360, 720)


def bit_exact(n: int, device) -> bool:
    """Whether a match of ``n`` points on CUDA ``device`` is the plain
    version's bits but for rmse and |x|: at a beam count of ``BIT_EXACT``,
    with the toolkit and card of ``MEASURED_ON``. A cuBLAS update may change
    its split-K runs or its GEMV without notice; elsewhere the two agree
    to float32 rounding only."""
    return (n in BIT_EXACT and torch.version.cuda == MEASURED_ON[0]
            and torch.cuda.get_device_capability(device) == MEASURED_ON[1])


def gemm_chunk(n: int) -> int:
    """Rows per run of AᵀWA's chains at ``n`` points: cuBLAS's where known,
    else runs of ~n/32 rows (the kernel's own order)."""
    return CUBLAS_CHUNK.get(n, max(1, -(-n // 32)))


def cloud_bytes(n: int) -> int:
    """Bytes of a block's per-point arrays at ``n`` points
    (csrc/icp.cu: cloud_bytes)."""
    up = lambda x, m: -(-x // m) * m
    return up(8 * up(n, 2) + 8 * up(n, 4) + 54 * n, 16)


def _group(rows: int) -> int:
    """Lanes per source row: the largest power of two up to 32 whose groups
    cover ``rows`` rows with the block's threads (at least 1)."""
    g = 1
    while g < 32 and 2 * g * rows <= THREADS:
        g *= 2
    return g


def plan(n: int, smem_limit: int):
    """(cluster, rows, group, layout, shared bytes) of a match of ``n``
    points on a card whose blocks may opt in to ``smem_limit`` bytes:
    ``cluster`` blocks of ``rows`` source rows each (one block up to
    ``SMALL_N`` points, else one per ``ROWS_PER_BLOCK`` rows, at most
    ``MAX_CLUSTER``), ``group`` lanes per row, and the clouds in shared
    memory (``"shared"``) or, past it, in a device scratch of
    ``cloud_bytes(n)`` bytes with one block (``"global"``)."""
    cluster = 1 if n <= SMALL_N else min(MAX_CLUSTER, -(-n // ROWS_PER_BLOCK))
    rows = -(-n // cluster)
    need = cloud_bytes(n)
    if need + STATIC_BYTES <= smem_limit:
        return cluster, rows, _group(rows), "shared", need
    return 1, n, _group(n), "global", 0


def _check_config(cfg) -> None:
    if int(cfg.max_iter) < 1:
        raise ValueError(f"ICP needs max_iter >= 1, got {cfg.max_iter}")


def _check_cloud(name, pts, ok, n, device) -> None:
    if pts.device != device or ok.device != device:
        raise ValueError(f"{name} and its mask must be on {device}")
    if pts.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {pts.dtype}")
    if ok.dtype != torch.bool:
        raise TypeError(f"{name}'s mask must be bool, got {ok.dtype}")
    if tuple(pts.shape) != (n, 2) or tuple(ok.shape) != (n,):
        raise ValueError(f"{name} must be ({n}, 2) with an ({n},) mask, got "
                         f"{tuple(pts.shape)} and {tuple(ok.shape)}")
    if not (pts.is_contiguous() and ok.is_contiguous()):
        raise ValueError(f"{name} and its mask must be contiguous")


def _check_scan(name, ranges, n, device) -> None:
    if ranges.device != device:
        raise ValueError(f"{name} is on {ranges.device}, expected {device}")
    if ranges.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {ranges.dtype}")
    if tuple(ranges.shape) != (n,) or not ranges.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({n},) scan, got "
                         f"{tuple(ranges.shape)}")


def _guess(T_init, device):
    T = torch.as_tensor(T_init, dtype=torch.float32, device=device)
    if tuple(T.shape) != (3,):
        raise ValueError(f"T_init must be (3,), got {tuple(T.shape)}")
    return T.contiguous()


def _launch(cfg, src, src_ok, dst, dst_ok, T, scan=None):
    """One launch; ``scan`` = (range_min, range_max, beam_min, beam_delta)
    where ``src`` and ``dst`` are ranges (masks None)."""
    global ICP_LAUNCHES
    if not src.is_cuda:
        raise ValueError(f"the ICP kernel takes CUDA tensors, got {src.device}")
    lib = load()
    n = src.shape[0]
    cluster, rows, group, layout, smem = plan(
        n, lib.tpunav_max_dynamic_smem())
    check_shared_memory(lib, smem + STATIC_BYTES, f"ICP at N={n}")
    scratch = (torch.empty(cloud_bytes(n), dtype=torch.uint8,
                           device=src.device) if layout == "global" else None)
    out = torch.empty(7, dtype=torch.float32, device=src.device)
    conv = torch.empty((), dtype=torch.bool, device=src.device)
    ranges = scan or (0.0, 0.0, 0.0, 0.0)
    params = _IcpParams(n, int(cfg.max_iter), int(scan is not None), cluster,
                        rows, group, int(layout == "global"), gemm_chunk(n),
                        *ranges,
                        cfg.max_corr_dist, cfg.converged_rmse,
                        cfg.outlier_thresh, cfg.outlier_scale,
                        cfg.transform_eps, cfg.min_inlier_frac,
                        cfg.min_normal_eig)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tpunav_icp(
            ctypes.addressof(params), src.data_ptr(),
            None if src_ok is None else src_ok.data_ptr(), dst.data_ptr(),
            None if dst_ok is None else dst_ok.data_ptr(), T.data_ptr(),
            out.data_ptr(), conv.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stream)
    check_launch(lib, err, "ICP")
    ICP_LAUNCHES += 1
    return out[:3], conv, out[3], out[4], out[5], out[6]


def icp_points(cfg, src, src_valid, dst, dst_valid,
               T_init) -> Tuple[torch.Tensor, ...]:
    """The kernel on (N, 2) float32 clouds with (N,) bool masks, all on one
    CUDA device; raises on anything else, before launching."""
    _check_config(cfg)
    n = src.shape[0] if src.dim() else 0
    if n < 1:
        raise ValueError("ICP needs at least one point")
    _check_cloud("src", src, src_valid, n, src.device)
    _check_cloud("dst", dst, dst_valid, n, src.device)
    return _launch(cfg, src, src_valid, dst, dst_valid,
                   _guess(T_init, src.device))


def icp_scans(cfg, ranges, prev_ranges, T_init, range_min, range_max,
              beam_min, beam_delta) -> Tuple[torch.Tensor, ...]:
    """The kernel on two (B,) float32 scans on one CUDA device (``ranges``
    the source, ``prev_ranges`` the destination), each turned into points
    inside the launch as ``scan_to_points`` does; raises on anything else,
    before launching."""
    _check_config(cfg)
    n = ranges.shape[0] if ranges.dim() else 0
    if n < 1:
        raise ValueError("ICP needs at least one beam")
    _check_scan("ranges", ranges, n, ranges.device)
    _check_scan("prev_ranges", prev_ranges, n, ranges.device)
    return _launch(cfg, ranges, None, prev_ranges, None,
                   _guess(T_init, ranges.device),
                   scan=(range_min, range_max, beam_min, beam_delta))
