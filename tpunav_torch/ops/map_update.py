"""The per-particle map update with its distance field (kernel K3), and the
distance field alone (kernel K4): their wrappers and plain versions.

Port of ``tpunav/ops/pallas_map_update.py`` (``map_update_batch``,
``edt_batch``). Both kernels are hand-written CUDA for Hopper in one
source, ``csrc/map_update.cu``, which replaces the Pallas kernels
``_map_kernel`` and ``_edt_kernel``. K3 folds one scan into each of P
particles' (H, W) log-odds grids, each from its own pose, and rebuilds
each particle's distance field; K4 rebuilds distance fields from grids.
Both run one device function for the EDT, an exact linear-time lower
envelope in integers (Meijster's), so K4 on K3's grids gives K3's fields
bit for bit, and both give ``esdf``'s. Each block keeps its planes in
shared memory where they fit (about 168×168 cells) and in its slice of a
global scratch beyond (:func:`_map_layout`, :func:`_edt_layout`).

A CPU tensor takes the plain versions (:func:`_map_update_reference`, the
TPU kernel's arithmetic in plain torch, and :func:`_edt_reference`); a
CUDA tensor launches the kernel, or raises. ``MAP_LAUNCHES`` and
``EDT_LAUNCHES`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import TYPE_CHECKING

import torch

from . import beams
from ._build import (check_launch, check_shared_memory, check_tensors,
                     load)

if TYPE_CHECKING:
    from ..estimation.rbpf.grid import GridConfig

_RUNS = 2                   # csrc/map_update.cu's kSegments
MAP_LAUNCHES = 0            # K3 launches (one per call on the card)
EDT_LAUNCHES = 0            # K4 launches (one per call on the card)


class _MapParams(ctypes.Structure):
    """Mirror of ``MapParams`` in csrc/map_update.cu."""

    _fields_ = [
        ("particles", ctypes.c_int), ("height", ctypes.c_int),
        ("width", ctypes.c_int), ("beams", ctypes.c_int),
        ("beams_full", ctypes.c_int),
        ("xmin", ctypes.c_float), ("ymin", ctypes.c_float),
        ("inv_res", ctypes.c_float), ("res", ctypes.c_float),
        ("x0", ctypes.c_float), ("y0", ctypes.c_float),
        ("beam_min", ctypes.c_float), ("two_pi", ctypes.c_float),
        ("inv_two_pi", ctypes.c_float), ("inv_delta", ctypes.c_float),
        ("delta", ctypes.c_float), ("half_res", ctypes.c_float),
        ("d_free", ctypes.c_float), ("d_occ", ctypes.c_float),
        ("l_occ", ctypes.c_float), ("big", ctypes.c_float),
        ("max_occ", ctypes.c_float),
    ]


def _map_params(cfg: GridConfig, p: int) -> _MapParams:
    h, w, res = cfg.height, cfg.width, cfg.resolution
    two_pi = 2.0 * math.pi
    return _MapParams(
        p, h, w, cfg.num_beams, beams.beams_per_revolution(cfg),
        cfg.xmin, cfg.ymin, 1.0 / res, res, cfg.xmin + res * 0.5,
        cfg.ymin + res * 0.5, cfg.beam_min, two_pi, 1.0 / two_pi,
        1.0 / cfg.beam_delta, cfg.beam_delta, 0.5 * res,
        cfg.l_free - cfg.l_prior, cfg.l_occ - cfg.l_prior, cfg.l_occ,
        h + w + 2.0, cfg.max_occ_dist)


def _layout(planes: int, rest: int, smem_limit: int):
    """(shared bytes per block, scratch ints per particle): the ``planes``
    ints in shared memory beside the ``rest`` if all fit ``smem_limit``
    bytes, else in a global scratch."""
    if 4 * (planes + rest) <= smem_limit:
        return 4 * (planes + rest), 0
    return 4 * rest, planes


def _map_layout(cfg: GridConfig, smem_limit: int):
    """K3's layout (as tpunav_map_update sizes it) on a card that lets a
    block opt in to ``smem_limit`` bytes: the endpoint count image (H, W)
    and the EDT's working plane at the odd row stride W | 1, shared or in
    the scratch; the column envelopes' stack tops (_RUNS per column) and
    the beam table, shared."""
    h, w = cfg.height, cfg.width
    return _layout(h * w + h * (w | 1), _RUNS * w + cfg.num_beams,
                   smem_limit)


def _edt_layout(cfg: GridConfig, smem_limit: int):
    """K4's: the working plane at the odd row stride and the column stacks
    (H, W), shared or in the scratch; their tops, shared."""
    h, w = cfg.height, cfg.width
    return _layout(h * w + h * (w | 1), _RUNS * w, smem_limit)


def _scratch(lib, layout, p: int, device, what: str):
    """The (P, ints) int32 plane scratch of a layout, or None; raises if
    what stays shared exceeds the card's limit."""
    smem, ints = layout
    check_shared_memory(lib, smem, what)
    if ints == 0:
        return None
    return torch.empty((p, ints), dtype=torch.int32, device=device)


def _pose_trig(poses):
    """(P, 2) [cos θ, sin θ] of (P, 3) poses, as ``map_update_batch`` builds
    them for its kernel."""
    th = poses[:, 0]
    return torch.stack([torch.cos(th), torch.sin(th)], dim=1)


def _beam_index_reference(cfg: GridConfig, poses):
    """The kernel's bearing quantizer in plain torch: each cell's range from
    each pose and its beam index mod beams per revolution, as
    (r_c (P, H, W), beam (P, H, W) int64)."""
    return beams.cell_beams(cfg, poses, kernel_form=True)


def _map_update_reference(cfg: GridConfig, grids, ranges, poses,
                          table=None):
    """K3 in plain torch, in the kernel's (and ``_map_kernel``'s) order of
    operations: endpoint counts, covering beam, free test against the
    3×3-dilated endpoint mask, multiplicity mass, new log-odds, EDT.
    ``table``: the scan's beam table, if already built."""
    from ..estimation.rbpf.grid import _dilate3x3

    p, h, w = grids.shape
    res = cfg.resolution
    if table is None:
        table = beams.beam_table(cfg, ranges)
    r, cb, sb, rm = table[:beams.R_MARK + 1]
    trig = _pose_trig(poses)
    c0, s0 = trig[:, 0, None], trig[:, 1, None]
    ex = poses[:, 1, None] + r * (c0 * cb - s0 * sb)          # (P, B)
    ey = poses[:, 2, None] + r * (s0 * cb + c0 * sb)
    inv_res = 1.0 / res
    eix = torch.clamp(torch.floor((ex - cfg.xmin) * inv_res), 0, w - 1)
    eiy = torch.clamp(torch.floor((ey - cfg.ymin) * inv_res), 0, h - 1)
    cell = (eiy.long() * w + eix.long()
            + torch.arange(p, device=grids.device)[:, None] * (h * w))
    count = torch.zeros(p * h * w, dtype=torch.float32, device=grids.device)
    count.index_add_(0, cell.reshape(-1),
                     (rm >= 0.0).to(torch.float32).expand(p, -1).reshape(-1))
    count = count.reshape(p, h, w)
    near_end = _dilate3x3((count > 0.5).to(torch.float32)) > 0.5

    r_c, b_full = _beam_index_reference(cfg, poses)
    in_fov = b_full < cfg.num_beams
    rb = rm[torch.clamp(b_full, max=cfg.num_beams - 1)]
    free = in_fov & (r_c < rb - res) & ~near_end
    # A true division, as the kernel's: torch computes scalar / tensor as
    # a reciprocal times the scalar, which rounds differently.
    m = torch.clamp(r_c.new_tensor(res) / (torch.clamp(r_c, min=0.5 * res)
                                           * cfg.beam_delta),
                    max=float(cfg.num_beams))
    d_free = cfg.l_free - cfg.l_prior
    d_occ = cfg.l_occ - cfg.l_prior
    gnew = grids + torch.where(free, m * d_free, 0.0) + d_occ * count
    return gnew, _edt_reference(cfg, gnew)


def _edt_reference(cfg: GridConfig, grids):
    """K4 in plain torch: the batched ESDF of ``estimation/rbpf/grid.py``.
    The EDT is exact small-integer arithmetic until the final sqrt·res,
    so this equals the kernels' row pass and column envelope bit for bit."""
    from ..estimation.rbpf.grid import esdf

    return esdf(cfg, grids)


def _check_inputs(cfg: GridConfig, grids, ranges=None, poses=None,
                  table=None):
    if grids.dim() != 3:
        raise ValueError(f"grids must be (P, H, W), got {tuple(grids.shape)}")
    p = grids.shape[0]
    named = [("grids", grids, (p, cfg.height, cfg.width))]
    if ranges is not None:
        named += [("ranges", ranges, (cfg.num_beams,)),
                  ("poses", poses, (p, 3))]
    if table is not None:
        named.append(("table", table, (beams.ROWS, cfg.num_beams)))
    check_tensors(named, grids.device)
    if grids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no map-update path for device {grids.device}")


def _launch_map(cfg: GridConfig, grids, ranges, poses, table, beam_out):
    global MAP_LAUNCHES
    lib = load()
    gout = torch.empty_like(grids)
    dout = torch.empty_like(grids)
    if grids.shape[0] == 0:
        return gout, dout
    scratch = _scratch(lib, _map_layout(cfg, lib.tpunav_max_dynamic_smem()),
                       grids.shape[0], grids.device,
                       f"the map update of a {cfg.height}x{cfg.width} map")
    if table is None:
        table = beams.beam_table(cfg, ranges)
    trig = _pose_trig(poses)
    params = _map_params(cfg, grids.shape[0])
    with torch.cuda.device(grids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tpunav_map_update(
            ctypes.addressof(params), grids.data_ptr(), poses.data_ptr(),
            trig.data_ptr(), table.data_ptr(), gout.data_ptr(),
            dout.data_ptr(), None if beam_out is None else beam_out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stream)
    check_launch(lib, err, "map-update")
    MAP_LAUNCHES += 1
    return gout, dout


def map_update_batch(cfg: GridConfig, grids, ranges, poses, table=None,
                     beam_out=None):
    """Integrate one (B,) float32 scan into every particle's (P, H, W)
    float32 log-odds grid, each from its (P, 3) pose [θ, x, y], and rebuild
    each distance field: returns (new_grids, dist_fields). On the card this
    is kernel K3; on the CPU its plain version. ``table``: the scan's
    :func:`beams.beam_table`, if the caller has built it.

    ``beam_out``: an optional (P, H, W) int32 CUDA tensor that receives each
    cell's beam index (mod beams per revolution), for checking the kernel's
    bearing quantizer against :func:`_beam_index_reference`."""
    _check_inputs(cfg, grids, ranges, poses, table)
    if grids.is_cuda:
        if beam_out is not None and (
                beam_out.dtype != torch.int32 or beam_out.shape != grids.shape
                or beam_out.device != grids.device
                or not beam_out.is_contiguous()):
            raise ValueError("beam_out must be a contiguous int32 tensor "
                             "shaped and placed like grids")
        return _launch_map(cfg, grids, ranges, poses, table, beam_out)
    if beam_out is not None:
        raise ValueError("beam_out is filled by the kernel only")
    return _map_update_reference(cfg, grids, ranges, poses, table)


def edt_batch(cfg: GridConfig, grids):
    """Distance fields (P, H, W) of (P, H, W) float32 log-odds grids — the
    EDT stage of :func:`map_update_batch` alone, bit-identical to the
    fields it produces from the same grids. On the card this is kernel K4;
    on the CPU its plain version."""
    global EDT_LAUNCHES
    _check_inputs(cfg, grids)
    if not grids.is_cuda:
        return _edt_reference(cfg, grids)
    lib = load()
    dout = torch.empty_like(grids)
    if grids.shape[0] == 0:
        return dout
    scratch = _scratch(lib, _edt_layout(cfg, lib.tpunav_max_dynamic_smem()),
                       grids.shape[0], grids.device,
                       f"the EDT of a {cfg.height}x{cfg.width} map")
    params = _map_params(cfg, grids.shape[0])
    with torch.cuda.device(grids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tpunav_edt(ctypes.addressof(params), grids.data_ptr(),
                             dout.data_ptr(),
                             None if scratch is None else scratch.data_ptr(),
                             stream)
    check_launch(lib, err, "EDT")
    EDT_LAUNCHES += 1
    return dout
