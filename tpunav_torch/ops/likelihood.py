"""The batched likelihood-field sensor model (kernel K2): its wrapper and
its plain version.

Port of ``tpunav/ops/pallas_likelihood.py`` (``likelihood_field_batch``,
``_lik_pallas``). The kernel is hand-written CUDA for Hopper,
``csrc/likelihood.cu``; it replaces the Pallas kernel ``_lik_kernel``. For
(P, H, W) distance fields, a (B,) scan and (P, k, 3) pose samples it
returns log P(z | m, x) of shape (P, k) under the likelihood-field mixture
(ref: bmapping/src/bmapping/grid_mapper.cpp:69-133).

The kernel turns each field into a table of the mixture's log per cell and
sums table lookups. :func:`_plan` picks its path from the shapes and the
card alone: fused (one launch, the table in shared memory) or two-pass (a
table launch into a global scratch, then a lookup launch), with the same
bits.

A CPU tensor takes the plain version (:func:`_lik_reference`, the TPU
kernel's arithmetic in plain torch); a CUDA tensor launches the kernel, or
raises. ``LIK_LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import TYPE_CHECKING

import torch

from . import beams
from ._build import (check_launch, check_shared_memory, check_tensors,
                     load, sm_count)

if TYPE_CHECKING:
    from ..estimation.rbpf.grid import GridConfig

LIK_LAUNCHES = 0            # kernel launches (one or two per call on the card)
_TABLE_CELLS = 2048         # csrc/likelihood.cu's kTableCells
_LOOKUP_WARPS = 8           # csrc/likelihood.cu's kLookupWarps


class _LikParams(ctypes.Structure):
    """Mirror of ``LikParams`` in csrc/likelihood.cu."""

    _fields_ = [
        ("particles", ctypes.c_int), ("samples", ctypes.c_int),
        ("height", ctypes.c_int), ("width", ctypes.c_int),
        ("beams", ctypes.c_int),
        ("xmin", ctypes.c_float), ("ymin", ctypes.c_float),
        ("inv_res", ctypes.c_float), ("neg_half_inv_var", ctypes.c_float),
        ("zh_norm", ctypes.c_float), ("floor_p", ctypes.c_float),
        ("max_occ", ctypes.c_float),
    ]


def _constants(cfg: GridConfig):
    """The mixture's constants, formed in double as ``tpunav`` forms them:
    (1/res, -0.5/σ², z_hit/sqrt(2πσ²), z_rand/z_max)."""
    var = float(cfg.sigma_hit) ** 2
    return (1.0 / cfg.resolution, -0.5 * (1.0 / var),
            float(cfg.z_hit) / (2.0 * math.pi * var) ** 0.5,
            float(cfg.z_rand) / float(cfg.z_max))


def _lik_reference(cfg: GridConfig, dist_fields, ranges, samples,
                   table=None):
    """K2 in plain torch: the endpoint, cell and mixture expressions of the
    kernel (and of ``_lik_pallas``), with the beam sum taken by
    ``torch.sum``. ``table``: the scan's beam table, if already built."""
    p, h, w = dist_fields.shape
    inv_res, nhiv, zh_norm, floor_p = _constants(cfg)
    if table is None:
        table = beams.beam_table(cfg, ranges)
    rm, rcb, rsb = table[beams.R_MARK:]
    th = samples[..., 0]
    c0, s0 = torch.cos(th)[..., None], torch.sin(th)[..., None]
    ex = samples[..., 1, None] + c0 * rcb - s0 * rsb          # (P, k, B)
    ey = samples[..., 2, None] + s0 * rcb + c0 * rsb
    ix = torch.clamp(torch.floor((ex - cfg.xmin) * inv_res), 0, w - 1)
    iy = torch.clamp(torch.floor((ey - cfg.ymin) * inv_res), 0, h - 1)
    idx = (iy.long() * w + ix.long()).reshape(p, -1)
    d = torch.gather(dist_fields.reshape(p, h * w), 1, idx).reshape(ex.shape)
    pz = zh_norm * torch.exp(nhiv * d * d) + floor_p
    lp = torch.sum(torch.where(rm >= 0.0, torch.log(pz), 0.0), dim=-1)
    any_occ = (dist_fields < cfg.max_occ_dist).reshape(p, -1).any(1)
    return torch.where(any_occ[:, None], lp, 0.0)


def _check_inputs(cfg: GridConfig, dist_fields, ranges, samples, table):
    if dist_fields.dim() != 3 or samples.dim() != 3:
        raise ValueError("dist_fields must be (P, H, W) and samples "
                         "(P, k, 3)")
    p, k = dist_fields.shape[0], samples.shape[1]
    named = [("dist_fields", dist_fields, (p, cfg.height, cfg.width)),
             ("ranges", ranges, (cfg.num_beams,)),
             ("samples", samples, (p, k, 3))]
    if table is not None:
        named.append(("table", table, (beams.ROWS, cfg.num_beams)))
    check_tensors(named, dist_fields.device)


def _beam_bytes(b: int) -> int:
    """Shared memory of the compacted beam table and its chunk counts."""
    return 8 * b + 4 * -(-b // 32)


def _fused_bytes(h: int, w: int, b: int, k: int) -> int:
    """The fused path's dynamic shared memory per block (as
    tpunav_likelihood_field sizes it): the lp table at the odd row stride
    W | 1, rounded up to 16 bytes, each sample's (cos θ, sin θ, x, y), the
    beams."""
    return 4 * ((h * (w | 1) + 3) // 4 * 4) + 16 * k + _beam_bytes(b)


def _lookup_bytes(b: int) -> int:
    """The two-pass lookup launch's dynamic shared memory per block."""
    return 16 * _LOOKUP_WARPS + _beam_bytes(b)


def _plan(p: int, k: int, h: int, w: int, b: int, sms: int,
          smem_limit: int):
    """K2's path for P particles, k samples, an H×W field and B beams on a
    card with ``sms`` SMs that lets a block opt in to ``smem_limit`` bytes
    of shared memory: ("fused", launches 1, scratch floats 0) where one
    particle's block fits and there are at least as many particles as SMs;
    else ("two_pass", 2, the scratch floats of the lp table (P, H, W) and
    its per-chunk occupancy flags)."""
    if _fused_bytes(h, w, b, k) <= smem_limit and p >= sms:
        return "fused", 1, 0
    return "two_pass", 2, p * h * w + p * (-(-h * w // _TABLE_CELLS))


def _launch(cfg: GridConfig, dist_fields, ranges, samples, table):
    global LIK_LAUNCHES
    lib = load()
    p, h, w = dist_fields.shape
    k = samples.shape[1]
    out = torch.empty((p, k), dtype=torch.float32, device=dist_fields.device)
    if p == 0 or k == 0:
        return out
    b = cfg.num_beams
    path, launches, scratch_floats = _plan(
        p, k, h, w, b, sm_count(dist_fields.device),
        lib.tpunav_max_dynamic_smem())
    scratch = None
    if path == "two_pass":
        check_shared_memory(lib, _lookup_bytes(b),
                            f"the likelihood lookups of {b} beams")
        scratch = torch.empty(scratch_floats, dtype=torch.float32,
                              device=dist_fields.device)
    if table is None:
        table = beams.beam_table(cfg, ranges)
    inv_res, nhiv, zh_norm, floor_p = _constants(cfg)
    params = _LikParams(p, k, h, w, b, cfg.xmin, cfg.ymin,
                        inv_res, nhiv, zh_norm, floor_p, cfg.max_occ_dist)
    with torch.cuda.device(dist_fields.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tpunav_likelihood_field(
            ctypes.addressof(params), dist_fields.data_ptr(),
            samples.data_ptr(), table[beams.R_MARK:].data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), stream)
    check_launch(lib, err, "likelihood-field")
    LIK_LAUNCHES += launches
    return out


def likelihood_field_batch(cfg: GridConfig, dist_fields, ranges, samples,
                           table=None):
    """log P(z | m, x) for (P, k, 3) float32 pose samples against (P, H, W)
    float32 distance fields and a (B,) float32 scan. Returns (P, k); 0 for
    a particle whose map has no occupied cell. On the card this is kernel
    K2; on the CPU its plain version. ``table``: the scan's
    :func:`beams.beam_table`, if the caller has built it."""
    _check_inputs(cfg, dist_fields, ranges, samples, table)
    if dist_fields.is_cuda:
        return _launch(cfg, dist_fields, ranges, samples, table)
    if dist_fields.device.type != "cpu":
        raise ValueError(f"no likelihood-field path for device "
                         f"{dist_fields.device}")
    return _lik_reference(cfg, dist_fields, ranges, samples, table)
