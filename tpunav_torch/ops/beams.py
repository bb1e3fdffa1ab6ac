"""One scan's beam geometry and the per-cell beam quantizers.

The likelihood field (K2, ``likelihood.py``), the map update (K3,
``map_update.py``), their plain versions and the grid functions of
``estimation/rbpf/grid.py`` all read one scan through :func:`beam_table`.
The particle filter builds the table once per scan and hands it to both
kernels.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

import torch

from .trig import atan2, positive_mod, round_half_up

if TYPE_CHECKING:
    from ..estimation.rbpf.grid import GridConfig

# Rows of the beam table. A beam is valid when range_min <= r < range_max.
R = 0          # the range, range_min where invalid
COS = 1        # cos of the beam angle
SIN = 2        # sin of the beam angle
R_MARK = 3     # the range, -1 where invalid
R_COS = 4      # R·cos
R_SIN = 5      # R·sin
ROWS = 6


def beam_table(cfg: GridConfig, ranges):
    """The (6, B) table of one (B,) scan in the scan's dtype, rows as named
    above. K3 reads rows R..R_MARK, K2 rows R_MARK..R_SIN."""
    beam = cfg.beam_min + cfg.beam_delta * torch.arange(
        cfg.num_beams, dtype=ranges.dtype, device=ranges.device)
    valid = torch.logical_and(ranges >= cfg.range_min,
                              ranges < cfg.range_max)
    r = torch.where(valid, ranges, cfg.range_min)
    cb, sb = torch.cos(beam), torch.sin(beam)
    return torch.stack([r, cb, sb, torch.where(valid, ranges, -1.0),
                        r * cb, r * sb])


def beams_per_revolution(cfg: GridConfig) -> int:
    """Number of beam slots in a full revolution; raises unless
    ``beam_delta`` divides 2π evenly (otherwise the dense per-cell beam
    assignment would wrap to the wrong beam)."""
    b_full_f = float(2.0 * math.pi / cfg.beam_delta)
    b_full = int(round(b_full_f))
    if abs(b_full_f - b_full) > 1e-6:
        raise ValueError(
            f"beam_delta={cfg.beam_delta} must divide 2*pi evenly "
            f"(got {b_full_f} beams/revolution)")
    return b_full


def cell_beams(cfg: GridConfig, pose, dtype=torch.float32,
               kernel_form: bool = False):
    """Each cell's range from the sensor and covering beam under ``pose``
    (..., 3): (r_c (..., H, W), beam index (..., H, W) int64 in
    [0, beams per revolution)).

    Two forms, each bit for bit the quantizer of one ``tpunav`` path. By
    default the cell offset is (xmin + (i + ½)·res) − x and the bearing is
    divided by δ, as in ``tpunav``'s ``integrate_scan``; ``kernel_form``
    takes (xmin + ½res − x) + res·i and multiplies by 1/δ, as its
    ``_map_kernel`` and so kernel K3 do. The two round apart on a few cells
    (tests/test_torch_rbpf_ops.py shows one at the test's poses), and such
    a cell's free-space update moves with its beam, so both forms stay."""
    h, w, res = cfg.height, cfg.width, cfg.resolution
    kw = dict(dtype=dtype, device=pose.device)
    th, px, py = (pose[..., i, None, None] for i in range(3))
    if kernel_form:
        dx = (cfg.xmin + res * 0.5 - px) + res * torch.arange(w, **kw)
        dy = (cfg.ymin + res * 0.5 - py) + res * torch.arange(h, **kw)[:, None]
    else:
        dx = cfg.xmin + (torch.arange(w, **kw) + 0.5) * res - px
        dy = cfg.ymin + (torch.arange(h, **kw)[:, None] + 0.5) * res - py
    alpha = positive_mod(atan2(dy, dx) - th - cfg.beam_min, 2.0 * math.pi)
    q = (alpha * (1.0 / cfg.beam_delta) if kernel_form
         else alpha / cfg.beam_delta)
    b = round_half_up(q).long() % beams_per_revolution(cfg)
    return torch.sqrt(dx * dx + dy * dy), b
