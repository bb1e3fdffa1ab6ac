"""The yardstick's constants: one H100's published peaks, the least time a
piece of work can take on it, and the work that each kernel's function
needs at a cell's shapes.

The counts depend on the shapes and on the inputs given (the valid beams of
a scan), never on how the port implements a function, so a kernel that is
redesigned or merged is still measured against the same work.
"""

from __future__ import annotations

# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): HBM3 bytes/s
# and float32 operations/s outside the tensor cores (no kernel measured
# here uses them).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float, peak: float = F32_OPS_PER_S):
    """(seconds, "bytes" or "operations"): the least time for ``nbytes`` of
    traffic and ``ops`` operations at the card's peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / peak
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def k1_work(k: int, n: int):
    """(bytes, operations) of one fused MPPI solve of K rollouts over N
    steps: u, pose, goal and seed in and u_next out; per rollout and step
    about 171 operations — one Philox4x32-10 draw (~100 integer
    operations), one Box-Muller pair (~8), the RK4 step with its six
    cos/sin (~35), the loss (~17), the cost-to-go add and the softmax
    partial (~11)."""
    return 4 * (2 * n + 3 + 3 + 1 + 2 * n), 171.0 * k * n


def rbpf_work(p: int, k: int, h: int, w: int, beams: int, valid: int):
    """{"K2": (bytes, ops), "K3": (bytes, ops)} of one RBPF update: the
    likelihood sweep of ``k`` samples per particle (the proposal's and the
    motion model's) over P fields of H×W, and the map update of P grids
    with its distance field, for a scan of ``beams`` beams of which
    ``valid`` lie in range."""
    hw = h * w
    # K2: per valid (sample, beam) the endpoint (8), its cell (10) and the
    # sum (1); the mixture (6) once per cell or per lookup, whichever is
    # fewer; cos and sin per sample.
    k2 = (4 * (p * hw + p * k * 3 + beams + p * k),
          p * (k * (19 * valid + 2) + 6 * min(hw, k * valid)))
    # An exact EDT needs O(1) work per cell: the two row sweeps and the
    # square (5); a linear-time lower envelope down each column, where each
    # cell enters and leaves the envelope once, at most two intersection
    # tests of ~8 operations (16), and its evaluation (4); sqrt·res and the
    # cap (3). K3 per cell: bearing, quantizer, dilation, free test, mass
    # and update (55) then the EDT; per valid beam its endpoint cell (16).
    edt = 5 + 16 + 4 + 3
    k3 = (4 * (3 * p * hw + 3 * p + beams),
          p * (hw * (55 + edt) + 16 * valid))
    return {"K2": k2, "K3": k3}
