"""K1's share of its roofline with its problem axis: the least time that
B fused solves of the cell's K rollouts over N steps need on the card
(``peaks.k1_work`` of one solve, times B), over K1's device time per
launch in the stretch (both of its kernels; one launch solves all B)."""

from navbench.peaks import bound_s, k1_work
from navbench.trace import family_seconds_per_launch


def read(ctx):
    per_launch = family_seconds_per_launch(ctx, "K1", "mppi_")
    if per_launch is None or "b" not in ctx:
        return None
    nbytes, ops = k1_work(ctx["k"], ctx["n"])
    return 100.0 * bound_s(ctx["b"] * nbytes, ctx["b"] * ops)[0] / per_launch
