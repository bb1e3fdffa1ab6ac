"""K2's share of its roofline: the least time the likelihood sweeps of the
stretch's updates need (``peaks.rbpf_work`` on each update's scan), over
K2's device time in the stretch."""

from navbench.metrics import kernel_share


def read(ctx):
    return kernel_share(ctx, "K2", "k2_bound_s")
