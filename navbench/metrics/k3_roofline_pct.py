"""K3's share of its roofline: the least time the map updates of the
stretch's updates need (``peaks.rbpf_work`` on each update's scan), over
K3's device time in the stretch."""

from navbench.metrics import kernel_share


def read(ctx):
    return kernel_share(ctx, "K3", "k3_bound_s")
