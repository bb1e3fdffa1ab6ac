"""K1's share of its roofline: the least time one fused solve of the
cell's K rollouts over N steps needs on the card (``peaks.k1_work``), over
K1's device time per launch in the stretch (both of its kernels)."""

from navbench.metrics import k1_share


def read(ctx):
    return k1_share(ctx)
