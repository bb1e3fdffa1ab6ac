"""Device µs a control tick spends outside K1's kernels: the waypoint
advance, the motor, the plant and the runner's copies."""

from navbench.metrics import device_seconds
from navbench.trace import family_seconds


def read(ctx):
    total = device_seconds(ctx)
    if total is None:
        return None
    rest = total - family_seconds(ctx, "mppi_")
    return 1e6 * rest / ctx["delta"]["solves"]
