"""Device ms per SLAM update: every operation of the replayed step,
summed, over the updates in the stretch."""

from navbench.metrics import device_seconds


def read(ctx):
    total = device_seconds(ctx)
    return None if total is None else 1e3 * total / ctx["delta"]["updates"]
