"""Device ms of the EKF update on a sensing tick, for all B seeds of the
sweep: the tracer's ``ekf.update`` phase (two timing events captured into
the chunk's graph around the masked unknown-DA step), its mean over the
window's replays taken without the profiler."""

from navbench.metrics.sense_device_ms import phase_ms


def read(ctx):
    return phase_ms(ctx, "ekf.update")
