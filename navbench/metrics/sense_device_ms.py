"""Device ms of the sensor chain on a sensing tick, for all B seeds of the
sweep: the tracer's ``slam.sense`` phase around the lidar's raycast, the
circle detector with its eigensolver and the measurements' hand-off, its
mean over the window's replays taken without the profiler. Also the
arithmetic that the EKF's reader shares."""


def phase_ms(ctx, name: str):
    """A tracer phase's mean device ms, or None where the driver gave no
    phases or the phase was never timed (a program without it)."""
    phase = ctx.get("phases", {}).get(name)
    if not phase or not phase.get("count"):
        return None
    return phase["mean_ms"]


def read(ctx):
    return phase_ms(ctx, "slam.sense")
