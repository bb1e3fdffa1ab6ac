"""The per-layer metrics: ``<name>.py`` holds ``read(ctx)``, which returns
the metric from a profiled stretch (``navbench.trace``) or None where the
stretch holds nothing for it. What several readers share is here.

A metric named ``<quantity>.<cells>`` (one quantity split by the
end-to-end metric it moves) is read by ``<quantity>.py`` where it has no
file of its own; BENCHMARK.json's ``workloads`` say where it is read."""

from navbench.peaks import bound_s, k1_work
from navbench.trace import family_seconds_per_launch, nearly_sound


def k1_share(ctx):
    """K1's roofline share in %, both of its kernels, or None where K1 did
    not run."""
    per_launch = family_seconds_per_launch(ctx, "K1", "mppi_")
    if per_launch is None:
        return None
    return 100.0 * bound_s(*k1_work(ctx["k"], ctx["n"]))[0] / per_launch


def kernel_share(ctx, key: str, bound_key: str):
    """A kernel's roofline share in %: the least time of its launches in the
    stretch (the driver's tally of their work) over its device time per
    recorded launch times its launches."""
    per_launch = family_seconds_per_launch(ctx, key)
    if per_launch is None:
        return None
    return 100.0 * ctx["delta"][bound_key] / (per_launch *
                                              ctx["counters"][key])


def device_seconds(ctx):
    """Every operation's device seconds in the stretch, or None where the
    profiler dropped too many kernel records to give it."""
    if not nearly_sound(ctx, ctx["steps"]):
        return None
    return sum(s for s, _ in ctx["kernels"].values())

