"""The share of the traced stretch in which no operation ran on the device:
one minus the union of the device operations' intervals over the span from
the stretch's first device operation to the end of its last, all read from
the trace. It serves every ``device_idle_pct.<cells>`` metric; the cells
each one reads in are listed in BENCHMARK.json."""


def read(ctx):
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
