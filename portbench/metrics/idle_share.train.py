"""Percent of the profiled segment in which no operation ran on the
device: (segment - busy) / segment, from the profiler's trace."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
