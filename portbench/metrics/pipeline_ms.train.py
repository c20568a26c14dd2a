"""Milliseconds a training step spends in the data pipeline's ``next``
(the OREO decision over the corpus metadata, the selection scan and the
batch draw), over the window's steps: the benchmark's span."""


def read(ctx):
    seconds, calls = ctx.window["spans"].get("pipeline", (0.0, 0))
    return 1e3 * seconds / calls if calls else None
