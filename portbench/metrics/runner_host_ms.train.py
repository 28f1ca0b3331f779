"""The harness's own clock around each `TrainStepRunner.run` call of the
window (the call returns after its synchronize): the median call, ms."""

import statistics


def read(ctx):
    calls = ctx["window"]["call_ms"]
    return statistics.median(calls) if calls else None
