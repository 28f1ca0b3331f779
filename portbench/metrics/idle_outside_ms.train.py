"""Device idle ms a training step while the host was outside every
`train.step` span (the caller's loop between runner calls, the trace's
ends; `portbench/spans.py`)."""

from portbench import spans


def read(ctx):
    return spans.train_idle_ms(ctx["trace"], inside=False)
