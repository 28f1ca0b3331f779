"""Device idle ms a training step while the host was inside a
`train.step` span (the runner's call and its children;
`portbench/spans.py`)."""

from portbench import spans


def read(ctx):
    return spans.train_idle_ms(ctx["trace"], inside=True)
