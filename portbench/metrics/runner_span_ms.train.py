"""The median `train.step` span of the traced steps, ms: one
`TrainStepRunner.run` call on the program's own clock (the in-program
counterpart of `runner_host_ms.train`; `portbench/spans.py`)."""

from portbench import spans


def read(ctx):
    return spans.span_ms_median(ctx["trace"], "train.step")
