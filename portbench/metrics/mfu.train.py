"""Whole training step's share of the bf16 peak: the algorithmic FLOPs
of a step (`peaks.train_flops`) times the window's steps a second, over
989 TFLOP/s."""

from portbench import peaks


def read(ctx):
    w = ctx["window"]
    if not w["steps"]:
        return None
    return 100.0 * ctx["flops_per_step"] * w["steps"] / w["elapsed_s"] \
        / peaks.PEAK_BF16_FLOPS
