"""Device ms a training step of elementwise, copy/cast and reduction
kernels (the profiler's kernels by name, `profiler.KERNEL_CLASSES`)."""

UNFUSED = ("elementwise", "copy/cast", "reduction")


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    by = t.class_seconds()
    return 1e3 * sum(by.get(c, 0.0) for c in UNFUSED) / ctx["profile_steps"]
