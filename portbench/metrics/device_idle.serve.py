"""Share of the traced stretch of serving in which no operation ran on the
device."""


def read(ctx):
    t = ctx["trace"]
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.window_s)
