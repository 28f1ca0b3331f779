"""Device ms a training step of GEMM kernels (by kernel name)."""


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    return 1e3 * t.class_seconds().get("gemm", 0.0) / ctx["profile_steps"]
