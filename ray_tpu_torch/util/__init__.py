"""ray_tpu_torch.util — the port's own copies of the JAX package's
JAX-free observability modules: the metrics registry (`metrics`),
tracing spans (`tracing`), structured events (`events`), the per-step
flight recorder (`step_profiler`) and the per-request recorder
(`request_recorder`). The state API and the timeline come with the port
of the runtime."""

from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

__all__ = ["Counter", "Gauge", "Histogram"]
