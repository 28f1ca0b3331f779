"""ray_tpu_torch.util — metrics, state API, and operator utilities.

Reference: `python/ray/util/` (SURVEY.md §2.3). The port's copies of
the JAX package's `ray_tpu/util/` modules: the metrics registry
(`metrics`), tracing spans (`tracing`), structured events (`events`),
the per-step flight recorder (`step_profiler`), the per-request
recorder (`request_recorder`), the state API (`state`), the timeline
(`timeline`), `actor_pool`, `queue`, `multiprocessing`, the metrics
time series (`tsdb`) and the SLO alerts (`slo`). The Ray Client
(`util/client`) comes with its own slice of the port.
"""

from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram
from ray_tpu_torch.util.timeline import timeline
from ray_tpu_torch.util.state import (
    list_actors,
    list_nodes,
    list_objects,
    list_tasks,
    summarize_tasks,
)

__all__ = ["Counter", "Gauge", "Histogram", "list_actors", "list_nodes",
           "list_objects", "list_tasks", "summarize_tasks", "timeline"]
