"""ray_tpu_torch.parallel — the compiled-step cache (one CUDA graph per
abstract signature, `compile_cache`) and the attention references (the
sharded variants come with the port of the JAX package's `parallel/`)."""

from ray_tpu_torch.parallel.compile_cache import (  # noqa: F401
    CacheStats, ExecutableCache, RetraceError, cache_stats, compiled_step,
    global_cache)
from ray_tpu_torch.parallel.ring_attention import (  # noqa: F401
    NEG_INF, expand_kv_heads, full_attention)

__all__ = ["CacheStats", "ExecutableCache", "NEG_INF", "RetraceError",
           "cache_stats", "compiled_step", "expand_kv_heads",
           "full_attention", "global_cache"]
