"""ray_tpu_torch.parallel — the compiled-step cache (one CUDA graph per
abstract signature, `compile_cache`; `fold_steps` folds K steps into one)
and the attention references (the sharded variants come with the port of
the JAX package's `parallel/`)."""

from ray_tpu_torch.parallel.compile_cache import (  # noqa: F401
    CacheStats, ExecutableCache, RetraceError, cache_stats, compiled_step,
    fold_steps, global_cache, stack_batches)
from ray_tpu_torch.parallel.ring_attention import (  # noqa: F401
    NEG_INF, expand_kv_heads, full_attention)

__all__ = ["CacheStats", "ExecutableCache", "NEG_INF", "RetraceError",
           "cache_stats", "compiled_step", "expand_kv_heads",
           "fold_steps", "full_attention", "global_cache",
           "stack_batches"]
