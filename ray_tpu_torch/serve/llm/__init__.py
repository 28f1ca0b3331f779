"""serve.llm — LLM inference plane of the port: a paged KV cache in
device memory (`kv_cache.py`) and the continuous-batching engine on the
compiled-step cache, one CUDA graph per bucket (`engine.py`). The Serve
deployment and `reclaim_arena` come with the port of the runtime.
"""

from ray_tpu_torch.serve.llm.kv_cache import (
    KVCacheError,
    OutOfPagesError,
    PagedKVCache,
    PrefixCache,
)
from ray_tpu_torch.serve.llm.engine import (
    EngineConfig,
    LLMEngine,
    Request,
    RequestRejected,
)

__all__ = [
    "EngineConfig",
    "KVCacheError",
    "LLMEngine",
    "OutOfPagesError",
    "PagedKVCache",
    "PrefixCache",
    "Request",
    "RequestRejected",
]
