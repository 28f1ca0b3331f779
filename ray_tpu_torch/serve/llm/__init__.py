"""serve.llm — LLM inference plane of the port: a paged KV cache in
device memory (`kv_cache.py`) and the continuous-batching engine
(`engine.py`). The Serve deployment comes with the port of the runtime.
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
