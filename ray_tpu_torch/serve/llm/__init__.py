"""serve.llm — LLM inference plane of the port.

Paged KV cache in device memory (`kv_cache.py`) + the continuous-batching
engine on the compiled-step cache, one CUDA graph per bucket
(`engine.py`) + a Serve deployment streaming tokens over
`handle_request_streaming` (`deployment.py`), as in the JAX package's
`ray_tpu/serve/llm`.

The names load lazily (PEP 562): Serve's controller unpickles
`LLMDeployment` and imports `reclaim_arena` without importing torch, as
the JAX controller never imports jax; replicas pay for torch when they
build their engine.
"""

import importlib

_EXPORTS = {
    "KVCacheError": "kv_cache",
    "OutOfPagesError": "kv_cache",
    "PagedKVCache": "kv_cache",
    "PrefixCache": "kv_cache",
    "reclaim_arena": "kv_cache",
    "EngineConfig": "engine",
    "LLMEngine": "engine",
    "Request": "engine",
    "RequestRejected": "engine",
    "LLMDeployment": "deployment",
    "build_app": "deployment",
}


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


__all__ = sorted(_EXPORTS)
