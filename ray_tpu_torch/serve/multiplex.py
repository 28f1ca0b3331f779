"""Model multiplexing: many models behind one deployment's replicas.

Reference: `python/ray/serve/multiplex.py` — `@serve.multiplexed` wraps
a per-model loader; each replica keeps an LRU of loaded models
(`max_num_models_per_replica`) and requests carry the model id. On TPU
replicas the loader typically returns jitted apply fns + device-resident
params, so the LRU bound is what keeps HBM usage flat.
"""

from __future__ import annotations

import asyncio
import contextvars
import functools
import threading
from collections import OrderedDict
from typing import Any, Callable, Optional

# contextvar, NOT threading.local: concurrent requests interleave on one
# async replica's event loop and must each see their own model id
_current_model_id: "contextvars.ContextVar[str]" = \
    contextvars.ContextVar("multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """Inside a request: the model id this call was routed for
    (reference `serve.get_multiplexed_model_id`)."""
    return _current_model_id.get()


def _set_model_id(model_id: str):
    _current_model_id.set(model_id)


class _LRU:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self._items: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key: str):
        with self._lock:
            if key in self._items:
                self._items.move_to_end(key)
                return True, self._items[key]
            return False, None

    def put(self, key: str, value: Any):
        evicted = []
        with self._lock:
            self._items[key] = value
            self._items.move_to_end(key)
            while len(self._items) > self.capacity:
                evicted.append(self._items.popitem(last=False))
        return evicted


def multiplexed(max_num_models_per_replica: int = 3):
    """Decorator for the model loader method of a deployment class:

        @serve.deployment
        class Multi:
            @serve.multiplexed(max_num_models_per_replica=2)
            async def load(self, model_id: str):
                return load_model(model_id)

            async def __call__(self, body):
                model = await self.load(body["model"])
                return model(body["input"])

    Loaded models are LRU-cached per replica; loading beyond the cap
    evicts the least recently used (whose `__del__`/`unload` frees HBM).
    """

    def decorate(loader: Callable):
        state_attr = f"_multiplex_state_{loader.__name__}"

        def _state(self):
            # per-INSTANCE cache: two replicas of the class in one
            # process must not share (or cross-evict) each other's
            # device-bound models
            state = self.__dict__.get(state_attr)
            if state is None:
                state = self.__dict__[state_attr] = (
                    _LRU(max_num_models_per_replica), {})
            return state

        @functools.wraps(loader)
        async def wrapper(self, model_id: str):
            cache, inflight = _state(self)
            hit, model = cache.get(model_id)
            if hit:
                _set_model_id(model_id)
                return model
            # dedupe concurrent cold loads: two requests for the same
            # unloaded model must share ONE loader call — a double load
            # doubles peak HBM and orphans the losing copy
            fut = inflight.get(model_id)
            if fut is not None:
                result = await fut
                _set_model_id(model_id)
                return result
            fut = asyncio.get_event_loop().create_future()
            inflight[model_id] = fut
            try:
                result = loader(self, model_id)
                if asyncio.iscoroutine(result):
                    result = await result
            except BaseException as e:
                fut.set_exception(e)
                inflight.pop(model_id, None)
                raise
            for _key, old in cache.put(model_id, result):
                unload = getattr(old, "unload", None)
                if callable(unload):
                    try:
                        unload()
                    except Exception:  # noqa: BLE001
                        pass
            fut.set_result(result)
            inflight.pop(model_id, None)
            _set_model_id(model_id)
            return result

        wrapper.__wrapped_loader__ = loader
        return wrapper

    return decorate
