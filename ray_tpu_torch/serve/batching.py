"""@serve.batch — opportunistic request batching inside a replica.

Reference: `python/ray/serve/batching.py` — concurrent calls to the
decorated method are queued; a batch runs when `max_batch_size` items are
waiting or the oldest has waited `batch_wait_timeout_s`. The TPU angle:
batched inference keeps the MXU fed — callers batch lists of inputs into
one jitted forward pass.

Requires the replica to receive concurrent calls (replica actors run with
max_concurrency = max_ongoing_requests).
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Callable, List, Optional


class _Batcher:
    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout = batch_wait_timeout_s
        self._lock = threading.Lock()
        self._queue: List[dict] = []
        self._flush_scheduled = False

    def submit(self, instance, item: Any) -> Any:
        entry = {"item": item, "event": threading.Event(),
                 "result": None, "error": None}
        batch: List[dict] = []
        timer = None
        with self._lock:
            self._queue.append(entry)
            if len(self._queue) >= self.max_batch_size:
                batch, self._queue = self._queue, []
                self._flush_scheduled = False
            elif not self._flush_scheduled:
                self._flush_scheduled = True
                timer = threading.Timer(
                    self.timeout, self._flush_timer, args=(instance,))
                timer.daemon = True
        # thread spawn and the batched call both stay outside the
        # critical section: the lock only guards the queue swap
        if timer is not None:
            started = False
            try:
                timer.start()
                started = True
            finally:
                if not started:
                    # un-wedge the batcher: with the flag stuck True no
                    # later submit would ever schedule a flush, hanging
                    # every queued caller
                    with self._lock:
                        self._flush_scheduled = False
        if batch:
            self._run(instance, batch)
        if not entry["event"].wait(timeout=600.0):
            raise TimeoutError(
                "batched call did not complete within 600s")
        if entry["error"] is not None:
            raise entry["error"]
        return entry["result"]

    def _flush_timer(self, instance):
        with self._lock:
            batch, self._queue = self._queue, []
            self._flush_scheduled = False
        if batch:
            self._run(instance, batch)

    def _run(self, instance, batch: List[dict]) -> None:
        items = [e["item"] for e in batch]
        try:
            results = (self.fn(instance, items) if instance is not None
                       else self.fn(items))
            if len(results) != len(items):
                raise ValueError(
                    f"batched fn returned {len(results)} results for "
                    f"{len(items)} inputs")
            for e, r in zip(batch, results):
                # per-item failure: a batched fn returns an Exception
                # INSTANCE in an item's slot (reference semantics: one
                # bad input fails its own caller, not its batch-mates)
                if isinstance(r, Exception):
                    e["error"] = r
                else:
                    e["result"] = r
        except Exception as err:  # noqa: BLE001 — a raise (not a
            # returned per-item error) still fails the whole batch:
            # there is no way to know which input caused it
            for e in batch:
                e["error"] = err
        finally:
            for e in batch:
                e["event"].set()


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorate a method taking a LIST of inputs -> list of outputs.

    The _Batcher (which holds locks/timers) is created lazily in the
    process that serves requests — the decorated class must stay
    cloudpickle-able for shipment to replica actors.
    """

    def wrap(fn):
        key = f"__serve_batcher_{fn.__name__}"

        @functools.wraps(fn)
        def method(self_or_item, *rest):
            # bound method: (self, item); free function: (item,)
            instance = self_or_item if rest else None
            item = rest[0] if rest else self_or_item
            if instance is not None:
                batcher = getattr(instance, key, None)
                if batcher is None:
                    batcher = _Batcher(fn, max_batch_size,
                                       batch_wait_timeout_s)
                    setattr(instance, key, batcher)
            else:
                batcher = getattr(method, "_batcher", None)
                if batcher is None:
                    batcher = _Batcher(fn, max_batch_size,
                                       batch_wait_timeout_s)
                    method._batcher = batcher
            return batcher.submit(instance, item)

        method._batch_params = (max_batch_size, batch_wait_timeout_s)
        return method

    if _fn is not None:
        return wrap(_fn)
    return wrap
