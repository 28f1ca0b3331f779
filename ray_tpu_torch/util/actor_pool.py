"""ActorPool: multiplex work over a fixed set of actors.

Reference: `python/ray/util/actor_pool.py:13` — same surface
(submit/get_next/get_next_unordered/map/map_unordered/has_next), rebuilt
on this framework's futures. The port's copy of
`ray_tpu/util/actor_pool.py`.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._idle: List[Any] = list(actors)
        self._future_to_actor: dict = {}
        self._index_to_future: dict = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits: List[tuple] = []

    def submit(self, fn: Callable[[Any, Any], Any], value: Any):
        """fn(actor, value) -> ObjectRef; queued until an actor frees."""
        if self._idle:
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._future_to_actor[ref] = actor
            self._index_to_future[self._next_task_index] = ref
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._index_to_future) or bool(self._pending_submits)

    def get_next(self, timeout: float | None = None) -> Any:
        """Next result in submission order. A timeout leaves the pool
        state untouched (the result stays claimable; the actor stays
        busy) — reference semantics."""
        if self._next_return_index not in self._index_to_future:
            raise StopIteration("no pending results")
        ref = self._index_to_future[self._next_return_index]
        if timeout is not None:
            ready, _ = ray_tpu_torch.wait([ref], num_returns=1,
                                    timeout=timeout)
            if not ready:
                raise TimeoutError("no result within timeout")
        del self._index_to_future[self._next_return_index]
        self._next_return_index += 1
        try:
            return ray_tpu_torch.get(ref)
        finally:
            self._return_actor(self._future_to_actor.pop(ref))

    def get_next_unordered(self, timeout: float | None = None) -> Any:
        """Whichever pending result finishes first. Timeout is
        state-preserving, as above."""
        if not self._index_to_future:
            raise StopIteration("no pending results")
        refs = list(self._index_to_future.values())
        ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        ref = ready[0]
        for idx, fut in list(self._index_to_future.items()):
            if fut == ref:
                del self._index_to_future[idx]
                break
        try:
            return ray_tpu_torch.get(ref)
        finally:
            self._return_actor(self._future_to_actor.pop(ref))

    def _return_actor(self, actor):
        if self._pending_submits:
            fn, value = self._pending_submits.pop(0)
            ref = fn(actor, value)
            self._future_to_actor[ref] = actor
            self._index_to_future[self._next_task_index] = ref
            self._next_task_index += 1
        else:
            self._idle.append(actor)

    def map(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def pop_idle(self):
        return self._idle.pop() if self._idle else None

    def push(self, actor):
        self._return_actor(actor)
