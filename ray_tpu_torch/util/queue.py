"""Distributed Queue backed by an async actor.

Reference: `python/ray/util/queue.py:20` — same surface
(put/get/put_nowait/get_nowait/size/empty/full), the queue state living
in one async actor so any worker can produce/consume. The port's copy
of `ray_tpu/util/queue.py`.
"""

from __future__ import annotations

from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        import asyncio

        self._q: "asyncio.Queue" = asyncio.Queue(maxsize)

    async def put(self, item, timeout: Optional[float] = None) -> bool:
        import asyncio

        try:
            if timeout is None:
                await self._q.put(item)
            else:
                await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def get(self, timeout: Optional[float] = None):
        import asyncio

        try:
            if timeout is None:
                return True, await self._q.get()
            return True, await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    def put_nowait(self, item) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except Exception:  # noqa: BLE001 — asyncio.QueueFull
            return False

    def get_nowait(self):
        try:
            return True, self._q.get_nowait()
        except Exception:  # noqa: BLE001 — asyncio.QueueEmpty
            return False, None

    def qsize(self) -> int:
        return self._q.qsize()


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: dict | None = None):
        cls = ray_tpu_torch.remote(_QueueActor)
        # a blocking get() parks one concurrency slot — the actor needs
        # headroom so puts (which unblock that get) can still run
        opts = {"max_concurrency": 16}
        opts.update(actor_options or {})
        self._actor = cls.options(**opts).remote(maxsize)

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None):
        if not block:
            if not ray_tpu_torch.get(self._actor.put_nowait.remote(item)):
                raise Full
            return
        if not ray_tpu_torch.get(self._actor.put.remote(item, timeout)):
            raise Full

    def get(self, block: bool = True,
            timeout: Optional[float] = None) -> Any:
        if not block:
            ok, item = ray_tpu_torch.get(self._actor.get_nowait.remote())
            if not ok:
                raise Empty
            return item
        ok, item = ray_tpu_torch.get(self._actor.get.remote(timeout))
        if not ok:
            raise Empty
        return item

    def put_nowait(self, item: Any):
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self._actor.qsize.remote())

    def size(self) -> int:
        return self.qsize()

    def empty(self) -> bool:
        return self.qsize() == 0

    def put_many(self, items: List[Any]):
        for item in items:
            self.put(item)

    def shutdown(self):
        ray_tpu_torch.kill(self._actor)
