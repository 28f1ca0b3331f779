"""multiprocessing.Pool API over ray_tpu_torch actors.

Reference: `python/ray/util/multiprocessing/pool.py` — a drop-in
`Pool` whose workers are actors, so `pool.map` scales past one machine
and mixes with the rest of the cluster. Covers the surface real code
uses: map/starmap/apply + their async variants, imap/imap_unordered,
context-manager close/join/terminate. The port's copy of
`ray_tpu/util/multiprocessing.py`.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch

_POOL_DEFAULT_CHUNK_TARGET = 4  # chunks per worker, like stdlib


@ray_tpu_torch.remote
class _PoolWorker:
    def __init__(self, init, args):
        if init is not None:
            init(*args)

    def run_chunk(self, fn, chunk, star):
        if star:
            return [fn(*item) for item in chunk]
        return [fn(item) for item in chunk]

    def run_one(self, fn, args, kwargs):
        return fn(*args, **(kwargs or {}))


class AsyncResult:
    """stdlib-compatible handle over a list of ObjectRefs."""

    def __init__(self, refs: List[Any], single: bool = False):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        chunks = ray_tpu_torch.get(self._refs, timeout=timeout)
        if self._single:
            return chunks[0]
        return [item for chunk in chunks for item in chunk]

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                     timeout=timeout)

    def ready(self) -> bool:
        done, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                               timeout=0)
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("still running")  # stdlib contract
        try:
            self.get(timeout=0)
            return True
        except Exception:  # noqa: BLE001 — stdlib contract
            return False


class Pool:
    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = ()):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        if processes is None:
            import os

            processes = max(1, int(
                ray_tpu_torch.cluster_resources().get("CPU",
                                                os.cpu_count() or 1)))
        self._size = processes
        self._workers = [_PoolWorker.remote(initializer, initargs)
                         for _ in range(processes)]
        self._rr = itertools.cycle(range(processes))
        self._closed = False

    # -- internals ---------------------------------------------------------

    def _check(self):
        if self._closed:
            raise ValueError("Pool not running")

    def _chunks(self, iterable: Iterable, chunksize: Optional[int]):
        items = list(iterable)
        if chunksize is None:
            chunksize = max(
                1, len(items) // (self._size *
                                  _POOL_DEFAULT_CHUNK_TARGET) or 1)
        return [items[i:i + chunksize]
                for i in range(0, len(items), chunksize)]

    def _submit_chunks(self, fn, chunks, star: bool) -> List[Any]:
        return [
            self._workers[next(self._rr)].run_chunk.remote(fn, c, star)
            for c in chunks
        ]

    # -- the stdlib surface ------------------------------------------------

    def apply(self, fn, args: tuple = (), kwds: dict = None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn, args: tuple = (), kwds: dict = None
                    ) -> AsyncResult:
        self._check()
        ref = self._workers[next(self._rr)].run_one.remote(
            fn, args, kwds)
        return AsyncResult([ref], single=True)

    def map(self, fn, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn, iterable: Iterable,
                  chunksize: Optional[int] = None) -> AsyncResult:
        self._check()
        return AsyncResult(self._submit_chunks(
            fn, self._chunks(iterable, chunksize), star=False))

    def starmap(self, fn, iterable: Iterable,
                chunksize: Optional[int] = None) -> List[Any]:
        return self.starmap_async(fn, iterable, chunksize).get()

    def starmap_async(self, fn, iterable: Iterable,
                      chunksize: Optional[int] = None) -> AsyncResult:
        self._check()
        return AsyncResult(self._submit_chunks(
            fn, self._chunks(iterable, chunksize), star=True))

    def imap(self, fn, iterable: Iterable,
             chunksize: Optional[int] = None):
        """Results in order, yielded as chunks complete."""
        self._check()
        for ref in self._submit_chunks(
                fn, self._chunks(iterable, chunksize), star=False):
            for item in ray_tpu_torch.get(ref):
                yield item

    def imap_unordered(self, fn, iterable: Iterable,
                       chunksize: Optional[int] = None):
        """Results as they finish, regardless of submission order."""
        self._check()
        pending = self._submit_chunks(
            fn, self._chunks(iterable, chunksize), star=False)
        while pending:
            done, pending = ray_tpu_torch.wait(pending, num_returns=1)
            for item in ray_tpu_torch.get(done[0]):
                yield item

    # -- lifecycle ---------------------------------------------------------

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True
        for w in self._workers:
            ray_tpu_torch.kill(w)
        self._workers = []

    def join(self):
        if not self._closed:
            raise ValueError("Pool is still running")
        # actor mailboxes drain in order: a ping returning means every
        # earlier submission on that worker has finished
        if self._workers:
            # stdlib join blocks until outstanding work completes —
            # no deadline, however slow the queued chunks are
            ray_tpu_torch.get([w.run_one.remote(lambda: None, (), None)
                         for w in self._workers], timeout=None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
