"""DataIterator: batched consumption of a set of block refs.

Reference: `python/ray/data/iterator.py:68,106` (`iter_batches`) and
`_internal/iterator/stream_split_iterator.py:32` (per-train-worker
splits). An iterator is picklable (block refs serialize), so train workers
can consume shards created by the driver.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch._private import fault_injection as _fi
from ray_tpu_torch.data.block import Block, BlockAccessor


def _maybe_stall() -> None:
    # chaos plane: an active `data_stall` window makes every block read
    # sleep it out (models an ingest-source brownout)
    p = _fi._PLAN
    if p is not None:
        p.data_read_sync()


class DataIterator:
    def __init__(self, block_refs: List[Any]):
        self._block_refs = block_refs

    def _iter_blocks(self, prefetch: int = 0) -> Iterator[Block]:
        if prefetch <= 0:
            for ref in self._block_refs:
                _maybe_stall()
                yield ray_tpu_torch.get(ref, timeout=600)
            return
        # Resolve up to `prefetch` blocks AHEAD of the consumer: the
        # fetch/deserialize of block i+1..i+P overlaps the caller's
        # compute on block i, so step wall-time approaches
        # max(fetch, compute) instead of their sum (reference
        # `iterator.py:109` prefetch_batches).
        from collections import deque

        window: deque = deque()
        refs = iter(self._block_refs)
        try:
            while True:
                while len(window) <= prefetch:
                    try:
                        window.append(next(refs).future())
                    except StopIteration:
                        break
                if not window:
                    return
                _maybe_stall()
                yield window.popleft().result(timeout=600)
        finally:
            for f in window:
                f.cancel()

    def iter_batches(
        self,
        *,
        batch_size: int = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        prefetch_batches: int = 1,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
        start_batch_index: int = 0,
    ) -> Iterator[Any]:
        """Yield dict-of-numpy (or pandas) batches of exactly batch_size
        (except possibly the last).

        `start_batch_index` resumes consumption mid-shard: the first
        `start_batch_index` batches (= `start_batch_index * batch_size`
        rows of the deterministic block stream) are skipped, so an
        elastic restore that persisted its read offset in the checkpoint
        continues exactly where the committed step left off — no batch
        duplicated, none skipped. Requires deterministic order
        (incompatible with local shuffle); exact only for iterators with
        a static block list (a `streaming_split` rebalances dynamically,
        so its offsets are best-effort counts, not content-stable)."""
        if start_batch_index < 0:
            raise ValueError("start_batch_index must be >= 0")
        if start_batch_index and local_shuffle_buffer_size:
            raise ValueError(
                "start_batch_index requires deterministic batch order; "
                "disable local_shuffle_buffer_size")
        skip_rows = start_batch_index * batch_size
        carry: Optional[Block] = None
        rng = (np.random.default_rng(local_shuffle_seed)
               if local_shuffle_buffer_size else None)

        def emit(block: Block):
            if batch_format == "pandas":
                return BlockAccessor(block).to_pandas()
            return block

        def shuffled_blocks() -> Iterator[Block]:
            """Block stream, optionally re-chunked through a local
            shuffle buffer (reference local_shuffle_buffer_size)."""
            buf: List[Block] = []
            buf_rows = 0
            for block in self._iter_blocks(prefetch=prefetch_batches):
                if not block or not BlockAccessor(block).num_rows():
                    continue
                if rng is None:
                    yield block
                    continue
                buf.append(block)
                buf_rows += BlockAccessor(block).num_rows()
                if buf_rows >= local_shuffle_buffer_size:
                    acc = BlockAccessor(BlockAccessor.concat(buf))
                    yield acc.take(rng.permutation(acc.num_rows()))
                    buf, buf_rows = [], 0
            if buf:
                acc = BlockAccessor(BlockAccessor.concat(buf))
                yield acc.take(rng.permutation(acc.num_rows()))

        for block in shuffled_blocks():
            if skip_rows:
                n_rows = BlockAccessor(block).num_rows()
                if skip_rows >= n_rows:
                    skip_rows -= n_rows
                    continue
                block = BlockAccessor(block).slice(skip_rows, n_rows)
                skip_rows = 0
            if carry is not None:
                block = BlockAccessor.concat([carry, block])
                carry = None
            acc = BlockAccessor(block)
            n = acc.num_rows()
            lo = 0
            while n - lo >= batch_size:
                yield emit(acc.slice(lo, lo + batch_size))
                lo += batch_size
            if lo < n:
                carry = acc.slice(lo, n)
        if carry is not None and not drop_last:
            if BlockAccessor(carry).num_rows():
                yield emit(carry)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for block in self._iter_blocks():
            yield from BlockAccessor(block).iter_rows()

    def materialize_numpy(self) -> Block:
        return BlockAccessor.concat(list(self._iter_blocks()))


class _SplitCoordinator:
    """Actor owning one streaming execution of a dataset plan, feeding N
    consumers (reference `stream_split_iterator.py:32`
    SplitCoordinator). Blocks are handed out PULL-BASED: whichever
    consumer asks first gets the next completed block, so a slow train
    worker naturally receives fewer blocks while fast ones stay fed —
    dynamic balancing with no static assignment. Execution runs in a
    background thread pushing into a bounded queue, so the first blocks
    are consumable while upstream stages still produce (and the bound
    backpressures the pipeline against slow consumers)."""

    def __init__(self, op):
        import queue
        import threading

        from ray_tpu_torch.data.executor import StreamingExecutor

        self._q: "queue.Queue" = queue.Queue(maxsize=16)
        self._error = None
        self._stopped = threading.Event()

        def run():
            try:
                for ref in StreamingExecutor().execute_iter(op):
                    while not self._stopped.is_set():
                        try:
                            self._q.put(ref, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if self._stopped.is_set():
                        return
            except BaseException as e:  # noqa: BLE001 — surfaced to consumers
                self._error = e
            finally:
                self._q.put(None)

        threading.Thread(target=run, daemon=True,
                         name="split-coordinator").start()

    def next_block(self):
        """Next completed block ref, or None when the stream ends."""
        item = self._q.get()
        if item is None:
            # poison-pill relay: wake every other blocked consumer
            self._q.put(None)
            if self._error is not None:
                raise self._error
            return None
        return item

    def stop(self):
        """Abandon the stream: the producer thread exits at its next
        put and remaining queued refs are dropped (consumers that
        stopped iterating early must call this via the iterator's
        `shutdown()` or the pipeline keeps producing into the queue)."""
        import queue

        self._stopped.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._q.put(None)
        return True


class StreamSplitDataIterator(DataIterator):
    """Per-train-worker view of a streaming split: pulls block refs from
    the shared coordinator on demand. Picklable (carries only the actor
    handle), so Train workers can consume a split created on the
    driver."""

    def __init__(self, coord):
        super().__init__([])
        self._coord = coord

    def shutdown(self):
        """Tear the SHARED coordinator down (all sibling split
        iterators stop receiving). Call when abandoning consumption
        early — e.g. between training epochs — so the coordinator's
        pipeline and actor don't linger for the session."""
        import ray_tpu_torch

        try:
            ray_tpu_torch.get(self._coord.stop.remote(), timeout=30)
        except Exception:  # noqa: BLE001 — best-effort teardown
            pass
        try:
            ray_tpu_torch.kill(self._coord)
        except Exception:  # noqa: BLE001
            pass

    def _iter_blocks(self, prefetch: int = 0) -> Iterator[Block]:
        from collections import deque

        # keep `prefetch`+1 next_block requests outstanding: the
        # coordinator round-trip AND the block fetch overlap consumer
        # compute
        pending: deque = deque()
        done = False
        while True:
            while not done and len(pending) <= max(0, prefetch):
                pending.append(self._coord.next_block.remote())
            if not pending:
                return
            _maybe_stall()
            ref = ray_tpu_torch.get(pending.popleft(), timeout=600)
            if ref is None:
                done = True
                continue
            yield ray_tpu_torch.get(ref, timeout=600)
