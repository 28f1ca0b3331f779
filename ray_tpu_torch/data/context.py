"""Global data-execution tunables (reference:
`python/ray/data/context.py:141` DataContext)."""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional


@dataclasses.dataclass
class DataContext:
    target_max_block_size: int = 128 * 1024 * 1024
    target_min_block_size: int = 1 * 1024 * 1024
    # explicit concurrency cap for the streaming executor; None (default)
    # derives the in-flight window from cluster CPU count, and submission
    # additionally stalls while the object store is above
    # `store_backpressure_fraction` (reference ResourceManager budgets +
    # ConcurrencyCapBackpressurePolicy)
    max_concurrent_tasks: Optional[int] = None
    store_backpressure_fraction: float = 0.8
    default_batch_size: int = 1024
    read_parallelism: int = 8
    shuffle_partitions: Optional[int] = None
    # push-based shuffle (reference DataContext.use_push_based_shuffle /
    # the magnet-style pipelined shuffle): mappers' partials are merged
    # incrementally in rounds of `shuffle_merge_factor` blocks, so
    # reducer fan-in (and peak arg memory) is bounded by the merge
    # factor instead of the input block count. Engages automatically
    # when an exchange has more inputs than the merge factor.
    use_push_based_shuffle: bool = True
    shuffle_merge_factor: int = 8
    eager_free: bool = True
    # trace of the most recent actor-pool map stage's autoscaling
    # decisions ({"peak", "grows", "shrinks"}), written by the executor
    last_actor_pool_stats: Optional[dict] = None

    _instance = None
    _lock = threading.Lock()

    @classmethod
    def get_current(cls) -> "DataContext":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance
