"""Keyed-shard GCS table (reference: the sharded table storage under
`src/ray/gcs/` that spreads actor/task metadata over Redis shards).

`ShardedTable` is a drop-in `MutableMapping`: callers keep using plain
dict syntax while keys spread over N shards the way `shm_store` sharded
its object index (PR 3) — the point is not in-process lock contention
(the GCS is single-threaded asyncio) but (a) per-shard mutation counters
cheap enough to scrape per `/metrics` hit, exposing *which* slice of the
keyspace is hot, and (b) a stable `shard_index(key)` the GCS reuses to
route write-through persistence onto per-shard writer threads, so
concurrent registrations and event ingestion stop serializing on one
dict + one store thread.

A global insertion sequence is kept per key so recency survives
sharding: `iter_recent()` k-way-merges the shards newest-first (the
task-events table lists most-recent tasks first), and `popitem_oldest()`
evicts the globally oldest entry (the bounded task-events cap).
"""

from __future__ import annotations

import itertools
from collections import OrderedDict
from typing import Any, Iterator, List, MutableMapping, Tuple


def shard_index(key: Any, num_shards: int) -> int:
    """Stable key → shard routing (power-of-2 `num_shards`). Bytes keys
    (actor/task IDs are random) route on their first byte; anything else
    on `hash()` — stable within a process, which is all the persist-path
    routing needs (durable records are keyed by name, not by shard)."""
    if isinstance(key, (bytes, bytearray)) and key:
        return key[0] & (num_shards - 1)
    return hash(key) & (num_shards - 1)


class ShardedTable(MutableMapping):
    """Dict-compatible table split over `num_shards` keyed shards."""

    DEFAULT_SHARDS = 8

    def __init__(self, num_shards: int = DEFAULT_SHARDS, name: str = ""):
        if num_shards & (num_shards - 1):
            raise ValueError("num_shards must be a power of 2")
        self.name = name
        self.num_shards = num_shards
        self._shards: List["OrderedDict[Any, Any]"] = [
            OrderedDict() for _ in range(num_shards)]
        self._seqs: List["OrderedDict[Any, int]"] = [
            OrderedDict() for _ in range(num_shards)]
        self._seq = itertools.count(1)
        self._ops = [0] * num_shards  # per-shard mutation counters

    @classmethod
    def from_mapping(cls, mapping, num_shards: int = DEFAULT_SHARDS,
                     name: str = "") -> "ShardedTable":
        """Wrap a plain dict (store restore / pre-shard snapshot),
        preserving its insertion order as the recency order."""
        table = cls(num_shards, name)
        for key, value in mapping.items():
            table[key] = value
        return table

    def shard_of(self, key) -> int:
        return shard_index(key, self.num_shards)

    # -- MutableMapping ------------------------------------------------

    def __getitem__(self, key):
        return self._shards[self.shard_of(key)][key]

    def __setitem__(self, key, value):
        i = self.shard_of(key)
        shard = self._shards[i]
        if key not in shard:
            self._seqs[i][key] = next(self._seq)
        shard[key] = value
        self._ops[i] += 1

    def __delitem__(self, key):
        i = self.shard_of(key)
        del self._shards[i][key]
        del self._seqs[i][key]
        self._ops[i] += 1

    def __contains__(self, key):
        return key in self._shards[self.shard_of(key)]

    def __len__(self):
        return sum(len(s) for s in self._shards)

    def __iter__(self) -> Iterator:
        for shard in self._shards:
            yield from shard

    def __repr__(self):
        return (f"ShardedTable({self.name or 'unnamed'}, "
                f"shards={self.num_shards}, len={len(self)})")

    # -- recency (the task-events table's contract) --------------------

    def iter_recent(self) -> Iterator:
        """Values newest-first: k-way merge of the per-shard insertion
        sequences (each shard's OrderedDict is already seq-ascending)."""
        lanes = [
            [(seq, key, i) for key, seq in reversed(s.items())]
            for i, s in enumerate(self._seqs)]
        iters = [iter(lane) for lane in lanes if lane]
        heads = [next(it) for it in iters]
        while heads:
            j = max(range(len(heads)), key=lambda k: heads[k][0])
            _, key, i = heads[j]
            yield self._shards[i][key]
            nxt = next(iters[j], None)
            if nxt is None:
                del heads[j], iters[j]
            else:
                heads[j] = nxt

    def popitem_oldest(self) -> Tuple[Any, Any]:
        """Evict the entry with the globally smallest insertion seq."""
        candidates = [(next(iter(s.values())), i)
                      for i, s in enumerate(self._seqs) if s]
        if not candidates:
            raise KeyError("popitem_oldest(): table is empty")
        _, i = min(candidates)
        key, _ = self._seqs[i].popitem(last=False)
        value = self._shards[i].pop(key)
        self._ops[i] += 1
        return key, value

    # -- observability -------------------------------------------------

    def shard_sizes(self) -> List[int]:
        return [len(s) for s in self._shards]

    def shard_ops(self) -> List[int]:
        return list(self._ops)

    def metrics_text(self) -> str:
        name = self.name or "table"
        lines = ["# TYPE gcs_table_shard_size gauge"]
        for i, n in enumerate(self.shard_sizes()):
            lines.append(
                f'gcs_table_shard_size{{table="{name}",shard="{i}"}} {n}')
        lines.append("# TYPE gcs_table_shard_ops counter")
        for i, n in enumerate(self._ops):
            lines.append(
                f'gcs_table_shard_ops{{table="{name}",shard="{i}"}} {n}')
        return "\n".join(lines) + "\n"

    # -- pickling (GCS snapshot) ---------------------------------------

    def __reduce__(self):
        items = [(s, k, self._shards[i][k])
                 for i, seqs in enumerate(self._seqs)
                 for k, s in seqs.items()]
        items.sort()  # global seq order → recency survives the snapshot
        return (_rebuild, (self.num_shards, self.name,
                           [(k, v) for _, k, v in items]))


def _rebuild(num_shards: int, name: str,
             items: List[Tuple[Any, Any]]) -> ShardedTable:
    table = ShardedTable(num_shards, name)
    for key, value in items:
        table[key] = value
    return table
