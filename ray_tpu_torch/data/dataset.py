"""Dataset: the lazy, distributed dataset facade.

Reference: `python/ray/data/dataset.py:137` — transformations append
logical ops; execution happens at consumption (iteration, count, take,
write) through the streaming executor. `ExecutionPlan` here is simply the
logical-op chain plus a cached materialization
(reference `_internal/plan.py:37`).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import logical as L
from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.datasource import (
    write_block_csv,
    write_block_json,
    write_block_parquet,
    write_block_tfrecords,
)
from ray_tpu_torch.data.executor import StreamingExecutor, _count_rows
from ray_tpu_torch.data.iterator import DataIterator


class Dataset:
    def __init__(self, op: L.LogicalOp):
        self._op = op
        self._materialized: Optional[List[Any]] = None

    # -- plan building (lazy) ----------------------------------------------

    def _derive(self, op: L.LogicalOp) -> "Dataset":
        return Dataset(op)

    def map(self, fn: Callable[[Dict], Dict]) -> "Dataset":
        return self._derive(L.MapRows(self._op, fn))

    def map_batches(self, fn: Callable, *, batch_size: Optional[int] = None,
                    fn_args: tuple = (),
                    fn_kwargs: Optional[dict] = None,
                    compute: Optional["L.ActorPoolStrategy"] = None,
                    fn_constructor_args: tuple = (),
                    fn_constructor_kwargs: Optional[dict] = None,
                    ) -> "Dataset":
        """Batch transform. `fn` may be a callable class when
        `compute=ActorPoolStrategy(...)`: each pool actor instantiates it
        once (with `fn_constructor_args/kwargs`) and reuses it across
        blocks — warm stateful UDFs (reference
        `actor_pool_map_operator.py`)."""
        return self._derive(L.MapBatches(
            self._op, fn, batch_size, fn_args, fn_kwargs,
            compute=compute, fn_constructor_args=fn_constructor_args,
            fn_constructor_kwargs=fn_constructor_kwargs))

    def filter(self, fn: Callable[[Dict], bool]) -> "Dataset":
        return self._derive(L.Filter(self._op, fn))

    def flat_map(self, fn: Callable[[Dict], List[Dict]]) -> "Dataset":
        return self._derive(L.FlatMap(self._op, fn))

    def add_column(self, col: str, fn: Callable) -> "Dataset":
        return self._derive(L.AddColumn(self._op, col, fn))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        return self._derive(L.DropColumns(self._op, cols))

    def select_columns(self, cols: List[str]) -> "Dataset":
        return self._derive(L.SelectColumns(self._op, cols))

    def limit(self, n: int) -> "Dataset":
        return self._derive(L.Limit(self._op, n))

    def repartition(self, n: int) -> "Dataset":
        return self._derive(L.Repartition(self._op, n))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return self._derive(L.RandomShuffle(self._op, seed))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._derive(L.Sort(self._op, key, descending))

    def union(self, *others: "Dataset") -> "Dataset":
        return self._derive(L.Union([self._op] + [o._op for o in others]))

    def zip(self, other: "Dataset") -> "Dataset":
        return self._derive(L.Zip(self._op, other._op))

    def _global_agg(self, kind: str, on: Optional[str]):
        label = f"{kind}({on or ''})"
        rows = self.groupby(None)._agg([(kind, on, label)]).take_all()
        return rows[0][label] if rows else None

    def sum(self, on: str):
        """Scalar column sum (reference `Dataset.sum`)."""
        return self._global_agg("sum", on)

    def min(self, on: str):
        return self._global_agg("min", on)

    def max(self, on: str):
        return self._global_agg("max", on)

    def mean(self, on: str):
        return self._global_agg("mean", on)

    def std(self, on: str):
        return self._global_agg("std", on)

    def unique(self, column: str) -> List[Any]:
        """Distinct values of a column (reference `Dataset.unique`).
        Sorted when the values are orderable, else first-seen order."""
        out: Dict[Any, None] = {}
        for row in self.select_columns([column]).iter_rows():
            out.setdefault(row[column])
        try:
            return sorted(out)
        except TypeError:  # mixed / None values have no total order
            return list(out)

    def groupby(self, key: Optional[str]) -> "GroupedData":
        return GroupedData(self, key)

    # -- execution ---------------------------------------------------------

    def _execute(self) -> List[Any]:
        if self._materialized is None:
            self._materialized = StreamingExecutor().execute(self._op)
        return self._materialized

    def materialize(self) -> "Dataset":
        refs = self._execute()
        ds = Dataset(L.InputBlocks(refs))
        ds._materialized = refs
        return ds

    def num_blocks(self) -> int:
        return len(self._execute())

    def count(self) -> int:
        refs = self._execute()
        if not refs:
            return 0
        # fresh RemoteFunction per call: a cached one would hold a function
        # key from a previous cluster across shutdown()/init() cycles
        rf = ray_tpu_torch.remote(_count_rows)
        return int(sum(ray_tpu_torch.get([rf.remote(b) for b in refs],
                                   timeout=600)))

    def schema(self) -> Dict[str, str]:
        for block in DataIterator(self._execute())._iter_blocks():
            if BlockAccessor(block).num_rows():
                return BlockAccessor(block).schema()
        return {}

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for row in DataIterator(self._execute()).iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Dict[str, Any]]:
        return list(DataIterator(self._execute()).iter_rows())

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def to_pandas(self):
        return BlockAccessor(
            DataIterator(self._execute()).materialize_numpy()).to_pandas()

    def to_arrow(self):
        """Materialize as one pyarrow Table (reference
        `Dataset.to_arrow_refs` shape, collapsed to a local table)."""
        return BlockAccessor(
            DataIterator(self._execute()).materialize_numpy()).to_arrow()

    def to_numpy(self) -> Block:
        return DataIterator(self._execute()).materialize_numpy()

    # -- consumption -------------------------------------------------------

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        return DataIterator(self._execute()).iter_rows()

    def iter_batches(self, **kwargs) -> Iterator[Any]:
        return DataIterator(self._execute()).iter_batches(**kwargs)

    def iterator(self) -> DataIterator:
        return DataIterator(self._execute())

    def random_sample(self, fraction: float,
                      *, seed: Optional[int] = None) -> "Dataset":
        """Bernoulli row sample (reference `Dataset.random_sample`):
        every row gets an independent draw (duplicate rows sample
        independently). Deterministic per (seed, partitioning) — the
        per-block RNG mixes the block's position in the dataset with the
        seed, so identical-content blocks still draw independent masks."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1]: {fraction}")
        base = int(np.random.default_rng(seed).integers(0, 2 ** 31))

        def sample_block(batch: Dict[str, Any],
                         block_idx: int) -> Dict[str, Any]:
            n = len(next(iter(batch.values()))) if batch else 0
            if n == 0:
                return batch
            mask = np.random.default_rng(
                (base, block_idx)).random(n) < fraction
            return {k: np.asarray(v)[mask] for k, v in batch.items()}

        return self._derive(L.MapBatches(
            self._op, sample_block, None, with_block_index=True))

    def train_test_split(self, test_size: float, *,
                         shuffle: bool = False,
                         seed: Optional[int] = None
                         ) -> Tuple["Dataset", "Dataset"]:
        """(train, test) row split (reference `Dataset.train_test_split`:
        test gets the LAST `test_size` fraction of rows; pass
        shuffle=True to randomize first)."""
        if not 0.0 < test_size < 1.0:
            raise ValueError(
                f"test_size must be in (0, 1): {test_size}")
        ds = self.random_shuffle(seed=seed) if shuffle else self
        refs = ds._execute()
        ds = Dataset(L.InputBlocks(refs))
        ds._materialized = refs
        # one parallel count pass gives total + per-block sizes without
        # moving any block bytes to the driver
        rf_count = ray_tpu_torch.remote(_count_rows)
        counts = ray_tpu_torch.get([rf_count.remote(b) for b in refs],
                             timeout=600)
        total = int(sum(counts))
        n_test = int(total * test_size)
        train = ds.limit(total - n_test)
        # tail slice: skip the first total-n_test rows

        @ray_tpu_torch.remote
        def _tail(block, skip):
            acc = BlockAccessor(block)
            return acc.slice(min(skip, acc.num_rows()), acc.num_rows())

        out, seen = [], 0
        cut = total - n_test
        for b, rows in zip(refs, counts):
            if seen + rows <= cut:
                pass  # entirely train
            elif seen >= cut:
                out.append(b)  # entirely test
            else:
                out.append(_tail.remote(b, cut - seen))
            seen += rows
        test = Dataset(L.InputBlocks(out))
        test._materialized = out
        return train, test

    def split(self, n: int) -> List["Dataset"]:
        """Split into n datasets by round-robin over blocks (reference
        `Dataset.split`). Repartitions first if fewer blocks than splits."""
        refs = self._execute()
        if len(refs) < n:
            # repartition the materialized blocks, not the original plan —
            # re-running the upstream pipeline would double all its work
            refs = Dataset(L.InputBlocks(refs)).repartition(n)._execute()
        shards = [refs[i::n] for i in range(n)]
        out = []
        for s in shards:
            ds = Dataset(L.InputBlocks(s))
            ds._materialized = s
            out.append(ds)
        return out

    def streaming_split(self, n: int) -> List[DataIterator]:
        """Per-train-worker iterators over ONE shared streaming
        execution (reference `StreamSplitDataIterator`,
        `stream_split_iterator.py:32`): a coordinator actor runs the
        plan in the background and hands each completed block to
        whichever consumer asks first — dynamically balanced (a slow
        worker gets fewer blocks), with first-block latency set by the
        first task, not the whole pipeline."""
        from ray_tpu_torch.data.iterator import (_SplitCoordinator,
                                           StreamSplitDataIterator)

        if self._materialized is not None:
            op = L.InputBlocks(self._materialized)
        else:
            op = self._op
        coord_cls = ray_tpu_torch.remote(_SplitCoordinator)
        coord = coord_cls.options(num_cpus=0).remote(op)
        return [StreamSplitDataIterator(coord) for _ in range(n)]

    # -- writes ------------------------------------------------------------

    def _write(self, path: str, ext: str, write_fn) -> List[str]:
        os.makedirs(path, exist_ok=True)
        refs = self._execute()
        rf = ray_tpu_torch.remote(_make_writer(write_fn))
        outs = [os.path.join(path, f"part_{i:05d}.{ext}")
                for i in range(len(refs))]
        ray_tpu_torch.get([rf.remote(b, p) for b, p in zip(refs, outs)],
                    timeout=600)
        return outs

    def write_csv(self, path: str) -> List[str]:
        return self._write(path, "csv", write_block_csv)

    def write_json(self, path: str) -> List[str]:
        return self._write(path, "json", write_block_json)

    def write_parquet(self, path: str) -> List[str]:
        return self._write(path, "parquet", write_block_parquet)

    def write_tfrecords(self, path: str) -> List[str]:
        return self._write(path, "tfrecords", write_block_tfrecords)

    def write_webdataset(self, path: str) -> List[str]:
        from ray_tpu_torch.data.datasource import write_block_webdataset

        return self._write(path, "tar", write_block_webdataset)

    def __repr__(self) -> str:
        return f"Dataset(op={self._op.name})"


def _make_writer(write_fn):
    def write(block, path):
        write_fn(block, path)
        return path
    return write


class GroupedData:
    """Reference: `python/ray/data/grouped_data.py`."""

    def __init__(self, ds: Dataset, key: Optional[str]):
        self._ds = ds
        self._key = key

    def _agg(self, aggs: List[Tuple[str, Optional[str], str]]) -> Dataset:
        return self._ds._derive(
            L.GroupByAggregate(self._ds._op, self._key, aggs))

    def count(self) -> Dataset:
        return self._agg([("count", None, "count()")])

    def sum(self, on: str) -> Dataset:
        return self._agg([("sum", on, f"sum({on})")])

    def min(self, on: str) -> Dataset:
        return self._agg([("min", on, f"min({on})")])

    def max(self, on: str) -> Dataset:
        return self._agg([("max", on, f"max({on})")])

    def mean(self, on: str) -> Dataset:
        return self._agg([("mean", on, f"mean({on})")])

    def std(self, on: str) -> Dataset:
        return self._agg([("std", on, f"std({on})")])

    def aggregate(self, *aggs: Tuple[str, Optional[str], str]) -> Dataset:
        return self._agg(list(aggs))
