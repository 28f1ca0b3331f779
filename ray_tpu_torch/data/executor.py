"""Streaming plan executor.

Reference: `python/ray/data/_internal/execution/streaming_executor.py:48` +
`streaming_executor_state.py:165` (pull-based OpState loop with
backpressure) and `_internal/planner/exchange/` (shuffle/sort exchanges).

Execution here is ray_tpu_torch tasks over block refs with a bounded in-flight
window per stage (the ConcurrencyCap backpressure policy); all-to-all ops
(repartition/shuffle/sort/groupby) are two-stage map/reduce exchanges like
the reference's push-based shuffle.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import logical as L
from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.context import DataContext


# ---------------------------------------------------------------------------
# remote task bodies (module-level so they pickle by reference-by-value once)
# ---------------------------------------------------------------------------


def _run_read(read_task) -> Block:
    return read_task()


def _run_transform(transform, block: Block, idx: int = 0) -> Block:
    return transform(block, idx)


def _run_read_fused(read_task, transforms, idx: int) -> Block:
    """Read + fused map chain in ONE task: the intermediate blocks stay
    in this process (zero copies, no store round-trip)."""
    block = read_task()
    for t in transforms:
        block = t(block, idx)
    return block


def _count_rows(block: Block) -> int:
    return BlockAccessor(block).num_rows()


def _slice_block(block: Block, start: int, end: int) -> Block:
    return BlockAccessor(block).slice(start, end)


def _split_for_partition(block: Block, assign_fn, p: int) -> List[Block]:
    """Map side of an exchange: split one block into p partition pieces."""
    acc = BlockAccessor(block)
    n = acc.num_rows()
    if n == 0:
        return [dict() for _ in range(p)]
    assignment = assign_fn(acc)
    return [acc.take(np.nonzero(assignment == i)[0]) for i in range(p)]


def _reduce_concat(*parts: Block) -> Block:
    return BlockAccessor.concat(list(parts))


# merge stage of the push-based exchange: folding a round's partition
# pieces (plus the running merged block) IS a concat
_merge_partials = _reduce_concat


def _reduce_shuffle(seed: Optional[int], part_idx: int = 0,
                    *parts: Block) -> Block:
    block = BlockAccessor.concat(list(parts))
    acc = BlockAccessor(block)
    n = acc.num_rows()
    if n == 0:
        return block
    rng = np.random.default_rng(None if seed is None else seed + part_idx)
    return acc.take(rng.permutation(n))


def _reduce_sort(key: str, descending: bool, *parts: Block) -> Block:
    block = BlockAccessor.concat(list(parts))
    acc = BlockAccessor(block)
    if acc.num_rows() == 0:
        return block
    order = np.argsort(block[key], kind="stable")
    if descending:
        order = order[::-1]
    return acc.take(order)


def _sample_block(block: Block, key: str, k: int) -> np.ndarray:
    acc = BlockAccessor(block)
    n = acc.num_rows()
    if n == 0:
        return np.asarray([])
    idx = np.random.default_rng(0).choice(n, size=min(k, n), replace=False)
    return np.asarray(block[key])[idx]


_AGG_FNS = {
    "count": lambda v: len(v),
    "sum": lambda v: np.sum(v),
    "min": lambda v: np.min(v),
    "max": lambda v: np.max(v),
    "mean": lambda v: np.mean(v),
    "std": lambda v: np.std(v),
}


def _reduce_groupby(key: Optional[str], aggs, *parts: Block) -> Block:
    block = BlockAccessor.concat(list(parts))
    acc = BlockAccessor(block)
    if acc.num_rows() == 0:
        return {}
    if key is None:
        row: Dict[str, Any] = {}
        for agg_name, on, out_name in aggs:
            vals = block[on] if on else next(iter(block.values()))
            row[out_name] = _AGG_FNS[agg_name](vals)
        return BlockAccessor.from_rows([row])
    keys = block[key]
    uniq = np.unique(keys)
    rows = []
    for kv in uniq:
        mask = keys == kv
        row = {key: kv}
        for agg_name, on, out_name in aggs:
            vals = (block[on] if on else keys)[mask]
            row[out_name] = _AGG_FNS[agg_name](vals)
        rows.append(row)
    return BlockAccessor.from_rows(rows)


def _zip_blocks(left: Block, right: Block) -> Block:
    nl = BlockAccessor(left).num_rows()
    nr = BlockAccessor(right).num_rows()
    if nl != nr:
        raise ValueError(
            f"zip requires equal rows per paired block ({nl} vs {nr}); "
            "repartition both datasets to aligned blocks first")
    out = dict(left)
    for k, v in right.items():
        out[k if k not in out else f"{k}_1"] = v
    return out


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------


class _RemoteCache:
    """Lazily-created RemoteFunction wrappers (one GCS function push each)."""

    def __init__(self):
        self._cache: Dict[Tuple[Callable, int], Any] = {}

    def get(self, fn: Callable, num_returns: int = 1):
        key = (fn, num_returns)
        if key not in self._cache:
            rf = ray_tpu_torch.remote(fn)
            if num_returns != 1:
                rf = rf.options(num_returns=num_returns)
            self._cache[key] = rf
        return self._cache[key]


class _MapWorker:
    """Pool actor hosting one warm UDF instance (reference
    `_internal/execution/operators/actor_pool_map_operator.py` _MapWorker).
    The transform factory runs in __init__, so a class UDF's state
    (tokenizer, decoder, model) is built once and reused per block."""

    def __init__(self, transform_factory):
        self._transform = transform_factory()

    def ready(self) -> bool:
        return True

    def apply(self, block: Block, idx: int) -> Block:
        return self._transform(block, idx)


class _ResourceBudget:
    """Admission budget for task submission (reference
    `_internal/execution/resource_manager.py:29` ResourceManager +
    backpressure policies): the in-flight task window is derived from the
    cluster's CPU count instead of a fixed constant, and submission
    additionally stalls while the local object store is above an
    occupancy threshold (completed-but-unconsumed blocks are filling it —
    producing more would only force spilling). At least one task may
    always run, so progress is guaranteed and consumption drains the
    store."""

    def __init__(self, ctx: DataContext):
        self.ctx = ctx
        self._cap: Optional[int] = None
        self._occ_checked = 0.0
        self._occ_high = False

    def task_cap(self) -> int:
        if self._cap is None:
            if self.ctx.max_concurrent_tasks is not None:
                # explicit user cap wins (and is the test knob)
                self._cap = max(1, self.ctx.max_concurrent_tasks)
            else:
                try:
                    cpus = ray_tpu_torch.cluster_resources().get("CPU", 1.0)
                except Exception:
                    cpus = 1.0
                # modest oversubscription hides push/reply latency
                self._cap = max(2, int(cpus * 1.5))
        return self._cap

    def store_pressure(self) -> bool:
        """True when the local shm arena is above the high-water mark.
        Rechecked at most every 0.25s (a stats() syscall per wait tick is
        wasteful)."""
        import time as _time
        now = _time.monotonic()
        if now - self._occ_checked < 0.25:
            return self._occ_high
        self._occ_checked = now
        self._occ_high = False
        try:
            from ray_tpu_torch._private.object_ref import get_core_worker
            cw = get_core_worker()
            if cw is not None and cw.store is not None:
                st = cw.store.stats()
                if st["capacity"]:
                    # referenced (unevictable) bytes, not allocated: the
                    # arena may be full of evictable garbage a create
                    # would reclaim — stalling on that is a false stall
                    used = st.get("referenced", st["allocated"])
                    frac = used / st["capacity"]
                    self._occ_high = \
                        frac > self.ctx.store_backpressure_fraction
        except Exception:
            pass
        return self._occ_high


class StreamingExecutor:
    def __init__(self, ctx: Optional[DataContext] = None):
        self.ctx = ctx or DataContext.get_current()
        self._remote = _RemoteCache()
        self._budget = _ResourceBudget(self.ctx)

    # -- budgeted-window submission (the backpressure policy) --------------

    def _windowed(self, submit_fns: List[Callable[[], Any]]) -> List[Any]:
        budget = self._budget
        cap = budget.task_cap()
        out: List[Any] = [None] * len(submit_fns)
        in_flight: Dict[Any, int] = {}
        next_i = 0
        while next_i < len(submit_fns) or in_flight:
            while next_i < len(submit_fns) and len(in_flight) < cap:
                if in_flight and budget.store_pressure():
                    break  # drain before producing more blocks
                ref = submit_fns[next_i]()
                out[next_i] = ref
                # multi-return tasks yield a list; any one ref tracks
                # task completion for the backpressure window
                in_flight[ref[0] if isinstance(ref, list) else ref] = next_i
                next_i += 1
            if in_flight:
                ready, _ = ray_tpu_torch.wait(list(in_flight), num_returns=1,
                                        timeout=30.0)
                for r in ready:
                    in_flight.pop(r, None)
        return out

    def _windowed_iter(self, fns) -> "Iterator[Any]":
        """Generator flavor of _windowed: pull submit thunks LAZILY from
        `fns` and yield each block ref as its task COMPLETES (completion
        order). Lazy pull means backpressure propagates up a chain of
        streaming stages; completion-order yield is what lets a split
        coordinator hand finished blocks to whichever consumer is
        hungriest (reference StreamingExecutor's pull-based loop,
        `streaming_executor_state.py:165`)."""
        budget = self._budget
        cap = budget.task_cap()
        fns = iter(fns)
        in_flight: Dict[Any, Any] = {}  # wait_ref -> yield_ref
        exhausted = False
        while not exhausted or in_flight:
            while not exhausted and len(in_flight) < cap:
                if in_flight and budget.store_pressure():
                    break
                try:
                    ref = next(fns)()
                except StopIteration:
                    exhausted = True
                    break
                in_flight[ref[0] if isinstance(ref, list) else ref] = ref
            if in_flight:
                ready, _ = ray_tpu_torch.wait(list(in_flight), num_returns=1,
                                        timeout=30.0)
                for r in ready:
                    yield in_flight.pop(r)

    # -- plan walk ---------------------------------------------------------

    def execute(self, op: L.LogicalOp) -> List[Any]:
        """Returns the output block refs of the (optimized) plan."""
        op = L.optimize(op)
        return self._exec(op)

    def execute_iter(self, op: L.LogicalOp) -> "Iterator[Any]":
        """Streaming execution: yield output block refs as their tasks
        complete, while upstream stages keep producing — first blocks
        are consumable long before the pipeline finishes (the
        train-ingest hot path; reference `stream_split_iterator.py:32`).
        Barrier ops (shuffle/sort/groupby/...) and actor-pool stages
        fall back to full materialization of their subtree."""
        op = L.optimize(op)
        yield from self._iter(op)

    def _iter(self, op: L.LogicalOp) -> "Iterator[Any]":
        if isinstance(op, L.Read) and op.limit_rows is None:
            tasks = op.datasource.get_read_tasks(op.parallelism)
            rf = self._remote.get(_run_read)
            yield from self._windowed_iter(
                (lambda t=t: rf.remote(t)) for t in tasks)
        elif isinstance(op, L.FusedRead):
            tasks = op.datasource.get_read_tasks(op.parallelism)
            rf = self._remote.get(_run_read_fused)
            transforms = op.transforms
            yield from self._windowed_iter(
                (lambda t=t, i=i: rf.remote(t, transforms, i))
                for i, t in enumerate(tasks))
        elif isinstance(op, L.AbstractMap) and op.compute is None:
            transform = op.make_transform()
            rf = self._remote.get(_run_transform)
            upstream = self._iter(op.input_op)
            yield from self._windowed_iter(
                (lambda b=b, i=i: rf.remote(transform, b, i))
                for i, b in enumerate(upstream))
        else:
            yield from self._exec(op)

    def _exec(self, op: L.LogicalOp) -> List[Any]:
        if isinstance(op, L.InputBlocks):
            return list(op.block_refs)
        if isinstance(op, L.Read):
            if op.limit_rows is not None:
                return self._exec_read_limited(op)
            tasks = op.datasource.get_read_tasks(op.parallelism)
            rf = self._remote.get(_run_read)
            return self._windowed([
                (lambda t=t: rf.remote(t)) for t in tasks])
        if isinstance(op, L.FusedRead):
            tasks = op.datasource.get_read_tasks(op.parallelism)
            rf = self._remote.get(_run_read_fused)
            transforms = op.transforms
            return self._windowed([
                (lambda t=t, i=i: rf.remote(t, transforms, i))
                for i, t in enumerate(tasks)])
        if isinstance(op, L.AbstractMap):
            inputs = self._exec(op.input_op)
            if op.compute is not None:
                return self._exec_actor_map(op, inputs)
            transform = op.make_transform()
            rf = self._remote.get(_run_transform)
            return self._windowed([
                (lambda b=b, i=i: rf.remote(transform, b, i))
                for i, b in enumerate(inputs)])
        if isinstance(op, L.Limit):
            return self._exec_limit(op)
        if isinstance(op, L.Repartition):
            inputs = self._exec(op.input_op)
            return self._exchange(
                inputs, op.n, _round_robin_assigner(op.n), _reduce_concat)
        if isinstance(op, L.RandomShuffle):
            inputs = self._exec(op.input_op)
            p = self.ctx.shuffle_partitions or max(1, len(inputs))
            seed = op.seed
            return self._exchange(
                inputs, p, _random_assigner(p, seed),
                _reduce_shuffle, extra_args=lambda i: (seed, i))
        if isinstance(op, L.Sort):
            return self._exec_sort(op)
        if isinstance(op, L.GroupByAggregate):
            return self._exec_groupby(op)
        if isinstance(op, L.Union):
            out: List[Any] = []
            for child in op.inputs:
                out.extend(self._exec(child))
            return out
        if isinstance(op, L.Zip):
            left = self._exec(op.left)
            right = self._exec(op.right)
            if len(left) != len(right):
                raise ValueError(
                    f"zip requires equal block counts ({len(left)} vs "
                    f"{len(right)}); repartition first")
            rf = self._remote.get(_zip_blocks)
            return self._windowed([
                (lambda l=l, r=r: rf.remote(l, r))
                for l, r in zip(left, right)])
        raise TypeError(f"unknown logical op {op!r}")

    # -- actor-compute map stage -------------------------------------------

    def _exec_actor_map(self, op: L.AbstractMap,
                        inputs: List[Any]) -> List[Any]:
        """Run one map stage on a pool of warm UDF actors with autoscaling
        (reference `actor_pool_map_operator.py` + `_ActorPool`): blocks go
        to the least-loaded actor, each actor runs at most
        `max_tasks_in_flight_per_actor` blocks, and while there is a
        backlog with every actor saturated the pool grows up to
        `max_size`. The pool is torn down when the stage drains."""
        if not inputs:
            return []
        strategy = op.compute
        factory = op.make_transform_factory()
        actor_cls = ray_tpu_torch.remote(_MapWorker)
        min_size = strategy.min_size
        max_size = strategy.max_size or min_size
        per_actor = max(1, strategy.max_tasks_in_flight_per_actor)
        budget = self._budget

        actors: List[Any] = []
        out: List[Any] = [None] * len(inputs)
        load: Dict[int, int] = {}
        ref_actor: Dict[Any, int] = {}
        next_i = 0
        # autoscaling trace, observable via the DataContext singleton
        # (the GCS-side ALIVE view lags worker spawn latency)
        stats = {"peak": 0, "grows": 0, "shrinks": 0}
        self.ctx.last_actor_pool_stats = stats
        killed: set = set()
        try:
            actors.extend(actor_cls.remote(factory)
                          for _ in range(min(min_size, len(inputs))))
            load.update({j: 0 for j in range(len(actors))})
            stats["peak"] = len(load)
            # block until at least one worker built its UDF state — a
            # broken constructor should fail the stage here, not
            # per-block (and the finally reaps the spawned pool)
            ray_tpu_torch.get(actors[0].ready.remote(), timeout=300)
            while next_i < len(inputs) or ref_actor:
                while next_i < len(inputs):
                    if ref_actor and budget.store_pressure():
                        break  # drain output blocks before producing more
                    j = min(load, key=load.get)
                    if load[j] >= per_actor:
                        if len(actors) < max_size:
                            # backlog with every actor saturated: scale up
                            actors.append(actor_cls.remote(factory))
                            load[len(actors) - 1] = 0
                            stats["grows"] += 1
                            stats["peak"] = max(stats["peak"], len(load))
                            continue
                        break
                    ref = actors[j].apply.remote(inputs[next_i], next_i)
                    out[next_i] = ref
                    ref_actor[ref] = j
                    load[j] += 1
                    next_i += 1
                if ref_actor:
                    ready, _ = ray_tpu_torch.wait(list(ref_actor),
                                            num_returns=1, timeout=30.0)
                    for r in ready:
                        j = ref_actor.pop(r, None)
                        if j is not None:
                            load[j] -= 1
                # scale down: an idle actor whose capacity the remaining
                # backlog no longer needs is released immediately
                # (reference `default_autoscaler.py` downscaling)
                remaining = (len(inputs) - next_i) + len(ref_actor)
                while len(load) > min_size:
                    idle = [j for j, n in load.items() if n == 0]
                    if not idle or remaining > (len(load) - 1) * per_actor:
                        break
                    # reap the NEWEST idle actor: it is the least warm,
                    # and on slow-spawning hosts may not even have
                    # scheduled yet — killing the oldest would discard a
                    # warm UDF while keeping a cold one
                    j = max(idle)
                    load.pop(j)
                    killed.add(j)
                    stats["shrinks"] += 1
                    try:
                        ray_tpu_torch.kill(actors[j])
                    except Exception:
                        pass
        finally:
            # every spawned actor dies here, including ones spawned
            # before `load` was populated (a failed spawn loop must not
            # leak the warm UDF actors already created)
            for j, a in enumerate(actors):
                if j in killed:
                    continue
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass
        return out

    # -- all-to-all exchange (map: split into p, reduce: combine) ----------

    def _exchange(self, inputs: List[Any], p: int, assign_fn,
                  reduce_fn, extra_args=lambda i: ()) -> List[Any]:
        """Two-stage exchange. `reduce_fn(*extra_args(i), *parts)` combines
        partition i; one cached RemoteFunction serves all partitions."""
        if not inputs:
            return []
        rf = self._remote.get(reduce_fn)
        if p == 1:
            # degenerate exchange: one reduce over all input blocks
            return [rf.remote(*extra_args(0), *inputs)]
        if (self.ctx.use_push_based_shuffle
                and len(inputs) > self.ctx.shuffle_merge_factor):
            return self._exchange_push(inputs, p, assign_fn, reduce_fn,
                                       rf, extra_args)
        split_rf = self._remote.get(_split_for_partition, num_returns=p)
        cols = self._windowed([
            (lambda b=b: split_rf.remote(b, assign_fn, p)) for b in inputs])
        submit = []
        for i in range(p):
            parts_i = [cols[j][i] for j in range(len(inputs))]
            submit.append(lambda i=i, parts=parts_i:
                          rf.remote(*extra_args(i), *parts))
        return self._windowed(submit)

    def _exchange_push(self, inputs: List[Any], p: int, assign_fn,
                       reduce_fn, reduce_rf, extra_args) -> List[Any]:
        """Push-based (pipelined-merge) exchange.

        Reference: the push-based shuffle behind
        `DataContext.use_push_based_shuffle` (`python/ray/data/
        _internal/planner/exchange/push_based_shuffle_task_scheduler.py`)
        — instead of every reducer consuming one partial from EVERY map
        task (fan-in = num input blocks, all partials alive at once),
        map tasks run in rounds of `shuffle_merge_factor` and each
        round's partials are merged into a running per-partition block.
        Fan-in of any task is bounded by the merge factor + 1, partials
        die after their round's merge, and merging for round r overlaps
        the split tasks of round r+1 through the windowed submitter.
        """
        k = self.ctx.shuffle_merge_factor
        split_rf = self._remote.get(_split_for_partition, num_returns=p)
        merge_rf = self._remote.get(_merge_partials)
        merged: List[Any] = [None] * p
        for start in range(0, len(inputs), k):
            round_blocks = inputs[start:start + k]
            cols = self._windowed([
                (lambda b=b: split_rf.remote(b, assign_fn, p))
                for b in round_blocks])
            submit = []
            for i in range(p):
                parts = [cols[j][i] for j in range(len(round_blocks))]
                if merged[i] is not None:
                    parts = [merged[i]] + parts
                submit.append(lambda parts=parts: merge_rf.remote(*parts))
            merged = self._windowed(submit)
        if reduce_fn is _reduce_concat:
            # the merged blocks already ARE the concatenated partitions —
            # a final concat-of-one reduce would just re-copy everything
            return merged
        return self._windowed([
            (lambda i=i: reduce_rf.remote(*extra_args(i), merged[i]))
            for i in range(p)])

    def _exec_read_limited(self, op: L.Read) -> List[Any]:
        """Limit-pushdown read (reference `set_read_parallelism` /
        `limit_pushdown.py`): launch read tasks in small waves and STOP
        once enough rows exist — a `.limit(n)` over a big datasource
        must not fan out the whole read."""
        tasks = op.datasource.get_read_tasks(op.parallelism)
        rf = self._remote.get(_run_read)
        rf_count = self._remote.get(_count_rows)
        out: List[Any] = []
        rows = 0
        i = 0
        window = max(1, min(4, self._budget.task_cap()))
        in_flight: List[tuple] = []  # (block_ref, count_ref)
        while rows < op.limit_rows and (i < len(tasks) or in_flight):
            while i < len(tasks) and len(in_flight) < window:
                b = rf.remote(tasks[i])
                in_flight.append((b, rf_count.remote(b)))
                i += 1
            b, c = in_flight.pop(0)
            rows += ray_tpu_torch.get(c, timeout=300)
            out.append(b)
        return out

    def _exec_limit(self, op: L.Limit) -> List[Any]:
        inputs = self._exec(op.input_op)
        rf_count = self._remote.get(_count_rows)
        rf_slice = self._remote.get(_slice_block)
        out: List[Any] = []
        remaining = op.n
        for b in inputs:
            if remaining <= 0:
                break
            n = ray_tpu_torch.get(rf_count.remote(b), timeout=120)
            if n <= remaining:
                out.append(b)
                remaining -= n
            else:
                out.append(rf_slice.remote(b, 0, remaining))
                remaining = 0
        return out

    def _exec_sort(self, op: L.Sort) -> List[Any]:
        inputs = self._exec(op.input_op)
        if not inputs:
            return []
        p = max(1, len(inputs))
        key = op.key
        rf_sample = self._remote.get(_sample_block)
        samples = ray_tpu_torch.get(
            [rf_sample.remote(b, key, 16) for b in inputs], timeout=300)
        allv = np.concatenate([s for s in samples if len(s)]) \
            if any(len(s) for s in samples) else np.asarray([0])
        qs = np.linspace(0, 100, p + 1)[1:-1]
        bounds = np.percentile(allv, qs) if len(qs) else np.asarray([])
        descending = op.descending
        refs = self._exchange(
            inputs, p, _range_assigner(key, bounds),
            _reduce_sort, extra_args=lambda i: (key, descending))
        # partitions ascend by range; for descending output reverse them
        return list(reversed(refs)) if descending else refs

    def _exec_groupby(self, op: L.GroupByAggregate) -> List[Any]:
        inputs = self._exec(op.input_op)
        if not inputs:
            return []
        key, aggs = op.key, op.aggs
        if key is None:
            rf = self._remote.get(_reduce_groupby)
            return [rf.remote(None, aggs, *inputs)]
        p = min(len(inputs), 8)
        return self._exchange(
            inputs, p, _hash_assigner(key, p),
            _reduce_groupby, extra_args=lambda i: (key, aggs))


# assigner factories (picklable closures shipped to map tasks)

def _round_robin_assigner(p: int):
    def assign(acc: BlockAccessor) -> np.ndarray:
        return np.arange(acc.num_rows()) % p
    return assign


def _random_assigner(p: int, seed: Optional[int]):
    def assign(acc: BlockAccessor) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return rng.integers(0, p, size=acc.num_rows())
    return assign


def _range_assigner(key: str, bounds: np.ndarray):
    def assign(acc: BlockAccessor) -> np.ndarray:
        return np.searchsorted(bounds, acc.block[key], side="right")
    return assign


def _hash_assigner(key: str, p: int):
    def assign(acc: BlockAccessor) -> np.ndarray:
        vals = acc.block[key]
        # stable hash via string digest (object/str cols) or modulo (ints)
        if vals.dtype.kind in "iu":
            return vals % p
        import zlib
        return np.asarray([zlib.crc32(str(v).encode()) % p for v in vals])
    return assign
