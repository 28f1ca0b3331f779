"""Logical plan operators + the fusion optimizer.

Reference: `python/ray/data/_internal/logical/{operators,rules,
optimizers.py}` — the key rule rebuilt here is **operator fusion**:
adjacent one-to-one transforms collapse into a single task per block
(reference `rules/operator_fusion.py`), which is also the XLA-ish thing to
do — fewer task launches, fewer object-store round trips.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.data.block import (
    Block,
    BlockAccessor,
    normalize_batch_output,
)
from ray_tpu_torch.data.datasource import Datasource


@dataclasses.dataclass
class ActorPoolStrategy:
    """Run a map stage's UDF inside a pool of warm, stateful actors
    (reference `python/ray/data/_internal/compute.py` ActorPoolStrategy +
    `_internal/execution/operators/actor_pool_map_operator.py`).

    The pool starts at `min_size` and autoscales up to `max_size` while
    the stage has a backlog; each actor executes at most
    `max_tasks_in_flight_per_actor` blocks concurrently (pipelining the
    object transfer behind the running task). With a class UDF the class
    is instantiated ONCE per actor — expensive state (tokenizers, model
    weights, decoders) is paid per worker, not per block.
    """

    min_size: int = 1
    max_size: Optional[int] = None  # None: fixed pool of min_size
    max_tasks_in_flight_per_actor: int = 2

    def __post_init__(self):
        if self.min_size < 1:
            raise ValueError("min_size must be >= 1")
        if self.max_size is not None and self.max_size < self.min_size:
            raise ValueError("max_size must be >= min_size")


class LogicalOp:
    def __init__(self, input_op: Optional["LogicalOp"] = None):
        self.input_op = input_op

    @property
    def name(self) -> str:
        return type(self).__name__


class Read(LogicalOp):
    def __init__(self, datasource: Datasource, parallelism: int):
        super().__init__(None)
        self.datasource = datasource
        self.parallelism = parallelism
        # set by the limit-pushdown rule: the executor launches read
        # tasks incrementally and stops once this many rows exist
        self.limit_rows: Optional[int] = None


class InputBlocks(LogicalOp):
    """Already-materialized input (from_blocks / materialized datasets)."""

    def __init__(self, block_refs: List[Any]):
        super().__init__(None)
        self.block_refs = block_refs


class AbstractMap(LogicalOp):
    """One-to-one block transform; fusable (task-compute stages only).

    Transforms take ``(block, block_index)`` — the index is the block's
    position in the stage's input list, giving deterministic per-block
    identity to transforms that need it (e.g. ``random_sample``'s RNG).
    """

    #: ActorPoolStrategy for actor-compute stages; None = stateless tasks
    compute: Optional[ActorPoolStrategy] = None

    def make_transform(self) -> Callable[[Block, int], Block]:
        raise NotImplementedError

    def make_transform_factory(self) -> Callable[[], Callable]:
        """Picklable zero-arg factory producing the transform ON the
        executing actor (where class UDFs instantiate their state)."""
        t = self.make_transform()
        return lambda: t


class MapBatches(AbstractMap):
    def __init__(self, input_op, fn: Callable, batch_size: Optional[int],
                 fn_args: tuple = (), fn_kwargs: Optional[dict] = None,
                 with_block_index: bool = False,
                 compute: Optional[ActorPoolStrategy] = None,
                 fn_constructor_args: tuple = (),
                 fn_constructor_kwargs: Optional[dict] = None):
        super().__init__(input_op)
        self.fn = fn
        self.batch_size = batch_size
        self.fn_args = fn_args
        self.fn_kwargs = fn_kwargs or {}
        self.with_block_index = with_block_index
        self.compute = compute
        self.fn_constructor_args = fn_constructor_args
        self.fn_constructor_kwargs = fn_constructor_kwargs or {}
        if isinstance(fn, type) and compute is None:
            raise ValueError(
                "map_batches with a class UDF requires "
                "compute=ActorPoolStrategy(...) — the class is stateful "
                "and must live in pooled actors (reference semantics)")
        if not isinstance(fn, type) and (fn_constructor_args
                                         or fn_constructor_kwargs):
            raise ValueError(
                "fn_constructor_args/kwargs require a callable-class fn "
                "(they are passed to its __init__, once per pool actor)")

    @staticmethod
    def _batch_loop(fn, bs, args, kwargs, with_idx):
        def transform(block: Block, idx: int) -> Block:
            acc = BlockAccessor(block)
            n = acc.num_rows()
            if n == 0:
                return block
            size = bs or n
            outs = []
            for lo in range(0, n, size):
                batch = acc.slice(lo, min(lo + size, n))
                extra = (idx,) if with_idx else ()
                outs.append(normalize_batch_output(
                    fn(batch, *extra, *args, **kwargs)))
            return BlockAccessor.concat(outs)

        return transform

    def make_transform(self):
        if isinstance(self.fn, type):
            raise TypeError("class UDFs run via make_transform_factory "
                            "on actor compute")
        return self._batch_loop(self.fn, self.batch_size, self.fn_args,
                                self.fn_kwargs, self.with_block_index)

    def make_transform_factory(self):
        fn, bs = self.fn, self.batch_size
        args, kwargs = self.fn_args, self.fn_kwargs
        with_idx = self.with_block_index
        ctor_args, ctor_kwargs = (self.fn_constructor_args,
                                  self.fn_constructor_kwargs)
        batch_loop = MapBatches._batch_loop

        def factory():
            # class UDFs instantiate HERE — once per pool actor
            call = fn(*ctor_args, **ctor_kwargs) if isinstance(fn, type) \
                else fn
            return batch_loop(call, bs, args, kwargs, with_idx)

        return factory


class MapRows(AbstractMap):
    def __init__(self, input_op, fn: Callable):
        super().__init__(input_op)
        self.fn = fn

    def make_transform(self):
        fn = self.fn

        def transform(block: Block, idx: int) -> Block:
            rows = [fn(r) for r in BlockAccessor(block).iter_rows()]
            return BlockAccessor.from_rows(rows)

        return transform


class Filter(AbstractMap):
    def __init__(self, input_op, fn: Callable):
        super().__init__(input_op)
        self.fn = fn

    def make_transform(self):
        fn = self.fn

        def transform(block: Block, idx: int) -> Block:
            acc = BlockAccessor(block)
            keep = np.asarray([bool(fn(r)) for r in acc.iter_rows()],
                              dtype=bool)
            return acc.take(np.nonzero(keep)[0]) if len(keep) else block

        return transform


class FlatMap(AbstractMap):
    def __init__(self, input_op, fn: Callable):
        super().__init__(input_op)
        self.fn = fn

    def make_transform(self):
        fn = self.fn

        def transform(block: Block, idx: int) -> Block:
            rows: List[dict] = []
            for r in BlockAccessor(block).iter_rows():
                rows.extend(fn(r))
            return BlockAccessor.from_rows(rows)

        return transform


class AddColumn(AbstractMap):
    def __init__(self, input_op, col: str, fn: Callable):
        super().__init__(input_op)
        self.col = col
        self.fn = fn

    def make_transform(self):
        col, fn = self.col, self.fn

        def transform(block: Block, idx: int) -> Block:
            out = dict(block)
            out[col] = np.asarray(fn(BlockAccessor(block)))
            return out

        return transform


class DropColumns(AbstractMap):
    def __init__(self, input_op, cols: List[str]):
        super().__init__(input_op)
        self.cols = cols

    def make_transform(self):
        cols = set(self.cols)
        return lambda block, idx: {k: v for k, v in block.items()
                                   if k not in cols}


class SelectColumns(AbstractMap):
    def __init__(self, input_op, cols: List[str]):
        super().__init__(input_op)
        self.cols = cols

    def make_transform(self):
        cols = list(self.cols)
        return lambda block, idx: {k: block[k] for k in cols}


class FusedMap(AbstractMap):
    """Fusion product: run several transforms in one task."""

    def __init__(self, input_op,
                 transforms: List[Callable[[Block, int], Block]],
                 fused_names: List[str]):
        super().__init__(input_op)
        self.transforms = transforms
        self.fused_names = fused_names

    @property
    def name(self) -> str:
        return "Fused[" + "->".join(self.fused_names) + "]"

    def make_transform(self):
        transforms = self.transforms

        def transform(block: Block, idx: int) -> Block:
            for t in transforms:
                block = t(block, idx)
            return block

        return transform


class FusedRead(LogicalOp):
    """Read fused with downstream map transforms: each read task
    produces its block AND runs the transform chain in the SAME task,
    so intermediate blocks never round-trip through the object store
    (reference `rules/zero_copy_map_fusion.py` + read-op fusion in
    `rules/operator_fusion.py` — one task wave instead of one per
    stage)."""

    def __init__(self, read: "Read",
                 transforms: List[Callable[[Block, int], Block]],
                 fused_names: List[str]):
        super().__init__(None)
        self.datasource = read.datasource
        self.parallelism = read.parallelism
        self.transforms = transforms
        self.fused_names = fused_names

    @property
    def name(self) -> str:
        return "Read->" + "->".join(self.fused_names)


class Limit(LogicalOp):
    def __init__(self, input_op, n: int):
        super().__init__(input_op)
        self.n = n


class Repartition(LogicalOp):
    def __init__(self, input_op, n: int):
        super().__init__(input_op)
        self.n = n


class RandomShuffle(LogicalOp):
    def __init__(self, input_op, seed: Optional[int] = None):
        super().__init__(input_op)
        self.seed = seed


class Sort(LogicalOp):
    def __init__(self, input_op, key: str, descending: bool = False):
        super().__init__(input_op)
        self.key = key
        self.descending = descending


class GroupByAggregate(LogicalOp):
    def __init__(self, input_op, key: Optional[str],
                 aggs: List[Tuple[str, Optional[str], str]]):
        """aggs: list of (agg_name, on_column, out_name)."""
        super().__init__(input_op)
        self.key = key
        self.aggs = aggs


class Union(LogicalOp):
    def __init__(self, inputs: List[LogicalOp]):
        super().__init__(None)
        self.inputs = inputs


class Zip(LogicalOp):
    def __init__(self, left: LogicalOp, right: LogicalOp):
        super().__init__(None)
        self.left = left
        self.right = right


# map ops that preserve row count 1:1 — Limit commutes past them
# (reference `rules/limit_pushdown.py`: only cardinality-preserving
# one-to-one ops; Filter/FlatMap/MapBatches can change row counts)
_CARDINALITY_PRESERVING = (MapRows, AddColumn, DropColumns, SelectColumns)


def _push_limit(op: "Limit") -> LogicalOp:
    """Limit pushdown (reference `rules/limit_pushdown.py`):
    - Limit(Limit(x, m), n) -> Limit(x, min(m, n))
    - Limit commutes below cardinality-preserving maps, so the map runs
      on only the surviving rows
    - Limit(Read) stays put but stamps `limit_rows` on the Read — the
      executor then launches read tasks incrementally instead of the
      whole wave (set_read_parallelism analogue)."""
    changed = True
    while changed:
        changed = False
        child = op.input_op
        if isinstance(child, Limit):
            op = Limit(child.input_op, min(op.n, child.n))
            changed = True
        elif (isinstance(child, _CARDINALITY_PRESERVING)
                and child.compute is None):
            inner = Limit(child.input_op, op.n)
            child.input_op = _push_limit(inner)
            return child
    if isinstance(op.input_op, Read):
        op.input_op.limit_rows = op.n
    return op


def clone_plan(op: LogicalOp) -> LogicalOp:
    """Per-node shallow copy of a plan tree. Datasets SHARE op objects
    (`Dataset._derive` wraps `self._op` without copying), so optimizer
    rules that rewire `input_op` or stamp fields must work on a private
    copy — mutating shared nodes would silently change the plans of
    sibling datasets."""
    import copy

    if not isinstance(op, LogicalOp):
        return op
    new = copy.copy(op)
    if isinstance(new, Union):
        new.inputs = [clone_plan(i) for i in new.inputs]
    elif isinstance(new, Zip):
        new.left = clone_plan(new.left)
        new.right = clone_plan(new.right)
    elif new.input_op is not None:
        new.input_op = clone_plan(new.input_op)
    return new


def optimize(op: LogicalOp) -> LogicalOp:
    """Bottom-up rules (reference `logical/rules/`): limit pushdown,
    then fusion of AbstractMap chains (`operator_fusion.py`). Operates
    on a private clone — the caller's plan is never mutated."""
    return _optimize(clone_plan(op))


def _optimize(op: LogicalOp) -> LogicalOp:
    if isinstance(op, Union):
        op.inputs = [_optimize(i) for i in op.inputs]
        return op
    if isinstance(op, Zip):
        op.left, op.right = _optimize(op.left), _optimize(op.right)
        return op
    if isinstance(op, Limit):
        op = _push_limit(op)
        if not isinstance(op, Limit):
            return _optimize(op)  # limit sank below a map: re-walk
    if op.input_op is not None:
        op.input_op = _optimize(op.input_op)
    if isinstance(op, AbstractMap) and isinstance(op.input_op, AbstractMap) \
            and op.compute is None and op.input_op.compute is None:
        # actor-compute stages never fuse: their UDF state lives in a
        # dedicated pool, and fusing a task-compute neighbor into it
        # would drag that neighbor's work onto the pool's actors
        # (reference fuses only compatible compute strategies)
        child = op.input_op
        child_transforms = (child.transforms
                            if isinstance(child, FusedMap)
                            else [child.make_transform()])
        child_names = (child.fused_names if isinstance(child, FusedMap)
                       else [child.name])
        op = FusedMap(
            child.input_op,
            child_transforms + [op.make_transform()],
            child_names + [op.name],
        )
    if isinstance(op, AbstractMap) and op.compute is None:
        # read fusion: the whole read->map chain becomes one task wave
        transforms = (op.transforms if isinstance(op, FusedMap)
                      else [op.make_transform()])
        names = (op.fused_names if isinstance(op, FusedMap)
                 else [op.name])
        child = op.input_op
        if isinstance(child, Read) and child.limit_rows is None:
            return FusedRead(child, transforms, names)
        if isinstance(child, FusedRead):
            # the input already fused into its read (bottom-up order);
            # append — the plan is a private clone, mutation is safe
            child.transforms = child.transforms + transforms
            child.fused_names = child.fused_names + names
            return child
    return op
