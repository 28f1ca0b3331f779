"""Blocks: the unit of data movement.

Reference: `python/ray/data/block.py:221` (`BlockAccessor` over Arrow
tables). The native block format is a **columnar dict of numpy
arrays** — what `torch.from_numpy` takes with zero conversion, as the
JAX package's `jnp.asarray` does — with Arrow/pandas as interop
boundaries rather than the core representation.
"""

from __future__ import annotations

import builtins
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np

Block = Dict[str, np.ndarray]


def _as_array(values: List[Any]) -> np.ndarray:
    # bytes columns must stay object-dtype: np.asarray would coerce
    # equal-length bytes to a fixed-width 'S' dtype, which silently
    # strips trailing NUL bytes on read-back — fatal for binary
    # payloads (encoded images etc.)
    if any(isinstance(v, bytes) for v in values):
        out = np.empty(len(values), dtype=object)
        out[:] = values
        return out
    try:
        return np.asarray(values)
    except ValueError:
        # ragged tensors / variable-length lists: keep an object array
        out = np.empty(len(values), dtype=object)
        out[:] = values
        return out


class BlockAccessor:
    """Uniform view over a columnar block."""

    def __init__(self, block: Block):
        self.block = block

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_rows(rows: List[Dict[str, Any]]) -> Block:
        if not rows:
            return {}
        # union of every row's keys (first-seen order): heterogeneous
        # rows (routine in e.g. webdataset shards) must not silently
        # drop columns absent from the first row; missing values are
        # None
        cols: Dict[str, List[Any]] = {}
        for r in rows:
            for k in r:
                cols.setdefault(k, [])
        for r in rows:
            for k in cols:
                cols[k].append(r.get(k))
        return {k: _as_array(v) for k, v in cols.items()}

    @staticmethod
    def from_items(items: List[Any]) -> Block:
        if items and isinstance(items[0], dict):
            return BlockAccessor.from_rows(items)
        return {"item": _as_array(items)}

    @staticmethod
    def concat(blocks: List[Block]) -> Block:
        blocks = [b for b in blocks if b and BlockAccessor(b).num_rows()]
        if not blocks:
            return {}
        keys = set(blocks[0].keys())
        for b in blocks[1:]:
            if set(b.keys()) != keys:
                raise ValueError(
                    f"cannot concat blocks with mismatched schemas: "
                    f"{sorted(keys)} vs {sorted(b.keys())}")
        return {k: np.concatenate([b[k] for b in blocks]) for k in keys}

    # -- introspection -----------------------------------------------------

    def num_rows(self) -> int:
        if not self.block:
            return 0
        return len(next(iter(self.block.values())))

    def size_bytes(self) -> int:
        return sum(a.nbytes if hasattr(a, "nbytes") else 64
                   for a in self.block.values())

    def schema(self) -> Dict[str, str]:
        return {k: str(v.dtype) for k, v in self.block.items()}

    # -- row/slice access --------------------------------------------------

    def row(self, i: int) -> Dict[str, Any]:
        return {k: v[i] for k, v in self.block.items()}

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for i in range(self.num_rows()):
            yield self.row(i)

    def slice(self, start: int, end: int) -> Block:
        return {k: v[start:end] for k, v in self.block.items()}

    def take(self, indices: np.ndarray) -> Block:
        return {k: v[indices] for k, v in self.block.items()}

    # -- interop -----------------------------------------------------------

    def to_pandas(self):
        import pandas as pd
        return pd.DataFrame({k: list(v) if v.dtype == object else v
                             for k, v in self.block.items()})

    def to_arrow(self):
        import pyarrow as pa
        return pa.table({k: pa.array(list(v)) if v.dtype == object
                         else pa.array(v) for k, v in self.block.items()})

    @staticmethod
    def from_pandas(df) -> Block:
        return {str(c): df[c].to_numpy() for c in df.columns}

    @staticmethod
    def from_arrow(table) -> Block:
        out: Block = {}
        for name in table.column_names:
            col = table.column(name)
            try:
                out[name] = col.to_numpy(zero_copy_only=False)
            except Exception:
                out[name] = _as_array(col.to_pylist())
        return out


def normalize_batch_output(out: Any) -> Block:
    """map_batches outputs: dict-of-arrays, DataFrame, list of rows."""
    if isinstance(out, dict):
        arrs = {k: np.asarray(v) if not isinstance(v, np.ndarray) else v
                for k, v in out.items()}
        for k, v in arrs.items():
            if v.ndim == 0:
                raise TypeError(
                    f"map_batches output column {k!r} is a scalar; columns "
                    f"must be 1+-dimensional arrays/lists (wrap it: [{k}])")
        return arrs
    try:
        import pandas as pd
        if isinstance(out, pd.DataFrame):
            return BlockAccessor.from_pandas(out)
    except ImportError:
        pass
    if isinstance(out, builtins.list):
        return BlockAccessor.from_items(out)
    raise TypeError(f"invalid map_batches output type: {type(out)}")
