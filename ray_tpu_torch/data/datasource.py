"""Datasources & sinks.

Reference: `python/ray/data/datasource/` (~35 sources). Each datasource
yields `ReadTask`s — serializable zero-arg callables returning one block —
which the executor runs as ray_tpu_torch tasks (reference
`datasource.py` ReadTask protocol).
"""

from __future__ import annotations

import glob as glob_mod
import json
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor

ReadTask = Callable[[], Block]


class Datasource:
    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        raise NotImplementedError

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None


def _expand_paths(paths) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(
                f for f in glob_mod.glob(os.path.join(p, "**", "*"),
                                         recursive=True)
                if os.path.isfile(f)))
        elif any(c in p for c in "*?["):
            out.extend(sorted(glob_mod.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files match {paths}")
    return out


class SimpleDatasource(Datasource):
    """Wrap a list of zero-arg read callables, one per partition —
    the minimal custom-source seam (reference: user Datasource
    subclasses, `python/ray/data/datasource/datasource.py`)."""

    def __init__(self, read_fns: List[ReadTask]):
        self._read_fns = list(read_fns)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        return list(self._read_fns)


class RangeDatasource(Datasource):
    def __init__(self, n: int, tensor_shape: Optional[tuple] = None):
        self.n = n
        self.tensor_shape = tensor_shape

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        n, shape = self.n, self.tensor_shape
        parallelism = max(1, min(parallelism, n)) if n else 1
        chunk = (n + parallelism - 1) // parallelism if n else 0
        tasks: List[ReadTask] = []
        for i in range(parallelism):
            lo, hi = i * chunk, min((i + 1) * chunk, n)
            if lo >= hi:
                break

            def read(lo=lo, hi=hi) -> Block:
                ids = np.arange(lo, hi, dtype=np.int64)
                if shape is None:
                    return {"id": ids}
                data = np.stack([np.full(shape, v, dtype=np.int64)
                                 for v in ids]) if hi > lo else \
                    np.zeros((0,) + shape, dtype=np.int64)
                return {"data": data}

            tasks.append(read)
        return tasks

    def estimate_inmemory_data_size(self):
        per = 8 if self.tensor_shape is None else \
            8 * int(np.prod(self.tensor_shape))
        return self.n * per


class ItemsDatasource(Datasource):
    def __init__(self, items: List[Any]):
        self.items = items

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        items = self.items
        n = len(items)
        parallelism = max(1, min(parallelism, n)) if n else 1
        chunk = (n + parallelism - 1) // parallelism if n else 0
        tasks = []
        for i in range(parallelism):
            part = items[i * chunk:(i + 1) * chunk]
            if not part:
                break
            tasks.append(lambda part=part: BlockAccessor.from_items(part))
        return tasks


class NumpyDatasource(Datasource):
    def __init__(self, arrays: Dict[str, np.ndarray]):
        self.arrays = arrays

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        n = len(next(iter(self.arrays.values())))
        parallelism = max(1, min(parallelism, n)) if n else 1
        chunk = (n + parallelism - 1) // parallelism if n else 0
        tasks = []
        for i in range(parallelism):
            part = {k: v[i * chunk:(i + 1) * chunk]
                    for k, v in self.arrays.items()}
            if not len(next(iter(part.values()))):
                break
            tasks.append(lambda part=part: part)
        return tasks


class _FileDatasource(Datasource):
    """One read task per file (reference FileBasedDatasource)."""

    def __init__(self, paths):
        self.paths = _expand_paths(paths)

    def _read_file(self, path: str) -> Block:
        raise NotImplementedError

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        read_file = self._read_file
        return [lambda p=p: read_file(p) for p in self.paths]


class CSVDatasource(_FileDatasource):
    def _read_file(self, path: str) -> Block:
        import pandas as pd
        return BlockAccessor.from_pandas(pd.read_csv(path))


class JSONDatasource(_FileDatasource):
    """JSONL or a top-level JSON array per file."""

    def _read_file(self, path: str) -> Block:
        with open(path) as f:
            first = f.read(1)
            f.seek(0)
            if first == "[":
                rows = json.load(f)
            else:
                rows = [json.loads(line) for line in f if line.strip()]
        return BlockAccessor.from_rows(rows)


class ParquetDatasource(_FileDatasource):
    def _read_file(self, path: str) -> Block:
        import pyarrow.parquet as pq
        return BlockAccessor.from_arrow(pq.read_table(path))


class TextDatasource(_FileDatasource):
    def _read_file(self, path: str) -> Block:
        with open(path) as f:
            lines = [ln.rstrip("\n") for ln in f]
        return {"text": np.asarray(lines, dtype=object)}


class BinaryDatasource(_FileDatasource):
    def _read_file(self, path: str) -> Block:
        with open(path, "rb") as f:
            data = f.read()
        arr = np.empty(1, dtype=object)
        arr[0] = data
        return {"bytes": arr, "path": np.asarray([path], dtype=object)}


class ImageDatasource(_FileDatasource):
    def __init__(self, paths, size: Optional[tuple] = None,
                 mode: str = "RGB"):
        super().__init__(paths)
        self.size = size
        self.mode = mode

    def _read_file(self, path: str) -> Block:
        from PIL import Image
        img = Image.open(path).convert(self.mode)
        if self.size:
            img = img.resize(self.size)
        return {"image": np.expand_dims(np.asarray(img), 0),
                "path": np.asarray([path], dtype=object)}


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------


def write_block_csv(block: Block, path: str) -> None:
    BlockAccessor(block).to_pandas().to_csv(path, index=False)


def write_block_json(block: Block, path: str) -> None:
    df = BlockAccessor(block).to_pandas()
    df.to_json(path, orient="records", lines=True)


def write_block_parquet(block: Block, path: str) -> None:
    import pyarrow.parquet as pq
    pq.write_table(BlockAccessor(block).to_arrow(), path)


class TFRecordDatasource(_FileDatasource):
    """TFRecord files of tf.train.Example protos, parsed with the
    dependency-free codec in `_tfrecord.py` (reference:
    `datasource/tfrecords_datasource.py`, which requires TensorFlow).
    Single-element lists flatten to scalar columns, matching the
    reference's auto-unwrap behavior. BytesList values stay bytes
    (as in the reference/TF — the wire cannot distinguish str from
    bytes, and arbitrary binary payloads like encoded images must not
    be UTF-8-decoded)."""

    def _read_file(self, path: str) -> Block:
        from ray_tpu_torch.data import _tfrecord as tfr

        rows = []
        for payload in tfr.read_records(path):
            ex = tfr.parse_example(payload)
            row = {k: (v[0] if len(v) == 1 else
                       (np.asarray(v) if not isinstance(v[0], bytes)
                        else v))
                   for k, v in ex.items()}
            rows.append(row)
        return BlockAccessor.from_rows(rows)


def write_block_tfrecords(block: Block, path: str) -> None:
    from ray_tpu_torch.data import _tfrecord as tfr

    acc = BlockAccessor(block)
    tfr.write_records(
        path, [tfr.build_example(acc.row(i))
               for i in range(acc.num_rows())])


class SQLDatasource(Datasource):
    """Rows from a DB-API connection (reference:
    `datasource/sql_datasource.py` — `read_sql(sql, connection_factory)`).
    One read task runs the query in a worker; the factory must be
    picklable (e.g. a module-level function opening sqlite3)."""

    def __init__(self, sql: str, connection_factory: Callable):
        self.sql = sql
        self.connection_factory = connection_factory

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        sql, factory = self.sql, self.connection_factory

        def read() -> Block:
            conn = factory()
            try:
                cur = conn.cursor()
                cur.execute(sql)
                names = [d[0] for d in cur.description]
                rows = cur.fetchall()
            finally:
                conn.close()
            return BlockAccessor.from_rows(
                [dict(zip(names, r)) for r in rows])

        return [read]


class ArrowDatasource(Datasource):
    """In-memory pyarrow Table(s), one block per table chunk."""

    def __init__(self, table):
        self.table = table

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        table = self.table
        n = table.num_rows
        parallelism = max(1, min(parallelism, n)) if n else 1
        chunk = (n + parallelism - 1) // parallelism if n else 0
        tasks: List[ReadTask] = []
        for i in range(parallelism):
            lo = i * chunk
            hi = min(n, lo + chunk)
            if lo >= hi:
                break
            part = table.slice(lo, hi - lo)  # capture only the slice
            tasks.append(lambda part=part: BlockAccessor.from_arrow(part))
        return tasks


class WebDatasetDatasource(_FileDatasource):
    """WebDataset-style tar shards (reference:
    `datasource/webdataset_datasource.py`): each .tar member is named
    `<key>.<ext>`; members sharing a key form one sample, with columns
    named by extension. Pure-stdlib tarfile — no webdataset dependency.
    Text-ish extensions decode to str, `.json` parses, `.cls`/`.id`
    parse to int when possible; everything else stays bytes (encoded
    images etc. must not be UTF-8-decoded)."""

    _TEXT_EXTS = {"txt", "text", "caption", "transcript"}
    _INT_EXTS = {"cls", "id", "label", "index"}

    def _read_file(self, path: str) -> Block:
        import tarfile
        from collections import OrderedDict

        samples: "OrderedDict[str, dict]" = OrderedDict()
        with tarfile.open(path) as tar:
            for member in tar:
                if not member.isfile():
                    continue
                base = os.path.basename(member.name)
                key, _, ext = base.partition(".")
                data = tar.extractfile(member).read()
                row = samples.setdefault(key, {"__key__": key})
                ext = ext.lower()
                if ext == "json":
                    row[ext] = json.loads(data)
                elif ext in self._TEXT_EXTS:
                    row[ext] = data.decode("utf-8")
                elif ext in self._INT_EXTS:
                    try:
                        row[ext] = int(data.decode("utf-8").strip())
                    except ValueError:
                        row[ext] = data
                else:
                    row[ext] = data
        return BlockAccessor.from_rows(list(samples.values()))


def write_block_webdataset(block: Block, path: str) -> None:
    """One tar shard per block: each row becomes `<key>.<column>`
    members (key = row's __key__ or its index)."""
    import io
    import tarfile

    acc = BlockAccessor(block)
    with tarfile.open(path, "w") as tar:
        for i in range(acc.num_rows()):
            row = acc.row(i)
            key = str(row.get("__key__", i))
            for col, value in row.items():
                if col == "__key__":
                    continue
                if isinstance(value, bytes):
                    payload = value
                elif isinstance(value, str):
                    payload = value.encode("utf-8")
                elif isinstance(value, (dict, list)):
                    payload = json.dumps(value).encode("utf-8")
                else:
                    payload = str(value).encode("utf-8")
                info = tarfile.TarInfo(name=f"{key}.{col}")
                info.size = len(payload)
                tar.addfile(info, io.BytesIO(payload))
