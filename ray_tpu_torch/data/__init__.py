"""ray_tpu_torch.data — streaming distributed datasets.

Reference: `python/ray/data/` (SURVEY.md §2.4): lazy logical plan →
fusion optimizer → streaming execution over ray_tpu_torch tasks, with columnar
numpy blocks in the shared-memory object store.

The port's copy of `ray_tpu/data/`: blocks stay columnar dicts of numpy
arrays, and a consumer moves a batch to the card itself (pinned host
memory, then ``.to("cuda", non_blocking=True)``), as the JAX package's
consumer calls ``jnp.asarray``. Nothing here imports torch: the split
coordinator and the train controller unpickle these objects without it.
The parquet, arrow, pandas and image readers import their libraries when
they are called.
"""

from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.data import logical as _L
from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.logical import ActorPoolStrategy
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import Dataset, GroupedData
from ray_tpu_torch.data.datasource import (
    ArrowDatasource,
    BinaryDatasource,
    CSVDatasource,
    Datasource,
    ImageDatasource,
    ItemsDatasource,
    JSONDatasource,
    NumpyDatasource,
    ParquetDatasource,
    RangeDatasource,
    SQLDatasource,
    TextDatasource,
    TFRecordDatasource,
)
from ray_tpu_torch.data.iterator import DataIterator


def _default_parallelism() -> int:
    return DataContext.get_current().read_parallelism


def read_datasource(ds: Datasource,
                    parallelism: Optional[int] = None) -> Dataset:
    return Dataset(_L.Read(ds, parallelism or _default_parallelism()))


def range(n: int, *, parallelism: Optional[int] = None) -> Dataset:  # noqa: A001
    return read_datasource(RangeDatasource(n), parallelism)


def range_tensor(n: int, *, shape: tuple = (1,),
                 parallelism: Optional[int] = None) -> Dataset:
    return read_datasource(RangeDatasource(n, tensor_shape=shape),
                           parallelism)


def from_items(items: List[Any],
               parallelism: Optional[int] = None) -> Dataset:
    return read_datasource(ItemsDatasource(items), parallelism)


def from_numpy(arrays, parallelism: Optional[int] = None) -> Dataset:
    if isinstance(arrays, np.ndarray):
        arrays = {"data": arrays}
    return read_datasource(NumpyDatasource(arrays), parallelism)


def from_pandas(df, parallelism: Optional[int] = None) -> Dataset:
    return read_datasource(
        NumpyDatasource(BlockAccessor.from_pandas(df)), parallelism)


def read_csv(paths, parallelism: Optional[int] = None) -> Dataset:
    return read_datasource(CSVDatasource(paths), parallelism)


def read_json(paths, parallelism: Optional[int] = None) -> Dataset:
    return read_datasource(JSONDatasource(paths), parallelism)


def read_parquet(paths, parallelism: Optional[int] = None) -> Dataset:
    return read_datasource(ParquetDatasource(paths), parallelism)


def read_text(paths, parallelism: Optional[int] = None) -> Dataset:
    return read_datasource(TextDatasource(paths), parallelism)


def read_binary_files(paths, parallelism: Optional[int] = None) -> Dataset:
    return read_datasource(BinaryDatasource(paths), parallelism)


def read_tfrecords(paths, parallelism: Optional[int] = None) -> Dataset:
    return read_datasource(TFRecordDatasource(paths), parallelism)


def read_webdataset(paths, parallelism: Optional[int] = None) -> Dataset:
    from ray_tpu_torch.data.datasource import WebDatasetDatasource

    return read_datasource(WebDatasetDatasource(paths), parallelism)


def read_sql(sql: str, connection_factory,
             parallelism: Optional[int] = None) -> Dataset:
    return read_datasource(SQLDatasource(sql, connection_factory),
                           parallelism)


def from_arrow(table, parallelism: Optional[int] = None) -> Dataset:
    return read_datasource(ArrowDatasource(table), parallelism)


def read_images(paths, *, size: Optional[tuple] = None, mode: str = "RGB",
                parallelism: Optional[int] = None) -> Dataset:
    return read_datasource(ImageDatasource(paths, size=size, mode=mode),
                           parallelism)


__all__ = [
    "ActorPoolStrategy",
    "Block",
    "BlockAccessor",
    "DataContext",
    "DataIterator",
    "Dataset",
    "Datasource",
    "GroupedData",
    "from_items",
    "from_numpy",
    "from_arrow",
    "from_pandas",
    "range",
    "range_tensor",
    "read_binary_files",
    "read_csv",
    "read_datasource",
    "read_images",
    "read_json",
    "read_parquet",
    "read_sql",
    "read_text",
    "read_tfrecords",
    "read_webdataset",
]
