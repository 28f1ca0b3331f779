"""The Data scenarios of `tests/test_data.py`, against the port's own
`ray_tpu_torch.data` on the port's runtime: transforms, fusion,
exchanges, IO, iteration, train ingest. One module-scoped cluster, as in
that file. At the end, one driver script of a pipeline runs against both
packages in subprocesses and their JSON results must be equal.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rd

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def cluster():
    ray_tpu_torch.init(num_cpus=8, num_gpus=0,
                 object_store_memory=256 * 1024 * 1024)
    yield
    ray_tpu_torch.shutdown()


def test_range_count_schema():
    ds = rd.range(100, parallelism=4)
    assert ds.count() == 100
    assert ds.num_blocks() == 4
    assert ds.schema() == {"id": "int64"}


def test_map_chain_fuses_and_computes():
    ds = (rd.range(32, parallelism=4)
          .map(lambda r: {"x": r["id"] * 2})
          .filter(lambda r: r["x"] % 4 == 0)
          .map_batches(lambda b: {"x": b["x"], "y": b["x"] + 1}))
    from ray_tpu_torch.data import logical as L
    optimized = L.optimize(ds._op)
    # the map chain fuses, then fuses INTO the read: one task wave
    assert isinstance(optimized, L.FusedRead)
    assert len(optimized.transforms) == 3
    rows = ds.take_all()
    xs = sorted(r["x"] for r in rows)
    assert xs == [i * 2 for i in range(32) if (i * 2) % 4 == 0]
    assert all(r["y"] == r["x"] + 1 for r in rows)


def test_flat_map_and_columns():
    ds = (rd.from_items([{"a": 1}, {"a": 2}])
          .flat_map(lambda r: [{"a": r["a"]}, {"a": r["a"] * 10}])
          .add_column("b", lambda acc: acc.block["a"] + 1)
          .select_columns(["b"]))
    assert sorted(r["b"] for r in ds.take_all()) == [2, 3, 11, 21]


def test_limit_streams():
    ds = rd.range(1000, parallelism=8).limit(25)
    assert ds.count() == 25


def test_repartition():
    ds = rd.range(100, parallelism=2).repartition(5)
    assert ds.num_blocks() == 5
    assert ds.count() == 100


def test_random_shuffle_permutes():
    ds = rd.range(200, parallelism=4).random_shuffle(seed=7)
    vals = [r["id"] for r in ds.take_all()]
    assert sorted(vals) == list(range(200))
    assert vals != list(range(200))


def test_sort_descending_and_ascending():
    rng = np.random.default_rng(0)
    vals = rng.permutation(500)
    ds = rd.from_numpy({"v": vals}, parallelism=5).sort("v")
    out = [r["v"] for r in ds.take_all()]
    assert out == sorted(out)
    out_d = [r["v"] for r in
             rd.from_numpy({"v": vals}, parallelism=5)
             .sort("v", descending=True).take_all()]
    assert out_d == sorted(out_d, reverse=True)


def test_groupby_aggregations():
    items = [{"k": i % 3, "v": float(i)} for i in range(30)]
    ds = rd.from_items(items, parallelism=4)
    out = {r["k"]: r for r in ds.groupby("k").sum("v").take_all()}
    for k in (0, 1, 2):
        expected = sum(i for i in range(30) if i % 3 == k)
        assert out[k]["sum(v)"] == expected
    counts = {r["k"]: r["count()"] for r in
              ds.groupby("k").count().take_all()}
    assert counts == {0: 10, 1: 10, 2: 10}
    # global aggregate (no key)
    total = ds.groupby(None).sum("v").take_all()
    assert total[0]["sum(v)"] == sum(builtins_range_f(30))


def builtins_range_f(n):
    return [float(i) for i in range(n)]


def test_iter_batches_exact_sizes():
    ds = rd.range(100, parallelism=3)
    batches = list(ds.iter_batches(batch_size=32))
    sizes = [len(b["id"]) for b in batches]
    assert sizes == [32, 32, 32, 4]
    all_ids = np.concatenate([b["id"] for b in batches])
    assert sorted(all_ids.tolist()) == list(range(100))
    # drop_last
    sizes2 = [len(b["id"]) for b in
              ds.iter_batches(batch_size=32, drop_last=True)]
    assert sizes2 == [32, 32, 32]


def test_union_and_zip():
    a = rd.range(10, parallelism=2)
    b = rd.range(10, parallelism=2).map(lambda r: {"id2": r["id"] + 100})
    assert a.union(rd.range(5, parallelism=1)).count() == 15
    z = a.zip(b)
    rows = z.take_all()
    assert all(r["id2"] == r["id"] + 100 for r in rows)


def test_csv_json_parquet_roundtrip(tmp_path):
    ds = rd.range(50, parallelism=2).map(
        lambda r: {"id": r["id"], "sq": r["id"] ** 2})
    for fmt, writer, reader in [
        ("csv", ds.write_csv, rd.read_csv),
        ("json", ds.write_json, rd.read_json),
        ("parquet", ds.write_parquet, rd.read_parquet),
    ]:
        out_dir = str(tmp_path / fmt)
        files = writer(out_dir)
        assert len(files) == 2
        back = reader(out_dir)
        rows = sorted(back.take_all(), key=lambda r: r["id"])
        assert len(rows) == 50
        assert rows[7]["sq"] == 49


def test_split_for_train_ingest():
    ds = rd.range(64, parallelism=4)
    shards = ds.streaming_split(2)
    assert len(shards) == 2
    seen = []
    for sh in shards:
        for b in sh.iter_batches(batch_size=8):
            seen.extend(b["id"].tolist())
    assert sorted(seen) == list(range(64))


def test_train_integration_dataset_shard(tmp_path):
    """get_dataset_shard inside a train worker (reference
    `python/ray/train/tests/test_data_parallel_trainer.py` datasets)."""
    from ray_tpu_torch import train
    from ray_tpu_torch.air import RunConfig, ScalingConfig

    def loop(config):
        it = train.get_dataset_shard("train")
        total = 0
        count = 0
        for batch in it.iter_batches(batch_size=16):
            total += int(batch["id"].sum())
            count += len(batch["id"])
        train.report({"total": total, "count": count})

    ds = rd.range(128, parallelism=4)
    trainer = train.DataParallelTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=str(tmp_path), name="ingest"),
        datasets={"train": ds},
    )
    result = trainer.fit()
    # rank0's shard is half the data; totals across workers sum to full
    assert result.metrics["count"] == 64


def test_tfrecords_roundtrip(tmp_path):
    """write_tfrecords -> read_tfrecords round-trips int/float/str
    columns through the dependency-free Example codec."""
    from ray_tpu_torch import data

    ds = data.from_items([
        {"id": i, "score": float(i) / 2, "name": f"row{i}"}
        for i in range(20)
    ])
    out = str(tmp_path / "tfr")
    import os

    os.makedirs(out, exist_ok=True)
    files = ds.write_tfrecords(out)
    assert files

    back = data.read_tfrecords(out).to_pandas().sort_values(
        "id").reset_index(drop=True)
    assert list(back["id"]) == list(range(20))
    assert back["name"][3] == b"row3"  # BytesList stays bytes
    import numpy as np

    np.testing.assert_allclose(back["score"],
                               [i / 2 for i in range(20)], rtol=1e-6)


def test_tfrecord_codec_vectors_and_negatives(tmp_path):
    """Multi-element lists and negative ints survive the proto wire."""
    from ray_tpu_torch.data import _tfrecord as tfr

    row = {"vec": np.asarray([1.5, -2.5, 3.0], np.float32),
           "ints": np.asarray([-7, 8], np.int64),
           "blob": b"\x00\x01\xff"}
    data_bytes = tfr.build_example(row)
    parsed = tfr.parse_example(data_bytes)
    np.testing.assert_allclose(parsed["vec"], row["vec"])
    np.testing.assert_array_equal(parsed["ints"], row["ints"])
    assert parsed["blob"] == [b"\x00\x01\xff"]
    # framing round-trip
    path = str(tmp_path / "one.tfrecords")
    tfr.write_records(path, [data_bytes, data_bytes])
    assert len(list(tfr.read_records(path))) == 2


def test_read_sql(tmp_path):
    import sqlite3

    db = str(tmp_path / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("DROP TABLE IF EXISTS t")
    conn.execute("CREATE TABLE t (a INTEGER, b TEXT)")
    conn.executemany("INSERT INTO t VALUES (?, ?)",
                     [(i, f"v{i}") for i in range(10)])
    conn.commit()
    conn.close()

    from ray_tpu_torch import data

    def sqlite_factory():  # nested -> cloudpickled by value
        import sqlite3 as sq

        return sq.connect(db)

    df = data.read_sql("SELECT * FROM t WHERE a >= 5",
                       sqlite_factory).to_pandas()
    assert sorted(df["a"]) == [5, 6, 7, 8, 9]
    assert set(df["b"]) == {f"v{i}" for i in range(5, 10)}


def test_from_arrow_to_arrow():
    import pyarrow as pa

    from ray_tpu_torch import data

    table = pa.table({"x": list(range(12)), "y": [i * 2 for i in range(12)]})
    ds = data.from_arrow(table, parallelism=3)
    back = ds.to_arrow()
    assert back.num_rows == 12
    assert sorted(back.column("x").to_pylist()) == list(range(12))
    # transforms apply on arrow-sourced data
    total = data.from_arrow(table).map_batches(
        lambda b: {"z": b["x"] + b["y"]}).to_pandas()["z"].sum()
    assert total == sum(i + 2 * i for i in range(12))


def test_push_based_shuffle_paths():
    """With many input blocks and a small merge factor, repartition/
    shuffle/sort/groupby route through the push-based (pipelined-merge)
    exchange and must produce identical results to the pull-based path."""
    from ray_tpu_torch.data.context import DataContext

    ctx = DataContext.get_current()
    old_factor, old_flag = ctx.shuffle_merge_factor, \
        ctx.use_push_based_shuffle
    try:
        ctx.shuffle_merge_factor = 3
        ctx.use_push_based_shuffle = True
        # 12 blocks > merge factor 3 -> push path engages
        ds = rd.range(240, parallelism=12)
        assert ds.repartition(4).count() == 240
        vals = [r["id"] for r in
                rd.range(240, parallelism=12)
                .random_shuffle(seed=3).take_all()]
        assert sorted(vals) == list(range(240))
        assert vals != list(range(240))

        rng = np.random.default_rng(1)
        raw = rng.permutation(300)
        out = [r["v"] for r in
               rd.from_numpy({"v": raw}, parallelism=12)
               .sort("v").take_all()]
        assert out == sorted(out)

        items = [{"k": i % 4, "v": float(i)} for i in range(120)]
        sums = {r["k"]: r["sum(v)"] for r in
                rd.from_items(items, parallelism=12)
                .groupby("k").sum("v").take_all()}
        assert sums == {k: float(sum(i for i in range(120) if i % 4 == k))
                        for k in range(4)}

        # pull path (flag off) agrees exactly on the same seed
        ctx.use_push_based_shuffle = False
        vals_pull = [r["id"] for r in
                     rd.range(240, parallelism=12)
                     .random_shuffle(seed=3).take_all()]
        assert vals_pull == vals
    finally:
        ctx.shuffle_merge_factor = old_factor
        ctx.use_push_based_shuffle = old_flag


def test_scalar_aggregates_and_unique():
    ds = rd.from_items([{"k": i % 3, "v": float(i)} for i in range(30)],
                       parallelism=4)
    assert ds.sum("v") == sum(range(30))
    assert ds.min("v") == 0.0
    assert ds.max("v") == 29.0
    assert abs(ds.mean("v") - 14.5) < 1e-9
    assert ds.unique("k") == [0, 1, 2]
    # mixed/None columns fall back to first-seen order instead of raising
    mixed = rd.from_items([{"k": 1}, {"k": None}, {"k": 1}],
                          parallelism=1)
    vals = mixed.unique("k")
    assert len(vals) == 2 and 1 in vals


def test_random_sample():
    ds = rd.range(2000, parallelism=4)
    frac = ds.random_sample(0.3, seed=5)
    n = frac.count()
    assert 400 < n < 800  # ~600 expected
    # deterministic per (seed, partitioning)
    assert rd.range(2000, parallelism=4).random_sample(
        0.3, seed=5).count() == n
    # duplicate rows draw independently (not all-or-nothing)
    dup = rd.from_items([{"x": 1}] * 1000, parallelism=2)
    m = dup.random_sample(0.5, seed=1).count()
    assert 300 < m < 700, m


def test_train_test_split():
    ds = rd.range(100, parallelism=4)
    train, test = ds.train_test_split(0.25)
    train_ids = [r["id"] for r in train.take_all()]
    test_ids = [r["id"] for r in test.take_all()]
    assert len(train_ids) == 75 and len(test_ids) == 25
    # unshuffled contract: test is the LAST fraction, order preserved
    assert sorted(train_ids + test_ids) == list(range(100))
    assert test_ids == list(range(75, 100))

    train, test = ds.train_test_split(0.25, shuffle=True, seed=0)
    ids = sorted([r["id"] for r in train.take_all()]
                 + [r["id"] for r in test.take_all()])
    assert ids == list(range(100))
    assert test.count() == 25


# -- actor-compute map stages (reference actor_pool_map_operator.py) --------


def test_map_batches_actor_pool_class_udf():
    class AddTag:
        def __init__(self, tag):
            # expensive state: built once per pool actor
            import os
            self.tag = tag
            self.instance = f"{os.getpid()}-{id(self)}"

        def __call__(self, batch):
            n = len(batch["id"])
            return {"id": batch["id"],
                    "tag": np.asarray([self.tag] * n),
                    "who": np.asarray([self.instance] * n)}

    ds = rd.range(64, parallelism=8).map_batches(
        AddTag, compute=rd.ActorPoolStrategy(min_size=2, max_size=2),
        fn_constructor_args=("t",))
    rows = ds.take_all()
    assert len(rows) == 64
    assert all(r["tag"] == "t" for r in rows)
    # 8 blocks ran on at most 2 warm instances (one per pool actor) —
    # the class was NOT instantiated per block
    assert 1 <= len({r["who"] for r in rows}) <= 2


def test_map_batches_actor_pool_autoscales():
    import time as _t

    class Slow:
        def __init__(self):
            self.instance = id(self)

        def __call__(self, batch):
            _t.sleep(0.2)
            return {"id": batch["id"],
                    "who": np.asarray([self.instance] * len(batch["id"]))}

    ds = rd.range(64, parallelism=8).map_batches(
        Slow, compute=rd.ActorPoolStrategy(
            min_size=1, max_size=3, max_tasks_in_flight_per_actor=1))
    rows = ds.take_all()
    # a saturated 1-actor pool with backlog must have grown
    assert len({r["who"] for r in rows}) > 1


def test_map_batches_class_udf_requires_actor_compute():
    class F:
        def __call__(self, b):
            return b

    with pytest.raises(ValueError, match="ActorPoolStrategy"):
        rd.range(8).map_batches(F)


def test_actor_map_does_not_fuse_with_task_maps():
    from ray_tpu_torch.data import logical as L

    class Id:
        def __call__(self, b):
            return b

    ds = (rd.range(32, parallelism=4)
          .map(lambda r: {"x": r["id"]})
          .map_batches(Id, compute=rd.ActorPoolStrategy(min_size=1))
          .map(lambda r: {"x": r["x"] + 1}))
    optimized = L.optimize(ds._op)
    # the actor stage stays a lone MapBatches between two task stages
    assert isinstance(optimized, L.MapRows)
    assert isinstance(optimized.input_op, L.MapBatches)
    assert optimized.input_op.compute is not None
    assert [r["x"] for r in sorted(ds.take_all(),
                                   key=lambda r: r["x"])] == \
        list(range(1, 33))


def test_streaming_ingest_actor_pool_to_train_worker():
    """VERDICT round-2 item 3 'done' criterion: a stateful actor pool
    tokenizes and feeds iter_batches into a train worker without
    materializing the dataset on the driver."""

    class Tokenizer:
        def __init__(self, vocab_base):
            self.vocab_base = vocab_base  # stands in for a real vocab load

        def __call__(self, batch):
            return {"tokens": batch["id"] + self.vocab_base}

    ds = rd.range(256, parallelism=8).map_batches(
        Tokenizer, compute=rd.ActorPoolStrategy(min_size=2, max_size=2),
        fn_constructor_args=(1000,))

    @ray_tpu_torch.remote
    def train_worker(it):
        total, nbatches = 0, 0
        for b in it.iter_batches(batch_size=32):
            total += int(b["tokens"].sum())
            nbatches += 1
        return total, nbatches

    [shard] = ds.streaming_split(1)
    total, nbatches = ray_tpu_torch.get(train_worker.remote(shard), timeout=180)
    assert nbatches == 8
    assert total == sum(i + 1000 for i in range(256))


def test_resource_budget_backpressure():
    from ray_tpu_torch.data.context import DataContext
    from ray_tpu_torch.data.executor import _ResourceBudget

    # default: window derives from cluster CPUs, not a constant
    ctx = DataContext(max_concurrent_tasks=None)
    b = _ResourceBudget(ctx)
    assert b.task_cap() == max(2, int(8 * 1.5))  # fixture cluster: 8 CPUs
    ctx2 = DataContext(max_concurrent_tasks=3)
    assert _ResourceBudget(ctx2).task_cap() == 3

    # with the high-water mark forced to 0 every allocated byte counts as
    # pressure; submission serializes but the stage still completes
    ctx3 = DataContext(store_backpressure_fraction=0.0)
    from ray_tpu_torch.data import executor as ex
    old = rd.DataContext.get_current().store_backpressure_fraction
    rd.DataContext.get_current().store_backpressure_fraction = 0.0
    try:
        big = rd.range_tensor(64, shape=(1024,), parallelism=8) \
            .map_batches(lambda b: {"data": b["data"] * 2})
        assert big.count() == 64
    finally:
        rd.DataContext.get_current().store_backpressure_fraction = old


# ---------------------------------------------------------------------------
# limit pushdown + streaming ingest (VERDICT r4 items 4 and 6)
# ---------------------------------------------------------------------------

def test_limit_pushdown_plan():
    """Limit commutes below cardinality-preserving maps and stamps
    limit_rows on the Read; Limit(Limit) collapses."""
    from ray_tpu_torch.data import logical as L

    ds = (rd.range(1000, parallelism=8)
          .map(lambda r: {"id": r["id"] * 2})
          .limit(100)
          .limit(40))
    op = L.optimize(ds._op)
    # map stays on top (runs only on the surviving rows)
    assert isinstance(op, L.MapRows) or isinstance(op, L.FusedMap)
    inner = op.input_op
    assert isinstance(inner, L.Limit) and inner.n == 40
    assert isinstance(inner.input_op, L.Read)
    assert inner.input_op.limit_rows == 40

    # filter blocks pushdown (changes cardinality); the filter itself
    # fuses into the read, with the limit staying on top
    ds2 = rd.range(100, parallelism=4).filter(
        lambda r: r["id"] % 2 == 0).limit(10)
    op2 = L.optimize(ds2._op)
    assert isinstance(op2, L.Limit)
    assert isinstance(op2.input_op, L.FusedRead)
    assert "Filter" in op2.input_op.name


def test_limit_pushdown_reads_fewer_tasks(tmp_path):
    """With limit pushed into the read, only enough read tasks run to
    satisfy it — the datasource records which partitions were read."""
    import json

    marker_dir = tmp_path / "reads"
    marker_dir.mkdir()

    def make_read(i):
        def read():
            with open(marker_dir / f"{i}", "w") as f:
                f.write("1")
            return {"id": np.arange(i * 10, (i + 1) * 10)}
        return read

    from ray_tpu_torch.data.datasource import SimpleDatasource

    ds = rd.read_datasource(
        SimpleDatasource([make_read(i) for i in range(16)]))
    got = ds.limit(10).map(lambda r: {"id": r["id"]}).take_all()
    assert len(got) == 10
    # far fewer than 16 partitions were touched (the launch window is 4)
    assert len(list(marker_dir.iterdir())) <= 8


def test_streaming_split_dynamic_balance():
    """A deliberately slow consumer receives FEWER blocks than a fast
    one — the coordinator hands blocks to whoever asks (VERDICT r3 weak
    #6: static round-robin gave no rebalancing)."""
    import threading
    import time as time_mod

    ds = rd.range(320, parallelism=16)
    fast_it, slow_it = ds.streaming_split(2)
    counts = {"fast": 0, "slow": 0}
    rows = {"fast": 0, "slow": 0}

    errors = []

    def consume(name, it, delay):
        try:
            for block in it._iter_blocks():
                counts[name] += 1
                rows[name] += len(block["id"])
                time_mod.sleep(delay)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append((name, repr(e)))

    t1 = threading.Thread(target=consume, args=("fast", fast_it, 0.0))
    t2 = threading.Thread(target=consume, args=("slow", slow_it, 0.25))
    t1.start(); t2.start()
    t1.join(timeout=180); t2.join(timeout=180)
    assert not t1.is_alive() and not t2.is_alive(), "consumers hung"
    assert not errors, errors
    assert rows["fast"] + rows["slow"] == 320
    assert counts["fast"] + counts["slow"] == 16
    # every block still arrives exactly once, and the fast consumer
    # carried the bulk of the stream
    assert counts["fast"] > counts["slow"]


def test_streaming_split_first_block_before_pipeline_done():
    """First block is consumable while upstream still produces: the
    time-to-first-block must be far below total pipeline time."""
    import time as time_mod

    def slow_identity(b):
        time_mod.sleep(0.5)
        return {"id": b["id"]}

    ds = rd.range(160, parallelism=8).map_batches(slow_identity)
    (it,) = ds.streaming_split(1)
    start = time_mod.monotonic()
    gen = it._iter_blocks()
    first = next(gen)
    first_latency = time_mod.monotonic() - start
    rest = list(gen)
    total = time_mod.monotonic() - start
    assert len(first["id"]) + sum(len(b["id"]) for b in rest) == 160
    # 8 blocks x 0.5s of map work: with streaming the first block lands
    # after ~1 task, not after the whole wave
    assert first_latency < total * 0.75, (first_latency, total)


def test_iter_batches_prefetch_overlaps():
    """prefetch_batches resolves blocks ahead of the consumer; values
    are unchanged and consumption overlaps production."""
    ds = rd.range(128, parallelism=8)
    it = ds.streaming_split(1)[0]
    seen = []
    for batch in it.iter_batches(batch_size=16, prefetch_batches=2):
        seen.extend(batch["id"].tolist())
    assert sorted(seen) == list(range(128))

    # plain materialized iterator path too
    got = []
    from ray_tpu_torch.data.iterator import DataIterator
    refs = rd.range(64, parallelism=4)._execute()
    for batch in DataIterator(refs).iter_batches(batch_size=8,
                                                 prefetch_batches=3):
        got.extend(batch["id"].tolist())
    assert sorted(got) == list(range(64))


def test_optimize_does_not_mutate_shared_plan():
    """Datasets share plan nodes; executing a derived .limit() dataset
    must not truncate the parent's later executions."""
    ds = rd.range(500, parallelism=8).map(lambda r: {"id": r["id"]})
    assert ds.limit(10).count() == 10
    assert ds.count() == 500  # parent plan untouched
    assert ds.limit(25).count() == 25
    assert ds.count() == 500


def summarize_tasks():
    """{task name: {state: count}} from the GCS task table, as the JAX
    package's `ray_tpu.util.state.summarize_tasks` (not ported yet)."""
    from ray_tpu_torch._private.worker_api import _require_state

    cw = _require_state().core_worker
    raw = cw._run_sync(cw.gcs.call("list_task_events", {
        "limit": 100_000, "name": None, "state": None}))
    out = {}
    for rec in raw:
        per = out.setdefault(rec["name"], {})
        per[rec["state"]] = per.get(rec["state"], 0) + 1
    return out


def test_read_map_fusion_single_task_wave():
    """VERDICT r5 item 8: a read->map->map pipeline executes as ONE task
    wave — intermediate blocks never round-trip through the store
    (reference `rules/zero_copy_map_fusion.py` + read fusion)."""
    import time as time_mod

    def quiesced_summary():
        # task events flush to the GCS asynchronously; wait until the
        # stream settles so earlier tests' in-flight events don't
        # pollute the before/after diff
        prev = summarize_tasks()
        deadline = time_mod.monotonic() + 30
        while time_mod.monotonic() < deadline:
            time_mod.sleep(1.0)
            cur = summarize_tasks()
            if cur == prev:
                return cur
            prev = cur
        return prev

    before = quiesced_summary()

    ds = (rd.range(64, parallelism=4)
          .map_batches(lambda b: {"x": b["id"] * 2})
          .map_batches(lambda b: {"x": b["x"] + 1}))
    rows = sorted(r["x"] for r in ds.take_all())
    assert rows == [i * 2 + 1 for i in range(64)]

    def delta(after, name):
        b = sum(before.get(name, {}).values())
        a = sum(after.get(name, {}).values())
        return a - b

    after = quiesced_summary()

    # one wave: one task per block, nothing per stage
    assert delta(after, "_run_read_fused") == 4, after.get("_run_read_fused")
    assert delta(after, "_run_read") == 0
    assert delta(after, "_run_transform") == 0


def test_actor_pool_grows_and_shrinks():
    """VERDICT r5 item 8: the actor-compute pool scales with queue depth
    both ways — grows while every actor is saturated with backlog,
    releases idle actors once the tail no longer needs them (reference
    `execution/autoscaler/default_autoscaler.py`). Asserted on the
    executor's own autoscaling trace: the GCS ALIVE view lags worker
    spawn by seconds on slow hosts, which is scheduler latency, not
    pool policy."""
    import time as time_mod

    from ray_tpu_torch.data.context import DataContext

    class Slow:
        def __call__(self, batch):
            # the last block is much slower: during its tail the idle
            # surplus actors must be released while the stage still runs
            time_mod.sleep(1.5 if int(batch["id"][0]) >= 150 else 0.2)
            return batch

    ds = rd.range(160, parallelism=16).map_batches(
        Slow, compute=rd.ActorPoolStrategy(
            min_size=1, max_size=4, max_tasks_in_flight_per_actor=2),
        batch_size=10)
    assert ds.count() == 160

    stats = DataContext.get_current().last_actor_pool_stats
    assert stats is not None
    assert stats["peak"] == 4, stats       # grew to max under backlog
    assert stats["grows"] == 3, stats
    assert stats["shrinks"] >= 1, stats    # released idle tail capacity


def test_webdataset_roundtrip(tmp_path):
    """write_webdataset -> read_webdataset round-trips tar shards of
    keyed samples (reference `datasource/webdataset_datasource.py`,
    here dependency-free via stdlib tarfile)."""
    ds = rd.from_items([
        {"__key__": f"s{i:03d}", "txt": f"caption {i}", "cls": i % 3,
         "bin": bytes([i, i + 1])}
        for i in range(12)
    ], parallelism=2)
    out = str(tmp_path / "wds")
    os.makedirs(out, exist_ok=True)
    files = ds.write_webdataset(out)
    assert len(files) == 2 and all(f.endswith(".tar") for f in files)

    back = sorted(rd.read_webdataset(out).take_all(),
                  key=lambda r: r["__key__"])
    assert len(back) == 12
    assert back[4]["txt"] == "caption 4"
    assert back[4]["cls"] == 1
    assert back[4]["bin"] == bytes([4, 5])


def test_webdataset_binary_and_heterogeneous(tmp_path):
    """Binary payloads with trailing NULs survive (bytes stay
    object-dtype, never fixed-width 'S'), and samples with differing
    member sets keep the union of columns."""
    import tarfile
    import io

    out = tmp_path / "shard.tar"
    with tarfile.open(out, "w") as tar:
        def add(name, payload):
            info = tarfile.TarInfo(name=name)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))

        add("a.txt", b"first")          # no .cls member
        add("b.txt", b"second")
        add("b.cls", b"7")
        add("a.bin", b"\x04\x00")       # trailing NUL
        add("b.bin", b"\x05\x06")

    rows = sorted(rd.read_webdataset(str(out)).take_all(),
                  key=lambda r: r["__key__"])
    assert rows[0]["bin"] == b"\x04\x00"
    assert rows[1]["bin"] == b"\x05\x06"
    assert rows[0]["cls"] is None       # union schema, missing -> None
    assert rows[1]["cls"] == 7


# -- start_batch_index: elastic resume-from-offset --------------------------


def test_iter_batches_start_batch_index_exact_resume():
    """Resuming at batch k replays the deterministic stream's suffix
    exactly — no batch duplicated, none skipped (the soak driver's
    watermark audit relies on this)."""
    ds = rd.range(100, parallelism=3)
    full = [b["id"].tolist() for b in ds.iter_batches(batch_size=32)]
    for k in range(len(full) + 1):
        resumed = [b["id"].tolist() for b in
                   ds.iter_batches(batch_size=32, start_batch_index=k)]
        assert resumed == full[k:], f"resume at batch {k} diverged"


def test_iter_batches_start_batch_index_crosses_blocks():
    # 4 blocks of 25 rows; skipping 3 batches of 10 lands 5 rows INTO
    # block 1 — the first emitted batch stitches a mid-block slice
    ds = rd.range(100, parallelism=4)
    batches = list(ds.iter_batches(batch_size=10, start_batch_index=3))
    assert batches[0]["id"].tolist() == list(range(30, 40))
    assert [len(b["id"]) for b in batches] == [10] * 7
    assert batches[-1]["id"].tolist() == list(range(90, 100))


def test_iter_batches_start_batch_index_past_end():
    ds = rd.range(20, parallelism=2)
    assert list(ds.iter_batches(batch_size=8, start_batch_index=3)) == []
    # partial last batch is itself resumable
    last = list(ds.iter_batches(batch_size=8, start_batch_index=2))
    assert len(last) == 1 and last[0]["id"].tolist() == [16, 17, 18, 19]


def test_iter_batches_start_batch_index_validation():
    ds = rd.range(10, parallelism=1)
    with pytest.raises(ValueError, match=">= 0"):
        list(ds.iter_batches(batch_size=4, start_batch_index=-1))
    with pytest.raises(ValueError, match="deterministic"):
        list(ds.iter_batches(batch_size=4, start_batch_index=1,
                             local_shuffle_buffer_size=8))


# One pipeline, run once against each package in its own process (range
# -> map_batches -> filter -> sort -> groupby -> seeded random_shuffle ->
# iter_batches resumed at a batch index): the port must give the JAX
# package's results.
TWO_PACKAGE_SCRIPT = r'''
import importlib, json, sys
import numpy as np
pkg = sys.argv[1]
rt = importlib.import_module(pkg)
rd = importlib.import_module(pkg + ".data")
gpus = {"num_gpus": 0} if pkg == "ray_tpu_torch" else {"num_tpus": 0}
rt.init(num_cpus=4, object_store_memory=128 << 20, **gpus)
out = {}
try:
    ds = (rd.range(200, parallelism=8)
          .map_batches(lambda b: {"id": b["id"], "sq": b["id"] * b["id"],
                                  "g": b["id"] % 5})
          .filter(lambda r: r["id"] % 3 != 0))
    out["count"] = ds.count()
    out["schema"] = sorted(ds.schema())
    srt = ds.sort("sq", descending=True)
    out["sorted_head"] = [int(r["id"]) for r in srt.take(10)]
    grouped = ds.groupby("g").sum("sq").take_all()
    out["groupby"] = sorted([int(r["g"]), int(r["sum(sq)"])]
                            for r in grouped)
    shuf = ds.random_shuffle(seed=7)
    out["shuffle_ids"] = [int(r["id"]) for r in shuf.take_all()]
    batches = list(shuf.iter_batches(batch_size=16, drop_last=True,
                                     start_batch_index=3))
    out["resumed"] = [b["id"].tolist() for b in batches]
    out["resumed_dtypes"] = sorted({str(v.dtype) for b in batches
                                    for v in b.values()})
finally:
    rt.shutdown()
print(json.dumps(out))
'''


def test_one_pipeline_gives_equal_results_on_both_packages():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-c", TWO_PACKAGE_SCRIPT, pkg], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("ray_tpu", "ray_tpu_torch")}
    results = {}
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{pkg}: {err[-3000:]}"
        results[pkg] = json.loads(out.strip().splitlines()[-1])
    want = results["ray_tpu"]
    assert want["count"] == len([i for i in range(200) if i % 3])
    assert sorted(want["shuffle_ids"]) == [i for i in range(200) if i % 3]
    assert want["shuffle_ids"] != sorted(want["shuffle_ids"])
    assert len(want["resumed"]) == want["count"] // 16 - 3
    assert results["ray_tpu_torch"] == want
