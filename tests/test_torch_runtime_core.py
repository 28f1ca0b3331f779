"""The core runtime scenarios of `tests/test_core_runtime.py`, against the
port's own runtime (`ray_tpu_torch`): tasks, objects, actors on a live
cluster of the port's GCS, raylet and workers.

One module-scoped cluster, as in that file, under the port's own
lock-order checker (`ray_tpu_torch._private.lockdep`): it records every
lock the driver creates, the daemons self-install it from the inherited
RAY_TPU_LOCKDEP=1, and teardown fails on any reported cycle. At the end,
one driver script runs against both packages in two subprocesses and
their JSON results must be equal.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import lockdep

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def lockdep_gate():
    """The port's lockdep, record-only in this process (a cycle fails
    the module at teardown with both witness stacks) and inherited by
    the cluster's daemons through the environment."""
    already = lockdep.enabled()
    if not already:
        lockdep.install(raise_on_cycle=False)
    os.environ[lockdep.ENV_VAR] = "1"
    try:
        yield
    finally:
        reports = lockdep.cycle_reports()
        os.environ.pop(lockdep.ENV_VAR, None)
        if not already:
            lockdep.uninstall()
        assert not reports, (
            "lockdep: lock-order cycle(s) detected:\n\n"
            + "\n\n".join(reports))


@pytest.fixture(scope="module", autouse=True)
def cluster(lockdep_gate):
    ray_tpu_torch.init(num_cpus=4, num_gpus=0, object_store_memory=256 * 1024 * 1024)
    yield
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
def square(x):
    return x * x


def test_basic_task():
    assert ray_tpu_torch.get(square.remote(7), timeout=60) == 49


def test_fanout_tasks():
    refs = [square.remote(i) for i in range(16)]
    assert ray_tpu_torch.get(refs, timeout=120) == [i * i for i in range(16)]


def test_kwargs_and_multiple_returns():
    @ray_tpu_torch.remote(num_returns=2)
    def divmod_task(a, b=3):
        return a // b, a % b

    q, r = divmod_task.remote(17, b=5)
    assert ray_tpu_torch.get([q, r], timeout=60) == [3, 2]


def test_plasma_roundtrip():
    @ray_tpu_torch.remote
    def make(n):
        return np.ones(n, dtype=np.float32)

    @ray_tpu_torch.remote
    def total(a):
        return float(a.sum())

    ref = make.remote(2_000_000)  # 8MB -> plasma
    assert ray_tpu_torch.get(total.remote(ref), timeout=120) == 2_000_000.0


def test_put_get_small_and_large():
    small = ray_tpu_torch.put({"a": 1})
    assert ray_tpu_torch.get(small, timeout=30) == {"a": 1}
    arr = np.arange(1_000_000)
    large = ray_tpu_torch.put(arr)
    np.testing.assert_array_equal(ray_tpu_torch.get(large, timeout=60), arr)


def test_error_propagation():
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("intentional-failure")

    with pytest.raises(ray_tpu_torch.RayTaskError, match="intentional-failure"):
        ray_tpu_torch.get(boom.remote(), timeout=60)


def test_get_timeout():
    @ray_tpu_torch.remote
    def slow():
        time.sleep(30)

    with pytest.raises(ray_tpu_torch.GetTimeoutError):
        ray_tpu_torch.get(slow.remote(), timeout=0.5)


def test_wait():
    refs = [square.remote(i) for i in range(6)]
    ready, not_ready = ray_tpu_torch.wait(refs, num_returns=2, timeout=60)
    assert len(ready) >= 2
    assert len(ready) + len(not_ready) == 6


def test_wait_drain_loop():
    """The reference `wait_multiple_refs` pattern: drain a batch one
    wait() at a time. Exercises both the caller-thread ready fast path
    and the scan-and-pulse slow path; every ref must surface exactly
    once."""
    refs = [square.remote(i) for i in range(200)]
    seen = []
    not_ready = refs
    while not_ready:
        ready, not_ready = ray_tpu_torch.wait(not_ready, timeout=60)
        assert ready, "wait timed out with tasks still pending"
        seen.extend(ready)
    assert len(seen) == 200
    assert {r.binary() for r in seen} == {r.binary() for r in refs}
    assert sorted(ray_tpu_torch.get(seen)) == sorted(i * i for i in range(200))


def test_wait_timeout_none_ready():
    @ray_tpu_torch.remote
    def sleepy():
        import time as _t
        _t.sleep(5)
        return 1

    ref = sleepy.remote()
    ready, not_ready = ray_tpu_torch.wait([ref], timeout=0.3)
    assert ready == [] and not_ready == [ref]
    assert ray_tpu_torch.get(ref, timeout=60) == 1


def test_task_burst_with_ref_dependencies():
    """A burst where later tasks depend on earlier ones' returns must not
    deadlock in the batched push pipeline (dependent specs ride their own
    frame — the batch reply would otherwise withhold the upstream value
    the executor is blocked on)."""
    @ray_tpu_torch.remote
    def add_one(x):
        return x + 1

    ref = add_one.remote(0)
    refs = [ref]
    for _ in range(20):
        ref = add_one.remote(ref)
        refs.append(ref)
    assert ray_tpu_torch.get(refs[-1], timeout=120) == 21

    # interleaved: independent + dependent specs in one burst
    base = [add_one.remote(i) for i in range(10)]
    chained = [add_one.remote(b) for b in base]
    assert ray_tpu_torch.get(chained, timeout=120) == [i + 2 for i in range(10)]


def test_task_burst_batched_pipeline():
    """A burst bigger than the lease-pipeline window rides batch frames;
    results and errors must still map back per-task."""
    @ray_tpu_torch.remote
    def may_fail(i):
        if i % 17 == 0:
            raise ValueError(f"boom {i}")
        return i

    refs = [may_fail.remote(i) for i in range(300)]
    ok, errs = 0, 0
    for i, r in enumerate(refs):
        try:
            assert ray_tpu_torch.get(r, timeout=120) == i
            ok += 1
        except ray_tpu_torch.RayTaskError as e:
            assert f"boom {i}" in str(e)
            errs += 1
    assert ok == 282 and errs == 18


def test_nested_tasks():
    @ray_tpu_torch.remote
    def outer(n):
        inner = [square.remote(i) for i in range(n)]
        return sum(ray_tpu_torch.get(inner))

    assert ray_tpu_torch.get(outer.remote(4), timeout=120) == 14


def test_actor_state_and_ordering():
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self, start=0):
            self.v = start

        def incr(self, n=1):
            self.v += n
            return self.v

    c = Counter.remote(100)
    refs = [c.incr.remote() for _ in range(50)]
    # Sequence ordering: the 50th increment sees all prior ones.
    assert ray_tpu_torch.get(refs[-1], timeout=120) == 150


def test_named_actor():
    @ray_tpu_torch.remote
    class Registry:
        def who(self):
            return "registry"

    Registry.options(name="test_named_actor").remote()
    h = ray_tpu_torch.get_actor("test_named_actor")
    assert ray_tpu_torch.get(h.who.remote(), timeout=60) == "registry"


def test_actor_handle_passing():
    @ray_tpu_torch.remote
    class Holder:
        def __init__(self):
            self.v = 41

        def bump(self):
            self.v += 1
            return self.v

    @ray_tpu_torch.remote
    def call_through(handle):
        return ray_tpu_torch.get(handle.bump.remote())

    h = Holder.remote()
    assert ray_tpu_torch.get(call_through.remote(h), timeout=120) == 42


def test_async_actor_concurrency():
    @ray_tpu_torch.remote
    class AsyncWorker:
        async def work(self, x):
            import asyncio

            await asyncio.sleep(0.2)
            return x

    aw = AsyncWorker.options(max_concurrency=8).remote()
    # warm: actor creation spawns a worker (~2s JAX import) that must
    # not land inside the timed window
    ray_tpu_torch.get(aw.work.remote(-1), timeout=120)
    start = time.time()
    out = ray_tpu_torch.get([aw.work.remote(i) for i in range(8)], timeout=120)
    elapsed = time.time() - start
    assert out == list(range(8))
    # 8 concurrent 0.2s sleeps must overlap (serial would be 1.6s+).
    assert elapsed < 1.4


def test_actor_death_raises():
    @ray_tpu_torch.remote
    class Mortal:
        def die(self):
            os._exit(1)

        def ping(self):
            return "pong"

    m = Mortal.remote()
    assert ray_tpu_torch.get(m.ping.remote(), timeout=60) == "pong"
    with pytest.raises(Exception):
        ray_tpu_torch.get(m.die.remote(), timeout=60)
    time.sleep(1)
    with pytest.raises(Exception):
        ray_tpu_torch.get(m.ping.remote(), timeout=30)


def test_cluster_resources():
    res = ray_tpu_torch.cluster_resources()
    assert res["CPU"] == 4.0


def test_actor_seq_epoch_resync():
    """Executor-side (epoch, seq) reorder buffer: a newer epoch flushes and
    resyncs at seq 0 (reconnect after connection loss); an older epoch runs
    immediately instead of wedging the stream."""
    import asyncio

    from ray_tpu_torch._private.core_worker import CoreWorker
    from ray_tpu_torch._private.task import TaskSpec, ACTOR_TASK

    class Stub:
        _actor_seq_state = {}
        dispatched = []
        _enqueue_ordered_collect = CoreWorker._enqueue_ordered_collect

        def _dispatch_actor_task(self, spec, fut):
            self.dispatched.append((spec.seq_epoch, spec.seq_no))

    stub = Stub()

    def spec(epoch, seq):
        return TaskSpec(task_id=b"t", job_id=b"j", name="m",
                        task_type=ACTOR_TASK, owner_worker_id=b"caller",
                        seq_no=seq, seq_epoch=epoch)

    async def run():
        enq = CoreWorker._enqueue_ordered
        # Epoch 1: seq 0 runs, seq 2 buffers (seq 1 lost with the wire).
        await enq(stub, spec(1, 0), None)
        await enq(stub, spec(1, 2), None)
        assert stub.dispatched == [(1, 0)]
        # Epoch 2 arrives: buffered (1,2) flushes, numbering resyncs at 0.
        await enq(stub, spec(2, 0), None)
        assert stub.dispatched == [(1, 0), (1, 2), (2, 0)]
        # In-order epoch 2 traffic flows normally.
        await enq(stub, spec(2, 1), None)
        assert stub.dispatched[-1] == (2, 1)
        # A stray old-epoch orphan executes immediately.
        await enq(stub, spec(1, 5), None)
        assert stub.dispatched[-1] == (1, 5)
        # Epoch 2 stream is unaffected by the orphan.
        await enq(stub, spec(2, 2), None)
        assert stub.dispatched[-1] == (2, 2)

    asyncio.run(run())


def test_runtime_context():
    """ray_tpu_torch.get_runtime_context() exposes job/node/worker identity on
    the driver and task/actor ids inside workers (reference
    `python/ray/runtime_context.py`)."""
    import ray_tpu_torch

    ctx = ray_tpu_torch.get_runtime_context()
    assert ctx.get_worker_mode() == "driver"
    assert ctx.get_task_id() is None
    assert len(ctx.get_job_id()) > 0
    assert len(ctx.get_node_id()) > 0
    assert len(ctx.get_worker_id()) > 0
    assert ":" in ctx.gcs_address
    d = ctx.get()
    assert d["worker_mode"] == "driver"
    assert d["job_id"] == ctx.get_job_id()

    @ray_tpu_torch.remote
    def task_ctx():
        c = ray_tpu_torch.get_runtime_context()
        return {"mode": c.get_worker_mode(), "task_id": c.get_task_id(),
                "actor_id": c.get_actor_id(), "job_id": c.get_job_id()}

    info = ray_tpu_torch.get(task_ctx.remote())
    assert info["mode"] == "worker"
    assert info["task_id"] is not None
    assert info["actor_id"] is None
    assert info["job_id"] == ctx.get_job_id()

    @ray_tpu_torch.remote
    class A:
        def ctx(self):
            c = ray_tpu_torch.get_runtime_context()
            return {"actor_id": c.get_actor_id(),
                    "task_id": c.get_task_id()}

    a = A.remote()
    info = ray_tpu_torch.get(a.ctx.remote())
    assert info["actor_id"] is not None
    assert info["task_id"] is not None
    ray_tpu_torch.kill(a)


def test_actor_burst_with_intra_burst_ref_dependency():
    """A burst where a later call's argument is an earlier call's ref —
    submitted back-to-back so they land in ONE submit-buffer flush. The
    batching fast path must not put both in one batched frame (the
    batch's single reply would withhold the first result the second
    task's argument resolution is waiting on — deadlock)."""

    @ray_tpu_torch.remote
    class Chain:
        def produce(self, x):
            return x + 1

        def consume(self, v):
            return v * 10

    c = Chain.remote()
    ray_tpu_torch.get(c.produce.remote(0))  # resolve actor (enable fast path)
    r1 = c.produce.remote(41)
    r2 = c.consume.remote(r1)  # same burst, depends on r1
    assert ray_tpu_torch.get(r2, timeout=30) == 420
    # interleaved bursts keep working and stay ordered
    refs = []
    for i in range(20):
        a = c.produce.remote(i)
        refs.append(c.consume.remote(a))
    assert ray_tpu_torch.get(refs, timeout=60) == [(i + 1) * 10
                                             for i in range(20)]


def test_actor_burst_with_nested_ref_dependency():
    """Same deadlock shape, but the dependency ref is buried inside a
    container arg (a supported pattern — nested refs arrive as refs and
    the body get()s them). Top-level entries are all by-value then, so
    the batch guard must detect the ref during pickling, not by wire
    tag."""

    @ray_tpu_torch.remote
    class Chain:
        def produce(self, x):
            return x + 1

        def consume_nested(self, lst):
            return ray_tpu_torch.get(lst[0], timeout=20) * 10

    c = Chain.remote()
    ray_tpu_torch.get(c.produce.remote(0))  # resolve actor (enable fast path)
    r1 = c.produce.remote(41)
    r2 = c.consume_nested.remote([r1])  # same burst, nested dependency
    assert ray_tpu_torch.get(r2, timeout=30) == 420
    # dict-nested too, in a burst loop
    refs = []
    for i in range(5):
        a = c.produce.remote(i)
        refs.append(c.consume_nested.remote({0: a}))
    assert ray_tpu_torch.get(refs, timeout=60) == [(i + 1) * 10
                                             for i in range(5)]


def test_threaded_actor_concurrency_groups():
    """Named concurrency groups (reference
    concurrency_group_manager.h): per-group thread pools — 'io' (2) runs
    its methods concurrently while 'compute' (1) serializes, without
    either stealing the other's threads."""
    import time as time_mod

    @ray_tpu_torch.remote(concurrency_groups={"io": 2, "compute": 1})
    class Worker:
        @ray_tpu_torch.method(concurrency_group="io")
        def fetch(self):
            time_mod.sleep(0.5)
            return time_mod.monotonic()

        @ray_tpu_torch.method(concurrency_group="compute")
        def crunch(self):
            time_mod.sleep(0.5)
            return time_mod.monotonic()

        def plain(self):
            return "default"

    w = Worker.remote()
    ray_tpu_torch.get(w.plain.remote(), timeout=60)  # actor up

    t0 = time_mod.monotonic()
    ray_tpu_torch.get([w.fetch.remote(), w.fetch.remote()], timeout=60)
    io_elapsed = time_mod.monotonic() - t0
    assert io_elapsed < 0.95, f"io group did not run concurrently: {io_elapsed}"

    t0 = time_mod.monotonic()
    ray_tpu_torch.get([w.crunch.remote(), w.crunch.remote()], timeout=60)
    compute_elapsed = time_mod.monotonic() - t0
    assert compute_elapsed > 0.95, \
        f"compute group (size 1) overlapped: {compute_elapsed}"

    # per-call override routes a method into another group
    t0 = time_mod.monotonic()
    ray_tpu_torch.get([w.crunch.options(concurrency_group="io").remote(),
                 w.crunch.options(concurrency_group="io").remote()],
                timeout=60)
    assert time_mod.monotonic() - t0 < 0.95

    # unknown group fails loudly, not silently-default
    with pytest.raises(Exception, match="unknown concurrency group"):
        ray_tpu_torch.get(w.plain.options(concurrency_group="nope").remote(),
                    timeout=60)
    ray_tpu_torch.kill(w)


def test_async_actor_concurrency_groups():
    """Async actors get per-group semaphores on one event loop."""
    import time as time_mod

    @ray_tpu_torch.remote(concurrency_groups={"io": 4}, max_concurrency=1)
    class AsyncWorker:
        @ray_tpu_torch.method(concurrency_group="io")
        async def fetch(self):
            import asyncio
            await asyncio.sleep(0.4)
            return 1

        async def slow_default(self):
            import asyncio
            await asyncio.sleep(0.4)
            return 2

    w = AsyncWorker.remote()
    ray_tpu_torch.get(w.slow_default.remote(), timeout=60)

    t0 = time_mod.monotonic()
    ray_tpu_torch.get([w.fetch.remote() for _ in range(4)], timeout=60)
    assert time_mod.monotonic() - t0 < 1.1  # 4-deep io group overlaps

    t0 = time_mod.monotonic()
    ray_tpu_torch.get([w.slow_default.remote(), w.slow_default.remote()],
                timeout=60)
    assert time_mod.monotonic() - t0 > 0.75  # default group is 1-deep
    ray_tpu_torch.kill(w)


def test_gpu_task_without_a_gpu_stays_pending():
    """No fallback hides the device: on a node with no GPU a num_gpus=1
    task is never run on the CPU; it stays pending and `get` times out."""
    @ray_tpu_torch.remote(num_gpus=1)
    def on_gpu():
        return "ran"

    ref = on_gpu.remote()
    with pytest.raises(ray_tpu_torch.GetTimeoutError):
        ray_tpu_torch.get(ref, timeout=1.0)
    ready, not_ready = ray_tpu_torch.wait([ref], timeout=0.5)
    assert ready == [] and not_ready == [ref]
    ray_tpu_torch.cancel(ref)
    assert ray_tpu_torch.get(square.remote(3), timeout=60) == 9


# One driver script, run once against each package in its own process:
# the port's runtime must give the JAX runtime's results.
TWO_PACKAGE_SCRIPT = r'''
import importlib, json, sys
import numpy as np
rt = importlib.import_module(sys.argv[1])
gpus = {"num_gpus": 0} if sys.argv[1] == "ray_tpu_torch" else {"num_tpus": 0}
rt.init(num_cpus=2, object_store_memory=128 << 20, **gpus)


@rt.remote
def square(x):
    return x * x


@rt.remote(num_returns=2)
def divmod_task(a, b=3):
    return a // b, a % b


@rt.remote
def total(a):
    return float(a.sum())


@rt.remote
def boom():
    raise ValueError("intentional-failure")


@rt.remote
class Counter:
    def __init__(self):
        self.n = 0

    def add(self, k):
        self.n += k
        return self.n


@rt.remote
class Registry:
    def who(self):
        return "registry"


out = {}
try:
    out["task"] = rt.get(square.remote(7), timeout=60)
    out["fanout"] = rt.get([square.remote(i) for i in range(16)], timeout=120)
    out["divmod"] = rt.get(list(divmod_task.remote(17, b=5)), timeout=60)
    out["small"] = rt.get(rt.put({"a": 1, "b": [1, 2.5, "x"]}), timeout=30)
    arr = np.arange(3_000_000, dtype=np.float32)  # 12 MB: through the store
    big = rt.put(arr)
    got = rt.get(big, timeout=60)
    out["large"] = [list(got.shape), str(got.dtype), float(got.sum()),
                    bool(np.array_equal(got, arr))]
    out["large_in_task"] = rt.get(total.remote(big), timeout=60)
    refs = [square.remote(i) for i in range(6)]
    ready, not_ready = rt.wait(refs, num_returns=6, timeout=60)
    out["wait"] = [len(ready), len(not_ready), sorted(rt.get(ready))]
    try:
        rt.get(boom.remote(), timeout=60)
        out["error"] = None
    except rt.RayTaskError as e:
        out["error"] = [type(e).__name__, "intentional-failure" in str(e)]
    Registry.options(name="registry").remote()
    out["named_actor"] = rt.get(rt.get_actor("registry").who.remote(),
                                timeout=60)
    c = Counter.remote()
    out["actor_ordering"] = rt.get([c.add.remote(k) for k in range(1, 11)],
                                   timeout=60)
finally:
    rt.shutdown()
print(json.dumps(out))
'''


def test_one_script_gives_equal_results_on_both_packages():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    env.pop(lockdep.ENV_VAR, None)
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-c", TWO_PACKAGE_SCRIPT, pkg], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("ray_tpu", "ray_tpu_torch")}
    results = {}
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{pkg}: {err[-3000:]}"
        results[pkg] = json.loads(out.strip().splitlines()[-1])
    assert results["ray_tpu"]["fanout"] == [i * i for i in range(16)]
    assert results["ray_tpu"]["error"] == ["RayTaskError", True]
    assert results["ray_tpu_torch"] == results["ray_tpu"]
