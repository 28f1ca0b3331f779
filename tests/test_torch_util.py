"""The port's operator utilities (`ray_tpu_torch.util`): the scenarios of
`tests/test_util.py` (ActorPool, the distributed Queue, the
multiprocessing Pool) and the state checks of
`tests/test_observability.py::test_task_events_and_state_api` and
`::test_list_actors_and_objects` on one module-scoped port cluster;
`timeline()` held to `tests/test_dashboard.py::test_timeline_chrome_trace`.
Then one script runs the same work and state queries against both
packages in two subprocesses at once, and their JSON results must be
equal: the pool's and queue's values, the task table's states and
summaries, the keys of every state API record, and the keys of each
timeline event.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.util import state as state_api
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.queue import Empty, Queue

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def cluster():
    ray_tpu_torch.init(num_cpus=4, object_store_memory=128 * 1024 * 1024)
    yield
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class Doubler:
    def double(self, x):
        return 2 * x


def test_actor_pool_map_ordered():
    pool = ActorPool([Doubler.remote() for _ in range(2)])
    out = list(pool.map(lambda a, v: a.double.remote(v), range(6)))
    assert out == [0, 2, 4, 6, 8, 10]


def test_actor_pool_map_unordered():
    pool = ActorPool([Doubler.remote() for _ in range(2)])
    out = list(pool.map_unordered(
        lambda a, v: a.double.remote(v), range(6)))
    assert sorted(out) == [0, 2, 4, 6, 8, 10]


def test_actor_pool_submit_get_next():
    pool = ActorPool([Doubler.remote()])
    pool.submit(lambda a, v: a.double.remote(v), 10)
    pool.submit(lambda a, v: a.double.remote(v), 20)  # queues
    assert pool.has_next()
    assert pool.get_next(timeout=30) == 20
    assert pool.get_next(timeout=30) == 40
    assert not pool.has_next()


def test_queue_roundtrip():
    q = Queue(maxsize=4)
    q.put("a")
    q.put_many(["b", "c"])
    assert q.qsize() == 3
    assert q.get() == "a"
    assert q.get() == "b"
    assert q.get() == "c"
    assert q.empty()
    with pytest.raises(Empty):
        q.get_nowait()
    q.shutdown()


def test_queue_blocking_get_across_callers():
    q = Queue()
    got = []

    def consumer():
        got.append(q.get(timeout=30))

    t = threading.Thread(target=consumer)
    t.start()
    time.sleep(0.3)
    q.put("handoff")
    t.join(timeout=30)
    assert got == ["handoff"]
    q.shutdown()


def test_multiprocessing_pool():
    """The stdlib surface over the port's actors."""
    from ray_tpu_torch.util.multiprocessing import Pool

    with Pool(processes=2) as pool:
        assert pool.map(lambda x: x * x, range(10), chunksize=3) == [
            x * x for x in range(10)]
        assert pool.starmap(lambda a, b: a + b,
                            [(1, 2), (3, 4)]) == [3, 7]
        assert pool.apply(lambda a, k=0: a + k, (5,), {"k": 2}) == 7
        ar = pool.apply_async(lambda: "ok")
        assert ar.get(timeout=60) == "ok"
        assert ar.successful()
        assert list(pool.imap(lambda x: x + 1, range(6),
                              chunksize=2)) == [1, 2, 3, 4, 5, 6]
        assert sorted(pool.imap_unordered(
            lambda x: x * 2, range(6), chunksize=2)) == [
                0, 2, 4, 6, 8, 10]
        mr = pool.map_async(lambda x: -x, range(4))
        mr.wait(timeout=60)
        assert mr.ready() and mr.get() == [0, -1, -2, -3]
        pool.close()
        pool.join()


def test_task_events_and_state_api():
    @ray_tpu_torch.remote
    def tracked(x):
        return x + 1

    @ray_tpu_torch.remote
    def exploder():
        raise ValueError("boom")

    assert ray_tpu_torch.get(tracked.remote(1)) == 2
    with pytest.raises(ray_tpu_torch.RayTaskError):
        ray_tpu_torch.get(exploder.remote())

    deadline = time.monotonic() + 10
    tasks = []
    while time.monotonic() < deadline:
        tasks = state_api.list_tasks()
        names = {t["name"]: t["state"] for t in tasks}
        if names.get("tracked") == "FINISHED" and \
                names.get("exploder") == "FAILED":
            break
        time.sleep(0.5)
    names = {t["name"]: t["state"] for t in tasks}
    assert names.get("tracked") == "FINISHED"
    assert names.get("exploder") == "FAILED"
    rec = next(t for t in tasks if t["name"] == "tracked")
    states = [s for s, _ in rec["events"]]
    assert "SUBMITTED" in states and "FINISHED" in states

    summary = state_api.summarize_tasks()
    assert summary["tracked"]["FINISHED"] >= 1


def test_list_actors_and_objects():
    @ray_tpu_torch.remote
    class Holder:
        def ping(self):
            return 1

    h = Holder.options(name="state_holder").remote()
    ray_tpu_torch.get(h.ping.remote())
    actors = state_api.list_actors()
    assert any(a["name"] == "state_holder" and a["state"] == "ALIVE"
               for a in actors)

    ref = ray_tpu_torch.put(np.ones(500_000, np.uint8))  # plasma + pinned
    time.sleep(0.3)
    objs = state_api.list_objects()
    assert any(o["object_id"] == ref.hex() for o in objs)
    del ref
    ray_tpu_torch.kill(h)


def test_timeline_chrome_trace(tmp_path):
    from ray_tpu_torch.util.timeline import timeline

    @ray_tpu_torch.remote
    def traced(x):
        time.sleep(0.05)
        return x

    ray_tpu_torch.get([traced.remote(i) for i in range(3)])
    time.sleep(1.5)  # event flush

    out = tmp_path / "trace.json"
    events = timeline(str(out))
    traced_events = [e for e in events if e["name"] == "traced"]
    assert len(traced_events) >= 3
    for e in traced_events:
        assert e["ph"] == "X"
        assert e["dur"] >= 0.04 * 1e6  # spans the 50ms body
        assert e["pid"] == "ray_tpu_torch"
    loaded = json.loads(out.read_text())
    assert isinstance(loaded, list) and loaded


# One script, run once against each package in its own process: the same
# actor pool, queue and pool work, then the state API and the timeline.
TWO_PACKAGE_SCRIPT = r'''
import importlib, json, sys, time
import numpy as np
pkg = sys.argv[1]
rt = importlib.import_module(pkg)
state = importlib.import_module(pkg + ".util.state")
timeline_mod = importlib.import_module(pkg + ".util.timeline")
ActorPool = importlib.import_module(pkg + ".util.actor_pool").ActorPool
Queue = importlib.import_module(pkg + ".util.queue").Queue
Pool = importlib.import_module(pkg + ".util.multiprocessing").Pool
gpus = {"num_gpus": 0} if pkg == "ray_tpu_torch" else {"num_tpus": 0}
rt.init(num_cpus=4, object_store_memory=128 << 20, **gpus)
out = {}
try:
    @rt.remote
    class Doubler:
        def double(self, x):
            return 2 * x

    pool = ActorPool([Doubler.remote() for _ in range(2)])
    out["pool_map"] = list(pool.map(lambda a, v: a.double.remote(v),
                                    range(6)))
    q = Queue(maxsize=4)
    q.put_many(["a", "b", "c"])
    out["queue"] = [q.qsize(), q.get(), q.get(), q.get(), q.empty()]
    q.shutdown()
    with Pool(processes=2) as mp:
        out["mp_map"] = mp.map(lambda x: x * x, range(10), chunksize=3)
        out["mp_starmap"] = mp.starmap(lambda a, b: a + b, [(1, 2), (3, 4)])

    @rt.remote
    def tracked(x):
        time.sleep(0.05)
        return x + 1

    @rt.remote
    def exploder():
        raise ValueError("boom")

    out["tracked"] = rt.get([tracked.remote(i) for i in range(3)])
    try:
        rt.get(exploder.remote())
    except rt.RayTaskError:
        out["exploder"] = "RayTaskError"

    @rt.remote
    class Holder:
        def ping(self):
            return 1

    h = Holder.options(name="state_holder").remote()
    rt.get(h.ping.remote())
    ref = rt.put(np.ones(500_000, np.uint8))
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        summary = state.summarize_tasks()
        if summary.get("tracked", {}).get("FINISHED") == 3 and \
                summary.get("exploder", {}).get("FAILED") == 1:
            break
        time.sleep(0.3)
    out["summary"] = {k: summary[k] for k in ("tracked", "exploder")}
    tasks = state.list_tasks()
    out["task_keys"] = sorted(tasks[0])
    rec = next(t for t in tasks if t["name"] == "tracked")
    out["tracked_states"] = sorted({s for s, _ in rec["events"]})
    actors = [a for a in state.list_actors() if a["name"] == "state_holder"]
    out["actor"] = [sorted(actors[0]), actors[0]["state"],
                    actors[0]["class_name"]]
    objs = state.list_objects()
    out["object_listed"] = any(o["object_id"] == ref.hex() for o in objs)
    out["object_keys"] = sorted(next(o for o in objs
                                     if o["object_id"] == ref.hex()))
    out["node_keys"] = sorted(state.list_nodes()[0])
    out["store_keys"] = sorted(state.store_stats()[0])
    out["job_keys"] = sorted(state.list_jobs()[0])
    events = [e for e in timeline_mod.timeline()
              if e["name"] == "tracked"]
    out["timeline"] = [len(events), sorted(events[0]),
                       sorted(events[0]["args"]), events[0]["ph"],
                       events[0]["cat"], events[0]["tid"],
                       all(e["dur"] >= 0.04e6 for e in events)]
    unified = timeline_mod.unified_timeline(include_tasks=True)
    out["unified_has_tasks"] = any(e.get("name") == "tracked"
                                   for e in unified)
    rt.kill(h)
finally:
    rt.shutdown()
print(json.dumps(out, sort_keys=True))
'''


def test_one_script_gives_equal_results_on_both_packages():
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
    assert want["pool_map"] == [0, 2, 4, 6, 8, 10]
    assert want["summary"] == {"tracked": {"FINISHED": 3},
                               "exploder": {"FAILED": 1}}
    assert want["object_listed"] and want["unified_has_tasks"]
    assert want["timeline"][0] == 3 and want["timeline"][-1]
    assert results["ray_tpu_torch"] == want
