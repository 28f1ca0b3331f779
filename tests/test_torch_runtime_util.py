"""The observability functions the port's runtime calls, held to the JAX
package's on the same inputs: the task spans (`tracing.submit_span`,
`tracing.execute_span`), the async event report (`events.report_async`)
and the daemons' `/metrics` endpoint (`metrics.serve_metrics`). Ids,
times and pids differ from run to run and are compared by their links
only.
"""

import asyncio
import json
import os
from types import SimpleNamespace

from ray_tpu.util import events as jax_events
from ray_tpu.util import metrics as jax_metrics
from ray_tpu.util import tracing as jax_tracing
from ray_tpu_torch.util import events, metrics, tracing

PACKAGES = {"ray_tpu_torch": (tracing, events, metrics),
            "ray_tpu": (jax_tracing, jax_events, jax_metrics)}


def _task_spans(trace_mod, trace_dir, monkeypatch):
    monkeypatch.setenv("RAY_TPU_TRACE", "1")
    monkeypatch.setenv("RAY_TPU_TRACE_DIR", str(trace_dir))
    trace_mod._reset_writer()
    try:
        with trace_mod.submit_span("train_step", "NORMAL_TASK") as ctx:
            spec = SimpleNamespace(
                name="train_step", task_type="NORMAL_TASK", trace_ctx=ctx,
                task_id=SimpleNamespace(hex=lambda: "ab" * 16))
        with trace_mod.execute_span(spec):
            with trace_mod.span("inner", attrs={"k": 1}):
                pass
        monkeypatch.setenv("RAY_TPU_TRACE", "0")
        with trace_mod.submit_span("off", "NORMAL_TASK") as off_ctx:
            assert off_ctx is None
    finally:
        trace_mod._reset_writer()
    spans = trace_mod.collect(str(trace_dir))
    by_id = {s["span_id"]: s for s in spans}
    return [{
        "name": s["name"], "kind": s["kind"], "attrs": s["attrs"],
        "parent": by_id[s["parent_id"]]["name"] if s["parent_id"] else None,
        "same_trace": s["trace_id"] == spans[0]["trace_id"],
        "ordered": s["start"] <= s["end"],
    } for s in sorted(spans, key=lambda s: s["start"])]


def test_task_spans_match_the_jax_package(tmp_path, monkeypatch):
    got = {pkg: _task_spans(mods[0], tmp_path / pkg, monkeypatch)
           for pkg, mods in PACKAGES.items()}
    assert [s["name"] for s in got["ray_tpu"]] == [
        "train_step.remote", "train_step.execute", "inner"]
    assert got["ray_tpu"][1]["parent"] == "train_step.remote"
    assert got["ray_tpu_torch"] == got["ray_tpu"]


def test_report_async_matches_the_jax_package(tmp_path, monkeypatch):
    lines = {}
    for pkg, (_, ev_mod, _) in PACKAGES.items():
        monkeypatch.setenv("RAY_TPU_EVENT_DIR", str(tmp_path / pkg))
        ev_mod._reset_writers()
        ev = asyncio.run(ev_mod.report_async(
            "RAYLET", "WARNING", "WORKER_DIED", "worker process 7 exited",
            worker_id="00ff", pid_of_worker=7))
        ev_mod._reset_writers()
        (shard,) = os.listdir(tmp_path / pkg)
        with open(tmp_path / pkg / shard) as f:
            (line,) = f.read().splitlines()
        record = json.loads(line)
        assert record == ev
        lines[pkg] = {k: v for k, v in record.items() if k != "ts"}
    assert lines["ray_tpu"]["label"] == "WORKER_DIED"
    assert lines["ray_tpu_torch"] == lines["ray_tpu"]


async def _scrape(metrics_mod):
    reg = metrics_mod._Registry()
    c = metrics_mod.Counter("tasks_total", "tasks run", ("state",),
                            registry=reg)
    c.inc(3, tags={"state": "ok"})
    g = metrics_mod.Gauge("queue_depth", "queued leases", registry=reg)
    g.set(7)
    reg.register_callback("extra", lambda: "# TYPE pool_size gauge\n"
                                           "pool_size 2\n")
    server, port = await metrics_mod.serve_metrics(
        registry=reg, extra_text=lambda: "raylet_up 1\n")
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"GET /metrics HTTP/1.1\r\nHost: x\r\n\r\n")
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), timeout=10)
        writer.close()
    finally:
        server.close()
        await server.wait_closed()
    return raw.decode()


def test_serve_metrics_matches_the_jax_package():
    got = {pkg: asyncio.run(_scrape(mods[2]))
           for pkg, mods in PACKAGES.items()}
    head, body = got["ray_tpu"].split("\r\n\r\n", 1)
    assert head.startswith("HTTP/1.1 200 OK")
    assert 'tasks_total{state="ok"} 3' in body and body.endswith("# EOF\n")
    assert got["ray_tpu_torch"] == got["ray_tpu"]


def test_health_reads_the_ports_lockdep():
    """The watchdog's held-locks hook reads the port's own lockdep: off,
    nothing; armed, the lock a thread holds."""
    import threading

    from ray_tpu_torch._private import health, lockdep

    assert not lockdep.enabled()
    assert health._held_locks_by_thread() == {}
    lockdep.install(raise_on_cycle=False)
    try:
        lock = threading.Lock()
        with lock:
            held = health._held_locks_by_thread()
            mine = held.get(threading.get_ident(), [])
            assert len(mine) == 1 and "test_torch_runtime_util" in mine[0]
            stacks = health.dump_stacks()
            me = next(s for s in stacks
                      if s["ident"] == threading.get_ident())
            assert me["held_locks"] == mine
    finally:
        lockdep.uninstall()
