"""The port's dashboard (`ray_tpu_torch.dashboard`) and timeline, held
to `tests/test_dashboard.py` and to the JAX dashboard.

The scenarios of `test_dashboard.py` run on the port against one
module-scoped cluster, the dashboard on a free port (the JAX file's
18265 may be taken by its own cluster in another test worker). One
script then runs on both packages in two subprocesses: the same tasks,
actor and step record, then a GET of every one of the 17 routes. Each
route must give the same status, `Content-Type` and JSON keys on both;
values are compared where they are deterministic (actor names, task
summary counts, cluster resources, the `/` page's fetch list, the empty
panels).
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

import ray_tpu_torch

ROOT = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", autouse=True)
def cluster():
    ray_tpu_torch.init(num_cpus=2, num_gpus=0,
                       object_store_memory=128 * 1024 * 1024)
    yield
    ray_tpu_torch.shutdown()


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
    loaded = json.loads(out.read_text())
    assert isinstance(loaded, list) and loaded


def test_dashboard_rest_and_html():
    from ray_tpu_torch.dashboard import start_dashboard

    @ray_tpu_torch.remote
    class Visible:
        def ping(self):
            return 1

    v = Visible.options(name="dash_actor").remote()
    ray_tpu_torch.get(v.ping.remote())

    port = _free_port()
    dash = start_dashboard(port=port)
    assert dash.ready() == {"host": "127.0.0.1", "port": port}
    base = f"http://127.0.0.1:{port}"

    html = urllib.request.urlopen(base + "/", timeout=30).read().decode()
    assert "ray_tpu_torch" in html

    nodes = json.loads(urllib.request.urlopen(
        base + "/api/nodes", timeout=30).read())
    assert any(n["Alive"] for n in nodes)

    actors = json.loads(urllib.request.urlopen(
        base + "/api/actors", timeout=30).read())
    assert any(a["name"] == "dash_actor" for a in actors)

    res = json.loads(urllib.request.urlopen(
        base + "/api/cluster_resources", timeout=30).read())
    assert res["total"].get("CPU", 0) >= 2

    tl = json.loads(urllib.request.urlopen(
        base + "/api/timeline", timeout=30).read())
    assert isinstance(tl, list)

    jobs = json.loads(urllib.request.urlopen(
        base + "/api/jobs", timeout=30).read())
    assert len(jobs) >= 1  # this driver's job
    assert all(not jb["finished"] or jb["end_time"] for jb in jobs)

    events = json.loads(urllib.request.urlopen(
        base + "/api/events", timeout=30).read())
    assert isinstance(events, list)

    from ray_tpu_torch.util import step_profiler

    step_profiler.record_step(7, 11.0, host_dispatch_ms=2.0)
    try:
        steps = json.loads(urllib.request.urlopen(
            base + "/api/steps", timeout=30).read())
        assert any(r["step"] == 7 for r in steps["records"])
        assert "attribution" in steps and "summary" in steps
    finally:
        step_profiler.clear()

    # the router's own answers: an unknown path, a method it lacks
    for path, method, code in (("/api/nope", "GET", 404),
                               ("/api/nodes", "POST", 405)):
        req = urllib.request.Request(base + path, method=method,
                                     data=b"" if method == "POST" else None)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == code
    ray_tpu_torch.kill(v)


def test_a_panel_that_raises_answers_500(monkeypatch):
    from ray_tpu_torch.dashboard import start_dashboard
    from ray_tpu_torch.util import state as state_api

    def broken():
        raise RuntimeError("panel failed")

    monkeypatch.setattr(state_api, "list_tasks", broken)
    port = _free_port()
    start_dashboard(port=port)
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/api/tasks",
                               timeout=30)
    assert e.value.code == 500
    assert e.value.headers["Content-Type"] == \
        "application/json; charset=utf-8"
    assert json.loads(e.value.read()) == {"error": "panel failed"}
    # the other panels still answer
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/nodes",
                                timeout=30) as r:
        assert json.loads(r.read())[0]["Alive"]


ROUTES = ("/", "/api/nodes", "/api/actors", "/api/tasks", "/api/objects",
          "/api/task_summary", "/api/timeline", "/api/cluster_resources",
          "/api/cluster_load", "/api/jobs", "/api/events", "/api/steps",
          "/api/serve_llm", "/api/timeseries", "/api/alerts",
          "/api/requests", "/api/recovery")

TWO_PACKAGE_DASHBOARD = r'''
import importlib, json, re, socket, sys, time, urllib.request

pkg = sys.argv[1]
routes = json.loads(sys.argv[2])
rt = importlib.import_module(pkg)
dashboard = importlib.import_module(pkg + ".dashboard")
step_profiler = importlib.import_module(pkg + ".util.step_profiler")

with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]


@rt.remote
def traced(x):
    time.sleep(0.05)
    return x


@rt.remote
class Visible:
    def ping(self):
        return 1


def keys(value):
    """The JSON shape: a dict's sorted keys, a list's element keys."""
    if isinstance(value, dict):
        return sorted(value)
    if isinstance(value, list):
        return sorted({k for v in value if isinstance(v, dict) for k in v})
    return type(value).__name__


kw = {"num_tpus": 0} if pkg == "ray_tpu" else {"num_gpus": 0}
rt.init(num_cpus=2, object_store_memory=128 << 20, **kw)
out = {}
try:
    rt.get([traced.remote(i) for i in range(3)])
    v = Visible.options(name="dash_actor").remote()
    rt.get(v.ping.remote())
    step_profiler.record_step(7, 11.0, host_dispatch_ms=2.0)
    time.sleep(1.5)  # task events flush
    dashboard.start_dashboard(port=port)
    for route in routes:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=60) as r:
            status, ctype, body = r.status, r.headers["Content-Type"], r.read()
        rec = {"status": status, "content_type": ctype}
        if route == "/":
            rec["fetches"] = re.findall(r"fetch\('([^']+)'\)", body.decode())
        else:
            value = json.loads(body)
            rec["keys"] = keys(value)
            if route == "/api/events":
                # the lifecycle events' shape; a loaded host may add a
                # watchdog's stall events to either cluster's log
                rec["keys"] = keys([e for e in value
                                    if e.get("label") == "NODE_ADDED"])
            elif route == "/api/actors":
                rec["names"] = sorted(a["name"] or "" for a in value)
            elif route == "/api/task_summary":
                rec["value"] = value
            elif route == "/api/cluster_resources":
                rec["value"] = {side: {k.replace("TPU", "ACCEL")
                                            .replace("GPU", "ACCEL"): n
                                       for k, n in res.items()}
                                for side, res in value.items()}
            elif route == "/api/steps":
                rec["steps"] = [r["step"] for r in value["records"]]
                rec["record_keys"] = keys(value["records"])
            elif route in ("/api/serve_llm", "/api/requests"):
                rec["value"] = value
            elif route == "/api/alerts":
                rec["rules"] = sorted(a["rule"] for a in value["alerts"])
        out[route] = rec
finally:
    rt.shutdown()
print(json.dumps(out))
'''


def test_every_route_answers_as_the_jax_dashboard(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    # each cluster's own event log: the default directory is shared by
    # every cluster on the machine
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-c", TWO_PACKAGE_DASHBOARD, pkg,
         json.dumps(ROUTES)], cwd=ROOT,
        env=dict(env, RAY_TPU_EVENT_DIR=str(tmp_path / pkg)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("ray_tpu", "ray_tpu_torch")}
    results = {}
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{pkg}: {err[-3000:]}"
        results[pkg] = json.loads(out.strip().splitlines()[-1])
    jax, port = results["ray_tpu"], results["ray_tpu_torch"]
    assert list(jax) == list(ROUTES) and len(ROUTES) == 17
    assert all(rec["status"] == 200 for rec in jax.values())
    assert jax["/"]["fetches"][0] == "/api/nodes"
    assert jax["/api/actors"]["names"] == ["dash_actor"]
    assert jax["/api/task_summary"]["value"]["traced"]
    assert jax["/api/steps"]["steps"] == [7]
    assert "label" in jax["/api/events"]["keys"]
    for route in ROUTES:
        assert port[route] == jax[route], route
