"""The port's operator CLI (`python -m ray_tpu_torch <verb>`,
`ray_tpu_torch/scripts/cli.py`), held to the JAX CLI's cases.

The CLI cases of `tests/test_observability.py` (status and list, memory,
serve status and shutdown), of `tests/test_slo.py` (stack and alerts
against a live cluster), of `tests/test_request_recorder.py` (requests)
and of `tests/test_step_profiler.py` (profile, the unified timeline),
plus: the offline verbs (`events`, `events --otlp`, `trace`, `profile`,
`requests`) run by both packages' CLIs on the same shards with equal
output; `serve-deploy` of a YAML config with HTTP on a free port and
`top` over it; `job submit --wait`; the `dashboard` and `client-server`
verbs; and a worker node joined by the exact command line that
`autoscaler/gcp_tpu.bootstrap_script` writes.

Every test tracks its daemons in its own state file
(`RAY_TPU_TORCH_CLI_STATE_FILE`), as the JAX cases do. The live-cluster
cases share one head started by the CLI for the module, and
`test_cli_status_and_list` starts and stops its own.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CLI = [sys.executable, "-m", "ray_tpu_torch"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_env(state_file, pythonpath=None) -> dict:
    env = dict(os.environ)
    env.pop("RAY_TPU_TORCH_ADDRESS", None)
    env["RAY_TPU_TORCH_CLI_STATE_FILE"] = str(state_file)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(p) for p in (pythonpath or [])] + [str(ROOT)])
    return env


def _run(args, env, timeout=300, check=True):
    out = subprocess.run(CLI + list(args), capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=timeout)
    if check:
        assert out.returncode == 0, \
            f"{args}: rc={out.returncode}\n{out.stdout[-2000:]}\n" \
            f"{out.stderr[-3000:]}"
    return out


def test_cli_status_and_list(tmp_path):
    """The operator CLI forms a standalone cluster, reports status, and
    tears it down."""
    env = _cli_env(tmp_path / "cli_node.json")
    out = _run(["start", "--head", "--port", "0", "--resources",
                '{"CPU": 2.0}'], env)
    assert "GCS started at" in out.stdout
    assert "RAY_TPU_TORCH_ADDRESS=" in out.stdout
    with open(env["RAY_TPU_TORCH_CLI_STATE_FILE"]) as f:
        state = json.load(f)
    gcs_addr = state["gcs_addr"]
    try:
        # a second start over a live tracked node refuses
        again = _run(["start", "--head", "--port", "0"], env, check=False)
        assert again.returncode != 0
        assert "node already running" in again.stderr
        status = _run(["status", "--address", gcs_addr], env)
        assert "1 alive node(s)" in status.stdout
        nodes = _run(["list", "nodes", "--address", gcs_addr], env)
        assert gcs_addr.split(":")[0] in nodes.stdout  # host appears
        assert json.loads(nodes.stdout.splitlines()[0])["Alive"]
    finally:
        stop = _run(["stop"], env, timeout=60)
    assert "stopped pid" in stop.stdout
    assert not os.path.exists(env["RAY_TPU_TORCH_CLI_STATE_FILE"])
    deadline = time.time() + 30
    while time.time() < deadline and any(
            _alive(p) for p in state["pids"]):
        time.sleep(0.2)
    assert not any(_alive(p) for p in state["pids"])


@pytest.mark.parametrize("host_env,gpus", [
    ({"NVIDIA_VISIBLE_DEVICES": "3"}, 1.0),
    ({"CUDA_VISIBLE_DEVICES": "0,1"}, 2.0),
], ids=["container-device-list", "cuda-visible-devices"])
def test_head_without_resources_detects_the_hosts_gpus(tmp_path, host_env,
                                                       gpus):
    """F14: a head started with no `--resources` counted no GPU, because
    its raylet runs with CUDA_VISIBLE_DEVICES="" (daemons touch no
    device) and its detection read that. It now counts the host's
    devices: a card in the container's device list, or the host's own
    CUDA_VISIBLE_DEVICES."""
    env = _cli_env(tmp_path / "cli_node.json")
    for key in ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES",
                "RAY_TPU_GPU_COUNT"):
        env.pop(key, None)
    env.update(host_env)
    _run(["start", "--head", "--port", "0"], env)
    try:
        with open(env["RAY_TPU_TORCH_CLI_STATE_FILE"]) as f:
            gcs_addr = json.load(f)["gcs_addr"]
        status = _run(["status", "--address", gcs_addr], env)
        assert f"'GPU': {gpus}" in status.stdout, status.stdout
    finally:
        _run(["stop"], env, timeout=60)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie of an exited daemon is gone for the operator's purposes
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


@pytest.fixture(scope="module")
def head(tmp_path_factory):
    """One CLI-started head (4 CPUs) for the live-cluster cases."""
    d = tmp_path_factory.mktemp("cli_head")
    env = _cli_env(d / "cli_node.json")
    _run(["start", "--head", "--port", "0", "--resources",
          '{"CPU": 4.0}'], env)
    with open(env["RAY_TPU_TORCH_CLI_STATE_FILE"]) as f:
        gcs_addr = json.load(f)["gcs_addr"]
    yield env, gcs_addr
    _run(["stop"], env, timeout=60, check=False)


def test_cli_memory(head):
    """`memory` reports per-node object-store usage and largest objects
    (reference `ray memory`'s primary-copy view)."""
    env, gcs_addr = head
    driver = (
        "import numpy as np\n"
        "import ray_tpu_torch\n"
        f"ray_tpu_torch.init(address={gcs_addr!r})\n"
        "refs = [ray_tpu_torch.put(np.ones(1 << 20, np.uint8))"
        " for _ in range(3)]\n"
        "import time; time.sleep(0.5)\n"
        "ray_tpu_torch.shutdown()\n")
    r = subprocess.run([sys.executable, "-c", driver], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr
    mem = _run(["memory", "--address", gcs_addr], env)
    assert "MB shm" in mem.stdout
    assert "primary copies" in mem.stdout


def test_cli_serve_status_and_shutdown(head):
    """`serve status` observes a live Serve instance without starting
    one, and `serve shutdown` stops it (reference serve CLI)."""
    env, gcs_addr = head
    st = _run(["serve", "status", "--address", gcs_addr], env)
    assert "no serve instance" in st.stdout

    driver = (
        "import ray_tpu_torch\n"
        "from ray_tpu_torch import serve\n"
        f"ray_tpu_torch.init(address={gcs_addr!r})\n"
        "@serve.deployment\n"
        "def echo(x):\n"
        "    return x\n"
        "serve.run(echo.bind())\n"
        "import time; time.sleep(30)\n")
    drv = subprocess.Popen([sys.executable, "-c", driver], env=env,
                           cwd=ROOT, stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            st = _run(["serve", "status", "--address", gcs_addr], env)
            if '"echo"' in st.stdout:
                break
            time.sleep(1)
        assert '"echo"' in st.stdout, st.stdout
        down = _run(["serve", "shutdown", "--address", gcs_addr], env)
        assert "shut down" in down.stdout
    finally:
        drv.terminate()
        drv.wait(timeout=30)
    st = _run(["serve", "status", "--address", gcs_addr], env)
    assert "no serve instance" in st.stdout


_APP_MODULE = '''
from ray_tpu_torch import serve


@serve.deployment
def echo(body=None):
    return {"echo": body}


app = echo.bind()
'''


def test_cli_serve_deploy_yaml_with_http_and_top(head, tmp_path):
    """`serve-deploy` reads a YAML config (the app's module on the CLI's
    `PYTHONPATH`), starts the controller and the HTTP proxy on the
    config's port, and the app answers over HTTP; `top` shows it; the
    instance outlives the CLI until `serve shutdown`."""
    env, gcs_addr = head
    (tmp_path / "cli_echo_app.py").write_text(_APP_MODULE)
    port = _free_port()
    (tmp_path / "serve.yaml").write_text(
        f"http_options:\n  port: {port}\n"
        "applications:\n"
        "  - name: echo\n"
        "    import_path: cli_echo_app:app\n"
        "    route_prefix: /echo\n"
        "    deployments:\n"
        "      - name: echo\n"
        "        num_replicas: 1\n")
    denv = dict(env, PYTHONPATH=f"{tmp_path}{os.pathsep}{env['PYTHONPATH']}")
    try:
        out = _run(["serve-deploy", str(tmp_path / "serve.yaml"),
                    "--address", gcs_addr], denv)
        assert "deployed applications: echo" in out.stdout
        req = urllib.request.Request(f"http://127.0.0.1:{port}/echo",
                                     data=b'{"k": 1}')
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.headers["Content-Type"] == \
                "application/json; charset=utf-8"
            assert json.loads(r.read()) == {"echo": {"k": 1}}
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=30)
        assert e.value.code == 404
        top = _run(["top", "--iterations", "2", "--interval", "0.2",
                    "--no-clear", "--address", gcs_addr], env)
        assert "deployment echo: 1 replicas" in top.stdout
        assert "[series=" in top.stdout
    finally:
        _run(["serve", "shutdown", "--address", gcs_addr], env)


_DETACHED_PARENT = r'''
import sys
import ray_tpu_torch


@ray_tpu_torch.remote
class Child:
    def ping(self):
        return "child"


@ray_tpu_torch.remote
class Keeper:
    def __init__(self):
        self.child = Child.remote()

    def child_ping(self):
        return ray_tpu_torch.get(self.child.ping.remote(), timeout=60)


ray_tpu_torch.init(address=sys.argv[1])
k = Keeper.options(name="keeper", lifetime="detached").remote()
print(ray_tpu_torch.get(k.child_ping.remote(), timeout=60))
ray_tpu_torch.shutdown()
'''


def test_detached_actor_and_its_children_outlive_their_job(head):
    """F13: the end of a job killed every actor it created and every
    worker of the job, the detached ones included, so `serve-deploy`'s
    controller and replicas died with the CLI. Now a detached actor and
    the actors it created survive their job; a later driver reaches both
    (and kills them)."""
    env, gcs_addr = head
    first = subprocess.run([sys.executable, "-c", _DETACHED_PARENT,
                            gcs_addr], capture_output=True, text=True,
                           env=env, cwd=ROOT, timeout=300)
    assert first.returncode == 0, first.stderr[-3000:]
    assert first.stdout.strip() == "child"
    later = (
        "import ray_tpu_torch\n"
        f"ray_tpu_torch.init(address={gcs_addr!r})\n"
        "k = ray_tpu_torch.get_actor('keeper')\n"
        "print(ray_tpu_torch.get(k.child_ping.remote(), timeout=60))\n"
        "ray_tpu_torch.kill(k)\n"
        "ray_tpu_torch.shutdown()\n")
    time.sleep(1.0)  # the first job's end has reached the raylet
    second = subprocess.run([sys.executable, "-c", later],
                            capture_output=True, text=True, env=env,
                            cwd=ROOT, timeout=300)
    assert second.returncode == 0, second.stderr[-3000:]
    assert second.stdout.strip() == "child"


def test_job_survivors_follow_an_owner_across_restarts():
    """F13's rule matches a child to its creator by the creator's worker
    in any incarnation, not its current address: a detached owner that
    is restarting (no address) or came back on a new worker still keeps
    the actors an earlier incarnation created, transitively; an actor
    the driver created does not survive."""
    from types import SimpleNamespace

    from ray_tpu_torch._private import gcs, task

    job = b"j" * 4

    def actor(owner, worker_ids, addr, detached=False):
        spec = task.TaskSpec(task_id=b"t", job_id=job, name="A",
                             owner_worker_id=owner)
        return {"job_id": job, "state": gcs.ALIVE, "addr": addr,
                "detached": detached, "worker_ids": worker_ids,
                "spec": spec.to_wire()}

    actors = {
        # restarting: its first worker w1 created `child`
        b"keeper": actor(b"driver", [b"w1"], None, detached=True),
        b"child": actor(b"w1", [b"w2"], "h:2"),
        b"grandchild": actor(b"w2", [b"w3"], "h:3"),
        # came back on w5; its first worker w4 created `late`
        b"moved": actor(b"driver", [b"w4", b"w5"], "h:5", detached=True),
        b"late": actor(b"w4", [b"w6"], "h:6"),
        b"driver_own": actor(b"driver", [b"w7"], "h:7"),
    }
    fake = SimpleNamespace(actors=actors)
    assert gcs.GcsServer._job_survivors(fake, job) == {
        b"keeper", b"child", b"grandchild", b"moved", b"late"}


def test_cli_job_submit_wait(head, tmp_path):
    """`job submit --wait` runs an entrypoint as a cluster-hosted job,
    waits for it and prints its status and logs."""
    env, gcs_addr = head
    script = tmp_path / "job.py"
    script.write_text(
        "import ray_tpu_torch\n"
        "ray_tpu_torch.init()\n"
        "@ray_tpu_torch.remote\n"
        "def sq(x):\n"
        "    return x * x\n"
        "print('job result', ray_tpu_torch.get(sq.remote(7)))\n")
    # the entrypoint next to `submit`: Python 3.12.3's argparse (the
    # card host's) takes it nowhere after the subcommand's options
    out = _run(["job", "submit", sys.executable, str(script), "--wait",
                "--address", gcs_addr], env)
    lines = out.stdout.splitlines()
    assert lines[0].startswith("job-")
    assert "SUCCEEDED" in out.stdout
    assert "job result 49" in out.stdout
    listed = _run(["job", "list", "--address", gcs_addr], env)
    assert lines[0].strip() in listed.stdout


def test_cli_stack_and_alerts_against_live_cluster(head):
    """`stack` aggregates the dump_stacks RPC across a live cluster —
    even a one-node cluster yields ≥3 distinct processes (gcs, raylet,
    cli) — and `alerts` evaluates the default rule pack over live
    scrapes: a healthy idle cluster reports 0 firing."""
    env, gcs_addr = head
    stack = _run(["stack", "--json", "--address", gcs_addr], env)
    reports = [r for r in json.loads(stack.stdout) if "error" not in r]
    assert len({r["pid"] for r in reports}) >= 3
    assert {"gcs", "raylet", "cli"} <= {r["role"] for r in reports}
    for r in reports:
        assert r["threads"] and all(t["stack"] for t in r["threads"])

    text = _run(["stack", "--address", gcs_addr], env)
    assert "==== gcs" in text.stdout
    assert "==== raylet" in text.stdout
    assert "processes," in text.stdout  # summary line

    alerts = _run(["alerts", "--scrapes", "2", "--interval", "0.2",
                   "--address", gcs_addr], env)
    assert "0 firing" in alerts.stdout
    assert "DEGRADED" not in alerts.stdout
    snap = json.loads(_run(["alerts", "--scrapes", "2", "--interval", "0.2",
                            "--json", "--address", gcs_addr], env).stdout)
    assert snap["firing"] == [] and snap["alerts"]


def test_worker_joins_by_the_bootstrap_command_line(head, tmp_path):
    """A host booted from `gcp_tpu.bootstrap_script` joins: its command
    line, run as written, starts a raylet that registers with the
    autoscaler's instance label; `status` counts two nodes."""
    from ray_tpu_torch.autoscaler import gcp_tpu

    env, gcs_addr = head
    script = gcp_tpu.bootstrap_script(gcs_addr, "qr-test-7")
    wenv = dict(env, RAY_TPU_TORCH_CLI_STATE_FILE=str(tmp_path / "w.json"))
    out = subprocess.run(["bash", "-c", script], capture_output=True,
                         text=True, env=wenv, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "raylet started" in out.stdout
    try:
        status = _run(["status", "--address", gcs_addr], env)
        assert "2 alive node(s)" in status.stdout
        driver = (
            "import json, ray_tpu_torch\n"
            f"ray_tpu_torch.init(address={gcs_addr!r})\n"
            "from ray_tpu_torch._private.worker_api import _require_state\n"
            "cw = _require_state().core_worker\n"
            "nodes = cw._run_sync(cw.gcs.call('get_nodes', {}))\n"
            "print(json.dumps([n.get('labels') or {} for n in nodes]))\n"
            "ray_tpu_torch.shutdown()\n")
        r = subprocess.run([sys.executable, "-c", driver],
                           capture_output=True, text=True, env=env,
                           cwd=ROOT, timeout=300)
        assert r.returncode == 0, r.stderr
        labels = json.loads(r.stdout.strip().splitlines()[-1])
        assert {gcp_tpu.INSTANCE_LABEL: "qr-test-7"} in labels
    finally:
        _run(["stop"], wenv, timeout=60)
    deadline = time.time() + 30
    while time.time() < deadline:
        if "1 alive node(s)" in _run(["status", "--address", gcs_addr],
                                     env).stdout:
            break
        time.sleep(1)
    else:
        raise AssertionError("the worker node never left")


def test_cli_dashboard_and_client_server_verbs(head):
    """`dashboard` serves the cluster from its own process until SIGTERM;
    `client-server` prints its ready line and serves a `client://`
    driver."""
    env, gcs_addr = head
    env = dict(env)
    env.pop("PYTHONUNBUFFERED", None)  # the ready lines are flushed
    port = _free_port()
    dash = subprocess.Popen(
        CLI + ["dashboard", "--address", gcs_addr, "--port", str(port)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    server = subprocess.Popen(
        CLI + ["client-server", "--address", gcs_addr, "--port", "0"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        assert dash.stdout.readline().startswith(
            f"dashboard at http://127.0.0.1:{port}")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/nodes",
                                    timeout=60) as r:
            assert json.loads(r.read())[0]["Alive"]
        line = server.stdout.readline()
        assert line.startswith("CLIENT_SERVER_READY"), line
        addr = line.split()[1]
        driver = (
            "import ray_tpu_torch\n"
            f"ray_tpu_torch.init(address='client://{addr}')\n"
            "@ray_tpu_torch.remote\n"
            "def f(x):\n"
            "    return x + 1\n"
            "print(ray_tpu_torch.get(f.remote(41)))\n"
            "ray_tpu_torch.shutdown()\n")
        r = subprocess.run([sys.executable, "-c", driver],
                           capture_output=True, text=True, env=env,
                           cwd=ROOT, timeout=300)
        assert r.returncode == 0, r.stderr
        assert r.stdout.strip() == "42"
    finally:
        for proc in (dash, server):
            proc.send_signal(signal.SIGTERM)
        for proc in (dash, server):
            proc.wait(timeout=30)
    assert dash.returncode is not None and server.returncode is not None


# -- offline verbs ------------------------------------------------------------


def _traced_env(monkeypatch, trace_dir):
    monkeypatch.setenv("RAY_TPU_TRACE", "1")
    monkeypatch.setenv("RAY_TPU_TRACE_DIR", str(trace_dir))


def test_cli_requests_offline(tmp_path, capsys, monkeypatch):
    from ray_tpu_torch.scripts.cli import main
    from ray_tpu_torch.util import request_recorder as rr

    trace_dir = tmp_path / "traces"
    _traced_env(monkeypatch, trace_dir)
    rr._reset_shard_writer()
    try:
        for i in range(5):
            ctx = rr.new_context("chat", job="tenant-a")
            rr.record_engine(ctx, ts=float(i),
                             total_ms=10.0 * (i + 1),
                             prefill_ms=6.0 * (i + 1),
                             decode_ms=4.0 * (i + 1),
                             ttft_ms=7.0, tpot_ms=1.5, tokens_out=4)
    finally:
        monkeypatch.delenv("RAY_TPU_TRACE")
        rr._reset_shard_writer()

    main(["requests", "--trace-dir", str(trace_dir), "--last", "3"])
    out = capsys.readouterr().out
    assert "phase attribution" in out
    assert "chat" in out and "tenant-a" in out

    main(["requests", "--trace-dir", str(trace_dir), "--slow", "2",
          "--json"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert len(lines) == 2
    assert json.loads(lines[0])["total_ms"] == 50.0  # worst first


def test_cli_profile_prints_step_table(tmp_path, capsys, monkeypatch):
    from ray_tpu_torch.scripts.cli import main
    from ray_tpu_torch.util import step_profiler as sp

    trace_dir = tmp_path / "traces"
    _traced_env(monkeypatch, trace_dir)
    sp._reset_shard_writer()
    try:
        for i in range(5):
            sp.record_step(i + 1, 10.0 + i, host_dispatch_ms=1.0,
                           device_execute_ms=7.0, tokens=32,
                           flops=1e9, peak=1e12)
    finally:
        monkeypatch.delenv("RAY_TPU_TRACE")
        sp._reset_shard_writer()

    main(["profile", "--trace-dir", str(trace_dir), "--last", "3"])
    out = capsys.readouterr().out
    assert "MFU" in out and "time attribution" in out
    assert f"{'5':>8}" in out  # newest step present
    main(["profile", "--trace-dir", str(trace_dir), "--json", "--last",
          "2"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert len(lines) == 2
    assert json.loads(lines[-1])["step"] == 5


def test_cli_timeline_unified_offline(tmp_path, capsys, monkeypatch):
    from ray_tpu_torch.scripts.cli import main
    from ray_tpu_torch.util import step_profiler as sp
    from ray_tpu_torch.util import tracing

    trace_dir = tmp_path / "traces"
    _traced_env(monkeypatch, trace_dir)
    monkeypatch.delenv("RAY_TPU_TORCH_ADDRESS", raising=False)
    # an empty state file: a stale machine-wide one must not make
    # --unified try a dead GCS
    monkeypatch.setenv("RAY_TPU_TORCH_CLI_STATE_FILE",
                       str(tmp_path / "none.json"))
    tracing._reset_writer()
    sp._reset_shard_writer()
    try:
        with tracing.span("work"):
            pass
        sp.record_step(1, 3.0)
        monkeypatch.delenv("RAY_TPU_TRACE")
        out_file = str(tmp_path / "unified.json")
        main(["timeline", "--unified", "--trace-dir", str(trace_dir),
              "--output", out_file])
        assert "step records" in capsys.readouterr().out
        events = json.load(open(out_file))
        assert any(e.get("cat") == "train_step" for e in events)
        assert any(e["name"] == "work" for e in events)
    finally:
        tracing._reset_writer()
        sp._reset_shard_writer()


_WRITE_SHARDS = r'''
import sys
from ray_tpu_torch.util import events, request_recorder as rr
from ray_tpu_torch.util import step_profiler as sp, tracing

for i in range(4):
    sp.record_step(i + 1, 10.0 + i, host_dispatch_ms=1.0,
                   device_execute_ms=7.0, tokens=32, flops=1e9, peak=1e12)
for i in range(3):
    ctx = rr.new_context("chat", job="tenant-b")
    rr.record_engine(ctx, ts=float(i), total_ms=10.0 * (i + 1),
                     prefill_ms=6.0, decode_ms=4.0, ttft_ms=7.0,
                     tpot_ms=1.5, tokens_out=4)
with tracing.span("outer"):
    with tracing.span("inner"):
        pass
events.report("GCS", "INFO", "NODE_ADDED", "node n1 joined", node_id="n1")
events.report("RAYLET", "WARNING", "WORKER_DIED", "worker 7 exited", pid=7)
'''


def test_offline_verbs_print_as_the_jax_cli(tmp_path):
    """`profile`, `requests`, `events`, `events --otlp` and `trace` read
    the same shards (written by the port's recorders, whose shard format
    is the JAX package's) and print the same text on both packages'
    CLIs; the OTLP payloads differ only in the package's service and
    scope names."""
    trace_dir, event_dir = tmp_path / "traces", tmp_path / "events"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               RAY_TPU_TRACE="1", RAY_TPU_TRACE_DIR=str(trace_dir),
               RAY_TPU_EVENT_DIR=str(event_dir))
    w = subprocess.run([sys.executable, "-c", _WRITE_SHARDS], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert w.returncode == 0, w.stderr
    env.pop("RAY_TPU_TRACE")
    verbs = [["profile", "--trace-dir", str(trace_dir)],
             ["profile", "--trace-dir", str(trace_dir), "--json"],
             ["requests", "--trace-dir", str(trace_dir)],
             ["requests", "--trace-dir", str(trace_dir), "--json"],
             ["events"], ["events", "--source", "GCS"]]
    outs = {}
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        outs[pkg] = []
        for verb in verbs + [
                ["events", "--otlp", str(tmp_path / f"{pkg}.json")],
                ["trace", "--trace-dir", str(trace_dir), "--output",
                 str(tmp_path / f"{pkg}.trace")]]:
            r = subprocess.run([sys.executable, "-m", pkg] + verb, env=env,
                               cwd=ROOT, capture_output=True, text=True,
                               timeout=120)
            assert r.returncode == 0, f"{pkg} {verb}: {r.stderr[-2000:]}"
            outs[pkg].append(r.stdout.replace(pkg, "PKG"))
    assert "chat" in outs["ray_tpu"][2] and "tenant-b" in outs["ray_tpu"][2]
    assert "NODE_ADDED" in outs["ray_tpu"][4]
    assert "WORKER_DIED" not in outs["ray_tpu"][5]
    assert "wrote 2 OTLP log records" in outs["ray_tpu"][6]
    assert "merged 2 spans" in outs["ray_tpu"][7]
    assert outs["ray_tpu_torch"] == outs["ray_tpu"]
    otlp = {pkg: (tmp_path / f"{pkg}.json").read_text()
            .replace(f'"{pkg}.', '"PKG.') for pkg in outs}
    assert otlp["ray_tpu_torch"] == otlp["ray_tpu"]
    traces = {pkg: sorted(e["name"] for e in json.loads(
        (tmp_path / f"{pkg}.trace").read_text())) for pkg in outs}
    assert {"inner", "outer"} <= set(traces["ray_tpu"])
    assert traces["ray_tpu_torch"] == traces["ray_tpu"]
