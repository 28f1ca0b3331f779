"""The port's Ray Client (`ray_tpu_torch.util.client`): a thin driver
proxied through a ClientServer, held to `tests/test_client.py`.

The 8 scenarios of that file run on the port (a `Cluster` and a
`python -m ray_tpu_torch client-server` subprocess), plus a CPU tensor
round trip through the relay (put/get, a task argument, a task result,
bf16 included). One driver script then runs through `client://` on
both packages in two subprocesses, each against its own cluster and
client server, and the two JSON results must be equal.
"""

import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.node import Cluster


@pytest.fixture(scope="module")
def client_cluster():
    cluster = Cluster(head_resources={"CPU": 4.0, "GPU": 0.0},
                      object_store_memory=128 * 1024 * 1024)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "client-server",
         "--address", cluster.gcs_addr, "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    addr = None
    deadline = time.time() + 60
    while time.time() < deadline:
        line = proc.stdout.readline()
        if line.startswith("CLIENT_SERVER_READY"):
            addr = line.split()[1]
            break
    assert addr, "client server never became ready"
    yield addr
    proc.terminate()
    proc.wait(timeout=10)
    cluster.shutdown()


@pytest.fixture
def client(client_cluster):
    ray_tpu_torch.init(address=f"client://{client_cluster}")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_client_objects_tasks_actors(client):
    import numpy as np

    assert ray_tpu_torch.is_initialized()

    # objects: put/get roundtrip incl. numpy payloads
    ref = ray_tpu_torch.put({"a": np.arange(5)})
    out = ray_tpu_torch.get(ref)
    np.testing.assert_array_equal(out["a"], np.arange(5))

    # tasks: args, kwargs, ref args, multiple returns
    @ray_tpu_torch.remote
    def add(x, y=0):
        return x + y

    assert ray_tpu_torch.get(add.remote(1, y=2)) == 3
    assert ray_tpu_torch.get(add.remote(ray_tpu_torch.put(10), y=5)) == 15

    @ray_tpu_torch.remote(num_returns=2)
    def pair():
        return "a", "b"

    r1, r2 = pair.remote()
    assert ray_tpu_torch.get([r1, r2]) == ["a", "b"]

    # wait
    refs = [add.remote(i) for i in range(4)]
    ready, not_ready = ray_tpu_torch.wait(refs, num_returns=4, timeout=60)
    assert len(ready) == 4 and not not_ready

    # actors: create, method calls, state, named lookup, kill
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

    c = Counter.options(name="client-counter").remote(100)
    assert ray_tpu_torch.get(c.inc.remote()) == 101
    assert ray_tpu_torch.get(c.inc.remote(9)) == 110

    c2 = ray_tpu_torch.get_actor("client-counter")
    assert ray_tpu_torch.get(c2.inc.remote()) == 111
    ray_tpu_torch.kill(c)

    # cluster introspection proxied
    res = ray_tpu_torch.cluster_resources()
    assert res.get("CPU", 0) >= 4.0


def test_client_task_error_propagates(client):
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("kaboom")

    with pytest.raises(Exception, match="kaboom"):
        ray_tpu_torch.get(boom.remote())


def test_client_cancel(client):
    """ray_tpu_torch.cancel proxies through the client server (no local core
    worker in client mode)."""
    import time as time_mod

    @ray_tpu_torch.remote
    def busy():
        d = time_mod.monotonic() + 60
        while time_mod.monotonic() < d:
            time_mod.sleep(0.02)

    ref = busy.remote()
    time_mod.sleep(0.8)
    ray_tpu_torch.cancel(ref)
    with pytest.raises(Exception, match="cancel"):
        ray_tpu_torch.get(ref, timeout=30)


def test_client_unknown_actor_raises(client):
    with pytest.raises(ValueError):
        ray_tpu_torch.get_actor("does-not-exist")


def test_client_nested_refs_and_handles(client):
    """Refs nested in containers and actor handles passed as args
    resolve server-side via the persistent-id pickle protocol."""
    @ray_tpu_torch.remote
    def total(refs):
        return sum(ray_tpu_torch.get(refs))

    nested = [ray_tpu_torch.put(i) for i in (1, 2, 3)]
    assert ray_tpu_torch.get(total.remote(nested)) == 6

    @ray_tpu_torch.remote
    class Store:
        def __init__(self):
            self.v = None

        def set(self, v):
            self.v = v
            return "ok"

        def get(self):
            return self.v

    s = Store.remote()

    @ray_tpu_torch.remote
    def write_through(handle, value):
        return ray_tpu_torch.get(handle.set.remote(value))

    assert ray_tpu_torch.get(write_through.remote(s, 42)) == "ok"
    assert ray_tpu_torch.get(s.get.remote()) == 42
    ray_tpu_torch.kill(s)


def test_client_timeout_error_type(client):
    """Server-side GetTimeoutError surfaces with its real type."""
    @ray_tpu_torch.remote
    def slow():
        import time

        time.sleep(30)

    with pytest.raises(ray_tpu_torch.GetTimeoutError):
        ray_tpu_torch.get(slow.remote(), timeout=1.0)


def test_client_reconnect_reuses_module_functions(client_cluster):
    """A module-level remote function keeps working across
    shutdown + re-init (no stale-context cache)."""
    @ray_tpu_torch.remote
    def echo(x):
        return x

    ray_tpu_torch.init(address=f"client://{client_cluster}")
    try:
        assert ray_tpu_torch.get(echo.remote(1)) == 1
    finally:
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(address=f"client://{client_cluster}")
    try:
        assert ray_tpu_torch.get(echo.remote(2)) == 2
    finally:
        ray_tpu_torch.shutdown()


def test_client_rejects_local_cluster_kwargs(client_cluster):
    with pytest.raises(ValueError, match="does not accept"):
        ray_tpu_torch.init(address=f"client://{client_cluster}", num_cpus=2)


# -- tensors through the relay ------------------------------------------------


def test_client_tensor_round_trip(client):
    torch = pytest.importorskip("torch")

    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    b = (torch.arange(35, dtype=torch.float32).reshape(5, 7) / 7).to(
        torch.bfloat16)
    out = ray_tpu_torch.get(ray_tpu_torch.put({"t": t, "b": b}))
    assert torch.equal(out["t"], t)
    assert out["b"].dtype == torch.bfloat16 and torch.equal(out["b"], b)

    @ray_tpu_torch.remote
    def double(x):
        return x * 2

    @ray_tpu_torch.remote
    def total(xs):
        return sum(float(x.float().sum()) for x in xs)

    assert torch.equal(ray_tpu_torch.get(double.remote(t)), t * 2)
    got = ray_tpu_torch.get(double.remote(b))
    assert got.dtype == torch.bfloat16 and torch.equal(got, b * 2)
    assert ray_tpu_torch.get(total.remote([t, b])) == \
        float(t.sum()) + float(b.float().sum())


def test_relay_keeps_cuda_tensors_on_the_host(monkeypatch):
    """The client server reads a CUDA tensor's frame onto the host,
    tagged, and writes it out again as a CUDA tensor; a process that is
    no relay and sees no GPU refuses the frame."""
    torch = pytest.importorskip("torch")
    from ray_tpu_torch._private import serialization

    if torch.cuda.is_available():
        pytest.skip("this case needs a process that sees no GPU")
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    rebuild, args = serialization._reduce_tensor(torch, t)
    cuda_args = args[:3] + ("cuda",) + args[4:]
    with pytest.raises(RuntimeError, match="sees no GPU"):
        rebuild(*cuda_args)
    monkeypatch.setattr(serialization, "_relay", True)
    held = rebuild(*cuda_args)
    assert held.device.type == "cpu" and torch.equal(held, t)
    again = serialization.loads(serialization.dumps({"x": held}))["x"]
    assert getattr(again, serialization._RELAY_ATTR) == "cuda"
    assert serialization._reduce_tensor(torch, again)[1][3] == "cuda"
    assert serialization._reduce_tensor(torch, t)[1][3] == "cpu"


# -- one driver script on both packages ---------------------------------------


TWO_PACKAGE_CLIENT = r'''
import importlib, json, subprocess, sys, time

import numpy as np

pkg = sys.argv[1]
rt = importlib.import_module(pkg)
node = importlib.import_module(pkg + "._private.node")
accel = "TPU" if pkg == "ray_tpu" else "GPU"
cluster = node.Cluster(head_resources={"CPU": 4.0, accel: 0.0},
                       object_store_memory=128 << 20)
proc = subprocess.Popen(
    [sys.executable, "-m", pkg, "client-server", "--address",
     cluster.gcs_addr, "--port", "0"],
    stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
addr = None
for _ in range(200):
    line = proc.stdout.readline()
    if line.startswith("CLIENT_SERVER_READY"):
        addr = line.split()[1]
        break


@rt.remote
def add(x, y=0):
    return x + y


@rt.remote(num_returns=2)
def pair():
    return "a", "b"


@rt.remote
def boom():
    raise ValueError("kaboom")


@rt.remote
def slow():
    time.sleep(30)


@rt.remote
def total(refs):
    return sum(rt.get(refs))


@rt.remote
def write_through(handle, value):
    return rt.get(handle.set.remote(value))


@rt.remote
class Counter:
    def __init__(self, start=0):
        self.n = start

    def inc(self, k=1):
        self.n += k
        return self.n

    def set(self, v):
        self.n = v
        return "ok"


out = {}
try:
    try:
        rt.init(address=f"client://{addr}", num_cpus=2)
    except ValueError as e:
        out["rejects_kwargs"] = "does not accept" in str(e)
    rt.init(address=f"client://{addr}")
    out["initialized"] = rt.is_initialized()
    out["put_get"] = rt.get(rt.put({"a": [1, 2.5, "x"], "b": None}))
    out["numpy"] = rt.get(rt.put(np.arange(5))).tolist()
    out["task"] = rt.get(add.remote(1, y=2))
    out["ref_arg"] = rt.get(add.remote(rt.put(10), y=5))
    out["pair"] = rt.get(list(pair.remote()))
    refs = [add.remote(i) for i in range(4)]
    ready, not_ready = rt.wait(refs, num_returns=4, timeout=60)
    out["wait"] = [len(ready), len(not_ready), sorted(rt.get(ready))]
    c = Counter.options(name="client-counter").remote(100)
    out["actor"] = [rt.get(c.inc.remote()), rt.get(c.inc.remote(9)),
                    rt.get(rt.get_actor("client-counter").inc.remote())]
    try:
        rt.get(boom.remote())
    except Exception as e:
        out["error"] = [type(e).__name__, "kaboom" in str(e)]
    try:
        rt.get_actor("does-not-exist")
    except ValueError:
        out["unknown_actor"] = "ValueError"
    try:
        rt.get(slow.remote(), timeout=1.0)
    except Exception as e:
        out["timeout"] = type(e).__name__
    out["nested"] = rt.get(total.remote([rt.put(i) for i in (1, 2, 3)]))
    s = Counter.remote()
    out["handle_arg"] = [rt.get(write_through.remote(s, 42)),
                         rt.get(s.inc.remote(0))]
    rt.kill(c)
    rt.kill(s)
    out["cpus"] = rt.cluster_resources().get("CPU")
    rt.shutdown()
    out["after_shutdown"] = rt.is_initialized()
    rt.init(address=f"client://{addr}")
    out["reconnect"] = rt.get(add.remote(2))
    rt.shutdown()
finally:
    proc.terminate()
    proc.wait(timeout=10)
    cluster.shutdown()
print(json.dumps(out))
'''


def test_one_client_script_gives_equal_results_on_both_packages():
    import json
    import os
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(root))
    env.pop("RAY_TPU_ADDRESS", None)
    env.pop("RAY_TPU_TORCH_ADDRESS", None)
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-c", TWO_PACKAGE_CLIENT, pkg], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("ray_tpu", "ray_tpu_torch")}
    results = {}
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{pkg}: {err[-3000:]}"
        results[pkg] = json.loads(out.strip().splitlines()[-1])
    jax = results["ray_tpu"]
    assert jax["actor"] == [101, 110, 111] and jax["nested"] == 6
    assert jax["error"] == ["RayTaskError", True]
    assert jax["timeout"] == "GetTimeoutError" and jax["rejects_kwargs"]
    assert results["ray_tpu_torch"] == jax
