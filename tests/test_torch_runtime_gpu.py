"""GPU accounting of the port's runtime, on the CPU with faked GPUs.

The raylet binds a GPU to a worker process from spawn until it dies, as
the JAX raylet binds a TPU chip: a worker holding GPUs sees exactly those
through CUDA_VISIBLE_DEVICES, every other worker sees "" and never
touches the card. A live GPU actor holds its GPU until it is killed.
The same scenario on the JAX package (`num_tpus`, TPU_VISIBLE_CHIPS)
gives the same grant pattern. Also here: detection and its environment
override, and three repairs around `kill` held against the JAX package
(a killed actor inside a method ends at once and frees its GPU; a
second kill of a dead actor returns at once; a killed named actor's
name is free), and one around an actor that died under a call (the next
call and a kill return at once, not after a 10 s connect).
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import accelerators

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=2, num_gpus=2,
                       object_store_memory=64 * 1024 * 1024)
    yield
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote(num_gpus=1)
def gpu_task(hold_s):
    time.sleep(hold_s)
    return os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid()


@ray_tpu_torch.remote
def cpu_task():
    return (os.environ.get("CUDA_VISIBLE_DEVICES"),
            os.environ.get(accelerators.WORKER_VISIBLE_ENV))


@ray_tpu_torch.remote(num_gpus=1)
class GpuHolder:
    def device(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


def test_concurrent_gpu_tasks_get_distinct_devices(cluster):
    assert ray_tpu_torch.cluster_resources()["GPU"] == 2.0
    (dev_a, pid_a), (dev_b, pid_b) = ray_tpu_torch.get(
        [gpu_task.remote(1.5), gpu_task.remote(1.5)], timeout=120)
    assert sorted([dev_a, dev_b]) == ["0", "1"]
    assert pid_a != pid_b


def test_cpu_tasks_see_no_gpu(cluster):
    for visible, host_visible in ray_tpu_torch.get(
            [cpu_task.remote() for _ in range(4)], timeout=120):
        assert visible == ""
        assert host_visible is None


def test_live_gpu_actors_hold_the_gpus_until_killed(cluster):
    holders = [GpuHolder.remote() for _ in range(2)]
    devices = ray_tpu_torch.get([h.device.remote() for h in holders],
                                timeout=120)
    assert sorted(devices) == ["0", "1"]
    waiting = gpu_task.remote(0.0)
    ready, not_ready = ray_tpu_torch.wait([waiting], timeout=2)
    assert ready == [] and not_ready == [waiting]
    ray_tpu_torch.kill(holders[0])
    got, _ = ray_tpu_torch.get(waiting, timeout=120)
    assert got == devices[0]
    ray_tpu_torch.kill(holders[1])


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


@ray_tpu_torch.remote(num_gpus=1)
class BusyGpuHolder:
    def pid(self):
        return os.getpid()

    def busy(self, seconds):
        time.sleep(seconds)
        return "done"


@ray_tpu_torch.remote
class SlowCleanup:
    """An exit hook that outlasts the kill grace: it writes `marker`
    2 x KILL_GRACE_S after the worker starts its orderly exit."""

    def __init__(self, marker):
        import atexit

        from ray_tpu_torch._private.core_worker import KILL_GRACE_S

        def cleanup():
            time.sleep(2 * KILL_GRACE_S)
            with open(marker, "w") as f:
                f.write("clean")

        atexit.register(cleanup)

    def pid(self):
        return os.getpid()


def test_kill_ends_a_running_method_and_frees_its_gpu(cluster, tmp_path):
    """A repair of the port (the JAX worker queues its exit behind the
    running method, see the next test): `kill` ends a GPU actor that is
    inside a long method within seconds, the method fails with
    ActorDiedError, the GPU is free again, and a second kill returns at
    once. An idle actor's orderly exit is not cut: its exit hook, longer
    than the grace, runs to its end."""
    marker = tmp_path / "cleanup"
    idle = SlowCleanup.remote(str(marker))
    idle_pid = ray_tpu_torch.get(idle.pid.remote(), timeout=120)
    holder = BusyGpuHolder.remote()
    pid = ray_tpu_torch.get(holder.pid.remote(), timeout=120)
    ref = holder.busy.remote(120)
    time.sleep(0.5)
    ray_tpu_torch.kill(holder)
    deadline = time.monotonic() + 15
    while _alive(pid) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not _alive(pid), "the killed actor's process is still running"
    with pytest.raises(ray_tpu_torch.ActorDiedError):
        ray_tpu_torch.get(ref, timeout=60)
    while ray_tpu_torch.available_resources().get("GPU", 0) < 2:
        assert time.monotonic() < deadline + 30, "the GPU was not freed"
        time.sleep(0.1)
    t0 = time.monotonic()
    ray_tpu_torch.kill(holder)
    assert time.monotonic() - t0 < 2
    ray_tpu_torch.kill(idle)
    deadline = time.monotonic() + 30
    while _alive(idle_pid) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not _alive(idle_pid), "the killed idle actor never exited"
    assert marker.read_text() == "clean"


# One script, either package: kill an actor inside a 60 s method and
# report whether its process still runs 10 s later; kill an idle named
# actor twice, time the second kill and look its name up.
KILL_SCRIPT = r'''
import json, os, sys, time, importlib
pkg = sys.argv[1]
rt = importlib.import_module(pkg)
rt.init(num_cpus=2, object_store_memory=64 * 1024 * 1024,
        **({"num_tpus": 0} if pkg == "ray_tpu" else {"num_gpus": 0}))

def alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False

@rt.remote
class Busy:
    def pid(self):
        return os.getpid()

    def busy(self, seconds):
        time.sleep(seconds)

try:
    actor, idle = Busy.remote(), Busy.options(name="idle").remote()
    pid = rt.get(actor.pid.remote(), timeout=120)
    rt.get(idle.pid.remote(), timeout=120)
    actor.busy.remote(60)
    time.sleep(0.5)
    rt.kill(actor)
    rt.kill(idle)
    time.sleep(10)
    t0 = time.monotonic()
    rt.kill(idle)
    second_kill_s = time.monotonic() - t0
    try:
        rt.get_actor("idle")
        dead_name_found = True
    except ValueError:
        dead_name_found = False
    print(json.dumps({"alive_10s_after_kill": alive(pid),
                      "second_kill_under_2s": second_kill_s < 2,
                      "dead_name_found": dead_name_found}))
finally:
    rt.shutdown()
'''


def test_kill_against_the_jax_package():
    """The differences the three repairs make: the JAX worker is still
    running 10 s after `kill` (its exit waits for the 60 s method), the
    port's is gone; a second kill of a dead actor takes the JAX GCS a
    10 s connect to the dead worker, the port's returns at once; and
    `get_actor` finds a killed named actor in the JAX package, not in
    the port (its name is free again)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-c", KILL_SCRIPT, pkg], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("ray_tpu", "ray_tpu_torch")}
    results = {}
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{pkg}: {err[-3000:]}"
        results[pkg] = json.loads(out.strip().splitlines()[-1])
    assert results == {
        "ray_tpu": {"alive_10s_after_kill": True,
                    "second_kill_under_2s": False,
                    "dead_name_found": True},
        "ray_tpu_torch": {"alive_10s_after_kill": False,
                          "second_kill_under_2s": True,
                          "dead_name_found": False}}


# One script, either package: two actors whose processes die (os._exit
# from a thread, as a killed rank does) while a call of the driver's is
# in flight; at once after each death, a second call to the first and a
# `kill` of the second, each timed.
DEATH_SCRIPT = r'''
import json, os, sys, threading, time, importlib
pkg = sys.argv[1]
rt = importlib.import_module(pkg)
rt.init(num_cpus=2, object_store_memory=64 * 1024 * 1024,
        **({"num_tpus": 0} if pkg == "ray_tpu" else {"num_gpus": 0}))

@rt.remote
class Mortal:
    def die_soon(self):
        def die():
            time.sleep(0.5)
            os._exit(1)
        threading.Thread(target=die, daemon=True).start()

    def wait(self, seconds):
        time.sleep(seconds)
        return seconds

def died_mid_call(actor):
    rt.get(actor.die_soon.remote(), timeout=120)
    try:
        rt.get(actor.wait.remote(30), timeout=60)
        return False
    except rt.ActorDiedError:
        return True

out = {}
try:
    called, killed = Mortal.remote(), Mortal.remote()
    rt.get([called.wait.remote(0), killed.wait.remote(0)], timeout=120)
    out["in_flight_failed"] = [died_mid_call(called)]
    t0 = time.monotonic()
    try:
        rt.get(called.wait.remote(0), timeout=60)
        out["next_call"] = "returned"
    except rt.ActorDiedError:
        out["next_call"] = "ActorDiedError"
    out["next_call_s"] = time.monotonic() - t0
    out["in_flight_failed"].append(died_mid_call(killed))
    t0 = time.monotonic()
    rt.kill(killed)
    out["kill_s"] = time.monotonic() - t0
finally:
    rt.shutdown()
print(json.dumps(out))
'''


def test_a_dead_actor_fails_fast_against_the_jax_package():
    """F8: right after an actor's process dies under a call (before its
    raylet has told the GCS), the JAX package's next call to it dials the
    refused port for a whole connect timeout (10 s) and its `kill` holds
    the caller as long, dialling it to send the exit notice. The port's
    next call fails at once (the lost connection poisons the address)
    and its kill returns without waiting for the dial; both packages
    fail the in-flight call and the next one with ActorDiedError."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-c", DEATH_SCRIPT, pkg], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("ray_tpu", "ray_tpu_torch")}
    results = {}
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{pkg}: {err[-3000:]}"
        results[pkg] = json.loads(out.strip().splitlines()[-1])
    for r in results.values():
        assert r["in_flight_failed"] == [True, True], results
        assert r["next_call"] == "ActorDiedError", results
    port = results["ray_tpu_torch"]
    # the kill's remaining cost is the GCS's 2 s budget for publishing
    # the death to a subscriber that is the dead worker itself
    assert port["next_call_s"] < 1.0 and port["kill_s"] < 3.0, results


def test_detection_honours_the_environment(monkeypatch):
    monkeypatch.setenv(accelerators.GPU_COUNT_ENV, "3")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    assert accelerators.num_local_gpus() == 3
    monkeypatch.delenv(accelerators.GPU_COUNT_ENV)
    assert accelerators.num_local_gpus() == 1
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1,3")
    assert accelerators.num_local_gpus() == 2
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert accelerators.num_local_gpus() == 0
    # a container given device 7 of a host (its /dev may hold more files)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    monkeypatch.setenv("NVIDIA_VISIBLE_DEVICES", "7")
    assert accelerators.num_local_gpus() == 1
    # a worker's indices name the host's own devices where it has a list
    assert accelerators.worker_visible_devices((1,), "4,6") == "6"
    assert accelerators.worker_visible_devices((0, 1), None) == "0,1"
    assert accelerators.slice_env() is None


# One scenario, run once against each package in its own process: two
# accelerators, two concurrent accelerator tasks, a CPU task, two live
# actors holding both, a third task that waits until one is killed.
GRANT_SCRIPT = r'''
import importlib, json, os, sys, time
pkg = sys.argv[1]
rt = importlib.import_module(pkg)
if pkg == "ray_tpu_torch":
    # the node detects its two GPUs through the environment override
    var, key, res = "CUDA_VISIBLE_DEVICES", "num_gpus", "GPU"
    rt.init(num_cpus=2, object_store_memory=64 << 20)
else:
    var, key, res = "TPU_VISIBLE_CHIPS", "num_tpus", "TPU"
    rt.init(num_cpus=2, num_tpus=2, object_store_memory=64 << 20)


@rt.remote(**{key: 1})
def acc_task(hold_s):
    time.sleep(hold_s)
    return os.environ.get(var)


@rt.remote
def cpu_task():
    return os.environ.get(var) or ""


@rt.remote(**{key: 1})
class Holder:
    def device(self):
        return os.environ.get(var)


out = {}
try:
    out["resources"] = rt.cluster_resources()[res]
    out["concurrent"] = sorted(rt.get([acc_task.remote(1.5),
                                       acc_task.remote(1.5)], timeout=120))
    out["cpu"] = rt.get(cpu_task.remote(), timeout=120)
    holders = [Holder.remote() for _ in range(2)]
    devices = rt.get([h.device.remote() for h in holders], timeout=120)
    out["actors"] = sorted(devices)
    waiting = acc_task.remote(0.0)
    ready, _ = rt.wait([waiting], timeout=2)
    out["third_waited"] = ready == []
    rt.kill(holders[0])
    out["third_got_the_killed_actors_device"] = (
        rt.get(waiting, timeout=120) == devices[0])
finally:
    rt.shutdown()
print(json.dumps(out))
'''


def test_grant_pattern_matches_the_jax_package():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    env[accelerators.GPU_COUNT_ENV] = "2"
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-c", GRANT_SCRIPT, pkg], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("ray_tpu", "ray_tpu_torch")}
    results = {}
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{pkg}: {err[-3000:]}"
        results[pkg] = json.loads(out.strip().splitlines()[-1])
    assert results["ray_tpu"] == {
        "resources": 2.0, "concurrent": ["0", "1"], "cpu": "",
        "actors": ["0", "1"], "third_waited": True,
        "third_got_the_killed_actors_device": True}
    assert results["ray_tpu_torch"] == results["ray_tpu"]
