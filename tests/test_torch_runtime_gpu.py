"""GPU accounting of the port's runtime, on the CPU with faked GPUs.

The raylet binds a GPU to a worker process from spawn until it dies, as
the JAX raylet binds a TPU chip: a worker holding GPUs sees exactly those
through CUDA_VISIBLE_DEVICES, every other worker sees "" and never
touches the card. A live GPU actor holds its GPU until it is killed.
The same scenario on the JAX package (`num_tpus`, TPU_VISIBLE_CHIPS)
gives the same grant pattern. Also here: detection and its environment
override.
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
