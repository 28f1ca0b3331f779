"""The port's `serve.llm` deployment (`LLMDeployment`, `build_app`) on the
port's Serve and runtime, held to the JAX package:

  * `build_app` served through a `DeploymentHandle` gives the JAX
    engine's greedy tokens on the same weights (the tiny f32 GPT, carried
    with `models.convert`), on the Python router path and on the native
    request ring (whose stats prove it carried the requests);
  * a dead replica's KV arena is reclaimed by the controller, and
    `serve_llm_arenas_reclaimed_total` counts it;
  * a replica killed mid-stream with two replicas: the handle resumes on
    the survivor and the stream equals the uninterrupted one, and the
    dead replica's arena is reclaimed (the port's own failover oracle);
  * two clusters of the port on one host that deploy `llm` with the ring
    get segments of their own, and one's `serve.delete` leaves the
    other's ring serving;
  * a replica asked for `device="cuda"` where there is no GPU raises;
  * one driver script run against both packages gives equal results.

One module-scoped cluster of the port's runtime with
RAY_TPU_NATIVE_DISPATCH=1 in its workers' environment, so the controller
publishes every deployment into its native segment and replicas attach
their intakes; the driver sets the variable only while it uses the ring
(the handle reads it per request).
"""

import glob
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch import serve  # noqa: E402
from ray_tpu_torch._private.worker_api import ActorMethod  # noqa: E402
from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.serve import dispatch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PROMPTS = [[5, 9, 3], [7], [1, 2, 3, 4, 5, 6, 7, 8], [11, 13]]
NEW = [6, 9, 3, 7]
ENGINE = {"batch_buckets": (1, 2, 4), "prefill_buckets": (8, 16)}


@pytest.fixture(scope="module", autouse=True)
def cluster():
    was = os.environ.get(dispatch.ENV_FLAG)
    os.environ[dispatch.ENV_FLAG] = "1"  # inherited by every worker
    try:
        ray_tpu_torch.init(num_cpus=8, num_gpus=0,
                           object_store_memory=256 * 1024 * 1024)
    finally:
        os.environ.pop(dispatch.ENV_FLAG)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()
    if was is not None:
        os.environ[dispatch.ENV_FLAG] = was


@pytest.fixture(scope="module")
def weights():
    """The tiny f32 GPT's JAX weights (Dense kernels x8, so the blocks,
    not the tied embedding, pick each token), the port's copy of them,
    and the JAX engine's greedy tokens for PROMPTS."""
    from ray_tpu.models import gpt as jmod
    from ray_tpu.serve.llm import EngineConfig as JaxEngineConfig
    from ray_tpu.serve.llm import LLMEngine as JaxLLMEngine
    from ray_tpu_torch.models.gpt import GPTConfig

    net = jmod.GPT(jmod.GPTConfig.tiny(dtype=jnp.float32))
    variables = jax.jit(net.init)(jax.random.PRNGKey(0),
                                  jnp.ones((1, 8), jnp.int32))
    variables = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 8.0 if any(getattr(p, "key", None) == "kernel"
                                       for p in path) else x, variables)
    jeng = JaxLLMEngine(model="gpt", params=variables,
                        engine_config=JaxEngineConfig(**ENGINE))
    try:
        reqs = [jeng.submit(p, n) for p, n in zip(PROMPTS, NEW)]
        jeng.run_until_idle(timeout=120)
        want = [r.result(timeout=30) for r in reqs]
    finally:
        assert jeng.shutdown() == 0
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmod.unboxed_params(variables))
    params = convert.gpt_params_from_jax(
        tree, GPTConfig.tiny(dtype=torch.float32), "cpu")
    return params, want


@pytest.fixture
def llm(weights):
    """One replica of `build_app` on the CPU with the JAX weights; the
    deployment is deleted afterwards."""
    params, want = weights
    handle = serve.run(serve.llm.build_app(
        name="llm", model="gpt", params=params, device="cpu",
        engine_config=ENGINE))
    # the replica answers once its engine warmed up and started
    assert handle.engine_metrics.remote().result(timeout=120)["model"] \
        == "gpt"
    yield handle, want
    serve.delete("llm")


def _ring(name):
    """The deployment's native segment once its replicas attached."""
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            ring = dispatch.DispatchRing(dispatch.domain_segment(name),
                                         create=False)
        except FileNotFoundError:
            time.sleep(0.1)
            continue
        if ring.mode() == dispatch.MODE_RAW_LLM:
            return ring
        ring.close()
        time.sleep(0.1)
    raise AssertionError(f"no attached native ring for {name!r}")


def _streams(handle):
    gens = [handle.generate.options(stream=True).remote(p, n)
            for p, n in zip(PROMPTS, NEW)]
    return gens, [[c["token"] for c in g] for g in gens]


def test_build_app_python_path_gives_jax_engine_tokens(llm):
    handle, want = llm
    assert not dispatch.native_requested()
    ring = _ring("llm")
    before = ring.stats()["enqueued"]
    gens, got = _streams(handle)
    assert all(type(g).__name__ == "DeploymentResponseGenerator"
               for g in gens)
    assert got == want
    assert handle.generate_once.remote(PROMPTS[0], NEW[0]).result(
        timeout=60) == want[0]
    assert ring.stats()["enqueued"] == before  # the ring carried nothing
    ring.close()


def test_build_app_native_ring_gives_jax_engine_tokens(llm, monkeypatch):
    handle, want = llm
    ring = _ring("llm")
    assert ring.slot_bytes >= dispatch.REQUEST_SLOT_BYTES
    before = ring.stats()
    monkeypatch.setenv(dispatch.ENV_FLAG, "1")
    gens, got = _streams(handle)
    assert all(type(g).__name__ == "NativeDeploymentResponseGenerator"
               for g in gens)
    assert got == want
    once = handle.generate_once.remote(PROMPTS[2], NEW[2])
    assert type(once).__name__ == "NativeDeploymentResponse"
    assert once.result(timeout=60) == want[2]
    after = ring.stats()
    n = len(PROMPTS) + 1
    assert after["enqueued"] - before["enqueued"] == n
    assert after["drained"] - before["drained"] == n
    _ver, rows = ring.snapshot()
    assert sum(row[2] for row in rows) == 0  # in-flight balanced
    ring.close()


# A second cluster of the port on this host deploys `llm` on the ring,
# prints its domain segment, router FIFO and response ring once its ring
# carried a request, deletes the deployment on the first line of input
# and shuts down on the second.
OTHER_CLUSTER_SCRIPT = r'''
import os, sys, time
import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.serve import dispatch
os.environ[dispatch.ENV_FLAG] = "1"
ray_tpu_torch.init(num_cpus=2, num_gpus=0,
                   object_store_memory=128 * 1024 * 1024)
try:
    handle = serve.run(serve.llm.build_app(
        name="llm", model="gpt", seed=0, device="cpu",
        engine_config={"batch_buckets": (1, 2), "prefill_buckets": (8,)}))
    seg = dispatch.domain_segment("llm")
    deadline = time.monotonic() + 120
    while True:
        try:
            ring = dispatch.DispatchRing(seg, create=False)
        except FileNotFoundError:
            ring = None
        if ring is not None and ring.mode() == dispatch.MODE_RAW_LLM:
            break
        assert time.monotonic() < deadline, "no attached ring"
        time.sleep(0.1)
    handle.generate_once.remote([1, 2], 2).result(timeout=300)
    assert ring.stats()["drained"] == 1, ring.stats()
    ring.close()
    print(seg, dispatch.router_wake_path("llm"),
          dispatch.client_segment(dispatch.ClientPlane.get().cookie),
          flush=True)
    sys.stdin.readline()
    serve.delete("llm")
    print("deleted", flush=True)
    sys.stdin.readline()
finally:
    serve.shutdown()
    ray_tpu_torch.shutdown()
'''


def test_two_clusters_deploying_llm_keep_their_own_segments(llm,
                                                            monkeypatch):
    """The segment names cover the cluster: another cluster of the port
    on this host that deploys `llm` on the ring gets its own domain and
    router FIFO, its `serve.delete` unlinks only its own, and this
    cluster's ring goes on carrying every request. The other cluster's
    `serve.shutdown()` closes its response ring, and nothing of it is
    left after its process exits."""
    handle, want = llm
    ring = _ring("llm")
    mine = dispatch.domain_segment("llm")
    assert ring.segment == mine
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-c", OTHER_CLUSTER_SCRIPT], cwd=ROOT, env=env,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline().split()
        assert len(line) == 3, proc.communicate(timeout=60)[1][-3000:]
        theirs, their_wake, their_responses = line
        assert os.path.exists("/dev/shm" + their_responses)
        assert theirs != mine
        assert their_wake != dispatch.router_wake_path("llm")
        assert os.path.exists("/dev/shm" + theirs)
        assert os.path.exists(their_wake)
        proc.stdin.write("\n")
        proc.stdin.flush()
        assert proc.stdout.readline().strip() == "deleted"
        assert not os.path.exists("/dev/shm" + theirs)
        assert not os.path.exists(their_wake)
        assert os.path.exists("/dev/shm" + mine)
        assert os.path.exists(dispatch.router_wake_path("llm"))
        before = ring.stats()
        monkeypatch.setenv(dispatch.ENV_FLAG, "1")
        gens, got = _streams(handle)
        assert all(type(g).__name__ == "NativeDeploymentResponseGenerator"
                   for g in gens)
        assert got == want
        after = ring.stats()
        assert after["enqueued"] - before["enqueued"] == len(PROMPTS)
        assert after["drained"] - before["drained"] == len(PROMPTS)
        proc.stdin.write("\n")
        proc.stdin.flush()
        _out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err[-3000:]
        assert not glob.glob("/dev/shm" + their_responses + "*")
    finally:
        if proc.poll() is None:
            proc.stdin.close()  # EOF: the other cluster shuts down
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        ring.close()


def _controller():
    return ray_tpu_torch.get_actor("SERVE_CONTROLLER")


def _reclaimed_total(ctrl):
    """`serve_llm_arenas_reclaimed_total` from the controller's own
    registry callback (its `/metrics` text)."""
    text = ray_tpu_torch.get(ActorMethod(ctrl, "_metrics_text").remote(),
                             timeout=30)
    line = next(ln for ln in text.splitlines()
                if ln.startswith("serve_llm_arenas_reclaimed_total "))
    return int(line.split()[1])


def _await_reclaim(ctrl, arena):
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        ray_tpu_torch.get(ctrl.reconcile_now.remote(), timeout=60)
        if arena in ray_tpu_torch.get(ctrl.get_reclaimed_arenas.remote(),
                                      timeout=30):
            return
        time.sleep(0.5)
    raise AssertionError("dead replica's KV arena never reclaimed")


def test_dead_replica_arena_is_reclaimed_by_the_controller(llm):
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.object_ref import get_core_worker

    handle, want = llm
    ctrl = _controller()
    ray_tpu_torch.get(ctrl.reconcile_now.remote(), timeout=60)
    total = _reclaimed_total(ctrl)
    (replica,) = ray_tpu_torch.get(ctrl.get_replicas.remote("llm"),
                                   timeout=30)["replicas"]
    arena = ray_tpu_torch.get(replica.get_metrics.remote(),
                              timeout=30)["kv_arena_id"]
    store = get_core_worker().store
    assert arena and store.contains(ObjectID.from_hex(arena))
    ray_tpu_torch.kill(replica)
    _await_reclaim(ctrl, arena)
    assert not store.contains(ObjectID.from_hex(arena))
    assert _reclaimed_total(ctrl) == total + 1
    # the replacement serves the same tokens
    assert handle.generate_once.remote(PROMPTS[1], NEW[1]).result(
        timeout=120) == want[1]


def test_replica_killed_midstream_resumes_the_same_stream(weights):
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.object_ref import get_core_worker
    from ray_tpu_torch.serve.llm import LLMDeployment
    from ray_tpu_torch.util import request_recorder as rr

    params, want = weights

    class SlowLLM(LLMDeployment):
        """Per-chunk delay so the kill lands mid-stream."""

        def generate(self, prompt, max_new_tokens=16, timeout_s=None):
            for chunk in LLMDeployment.generate(
                    self, prompt, max_new_tokens, timeout_s):
                time.sleep(0.05)
                yield chunk

    handle = serve.run(serve.deployment(name="llm-kill", num_replicas=2)(
        SlowLLM).bind(model="gpt", params=params, device="cpu",
                      engine_config=ENGINE))
    try:
        ctrl = _controller()
        # both replicas up, and the controller's metrics cache primed
        # with their arena ids
        deadline = time.monotonic() + 120
        while True:
            replicas = ray_tpu_torch.get(
                ctrl.get_replicas.remote("llm-kill"), timeout=30)["replicas"]
            if len(replicas) == 2 and all(
                    ray_tpu_torch.get(r.get_metrics.remote(), timeout=60)
                    .get("kv_arena_id") for r in replicas):
                break
            assert time.monotonic() < deadline, "replicas never came up"
            time.sleep(0.2)
        ray_tpu_torch.get(ctrl.reconcile_now.remote(), timeout=60)
        total = _reclaimed_total(ctrl)
        prompt, n = PROMPTS[1], NEW[1]
        gen = handle.generate.options(stream=True).remote(prompt, n)
        tokens = [next(gen)["token"] for _ in range(3)]
        serving = dead_arena = None
        for r in replicas:
            m = ray_tpu_torch.get(r.get_metrics.remote(), timeout=30)
            if m["ongoing"] >= 1 and serving is None:
                serving, dead_arena = r, m["kv_arena_id"]
        assert serving is not None and dead_arena
        ray_tpu_torch.kill(serving)
        tokens += [chunk["token"] for chunk in gen]
        assert tokens == want[1]  # the uninterrupted stream
        fo = [r for r in rr.ring().recent()
              if r.role == "client" and r.outcome == "failed_over"]
        assert len(fo) == 1 and fo[0].tokens_out == n
        assert fo[0].replayed_tokens >= 3
        _await_reclaim(ctrl, dead_arena)
        assert not get_core_worker().store.contains(
            ObjectID.from_hex(dead_arena))
        assert _reclaimed_total(ctrl) == total + 1
    finally:
        serve.delete("llm-kill")


@ray_tpu_torch.remote
def _llm_deployment_without_a_gpu():
    from ray_tpu_torch.serve.llm import LLMDeployment
    LLMDeployment(model="gpt")


def test_replica_without_a_gpu_refuses_cuda():
    """`device="cuda"` (the default) where no GPU is visible: the
    replica raises in `__init__` ("no CUDA device") and the deployment
    answers nothing; it never serves on the CPU. `build_app` asks one
    GPU per CUDA replica."""
    app = serve.llm.build_app(name="llm-cuda", model="gpt")
    assert app.deployment.config.ray_actor_options == {"num_gpus": 1}
    assert serve.llm.build_app(
        name="x", device="cpu").deployment.config.ray_actor_options is None
    with pytest.raises(Exception, match="no CUDA device"):
        ray_tpu_torch.get(_llm_deployment_without_a_gpu.remote(),
                          timeout=120)
    handle = serve.run(serve.llm.build_app(
        name="llm-cuda", model="gpt", ray_actor_options={}))
    try:
        with pytest.raises(Exception):
            handle.generate_once.remote([1, 2], 2).result(timeout=120)
    finally:
        serve.delete("llm-cuda")


# One script, either package: plain deployments, a streaming handle, an
# LLM deployment on the JAX seed-0 weights (the port's copy read from the
# file the test writes) and the reclaim of an idle replica's arena.
TWO_PACKAGE_SCRIPT = r'''
import importlib, json, sys, time
import numpy as np
pkg, weights = sys.argv[1], sys.argv[2]
rt = importlib.import_module(pkg)
serve = importlib.import_module(pkg + ".serve")
ENGINE = {"batch_buckets": (1, 2, 4), "prefill_buckets": (8, 16)}
rt.init(num_cpus=4, object_store_memory=128 * 1024 * 1024,
        **({"num_tpus": 0} if pkg == "ray_tpu" else {"num_gpus": 0}))
out = {}
try:
    @serve.deployment
    def doubler(x):
        return x * 2

    @serve.deployment(num_replicas=2)
    class Counter:
        def __init__(self, start):
            self.base = start

        def __call__(self, x):
            return self.base + x

        def describe(self):
            return "counter"

    @serve.deployment
    class Model:
        def __init__(self, pre):
            self.pre = pre

        def __call__(self, x):
            return self.pre.remote(x).result(timeout=30) * 10

    @serve.deployment
    class Tokens:
        def generate(self, n):
            for i in range(n):
                yield {"token": i}

    def run(app):
        return serve.run(app, route_prefix=None)

    out["doubler"] = run(doubler.bind()).remote(21).result()
    h = run(Counter.bind(100))
    out["counter"] = [h.remote(5).result(), h.describe.remote().result()]
    out["composed"] = run(Model.bind(doubler.bind())).remote(4).result()
    out["stream"] = list(run(Tokens.bind()).generate.options(
        stream=True).remote(4))
    out["status"] = {k: [v["num_replicas"], v["target_replicas"]]
                     for k, v in sorted(serve.status().items())}

    kw = dict(name="llm", model="gpt", seed=0, engine_config=ENGINE)
    if pkg == "ray_tpu_torch":
        from ray_tpu_torch.models import convert
        from ray_tpu_torch.models.gpt import GPTConfig
        import torch
        tree = dict(np.load(weights, allow_pickle=True))["tree"].item()
        kw.update(device="cpu", params=convert.gpt_params_from_jax(
            tree, GPTConfig.tiny(dtype=torch.float32), "cpu"))
    llm = run(serve.llm.build_app(**kw))
    prompts = [[5, 9, 3], [7], [11, 13]]
    out["llm_once"] = [llm.generate_once.remote(p, 5).result(timeout=300)
                       for p in prompts]
    out["llm_stream"] = [
        [c for c in llm.generate.options(stream=True).remote(p, 4)]
        for p in prompts]
    ctrl = rt.get_actor("SERVE_CONTROLLER")
    rt.get(ctrl.reconcile_now.remote(), timeout=60)
    (replica,) = rt.get(ctrl.get_replicas.remote("llm"),
                        timeout=30)["replicas"]
    arena = rt.get(replica.get_metrics.remote(), timeout=30)["kv_arena_id"]
    rt.kill(replica)
    deadline = time.monotonic() + 120
    while arena not in rt.get(ctrl.get_reclaimed_arenas.remote(),
                              timeout=30):
        assert time.monotonic() < deadline, "arena never reclaimed"
        rt.get(ctrl.reconcile_now.remote(), timeout=60)
        time.sleep(0.5)
    out["reclaimed"] = len(rt.get(ctrl.get_reclaimed_arenas.remote(),
                                  timeout=30))
    out["arena_id_len"] = len(arena)
    out["llm_after_kill"] = llm.generate_once.remote(
        prompts[0], 5).result(timeout=300)
finally:
    serve.shutdown()
    rt.shutdown()
print(json.dumps(out))
'''


def test_one_script_gives_equal_results_on_both_packages(tmp_path):
    from ray_tpu.models import gpt as jmod

    # the JAX deployment's seed-0 weights, as its engine draws them
    net = jmod.GPT(jmod.GPTConfig.tiny(dtype=jnp.float32))
    variables = net.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmod.unboxed_params(variables))
    weights = tmp_path / "gpt_seed0.npz"
    np.savez(weights, tree=np.array(tree, dtype=object))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    env.pop(dispatch.ENV_FLAG, None)
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-c", TWO_PACKAGE_SCRIPT, pkg, str(weights)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pkg in ("ray_tpu", "ray_tpu_torch")}
    results = {}
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=400)
        assert proc.returncode == 0, f"{pkg}: {err[-3000:]}"
        results[pkg] = json.loads(out.strip().splitlines()[-1])
    want = results["ray_tpu"]
    assert want["doubler"] == 42 and want["composed"] == 80
    assert want["reclaimed"] == 1 and want["arena_id_len"] == 32
    assert len(want["llm_once"]) == 3
    assert results["ray_tpu_torch"] == want


def test_serve_restarts_after_shutdown(weights):
    """`serve.shutdown()` kills the controller; the next `serve.run`
    starts a new one (the killed controller's name is free: the JAX
    runtime's `get_actor` would hand back the dead one) and serves."""
    params, want = weights
    serve.shutdown()
    handle = serve.run(serve.llm.build_app(
        name="llm", model="gpt", params=params, device="cpu",
        engine_config=ENGINE))
    try:
        assert handle.generate_once.remote(PROMPTS[3], NEW[3]).result(
            timeout=120) == want[3]
    finally:
        serve.delete("llm")
