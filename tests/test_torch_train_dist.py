"""The distributed train plane of the port (`ray_tpu_torch.train`)
against the JAX package's (`ray_tpu.train`).

The scenarios of tests/test_train.py — two workers reporting in
lockstep, a checkpoint round trip with keep-top-K, a restore from a
checkpoint, a worker failure that propagates, a trainer that trains —
and the commit-kill walk-back of tests/test_chaos.py (a rank killed
between its shard's persist and the gang commit) run as one driver
script against each package, in subprocesses, and the `result.metrics`
must be equal. Only the trainer's own training loop differs: jax and
optax under `JaxTrainer`, torch under `TorchTrainer`, on the same data
from a numpy seed; their first losses and final weights agree within
1e-5 relative, their final losses (near 1e-4) within 1e-4.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent

# argv: package, storage dir. The five scenarios of tests/test_train.py
# on one cluster; prints one JSON object of their results.
SCENARIOS = r'''
import importlib, json, os, sys
import numpy as np

pkg, storage = sys.argv[1], sys.argv[2]
rt = importlib.import_module(pkg)
train = importlib.import_module(pkg + ".train")
air = importlib.import_module(pkg + ".air")
acc = {"num_gpus": 0} if pkg == "ray_tpu_torch" else {"num_tpus": 0}
rt.init(num_cpus=4, object_store_memory=128 << 20, **acc)


def run(loop, name, trainer=train.DataParallelTrainer, **kw):
    return trainer(loop, run_config=air.RunConfig(
        storage_path=storage, name=name,
        checkpoint_config=kw.pop("checkpoint_config", None)), **kw).fit()


def lockstep(config):
    ctx = train.get_context()
    assert ctx.get_world_size() == 2
    for step in range(3):
        train.report({"step": step, "rank": ctx.get_world_rank(),
                      "val": config["base"] + step,
                      "local": [ctx.get_local_rank(),
                                ctx.get_local_world_size(),
                                ctx.get_node_rank()]})


def topk(config):
    ctx = train.get_context()
    for step in range(4):
        ckpt = air.Checkpoint.from_dict({"step": step,
                                         "rank": ctx.get_world_rank()})
        train.report({"score": float(step)}, checkpoint=ckpt)


def restore(config):
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        start = ckpt.to_dict()["step"] + 1
    train.report({"resumed_from": start})


def fail(config):
    if train.get_context().get_world_rank() == 1:
        raise ValueError("boom from rank 1")
    train.report({"ok": True})


def trains_jax(config):
    import jax
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((64, 4)).astype(np.float32))
    y = x @ jnp.array([1.0, -2.0, 3.0, 0.5])
    w = jnp.zeros((4,), jnp.float32)
    opt = optax.sgd(0.1)
    state = opt.init(w)

    @jax.jit
    def step(w, state):
        loss, g = jax.value_and_grad(lambda w: jnp.mean((x @ w - y) ** 2))(w)
        updates, state = opt.update(g, state)
        return optax.apply_updates(w, updates), state, loss

    losses = []
    for _ in range(50):
        w, state, loss = step(w, state)
        losses.append(float(loss))
    train.report({"loss": losses[-1], "first": losses[0],
                  "w": [float(v) for v in w]})


def trains_torch(config):
    import torch

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, 4)).astype(np.float32))
    y = x @ torch.tensor([1.0, -2.0, 3.0, 0.5])
    w = torch.zeros(4, requires_grad=True)
    opt = torch.optim.SGD([w], lr=0.1)
    losses = []
    for _ in range(50):
        loss = ((x @ w - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(loss))
    train.report({"loss": losses[-1], "first": losses[0],
                  "w": [float(v) for v in w.detach()]})


out = {}
try:
    S = air.ScalingConfig
    r = run(lockstep, "lockstep", train_loop_config={"base": 10},
            scaling_config=S(num_workers=2))
    out["lockstep"] = [r.metrics, r.error is None,
                       [m["step"] for m in r.metrics_history]]
    r = run(topk, "ckpt", scaling_config=S(num_workers=1),
            checkpoint_config=air.CheckpointConfig(
                num_to_keep=2, checkpoint_score_attribute="score"))
    trial_root = os.path.dirname(r.checkpoint.path)
    out["topk"] = [r.metrics, r.checkpoint.to_dict(), sorted(
        d for d in os.listdir(trial_root) if d.startswith("checkpoint_"))]
    r = run(restore, "restore", scaling_config=S(num_workers=1),
            resume_from_checkpoint=air.Checkpoint.from_dict({"step": 41}))
    out["restore"] = r.metrics
    try:
        run(fail, "fail", scaling_config=S(num_workers=2))
        out["failure"] = None
    except train.TrainingFailedError as e:
        out["failure"] = [type(e).__name__, "boom from rank 1" in str(e),
                          "ValueError" in str(e)]
    trainer = (train.JaxTrainer if pkg == "ray_tpu" else train.TorchTrainer)
    r = run(trains_jax if pkg == "ray_tpu" else trains_torch, "trains",
            trainer=trainer, scaling_config=S(num_workers=1))
    out["trains"] = r.metrics
finally:
    rt.shutdown()
print(json.dumps(out))
'''

# argv: package, storage dir. tests/test_chaos.py's commit-kill
# walk-back: RAY_TPU_CHAOS kills rank 1 inside its step-2 report, after
# its shard is durable and before the gang commit. The carry is
# replicated on both ranks of a process group (jax.distributed: each
# array replicated over the global mesh; torch.distributed over gloo: the
# same tensors in each rank), so rank 0 writes it.
COMMIT_KILL = r'''
import importlib, json, os, sys

pkg, storage = sys.argv[1], sys.argv[2]
os.environ["RAY_TPU_CHAOS"] = "seed=11;commit_kill=1:1"
rt = importlib.import_module(pkg)
train = importlib.import_module(pkg + ".train")
air = importlib.import_module(pkg + ".air")
rt.init(num_cpus=4, object_store_memory=128 << 20)
os.environ.pop("RAY_TPU_CHAOS")


def loop_jax(config):
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ray_tpu import train as t
    from ray_tpu.train import array_checkpoint as ac

    mesh = Mesh(np.array(jax.devices()), ("dp",))
    rep = NamedSharding(mesh, P())
    w0 = np.arange(32, dtype=np.float32).reshape(8, 4)
    state = {"w": jax.make_array_from_callback((8, 4), rep,
                                               lambda idx: w0[idx]),
             "step": jax.make_array_from_callback(
                 (), rep, lambda idx: np.zeros((), np.int32))}
    start = 0
    ckpt = t.get_checkpoint()
    if ckpt is not None and ac.is_sharded_checkpoint(ckpt):
        state = ac.restore_sharded(ckpt, state)
        start = int(np.asarray(state["step"].addressable_shards[0].data))
    update = jax.jit(lambda s: {"w": s["w"] * 2.0 + 1.0,
                                "step": s["step"] + 1})
    for i in range(start, 3):
        state = update(state)
        # this process's replica-0 blocks only: no collective after the
        # kill can wedge the survivor
        fp = float(sum(np.asarray(s.data, np.float64).sum()
                       for s in state["w"].addressable_shards
                       if s.replica_id == 0))
        t.report({"step": i + 1, "fp": fp, "resumed_from": start},
                 checkpoint=ac.save_to_checkpoint(state))


def loop_torch(config):
    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train as t
    from ray_tpu_torch.train import array_checkpoint as ac

    assert dist.is_initialized() and dist.get_world_size() == 2
    state = {"w": torch.arange(32, dtype=torch.float32).reshape(8, 4),
             "step": torch.zeros((), dtype=torch.int32)}
    start = 0
    ckpt = t.get_checkpoint()
    if ckpt is not None and ac.is_sharded_checkpoint(ckpt):
        state = ac.restore_sharded(ckpt, state)
        start = int(state["step"])
    for i in range(start, 3):
        state = {"w": state["w"] * 2.0 + 1.0, "step": state["step"] + 1}
        # rank 0 holds the one copy that checkpoints keep (JAX's
        # replica 0)
        fp = (float(state["w"].double().sum())
              if dist.get_rank() == 0 else 0.0)
        t.report({"step": i + 1, "fp": fp, "resumed_from": start},
                 checkpoint=ac.save_to_checkpoint(state))


if pkg == "ray_tpu":
    from ray_tpu.train.backend import JaxConfig as Config
    trainer, loop = train.JaxTrainer, loop_jax
    config = Config(distributed="on", platform="cpu",
                    xla_flags="--xla_force_host_platform_device_count=2")
else:
    trainer, loop = train.TorchTrainer, loop_torch
    config = train.TorchConfig(distributed="on", platform="cpu")
try:
    r = trainer(loop, backend_config=config,
                scaling_config=air.ScalingConfig(num_workers=2),
                run_config=air.RunConfig(
                    storage_path=storage, name="commitkill",
                    failure_config=air.FailureConfig(max_failures=1))).fit()
    ckpt = r.checkpoint.path
    shards = sorted(os.listdir(ckpt + "_shards"))
    out = {"metrics": r.metrics, "shards": shards,
           "history": [[m["step"], m["resumed_from"]]
                       for m in r.metrics_history]}
finally:
    rt.shutdown()
print(json.dumps(out))
'''


def _start(script, tmp_path):
    """Starts `script` against each package, each in its own process."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    env.pop("RAY_TPU_LOCKDEP", None)
    return {pkg: subprocess.Popen(
        [sys.executable, "-c", script, pkg, str(tmp_path / pkg)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pkg in ("ray_tpu", "ray_tpu_torch")}


def _results(procs):
    """Each package's JSON result: (JAX package's, port's)."""
    results = {}
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=400)
        assert proc.returncode == 0, f"{pkg}: {err[-4000:]}"
        results[pkg] = json.loads(out.strip().splitlines()[-1])
    return results["ray_tpu"], results["ray_tpu_torch"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both scripts on both packages, all four started at once (each
    takes about a minute, mostly the harness's result polling)."""
    procs = {name: _start(script, tmp_path_factory.mktemp(name))
             for name, script in (("scenarios", SCENARIOS),
                                  ("commit_kill", COMMIT_KILL))}
    try:
        yield {name: _results(p) for name, p in procs.items()}
    finally:
        for p in procs.values():
            for proc in p.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


@pytest.fixture()
def scenarios(runs):
    return runs["scenarios"]


def test_two_worker_report_lockstep(scenarios):
    want, got = scenarios
    assert want["lockstep"][0]["step"] == 2
    assert want["lockstep"][0]["val"] == 12
    assert want["lockstep"][0]["local"] == [0, 2, 0]
    assert want["lockstep"][1:] == [True, [0, 1, 2]]
    assert got["lockstep"] == want["lockstep"]


def test_checkpoint_roundtrip_and_topk(scenarios):
    want, got = scenarios
    metrics, state, kept = want["topk"]
    assert metrics["score"] == 3.0
    assert state == {"step": 3, "rank": 0}
    assert len(kept) == 2  # top-K eviction happened on disk
    assert got["topk"] == want["topk"]


def test_restore_from_checkpoint(scenarios):
    want, got = scenarios
    assert want["restore"]["resumed_from"] == 42
    assert got["restore"] == want["restore"]


def test_worker_failure_propagates(scenarios):
    want, got = scenarios
    assert want["failure"] == ["TrainingFailedError", True, True]
    assert got["failure"] == want["failure"]


def test_trainer_trains(scenarios):
    """`JaxTrainer` with jax/optax SGD and `TorchTrainer` with torch SGD
    on the same data: the same trajectory, within f32 rounding."""
    want, got = scenarios
    w, g = want["trains"], got["trains"]
    assert w["loss"] < 1e-2
    assert sorted(g) == sorted(w)
    assert g["training_iteration"] == w["training_iteration"] == 1
    np.testing.assert_allclose(g["first"], w["first"], rtol=1e-5)
    np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
    np.testing.assert_allclose(g["w"], w["w"], rtol=1e-5)


def test_commit_kill_walks_back_to_gang_durable(runs):
    """The kill lands between rank 1's shard persist and the gang commit
    of step 2: the walk-back must resume from step 1 (the last
    committed checkpoint) on both packages, bit-identically, and the
    kept checkpoint has both ranks' contributions."""
    want, got = runs["commit_kill"]
    assert want["metrics"]["step"] == 3
    assert want["metrics"]["resumed_from"] == 1
    w = np.arange(32, dtype=np.float64).reshape(8, 4)
    for _ in range(3):
        w = w * 2.0 + 1.0
    assert want["metrics"]["fp"] == float(w.sum())
    assert want["shards"] == ["rank_1"]
    assert got == want
