"""The port's distributed train plane as a whole, on a multi-rank gang:
`TorchTrainer` with `TorchConfig(distributed="on", platform="cpu")`
joins two train workers in a gloo process group.

* Data parallel training of the tiny GPT: each rank takes half of the
  batch and all-reduces the mean of its gradients (one flat bucket,
  inside the step run by `TrainStepRunner`), for 3 AdamW steps. Held to
  the JAX package's single-process full-batch `jax.grad` + optax steps on
  the same weights (carried across by `models/convert.py`): the losses
  within 1e-5 relative, the gang's mean gradient within 1e-5 of each
  leaf's largest magnitude, the final parameters within 1e-5.
* The elastic scenario of tests/test_sharded_checkpoint.py with a
  replicated carry: rank 1 is killed mid-run, the step's checkpoint is
  left without rank 1's contribution, the retry walks back to the last
  complete one (`resumed_from == 2`) and the result is bit-identical.
* Multi-rank array checkpoints cross between the packages: the gang's
  2-rank checkpoint passes the JAX package's `is_usable` and its
  `restore_sharded` gives the port's values; a checkpoint written by a
  2-process `jax.distributed` gang of the JAX package (a leaf sharded
  across the processes) restores in the port.
"""

import json
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: spare the other workers' cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu.models import gpt as jgpt  # noqa: E402
from ray_tpu.ops import flash_attention as jflash  # noqa: E402
from ray_tpu.ops import fused_cross_entropy as jfused_ce  # noqa: E402
from ray_tpu.train import array_checkpoint as jac  # noqa: E402
from ray_tpu_torch import train  # noqa: E402
from ray_tpu_torch.air import FailureConfig, RunConfig, ScalingConfig  # noqa: E402,E501
from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.models import gpt as tgpt  # noqa: E402
from ray_tpu_torch.train import array_checkpoint as tac  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
LR, WD, STEPS, BATCH = 3e-4, 1e-4, 3, 4

# A 2-process jax.distributed gang of the JAX package writes one
# checkpoint: "w" sharded by rows across the processes, "b" a replicated
# bf16 leaf, "step" a host value. argv: storage dir; prints its path.
JAX_GANG_CHECKPOINT = r'''
import json, sys
import ray_tpu
from ray_tpu import train
from ray_tpu.air import RunConfig, ScalingConfig
from ray_tpu.train.backend import JaxConfig


def loop(config):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ray_tpu import train as t
    from ray_tpu.train import array_checkpoint as ac

    assert jax.process_count() == 2
    mesh = Mesh(np.array(jax.devices()), ("dp",))
    w = np.arange(48, dtype=np.float32).reshape(8, 6) / 7.0
    b = (np.arange(6, dtype=np.float32) - 2.5).astype(jnp.bfloat16)
    state = {
        "w": jax.make_array_from_callback(
            w.shape, NamedSharding(mesh, P("dp")), lambda idx: w[idx]),
        "b": jax.make_array_from_callback(
            b.shape, NamedSharding(mesh, P()), lambda idx: b[idx]),
        "step": 7}
    t.report({"done": True}, checkpoint=ac.save_to_checkpoint(state))


ray_tpu.init(num_cpus=4, num_tpus=0, object_store_memory=128 << 20)
try:
    result = train.JaxTrainer(
        loop,
        backend_config=JaxConfig(
            distributed="on", platform="cpu",
            xla_flags="--xla_force_host_platform_device_count=1"),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=sys.argv[1], name="jaxgang"),
    ).fit()
finally:
    ray_tpu.shutdown()
print(json.dumps({"path": result.checkpoint.path}))
'''


@pytest.fixture(scope="module")
def jax_gang(tmp_path_factory):
    """The JAX gang's checkpoint, written by a subprocess that runs
    while this module's port cluster trains."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    env.pop("RAY_TPU_LOCKDEP", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_GANG_CHECKPOINT,
         str(tmp_path_factory.mktemp("jaxgang"))], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def cluster(jax_gang):
    ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                       object_store_memory=128 * 1024 * 1024)
    yield
    ray_tpu_torch.shutdown()


# -- data-parallel tiny GPT against jax.grad + optax ---------------------------


@pytest.fixture(scope="module")
def reference():
    """The JAX package's tiny GPT (f32, flash attention, fused CE on the
    tied head) trained on the full batch by 3 optax.adamw steps: its
    initial weights, the batch, the losses and the final weights."""
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32)
    net = jgpt.GPT(jcfg, attention_fn=partial(jflash, causal=True))
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (BATCH, 33)).astype(np.int32)
    inputs, targets = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])
    params = jax.jit(net.init)(jax.random.PRNGKey(1), inputs)

    def loss_fn(p):
        hidden, wte = net.apply(p, inputs, return_hidden=True)
        return jfused_ce(hidden, wte, targets)

    tx = optax.adamw(LR, weight_decay=WD)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(loss_fn)(p)
        updates, s = tx.update(g, s, p)
        return optax.apply_updates(p, updates), s, loss

    grads = jax.jit(jax.grad(loss_fn))(params)
    p, s, losses = params, tx.init(params), []
    for _ in range(STEPS):
        p, s, loss = step(p, s)
        losses.append(float(loss))
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32, remat=False)

    def port(tree):
        arrays = jax.tree_util.tree_map(np.asarray,
                                        jgpt.unboxed_params(tree))
        return {n: t.numpy() for n, t in convert.gpt_params_from_jax(
            arrays, cfg, device="cpu", dtype=torch.float32).items()}

    return dict(init=port(params), final=port(p), grads=port(grads),
                losses=losses, toks=toks)


def _make_dp_loop():
    # a factory, so that cloudpickle sends the loop by value: the train
    # workers cannot import this test module
    def loop(config):
        """Each rank trains on its half of the batch; the gradients and the
        loss are averaged over the gang by one all-reduce of a flat bucket
        inside the step."""
        from functools import partial as partial_

        import torch as torch_
        import torch.distributed as dist

        from ray_tpu_torch import train as t
        from ray_tpu_torch.models import gpt
        from ray_tpu_torch.ops.flash_attention import flash_attention
        from ray_tpu_torch.ops.fused_ce import fused_cross_entropy
        from ray_tpu_torch.train import array_checkpoint as ac

        torch_.set_num_threads(1)
        rank, world = dist.get_rank(), dist.get_world_size()
        cfg = gpt.GPTConfig.tiny(dtype=torch_.float32, remat=False)
        net = gpt.GPT.from_params(
            cfg, {n: torch_.from_numpy(a) for n, a in config["init"].items()},
            attention_fn=partial_(flash_attention, causal=True),
            trainable=True)
        params = dict(net.named_parameters())
        opt = torch_.optim.AdamW(params.values(), lr=config["lr"],
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=config["wd"])
        toks = torch_.from_numpy(config["toks"]).long()
        half = toks.shape[0] // world
        mine = toks[rank * half:(rank + 1) * half]
        batch = {"x": mine[:, :-1], "y": mine[:, 1:]}

        def step(carry, data):
            hidden, wte = net(data["x"], return_hidden=True)
            loss = fused_cross_entropy(hidden, wte, data["y"])
            loss.backward()
            grads = [p.grad for p in params.values()]
            flat = torch_.cat([loss.detach().reshape(1)]
                              + [g.reshape(-1) for g in grads])
            dist.all_reduce(flat)
            flat /= world
            off = 1
            for g in grads:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()
            if not first:  # the gang's mean gradient of step 1
                first.update({n: p.grad.clone().numpy()
                              for n, p in params.items()})
            opt.step()
            opt.zero_grad(set_to_none=True)
            return carry, flat[0]

        first = {}
        runner = t.TrainStepRunner(step, device="cpu")
        carry = {"params": params}
        for i in range(config["steps"]):
            carry, loss = runner.run(carry, batch)
            last = i == config["steps"] - 1
            t.report({"loss": float(loss), "rank": rank, "world": world,
                      "grads": first if i == 0 and rank == 0 else None},
                     checkpoint=(ac.save_to_checkpoint(
                         {"params": {n: p.detach() for n, p in
                                     params.items()}, "step": i + 1})
                         if last else None))

    return loop


@pytest.fixture(scope="module")
def dp_result(cluster, reference, tmp_path_factory):
    return train.TorchTrainer(
        _make_dp_loop(),
        train_loop_config=dict(init=reference["init"], toks=reference["toks"],
                               lr=LR, wd=WD, steps=STEPS),
        backend_config=train.TorchConfig(distributed="on", platform="cpu"),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=str(tmp_path_factory.mktemp("dp")),
                             name="dp"),
    ).fit()


def test_two_rank_gloo_gpt_matches_jax_full_batch(dp_result, reference):
    """The losses within 1e-5 relative; the gang's mean gradient of step
    1 within 1e-5 of each leaf's largest magnitude of the full-batch
    `jax.grad`; the final parameters within 1e-5 absolute, the tolerance
    of tests/test_torch_train.py's AdamW-vs-optax steps. (AdamW moves a
    weight by about lr per step whatever its gradient's size, so where a
    gradient is at rounding level — the key slice of each `attn_qkv.bias`,
    whose gradient is exactly 0 since softmax ignores a shift shared by
    all keys — the final weight carries the rounding noise of the
    all-reduce's summation order: up to 2.5e-6 here, against 9e-9 for
    1e-5 of that leaf's largest magnitude.)"""
    result = dp_result
    assert result.metrics["world"] == 2 and result.metrics["rank"] == 0
    losses = [m["loss"] for m in result.metrics_history]
    np.testing.assert_allclose(losses, reference["losses"], rtol=1e-5)
    assert losses[-1] < losses[0]
    grads = result.metrics_history[0]["grads"]
    assert grads.keys() == reference["grads"].keys()
    for n, want in reference["grads"].items():
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(grads[n], want, atol=1e-5 * scale,
                                   rtol=0, err_msg=n)
    like = {"params": {n: torch.zeros(a.shape) for n, a in
                       reference["final"].items()}, "step": 0}
    got = tac.restore_sharded(result.checkpoint, like)
    assert got["step"] == STEPS
    for n, want in reference["final"].items():
        np.testing.assert_allclose(got["params"][n].numpy(), want,
                                   atol=1e-5, rtol=0, err_msg=n)


def test_port_gang_checkpoint_restores_in_jax(dp_result, reference):
    """The 2-rank checkpoint (rank 0 wrote every leaf; rank 1 its index
    with empty shard lists, in `<dir>_shards/rank_1`) is usable and
    restores in the JAX package to the port's own restore."""
    path = dp_result.checkpoint.path
    assert os.listdir(path + "_shards") == ["rank_1"]
    with open(os.path.join(path + "_shards", "rank_1",
                           "asv_index.1.json")) as f:
        idx1 = json.load(f)
    assert idx1["num_processes"] == 2
    assert all(leaf.get("shards", []) == [] for leaf in idx1["leaves"])
    assert jac.is_usable(path) and tac.is_usable(path)
    like_np = {"params": {n: np.zeros(a.shape, np.float32) for n, a in
                          reference["final"].items()}, "step": 0}
    want = jac.restore_sharded(path, like_np)
    like = {"params": {n: torch.zeros(a.shape) for n, a in
                       reference["final"].items()}, "step": 0}
    got = tac.restore_sharded(path, like)
    assert want["step"] == got["step"] == STEPS
    for n, w in want["params"].items():
        assert np.array_equal(np.asarray(w), got["params"][n].numpy()), n


def test_jax_gang_checkpoint_restores_in_port(jax_gang):
    out, err = jax_gang.communicate(timeout=300)
    assert jax_gang.returncode == 0, err[-4000:]
    path = json.loads(out.strip().splitlines()[-1])["path"]
    indexes = sorted(
        os.path.basename(os.path.dirname(p)) + "/" + os.path.basename(p)
        for d in (path, path + "_shards/rank_1")
        for p in [os.path.join(d, f) for f in os.listdir(d)]
        if os.path.basename(p).startswith("asv_index"))
    assert len(indexes) == 2
    assert tac.is_usable(path)
    got = tac.restore_sharded(path, {"w": torch.zeros(8, 6),
                                     "b": torch.zeros(6,
                                                      dtype=torch.bfloat16),
                                     "step": 0})
    w = np.arange(48, dtype=np.float32).reshape(8, 6) / 7.0
    assert np.array_equal(got["w"].numpy(), w)
    b = torch.arange(6, dtype=torch.float32) - 2.5
    assert torch.equal(got["b"], b.to(torch.bfloat16))
    assert got["step"] == 7


# -- elastic: a killed rank, a walk-back, a bit-identical resume ---------------


def _make_elastic_loop():
    # a factory, so that cloudpickle sends the loop by value: the train
    # workers cannot import this test module
    def loop(config):
        import os as os_mod

        import torch as torch_
        import torch.distributed as dist

        from ray_tpu_torch import train as t
        from ray_tpu_torch.train import array_checkpoint as ac

        state = {"w": torch_.arange(32, dtype=torch_.float32).reshape(8, 4),
                 "step": torch_.zeros((), dtype=torch_.int32)}
        start = 0
        ckpt = t.get_checkpoint()
        if ckpt is not None and ac.is_sharded_checkpoint(ckpt):
            state = ac.restore_sharded(ckpt, state)
            start = int(state["step"])
        rank = dist.get_rank()
        for i in range(start, 4):
            if i == 2 and rank == 1 and start == 0:
                # hardware loss, first attempt only: the step-2 report (i ==
                # 1) returned here only after the gang committed it
                t.report({"step": i, "pre_crash": True})
                os_mod._exit(1)
            state = {"w": state["w"] * 2.0 + 1.0, "step": state["step"] + 1}
            # a local fingerprint (no collective: a dead peer cannot wedge
            # the survivor)
            fp = float(state["w"].double().sum())
            t.report({"step": i + 1, "fp": fp, "resumed_from": start,
                      "rank": rank},
                     checkpoint=ac.save_to_checkpoint(state))

    return loop


def test_elastic_restore_bit_identical(cluster, tmp_path):
    result = train.TorchTrainer(
        _make_elastic_loop(),
        backend_config=train.TorchConfig(distributed="on", platform="cpu"),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(
            storage_path=str(tmp_path / "results"), name="elastic",
            failure_config=FailureConfig(max_failures=1)),
    ).fit()
    assert result.metrics["step"] == 4
    assert result.metrics["resumed_from"] == 2
    w = np.arange(32, dtype=np.float64).reshape(8, 4)
    for _ in range(4):
        w = w * 2.0 + 1.0
    assert result.metrics["fp"] == float(w.sum())
    # the step-3 checkpoint of the first attempt lacked rank 1's index:
    # never registered; the resumed run's checkpoints have both
    assert tac.is_usable(result.checkpoint)
    assert [m["step"] for m in result.metrics_history][-2:] == [3, 4]


def test_cuda_platform_worker_without_a_gpu_raises(cluster, tmp_path):
    """`TorchConfig(platform="cuda")` on a node with no GPU: the worker
    sees no CUDA device and the run fails; it never trains on the CPU."""
    def loop(config):
        train.report({"ran": True})

    with pytest.raises(train.TrainingFailedError,
                       match="sees no CUDA device"):
        train.TorchTrainer(
            loop, scaling_config=ScalingConfig(num_workers=1),
            backend_config=train.TorchConfig(platform="cuda"),
            run_config=RunConfig(storage_path=str(tmp_path), name="nogpu"),
        ).fit()


def test_cpu_platform_worker_starts_without_torch(cluster, tmp_path):
    """`TorchConfig(distributed="off", platform="cpu")` forms no group
    and has nothing to check, so the workers start without importing
    torch (the JAX backend imports nothing there either): a loop that
    does not import torch finds it unimported."""
    def loop(config):
        import sys as sys_

        train.report({"torch": "torch" in sys_.modules})

    result = train.TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=2),
        backend_config=train.TorchConfig(distributed="off", platform="cpu"),
        run_config=RunConfig(storage_path=str(tmp_path), name="cpuoff"),
    ).fit()
    assert result.metrics["torch"] is False
