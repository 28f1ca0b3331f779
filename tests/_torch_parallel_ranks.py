"""Rank programs of the port's `parallel/` tests (torch and numpy only).

`tests/test_torch_parallel.py` holds `ray_tpu_torch.parallel` against the
JAX package. Its JAX side runs in the test process; the port side runs
here, in gloo process groups of CPU ranks, one process per rank:

    python tests/_torch_parallel_ranks.py GANG WORLD RANK STORE INPUTS OUT

GANG names a list of scenarios (`GANGS`), or is a comma-separated list
of scenario functions (to run some alone); each writes the global values it
computed (gathered from the ranks) into rank 0's result pickle at OUT.
INPUTS is a pickle of what the JAX side made (the tiny GPT's Flax params
as numpy). The scenarios' other inputs come from numpy seeds through the
`*_inputs` functions below, which the test calls too. `run_gang` starts a
gang and waits for it. This module must not import the test module: it
imports JAX.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


# -- inputs shared with the JAX side -------------------------------------------

def ring_inputs():
    rng = np.random.RandomState(0)
    b, t, h, d = 2, 32, 4, 8
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(3)]


def ring_grad_inputs():
    rng = np.random.RandomState(1)
    return [rng.randn(1, 64, 2, 4).astype(np.float32) for _ in range(3)]


def ulysses_inputs():
    rng = np.random.RandomState(2)
    return [rng.randn(2, 16, 4, 8).astype(np.float32) for _ in range(3)]


def gqa_inputs():
    rng = np.random.default_rng(0)
    b, t, h, h_kv, d = 2, 64, 8, 2, 16
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, h_kv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, h_kv, d)).astype(np.float32)
    k4 = rng.standard_normal((b, t, 4, d)).astype(np.float32)
    v4 = rng.standard_normal((b, t, 4, d)).astype(np.float32)
    return q, k, v, k4, v4


def pipeline_seq_inputs():
    rng = np.random.RandomState(3)
    ws = [(rng.randn(16, 16) * 0.1).astype(np.float32) for _ in range(4)]
    return np.stack(ws), rng.randn(8, 16).astype(np.float32)


def pipeline_grad_inputs():
    rng = np.random.RandomState(4)
    ws = np.stack([(rng.randn(8, 8) * 0.1).astype(np.float32)
                   for _ in range(2)])
    return ws, rng.randn(4, 8).astype(np.float32)


# (seed, stages, batch, dim, microbatches, weight scale): the fused-loss
# case of test_parallel.py and the stack of __graft_entry__._dryrun_pp(4)
FUSED_CASES = {"test_parallel": (7, 4, 16, 8, 8, 0.3),
               "dryrun_pp": (0, 4, 16, 8, 8, 0.1)}


def fused_inputs(case):
    seed, s, batch, dim, _, scale = FUSED_CASES[case]
    rng = np.random.RandomState(seed)
    ws = np.stack([(rng.randn(dim, dim) * scale).astype(np.float32)
                   for _ in range(s)])
    return ws, rng.randn(batch, dim).astype(np.float32), \
        rng.randn(batch, dim).astype(np.float32)


def scalar_loss_inputs():
    rng = np.random.RandomState(8)
    ws = np.stack([(rng.randn(4, 4) * 0.1).astype(np.float32)
                   for _ in range(2)])
    return ws, rng.randn(8, 4).astype(np.float32), \
        rng.randn(8, 4).astype(np.float32)


def moe_inputs():
    rng = np.random.RandomState(5)
    b, s, d, e = 2, 16, 8, 4
    return (rng.randn(b, s, d).astype(np.float32),
            (rng.randn(d, e) * 0.1).astype(np.float32),
            (rng.randn(e, d, d) * 0.1).astype(np.float32))


# the tiny GPT of the sharded steps: four heads, so that sp=2 divides each
# tp=2 rank's two heads (Ulysses)
GPT_CFG = dict(n_layer=2, n_head=4, d_model=64, vocab_size=512,
               max_seq_len=128)
GPT_LR = 1e-3


def gpt_tokens(batch=4, seq=32, seed=11):
    rng = np.random.default_rng(seed)
    return rng.integers(0, GPT_CFG["vocab_size"], (batch, seq + 1),
                        dtype=np.int64).astype(np.int32)


def pick_strategy(n_devices: int):
    """`__graft_entry__._pick_strategy`: peel factors of two onto fsdp, tp,
    sp; the rest is dp."""
    from ray_tpu_torch.parallel import ShardingStrategy

    axes = {"fsdp": 1, "tp": 1, "sp": 1}
    rem = n_devices
    for name in ("fsdp", "tp", "sp"):
        if rem % 2 == 0:
            axes[name] = 2
            rem //= 2
    return ShardingStrategy(dp=rem, **axes)


# -- scenarios (every rank runs each; rank 0's return value is kept) ----------

def _t(a, requires_grad=False):
    import torch

    return torch.tensor(a, requires_grad=requires_grad)


def _np(x):
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().numpy()


def _all_sum(x):
    import torch.distributed as dist

    x = x.clone()
    dist.all_reduce(x)
    return x


def sc_mesh():
    from ray_tpu_torch.parallel import build_hybrid_mesh, build_mesh

    mesh = build_mesh({"dp": 1, "fsdp": 2, "tp": 2}, device="cpu")
    hyb = build_hybrid_mesh({"fsdp": 2}, {"dcn": 2}, device="cpu")
    return {"mesh_shape": mesh.shape, "mesh_ranks": mesh.devices.tolist(),
            "mesh_dim_names": mesh.device_mesh.mesh_dim_names,
            "hybrid_names": hyb.axis_names, "hybrid_shape": hyb.shape,
            "hybrid_ranks": hyb.devices.tolist(),
            "hybrid_fsdp_group_size": hyb.group("fsdp").size()}


def sc_device_allreduce():
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel import build_mesh, collectives

    mesh = build_mesh({"dp": 4}, device="cpu")
    x = torch.arange(4.0)[dist.get_rank()].reshape(1)
    return {"out": _np(collectives.device_allreduce(mesh, x, axis="dp"))}


def sc_collectives():
    """The in-program ops' values (and allgather's gradient) over a
    {"dp": 2, "tp": 2} mesh."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel import build_mesh, collectives as c

    mesh = build_mesh({"dp": 2, "tp": 2}, device="cpu")
    r = float(dist.get_rank())
    x = torch.full((2, 2), r, requires_grad=True)
    g = c.allgather(x, "tp", gather_dim=1, mesh=mesh)
    (g * torch.arange(4.0)).sum().backward()
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, {
        "allreduce": c.allreduce(torch.tensor([r]), ("dp", "tp"),
                                 mesh=mesh).item(),
        "mean": c.allreduce_mean(torch.tensor([r]), "tp", mesh=mesh).item(),
        "gather": g.detach().numpy(), "gather_grad": x.grad.numpy(),
        "rs": c.reducescatter(torch.arange(4.0) + r, "tp",
                              mesh=mesh).numpy(),
        "a2a": c.all_to_all(torch.arange(4.0).reshape(2, 2) + 10 * r, "dp",
                            split_dim=0, concat_dim=1, mesh=mesh).numpy(),
        "permute": c.ring_permute(torch.tensor([r]), "tp",
                                  mesh=mesh).item(),
        "bcast": c.broadcast(torch.tensor([r]), "dp", root=1,
                             mesh=mesh).item(),
        "index": c.axis_index("tp", mesh=mesh)})
    return {"per_rank": gathered, "ranks": mesh.devices.tolist()}


def sc_ring():
    from ray_tpu_torch.parallel import build_mesh
    from ray_tpu_torch.parallel.ring_attention import ring_attention

    mesh = build_mesh({"dp": 2, "sp": 2}, device="cpu")
    q, k, v = (_t(a) for a in ring_inputs())
    return {causal: _np(ring_attention(q, k, v, mesh, causal=causal,
                                       head_axis=None))
            for causal in (False, True)}


def sc_ring_grad():
    from ray_tpu_torch.parallel import build_mesh
    from ray_tpu_torch.parallel.ring_attention import ring_attention

    mesh = build_mesh({"sp": 4}, device="cpu")
    q, k, v = (_t(a, True) for a in ring_grad_inputs())
    out = ring_attention(q, k, v, mesh, causal=True, head_axis=None,
                         batch_axes=())
    out.to_local().sum().backward()
    # the global loss is the sum of the ranks' blocks: sum their grads
    return {n: _np(_all_sum(x.grad)) for n, x in zip("qkv", (q, k, v))}


def sc_ulysses():
    from ray_tpu_torch.parallel import build_mesh
    from ray_tpu_torch.parallel.ring_attention import ulysses_attention

    mesh = build_mesh({"sp": 2, "dp": 2}, device="cpu")
    q, k, v = (_t(a) for a in ulysses_inputs())
    return {causal: _np(ulysses_attention(q, k, v, mesh, causal=causal))
            for causal in (False, True)}


def sc_gqa():
    from ray_tpu_torch.parallel import build_mesh
    from ray_tpu_torch.parallel.ring_attention import (ring_attention,
                                                       ulysses_attention)

    mesh = build_mesh({"sp": 4}, device="cpu")
    q, k, v, k4, v4 = (_t(a) for a in gqa_inputs())
    return {"ring": _np(ring_attention(q, k, v, mesh, causal=True,
                                       head_axis=None)),
            "ulysses": _np(ulysses_attention(q, k, v, mesh, causal=True)),
            "ulysses4": _np(ulysses_attention(q, k4, v4, mesh,
                                              causal=True))}


def _tanh_stage(p, h):
    return (h @ p["w"]).tanh()


def _mse(out, tgt):
    return ((out - tgt) ** 2).mean()


def sc_pipeline():
    import torch

    from ray_tpu_torch.parallel import build_mesh
    from ray_tpu_torch.parallel.pipeline import (bubble_fraction,
                                                 pipeline_apply,
                                                 pipeline_loss,
                                                 pipeline_train_step)

    out = {}
    ws, x = pipeline_seq_inputs()
    mesh4 = build_mesh({"pp": 4}, device="cpu")
    out["seq"] = _np(pipeline_apply(_tanh_stage, {"w": _t(ws)}, _t(x),
                                    mesh4, num_microbatches=4))
    # the grad case at pp=2, its batch split over dp=2
    mesh22 = build_mesh({"pp": 2, "dp": 2}, device="cpu")
    ws, x = pipeline_grad_inputs()
    w = _t(ws, True)
    pipeline_apply(_tanh_stage, {"w": w}, _t(x), mesh22,
                   num_microbatches=2).to_local().sum().backward()
    out["grad"] = _np(_all_sum(w.grad))
    for case, (_, _, _, _, n_mb, _) in FUSED_CASES.items():
        ws, x, y = fused_inputs(case)
        for remat in (True, False):
            loss, grads = pipeline_train_step(
                _tanh_stage, _mse, {"w": _t(ws)}, _t(x), _t(y), mesh4,
                num_microbatches=n_mb, remat=remat)
            out[f"fused:{case}:{remat}"] = (loss.item(),
                                            _np(grads["w"]))
    # the whole batch on each pp pair (tp is no data axis), as at pp=2 alone
    ws, x, y = scalar_loss_inputs()
    loss = pipeline_loss(lambda p, h: h @ p["w"], _mse, {"w": _t(ws)},
                         _t(x), _t(y), build_mesh({"pp": 2, "tp": 2},
                                                  device="cpu"),
                         num_microbatches=4)
    out["scalar"] = (tuple(loss.shape), _np(loss))
    out["bubble"] = (bubble_fraction(2, 4), bubble_fraction(4, 16),
                     bubble_fraction(4, 4))
    assert isinstance(loss, torch.Tensor)
    return out


def sc_moe():
    from ray_tpu_torch.parallel import build_mesh
    from ray_tpu_torch.parallel.moe import apply_moe

    x, router_w, expert_w = (_t(a) for a in moe_inputs())

    def expert_fn(w, tokens):
        return tokens @ w

    out = {}
    for name, axes in (("ep", {"ep": 2, "dp": 2}), ("dense", {"dp": 4})):
        mesh = build_mesh(axes, device="cpu")
        y, aux = apply_moe(x, router_w, expert_w, expert_fn, mesh,
                           capacity_factor=8.0)
        out[name] = (_np(y), aux.item())
    return out


def sc_multislice():
    import torch.distributed as dist

    from ray_tpu_torch.parallel import ShardingStrategy, shard_batch
    from ray_tpu_torch.parallel import collectives

    strategy = ShardingStrategy(dcn_dp=2, fsdp=2)
    mesh = strategy.build_mesh(device="cpu")
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    xs = shard_batch(x, mesh, strategy)
    total = collectives.allreduce(xs.to_local().sum(), strategy.data_axes,
                                  mesh=mesh)
    return {"data_axes": strategy.data_axes, "names": mesh.axis_names,
            "sum": total.item(), "local": xs.to_local().numpy(),
            "rank": dist.get_rank()}


def sc_compile_cache():
    """Keys by mesh: a hit on the same mesh (rebuilt), a miss without a
    retrace on another."""
    import torch

    from ray_tpu_torch.parallel import build_mesh, compile_cache as cc

    def f(x):
        return x * 2

    cache = cc.ExecutableCache()
    mesh_a = build_mesh({"dp": 2, "tp": 2}, device="cpu")
    mesh_a2 = build_mesh({"dp": 2, "tp": 2}, device="cpu")
    mesh_b = build_mesh({"fsdp": 4}, device="cpu")
    x = torch.ones(3)
    cc.compiled_step(f, mesh=mesh_a, cache=cache)(x)
    cc.compiled_step(f, mesh=mesh_a2, cache=cache)(x)
    after_same = cache.stats.as_dict()
    cc.compiled_step(f, mesh=mesh_b, cache=cache)(x)
    return {"after_same": after_same, "after_other": cache.stats.as_dict(),
            "keys": sorted(cc.cache_stats()),
            "key_a": cc._mesh_key(mesh_a), "key_b": cc._mesh_key(mesh_b)}


def _gpt_model(tree, mesh, strategy, device="cpu"):
    import torch

    from ray_tpu_torch.models import convert, gpt
    from ray_tpu_torch.ops import flash_attention
    from ray_tpu_torch.parallel import logical_axis_rules
    from ray_tpu_torch.parallel.sharding import param_shardings

    cfg = gpt.GPTConfig(**GPT_CFG, dtype=torch.float32, remat=False)
    shardings = param_shardings(mesh, gpt.param_logical_axes(cfg),
                                logical_axis_rules(strategy))
    placed = convert.gpt_params_from_jax(tree, cfg, dtype=torch.float32,
                                         mesh=mesh, shardings=shardings)
    model = gpt.GPT.from_params(cfg, placed,
                                attention_fn=partial(flash_attention,
                                                     causal=True),
                                trainable=True)
    return cfg, model, placed, shardings


def gpt_sharded_step(tree, n, steps_per_call=1):
    """One AdamW step of the tiny GPT at `pick_strategy(n)` through
    `TrainStepRunner(mesh=)` on the CPU: the global loss before the update
    and every parameter after it, gathered."""
    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import shard_batch
    from ray_tpu_torch.train import TrainStepRunner

    strategy = pick_strategy(n)
    mesh = strategy.build_mesh(device="cpu")
    cfg, model, placed, shardings = _gpt_model(tree, mesh, strategy)
    params = dict(model.named_parameters())
    opt = torch.optim.AdamW(params.values(), lr=GPT_LR, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    toks = gpt_tokens()
    batch = shard_batch({"x": toks[:, :-1], "y": toks[:, 1:]}, mesh,
                        strategy)
    data = {k: v.to_local() for k, v in batch.items()}

    def step(carry, data):
        loss = gpt.sharded_loss(model, data["x"], data["y"], mesh, shardings)
        loss.backward()
        gpt.reduce_gradients(params, mesh, shardings)
        opt.step()
        opt.zero_grad(set_to_none=True)
        return carry, gpt.global_loss(loss, mesh)

    runner = TrainStepRunner(step, mesh=mesh, device="cpu")
    _, loss = runner.run({}, data)
    after = {name: DTensor.from_local(p.detach(), mesh.device_mesh,
                                      shardings[name]).full_tensor().numpy()
             for name, p in params.items()}
    local_shapes = {name: tuple(p.shape) for name, p in params.items()}
    return {"loss": loss.item(), "params": after, "mesh": mesh.shape,
            "local_shapes": local_shapes, "cache": runner.cache_stats(),
            "batch_local": tuple(data["x"].shape)}


def sc_gpt4(inputs):
    return gpt_sharded_step(inputs["gpt_tree"], 4)


def sc_convert(inputs):
    """The sharded carry of the JAX params, gathered back, and this rank's
    local shapes."""
    strategy = pick_strategy(4)
    mesh = strategy.build_mesh(device="cpu")
    _, _, placed, shardings = _gpt_model(inputs["gpt_tree"], mesh, strategy)
    return {"full": {n: _np(p) for n, p in placed.items()},
            "local_shapes": {n: tuple(p.to_local().shape)
                             for n, p in placed.items()},
            "placements": {n: repr(p) for n, p in shardings.items()}}


def sc_gpt8(inputs):
    return gpt_sharded_step(inputs["gpt_tree"], 8)


GANGS = {
    "w4": [sc_mesh, sc_device_allreduce, sc_collectives, sc_ring,
           sc_ring_grad, sc_ulysses, sc_gqa, sc_pipeline, sc_moe,
           sc_multislice, sc_compile_cache, sc_gpt4, sc_convert],
    "w8": [sc_gpt8],
}


def main(argv):
    gang, world, rank, store, inputs_path, out = argv
    world, rank = int(world), int(rank)
    import inspect

    import torch
    import torch.distributed as dist

    torch.manual_seed(0)
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    results = {}
    try:
        fns = GANGS.get(gang) or [globals()[n] for n in gang.split(",")]
        for fn in fns:
            args = (inputs,) if inspect.signature(fn).parameters else ()
            results[fn.__name__] = fn(*args)
            dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def run_gang(gang: str, world: int, tmp: Path, inputs: dict,
             timeout: float = 240.0) -> dict:
    """Run GANG in `world` processes; rank 0's results. Raises with the
    ranks' output if any fails or the gang outlives `timeout`."""
    tmp.mkdir(parents=True, exist_ok=True)
    inputs_path = tmp / "inputs.pkl"
    with open(inputs_path, "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, gang, str(world), str(r),
         str(tmp / "store"), str(inputs_path), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0,
                                               deadline - time.monotonic()))
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError(f"gang {gang} failed: " + "\n".join(
            f"--- rank {r} rc {p.returncode}\n{log[-3000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    with open(tmp / "rank0.pkl", "rb") as f:
        return pickle.load(f)


if __name__ == "__main__":
    main(sys.argv[1:])
