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

import dataclasses
import os
import pickle
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

from ray_tpu_torch.dryrun import pick_strategy

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


# -- the other model families' sharded steps (test_torch_models_zoo_sharded)


def bert_tokens():
    """`test_bert_shards_like_the_decoders`' tokens."""
    return np.random.default_rng(2).integers(0, 512, (4, 16)).astype(
        np.int32)


def bert_mlm_targets():
    rng = np.random.default_rng(3)
    tokens = bert_tokens()
    return np.where(rng.random(tokens.shape) < 0.3, tokens, -1).astype(
        np.int32)


def sc_bert_sharded(inputs):
    """The tiny BERT (f32 and bf16) at dp=2 tp=2: the gathered hidden
    states of the sharded encoder, the unsharded port's, and the sharded
    MLM loss (summed over the data ranks)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import bert, convert
    from ray_tpu_torch.parallel import (ShardingStrategy, logical_axis_rules,
                                        shard_batch)
    from ray_tpu_torch.parallel.sharding import param_shardings

    strategy = ShardingStrategy(dp=2, tp=2)
    mesh = strategy.build_mesh(device="cpu")
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        cfg = bert.BertConfig.tiny(dtype=dtype, remat=False)
        shardings = param_shardings(mesh, bert.param_logical_axes(cfg),
                                    logical_axis_rules(strategy))
        tree = inputs["bert_tree"]
        placed = convert.bert_params_from_jax(tree, cfg, mesh=mesh,
                                              shardings=shardings)
        model = bert.BertEncoder.from_params(cfg, placed)
        plain = bert.BertEncoder.from_params(
            cfg, convert.bert_params_from_jax(tree, cfg, device="cpu"))
        batch = shard_batch({"x": bert_tokens(), "y": bert_mlm_targets()},
                            mesh, strategy)
        with torch.no_grad():
            hidden, _, spmd = bert.sharded_hidden(
                model, batch["x"].to_local().long(), mesh, shardings)
            loss = bert.sharded_mlm_loss(
                model, batch["x"].to_local().long(),
                batch["y"].to_local().long(), mesh, shardings)
            ref, _ = plain(torch.from_numpy(bert_tokens()).long())
        hidden = hidden.float().contiguous()
        parts = [torch.empty_like(hidden)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(parts, hidden)
        # ranks are (dp, tp) row-major: the dp blocks are ranks 0 and 2
        out[name] = {"hidden": torch.cat([parts[0], parts[2]]).numpy(),
                     "plain": ref.float().numpy(),
                     "loss": float(_all_sum(loss.float()) / 2),
                     "local_wte": tuple(model.wte.shape),
                     "heads": spmd.heads}
    return out


MOE_LR = 1e-3


def sc_moe_gpt_sharded(inputs):
    """The tiny MoE-GPT's two AdamW steps at dp=2 x ep=2 (the expert
    leaves split over ep), global routing: the global losses."""
    import torch

    from ray_tpu_torch.models import convert, gpt, moe_gpt
    from ray_tpu_torch.parallel import (ShardingStrategy, logical_axis_rules,
                                        shard_batch)
    from ray_tpu_torch.parallel.sharding import param_shardings

    strategy = ShardingStrategy(dp=2, ep=2)
    mesh = strategy.build_mesh(device="cpu")
    cfg = moe_gpt.MoEGPTConfig.tiny(dtype=torch.float32, remat=False)
    shardings = param_shardings(mesh, moe_gpt.param_logical_axes(cfg),
                                logical_axis_rules(strategy))
    placed = convert.moe_gpt_params_from_jax(
        inputs["moe_tree"], cfg, dtype=torch.float32, mesh=mesh,
        shardings=shardings)
    model = moe_gpt.MoEGPT.from_params(cfg, placed, trainable=True)
    params = dict(model.named_parameters())
    opt = torch.optim.AdamW(params.values(), lr=MOE_LR, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    toks = inputs["moe_tokens"]
    batch = shard_batch({"x": toks[:, :-1], "y": toks[:, 1:]}, mesh,
                        strategy)
    x, y = (batch[k].to_local().long() for k in ("x", "y"))
    losses = []
    for _ in range(2):
        loss = moe_gpt.sharded_loss(model, x, y, mesh, shardings)
        loss.backward()
        gpt.reduce_gradients(params, mesh, shardings)
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(gpt.global_loss(loss, mesh)))
    return {"losses": losses, "mesh": mesh.shape,
            "local_experts": tuple(params["h0.moe.experts_up"].shape),
            "placements": repr(shardings["h0.moe.experts_up"])}


# -- sharded array checkpoints (test_torch_sharded_checkpoint) -------------


def ckpt_state():
    """`test_cross_topology_restore`'s state, as global numpy values."""
    return {"w": np.arange(32, dtype=np.float32).reshape(8, 4),
            "b": np.full((4,), 2.5, np.float32), "step": 7,
            "rng": np.arange(3)}


def sc_ckpt_save(inputs, out):
    """A (dp=2, tp=2) gang saves a bf16 8x4 leaf sharded (dp, tp), a
    replicated f32 leaf (a DTensor), a plain tensor, an int and a numpy
    array: rank 0 into `<out>/ck`, rank k into `<out>/ck_shards/rank_k`."""
    import json

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel import build_mesh
    from ray_tpu_torch.parallel.sharding import P, as_global, local_block
    from ray_tpu_torch.train import array_checkpoint as ac

    mesh = build_mesh({"dp": 2, "tp": 2}, device="cpu")
    st = ckpt_state()
    w = torch.from_numpy(st["w"]).to(torch.bfloat16)
    state = {"w": as_global(local_block(w, mesh, P("dp", "tp")).contiguous(),
                            mesh, P("dp", "tp"), shape=w.shape),
             "b": as_global(torch.from_numpy(st["b"]), mesh, P(None),
                            shape=(4,)),
             "plain": torch.arange(6, dtype=torch.int32),
             "step": st["step"], "rng": st["rng"]}
    rank = dist.get_rank()
    d = os.path.join(out, "ck") if rank == 0 else os.path.join(
        out, "ck_shards", f"rank_{rank}")
    ac.save_sharded(d, state)
    dist.barrier()
    with open(os.path.join(d, f"asv_index.{rank}.json")) as f:
        index = json.load(f)
    return {"dir": os.path.join(out, "ck"),
            "shards": {leaf["path"]: [sh["index"] for sh in leaf["shards"]]
                       for leaf in index["leaves"] if leaf["kind"] == "array"}}


def sc_ckpt_restore(inputs):
    """The JAX-saved checkpoint at `inputs["jax_ckpt"]` restored onto
    fsdp=4 and (dp=2, tp=2) DTensors: each rank's local block and the
    gathered values."""
    import torch

    from ray_tpu_torch.parallel import build_mesh
    from ray_tpu_torch.parallel.sharding import P, as_global
    from ray_tpu_torch.train import array_checkpoint as ac

    out = {}
    for name, axes, wspec, bspec in (
            ("fsdp4", {"fsdp": 4}, P("fsdp", None), P("fsdp")),
            ("dp2tp2", {"dp": 2, "tp": 2}, P("dp", "tp"), P(None))):
        mesh = build_mesh(axes, device="cpu")

        def like(spec, shape, dtype):
            n = [mesh.axis_size(a) if a else 1 for a in spec]
            local = torch.zeros([s // k for s, k in zip(shape, n)],
                                dtype=dtype)
            return as_global(local, mesh, spec, shape=shape)

        got = ac.restore_sharded(inputs["jax_ckpt"], {
            "w": like(wspec, (8, 4), torch.bfloat16),
            "b": like(bspec, (4,), torch.float32), "step": 0,
            "rng": np.zeros(3, np.int64)})
        out[name] = {"w": _np(got["w"].float()),
                     "w_local": got["w"].to_local().float().numpy(),
                     "w_dtype": str(got["w"].dtype),
                     "b": _np(got["b"]), "step": got["step"],
                     "rng": np.asarray(got["rng"]),
                     "placements": repr(got["w"].placements)}
    return out


# -- Llama, MoE-GPT over tp/sp, dropout, ViT and ResNet sharded
# (test_torch_llama_sharded, test_torch_zoo_sharded_more)


def _gather_blocks(x, mesh, seq: bool = True):
    """The global [B, T, ...] (or [B, ...] with `seq=False`) value of a
    tensor every rank holds its block of: the blocks placed by each rank's
    batch index (over dcn, dp, fsdp) and sp index."""
    import torch
    import torch.distributed as dist

    x = x.detach().float().contiguous()
    batch = tuple(a for a in ("dcn", "dp", "fsdp") if a in mesh.shape)
    coords = [None] * dist.get_world_size()
    dist.all_gather_object(coords, (mesh.axis_index(batch),
                                    mesh.axis_index("sp") if seq else 0))
    parts = [torch.empty_like(x) for _ in coords]
    dist.all_gather(parts, x)
    grid = {c: part for c, part in zip(coords, parts)}
    nb, ns = mesh.axis_size(batch), mesh.axis_size("sp") if seq else 1
    return torch.cat([torch.cat([grid[(i, j)] for j in range(ns)], dim=1)
                      for i in range(nb)]).numpy()


def _adamw(params, lr):
    import torch

    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _sharded_steps(loss_fn, params, mesh, shardings, lr, steps=2):
    """`steps` AdamW steps of `loss_fn()` (this rank's share): the global
    losses."""
    from ray_tpu_torch.models import gpt

    opt = _adamw(params.values(), lr)
    losses = []
    for _ in range(steps):
        loss = loss_fn()
        loss.backward()
        gpt.reduce_gradients(params, mesh, shardings)
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(gpt.global_loss(loss, mesh)))
    return losses


def _placed(family, convert_fn, tree, cfg, axes):
    """(mesh, shardings, placed params) of `family` (a model module) at the
    strategy `axes`, the JAX tree carried across in f32."""
    import torch

    from ray_tpu_torch.parallel import ShardingStrategy, logical_axis_rules
    from ray_tpu_torch.parallel.sharding import param_shardings

    strategy = ShardingStrategy(**axes)
    mesh = strategy.build_mesh(device="cpu")
    shardings = param_shardings(mesh, family.param_logical_axes(cfg),
                                logical_axis_rules(strategy))
    placed = convert_fn(tree, cfg, dtype=torch.float32, mesh=mesh,
                        shardings=shardings)
    return strategy, mesh, shardings, placed


LLAMA_LR = 1e-3
# Llama tiny (4 q heads, 2 kv heads) at the strategies of the tests: the
# axes of test_models.py's GSPMD step on 4 devices, tp with sp (Ulysses
# over each tp rank's 2 q heads and its 1 kv head, repeated), and tp=4
# (each kv head read by two ranks' query heads)
LLAMA_STRATEGIES = {"fsdp2_tp2": dict(fsdp=2, tp=2),
                    "tp2_sp2": dict(tp=2, sp=2), "tp4": dict(tp=4)}


def llama_tokens():
    return np.random.default_rng(13).integers(0, 512, (8, 33)).astype(
        np.int32)


def sc_llama_sharded(inputs):
    """The tiny Llama at each of `LLAMA_STRATEGIES`: the gathered sharded
    hidden states and the unsharded port's, then two AdamW steps' global
    losses."""
    import torch

    from ray_tpu_torch.models import convert, llama
    from ray_tpu_torch.ops import flash_attention
    from ray_tpu_torch.parallel import shard_batch

    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, remat=False)
    tree = inputs["llama_tree"]
    toks = llama_tokens()
    plain = llama.Llama.from_params(cfg, convert.llama_params_from_jax(
        tree, cfg, device="cpu", dtype=torch.float32))
    with torch.no_grad():
        ref, _ = plain(torch.from_numpy(toks[:, :-1]).long(),
                       return_hidden=True)
    out = {"plain": ref.numpy()}
    attend = partial(flash_attention, causal=True)
    for name, axes in LLAMA_STRATEGIES.items():
        strategy, mesh, shardings, placed = _placed(
            llama, convert.llama_params_from_jax, tree, cfg, axes)
        model = llama.Llama.from_params(cfg, placed, attention_fn=attend,
                                        trainable=True)
        batch = shard_batch({"x": toks[:, :-1], "y": toks[:, 1:]}, mesh,
                            strategy)
        x, y = (batch[k].to_local().long() for k in ("x", "y"))
        with torch.no_grad():
            hidden, wte, spmd = llama.sharded_hidden(model, x, mesh,
                                                     shardings)
        params = dict(model.named_parameters())
        losses = _sharded_steps(
            lambda: llama.sharded_loss(model, x, y, mesh, shardings),
            params, mesh, shardings, LLAMA_LR)
        out[name] = {"hidden": _gather_blocks(hidden, mesh),
                     "losses": losses, "mesh": mesh.shape,
                     "heads": (spmd.heads, spmd.kv_heads),
                     "local_qkv": tuple(params["layer0.attn_qkv.weight"]
                                        .shape),
                     "local_wte": tuple(params["wte"].shape)}
    return out


# tp=2 sp=2 leaves each tp rank one of the two heads, which sp does not
# divide: the gather path
MOE_STRATEGIES = {"tp2_ep2": dict(tp=2, ep=2), "dp2_sp2": dict(dp=2, sp=2),
                  "tp2_sp2": dict(tp=2, sp=2)}


def moe_sp_tokens():
    return np.random.default_rng(17).integers(0, 512, (8, 33)).astype(
        np.int32)


def sc_moe_tp_sp(inputs):
    """The tiny MoE-GPT at each of `MOE_STRATEGIES`: the layers' aux loss
    summed over the data axes before any step, then two AdamW steps'
    global losses."""
    import torch

    from ray_tpu_torch.models import convert, gpt, moe_gpt
    from ray_tpu_torch.parallel import collectives, shard_batch

    cfg = moe_gpt.MoEGPTConfig.tiny(dtype=torch.float32, remat=False)
    toks = moe_sp_tokens()
    out = {}
    for name, axes in MOE_STRATEGIES.items():
        strategy, mesh, shardings, placed = _placed(
            moe_gpt, convert.moe_gpt_params_from_jax, inputs["moe_tree"],
            cfg, axes)
        model = moe_gpt.MoEGPT.from_params(cfg, placed, trainable=True)
        batch = shard_batch({"x": toks[:, :-1], "y": toks[:, 1:]}, mesh,
                            strategy)
        x, y = (batch[k].to_local().long() for k in ("x", "y"))
        with torch.no_grad():
            _, _, spmd, aux = moe_gpt.sharded_hidden(model, x, mesh,
                                                     shardings)
            aux = collectives.allreduce(moe_gpt.total_aux_loss(aux),
                                        spmd.data_axes, mesh=mesh)
        params = dict(model.named_parameters())
        losses = _sharded_steps(
            lambda: moe_gpt.sharded_loss(model, x, y, mesh, shardings),
            params, mesh, shardings, MOE_LR)
        out[name] = {"aux": float(aux), "losses": losses,
                     "mesh": mesh.shape,
                     "local_experts": tuple(params["h0.moe.experts_up"]
                                            .shape)}
    return out


DROPOUT = 0.1
DROPOUT_SEED = 21


def sc_dropout_sharded(inputs):
    """Dropout in the sharded forwards, `deterministic=False`: GPT at
    tp=2 sp=2 and BERT at dp=2 tp=2 from a generator in the same state as
    the unsharded forward's; the gathered hidden states of both, and the
    global mask the ranks' blocks make up against the unsharded draw."""
    import torch

    from ray_tpu_torch.models import bert, convert, gpt
    from ray_tpu_torch.ops import flash_attention
    from ray_tpu_torch.parallel import shard_batch

    def gen():
        return torch.Generator().manual_seed(DROPOUT_SEED)

    out = {}
    cfg = gpt.GPTConfig(**GPT_CFG, dtype=torch.float32, remat=False,
                        dropout=DROPOUT)
    toks = gpt_tokens()[:, :-1]
    attend = partial(flash_attention, causal=True)
    plain = gpt.GPT.from_params(cfg, convert.gpt_params_from_jax(
        inputs["gpt_tree"], cfg, device="cpu", dtype=torch.float32),
        attention_fn=attend)
    strategy, mesh, shardings, placed = _placed(
        gpt, convert.gpt_params_from_jax, inputs["gpt_tree"], cfg,
        dict(tp=2, sp=2))
    model = gpt.GPT.from_params(cfg, placed, attention_fn=attend)
    x = shard_batch({"x": toks}, mesh, strategy)["x"].to_local().long()
    with torch.no_grad():
        hidden, _, spmd = gpt.sharded_hidden(model, x, mesh, shardings,
                                             deterministic=False,
                                             generator=gen())
        ref, _ = plain(torch.from_numpy(toks).long(), return_hidden=True,
                       deterministic=False, generator=gen())
        still, _, _ = gpt.sharded_hidden(model, x, mesh, shardings)
        shape = (toks.shape[0], toks.shape[1], cfg.d_model)
        block = spmd.dropout_keep(tuple(x.shape) + (cfg.d_model,), DROPOUT,
                                  gen(), "cpu")
        whole = gpt.dropout_keep(shape, DROPOUT, gen(), "cpu")
    # remat's recompute keeps the forward's masks: the gradients with
    # and without it, from the same generator state, are equal
    y = shard_batch({"y": gpt_tokens()[:, 1:]}, mesh,
                    strategy)["y"].to_local().long()
    grads = []
    for remat in (False, True):
        net = gpt.GPT.from_params(dataclasses.replace(cfg, remat=remat),
                                  placed, attention_fn=attend,
                                  trainable=True)
        gpt.sharded_loss(net, x, y, mesh, shardings, deterministic=False,
                         generator=gen()).backward()
        grads.append({n: p.grad.clone() for n, p in
                      net.named_parameters()})
        net.zero_grad(set_to_none=True)
    remat_err = max(float((grads[0][n] - grads[1][n]).abs().max())
                    for n in grads[0])
    out["gpt"] = {"hidden": _gather_blocks(hidden, mesh), "plain":
                  ref.numpy(), "deterministic": _gather_blocks(still, mesh),
                  "mask": _gather_blocks(block, mesh), "whole":
                  whole.numpy(), "mesh": mesh.shape, "remat_err": remat_err}
    bcfg = bert.BertConfig.tiny(dtype=torch.float32, remat=False,
                                dropout=DROPOUT)
    plain = bert.BertEncoder.from_params(bcfg, convert.bert_params_from_jax(
        inputs["bert_tree"], bcfg, device="cpu"))
    strategy, mesh, shardings, placed = _placed(
        bert, convert.bert_params_from_jax, inputs["bert_tree"], bcfg,
        dict(dp=2, tp=2))
    model = bert.BertEncoder.from_params(bcfg, placed)
    x = shard_batch({"x": bert_tokens()}, mesh, strategy)["x"]
    with torch.no_grad():
        hidden, _, _ = bert.sharded_hidden(model, x.to_local().long(), mesh,
                                           shardings, deterministic=False,
                                           generator=gen())
        ref, _ = plain(torch.from_numpy(bert_tokens()).long(),
                       deterministic=False, generator=gen())
    out["bert"] = {"hidden": _gather_blocks(hidden, mesh),
                   "plain": ref.numpy(), "mesh": mesh.shape}
    return out


VIT_LR = 1e-3


def vit_batch():
    rng = np.random.default_rng(23)
    return (rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, 8).astype(np.int32))


def sc_vit_sharded(inputs):
    """The tiny ViT at dp=2 tp=2: two AdamW steps' global losses; and its
    forward at dp=2 sp=2 (17 tokens, 9 rows a rank)."""
    import torch

    from ray_tpu_torch.models import convert, vit
    from ray_tpu_torch.parallel import shard_batch

    cfg = vit.ViTConfig.tiny(dtype=torch.float32, remat=False)
    strategy, mesh, shardings, placed = _placed(
        vit, convert.vit_params_from_jax, inputs["vit_tree"], cfg,
        dict(dp=2, tp=2))
    model = vit.ViT.from_params(cfg, placed, trainable=True)
    imgs, labels = vit_batch()
    batch = shard_batch({"x": imgs, "y": labels}, mesh, strategy)
    x, y = batch["x"].to_local(), batch["y"].to_local().long()
    params = dict(model.named_parameters())
    losses = _sharded_steps(
        lambda: vit.sharded_loss(model, x, y, mesh, shardings), params,
        mesh, shardings, VIT_LR)
    sp_strategy, sp_mesh, sp_shardings, sp_placed = _placed(
        vit, convert.vit_params_from_jax, inputs["vit_tree"], cfg,
        dict(dp=2, sp=2))
    sp_x = shard_batch({"x": imgs}, sp_mesh, sp_strategy)["x"].to_local()
    with torch.no_grad():
        hidden, _ = vit.sharded_hidden(vit.ViT.from_params(cfg, sp_placed),
                                       sp_x, sp_mesh, sp_shardings)
    return {"losses": losses, "mesh": mesh.shape,
            "sp_hidden": (tuple(hidden.shape),
                          bool(torch.isfinite(hidden).all())),
            "local_head": tuple(params["head.weight"].shape)}


# the tiny ViT (17 tokens) over sp: Ulysses on its 4 heads (the sequence
# padded to 18 or 20 rows); VIT_GATHER_CFG's 2 heads at sp=4 are gathered
VIT_SP_STRATEGIES = {"dp2_sp2": dict(dp=2, sp=2), "tp2_sp2": dict(tp=2, sp=2),
                     "sp4": dict(sp=4)}
VIT_GATHER_CFG = dict(image_size=32, patch_size=8, num_classes=10,
                      n_layer=2, n_head=2, d_model=64)


def _vit_steps(cfg, tree, axes, **kw):
    """Two AdamW steps of the tiny ViT at `axes`: (global losses, this
    rank's hidden shape, its `_Spmd`)."""
    import torch

    from ray_tpu_torch.models import convert, vit
    from ray_tpu_torch.parallel import shard_batch

    strategy, mesh, shardings, placed = _placed(
        vit, convert.vit_params_from_jax, tree, cfg, axes)
    model = vit.ViT.from_params(cfg, placed, trainable=True)
    imgs, labels = vit_batch()
    batch = shard_batch({"x": imgs, "y": labels}, mesh, strategy)
    x, y = batch["x"].to_local(), batch["y"].to_local().long()
    with torch.no_grad():
        hidden, spmd = vit.sharded_hidden(model, x, mesh, shardings)
    losses = _sharded_steps(
        lambda: vit.sharded_loss(model, x, y, mesh, shardings, **kw),
        dict(model.named_parameters()), mesh, shardings, VIT_LR)
    return losses, tuple(hidden.shape), spmd


def sc_vit_sp(inputs):
    """The tiny ViT over sp: two AdamW steps' global losses at each of
    `VIT_SP_STRATEGIES` and, with 2 heads, at sp=4 (the gather); and at
    dropout 0.1 (dp=2 sp=2) two sharded steps beside two unsharded ones
    from a generator in the same state."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.models import convert, vit

    cfg = vit.ViTConfig.tiny(dtype=torch.float32, remat=False)
    out = {}
    for name, axes in VIT_SP_STRATEGIES.items():
        losses, local, spmd = _vit_steps(cfg, inputs["vit_tree"], axes)
        out[name] = {"losses": losses, "local": local,
                     "gather": spmd.heads % spmd.sp != 0}
    rcfg = vit.ViTConfig(dtype=torch.float32, remat=False, **VIT_GATHER_CFG)
    losses, local, spmd = _vit_steps(rcfg, inputs["vit_gather_tree"],
                                     dict(sp=4))
    out["gather_sp4"] = {"losses": losses, "local": local,
                       "gather": spmd.heads % spmd.sp != 0}

    def gen():
        return torch.Generator().manual_seed(DROPOUT_SEED)

    dcfg = vit.ViTConfig.tiny(dtype=torch.float32, remat=False,
                              dropout=DROPOUT)
    sharded, _, _ = _vit_steps(dcfg, inputs["vit_tree"], dict(dp=2, sp=2),
                               deterministic=False, generator=gen())
    plain = vit.ViT.from_params(dcfg, convert.vit_params_from_jax(
        inputs["vit_tree"], dcfg, device="cpu", dtype=torch.float32),
        trainable=True)
    opt, g = _adamw(plain.parameters(), VIT_LR), gen()
    imgs, labels = (torch.from_numpy(a) for a in vit_batch())
    unsharded = []
    for _ in range(2):
        loss = F.cross_entropy(plain(imgs, deterministic=False, generator=g),
                               labels.long())
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        unsharded.append(float(loss))
    out["dropout"] = {"sharded": sharded, "unsharded": unsharded}
    return out


# the gather path in the decoders: sp does not divide a rank's query heads
# (the tiny GPT's 2 heads at tp=2 sp=2; a 2-head, 1-kv-head Llama at sp=4,
# its kv head repeated for both query heads)
GATHER_LLAMA_CFG = dict(n_layer=2, n_head=2, n_kv_head=1, d_model=64,
                        vocab_size=512, max_seq_len=128)


def sc_gather_sharded(inputs):
    """Two AdamW steps' global losses of the tiny GPT at tp=2 sp=2 and of
    `GATHER_LLAMA_CFG`'s Llama at sp=4, each rank's query heads not a
    multiple of sp."""
    import torch

    from ray_tpu_torch.models import convert, gpt, llama
    from ray_tpu_torch.parallel import shard_batch

    out = {}
    for name, family, net_cls, convert_fn, cfg, tree, toks, axes in (
            ("gpt_tp2_sp2", gpt, gpt.GPT, convert.gpt_params_from_jax,
             gpt.GPTConfig.tiny(dtype=torch.float32, remat=False),
             inputs["gpt_gather_tree"], gpt_tokens(), dict(tp=2, sp=2)),
            ("llama_sp4", llama, llama.Llama, convert.llama_params_from_jax,
             llama.LlamaConfig(dtype=torch.float32, remat=False,
                               **GATHER_LLAMA_CFG),
             inputs["llama_gather_tree"], llama_tokens(), dict(sp=4))):
        strategy, mesh, shardings, placed = _placed(
            family, convert_fn, tree, cfg, axes)
        model = net_cls.from_params(cfg, placed, trainable=True)
        batch = shard_batch({"x": toks[:, :-1], "y": toks[:, 1:]}, mesh,
                            strategy)
        x, y = (batch[k].to_local().long() for k in ("x", "y"))
        spmd = gpt._Spmd(mesh, shardings, cfg)
        losses = _sharded_steps(
            lambda: family.sharded_loss(model, x, y, mesh, shardings),
            dict(model.named_parameters()), mesh, shardings, GPT_LR)
        out[name] = {"losses": losses, "mesh": mesh.shape,
                     "heads": (spmd.heads, spmd.kv_heads),
                     "gather": spmd.heads % spmd.sp != 0,
                     "local_tokens": tuple(x.shape)}
    return out


RESNET_LR = 1e-3
RESNET_CFG = dict(stage_sizes=(1, 1), num_classes=10, width=8,
                  small_images=True)


def resnet_batch():
    rng = np.random.default_rng(29)
    return (rng.standard_normal((8, 16, 16, 3)).astype(np.float32),
            rng.integers(0, 10, 8).astype(np.int32))


def sc_resnet_sharded(inputs):
    """A small ResNet at dp=2 fsdp=2: two AdamW steps' global losses and,
    after the first, every rank's running statistics."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import convert, gpt, resnet
    from ray_tpu_torch.parallel import shard_batch

    cfg = resnet.ResNetConfig(dtype=torch.float32, **RESNET_CFG)
    strategy, mesh, shardings, placed = _placed(
        resnet, convert.resnet_variables_from_jax, inputs["resnet_vars"],
        cfg, dict(dp=2, fsdp=2))
    model = resnet.ResNet.from_params(cfg, placed, trainable=True)
    imgs, labels = resnet_batch()
    batch = shard_batch({"x": imgs, "y": labels}, mesh, strategy)
    x, y = batch["x"].to_local(), batch["y"].to_local().long()
    params = dict(model.named_parameters())
    opt = _adamw(params.values(), RESNET_LR)
    losses, stats = [], None
    for _ in range(2):
        loss = resnet.sharded_loss(model, x, y, mesh, shardings)
        loss.backward()
        gpt.reduce_gradients(params, mesh, shardings)
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(gpt.global_loss(loss, mesh)))
        if stats is None:
            stats = [None] * dist.get_world_size()
            dist.all_gather_object(stats, {
                n: b.numpy().copy() for n, b in model.named_buffers()})
    return {"losses": losses, "stats": stats, "mesh": mesh.shape,
            "local_stem": tuple(params["stem.weight"].shape)}


GANGS = {
    "w4": [sc_mesh, sc_device_allreduce, sc_collectives, sc_ring,
           sc_ring_grad, sc_ulysses, sc_gqa, sc_pipeline, sc_moe,
           sc_multislice, sc_compile_cache, sc_gpt4, sc_convert],
    "w8": [sc_gpt8],
    "zoo": [sc_bert_sharded, sc_moe_gpt_sharded],
    "ckpt": [sc_ckpt_save, sc_ckpt_restore],
    "llama": [sc_llama_sharded],
    "zoo_more": [sc_moe_tp_sp, sc_dropout_sharded, sc_vit_sharded,
                 sc_resnet_sharded, sc_vit_sp, sc_gather_sharded],
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
            args = (inputs, out)[:len(inspect.signature(fn).parameters)]
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
    return start_gang(gang, world, tmp, inputs, timeout)()


def start_gang(gang: str, world: int, tmp: Path, inputs: dict,
               timeout: float = 240.0):
    """Start GANG in `world` processes and return `wait()`, which waits for
    them and gives rank 0's results (`run_gang`); the caller may work
    meanwhile."""
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

    def wait() -> dict:
        logs = []
        try:
            for p in procs:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
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

    return wait


if __name__ == "__main__":
    main(sys.argv[1:])
