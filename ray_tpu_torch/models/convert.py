"""Carry weights from the JAX models to the port.

The input is the Flax param tree as nested dicts of numpy arrays, with or
without the {"params": ...} wrapper — what
`jax.tree_util.tree_map(np.asarray, unboxed_params(variables))` gives.
This module imports neither jax nor flax.

Mapping, by the Flax names:
- a Dense `kernel [in, out]` becomes the `nn.Linear` weight `[out, in]`;
  the fused projections keep their output order, so the port splits
  `attn_qkv` where Flax does (GPT in thirds; Llama at `n_head*hd` and
  `(n_head+n_kv_head)*hd`) and `mlp_gate_up` in halves;
- Dense biases, `wte` (the tied head: one tensor) and `wpe` keep their
  shapes;
- LayerNorm/RMSNorm `scale` (and `bias`) keep their names;
- a conv kernel [kh, kw, in, out] (HWIO) becomes torch's [out, in, kh,
  kw] (OIHW): ViT's patchify, ResNet's convolutions;
- MoE-GPT's router and experts keep their JAX layouts; BERT's `wtt` and
  ViT's `cls` and `pos_embed` keep their shapes; ResNet's `batch_stats`
  (`mean`, `var`) become the model's f32 buffers of those names;
- an RLlib module's tree (`rl_module_params_from_jax`) becomes the f32
  numpy `{name: array}` weights `RLModule.set_weights` takes, each Dense
  kernel transposed.

Projections and embeddings are stored in `dtype` (default `cfg.dtype`):
Flax casts each to `cfg.dtype` at use, so a forward sees the same
values. Norm parameters, which Flax reads in f32, stay in
`cfg.param_dtype`.

Given a mesh and the parameters' placements (`parallel.sharding.
param_shardings`), the parameters of every family come back as DTensors
on the mesh (ResNet's running statistics replicated),
each rank holding its shards: the sharded model's parameters. Their
layout is the JAX one (the fused qkv's rows are not permuted), so a
gathered DTensor is the Flax array (transposed for a Dense kernel).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.gpt import unboxed_params


def _tensor(a, device, dtype):
    # a writable C-ordered copy: the tree's arrays may be read-only views
    return torch.from_numpy(np.array(a, order="C")).to(device=device,
                                                      dtype=dtype)


def _dense(out, prefix, node, device, dtype, bias=True):
    out[f"{prefix}.weight"] = _tensor(np.asarray(node["kernel"]).T,
                                      device, dtype)
    if bias:
        out[f"{prefix}.bias"] = _tensor(node["bias"], device, dtype)


def _norm(out, prefix, node, device, dtype, bias=True):
    out[f"{prefix}.scale"] = _tensor(node["scale"], device, dtype)
    if bias:
        out[f"{prefix}.bias"] = _tensor(node["bias"], device, dtype)


def gpt_params_from_jax(tree, cfg, device=None,
                        dtype: Optional[torch.dtype] = None, *, mesh=None,
                        shardings=None) -> Dict[str, torch.Tensor]:
    """Port params (the `GPT.from_params` dict) from a Flax GPT tree; with
    `mesh` and `shardings`, DTensors on the mesh's device (module
    docstring)."""
    if mesh is not None:
        return _sharded(gpt_params_from_jax, tree, cfg, dtype, mesh,
                        shardings)
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    p = unboxed_params(tree)
    out = {"wte": _tensor(p["wte"], device, dtype),
           "wpe": _tensor(p["wpe"], device, dtype)}
    for i in range(cfg.n_layer):
        lp = p[f"h{i}"]
        for name in ("attn_qkv", "attn_out", "mlp_up", "mlp_down"):
            _dense(out, f"h{i}.{name}", lp[name], device, dtype)
        for name in ("ln_1", "ln_2"):
            _norm(out, f"h{i}.{name}", lp[name], device, cfg.param_dtype)
    _norm(out, "ln_f", p["ln_f"], device, cfg.param_dtype)
    return out


def llama_params_from_jax(tree, cfg, device=None,
                          dtype: Optional[torch.dtype] = None, *, mesh=None,
                          shardings=None) -> Dict[str, torch.Tensor]:
    """Port params (the `Llama.from_params` dict) from a Flax Llama
    tree; DTensors with `mesh`."""
    if mesh is not None:
        return _sharded(llama_params_from_jax, tree, cfg, dtype, mesh,
                        shardings)
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    p = unboxed_params(tree)
    out = {"wte": _tensor(p["wte"], device, dtype)}
    for i in range(cfg.n_layer):
        lp = p[f"layer{i}"]
        for name in ("attn_qkv", "attn_out", "mlp_gate_up", "mlp_down"):
            _dense(out, f"layer{i}.{name}", lp[name], device, dtype,
                   bias=False)
        for name in ("attn_norm", "mlp_norm"):
            _norm(out, f"layer{i}.{name}", lp[name], device,
                  cfg.param_dtype, bias=False)
    _norm(out, "final_norm", p["final_norm"], device, cfg.param_dtype,
          bias=False)
    return out


def _sharded(fn, tree, cfg, dtype, mesh, shardings):
    """`fn`'s params as DTensors on `mesh` (`gpt_params_from_jax`)."""
    from ray_tpu_torch.parallel.sharding import shard_params

    return shard_params(fn(tree, cfg, "cpu", dtype), mesh, shardings)


def moe_gpt_params_from_jax(tree, cfg, device=None,
                            dtype: Optional[torch.dtype] = None, *,
                            mesh=None, shardings=None
                            ) -> Dict[str, torch.Tensor]:
    """Port params (the `MoEGPT.from_params` dict) from a Flax MoEGPT
    tree: the attention half as GPT's, the expert layer in its JAX layout
    (the router in `cfg.param_dtype`); DTensors with `mesh`."""
    if mesh is not None:
        return _sharded(moe_gpt_params_from_jax, tree, cfg, dtype, mesh,
                        shardings)
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    p = unboxed_params(tree)
    out = {"wte": _tensor(p["wte"], device, dtype),
           "wpe": _tensor(p["wpe"], device, dtype)}
    for i in range(cfg.n_layer):
        lp = p[f"h{i}"]
        for name in ("attn_qkv", "attn_out"):
            _dense(out, f"h{i}.{name}", lp[name], device, dtype)
        for name in ("ln_1", "ln_2"):
            _norm(out, f"h{i}.{name}", lp[name], device, cfg.param_dtype)
        moe = lp["moe"]
        out[f"h{i}.moe.router"] = _tensor(moe["router"], device,
                                          cfg.param_dtype)
        for name in ("experts_up", "experts_down"):
            out[f"h{i}.moe.{name}"] = _tensor(moe[name], device, dtype)
    _norm(out, "ln_f", p["ln_f"], device, cfg.param_dtype)
    return out


def bert_params_from_jax(tree, cfg, device=None,
                         dtype: Optional[torch.dtype] = None, *, mesh=None,
                         shardings=None) -> Dict[str, torch.Tensor]:
    """Port params (the `BertEncoder.from_params` dict) from a Flax
    BertEncoder tree; DTensors with `mesh`."""
    if mesh is not None:
        return _sharded(bert_params_from_jax, tree, cfg, dtype, mesh,
                        shardings)
    out = gpt_params_from_jax(tree, cfg._gpt_view(), device, dtype)
    out["wtt"] = _tensor(unboxed_params(tree)["wtt"], resolve_device(device),
                         dtype or cfg.dtype)
    return out


def _conv_kernel(k):
    """A Flax conv kernel [kh, kw, in, out] as torch's [out, in, kh, kw]."""
    return np.asarray(k).transpose(3, 2, 0, 1)


def vit_params_from_jax(tree, cfg, device=None,
                        dtype: Optional[torch.dtype] = None, *, mesh=None,
                        shardings=None) -> Dict[str, torch.Tensor]:
    """Port params (the `ViT.from_params` dict) from a Flax ViT tree;
    DTensors with `mesh`."""
    if mesh is not None:
        return _sharded(vit_params_from_jax, tree, cfg, dtype, mesh,
                        shardings)
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    p = unboxed_params(tree)
    out = {"patchify.weight": _tensor(_conv_kernel(p["patchify"]["kernel"]),
                                      device, dtype),
           "patchify.bias": _tensor(p["patchify"]["bias"], device, dtype),
           "cls": _tensor(p["cls"], device, dtype),
           "pos_embed": _tensor(p["pos_embed"], device, dtype)}
    for i in range(cfg.n_layer):
        lp = p[f"encoder{i}"]
        for name in ("attn_qkv", "attn_out", "mlp_up", "mlp_down"):
            _dense(out, f"encoder{i}.{name}", lp[name], device, dtype)
        for name in ("ln_1", "ln_2"):
            _norm(out, f"encoder{i}.{name}", lp[name], device,
                  cfg.param_dtype)
    _norm(out, "ln_f", p["ln_f"], device, cfg.param_dtype)
    _dense(out, "head", p["head"], device, dtype)
    return out


def resnet_variables_from_jax(variables, cfg, device=None,
                              dtype: Optional[torch.dtype] = None, *,
                              mesh=None, shardings=None
                              ) -> Dict[str, torch.Tensor]:
    """Port variables (the `ResNet.from_params` dict) from Flax ResNet
    variables {"params": ..., "batch_stats": ...}: conv kernels HWIO ->
    OIHW and the head in `dtype`, BatchNorm scale/bias in
    `cfg.param_dtype`, the running `mean`/`var` in f32. Without
    "batch_stats" (a gradient tree, say) only the parameters. DTensors
    with `mesh`."""
    if mesh is not None:
        return _sharded(resnet_variables_from_jax, variables, cfg, dtype,
                        mesh, shardings)
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    params = unboxed_params(variables)
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for name in sorted(node):
            leaf, path = node[name], f"{prefix}{name}"
            if isinstance(leaf, dict):
                walk(leaf, path + ".")
            elif name == "kernel" and prefix == "head.":
                out["head.weight"] = _tensor(np.asarray(leaf).T, device,
                                             dtype)
            elif name == "kernel":
                out[f"{prefix}weight"] = _tensor(_conv_kernel(leaf), device,
                                                 dtype)
            elif prefix == "head.":
                out[path] = _tensor(leaf, device, dtype)
            else:  # BatchNorm scale and bias
                out[path] = _tensor(leaf, device, cfg.param_dtype)

    walk(params, "")
    for mod, stats in sorted(variables.get("batch_stats", {}).items()):
        for blk, leaves in ([(mod, stats)] if "mean" in stats
                            else [(f"{mod}.{k}", v)
                                  for k, v in sorted(stats.items())]):
            for name in ("mean", "var"):
                out[f"{blk}.{name}"] = _tensor(leaves[name], device,
                                               torch.float32)
    return out


def _mlp_from_jax(out, prefix, hidden_nodes, head_nodes):
    """A port `_MLP`'s weights: Flax Dense nodes of the torso, then the
    heads, as `{prefix}.torso.{i}` / `{prefix}.heads.{j}` arrays."""
    for group, nodes in (("torso", hidden_nodes), ("heads", head_nodes)):
        for i, node in enumerate(nodes):
            out[f"{prefix}.{group}.{i}.weight"] = np.ascontiguousarray(
                np.asarray(node["kernel"], np.float32).T)
            out[f"{prefix}.{group}.{i}.bias"] = np.asarray(node["bias"],
                                                           np.float32)


def _dense_nodes(tree, first, count):
    return [tree[f"Dense_{i}"] for i in range(first, first + count)]


def rl_module_params_from_jax(params, spec) -> Dict[str, np.ndarray]:
    """RLlib module weights (`RLModule.get_weights()`'s `{name: array}`,
    f32 numpy) from a JAX RLModule param tree, for the module `spec`
    builds: the actor-critic tree (`_MLPTorso_0` + `Dense_0` the logits,
    `_MLPTorso_1` + `Dense_1` the value), the Q tree (`_MLPTorso_0` +
    `Dense_0`) or the SAC tree ({"policy", "q1", "q2", "log_alpha"}, any
    of them: a SAC learner's target critics are {"q1", "q2"})."""
    k = len(spec.hidden)
    out: Dict[str, np.ndarray] = {}
    if any(key in params for key in ("policy", "q1", "q2", "log_alpha")):
        if "policy" in params:
            p = unboxed_params(params["policy"])
            _mlp_from_jax(out, "policy", _dense_nodes(p, 0, k),
                          _dense_nodes(p, k, 2))
        for q in ("q1", "q2"):
            if q in params:
                p = unboxed_params(params[q])
                _mlp_from_jax(out, q, _dense_nodes(p, 0, k),
                              _dense_nodes(p, k, 1))
        if "log_alpha" in params:
            out["log_alpha"] = np.asarray(params["log_alpha"], np.float32)
        return out
    p = unboxed_params(params)
    torso = lambda name: _dense_nodes(p[name], 0, k)  # noqa: E731
    if "_MLPTorso_1" in p:  # actor-critic: two torsos
        _mlp_from_jax(out, "pi", torso("_MLPTorso_0"), [p["Dense_0"]])
        _mlp_from_jax(out, "vf", torso("_MLPTorso_1"), [p["Dense_1"]])
    else:
        _mlp_from_jax(out, "q", torso("_MLPTorso_0"), [p["Dense_0"]])
    return out
