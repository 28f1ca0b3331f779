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
- LayerNorm/RMSNorm `scale` (and `bias`) keep their names.

Projections and embeddings are stored in `dtype` (default `cfg.dtype`):
Flax casts each to `cfg.dtype` at use, so a forward sees the same
values. Norm parameters, which Flax reads in f32, stay in
`cfg.param_dtype`.

Given a mesh and the parameters' placements (`parallel.sharding.
param_shardings`), the GPT parameters come back as DTensors on the mesh,
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
        from ray_tpu_torch.parallel.sharding import shard_params

        return shard_params(gpt_params_from_jax(tree, cfg, "cpu", dtype),
                            mesh, shardings)
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
                          dtype: Optional[torch.dtype] = None
                          ) -> Dict[str, torch.Tensor]:
    """Port params (the `Llama.from_params` dict) from a Flax Llama
    tree."""
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
