"""Expert parallelism: sharded mixture-of-experts dispatch.

Port of `ray_tpu/parallel/moe.py`. Experts are split over the `ep` mesh
axis; tokens are routed top-1 with a static capacity, dispatched to the
expert shards with an `all_to_all` (differentiable: its backward is the
reverse exchange), processed, and combined back weighted by the router
probabilities. Plain PyTorch, as the JAX functions are plain `jnp`.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.compile_cache import _leaves_of, _tree_map
from ray_tpu_torch.parallel.sharding import PartitionSpec as P
from ray_tpu_torch.parallel.sharding import as_global, as_local


def top1_routing(router_logits, num_experts: int, capacity: int):
    """Top-1 routing with static capacity. Returns (dispatch [T, E, C]
    one-hot, combine [T, E, C] weights, aux_loss)."""
    probs = torch.softmax(router_logits, dim=-1)  # [T, E]
    expert = torch.argmax(probs, dim=-1)  # [T]
    gate = torch.take_along_dim(probs, expert[:, None], dim=-1)[:, 0]

    # Position of each token within its expert's capacity buffer.
    onehot = F.one_hot(expert, num_experts).to(torch.int32)  # [T, E]
    position = torch.cumsum(onehot, dim=0) * onehot - 1  # [T, E]
    in_capacity = (position < capacity) & (position >= 0)
    pos_clipped = torch.clamp(position, 0, capacity - 1).long()
    dispatch = (F.one_hot(pos_clipped, capacity).to(probs.dtype)
                * in_capacity[..., None])  # [T, E, C]
    combine = dispatch * gate[:, None, None]

    # Load-balancing auxiliary loss (Switch Transformer).
    density = onehot.to(probs.dtype).mean(dim=0)
    density_proxy = probs.mean(dim=0)
    aux_loss = torch.sum(density * density_proxy) * num_experts
    return dispatch, combine, aux_loss


def _experts(expert_fn, expert_params, expert_in):
    """`jax.vmap(expert_fn)` over the leading expert axis."""
    return torch.func.vmap(expert_fn)(expert_params, expert_in)


def moe_layer(
    x,                         # [tokens, d_model] (shard-local)
    router_w,                  # [d_model, num_experts] (replicated)
    expert_params,             # tree with leading [experts_local, ...]
    expert_fn: Callable,       # (params_e, tokens[C, d]) -> [C, d]
    *,
    axis_name: str = "ep",
    capacity_factor: float = 1.25,
    mesh,
):
    """Shard-local MoE body: this rank's tokens and its experts' params
    (experts split over `axis_name`)."""
    n_shards = mesh.axis_size(axis_name)
    tokens, d_model = x.shape
    experts_local = _leaves_of(expert_params)[0].shape[0]
    num_experts = experts_local * n_shards
    capacity = max(1, int(capacity_factor * tokens / num_experts))

    logits = x @ router_w
    dispatch, combine, aux = top1_routing(logits, num_experts, capacity)

    # Dispatch: [E, C, d]; shard j hosts experts [j*E_local, (j+1)*E_local).
    # The untiled all_to_all removes the size-n split axis and stacks the
    # n received pieces at concat_dim.
    expert_in = torch.einsum("tec,td->ecd", dispatch, x)  # [E, C, d]
    expert_in = expert_in.reshape(n_shards, experts_local, capacity,
                                  d_model)
    expert_in = collectives.all_to_all(expert_in, axis_name, split_dim=0,
                                       concat_dim=2, tiled=False, mesh=mesh)
    # [E_local, C, n_src, d] -> [E_local, n_src * C, d]
    expert_in = expert_in.permute(0, 2, 1, 3).reshape(
        experts_local, n_shards * capacity, d_model)

    expert_out = _experts(expert_fn, expert_params, expert_in)

    # Route back: the exact inverse layout walk.
    expert_out = expert_out.reshape(experts_local, n_shards, capacity,
                                    d_model)
    expert_out = expert_out.permute(0, 2, 1, 3)  # [E_local, C, n_src, d]
    expert_out = collectives.all_to_all(expert_out, axis_name, split_dim=2,
                                        concat_dim=0, tiled=False,
                                        mesh=mesh)
    # [n_host, E_local, C, d] -> [E, C, d] on every shard's own token set.
    expert_out = expert_out.reshape(num_experts, capacity, d_model)
    y = torch.einsum("tec,ecd->td", combine, expert_out)
    return y.to(x.dtype), aux


def apply_moe(
    x,                         # [batch, seq, d_model] global
    router_w,
    expert_params,             # [num_experts, ...] tree, split over ep
    expert_fn: Callable,
    mesh,
    *,
    axis_name: str = "ep",
    batch_axes=("dp", "fsdp"),
    capacity_factor: float = 1.25,
):
    """MoE over global values (DTensors or plain tensors, the same on every
    rank): returns (y, aux) with y a DTensor split over the data axes and
    aux the mean over `axis_name`. Without an `ep` axis of more than one
    rank, the dense dispatch without collectives on the global values."""
    if axis_name not in mesh.axis_names or mesh.shape[axis_name] == 1:
        from ray_tpu_torch.parallel.ring_attention import _global_value

        x, router_w = _global_value(x), _global_value(router_w)
        expert_params = _tree_map(_global_value, expert_params)
        b, s, d = x.shape
        flat = x.reshape(b * s, d)
        num_experts = _leaves_of(expert_params)[0].shape[0]
        capacity = max(1, int(capacity_factor * flat.shape[0] / num_experts))
        logits = flat @ router_w
        dispatch, combine, aux = top1_routing(logits, num_experts, capacity)
        expert_in = torch.einsum("tec,td->ecd", dispatch, flat)
        expert_out = _experts(expert_fn, expert_params, expert_in)
        y = torch.einsum("tec,ecd->td", combine, expert_out)
        return y.reshape(b, s, d).to(x.dtype), aux

    batch = tuple(a for a in batch_axes if a in mesh.axis_names)
    bspec = batch if len(batch) > 1 else (batch[0] if batch else None)
    xspec = P(bspec, None, None)
    xl = as_local(x, mesh, xspec)
    local_params = _tree_map(
        lambda p: as_local(p, mesh, P(axis_name, *([None] * (p.ndim - 1)))),
        expert_params)
    b, s, d = xl.shape
    y, aux = moe_layer(
        xl.reshape(b * s, d), as_local(router_w, mesh, P(None, None)),
        local_params, expert_fn, axis_name=axis_name,
        capacity_factor=capacity_factor, mesh=mesh)
    return (as_global(y.reshape(b, s, d), mesh, xspec, shape=x.shape),
            collectives.allreduce_mean(aux, axis_name, mesh=mesh))
