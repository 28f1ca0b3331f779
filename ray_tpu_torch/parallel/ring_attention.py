"""Ring attention and Ulysses: exact attention over a sequence sharded
across ranks, and the dense single-device reference both are held to.

Port of `ray_tpu/parallel/ring_attention.py`. The sequence axis is split
over the `sp` mesh axis. `ring_attention` keeps each rank's Q block and
rotates K/V blocks around the ring of `sp` ranks (`batch_isend_irecv`)
while an online softmax accumulates the output; causal blocks wholly in
the future are skipped. `ulysses_attention` swaps the split from the
sequence to the heads with an `all_to_all`, attends over the whole
sequence on its heads and swaps back. Both are plain PyTorch, as the JAX
functions are plain `jnp` outside any Pallas kernel. JAX differentiates
through `ppermute`; here the ring is a `torch.autograd.Function` whose
backward runs a second ring, carrying each K/V block's dK/dV
accumulators home with it.

Inputs are global arrays: DTensors over the mesh, or plain tensors
holding the same global value on every rank (each rank takes its block).
The result is a DTensor with the inputs' split (its local shard is this
rank's block), as the JAX result has q's sharding. Without an `sp` axis
of more than one rank both are `full_attention` on the global values.

Layout is the JAX package's: q is [B, T, H, D]; k/v are [B, T, H_kv, D]
with H % H_kv == 0 (grouped-query attention).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.sharding import PartitionSpec as P
from ray_tpu_torch.parallel.sharding import as_global, as_local

NEG_INF = -1e30


def _block_attend(q, k, v, q_offset: int, kv_offset: int, causal: bool,
                  scale: float):
    """Attend a q-block to one kv-block, returning unnormalized partials.

    q: [B, Tq, H, D], k/v: [B, Tkv, H, D] ->
    (out [B, Tq, H, D], row_max [B, H, Tq], row_sum [B, H, Tq])
    """
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        q_pos = q_offset + torch.arange(tq, device=q.device)[:, None]
        k_pos = kv_offset + torch.arange(tk, device=q.device)[None, :]
        mask = q_pos >= k_pos
        logits = torch.where(mask[None, None], logits, NEG_INF)
    row_max = torch.amax(logits, dim=-1)
    p = torch.exp(logits - row_max[..., None])
    row_sum = torch.sum(p, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return out, row_max, row_sum


def expand_kv_heads(q, k, v):
    """GQA inputs (fewer KV heads than Q heads) -> repeat KV query-side,
    each KV head once per query head of its group (query head h reads KV
    head h // group). The flash kernel reads the grouped heads in place
    and never calls this."""
    if k.shape[2] != q.shape[2]:
        groups = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, groups, dim=2)
        v = torch.repeat_interleave(v, groups, dim=2)
    return k, v


def full_attention(q, k, v, *, causal: bool = True,
                   scale: Optional[float] = None):
    """Dense (unsharded) softmax attention."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    k, v = expand_kv_heads(q, k, v)
    out, _, row_sum = _block_attend(q, k, v, 0, 0, causal, scale)
    return out / torch.clamp(row_sum, min=1e-20).transpose(1, 2)[..., None]


def _global_value(x):
    """A DTensor's full value, a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _expand_grad(g, h_kv: int):
    """The gradient of `expand_kv_heads`' repeat: each KV head's query
    group summed back to the KV head ([B, T, H, D] -> [B, T, h_kv, D])."""
    if g.shape[2] == h_kv:
        return g
    b, t, h, d = g.shape
    return g.reshape(b, t, h_kv, h // h_kv, d).sum(3)


def _causal_logits(q, k, q_offset, kv_offset, causal, scale):
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
        k_pos = kv_offset + torch.arange(k.shape[1], device=q.device)[None]
        logits = torch.where((q_pos >= k_pos)[None, None], logits, NEG_INF)
    return logits


class _RingAttention(torch.autograd.Function):
    """The per-rank body (`_ring_attention_local`): forward with an online
    softmax over the K/V blocks as they come round; backward with a second
    ring, in which each block travels with its dK/dV accumulators and is
    home again after n hops."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        n, me = group.size(), torch.distributed.get_rank(group)
        b, tq, h, d = q.shape
        tk = k.shape[1]
        q_offset = me * tq
        acc = torch.zeros((b, tq, h, d), dtype=torch.float32,
                          device=q.device)
        row_max = torch.full((b, h, tq), NEG_INF, dtype=torch.float32,
                             device=q.device)
        row_sum = torch.zeros((b, h, tq), dtype=torch.float32,
                              device=q.device)
        k_blk, v_blk = k, v
        for step in range(n):
            kv_offset = ((me - step) % n) * tk
            # a block wholly in the future contributes nothing
            if not causal or q_offset + tq - 1 >= kv_offset:
                k_e, v_e = expand_kv_heads(q, k_blk, v_blk)
                out, blk_max, blk_sum = _block_attend(
                    q, k_e, v_e, q_offset, kv_offset, causal, scale)
                new_max = torch.maximum(row_max, blk_max)
                old_scale = torch.exp(row_max - new_max)
                blk_scale = torch.exp(blk_max - new_max)
                acc = acc * old_scale.transpose(1, 2)[..., None] + \
                    out.float() * blk_scale.transpose(1, 2)[..., None]
                row_sum = row_sum * old_scale + blk_sum * blk_scale
                row_max = new_max
            if step < n - 1:  # the last rotation would only bring k home
                k_blk = collectives._permute(k_blk, group, 1)
                v_blk = collectives._permute(v_blk, group, 1)
        row_sum = torch.clamp(row_sum, min=1e-20)
        out = (acc / row_sum.transpose(1, 2)[..., None]).to(q.dtype)
        lse = row_max + torch.log(row_sum)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, causal, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.args
        n, me = group.size(), torch.distributed.get_rank(group)
        tq, tk, h_kv = q.shape[1], k.shape[1], k.shape[2]
        q_offset = me * tq
        q32, do32 = q.float(), dout.float()
        delta = (do32 * out.float()).sum(-1).transpose(1, 2)   # [B, H, Tq]
        dq = torch.zeros_like(q32)
        k_blk, v_blk = k, v
        dk_blk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_blk = torch.zeros_like(dk_blk)
        for step in range(n):
            kv_offset = ((me - step) % n) * tk
            if not causal or q_offset + tq - 1 >= kv_offset:
                k_e, v_e = (x.float() for x in
                            expand_kv_heads(q, k_blk, v_blk))
                p = torch.exp(_causal_logits(q32, k_e, q_offset, kv_offset,
                                             causal, scale)
                              - lse[..., None])
                dv_blk = dv_blk + _expand_grad(
                    torch.einsum("bhqk,bqhd->bkhd", p, do32), h_kv)
                dp = torch.einsum("bqhd,bkhd->bhqk", do32, v_e)
                ds = p * (dp - delta[..., None]) * scale
                dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, k_e)
                dk_blk = dk_blk + _expand_grad(
                    torch.einsum("bhqk,bqhd->bkhd", ds, q32), h_kv)
            # the accumulators travel with their block: after n hops every
            # block's dK/dV is back on the rank that owns it
            dk_blk = collectives._permute(dk_blk, group, 1)
            dv_blk = collectives._permute(dv_blk, group, 1)
            if step < n - 1:
                k_blk = collectives._permute(k_blk, group, 1)
                v_blk = collectives._permute(v_blk, group, 1)
        return (dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype),
                None, None, None)


def _ring_attention_local(q, k, v, *, mesh, axis_name: str, causal: bool,
                          scale: float):
    """Per-shard body: this rank's Q block against every K/V block of the
    `axis_name` ring (local blocks in, this rank's output block out)."""
    return _RingAttention.apply(q, k, v, mesh.group(axis_name), causal,
                                scale)


def _batch_entry(mesh, batch_axes):
    batch = tuple(a for a in batch_axes if a in mesh.axis_names)
    return batch if len(batch) > 1 else (batch[0] if batch else None)


def _no_sp(mesh, axis_name: str) -> bool:
    return axis_name not in mesh.axis_names or mesh.shape[axis_name] == 1


def ring_attention(
    q,
    k,
    v,
    mesh,
    *,
    axis_name: str = "sp",
    causal: bool = True,
    scale: Optional[float] = None,
    batch_axes=("dp", "fsdp"),
    head_axis: Optional[str] = "tp",
):
    """Exact attention with the sequence split over `axis_name` (module
    docstring): global [batch, seq, heads, head_dim] in, a DTensor with
    q's split out."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _no_sp(mesh, axis_name):
        # No sequence sharding: plain attention.
        return full_attention(_global_value(q), _global_value(k),
                              _global_value(v), causal=causal, scale=scale)
    hspec = head_axis if head_axis in mesh.axis_names else None
    spec = P(_batch_entry(mesh, batch_axes), axis_name, hspec, None)
    out = _ring_attention_local(
        as_local(q, mesh, spec), as_local(k, mesh, spec),
        as_local(v, mesh, spec), mesh=mesh, axis_name=axis_name,
        causal=causal, scale=scale)
    return as_global(out, mesh, spec, shape=q.shape)


def ulysses_attention(
    q,
    k,
    v,
    mesh,
    *,
    axis_name: str = "sp",
    causal: bool = True,
    scale: Optional[float] = None,
    batch_axes=("dp", "fsdp"),
):
    """Ulysses/DeepSpeed-style sequence parallelism: an all_to_all swaps
    the split dimension from sequence to heads, attention runs over the
    whole sequence on a head subset, then an all_to_all swaps back.
    Requires heads % sp == 0; GQA K/V whose heads sp does not divide are
    expanded first."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _no_sp(mesh, axis_name):
        return full_attention(_global_value(q), _global_value(k),
                              _global_value(v), causal=causal, scale=scale)
    spec = P(_batch_entry(mesh, batch_axes), axis_name, None, None)
    q_l, k_l, v_l = (as_local(x, mesh, spec) for x in (q, k, v))
    if k.shape[2] % mesh.shape[axis_name]:
        # GQA with kv heads not divisible by sp: the head all_to_all
        # can't split h_kv evenly — expand first (full-width comm)
        k_l, v_l = expand_kv_heads(q_l, k_l, v_l)
    out = ulysses_local(q_l, k_l, v_l, mesh=mesh, axis_name=axis_name,
                        causal=causal, scale=scale)
    return as_global(out, mesh, spec, shape=q.shape)


def ulysses_local(q, k, v, *, mesh, axis_name: str = "sp",
                  causal: bool = True, scale: Optional[float] = None,
                  attention_fn: Optional[Callable] = None):
    """Ulysses' per-rank body on local blocks [B, T/sp, H, D]: all_to_all
    to [B, T, H/sp, D], attend, all_to_all back. `attention_fn(q, k, v)`
    (default `full_attention` with `causal` and `scale`) is the per-rank
    attention: the sharded GPT passes its own (the flash kernel)."""
    def swap(x):
        return collectives.all_to_all(x, axis_name, split_dim=2,
                                      concat_dim=1, mesh=mesh)

    if attention_fn is None:
        out = full_attention(swap(q), swap(k), swap(v), causal=causal,
                             scale=scale)
    else:
        out = attention_fn(swap(q), swap(k), swap(v))
    return collectives.all_to_all(out, axis_name, split_dim=1,
                                  concat_dim=2, mesh=mesh)
