"""Dense attention: the single-device reference every attention variant
is held to.

Port of the unsharded part of `ray_tpu/parallel/ring_attention.py`
(`NEG_INF`, `_block_attend`, `expand_kv_heads`, `full_attention`). The
ring and Ulysses variants, which shard the sequence across devices, come
with the port of `parallel/`.

Layout is the JAX package's: q is [B, T, H, D]; k/v are [B, T, H_kv, D]
with H % H_kv == 0 (grouped-query attention).
"""

from __future__ import annotations

from typing import Optional

import torch

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
