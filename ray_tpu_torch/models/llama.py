"""Llama-family decoder-only transformer in PyTorch.

Port of `ray_tpu/models/llama.py`: RMSNorm, rotary embeddings, SwiGLU
MLP and grouped-query attention, per-block remat for training, plus the
decode path shared with GPT (`paged_attend`, `paged_attend_chunk`,
`chunk_valid_mask`).

Numerics follow the Flax model:
- RMSNorm has f32 internals and eps `cfg.norm_eps` (1e-5);
- RoPE rotates the two HALVES of each head (not interleaved pairs) with
  f32 cos/sin tables computed in numpy exactly as the JAX model does;
- the SwiGLU width is `ffn_mult * d_model` rounded up to a multiple of
  128, with gate and up fused in one projection;
- the fused QKV projection splits at `n_head*hd` and
  `(n_head+n_kv_head)*hd`; K/V keep their `n_kv_head` heads (each
  attention function handles the grouping itself).
Storage dtypes and parameter names follow `gpt.py`: the projections are
GPT's `Dense` without bias, which casts its weight to `cfg.dtype` at use,
and `wte` is cast where it is read, so serving weights stored in
`cfg.dtype` and f32 master weights for training
(`init_params(..., dtype=torch.float32)` or
`convert.llama_params_from_jax(..., dtype=torch.float32)`) go through one
module; norm scales stay in `cfg.param_dtype`; names come from the Flax
tree. With `cfg.remat` each block is recomputed in the backward
(`torch.utils.checkpoint`) whenever grad is enabled, as the Flax model
wraps it in `nn.remat`.

Sharded over a mesh (`sharded_loss`), the model holds this rank's shards
(`param_logical_axes`, the Flax annotations) and runs `gpt`'s sharded
forward (`gpt._Spmd`): FSDP's `embed` shards gathered at use, Megatron
splits over `tp` (the fused qkv gathered and sliced to this rank's query
heads and the kv heads they read, `[gate; up]` gathered and sliced to
this rank's columns of each half), the vocab-parallel embedding and tied
head, and the sequence over `sp` through Ulysses with RoPE at the rank's
positions.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models.gpt import (Dense, _from_params, _next_logits,
                                      _norm_params, _normal, unboxed_params)
from ray_tpu_torch.parallel.ring_attention import NEG_INF, full_attention

__all__ = [
    "LlamaConfig", "RMSNorm", "rope_tables", "apply_rope", "LlamaBlock",
    "Llama", "init_params", "unboxed_params", "paged_attend",
    "paged_attend_chunk", "chunk_valid_mask", "prefill_step", "chunk_step",
    "decode_step", "flops_per_token", "param_logical_axes",
    "sharded_hidden", "sharded_loss",
]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_layer: int = 12
    n_head: int = 12
    n_kv_head: int = 4          # GQA group count (== n_head -> MHA)
    d_model: int = 768
    ffn_mult: float = 8 / 3     # SwiGLU hidden = ffn_mult * d_model
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def ffn_dim(self) -> int:
        d = int(self.ffn_mult * self.d_model)
        return ((d + 127) // 128) * 128

    @classmethod
    def llama_125m(cls, **kw):
        return cls(n_layer=12, n_head=12, n_kv_head=4, d_model=768, **kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 512)
        kw.setdefault("max_seq_len", 128)
        kw.setdefault("n_kv_head", 2)
        return cls(n_layer=2, n_head=4, d_model=64, **kw)


def _rms(x, scale, eps, dtype):
    # mirrors RMSNorm (float32 internals)
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dtype)


class RMSNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5,
                 dtype=torch.bfloat16, param_dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features, dtype=param_dtype))

    def forward(self, x):
        return _rms(x, self.scale, self.eps, self.dtype)


def rope_tables(seq_len: int, head_dim: int, theta: float):
    """(cos, sin) float32 tables [T, head_dim/2] (CPU tensors, computed
    in numpy exactly as the JAX model computes them)."""
    freqs = 1.0 / (theta ** (
        np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    t = np.arange(seq_len, dtype=np.float32)
    ang = np.outer(t, freqs)
    return torch.from_numpy(np.cos(ang)), torch.from_numpy(np.sin(ang))


def _rotate(x, c, s):
    x32 = x.float()
    x1, x2 = torch.chunk(x32, 2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def apply_rope(x, cos, sin):
    """Rotate the two halves of each head; x: [B, T, H, D] with D even."""
    t = x.shape[1]
    return _rotate(x, cos[None, :t, None, :], sin[None, :t, None, :])


def _rope_at(x, cos_p, sin_p):
    """apply_rope for a single position per sequence; x: [B, H, D],
    cos_p/sin_p: [B, D/2] rows gathered at each sequence's position."""
    return _rotate(x, cos_p[:, None, :], sin_p[:, None, :])


def _rope_chunk(x, cos_p, sin_p):
    """apply_rope for a window of positions per sequence; x:
    [B, C, H, D], cos_p/sin_p: [B, C, D/2]."""
    return _rotate(x, cos_p[:, :, None, :], sin_p[:, :, None, :])


class LlamaBlock(nn.Module):
    def __init__(self, config: LlamaConfig,
                 attention_fn: Optional[Callable] = None):
        super().__init__()
        cfg = self.config = config
        d, hd = cfg.d_model, cfg.head_dim
        self.attention_fn = attention_fn
        norm = partial(RMSNorm, d, cfg.norm_eps, cfg.dtype, cfg.param_dtype)
        self.attn_norm = norm()
        dense = partial(Dense, dtype=cfg.dtype, bias=False)
        # fused QKV: n_head q-heads + 2 * n_kv_head kv-heads in one matmul
        self.attn_qkv = dense(d, (cfg.n_head + 2 * cfg.n_kv_head) * hd)
        self.attn_out = dense(d, d)
        self.mlp_norm = norm()
        self.mlp_gate_up = dense(d, 2 * cfg.ffn_dim)
        self.mlp_down = dense(cfg.ffn_dim, d)

    def project_qkv(self, x):
        """attn_norm + the fused QKV projection, split into q
        [..., n_head, hd] and k/v [..., n_kv_head, hd] (before RoPE)."""
        cfg = self.config
        hd = cfg.head_dim
        fused = self.attn_qkv(self.attn_norm(x))
        lead = fused.shape[:-1]
        q, k, v = fused.split(
            [cfg.n_head * hd, cfg.n_kv_head * hd, cfg.n_kv_head * hd],
            dim=-1)
        return (q.reshape(*lead, cfg.n_head, hd),
                k.reshape(*lead, cfg.n_kv_head, hd),
                v.reshape(*lead, cfg.n_kv_head, hd))

    def residual_mlp(self, x, att):
        """x + attn_out(att), then the SwiGLU sub-block with its
        residual; att is [..., d_model]."""
        x = x + self.attn_out(att)
        gate, up = self.mlp_gate_up(self.mlp_norm(x)).chunk(2, dim=-1)
        return x + self.mlp_down(F.silu(gate) * up)

    def forward(self, x, cos, sin, kv_sink: Optional[list] = None):
        b, t = x.shape[0], x.shape[1]
        q, k, v = self.project_qkv(x)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        # post-RoPE K/V are what a decode cache needs (the Flax `sow`)
        if kv_sink is not None:
            kv_sink.append((k, v))
        attend = self.attention_fn or partial(full_attention, causal=True)
        att = attend(q, k, v).reshape(b, t, self.config.d_model)
        return self.residual_mlp(x, att)


class Llama(nn.Module):
    """Decoder-only LM with a tied head, as `GPT`: `attention_fn` swaps
    the attention of every block, `return_hidden=True` returns
    `(hidden [B, T, D], wte in cfg.dtype)` for `fused_cross_entropy`, and
    `wte` keeps the dtype `from_params` gave it (f32 master weights are
    cast at use)."""

    def __init__(self, config: LlamaConfig,
                 attention_fn: Optional[Callable] = None):
        super().__init__()
        cfg = self.config = config
        self.wte = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, dtype=cfg.dtype))
        for i in range(cfg.n_layer):
            self.add_module(f"layer{i}", LlamaBlock(cfg, attention_fn))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype,
                                  cfg.param_dtype)
        self._rope: Dict[torch.device, tuple] = {}

    from_params = classmethod(_from_params)

    def blocks(self):
        return [getattr(self, f"layer{i}")
                for i in range(self.config.n_layer)]

    def rope_tables(self, device):
        """The model's (cos, sin) tables on `device`, made once."""
        tabs = self._rope.get(device)
        if tabs is None:
            cfg = self.config
            tabs = tuple(t.to(device) for t in rope_tables(
                cfg.max_seq_len, cfg.head_dim, cfg.rope_theta))
            self._rope[device] = tabs
        return tabs

    def forward(self, tokens, return_hidden: bool = False,
                kv_sink: Optional[list] = None):
        cfg = self.config
        remat = cfg.remat and torch.is_grad_enabled() and kv_sink is None
        x = self.wte.to(cfg.dtype)[tokens]
        cos, sin = self.rope_tables(tokens.device)
        for blk in self.blocks():
            if remat:
                x = checkpoint(blk, x, cos, sin, None, use_reentrant=False)
            else:
                x = blk(x, cos, sin, kv_sink)
        x = self.final_norm(x)
        if return_hidden:
            return x, self.wte.to(cfg.dtype)
        # tied LM head
        return torch.einsum("btd,vd->btv", x, self.wte.to(cfg.dtype))


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None, dtype: Optional[torch.dtype] = None
                ) -> Dict[str, torch.Tensor]:
    """Fresh weights with the Flax model's init distributions (Dense
    kernels and `wte` normal(0.02), norm scales one). Projections and
    `wte` are in `dtype` (default `cfg.dtype`: serving;
    `torch.float32` for training's master weights); values differ from
    JAX's for the same seed, as in `gpt.init_params`."""
    device = resolve_device(device)
    d, hd, dt = cfg.d_model, cfg.head_dim, dtype or cfg.dtype
    normal = partial(_normal, generator=generator, device=device, dtype=dt)
    p = {"wte": normal((cfg.vocab_size, d), 0.02)}
    for i in range(cfg.n_layer):
        for name, (fin, fout) in (
                ("attn_qkv", (d, (cfg.n_head + 2 * cfg.n_kv_head) * hd)),
                ("attn_out", (d, d)),
                ("mlp_gate_up", (d, 2 * cfg.ffn_dim)),
                ("mlp_down", (cfg.ffn_dim, d))):
            p[f"layer{i}.{name}.weight"] = normal((fout, fin), 0.02)
        for name in ("attn_norm", "mlp_norm"):
            p.update(_norm_params(f"layer{i}.{name}", d, cfg.param_dtype,
                                  device, bias=False))
    p.update(_norm_params("final_norm", d, cfg.param_dtype, device,
                          bias=False))
    return p


def param_logical_axes(cfg: LlamaConfig) -> Dict[str, tuple]:
    """Each parameter's logical axes in the torch tensor's dimension order
    (`gpt.param_logical_axes`): the Flax model's Dense kernels reversed,
    `wte` ("vocab", "embed"), the RMSNorm scales ("norm",)."""
    axes = {"wte": ("vocab", "embed"), "final_norm.scale": ("norm",)}
    for i in range(cfg.n_layer):
        for name, kernel in (("attn_qkv", ("embed", "qkv")),
                             ("attn_out", ("heads", "embed")),
                             ("mlp_gate_up", ("embed", "mlp")),
                             ("mlp_down", ("mlp", "embed"))):
            axes[f"layer{i}.{name}.weight"] = kernel[::-1]
        for name in ("attn_norm", "mlp_norm"):
            axes[f"layer{i}.{name}.scale"] = ("norm",)
    return axes


def _sharded_block(blk: LlamaBlock, spmd, prefix: str, x, keep=None, *,
                   cos, sin):
    """The block on this rank's token block, heads and SwiGLU columns
    (module docstring); `cos`/`sin` are the rows of the rank's positions.
    Llama has no dropout (`keep` is None)."""
    cfg = blk.config
    b, t, hd = x.shape[0], x.shape[1], cfg.head_dim
    param = partial(gpt._block_param, blk, spmd, prefix)
    w = spmd.fused(prefix + "attn_qkv.weight", blk.attn_qkv.weight,
                   cfg.dtype, spmd.qkv_rows)
    q, k, v = spmd.split_qkv(F.linear(spmd.tp_input(blk.attn_norm(x)), w),
                             hd)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    attend = blk.attention_fn or partial(full_attention, causal=True)
    att = spmd.attend(attend, q, k, v).reshape(b, t, spmd.heads * hd)
    x = x + spmd.row_linear(att, param("attn_out.weight"))
    w = spmd.fused(prefix + "mlp_gate_up.weight", blk.mlp_gate_up.weight,
                   cfg.dtype, spmd.tp_rows(cfg.ffn_dim, 2))
    gate, up = F.linear(spmd.tp_input(blk.mlp_norm(x)), w).chunk(2, dim=-1)
    x = x + spmd.row_linear(F.silu(gate) * up, param("mlp_down.weight"))
    return spmd.constrain(x, ("batch", "seq", "embed"))


def sharded_hidden(model: Llama, tokens, mesh, shardings):
    """The sharded forward up to `final_norm` on this rank's token block
    [B / data ranks, T / sp] (`gpt.sharded_hidden`'s layout): (hidden
    [B_l, T_l, D], this rank's wte rows, its `gpt._Spmd`)."""
    cfg = model.config
    spmd = gpt._Spmd(mesh, shardings, cfg)
    # the tied head takes wte as it is stored (`gpt.sharded_embed`)
    wte = spmd.param("wte", model.wte, model.wte.dtype)
    x = spmd.constrain(spmd.embed(wte.to(cfg.dtype), tokens),
                       ("batch", "seq", "embed"))
    # the sequence block's positions are its global ones
    t = tokens.shape[1]
    off = spmd.sp_rank * t
    cos, sin = (tab[off:off + t] for tab in model.rope_tables(tokens.device))
    x = gpt.sharded_blocks(model, spmd, x,
                           partial(_sharded_block, cos=cos, sin=sin))
    return model.final_norm(x), wte, spmd


def sharded_loss(model: Llama, tokens, targets, mesh, shardings,
                 ignore_index: int = -1):
    """This rank's share of the global batch's mean token NLL
    (`gpt.sharded_loss`: `gpt.global_loss` sums the shares,
    `gpt.reduce_gradients` completes the gradients)."""
    hidden, wte, spmd = sharded_hidden(model, tokens, mesh, shardings)
    return gpt.sharded_head_loss(hidden, wte, targets, spmd, ignore_index)


# -- decode path (serve.llm) ----------------------------------------------
#
# Inference splits the forward in two:
#   prefill_step — the full-sequence forward (the module itself, so the
#     math is the training forward's) that also returns per-position K/V
#     for seeding the cache, through the blocks' kv_sink tap;
#   decode_step / chunk_step — forwards over a paged KV cache: attention
#     receives the whole page arena plus per-sequence gather indices
#     (page-table rows).


def paged_attend(q, k_new, v_new, k_pages_l, v_pages_l, page_table,
                 valid, scale):
    """One decode token attending over its paged KV history + itself.

    q: [B, H, D]; k_new/v_new: [B, KVH, D] (this token, post-RoPE);
    k_pages_l/v_pages_l: [P, block, KVH, D] (one layer's arena);
    page_table: [B, n_pages] gather indices; valid: [B, T+1] key mask
    (True for cached positions < seq_len and for the appended self key).
    Math matches `full_attention` (NEG_INF mask, row-max subtraction,
    1e-20 sum floor).
    """
    b, h, d = q.shape
    kvh = k_new.shape[1]
    kc = k_pages_l[page_table].reshape(b, -1, kvh, d).to(q.dtype)
    vc = v_pages_l[page_table].reshape(b, -1, kvh, d).to(q.dtype)
    k_all = torch.cat([kc, k_new[:, None]], dim=1)  # [B, T+1, KVH, D]
    v_all = torch.cat([vc, v_new[:, None]], dim=1)
    if kvh != h:  # GQA: repeat KV query-side (expand_kv_heads)
        k_all = torch.repeat_interleave(k_all, h // kvh, dim=2)
        v_all = torch.repeat_interleave(v_all, h // kvh, dim=2)
    logits = torch.einsum("bhd,bkhd->bhk", q, k_all) * scale
    logits = torch.where(valid[:, None, :], logits, NEG_INF)
    row_max = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - row_max)
    row_sum = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bhk,bkhd->bhd", p, v_all)
    return out / torch.clamp(row_sum, min=1e-20)


def paged_attend_chunk(q, k_new, v_new, k_pages_l, v_pages_l, page_table,
                       valid, scale):
    """A window of C tokens attending over paged KV history + the
    window itself (causally).

    q: [B, C, H, D]; k_new/v_new: [B, C, KVH, D] (this window,
    post-RoPE); k_pages_l/v_pages_l: [P, block, KVH, D]; page_table:
    [B, n_pages]; valid: [B, C, T+C] key mask per query position. Same
    math as `paged_attend` (C=1 reduces to it).
    """
    b, c, h, d = q.shape
    kvh = k_new.shape[2]
    kc = k_pages_l[page_table].reshape(b, -1, kvh, d).to(q.dtype)
    vc = v_pages_l[page_table].reshape(b, -1, kvh, d).to(q.dtype)
    k_all = torch.cat([kc, k_new], dim=1)  # [B, T+C, KVH, D]
    v_all = torch.cat([vc, v_new], dim=1)
    if kvh != h:  # GQA: repeat KV query-side (expand_kv_heads)
        k_all = torch.repeat_interleave(k_all, h // kvh, dim=2)
        v_all = torch.repeat_interleave(v_all, h // kvh, dim=2)
    logits = torch.einsum("bchd,bkhd->bhck", q, k_all) * scale
    logits = torch.where(valid[:, None, :, :], logits, NEG_INF)
    row_max = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - row_max)
    row_sum = torch.sum(p, dim=-1, keepdim=True)
    return torch.einsum("bhck,bkhd->bchd",
                        p / torch.clamp(row_sum, min=1e-20), v_all)


def chunk_valid_mask(start, positions, c: int, t_max: int):
    """[B, C, T+C] key mask for `paged_attend_chunk`: query j (global
    position start+j) sees cached keys < start plus window keys <= j.
    Padding rows still compute; the caller discards their output."""
    key_idx = torch.arange(t_max, device=start.device)
    cache_valid = key_idx[None, None, :] < start[:, None, None]
    b = start.shape[0]
    causal = torch.ones(c, c, dtype=torch.bool, device=start.device).tril()
    return torch.cat([cache_valid.expand(b, c, t_max),
                      causal[None].expand(b, c, c)], dim=-1)


def prefill_step(model, cfg: LlamaConfig, tokens, true_len):
    """Prefill: full forward over a padded prompt batch (with the
    attention the model was built with).

    tokens: [B, S_bucket] (positions >= true_len are padding, kept out
    of every real position by causality); true_len: [B]. Returns
    (next_logits [B, V], k [B, S, L, KVH, D], v [B, S, L, KVH, D]); k/v
    rows past true_len are garbage the caller must not cache.
    """
    sink: list = []
    hidden, wte = model(tokens, return_hidden=True, kv_sink=sink)
    k = torch.stack([kv[0] for kv in sink], dim=2)  # [B, S, L, KVH, D]
    v = torch.stack([kv[1] for kv in sink], dim=2)
    return _next_logits(hidden, wte, true_len), k, v


def chunk_step(model, cfg: LlamaConfig, tokens, start,
               k_pages, v_pages, page_table):
    """Forward C tokens per sequence against a paged cache holding each
    sequence's first `start` positions (chunked prefill, prefix-cache
    suffixes).

    tokens: [B, C]; start: [B]; k_pages/v_pages: [P, L, block, KVH, D];
    page_table: [B, n_pages]. Returns (logits [B, C, V], new_k
    [B, C, L, KVH, D], new_v [B, C, L, KVH, D]).
    """
    dtype = cfg.dtype
    hd = cfg.head_dim
    b, c = tokens.shape
    block = k_pages.shape[2]
    t_max = page_table.shape[1] * block
    wte = model.wte.to(dtype)
    x = wte[tokens]  # [B, C, D]
    # clamp pad positions into the rope table (their output is garbage
    # by contract; the clamp only keeps the gather in bounds)
    positions = torch.clamp(
        start[:, None] + torch.arange(c, device=tokens.device)[None, :],
        max=cfg.max_seq_len - 1)
    cos_t, sin_t = model.rope_tables(tokens.device)
    cos_p, sin_p = cos_t[positions], sin_t[positions]  # [B, C, D/2]
    scale = hd ** -0.5
    valid = chunk_valid_mask(start, positions, c, t_max)
    new_ks, new_vs = [], []
    for i, blk in enumerate(model.blocks()):
        q, k, v = blk.project_qkv(x)
        q = _rope_chunk(q, cos_p, sin_p)
        k = _rope_chunk(k, cos_p, sin_p)
        att = paged_attend_chunk(q, k, v, k_pages[:, i], v_pages[:, i],
                                 page_table, valid, scale)
        x = blk.residual_mlp(x, att.reshape(b, c, cfg.d_model))
        new_ks.append(k)
        new_vs.append(v)
    x = model.final_norm(x)
    logits = torch.einsum("bcd,vd->bcv", x, wte)
    return logits, torch.stack(new_ks, dim=2), torch.stack(new_vs, dim=2)


def decode_step(model, cfg: LlamaConfig, tokens, positions,
                k_pages, v_pages, page_table):
    """One decode iteration for a batch of sequences on a paged cache.

    tokens: [B] current token ids; positions: [B] their 0-based
    positions (== tokens already cached per sequence); k_pages/v_pages:
    [P, L, block, KVH, D] arena views; page_table: [B, n_pages] page ids
    per logical block (rows padded with any valid page id — masked).
    Returns (logits [B, V], new_k [B, L, KVH, D], new_v [B, L, KVH, D]);
    the caller appends new_k/new_v into each sequence's tail page.
    """
    dtype = cfg.dtype
    hd = cfg.head_dim
    b = tokens.shape[0]
    block = k_pages.shape[2]
    t_max = page_table.shape[1] * block
    wte = model.wte.to(dtype)
    x = wte[tokens]  # [B, D]
    cos_t, sin_t = model.rope_tables(tokens.device)
    cos_p, sin_p = cos_t[positions], sin_t[positions]
    scale = hd ** -0.5
    key_idx = torch.arange(t_max + 1, device=tokens.device)
    valid = (key_idx[None, :] < positions[:, None]) | \
        (key_idx[None, :] == t_max)
    new_ks, new_vs = [], []
    for i, blk in enumerate(model.blocks()):
        q, k, v = blk.project_qkv(x)
        q = _rope_at(q, cos_p, sin_p)
        k = _rope_at(k, cos_p, sin_p)
        att = paged_attend(q, k, v, k_pages[:, i], v_pages[:, i],
                           page_table, valid, scale)
        x = blk.residual_mlp(x, att.reshape(b, cfg.d_model))
        new_ks.append(k)
        new_vs.append(v)
    x = model.final_norm(x)
    logits = torch.einsum("bd,vd->bv", x, wte)
    return logits, torch.stack(new_ks, dim=1), torch.stack(new_vs, dim=1)


def flops_per_token(cfg: LlamaConfig, seq_len: int | None = None) -> float:
    t = seq_len or cfg.max_seq_len
    hd = cfg.head_dim
    per_layer = (
        2 * cfg.d_model * (cfg.n_head + 2 * cfg.n_kv_head) * hd  # qkv
        + 2 * cfg.d_model * cfg.d_model                          # attn out
        + 3 * 2 * cfg.d_model * cfg.ffn_dim                      # swiglu
    )
    n_flops = cfg.n_layer * per_layer + 2 * cfg.vocab_size * cfg.d_model
    return 3.0 * n_flops + 12.0 * cfg.n_layer * cfg.d_model * t
