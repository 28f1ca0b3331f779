"""GPT-2-family decoder-only transformer in PyTorch.

Port of `ray_tpu/models/gpt.py` for serving: the config, the pre-LN
`Block` with its `attention_fn` seam, the tied-head `GPT`, and the decode
path (`prefill_step`, `decode_step`, `chunk_step`). The training losses
come with the training slice.

Numerics follow the Flax model:
- compute in `cfg.dtype` (bf16 by default). Flax keeps f32 params and
  casts each one to `cfg.dtype` where it is used, so the port stores the
  projection weights and embeddings in `cfg.dtype` already (the values a
  forward sees are identical) and keeps the norm parameters, which Flax
  reads in f32, in `cfg.param_dtype`;
- LayerNorm is Flax's: f32 statistics, fast variance E[x²]−E[x]², eps
  1e-6 (`_ln`), not `torch.nn.LayerNorm`;
- GELU is the tanh approximation (`nn.gelu`'s default);
- projections are `nn.Linear`, whose weight is the transpose of the Flax
  Dense kernel ([out, in] for [in, out]); `models/convert.py` carries
  weights across.

Parameter names follow the Flax tree (`h{i}.attn_qkv.weight` for
`h{i}/attn_qkv/kernel`, `ln_1.scale`, ...).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch import resolve_device
from ray_tpu_torch.parallel.ring_attention import full_attention


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304  # GPT-2 vocab padded to a multiple of 128
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    max_seq_len: int = 1024
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @classmethod
    def gpt2_125m(cls, **kw):
        return cls(n_layer=12, n_head=12, d_model=768, **kw)

    @classmethod
    def gpt2_350m(cls, **kw):
        return cls(n_layer=24, n_head=16, d_model=1024, **kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 512)
        kw.setdefault("max_seq_len", 128)
        return cls(n_layer=2, n_head=2, d_model=64, **kw)


def _ln(x, scale, bias, dtype, eps=1e-6):
    # mirrors flax LayerNorm (f32 stats, fast-variance, eps 1e-6)
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    mean2 = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    var = torch.clamp(mean2 - torch.square(mean), min=0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(dtype)


class LayerNorm(nn.Module):
    """`flax.linen.LayerNorm` as the JAX model configures it (`_ln`)."""

    def __init__(self, features: int, dtype, param_dtype):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype))

    def forward(self, x):
        return _ln(x, self.scale, self.bias, self.dtype)


class Block(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, config: GPTConfig,
                 attention_fn: Optional[Callable] = None):
        super().__init__()
        cfg = self.config = config
        d = cfg.d_model
        self.attention_fn = attention_fn
        self.ln_1 = LayerNorm(d, cfg.dtype, cfg.param_dtype)
        self.attn_qkv = nn.Linear(d, 3 * d, dtype=cfg.dtype)
        self.attn_out = nn.Linear(d, d, dtype=cfg.dtype)
        self.ln_2 = LayerNorm(d, cfg.dtype, cfg.param_dtype)
        self.mlp_up = nn.Linear(d, 4 * d, dtype=cfg.dtype)
        self.mlp_down = nn.Linear(4 * d, d, dtype=cfg.dtype)

    def project_qkv(self, x):
        """ln_1 + the fused QKV projection, split into q/k/v
        [..., n_head, head_dim] (views of one tensor, no copies)."""
        cfg = self.config
        qkv = self.attn_qkv(self.ln_1(x))
        lead = qkv.shape[:-1]
        hd = cfg.d_model // cfg.n_head
        return tuple(t.reshape(*lead, cfg.n_head, hd)
                     for t in qkv.split(cfg.d_model, dim=-1))

    def residual_mlp(self, x, att):
        """x + attn_out(att), then the MLP sub-block with its residual;
        att is [..., d_model]."""
        x = x + self.attn_out(att)
        h = F.gelu(self.mlp_up(self.ln_2(x)), approximate="tanh")
        return x + self.mlp_down(h)

    def forward(self, x, kv_sink: Optional[list] = None):
        b, t = x.shape[0], x.shape[1]
        q, k, v = self.project_qkv(x)
        # decode-cache tap (serve.llm prefill), the Flax `sow`
        if kv_sink is not None:
            kv_sink.append((k, v))
        attend = self.attention_fn or partial(full_attention, causal=True)
        att = attend(q, k, v).reshape(b, t, self.config.d_model)
        return self.residual_mlp(x, att)


def _from_params(cls, config, params: Dict[str, torch.Tensor],
                 attention_fn: Optional[Callable] = None):
    """An inference model over `params` (from `init_params` or
    `convert`), sharing their storage: two models built from one dict
    hold one copy of the weights."""
    with torch.device("meta"):
        net = cls(config, attention_fn)
    net.load_state_dict(params, assign=True)
    return net.requires_grad_(False).eval()


class GPT(nn.Module):
    """Decoder-only LM with a tied head. `attention_fn` swaps the
    attention of every block (the serving engine passes the flash
    kernel). `return_hidden=True` skips the LM head and returns
    `(hidden [B, T, D], wte [V, D])`."""

    def __init__(self, config: GPTConfig,
                 attention_fn: Optional[Callable] = None):
        super().__init__()
        cfg = self.config = config
        self.wte = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, dtype=cfg.dtype))
        self.wpe = nn.Parameter(
            torch.empty(cfg.max_seq_len, cfg.d_model, dtype=cfg.dtype))
        for i in range(cfg.n_layer):
            self.add_module(f"h{i}", Block(cfg, attention_fn))
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype, cfg.param_dtype)

    from_params = classmethod(_from_params)

    def blocks(self):
        return [getattr(self, f"h{i}") for i in range(self.config.n_layer)]

    def forward(self, tokens, return_hidden: bool = False,
                kv_sink: Optional[list] = None):
        cfg = self.config
        t = tokens.shape[1]
        x = self.wte.to(cfg.dtype)[tokens] + self.wpe.to(cfg.dtype)[None, :t]
        for blk in self.blocks():
            x = blk(x, kv_sink)
        x = self.ln_f(x)
        if return_hidden:
            return x, self.wte
        # tied LM head: logits = x @ wte^T
        return torch.einsum("btd,vd->btv", x, self.wte.to(cfg.dtype))


def _normal(shape, std, generator, device, dtype):
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x * std).to(device=device, dtype=dtype)


def init_params(cfg: GPTConfig, generator: torch.Generator,
                device=None) -> Dict[str, torch.Tensor]:
    """Fresh weights with the Flax model's init distributions: Dense
    kernels normal(0.02), biases zero, norm scales one, `wte`
    normal(0.02), `wpe` normal(0.01). The values differ from JAX's for
    the same seed (two different generators); tests that compare the two
    frameworks carry JAX's weights across with `convert` instead."""
    device = resolve_device(device)
    d, dt = cfg.d_model, cfg.dtype
    normal = partial(_normal, generator=generator, device=device, dtype=dt)
    p = {"wte": normal((cfg.vocab_size, d), 0.02),
         "wpe": normal((cfg.max_seq_len, d), 0.01)}
    for i in range(cfg.n_layer):
        for name, (fin, fout) in (("attn_qkv", (d, 3 * d)),
                                  ("attn_out", (d, d)),
                                  ("mlp_up", (d, 4 * d)),
                                  ("mlp_down", (4 * d, d))):
            p[f"h{i}.{name}.weight"] = normal((fout, fin), 0.02)
            p[f"h{i}.{name}.bias"] = torch.zeros(fout, dtype=dt,
                                                 device=device)
        for name in ("ln_1", "ln_2"):
            p.update(_norm_params(f"h{i}.{name}", d, cfg.param_dtype,
                                  device))
    p.update(_norm_params("ln_f", d, cfg.param_dtype, device))
    return p


def _norm_params(prefix, d, dtype, device, bias=True):
    p = {f"{prefix}.scale": torch.ones(d, dtype=dtype, device=device)}
    if bias:
        p[f"{prefix}.bias"] = torch.zeros(d, dtype=dtype, device=device)
    return p


# -- decode path (serve.llm) ----------------------------------------------
# Same two-function split as `llama.py`: prefill is the module itself (K/V
# tapped per block), decode is a single-token forward over a paged cache
# sharing `paged_attend` with Llama.


def unboxed_params(variables):
    """Strip the {"params": ...} wrapper of a Flax variable tree."""
    return variables["params"] if "params" in variables else variables


def _next_logits(hidden, wte, true_len):
    """LM-head logits at each sequence's last real position
    (true_len - 1): only the rows the caller reads are projected."""
    idx = torch.clamp(true_len - 1, min=0)
    rows = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
    return rows @ wte.to(rows.dtype).T


def prefill_step(model, cfg: GPTConfig, tokens, true_len):
    """Full forward over a padded prompt batch (the attention the model
    was built with: the engine passes the flash kernel); returns
    (next_logits [B, V], k [B, S, L, H, D], v [B, S, L, H, D]). K/V rows
    at and past true_len are garbage the caller must not cache."""
    sink: list = []
    hidden, wte = model(tokens, return_hidden=True, kv_sink=sink)
    k = torch.stack([kv[0] for kv in sink], dim=2)
    v = torch.stack([kv[1] for kv in sink], dim=2)
    return _next_logits(hidden, wte, true_len), k, v


def decode_step(model, cfg: GPTConfig, tokens, positions,
                k_pages, v_pages, page_table):
    """Single-token decode over a paged KV cache (MHA: kv heads == query
    heads). Shapes as in `llama.decode_step`."""
    from ray_tpu_torch.models.llama import paged_attend  # import cycle

    dtype = cfg.dtype
    hd = cfg.d_model // cfg.n_head
    b = tokens.shape[0]
    block = k_pages.shape[2]
    t_max = page_table.shape[1] * block
    wte = model.wte.to(dtype)
    x = wte[tokens] + model.wpe.to(dtype)[positions]
    scale = hd ** -0.5
    key_idx = torch.arange(t_max + 1, device=tokens.device)
    # cached keys < position, plus the appended self key at index t_max
    valid = (key_idx[None, :] < positions[:, None]) | \
        (key_idx[None, :] == t_max)
    new_ks, new_vs = [], []
    for i, blk in enumerate(model.blocks()):
        q, k, v = blk.project_qkv(x)                       # [B, H, D]
        att = paged_attend(q, k, v, k_pages[:, i], v_pages[:, i],
                           page_table, valid, scale)
        x = blk.residual_mlp(x, att.reshape(b, cfg.d_model))
        new_ks.append(k)
        new_vs.append(v)
    x = model.ln_f(x)
    logits = torch.einsum("bd,vd->bv", x, wte)
    return logits, torch.stack(new_ks, dim=1), torch.stack(new_vs, dim=1)


def chunk_step(model, cfg: GPTConfig, tokens, start,
               k_pages, v_pages, page_table):
    """Forward C tokens per sequence against a paged cache (chunked
    prefill, prefix-cache suffixes). Shapes as in `llama.chunk_step`."""
    from ray_tpu_torch.models.llama import (  # import cycle
        chunk_valid_mask, paged_attend_chunk)

    dtype = cfg.dtype
    hd = cfg.d_model // cfg.n_head
    b, c = tokens.shape
    block = k_pages.shape[2]
    t_max = page_table.shape[1] * block
    wte = model.wte.to(dtype)
    positions = torch.clamp(
        start[:, None] + torch.arange(c, device=tokens.device)[None, :],
        max=cfg.max_seq_len - 1)
    x = wte[tokens] + model.wpe.to(dtype)[positions]
    scale = hd ** -0.5
    valid = chunk_valid_mask(start, positions, c, t_max)
    new_ks, new_vs = [], []
    for i, blk in enumerate(model.blocks()):
        q, k, v = blk.project_qkv(x)                       # [B, C, H, D]
        att = paged_attend_chunk(q, k, v, k_pages[:, i], v_pages[:, i],
                                 page_table, valid, scale)
        x = blk.residual_mlp(x, att.reshape(b, c, cfg.d_model))
        new_ks.append(k)
        new_vs.append(v)
    x = model.ln_f(x)
    logits = torch.einsum("bcd,vd->bcv", x, wte)
    return logits, torch.stack(new_ks, dim=2), torch.stack(new_vs, dim=2)


def count_params(params) -> int:
    """Parameter count of a param dict or a module."""
    tensors = params.parameters() if isinstance(params, nn.Module) \
        else params.values()
    return sum(int(p.numel()) for p in tensors)


def flops_per_token(cfg: GPTConfig, seq_len: int | None = None) -> float:
    """Approximate training FLOPs per token (6N + attention term)."""
    t = seq_len or cfg.max_seq_len
    n_params = (
        cfg.vocab_size * cfg.d_model
        + cfg.max_seq_len * cfg.d_model
        + cfg.n_layer * (12 * cfg.d_model**2 + 13 * cfg.d_model)
        + 2 * cfg.d_model
    )
    return 6.0 * n_params + 12.0 * cfg.n_layer * cfg.d_model * t
