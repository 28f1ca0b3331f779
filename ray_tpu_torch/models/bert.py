"""BERT-family bidirectional encoder in PyTorch.

Port of `ray_tpu/models/bert.py`: the encoder reuses the decoder's
`gpt.Block` (pre-LN, fused QKV, GELU MLP), and only the attention's mask
differs: each block gets non-causal attention (`full_attention(causal=
False)` by default; the flash kernel with `causal=False` on the card).
The MLM objective is the fused LM-head cross-entropy on the tied word
embedding: positions that were not masked carry `ignore_index` targets,
so `fused_cross_entropy(hidden, wte, mlm_targets)` scores exactly the
masked positions (the mean over them; 0 for a batch without any).

The module holds its parameters (`BertEncoder.from_params` over
`init_params` or `convert.bert_params_from_jax`), so `mlm_loss` takes the
encoder and no separate params. `mask_tokens` draws BERT's 80/10/10
corruption from a `torch.Generator`; its bits are not `jax.random`'s.

Sharded over a mesh (`sharded_hidden`, `sharded_mlm_loss`), the encoder
runs `gpt`'s sharded block (data axes, tp, sp) with each block's own
non-causal attention, and dropout from the global masks.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models.gpt import Block, GPTConfig, LayerNorm
from ray_tpu_torch.parallel.ring_attention import full_attention


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30528       # padded to a multiple of 64
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    max_seq_len: int = 512
    type_vocab_size: int = 2      # segment A/B embeddings
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True

    @classmethod
    def bert_base(cls, **kw):
        return cls(n_layer=12, n_head=12, d_model=768, **kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 512)
        kw.setdefault("max_seq_len", 128)
        return cls(n_layer=2, n_head=2, d_model=64, **kw)

    def _gpt_view(self) -> GPTConfig:
        """The blocks' config: the decoder's, with this encoder's widths."""
        return GPTConfig(
            vocab_size=self.vocab_size, n_layer=self.n_layer,
            n_head=self.n_head, d_model=self.d_model,
            max_seq_len=self.max_seq_len, dropout=self.dropout,
            dtype=self.dtype, param_dtype=self.param_dtype,
            remat=self.remat)


class BertEncoder(nn.Module):
    """Bidirectional encoder: `forward(tokens, token_types=None)` returns
    the final hidden states and the tied word embedding `(hidden, wte)`,
    ready for `fused_cross_entropy` (MLM) or downstream heads.
    `attention_fn` is every block's attention (non-causal dense by
    default). Dropout (`deterministic=False`) draws from `generator` as in
    `gpt.GPT`."""

    def __init__(self, config: BertConfig,
                 attention_fn: Optional[Callable] = None):
        super().__init__()
        cfg = self.config = config
        d = cfg.d_model
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, d,
                                            dtype=cfg.dtype))
        self.wpe = nn.Parameter(torch.empty(cfg.max_seq_len, d,
                                            dtype=cfg.dtype))
        self.wtt = nn.Parameter(torch.empty(cfg.type_vocab_size, d,
                                            dtype=cfg.dtype))
        attend = attention_fn or partial(full_attention, causal=False)
        gcfg = cfg._gpt_view()
        for i in range(cfg.n_layer):
            self.add_module(f"h{i}", Block(gcfg, attend))
        self.ln_f = LayerNorm(d, cfg.dtype, cfg.param_dtype)

    from_params = classmethod(gpt._from_params)

    def blocks(self):
        return [getattr(self, f"h{i}") for i in range(self.config.n_layer)]

    def embed(self, tokens, token_types=None):
        cfg = self.config
        t = tokens.shape[1]
        x = self.wte.to(cfg.dtype)[tokens] + self.wpe.to(cfg.dtype)[None, :t]
        if token_types is not None:
            x = x + self.wtt.to(cfg.dtype)[token_types]
        return x

    def forward(self, tokens, token_types=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        cfg = self.config
        drop = cfg.dropout > 0 and not deterministic
        if drop and generator is None:
            raise ValueError("BertEncoder: dropout needs a torch.Generator "
                             "(deterministic=False, dropout > 0)")
        remat = cfg.remat and torch.is_grad_enabled()
        x = self.embed(tokens, token_types)
        for blk in self.blocks():
            keep = gpt.dropout_keep(x.shape, cfg.dropout, generator,
                                    x.device) if drop else None
            x = checkpoint(blk, x, None, keep, use_reentrant=False) \
                if remat else blk(x, None, keep)
        return self.ln_f(x), self.wte


def mlm_loss(encoder: BertEncoder, tokens, mlm_targets, token_types=None,
             ignore_index: int = -1, deterministic: bool = True,
             generator: Optional[torch.Generator] = None):
    """Masked-LM objective: `mlm_targets` holds the original token at
    masked positions and `ignore_index` everywhere else."""
    from ray_tpu_torch.ops.fused_ce import fused_cross_entropy

    hidden, wte = encoder(tokens, token_types, deterministic=deterministic,
                          generator=generator)
    return fused_cross_entropy(hidden, wte, mlm_targets, ignore_index)


def mask_tokens(tokens, generator: torch.Generator, *, mask_token_id: int,
                vocab_size: int, mask_prob: float = 0.15,
                ignore_index: int = -1):
    """BERT's 80/10/10 corruption: returns (corrupted, mlm_targets). Of
    the positions selected with `mask_prob`, 80 % become `mask_token_id`,
    10 % a random token and 10 % stay."""
    dev = generator.device
    selected = torch.rand(tokens.shape, generator=generator,
                          device=dev).to(tokens.device) < mask_prob
    kind = torch.rand(tokens.shape, generator=generator,
                      device=dev).to(tokens.device)
    random_toks = torch.randint(0, vocab_size, tokens.shape,
                                generator=generator,
                                device=dev).to(tokens)
    corrupted = torch.where(
        selected & (kind < 0.8), torch.full_like(tokens, mask_token_id),
        torch.where(selected & (kind >= 0.9), random_toks, tokens))
    targets = torch.where(selected, tokens,
                          torch.full_like(tokens, ignore_index))
    return corrupted, targets


def init_params(cfg: BertConfig, generator: torch.Generator, device=None,
                dtype: Optional[torch.dtype] = None
                ) -> Dict[str, torch.Tensor]:
    """Fresh weights with the Flax encoder's init distributions: the
    blocks' as `gpt.init_params`, `wte` normal(0.02), `wpe` and `wtt`
    normal(0.01); dtypes as there."""
    device = resolve_device(device)
    dt = dtype or cfg.dtype
    p = gpt.init_params(cfg._gpt_view(), generator, device=device, dtype=dt)
    p["wtt"] = gpt._normal((cfg.type_vocab_size, cfg.d_model), 0.01,
                           generator, device, dt)
    return p


def param_logical_axes(cfg: BertConfig) -> Dict[str, tuple]:
    """Each parameter's logical axes: the decoder's, and `wtt` (None,
    "embed")."""
    axes = gpt.param_logical_axes(cfg._gpt_view())
    axes["wtt"] = (None, "embed")
    return axes


# -- sharded forward (a mesh) ----------------------------------------------


def sharded_hidden(model: BertEncoder, tokens, mesh, shardings,
                   token_types=None, deterministic: bool = True,
                   generator: Optional[torch.Generator] = None):
    """The encoder on this rank's token block (`gpt.sharded_hidden`'s
    layout): (hidden [B_l, T_l, D], this rank's wte rows, its `_Spmd`).
    Dropout as `BertEncoder.forward`, each mask this rank's block of the
    global one (`gpt.sharded_blocks`)."""
    cfg = model.config
    spmd = gpt._Spmd(mesh, shardings, cfg)
    x, wte = gpt.sharded_embed(model, spmd, tokens)
    if token_types is not None:
        x = x + spmd.param("wtt", model.wtt, cfg.dtype)[token_types]
    x = spmd.constrain(x, ("batch", "seq", "embed"))
    x = gpt.sharded_blocks(model, spmd, x, gpt._sharded_block,
                           deterministic, generator)
    return model.ln_f(x), wte, spmd


def sharded_mlm_loss(model: BertEncoder, tokens, mlm_targets, mesh,
                     shardings, token_types=None, ignore_index: int = -1,
                     deterministic: bool = True,
                     generator: Optional[torch.Generator] = None):
    """This rank's share of the global batch's MLM loss (the mean over
    every masked position of the global batch), as `gpt.sharded_loss`."""
    hidden, wte, spmd = sharded_hidden(model, tokens, mesh, shardings,
                                       token_types, deterministic,
                                       generator)
    return gpt.sharded_head_loss(hidden, wte, mlm_targets, spmd,
                                 ignore_index)
