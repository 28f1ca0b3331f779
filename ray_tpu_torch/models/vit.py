"""Vision Transformer (ViT) classifier in PyTorch.

Port of `ray_tpu/models/vit.py`: a patchify convolution (kernel = stride =
patch), a cls token first, learned position embeddings, pre-LN encoder
blocks and a linear head on the cls token. The attention is the JAX
model's plain einsums, outside any kernel: scores scaled by 1/sqrt(hd) in
the activation dtype, softmax in f32 and cast back, then P.V
(`torch.einsum`). LayerNorm and Dense are `gpt`'s (Flax numerics); GELU
is the tanh approximation.

Images are NHWC, as the JAX signature takes them; the patchify weight is
the convolution kernel in torch's OIHW layout (`convert` transposes the
Flax HWIO kernel), and the patches flatten row-major over (H', W'), as
the JAX reshape does. Parameter names follow the Flax tree
(`encoder{i}.attn_qkv.weight`, `patchify.weight`, `cls`, `pos_embed`,
`head.weight`).

Sharded (`sharded_loss`) over the data axes, fsdp, tp and sp, as GSPMD
shards the annotated Flax model (`param_logical_axes`): the blocks as the
decoders' (`gpt`'s sharded block), the class head vocab-parallel over tp.
Over sp the 1 + patches tokens (197 at ViT-B/16, which no sp > 1
divides) are padded at their end as GSPMD pads them, each rank holding
its rows, and the attention masks the pad keys.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models.gpt import Dense, LayerNorm
from ray_tpu_torch.parallel import collectives


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    mlp_mult: int = 4
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def base_16(cls, **kw):  # ViT-B/16
        return cls(n_layer=12, n_head=12, d_model=768, **kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("image_size", 32)
        kw.setdefault("patch_size", 8)
        kw.setdefault("num_classes", 10)
        return cls(n_layer=2, n_head=4, d_model=64, **kw)


class EncoderBlock(nn.Module):
    """Pre-LN encoder block with the JAX model's plain attention."""

    def __init__(self, config: ViTConfig):
        super().__init__()
        cfg = self.config = config
        d = cfg.d_model
        self.ln_1 = LayerNorm(d, cfg.dtype, cfg.param_dtype)
        self.attn_qkv = Dense(d, 3 * d, cfg.dtype)
        self.attn_out = Dense(d, d, cfg.dtype)
        self.ln_2 = LayerNorm(d, cfg.dtype, cfg.param_dtype)
        self.mlp_up = Dense(d, cfg.mlp_mult * d, cfg.dtype)
        self.mlp_down = Dense(cfg.mlp_mult * d, d, cfg.dtype)

    def attend(self):
        """The block's attention on [B, T, H, hd] q/k/v (any H): the JAX
        model's einsums."""
        return self._attention

    def _attention(self, q, k, v, key_valid=None):
        cfg = self.config
        # sqrt(hd) rounded to the activation dtype, as the JAX model takes
        # it; a host number, so that a captured step copies nothing
        scale = float(torch.sqrt(torch.tensor(q.shape[-1], dtype=cfg.dtype)))
        scores = (torch.einsum("bqhd,bkhd->bhqk", q, k) / scale).float()
        if key_valid is not None:
            # the pad keys of a sequence padded over sp (`gpt._Spmd`)
            scores = scores.masked_fill(~key_valid, float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    def forward(self, x, keep=None):
        cfg = self.config
        b, t = x.shape[0], x.shape[1]
        hd = cfg.d_model // cfg.n_head
        q, k, v = (y.reshape(b, t, cfg.n_head, hd) for y in
                   self.attn_qkv(self.ln_1(x)).split(cfg.d_model, dim=-1))
        att = self._attention(q, k, v).reshape(b, t, cfg.d_model)
        x = x + self.attn_out(att)
        h = F.gelu(self.mlp_up(self.ln_2(x)), approximate="tanh")
        h = self.mlp_down(h)
        if keep is not None:
            h = gpt.dropout(h, cfg.dropout, keep)
        return x + h


class ViT(nn.Module):
    """images [B, H, W, C] -> class logits [B, num_classes] (f32). Dropout
    (`deterministic=False`) draws from `generator` as in `gpt.GPT`; with
    `cfg.remat` each block is recomputed in the backward."""

    def __init__(self, config: ViTConfig, channels: int = 3):
        super().__init__()
        cfg = self.config = config
        d, p = cfg.d_model, cfg.patch_size
        self.patchify = nn.Module()
        self.patchify.weight = nn.Parameter(
            torch.empty(d, channels, p, p, dtype=cfg.dtype))
        self.patchify.bias = nn.Parameter(torch.empty(d, dtype=cfg.dtype))
        self.cls = nn.Parameter(torch.empty(1, d, dtype=cfg.dtype))
        self.pos_embed = nn.Parameter(
            torch.empty(cfg.num_patches + 1, d, dtype=cfg.dtype))
        for i in range(cfg.n_layer):
            self.add_module(f"encoder{i}", EncoderBlock(cfg))
        self.ln_f = LayerNorm(d, cfg.dtype, cfg.param_dtype)
        self.head = Dense(d, cfg.num_classes, cfg.dtype)

    @classmethod
    def from_params(cls, config: ViTConfig, params: Dict[str, torch.Tensor],
                    trainable: bool = False):
        """A model over `params` (`gpt._from_params`' contract)."""
        with torch.device("meta"):
            net = cls(config, channels=params["patchify.weight"].shape[1])
        return gpt.load_params(net, params, trainable)

    def blocks(self):
        return [getattr(self, f"encoder{i}")
                for i in range(self.config.n_layer)]

    def forward(self, images, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        cfg = self.config
        drop = cfg.dropout > 0 and not deterministic
        if drop and generator is None:
            raise ValueError("ViT: dropout needs a torch.Generator "
                             "(deterministic=False, dropout > 0)")
        x = _embed(cfg, images, self.patchify.weight, self.patchify.bias,
                   self.cls, self.pos_embed)
        remat = cfg.remat and torch.is_grad_enabled()
        for blk in self.blocks():
            keep = gpt.dropout_keep(x.shape, cfg.dropout, generator,
                                    x.device) if drop else None
            x = checkpoint(blk, x, keep, use_reentrant=False) if remat \
                else blk(x, keep)
        x = self.ln_f(x)
        return self.head(x[:, 0]).float()


def _embed(cfg: ViTConfig, images, w, b, cls, pos):
    """Patchify, the cls token first, the position embeddings: [B, 1 +
    patches, D] in `cfg.dtype`."""
    dt = cfg.dtype
    x = F.conv2d(images.to(dt).permute(0, 3, 1, 2), w.to(dt), b.to(dt),
                 stride=cfg.patch_size)
    n = x.shape[0]
    x = x.permute(0, 2, 3, 1).reshape(n, -1, cfg.d_model)
    x = torch.cat([cls.to(dt).expand(n, 1, cfg.d_model), x], dim=1)
    return x + pos.to(dt)[None]


def _xavier_uniform(shape, fan_in, fan_out, generator, device, dtype):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, device=generator.device)
    return ((2.0 * u - 1.0) * limit).to(device=device, dtype=dtype)


def init_params(cfg: ViTConfig, generator: torch.Generator, device=None,
                dtype: Optional[torch.dtype] = None, channels: int = 3
                ) -> Dict[str, torch.Tensor]:
    """Fresh weights with the Flax model's init distributions: Dense and
    patchify kernels xavier-uniform (a conv's fans are its channels times
    the receptive field), biases and `cls` zero, `pos_embed` normal(0.02),
    norm scales one. Dtypes as `gpt.init_params`."""
    device = resolve_device(device)
    dt = dtype or cfg.dtype
    d, p = cfg.d_model, cfg.patch_size

    def dense(name, fin, fout):
        out[f"{name}.weight"] = _xavier_uniform((fout, fin), fin, fout,
                                                generator, device, dt)
        out[f"{name}.bias"] = torch.zeros(fout, dtype=dt, device=device)

    out = {"patchify.weight": _xavier_uniform(
               (d, channels, p, p), channels * p * p, d * p * p, generator,
               device, dt),
           "patchify.bias": torch.zeros(d, dtype=dt, device=device),
           "cls": torch.zeros(1, d, dtype=dt, device=device),
           "pos_embed": gpt._normal((cfg.num_patches + 1, d), 0.02,
                                    generator, device, dt)}
    f = cfg.mlp_mult * d
    for i in range(cfg.n_layer):
        for name, fin, fout in (("attn_qkv", d, 3 * d), ("attn_out", d, d),
                                ("mlp_up", d, f), ("mlp_down", f, d)):
            dense(f"encoder{i}.{name}", fin, fout)
        for name in ("ln_1", "ln_2"):
            out.update(gpt._norm_params(f"encoder{i}.{name}", d,
                                        cfg.param_dtype, device))
    out.update(gpt._norm_params("ln_f", d, cfg.param_dtype, device))
    dense("head", d, cfg.num_classes)
    return out


def param_logical_axes(cfg: ViTConfig) -> Dict[str, tuple]:
    """Each parameter's logical axes in the torch tensor's dimension order
    (`gpt.param_logical_axes`): the encoder blocks' as GPT's, the patchify
    kernel's output channels "embed" (its bias unannotated), `cls` and
    `pos_embed` (None, "embed"), the head ("embed", "vocab") reversed."""
    axes = {"patchify.weight": ("embed", None, None, None),
            "patchify.bias": (None,), "cls": (None, "embed"),
            "pos_embed": (None, "embed"), "ln_f.scale": ("norm",),
            "ln_f.bias": ("norm",), "head.weight": ("vocab", "embed"),
            "head.bias": ("vocab",)}
    for name, a in gpt.param_logical_axes(
            gpt.GPTConfig(n_layer=cfg.n_layer)).items():
        if name.startswith("h"):
            axes["encoder" + name[1:]] = a
    return axes


def sharded_hidden(model: ViT, images, mesh, shardings,
                   deterministic: bool = True,
                   generator: Optional[torch.Generator] = None):
    """The sharded forward up to `ln_f` on this rank's images [B / data
    ranks, H, W, C] (under sp, as `shard_batch` places them, their rows
    split over sp: gathered here): (hidden [B_l, T_l, D], its
    `gpt._Spmd`). Over the data axes, fsdp (the `embed` shards gathered
    at use), tp (`gpt`'s sharded block on this rank's heads, with the JAX
    model's plain attention) and sp: the 1 + patches tokens padded with
    zero rows at their end to T_l = ceil((1 + patches) / sp) a rank (the
    class token's row first on sp rank 0; each rank's position
    embeddings its rows'), the pad keys masked in the attention, the pad
    rows never read by a real one. Dropout from the global masks."""
    cfg = model.config
    spmd = gpt._Spmd(mesh, shardings, cfg, seq_len=cfg.num_patches + 1)
    if images.shape[1] < cfg.image_size:
        images = collectives.allgather(images, "sp", gather_dim=1,
                                       mesh=mesh)
    param = partial(spmd.param, dtype=cfg.dtype)
    x = _embed(cfg, images,
               *(param(n, p) for n, p in (
                   ("patchify.weight", model.patchify.weight),
                   ("patchify.bias", model.patchify.bias),
                   ("cls", model.cls), ("pos_embed", model.pos_embed))))
    x = spmd.constrain(spmd.seq_block(x), ("batch", "seq", "embed"))
    x = gpt.sharded_blocks(model, spmd, x, gpt._sharded_block, deterministic,
                           generator)
    return model.ln_f(x), spmd


def sharded_loss(model: ViT, images, labels, mesh, shardings,
                 deterministic: bool = True,
                 generator: Optional[torch.Generator] = None):
    """This rank's share of the global batch's mean softmax cross-entropy
    of the class logits (`gpt.global_loss` sums the shares,
    `gpt.reduce_gradients` completes the gradients, over sp too): the
    head is vocab-parallel over tp and reads the class token's row on sp
    rank 0 (`gpt.sharded_class_loss`)."""
    hidden, spmd = sharded_hidden(model, images, mesh, shardings,
                                  deterministic, generator)
    dt = model.config.dtype
    logits = F.linear(spmd.tp_input(hidden[:, 0]),
                      spmd.param("head.weight", model.head.weight, dt),
                      spmd.param("head.bias", model.head.bias, dt))
    return gpt.sharded_class_loss(logits.float(), labels, spmd)
