"""GPT-2-family decoder-only transformer in PyTorch.

Port of `ray_tpu/models/gpt.py`: the config, the pre-LN `Block` with its
`attention_fn` seam, the tied-head `GPT` (with dropout and per-block
remat for training), the training losses (`cross_entropy_loss`,
`chunked_cross_entropy`) and the decode path (`prefill_step`,
`decode_step`, `chunk_step`).

Numerics follow the Flax model:
- compute in `cfg.dtype` (bf16 by default). Flax keeps params in
  `param_dtype` (f32) and casts each one to `cfg.dtype` where it is used;
  the port's `Dense` and embeddings do the same cast at use, so one module
  serves both paths: serving loads weights already in `cfg.dtype` (the
  cast is a no-op, the values a forward sees are identical), training
  loads f32 master weights (`init_params(..., dtype=torch.float32)` or
  `convert.gpt_params_from_jax(..., dtype=torch.float32)`) that the
  optimizer updates. Norm parameters, which Flax reads in f32, stay in
  `cfg.param_dtype`;
- LayerNorm is Flax's: f32 statistics, fast variance E[x²]−E[x]², eps
  1e-6 (`_ln`), not `torch.nn.LayerNorm`;
- GELU is the tanh approximation (`nn.gelu`'s default);
- a `Dense` weight is the transpose of the Flax Dense kernel ([out, in]
  for [in, out]), as in `nn.Linear`; `models/convert.py` carries weights
  across;
- dropout (after `mlp_down` only, as in Flax) draws from an explicit
  `torch.Generator`; the generators differ from JAX's, so only its
  distribution and its p=0 identity carry over.

Parameter names follow the Flax tree (`h{i}.attn_qkv.weight` for
`h{i}/attn_qkv/kernel`, `ln_1.scale`, ...).

Sharded over a mesh (`sharded_loss`), the model holds this rank's shards
of the parameters (`GPT.from_params` with DTensors from
`parallel.sharding.shard_params`, their layouts from `param_shardings`
over `param_logical_axes`, the Flax annotations) and runs the forward of
a JAX `shard_map` body of the GSPMD program: FSDP's `embed` shards
gathered at use (their gradients reduce-scattered back), Megatron column
and row splits over `tp` (`mlp_up`/`mlp_down`, `attn_out`, the fused qkv
gathered and sliced to this rank's heads, the vocab-parallel embedding
and loss), and the sequence over `sp`. The attention is the model's
`attention_fn` (the flash kernel) on this rank's heads, through Ulysses
where sp divides them; where it does not, on the whole sequence of the
rank's heads, gathered over sp (as GSPMD runs dense attention on a split
sequence), each rank keeping its rows. A sequence that sp does not divide
(ViT's 197 tokens) is padded at its end, as GSPMD pads it, and its pad
keys are masked. Dropout there draws the global mask on every rank and
keeps the rank's block (`_Spmd.dropout_keep`).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import resolve_device
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.ring_attention import (expand_kv_heads,
                                                   full_attention,
                                                   ulysses_local)
from ray_tpu_torch.parallel.sharding import (ShardingStrategy,
                                              logical_axis_rules,
                                              logical_to_mesh,
                                              sharding_constraint)


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304  # GPT-2 vocab padded to a multiple of 128
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    max_seq_len: int = 1024
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True

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


class Dense(nn.Module):
    """`flax.linen.Dense(dtype=dtype, use_bias=bias)`: y = x W^T (+ b)
    with the weight ([out, in]) and bias cast to `dtype` at use. Weights
    stored in `dtype` (serving) make the cast a no-op; f32 master weights
    (training) get their gradients through it in f32."""

    def __init__(self, features_in: int, features_out: int, dtype,
                 bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(features_out, features_in, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(features_out, dtype=dtype)) \
            if bias else None

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x, self.weight.to(self.dtype), bias)


def dropout(x, rate: float, keep):
    """`flax.linen.Dropout`: kept entries scaled by 1 / (1 - rate), the
    others zero. `keep` is the boolean mask (`dropout_keep`)."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dropout_keep(shape, rate: float, generator: torch.Generator, device):
    """A keep mask with P(keep) = 1 - rate, drawn from `generator`."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u < 1.0 - rate).to(device)


class Block(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, config: GPTConfig,
                 attention_fn: Optional[Callable] = None):
        super().__init__()
        cfg = self.config = config
        d = cfg.d_model
        self.attention_fn = attention_fn
        self.ln_1 = LayerNorm(d, cfg.dtype, cfg.param_dtype)
        self.attn_qkv = Dense(d, 3 * d, cfg.dtype)
        self.attn_out = Dense(d, d, cfg.dtype)
        self.ln_2 = LayerNorm(d, cfg.dtype, cfg.param_dtype)
        self.mlp_up = Dense(d, 4 * d, cfg.dtype)
        self.mlp_down = Dense(4 * d, d, cfg.dtype)

    def project_qkv(self, x):
        """ln_1 + the fused QKV projection, split into q/k/v
        [..., n_head, head_dim] (views of one tensor, no copies)."""
        cfg = self.config
        qkv = self.attn_qkv(self.ln_1(x))
        lead = qkv.shape[:-1]
        hd = cfg.d_model // cfg.n_head
        return tuple(t.reshape(*lead, cfg.n_head, hd)
                     for t in qkv.split(cfg.d_model, dim=-1))

    def residual_mlp(self, x, att, keep=None):
        """x + attn_out(att), then the MLP sub-block with its residual;
        att is [..., d_model]. `keep` is the dropout mask of the MLP
        output (None: no dropout)."""
        x = x + self.attn_out(att)
        h = F.gelu(self.mlp_up(self.ln_2(x)), approximate="tanh")
        h = self.mlp_down(h)
        if keep is not None:
            h = dropout(h, self.config.dropout, keep)
        return x + h

    def attend(self):
        """The block's attention: its `attention_fn`, else dense causal
        attention (the encoder passes a non-causal one)."""
        return self.attention_fn or partial(full_attention, causal=True)

    def forward(self, x, kv_sink: Optional[list] = None, keep=None):
        b, t = x.shape[0], x.shape[1]
        q, k, v = self.project_qkv(x)
        # decode-cache tap (serve.llm prefill), the Flax `sow`
        if kv_sink is not None:
            kv_sink.append((k, v))
        att = self.attend()(q, k, v).reshape(b, t, self.config.d_model)
        return self.residual_mlp(x, att, keep)


def _from_params(cls, config, params: Dict[str, torch.Tensor],
                 attention_fn: Optional[Callable] = None,
                 trainable: bool = False):
    """A model over `params` (from `init_params` or `convert`), sharing
    their storage: two models built from one dict hold one copy of the
    weights (and an optimizer step on one is seen by the other). By
    default an inference model (frozen, eval mode); `trainable=True`
    gives one whose parameters require grad, in train mode.

    DTensors (`parallel.sharding.shard_params`) give a model of this
    rank's shards: each parameter is the DTensor's local tensor, which
    only `sharded_loss` knows how to run."""
    with torch.device("meta"):
        net = cls(config, attention_fn)
    return load_params(net, params, trainable)


def load_params(net: nn.Module, params: Dict[str, torch.Tensor],
                trainable: bool = False):
    """`net` (built on the meta device) over `params`, as `_from_params`
    describes: the model's state (parameters and buffers) shares their
    storage; DTensors give this rank's shards."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(p, DTensor) for p in params.values()):
        want = set(net.state_dict())
        if set(params) != want:
            raise KeyError(f"from_params: missing {sorted(want - set(params))}"
                           f", unexpected {sorted(set(params) - want)}")
        buffers = {name for name, _ in net.named_buffers()}
        for name, p in params.items():
            mod, _, leaf = name.rpartition(".")
            local = p.to_local()
            setattr(net.get_submodule(mod), leaf, local if name in buffers
                    else nn.Parameter(local, requires_grad=False))
    else:
        net.load_state_dict(params, assign=True)
    return net.requires_grad_(trainable).train(trainable)


class GPT(nn.Module):
    """Decoder-only LM with a tied head. `attention_fn` swaps the
    attention of every block (the serving engine and the train step pass
    the flash kernel). `return_hidden=True` skips the LM head and returns
    `(hidden [B, T, D], wte [V, D])`, for `fused_cross_entropy` or
    `chunked_cross_entropy`.

    Training: `deterministic=False` turns dropout on (`cfg.dropout > 0`),
    drawing from `generator` (inside a `compiled_step` graph too, when the
    generator is one of the step's arguments: `parallel.compile_cache`
    registers it). With `cfg.remat` each block is recomputed in
    the backward (`torch.utils.checkpoint`) whenever grad is enabled; its
    dropout mask is drawn before the checkpointed call, so the recompute
    reuses it."""

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
                kv_sink: Optional[list] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        cfg = self.config
        t = tokens.shape[1]
        drop = cfg.dropout > 0 and not deterministic
        if drop and generator is None:
            raise ValueError("GPT: dropout needs a torch.Generator "
                             "(deterministic=False, dropout > 0)")
        remat = cfg.remat and torch.is_grad_enabled() and kv_sink is None
        x = self.wte.to(cfg.dtype)[tokens] + self.wpe.to(cfg.dtype)[None, :t]
        for blk in self.blocks():
            keep = dropout_keep(x.shape, cfg.dropout, generator, x.device) \
                if drop else None
            if remat:
                x = checkpoint(blk, x, None, keep, use_reentrant=False)
            else:
                x = blk(x, kv_sink, keep)
        x = self.ln_f(x)
        if return_hidden:
            return x, self.wte
        # tied LM head: logits = x @ wte^T
        return torch.einsum("btd,vd->btv", x, self.wte.to(cfg.dtype))


def _normal(shape, std, generator, device, dtype):
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x * std).to(device=device, dtype=dtype)


def init_params(cfg: GPTConfig, generator: torch.Generator,
                device=None, dtype: Optional[torch.dtype] = None
                ) -> Dict[str, torch.Tensor]:
    """Fresh weights with the Flax model's init distributions: Dense
    kernels normal(0.02), biases zero, norm scales one, `wte`
    normal(0.02), `wpe` normal(0.01). Projections and embeddings are in
    `dtype` (default `cfg.dtype`: serving; `torch.float32` for training's
    master weights). The values differ from JAX's for the same seed (two
    different generators); tests that compare the two frameworks carry
    JAX's weights across with `convert` instead."""
    device = resolve_device(device)
    d, dt = cfg.d_model, dtype or cfg.dtype
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


def param_logical_axes(cfg: GPTConfig) -> Dict[str, tuple]:
    """Each parameter's logical axes, in the torch tensor's dimension
    order: the `nn.with_partitioning` annotations of the Flax model (a
    Dense kernel's (in, out) axes reversed for the [out, in] weight, its
    bias the last of them; norms ("norm",); `wte` ("vocab", "embed"),
    `wpe` (None, "embed")). `parallel.sharding.param_shardings` maps them
    through a strategy's rules."""
    axes = {"wte": ("vocab", "embed"), "wpe": (None, "embed"),
            "ln_f.scale": ("norm",), "ln_f.bias": ("norm",)}
    for i in range(cfg.n_layer):
        for name, kernel in (("attn_qkv", ("embed", "qkv")),
                             ("attn_out", ("heads", "embed")),
                             ("mlp_up", ("embed", "mlp")),
                             ("mlp_down", ("mlp", "embed"))):
            axes[f"h{i}.{name}.weight"] = kernel[::-1]
            axes[f"h{i}.{name}.bias"] = (kernel[-1],)
        for name in ("ln_1", "ln_2"):
            axes[f"h{i}.{name}.scale"] = ("norm",)
            axes[f"h{i}.{name}.bias"] = ("norm",)
    return axes


def _norm_params(prefix, d, dtype, device, bias=True):
    p = {f"{prefix}.scale": torch.ones(d, dtype=dtype, device=device)}
    if bias:
        p[f"{prefix}.bias"] = torch.zeros(d, dtype=dtype, device=device)
    return p


def _nll_sum(logits, targets, ignore_index):
    """(sum of the token NLLs in float32 over the targets that are not
    `ignore_index`, their count)."""
    mask = (targets != ignore_index).float()
    targets = torch.clamp(targets, min=0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return (nll * mask).sum(), mask.sum()


def cross_entropy_loss(logits, targets, ignore_index: int = -1):
    """Mean token NLL in float32 (stable softmax on bf16 logits)."""
    total, count = _nll_sum(logits, targets, ignore_index)
    return total / torch.clamp(count, min=1.0)


def _chunk_nll(h_blk, t_blk, wte_c, ignore_index):
    return _nll_sum(torch.einsum("bcd,vd->bcv", h_blk, wte_c), t_blk,
                    ignore_index)


def chunked_cross_entropy(hidden, wte, targets, ignore_index: int = -1,
                          chunk_size: int = 128):
    """LM-head + token NLL computed blockwise over the sequence.

    One [B, chunk, V] logits block is live at a time instead of the whole
    [B, T, V] tensor: each block is checkpointed, so its logits are
    recomputed in the backward rather than kept (the JAX `lax.scan`
    becomes a Python loop). Same math as
    `cross_entropy_loss(logits, targets)` on the full logits; a sequence
    that `chunk_size` does not divide ends with one tail block.
    """
    wte_c = wte.to(hidden.dtype)
    total = count = hidden.new_zeros((), dtype=torch.float32)
    for lo in range(0, hidden.shape[1], chunk_size):  # last: maybe a tail
        args = (hidden[:, lo:lo + chunk_size], targets[:, lo:lo + chunk_size],
                wte_c, ignore_index)
        s, c = checkpoint(_chunk_nll, *args, use_reentrant=False) \
            if torch.is_grad_enabled() else _chunk_nll(*args)
        total, count = total + s, count + c
    return total / torch.clamp(count, min=1.0)


# -- sharded forward (a mesh) ----------------------------------------------

# the axes a batch's tokens are split over: a replicated parameter's
# gradient is summed over them (`reduce_gradients`)
DATA_AXES = ("dcn", "dp", "fsdp", "sp")


class _Spmd:
    """This rank's place in `mesh` for the sharded forward: the groups and
    offsets of its `tp` and `sp` axes, and each parameter's placements.

    Under tp a rank holds `heads` query heads and the `kv_heads` key/value
    heads they read (grouped-query attention: query head h reads kv head
    h // (n_head / n_kv_head); a kv head that several ranks' query heads
    read is held by each of them). `qkv_rows` are the rows of the fused
    qkv ([n_head + 2 n_kv_head heads, d], the JAX layout) of those heads.
    Without a `cfg` (a model without heads) only the mesh's part.

    `seq_len` is the global sequence's length where the model makes the
    sequence itself (ViT's patches); None where the caller split the
    tokens evenly over sp. A length that sp does not divide is padded at
    its end to `t_local * sp` rows, `t_local` a rank (`seq_block`), and
    `key_valid` [t_local * sp] marks the real keys (None: no padding)."""

    def __init__(self, mesh, shardings, cfg=None, seq_len=None):
        self.mesh, self.shardings = mesh, shardings
        self.tp = mesh.axis_size("tp")
        self.tp_rank = mesh.axis_index("tp")
        self.sp = mesh.axis_size("sp")
        self.sp_rank = mesh.axis_index("sp")
        self.seq_len, self.key_valid = seq_len, None
        if seq_len is not None:
            self.t_local = -(-seq_len // self.sp)
            padded = self.t_local * self.sp
            if padded != seq_len:
                self.key_valid = torch.arange(
                    padded, device=mesh.device_type) < seq_len
        self.data_axes = tuple(a for a in DATA_AXES if a in mesh.shape)
        # the axes that split the batch (the others of the data axes, sp,
        # split the sequence)
        self.batch_axes = tuple(a for a in self.data_axes if a != "sp")
        size = mesh.shape.get
        self.rules = logical_axis_rules(ShardingStrategy(
            dp=size("dp", 1), fsdp=size("fsdp", 1), tp=self.tp, sp=self.sp,
            pp=size("pp", 1), ep=size("ep", 1), dcn_dp=size("dcn", 1)))
        if cfg is None:  # a model without attention heads
            return
        n_head = cfg.n_head
        n_kv = getattr(cfg, "n_kv_head", n_head)
        name = type(cfg).__name__.replace("Config", "")
        if n_head % self.tp:
            raise ValueError(f"{name}: {n_head} heads do not split over "
                             f"tp={self.tp}")
        self.heads = n_head // self.tp
        if n_kv % self.tp and self.tp % n_kv:
            raise ValueError(f"{name}: {n_kv} kv heads and tp={self.tp}: "
                             f"neither divides the other")
        group = n_head // n_kv
        kv_lo = self.tp_rank * self.heads // group
        self.kv_heads = max(1, self.heads // group)
        hd = cfg.d_model // n_head
        self.qkv_rows = None if self.tp == 1 else self.rows(
            [(self.tp_rank * self.heads * hd, self.heads * hd),
             ((n_head + kv_lo) * hd, self.kv_heads * hd),
             ((n_head + n_kv + kv_lo) * hd, self.kv_heads * hd)])

    def rows(self, spans):
        """The row indices of `spans` [(start, length), ...], in order."""
        device = self.mesh.device_type
        return torch.cat([torch.arange(n, device=device) + lo
                          for lo, n in spans])

    def tp_rows(self, width: int, blocks: int):
        """The rows of this tp rank's 1/tp of each of `blocks` equal
        blocks of `width` rows (a fused projection such as `[gate; up]`),
        or None at tp=1."""
        if self.tp == 1:
            return None
        n = width // self.tp
        return self.rows([(j * width + self.tp_rank * n, n)
                          for j in range(blocks)])

    def param(self, name, p, dtype, keep=("tp",)):
        """`p` (this rank's shard) in `dtype`, gathered over every mesh axis
        that splits it but those of `keep`: innermost first."""
        p = p.to(dtype)
        pl = self.shardings[name]
        for i in reversed(range(len(pl))):
            axis = self.mesh.axis_names[i]
            if pl[i].is_shard() and axis not in keep:
                p = collectives.allgather(p, axis, gather_dim=pl[i].dim,
                                          mesh=self.mesh)
        return p

    def fused(self, name, p, dtype, rows):
        """A fused projection's weight (or bias) `p` gathered whole and
        sliced to `rows` (this rank's part of each block): an even split
        of its rows would not give a rank its part of every block."""
        p = self.param(name, p, dtype, keep=())
        return p if rows is None else p.index_select(0, rows)

    def constrain(self, x, logical):
        """`nn.with_logical_constraint`: the identity on a local shard,
        which the forward keeps in the constrained layout."""
        return sharding_constraint(x, self.mesh,
                                   logical_to_mesh(logical, self.rules))

    def tp_input(self, x):
        return collectives.replicated_input(x, "tp", mesh=self.mesh)

    def row_linear(self, x, w, b=None):
        """A row-parallel Dense: the partial products summed over tp, then
        the bias (one rank's Dense when tp is 1)."""
        if self.tp == 1:
            return F.linear(x, w, b)
        y = collectives.allreduce(F.linear(x, w), "tp", mesh=self.mesh)
        return y if b is None else y + b

    def embed(self, wte, tokens):
        """The vocab-parallel lookup: each rank's rows, summed over tp."""
        if self.tp == 1:
            return wte[tokens]
        local = tokens - self.tp_rank * wte.shape[0]
        hit = (local >= 0) & (local < wte.shape[0])
        x = wte[torch.clamp(local, 0, wte.shape[0] - 1)] * \
            hit[..., None].to(wte.dtype)
        return collectives.allreduce(x, "tp", mesh=self.mesh)

    def split_qkv(self, qkv, hd):
        """This rank's fused q/k/v columns as q [B, T, heads, hd] and k, v
        [B, T, kv_heads, hd]."""
        b, t = qkv.shape[0], qkv.shape[1]
        q, k, v = qkv.split([self.heads * hd, self.kv_heads * hd,
                             self.kv_heads * hd], dim=-1)
        return tuple(self.constrain(y.reshape(b, t, -1, hd),
                                    ("batch", "seq", "heads", None))
                     for y in (q, k, v))

    def attend(self, fn, q, k, v):
        """This rank's query block [B_l, T_l, heads, hd] attended over the
        whole sequence by `fn` (the model's attention: the flash kernel
        in the decoders). Over sp, Ulysses where sp divides the rank's
        query heads (`fn` on a subset of them over the whole sequence);
        where it does not, q, k and v are gathered over sp, `fn` attends
        the whole sequence of the rank's heads, and the rank keeps its
        rows (the gather's backward reduce-scatters the gradients). A
        padded sequence's `key_valid` goes to `fn`."""
        if self.sp == 1:
            return fn(q, k, v)
        kw = {} if self.key_valid is None else {"key_valid": self.key_valid}
        if self.heads % self.sp:
            t_local = q.shape[1]
            out = fn(*(collectives.allgather(y, "sp", gather_dim=1,
                                             mesh=self.mesh)
                       for y in (q, k, v)), **kw)
            return out.narrow(1, self.sp_rank * t_local, t_local)
        if k.shape[2] % self.sp:
            # Ulysses splits the kv heads over sp: where sp does not
            # divide them, each query head's kv head is repeated first
            k, v = expand_kv_heads(q, k, v)
        return ulysses_local(q, k, v, mesh=self.mesh, attention_fn=fn, **kw)

    def seq_block(self, x):
        """This rank's `t_local` rows of the global sequence x [B, T, ...]
        (`seq_len` rows), padded with zeros at its end."""
        pad = self.t_local * self.sp - x.shape[1]
        if pad:
            x = torch.cat([x, x.new_zeros((x.shape[0], pad,
                                           *x.shape[2:]))], dim=1)
        return x.narrow(1, self.sp_rank * self.t_local, self.t_local)

    def dropout_keep(self, shape, rate: float, generator, device):
        """This rank's block of the dropout mask of the global activation
        whose local block has `shape` [B_l, T_l, ...]: every rank draws
        the global mask from the same generator state (as the JAX package
        draws the global array's bits whatever the mesh), so a sharded
        step drops what the unsharded one does. A padded sequence's mask
        is drawn at its `seq_len` rows, then padded (`seq_block`)."""
        nb = self.mesh.axis_size(self.batch_axes)
        t = shape[1] * self.sp if self.seq_len is None else self.seq_len
        whole = dropout_keep((shape[0] * nb, t, *shape[2:]), rate,
                             generator, device)
        bi = self.mesh.axis_index(self.batch_axes)
        whole = whole.narrow(0, bi * shape[0], shape[0])
        if self.seq_len is not None:
            return self.seq_block(whole)
        return whole.narrow(1, self.sp_rank * shape[1], shape[1])


def _block_param(blk, spmd: _Spmd, prefix: str, name: str, keep=("tp",)):
    """The block's parameter `name` as `spmd.param` gathers it."""
    mod, _, leaf = name.rpartition(".")
    return spmd.param(prefix + name, getattr(blk.get_submodule(mod), leaf),
                      blk.config.dtype, keep)


def _sharded_attention(blk, spmd: _Spmd, prefix: str, x):
    """x + the attention sub-block of `blk` (a `Block`, or any block with
    its ln_1, attn_qkv, attn_out and `attend`) on this rank's heads."""
    cfg = blk.config
    b, t = x.shape[0], x.shape[1]
    hd = cfg.d_model // cfg.n_head
    param = partial(_block_param, blk, spmd, prefix)
    w, bias = (spmd.fused(prefix + f"attn_qkv.{n}",
                          getattr(blk.attn_qkv, n), cfg.dtype,
                          spmd.qkv_rows) for n in ("weight", "bias"))
    qkv = F.linear(spmd.tp_input(blk.ln_1(x)), w, bias)
    q, k, v = spmd.split_qkv(qkv, hd)
    # the block's own mask: causal in the decoders, not in the encoder
    att = spmd.attend(blk.attend(), q, k, v).reshape(b, t, spmd.heads * hd)
    return x + spmd.row_linear(att, param("attn_out.weight"),
                               param("attn_out.bias"))


def _sharded_block(blk: Block, spmd: _Spmd, prefix: str, x, keep=None):
    param = partial(_block_param, blk, spmd, prefix)
    x = _sharded_attention(blk, spmd, prefix, x)
    h = spmd.tp_input(blk.ln_2(x))
    h = F.gelu(F.linear(h, param("mlp_up.weight"), param("mlp_up.bias")),
               approximate="tanh")
    h = spmd.row_linear(h, param("mlp_down.weight"), param("mlp_down.bias"))
    if keep is not None:
        h = dropout(h, blk.config.dropout, keep)
    return spmd.constrain(x + h, ("batch", "seq", "embed"))


def sharded_embed(model, spmd: _Spmd, tokens):
    """The token and position embeddings of this rank's token block, and
    this rank's wte (rows over tp)."""
    cfg = model.config
    t = tokens.shape[1]
    # the tied head takes wte as it is stored (the fused CE casts it), so
    # that its gradient is summed with the embedding's in the master dtype
    # as on one device
    wte = spmd.param("wte", model.wte, model.wte.dtype)
    wpe = spmd.param("wpe", model.wpe, cfg.dtype)
    # the sequence block's positions are its global ones
    off = spmd.sp_rank * t
    x = spmd.embed(wte.to(cfg.dtype), tokens) + wpe[None, off:off + t]
    return x, wte


def sharded_blocks(model, spmd: _Spmd, x, block_fn, deterministic=True,
                   generator: Optional[torch.Generator] = None):
    """`block_fn(blk, spmd, prefix, x, keep)` over the model's blocks (the
    prefix `h{i}.`, or the name `blocks()` gives), each recomputed in the
    backward under `cfg.remat`. With dropout on (`deterministic=False`,
    `cfg.dropout > 0`) each block's mask is this rank's block of the global
    mask, drawn before the block as the unsharded forward draws it."""
    cfg = model.config
    drop = getattr(cfg, "dropout", 0.0) > 0 and not deterministic
    if drop and generator is None:
        raise ValueError(f"{type(model).__name__}: dropout needs a "
                         f"torch.Generator (deterministic=False, "
                         f"dropout > 0)")
    remat = cfg.remat and torch.is_grad_enabled()
    names = dict((id(m), n) for n, m in model.named_children())
    for blk in model.blocks():
        keep = spmd.dropout_keep(x.shape, cfg.dropout, generator, x.device) \
            if drop else None
        fn = partial(block_fn, blk, spmd, names[id(blk)] + ".")
        x = checkpoint(fn, x, keep, use_reentrant=False) if remat \
            else fn(x, keep)
    return x


def sharded_hidden(model: GPT, tokens, mesh, shardings,
                   deterministic: bool = True,
                   generator: Optional[torch.Generator] = None):
    """The sharded forward up to `ln_f` on this rank's token block
    [B / data ranks, T / sp] (module docstring): (hidden [B_l, T_l, D],
    this rank's wte rows, the head's weight, and this rank's `_Spmd`).
    Dropout as `GPT.forward` (`sharded_blocks`)."""
    cfg = model.config
    spmd = _Spmd(mesh, shardings, cfg)
    x, wte = sharded_embed(model, spmd, tokens)
    x = spmd.constrain(x, ("batch", "seq", "embed"))
    x = sharded_blocks(model, spmd, x, _sharded_block, deterministic,
                       generator)
    return model.ln_f(x), wte, spmd


def sharded_loss(model: GPT, tokens, targets, mesh, shardings,
                 ignore_index: int = -1, deterministic: bool = True,
                 generator: Optional[torch.Generator] = None):
    """This rank's share of the mean token NLL of the global batch under
    `mesh` (the JAX sharded step's loss is the sum of the shares over the
    data axes: `global_loss`), through the fused LM-head loss, vocab-
    parallel over tp. `tokens`/`targets` are this rank's blocks;
    `shardings` the parameters' placements (`param_shardings`). After
    `backward`, `reduce_gradients` completes the gradients."""
    hidden, wte, spmd = sharded_hidden(model, tokens, mesh, shardings,
                                       deterministic, generator)
    return sharded_head_loss(hidden, wte, targets, spmd, ignore_index)


def sharded_head_loss(hidden, wte, targets, spmd: _Spmd,
                      ignore_index: int = -1):
    """The fused LM-head loss on this rank's block, vocab-parallel over tp,
    counted over the data axes (`sharded_loss`)."""
    from ray_tpu_torch.ops.fused_ce import fused_cross_entropy

    mesh = spmd.mesh
    return fused_cross_entropy(
        spmd.tp_input(hidden), wte, targets, ignore_index,
        vocab_group=mesh.group("tp"),
        vocab_start=spmd.tp_rank * wte.shape[0],
        count_group=mesh.group(spmd.data_axes))


def sharded_class_loss(logits, labels, spmd: _Spmd):
    """This rank's share of the mean softmax cross-entropy over the global
    batch (`global_loss` sums the shares): `logits` [B_l, classes / tp]
    (f32) are this rank's rows and its classes of a vocab-parallel head
    (`("embed", "vocab")`), whose input the caller marks tp-replicated.
    The row max and the sum of exponentials are all-reduced over tp, and
    so is the label's logit (the rank holding its class gives it). Over
    sp the logits are sp rank 0's (the class token's row lives there):
    the other sp ranks' shares are 0, through their logits, so that
    their backward runs the same collectives."""
    loss = _class_loss(logits, labels, spmd)
    return loss if spmd.sp_rank == 0 else loss * 0.0


def _class_loss(logits, labels, spmd: _Spmd):
    mesh = spmd.mesh
    n = logits.shape[0] * mesh.axis_size(spmd.batch_axes)
    if spmd.tp == 1:
        return F.cross_entropy(logits, labels, reduction="sum") / n
    v = logits.shape[-1]
    with torch.no_grad():
        m = logits.amax(dim=-1)
        torch.distributed.all_reduce(m, torch.distributed.ReduceOp.MAX,
                                     group=mesh.group("tp"))
    total = collectives.allreduce(torch.exp(logits - m[:, None]).sum(-1),
                                  "tp", mesh=mesh)
    local = labels - spmd.tp_rank * v
    hit = (local >= 0) & (local < v)
    label = torch.gather(logits, 1, torch.clamp(local, 0, v - 1)[:, None])
    label = collectives.allreduce(label[:, 0] * hit, "tp", mesh=mesh)
    return (m + torch.log(total) - label).sum() / n


def global_loss(loss, mesh):
    """The global batch's loss from this rank's share (no gradient)."""
    axes = tuple(a for a in DATA_AXES if a in mesh.shape)
    return collectives.allreduce(loss.detach(), axes, mesh=mesh)


def reduce_gradients(params: Dict[str, torch.Tensor], mesh, shardings):
    """Sum each parameter's gradient over the data axes it is replicated
    on, one all-reduce of a flat bucket per set of axes (the axes that
    split it were summed by its gather's reduce-scatter). Parameters
    without a gradient are skipped."""
    buckets: Dict[tuple, list] = {}
    for name, p in params.items():
        if p.grad is None:
            continue
        pl = shardings[name]
        split = {mesh.axis_names[i] for i, x in enumerate(pl) if x.is_shard()}
        axes = tuple(a for a in DATA_AXES if a in mesh.shape and a not in split)
        if mesh.group(axes) is not None:
            buckets.setdefault(axes, []).append(p)
    for axes, ps in buckets.items():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        torch.distributed.all_reduce(flat, group=mesh.group(axes))
        for p, g in zip(ps, flat.split([p.numel() for p in ps])):
            p.grad = g.view_as(p)


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
