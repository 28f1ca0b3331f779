"""Mixture-of-Experts decoder LM (Switch-style top-1) in PyTorch.

Port of `ray_tpu/models/moe_gpt.py`: the GPT decoder with the dense MLP
replaced by a top-1-routed expert layer whose experts are a leading
parameter axis. The arithmetic is the JAX model's:

- routing in f32 (the router's logits, softmax, argmax and gate);
- one capacity for every expert, C = max(1, int(capacity_factor * T / E))
  over all T tokens of the call, and each token's slot in its expert's
  buffer from a cumulative sum in token order; tokens past C pass through
  the residual untouched;
- the dense dispatch and combine einsums ([T, E, C] masks in the
  activation dtype), GELU (tanh) experts;
- the Switch load-balancing loss E * sum(density * mean prob), scaled by
  `router_aux_coeff`.

The Flax model `sow`s each layer's aux loss into a collection; here it is
an explicit return: `MoEGPT.forward` gives `(logits, aux)` (or `(hidden,
wte, aux)` with `return_hidden=True`), `aux` the list of the layers'
scaled losses in layer order, and `total_aux_loss(aux)` their sum, which
the caller adds to the task loss.

Parameters follow the Flax tree: the attention half of each block is
`gpt.Block`'s (`h{i}.attn_qkv.weight`, ...), the expert layer keeps the
JAX layouts (`h{i}.moe.router` [d, E], `h{i}.moe.experts_up` [E, d, 4d],
`h{i}.moe.experts_down` [E, 4d, d]); the router, which Flax reads in f32,
stays in `cfg.param_dtype` like the norms.

Sharded (`sharded_loss`) over data axes, `ep`, `tp` and `sp`: the expert
leaves are split over `ep` by their "expert" axis and over `tp` by their
"mlp" axis (`param_logical_axes`). The JAX model is GSPMD-global, so the
routing is the global one: C comes from the global token count, and a
token's slot counts the same-expert tokens before it in the global (b, t)
order, those of the earlier rows and, under sp, of the earlier sequence
blocks of its own row (`_row_offsets`). Each rank builds its slots of the
[E, C, d] buffers of its `ep` rank's experts, the buffers are summed over
the data axes, the experts run as a Megatron pair each (their partial
outputs summed over `tp`), and their outputs are gathered over `ep`. The
attention is `gpt`'s sharded one (tp heads, Ulysses over sp); the router
stays whole and in f32.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models.gpt import (Block, Dense, GPTConfig, LayerNorm,
                                      _from_params)
from ray_tpu_torch.parallel import collectives


@dataclasses.dataclass(frozen=True)
class MoEGPTConfig(GPTConfig):
    num_experts: int = 8
    capacity_factor: float = 1.25
    router_aux_coeff: float = 0.01

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 512)
        kw.setdefault("max_seq_len", 128)
        kw.setdefault("num_experts", 4)
        return cls(n_layer=2, n_head=2, d_model=64, **kw)


def capacity(cfg: MoEGPTConfig, tokens: int) -> int:
    """Each expert's buffer length for a call of `tokens` tokens."""
    return max(1, int(cfg.capacity_factor * tokens / cfg.num_experts))


def top1(flat, router, num_experts: int):
    """f32 top-1 routing of [T, d] tokens: (probs [T, E], gate [T],
    onehot [T, E] int32)."""
    probs = torch.softmax(flat.float() @ router.float(), dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = torch.gather(probs, 1, expert[:, None])[:, 0]
    # comparisons, not F.one_hot: its range checks would sync the host
    # inside a captured step
    ids = torch.arange(num_experts, device=flat.device)
    return probs, gate, (expert[:, None] == ids).to(torch.int32)


def slots(onehot, gate, cap: int, dtype, offset=None):
    """(dispatch [T, E, C], combine [T, E, C]) in `dtype`: a token's slot
    is its rank among its expert's tokens in token order; tokens past
    `cap` get none. With `offset` [R, E] the tokens are R rows of equal
    length, and a token's rank counts within its row from `offset[row,
    e]` (the same-expert tokens before the row's first one)."""
    if offset is None:
        position = torch.cumsum(onehot, dim=0) * onehot - 1
    else:
        rows, e = offset.shape
        oh = onehot.reshape(rows, -1, e)
        position = ((torch.cumsum(oh, dim=1) + offset[:, None]) * oh
                    - 1).reshape(-1, e)
    keep = (position >= 0) & (position < cap)
    pos_c = torch.clamp(position, 0, cap - 1)
    ids = torch.arange(cap, device=onehot.device)
    dispatch = ((pos_c[..., None] == ids) & keep[..., None]).to(dtype)
    return dispatch, dispatch * gate.to(dtype)[:, None, None]


def _experts(buf, w_up, w_down):
    h = F.gelu(torch.einsum("ecd,edf->ecf", buf, w_up), approximate="tanh")
    return torch.einsum("ecf,efd->ecd", h, w_down)


class MoEMLP(nn.Module):
    """Top-1 routed expert MLP: [B, T, d] -> ([B, T, d], the layer's
    scaled aux loss)."""

    def __init__(self, config: MoEGPTConfig):
        super().__init__()
        cfg = self.config = config
        d, e = cfg.d_model, cfg.num_experts
        self.router = nn.Parameter(torch.empty(d, e, dtype=cfg.param_dtype))
        self.experts_up = nn.Parameter(
            torch.empty(e, d, 4 * d, dtype=cfg.dtype))
        self.experts_down = nn.Parameter(
            torch.empty(e, 4 * d, d, dtype=cfg.dtype))

    def forward(self, x):
        cfg, dt = self.config, self.config.dtype
        b, t, d = x.shape
        flat = x.reshape(b * t, d)
        probs, gate, onehot = top1(flat, self.router, cfg.num_experts)
        dispatch, combine = slots(onehot, gate, capacity(cfg, b * t), dt)
        buf = torch.einsum("td,tec->ecd", flat, dispatch)
        h = _experts(buf, self.experts_up.to(dt), self.experts_down.to(dt))
        out = torch.einsum("ecd,tec->td", h, combine)
        density = onehot.float().mean(dim=0)
        aux = torch.sum(density * probs.mean(dim=0)) * cfg.num_experts
        return out.reshape(b, t, d), cfg.router_aux_coeff * aux


class MoEBlock(nn.Module):
    """`gpt.Block` with the MLP an expert layer: x -> (x, aux)."""

    def __init__(self, config: MoEGPTConfig,
                 attention_fn: Optional[Callable] = None):
        super().__init__()
        cfg = self.config = config
        d = cfg.d_model
        self.attention_fn = attention_fn
        self.ln_1 = LayerNorm(d, cfg.dtype, cfg.param_dtype)
        self.attn_qkv = Dense(d, 3 * d, cfg.dtype)
        self.attn_out = Dense(d, d, cfg.dtype)
        self.ln_2 = LayerNorm(d, cfg.dtype, cfg.param_dtype)
        self.moe = MoEMLP(cfg)

    project_qkv = Block.project_qkv
    attend = Block.attend

    def forward(self, x):
        b, t = x.shape[0], x.shape[1]
        q, k, v = self.project_qkv(x)
        att = self.attend()(q, k, v).reshape(b, t, self.config.d_model)
        x = x + self.attn_out(att)
        y, aux = self.moe(self.ln_2(x))
        return x + y, aux


class MoEGPT(nn.Module):
    """MoE decoder LM with a tied head. `forward(tokens)` returns
    `(logits, aux)`; with `return_hidden=True`, `(hidden, wte, aux)` for
    `fused_cross_entropy`. `aux` is the list of the layers' scaled router
    losses (`total_aux_loss`). With `cfg.remat` each block is recomputed
    in the backward whenever grad is enabled."""

    def __init__(self, config: MoEGPTConfig,
                 attention_fn: Optional[Callable] = None):
        super().__init__()
        cfg = self.config = config
        self.wte = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, dtype=cfg.dtype))
        self.wpe = nn.Parameter(
            torch.empty(cfg.max_seq_len, cfg.d_model, dtype=cfg.dtype))
        for i in range(cfg.n_layer):
            self.add_module(f"h{i}", MoEBlock(cfg, attention_fn))
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype, cfg.param_dtype)

    from_params = classmethod(_from_params)

    def blocks(self):
        return [getattr(self, f"h{i}") for i in range(self.config.n_layer)]

    def forward(self, tokens, return_hidden: bool = False):
        cfg = self.config
        t = tokens.shape[1]
        remat = cfg.remat and torch.is_grad_enabled()
        x = self.wte.to(cfg.dtype)[tokens] + self.wpe.to(cfg.dtype)[None, :t]
        aux = []
        for blk in self.blocks():
            x, a = checkpoint(blk, x, use_reentrant=False) if remat \
                else blk(x)
            aux.append(a)
        x = self.ln_f(x)
        if return_hidden:
            return x, self.wte, aux
        return torch.einsum("btd,vd->btv", x, self.wte.to(cfg.dtype)), aux


def total_aux_loss(aux: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of the layers' router losses (0 without any)."""
    aux = list(aux)
    if not aux:
        return torch.zeros(())
    return sum(torch.sum(a) for a in aux)


def init_params(cfg: MoEGPTConfig, generator: torch.Generator,
                device=None, dtype: Optional[torch.dtype] = None
                ) -> Dict[str, torch.Tensor]:
    """Fresh weights with the Flax model's init distributions (all
    normal(0.02) but `wpe` normal(0.01), biases zero, norm scales one);
    dtypes as `gpt.init_params`, the router in `cfg.param_dtype`."""
    device = resolve_device(device)
    d, e, dt = cfg.d_model, cfg.num_experts, dtype or cfg.dtype
    normal = partial(gpt._normal, generator=generator, device=device)
    p = {"wte": normal((cfg.vocab_size, d), 0.02, dtype=dt),
         "wpe": normal((cfg.max_seq_len, d), 0.01, dtype=dt)}
    for i in range(cfg.n_layer):
        for name, (fin, fout) in (("attn_qkv", (d, 3 * d)),
                                  ("attn_out", (d, d))):
            p[f"h{i}.{name}.weight"] = normal((fout, fin), 0.02, dtype=dt)
            p[f"h{i}.{name}.bias"] = torch.zeros(fout, dtype=dt,
                                                 device=device)
        p[f"h{i}.moe.router"] = normal((d, e), 0.02, dtype=cfg.param_dtype)
        p[f"h{i}.moe.experts_up"] = normal((e, d, 4 * d), 0.02, dtype=dt)
        p[f"h{i}.moe.experts_down"] = normal((e, 4 * d, d), 0.02, dtype=dt)
        for name in ("ln_1", "ln_2"):
            p.update(gpt._norm_params(f"h{i}.{name}", d, cfg.param_dtype,
                                      device))
    p.update(gpt._norm_params("ln_f", d, cfg.param_dtype, device))
    return p


def param_logical_axes(cfg: MoEGPTConfig) -> Dict[str, tuple]:
    """Each parameter's logical axes (`gpt.param_logical_axes`), the
    expert layer's as the Flax annotations give them (the JAX layouts are
    kept, so nothing is reversed)."""
    axes = {n: a for n, a in gpt.param_logical_axes(cfg).items()
            if ".mlp_" not in n}
    for i in range(cfg.n_layer):
        axes[f"h{i}.moe.router"] = ("embed", None)
        axes[f"h{i}.moe.experts_up"] = ("expert", "embed", "mlp")
        axes[f"h{i}.moe.experts_down"] = ("expert", "mlp", "embed")
    return axes


# -- sharded forward (a mesh) ----------------------------------------------


def _gather_experts(h, mesh):
    """[E_local, C, d] of each `ep` rank gathered into [E, C, d]. Every
    rank of the ep group holds the same tokens and loss, so only this
    rank's own slice carries gradient: each rank back-propagates into its
    own experts."""
    group = mesh.group("ep")
    if group is None:
        return h
    j, e_l = mesh.axis_index("ep"), h.shape[0]
    whole = collectives._all_gather(h.detach(), group, 0)
    return torch.cat([whole[:j * e_l], h, whole[(j + 1) * e_l:]])


def _row_offsets(onehot, spmd):
    """[B_l, E]: for each row of this rank's token block (onehot [B_l,
    T_l, E]), the tokens of each expert before the block's first token in
    the global (b, t) order: all tokens of the earlier global rows, and
    the earlier sp blocks of the same row."""
    mesh, (b, _, e) = spmd.mesh, onehot.shape
    nb, bi = mesh.axis_size(spmd.batch_axes), mesh.axis_index(
        spmd.batch_axes)
    table = torch.zeros(nb, spmd.sp, b, e, dtype=torch.int32,
                        device=onehot.device)
    table[bi, spmd.sp_rank] = onehot.sum(dim=1, dtype=torch.int32)
    table = collectives.allreduce(table, spmd.data_axes, mesh=mesh)
    rows = table.sum(dim=1).reshape(nb * b, e)
    before = torch.cumsum(rows, dim=0) - rows
    return before[bi * b:(bi + 1) * b] + table[bi, :spmd.sp_rank].sum(dim=0)


def _sharded_moe(moe: MoEMLP, spmd, prefix: str, x):
    """The expert layer on this rank's token block under the global
    routing of the JAX model (module docstring): (y, this rank's share of
    the layer's aux loss, whose sum over the data axes is the JAX
    value)."""
    cfg, dt, mesh = moe.config, moe.config.dtype, spmd.mesh
    b, t, d = x.shape
    data = spmd.data_axes
    e = cfg.num_experts
    tokens = b * t * mesh.axis_size(data)
    cap = capacity(cfg, tokens)
    flat = x.reshape(b * t, d)
    router = spmd.param(prefix + "router", moe.router, moe.router.dtype,
                        keep=())
    probs, gate, onehot = top1(flat, router, e)
    with torch.no_grad():
        offset = _row_offsets(onehot.reshape(b, t, e), spmd)
    dispatch, combine = slots(onehot, gate, cap, dt, offset)
    # this rank's experts (ep), each its columns of the hidden width (tp)
    up, down = (spmd.param(prefix + n, getattr(moe, n), dt,
                           keep=("ep", "tp"))
                for n in ("experts_up", "experts_down"))
    e_l, j = up.shape[0], mesh.axis_index("ep")
    # this rank's slots of its experts' buffers, summed over the data
    # ranks (each slot is one token's, so the sum is exact; its backward
    # is the identity: a rank's loss reads only its own tokens' slots);
    # the tokens' gradient through them is partial over ep and tp
    x_in = collectives.replicated_input(flat, ("ep", "tp"), mesh=mesh)
    buf = torch.einsum("td,tec->ecd", x_in, dispatch[:, j * e_l:(j + 1) * e_l])
    buf = collectives.allreduce(buf, data, mesh=mesh)
    # a Megatron pair per expert: the partial outputs summed over tp
    h = collectives.allreduce(_experts(buf, up, down), "tp", mesh=mesh)
    out = torch.einsum("ecd,tec->td", _gather_experts(h, mesh), combine)
    with torch.no_grad():
        density = collectives.allreduce(onehot.float().sum(dim=0), data,
                                        mesh=mesh) / tokens
    aux = torch.sum(density * probs.sum(dim=0) / tokens) * e
    return out.reshape(b, t, d), cfg.router_aux_coeff * aux


def _sharded_moe_block(blk: MoEBlock, spmd, prefix: str, x):
    x = gpt._sharded_attention(blk, spmd, prefix, x)
    y, aux = _sharded_moe(blk.moe, spmd, prefix + "moe.", blk.ln_2(x))
    return spmd.constrain(x + y, ("batch", "seq", "embed")), aux


def sharded_hidden(model: MoEGPT, tokens, mesh, shardings):
    """The sharded forward up to `ln_f` on this rank's token block
    (`gpt.sharded_hidden`'s layout): (hidden, this rank's wte rows, its
    `gpt._Spmd`, the layers' shares of their aux losses). The mesh may
    have data axes, `ep`, `tp` and `sp`."""
    cfg = model.config
    spmd = gpt._Spmd(mesh, shardings, cfg)
    if cfg.num_experts % mesh.axis_size("ep"):
        raise ValueError(f"MoEGPT: {cfg.num_experts} experts do not split "
                         f"over ep={mesh.axis_size('ep')}")
    x, wte = gpt.sharded_embed(model, spmd, tokens)
    x = spmd.constrain(x, ("batch", "seq", "embed"))
    remat = cfg.remat and torch.is_grad_enabled()
    aux = []
    for i, blk in enumerate(model.blocks()):
        fn = partial(_sharded_moe_block, blk, spmd, f"h{i}.")
        x, a = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
        aux.append(a)
    return model.ln_f(x), wte, spmd, aux


def sharded_loss(model: MoEGPT, tokens, targets, mesh, shardings,
                 ignore_index: int = -1):
    """This rank's share of the global loss (the mean token NLL plus the
    layers' router losses) under `mesh`, as `gpt.sharded_loss`:
    `gpt.global_loss` sums the shares over the data axes and
    `gpt.reduce_gradients` completes the gradients after `backward`."""
    hidden, wte, spmd, aux = sharded_hidden(model, tokens, mesh, shardings)
    loss = gpt.sharded_head_loss(hidden, wte, targets, spmd, ignore_index)
    return loss + total_aux_loss(aux)
