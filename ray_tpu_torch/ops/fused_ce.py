"""Fused LM-head cross-entropy with a hand-written backward.

Port of `ray_tpu/ops/fused_ce.py`: the mean token NLL of
`hidden @ wte^T` as a `torch.autograd.Function` with the JAX package's
arithmetic. The forward computes the logits in the working dtype (bf16
in training), the row max and logsumexp in f32, and keeps the logits as
the residual; the backward builds `dlogits = exp(s - lse) * coef` in the
working dtype and takes the `-onehot(y) * coef` term without touching
[B, T, V]: a row gather of wte for dh and an `index_add` over the targets
for dw.

This is no Pallas kernel (XLA computed it), so it is plain PyTorch
operators and `torch.matmul`. Two differences from XLA, both in the
working memory and not in the values: eager PyTorch materialises the f32
[B, T, V] temporaries that XLA fused into its reductions (3.3 GB each at
B=16, T=1024, V=50304), and `index_add_` on CUDA sums with atomics, so
dw's `-onehot` term is added in a varying order (in the working dtype,
as the JAX scatter-add is).

Under tensor parallelism `wte`'s vocab axis is split over `tp` (the JAX
rules), and so are the logits: `vocab_group` makes it a vocab-parallel
loss over this rank's rows of wte (those from `vocab_start`). The row max
and the sum of exponentials are all-reduced over the group (max, then
sum), and so is the target logit (the rank holding the target's row
gives it); the backward is this rank's slice of the same
`dlogits`, so no [B, T, V] tensor is ever gathered (a gather of the
full logits would be 1.65 GB in bf16 at B=16 T=1024 V=50304). The
caller marks `hidden` as the tp-replicated input of the head
(`collectives.replicated_input`), whose backward sums dh over the
group. `count_group` all-reduces the count of counted tokens, so that
with the batch split over data ranks each rank's loss is its share of
the global mean.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


class _FusedCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, wte, targets, ignore_index, vocab_group,
                vocab_start, count_group):
        dtype = hidden.dtype
        logits = torch.einsum("btd,vd->btv", hidden, wte.to(dtype))
        mask = targets != ignore_index
        y = torch.clamp(targets, min=0).long()
        s32 = logits.float()
        m = _all_reduce(torch.amax(s32, dim=-1), vocab_group,
                        dist.ReduceOp.MAX)
        lse = m + torch.log(_all_reduce(
            torch.sum(torch.exp(s32 - m[..., None]), dim=-1), vocab_group))
        if vocab_group is None:
            tgt = torch.gather(s32, -1, y[..., None])[..., 0]
            hit = None
        else:
            # this rank's rows of wte: the target logit where it holds the
            # target's row, 0 elsewhere, summed over the group
            y = y - vocab_start
            hit = (y >= 0) & (y < wte.shape[0])
            y = torch.clamp(y, 0, wte.shape[0] - 1)
            tgt = _all_reduce(torch.where(
                hit, torch.gather(s32, -1, y[..., None])[..., 0], 0.0),
                vocab_group)
        del s32
        count = torch.clamp(_all_reduce(mask.sum().float(), count_group),
                            min=1.0)
        loss = torch.where(mask, lse - tgt, 0.0).sum() / count
        ctx.save_for_backward(hidden, wte, logits, lse, y, mask, count, hit)
        return loss

    @staticmethod
    def backward(ctx, g):
        hidden, wte, logits, lse, y, mask, count, hit = ctx.saved_tensors
        dtype = hidden.dtype
        w = wte.to(dtype)
        coef = (g / count) * mask.float()                         # [B, T]
        # the softmax term, in the working dtype straight from the saved
        # logits: the only [B, T, V] tensor the gradients are built from
        p = torch.exp(logits.float() - lse[..., None])
        dlogits = (p * coef[..., None]).to(dtype)                 # [B, T, V]
        del p
        dh = torch.einsum("btv,vd->btd", dlogits, w)
        dw = torch.einsum("btv,btd->vd", dlogits, hidden)
        # -onehot(y) * coef: a row gather of wte for dh, a scatter-add over
        # the targets for dw
        wcoef = coef.to(dtype)[..., None]
        if hit is not None:  # only the targets whose rows this rank holds
            wcoef = wcoef * hit[..., None].to(dtype)
        dh = dh - wcoef * w[y]
        dw = dw.index_add(0, y.reshape(-1),
                          -(wcoef * hidden).reshape(-1, hidden.shape[-1]))
        return (dh.to(hidden.dtype), dw.to(wte.dtype), None, None, None,
                None, None)


def fused_cross_entropy(hidden, wte, targets, ignore_index: int = -1, *,
                        vocab_group=None, vocab_start: int = 0,
                        count_group=None):
    """Mean token NLL of `hidden @ wte^T` against `targets`.

    hidden: [B, T, D] (bf16 or f32); wte: [V, D]; targets: [B, T] int,
    entries equal to `ignore_index` are excluded from the mean (the
    contract of `models.gpt.cross_entropy_loss`). `vocab_group`,
    `vocab_start` and `count_group` (process groups, or None for one
    rank) make it the vocab-parallel, data-parallel loss of the module
    docstring: wte holds rows [vocab_start, vocab_start + V) of the vocab.
    """
    return _FusedCrossEntropy.apply(hidden, wte, targets, ignore_index,
                                    vocab_group, vocab_start, count_group)
