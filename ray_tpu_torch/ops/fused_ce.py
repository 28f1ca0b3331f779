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
"""

from __future__ import annotations

import torch


class _FusedCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, wte, targets, ignore_index):
        dtype = hidden.dtype
        logits = torch.einsum("btd,vd->btv", hidden, wte.to(dtype))
        mask = targets != ignore_index
        y = torch.clamp(targets, min=0).long()
        s32 = logits.float()
        m = torch.amax(s32, dim=-1)
        lse = m + torch.log(torch.sum(torch.exp(s32 - m[..., None]), dim=-1))
        tgt = torch.gather(s32, -1, y[..., None])[..., 0]
        del s32
        count = torch.clamp(mask.sum(), min=1).float()
        loss = torch.where(mask, lse - tgt, 0.0).sum() / count
        ctx.save_for_backward(hidden, wte, logits, lse, y, mask, count)
        return loss

    @staticmethod
    def backward(ctx, g):
        hidden, wte, logits, lse, y, mask, count = ctx.saved_tensors
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
        dh = dh - wcoef * w[y]
        dw = dw.index_add(0, y.reshape(-1),
                          -(wcoef * hidden).reshape(-1, hidden.shape[-1]))
        return dh.to(hidden.dtype), dw.to(wte.dtype), None, None


def fused_cross_entropy(hidden, wte, targets, ignore_index: int = -1):
    """Mean token NLL of `hidden @ wte^T` against `targets`.

    hidden: [B, T, D] (bf16 or f32); wte: [V, D]; targets: [B, T] int,
    entries equal to `ignore_index` are excluded from the mean (the
    contract of `models.gpt.cross_entropy_loss`).
    """
    return _FusedCrossEntropy.apply(hidden, wte, targets, ignore_index)
