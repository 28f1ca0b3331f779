"""GPT-2 as the port runs it, in plain float32 PyTorch: learned
positions, pre-LN blocks (LayerNorm with the configuration's eps, fused
QKV projection with biases, softmax attention with a causal mask, GELU
(tanh) MLP of width 4d), a final LayerNorm and the head tied to the
token embedding.

Parameters are a dict of float32 tensors named as the benchmark made
them (`wte`, `wpe`, `h{i}.attn_qkv.weight` [3d, d], ..., `ln_f.scale`);
a weight is [out, in]. `mm` is the matrix product (`precision`).
"""

from __future__ import annotations

import math

import torch

from portbench.reference.precision import matmul


def layer_norm(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def linear(x, w, b, mm):
    return mm(x, w.transpose(0, 1)) + b


def attention(q, k, v, causal: bool, mm):
    """q, k, v: [B, T, H, D] -> [B, T, H, D]."""
    t, d = q.shape[1], q.shape[-1]
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))   # [B, H, T, D]
    s = mm(qh, kh.transpose(-1, -2)) / math.sqrt(d)
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return mm(p, vh).transpose(1, 2)


def block(x, p, i, n_head, eps, causal, mm):
    pre = f"h{i}."
    b, t, d = x.shape
    h = layer_norm(x, p[pre + "ln_1.scale"], p[pre + "ln_1.bias"], eps)
    qkv = linear(h, p[pre + "attn_qkv.weight"], p[pre + "attn_qkv.bias"], mm)
    q, k, v = (z.reshape(b, t, n_head, d // n_head)
               for z in qkv.split(d, dim=-1))
    att = attention(q, k, v, causal, mm).reshape(b, t, d)
    x = x + linear(att, p[pre + "attn_out.weight"], p[pre + "attn_out.bias"],
                   mm)
    h = layer_norm(x, p[pre + "ln_2.scale"], p[pre + "ln_2.bias"], eps)
    h = gelu_tanh(linear(h, p[pre + "mlp_up.weight"], p[pre + "mlp_up.bias"],
                         mm))
    return x + linear(h, p[pre + "mlp_down.weight"],
                      p[pre + "mlp_down.bias"], mm)


def encode(p, x, cfg, causal, mm):
    """The blocks and the final LayerNorm over embeddings x [B, T, d]."""
    eps = cfg["layer_norm_epsilon"]
    for i in range(cfg["n_layer"]):
        x = block(x, p, i, cfg["n_head"], eps, causal, mm)
    return layer_norm(x, p["ln_f.scale"], p["ln_f.bias"], eps)


def hidden(p, tokens, cfg, mm=matmul):
    t = tokens.shape[1]
    x = p["wte"][tokens] + p["wpe"][:t][None]
    return encode(p, x, cfg, True, mm)


def logits(p, tokens, cfg, mm=matmul):
    """[B, T, V] next-token logits of token rows [B, T]."""
    return mm(hidden(p, tokens, cfg, mm), p["wte"].transpose(0, 1))


def nll_sum(p, batch, cfg, mm=matmul):
    """(sum of the token NLLs, their count) of a causal-LM batch."""
    lg = logits(p, batch["x"], cfg, mm)
    y = batch["y"]
    nll = torch.logsumexp(lg, -1) - lg.gather(-1, y[..., None])[..., 0]
    return nll.sum(), y.numel()
