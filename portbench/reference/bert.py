"""BERT-base as the port runs it, in plain float32 PyTorch: token,
position and segment embeddings, the pre-LN blocks of `reference.gpt`
without a mask (the configuration's LayerNorm eps, GELU tanh), a final
LayerNorm, and the MLM loss of the head tied to the token embedding,
evaluated at the masked positions only (targets other than -1)."""

from __future__ import annotations

import torch

from portbench.reference import gpt
from portbench.reference.precision import matmul


def _gpt_view(cfg: dict) -> dict:
    return {"n_layer": cfg["num_hidden_layers"],
            "n_head": cfg["num_attention_heads"],
            "layer_norm_epsilon": cfg["layer_norm_eps"]}


def hidden(p, tokens, types, cfg, mm=matmul):
    t = tokens.shape[1]
    x = p["wte"][tokens] + p["wpe"][:t][None] + p["wtt"][types]
    return gpt.encode(p, x, _gpt_view(cfg), False, mm)


def nll_sum(p, batch, cfg, mm=matmul):
    h = hidden(p, batch["x"], batch["t"], cfg, mm)
    sel = batch["y"] != -1
    rows, y = h[sel], batch["y"][sel]
    lg = mm(rows, p["wte"].transpose(0, 1))
    nll = torch.logsumexp(lg, -1) - lg.gather(-1, y[:, None])[:, 0]
    return nll.sum(), int(sel.sum())
