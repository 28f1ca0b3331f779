"""BERT-base through the port: `ray_tpu_torch.models.bert.BertEncoder`
(the decoder's `gpt.Block` with the non-causal flash kernels) and
`bert.mlm_loss` (the fused CE over the tied word embedding)."""

from __future__ import annotations

from functools import partial

from portbench import weights
from portbench.families.gpt import _dtype
from portbench.families.gpt import check_parts  # noqa: F401 (gpt.Block)

REFERENCE = "bert"
CAUSAL = False


def shape(cfg: dict) -> dict:
    return {"d_model": cfg["hidden_size"], "n_layer": cfg["num_hidden_layers"],
            "n_head": cfg["num_attention_heads"],
            "d_ff": cfg["intermediate_size"],
            "vocab": cfg["published"]["vocab_size"]}


def port_config(cfg: dict):
    from ray_tpu_torch.models.bert import BertConfig

    if cfg["intermediate_size"] != 4 * cfg["hidden_size"]:
        raise ValueError("the port's block has d_ff = 4 * d_model")
    return BertConfig(vocab_size=cfg["vocab_size"],
                      n_layer=cfg["num_hidden_layers"],
                      n_head=cfg["num_attention_heads"],
                      d_model=cfg["hidden_size"],
                      max_seq_len=cfg["max_position_embeddings"],
                      type_vocab_size=cfg["type_vocab_size"], dropout=0.0,
                      dtype=_dtype(cfg["compute_dtype"]), remat=False)


def _init_of(name: str):
    if name == "wte":
        return "normal", 0.02
    if name in ("wpe", "wtt"):
        return "normal", 0.01
    if name.endswith(".weight"):
        return "normal", 0.02
    return "const", 1.0 if name.endswith(".scale") else 0.0


def make_params(cfg: dict, seed: int, device, train: bool) -> dict:
    import torch

    from ray_tpu_torch.models.bert import BertEncoder

    with torch.device("meta"):
        net = BertEncoder(port_config(cfg))
    return weights.make(net, _init_of, seed, device,
                        torch.float32 if train else None)


def train_model(cfg: dict, params: dict):
    from ray_tpu_torch.models.bert import BertEncoder
    from ray_tpu_torch.ops.flash_attention import flash_attention

    return BertEncoder.from_params(
        port_config(cfg), params,
        attention_fn=partial(flash_attention, causal=False), trainable=True)


def loss(model, batch):
    from ray_tpu_torch.models import bert

    return bert.mlm_loss(model, batch["x"], batch["y"], batch["t"])
