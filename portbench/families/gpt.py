"""GPT-2 through the port: `ray_tpu_torch.models.gpt.GPT` with the flash
kernels, the fused CE and, for serving, `serve.llm.LLMEngine`."""

from __future__ import annotations

from functools import partial

from portbench import weights

DTYPES = ("float32", "bfloat16", "float16")
REFERENCE = "gpt"
CAUSAL = True


def _dtype(name: str):
    import torch

    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}")
    return getattr(torch, name)


def shape(cfg: dict) -> dict:
    """The sizes the FLOP counts use (`peaks`), the head over the
    published vocabulary."""
    return {"d_model": cfg["n_embd"], "n_layer": cfg["n_layer"],
            "n_head": cfg["n_head"], "d_ff": 4 * cfg["n_embd"],
            "vocab": cfg["published"]["vocab_size"]}


def port_config(cfg: dict):
    from ray_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(vocab_size=cfg["vocab_size"], n_layer=cfg["n_layer"],
                     n_head=cfg["n_head"], d_model=cfg["n_embd"],
                     max_seq_len=cfg["n_positions"], dropout=0.0,
                     dtype=_dtype(cfg["compute_dtype"]), remat=False)


def _init_of(name: str):
    if name == "wte":
        return "normal", 0.02
    if name == "wpe":
        return "normal", 0.01
    if name.endswith(".weight"):
        return "normal", 0.02
    return "const", 1.0 if name.endswith(".scale") else 0.0


def make_params(cfg: dict, seed: int, device, train: bool) -> dict:
    """Training: f32 master weights; serving: each leaf in the type it is
    served in (projections and embeddings in `compute_dtype`)."""
    import torch

    from ray_tpu_torch.models.gpt import GPT

    with torch.device("meta"):
        net = GPT(port_config(cfg))
    return weights.make(net, _init_of, seed, device,
                        torch.float32 if train else None)


def train_model(cfg: dict, params: dict):
    from ray_tpu_torch.models.gpt import GPT
    from ray_tpu_torch.ops.flash_attention import flash_attention

    return GPT.from_params(port_config(cfg), params,
                           attention_fn=partial(flash_attention, causal=True),
                           trainable=True)


def loss(model, batch):
    from ray_tpu_torch.ops import fused_ce

    hidden, wte = model(batch["x"], return_hidden=True)
    return fused_ce.fused_cross_entropy(hidden, wte, batch["y"])


def check_parts(name: str, t) -> dict:
    """The units the output check reads a parameter in: the fused QKV
    projection's weight and bias as their Q, K and V thirds, so that the
    key's bias, which has no gradient under softmax, is a unit of its own
    (the check leaves it out by its reference gradient)."""
    if ".attn_qkv." in name:
        return {f"{name}.{part}": x
                for part, x in zip("qkv", t.chunk(3, dim=0))}
    return {name: t}


def engine(cfg: dict, params: dict, settings: dict, device):
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    ecfg = EngineConfig(
        block_size=settings["block_size"],
        batch_buckets=tuple(settings["batch_buckets"]),
        prefill_buckets=tuple(settings["prefill_buckets"]),
        max_running=settings["max_running"],
        prefix_cache=int(settings["prefix_cache"]),
        prefill_chunk=settings["prefill_chunk"],
        spec_k=settings["spec_k"])
    return LLMEngine(model="gpt", model_cfg=port_config(cfg), params=params,
                     engine_config=ecfg, device=device)
