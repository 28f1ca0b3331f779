"""Model zoo of the port: GPT-2 decoders (`gpt`), Llama-style decoders
with RoPE/SwiGLU/GQA (`llama`), MoE decoders (`moe_gpt`), BERT encoders
(`bert`), Vision Transformers (`vit`) and ResNet convnets (`resnet`),
with `convert` to carry weights across from the JAX models."""

from ray_tpu_torch.models.bert import (BertConfig, BertEncoder,
                                       mask_tokens, mlm_loss)
from ray_tpu_torch.models.gpt import GPT, GPTConfig
from ray_tpu_torch.models.llama import Llama, LlamaConfig
from ray_tpu_torch.models.moe_gpt import MoEGPT, MoEGPTConfig
from ray_tpu_torch.models.resnet import ResNet, ResNetConfig
from ray_tpu_torch.models.vit import ViT, ViTConfig

__all__ = [
    "BertConfig", "BertEncoder", "mask_tokens", "mlm_loss",
    "GPT", "GPTConfig", "Llama", "LlamaConfig", "MoEGPT", "MoEGPTConfig",
    "ResNet", "ResNetConfig", "ViT", "ViTConfig",
]
