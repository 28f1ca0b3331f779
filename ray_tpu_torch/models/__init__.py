"""Model zoo of the port: GPT-2 decoders (`gpt`) and Llama-style decoders
with RoPE/SwiGLU/GQA (`llama`), with `convert` to carry weights across
from the JAX models. The other families come with later slices."""

from ray_tpu_torch.models.gpt import GPT, GPTConfig
from ray_tpu_torch.models.llama import Llama, LlamaConfig

__all__ = ["GPT", "GPTConfig", "Llama", "LlamaConfig"]
