"""ray_tpu_torch.parallel — attention references (the sharded variants
come with the port of the JAX package's `parallel/`)."""

from ray_tpu_torch.parallel.ring_attention import (  # noqa: F401
    NEG_INF, expand_kv_heads, full_attention)

__all__ = ["NEG_INF", "expand_kv_heads", "full_attention"]
