"""ray_tpu_torch.ops — hand-written CUDA kernels for Hopper, each with
its plain PyTorch version beside it (the CPU path and the yardstick the
kernel is checked against on the card), and the fused LM-head loss.
Kernel sources live in `csrc/` and are built at first use by `_build`."""

from ray_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_plain)
from ray_tpu_torch.ops.fused_ce import fused_cross_entropy  # noqa: F401

# every kernel wrapper's launch counter (`.launches`): the compiled-step
# cache credits each graph replay with the launches its capture counted
LAUNCH_COUNTERS = (flash_attention, flash_attention_bwd)

__all__ = ["LAUNCH_COUNTERS", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_plain",
           "fused_cross_entropy"]
