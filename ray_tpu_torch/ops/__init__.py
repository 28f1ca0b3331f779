"""ray_tpu_torch.ops — hand-written CUDA kernels for Hopper, each with
its plain PyTorch version beside it (the CPU path and the yardstick the
kernel is checked against on the card). Sources live in `csrc/` and are
built at first use by `_build`."""

from ray_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_attention, flash_attention_plain)

__all__ = ["flash_attention", "flash_attention_plain"]
