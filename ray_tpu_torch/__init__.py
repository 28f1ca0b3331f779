"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's compute path.

The package mirrors `ray_tpu`'s layout (`ops`, `parallel`, `models`,
`serve.llm`) with the same module and function names, so each piece has
an obvious counterpart in the JAX package, which stays the reference the
port is tested against. It imports `torch` and `numpy` only — never
`jax`, `flax` or anything of `ray_tpu`.

Every entry point takes `device=` and defaults to ``"cuda"``. Only the
caller may ask for the CPU (``device="cpu"``, as the tests do); without
a GPU and without that request an entry point raises instead of quietly
running on the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another. Raises when CUDA is asked for (explicitly or by
    default) and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the host explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"ray_tpu_torch: unsupported device {dev}")
    return dev


__all__ = ["resolve_device"]
