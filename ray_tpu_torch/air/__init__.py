"""Shared Train/Tune plumbing: run configs, checkpoints, results.

Port of `ray_tpu/air/__init__.py`, with the same public names. Nothing
here imports torch: Tune's trial actors and the train controller use
these without it.
"""

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air.result import Result

__all__ = [
    "Checkpoint",
    "CheckpointConfig",
    "FailureConfig",
    "Result",
    "RunConfig",
    "ScalingConfig",
]
