"""ray_tpu_torch.air — the Train/Tune plumbing the port needs so far:
`Checkpoint` (a directory). The run configs and results
(`ray_tpu/air/{config,result}.py`) come with the distributed train plane
(ROADMAP S4d)."""

from ray_tpu_torch.air.checkpoint import Checkpoint

__all__ = ["Checkpoint"]
