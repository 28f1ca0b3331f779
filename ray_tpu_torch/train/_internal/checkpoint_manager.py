"""Keep-top-K checkpoint bookkeeping.

Port of `ray_tpu/train/_internal/checkpoint_manager.py`, unchanged but
for the imports.

Reference: `python/ray/train/_internal/checkpoint_manager.py` — registers
each reported checkpoint with its metrics, ranks by the configured score
attribute, deletes evicted directories.
"""

from __future__ import annotations

import shutil
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import CheckpointConfig


class IncompleteCheckpointError(RuntimeError):
    """A checkpoint offered for registration is missing shard
    contributions — registering it would make an unusable checkpoint a
    resume candidate."""


class _TrackedCheckpoint:
    def __init__(self, checkpoint: Checkpoint, metrics: Dict[str, Any],
                 index: int):
        self.checkpoint = checkpoint
        self.metrics = metrics
        self.index = index


class CheckpointManager:
    def __init__(self, config: Optional[CheckpointConfig] = None):
        self.config = config or CheckpointConfig()
        self._checkpoints: List[_TrackedCheckpoint] = []
        self._index = 0

    def register_checkpoint(self, checkpoint: Checkpoint,
                            metrics: Dict[str, Any],
                            require_usable: bool = False) -> None:
        if require_usable:
            # Gang-durable commit gate: a sharded checkpoint is only
            # committed when every process's contribution is present and
            # readable. In the barrier protocol this should always hold
            # (each rank persists before reporting), so tripping here
            # means a shard went missing between persist and commit —
            # fail the step rather than ack a checkpoint that cannot be
            # restored.
            from ray_tpu_torch.train import array_checkpoint

            if not array_checkpoint.is_usable(checkpoint):
                raise IncompleteCheckpointError(
                    f"checkpoint {checkpoint.path!r} is missing shard "
                    f"contributions; refusing to register it as a resume "
                    f"candidate")
        self._checkpoints.append(
            _TrackedCheckpoint(checkpoint, dict(metrics), self._index))
        self._index += 1
        k = self.config.num_to_keep
        if k is None or len(self._checkpoints) <= k:
            return
        attr = self.config.checkpoint_score_attribute
        if attr is None:
            evict = self._checkpoints.pop(0)  # FIFO
        else:
            sign = 1 if self.config.checkpoint_score_order == "max" else -1
            worst = min(
                self._checkpoints[:-1],  # never evict the newest
                key=lambda t: sign * float(t.metrics.get(attr, float("-inf"))
                                           if sign > 0 else
                                           t.metrics.get(attr, float("inf"))),
            )
            self._checkpoints.remove(worst)
            evict = worst
        shutil.rmtree(evict.checkpoint.path, ignore_errors=True)
        # non-rank-0 shards live in a sibling dir (session._persist_checkpoint)
        shutil.rmtree(evict.checkpoint.path + "_shards", ignore_errors=True)

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        return self._checkpoints[-1].checkpoint if self._checkpoints else None

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        attr = self.config.checkpoint_score_attribute
        if not self._checkpoints:
            return None
        if attr is None:
            return self.latest_checkpoint
        sign = 1 if self.config.checkpoint_score_order == "max" else -1
        best = max(self._checkpoints,
                   key=lambda t: sign * float(
                       t.metrics.get(attr, float("-inf") if sign > 0
                                     else float("inf"))))
        return best.checkpoint

    def best_checkpoints(self) -> List[Tuple[Checkpoint, Dict[str, Any]]]:
        return [(t.checkpoint, t.metrics) for t in self._checkpoints]
