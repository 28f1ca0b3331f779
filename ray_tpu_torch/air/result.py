"""Result of a training run / trial.

Port of `ray_tpu/air/result.py` (reference: `python/ray/air/result.py`):
metrics + checkpoint + error + per-trial path, plus the metrics history.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint


@dataclasses.dataclass
class Result:
    metrics: Optional[Dict[str, Any]] = None
    checkpoint: Optional[Checkpoint] = None
    error: Optional[Exception] = None
    path: Optional[str] = None
    metrics_history: Optional[List[Dict[str, Any]]] = None
    best_checkpoints: Optional[List[tuple]] = None

    @property
    def config(self) -> Optional[Dict[str, Any]]:
        if self.metrics is None:
            return None
        return self.metrics.get("config")

    def __repr__(self) -> str:
        keys = sorted(self.metrics.keys()) if self.metrics else []
        return (f"Result(metrics_keys={keys}, checkpoint={self.checkpoint}, "
                f"error={type(self.error).__name__ if self.error else None})")
