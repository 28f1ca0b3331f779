"""Trial state (reference: `python/ray/tune/experiment/trial.py:247`).

Port of `ray_tpu/tune/experiment.py`, unchanged.
"""

from __future__ import annotations

import dataclasses
import uuid
from typing import Any, Dict, List, Optional

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


@dataclasses.dataclass
class Trial:
    config: Dict[str, Any]
    trial_id: str = dataclasses.field(
        default_factory=lambda: uuid.uuid4().hex[:8])
    status: str = PENDING
    resources: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"CPU": 1.0})
    last_result: Optional[Dict[str, Any]] = None
    metrics_history: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    error: Optional[str] = None
    num_failures: int = 0
    checkpoint_path: Optional[str] = None
    trial_dir: str = ""

    @property
    def is_finished(self) -> bool:
        return self.status in (TERMINATED, ERROR)
