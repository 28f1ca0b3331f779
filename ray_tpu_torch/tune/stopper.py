"""Stoppers (reference: `python/ray/tune/stopper/`).

Port of `ray_tpu/tune/stopper.py`, unchanged.
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Any, Dict


class Stopper:
    def __call__(self, trial_id: str, result: Dict[str, Any]) -> bool:
        return False

    def stop_all(self) -> bool:
        return False


class MaximumIterationStopper(Stopper):
    def __init__(self, max_iter: int):
        self.max_iter = max_iter

    def __call__(self, trial_id, result):
        return result.get("training_iteration", 0) >= self.max_iter


class TrialPlateauStopper(Stopper):
    """Stop when the metric's std over the last `num_results` reports falls
    below `std` (reference `stopper/trial_plateau.py`)."""

    def __init__(self, metric: str, std: float = 0.01,
                 num_results: int = 4, grace_period: int = 4):
        self.metric = metric
        self.std = std
        self.num_results = num_results
        self.grace_period = grace_period
        self._window = defaultdict(lambda: deque(maxlen=num_results))
        self._count = defaultdict(int)

    def __call__(self, trial_id, result):
        if self.metric not in result:
            return False
        self._count[trial_id] += 1
        w = self._window[trial_id]
        w.append(float(result[self.metric]))
        if self._count[trial_id] < self.grace_period or \
                len(w) < self.num_results:
            return False
        mean = sum(w) / len(w)
        var = sum((x - mean) ** 2 for x in w) / len(w)
        return var ** 0.5 <= self.std


class CombinedStopper(Stopper):
    def __init__(self, *stoppers: Stopper):
        self.stoppers = stoppers

    def __call__(self, trial_id, result):
        return any(s(trial_id, result) for s in self.stoppers)

    def stop_all(self):
        return any(s.stop_all() for s in self.stoppers)


class FunctionStopper(Stopper):
    def __init__(self, fn):
        self.fn = fn

    def __call__(self, trial_id, result):
        return bool(self.fn(trial_id, result))


def resolve_stop_criteria(stop) -> Stopper:
    """dict / callable / Stopper → Stopper (reference `tune.py` handling
    of the `stop` arg)."""
    if stop is None:
        return Stopper()
    if isinstance(stop, Stopper):
        return stop
    if isinstance(stop, dict):
        crit = dict(stop)

        class _DictStopper(Stopper):
            def __call__(self, trial_id, result):
                return any(k in result and result[k] >= v
                           for k, v in crit.items())

        return _DictStopper()
    if callable(stop):
        return FunctionStopper(stop)
    raise TypeError(f"invalid stop criteria: {stop!r}")
