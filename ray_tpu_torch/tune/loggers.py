"""Per-trial result loggers (reference: `python/ray/tune/logger/` —
CSV/JSON; TensorBoard omitted until a tbx dep is available).

Port of `ray_tpu/tune/loggers.py`, unchanged.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Dict, Optional


class LoggerCallback:
    def on_trial_start(self, trial) -> None:
        pass

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(self, trial) -> None:
        pass


class JsonLoggerCallback(LoggerCallback):
    """Appends one JSON line per result to `result.json` in the trial dir
    (reference `logger/json.py`)."""

    def on_trial_result(self, trial, result):
        if not trial.trial_dir:
            return
        os.makedirs(trial.trial_dir, exist_ok=True)
        path = os.path.join(trial.trial_dir, "result.json")
        safe = {k: v for k, v in result.items()
                if isinstance(v, (int, float, str, bool, type(None)))}
        safe["_timestamp"] = time.time()
        safe["trial_id"] = trial.trial_id
        with open(path, "a") as f:
            f.write(json.dumps(safe) + "\n")


class CSVLoggerCallback(LoggerCallback):
    """`progress.csv` per trial (reference `logger/csv.py`)."""

    def __init__(self):
        self._writers: Dict[str, Any] = {}
        self._files: Dict[str, Any] = {}
        self._fields: Dict[str, list] = {}

    def on_trial_result(self, trial, result):
        if not trial.trial_dir:
            return
        os.makedirs(trial.trial_dir, exist_ok=True)
        tid = trial.trial_id
        flat = {k: v for k, v in result.items()
                if isinstance(v, (int, float, str, bool))}
        if tid not in self._writers:
            path = os.path.join(trial.trial_dir, "progress.csv")
            f = open(path, "w", newline="")
            fields = sorted(flat)
            w = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
            w.writeheader()
            self._files[tid], self._writers[tid] = f, w
            self._fields[tid] = fields
        self._writers[tid].writerow(flat)
        self._files[tid].flush()

    def on_trial_complete(self, trial):
        tid = trial.trial_id
        f = self._files.pop(tid, None)
        self._writers.pop(tid, None)
        if f:
            f.close()


DEFAULT_LOGGERS = (JsonLoggerCallback, CSVLoggerCallback)
