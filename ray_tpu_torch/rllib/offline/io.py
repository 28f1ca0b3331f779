"""Offline episode IO: JSONL shards of recorded episodes.

Reference: `rllib/offline/json_writer.py` / `json_reader.py` — the
reference serializes SampleBatches to sharded JSON files and reads them
back (with glob expansion) for offline training. Same shape here over
the rebuilt `Episode` fragments: one JSON object per episode per line,
sharded by row count, numpy obs stored as nested lists.

Port of `ray_tpu/rllib/offline/io.py`, unchanged but for the imports:
the two packages read each other's shards.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Iterator, List, Optional

import numpy as np

from ray_tpu_torch.rllib.env.env_runner import Episode


def episode_to_json(ep: Episode) -> dict:
    return {
        "obs": np.stack(ep.obs).tolist() if ep.obs else [],
        "actions": [int(a) if np.ndim(a) == 0
                    else np.asarray(a, np.float32).tolist()
                    for a in ep.actions],
        "rewards": list(map(float, ep.rewards)),
        "logps": list(map(float, ep.logps)),
        "vf_preds": list(map(float, ep.vf_preds)),
        "terminated": bool(ep.terminated),
        "truncated": bool(ep.truncated),
        "last_obs": (ep.last_obs.tolist()
                     if ep.last_obs is not None else None),
    }


def episode_from_json(d: dict) -> Episode:
    ep = Episode()
    ep.obs = [np.asarray(o, np.float32) for o in d["obs"]]
    ep.actions = [a if not isinstance(a, list)
                  else np.asarray(a, np.float32)
                  for a in d["actions"]]
    ep.rewards = list(d["rewards"])
    ep.logps = list(d.get("logps", [0.0] * len(d["actions"])))
    ep.vf_preds = list(d.get("vf_preds", [0.0] * len(d["actions"])))
    ep.terminated = bool(d.get("terminated", False))
    ep.truncated = bool(d.get("truncated", False))
    last = d.get("last_obs")
    ep.last_obs = np.asarray(last, np.float32) if last is not None else None
    return ep


class JsonWriter:
    """Append episodes to JSONL shard files under a directory.

    Shards roll over at ``max_rows_per_shard`` env steps, mirroring the
    reference writer's `max_file_size` rollover (`json_writer.py`).
    """

    def __init__(self, path: str, max_rows_per_shard: int = 50_000):
        self.path = path
        self.max_rows = max_rows_per_shard
        os.makedirs(path, exist_ok=True)
        self._shard = 0
        self._rows_in_shard = 0
        # continue after existing shards rather than clobbering them
        existing = sorted(glob.glob(os.path.join(path, "output-*.jsonl")))
        if existing:
            last = os.path.basename(existing[-1])
            self._shard = int(last.split("-")[1].split(".")[0]) + 1

    def _shard_path(self) -> str:
        return os.path.join(self.path, f"output-{self._shard:05d}.jsonl")

    def write(self, episodes: List[Episode]) -> None:
        if not episodes:
            return
        f = open(self._shard_path(), "a")
        try:
            for ep in episodes:
                if ep.length == 0:
                    continue
                f.write(json.dumps(episode_to_json(ep)) + "\n")
                self._rows_in_shard += ep.length
                if self._rows_in_shard >= self.max_rows:
                    f.close()
                    self._shard += 1
                    self._rows_in_shard = 0
                    f = open(self._shard_path(), "a")
        finally:
            if not f.closed:
                f.close()


class JsonReader:
    """Read episodes back from a directory (or glob) of JSONL shards.

    Reference: `rllib/offline/json_reader.py` — supports sampling random
    episodes for minibatch training and full iteration for estimators.
    """

    def __init__(self, path: str, seed: int = 0):
        if os.path.isdir(path):
            pattern = os.path.join(path, "*.jsonl")
        else:
            pattern = path
        self.files = sorted(glob.glob(pattern))
        if not self.files:
            raise FileNotFoundError(f"no offline shards match {pattern}")
        self._episodes: Optional[List[Episode]] = None
        self._rng = np.random.default_rng(seed)

    def _load(self) -> List[Episode]:
        if self._episodes is None:
            self._episodes = []
            for fn in self.files:
                with open(fn) as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            self._episodes.append(
                                episode_from_json(json.loads(line)))
        return self._episodes

    @property
    def num_episodes(self) -> int:
        return len(self._load())

    @property
    def num_steps(self) -> int:
        return sum(ep.length for ep in self._load())

    def iter_episodes(self) -> Iterator[Episode]:
        return iter(self._load())

    def sample_episodes(self, num_steps: int) -> List[Episode]:
        """Random episodes totaling >= num_steps env steps."""
        eps = self._load()
        out: List[Episode] = []
        steps = 0
        while steps < num_steps:
            ep = eps[int(self._rng.integers(len(eps)))]
            out.append(ep)
            steps += ep.length
        return out
