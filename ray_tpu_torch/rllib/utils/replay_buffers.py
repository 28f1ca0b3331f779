"""Replay buffers.

Reference: `rllib/utils/replay_buffers/` — `EpisodeReplayBuffer`
(`episode_replay_buffer.py:14`) and the prioritized variant
(`prioritized_episode_replay_buffer.py`). Stored as flat transition
arrays (columnar, numpy) — the TPU-friendly layout for batch sampling.

Port of `ray_tpu/rllib/utils/replay_buffers.py`, unchanged but for the
imports: the same numpy seed gives the same samples.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.core.rl_module import Columns
from ray_tpu_torch.rllib.env.env_runner import Episode


class ReplayBuffer:
    """Uniform FIFO transition buffer."""

    def __init__(self, capacity: int = 100_000, seed: Optional[int] = None):
        self.capacity = capacity
        self._cols: Dict[str, List] = {
            Columns.OBS: [], Columns.ACTIONS: [], Columns.REWARDS: [],
            Columns.NEXT_OBS: [], Columns.TERMINATEDS: [],
        }
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self._cols[Columns.ACTIONS])

    def add_episode(self, ep: Episode) -> None:
        obs = ep.obs + ([ep.last_obs] if ep.last_obs is not None
                        else [ep.obs[-1]])
        for t in range(ep.length):
            self._add_row(obs[t], ep.actions[t], ep.rewards[t],
                          obs[t + 1],
                          ep.terminated and t == ep.length - 1)

    def _add_row(self, o, a, r, o2, term) -> None:
        self._cols[Columns.OBS].append(np.asarray(o, np.float32))
        self._cols[Columns.ACTIONS].append(a)
        self._cols[Columns.REWARDS].append(np.float32(r))
        self._cols[Columns.NEXT_OBS].append(np.asarray(o2, np.float32))
        self._cols[Columns.TERMINATEDS].append(bool(term))
        if len(self) > self.capacity:
            for col in self._cols.values():
                col.pop(0)
        self._on_add()

    def _on_add(self) -> None:
        pass

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self.rng.integers(0, len(self), size=batch_size)
        return self._gather(idx)

    def _gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {
            Columns.OBS: np.stack(
                [self._cols[Columns.OBS][i] for i in idx]),
            Columns.ACTIONS: np.asarray(
                [self._cols[Columns.ACTIONS][i] for i in idx]),
            Columns.REWARDS: np.asarray(
                [self._cols[Columns.REWARDS][i] for i in idx],
                np.float32),
            Columns.NEXT_OBS: np.stack(
                [self._cols[Columns.NEXT_OBS][i] for i in idx]),
            Columns.TERMINATEDS: np.asarray(
                [self._cols[Columns.TERMINATEDS][i] for i in idx],
                np.float32),
            "_indices": idx,
        }


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (reference
    `prioritized_episode_replay_buffer.py`): P(i) ∝ p_i^α with
    importance-sampling weights w_i = (N·P(i))^-β."""

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6,
                 beta: float = 0.4, seed: Optional[int] = None):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self._priorities: List[float] = []
        self._max_priority = 1.0

    def _on_add(self) -> None:
        self._priorities.append(self._max_priority)
        while len(self._priorities) > len(self):
            self._priorities.pop(0)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        pri = np.asarray(self._priorities) ** self.alpha
        probs = pri / pri.sum()
        idx = self.rng.choice(len(self), size=batch_size, p=probs)
        batch = self._gather(idx)
        weights = (len(self) * probs[idx]) ** (-self.beta)
        batch["weights"] = (weights / weights.max()).astype(np.float32)
        return batch

    def update_priorities(self, indices: np.ndarray,
                          td_errors: np.ndarray) -> None:
        for i, td in zip(indices, td_errors):
            p = float(abs(td)) + 1e-6
            self._priorities[int(i)] = p
            self._max_priority = max(self._max_priority, p)
