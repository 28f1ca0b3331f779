"""DQN — double-DQN with (prioritized) replay on the new stack.

Reference: `rllib/algorithms/dqn/dqn.py` `training_step`: sample with
epsilon-greedy exploration into a replay buffer; once `learning_starts`
transitions are stored, run `num_updates_per_iteration` sampled-batch
updates (priorities refreshed from TD errors), syncing weights to the
env runners each iteration.

Port of `ray_tpu/rllib/algorithms/dqn.py`, unchanged but for the
imports.
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import DQNLearner
from ray_tpu_torch.rllib.core.rl_module import QModule
from ray_tpu_torch.rllib.utils.replay_buffers import (
    PrioritizedReplayBuffer,
    ReplayBuffer,
)


class DQNConfig(AlgorithmConfig):
    def __init__(self, algo_class: type = None):
        super().__init__(algo_class or DQN)
        self.module_class = QModule
        self.lr = 1e-3
        self.train_batch_size = 64
        self.rollout_fragment_length = 100
        self.extra.update({
            "target_update_freq": 200,
            "learning_starts": 500,
            "num_updates_per_iteration": 16,
            "replay_capacity": 50_000,
            "prioritized_replay": False,
            "epsilon_initial": 1.0,
            "epsilon_final": 0.05,
            "epsilon_decay_iterations": 30,
        })


class DQN(Algorithm):
    learner_cls = DQNLearner
    config_cls = DQNConfig

    def setup(self, config: Dict[str, Any]) -> None:
        super().setup(config)
        x = self.algo_config.extra
        if x.get("prioritized_replay"):
            self.replay = PrioritizedReplayBuffer(
                capacity=x["replay_capacity"],
                seed=self.algo_config.seed)
        else:
            self.replay = ReplayBuffer(capacity=x["replay_capacity"],
                                       seed=self.algo_config.seed)

    def _epsilon(self) -> float:
        x = self.algo_config.extra
        frac = min(1.0, self._iteration /
                   max(1, x["epsilon_decay_iterations"]))
        return x["epsilon_initial"] + frac * (x["epsilon_final"] -
                                              x["epsilon_initial"])

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        x = cfg.extra
        eps = self._epsilon()
        # runner-side exploration: epsilon flows through forward_exploration
        self.env_runner_group.set_explore_config({"epsilon": eps})
        episodes = self.env_runner_group.sample(
            cfg.rollout_fragment_length)
        self.record_episodes(episodes)
        for ep in episodes:
            if ep.length:
                self.replay.add_episode(ep)
        stats: Dict[str, float] = {}
        num_updates = 0
        if len(self.replay) >= x["learning_starts"]:
            for _ in range(x["num_updates_per_iteration"]):
                batch = self.replay.sample(cfg.train_batch_size)
                idx = batch.pop("_indices")
                s = self.learner_group.update_from_batch(batch)
                if x.get("prioritized_replay"):
                    batch["_indices"] = idx
                    td = self.learner_group.td_errors(
                        {k: v for k, v in batch.items()
                         if k != "_indices"})
                    self.replay.update_priorities(idx, td)
                for k, v in s.items():
                    stats[k] = stats.get(k, 0.0) + v
                num_updates += 1
            self.env_runner_group.sync_weights(
                self.learner_group.get_weights())
        out = {k: v / max(1, num_updates) for k, v in stats.items()}
        out["epsilon"] = eps
        out["replay_size"] = len(self.replay)
        return out
