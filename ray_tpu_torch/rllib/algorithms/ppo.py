"""PPO — proximal policy optimization on the new-stack components.

Reference: `rllib/algorithms/ppo/ppo.py:395` (class) / :421
(`training_step`): synchronous on-policy loop — sample a train batch from
the env runners, GAE-postprocess, run minibatch SGD epochs on the
learner group, broadcast fresh weights back to the runners.

Port of `ray_tpu/rllib/algorithms/ppo.py`. `update_from_episodes` is the
iteration after sampling (GAE, the minibatch epochs, the weight
broadcast), so two learner groups can take the same iteration on the
same episodes. A result's `timers` hold the iteration's sample and learn
seconds.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.connectors import (
    GAE,
    columns_from_episodes,
    standardize_advantages,
)
from ray_tpu_torch.rllib.core.learner import PPOLearner


class PPOConfig(AlgorithmConfig):
    def __init__(self, algo_class: type = None):
        super().__init__(algo_class or PPO)
        self.lr = 3e-4
        self.train_batch_size = 2000
        self.minibatch_size = 256
        self.num_epochs = 8
        # PPO loss knobs (flow into the Learner via extra)
        self.extra.update({
            "clip_param": 0.2,
            "vf_loss_coeff": 0.5,
            "entropy_coeff": 0.0,
            "lambda_": 0.95,
        })


class PPO(Algorithm):
    learner_cls = PPOLearner
    config_cls = PPOConfig

    def setup(self, config: Dict[str, Any]) -> None:
        super().setup(config)
        cfg = self.algo_config
        # GAE bootstraps open episode fragments with the current value fn
        module = self.spec.build()
        self._gae = GAE(
            gamma=cfg.gamma,
            lambda_=cfg.extra.get("lambda_", 0.95),
            module=module,
            params_getter=self.learner_group.get_weights)

    def training_step(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        episodes = self.env_runner_group.sample(
            self.algo_config.train_batch_size)
        self.record_episodes(episodes)
        t1 = time.perf_counter()
        out = self.update_from_episodes(episodes)
        # reference: the result's `timers` (sample and learn wall time)
        out["timers"] = {"sample_s": t1 - t0,
                         "learn_s": time.perf_counter() - t1}
        return out

    def update_from_episodes(self, episodes) -> Dict[str, Any]:
        cfg = self.algo_config
        batch = columns_from_episodes(episodes, {})
        batch = self._gae(episodes, batch)
        batch = standardize_advantages(episodes, batch)
        n = batch["actions"].shape[0]
        rng = np.random.default_rng(cfg.seed + self._iteration)
        stats: Dict[str, float] = {}
        num_minibatches = 0
        for _ in range(cfg.num_epochs):
            perm = rng.permutation(n)
            for start in range(0, n, cfg.minibatch_size):
                idx = perm[start:start + cfg.minibatch_size]
                if idx.shape[0] < 2:
                    continue
                mb = {k: v[idx] for k, v in batch.items()}
                s = self.learner_group.update_from_batch(mb)
                for k, v in s.items():
                    stats[k] = stats.get(k, 0.0) + v
                num_minibatches += 1
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights())
        out = {k: v / max(1, num_minibatches) for k, v in stats.items()}
        out["num_env_steps_sampled"] = int(n)
        return out
