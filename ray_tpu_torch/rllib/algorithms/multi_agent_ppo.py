"""Multi-agent PPO: independent per-module PPO over a shared rollout.

Reference: `rllib/algorithms/ppo/ppo.py:421` training_step combined with
the multi-agent plumbing of `rllib/env/multi_agent_env_runner.py` and
`rllib/core/rl_module/multi_rl_module.py`. Shared policies are many
agents mapped onto one module by `policy_mapping_fn`; each module gets
its own LearnerGroup (one compiled update per module — see the design
note in ray_tpu_torch/rllib/env/multi_agent.py).

Port of `ray_tpu/rllib/algorithms/multi_agent_ppo.py`.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig
from ray_tpu_torch.rllib.connectors import (GAE, columns_from_episodes,
                                      standardize_advantages)
from ray_tpu_torch.rllib.core.learner import PPOLearner
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.env.multi_agent import MultiAgentEnvRunnerGroup


def _spec_from_spaces(obs_space, act_space, cfg) -> RLModuleSpec:
    obs_dim = int(np.prod(obs_space.shape))
    if hasattr(act_space, "n"):
        return RLModuleSpec(observation_dim=obs_dim,
                            action_dim=int(act_space.n),
                            hidden=cfg.hidden, discrete=True,
                            module_class=cfg.module_class)
    low = np.asarray(act_space.low, np.float64).ravel()
    high = np.asarray(act_space.high, np.float64).ravel()
    return RLModuleSpec(
        observation_dim=obs_dim, action_dim=int(np.prod(act_space.shape)),
        hidden=cfg.hidden, discrete=False,
        action_scale=tuple(((high - low) / 2).tolist()),
        action_offset=tuple(((high + low) / 2).tolist()),
        module_class=cfg.module_class)


class MultiAgentPPOConfig(PPOConfig):
    def __init__(self, algo_class: type = None):
        super().__init__(algo_class or MultiAgentPPO)


class MultiAgentPPO(Algorithm):
    """`config.multi_agent(policies=..., policy_mapping_fn=...)` +
    `config.environment(env=<MultiAgentEnv creator>)`."""

    config_cls = MultiAgentPPOConfig

    def _build_groups(self, cfg, env_creator) -> None:
        """Multi-module construction: one LearnerGroup per policy module
        plus the multi-agent runner fleet (the shared setup scaffolding —
        config merge, output writer, iteration counter — stays in
        Algorithm.setup)."""
        if not cfg.policies or cfg.policy_mapping_fn is None:
            raise ValueError(
                "MultiAgentPPO needs config.multi_agent(policies=..., "
                "policy_mapping_fn=...)")
        mapping = cfg.policy_mapping_fn

        # infer unspecified module specs from the env's declared spaces
        probe = env_creator()
        try:
            self.specs: Dict[str, RLModuleSpec] = {}
            for mid, spec in cfg.policies.items():
                if spec is None:
                    agents = [a for a in probe.possible_agents
                              if mapping(a) == mid]
                    if not agents:
                        raise ValueError(
                            f"no agent maps to module {mid!r}")
                    a = agents[0]
                    spec = _spec_from_spaces(
                        probe.observation_spaces[a],
                        probe.action_spaces[a], cfg)
                self.specs[mid] = spec
        finally:
            probe.close()

        self.learner_groups: Dict[str, LearnerGroup] = {
            mid: LearnerGroup(
                PPOLearner, spec, cfg.learner_config(),
                num_learners=cfg.num_learners,
                num_devices_per_learner=cfg.num_devices_per_learner,
                seed=cfg.seed + i,
                resources_per_learner=cfg.resources_per_learner,
                device=cfg.learner_device)
            for i, (mid, spec) in enumerate(self.specs.items())
        }
        self.env_runner_group = MultiAgentEnvRunnerGroup(
            env_creator, self.specs, mapping,
            num_env_runners=cfg.num_env_runners, seed=cfg.seed,
            explore_config=cfg.explore_config)
        self.env_runner_group.sync_weights(self._weights())
        self._gae = {
            mid: GAE(gamma=cfg.gamma,
                     lambda_=cfg.extra.get("lambda_", 0.95),
                     module=spec.build(),
                     params_getter=self.learner_groups[mid].get_weights)
            for mid, spec in self.specs.items()
        }

    def _weights(self) -> Dict[str, Any]:
        return {mid: lg.get_weights()
                for mid, lg in self.learner_groups.items()}

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        by_module = self.env_runner_group.sample(cfg.train_batch_size)
        self.record_episodes(
            [ep for eps in by_module.values() for ep in eps])
        rng = np.random.default_rng(cfg.seed + self._iteration)
        out: Dict[str, Any] = {}
        total_steps = 0
        for mid, episodes in by_module.items():
            if not episodes:
                continue
            batch = columns_from_episodes(episodes, {})
            batch = self._gae[mid](episodes, batch)
            batch = standardize_advantages(episodes, batch)
            n = batch["actions"].shape[0]
            total_steps += n
            stats: Dict[str, float] = {}
            num_mb = 0
            lg = self.learner_groups[mid]
            for _ in range(cfg.num_epochs):
                perm = rng.permutation(n)
                for start in range(0, n, cfg.minibatch_size):
                    idx = perm[start:start + cfg.minibatch_size]
                    if idx.shape[0] < 2:
                        continue
                    mb = {k: v[idx] for k, v in batch.items()}
                    s = lg.update_from_batch(mb)
                    for k, v in s.items():
                        stats[k] = stats.get(k, 0.0) + v
                    num_mb += 1
            for k, v in stats.items():
                out[f"{mid}/{k}"] = v / max(1, num_mb)
        self.env_runner_group.sync_weights(self._weights())
        out["num_env_steps_sampled"] = int(total_steps)
        return out

    def evaluate(self) -> Dict[str, Any]:
        from ray_tpu_torch.rllib.env.multi_agent import MultiAgentEnvRunner

        if self._eval_runner is None:
            self._eval_runner = MultiAgentEnvRunner(
                self._env_creator, self.specs,
                self.algo_config.policy_mapping_fn,
                seed=self.algo_config.seed + 999_983)
        self._eval_runner.set_weights(self._weights())
        self._eval_runner.sample(
            self.algo_config.evaluation_duration, explore=False)
        return self._eval_runner.get_metrics()

    # -- checkpointing (per-module learner states) -------------------------

    def save_checkpoint(self, checkpoint_dir: str) -> None:
        state = {
            "learners": {mid: lg.get_state()
                         for mid, lg in self.learner_groups.items()},
            "iteration": self._iteration,
        }
        with open(os.path.join(checkpoint_dir, "algorithm.pkl"),
                  "wb") as f:
            pickle.dump(state, f)

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algorithm.pkl"),
                  "rb") as f:
            state = pickle.load(f)
        for mid, st in state["learners"].items():
            self.learner_groups[mid].set_state(st)
        self._iteration = state["iteration"]
        self.env_runner_group.sync_weights(self._weights())

    def stop(self) -> None:
        if getattr(self, "env_runner_group", None) is not None:
            self.env_runner_group.stop()
        for lg in getattr(self, "learner_groups", {}).values():
            lg.stop()
        if self._eval_runner is not None:
            self._eval_runner._env.close()
            self._eval_runner = None
