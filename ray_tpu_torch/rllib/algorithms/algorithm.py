"""Algorithm: the top-level RL trainer, runnable standalone or under Tune.

Port of `ray_tpu/rllib/algorithms/algorithm.py`, on the port's
`tune.trainable.Trainable`. Its `algorithm.pkl` holds the learner state
as numpy (weights, Adam's count and moments): the port writes and reads
its own checkpoints; a JAX package's pickle holds optax state, which
only optax can unpickle, so the port does not read it.

Reference: `rllib/algorithms/algorithm.py:213` — Algorithm subclasses
Tune's `Trainable`; `setup` (:579) builds the `EnvRunnerGroup` +
`LearnerGroup`, and each `train()`/`step()` call runs the per-algorithm
`training_step` (:1586) that orchestrates sample → update → weight
broadcast. Same shape here: subclass `ray_tpu_torch.tune.Trainable`, so
`Tuner(PPO, param_space=...)` works exactly like a Train/Tune run.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional, Type

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.env.env_runner import EnvRunnerGroup
from ray_tpu_torch.tune.trainable import Trainable


class Algorithm(Trainable):
    """Drive sample→update→broadcast; one `step()` = one training
    iteration (reference `training_step`)."""

    #: subclasses bind their Learner and default config
    learner_cls: Type[Learner] = None
    config_cls: Type[AlgorithmConfig] = AlgorithmConfig

    def __init__(self, config: Optional[AlgorithmConfig] = None):
        super().__init__()
        self._algo_config = config
        self.env_runner_group: Optional[EnvRunnerGroup] = None
        self.learner_group: Optional[LearnerGroup] = None
        # pre-set so stop()/cleanup() are safe when setup() fails early
        self._eval_runner = None
        self._output_writer = None
        self._setup_called = False
        if config is not None:
            # standalone construction (config.build_algo()) — Tune-hosted
            # instances defer to setup(param_space_dict)
            self.setup({})

    # -- Trainable interface ----------------------------------------------

    def setup(self, config: Dict[str, Any]) -> None:
        """Shared scaffolding (guard, config merge, output writer,
        iteration counter); the algorithm-specific spec inference and
        runner/learner-group construction live in `_build_groups` so
        variants (e.g. MultiAgentPPO) override that hook instead of
        re-implementing setup."""
        if self._setup_called:
            return
        self._setup_called = True
        cfg = (self._algo_config.copy() if self._algo_config is not None
               else self.default_config())
        if config:
            cfg.update_from_dict(config)
        self.algo_config = cfg
        env_creator = cfg.env_creator()
        self._env_creator = env_creator
        self._build_groups(cfg, env_creator)
        if cfg.output:
            from ray_tpu_torch.rllib.offline.io import JsonWriter
            self._output_writer = JsonWriter(cfg.output)
        self._iteration = 0

    def _build_groups(self, cfg: AlgorithmConfig, env_creator) -> None:
        """Infer the module spec from the env and build the learner +
        env-runner groups. Overridable construction hook."""
        probe = env_creator()
        try:
            obs_dim = int(np.prod(probe.observation_space.shape))
            space = probe.action_space
            if hasattr(space, "n"):  # Discrete
                act_dim, discrete = int(space.n), True
                scale, offset = 1.0, 0.0
            else:  # Box: per-dim affine tanh squashing onto [low, high]
                act_dim = int(np.prod(space.shape))
                discrete = False
                low = np.asarray(space.low, np.float64).ravel()
                high = np.asarray(space.high, np.float64).ravel()
                if not (np.isfinite(low).all()
                        and np.isfinite(high).all()):
                    raise ValueError(
                        f"continuous algorithms need a bounded Box "
                        f"action space; got low={low}, high={high}")
                scale = tuple(((high - low) / 2).tolist())
                offset = tuple(((high + low) / 2).tolist())
        finally:
            probe.close()
        self.spec = RLModuleSpec(
            observation_dim=obs_dim, action_dim=act_dim,
            hidden=cfg.hidden, discrete=discrete, action_scale=scale,
            action_offset=offset, module_class=cfg.module_class)
        self.learner_group = LearnerGroup(
            type(self).learner_cls, self.spec, cfg.learner_config(),
            num_learners=cfg.num_learners,
            num_devices_per_learner=cfg.num_devices_per_learner,
            seed=cfg.seed,
            resources_per_learner=cfg.resources_per_learner,
            device=cfg.learner_device)
        self.env_runner_group = EnvRunnerGroup(
            env_creator, self.spec,
            num_env_runners=cfg.num_env_runners,
            num_envs_per_runner=cfg.num_envs_per_env_runner,
            seed=cfg.seed, explore_config=cfg.explore_config)
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights())

    @classmethod
    def default_config(cls) -> AlgorithmConfig:
        return cls.config_cls(algo_class=cls)

    def step(self) -> Dict[str, Any]:
        self._iteration += 1
        results = self.training_step()
        metrics = self.env_runner_group.get_metrics()
        returns = [m["episode_return_mean"] for m in metrics
                   if m.get("episode_return_mean") is not None]
        results["episode_return_mean"] = (
            float(np.mean(returns)) if returns else float("nan"))
        results["num_episodes"] = int(
            sum(m.get("num_episodes", 0) for m in metrics))
        results["training_iteration"] = self._iteration
        interval = self.algo_config.evaluation_interval
        if interval and self._iteration % interval == 0:
            results["evaluation"] = self.evaluate()
        return results

    def evaluate(self) -> Dict[str, Any]:
        """Greedy (explore=False) rollouts with the current weights.

        Reference: `Algorithm.evaluate` (`rllib/algorithms/
        algorithm.py:1061`) — like the reference's dedicated evaluation
        workers, this samples on a SEPARATE local runner so greedy eval
        episodes never pollute the training runners' episode metrics or
        interrupt their in-flight episodes.
        """
        from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner

        if self._eval_runner is None:
            self._eval_runner = SingleAgentEnvRunner(
                self._env_creator, self.spec,
                num_envs=self.algo_config.num_envs_per_env_runner,
                seed=self.algo_config.seed + 999_983)
        self._eval_runner.set_weights(self.learner_group.get_weights())
        episodes = self._eval_runner.sample(
            self.algo_config.evaluation_duration, explore=False)
        returns = [ep.total_reward for ep in episodes if ep.terminated
                   or ep.truncated]
        return {
            "episode_return_mean": (float(np.mean(returns)) if returns
                                    else float("nan")),
            "num_episodes": len(returns),
        }

    def record_episodes(self, episodes) -> None:
        """Persist sampled episodes when `config.offline_data(output=)`
        is set (reference: env-runner output writers)."""
        if self._output_writer is not None:
            self._output_writer.write(episodes)

    def train(self) -> Dict[str, Any]:
        """Standalone stepping (outside Tune): one training iteration."""
        return self.step()

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    # -- checkpointing -----------------------------------------------------

    def save_checkpoint(self, checkpoint_dir: str) -> None:
        state = {
            "learner": self.learner_group.get_state(),
            "iteration": self._iteration,
            "algo_state": self.get_algo_state(),
        }
        with open(os.path.join(checkpoint_dir, "algorithm.pkl"),
                  "wb") as f:
            pickle.dump(state, f)

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algorithm.pkl"),
                  "rb") as f:
            state = pickle.load(f)
        self.learner_group.set_state(state["learner"])
        self._iteration = state["iteration"]
        self.set_algo_state(state.get("algo_state", {}))
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights())

    def get_algo_state(self) -> Dict[str, Any]:
        """Algorithm-specific extra state (e.g. DQN epsilon schedule)."""
        return {}

    def set_algo_state(self, state: Dict[str, Any]) -> None:
        pass

    def cleanup(self) -> None:
        self.stop()

    def stop(self) -> None:
        if self.env_runner_group is not None:
            self.env_runner_group.stop()
        if self.learner_group is not None:
            self.learner_group.stop()
        if self._eval_runner is not None:
            self._eval_runner.close()
            self._eval_runner = None
