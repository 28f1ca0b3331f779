"""EnvRunners: rollout collection actors.

Port of `ray_tpu/rllib/env/env_runner.py` onto the port's runtime.

Reference: `rllib/env/env_runner.py:15` (ABC),
`single_agent_env_runner.py:49` (vectorised envs + RLModule
forward_exploration through connector pipelines),
`env_runner_group.py:66` (the fault-tolerant fleet). The runner holds the
module on the host's CPU (sim envs): the learner's card stays dedicated
to updates.

The runner steps its own list of envs (any object with gymnasium's
`reset(seed=)` / `step(action)` / `close()`; no `gymnasium.vector`) and
resets an env on the step its episode ends: the final observation becomes
the episode's `last_obs` and the reset observation the next episode's
first. The JAX runner steps `gym.vector.SyncVectorEnv`, whose gymnasium
1.x default (`AutoresetMode.NEXT_STEP`) resets an env one step later,
ignoring that step's action and returning reward 0, and records that step
as the next episode's first transition, from the terminal observation.
Env ``i`` is first reset with ``seed + i`` and afterwards without a seed,
so its random stream is the one `SyncVectorEnv` gives it: a greedy
rollout equals the JAX runner's once its reset transitions are removed.

`get_metrics` reports whole episodes' returns. An episode still running
when `sample` returns goes out as a fragment and goes on in the next
call; the JAX runner records only the return of an episode's last
fragment, so an episode longer than the steps a call gives each env is
reported short (F17).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.core.rl_module import Columns, RLModuleSpec
from ray_tpu_torch.rllib.utils.actor_manager import (
    ACTOR_THREADS, FaultTolerantActorManager, set_actor_threads)


class Episode:
    """One (possibly truncated) episode fragment of columnar data."""

    def __init__(self):
        self.obs: List[np.ndarray] = []
        self.actions: List[Any] = []
        self.rewards: List[float] = []
        self.logps: List[float] = []
        self.vf_preds: List[float] = []
        self.terminated = False
        self.truncated = False
        self.last_obs: Optional[np.ndarray] = None

    @property
    def length(self) -> int:
        return len(self.actions)

    @property
    def total_reward(self) -> float:
        return float(sum(self.rewards))


def module_outputs(fwd: Dict, n: int):
    """(actions, logps, vf_preds) of a forward pass as numpy, zeros where
    the module gives none."""
    zeros = np.zeros(n, np.float32)
    actions = fwd["actions"].cpu().numpy()
    logps = fwd[Columns.ACTION_LOGP].cpu().numpy() \
        if Columns.ACTION_LOGP in fwd else zeros
    vfs = fwd[Columns.VF_PREDS].cpu().numpy() \
        if Columns.VF_PREDS in fwd else zeros
    return actions, logps, vfs


def env_action(a):
    """Discrete -> Python int; continuous (Box) -> float32 vector."""
    return int(a) if np.ndim(a) == 0 else np.asarray(a, np.float32)


class SingleAgentEnvRunner:
    """Steps N envs with the current module weights."""

    def __init__(self, env_creator: Callable, spec: RLModuleSpec,
                 num_envs: int = 1, seed: int = 0,
                 explore_config: Optional[Dict[str, Any]] = None,
                 num_threads: Optional[int] = None):
        set_actor_threads(num_threads)
        self._envs = [env_creator() for _ in range(num_envs)]
        self.num_envs = num_envs
        self.module = spec.build()
        self._has_weights = False
        self._generator = torch.Generator().manual_seed(seed)
        self._explore = dict(explore_config or {})
        self._obs = [env.reset(seed=seed + i)[0]
                     for i, env in enumerate(self._envs)]
        self._open = [Episode() for _ in range(num_envs)]
        # each env's return so far in its current episode, over the
        # fragments `sample` has already handed out
        self._returns = [0.0] * num_envs
        self._completed_rewards: List[float] = []

    def set_weights(self, weights) -> None:
        self.module.set_weights(weights)
        self._has_weights = True

    def set_explore_config(self, explore_config: Dict[str, Any]) -> None:
        """Update exploration kwargs (e.g. DQN's decayed epsilon) passed
        to the module's forward_exploration on subsequent samples."""
        self._explore = dict(explore_config)

    def sample(self, num_steps: int = 200,
               explore: bool = True) -> List[Episode]:
        """Collect >= num_steps env steps; returns closed + open fragments."""
        assert self._has_weights, "set_weights first"
        episodes: List[Episode] = []
        steps = 0
        while steps < num_steps:
            obs = np.stack(self._obs).astype(np.float32)
            x = torch.from_numpy(obs)
            if explore:
                fwd = self.module.forward_exploration(
                    x, self._generator, **self._explore)
            else:
                fwd = self.module.forward_inference(x)
            actions, logps, vfs = module_outputs(fwd, self.num_envs)
            for i, env in enumerate(self._envs):
                act = env_action(actions[i])
                next_obs, reward, term, trunc, _ = env.step(act)
                ep = self._open[i]
                ep.obs.append(obs[i])
                ep.actions.append(act)
                ep.rewards.append(float(reward))
                ep.logps.append(float(logps[i]))
                ep.vf_preds.append(float(vfs[i]))
                self._returns[i] += float(reward)
                if term or trunc:
                    ep.terminated = bool(term)
                    ep.truncated = bool(trunc)
                    ep.last_obs = np.asarray(next_obs, np.float32)
                    episodes.append(ep)
                    self._completed_rewards.append(self._returns[i])
                    self._returns[i] = 0.0
                    self._open[i] = Episode()
                    next_obs, _ = env.reset()
                self._obs[i] = next_obs
            steps += self.num_envs
        # flush open fragments (bootstrapped by the learner connector)
        for i in range(self.num_envs):
            ep = self._open[i]
            if ep.length:
                ep.last_obs = np.asarray(self._obs[i], np.float32)
                episodes.append(ep)
                self._open[i] = Episode()
        return episodes

    def get_metrics(self) -> Dict[str, Any]:
        recent = self._completed_rewards[-100:]
        return {
            "episode_return_mean": (float(np.mean(recent))
                                    if recent else None),
            "num_episodes": len(self._completed_rewards),
        }

    def ping(self) -> bool:
        return True

    def close(self) -> None:
        for env in self._envs:
            env.close()


class EnvRunnerGroup:
    """Fleet of env-runner actors with fault tolerance.

    Reference: `rllib/env/env_runner_group.py:66` — remote runners managed
    by `FaultTolerantActorManager`; `num_env_runners=0` runs one local
    runner in-process (the reference's local-worker mode).
    """

    def __init__(self, env_creator: Callable, spec: RLModuleSpec,
                 num_env_runners: int = 0, num_envs_per_runner: int = 1,
                 seed: int = 0,
                 explore_config: Optional[Dict[str, Any]] = None):
        self.num_env_runners = num_env_runners
        if num_env_runners == 0:
            self.local_runner = SingleAgentEnvRunner(
                env_creator, spec, num_envs_per_runner, seed,
                explore_config)
            self.manager = None
        else:
            self.local_runner = None
            cls = ray_tpu_torch.remote(SingleAgentEnvRunner)
            actors = [
                cls.remote(env_creator, spec, num_envs_per_runner,
                           seed + 1000 * (i + 1), explore_config,
                           ACTOR_THREADS)
                for i in range(num_env_runners)
            ]
            restart = (lambda i: cls.remote(
                env_creator, spec, num_envs_per_runner,
                seed + 1000 * (i + 1), explore_config, ACTOR_THREADS))
            self.manager = FaultTolerantActorManager(actors, restart)

    def sync_weights(self, weights) -> None:
        if self.local_runner is not None:
            self.local_runner.set_weights(weights)
        else:
            self.manager.foreach(lambda a: a.set_weights.remote(weights))

    def set_explore_config(self, explore_config: Dict[str, Any]) -> None:
        if self.local_runner is not None:
            self.local_runner.set_explore_config(explore_config)
        else:
            self.manager.foreach(
                lambda a: a.set_explore_config.remote(explore_config))

    def sample(self, num_steps: int,
               explore: bool = True) -> List[Episode]:
        if self.local_runner is not None:
            return self.local_runner.sample(num_steps, explore)
        per = max(1, num_steps // max(1, self.manager.num_healthy()))
        results = self.manager.foreach(
            lambda a: a.sample.remote(per, explore), timeout=600)
        out: List[Episode] = []
        for eps in results:
            out.extend(eps)
        return out

    def get_metrics(self) -> List[Dict[str, Any]]:
        if self.local_runner is not None:
            return [self.local_runner.get_metrics()]
        return self.manager.foreach(lambda a: a.get_metrics.remote())

    def stop(self) -> None:
        if self.manager is not None:
            self.manager.stop()
        else:
            self.local_runner.close()
