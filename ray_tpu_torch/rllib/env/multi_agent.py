"""Multi-agent environments and rollout collection.

Reference: `rllib/env/multi_agent_env.py:31` (dict-keyed step/reset API),
`rllib/env/multi_agent_env_runner.py` (per-agent episode bookkeeping,
module routing via the policy mapping fn) and the multi-agent RLModule
container (`rllib/core/rl_module/multi_rl_module.py`). The runner
groups the agents that share a module and does ONE batched forward per
module per env step (instead of the reference's per-agent passes), so
rollout compute stays vectorised however many agents the env has.

Design decision vs the reference: policies are trained as independent
modules (shared policies = many agents mapped onto one module). The
reference couples modules through a summed loss inside one Learner —
that only matters for shared encoders, which the flat RLModuleSpec
doesn't model; independent per-module Learners keep every module's
update a single compiled step.

Port of `ray_tpu/rllib/env/multi_agent.py` onto the port's runtime: the
modules are the port's nn.Modules on the runner's CPU, and exploration
draws from the runner's ``torch.Generator`` (the JAX runner splits a
PRNG key per module and step).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.env.env_runner import (Episode, env_action,
                                               module_outputs)
from ray_tpu_torch.rllib.utils.actor_manager import (
    ACTOR_THREADS, FaultTolerantActorManager, set_actor_threads)

AgentID = str
ModuleID = str


class MultiAgentEnv:
    """Dict-keyed environment: every step consumes an action per *live*
    agent and returns per-agent obs/rewards/terms/truncs plus the
    "__all__" episode-done flag (reference `multi_agent_env.py:66`).

    Subclasses define `possible_agents`, `observation_spaces`,
    `action_spaces` (dicts keyed by agent id) and the two methods below.
    Agents may appear/disappear between steps; only agents present in
    the returned obs dict act next step.
    """

    possible_agents: List[AgentID] = []
    observation_spaces: Dict[AgentID, Any] = {}
    action_spaces: Dict[AgentID, Any] = {}

    def reset(self, *, seed: Optional[int] = None
              ) -> Tuple[Dict[AgentID, np.ndarray], Dict]:
        raise NotImplementedError

    def step(self, actions: Dict[AgentID, Any]) -> Tuple[
            Dict[AgentID, np.ndarray], Dict[AgentID, float],
            Dict[AgentID, bool], Dict[AgentID, bool], Dict]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MultiAgentEnvRunner:
    """Collects per-agent episode fragments from one MultiAgentEnv.

    Episodes are tagged with the module that produced them; `sample`
    returns {module_id: [Episode, ...]} so each module's connector/GAE/
    learner path is exactly the single-agent one.
    """

    def __init__(self, env_creator: Callable[[], MultiAgentEnv],
                 specs: Dict[ModuleID, RLModuleSpec],
                 policy_mapping_fn: Callable[[AgentID], ModuleID],
                 seed: int = 0,
                 explore_config: Optional[Dict[str, Any]] = None,
                 num_threads: Optional[int] = None):
        set_actor_threads(num_threads)
        self._env = env_creator()
        self._mapping = policy_mapping_fn
        self.modules = {mid: spec.build() for mid, spec in specs.items()}
        self._weighted: set = set()
        self._generator = torch.Generator().manual_seed(seed)
        self._explore = dict(explore_config or {})
        self._seed = seed
        self._obs, _ = self._env.reset(seed=seed)
        self._open: Dict[AgentID, Episode] = {}
        self._completed_returns: List[float] = []  # env-level (summed)
        self._episode_reward = 0.0

    def set_weights(self, weights: Dict[ModuleID, Any]) -> None:
        for mid, w in weights.items():
            self.modules[mid].set_weights(w)
            self._weighted.add(mid)

    def set_explore_config(self, explore_config: Dict[str, Any]) -> None:
        self._explore = dict(explore_config)

    def _module_of(self, agent: AgentID) -> ModuleID:
        return self._mapping(agent)

    def _forward(self, agents: List[AgentID], explore: bool):
        """One batched forward per module covering its live agents."""
        by_module: Dict[ModuleID, List[AgentID]] = {}
        for a in agents:
            by_module.setdefault(self._module_of(a), []).append(a)
        acts: Dict[AgentID, Any] = {}
        logps: Dict[AgentID, float] = {}
        vfs: Dict[AgentID, float] = {}
        for mid, group in by_module.items():
            obs = np.stack([np.asarray(self._obs[a], np.float32).ravel()
                            for a in group])
            mod = self.modules[mid]
            x = torch.from_numpy(obs)
            if explore:
                fwd = mod.forward_exploration(x, self._generator,
                                              **self._explore)
            else:
                fwd = mod.forward_inference(x)
            actions, lp, vf = module_outputs(fwd, len(group))
            for i, a in enumerate(group):
                acts[a] = env_action(actions[i])
                logps[a] = float(lp[i])
                vfs[a] = float(vf[i])
        return acts, logps, vfs

    def sample(self, num_steps: int = 200, explore: bool = True
               ) -> Dict[ModuleID, List[Episode]]:
        assert self._weighted == set(self.modules), "set_weights first"
        out: Dict[ModuleID, List[Episode]] = {
            mid: [] for mid in self.modules}
        steps = 0
        while steps < num_steps:
            agents = list(self._obs.keys())
            acts, logps, vfs = self._forward(agents, explore)
            next_obs, rewards, terms, truncs, _ = self._env.step(acts)
            for a in agents:
                ep = self._open.setdefault(a, Episode())
                ep.obs.append(np.asarray(self._obs[a], np.float32).ravel())
                ep.actions.append(acts[a])
                ep.rewards.append(float(rewards.get(a, 0.0)))
                ep.logps.append(logps[a])
                ep.vf_preds.append(vfs[a])
                self._episode_reward += float(rewards.get(a, 0.0))
            done_all = terms.get("__all__", False) or \
                truncs.get("__all__", False)
            for a in agents:
                a_done = terms.get(a, False) or truncs.get(a, False)
                # an agent may also vanish from the obs dict with no
                # term/trunc flag (it left the episode) — close its
                # fragment rather than stranding it in self._open
                vanished = not done_all and not a_done and a not in next_obs
                if a_done or done_all or vanished:
                    ep = self._open.pop(a, None)
                    if ep is not None and ep.length:
                        ep.terminated = bool(
                            terms.get(a, False) or terms.get("__all__",
                                                             False))
                        ep.truncated = not ep.terminated
                        if a in next_obs:
                            ep.last_obs = np.asarray(
                                next_obs[a], np.float32).ravel()
                        out[self._module_of(a)].append(ep)
            steps += len(agents)
            if done_all:
                # flush fragments of agents that were already absent
                # this step, then start a fresh episode
                for a, ep in self._open.items():
                    if ep.length:
                        ep.truncated = True
                        out[self._module_of(a)].append(ep)
                self._completed_returns.append(self._episode_reward)
                self._episode_reward = 0.0
                self._seed += 1
                self._obs, _ = self._env.reset(seed=self._seed)
                self._open.clear()
            else:
                self._obs = next_obs
        # flush open fragments (bootstrapped by GAE via last_obs)
        for a, ep in list(self._open.items()):
            if ep.length:
                ep.last_obs = np.asarray(self._obs[a], np.float32).ravel()
                out[self._module_of(a)].append(ep)
                self._open[a] = Episode()
        return out

    def get_metrics(self) -> Dict[str, Any]:
        recent = self._completed_returns[-100:]
        return {
            "episode_return_mean": (float(np.mean(recent))
                                    if recent else None),
            "num_episodes": len(self._completed_returns),
        }

    def ping(self) -> bool:
        return True


class MultiAgentEnvRunnerGroup:
    """Fleet of multi-agent runners; mirrors EnvRunnerGroup (local mode
    at num_env_runners=0, fault-tolerant actor fleet otherwise)."""

    def __init__(self, env_creator: Callable[[], MultiAgentEnv],
                 specs: Dict[ModuleID, RLModuleSpec],
                 policy_mapping_fn: Callable[[AgentID], ModuleID],
                 num_env_runners: int = 0, seed: int = 0,
                 explore_config: Optional[Dict[str, Any]] = None):
        self.num_env_runners = num_env_runners
        if num_env_runners == 0:
            self.local_runner = MultiAgentEnvRunner(
                env_creator, specs, policy_mapping_fn, seed,
                explore_config)
            self.manager = None
        else:
            self.local_runner = None
            cls = ray_tpu_torch.remote(MultiAgentEnvRunner)
            actors = [
                cls.remote(env_creator, specs, policy_mapping_fn,
                           seed + 1000 * (i + 1), explore_config,
                           ACTOR_THREADS)
                for i in range(num_env_runners)
            ]
            restart = (lambda i: cls.remote(
                env_creator, specs, policy_mapping_fn,
                seed + 1000 * (i + 1), explore_config, ACTOR_THREADS))
            self.manager = FaultTolerantActorManager(actors, restart)

    def sync_weights(self, weights: Dict[ModuleID, Any]) -> None:
        if self.local_runner is not None:
            self.local_runner.set_weights(weights)
        else:
            self.manager.foreach(lambda a: a.set_weights.remote(weights))

    def sample(self, num_steps: int, explore: bool = True
               ) -> Dict[ModuleID, List[Episode]]:
        if self.local_runner is not None:
            return self.local_runner.sample(num_steps, explore)
        per = max(1, num_steps // max(1, self.manager.num_healthy()))
        results = self.manager.foreach(
            lambda a: a.sample.remote(per, explore), timeout=600)
        out: Dict[ModuleID, List[Episode]] = {}
        for res in results:
            for mid, eps in res.items():
                out.setdefault(mid, []).extend(eps)
        return out

    def get_metrics(self) -> List[Dict[str, Any]]:
        if self.local_runner is not None:
            return [self.local_runner.get_metrics()]
        return self.manager.foreach(lambda a: a.get_metrics.remote())

    def stop(self) -> None:
        if self.manager is not None:
            self.manager.stop()
        elif self.local_runner is not None:
            self.local_runner._env.close()
