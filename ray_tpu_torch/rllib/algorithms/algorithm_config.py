"""AlgorithmConfig: the fluent builder that parameterizes an Algorithm.

Port of `ray_tpu/rllib/algorithms/algorithm_config.py`, with one field of
the port's own: `learner_device` (`.learners(learner_device=...)`), the
device every learner runs on (default ``"cuda"``; ``"cpu"`` on a host
without a card). An env is a callable creator or a gymnasium id; only an
id imports gymnasium (`gymnasium.make`).

Reference: `rllib/algorithms/algorithm_config.py` (4.9k LoC) — rebuilt as
a compact dataclass-backed fluent API covering the new-stack surface the
rebuilt Algorithm actually consumes: environment / env_runners / training
/ learners / rl_module / evaluation groups, `to_dict`/`from_dict` so Tune
param_space dicts overlay cleanly, and `build_algo()`.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Tuple


class AlgorithmConfig:
    def __init__(self, algo_class: Optional[type] = None):
        self.algo_class = algo_class
        # environment
        self.env: Any = None  # gym id string or callable creator
        self.env_config: Dict[str, Any] = {}
        # env runners (reference .env_runners())
        self.num_env_runners: int = 0
        self.num_envs_per_env_runner: int = 1
        self.rollout_fragment_length: int = 200
        self.explore_config: Dict[str, Any] = {}
        # training (shared knobs; algos add their own via .training())
        self.lr: float = 3e-4
        self.gamma: float = 0.99
        self.grad_clip: float = 0.5
        self.train_batch_size: int = 2000
        self.minibatch_size: int = 256
        self.num_epochs: int = 8
        # learners (reference .learners())
        self.num_learners: int = 0
        self.num_devices_per_learner: int = 1
        self.resources_per_learner: Optional[Dict[str, float]] = None
        self.learner_device: Optional[str] = None  # None: "cuda"
        # rl module
        self.hidden: Tuple[int, ...] = (64, 64)
        self.module_class: Optional[type] = None
        # evaluation (reference .evaluation())
        self.evaluation_interval: int = 0  # iterations; 0 = off
        self.evaluation_duration: int = 500  # env steps per evaluate()
        # offline data (reference .offline_data())
        self.input_: Any = None  # path/glob of recorded episode shards
        self.output: Any = None  # directory to record sampled episodes
        # multi-agent (reference .multi_agent(); empty = single-agent)
        self.policies: Dict[str, Any] = {}
        self.policy_mapping_fn: Optional[Callable] = None
        # misc
        self.seed: int = 0
        self.extra: Dict[str, Any] = {}

    # -- fluent groups (each returns self, reference style) ----------------

    def environment(self, env: Any = None, *,
                    env_config: Optional[Dict] = None
                    ) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None,
                    explore_config: Optional[Dict] = None
                    ) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if explore_config is not None:
            self.explore_config = dict(explore_config)
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        """Set any training hyperparameter; unknown keys land in `extra`
        and flow into the Learner config (so algo-specific knobs like
        `clip_param` need no dedicated field)."""
        for k, v in kwargs.items():
            if hasattr(self, k) and k != "extra":
                setattr(self, k, v)
            else:
                self.extra[k] = v
        return self

    def learners(self, *, num_learners: Optional[int] = None,
                 num_devices_per_learner: Optional[int] = None,
                 resources_per_learner: Optional[Dict] = None,
                 learner_device: Optional[str] = None
                 ) -> "AlgorithmConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        if num_devices_per_learner is not None:
            self.num_devices_per_learner = num_devices_per_learner
        if resources_per_learner is not None:
            self.resources_per_learner = dict(resources_per_learner)
        if learner_device is not None:
            self.learner_device = learner_device
        return self

    def rl_module(self, *, hidden: Optional[Tuple[int, ...]] = None,
                  module_class: Optional[type] = None
                  ) -> "AlgorithmConfig":
        if hidden is not None:
            self.hidden = tuple(hidden)
        if module_class is not None:
            self.module_class = module_class
        return self

    def evaluation(self, *, evaluation_interval: Optional[int] = None,
                   evaluation_duration: Optional[int] = None
                   ) -> "AlgorithmConfig":
        if evaluation_interval is not None:
            self.evaluation_interval = evaluation_interval
        if evaluation_duration is not None:
            self.evaluation_duration = evaluation_duration
        return self

    def offline_data(self, *, input_: Any = None, output: Any = None
                     ) -> "AlgorithmConfig":
        if input_ is not None:
            self.input_ = input_
        if output is not None:
            self.output = output
        return self

    def debugging(self, *, seed: Optional[int] = None
                  ) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    # -- dict interop (Tune param_space overlay) ---------------------------

    _SKIP = {"algo_class"}

    def to_dict(self) -> Dict[str, Any]:
        d = {k: v for k, v in self.__dict__.items()
             if k not in self._SKIP and k != "extra"}
        d.update(self.extra)
        return d

    def multi_agent(self, *, policies: Optional[Dict[str, Any]] = None,
                    policy_mapping_fn: Optional[Callable] = None
                    ) -> "AlgorithmConfig":
        """Declare the policy modules and the agent->module routing.

        `policies` maps module ids to an RLModuleSpec or None (None =
        infer the spec from the env's per-agent spaces); every agent id
        is routed by `policy_mapping_fn(agent_id) -> module_id`
        (reference `algorithm_config.py` .multi_agent()).
        """
        if policies is not None:
            self.policies = dict(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    def update_from_dict(self, d: Dict[str, Any]) -> "AlgorithmConfig":
        for k, v in d.items():
            if k in self._SKIP:
                continue
            if hasattr(self, k) and k != "extra":
                setattr(self, k, v)
            else:
                self.extra[k] = v
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    # -- derived -----------------------------------------------------------

    def learner_config(self) -> Dict[str, Any]:
        cfg = {"lr": self.lr, "gamma": self.gamma,
               "grad_clip": self.grad_clip}
        cfg.update(self.extra)
        return cfg

    def env_creator(self) -> Callable:
        env = self.env
        env_config = self.env_config
        if callable(env):
            if env_config:
                return lambda: env(env_config)
            return env
        if isinstance(env, str):
            def make():
                import gymnasium as gym
                return gym.make(env, **env_config)
            return make
        raise ValueError(f"config.environment(env=...) required; got "
                         f"{env!r}")

    def build_algo(self):
        if self.algo_class is None:
            raise ValueError("no algo_class bound to this config")
        return self.algo_class(config=self)
