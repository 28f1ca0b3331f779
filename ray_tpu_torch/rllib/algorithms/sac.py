"""SAC — soft actor-critic for continuous (Box) action spaces.

Port of `ray_tpu/rllib/algorithms/sac.py`. Reference:
`rllib/algorithms/sac/sac.py` (+ torch policy losses in
`sac/torch/sac_torch_learner.py`): off-policy maximum-entropy RL with a
tanh-squashed Gaussian policy, twin Q networks with polyak-averaged
targets, and auto-tuned entropy temperature alpha. As in the JAX package,
policy, critics and alpha are one module updated by one optimizer in one
compiled step; gradient isolation between them is detached weights
(`frozen`) and detached terms instead of separate optimizers.

The reparameterisation noise is an INPUT of the update. The JAX loss
draws it inside the jitted function from key words in the batch
(``batch["rng"]``); here `SACLearner` draws ``noise_next`` and
``noise_new`` ([B, A] standard normals) on the host from a
``torch.Generator`` seeded by those words, before the captured region, so
every update with new words gets new noise and a graph never replays the
noise of its capture. A batch that already holds the noise (a test
handing over the JAX draws) and no words is used as it is.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.core.rl_module import (_MLP, Columns, RLModule,
                                                RLModuleSpec, as_tensor,
                                                params_to_numpy)
from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
_LOG_2PI = math.log(2 * math.pi)


def _squash(mean, log_std, noise, scale, offset=0.0):
    """Reparameterized affine-tanh-Gaussian sample + log-prob (with the
    tanh change-of-variables correction; the offset shifts the support
    without affecting the density). `noise` is standard normal, shaped
    like `mean` or with leading sample axes."""
    std = torch.exp(log_std)
    u = mean + std * noise
    a = torch.tanh(u) * scale + offset
    logp_u = -0.5 * (((u - mean) / std) ** 2 + 2 * log_std + _LOG_2PI)
    # d (tanh(u)*s + o) / du = s * (1 - tanh(u)^2)
    correction = torch.log(scale * (1 - torch.tanh(u) ** 2) + 1e-6)
    logp = (logp_u - correction).sum(dim=-1)
    return a, logp


def noise_generator(words) -> torch.Generator:
    """A host generator seeded by two uint32 words (a batch's ``rng``)."""
    w = [int(x) & 0xFFFFFFFF for x in np.asarray(words).ravel()[:2]]
    return torch.Generator().manual_seed((w[0] << 32) | w[1])


class SACModule(RLModule):
    """Policy + twin critics + log-alpha in one module."""

    def __init__(self, spec: RLModuleSpec):
        super().__init__(spec)
        obs, act = spec.observation_dim, spec.action_dim
        self.log_alpha = nn.Parameter(torch.zeros(()))
        self.policy = _MLP(obs, spec.hidden, (act, act))
        self.q1 = _MLP(obs + act, spec.hidden, (1,))
        self.q2 = _MLP(obs + act, spec.hidden, (1,))
        self.register_buffer("scale", torch.as_tensor(
            spec.action_scale, dtype=torch.float32), persistent=False)
        self.register_buffer("offset", torch.as_tensor(
            spec.action_offset, dtype=torch.float32), persistent=False)

    def pi(self, obs, frozen: bool = False):
        """(mean, log_std clipped to [LOG_STD_MIN, LOG_STD_MAX])."""
        mean, log_std = self.policy(obs, frozen)
        return mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)

    @staticmethod
    def q(net: _MLP, obs, actions, frozen: bool = False):
        """Q(s, a) of one critic over concatenated observation+action."""
        return net(torch.cat([obs, actions], dim=-1), frozen)[0].squeeze(-1)

    @torch.no_grad()
    def forward_inference(self, obs):
        mean, _ = self.pi(obs)
        return {"actions": torch.tanh(mean) * self.scale + self.offset}

    @torch.no_grad()
    def forward_exploration(self, obs, generator=None):
        mean, log_std = self.pi(obs)
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device)
        a, logp = _squash(mean, log_std, noise, self.scale, self.offset)
        return {"actions": a, Columns.ACTION_LOGP: logp}

    def forward_train(self, batch):
        mean, log_std = self.pi(batch[Columns.OBS])
        return {"mean": mean, "log_std": log_std}

    def q_values(self, obs, actions):
        return self.q(self.q1, obs, actions), self.q(self.q2, obs, actions)


class SACLearner(Learner):
    """Combined update: critic TD loss on batch actions, actor loss on
    reparameterized fresh actions against frozen critics, and the alpha
    (temperature) loss. The target critics polyak-update in place in
    `_after_update` (reference uses tau-averaged target nets)."""

    def __init__(self, spec: RLModuleSpec, config=None, seed: int = 0,
                 num_devices: int = 1, device=None,
                 num_threads: Optional[int] = None):
        super().__init__(spec, config, seed, num_devices, device,
                         num_threads)
        self.target_q = copy.deepcopy(nn.ModuleDict(
            {"q1": self.module.q1, "q2": self.module.q2})
        ).requires_grad_(False)
        self._polyak = list(zip(
            self.target_q.parameters(),
            [*self.module.q1.parameters(), *self.module.q2.parameters()]))
        self.tau = self.config.get("tau", 0.005)
        self.target_entropy = self.config.get(
            "target_entropy", -float(spec.action_dim))

    def _noise(self, batch):
        if "rng" not in batch:
            return {}
        gen = noise_generator(batch["rng"])
        shape = (batch[Columns.OBS].shape[0], self.spec.action_dim)
        return {"noise_next": torch.randn(shape, generator=gen).numpy(),
                "noise_new": torch.randn(shape, generator=gen).numpy()}

    def compute_loss(self, batch):
        m: SACModule = self.module
        gamma = self.config.get("gamma", 0.99)
        obs = batch[Columns.OBS]
        actions = batch[Columns.ACTIONS]
        alpha = torch.exp(m.log_alpha)

        # --- critic loss (batch actions, frozen targets) ----------------
        with torch.no_grad():
            next_obs = batch[Columns.NEXT_OBS]
            mean_n, log_std_n = m.pi(next_obs)
            a_next, logp_next = _squash(mean_n, log_std_n,
                                        batch["noise_next"], m.scale,
                                        m.offset)
            tq1 = m.q(self.target_q["q1"], next_obs, a_next)
            tq2 = m.q(self.target_q["q2"], next_obs, a_next)
            not_done = 1.0 - batch[Columns.TERMINATEDS].float()
            backup = batch[Columns.REWARDS] + gamma * not_done * \
                (torch.minimum(tq1, tq2) - alpha * logp_next)
        q1, q2 = m.q_values(obs, actions)
        q_loss = ((q1 - backup) ** 2).mean() + ((q2 - backup) ** 2).mean()

        # --- actor loss (fresh actions, frozen critics) -----------------
        mean, log_std = m.pi(obs)
        a_new, logp_new = _squash(mean, log_std, batch["noise_new"],
                                  m.scale, m.offset)
        q_new = torch.minimum(m.q(m.q1, obs, a_new, frozen=True),
                              m.q(m.q2, obs, a_new, frozen=True))
        policy_loss = (alpha.detach() * logp_new - q_new).mean()

        # --- temperature loss -------------------------------------------
        alpha_loss = -(m.log_alpha
                       * (logp_new + self.target_entropy).detach()).mean()

        loss = q_loss + policy_loss + alpha_loss
        return loss, {
            "q_loss": q_loss, "policy_loss": policy_loss,
            "alpha_loss": alpha_loss, "alpha": alpha,
            "q_mean": q1.mean(), "entropy": -logp_new.mean(),
        }

    @torch.no_grad()
    def _after_update(self) -> None:
        for t, o in self._polyak:
            t.lerp_(o, self.tau)  # (1 - tau) * t + tau * o

    def get_state(self):
        state = super().get_state()
        state["target_q"] = params_to_numpy(self.target_q)
        return state

    def set_state(self, state) -> None:
        super().set_state(state)
        if "target_q" in state:
            with torch.no_grad():
                for name, p in self.target_q.named_parameters():
                    p.copy_(as_tensor(state["target_q"][name]))


class SACConfig(AlgorithmConfig):
    def __init__(self, algo_class: type = None):
        super().__init__(algo_class or SAC)
        self.module_class = SACModule
        self.lr = 3e-4
        self.train_batch_size = 256
        self.rollout_fragment_length = 200
        self.grad_clip = 10.0
        self.extra.update({
            "tau": 0.005,
            "learning_starts": 1000,
            "num_updates_per_iteration": 32,
            "replay_capacity": 100_000,
        })


class SAC(Algorithm):
    learner_cls = SACLearner
    config_cls = SACConfig

    def setup(self, config: Dict[str, Any]) -> None:
        super().setup(config)
        if self.spec.discrete:
            raise ValueError(
                "SAC targets continuous (Box) action spaces; use DQN "
                "for discrete envs (reference SAC has the same core)")
        x = self.algo_config.extra
        self.replay = ReplayBuffer(capacity=x["replay_capacity"],
                                   seed=self.algo_config.seed)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        x = cfg.extra
        episodes = self.env_runner_group.sample(
            cfg.rollout_fragment_length)
        self.record_episodes(episodes)
        for ep in episodes:
            if ep.length:
                self.replay.add_episode(ep)
        stats: Dict[str, float] = {}
        num_updates = 0
        if len(self.replay) >= x["learning_starts"]:
            for u in range(x["num_updates_per_iteration"]):
                batch = self.replay.sample(cfg.train_batch_size)
                # fresh reparameterization noise per update: the words
                # seed the learner's host generator
                batch["rng"] = np.asarray(
                    [cfg.seed & 0xFFFFFFFF,
                     (977 * self._iteration + u) & 0xFFFFFFFF],
                    np.uint32)
                s = self.learner_group.update_from_batch(batch)
                for k, v in s.items():
                    stats[k] = stats.get(k, 0.0) + v
                num_updates += 1
            self.env_runner_group.sync_weights(
                self.learner_group.get_weights())
        out = {k: v / max(1, num_updates) for k, v in stats.items()}
        out["replay_size"] = len(self.replay)
        out["num_updates"] = num_updates
        return out
