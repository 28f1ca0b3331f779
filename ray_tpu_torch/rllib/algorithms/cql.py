"""CQL — conservative Q-learning for offline continuous control.

Port of `ray_tpu/rllib/algorithms/cql.py`. Reference:
`rllib/algorithms/cql/cql.py` (+ `cql/torch/cql_torch_learner.py`): SAC's
twin-critic/auto-alpha machinery trained purely from a logged dataset,
with the CQL(H) conservative regularizer pushing Q down on
out-of-distribution actions (logsumexp over sampled actions) and up on
dataset actions. The regularizer's sampled-action Q evaluations are
batched into the same compiled update as the SAC loss:
`num_sampled_actions` uniform + policy + next-policy samples evaluated in
one [3n, B] critic pass, no Python loop.

Its noise is an input of the update, as SAC's is: ``cql_uniform``
(uniform on [0, 1), scaled onto the action box in the loss) and
``cql_noise_pol`` / ``cql_noise_next`` (standard normals), each [n, B, A],
drawn on the host from a generator seeded by the batch's ``cql_rng``
words (the JAX loss draws them inside the jit from those words).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.sac import (SACConfig, SACLearner,
                                                SACModule, _squash,
                                                noise_generator)
from ray_tpu_torch.rllib.core.rl_module import Columns
from ray_tpu_torch.rllib.offline.io import JsonReader
from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer


class CQLLearner(SACLearner):
    """SAC loss + the CQL(H) conservative term on both critics."""

    def _noise(self, batch):
        out = super()._noise(batch)
        if "cql_rng" in batch:
            gen = noise_generator(batch["cql_rng"])
            n = int(self.config.get("num_sampled_actions", 10))
            shape = (n, batch[Columns.OBS].shape[0], self.spec.action_dim)
            out["cql_uniform"] = torch.rand(shape, generator=gen).numpy()
            out["cql_noise_pol"] = torch.randn(shape, generator=gen).numpy()
            out["cql_noise_next"] = torch.randn(shape, generator=gen).numpy()
        return out

    def compute_loss(self, batch):
        m: SACModule = self.module
        sac_loss, stats = super().compute_loss(batch)
        n = int(self.config.get("num_sampled_actions", 10))
        cql_alpha = self.config.get("cql_alpha", 5.0)
        obs = batch[Columns.OBS]
        B = obs.shape[0]
        A = m.spec.action_dim

        # --- candidate actions: [n, B, A] each ---------------------------
        scale = torch.broadcast_to(m.scale, (A,))
        lo, hi = m.offset - scale, m.offset + scale
        a_unif = torch.maximum(lo, batch["cql_uniform"] * (hi - lo) + lo)
        # uniform log-density over the box (importance correction)
        log_unif = -torch.log(2.0 * scale + 1e-8).sum()

        # The conservative term trains the CRITICS only (reference CQL
        # attaches it to the critic optimizers and detaches the policy
        # log-probs): the policy samples carry no gradient.
        with torch.no_grad():
            def policy_samples(o, noise):
                mean, log_std = m.pi(o)
                return _squash(mean, log_std, noise, m.scale, m.offset)

            a_pol, logp_pol = policy_samples(obs, batch["cql_noise_pol"])
            a_nxt, logp_nxt = policy_samples(batch[Columns.NEXT_OBS],
                                             batch["cql_noise_next"])

        cand = torch.cat([a_unif, a_pol, a_nxt], dim=0)  # [3n, B, A]
        log_dens = torch.cat([log_unif.expand(n, B), logp_pol, logp_nxt],
                             dim=0)
        obs_rep = obs.expand(3 * n, *obs.shape)

        def ood_term(q_net):
            q = m.q(q_net, obs_rep, cand)  # [3n, B]
            # CQL(H): logsumexp with importance weights, minus data Q
            lse = torch.logsumexp(q - log_dens, dim=0) - math.log(3.0 * n)
            q_data = m.q(q_net, obs, batch[Columns.ACTIONS])
            # mean critic value on the policy's own (OOD) actions — the
            # quantity the conservative penalty is meant to suppress
            q_ood = q[n:2 * n].mean()
            return (lse - q_data).mean(), q_ood

        t1, ood1 = ood_term(m.q1)
        t2, ood2 = ood_term(m.q2)
        cql_term = t1 + t2
        loss = sac_loss + cql_alpha * cql_term
        stats = dict(stats)
        stats["cql_loss"] = cql_term
        stats["q_ood_mean"] = 0.5 * (ood1 + ood2)
        return loss, stats


class CQLConfig(SACConfig):
    def __init__(self, algo_class: type = None):
        super().__init__(algo_class or CQL)
        self.num_epochs = 1
        self.extra.update({
            "cql_alpha": 5.0,
            "num_sampled_actions": 10,
            "num_updates_per_iteration": 64,
        })


class CQL(Algorithm):
    """Offline: `config.offline_data(input_=...)` + an env for space
    inference and greedy evaluation (reference CQL evaluates the learned
    policy on the real env too)."""

    learner_cls = CQLLearner
    config_cls = CQLConfig

    def setup(self, config: Dict[str, Any]) -> None:
        super().setup(config)
        cfg = self.algo_config
        if self.spec.discrete:
            raise ValueError("CQL targets continuous (Box) action "
                             "spaces (reference CQL extends SAC)")
        if not cfg.input_:
            raise ValueError(
                "offline algorithms need config.offline_data(input_=...)")
        # load the whole logged dataset into a flat transition buffer
        reader = JsonReader(cfg.input_, seed=cfg.seed)
        self.replay = ReplayBuffer(capacity=10_000_000, seed=cfg.seed)
        for ep in reader.iter_episodes():
            if ep.length:
                self.replay.add_episode(ep)
        if not len(self.replay):
            raise ValueError(f"no transitions found in {cfg.input_!r}")

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        x = cfg.extra
        stats: Dict[str, float] = {}
        num_updates = 0
        for u in range(x["num_updates_per_iteration"]):
            batch = self.replay.sample(cfg.train_batch_size)
            batch["rng"] = np.asarray(
                [cfg.seed & 0xFFFFFFFF,
                 (977 * self._iteration + u) & 0xFFFFFFFF], np.uint32)
            batch["cql_rng"] = np.asarray(
                [(cfg.seed + 1) & 0xFFFFFFFF,
                 (991 * self._iteration + u) & 0xFFFFFFFF], np.uint32)
            s = self.learner_group.update_from_batch(batch)
            for k, v in s.items():
                stats[k] = stats.get(k, 0.0) + v
            num_updates += 1
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights())
        out = {k: v / max(1, num_updates) for k, v in stats.items()}
        out["num_offline_steps_trained"] = int(
            num_updates * cfg.train_batch_size)
        return out
