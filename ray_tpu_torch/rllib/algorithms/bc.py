"""BC and MARWIL — offline RL algorithms over recorded episodes.

Reference: `rllib/algorithms/bc/bc.py` (behavior cloning = MARWIL with
beta=0) and `rllib/algorithms/marwil/marwil.py` — train from an offline
dataset (`config.offline_data(input_=...)`) instead of env runners;
MARWIL weights the log-likelihood by exponentiated advantages
(exp(beta * (G - V))) and regresses V toward the Monte-Carlo return.
The env in the config is used only for `evaluate()` rollouts.

Port of `ray_tpu/rllib/algorithms/bc.py`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner, _take
from ray_tpu_torch.rllib.core.rl_module import Columns
from ray_tpu_torch.rllib.offline.io import JsonReader


def offline_batch(episodes, gamma: float) -> Dict[str, np.ndarray]:
    """Columnar batch with discounted returns-to-go as VALUE_TARGETS.

    Truncated episodes bootstrap nothing (reference MARWIL also uses raw
    Monte-Carlo returns from the logged data)."""
    obs, actions, returns = [], [], []
    for ep in episodes:
        if not ep.length:
            continue
        r = np.asarray(ep.rewards, np.float32)
        g = np.zeros_like(r)
        acc = 0.0
        for t in range(len(r) - 1, -1, -1):
            acc = r[t] + gamma * acc
            g[t] = acc
        obs.append(np.stack(ep.obs))
        actions.append(np.asarray(ep.actions))
        returns.append(g)
    return {
        Columns.OBS: np.concatenate(obs).astype(np.float32),
        Columns.ACTIONS: np.concatenate(actions),
        Columns.VALUE_TARGETS: np.concatenate(returns),
    }


class MARWILLearner(Learner):
    """Advantage-weighted log-likelihood + value regression.

    beta=0 degenerates to plain behavior cloning (the reference makes BC
    exactly this: `bc.py` subclasses MARWIL with beta forced to 0)."""

    def compute_loss(self, batch):
        out = self.module.forward_train(batch)
        logits = out[Columns.ACTION_DIST_INPUTS]
        logp_all = torch.log_softmax(logits, -1)
        logp = _take(logp_all, batch[Columns.ACTIONS])
        beta = self.config.get("beta", 0.0)
        if beta:
            values = out[Columns.VF_PREDS]
            targets = batch[Columns.VALUE_TARGETS]
            adv = (targets - values).detach()
            # clip the exponent for numerical safety (reference clips
            # advantages via a moving norm estimate)
            w = torch.exp(torch.clamp(beta * adv, -10.0, 10.0))
            policy_loss = -(w * logp).mean()
            vf_loss = ((values - targets) ** 2).mean()
        else:
            policy_loss = -logp.mean()
            vf_loss = logits.new_zeros(())
        probs = torch.softmax(logits, -1)
        entropy = -(probs * logp_all).sum(-1).mean()
        loss = policy_loss \
            + self.config.get("vf_loss_coeff", 1.0) * vf_loss \
            - self.config.get("entropy_coeff", 0.0) * entropy
        return loss, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                      "entropy": entropy}


class MARWILConfig(AlgorithmConfig):
    def __init__(self, algo_class: type = None):
        super().__init__(algo_class or MARWIL)
        self.lr = 1e-3
        self.train_batch_size = 2000
        self.minibatch_size = 256
        self.num_epochs = 1
        self.extra.update({
            "beta": 1.0,
            "vf_loss_coeff": 1.0,
            "entropy_coeff": 0.0,
        })


class BCConfig(MARWILConfig):
    def __init__(self, algo_class: type = None):
        super().__init__(algo_class or BC)
        self.extra["beta"] = 0.0


class MARWIL(Algorithm):
    learner_cls = MARWILLearner
    config_cls = MARWILConfig

    def setup(self, config: Dict[str, Any]) -> None:
        super().setup(config)
        cfg = self.algo_config
        if not cfg.input_:
            raise ValueError(
                "offline algorithms need config.offline_data(input_=...)")
        self.reader = JsonReader(cfg.input_, seed=cfg.seed)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        episodes = self.reader.sample_episodes(cfg.train_batch_size)
        batch = offline_batch(episodes, cfg.gamma)
        n = batch[Columns.ACTIONS].shape[0]
        rng = np.random.default_rng(cfg.seed + self._iteration)
        stats: Dict[str, float] = {}
        num_mb = 0
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
                num_mb += 1
        out = {k: v / max(1, num_mb) for k, v in stats.items()}
        out["num_offline_steps_trained"] = int(n)
        return out


class BC(MARWIL):
    """Behavior cloning = MARWIL with beta pinned to 0 (the reference's
    `bc.py` validates exactly this relationship)."""

    learner_cls = MARWILLearner
    config_cls = BCConfig

    def setup(self, config: Dict[str, Any]) -> None:
        super().setup(config)
        if self.algo_config.extra.get("beta", 0.0) != 0.0:
            raise ValueError("BC requires beta=0; use MARWIL for beta>0")
