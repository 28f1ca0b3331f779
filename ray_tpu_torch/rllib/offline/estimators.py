"""Off-policy estimators: evaluate a target policy on behavior data.

Reference: `rllib/offline/estimators/` — `ImportanceSampling`
(`is_estimator.py`) and `WeightedImportanceSampling`
(`wis_estimator.py`) compute per-step importance-weighted returns of
the target policy from episodes recorded under a (logged) behavior
policy. Target log-probs come from one batched `forward_train` pass per
episode.

Port of `ray_tpu/rllib/offline/estimators.py`: the target policy is the
port's RLModule and its weights (``{name: array}``), loaded into the
module before each estimate.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch.rllib.core.rl_module import Columns, RLModule
from ray_tpu_torch.rllib.env.env_runner import Episode


class OffPolicyEstimator:
    """Base: holds the target policy (module + params) and gamma."""

    def __init__(self, module: RLModule, params: Any,
                 gamma: float = 0.99):
        self.module = module
        self.params = {k: np.asarray(v) for k, v in params.items()}
        self.gamma = gamma

    def _target_logps(self, ep: Episode) -> np.ndarray:
        obs = np.stack(ep.obs).astype(np.float32)
        with torch.no_grad():
            out = self.module.forward_train(
                {Columns.OBS: torch.from_numpy(obs)})
        logits = out[Columns.ACTION_DIST_INPUTS].numpy()
        logp_all = logits - _logsumexp(logits)
        return logp_all[np.arange(len(ep.actions)), ep.actions]

    def _stepwise_weights(self, episodes: List[Episode], max_t: int
                          ) -> np.ndarray:
        """[N, T] cumulative importance ratios prod_{t'<=t} pi/mu, padded
        by carrying the final weight forward (episodes shorter than T
        contribute their terminal weight, matching the reference's
        per-step estimators)."""
        self.module.set_weights(self.params)
        w = np.zeros((len(episodes), max_t), np.float64)
        for i, ep in enumerate(episodes):
            ratios = np.exp(
                self._target_logps(ep)
                - np.asarray(ep.logps, np.float64))
            cum = np.cumprod(ratios)
            w[i, :len(cum)] = cum
            if len(cum) < max_t:
                w[i, len(cum):] = cum[-1]
        return w

    @staticmethod
    def _padded_rewards(episodes: List[Episode], max_t: int) -> np.ndarray:
        r = np.zeros((len(episodes), max_t), np.float64)
        for i, ep in enumerate(episodes):
            r[i, :ep.length] = ep.rewards
        return r

    def estimate(self, episodes: List[Episode]) -> Dict[str, float]:
        raise NotImplementedError


def _logsumexp(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=-1, keepdims=True))


class ImportanceSampling(OffPolicyEstimator):
    """Per-step (ordinary) IS: V = E_n[ sum_t gamma^t w_{n,t} r_{n,t} ].

    Unbiased but high-variance (reference `is_estimator.py`)."""

    def estimate(self, episodes: List[Episode]) -> Dict[str, float]:
        max_t = max(ep.length for ep in episodes)
        w = self._stepwise_weights(episodes, max_t)
        r = self._padded_rewards(episodes, max_t)
        disc = self.gamma ** np.arange(max_t)
        v_target = float(np.mean((w * r * disc[None, :]).sum(axis=1)))
        v_behavior = float(np.mean((r * disc[None, :]).sum(axis=1)))
        return {
            "v_behavior": v_behavior,
            "v_target": v_target,
            "v_gain": v_target / v_behavior if v_behavior else float("nan"),
        }


class WeightedImportanceSampling(OffPolicyEstimator):
    """Per-step WIS: weights normalized by their mean at each step —
    biased, much lower variance (reference `wis_estimator.py`)."""

    def estimate(self, episodes: List[Episode]) -> Dict[str, float]:
        max_t = max(ep.length for ep in episodes)
        w = self._stepwise_weights(episodes, max_t)
        r = self._padded_rewards(episodes, max_t)
        w_mean = w.mean(axis=0, keepdims=True)
        w_norm = np.where(w_mean > 0, w / w_mean, 0.0)
        disc = self.gamma ** np.arange(max_t)
        v_target = float(np.mean((w_norm * r * disc[None, :]).sum(axis=1)))
        v_behavior = float(np.mean((r * disc[None, :]).sum(axis=1)))
        return {
            "v_behavior": v_behavior,
            "v_target": v_target,
            "v_gain": v_target / v_behavior if v_behavior else float("nan"),
        }
