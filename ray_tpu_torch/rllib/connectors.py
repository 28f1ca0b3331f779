"""ConnectorV2 pipelines — episodes → train batch.

Port of `ray_tpu/rllib/connectors.py`: numpy, as there. GAE bootstraps
open fragments through the module's `forward_inference`, after loading
the learner's weights into it, in one batched pass over the fragments
that need it.

Reference: `rllib/connectors/connector_v2.py:18` and the learner-pipeline
GAE connector (`rllib/connectors/learner/
general_advantage_estimation.py`). Kept as plain composable callables:
each connector takes and returns the (episodes, batch) pair.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from ray_tpu_torch.rllib.core.rl_module import Columns
from ray_tpu_torch.rllib.env.env_runner import Episode

Batch = Dict[str, np.ndarray]


class ConnectorPipeline:
    def __init__(self, connectors: List[Callable]):
        self.connectors = list(connectors)

    def __call__(self, episodes: List[Episode], batch: Batch) -> Batch:
        for c in self.connectors:
            batch = c(episodes, batch)
        return batch


def columns_from_episodes(episodes: List[Episode], batch: Batch) -> Batch:
    """Flatten episode fragments into columnar arrays."""
    batch[Columns.OBS] = np.concatenate(
        [np.stack(ep.obs) for ep in episodes]).astype(np.float32)
    batch[Columns.ACTIONS] = np.concatenate(
        [np.asarray(ep.actions) for ep in episodes])
    batch[Columns.REWARDS] = np.concatenate(
        [np.asarray(ep.rewards, np.float32) for ep in episodes])
    batch[Columns.ACTION_LOGP] = np.concatenate(
        [np.asarray(ep.logps, np.float32) for ep in episodes])
    batch[Columns.VF_PREDS] = np.concatenate(
        [np.asarray(ep.vf_preds, np.float32) for ep in episodes])
    return batch


class GAE:
    """Generalized advantage estimation over episode fragments.

    Reference: the learner GAE connector + `rllib/evaluation/
    postprocessing.py` compute_advantages. Truncated/open fragments are
    bootstrapped with the module's value of `last_obs`."""

    def __init__(self, gamma: float = 0.99, lambda_: float = 0.95,
                 module=None, params_getter: Callable = None):
        self.gamma = gamma
        self.lambda_ = lambda_
        self.module = module
        self.params_getter = params_getter

    def _bootstrap_values(self, episodes: List[Episode],
                          params) -> np.ndarray:
        """The module's value of each open fragment's `last_obs` (0 for
        terminated episodes, or without a module or weights)."""
        boot = np.zeros(len(episodes), np.float32)
        if self.module is None or params is None:
            return boot
        need = [i for i, ep in enumerate(episodes) if not ep.terminated]
        if need:
            self.module.set_weights(params)
            obs = np.stack([episodes[i].last_obs for i in need])
            out = self.module.forward_inference(
                torch.from_numpy(obs.astype(np.float32)))
            boot[need] = out[Columns.VF_PREDS].cpu().numpy()
        return boot

    def __call__(self, episodes: List[Episode], batch: Batch) -> Batch:
        # fetch weights once per batch — in remote-learner mode the
        # getter is an actor round-trip
        params = (self.params_getter()
                  if self.params_getter is not None else None)
        boot = self._bootstrap_values(episodes, params)
        advs, targets = [], []
        for ep, last_v in zip(episodes, boot.tolist()):
            rewards = np.asarray(ep.rewards, np.float32)
            values = np.asarray(ep.vf_preds, np.float32)
            next_values = np.append(values[1:], last_v)
            deltas = rewards + self.gamma * next_values - values
            adv = np.zeros_like(deltas)
            acc = 0.0
            for t in range(len(deltas) - 1, -1, -1):
                acc = deltas[t] + self.gamma * self.lambda_ * acc
                adv[t] = acc
            advs.append(adv)
            targets.append(adv + values)
        batch[Columns.ADVANTAGES] = np.concatenate(advs)
        batch[Columns.VALUE_TARGETS] = np.concatenate(targets)
        return batch


def standardize_advantages(episodes: List[Episode], batch: Batch) -> Batch:
    adv = batch[Columns.ADVANTAGES]
    batch[Columns.ADVANTAGES] = (adv - adv.mean()) / \
        max(1e-6, adv.std())
    return batch


def sequence_batch(episodes: List[Episode], max_len: int = 0) -> Batch:
    """Pad episode fragments into [B, T] row-major arrays with a
    validity mask — the layout V-trace needs (reference: IMPALA's
    learner queue batches of trajectories). Episodes longer than T are
    SPLIT into chained rows (never truncated): each non-final chunk
    bootstraps from the next chunk's first observation, the final chunk
    carries the episode's own terminated flag and last_obs.
    """
    T = max_len or max(ep.length for ep in episodes)
    rows = []  # (slice of ep, terminated, bootstrap_obs)
    for ep in episodes:
        for start in range(0, ep.length, T):
            end = min(start + T, ep.length)
            final = end == ep.length
            boot = (ep.last_obs if ep.last_obs is not None
                    else ep.obs[-1]) if final else ep.obs[end]
            rows.append((ep, start, end,
                         ep.terminated and final, boot))
    B = len(rows)
    obs_dim = episodes[0].obs[0].shape[-1]
    obs = np.zeros((B, T, obs_dim), np.float32)
    actions = np.zeros((B, T), np.int64)
    rewards = np.zeros((B, T), np.float32)
    logp = np.zeros((B, T), np.float32)
    mask = np.zeros((B, T), np.float32)
    terminated = np.zeros((B,), np.float32)
    last_obs = np.zeros((B, obs_dim), np.float32)
    for b, (ep, start, end, term, boot) in enumerate(rows):
        n = end - start
        obs[b, :n] = np.stack(ep.obs[start:end])
        actions[b, :n] = ep.actions[start:end]
        rewards[b, :n] = ep.rewards[start:end]
        logp[b, :n] = ep.logps[start:end]
        mask[b, :n] = 1.0
        terminated[b] = float(term)
        last_obs[b] = boot
    return {
        Columns.OBS: obs, Columns.ACTIONS: actions,
        Columns.REWARDS: rewards, Columns.ACTION_LOGP: logp,
        "mask": mask, Columns.TERMINATEDS: terminated,
        "last_obs": last_obs,
    }
