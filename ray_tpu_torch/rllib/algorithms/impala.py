"""IMPALA — importance-weighted actor-learner architecture.

Reference: `rllib/algorithms/impala/impala.py` — decoupled acting and
learning: env runners sample with weights that lag the learner, and the
V-trace corrections (`vtrace_tf.py`, rebuilt as `vtrace_returns`)
make the off-policy updates sound. Here the lag is explicit:
weights broadcast to the runners every `broadcast_interval` iterations,
so between broadcasts the learner trains on behavior-stale trajectories
exactly as the asynchronous reference does.

Port of `ray_tpu/rllib/algorithms/impala.py`, unchanged but for the
imports.
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.connectors import sequence_batch
from ray_tpu_torch.rllib.core.learner import IMPALALearner


class IMPALAConfig(AlgorithmConfig):
    def __init__(self, algo_class: type = None):
        super().__init__(algo_class or IMPALA)
        self.lr = 5e-4
        self.train_batch_size = 500  # env steps per iteration
        self.rollout_fragment_length = 50
        self.extra.update({
            "vtrace_rho_clip": 1.0,
            "vtrace_c_clip": 1.0,
            "vf_loss_coeff": 0.5,
            "entropy_coeff": 0.01,
            "broadcast_interval": 2,  # iterations between weight syncs
            # SGD passes per sampled batch (reference: replay-capable
            # learner queue; v-trace re-corrects against the updated
            # policy on every pass)
            "num_updates_per_batch": 2,
        })


class IMPALA(Algorithm):
    learner_cls = IMPALALearner
    config_cls = IMPALAConfig

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        episodes = [
            ep for ep in self.env_runner_group.sample(
                cfg.train_batch_size)
            if ep.length
        ]
        self.record_episodes(episodes)
        batch = sequence_batch(episodes,
                               max_len=cfg.rollout_fragment_length)
        for _ in range(cfg.extra["num_updates_per_batch"]):
            stats = self.learner_group.update_from_batch(batch)
        # decoupled acting: runners keep sampling with stale weights
        # between broadcasts (v-trace corrects the lag)
        if self._iteration % cfg.extra["broadcast_interval"] == 0:
            self.env_runner_group.sync_weights(
                self.learner_group.get_weights())
        stats["num_env_steps_sampled"] = int(
            sum(ep.length for ep in episodes))
        return stats
