"""APPO — asynchronous PPO: IMPALA's actor-learner loop with PPO's
clipped surrogate on V-trace-corrected advantages.

Reference: `rllib/algorithms/appo/appo.py` (+ the torch learner's
clipped loss over vtrace advantages). Reuses this repo's IMPALA
machinery end to end — same sequence batches, same `vtrace_returns`,
same stale-weight broadcasting — and swaps only the policy surrogate
(the `_policy_loss` hook on IMPALALearner), which tolerates more
policy lag per sampled batch (hence more SGD passes than IMPALA's
default).

Port of `ray_tpu/rllib/algorithms/appo.py`.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.core.learner import IMPALALearner


class APPOLearner(IMPALALearner):
    """V-trace targets + PPO clip on the importance ratio."""

    def _policy_loss(self, target_logp, behavior_logp, pg_adv, mask, n):
        ratio = torch.exp(target_logp - behavior_logp)
        clip_eps = self.config.get("clip_param", 0.2)
        surrogate = torch.minimum(
            ratio * pg_adv,
            torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * pg_adv)
        return (-(surrogate * mask).sum() / n,
                {"mean_ratio": (ratio * mask).sum() / n})


class APPOConfig(IMPALAConfig):
    def __init__(self, algo_class: type = None):
        super().__init__(algo_class or APPO)
        self.extra.update({
            "clip_param": 0.2,
            # the clip objective tolerates more reuse of a sampled
            # batch than IMPALA's plain pg term
            "num_updates_per_batch": 4,
        })


class APPO(IMPALA):
    learner_cls = APPOLearner
    config_cls = APPOConfig
