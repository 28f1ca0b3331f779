"""ray_tpu_torch.rllib.offline — offline RL: episode IO + off-policy
estimators. Port of `ray_tpu/rllib/offline/`.

Reference: `rllib/offline/` — `json_writer.py` / `json_reader.py`
(episode shards on disk), `is_estimator.py` / `wis_estimator.py`
(off-policy value estimation), consumed by BC/MARWIL/CQL and by
`Algorithm.evaluate()` with `off_policy_estimation_methods`.
"""

from ray_tpu_torch.rllib.offline.io import JsonReader, JsonWriter
from ray_tpu_torch.rllib.offline.estimators import (
    ImportanceSampling,
    OffPolicyEstimator,
    WeightedImportanceSampling,
)

__all__ = [
    "JsonReader", "JsonWriter", "OffPolicyEstimator",
    "ImportanceSampling", "WeightedImportanceSampling",
]
