"""ray_tpu_torch.train — the distributed training harness.

Port of `ray_tpu/train/__init__.py`, with the same public names but
`TorchConfig` / `TorchTrainer` in place of `JaxConfig` / `JaxTrainer`:
trainers (`TorchTrainer`, `DataParallelTrainer`) that run a training
loop on a gang of worker actors under a one-trial Tune run, the
per-worker session API (`report`, `get_checkpoint`, `get_context`,
`get_dataset_shard`), configs, `Checkpoint`, `TrainStepRunner` (a train
step as one captured CUDA graph, or K steps as one) and
`array_checkpoint` (the carry's checkpoints in the JAX package's format).

Importing this package does not import torch: the train controller and
Tune's trial actors run without it; the workers' training loops and the
runner's methods import it.
"""

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train._internal.session import (
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
)
from ray_tpu_torch.train import array_checkpoint
from ray_tpu_torch.train._internal.backend_executor import TrainingFailedError
from ray_tpu_torch.train.backend import Backend, BackendConfig, TorchConfig
from ray_tpu_torch.train.trainer import (
    BaseTrainer,
    DataParallelTrainer,
    TorchTrainer,
    TrainStepRunner,
)

__all__ = [
    "array_checkpoint",
    "Backend",
    "BackendConfig",
    "BaseTrainer",
    "Checkpoint",
    "CheckpointConfig",
    "DataParallelTrainer",
    "FailureConfig",
    "TorchConfig",
    "TrainingFailedError",
    "TorchTrainer",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TrainContext",
    "TrainStepRunner",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "report",
]
