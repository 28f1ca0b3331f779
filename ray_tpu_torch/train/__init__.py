"""ray_tpu_torch.train — the single-process train plane: `TrainStepRunner`
(a train step as one captured CUDA graph, or K steps as one with
``steps_per_call``) and `array_checkpoint` (the carry's checkpoints in
the JAX package's format). The trainers, the session and the worker
group need the runtime and come with ROADMAP S4d."""

from ray_tpu_torch.train import array_checkpoint
from ray_tpu_torch.train.trainer import TrainStepRunner

__all__ = ["TrainStepRunner", "array_checkpoint"]
