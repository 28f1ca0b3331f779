"""Run/scaling/failure/checkpoint configs shared by Train and Tune.

Port of `ray_tpu/air/config.py` (reference: `python/ray/air/config.py` —
`ScalingConfig` (:103), `FailureConfig` (:395), `CheckpointConfig`
(:445), `RunConfig` (:594)). Differences from the JAX package, kept on
purpose:

- `ScalingConfig.use_gpu` / `gpus_per_worker` take the place of
  `use_tpu` / `tpus_per_worker`: a worker's accelerators are the runtime's
  `GPU` resource (CUDA devices). `topology`, `num_slices`, `mesh_axes` and
  `mesh_shape` are carried as in the JAX package, which reads the mesh
  fields nowhere either: a training loop builds its mesh over the
  workers' process group (`ray_tpu_torch.parallel.ShardingStrategy.
  build_mesh`).
- `RunConfig`'s default storage is ``~/ray_tpu_torch_results`` (the JAX
  package's is ``~/ray_tpu_results``; both read ``RAY_TPU_RESULTS_DIR``
  first), so runs of the two packages never share a trial directory.
- Placement-group bundles are one per worker with its GPU count, the
  reference's worker-bundle layout
  (`python/ray/train/_internal/backend_executor.py:206-256`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class ScalingConfig:
    """How many train workers, and what each one holds.

    num_workers: worker actors (one torch process each).
    use_gpu: give each worker GPUs (CUDA devices).
    resources_per_worker: explicit per-worker resources; defaults to
        ``{"CPU": 1}`` plus ``{"GPU": gpus_per_worker}`` when ``use_gpu``.
    gpus_per_worker: GPUs per worker (default 1 with ``use_gpu``).
    mesh_axes / mesh_shape: the global device-mesh the trainer should build
        across all workers' devices, e.g. axes ``("dp", "tp")`` shape
        ``(8, 4)``. ``None`` → pure DP over all devices.
    placement_strategy: PG strategy (PACK default, like the reference).
    """

    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: int = 0
    resources_per_worker: Optional[Dict[str, float]] = None
    mesh_axes: Optional[Tuple[str, ...]] = None
    mesh_shape: Optional[Tuple[int, ...]] = None
    placement_strategy: str = "PACK"
    trainer_resources: Optional[Dict[str, float]] = None
    # slice topology (labelled raylets): gang-place one worker per host
    # of a single complete slice, atomically — num_workers must equal the
    # slice's host count (x num_slices for multislice). See
    # scheduling.place_slice_bundles.
    topology: Optional[str] = None
    # Multislice (the reference's pod convention,
    # python/ray/_private/accelerators/tpu.py:363-388): place one atomic
    # gang per slice, num_slices gangs total. Workers split evenly across
    # slices in rank order.
    num_slices: int = 1
    # how long fit() waits for the gang placement before failing
    pg_timeout_s: float = 120.0

    def _worker_resources(self) -> Dict[str, float]:
        if self.resources_per_worker is not None:
            return dict(self.resources_per_worker)
        res: Dict[str, float] = {"CPU": 1.0}
        if self.use_gpu:
            res["GPU"] = float(self.gpus_per_worker or 1)
        return res

    @property
    def num_gpus_per_worker(self) -> float:
        return self._worker_resources().get("GPU", 0.0)

    @property
    def workers_per_slice(self) -> int:
        if self.num_slices <= 1:
            return self.num_workers
        if self.num_workers % self.num_slices != 0:
            raise ValueError(
                f"num_workers={self.num_workers} must divide evenly "
                f"across num_slices={self.num_slices}")
        return self.num_workers // self.num_slices

    def bundles(self) -> List[Dict[str, float]]:
        """One bundle per worker (+ a zero-CPU trainer bundle is implicit).
        For multislice this is ONE slice's worth — the executor creates
        num_slices placement groups from it."""
        n = self.workers_per_slice if self.num_slices > 1 else self.num_workers
        return [self._worker_resources() for _ in range(n)]

    def total_bundles(self) -> List[Dict[str, float]]:
        return [self._worker_resources() for _ in range(self.num_workers)]

    def total_resources(self) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for b in self.total_bundles():
            for k, v in b.items():
                total[k] = total.get(k, 0.0) + v
        return total


@dataclasses.dataclass
class FailureConfig:
    """Trial-level retry policy (reference `air/config.py:395`).

    max_failures: retries after a worker/trial crash. 0 = no retries,
        -1 = infinite.
    """

    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    """Keep-top-K policy (reference `air/config.py:445`)."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0
    checkpoint_at_end: Optional[bool] = None

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")


@dataclasses.dataclass
class RunConfig:
    """Experiment-level config (reference `air/config.py:594`)."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None
    stop: Optional[Any] = None
    verbose: int = 0
    log_to_file: bool = False
    callbacks: Optional[List[Any]] = None

    def __post_init__(self):
        if self.storage_path is None:
            self.storage_path = os.path.expanduser(
                os.environ.get("RAY_TPU_RESULTS_DIR", "~/ray_tpu_torch_results")
            )
        if self.failure_config is None:
            self.failure_config = FailureConfig()
        if self.checkpoint_config is None:
            self.checkpoint_config = CheckpointConfig()
