"""Backend executor: placement group + worker fleet + collective bootstrap.

Reference: `python/ray/train/_internal/backend_executor.py:66` —
`start` (:124) creates the placement group (:206-256) and the worker
actors; `start_training` (:436) initializes sessions and launches the
user loop; `get_next_results` polls workers in lockstep.

Port of `ray_tpu/train/_internal/backend_executor.py`, unchanged but for
the imports: `Backend.on_start` joins the workers in the backend's
rendezvous (`TorchConfig`: a `torch.distributed` process group), and a
worker's GPUs are the raylet's `CUDA_VISIBLE_DEVICES` grant at spawn.
Datasets without ``streaming_split`` pass through whole.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.train._internal.session import SessionConfig
from ray_tpu_torch.train._internal.worker_group import WorkerGroup
from ray_tpu_torch.train.backend import Backend, BackendConfig


class TrainingFailedError(RuntimeError):
    pass


class BackendExecutor:
    def __init__(self, backend_config: BackendConfig,
                 scaling_config: ScalingConfig,
                 experiment_name: str = "train",
                 storage_path: str = "/tmp/ray_tpu_torch_results",
                 trial_id: str = "default"):
        self.backend_config = backend_config
        self.backend: Backend = backend_config.backend_cls()
        self.scaling = scaling_config
        self.experiment_name = experiment_name
        self.storage_path = storage_path
        self.trial_id = trial_id
        self.worker_group: Optional[WorkerGroup] = None
        self.pg = None
        self.pgs: list = []
        self._finished_workers: set[int] = set()
        self._errors: Dict[int, str] = {}
        # ranks whose last report awaits the gang-commit ack: (rank, index)
        self._pending_commit: list[tuple[int, int]] = []

    # -- lifecycle ---------------------------------------------------------

    def start(self, timeout: float | None = None) -> None:
        if timeout is None:
            timeout = self.scaling.pg_timeout_s
        bundles = self.scaling.bundles()
        # topology= gang-places one worker bundle per host of a single
        # complete slice, all-or-nothing.
        # Multislice: one atomic gang PER SLICE — num_slices placement
        # groups, each a complete slice (the reference's pod-head
        # convention generalized, accelerators/tpu.py:363-388).
        n_slices = max(1, self.scaling.num_slices)
        self.pgs = [
            ray_tpu_torch.placement_group(
                bundles, strategy=self.scaling.placement_strategy,
                topology=self.scaling.topology)
            for _ in range(n_slices)
        ]
        self.pg = self.pgs[0]
        deadline = time.monotonic() + timeout
        for i, pg in enumerate(self.pgs):
            if not pg.ready(timeout=max(0.0, deadline - time.monotonic())):
                raise TrainingFailedError(
                    f"placement group {i + 1}/{n_slices} with bundles "
                    f"{bundles} "
                    + (f"on slice topology {self.scaling.topology!r} "
                       if self.scaling.topology else "")
                    + f"not placeable within {timeout}s (cluster "
                    f"resources: {ray_tpu_torch.cluster_resources()})")
        self.worker_group = WorkerGroup(
            self.scaling.num_workers,
            self.scaling._worker_resources(),
            placement_group=self.pgs if n_slices > 1 else self.pg,
            worker_env=self.backend_config.worker_env(),
        )
        # Rank assignment: sort by (hostname, pid) for stable local ranks
        # (reference sorts by node IP to group local workers).
        metas = ray_tpu_torch.get(
            [w.get_metadata.remote() for w in self.worker_group.workers],
            timeout=timeout)
        self._metas = metas
        self.backend.on_start(self.worker_group, self.backend_config)

    def start_training(
        self,
        train_fn: Callable,
        config: Optional[Dict[str, Any]] = None,
        datasets: Optional[Dict[str, Any]] = None,
        checkpoint: Optional[Checkpoint] = None,
    ) -> None:
        assert self.worker_group is not None, "call start() first"
        wg = self.worker_group
        hosts = sorted({m["hostname"] for m in self._metas})
        node_rank = {h: i for i, h in enumerate(hosts)}
        local_counts: Dict[str, int] = {}
        trial_dir = os.path.join(self.storage_path, self.experiment_name,
                                 self.trial_id)
        init_refs = []
        for rank, (w, meta) in enumerate(zip(wg.workers, self._metas)):
            host = meta["hostname"]
            local_rank = local_counts.get(host, 0)
            local_counts[host] = local_rank + 1
            cfg = SessionConfig(
                experiment_name=self.experiment_name,
                storage_path=self.storage_path,
                world_rank=rank,
                world_size=len(wg),
                local_rank=local_rank,
                local_world_size=0,  # patched below
                node_rank=node_rank[host],
                slice_rank=wg.slice_rank(rank),
                num_slices=wg.num_slices,
                trial_id=self.trial_id,
                trial_dir=trial_dir,
                checkpoint=checkpoint,
                gang_commit=True,
            )
            init_refs.append((w, cfg))
        total_local = dict(local_counts)
        refs = []
        for (w, cfg) in init_refs:
            cfg.local_world_size = total_local[
                self._metas[cfg.world_rank]["hostname"]]
            refs.append(w.init_session.remote(cfg))
        ray_tpu_torch.get(refs, timeout=60)

        if datasets:
            self._assign_dataset_shards(datasets)

        self.backend.on_training_start(wg, self.backend_config)
        ray_tpu_torch.get([w.start_training.remote(train_fn, config or {})
                     for w in wg.workers], timeout=60)
        self._finished_workers = set()
        self._errors = {}
        self._pending_commit = []

    def _assign_dataset_shards(self, datasets: Dict[str, Any]) -> None:
        """Split each dataset across workers.

        Datasets with a ``streaming_split`` method (a Data dataset)
        are split per-worker; anything else is passed through whole.
        Reference: `python/ray/train/_internal/data_config.py`.
        """
        wg = self.worker_group
        per_worker: List[Dict[str, Any]] = [dict() for _ in range(len(wg))]
        for name, ds in datasets.items():
            if hasattr(ds, "streaming_split"):
                shards = ds.streaming_split(len(wg))
                for i, sh in enumerate(shards):
                    per_worker[i][name] = sh
            else:
                for i in range(len(wg)):
                    per_worker[i][name] = ds
        ray_tpu_torch.get([w.set_dataset_shards.remote(per_worker[i])
                     for i, w in enumerate(wg.workers)], timeout=60)

    # -- result pump -------------------------------------------------------

    def get_next_results(self, timeout: float = 600.0
                         ) -> Optional[List[Dict[str, Any]]]:
        """Block until every live worker reports once (or finishes).

        Returns the list of per-worker report dicts, or None when all
        workers have finished. Raises TrainingFailedError if any worker's
        train fn raised.
        """
        assert self.worker_group is not None
        wg = self.worker_group
        results: Dict[int, Dict[str, Any]] = {}
        deadline = time.monotonic() + timeout
        pending = [i for i in range(len(wg))
                   if i not in self._finished_workers]
        if not pending:
            return None
        while pending:
            if time.monotonic() > deadline:
                raise TrainingFailedError(
                    f"workers {pending} produced no result within {timeout}s")
            refs = {i: wg.workers[i].next_result.remote(5.0) for i in pending}
            try:
                got = ray_tpu_torch.get(list(refs.values()), timeout=60.0)
            except (ray_tpu_torch.ActorDiedError, ray_tpu_torch.RayTaskError,
                    ray_tpu_torch.GetTimeoutError) as e:
                # A worker actor dying must route through the same
                # retry-from-checkpoint path as a train-fn exception —
                # FailureConfig(max_failures) covers actual crashes too.
                raise TrainingFailedError(
                    f"train worker died or stopped responding: {e}") from e
            still = []
            for i, item in zip(pending, got):
                if item is None:
                    still.append(i)
                elif item.get("_finished"):
                    self._finished_workers.add(i)
                    if item.get("_error"):
                        self._errors[i] = item["_error"]
                        raise TrainingFailedError(
                            f"train worker rank={i} failed:\n{item['_error']}")
                else:
                    results[i] = item
                    if item.get("gang_commit"):
                        # the rank is now blocked in report()'s commit
                        # barrier; released by commit_gang_checkpoint()
                        # once the controller registered the checkpoint
                        self._pending_commit.append(
                            (i, item["report_index"]))
            pending = still
            if results and all(
                (i in results or i in self._finished_workers)
                for i in range(len(wg))
            ):
                break
        if not results:
            return None
        return [results[i] for i in sorted(results)]

    def commit_gang_checkpoint(self, timeout: float = 60.0) -> None:
        """Second half of the gang-durable commit: release every rank
        blocked in report()'s barrier. Called by the controller AFTER it
        registered the checkpoint — at that point every rank's shard is
        durable (each rank persists before enqueueing its report, and
        the barrier only arms once get_next_results collected the report
        from every live rank), so report() may return everywhere. No-op
        when no checkpoint report is pending."""
        pending, self._pending_commit = self._pending_commit, []
        if not pending or self.worker_group is None:
            return
        wg = self.worker_group
        refs = [wg.workers[i].ack_commit.remote(idx) for i, idx in pending]
        for ref in refs:
            try:
                ray_tpu_torch.get(ref, timeout=timeout)
            except Exception:  # noqa: BLE001 — ack delivery is best-effort
                # The ack released the rank BEFORE its reply frame went
                # out, so a rank that exits immediately after resuming
                # (elastic tests, real preemption) can die mid-reply.
                # The checkpoint is already registered — the commit
                # happened — and worker death is adjudicated by the next
                # get_next_results poll; surfacing the delivery error
                # here would turn a committed step into a spurious
                # trial-level failure that skips the train-level
                # walk-back.
                continue

    def pause_reporting(self) -> None:
        pass

    def shutdown(self) -> None:
        self._pending_commit = []
        if self.worker_group is not None:
            try:
                self.backend.on_shutdown(self.worker_group,
                                         self.backend_config)
            except Exception:
                pass
            self.worker_group.shutdown()
            self.worker_group = None
        for pg in getattr(self, "pgs", None) or ([self.pg] if self.pg else []):
            try:
                ray_tpu_torch.remove_placement_group(pg)
            except Exception:
                pass
        self.pg = None
        self.pgs = []
