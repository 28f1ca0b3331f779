"""Per-worker train session: the report/checkpoint channel.

Port of `ray_tpu/train/_internal/session.py`, unchanged but for the
imports (the port's fault-injection plane and step profiler).

Reference: `python/ray/train/_internal/session.py` — `_TrainSession`
(:110), `report` (:402/:666), `get_checkpoint` (:753). The session runs the
user's `train_loop_per_worker` on a background thread inside the train
worker actor; `report()` synchronizes with the controller by blocking until
the controller has consumed the previous result (queue of size 1, matching
the reference's back-to-back report semantics).

Checkpoint reports are additionally a GANG BARRIER when the session is
configured with `gang_commit` (Train worker sessions): `report(checkpoint=)`
does not return on any rank until every rank's shard contribution is
durable and the controller has registered the checkpoint — the
persist-before-return semantics of the reference's
`StorageContext.persist_current_checkpoint`
(`python/ray/train/_internal/storage.py:349`), extended across the gang so
elastic walk-back always lands on a checkpoint the whole gang committed.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import shutil
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch._private import fault_injection as _fi
from ray_tpu_torch.air.checkpoint import Checkpoint


@dataclasses.dataclass
class SessionConfig:
    experiment_name: str
    storage_path: str          # experiment dir on the shared filesystem
    world_rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    node_rank: int
    # multislice: which slice this worker's gang occupies, and how
    # many slices the run spans
    slice_rank: int = 0
    num_slices: int = 1
    trial_id: str = "default"
    trial_dir: str = ""        # {storage_path}/{trial_id}
    checkpoint: Optional[Checkpoint] = None   # restore-from
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Gang-durable commit: report(checkpoint=) blocks until the controller
    # has registered the checkpoint and acked every rank (Train worker
    # sessions; Tune trial sessions keep per-worker semantics).
    gang_commit: bool = False


class _TrainSession:
    def __init__(self, config: SessionConfig):
        self.config = config
        self.result_queue: "queue.Queue[dict]" = queue.Queue(maxsize=1)
        self.finished = threading.Event()
        self.error: Optional[BaseException] = None
        self._report_index = 0
        self._last_checkpoint = config.checkpoint
        self.datasets: Dict[str, Any] = {}
        # gang-commit barrier state: highest report index the controller
        # has acked as registered; abort releases blocked reporters
        self._commit_cond = threading.Condition()
        self._commit_index = -1
        self._commit_abort: Optional[str] = None
        os.makedirs(config.trial_dir, exist_ok=True)
        if config.gang_commit:
            # chaos: this process now hosts a GANG train rank — arm
            # train-scoped timed faults (RAY_TPU_CHAOS_LOG
            # once-sentinels keep re-armed plans in restarted attempts
            # from re-firing). Tune trial sessions (gang_commit=False,
            # e.g. the Trainable controller hosting a nested Train run)
            # must NOT arm: the controller would claim the sentinel and
            # the fault would land outside any train rank.
            _fi.set_role("train")

    # called from the user's train-fn thread
    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        persisted_path = None
        index = self._report_index
        if checkpoint is not None:
            if getattr(checkpoint, "_persisted", False):
                # Already in durable trial storage (e.g. Train's controller
                # reporting through the Tune session): pass by reference —
                # a copy here would escape num_to_keep eviction.
                persisted_path = checkpoint.path
            else:
                import time as _time

                from ray_tpu_torch.util import step_profiler as _sp

                if _fi._PLAN is not None:
                    # chaos: injected persist failure (storage fault) —
                    # raises before anything lands, failing the attempt
                    # ahead of the gang commit
                    _fi._PLAN.checkpoint_persist()
                _t0 = _time.perf_counter()
                persisted_path = self._persist_checkpoint(checkpoint)
                # flight recorder: checkpoint persist time folds into
                # the next StepStats record on this (train-fn) thread
                _sp.add_phase_ms(
                    "checkpoint_ms",
                    (_time.perf_counter() - _t0) * 1e3)
            self._last_checkpoint = Checkpoint(persisted_path)
            if _fi._PLAN is not None:
                # chaos window: this rank's shard is durable, the gang
                # commit has not happened — the exact interval the
                # gang-durable guarantee exists to survive
                _fi._PLAN.train_pre_commit(
                    self.config.world_rank, index,
                    fresh=self.config.checkpoint is None)
        needs_commit = checkpoint is not None and self.config.gang_commit
        item = {
            "metrics": dict(metrics),
            "checkpoint_path": persisted_path,
            "report_index": index,
            "world_rank": self.config.world_rank,
        }
        if needs_commit:
            item["gang_commit"] = True
        self._report_index += 1
        # Blocks until the controller drained the previous report — keeps
        # workers in lockstep the way the reference's session does.
        self.result_queue.put(item)
        if needs_commit:
            # Gang-durable commit (reference semantics: persist-before-
            # return, `python/ray/train/_internal/storage.py:349`): do not
            # return on ANY rank until every rank's shard contribution is
            # durable and the controller has registered the checkpoint.
            # The controller only acks after it has collected this report
            # index from every live rank (each rank persists before
            # enqueueing, so collection implies durability) and put the
            # checkpoint in its CheckpointManager — a rank that dies
            # after this point can no longer strand a checkpoint the gang
            # believed committed.
            self._await_commit(index)

    def _await_commit(self, index: int) -> None:
        with self._commit_cond:
            while self._commit_index < index and self._commit_abort is None:
                self._commit_cond.wait(timeout=1.0)
            if self._commit_index < index:
                raise RuntimeError(
                    f"gang checkpoint commit aborted: {self._commit_abort}")

    def ack_commit(self, index: int) -> None:
        """Controller-side ack: the checkpoint of report `index` is
        registered; release the reporter."""
        with self._commit_cond:
            if index > self._commit_index:
                self._commit_index = index
            self._commit_cond.notify_all()

    def abort_commit(self, reason: str) -> None:
        """Release a blocked reporter with an error (session shutdown /
        gang teardown) instead of leaving the train thread wedged."""
        with self._commit_cond:
            self._commit_abort = reason
            self._commit_cond.notify_all()

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self._last_checkpoint

    def _persist_checkpoint(self, checkpoint: Checkpoint) -> str:
        """Move the worker's local checkpoint dir into trial storage.

        Reference: `python/ray/train/_internal/storage.py:349`
        (StorageContext.persist_current_checkpoint) — here storage is a
        shared local filesystem path.
        """
        dest = os.path.join(
            self.config.trial_dir,
            f"checkpoint_{self._report_index:06d}",
        )
        rank_dest = (dest if self.config.world_rank == 0
                     else os.path.join(dest + "_shards",
                                       f"rank_{self.config.world_rank}"))
        checkpoint.to_directory(rank_dest)
        if getattr(checkpoint, "_temp_source", False):
            # from_dict() staged the data in a throwaway tempdir; it has
            # been copied into trial storage, so reclaim it now (long runs
            # would otherwise leak one /tmp dir per report). Re-point the
            # user's object at the persisted copy so it stays readable.
            shutil.rmtree(checkpoint.path, ignore_errors=True)
            checkpoint.path = rank_dest
            checkpoint._temp_source = False
        return dest if self.config.world_rank == 0 else rank_dest


_session_lock = threading.Lock()
_session: Optional[_TrainSession] = None


def init_session(config: SessionConfig) -> _TrainSession:
    global _session
    with _session_lock:
        _session = _TrainSession(config)
        return _session


def get_session() -> Optional[_TrainSession]:
    return _session


def shutdown_session() -> None:
    global _session
    with _session_lock:
        if _session is not None:
            _session.abort_commit("session shutdown")
        _session = None


# ---------------------------------------------------------------------------
# public API surface (`ray_tpu_torch.train.report` etc.)
# ---------------------------------------------------------------------------

class TrainContext:
    """Reference: `python/ray/train/context.py:26`."""

    def get_world_size(self) -> int:
        return _require().config.world_size

    def get_world_rank(self) -> int:
        return _require().config.world_rank

    def get_local_rank(self) -> int:
        return _require().config.local_rank

    def get_local_world_size(self) -> int:
        return _require().config.local_world_size

    def get_node_rank(self) -> int:
        return _require().config.node_rank

    def get_slice_rank(self) -> int:
        """Which slice this worker's gang occupies (multislice)."""
        return _require().config.slice_rank

    def get_num_slices(self) -> int:
        return _require().config.num_slices

    def get_trial_id(self) -> str:
        return _require().config.trial_id

    def get_trial_dir(self) -> str:
        return _require().config.trial_dir

    def get_experiment_name(self) -> str:
        return _require().config.experiment_name

    def get_metadata(self) -> Dict[str, Any]:
        return dict(_require().config.metadata)


def _require() -> _TrainSession:
    s = get_session()
    if s is None:
        raise RuntimeError(
            "No train session active — call this from inside a "
            "train_loop_per_worker")
    return s


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    _require().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return _require().get_checkpoint()


def get_context() -> TrainContext:
    _require()
    return TrainContext()


def get_dataset_shard(name: str = "train"):
    """Per-worker split of a dataset passed to the trainer.

    Reference: `python/ray/train/_internal/session.py` get_dataset_shard +
    `python/ray/data/_internal/iterator/stream_split_iterator.py:32`.
    """
    s = _require()
    shard = s.datasets.get(name)
    if shard is None:
        raise KeyError(f"no dataset shard named {name!r}; available: "
                       f"{sorted(s.datasets)}")
    return shard
