"""Worker group: the actor fleet a trainer runs on.

Port of `ray_tpu/train/_internal/worker_group.py`: a worker's `GPU`
resource maps to ``num_gpus`` (the JAX package maps `TPU` to
``num_tpus``), and the worker has no platform switch to apply — its
devices are fixed at spawn. The train function runs in a daemon thread.

Reference: `python/ray/train/_internal/worker_group.py:102` — a list of
actors created inside a placement group, with `execute`/`execute_async`
fan-out helpers. The `TrainWorker` actor here also owns the train-fn
thread + result queue (the reference splits this into `RayTrainWorker` +
session; collapsed because the session already lives in
`_internal/session.py`).
"""

from __future__ import annotations

import os
import socket
import threading
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train._internal import session as session_mod
from ray_tpu_torch.train._internal.session import SessionConfig


class TrainWorker:
    """Actor hosting one train worker (one torch process). Its devices
    are its `CUDA_VISIBLE_DEVICES` at spawn (the raylet's GPU grant)."""

    def __init__(self, worker_env: Optional[Dict[str, str]] = None):
        for k, v in (worker_env or {}).items():
            os.environ[k] = v
        self._thread: Optional[threading.Thread] = None
        self._session: Optional[session_mod._TrainSession] = None

    # -- introspection -----------------------------------------------------

    def get_metadata(self) -> Dict[str, Any]:
        return {
            "hostname": socket.gethostname(),
            "pid": os.getpid(),
            "node_id": os.environ.get("RAY_TPU_NODE_ID", ""),
        }

    def get_free_port(self) -> int:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    # -- generic fan-out (reference WorkerGroup.execute) -------------------

    def execute(self, fn: Callable, *args, **kwargs):
        return fn(*args, **kwargs)

    # -- training lifecycle ------------------------------------------------

    def init_session(self, config: SessionConfig) -> None:
        self._session = session_mod.init_session(config)

    def set_dataset_shards(self, shards: Dict[str, Any]) -> None:
        assert self._session is not None
        self._session.datasets = shards

    def start_training(self, train_fn: Callable,
                       config: Dict[str, Any]) -> None:
        assert self._session is not None, "init_session first"
        sess = self._session

        def run():
            try:
                import inspect
                if len(inspect.signature(train_fn).parameters) == 0:
                    train_fn()
                else:
                    train_fn(config)
            except BaseException as e:  # noqa: BLE001 — reported to driver
                sess.error = e
            finally:
                sess.finished.set()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="train_fn")
        self._thread.start()

    def next_result(self, timeout: float = 5.0) -> Optional[Dict[str, Any]]:
        """One report item, or a terminal marker, or None (poll again)."""
        assert self._session is not None
        sess = self._session
        import queue as queue_mod
        try:
            return sess.result_queue.get(timeout=timeout)
        except queue_mod.Empty:
            pass
        if sess.finished.is_set() and sess.result_queue.empty():
            if sess.error is not None:
                import traceback
                tb = "".join(traceback.format_exception(
                    type(sess.error), sess.error, sess.error.__traceback__))
                return {"_finished": True, "_error": tb,
                        "_error_obj": _safe_exc(sess.error)}
            return {"_finished": True}
        return None

    def ack_commit(self, report_index: int) -> None:
        """Gang-commit ack from the controller: the checkpoint of
        `report_index` is registered — release report()'s barrier."""
        assert self._session is not None
        self._session.ack_commit(report_index)

    def shutdown_session(self) -> None:
        session_mod.shutdown_session()
        self._session = None
        self._thread = None


def _safe_exc(e: BaseException):
    try:
        import pickle
        pickle.dumps(e)
        return e
    except Exception:
        return RuntimeError(f"{type(e).__name__}: {e}")


class WorkerGroup:
    """Fleet of TrainWorker actors pinned to placement-group bundles.

    `placement_group` may be a single PG, or a LIST of PGs for
    multislice — workers are split evenly across them in rank order
    (slice_rank = world_rank // workers_per_slice), so each slice's gang
    is a contiguous rank range."""

    def __init__(self, num_workers: int,
                 resources_per_worker: Dict[str, float],
                 placement_group=None,
                 worker_env: Optional[Dict[str, str]] = None):
        self.num_workers = num_workers
        self.workers: List[Any] = []
        pgs = (list(placement_group)
               if isinstance(placement_group, (list, tuple))
               else ([placement_group] if placement_group is not None
                     else None))
        self.num_slices = len(pgs) if pgs else 1
        per_slice = num_workers // self.num_slices if pgs else num_workers
        cls = ray_tpu_torch.remote(TrainWorker)
        res = dict(resources_per_worker)
        num_cpus = res.pop("CPU", 1.0)
        num_gpus = res.pop("GPU", None)
        for i in range(num_workers):
            opts: Dict[str, Any] = dict(num_cpus=num_cpus, resources=dict(res))
            if num_gpus:
                opts["num_gpus"] = num_gpus
            if worker_env:
                # spawn-time env vars: they must be in the process
                # environment BEFORE torch initializes CUDA, which the
                # post-spawn os.environ writes in TrainWorker.__init__
                # cannot guarantee (a pooled worker may already have
                # torch live). The env hash also forces a fresh worker
                # process instead of a pooled reuse.
                opts["runtime_env"] = {"env_vars": dict(worker_env)}
            if pgs is not None:
                opts["scheduling_strategy"] = \
                    ray_tpu_torch.PlacementGroupSchedulingStrategy(
                        placement_group=pgs[i // per_slice],
                        placement_group_bundle_index=i % per_slice)
            self.workers.append(cls.options(**opts).remote(worker_env))

    def slice_rank(self, world_rank: int) -> int:
        per_slice = self.num_workers // self.num_slices
        return world_rank // per_slice

    def execute_async(self, fn: Callable, *args, **kwargs) -> List[Any]:
        return [w.execute.remote(fn, *args, **kwargs) for w in self.workers]

    def execute(self, fn: Callable, *args, timeout: float = 300.0,
                **kwargs) -> List[Any]:
        return ray_tpu_torch.get(self.execute_async(fn, *args, **kwargs),
                           timeout=timeout)

    def execute_single(self, rank: int, fn: Callable, *args,
                       timeout: float = 300.0, **kwargs) -> Any:
        return ray_tpu_torch.get(
            self.workers[rank].execute.remote(fn, *args, **kwargs),
            timeout=timeout)

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []

    def __len__(self) -> int:
        return len(self.workers)
