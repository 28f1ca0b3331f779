"""RuntimeContext — introspection of the current driver/worker process.

Reference: `python/ray/runtime_context.py` — `ray.get_runtime_context()`
returns a per-process view of job/node/worker/task/actor identity plus
cluster metadata. Same surface here, read off the process CoreWorker.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class RuntimeContext:
    """Snapshot accessors over the calling process's CoreWorker."""

    def __init__(self, core_worker):
        self._cw = core_worker

    # -- identity ----------------------------------------------------------

    def get_job_id(self) -> str:
        return self._cw.job_id.hex()

    def get_node_id(self) -> str:
        return self._cw.node_id_hex

    def get_worker_id(self) -> str:
        return self._cw.worker_id.hex()

    def get_task_id(self) -> Optional[str]:
        """Current task id, or None on the driver (reference returns
        None outside a worker task)."""
        if self._cw.mode != "worker":
            return None
        tid = self._cw.current_task_id
        return tid.hex() if tid is not None else None

    def get_actor_id(self) -> Optional[str]:
        aid = self._cw.current_actor_id
        return aid.hex() if aid is not None else None

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return bool(getattr(self._cw, "actor_restart_count", 0) > 0)

    # -- cluster metadata --------------------------------------------------

    @property
    def gcs_address(self) -> str:
        return self._cw.gcs_addr

    def get_worker_mode(self) -> str:
        """"driver" or "worker"."""
        return self._cw.mode

    def get_runtime_env(self) -> Dict[str, Any]:
        """The runtime env this process was started under (empty dict on
        the driver or for plain workers)."""
        return dict(getattr(self._cw, "current_runtime_env", None) or {})

    def get(self) -> Dict[str, Any]:
        """Legacy dict form (reference `RuntimeContext.get`)."""
        out: Dict[str, Any] = {
            "job_id": self.get_job_id(),
            "node_id": self.get_node_id(),
            "worker_id": self.get_worker_id(),
            "worker_mode": self.get_worker_mode(),
        }
        if self.get_task_id() is not None:
            out["task_id"] = self.get_task_id()
        if self.get_actor_id() is not None:
            out["actor_id"] = self.get_actor_id()
        return out


def get_runtime_context() -> RuntimeContext:
    """Public accessor (reference `ray.get_runtime_context()`)."""
    from ray_tpu_torch._private.worker_api import _require_state

    return RuntimeContext(_require_state().core_worker)
