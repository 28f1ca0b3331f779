"""Job submission: run driver scripts ON the cluster, track their state.

Reference: `dashboard/modules/job/{job_manager,job_supervisor,sdk}.py` —
a `JobSupervisor` detached actor wraps the driver subprocess; submission
state lives in the GCS (KV here, job table there). No separate dashboard
process: the supervisor is an ordinary detached actor reachable from any
client of the cluster.

The port's copy of `ray_tpu/job_submission.py`. The entrypoint joins
the port's cluster through `RAY_TPU_TORCH_ADDRESS` (the JAX package's
drivers read `RAY_TPU_ADDRESS`), and the checkout that holds
`ray_tpu_torch` leads the subprocess's `PYTHONPATH`.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch

_KV_NS = "job_submission"

# terminal + live states (reference: JobStatus enum)
PENDING = "PENDING"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"


class _JobSupervisor:
    """Detached actor: runs the entrypoint as a subprocess on its node,
    captures output, publishes status to the GCS KV (reference:
    job_supervisor.py)."""

    def __init__(self, job_id: str, entrypoint: str,
                 env_vars: Optional[Dict[str, str]] = None):
        import os
        import subprocess
        import threading

        self._job_id = job_id
        self._entrypoint = entrypoint
        self._log: List[str] = []
        self._status = RUNNING
        self._returncode: Optional[int] = None
        env = dict(os.environ)
        env.update(env_vars or {})
        # the driver joins THIS cluster
        from ray_tpu_torch._private.worker_api import (ADDRESS_ENV,
                                                       _require_state)

        env[ADDRESS_ENV] = _require_state().core_worker.gcs_addr
        # the framework package must resolve in the subprocess no matter
        # its cwd/script dir (the session dir /tmp/ray_tpu_torch would
        # otherwise shadow it as a namespace package!)
        import ray_tpu_torch as _pkg

        pkg_root = os.path.dirname(
            os.path.dirname(os.path.abspath(_pkg.__file__)))
        env["PYTHONPATH"] = pkg_root + os.pathsep + \
            env.get("PYTHONPATH", "")
        self._proc = subprocess.Popen(
            entrypoint, shell=True, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self._publish()

        def pump():
            for line in self._proc.stdout:
                self._log.append(line)
                if len(self._log) > 10_000:
                    del self._log[:1000]
            self._returncode = self._proc.wait()
            if self._status != STOPPED:
                self._status = SUCCEEDED if self._returncode == 0 \
                    else FAILED
            self._publish()

        threading.Thread(target=pump, daemon=True).start()

    def _publish(self):
        from ray_tpu_torch._private.worker_api import _require_state

        cw = _require_state().core_worker
        cw._run_sync(cw.gcs.call("kv_put", {
            "ns": _KV_NS,
            "key": self._job_id.encode(),
            "value": json.dumps({
                "job_id": self._job_id,
                "entrypoint": self._entrypoint,
                "status": self._status,
                "returncode": self._returncode,
                "ts": time.time(),
            }).encode(),
        }))

    def status(self) -> Dict[str, Any]:
        return {"job_id": self._job_id, "status": self._status,
                "returncode": self._returncode}

    def logs(self, tail: int = 1000) -> str:
        return "".join(self._log[-tail:])

    def stop(self) -> bool:
        if self._proc.poll() is None:
            self._status = STOPPED
            self._proc.terminate()
            self._publish()
            return True
        return False

    def ping(self) -> bool:
        return True


class JobSubmissionClient:
    """Reference: `python/ray/dashboard/modules/job/sdk.py`
    JobSubmissionClient — same verbs (submit/status/logs/stop/list),
    actor-backed instead of REST."""

    def __init__(self, address: Optional[str] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=address)

    def submit_job(self, *, entrypoint: str,
                   submission_id: Optional[str] = None,
                   env_vars: Optional[Dict[str, str]] = None) -> str:
        job_id = submission_id or f"job-{uuid.uuid4().hex[:10]}"
        if submission_id is not None:
            # reference parity: an explicit submission_id that collides
            # with a recorded job is a caller error, not a silent
            # overwrite of the old job's record
            from ray_tpu_torch._private.worker_api import _require_state

            cw = _require_state().core_worker
            reply = cw._run_sync(cw.gcs.call("kv_exists", {
                "ns": _KV_NS, "key": submission_id.encode()}))
            if reply["exists"]:
                raise ValueError(
                    f"job {submission_id!r} was already submitted")
        supervisor_cls = ray_tpu_torch.remote(_JobSupervisor)
        supervisor_cls.options(
            name=f"_job_supervisor_{job_id}",
            lifetime="detached", num_cpus=0,
        ).remote(job_id, entrypoint, env_vars)
        return job_id

    def _supervisor(self, job_id: str):
        return ray_tpu_torch.get_actor(f"_job_supervisor_{job_id}")

    def get_job_status(self, job_id: str) -> str:
        try:
            sup = self._supervisor(job_id)
            return ray_tpu_torch.get(sup.status.remote(), timeout=30)["status"]
        except Exception:  # noqa: BLE001 — supervisor gone: read the KV
            rec = self._kv_record(job_id)
            return rec["status"] if rec else FAILED

    def get_job_info(self, job_id: str) -> Optional[Dict[str, Any]]:
        return self._kv_record(job_id)

    def get_job_logs(self, job_id: str, tail: int = 1000) -> str:
        sup = self._supervisor(job_id)
        return ray_tpu_torch.get(sup.logs.remote(tail), timeout=30)

    def stop_job(self, job_id: str) -> bool:
        sup = self._supervisor(job_id)
        return ray_tpu_torch.get(sup.stop.remote(), timeout=30)

    def wait_until_finished(self, job_id: str,
                            timeout: float = 600.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in (SUCCEEDED, FAILED, STOPPED):
                return status
            time.sleep(0.5)
        raise TimeoutError(f"job {job_id} still {status} after {timeout}s")

    def delete_job(self, job_id: str) -> bool:
        """Drop a terminal job's KV record (reference SDK verb).
        Refuses while the job may still be running — stop it first."""
        from ray_tpu_torch._private.worker_api import _require_state

        status = self.get_job_status(job_id)
        if status not in (SUCCEEDED, FAILED, STOPPED):
            raise RuntimeError(
                f"job {job_id!r} is {status}; stop it before deleting")
        cw = _require_state().core_worker
        reply = cw._run_sync(cw.gcs.call("kv_del", {
            "ns": _KV_NS, "key": job_id.encode()}))
        return bool(reply["deleted"])

    def list_jobs(self) -> List[Dict[str, Any]]:
        from ray_tpu_torch._private.worker_api import _require_state

        cw = _require_state().core_worker
        keys = cw._run_sync(
            cw.gcs.call("kv_keys", {"ns": _KV_NS}))["keys"]
        out = []
        for key in keys:
            rec = self._kv_record(
                key.decode() if isinstance(key, bytes) else key)
            if rec:
                out.append(rec)
        return out

    def _kv_record(self, job_id: str) -> Optional[Dict[str, Any]]:
        from ray_tpu_torch._private.worker_api import _require_state

        cw = _require_state().core_worker
        reply = cw._run_sync(cw.gcs.call("kv_get", {
            "ns": _KV_NS, "key": job_id.encode()}))
        if reply["value"] is None:
            return None
        return json.loads(reply["value"])
