"""Node bootstrap: spawn the daemons that make up a ray_tpu_torch node.

Reference: `python/ray/_private/node.py` — `start_head_processes` (GCS then
raylet, dashboard, monitors) and `python/ray/_private/services.py` command
assembly. Also provides `Cluster`, the multi-node-on-one-machine testing
mechanism (reference: `python/ray/cluster_utils.py:135` — one raylet + store
per simulated node, one shared GCS).
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private import accelerators
from ray_tpu_torch._private.config import SESSION_ROOT

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class ProcessHandle:
    def __init__(self, proc: subprocess.Popen, ready_line: str, log_path: str):
        self.proc = proc
        self.ready_line = ready_line
        self.log_path = log_path

    def terminate(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()


def _spawn(args: List[str], log_path: str, ready_prefix: str,
           timeout: float = 240.0, env: dict | None = None,
           detach: bool = False) -> ProcessHandle:
    """Spawn a daemon and wait for its READY line. `detach` puts it in
    its own session (CLI-started nodes that outlive the launcher). The
    ready wait is non-blocking so a wedged daemon that never prints and
    never exits still trips the deadline — generous by default because
    on a loaded box interpreter start alone can take tens of seconds."""
    env = dict(env or os.environ)
    env.setdefault("PYTHONPATH", REPO_ROOT)
    # Daemons never touch accelerators; workers get GPUs explicitly. Keep
    # the host's visible devices so raylets can hand them to GPU workers.
    kept = accelerators.WORKER_VISIBLE_ENV
    if "CUDA_VISIBLE_DEVICES" in env and kept not in env:
        env[kept] = env["CUDA_VISIBLE_DEVICES"]
    env["CUDA_VISIBLE_DEVICES"] = ""
    logfile = open(log_path, "wb" if not detach else "ab")
    proc = subprocess.Popen(
        args, stdout=subprocess.PIPE, stderr=logfile, env=env,
        cwd=REPO_ROOT, start_new_session=detach,
    )
    logfile.close()
    os.set_blocking(proc.stdout.fileno(), False)
    deadline = time.monotonic() + timeout
    buf = b""
    while time.monotonic() < deadline:
        chunk = proc.stdout.read()
        if chunk:
            buf += chunk
            for line in buf.decode(errors="replace").splitlines():
                if line.startswith(ready_prefix):
                    return ProcessHandle(proc, line.strip(), log_path)
        if proc.poll() is not None:
            raise RuntimeError(
                f"daemon exited: {args!r}; log: {log_path}: "
                + open(log_path, errors="replace").read()[-2000:]
            )
        time.sleep(0.02)
    proc.terminate()
    raise RuntimeError(f"daemon not ready in {timeout}s: {args!r}")


class NodeHandle:
    def __init__(self, raylet: ProcessHandle):
        parts = raylet.ready_line.split()
        self.raylet_addr = parts[1]
        self.store_name = parts[2]
        self.node_id_hex = parts[3]
        self.process = raylet


class Cluster:
    """A real multi-daemon cluster on one machine.

    `Cluster(num_nodes=3)` starts one GCS and three raylets, each with its
    own shared-memory arena and worker pool — the mechanism every
    multi-node test in the reference uses (`ray_start_cluster`).
    """

    def __init__(
        self,
        head_resources: Dict[str, float] | None = None,
        object_store_memory: int | None = None,
        session_dir: str | None = None,
        gcs_persistence: bool = False,
        gcs_store: bool = False,
    ):
        ts = int(time.time() * 1000)
        self.session_dir = session_dir or f"{SESSION_ROOT}/session_{ts}_{os.getpid()}"
        os.makedirs(os.path.join(self.session_dir, "logs"), exist_ok=True)
        self.object_store_memory = object_store_memory
        self.gcs_persistence = gcs_persistence
        # write-through external store (Redis-role FileStoreClient):
        # durability per mutation, no snapshot-interval freshness window
        self.gcs_store = gcs_store
        self.gcs: Optional[ProcessHandle] = None
        self.nodes: List[NodeHandle] = []
        self._start_gcs()
        if head_resources is not None:
            self.add_node(head_resources)

    def _log(self, name: str) -> str:
        return os.path.join(self.session_dir, "logs", name)

    def _start_gcs(self, port: int = 0):
        args = [sys.executable, "-m", "ray_tpu_torch._private.gcs",
                "--port", str(port),
                "--log-file", self._log("gcs.log")]
        if self.gcs_persistence:
            args += ["--persist-path",
                     os.path.join(self.session_dir, "gcs_state.pkl")]
        if self.gcs_store:
            args += ["--store-path",
                     os.path.join(self.session_dir, "gcs_store")]
        self.gcs = _spawn(args, self._log("gcs.out"), "GCS_READY")
        self.gcs_addr = self.gcs.ready_line.split()[1]

    def restart_gcs(self):
        """Kill and respawn the GCS on the same address (fault-tolerance
        testing; requires gcs_persistence or gcs_store so tables
        survive — reference: test_gcs_fault_tolerance.py's
        restart_gcs_server)."""
        if not (self.gcs_persistence or self.gcs_store):
            raise RuntimeError(
                "restart_gcs requires gcs_persistence or gcs_store")
        port = int(self.gcs_addr.rsplit(":", 1)[1])
        self.gcs.terminate()
        self._start_gcs(port=port)

    def add_node(self, resources: Dict[str, float],
                 object_store_memory: int | None = None,
                 labels: Dict[str, str] | None = None) -> NodeHandle:
        args = [
            sys.executable, "-m", "ray_tpu_torch._private.raylet",
            "--gcs-addr", self.gcs_addr,
            "--resources", json.dumps(resources),
            "--session-dir", self.session_dir,
            "--log-file", self._log(f"raylet-{len(self.nodes)}.log"),
        ]
        # always explicit ({} for plain nodes): a test-cluster node must
        # never inherit slice identity from the host's environment
        args += ["--labels", json.dumps(labels or {})]
        mem = object_store_memory or self.object_store_memory
        if mem:
            args += ["--object-store-memory", str(mem)]
        raylet = _spawn(args, self._log(f"raylet-{len(self.nodes)}.out"),
                        "RAYLET_READY")
        node = NodeHandle(raylet)
        self.nodes.append(node)
        return node

    def add_slice(self, slice_type: str, num_hosts: int,
                  gpus_per_host: int = 4, cpus_per_host: float = 4.0,
                  name: str | None = None,
                  extra_labels: Dict[str, str] | None = None
                  ) -> List[NodeHandle]:
        """Simulate one GPU slice: `num_hosts` raylets sharing a slice
        name, each owning its host-local GPUs (the JAX package's TPU pod
        slice, the reference's accelerators/tpu.py:341-369, as local
        processes — the multi-host analogue of `ray_start_cluster`)."""
        acc = accelerators

        name = name or f"{slice_type}-{len(self.nodes)}"
        handles = []
        for host_id in range(num_hosts):
            labels = {
                acc.LABEL_SLICE_NAME: name,
                acc.LABEL_SLICE_TYPE: slice_type,
                acc.LABEL_SLICE_HOST_ID: str(host_id),
                acc.LABEL_SLICE_NUM_HOSTS: str(num_hosts),
                **(extra_labels or {}),
            }
            handles.append(self.add_node(
                {"CPU": cpus_per_host, "GPU": float(gpus_per_host)},
                labels=labels))
        return handles

    @property
    def head_node(self) -> NodeHandle:
        return self.nodes[0]

    def remove_node(self, node: NodeHandle):
        node.process.terminate()
        self.nodes.remove(node)
        # terminate() SIGKILLs after a 5s grace — the raylet may never
        # reach its own store.destroy(), so reap the arena here too
        try:
            os.unlink(f"/dev/shm{node.store_name}")
        except OSError:
            pass

    def shutdown(self):
        # Arena cleanup is scoped to THIS session's stores — other clusters
        # on the machine own their own /dev/shm entries.
        store_names = [n.store_name for n in self.nodes]
        for node in self.nodes:
            node.process.terminate()
        if self.gcs:
            self.gcs.terminate()
        self.nodes.clear()
        for name in store_names:
            try:
                os.unlink(f"/dev/shm{name}")
            except OSError:
                pass
