"""Central config registry, env-var overridable.

Equivalent of the reference's `RayConfig` macro registry
(`src/ray/common/ray_config_def.h` — 216 `RAY_CONFIG(...)` knobs, each
overridable via a `RAY_<name>` env var). Here every knob is declared once with
a type and default and can be overridden with `RAY_TPU_<NAME>` env vars or
programmatically via `ray_tpu_torch.init(_system_config={...})`.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field, fields
from typing import Any

_ENV_PREFIX = "RAY_TPU_"

# The port's session root (sessions, logs, env caches): apart from the
# JAX package's /tmp/ray_tpu, so clusters of the two packages on one
# host never find each other.
SESSION_ROOT = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")


@dataclass
class Config:
    # --- object store / data plane ---
    # Objects <= this many bytes are returned in-band in the task reply and
    # live in the owner's in-process memory store (reference:
    # `max_direct_call_object_size`, ray_config_def.h:206 — 100KB default).
    max_direct_call_object_size: int = 100 * 1024
    # Streaming generators: how many reported-but-unconsumed items the
    # owner buffers before it withholds the executor's ack (reference:
    # generator_waiter.h backpressure threshold).
    streaming_backpressure_items: int = 16
    # Node-to-node object transfer chunk size (reference:
    # object_manager_default_chunk_size, ray_config_def.h) and how many
    # chunk fetches ride in flight per object.
    object_transfer_chunk_bytes: int = 4 * 1024 * 1024
    object_transfer_parallelism: int = 4
    # Outstanding worker-lease requests per scheduling key (reference:
    # max_pending_lease_requests_per_scheduling_category).
    max_lease_requests_per_key: int = 8
    # Tasks pushed to one leased worker before its first reply arrives
    # (reference: max_tasks_in_flight_per_worker,
    # direct_task_transport.h:75 lease pipelining). The worker queues
    # them FIFO; pipelining amortizes the submit round trip for small
    # tasks.
    max_tasks_in_flight_per_worker: int = 16
    # Default per-node shared-memory store capacity.
    object_store_memory: int = 2 * 1024**3
    # Object-table slots in the shm store header.
    object_store_table_size: int = 65536
    # Chunk size for node-to-node object transfer.
    object_transfer_chunk_bytes: int = 8 * 1024**2

    # --- scheduling ---
    # Hybrid policy: pack onto the local node until its utilization crosses
    # this threshold, then spread (reference hybrid_scheduling_policy).
    scheduler_spread_threshold: float = 0.5
    # How long a leased worker is kept by a submitter with no queued tasks.
    idle_lease_keepalive_s: float = 0.2
    # Max workers a raylet will fork per node by default: num_cpus.
    maximum_startup_concurrency: int = 8
    # consecutive pre-registration worker deaths for one pool key before
    # the raylet stops respawning and fails the waiting leases (a broken
    # runtime-env interpreter would otherwise crash-loop forever)
    max_worker_startup_failures: int = 5
    # Worker pool: keep this many idle workers warm.
    num_prestart_workers: int = 0
    worker_register_timeout_s: float = 30.0

    # --- host memory monitor (reference: memory_monitor.h:52 +
    # worker_killing_policy_group_by_owner.h) ---
    # Kill workers when host used/total crosses this fraction; <= 0
    # disables the monitor.
    memory_usage_threshold: float = 0.95
    memory_monitor_refresh_ms: int = 250
    # Test hook: a file containing "used_bytes total_bytes" read instead
    # of /proc/meminfo (empty = real host memory).
    memory_usage_path: str = ""

    # --- health / fault tolerance ---
    raylet_heartbeat_period_s: float = 0.5
    health_check_failure_threshold: int = 10
    actor_max_restarts_default: int = 0
    task_max_retries_default: int = 3
    # Lineage: max bytes of task specs retained by an owner for reconstruction.
    # Also settable as RAY_TPU_LINEAGE_MAX_BYTES (alias).
    max_lineage_bytes: int = 1024**3
    # Deepest chain of missing upstream inputs a single reconstruction
    # will recursively re-submit before giving up with ObjectLostError
    # (reference: lineage depth bound in task_manager resubmit).
    lineage_max_depth: int = 100
    # Per producing task: how many times its lost returns may be
    # re-executed before the owner marks them unreconstructable
    # (reference: max_retries semantics on object recovery).
    max_object_reconstructions: int = 3

    # --- rpc ---
    rpc_connect_timeout_s: float = 10.0
    rpc_max_frame_bytes: int = 512 * 1024**2
    # Write-side frame coalescing: logical messages queued within one
    # event-loop tick share a BATCH wire frame; crossing either watermark
    # flushes immediately. 1 disables batching (every message is its own
    # frame, byte-identical to the pre-BATCH wire format).
    rpc_batch_max_msgs: int = 128
    rpc_batch_max_bytes: int = 256 * 1024
    # Transport send-buffer high-watermark: above this the coalescer stops
    # writing and parks behind one awaited drain() (backpressure for the
    # call_nowait pipelined path against a slow peer).
    rpc_send_high_watermark: int = 4 * 1024**2

    # --- gcs ---
    gcs_pubsub_batch_ms: float = 5.0
    resource_broadcast_period_s: float = 0.1

    # --- paths ---
    session_dir_root: str = SESSION_ROOT

    def update(self, overrides: dict[str, Any] | None = None) -> "Config":
        if overrides:
            for key, value in overrides.items():
                if not hasattr(self, key):
                    raise ValueError(f"Unknown config key: {key}")
                setattr(self, key, value)
        return self

    # Alternate env spellings: RAY_TPU_<alias> -> field. The canonical
    # RAY_TPU_<FIELD_NAME> form always works; aliases exist where the
    # documented knob name differs from the field (wins over the
    # canonical spelling when both are set).
    _ENV_ALIASES = {
        "LINEAGE_MAX_BYTES": "max_lineage_bytes",
        "LINEAGE_MAX_DEPTH": "lineage_max_depth",
    }

    @classmethod
    def from_env(cls) -> "Config":
        cfg = cls()
        alias_for = {v: k for k, v in cls._ENV_ALIASES.items()}
        for f in fields(cls):
            env = os.environ.get(_ENV_PREFIX + f.name.upper())
            alias = alias_for.get(f.name)
            if alias is not None:
                env = os.environ.get(_ENV_PREFIX + alias, env)
            if env is not None:
                if f.type in ("int", int):
                    setattr(cfg, f.name, int(env))
                elif f.type in ("float", float):
                    setattr(cfg, f.name, float(env))
                elif f.type in ("bool", bool):
                    setattr(cfg, f.name, env.lower() in ("1", "true", "yes"))
                else:
                    setattr(cfg, f.name, env)
        return cfg


_global_config: Config | None = None


def global_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config.from_env()
    return _global_config


def set_global_config(cfg: Config) -> None:
    global _global_config
    _global_config = cfg
