"""State API: list/summarize cluster entities.

Reference: `python/ray/util/state/` (`ray list tasks/actors/objects`,
`ray summary tasks`) backed by `dashboard/state_aggregator.py` +
`GcsTaskManager`. Here the GCS task table and the raylets are queried
directly over the worker's existing GCS client.

The port's copy of `ray_tpu/util/state.py`, over the port's GCS and
raylets.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


def _core_worker():
    from ray_tpu_torch._private.worker_api import _require_state

    return _require_state().core_worker


def list_tasks(limit: int = 1000, name: Optional[str] = None,
               state: Optional[str] = None) -> List[Dict[str, Any]]:
    """Task-event records from the GCS task table (newest first)."""
    cw = _core_worker()
    raw = cw._run_sync(cw.gcs.call("list_task_events", {
        "limit": limit, "name": name, "state": state,
    }))
    return [
        {
            "task_id": r["task_id"].hex(),
            "name": r["name"],
            "type": r["type"],
            "state": r["state"],
            "events": r["events"],
        }
        for r in raw
    ]


def summarize_tasks() -> Dict[str, Dict[str, int]]:
    """{task name: {state: count}} (reference: `ray summary tasks`)."""
    out: Dict[str, Dict[str, int]] = {}
    for rec in list_tasks(limit=100_000):
        per = out.setdefault(rec["name"], {})
        per[rec["state"]] = per.get(rec["state"], 0) + 1
    return out


def list_actors(limit: int = 1000) -> List[Dict[str, Any]]:
    cw = _core_worker()
    raw = cw._run_sync(cw.gcs.call("list_actors", {}))
    return [
        {
            "actor_id": a["actor_id"].hex(),
            "name": a.get("name"),
            "state": a["state"],
            "class_name": a.get("class_name", ""),
            "num_restarts": a.get("num_restarts", 0),
            "node_id": a["node_id"].hex() if a.get("node_id") else None,
        }
        for a in raw[:limit]
    ]


def list_jobs() -> List[Dict[str, Any]]:
    cw = _core_worker()
    raw = cw._run_sync(cw.gcs.call("list_jobs", {}))
    return [
        {
            "job_id": jb["job_id"].hex(),
            "driver_addr": jb.get("driver_addr", ""),
            "start_time": jb.get("start_time"),
            "end_time": jb.get("end_time"),
            "finished": jb.get("finished", False),
            "quotas": jb.get("quotas"),
        }
        for jb in raw
    ]


def list_cluster_events() -> List[Dict[str, Any]]:
    """Recent structured cluster events via the GCS (reference:
    `ray list cluster-events`)."""
    cw = _core_worker()
    return cw._run_sync(cw.gcs.call("list_events", {}))


def list_nodes() -> List[Dict[str, Any]]:
    import ray_tpu_torch

    return ray_tpu_torch.nodes()


def store_stats() -> List[Dict[str, Any]]:
    """Per-node shared-memory store counters (capacity, allocated,
    object count, eviction/spill pressure) straight from each raylet
    (reference: `ray memory --stats-only`'s plasma summary)."""
    cw = _core_worker()
    nodes = cw._run_sync(cw.gcs.call("get_nodes", {}))
    out: List[Dict[str, Any]] = []
    for node in nodes:
        if not node["alive"]:
            continue
        try:
            s = cw._run_sync(cw._store_stats_on(node["raylet_addr"]))
        except Exception:  # noqa: BLE001 — node may be going away
            continue
        s["node_id"] = node["node_id"].hex()
        out.append(s)
    return out


def list_objects(limit: int = 1000) -> List[Dict[str, Any]]:
    """Primary copies across the cluster: every raylet's pinned +
    spilled objects (reference: `ray list objects`, which reports
    plasma-pinned primaries per node)."""
    cw = _core_worker()
    nodes = cw._run_sync(cw.gcs.call("get_nodes", {}))
    out: List[Dict[str, Any]] = []
    for node in nodes:
        if not node["alive"]:
            continue
        try:
            objs = cw._run_sync(cw._list_objects_on(node["raylet_addr"]))
        except Exception:  # noqa: BLE001 — node may be going away
            continue
        for o in objs:
            o["node_id"] = node["node_id"].hex()
            out.append(o)
            if len(out) >= limit:
                return out
    return out
