"""Structured events as durable JSONL.

The port's own copy of `ray_tpu/util/events.py`. The health watchdog
(`ray_tpu_torch._private.health`) and the daemons report: `report()`
appends one severity/label/source-tagged event to a JSONL shard per
(source, pid), with the same size cap and rotation
(`RAY_TPU_EVENTS_MAX_BYTES`, `RAY_TPU_EVENTS_KEEP`), and `list_events()`
merges the shards. The directory is `RAY_TPU_EVENT_DIR`, by default
`ray_tpu/events` under the temporary directory (`TMPDIR`).
`report_async()` is `report()` for the runtime's async daemons.
`export_otlp()` writes the merged log as an OTLP/JSON Logs payload (the
CLI's `events --otlp`), its services named `ray_tpu_torch.<source>`.
"""

from __future__ import annotations

import glob
import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

SEVERITIES = ("DEBUG", "INFO", "WARNING", "ERROR", "FATAL")

_lock = threading.Lock()
_files: Dict[str, Any] = {}


def _reset_writers() -> None:
    """Fork safety: per-source writer handles are pid-named; a forked
    child inheriting them would append events to the parent's shard on a
    shared file offset. Drop the cache in the child — the next report()
    opens the child's own shard."""
    _files.clear()


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reset_writers)


def event_dir() -> str:
    return os.environ.get("RAY_TPU_EVENT_DIR") or os.path.join(
        tempfile.gettempdir(), "ray_tpu", "events")


def _max_bytes() -> int:
    """Per-shard size cap (0 = unbounded, the historical behavior)."""
    try:
        return int(os.environ.get("RAY_TPU_EVENTS_MAX_BYTES", "0"))
    except ValueError:
        return 0


def _keep() -> int:
    """Rotated generations retained per shard (plus the active file)."""
    try:
        return max(1, int(os.environ.get("RAY_TPU_EVENTS_KEEP", "3")))
    except ValueError:
        return 3


def _shard_base(source: str) -> str:
    return os.path.join(event_dir(),
                        f"event_{source}_{os.getpid()}")


def _writer_locked(source: str):
    f = _files.get(source)
    if f is None:
        os.makedirs(event_dir(), exist_ok=True)
        f = open(f"{_shard_base(source)}.jsonl", "a", buffering=1)
        _files[source] = f
    return f


def _rotate_locked(source: str, f) -> None:
    """Shift `<base>.N.jsonl` generations up (dropping the oldest past
    keep-last-K) and retire the active shard to `.1`. Rotation happens
    strictly BETWEEN whole-line writes under the module lock, so no
    JSON line is ever torn across files. Rotated names keep the
    `.jsonl` suffix so `list_events()`'s glob still merges them."""
    f.close()
    _files.pop(source, None)
    base = _shard_base(source)
    keep = _keep()
    try:
        for n in range(keep - 1, 0, -1):
            src = f"{base}.{n}.jsonl"
            if os.path.exists(src):
                os.replace(src, f"{base}.{n + 1}.jsonl")
        os.replace(f"{base}.jsonl", f"{base}.1.jsonl")
    except OSError:
        pass  # next report() reopens the active shard either way


def report(source: str, severity: str, label: str, message: str,
           **fields: Any) -> dict:
    """Record one structured event (never raises — observability must
    not take down the daemon emitting it)."""
    if severity not in SEVERITIES:  # coerce, consistent with no-raise
        severity = "INFO"
    ev = {
        "ts": time.time(),
        "source": source,          # e.g. SERVE_LLM
        "severity": severity,
        "label": label,            # stable machine key, e.g. NODE_DEAD
        "message": message,
        "pid": os.getpid(),
        **fields,
    }
    try:
        line = json.dumps(ev) + "\n"
    except TypeError:
        return ev
    try:
        # one lock for write + rotation check: a concurrent rotation can
        # never close a handle mid-write, and each line lands whole in
        # exactly one generation
        with _lock:
            f = _writer_locked(source)
            f.write(line)
            limit = _max_bytes()
            if limit and f.tell() >= limit:
                _rotate_locked(source, f)
    except OSError:
        pass
    return ev


async def report_async(source: str, severity: str, label: str,
                       message: str, **fields: Any) -> dict:
    """`report` for async daemons (GCS/raylet handlers): the JSONL
    append — a lazy open() on the shard's first event plus the write —
    runs in the default executor so an event at a lifecycle transition
    never stalls the RPC event loop behind disk latency."""
    import asyncio
    import functools

    return await asyncio.get_running_loop().run_in_executor(
        None, functools.partial(report, source, severity, label,
                                message, **fields))


def list_events(source: Optional[str] = None,
                severity: Optional[str] = None,
                label: Optional[str] = None,
                path: Optional[str] = None) -> List[dict]:
    """Merge every shard, oldest first, with optional filters
    (reference `ray list cluster-events` semantics)."""
    out: List[dict] = []
    pattern = os.path.join(path or event_dir(),
                           f"event_{source or '*'}_*.jsonl")
    for fn in sorted(glob.glob(pattern)):
        try:
            with open(fn) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    ev = json.loads(line)
                    if severity and ev.get("severity") != severity:
                        continue
                    if label and ev.get("label") != label:
                        continue
                    out.append(ev)
        except (OSError, json.JSONDecodeError):
            continue
    out.sort(key=lambda e: e.get("ts", 0))
    return out


# -- OpenTelemetry export ----------------------------------------------------

_OTLP_SEVERITY_NUM = {"DEBUG": 5, "INFO": 9, "WARNING": 13, "ERROR": 17,
                      "FATAL": 21}


def export_otlp(out_path: str, source: Optional[str] = None,
                severity: Optional[str] = None,
                label: Optional[str] = None,
                path: Optional[str] = None) -> int:
    """Write the merged event log as an OTLP/JSON Logs payload.

    Reference: the reference exports its event/metric streams through an
    OpenTelemetry pipeline (`src/ray/util/event.h` + the dashboard's
    metrics agent). Zero-egress equivalent: one `resourceLogs` entry per
    (source, pid) shard in the standard OTLP-JSON shape, ready for
    `otelcol --config 'receivers: filelog'` or any OTLP ingester.
    Returns the number of log records written.
    """
    events = list_events(source=source, severity=severity, label=label,
                         path=path)
    by_resource: Dict[tuple, List[dict]] = {}
    for ev in events:
        by_resource.setdefault(
            (ev.get("source", "?"), ev.get("pid", 0)), []).append(ev)
    resource_logs = []
    for (src, pid), evs in sorted(by_resource.items()):
        records = []
        for ev in evs:
            attrs = [
                {"key": k, "value": {"stringValue": str(v)}}
                for k, v in ev.items()
                if k not in ("ts", "severity", "message", "source", "pid")
            ]
            records.append({
                "timeUnixNano": str(int(ev.get("ts", 0) * 1e9)),
                "severityNumber": _OTLP_SEVERITY_NUM.get(
                    ev.get("severity", "INFO"), 9),
                "severityText": ev.get("severity", "INFO"),
                "body": {"stringValue": ev.get("message", "")},
                "attributes": attrs,
            })
        resource_logs.append({
            "resource": {"attributes": [
                {"key": "service.name",
                 "value": {"stringValue": f"ray_tpu_torch.{src.lower()}"}},
                {"key": "process.pid",
                 "value": {"intValue": str(pid)}},
            ]},
            "scopeLogs": [{
                "scope": {"name": "ray_tpu_torch.events"},
                "logRecords": records,
            }],
        })
    with open(out_path, "w") as f:
        json.dump({"resourceLogs": resource_logs}, f)
    return len(events)
