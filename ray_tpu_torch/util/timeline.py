"""Timeline export: task events → Chrome trace JSON.

Reference: `ray timeline` (`python/ray/_private/state.py:434`
`chrome_tracing_dump`) — profile events from the GCS task table rendered
for chrome://tracing / Perfetto. Each task becomes a complete ("X")
event on its owner's row, spanning SUBMITTED → FINISHED/FAILED.

`unified_timeline` additionally merges the tracing plane's span shards
(submit/execute spans, channel write→read hops with cross-process flow
arrows), the flight recorder's per-step records, and the request
recorder's per-request records into ONE Chrome trace — the
`ray_tpu timeline --unified` view: task rows from the GCS, span rows
per process, a "train-step" row per training process, a
"serve-request" row per serving process (handle→replica→engine arrows
stitched by `flow_id="req:<id>"`), all on the same wall clock.

The port's copy of `ray_tpu/util/timeline.py`, over the port's state
API, tracing, step profiler and request recorder. Its task rows carry
`pid` "ray_tpu_torch". The CLI verb comes with the port of
`scripts/cli.py`.
"""

from __future__ import annotations

import json
from typing import Optional


def timeline(filename: Optional[str] = None) -> list:
    """Build (and optionally write) the Chrome trace for everything in
    the GCS task table. Load the file in chrome://tracing or
    ui.perfetto.dev."""
    from ray_tpu_torch.util.state import list_tasks

    events = []
    for rec in list_tasks(limit=100_000):
        transitions = dict()
        for state, ts in rec["events"]:
            # keep the FIRST time each state was reached
            transitions.setdefault(state, ts)
        start = transitions.get("SUBMITTED")
        end = transitions.get("FINISHED", transitions.get("FAILED"))
        if start is None:
            continue
        if end is None or end < start:
            end = start
        events.append({
            "name": rec["name"],
            "cat": rec["type"],
            "ph": "X",  # complete event
            "ts": start * 1e6,  # chrome wants microseconds
            "dur": max(1.0, (end - start) * 1e6),
            "pid": "ray_tpu_torch",
            "tid": rec["type"],
            "args": {
                "task_id": rec["task_id"],
                "state": rec["state"],
            },
        })
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
    return events


def unified_timeline(filename: Optional[str] = None,
                     trace_dir: Optional[str] = None,
                     include_tasks: bool = True) -> list:
    """Merge task events + tracing spans + step records into one Chrome
    trace. Each source is optional on its own: no cluster connection
    skips the task table (`include_tasks=False` or a connection error),
    an empty trace dir contributes nothing — whatever telemetry exists
    lands in the one file."""
    from ray_tpu_torch.util import request_recorder, step_profiler, tracing

    events: list = []
    if include_tasks:
        try:
            events.extend(timeline(None))
        except Exception:  # noqa: BLE001 — offline use: spans + steps
            pass           # still merge without a cluster
    spans = tracing.collect(trace_dir)
    events.extend(tracing.to_chrome(spans))
    steps = step_profiler.collect(trace_dir)
    events.extend(step_profiler.to_chrome(steps))
    requests = request_recorder.collect(trace_dir)
    events.extend(request_recorder.to_chrome(requests))
    events.sort(key=lambda e: e.get("ts", 0))
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
    return events
