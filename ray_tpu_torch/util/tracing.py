"""Tracing: spans as JSONL shards, merged into a chrome://tracing view.

The port's own copy of `ray_tpu/util/tracing.py`: spans are plain dicts
written as one JSONL shard per process (zero deps, zero cost when
disabled), nested through a context variable, and `collect()` /
`to_chrome()` merge the shards into one timeline. It reads the same
`RAY_TPU_TRACE=1` and `RAY_TPU_TRACE_DIR` variables as the JAX package,
so one setting traces both; the default directory is `ray_tpu/traces`
under the temporary directory (`TMPDIR`). The runtime's task spans
(`submit_span`, `execute_span`) carry trace and parent ids through
`TaskSpec.trace_ctx`, so spans from every process of a cluster stitch
into one trace.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import tempfile
import threading
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional

_current: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "ray_tpu_trace_span", default=None)

_lock = threading.Lock()
_file = None


def _reset_writer() -> None:
    """Fork safety: a child inheriting the parent's cached handle would
    append its spans to the PARENT's pid-named shard (and interleave
    writes on a shared file offset). Daemons fork workers, so the cached
    handle is dropped in the child; the next span opens the child's own
    shard. Runs in the just-forked child, which is single-threaded —
    taking the fork-inherited lock here could deadlock on a holder that
    no longer exists in the child."""
    global _file
    _file = None


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reset_writer)


def enabled() -> bool:
    return os.environ.get("RAY_TPU_TRACE", "") in ("1", "true", "on")


def trace_dir() -> str:
    return os.environ.get("RAY_TPU_TRACE_DIR") or os.path.join(
        tempfile.gettempdir(), "ray_tpu", "traces")


def _writer():
    global _file
    if _file is None:
        with _lock:
            if _file is None:
                os.makedirs(trace_dir(), exist_ok=True)
                # opened once per process at the first span; per-span
                # appends are line-buffered local writes (µs-scale), so
                # span exits inside async executors stay loop-safe
                _file = open(
                    os.path.join(trace_dir(), f"trace-{os.getpid()}.jsonl"),
                    "a", buffering=1)  # line-buffered: crash-safe
    return _file


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


@contextlib.contextmanager
def span(name: str, kind: str = "internal",
         parent: Optional[Dict[str, str]] = None,
         attrs: Optional[Dict[str, Any]] = None) -> Iterator[dict]:
    """Record one span; nests under the context-local current span
    unless an explicit cross-process `parent` ctx is given."""
    if not enabled():
        yield {}
        return
    cur = _current.get()
    if parent is None and cur is not None:
        parent = {"trace_id": cur["trace_id"], "span_id": cur["span_id"]}
    s = {
        "trace_id": (parent or {}).get("trace_id") or _new_id(),
        "span_id": _new_id(),
        "parent_id": (parent or {}).get("span_id"),
        "name": name,
        "kind": kind,
        "pid": os.getpid(),
        "start": time.time(),
        "attrs": dict(attrs or {}),
    }
    token = _current.set(s)
    try:
        yield s
    except Exception as e:
        s["attrs"]["error"] = type(e).__name__
        raise
    finally:
        _current.reset(token)
        s["end"] = time.time()
        try:
            _writer().write(json.dumps(s) + "\n")
        except OSError:  # tracing must never break the task path
            pass


def current_context() -> Optional[Dict[str, str]]:
    """Wire form of the current span (to stuff into a TaskSpec)."""
    cur = _current.get()
    if cur is None:
        return None
    return {"trace_id": cur["trace_id"], "span_id": cur["span_id"]}


@contextlib.contextmanager
def submit_span(task_name: str, task_type: str):
    """Producer-side span; yields the ctx dict to ship in the spec
    (None when tracing is off — zero wire overhead)."""
    if not enabled():
        yield None
        return
    with span(f"{task_name}.remote", kind="producer",
              attrs={"task_type": task_type}) as s:
        yield {"trace_id": s["trace_id"], "span_id": s["span_id"]}


@contextlib.contextmanager
def execute_span(spec) -> Iterator:
    """Consumer-side span parented on the submitter's ctx."""
    if not enabled():
        yield
        return
    parent = getattr(spec, "trace_ctx", None)
    with span(f"{spec.name}.execute", kind="consumer", parent=parent,
              attrs={"task_type": spec.task_type,
                     "task_id": spec.task_id.hex()}):
        yield


# -- aggregation ---------------------------------------------------------

def collect(path: Optional[str] = None) -> List[dict]:
    """Merge every process's span shard (sorted by start time)."""
    import glob

    spans = []
    for fn in sorted(glob.glob(os.path.join(path or trace_dir(),
                                            "trace-*.jsonl"))):
        with open(fn) as f:
            for line in f:
                line = line.strip()
                if line:
                    spans.append(json.loads(line))
    spans.sort(key=lambda s: s["start"])
    return spans


def to_chrome(spans: List[dict], filename: Optional[str] = None) -> list:
    """Chrome-trace view: one complete event per span, rows = processes,
    flow arrows producer → consumer (chrome 's'/'f' flow events).

    Two arrow mechanisms: parent/span-id links (the submit→execute task
    path, where the child ships the parent ctx in its TaskSpec), and
    explicit ``flow_id`` attrs for planes where no ctx can ride the
    wire — a channel frame has a fixed raw header, so the producer and
    consumer spans both carry ``flow_id="<channel>:<seq>"`` and the
    arrow is stitched here, at merge time, across processes."""
    events = []
    for s in spans:
        events.append({
            "name": s["name"], "cat": s["kind"], "ph": "X",
            "ts": s["start"] * 1e6,
            "dur": max(1.0, (s.get("end", s["start"]) - s["start"]) * 1e6),
            "pid": s["pid"], "tid": s["trace_id"][:8],
            "args": {k: str(v) for k, v in s.get("attrs", {}).items()},
        })
        if s.get("parent_id"):
            # flow arrow from the parent span's row
            events.append({
                "name": "flow", "cat": "trace", "ph": "f", "bp": "e",
                "id": s["parent_id"], "ts": s["start"] * 1e6,
                "pid": s["pid"], "tid": s["trace_id"][:8],
            })
        if s["kind"] == "producer":
            events.append({
                "name": "flow", "cat": "trace", "ph": "s",
                "id": s["span_id"],
                "ts": s["start"] * 1e6,
                "pid": s["pid"], "tid": s["trace_id"][:8],
            })
        flow_id = s.get("attrs", {}).get("flow_id")
        if flow_id:
            events.append({
                "name": "hop", "cat": "channel",
                "ph": "s" if s["kind"] == "producer" else "f",
                "bp": "e", "id": str(flow_id),
                "ts": s["start"] * 1e6,
                "pid": s["pid"], "tid": s["trace_id"][:8],
            })
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
    return events
