"""Workflow executor: checkpointed step-by-step DAG execution.

Reference: `python/ray/workflow/workflow_executor.py:32` (the in-flight
execution state machine) + `workflow_storage.py` (step-result storage).
Steps are content-keyed by their position in the DAG; a completed step's
pickled result short-circuits re-execution on resume.

Dynamic workflows (reference: `workflow.continuation`
and the dynamic-DAG growth in `workflow_executor.py`): a step may RETURN
`workflow.continuation(sub_dag)` — the executor checkpoints the returned
sub-DAG under the parent step's key, then executes it in a nested step
namespace. Recovery crosses the boundary: a crash mid-continuation
resumes INTO the continuation (rebuilt from the parent's checkpoint)
without re-running the parent, and completed continuation steps skip via
their own checkpoints. Chained continuations (a continuation returning
another continuation) unwind iteratively, so recursion depth is bounded
by the continuation chain, not the Python stack.

Durable events (reference `workflow.wait_for_event` /
`python/ray/workflow/event_listener.py`): `wait_for_event(name)` is a
step that blocks until `send_event(workflow_id, name, payload)` lands;
the received payload checkpoints like any step result, so a resumed
workflow does not re-wait a consumed event.

The port's copy of `ray_tpu/workflow/execution.py`, over the port's
`dag.py` and serializer. Its default storage is
`~/.ray_tpu_torch_workflows` (the JAX package's `~/.ray_tpu_workflows`);
a step's checkpoint file has the same name in both packages.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private import serialization
from ray_tpu_torch.dag import DAGNode, InputNode

_storage_root = os.path.expanduser("~/.ray_tpu_torch_workflows")

RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"


class Continuation:
    """A step's request to continue INTO a dynamically-built sub-DAG
    (reference `workflow.continuation`): the workflow's final value for
    that step becomes the sub-DAG's result."""

    def __init__(self, node: DAGNode):
        if not isinstance(node, DAGNode):
            raise TypeError("continuation() takes a bound DAG node")
        self.node = node


def continuation(node: DAGNode) -> Continuation:
    return Continuation(node)


class EventStep:
    """Durable external-event wait (reference `workflow.wait_for_event`):
    blocks the workflow until `send_event(workflow_id, name, payload)`;
    the payload checkpoints as the step's value."""

    def __init__(self, name: str):
        self.name = name


def wait_for_event(name: str) -> EventStep:
    return EventStep(name)


def send_event(workflow_id: str, name: str, payload: Any = None) -> None:
    """Deliver an event to a (possibly running) workflow. Durable: the
    payload is written before the waiting step can observe it."""
    wf_dir = _wf_dir(workflow_id)
    os.makedirs(wf_dir, exist_ok=True)
    _write(os.path.join(wf_dir, f"event-{name}.pkl"), payload)


def init(storage: Optional[str] = None) -> None:
    global _storage_root
    if storage:
        _storage_root = storage
    os.makedirs(_storage_root, exist_ok=True)


def _wf_dir(workflow_id: str) -> str:
    return os.path.join(_storage_root, workflow_id)


def _write(path: str, obj: Any) -> None:
    # cloudpickle: step functions are often closures/lambdas the stdlib
    # pickler cannot serialize
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(serialization.dumps(obj))
    os.replace(tmp, path)


def _read(path: str) -> Any:
    with open(path, "rb") as f:
        return serialization.loads(f.read())


def _step_key(node: DAGNode, dag_path: str) -> str:
    """Stable identity for a step: its position in the DAG plus the
    function name (the DAG shape is fixed across resumes)."""
    name = getattr(node._fn, "__name__", "step")
    return hashlib.sha1(f"{dag_path}:{name}".encode()).hexdigest()[:16]


def _execute_node(node: Any, wf_dir: str, dag_path: str,
                  root_args: tuple,
                  run_cache: Optional[Dict[int, Any]] = None) -> Any:
    """Post-order execution with per-step checkpoints. Returns the
    step's VALUE (not a ref) — each step is a barrier, which is what
    makes the checkpoint a consistent resume point. `run_cache` dedupes
    shared (diamond) nodes within one run: a node reached via two paths
    must execute once, like dag.execute's per-run cache."""
    if isinstance(node, InputNode):
        return node.pick(root_args)
    if isinstance(node, EventStep):
        return _execute_event(node, wf_dir, dag_path)
    if not isinstance(node, DAGNode):
        return node
    if run_cache is None:
        run_cache = {}
    if id(node) in run_cache:
        return run_cache[id(node)]
    # Unwind continuations ITERATIVELY in THIS frame: each hop runs one
    # step (whose args recurse over the static DAG only) and may yield
    # the next hop's sub-DAG. A continuation chain of any length costs
    # zero extra stack — hop k's namespace is dag_path + "@c0"*k, stable
    # across resumes because the chain is rebuilt from checkpoints.
    ckpt = os.path.join(wf_dir, f"step-{_step_key(node, dag_path)}.pkl")
    cur_node, cur_path = node, dag_path
    value = _execute_step(cur_node, wf_dir, cur_path, root_args,
                          run_cache)
    had_continuation = isinstance(value, Continuation)
    while isinstance(value, Continuation):
        cur_node, cur_path = value.node, cur_path + "@c0"
        value = _execute_step(cur_node, wf_dir, cur_path, root_args,
                              run_cache)
    if had_continuation:
        _write(ckpt, value)  # collapse the record to the final value
    run_cache[id(node)] = value
    return value


def _execute_step(node: DAGNode, wf_dir: str, dag_path: str,
                  root_args: tuple, run_cache: Dict[int, Any]) -> Any:
    """Run ONE step (args resolved recursively over the static DAG) and
    return its raw value — possibly a Continuation, which the CALLER
    unwinds. The checkpoint is written before returning, so a crash
    inside a continuation resumes into it without re-running this
    step."""
    key = _step_key(node, dag_path)
    ckpt = os.path.join(wf_dir, f"step-{key}.pkl")
    if os.path.exists(ckpt):
        return _read(ckpt)
    args = [
        _execute_node(a, wf_dir, f"{dag_path}/{i}", root_args, run_cache)
        for i, a in enumerate(node._args)
    ]
    kwargs = {
        k: _execute_node(v, wf_dir, f"{dag_path}/{k}", root_args,
                         run_cache)
        for k, v in node._kwargs.items()
    }
    value = ray_tpu_torch.get(node._fn.remote(*args, **kwargs))
    _write(ckpt, value)
    return value


def _execute_event(node: EventStep, wf_dir: str, dag_path: str) -> Any:
    key = hashlib.sha1(f"{dag_path}:event:{node.name}".encode()) \
        .hexdigest()[:16]
    ckpt = os.path.join(wf_dir, f"step-{key}.pkl")
    if os.path.exists(ckpt):
        return _read(ckpt)  # event already consumed pre-crash
    path = os.path.join(wf_dir, f"event-{node.name}.pkl")
    while not os.path.exists(path):
        time.sleep(0.05)
    payload = _read(path)
    _write(ckpt, payload)
    return payload


def run(dag: DAGNode, *args, workflow_id: Optional[str] = None,
        metadata: Optional[Dict[str, Any]] = None) -> Any:
    """Execute to completion, checkpointing each step; returns the final
    value. A re-run (or `resume`) with the same workflow_id skips
    completed steps. `metadata` attaches user key/values retrievable via
    `get_metadata` (reference `workflow.run(metadata=...)`)."""
    workflow_id = workflow_id or f"wf-{int(time.time() * 1000)}"
    wf_dir = _wf_dir(workflow_id)
    os.makedirs(wf_dir, exist_ok=True)
    meta_path = os.path.join(wf_dir, "meta.pkl")
    prior = (_read(meta_path) if os.path.exists(meta_path) else {})
    _write(meta_path, {"workflow_id": workflow_id, "status": RUNNING,
                       "dag": dag, "args": args, "ts": time.time(),
                       "start_time": prior.get("start_time",
                                               time.time()),
                       "user_metadata": (metadata if metadata is not None
                                         else prior.get("user_metadata",
                                                        {}))})
    try:
        out = _execute_node(dag, wf_dir, "", args)
    except BaseException:
        meta = _read(meta_path)
        meta["status"] = FAILED
        meta["end_time"] = time.time()
        _write(meta_path, meta)
        raise
    meta = _read(meta_path)
    meta.update(status=SUCCEEDED, result=out, end_time=time.time())
    _write(meta_path, meta)
    return out


def run_async(dag: DAGNode, *args,
              workflow_id: Optional[str] = None,
              metadata: Optional[Dict[str, Any]] = None):
    """Run in a detached driver thread; returns the workflow id."""
    import threading

    workflow_id = workflow_id or f"wf-{int(time.time() * 1000)}"
    # write the meta record BEFORE returning so status() is immediately
    # answerable (the thread re-writes it as RUNNING on entry)
    wf_dir = _wf_dir(workflow_id)
    os.makedirs(wf_dir, exist_ok=True)
    _write(os.path.join(wf_dir, "meta.pkl"),
           {"workflow_id": workflow_id, "status": RUNNING, "dag": dag,
            "args": args, "ts": time.time(), "start_time": time.time(),
            "user_metadata": metadata or {}})
    threading.Thread(
        target=lambda: _swallow(run, dag, *args,
                                workflow_id=workflow_id,
                                metadata=metadata),
        daemon=True).start()
    return workflow_id


def _swallow(fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except BaseException:  # noqa: BLE001 — recorded in meta
        pass


def resume(workflow_id: str) -> Any:
    """Re-run a failed/interrupted workflow: completed steps come from
    their checkpoints, only the rest re-execute (reference:
    `workflow.resume`)."""
    meta = _read(os.path.join(_wf_dir(workflow_id), "meta.pkl"))
    return run(meta["dag"], *meta["args"], workflow_id=workflow_id)


def status(workflow_id: str) -> str:
    return _read(os.path.join(_wf_dir(workflow_id), "meta.pkl"))["status"]


def get_metadata(workflow_id: str) -> Dict[str, Any]:
    """Workflow metadata (reference `workflow.get_metadata`): status,
    timing, user metadata, and the completed-step checkpoint count."""
    wf_dir = _wf_dir(workflow_id)
    meta = _read(os.path.join(wf_dir, "meta.pkl"))
    steps = [f for f in os.listdir(wf_dir) if f.startswith("step-")]
    return {
        "workflow_id": workflow_id,
        "status": meta["status"],
        "start_time": meta.get("start_time"),
        "end_time": meta.get("end_time"),
        "user_metadata": dict(meta.get("user_metadata", {})),
        "steps_checkpointed": len(steps),
    }


def get_output(workflow_id: str) -> Any:
    meta = _read(os.path.join(_wf_dir(workflow_id), "meta.pkl"))
    if meta["status"] != SUCCEEDED:
        raise RuntimeError(f"workflow {workflow_id} is {meta['status']}")
    return meta["result"]


def list_all() -> List[Dict[str, Any]]:
    out = []
    if not os.path.isdir(_storage_root):
        return out
    for wid in os.listdir(_storage_root):
        meta_path = os.path.join(_storage_root, wid, "meta.pkl")
        if os.path.exists(meta_path):
            meta = _read(meta_path)
            out.append({"workflow_id": wid, "status": meta["status"]})
    return out
