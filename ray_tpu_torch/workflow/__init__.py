"""Durable workflows: DAG execution with step-level checkpoints + resume.

Reference: `python/ray/workflow/` — `workflow.run` executes a DAG of
steps with each step's output checkpointed to storage
(`workflow_executor.py:32`, `workflow_storage.py`), so a crashed
workflow resumes from the last completed step rather than restarting.

Surface here: `workflow.run(dag_node, workflow_id=..., metadata=...)`
over `ray_tpu_torch.dag` DAGs, `workflow.resume(workflow_id)`,
`workflow.status`, `workflow.get_metadata`, `workflow.list_all`;
dynamic workflows via `workflow.continuation(sub_dag)` (a step's return
value grows the DAG, with recovery across the continuation boundary);
durable external events via `workflow.wait_for_event(name)` +
`workflow.send_event(workflow_id, name, payload)`. Storage is a
filesystem directory (set via `workflow.init(storage=...)`).

The port's copy of `ray_tpu/workflow/`: steps are the port's remote
functions, and a `num_gpus=1` step runs on a GPU worker.
"""

from ray_tpu_torch.workflow.execution import (
    continuation,
    get_metadata,
    get_output,
    init,
    list_all,
    resume,
    run,
    run_async,
    send_event,
    status,
    wait_for_event,
)

__all__ = ["init", "run", "run_async", "resume", "status", "list_all",
           "continuation", "wait_for_event", "send_event",
           "get_metadata", "get_output"]
