"""Task specification — the unit shipped from submitter to executor.

Equivalent of the reference's `TaskSpecification`
(`src/ray/common/task/task_spec.h:247`), kept msgpack-serializable so it can
ride the RPC layer without a separate proto toolchain. Args are a list of
entries, each either an inlined serialized value or an object reference
(top-level ObjectRef args become dependencies; the executor resolves them to
values before invoking the function — reference semantics).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

NORMAL_TASK = "normal"
ACTOR_CREATION_TASK = "actor_creation"
ACTOR_TASK = "actor"

# Scheduling strategies (reference: python/ray/util/scheduling_strategies.py).
STRATEGY_DEFAULT = "DEFAULT"
STRATEGY_SPREAD = "SPREAD"
STRATEGY_NODE_AFFINITY = "NODE_AFFINITY"
STRATEGY_PLACEMENT_GROUP = "PLACEMENT_GROUP"


@dataclass(slots=True)
class TaskSpec:
    task_id: bytes
    job_id: bytes
    name: str
    task_type: str = NORMAL_TASK
    # Function: either a KV key into the GCS function table (normal path) or
    # an inline pickled callable (actor creation ships the class inline).
    function_key: Optional[bytes] = None
    # Serialized positional args: list of ("v", frame_bytes) | ("r", id, owner_addr).
    args: List = field(default_factory=list)
    # Serialized kwargs: {name: same entry form}.
    kwargs: Dict[str, Any] = field(default_factory=dict)
    num_returns: int = 1
    resources: Dict[str, float] = field(default_factory=dict)
    owner_addr: str = ""
    owner_worker_id: bytes = b""
    # Actor fields.
    actor_id: Optional[bytes] = None
    method_name: Optional[str] = None
    seq_no: int = 0
    # Sequence epoch: bumped by the submitter whenever it restarts seq
    # numbering (actor restart OR reconnect after a connection loss), so the
    # executor can resynchronize its reorder buffer instead of waiting
    # forever on a seq that died with the old connection.
    seq_epoch: int = 0
    max_restarts: int = 0
    max_concurrency: int = 1
    # Scheduling.
    strategy: str = STRATEGY_DEFAULT
    node_id: Optional[bytes] = None  # NODE_AFFINITY target
    soft: bool = False
    placement_group_id: Optional[bytes] = None
    bundle_index: int = -1
    max_retries: int = 0
    runtime_env: Optional[dict] = None
    # Detached actors outlive their creator job.
    detached: bool = False
    actor_name: Optional[str] = None
    # Streaming generator task (num_returns="streaming"): the executor
    # reports each yielded item to the owner as it is produced
    # (reference: ReportGeneratorItemReturns, core_worker.proto:462).
    streaming: bool = False
    # Tracing context {trace_id, span_id} propagated submitter → executor
    # (reference: span context in task metadata, tracing_helper.py:326).
    trace_ctx: Optional[dict] = None
    # Named concurrency groups (reference:
    # src/ray/core_worker/transport/concurrency_group_manager.h):
    # creation carries {group_name: max_concurrency}; an actor task may
    # name the group it runs in ('' = the method's declared group, or
    # the default group).
    concurrency_groups: Optional[Dict[str, int]] = None
    concurrency_group: str = ""
    # Submitter-local only (never on the wire; must stay the LAST field
    # so `from_wire`'s positional splat fills exactly the wire fields):
    # the nested ObjectRefs found while serializing args, as
    # (object_id, owner_addr) pairs. Truthy ⇒ the spec must not ride a
    # multi-task batch (see CoreWorker._batchable); the pairs join
    # plasma_deps() so the owner pins them for the task's lifetime.
    _nested_refs: Any = False

    # Positional wire encoding: a flat msgpack array in field order.
    # Packing 29 values is ~3x cheaper than a 29-key string map (no key
    # strings packed/hashed per message), and this is the hottest
    # serialization in the system — every task submission ships one.
    _WIRE_FIELDS = (
        "task_id", "job_id", "name", "task_type", "function_key",
        "args", "kwargs", "num_returns", "resources", "owner_addr",
        "owner_worker_id", "actor_id", "method_name", "seq_no",
        "seq_epoch", "max_restarts", "max_concurrency", "strategy",
        "node_id", "soft", "placement_group_id", "bundle_index",
        "max_retries", "runtime_env", "detached", "actor_name",
        "streaming", "trace_ctx", "concurrency_groups",
        "concurrency_group",
    )

    def to_wire(self) -> list:
        return [
            self.task_id, self.job_id, self.name, self.task_type,
            self.function_key, self.args, self.kwargs, self.num_returns,
            self.resources, self.owner_addr, self.owner_worker_id,
            self.actor_id, self.method_name, self.seq_no, self.seq_epoch,
            self.max_restarts, self.max_concurrency, self.strategy,
            self.node_id, self.soft, self.placement_group_id,
            self.bundle_index, self.max_retries, self.runtime_env,
            self.detached, self.actor_name, self.streaming,
            self.trace_ctx, self.concurrency_groups,
            self.concurrency_group,
        ]

    @classmethod
    def from_wire(cls, wire) -> "TaskSpec":
        # msgpack round-trips lists as lists; args entries arrive as lists.
        return cls(*wire)

    def plasma_deps(self) -> List[tuple[bytes, str]]:
        """(object_id, owner_addr) for every by-reference arg — top-level
        entries plus (submitter side only) refs nested inside by-value
        containers. Wire-decoded specs carry no nested list, so executor/
        raylet callers see just the top-level deps."""
        deps = []
        for entry in self.args:
            if entry[0] == "r":
                deps.append((entry[1], entry[2]))
        for entry in self.kwargs.values():
            if entry[0] == "r":
                deps.append((entry[1], entry[2]))
        if isinstance(self._nested_refs, list):
            deps.extend(
                (oid, owner) for oid, owner in self._nested_refs)
        return deps

    def scheduling_key(self) -> tuple:
        """Tasks with the same key can reuse a cached worker lease
        (reference: SchedulingKey in direct_task_transport.h). The
        runtime env is part of the key: a lease's worker is materialized
        for ONE env, so tasks with different envs must never share a
        drain queue."""
        from ray_tpu_torch._private.runtime_env import env_hash

        return (
            self.function_key,
            tuple(sorted(self.resources.items())),
            self.strategy,
            self.node_id,
            self.placement_group_id,
            self.bundle_index,
            env_hash(self.runtime_env),
        )


# from_wire unpacks positionally — the wire tuple and the dataclass field
# order must stay in lockstep (submitter-local fields trail the wire
# fields, defaulted) or every spec silently corrupts.
_LOCAL_FIELDS = ("_nested_refs",)
assert TaskSpec._WIRE_FIELDS + _LOCAL_FIELDS == tuple(
    f.name for f in TaskSpec.__dataclass_fields__.values()), \
    "TaskSpec._WIRE_FIELDS out of sync with field order"
