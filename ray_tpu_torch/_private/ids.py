"""Unique identifiers for jobs, tasks, actors, objects, nodes, and workers.

Design follows the reference's hash-derived ID scheme (`src/ray/common/id.h`):
ObjectIDs are derived from the TaskID that creates them plus a return index,
TaskIDs embed the parent ActorID (for actor tasks), and all IDs render as hex.
Sizes are fixed so IDs can live in shared-memory object tables (16 bytes).
"""

from __future__ import annotations

import hashlib
import os

ID_SIZE = 16  # bytes

_NIL = b"\xff" * ID_SIZE


class BaseID:
    __slots__ = ("_bytes",)
    _cache: dict = {}

    def __init__(self, binary: bytes):
        if len(binary) != ID_SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {ID_SIZE} bytes, got {len(binary)}"
            )
        self._bytes = binary

    @classmethod
    def from_random(cls):
        return cls(os.urandom(ID_SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(_NIL)

    def is_nil(self) -> bool:
        return self._bytes == _NIL

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return hash((type(self).__name__, self._bytes))

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    __slots__ = ()

    @classmethod
    def from_int(cls, value: int):
        return cls(value.to_bytes(ID_SIZE, "big"))


class NodeID(BaseID):
    __slots__ = ()


class WorkerID(BaseID):
    __slots__ = ()


class ActorID(BaseID):
    __slots__ = ()

    @classmethod
    def of(cls, job_id: JobID, parent_task_id: "TaskID", counter: int):
        h = hashlib.sha1()
        h.update(job_id.binary())
        h.update(parent_task_id.binary())
        h.update(counter.to_bytes(8, "big"))
        return cls(h.digest()[:ID_SIZE])


class PlacementGroupID(BaseID):
    __slots__ = ()


class TaskID(BaseID):
    """Task ids are structural: sha1(job, parent, actor)[:8] prefix +
    submission counter (5 bytes) + 3 zero bytes. The zero suffix is the
    keyspace `ObjectID.for_task_return` substitutes the return index
    into, so deriving a return id is a slice+concat instead of a hash —
    this pair is the hottest id math in the system (2 per task
    submission). The 64-bit prefix gives the same birthday-bound
    uniqueness story as the reference's hash-derived ids
    (`src/ray/common/id.h`), with counters disambiguating within a
    submitter context."""

    __slots__ = ()
    _prefix_cache: dict = {}

    @classmethod
    def for_driver(cls, job_id: JobID):
        h = hashlib.sha1(b"driver_task" + job_id.binary())
        return cls(h.digest()[:ID_SIZE])

    @classmethod
    def of(cls, job_id: JobID, parent_task_id: "TaskID", counter: int,
           actor_id: ActorID | None = None):
        key = (job_id._bytes, parent_task_id._bytes,
               None if actor_id is None else actor_id._bytes)
        prefix = cls._prefix_cache.get(key)
        if prefix is None:
            if len(cls._prefix_cache) > 4096:
                cls._prefix_cache.clear()  # workers churn parent contexts
            h = hashlib.sha1()
            h.update(job_id.binary())
            h.update(parent_task_id.binary())
            if actor_id is not None:
                h.update(actor_id.binary())
            prefix = cls._prefix_cache[key] = h.digest()[:8]
        return cls(prefix + counter.to_bytes(5, "big") + b"\x00\x00\x00")


class ObjectID(BaseID):
    __slots__ = ()

    @classmethod
    def for_task_return(cls, task_id: TaskID, return_index: int):
        # Slot the 1-based index into the task id's zero suffix (see
        # TaskID.of). Return ids and task ids live in disjoint keyspaces
        # everywhere they are stored, so index 0 colliding with the
        # task id itself would still be harmless — but 1-based keeps
        # them distinct anyway.
        return cls(task_id._bytes[:13]
                   + (return_index + 1).to_bytes(3, "big"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int):
        h = hashlib.sha1()
        h.update(b"put")
        h.update(task_id.binary())
        h.update(put_index.to_bytes(4, "big"))
        return cls(h.digest()[:ID_SIZE])
