"""ObjectRef — a distributed future referencing an object owned by a worker.

Reference: `ObjectRef` in `python/ray/_raylet.pyx` + the ownership model of
`src/ray/core_worker/reference_count.h`: every object has exactly one owner
(the worker that created it); the ref carries the owner's address so any
holder can resolve status/location. Pickling a ref inside task args registers
the receiving worker as a borrower when deserialized.
"""

from __future__ import annotations

import threading
from typing import Optional

from ray_tpu_torch._private.ids import ObjectID

# Process-global hook: the active CoreWorker registers itself here so that
# ObjectRefs deserialized from task args / nested structures bind to it
# (reference: per-process Worker singleton in python/ray/_private/worker.py).
_context = threading.local()
_global_core_worker = None


def set_core_worker(cw) -> None:
    global _global_core_worker
    _global_core_worker = cw


def get_core_worker():
    return _global_core_worker


class ObjectRef:
    __slots__ = ("_id", "_owner_addr", "_weakref_slot", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_addr: str = ""):
        self._id = object_id
        self._owner_addr = owner_addr
        cw = _global_core_worker
        if cw is not None:
            cw.register_ref(self)

    @property
    def id(self) -> ObjectID:
        return self._id

    @property
    def owner_addr(self) -> str:
        return self._owner_addr

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def future(self):
        """A concurrent.futures.Future resolving to the object's value."""
        cw = _global_core_worker
        if cw is None:
            raise RuntimeError("ray_tpu_torch is not initialized")
        return cw.as_future(self)

    def __await__(self):
        """Allow `await ref` inside async actors."""
        cw = _global_core_worker
        if cw is None:
            raise RuntimeError("ray_tpu_torch is not initialized")
        return cw.await_ref(self).__await__()

    def __reduce__(self):
        return (_reconstruct_ref, (self._id.binary(), self._owner_addr))

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __del__(self):
        cw = _global_core_worker
        if cw is not None:
            try:
                cw.deregister_ref(self)
            except Exception:
                pass


def _reconstruct_ref(id_bytes: bytes, owner_addr: str) -> ObjectRef:
    return ObjectRef(ObjectID(id_bytes), owner_addr)
