"""Shared wire helpers for the client protocol.

Reference: `python/ray/util/client/` — the reference's Ray Client ships
pickled functions/args over gRPC to a server-side proxy that executes
them against a real worker. Same protocol shape here over the native
msgpack RPC layer, with pickle's persistent-id protocol carrying object
refs and actor handles at ANY nesting depth: the client pickler swaps
each ClientObjectRef/ClientActorHandle for a persistent id, and the
server unpickler resolves those ids back to live ObjectRefs /
ActorHandles while deserializing — so `f.remote([ref1, ref2])` or
`f.remote(actor)` behave exactly as in native mode.

The port's copy of `ray_tpu/util/client/common.py`. Arguments pickle
through the port's tensor reduction (`serialization._reduce_tensor`),
in band: a CUDA tensor argument crosses as host bytes tagged `cuda`.
"""

from __future__ import annotations

import io
import pickle
import sys
from typing import Any, Dict, List, Tuple

import cloudpickle

from ray_tpu_torch._private import serialization


def client_dumps(obj: Any, ref_cls, handle_cls) -> bytes:
    """Client side: cloudpickle with refs/handles externalized."""
    buf = io.BytesIO()

    class _Pickler(cloudpickle.CloudPickler):
        def persistent_id(self, o):
            if isinstance(o, ref_cls):
                return ("ref", o.ref_id)
            if isinstance(o, handle_cls):
                return ("actor", o._actor_id)
            return None

        def reducer_override(self, o):
            torch = sys.modules.get("torch")
            if torch is not None and type(o) in (torch.Tensor,
                                                 torch.nn.Parameter):
                reduced = serialization._reduce_tensor(torch, o)
                if reduced is not None:
                    return reduced
            return super().reducer_override(o)

    _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def server_loads(data: bytes, resolve_ref, resolve_actor) -> Any:
    """Server side: persistent ids -> live ObjectRef / ActorHandle."""

    class _Unpickler(pickle.Unpickler):
        def persistent_load(self, pid):
            kind, value = pid
            if kind == "ref":
                return resolve_ref(value)
            if kind == "actor":
                return resolve_actor(value)
            raise pickle.UnpicklingError(f"unknown persistent id {kind}")

    return _Unpickler(io.BytesIO(data)).load()


def pack_args(args: tuple, kwargs: dict, ref_cls,
              handle_cls) -> Tuple[List, Dict]:
    """Client side: top-level refs ride as ("r", id) so the server can
    treat them as dependencies without unpickling; everything else
    (including nested refs/handles) as ("v", client_dumps-bytes)."""
    def entry(a):
        if isinstance(a, ref_cls):
            return ("r", a.ref_id)
        return ("v", client_dumps(a, ref_cls, handle_cls))

    return [entry(a) for a in args], {k: entry(v)
                                      for k, v in kwargs.items()}


def unpack_args(wire_args: List, wire_kwargs: Dict, resolve_ref,
                resolve_actor) -> Tuple[tuple, dict]:
    """Server side: ("r", id) -> live ObjectRef, ("v", b) -> value."""
    def entry(e):
        kind, payload = e[0], e[1]
        if kind == "r":
            return resolve_ref(payload)
        return server_loads(payload, resolve_ref, resolve_actor)

    return (tuple(entry(e) for e in wire_args),
            {k: entry(e) for k, e in wire_kwargs.items()})


def dump_exception(e: BaseException) -> bytes:
    """Ship a server-side exception with its type preserved; fall back
    to a RuntimeError carrying the repr if the instance won't pickle."""
    try:
        return serialization.dumps(e)
    except Exception:  # noqa: BLE001
        return serialization.dumps(
            RuntimeError(f"{type(e).__name__}: {e}"))
