"""Ray Client equivalent: thin remote drivers over the native RPC.

Reference: `python/ray/util/client/` (3.8k LoC gRPC proxy — "ray://"
addresses). The port's copy of `ray_tpu/util/client/__init__.py`. A
remote machine with no cluster daemons gets the full task/actor/object
API by proxying every call to a `ClientServer` attached to the cluster.
Entry point:
`ray_tpu_torch.init(address="client://host:port")`, which routes the
module-level `put/get/wait/remote/kill/get_actor/...` through a
`ClientContext` instead of a local CoreWorker.

Protocol-level design deltas vs the reference: the wire is the native
length-prefixed msgpack RPC (no gRPC/protobuf), functions and actor
classes ship once keyed by pickle SHA, top-level args travel as
("v", pickled) | ("r", ref-id) entries exactly like TaskSpec, and
nested refs/actor handles ride pickle persistent-ids (common.py).
Tensors travel as the port's serializer carries them: a CUDA tensor is
copied to the host on the client, stays on the host in the client
server, and lands on the `cuda` device of the process that reads it.
"""

from __future__ import annotations

import asyncio
import hashlib
import threading
from typing import Any, Dict, List, Optional, Sequence

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.rpc import RpcClient
from ray_tpu_torch.util.client.common import pack_args as _pack_args


def _wire_args(args, kwargs):
    return _pack_args(args, kwargs, ClientObjectRef, ClientActorHandle)


class ClientObjectRef:
    __slots__ = ("ref_id", "_ctx")

    def __init__(self, ref_id: bytes, ctx: "ClientContext"):
        self.ref_id = ref_id
        self._ctx = ctx

    def binary(self) -> bytes:
        return self.ref_id

    def hex(self) -> str:
        return self.ref_id.hex()

    def __repr__(self):
        return f"ClientObjectRef({self.ref_id.hex()[:16]})"

    def __hash__(self):
        return hash(self.ref_id)

    def __eq__(self, other):
        return (isinstance(other, ClientObjectRef)
                and other.ref_id == self.ref_id)

    def __del__(self):
        ctx = self._ctx
        if ctx is not None and not ctx._closed:
            ctx._release(self.ref_id)


class ClientRemoteFunction:
    def __init__(self, ctx: "ClientContext", fn, options: dict):
        self._ctx = ctx
        self._fn = fn
        self._options = dict(options)
        self._key: Optional[bytes] = None
        self._pickled: Optional[bytes] = None

    def options(self, **opts) -> "ClientRemoteFunction":
        f = ClientRemoteFunction(self._ctx, self._fn,
                                 {**self._options, **opts})
        f._key, f._pickled = self._key, self._pickled
        return f

    def _ensure_registered(self):
        if self._pickled is None:
            self._pickled = serialization.dumps(self._fn)
            self._key = hashlib.sha256(self._pickled).digest()
        if not getattr(self, "_registered", False):
            # one round-trip total — the server dedupes by content key
            self._ctx._call("register_function",
                            {"key": self._key, "function": self._pickled})
            self._registered = True

    def remote(self, *args, **kwargs):
        self._ensure_registered()
        wire_args, wire_kwargs = _wire_args(args, kwargs)
        reply = self._ctx._call("submit_task", {
            "session": self._ctx._session,
            "key": self._key,
            "args": wire_args,
            "kwargs": wire_kwargs,
            "options": self._options,
        })
        refs = [ClientObjectRef(r, self._ctx) for r in reply["refs"]]
        n = self._options.get("num_returns", 1)
        return refs[0] if n == 1 else refs


class ClientActorMethod:
    def __init__(self, handle: "ClientActorHandle", name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns

    def options(self, num_returns: int = 1) -> "ClientActorMethod":
        return ClientActorMethod(self._handle, self._name, num_returns)

    def remote(self, *args, **kwargs):
        ctx = self._handle._ctx
        wire_args, wire_kwargs = _wire_args(args, kwargs)
        reply = ctx._call("actor_method", {
            "session": ctx._session,
            "actor_id": self._handle._actor_id,
            "method": self._name,
            "args": wire_args,
            "kwargs": wire_kwargs,
            "num_returns": self._num_returns,
        })
        refs = [ClientObjectRef(r, ctx) for r in reply["refs"]]
        return refs[0] if self._num_returns == 1 else refs


class ClientActorHandle:
    def __init__(self, ctx: "ClientContext", actor_id: bytes):
        self._ctx = ctx
        self._actor_id = actor_id

    def __getattr__(self, name: str) -> ClientActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ClientActorMethod(self, name)

    def __repr__(self):
        return f"ClientActorHandle({self._actor_id.hex()[:16]})"


class ClientActorClass:
    def __init__(self, ctx: "ClientContext", cls, options: dict):
        self._ctx = ctx
        self._cls = cls
        self._options = dict(options)
        self._key: Optional[bytes] = None
        self._pickled: Optional[bytes] = None

    def options(self, **opts) -> "ClientActorClass":
        c = ClientActorClass(self._ctx, self._cls,
                             {**self._options, **opts})
        c._key, c._pickled = self._key, self._pickled
        return c

    def remote(self, *args, **kwargs) -> ClientActorHandle:
        if self._pickled is None:
            self._pickled = serialization.dumps(self._cls)
            self._key = hashlib.sha256(self._pickled).digest()
        if not getattr(self, "_registered", False):
            self._ctx._call("register_class",
                            {"key": self._key, "class": self._pickled})
            self._registered = True
        wire_args, wire_kwargs = _wire_args(args, kwargs)
        reply = self._ctx._call("create_actor", {
            "session": self._ctx._session,
            "key": self._key,
            "args": wire_args,
            "kwargs": wire_kwargs,
            "options": self._options,
        })
        return ClientActorHandle(self._ctx, reply["actor_id"])


class ClientContext:
    """One remote-driver connection. Owns a background asyncio loop
    thread carrying the RpcClient (the public API is synchronous)."""

    def __init__(self, address: str):
        self.address = address
        self._closed = False
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, daemon=True,
            name="ray_tpu_torch_client")
        self._thread.start()
        self._client = self._run(self._connect(address))
        self._session = self._call("connect", {})["session"]

    async def _connect(self, address: str):
        return await RpcClient(address).connect()

    def _run(self, coro, timeout: Optional[float] = 300.0):
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        return fut.result(timeout)

    def _call(self, method: str, payload: dict,
              timeout: Optional[float] = 300.0):
        """timeout=None blocks indefinitely (native-get parity)."""
        reply = self._run(
            self._client.call(method, payload, timeout=timeout), timeout)
        if isinstance(reply, dict) and reply.get("exc"):
            # server-side exception with its original type preserved
            raise serialization.loads(reply["exc"])
        if isinstance(reply, dict) and reply.get("error"):
            raise RuntimeError(f"client-server error: {reply['error']}")
        return reply

    def _release(self, ref_id: bytes):
        try:
            self._run(self._client.notify(
                "release", {"session": self._session,
                            "refs": [ref_id]}), 10.0)
        except Exception:  # interpreter teardown / lost connection
            pass

    # -- public API (mirrors the module-level surface) ---------------------

    def put(self, value: Any) -> ClientObjectRef:
        reply = self._call("put", {
            "session": self._session,
            "data": serialization.dumps(value)})
        return ClientObjectRef(reply["ref"], self)

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ClientObjectRef)
        if single:
            refs = [refs]
        reply = self._call("get", {
            "session": self._session,
            "refs": [r.ref_id for r in refs],
            "timeout": timeout,
        }, timeout=None if timeout is None else timeout + 30.0)
        values = [serialization.loads(d) for d in reply["data"]]
        return values[0] if single else values

    def wait(self, refs: Sequence[ClientObjectRef], *,
             num_returns: int = 1, timeout: Optional[float] = None):
        reply = self._call("wait", {
            "session": self._session,
            "refs": [r.ref_id for r in refs],
            "num_returns": num_returns,
            "timeout": timeout,
        }, timeout=None if timeout is None else timeout + 30.0)
        by_id = {r.ref_id: r for r in refs}
        return ([by_id[r] for r in reply["ready"]],
                [by_id[r] for r in reply["not_ready"]])

    def remote(self, fn_or_cls, **options):
        import inspect

        if inspect.isclass(fn_or_cls):
            return ClientActorClass(self, fn_or_cls, options)
        return ClientRemoteFunction(self, fn_or_cls, options)

    def kill(self, handle: ClientActorHandle, *, no_restart: bool = True):
        self._call("kill_actor", {"actor_id": handle._actor_id,
                                  "no_restart": no_restart})

    def cancel(self, ref: ClientObjectRef, *, force: bool = False,
               recursive: bool = True):
        self._call("cancel", {"ref": ref.ref_id, "force": force,
                              "recursive": recursive})

    def get_actor(self, name: str) -> ClientActorHandle:
        try:
            reply = self._call("get_named_actor", {"name": name})
        except RuntimeError as e:
            raise ValueError(str(e)) from None
        return ClientActorHandle(self, reply["actor_id"])

    def cluster_resources(self) -> Dict[str, float]:
        return self._call("cluster_resources", {})["resources"]

    def available_resources(self) -> Dict[str, float]:
        return self._call("available_resources", {})["resources"]

    def ping(self) -> bool:
        """Cheap liveness probe of the attached ClientServer — True
        when the control connection still answers."""
        try:
            return bool(self._call("ping", {}, timeout=10.0)["ok"])
        except Exception:  # noqa: BLE001 — dead link IS the answer
            return False

    def disconnect(self):
        if self._closed:
            return
        self._closed = True
        try:
            self._run(self._client.call(
                "disconnect", {"session": self._session}, timeout=10.0),
                15.0)
        except Exception:
            pass
        try:
            self._run(self._client.close(), 10.0)
        except Exception:
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5.0)
