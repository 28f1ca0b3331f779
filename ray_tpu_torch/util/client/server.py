"""Client server: the cluster-side proxy executing remote drivers' calls.

Reference: `python/ray/util/client/server/server.py` — a proxy process
on the cluster holds the real driver state (object refs, actor handles,
shipped function definitions) on behalf of thin remote clients. Here it
is a plain asyncio RpcServer over the native msgpack protocol, started
by `python -m ray_tpu_torch client-server --address <gcs> --port <p>`.
The port's copy of `ray_tpu/util/client/server.py`. The server relays
values without computing with them: it reads CUDA tensors onto the host
(`serialization.relay_cuda_tensors`), so it needs no GPU.

Blocking data-plane calls (get/wait/submit) run in the default thread
executor so one slow client cannot stall the server's event loop.
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Any, Dict

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.rpc import RpcServer
from ray_tpu_torch.util.client.common import dump_exception, unpack_args

logger = logging.getLogger(__name__)


class ClientServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 10001):
        import ray_tpu_torch

        self._ray = ray_tpu_torch
        serialization.relay_cuda_tensors()
        self._server = RpcServer(host, port)
        self._server.register_all(self)
        # server-side state per client session
        self._refs: Dict[bytes, Any] = {}       # ref_id -> ObjectRef
        self._actors: Dict[bytes, Any] = {}     # actor_id -> ActorHandle
        self._functions: Dict[bytes, Any] = {}  # sha -> RemoteFunction
        self._classes: Dict[bytes, Any] = {}    # sha -> ActorClass
        self._sessions: Dict[str, set] = {}     # session -> ref ids

    async def start(self):
        await self._server.start()
        return self._server.address

    async def stop(self):
        await self._server.stop()

    def _track(self, session: str, ref) -> bytes:
        rid = ref.binary()
        self._refs[rid] = ref
        self._sessions.setdefault(session, set()).add(rid)
        return rid

    def _resolve(self, rid: bytes):
        ref = self._refs.get(rid)
        if ref is None:
            raise ValueError(f"unknown ref {rid.hex()[:12]} "
                             "(released or wrong session?)")
        return ref

    def _resolve_actor(self, aid: bytes):
        handle = self._actors.get(aid)
        if handle is None:
            raise ValueError(f"unknown actor {aid.hex()[:12]}")
        return handle

    def _unpack(self, req):
        return unpack_args(req["args"], req["kwargs"], self._resolve,
                           self._resolve_actor)

    async def _blocking(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(
            None, fn, *args)

    # -- protocol handlers -------------------------------------------------

    async def rpc_connect(self, req):
        session = os.urandom(8).hex()
        self._sessions[session] = set()
        return {"session": session}

    async def rpc_disconnect(self, req):
        for rid in self._sessions.pop(req["session"], set()):
            self._refs.pop(rid, None)
        return {"ok": True}

    async def rpc_put(self, req):
        value = serialization.loads(req["data"])
        ref = await self._blocking(self._ray.put, value)
        return {"ref": self._track(req["session"], ref)}

    async def rpc_get(self, req):
        refs = [self._resolve(r) for r in req["refs"]]
        timeout = req.get("timeout")

        def do_get():
            return self._ray.get(refs, timeout=timeout)

        try:
            values = await self._blocking(do_get)
        except Exception as e:  # noqa: BLE001 — retyped client-side
            return {"exc": dump_exception(e)}
        return {"data": [serialization.dumps(v) for v in values]}

    async def rpc_wait(self, req):
        refs = [self._resolve(r) for r in req["refs"]]

        def do_wait():
            return self._ray.wait(
                refs, num_returns=req.get("num_returns", 1),
                timeout=req.get("timeout"))

        try:
            ready, not_ready = await self._blocking(do_wait)
        except Exception as e:  # noqa: BLE001
            return {"exc": dump_exception(e)}
        return {"ready": [r.binary() for r in ready],
                "not_ready": [r.binary() for r in not_ready]}

    async def rpc_cancel(self, req):
        ref = self._resolve(req["ref"])

        def do_cancel():
            return self._ray.cancel(ref, force=req.get("force", False),
                                    recursive=req.get("recursive", True))

        try:
            await self._blocking(do_cancel)
        except Exception as e:  # noqa: BLE001
            return {"exc": dump_exception(e)}
        return {"ok": True}

    async def rpc_release(self, req):
        sess = self._sessions.get(req.get("session", ""), set())
        for rid in req["refs"]:
            self._refs.pop(rid, None)
            sess.discard(rid)
        return {"ok": True}

    async def rpc_register_function(self, req):
        key = req["key"]
        if key not in self._functions:
            fn = serialization.loads(req["function"])
            self._functions[key] = self._ray.remote(fn)
        return {"ok": True}

    async def rpc_submit_task(self, req):
        fn = self._functions.get(req["key"])
        if fn is None:
            return {"error": "function not registered"}
        args, kwargs = self._unpack(req)
        opts = req.get("options") or {}
        target = fn.options(**opts) if opts else fn

        def submit():
            return target.remote(*args, **kwargs)

        refs = await self._blocking(submit)
        if not isinstance(refs, list):
            refs = [refs]
        session = req["session"]
        return {"refs": [self._track(session, r) for r in refs]}

    async def rpc_register_class(self, req):
        key = req["key"]
        if key not in self._classes:
            cls = serialization.loads(req["class"])
            self._classes[key] = self._ray.remote(cls)
        return {"ok": True}

    async def rpc_create_actor(self, req):
        cls = self._classes.get(req["key"])
        if cls is None:
            return {"error": "class not registered"}
        args, kwargs = self._unpack(req)
        opts = req.get("options") or {}
        target = cls.options(**opts) if opts else cls

        def create():
            return target.remote(*args, **kwargs)

        handle = await self._blocking(create)
        aid = handle._actor_id.binary()
        self._actors[aid] = handle
        return {"actor_id": aid}

    async def rpc_actor_method(self, req):
        handle = self._actors.get(req["actor_id"])
        if handle is None:
            return {"error": "unknown actor"}
        args, kwargs = self._unpack(req)
        method = getattr(handle, req["method"])
        num_returns = req.get("num_returns", 1)

        def call():
            m = (method.options(num_returns=num_returns)
                 if num_returns != 1 else method)
            return m.remote(*args, **kwargs)

        refs = await self._blocking(call)
        if not isinstance(refs, list):
            refs = [refs]
        session = req["session"]
        return {"refs": [self._track(session, r) for r in refs]}

    async def rpc_get_named_actor(self, req):
        try:
            handle = await self._blocking(self._ray.get_actor,
                                          req["name"])
        except ValueError as e:
            return {"error": str(e)}
        aid = handle._actor_id.binary()
        self._actors[aid] = handle
        return {"actor_id": aid}

    async def rpc_kill_actor(self, req):
        handle = self._actors.get(req["actor_id"])
        if handle is not None:
            await self._blocking(
                lambda: self._ray.kill(
                    handle, no_restart=req.get("no_restart", True)))
        return {"ok": True}

    async def rpc_cluster_resources(self, req):
        return {"resources": await self._blocking(
            self._ray.cluster_resources)}

    async def rpc_available_resources(self, req):
        return {"resources": await self._blocking(
            self._ray.available_resources)}

    async def rpc_ping(self, req):
        return {"ok": True}


def main(argv=None):
    import argparse

    import ray_tpu_torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--address", required=True,
                        help="GCS address of the cluster to attach to")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=10001)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    ray_tpu_torch.init(address=args.address)
    server = ClientServer(args.host, args.port)

    async def run():
        addr = await server.start()
        # ready-line handshake, same convention as the daemons
        print(f"CLIENT_SERVER_READY {addr}", flush=True)
        await asyncio.Event().wait()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    finally:
        ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
