"""gRPC proxy actor.

Reference: `python/ray/serve/_private/proxy.py:534` (gRPCProxy) — the
reference runs a gRPC server per node routing RPCs to deployment
replicas, with the target application named in request metadata. Same
shape here without a protoc step: a generic-handler service
`ray_tpu.serve.ServeAPI` speaking JSON bytes —

- `Call` (unary-unary):   request `{"deployment": name, "data": ...}`
  → response `{"result": ...}`
- `CallStreaming` (unary-stream): one JSON message per chunk yielded by
  a generator deployment
- `Healthz` (unary-unary): liveness probe

Clients need no generated stubs either:
`channel.unary_unary("/ray_tpu.serve.ServeAPI/Call")(json_bytes)`.
"""

from __future__ import annotations

import json
import threading
from concurrent import futures
from typing import Any, Dict

import ray_tpu_torch
from ray_tpu_torch.serve.handle import DeploymentHandle

SERVICE = "ray_tpu.serve.ServeAPI"


class GRPCProxy:
    def __init__(self, controller, host: str = "127.0.0.1",
                 port: int = 9000):
        self._controller = controller
        self._host = host
        self._port = port
        self._handles: Dict[str, DeploymentHandle] = {}
        # deployment -> (replica-set version, is_streaming)
        self._streaming: Dict[str, tuple] = {}
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="grpc_proxy")
        self._thread.start()
        self._started.wait(timeout=30)

    def ready(self) -> Dict[str, Any]:
        return {"host": self._host, "port": self._port}

    def _handle(self, name: str) -> DeploymentHandle:
        if name not in self._handles:
            self._handles[name] = DeploymentHandle(self._controller, name)
        return self._handles[name]

    def _is_streaming(self, handle: DeploymentHandle) -> bool:
        handle._router._refresh()
        version = handle._router._version
        cached = self._streaming.get(handle._name)
        if cached is None or cached[0] != version:
            cached = (version, handle._is_streaming_method())
            self._streaming[handle._name] = cached
        return cached[1]

    def _serve(self):
        import grpc

        def parse(request: bytes, context):
            # context.abort raises to terminate the RPC — these calls
            # must stay OUTSIDE any except Exception, or the status
            # detail gets swallowed into a blank INTERNAL
            req = json.loads(request) if request else {}
            name = req.get("deployment")
            if not name:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              "missing 'deployment' field")
            return self._handle(name), req.get("data")

        def call(request: bytes, context) -> bytes:
            handle, data = parse(request, context)
            try:
                resp = (handle.remote(data) if data is not None
                        else handle.remote())
                return json.dumps(
                    {"result": resp.result(timeout=60)}).encode()
            except Exception as e:  # noqa: BLE001 — surfaced as INTERNAL
                context.abort(grpc.StatusCode.INTERNAL,
                              f"{type(e).__name__}: {e}")

        def call_streaming(request: bytes, context):
            handle, data = parse(request, context)
            streaming = False
            try:
                streaming = self._is_streaming(handle)
            except Exception as e:  # noqa: BLE001
                context.abort(grpc.StatusCode.INTERNAL,
                              f"{type(e).__name__}: {e}")
            if not streaming:
                context.abort(
                    grpc.StatusCode.FAILED_PRECONDITION,
                    f"deployment {handle._name} is not a generator")
            h = handle.options(stream=True)
            gen = h.remote(data) if data is not None else h.remote()
            try:
                for chunk in gen:
                    yield json.dumps({"result": chunk}).encode()
            except Exception as e:  # noqa: BLE001
                context.abort(grpc.StatusCode.INTERNAL,
                              f"{type(e).__name__}: {e}")
            finally:
                gen.close()

        def healthz(request: bytes, context) -> bytes:
            return b"ok"

        identity = lambda b: b  # raw-bytes (de)serializers
        handlers = grpc.method_handlers_generic_handler(SERVICE, {
            "Call": grpc.unary_unary_rpc_method_handler(
                call, identity, identity),
            "CallStreaming": grpc.unary_stream_rpc_method_handler(
                call_streaming, identity, identity),
            "Healthz": grpc.unary_unary_rpc_method_handler(
                healthz, identity, identity),
        })
        server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=16))
        server.add_generic_rpc_handlers((handlers,))
        self._port = server.add_insecure_port(
            f"{self._host}:{self._port}")
        server.start()
        self._server = server
        self._started.set()
        server.wait_for_termination()
