"""HTTP proxy actor.

Reference: `python/ray/serve/_private/proxy.py:748,1112` (HTTPProxy /
ProxyActor). An HTTP server inside an actor routes
`{route_prefix}` → deployment handle; JSON bodies become the request
argument, results are JSON-encoded. The server is the port's own
(`_private/http.py`, on asyncio streams) where the JAX package's proxy
runs aiohttp: the routes, status codes, bodies, `Content-Type`s, stream
chunks and ASGI scopes are the same.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch._private import http
from ray_tpu_torch.serve.handle import DeploymentHandle


class HTTPProxy:
    def __init__(self, controller, host: str = "127.0.0.1",
                 port: int = 8000):
        self._controller = controller
        self._host = host
        self._port = port
        self._handles: Dict[str, DeploymentHandle] = {}
        # route -> (replica-set version, is_streaming)
        self._streaming_routes: Dict[str, tuple] = {}
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="http_proxy")
        self._thread.start()
        self._started.wait(timeout=30)

    def ready(self) -> Dict[str, Any]:
        return {"host": self._host, "port": self._port}

    def _match_route(self, path: str) -> Optional[tuple]:
        """Longest-prefix route match; returns (prefix, deployment)."""
        routes = ray_tpu_torch.get(self._controller.get_routes.remote(),
                             timeout=30)
        best = None
        for prefix, name in routes.items():
            if prefix and (path == prefix or
                           path.startswith(prefix.rstrip("/") + "/")):
                if best is None or len(prefix) > len(best[0]):
                    best = (prefix, name)
        return best

    def _serve(self):
        _STREAM = object()  # marker: second element is a chunk generator
        _ASGI = object()    # marker: second element is a send-event gen

        def dispatch_blocking(path: str, raw_body: Optional[bytes],
                              scope_base: dict):
            """Route + dispatch + await — everything that can block on
            controller/replica RPCs runs in the executor, never on the
            event loop."""
            match = self._match_route(path)
            if match is None:
                return 404, {"error": f"no route for {path}"}
            prefix, name = match
            if name not in self._handles:
                self._handles[name] = DeploymentHandle(
                    self._controller, name)
            handle = self._handles[name]
            # route dispatch kind, cached per replica-set version: a
            # redeploy may swap an ASGI/generator implementation for a
            # plain one (or vice versa). kinds: "asgi"|"stream"|"unary"
            handle._router._refresh()
            version = handle._router._version
            cached = self._streaming_routes.get(name)
            if cached is None or cached[0] != version:
                if handle._is_asgi():
                    kind = "asgi"
                elif handle._is_streaming_method():
                    kind = "stream"
                else:
                    kind = "unary"
                cached = (version, kind)
                self._streaming_routes[name] = cached
            kind = cached[1]
            if kind == "asgi":
                # raw scope hand-off (reference `@serve.ingress`): the
                # app sees the full path with the matched route prefix as
                # root_path, per the ASGI spec
                scope = dict(scope_base)
                scope["root_path"] = "" if prefix == "/" \
                    else prefix.rstrip("/")
                return _ASGI, handle._submit_asgi(scope, raw_body or b"")
            if raw_body:
                try:
                    body = json.loads(raw_body)
                except json.JSONDecodeError:
                    body = raw_body.decode()
            else:
                body = None
            if kind == "stream":
                h = handle.options(stream=True)
                gen = h.remote(body) if body is not None else h.remote()
                return _STREAM, gen
            resp = handle.remote(body) if body is not None \
                else handle.remote()
            return 200, resp.result(timeout=60)

        async def handler(request: http.Request):
            raw_body = request.body or None
            # plain-data ASGI scope (it crosses an RPC to the replica)
            peer = request.peer
            scope_base = {
                "type": "http",
                "asgi": {"version": "3.0", "spec_version": "2.3"},
                "http_version": "1.1",
                "method": request.method,
                "scheme": "http",
                "path": request.path,
                "raw_path": request.raw_path.encode(),
                "query_string": request.query_string.encode(),
                "headers": [(k.lower().encode(), v.encode())
                            for k, v in request.headers],
                "client": tuple(peer[:2]) if peer else None,
                "server": (self._host, self._port),
            }
            loop = asyncio.get_event_loop()
            try:
                status, result = await loop.run_in_executor(
                    None, dispatch_blocking, request.path, raw_body,
                    scope_base)
            except Exception as e:  # noqa: BLE001 — surfaced as HTTP 500
                return http.json_response({"error": str(e)}, status=500)
            if status is _ASGI:
                gen = result
                resp = http.StreamResponse()
                started = False
                try:
                    while True:
                        ev = await loop.run_in_executor(
                            None, next, gen, _ASGI)
                        if ev is _ASGI:
                            break
                        t = ev.get("type")
                        if t == "http.response.start":
                            resp.set_status(ev.get("status", 200))
                            for hk, hv in ev.get("headers", []):
                                name = hk.decode() if isinstance(
                                    hk, (bytes, bytearray)) else hk
                                val = hv.decode() if isinstance(
                                    hv, (bytes, bytearray)) else hv
                                if name.lower() in ("content-length",
                                                    "transfer-encoding"):
                                    continue  # the server frames the body
                                # added, not assigned: multi-value
                                # headers (Set-Cookie) must all survive
                                resp.add_header(name, val)
                            await resp.prepare(request)
                            started = True
                        elif t == "http.response.body":
                            if not started:
                                await resp.prepare(request)
                                started = True
                            chunk = ev.get("body", b"")
                            if chunk:
                                await resp.write(bytes(chunk))
                        elif t == "serve.error":
                            if not started:
                                return http.json_response(
                                    {"error": ev.get("error", "ASGI app "
                                                              "failed")},
                                    status=500)
                            break  # mid-stream failure: truncate
                finally:
                    gen.close()
                if not started:
                    await resp.prepare(request)
                await resp.write_eof()
                return resp
            if status is _STREAM:
                # JSON-lines chunked response; each chunk flushes as the
                # replica yields it
                resp = http.StreamResponse(
                    headers={"Content-Type": "application/jsonl"})
                await resp.prepare(request)
                gen = result
                try:
                    while True:
                        chunk = await loop.run_in_executor(
                            None, next, gen, _STREAM)
                        if chunk is _STREAM:
                            break
                        await resp.write(
                            (json.dumps(chunk) + "\n").encode())
                except Exception as e:  # noqa: BLE001
                    await resp.write(
                        (json.dumps({"error": str(e)}) + "\n").encode())
                finally:
                    gen.close()
                await resp.write_eof()
                return resp
            try:
                return http.json_response(result, status=status)
            except TypeError:
                return http.text_response(str(result), status=status)

        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        loop.run_until_complete(
            http.start_server(handler, self._host, self._port))
        self._started.set()
        loop.run_forever()
