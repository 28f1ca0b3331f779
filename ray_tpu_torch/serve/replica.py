"""Replica actor: hosts one copy of a deployment's callable.

Reference: `python/ray/serve/_private/replica.py` — runs the user
callable, tracks ongoing-request count (for pow-2 routing + autoscaling),
supports reconfigure(user_config) and health checks.
"""

from __future__ import annotations

import pickle
import threading
import time
from typing import Any, Dict, Optional

from ray_tpu_torch.serve import dispatch as _dispatch
from ray_tpu_torch.util import request_recorder as _rr
from ray_tpu_torch.util import tracing as _tracing


def _req_attrs(ctx: Optional[dict]) -> Dict[str, Any]:
    """Span attrs carrying the request's flow id — to_chrome stitches
    the handle's producer span to this replica's consumer span (and the
    engine's prefill span) by the shared ``flow_id``."""
    if not ctx:
        return {}
    return {"req_id": ctx["req_id"],
            "flow_id": f"req:{ctx['req_id']}",
            "deployment": ctx.get("deployment", "")}


class Replica:
    def __init__(self, func_or_class: Any, init_args: tuple,
                 init_kwargs: dict, user_config: Optional[Dict] = None):
        self._is_function = not isinstance(func_or_class, type)
        if self._is_function:
            self._callable = func_or_class
        else:
            self._callable = func_or_class(*init_args, **init_kwargs)
            if user_config is not None and \
                    hasattr(self._callable, "reconfigure"):
                self._callable.reconfigure(user_config)
        self._asgi_app = None
        self._asgi_loop = None
        self._ongoing = 0
        self._total = 0
        self._lock = threading.Lock()
        # dispatch plane v2 (attach_dispatch): the native request ring
        # this replica drains, batch at a time
        self._dispatch_ring = None
        self._dispatch_stop = False
        self._dispatch_thread: Optional[threading.Thread] = None
        marker = getattr(func_or_class, "__serve_asgi__", None)
        if marker is not None:
            from ray_tpu_torch.serve.asgi import resolve_app
            self._asgi_app = resolve_app(marker, self._callable)
            self._run_lifespan_startup()

    def handle_request(self, method: str, args: tuple, kwargs: dict,
                       ctx: Optional[dict] = None) -> Any:
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            with _rr.serving(ctx), \
                    _tracing.span("replica.handle_request",
                                  kind="consumer", attrs=_req_attrs(ctx)):
                if self._is_function:
                    return self._callable(*args, **kwargs)
                return getattr(self._callable, method)(*args, **kwargs)
        finally:
            with self._lock:
                self._ongoing -= 1

    def handle_request_streaming(self, method: str, args: tuple,
                                 kwargs: dict,
                                 ctx: Optional[dict] = None):
        """Generator variant: called with num_returns="streaming" so each
        yielded chunk ships to the caller as it is produced (reference:
        replica.py handle_request_streaming over the generator task
        protocol). Ongoing-count spans the whole stream — an in-progress
        stream holds autoscaling/routing weight like any request."""
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            # serving(ctx) spans the WHOLE stream: user generators run
            # lazily inside the yield-from, so engine submit() (which
            # reads request_recorder.current()) happens in this region
            with _rr.serving(ctx), \
                    _tracing.span("replica.handle_request_streaming",
                                  kind="consumer", attrs=_req_attrs(ctx)):
                if self._is_function:
                    result = self._callable(*args, **kwargs)
                else:
                    result = getattr(self._callable, method)(*args,
                                                             **kwargs)
                if hasattr(result, "__next__"):
                    yield from result
                else:
                    yield result
        finally:
            with self._lock:
                self._ongoing -= 1

    # -- ASGI ingress (reference _private/replica.py ASGI path) ----------

    def is_asgi(self) -> bool:
        return self._asgi_app is not None

    def _ensure_asgi_loop(self):
        import asyncio

        with self._lock:  # replicas serve concurrent requests: one loop
            if self._asgi_loop is None:
                loop = asyncio.new_event_loop()
                t = threading.Thread(target=loop.run_forever, daemon=True,
                                     name="replica_asgi_loop")
                t.start()
                self._asgi_loop = loop
            return self._asgi_loop

    def _run_lifespan_startup(self, timeout: float = 60.0):
        """Replay the ASGI lifespan protocol once per replica (reference:
        the replica wraps the app in a LifespanOn and awaits startup):
        frameworks build their state (DB pools, model handles,
        @app.on_event('startup')) here. Apps that don't speak lifespan
        (raise on the scope) are fine per the ASGI spec — the server
        continues without it. A lifespan `startup.failed` fails replica
        construction, matching the reference."""
        import asyncio
        import queue as queue_mod

        loop = self._ensure_asgi_loop()
        app = self._asgi_app
        started: "queue_mod.Queue" = queue_mod.Queue()

        async def run():
            in_q: asyncio.Queue = asyncio.Queue()
            await in_q.put({"type": "lifespan.startup"})
            self._lifespan_shutdown = (loop, in_q)

            async def receive():
                return await in_q.get()

            async def send(ev):
                if ev["type"] == "lifespan.startup.complete":
                    started.put(None)
                elif ev["type"] == "lifespan.startup.failed":
                    started.put(RuntimeError(
                        "ASGI lifespan startup failed: "
                        + ev.get("message", "")))

            try:
                await app({"type": "lifespan",
                           "asgi": {"version": "3.0",
                                    "spec_version": "2.0"}},
                          receive, send)
            except BaseException:  # noqa: BLE001 — app has no lifespan
                started.put(None)

        asyncio.run_coroutine_threadsafe(run(), loop)
        err = started.get(timeout=timeout)
        if err is not None:
            raise err

    #: hard cap on one ASGI request's lifetime (the unary path's analog
    #: is DeploymentResponse.result(timeout=60)); a hung app must not
    #: wedge the replica stream (and the proxy's executor thread) forever
    ASGI_REQUEST_TIMEOUT_S = 300.0

    def handle_asgi(self, scope: dict, body: bytes):
        """Run the ASGI app for one request, yielding its `send` events
        as a streaming generator — the proxy writes status/headers/chunks
        to the HTTP client as they arrive (streaming preserved). Called
        with num_returns="streaming"."""
        import asyncio
        import queue as queue_mod

        if self._asgi_app is None:
            raise RuntimeError("deployment is not an ASGI ingress")
        with self._lock:
            self._ongoing += 1
            self._total += 1
        # Bounded: a fast-streaming app with a slow HTTP client must
        # stall in send() instead of accumulating the whole response
        # body in replica memory.
        q: "queue_mod.Queue" = queue_mod.Queue(maxsize=64)
        loop = self._ensure_asgi_loop()
        app = self._asgi_app

        async def run():
            got_body = False
            # after the body, receive() BLOCKS (per the ASGI contract —
            # the next event would be a real client disconnect, which
            # this server reports only by cancelling the app when the
            # request ends). Returning http.disconnect eagerly would
            # make frameworks' listen_for_disconnect cancel live
            # streaming responses.
            hang = asyncio.Event()

            async def receive():
                nonlocal got_body
                if not got_body:
                    got_body = True
                    return {"type": "http.request", "body": body or b"",
                            "more_body": False}
                await hang.wait()
                return {"type": "http.disconnect"}

            async def send(event):
                # backpressure without blocking the (shared) ASGI loop:
                # poll-put so a full queue suspends only THIS app
                # coroutine until the proxy-side consumer drains
                while True:
                    try:
                        q.put_nowait(event)
                        return
                    except queue_mod.Full:
                        await asyncio.sleep(0.005)

            # Termination: a LIVE consumer must receive every queued
            # event plus the sentinel (backpressured send — never drop
            # data from a valid stream). A cancelled request means the
            # consumer is gone (it cancels us from its own finally /
            # timeout), so nothing is delivered and the sentinel is
            # skipped; cancellation also breaks any in-progress send's
            # poll loop, so no coroutine can spin forever.
            cancelled = False
            try:
                await app(scope, receive, send)
            except asyncio.CancelledError:
                cancelled = True
            except BaseException as e:  # noqa: BLE001 — shipped to proxy
                try:
                    await send({"type": "serve.error", "error": repr(e)})
                except asyncio.CancelledError:
                    cancelled = True
            finally:
                if not cancelled:
                    try:
                        await send(None)
                    except asyncio.CancelledError:
                        pass  # consumer left mid-sentinel

        task_box: dict = {}

        def _start():
            task_box["task"] = loop.create_task(run())

        def _cancel():
            t = task_box.get("task")
            if t is not None and not t.done():
                t.cancel()

        loop.call_soon_threadsafe(_start)
        import time as time_mod
        deadline = time_mod.monotonic() + self.ASGI_REQUEST_TIMEOUT_S
        try:
            while True:
                try:
                    ev = q.get(timeout=max(
                        0.0, deadline - time_mod.monotonic()))
                except queue_mod.Empty:
                    yield {"type": "serve.error",
                           "error": "ASGI request timed out after "
                                    f"{self.ASGI_REQUEST_TIMEOUT_S}s"}
                    return
                if ev is None:
                    break
                yield ev
        finally:
            # request over (done, timed out, or client gone): a
            # still-running app gets a real cancellation
            loop.call_soon_threadsafe(_cancel)
            with self._lock:
                self._ongoing -= 1

    def is_streaming(self, method: str) -> bool:
        """Whether the deployment's method is a (sync) generator function
        — the proxy uses this to pick a streaming HTTP response."""
        import inspect

        target = self._callable if self._is_function else \
            getattr(self._callable, method, None)
        return target is not None and (
            inspect.isgeneratorfunction(target))

    def get_metrics(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {"ongoing": float(self._ongoing),
                                   "total": float(self._total)}
        if not self._is_function and hasattr(
                self._callable, "get_autoscaling_metrics"):
            # deployment-provided load signals (serve.llm: queue depth,
            # KV-page occupancy, arena id for dead-replica reclaim) ride
            # the same poll the controller already makes
            try:
                extra = self._callable.get_autoscaling_metrics()
                if isinstance(extra, dict):
                    out.update(extra)
            except Exception:  # noqa: BLE001 — a bad user callable must
                pass           # not break liveness polling
        # request-recorder summary (this replica's in-memory ring of
        # engine records): TTFT/TPOT/attribution ride the same poll —
        # `ray_tpu top` aggregates these across replicas
        try:
            rs = _rr.summary()
            if rs.get("n"):
                out["request_summary"] = rs
        except Exception:  # noqa: BLE001
            pass
        return out

    # -- dispatch plane v2 (native request ring) --------------------------

    def attach_dispatch(self, segment: str, cookie: int,
                        deployment: str) -> int:
        """Controller RPC: start draining this replica's sub-ring of the
        deployment's native dispatch segment. serve.llm deployments hand
        the ring to the engine's pump (token frames come straight off
        `step()`); everything else gets a drain thread that re-enters
        Python once per BATCH of frames. Returns the segment mode this
        replica serves (MODE_RAW_LLM / MODE_PICKLE)."""
        if self._dispatch_ring is not None:
            return self._dispatch_ring.mode()
        ring = _dispatch.DispatchRing(segment, create=False)
        idx = ring.ring_of(cookie)
        if idx < 0:
            ring.close()
            raise RuntimeError(
                f"replica cookie {cookie:#x} not published in {segment}")
        engine = None if self._is_function else \
            getattr(self._callable, "engine", None)
        if engine is not None and hasattr(engine, "attach_intake"):
            ring.set_mode(_dispatch.MODE_RAW_LLM)
            engine.attach_intake(ring, idx, deployment)
        else:
            ring.set_mode(_dispatch.MODE_PICKLE)
            self._dispatch_stop = False
            self._dispatch_thread = threading.Thread(
                target=self._dispatch_loop, args=(ring, idx, deployment),
                daemon=True, name="dispatch_drain")
            self._dispatch_thread.start()
        self._dispatch_ring = ring
        return ring.mode()

    def detach_dispatch(self) -> None:
        self._dispatch_stop = True
        t, self._dispatch_thread = self._dispatch_thread, None
        if t is not None:
            t.join(timeout=2)
        ring, self._dispatch_ring = self._dispatch_ring, None
        if ring is not None:
            ring.close()

    def _dispatch_loop(self, ring, idx: int, deployment: str) -> None:
        while not self._dispatch_stop:
            frames = ring.drain(idx, max_frames=64)
            if not frames:
                ring.wait(idx, _dispatch._BLOCK_SLICE)
                continue
            for f in frames:
                self._serve_frame(ring, f, deployment)

    def _serve_frame(self, ring, f, deployment: str) -> None:
        """Execute one natively-dispatched request and ship the result
        back over the requester's response ring. The snapshot-plane
        in-flight count is released HERE (`rr_done` with the enqueue's
        generation — stale completions for a retired table entry are
        dropped, never mis-billed)."""
        try:
            try:
                method, args, kwargs, job = _dispatch.decode_call(
                    f.payload)
            except Exception:
                return  # torn producer bug; drop, counter keeps the score
            ctx = _rr.adopt_context(f.trace_id, deployment, job)
            try:
                val = self.handle_request(method, args, kwargs, ctx)
            except Exception as e:  # noqa: BLE001 — shipped to caller
                self._respond_error(f, e)
                return
            try:
                blob = pickle.dumps(val,
                                    protocol=pickle.HIGHEST_PROTOCOL)
            except Exception as e:  # noqa: BLE001
                self._respond_error(f, e)
                return
            self._respond_chunked(f, blob)
        finally:
            ring.done(f.rid, f.gen)

    @staticmethod
    def _respond_chunked(f, blob: bytes) -> None:
        resp = _dispatch.response_ring(f.client)
        if resp is None:
            return  # requester exited: drop the response
        cap = resp.slot_bytes
        n = max(1, (len(blob) + cap - 1) // cap)
        for i in range(n):
            part = blob[i * cap:(i + 1) * cap]
            # bounded spin on a full client ring (slow reader); the
            # chunk index/total ride the client word — the request
            # frame's cookie already did its routing job
            for _ in range(400):
                if resp.enqueue_to(0, part, trace=f.trace,
                                   client=(i << 32) | n,
                                   tag=_dispatch.TAG_RESULT):
                    break
                time.sleep(0.005)
            else:
                return  # reader wedged: stop shipping, stream is lost

    @staticmethod
    def _respond_error(f, err: BaseException) -> None:
        resp = _dispatch.response_ring(f.client)
        if resp is None:
            return
        msg = f"{type(err).__name__}: {err}".encode()[:resp.slot_bytes]
        for _ in range(400):
            if resp.enqueue_to(0, msg, trace=f.trace,
                               tag=_dispatch.TAG_ERROR):
                return
            time.sleep(0.005)

    def reconfigure(self, user_config: Dict) -> None:
        if not self._is_function and hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)

    def check_health(self) -> bool:
        if not self._is_function and hasattr(self._callable,
                                             "check_health"):
            return bool(self._callable.check_health())
        return True
