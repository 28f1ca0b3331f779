"""Deployment handles + the pow-2 router.

Reference: `python/ray/serve/handle.py:711,453`
(DeploymentHandle/DeploymentResponse) and
`python/ray/serve/_private/replica_scheduler/pow_2_scheduler.py:49` —
power-of-two-choices over the router's local view of per-replica in-flight
counts, with the replica list refreshed from the controller (the
reference's LongPollClient push becomes a pull with a short TTL).
"""

from __future__ import annotations

import pickle
import queue
import random
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private import fault_injection as _fi
from ray_tpu_torch._private import health as health_mod
from ray_tpu_torch.serve import dispatch as _dispatch
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import request_recorder as _rr
from ray_tpu_torch.util import tracing as _tracing

# module-level constructor (raylint: no metric objects on hot paths) —
# counts requests shed because their deadline passed before dispatch,
# attributable per deployment and per submitting job (tenant)
REQUEST_TIMEOUTS = _metrics.Counter(
    "serve_request_timeouts",
    "requests rejected because handle.options(timeout_s=...) expired "
    "before dispatch",
    tag_keys=("deployment", "job"))

# episodes where choose() found an empty replica view and had to park
# (FIFO-token wakeup, no sleep-poll) until the controller published one
ROUTER_EMPTY_WAITS = _metrics.Counter(
    "serve_router_empty_waits",
    "choose() calls that blocked waiting for a replica to be published",
    tag_keys=("deployment",))


def _current_job_label() -> str:
    """Short job label of the submitting process ({job=} metric rows)."""
    from ray_tpu_torch._private.object_ref import get_core_worker

    cw = get_core_worker()
    return cw.job_id.hex()[:8] if cw is not None else "none"


class RequestTimeoutError(TimeoutError):
    """The request's `timeout_s` deadline passed while it was still
    queued client-side (router backlog / no replicas) — shed instead of
    dispatched to serve a dead request."""


class DeploymentResponse:
    """Future for one request (reference `handle.py:453`).

    Completion feedback: the router's local in-flight count for the chosen
    replica is decremented when the result is fetched (or the response is
    dropped), keeping the pow-2 view accurate without a waiter thread.
    """

    def __init__(self, ref, router: Optional["Router"] = None,
                 replica_key: str = "", resubmit=None,
                 ctx: Optional[dict] = None,
                 submit_ts: Optional[float] = None,
                 queue_ms: float = 0.0):
        self._ref = ref
        self._router = router
        self._replica_key = replica_key
        self._done = False
        self._resubmit = resubmit
        # request-recorder plane: the ctx minted at _submit + what the
        # caller observed (the engine record carries the phase split)
        self._ctx = ctx
        self._submit_ts = submit_ts if submit_ts is not None \
            else time.monotonic()
        self._queue_ms = queue_ms
        self._failed_over = False
        self._recorded = False

    def _mark_done(self):
        if not self._done and self._router is not None:
            self._done = True
            self._router.done(self._replica_key)

    def _record(self, outcome: str):
        if self._recorded or self._ctx is None:
            return
        self._recorded = True
        total_ms = (time.monotonic() - self._submit_ts) * 1e3
        _rr.record_client(
            self._ctx, ts=time.time() - total_ms / 1e3,
            total_ms=total_ms, queue_ms=self._queue_ms,
            outcome=outcome)

    def result(self, timeout: Optional[float] = 60.0) -> Any:
        try:
            val = self._result_inner(timeout)
        except BaseException as e:
            self._record("timed_out" if isinstance(e, TimeoutError)
                         else "failed")
            raise
        self._record("failed_over" if self._failed_over else "ok")
        return val

    def _result_inner(self, timeout: Optional[float]) -> Any:
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        try:
            return ray_tpu_torch.get(self._ref, timeout=timeout)
        except ray_tpu_torch.ActorDiedError:
            # The chosen replica was torn down (reconfigure / autoscale
            # down) before this request completed. One retry against a
            # freshly-routed replica covers the transient window. The
            # retry spends the caller's remaining budget, never more.
            if self._resubmit is None:
                raise
            remaining = None if deadline is None \
                else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise
            self._mark_done()
            resubmit, self._resubmit = self._resubmit, None
            if self._router is not None:
                self._router.mark_dead(self._replica_key)
                self._router._refresh(force=True)
            retry = resubmit()
            self._ref = retry._ref
            self._router = retry._router
            self._replica_key = retry._replica_key
            self._done = False
            self._failed_over = True
            # This object took over the retry's in-flight accounting;
            # neuter the temporary so its __del__ can't double-decrement.
            retry._done = True
            retry._router = None
            retry._recorded = True  # one client record per request
            return ray_tpu_torch.get(self._ref, timeout=remaining)
        finally:
            self._mark_done()

    @property
    def ref(self):
        return self._ref

    def __del__(self):
        try:
            self._mark_done()
        except Exception:
            pass


class DeploymentResponseGenerator:
    """Streaming response: iterate to receive each yielded chunk as the
    replica produces it (reference `handle.py` DeploymentResponseGenerator
    riding the streaming-generator protocol)."""

    def __init__(self, gen, router: Optional["Router"] = None,
                 replica_key: str = "", resubmit=None,
                 ctx: Optional[dict] = None,
                 submit_ts: Optional[float] = None,
                 queue_ms: float = 0.0):
        self._gen = gen  # ObjectRefGenerator of chunk refs
        self._router = router
        self._replica_key = replica_key
        self._done = False
        self._resubmit = resubmit
        self._delivered = 0  # chunks already handed to the caller
        # request-recorder plane: per-chunk stamps give the
        # caller-observed TTFT and TPOT. TPOT averages the gaps between
        # chunks the caller ACTUALLY waited on: after a failover the
        # gap stamp resets (the next chunk's wait is recovery, not
        # decode) and survivor-replayed chunks are counted in
        # `replayed_tokens` but never timed.
        self._ctx = ctx
        self._submit_ts = submit_ts if submit_ts is not None \
            else time.monotonic()
        self._queue_ms = queue_ms
        self._first_chunk_ts: Optional[float] = None
        self._prev_chunk_ts: Optional[float] = None
        self._tpot_sum = 0.0
        self._tpot_n = 0
        self._replayed = 0
        self._failed_over = False
        self._recorded = False

    def _mark_done(self):
        if not self._done and self._router is not None:
            self._done = True
            self._router.done(self._replica_key)

    def _record(self, outcome: str):
        if self._recorded or self._ctx is None:
            return
        self._recorded = True
        total_ms = (time.monotonic() - self._submit_ts) * 1e3
        ttft = None
        if self._first_chunk_ts is not None:
            ttft = (self._first_chunk_ts - self._submit_ts) * 1e3
        tpot = (self._tpot_sum / self._tpot_n * 1e3) \
            if self._tpot_n else None
        _rr.record_client(
            self._ctx, ts=time.time() - total_ms / 1e3,
            total_ms=total_ms, queue_ms=self._queue_ms,
            ttft_ms=ttft, tpot_ms=tpot, tokens_out=self._delivered,
            replayed_tokens=self._replayed, outcome=outcome,
            # how many inter-chunk gaps the TPOT mean is over: lets
            # tests pin that replay/recovery gaps were never timed
            timed_gaps=self._tpot_n)

    def __iter__(self):
        return self

    def __next__(self) -> Any:
        while True:
            try:
                ref = next(self._gen)
                val = ray_tpu_torch.get(ref)
            except StopIteration:
                self._mark_done()
                self._record("failed_over" if self._failed_over
                             else "ok")
                raise
            except ray_tpu_torch.ActorDiedError:
                # replica died mid-stream: restart the stream on a
                # freshly-routed replica and fast-forward past the
                # chunks the caller already consumed (deployment
                # streams are deterministic for a given request — the
                # contract this replay rides on; serve.llm's greedy
                # decode satisfies it). One retry, like the unary path.
                if self._resubmit is None:
                    self._mark_done()
                    self._record("failed")
                    raise
                self._mark_done()
                resubmit, self._resubmit = self._resubmit, None
                if self._router is not None:
                    self._router.mark_dead(self._replica_key)
                    self._router._refresh(force=True)
                retry = resubmit()
                self._gen = retry._gen
                self._router = retry._router
                self._replica_key = retry._replica_key
                self._done = False
                self._failed_over = True
                retry._done = True  # accounting moved to this object
                retry._router = None
                retry._recorded = True  # one client record per request
                # the survivor re-generates chunks the caller already
                # has: count them as replayed, never time them, and
                # reset the gap stamp so the next delivered chunk's
                # recovery wait is excluded from TPOT too
                self._replayed += self._delivered
                self._prev_chunk_ts = None
                for _ in range(self._delivered):  # replay dedup
                    ray_tpu_torch.get(next(self._gen))
                continue
            except Exception:
                self._mark_done()
                self._record("failed")
                raise
            now = time.monotonic()
            if self._first_chunk_ts is None:
                self._first_chunk_ts = now
            elif self._prev_chunk_ts is not None:
                self._tpot_sum += now - self._prev_chunk_ts
                self._tpot_n += 1
            self._prev_chunk_ts = now
            self._delivered += 1
            return val

    def close(self):
        """Cancel the stream: the replica's generator stops at its next
        yield."""
        self._gen.close()
        self._mark_done()
        self._record("failed_over" if self._failed_over else "ok")

    def __del__(self):
        try:
            self._mark_done()
        except Exception:
            pass


class NativeDeploymentResponse:
    """Future for one natively-dispatched request: the result
    arrives as frames on the caller's response ring instead of an object
    ref. The snapshot-plane in-flight count is decremented replica-side
    (`rr_done` with the generation the enqueue hit), so there is no
    router accounting here — and no aliasing to have.

    Handles both payload shapes: chunked pickled results (generic
    deployments, TAG_RESULT frames carrying ``(chunk index, total)`` in
    the client word) and serve.llm token streams collapsed to a list
    (TAG_TOKEN frames closed by TAG_DONE) — same values the Python path
    returns, bit for bit.
    """

    def __init__(self, plane, mailbox, trace: int,
                 ctx: Optional[dict] = None,
                 submit_ts: Optional[float] = None,
                 queue_ms: float = 0.0, name: str = ""):
        self._plane = plane
        self._mailbox = mailbox
        self._trace = trace
        self._ctx = ctx
        self._submit_ts = submit_ts if submit_ts is not None \
            else time.monotonic()
        self._queue_ms = queue_ms
        self._name = name
        self._value: Any = None
        self._have = False
        self._recorded = False

    def _record(self, outcome: str):
        if self._recorded or self._ctx is None:
            return
        self._recorded = True
        total_ms = (time.monotonic() - self._submit_ts) * 1e3
        _rr.record_client(
            self._ctx, ts=time.time() - total_ms / 1e3,
            total_ms=total_ms, queue_ms=self._queue_ms,
            outcome=outcome)

    def result(self, timeout: Optional[float] = 60.0) -> Any:
        if self._have:
            return self._value
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        chunks: Dict[int, bytes] = {}
        tokens: List[int] = []
        try:
            while True:
                left = 3600.0 if deadline is None \
                    else deadline - time.monotonic()
                if left <= 0:
                    raise RequestTimeoutError(
                        f"native response from {self._name!r} timed out")
                try:
                    f = self._mailbox.q.get(timeout=left)
                except queue.Empty:
                    raise RequestTimeoutError(
                        f"native response from {self._name!r} "
                        "timed out") from None
                if f.tag == _dispatch.TAG_ERROR:
                    raise RuntimeError(
                        f.payload.decode("utf-8", "replace"))
                if f.tag == _dispatch.TAG_TOKEN:
                    _idx, tok = _dispatch._LLM_TOK.unpack(f.payload)
                    tokens.append(tok)
                elif f.tag == _dispatch.TAG_DONE:
                    self._value, self._have = tokens, True
                elif f.tag == _dispatch.TAG_RESULT:
                    i, n = f.client >> 32, f.client & 0xffffffff
                    chunks[i] = f.payload
                    if len(chunks) == n:
                        self._value = pickle.loads(
                            b"".join(chunks[j] for j in range(n)))
                        self._have = True
                if self._have:
                    self._record("ok")
                    return self._value
        except BaseException as e:
            self._record("timed_out" if isinstance(e, TimeoutError)
                         else "failed")
            raise
        finally:
            self._plane.unregister(self._trace)

    def __del__(self):
        try:
            self._plane.unregister(self._trace)
        except Exception:
            pass


class NativeDeploymentResponseGenerator:
    """Streaming variant of the native path: TAG_TOKEN frames become the
    same ``{"index", "token"}`` chunks the Python path yields; TAG_DONE
    ends the stream; TAG_ERROR raises. TTFT/TPOT stamps mirror
    DeploymentResponseGenerator so the recorder's client rows are
    path-agnostic."""

    def __init__(self, plane, mailbox, trace: int,
                 ctx: Optional[dict] = None,
                 submit_ts: Optional[float] = None,
                 queue_ms: float = 0.0, name: str = ""):
        self._plane = plane
        self._mailbox = mailbox
        self._trace = trace
        self._ctx = ctx
        self._submit_ts = submit_ts if submit_ts is not None \
            else time.monotonic()
        self._queue_ms = queue_ms
        self._name = name
        self._first_chunk_ts: Optional[float] = None
        self._prev_chunk_ts: Optional[float] = None
        self._tpot_sum = 0.0
        self._tpot_n = 0
        self._delivered = 0
        self._recorded = False
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self) -> Any:
        if self._closed:
            raise StopIteration
        try:
            f = self._mailbox.q.get(timeout=120.0)
        except queue.Empty:
            self._finish("failed")
            raise RuntimeError(
                f"native stream from {self._name!r} stalled") from None
        if f.tag == _dispatch.TAG_TOKEN:
            idx, tok = _dispatch._LLM_TOK.unpack(f.payload)
            now = time.monotonic()
            if self._first_chunk_ts is None:
                self._first_chunk_ts = now
            elif self._prev_chunk_ts is not None:
                self._tpot_sum += now - self._prev_chunk_ts
                self._tpot_n += 1
            self._prev_chunk_ts = now
            self._delivered += 1
            return {"index": idx, "token": tok}
        if f.tag == _dispatch.TAG_DONE:
            self._finish("ok")
            raise StopIteration
        self._finish("failed")
        raise RuntimeError(f.payload.decode("utf-8", "replace"))

    def _finish(self, outcome: str):
        if self._closed:
            return
        self._closed = True
        self._plane.unregister(self._trace)
        if self._recorded or self._ctx is None:
            return
        self._recorded = True
        total_ms = (time.monotonic() - self._submit_ts) * 1e3
        ttft = None if self._first_chunk_ts is None \
            else (self._first_chunk_ts - self._submit_ts) * 1e3
        tpot = (self._tpot_sum / self._tpot_n * 1e3) \
            if self._tpot_n else None
        _rr.record_client(
            self._ctx, ts=time.time() - total_ms / 1e3,
            total_ms=total_ms, queue_ms=self._queue_ms,
            ttft_ms=ttft, tpot_ms=tpot, tokens_out=self._delivered,
            outcome=outcome, timed_gaps=self._tpot_n)

    def close(self):
        """Stop consuming. The replica keeps producing into the ring;
        the orphan stash bounds what a dropped stream can hold."""
        self._finish("ok")

    def __del__(self):
        try:
            self._finish("ok")
        except Exception:
            pass


class Router:
    """Pow-2 replica chooser with a locally-tracked in-flight view.

    Replicas are keyed by their stable actor id (`dispatch.replica_key`)
    rather than a positional index. The old index keying aliased after
    `mark_dead`: the list compacted, every count was zeroed, and a
    `done(idx)` arriving from a request dispatched *before* the
    compaction decremented whichever replica had slid into that slot —
    permanently skewing the pow-2 view. With stable keys a late
    completion either hits the replica it belongs to or (replica gone)
    hits nothing.
    """

    _REFRESH_S = 2.0

    def __init__(self, controller, deployment_name: str):
        self._controller = controller
        self._name = deployment_name
        self._replicas: Dict[str, Any] = {}  # stable key -> actor handle
        self._version = -1
        self._inflight: Dict[str, int] = {}
        self._last_refresh = 0.0
        self._lock = threading.Lock()
        # deterministic chaos replays: under an armed fault plan the
        # pow-2 picks come from a per-site seeded stream, so a replayed
        # schedule routes every request the way the failing run did
        _plan = _fi.plan()
        self._rng = _plan.rng_for("serve.router") if _plan is not None \
            else random
        # empty-view parking: the controller posts this FIFO on every
        # replica-set version bump; choose() blocks here instead of
        # sleep-polling (tokens advisory — a lost one costs one slice).
        # The controller creates the FIFO and unlinks it with the
        # deployment; a router only opens it, so a handle to a deployment
        # that never existed leaves no FIFO behind
        self._wake = _dispatch._Wakeup(
            _dispatch.router_wake_path(deployment_name), create=False)
        # deadman probe over the wake loop: beats happen OUTSIDE
        # self._lock (a watchdog that needs the router's lock could
        # never fire while it is stuck); backlog = choosers currently
        # parked, so a quiet router is healthy but a parked chooser
        # whose beats stop (e.g. _refresh wedged against the
        # controller) is a captured stall
        self._parked = 0
        self._probe = health_mod.watch_loop(
            f"serve_router_{deployment_name}",
            backlog_fn=lambda: self._parked)

    def _refresh(self, force: bool = False):
        now = time.monotonic()
        if not force and now - self._last_refresh < self._REFRESH_S:
            return
        info = ray_tpu_torch.get(
            self._controller.get_replicas.remote(self._name), timeout=30)
        with self._lock:
            self._last_refresh = now
            if info["version"] != self._version:
                self._version = info["version"]
                new = {_dispatch.replica_key(r): r
                       for r in info["replicas"]}
                # carry surviving replicas' in-flight counts across the
                # version bump; only departed replicas' counts drop
                self._inflight = {k: self._inflight.get(k, 0)
                                  for k in new}
                self._replicas = new

    def choose(self) -> tuple:
        self._refresh()
        deadline = time.monotonic() + 30.0
        counted_wait = False
        try:
            while True:
                with self._lock:
                    keys = list(self._replicas)
                    if keys:
                        if len(keys) == 1:
                            key = keys[0]
                        else:
                            a, b = self._rng.sample(keys, 2)
                            key = a if self._inflight.get(a, 0) <= \
                                self._inflight.get(b, 0) else b
                        self._inflight[key] = \
                            self._inflight.get(key, 0) + 1
                        return key, self._replicas[key]
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"no replicas available for {self._name!r}")
                if not counted_wait:
                    counted_wait = True  # once per empty episode
                    ROUTER_EMPTY_WAITS.inc(
                        tags={"deployment": self._name})
                    self._parked += 1
                self._probe.beat()
                self._wake.wait(0.25)
                self._refresh(force=True)
        finally:
            if counted_wait:
                self._parked -= 1

    def done(self, key: str):
        with self._lock:
            if self._inflight.get(key, 0) > 0:
                self._inflight[key] -= 1

    def mark_dead(self, key: str):
        """Evict a replica observed dead (ActorDiedError) from the local
        view NOW — the controller's list stays stale until its next
        reconcile, and a retry routed through it could land on the same
        corpse. The next version bump (controller replacing the
        replica) restores the authoritative list. Surviving replicas
        keep their in-flight counts."""
        with self._lock:
            self._replicas.pop(key, None)
            self._inflight.pop(key, None)


class DeploymentHandle:
    def __init__(self, controller, deployment_name: str,
                 method: str = "__call__", stream: bool = False,
                 timeout_s: Optional[float] = None):
        self._controller = controller
        self._name = deployment_name
        self._method = method
        self._stream = stream
        self._timeout_s = timeout_s
        self._router = Router(controller, deployment_name)
        # dispatch plane v2: lazily-attached native request ring (None
        # until the controller has created the domain segment)
        self._ring: Optional[_dispatch.DispatchRing] = None
        self._ring_retry_at = 0.0

    def options(self, method_name: Optional[str] = None,
                stream: Optional[bool] = None,
                timeout_s: Optional[float] = None) -> "DeploymentHandle":
        h = DeploymentHandle(
            self._controller, self._name,
            method_name if method_name is not None else self._method,
            stream if stream is not None else self._stream,
            timeout_s if timeout_s is not None else self._timeout_s)
        h._router = self._router  # share the local view
        h._ring = self._ring      # and the ring attachment
        return h

    def __getattr__(self, name: str) -> "DeploymentHandle":
        if name.startswith("_"):
            raise AttributeError(name)
        return self.options(name)

    @staticmethod
    def _unwrap(v):
        # composed responses: Python-path futures pass their ref (the
        # replica resolves it); native-path futures resolve HERE — their
        # value lives on a response ring only this process can read
        if isinstance(v, DeploymentResponse):
            return v.ref
        if isinstance(v, NativeDeploymentResponse):
            return v.result()
        return v

    def remote(self, *args, **kwargs):
        args = tuple(self._unwrap(a) for a in args)
        kwargs = {k: self._unwrap(v) for k, v in kwargs.items()}
        deadline = None if self._timeout_s is None else \
            time.monotonic() + self._timeout_s
        return self._submit(args, kwargs, deadline)

    def _check_deadline(self, deadline: Optional[float]):
        """Shed a request whose per-request deadline passed while it was
        still queued client-side — a saturated deployment serves live
        requests instead of dead ones."""
        if deadline is not None and time.monotonic() > deadline:
            REQUEST_TIMEOUTS.inc(tags={"deployment": self._name,
                                       "job": _current_job_label()})
            raise RequestTimeoutError(
                f"request to {self._name!r} timed out after "
                f"{self._timeout_s}s before dispatch")

    def _native_ring(self) -> Optional["_dispatch.DispatchRing"]:
        """The deployment's dispatch domain, attach-only — never created
        here (the controller owns the geometry). Retries with a 1s
        backoff so a handle built before the first deploy picks the
        segment up once it exists."""
        if self._ring is not None:
            return self._ring
        now = time.monotonic()
        if now < self._ring_retry_at:
            return None
        try:
            self._ring = _dispatch.DispatchRing(
                _dispatch.domain_segment(self._name), create=False)
        except Exception:
            self._ring_retry_at = now + 1.0
            return None
        return self._ring

    def _native_submit(self, args, kwargs,
                       deadline: Optional[float], t0: float):
        """The zero-Python hot path: one `rr_enqueue` performs trace-id
        mint, deadline check, and pow-2 replica choice in native code;
        results come back as frames on this process's response ring.
        Returns None when the request isn't frameable (wrong mode /
        method / shape) — the caller falls back to the Python path."""
        ring = self._native_ring()
        if ring is None:
            return None
        mode = ring.mode()
        job = _current_job_label()
        if mode == _dispatch.MODE_RAW_LLM:
            if self._method not in ("generate", "generate_once"):
                return None
            try:
                prompt = args[0] if args else kwargs["prompt"]
                max_new = args[1] if len(args) > 1 \
                    else kwargs.get("max_new_tokens", 16)
                payload = _dispatch.encode_llm_request(
                    [int(t) for t in prompt], int(max_new), job)
            except Exception:
                return None  # shape we can't frame
        elif mode == _dispatch.MODE_PICKLE:
            if self._stream:
                return None  # generic streaming stays on the Python path
            payload = _dispatch.encode_call(self._method, args, kwargs,
                                            job)
        else:
            return None  # MODE_UNSET: replicas not attached yet
        plane = _dispatch.ClientPlane.get()
        deadline_ns = 0 if deadline is None \
            else max(1, int(deadline * 1e9))
        trace, _rid, _gen = ring.enqueue(
            payload, deadline_ns=deadline_ns, client=plane.cookie)
        mailbox = plane.register(trace)
        ctx = _rr.adopt_context(_dispatch.format_trace(trace),
                                self._name, job)
        queue_ms = (time.monotonic() - t0) * 1e3
        if self._stream:
            return NativeDeploymentResponseGenerator(
                plane, mailbox, trace, ctx=ctx, submit_ts=t0,
                queue_ms=queue_ms, name=self._name)
        return NativeDeploymentResponse(
            plane, mailbox, trace, ctx=ctx, submit_ts=t0,
            queue_ms=queue_ms, name=self._name)

    def _submit(self, args, kwargs, deadline: Optional[float] = None,
                ctx: Optional[dict] = None):
        t0 = time.monotonic()
        # native fast path first (opt-in): rejection codes map to the
        # Python path (FULL backpressure / TOO_BIG / NO_REPLICA) or to
        # the shed the Python path would also take (DEADLINE). Failover
        # resubmits (ctx passed back in) always reuse the Python path.
        if ctx is None and _dispatch.native_available():
            try:
                resp = self._native_submit(args, kwargs, deadline, t0)
                if resp is not None:
                    return resp
            except _dispatch.DispatchRejected as e:
                if e.code == _dispatch.ERR_DEADLINE:
                    REQUEST_TIMEOUTS.inc(
                        tags={"deployment": self._name,
                              "job": _current_job_label()})
                    elapsed_ms = (time.monotonic() - t0) * 1e3
                    _rr.record_client(
                        _rr.new_context(self._name,
                                        _current_job_label()),
                        ts=time.time() - elapsed_ms / 1e3,
                        total_ms=elapsed_ms, queue_ms=elapsed_ms,
                        outcome="timed_out")
                    raise RequestTimeoutError(
                        f"request to {self._name!r} timed out after "
                        f"{self._timeout_s}s before dispatch") from None
        # mint the request's identity ONCE; a failover resubmit passes
        # the same ctx back in so the survivor's work stitches into the
        # same record/trace
        if ctx is None:
            ctx = _rr.new_context(self._name, _current_job_label())
        key = None
        try:
            self._check_deadline(deadline)
            key, replica = self._router.choose()
            # choose() can block waiting for replicas — re-check before
            # committing the dispatch
            self._check_deadline(deadline)
        except RequestTimeoutError:
            if key is not None:
                self._router.done(key)
            elapsed_ms = (time.monotonic() - t0) * 1e3
            _rr.record_client(ctx, ts=time.time() - elapsed_ms / 1e3,
                              total_ms=elapsed_ms, queue_ms=elapsed_ms,
                              outcome="timed_out")
            raise
        # client-side queue phase: deadline checks + router choose
        queue_ms = (time.monotonic() - t0) * 1e3
        attrs = {"req_id": ctx["req_id"],
                 "flow_id": f"req:{ctx['req_id']}",
                 "deployment": self._name, "replica": key}
        if self._stream:
            with _tracing.span(f"serve.{self._name}.stream",
                               kind="producer", attrs=attrs):
                gen = replica.handle_request_streaming.options(
                    num_returns="streaming").remote(
                        self._method, args, kwargs, ctx)
            return DeploymentResponseGenerator(
                gen, self._router, key,
                resubmit=lambda: self._submit(args, kwargs, deadline,
                                              ctx),
                ctx=ctx, submit_ts=t0, queue_ms=queue_ms)
        with _tracing.span(f"serve.{self._name}.request",
                           kind="producer", attrs=attrs):
            ref = replica.handle_request.remote(
                self._method, args, kwargs, ctx)
        return DeploymentResponse(
            ref, self._router, key,
            resubmit=lambda: self._submit(args, kwargs, deadline, ctx),
            ctx=ctx, submit_ts=t0, queue_ms=queue_ms)

    def _submit_asgi(self, scope: dict, body: bytes
                     ) -> "DeploymentResponseGenerator":
        """Forward a raw ASGI scope to a replica; the returned generator
        yields the app's send-events as they are produced."""
        key, replica = self._router.choose()
        gen = replica.handle_asgi.options(
            num_returns="streaming").remote(scope, body)
        return DeploymentResponseGenerator(gen, self._router, key)

    def _is_asgi(self) -> bool:
        """Whether the deployment is an ASGI ingress (proxy-side routing
        decision)."""
        key, replica = self._router.choose()
        try:
            return bool(ray_tpu_torch.get(replica.is_asgi.remote(),
                                          timeout=30))
        finally:
            self._router.done(key)

    def _is_streaming_method(self) -> bool:
        """Ask a live replica whether the target method is a generator
        (proxy-side auto-detection for HTTP streaming)."""
        key, replica = self._router.choose()
        try:
            return bool(ray_tpu_torch.get(
                replica.is_streaming.remote(self._method), timeout=30))
        finally:
            self._router.done(key)

    def __reduce__(self):
        return (DeploymentHandle,
                (self._controller, self._name, self._method, self._stream,
                 self._timeout_s))
