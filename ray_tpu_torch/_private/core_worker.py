"""CoreWorker — the per-process runtime linked into every driver and worker.

Reference: `src/ray/core_worker/core_worker.h:292` and its transport layer —
task submission with cached worker leases
(`CoreWorkerDirectTaskSubmitter`, `transport/direct_task_transport.h:75`),
direct actor transport with per-caller sequence numbers
(`CoreWorkerDirectActorTaskSubmitter`), the in-process memory store for
small/in-band objects (`store_provider/memory_store/memory_store.h:43`),
ownership bookkeeping (`reference_count.h`), task retries (`task_manager.h`),
and the task-execution callback into user code (`_raylet.pyx execute_task`).

Threading model: all network state lives on a dedicated asyncio loop thread
(the reference's io_service); the public sync API posts coroutines to it.
Task execution happens on the process main thread (normal tasks), a thread
pool (threaded actors), or a dedicated actor event loop (async actors).
"""

from __future__ import annotations

import asyncio
import contextvars
import hashlib
import inspect
import itertools
import logging
import os
import queue as queue_mod
import threading
import time
import traceback
from collections import OrderedDict, deque
from concurrent.futures import Future as SyncFuture
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as SyncTimeoutError
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import fault_injection as _fi
from ray_tpu_torch._private import serialization
from ray_tpu_torch._private import task as task_mod
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.object_ref import ObjectRef, set_core_worker
from ray_tpu_torch._private.object_store import ObjectStore
from ray_tpu_torch.util import tracing
from ray_tpu_torch._private.rpc import (
    ClientPool,
    ConnectionLost,
    ReconnectingClient,
    RpcError,
    RpcServer,
)

logger = logging.getLogger(__name__)

# seconds a killed worker gets to leave through its task loop before it
# is ended (`rpc_exit_worker`)
KILL_GRACE_S = 1.0


class RayTaskError(Exception):
    """A task raised; carries the remote traceback (reference:
    ray.exceptions.RayTaskError)."""

    def __init__(self, message: str, cause: Exception | None = None):
        super().__init__(message)
        self.cause = cause


# The task id executing on THIS thread/coroutine. A ContextVar is the
# one mechanism correct for BOTH executor shapes: pool threads each see
# their own context, and every asyncio task gets a copied context — so
# concurrent async actor tasks attribute their children correctly where
# a shared instance attribute could not (recursive-cancel bookkeeping).
_executing_task_id: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_executing_task_id", default=None)


class TaskCancelledError(RayTaskError):
    """The task was cancelled via ray_tpu_torch.cancel() (reference:
    `ray.exceptions.TaskCancelledError`; cancel protocol
    `src/ray/protobuf/core_worker.proto:252-270`)."""


class _TaskCancelledInterrupt(BaseException):
    """Raised asynchronously inside an executing worker thread to
    interrupt a running task (the reference interrupts with
    KeyboardInterrupt — a BaseException so `except Exception` in user
    code cannot swallow the cancellation)."""


class ActorDiedError(RayTaskError):
    pass


class OutOfMemoryError(RayTaskError):
    """The raylet's memory monitor killed the worker running this task
    (reference: ray.exceptions.OutOfMemoryError); the message carries the
    killing policy's reasoning."""


class GetTimeoutError(Exception):
    pass


class ObjectLostError(RayTaskError):
    """Every copy of an object is gone and it cannot be reconstructed
    (reference: ray.exceptions.ObjectLostError). The message names the
    lost object and, when known, the lineage that died with it — a get()
    on such an object fails NOW instead of blocking to its timeout."""


class _MemoryStore:
    """In-process store for in-band results + object status (owner side)."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop
        self.values: Dict[bytes, bytes] = {}       # oid -> value frame
        self.errors: Dict[bytes, bytes] = {}       # oid -> pickled-exc frame
        self.locations: Dict[bytes, List[str]] = {}  # oid -> raylet addrs
        self._events: Dict[bytes, asyncio.Event] = {}
        # Global completion pulse: set on every _signal. `wait` scans +
        # blocks on this instead of growing a watcher future per pending
        # ref per call (which is O(n^2) across a drain loop).
        self._any_event = asyncio.Event()
        # Serializes sentinel→Future upgrades across getter threads
        # (cold path: taken only when a thread is about to block).
        self._arm_lock = threading.Lock()
        # Caller-thread waiters. At submit time each pending return is
        # registered with a None sentinel (a dict store — creating a
        # concurrent Future with its Condition per call would dominate
        # the submit path); `_get_fast` swaps in a real SyncFuture only
        # when a thread actually blocks. The reply handler (loop thread)
        # pops the entry and resolves it if it grew a Future.
        self.thread_waiters: Dict[bytes, Optional[SyncFuture]] = {}

    def _event(self, oid: bytes) -> asyncio.Event:
        ev = self._events.get(oid)
        if ev is None:
            ev = asyncio.Event()
            self._events[oid] = ev
        return ev

    def ready(self, oid: bytes) -> bool:
        return oid in self.values or oid in self.errors or oid in self.locations

    def register_thread_waiter(self, oid: bytes) -> None:
        """Mark oid as a pending owned result (cheap sentinel form)."""
        # Sentinel store from the single submit thread before any getter
        # can observe the oid — part of the documented lock-free protocol
        # above (only the upgrade path needs _arm_lock).
        self.thread_waiters[oid] = None  # raylint: disable=lock-discipline

    def arm_thread_waiter(self, oid: bytes) -> Optional[SyncFuture]:
        """Caller-thread: upgrade the sentinel to a blockable Future.
        Returns None if the result is no longer pending (the caller must
        re-check the value dicts)."""
        with self._arm_lock:  # two getter threads must SHARE one future
            if oid not in self.thread_waiters:
                return None
            existing = self.thread_waiters[oid]
            if existing is not None:
                # already armed by another thread — replacing it would
                # strand that thread forever (_signal resolves only the
                # stored one). If the reply just landed and resolved it,
                # result() returns immediately anyway.
                return existing
            fut = SyncFuture()
            self.thread_waiters[oid] = fut
        # Re-check AFTER publishing: if the reply landed between the
        # membership test and the store (the loop thread pops without
        # the lock), the value dicts are already populated and the
        # orphaned entry must not linger. RESOLVE what we pop — another
        # thread may have grabbed this same future in the meantime and
        # would otherwise block on it forever.
        if self.ready(oid):
            # loop-thread-style pop, deliberately outside _arm_lock (see
            # ordering comment above) # raylint: disable=lock-discipline
            w = self.thread_waiters.pop(oid, None)
            if w is not None and not w.done():
                w.set_result(True)
            return None
        return fut

    def _signal(self, oid: bytes):
        ev = self._events.pop(oid, None)
        if ev is not None:
            ev.set()
        # loop thread is the sole popper; armed futures are resolved, not
        # mutated, so no lock is needed # raylint: disable=lock-discipline
        waiter = self.thread_waiters.pop(oid, None)
        if waiter is not None and not waiter.done():
            waiter.set_result(True)
        self._any_event.set()

    async def wait_any(self, timeout: float | None):
        """Loop-thread: block until ANY object completes (or timeout).
        The caller must scan for readiness BEFORE calling (same loop
        iteration — signals only fire on the loop thread, so no signal
        can slip between the scan and the clear here)."""
        self._any_event.clear()
        await asyncio.wait_for(self._any_event.wait(), timeout)

    def put_value(self, oid: bytes, frame: bytes):
        self.values[oid] = frame
        self._signal(oid)

    def put_error(self, oid: bytes, frame: bytes):
        self.errors[oid] = frame
        self._signal(oid)

    def add_location(self, oid: bytes, raylet_addr: str):
        self.locations.setdefault(oid, [])
        if raylet_addr not in self.locations[oid]:
            self.locations[oid].append(raylet_addr)
        self._signal(oid)

    def drop_location(self, oid: bytes, raylet_addr: str):
        """Remove a dead/stale location; when the last one goes, the
        object is 'not ready' again so status waiters block until a
        reconstruction (or late report) re-adds one."""
        locs = self.locations.get(oid)
        if locs is None:
            return
        if raylet_addr in locs:
            locs.remove(raylet_addr)
        if not locs:
            self.locations.pop(oid, None)
            ev = self._events.get(oid)
            if ev is not None and oid not in self.values \
                    and oid not in self.errors:
                ev.clear()

    async def wait_ready(self, oid: bytes, timeout: float | None = None):
        if self.ready(oid):
            return
        await asyncio.wait_for(self._event(oid).wait(), timeout)


class ObjectRefGenerator:
    """Iterator over a streaming task's item refs (reference:
    `_raylet.pyx:273` ObjectRefGenerator). Yields ObjectRefs as the
    executor produces them; `ray_tpu_torch.get` each ref for its value.
    `close()` cancels the producer at its next report."""

    def __init__(self, core_worker: "CoreWorker", task_id: bytes):
        self._cw = core_worker
        self._task_id = task_id
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        return self._cw.stream_next(self._task_id)

    def next_with_timeout(self, timeout: float) -> ObjectRef:
        return self._cw.stream_next(self._task_id, timeout)

    async def _anext_async(self) -> ObjectRef:
        """Owner-loop async variant (internal plumbing for Serve/Data)."""
        out = await self._cw._stream_next_async(self._task_id)
        if out is type(self._cw)._STREAM_DONE:
            raise StopAsyncIteration
        return out

    def close(self):
        if not self._closed:
            self._closed = True
            self._cw.stream_cancel(self._task_id)

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class _KeyState:
    """Per-scheduling-key submit queue + lease pipeline state."""

    __slots__ = ("queue", "requesting")

    def __init__(self):
        self.queue: deque = deque()
        self.requesting = 0


class CoreWorker:
    def __init__(
        self,
        mode: str,  # "driver" | "worker"
        gcs_addr: str,
        raylet_addr: str | None = None,
        job_id: JobID | None = None,
        store: ObjectStore | None = None,
        node_id_hex: str = "",
        config: Config | None = None,
        gpu_ids: tuple = (),
    ):
        self.mode = mode
        self.config = config or Config.from_env()
        self.worker_id = WorkerID.from_random()
        # Never default to a shared job 0: an unlabelled CoreWorker gets
        # its own bucket so per-job accounting (fair queue lanes, store
        # quotas) can't silently merge tenants.
        self.job_id = job_id if job_id is not None else JobID.from_random()
        self.gcs_addr = gcs_addr
        self.raylet_addr = raylet_addr
        self.node_id_hex = node_id_hex
        self.store = store
        if store is not None:
            # stamp this process's puts with its job for per-job byte
            # accounting in the shm store (drivers and workers alike)
            store.set_current_job(self.job_id.binary())
            # quota_flood@<role> chaos victimizer: one job-charged put
            # per call, QuotaExceededError propagating to the flood
            # loop's rejection counter
            _fi.set_quota_flood_target(
                lambda: store.put_value(ObjectID.from_random(),
                                        b"\x00" * 65536))
        self.gpu_ids = gpu_ids
        # Per-PROCESS random base task id, NOT a job-deterministic one:
        # submissions from non-task threads (driver main thread, worker
        # background threads like Data's split coordinator) use this as
        # the parent. A shared deterministic base would give two
        # processes identical (parent, counter) pairs — colliding task
        # and return-object ids that alias stale values across owners.
        self.current_task_id = TaskID.from_random()
        self.current_actor_id: Optional[ActorID] = None

        self._put_counter = itertools.count(1)
        self._task_counter = itertools.count(1)
        self._seq_counters: Dict[bytes, itertools.count] = {}

        self._loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self._run_loop, name="ray_tpu-io", daemon=True
        )
        self._server = RpcServer()
        self._clients = ClientPool()
        self._key_states: Dict[tuple, _KeyState] = {}
        self._actor_clients: Dict[bytes, dict] = {}  # actor state cache
        self._actor_events: Dict[bytes, asyncio.Event] = {}
        # --- ownership plane (reference: reference_count.h) ---
        # _ref_lock is REENTRANT: ObjectRef.__del__ fires via the cycle
        # collector during any allocation — including while this same
        # thread already holds the lock — and deregister_ref must not
        # deadlock against ourselves. Discipline: mutate and decide
        # under the lock, act (RPC, enqueue) outside it.
        self._ref_lock = threading.RLock()
        self._local_refs: Dict[bytes, int] = {}
        # oid -> in-flight submitted tasks carrying the oid as an arg: a
        # caller that drops its handle right after `.remote()` must not
        # free an object the task still needs.
        self._task_arg_refs: Dict[bytes, int] = {}
        # Owner side: oid -> worker addresses that borrowed the ref
        # (deserialized it inside a task they execute). The object stays
        # alive until every borrower reports release (the reference's
        # WaitForRefRemoved protocol, inverted to borrower-push).
        self._borrowers: Dict[bytes, set] = {}
        # Borrower side: oid -> owner addr for refs this process holds
        # but does not own; the last local deref notifies the owner.
        self._borrowed_refs: Dict[bytes, str] = {}
        # Return-value handoffs: return oid -> [(nested oid, owner)]
        # for ObjectRefs pickled inside a task's return. Each pair
        # holds a _task_arg_refs count until the RETURN object itself
        # is released — the serialized reply "contains" the ref, so it
        # must keep the object alive even if this process never
        # deserializes a handle.
        self._contained_refs: Dict[bytes, List[tuple]] = {}
        # Producing task id -> reconstruction attempts consumed
        # (bounded by config.max_object_reconstructions).
        self._reconstruction_attempts: Dict[bytes, int] = {}
        # Oids whose lineage was evicted past max_lineage_bytes: a loss
        # is then permanent and the ObjectLostError should say why.
        self._lineage_evicted: set = set()
        # Owned plasma objects freed on refcount zero; consulted so a
        # late borrower status query errors instead of hanging.
        self._freed_objects: set = set()
        # recovery-plane counters (exported via the "ownership" metrics
        # callback; loop-thread writes, so plain ints suffice)
        self._stats_reconstructions = 0
        self._stats_reconstruction_failures = 0
        self._stats_reconstruction_depth_max = 0
        self._stats_lineage_evictions = 0
        self._stats_objects_freed = 0
        self._stats_borrower_notifies = 0
        # Owner-side streaming-generator state, keyed by the producing
        # task id (reference: StreamingGeneratorState in task_manager.h).
        self._streams: Dict[bytes, dict] = {}
        # Lineage (reference: TaskManager lineage pinning,
        # task_manager.h:208,269): specs of tasks whose returns live in
        # plasma, retained so a lost object can be re-executed. Bounded
        # by config.max_lineage_bytes, evicting oldest-first.
        self._lineage: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._lineage_oids: Dict[bytes, bytes] = {}  # oid -> task_id
        # put()-path pins in flight: oid -> future resolved at pin ack
        # (consulted by _unpin_at to preserve pin-before-unpin order)
        self._pending_pins: Dict[bytes, asyncio.Future] = {}
        self._lineage_bytes = 0
        self._reconstructing: Dict[bytes, asyncio.Future] = {}
        # Primary-copy pins (reference: local_object_manager pinning —
        # the raylet holding an owned object's primary copy keeps it
        # unevictable until the owner's refcount drops to zero).
        self._pinned_at: Dict[bytes, str] = {}
        # Task-event buffer (reference: TaskEventBuffer,
        # task_event_buffer.h — batched, periodically flushed to the
        # GCS task table for `list tasks` observability).
        self._task_events: List[dict] = []
        # Submission coalescing: caller threads append specs here and
        # schedule ONE loop callback per burst instead of one per task —
        # the flush groups actor tasks into batched push frames
        # (reference: the submit queue in direct_task_transport.h).
        self._submit_buffer: deque = deque()  # ("normal"|"actor", spec)
        self._submit_flush_scheduled = False
        # Cancellation (reference: CancelTask/RemoteCancelTask,
        # core_worker.proto:252-270). Owner side: ids the user cancelled
        # (suppresses retries; pending specs error out at push time) and
        # where each in-flight task was pushed (to route the cancel RPC).
        # id -> insertion time: entries are dropped at terminal reply
        # AND age-pruned (a cancel of an already-finished task would
        # otherwise park its id here forever).
        self._cancelled_tasks: Dict[bytes, float] = {}
        self._inflight_tasks: Dict[bytes, str] = {}  # task_id -> addr

        # Executor state (worker mode). SimpleQueue: C-implemented
        # lock-free handoff — the per-task wakeup is measurably cheaper
        # than queue.Queue's pure-Python condition variables.
        self._exec_queue: queue_mod.SimpleQueue = queue_mod.SimpleQueue()
        self._actor_instance = None
        self._actor_threadpool: Optional[ThreadPoolExecutor] = None
        self._actor_group_pools: Optional[Dict[str, ThreadPoolExecutor]] = None
        self._actor_group_sems: Dict[str, Any] = {}
        self._actor_async_loop: Optional[asyncio.AbstractEventLoop] = None
        self._actor_seq_state: Dict[bytes, dict] = {}
        self._function_cache: Dict[bytes, Any] = {}
        # Executor side of cancellation: ids whose cancel arrived before
        # (or during) execution; running task -> thread ident (sync) or
        # asyncio.Task (async actors); executing task -> ids of the
        # child tasks it submitted (recursive cancel). Same id -> time
        # age-pruned form as _cancelled_tasks.
        self._cancel_requested: Dict[bytes, float] = {}
        self._running_threads: Dict[bytes, int] = {}
        self._running_async: Dict[bytes, Any] = {}
        self._task_children: Dict[bytes, List[bytes]] = {}
        self._shutdown = False
        self.memory_store: Optional[_MemoryStore] = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def _run_loop(self):
        asyncio.set_event_loop(self._loop)
        self._loop.run_forever()

    def start(self):
        self._loop_thread.start()
        self._run_sync(self._start_async())
        set_core_worker(self)
        try:
            from ray_tpu_torch.util.metrics import DEFAULT_REGISTRY
            DEFAULT_REGISTRY.register_callback(
                "ownership", self._ownership_metrics_text)
        except Exception:  # noqa: BLE001 — observability only
            pass
        return self

    def _ownership_metrics_text(self) -> str:
        """Ownership/recovery plane for /metrics (keyed callback — one
        CoreWorker per process, re-registration replaces)."""
        if self.memory_store is None:
            return ""
        with self._ref_lock:
            owned = len(self._local_refs)
            borrowed = len(self._borrowed_refs)
            task_args = len(self._task_arg_refs)
            borrower_edges = sum(
                len(v) for v in self._borrowers.values())
        rows = [
            ("ray_tpu_owned_refs", "gauge", owned),
            ("ray_tpu_borrowed_refs", "gauge", borrowed),
            ("ray_tpu_task_arg_refs", "gauge", task_args),
            ("ray_tpu_borrower_edges", "gauge", borrower_edges),
            ("ray_tpu_lineage_bytes", "gauge", self._lineage_bytes),
            ("ray_tpu_lineage_tasks", "gauge", len(self._lineage)),
            ("ray_tpu_lineage_evictions_total", "counter",
             self._stats_lineage_evictions),
            ("ray_tpu_reconstructions_total", "counter",
             self._stats_reconstructions),
            ("ray_tpu_reconstruction_failures_total", "counter",
             self._stats_reconstruction_failures),
            ("ray_tpu_reconstruction_depth_max", "gauge",
             self._stats_reconstruction_depth_max),
            ("ray_tpu_objects_freed_total", "counter",
             self._stats_objects_freed),
            ("ray_tpu_borrower_notifies_total", "counter",
             self._stats_borrower_notifies),
        ]
        out = []
        for name, kind, value in rows:
            out.append(f"# TYPE {name} {kind}")
            out.append(f"{name} {value}")
        return "\n".join(out) + "\n"

    async def _start_async(self):
        self.memory_store = _MemoryStore(self._loop)
        self._server.register_all(self)
        await self._server.start()
        # reconnecting handle: survives a GCS restart (persistence FT)
        self.gcs = ReconnectingClient(self._clients, self.gcs_addr)
        await self.gcs.call("subscribe",
                            {"channel": "actors", "addr": self._server.address})
        # node-death notices drive owner-side location invalidation and
        # lineage reconstruction (drivers AND workers own objects)
        await self.gcs.call("subscribe",
                            {"channel": "nodes", "addr": self._server.address})
        self._event_flush_task = asyncio.ensure_future(
            self._event_flush_loop())

    def _emit_task_event(self, task_id: bytes, name: str,
                         task_type: str, state: str):
        # tuple form: 2 emits per task ride the submit/reply hot paths,
        # and a 5-tuple packs ~3x cheaper than a 5-key string map
        self._task_events.append((task_id, name, task_type, state,
                                  time.time()))

    async def _event_flush_loop(self):
        """Ship buffered task events to the GCS task table ~1/s
        (reference: TaskEventBuffer's periodic flush; fire-and-forget so
        observability never sits on the task path)."""
        while not self._shutdown:
            await asyncio.sleep(1.0)
            # drain the WHOLE buffer each tick (in bounded frames) — a
            # fixed drain rate below the emit rate would grow the buffer
            # without bound
            while self._task_events:
                batch, self._task_events = self._task_events[:512], \
                    self._task_events[512:]
                try:
                    await self.gcs.notify("add_task_events",
                                          {"events": batch})
                except (ConnectionLost, RpcError, OSError):
                    break

    def shutdown(self):
        if self._shutdown:
            return
        self._shutdown = True
        try:
            self._run_sync(self._stop_async(), timeout=5)
        except Exception:
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)
        set_core_worker(None)

    async def _stop_async(self):
        task = getattr(self, "_event_flush_task", None)
        if task is not None:
            task.cancel()  # mid-sleep; the tail flush below covers it
        if self._task_events:
            # a short-lived driver exits before the periodic flush —
            # ship the tail so its tasks appear in `list tasks`
            batch, self._task_events = self._task_events, []
            try:
                await self.gcs.notify("add_task_events",
                                      {"events": batch})
            except (ConnectionLost, RpcError, OSError):
                pass
        await self._clients.close_all()
        await self._server.stop()

    @property
    def address(self) -> str:
        return self._server.address

    def _run_sync(self, coro, timeout: float | None = None):
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        return fut.result(timeout)

    # ------------------------------------------------------------------
    # reference registry (local refcounts; reference: reference_count.h)
    # ------------------------------------------------------------------

    def _ref_gone(self, oid: bytes) -> bool:
        """Owner side, caller holds _ref_lock: nothing keeps oid alive —
        no local handle, no in-flight task argument, no borrower."""
        return (self._local_refs.get(oid, 0) <= 0
                and self._task_arg_refs.get(oid, 0) <= 0
                and not self._borrowers.get(oid))

    def register_ref(self, ref: ObjectRef):
        oid = ref.binary()
        borrow_from = None
        with self._ref_lock:
            self._local_refs[oid] = self._local_refs.get(oid, 0) + 1
            if (ref.owner_addr not in ("", self.address)
                    and oid not in self._borrowed_refs):
                # first handle to a ref this process does not own:
                # record the borrow and tell the owner, which keeps the
                # object alive until we report release. (The notify is
                # async; the submitted-task ref the owner holds until
                # our task's terminal reply covers the in-flight gap.)
                self._borrowed_refs[oid] = ref.owner_addr
                borrow_from = ref.owner_addr
        if borrow_from is not None and not self._shutdown:
            try:
                self._submit_enqueue("add_borrower", (oid, borrow_from))
            except RuntimeError:
                pass  # loop already closed at interpreter teardown

    def deregister_ref(self, ref: ObjectRef):
        oid = ref.binary()
        action = None  # decided under the lock, performed outside it
        with self._ref_lock:
            n = self._local_refs.get(oid, 0) - 1
            if n > 0:
                self._local_refs[oid] = n
                return
            self._local_refs.pop(oid, None)
            owner = self._borrowed_refs.get(oid)
            if owner is not None:
                # borrower side: release the borrow only when no
                # submitted task of OURS still carries the ref either
                if self._task_arg_refs.get(oid, 0) <= 0:
                    self._borrowed_refs.pop(oid, None)
                    action = ("remove_borrower", (oid, owner))
            elif self._ref_gone(oid):
                # owner side: last holder gone. Posted unconditionally —
                # the reply that records the pin may still be in flight
                # on the loop thread, so gating on "is a pin recorded
                # yet" here would race it (the reply side re-checks the
                # refcount after recording to cover the other order).
                action = ("release", oid)
        if action is not None and not self._shutdown:
            try:
                # rides the submit buffer: a release between two
                # `.remote()` calls shares their loop wakeup instead
                # of paying its own
                self._submit_enqueue(*action)
            except RuntimeError:
                pass  # loop already closed at interpreter teardown

    def _retain_args(self, spec: task_mod.TaskSpec):
        """Pin every by-reference argument for the submitted task's
        lifetime (reference: the submitted-task reference count in
        reference_count.h). Released at the terminal reply/error."""
        deps = spec.plasma_deps()
        if not deps:
            return
        with self._ref_lock:
            for oid, _owner in deps:
                self._task_arg_refs[oid] = \
                    self._task_arg_refs.get(oid, 0) + 1

    def _release_args(self, spec: task_mod.TaskSpec):
        """Terminal reply/error (loop thread): drop the submitted-task
        pins taken by _retain_args and free whatever hit zero."""
        deps = spec.plasma_deps()
        if not deps:
            return
        actions = []
        with self._ref_lock:
            for oid, _owner in deps:
                n = self._task_arg_refs.get(oid, 0) - 1
                if n > 0:
                    self._task_arg_refs[oid] = n
                    continue
                self._task_arg_refs.pop(oid, None)
                owner = self._borrowed_refs.get(oid)
                if owner is not None:
                    if self._local_refs.get(oid, 0) <= 0:
                        self._borrowed_refs.pop(oid, None)
                        actions.append(("remove_borrower", (oid, owner)))
                elif self._ref_gone(oid):
                    actions.append(("release", oid))
        for kind, payload in actions:
            if kind == "release":
                self._on_ref_released(payload)
            else:
                asyncio.ensure_future(
                    self._notify_borrow(payload[1], "remove_borrower",
                                        payload[0]))

    def _release_contained(self, ret_oid: bytes):
        """The return object died: drop the holds its serialized reply
        took on the ObjectRefs pickled inside it (mirrors _release_args
        — same _task_arg_refs accounting, same release verdicts)."""
        with self._ref_lock:
            pairs = self._contained_refs.pop(ret_oid, None)
        if not pairs:
            return
        actions = []
        with self._ref_lock:
            for oid, owner in pairs:
                n = self._task_arg_refs.get(oid, 0) - 1
                if n > 0:
                    self._task_arg_refs[oid] = n
                    continue
                self._task_arg_refs.pop(oid, None)
                b_owner = self._borrowed_refs.get(oid)
                if b_owner is not None:
                    if self._local_refs.get(oid, 0) <= 0:
                        self._borrowed_refs.pop(oid, None)
                        actions.append(("remove_borrower", oid, b_owner))
                else:
                    # we own the nested ref: the handoff registered OUR
                    # address in our own borrower set (pinning it against
                    # the executor's racing task-end remove_borrower) —
                    # clear that self-borrow before the zero check
                    s = self._borrowers.get(oid)
                    if s is not None:
                        s.discard(self.address)
                        if not s:
                            self._borrowers.pop(oid, None)
                    if self._ref_gone(oid):
                        actions.append(("release", oid, None))
        for kind, oid, owner in actions:
            if kind == "release":
                self._on_ref_released(oid)
            else:
                asyncio.ensure_future(
                    self._notify_borrow(owner, "remove_borrower", oid))

    def _on_ref_released(self, oid: bytes):
        """Loop thread, owner side: refcount hit zero — free the object
        everywhere (primary-copy unpin WITH store deletion, owner books,
        lineage) instead of leaving it to eviction pressure."""
        with self._ref_lock:
            # re-check: a borrower or a fresh submission may have taken
            # a reference while this release rode the submit buffer
            if not self._ref_gone(oid):
                return
            self._lineage_evicted.discard(oid)
        # a dying return drops the holds on refs its reply contained
        self._release_contained(oid)
        addr = self._pinned_at.pop(oid, None)
        if addr is not None:
            asyncio.ensure_future(self._unpin_at(oid, addr, free=True))
            self._stats_objects_freed += 1
        # a late borrower status query must error, not hang forever on
        # books we just emptied (bounded: blown away wholesale rather
        # than pay per-entry tracking)
        if len(self._freed_objects) > 65536:
            self._freed_objects.clear()
        self._freed_objects.add(oid)
        mem = self.memory_store
        if mem is not None:
            mem.values.pop(oid, None)
            mem.errors.pop(oid, None)
            mem.locations.pop(oid, None)
            mem._events.pop(oid, None)
        task_id = self._lineage_oids.pop(oid, None)
        if task_id is not None and task_id in self._lineage:
            spec, size, oids = self._lineage[task_id]
            if not any(o in self._lineage_oids for o in oids):
                self._lineage.pop(task_id, None)
                self._lineage_bytes -= size
                self._reconstruction_attempts.pop(task_id, None)

    async def _notify_borrow(self, owner_addr: str, method: str,
                             oid: bytes, addr: str | None = None):
        """Borrower -> owner ref-count edge (add_borrower at first
        handle, remove_borrower at last deref). `addr` overrides the
        registered borrower — the return-value handoff registers the
        CALLER, not the executing worker."""
        self._stats_borrower_notifies += 1
        try:
            owner = await self._clients.get(owner_addr)
            await owner.call(method, {
                "object_id": oid, "addr": addr or self.address,
            }, timeout=30.0)
        except (ConnectionLost, RpcError, OSError,
                asyncio.TimeoutError):
            pass  # owner gone: its ref books died with it

    async def _unpin_at(self, oid: bytes, addr: str, free: bool = False):
        # never let an unpin overtake its (async) pin — the raylet
        # would drop the unpin as unknown and the pin would then leak
        pending = self._pending_pins.get(oid)
        if pending is not None:
            await pending
        try:
            raylet = await self._clients.get(addr)
            # free=True: the owner's distributed refcount hit zero — the
            # raylet should delete the store copy outright (refcount
            # permitting), not merely make it evictable
            await raylet.notify("unpin_object",
                                {"object_id": oid, "free": free})
        except (ConnectionLost, RpcError, OSError):
            pass  # raylet gone — nothing left to unpin

    # -- lineage / reconstruction --------------------------------------

    def _retain_lineage(self, spec: task_mod.TaskSpec,
                        plasma_oids: List[bytes]):
        """Keep a re-executable task's spec while its plasma returns are
        referenced (reference: task_manager.h:215 max_lineage_bytes)."""
        if spec.task_type != task_mod.NORMAL_TASK or spec.streaming:
            return  # actor/streaming tasks are not re-executable
        size = sum(len(e[1]) if e[0] == "v" else 64 for e in spec.args) \
            + 256
        oids = [ObjectID.for_task_return(TaskID(spec.task_id), i).binary()
                for i in range(spec.num_returns)]
        # re-retains happen on every reconstruction reply — replace, do
        # not double-count
        old = self._lineage.pop(spec.task_id, None)
        if old is not None:
            self._lineage_bytes -= old[1]
        self._lineage[spec.task_id] = (spec, size, oids)
        for oid in plasma_oids:
            self._lineage_oids[oid] = spec.task_id
        self._lineage_bytes += size
        while self._lineage_bytes > self.config.max_lineage_bytes \
                and self._lineage:
            evicted_tid, (old_spec, old_size, old_oids) = \
                self._lineage.popitem(last=False)
            self._lineage_bytes -= old_size
            self._stats_lineage_evictions += 1
            self._reconstruction_attempts.pop(evicted_tid, None)
            for o in old_oids:
                if self._lineage_oids.pop(o, None) is not None:
                    # loss of this object is now permanent — remember
                    # why, so its ObjectLostError can say so
                    with self._ref_lock:
                        self._lineage_evicted.add(o)

    def _fail_lost_object(self, oid: bytes, reason: str | None = None):
        """Fail fast: every waiter on a lost, unreconstructable object
        sees ObjectLostError NOW instead of blocking to its timeout."""
        if reason is None:
            if oid in self._lineage_evicted:
                reason = ("its lineage was evicted past "
                          "max_lineage_bytes, so the producing task "
                          "cannot be re-executed")
            else:
                reason = ("it has no lineage to re-execute (ray.put "
                          "data, actor-method returns and streaming "
                          "items are not reconstructable)")
        self._stats_reconstruction_failures += 1
        self.memory_store.put_error(oid, serialization.dumps(
            ObjectLostError(
                f"object {oid.hex()[:12]} lost: all copies are gone "
                f"and {reason}")))

    async def _reconstruct(self, oid: bytes, depth: int = 0) -> bool:
        """Re-execute the task that created a lost object (reference:
        TaskManager::ResubmitTask + ObjectRecoveryManager), recursively
        recovering missing upstream inputs first. Dedupes concurrent
        recoveries of the same task; resolves when the re-execution's
        reply lands (repopulating locations + pins). Bounded two ways:
        lineage_max_depth on the recursive chain and
        max_object_reconstructions per producing task."""
        task_id = self._lineage_oids.get(oid)
        if task_id is None or task_id not in self._lineage:
            self._fail_lost_object(oid)
            return False
        if depth > self.config.lineage_max_depth:
            self._fail_lost_object(
                oid,
                f"its lineage chain is deeper than lineage_max_depth="
                f"{self.config.lineage_max_depth}")
            return False
        fut = self._reconstructing.get(task_id)
        if fut is None:
            spec, _, oids = self._lineage[task_id]
            attempts = self._reconstruction_attempts.get(task_id, 0)
            if attempts >= self.config.max_object_reconstructions:
                self._fail_lost_object(
                    oid,
                    f"task {spec.name or task_id.hex()[:12]} was "
                    f"already re-executed {attempts}x "
                    f"(max_object_reconstructions)")
                return False
            self._reconstruction_attempts[task_id] = attempts + 1
            # hex()[:12] is only the sha1 prefix shared by every task a
            # submitter mints — include the counter bytes or concurrent
            # recoveries all log as "the same" task
            logger.warning(
                "object %s lost — re-executing task %s (%s), "
                "attempt %d, depth %d",
                oid.hex()[:26], task_id.hex()[:26], spec.name,
                attempts + 1, depth)
            fut = self._loop.create_future()
            self._reconstructing[task_id] = fut
            self._stats_reconstructions += 1
            self._stats_reconstruction_depth_max = max(
                self._stats_reconstruction_depth_max, depth + 1)
            mem = self.memory_store
            for roid in oids:
                # clear each sibling's readiness properly: the event must
                # reset so status waiters block until the new copy lands
                for addr in list(mem.locations.get(roid, [])):
                    mem.drop_location(roid, addr)
                # release surviving sibling pins — a popped-but-not-
                # unpinned entry would hold plasma memory forever
                pinned = self._pinned_at.pop(roid, None)
                if pinned is not None:
                    asyncio.ensure_future(self._unpin_at(roid, pinned))
            # Recover missing upstream inputs FIRST: the re-executed
            # task would otherwise hang pulling a dependency whose only
            # copy died on the same node.
            for dep_oid, dep_owner in spec.plasma_deps():
                if dep_owner not in ("", self.address):
                    continue  # borrowed input: its own owner recovers it
                if dep_oid in mem.values or dep_oid in mem.errors \
                        or mem.locations.get(dep_oid):
                    continue
                if not await self._reconstruct(dep_oid, depth + 1):
                    # upstream unreconstructable: this task's returns
                    # are lost too — fail them with the lineage chain
                    self._reconstructing.pop(task_id, None)
                    if not fut.done():
                        fut.set_result(False)
                    self._stats_reconstruction_failures += 1
                    frame = serialization.dumps(ObjectLostError(
                        f"object {oid.hex()[:12]} lost: its producing "
                        f"task {spec.name or task_id.hex()[:12]} "
                        f"depends on upstream object "
                        f"{dep_oid.hex()[:12]}, which is itself lost "
                        f"and unreconstructable (lineage chain: "
                        f"{spec.name or '?'} <- {dep_oid.hex()[:12]})"))
                    for roid in oids:
                        mem.put_error(roid, frame)
                    return False
            # the re-execution's terminal reply releases arg pins like
            # any submission — take them afresh
            self._retain_args(spec)
            if spec.node_id is not None:
                # a task pinned to the dead node must be free to move
                spec.soft = True
            self._enqueue_task(spec)
        await fut
        return bool(fut.result())

    async def rpc_report_lost_location(self, req):
        """A raylet failed to fetch from a location we advertised: if the
        GCS agrees that node is dead, drop the location, and if that was
        the last copy of a reconstructible object kick off re-execution
        (the caller re-queries status, which then blocks until the new
        copy lands). A transient fetch error to a node the GCS still
        considers alive must NOT drop the location — for objects without
        lineage (puts, actor returns) a wrongly-dropped last copy is
        unrecoverable."""
        oid = req["object_id"]
        addr = req["raylet_addr"]
        if not req.get("authoritative"):
            # third-party report: only trust it if the GCS agrees the
            # node is dead (a raylet reporting about its OWN store is
            # authoritative and skips this)
            try:
                nodes = await self.gcs.call("get_nodes", {}, timeout=10.0)
                alive = {n["raylet_addr"] for n in nodes if n["alive"]}
            except (ConnectionLost, RpcError, OSError,
                    asyncio.TimeoutError):
                return {"ok": False, "still_alive": True}  # can't verify
            if addr in alive:
                return {"ok": False, "still_alive": True}
        self.memory_store.drop_location(oid, addr)
        if oid not in self.memory_store.locations:
            if oid in self._lineage_oids:
                asyncio.ensure_future(self._reconstruct(oid))
            else:
                # unrecoverable: fail every waiter fast instead of
                # letting status queries block to their timeouts
                self._fail_lost_object(oid)
        return {"ok": True}

    # ------------------------------------------------------------------
    # function manager (reference: python/ray/_private/function_manager.py)
    # ------------------------------------------------------------------

    def push_function(self, fn) -> bytes:
        pickled = serialization.dumps(fn)
        key = hashlib.sha1(pickled).digest()[:16]
        self._run_sync(self.gcs.call("kv_put", {
            "ns": "fn:" + self.job_id.hex(),
            "key": key,
            "value": pickled,
            "overwrite": False,
        }))
        return key

    async def _load_function(self, key: bytes):
        if key in self._function_cache:
            return self._function_cache[key]
        reply = await self.gcs.call("kv_get",
                                    {"ns": "fn:" + self.job_id.hex(), "key": key})
        if reply["value"] is None:
            raise RuntimeError(f"function {key.hex()} not found in GCS")
        fn = serialization.loads(reply["value"])
        self._function_cache[key] = fn
        return fn

    # ------------------------------------------------------------------
    # put / get / wait
    # ------------------------------------------------------------------

    def put(self, value: Any) -> ObjectRef:
        if not tracing.enabled():  # contextmanager costs ~2us/call
            return self._put_impl(value)
        with tracing.span("object.put", kind="producer") as s:
            ref = self._put_impl(value)
            s["attrs"]["object_id"] = ref.hex()[:16]
            return ref

    def _put_impl(self, value: Any) -> ObjectRef:
        oid = ObjectID.for_put(self.current_task_id, next(self._put_counter))
        # one-copy put: the serialized value holds only VIEWS (pickle
        # stream + out-of-band buffers); the payload is copied exactly
        # once, directly into the shm frame, on the plasma path below
        sv = serialization.serialize_value(value)
        if sv.size <= self.config.max_direct_call_object_size \
                or self.store is None:
            self._run_sync(self._put_inband(oid.binary(), sv.to_bytes()))
        else:
            # construct the ref (registering the local refcount) BEFORE
            # the pin is recorded — _on_ref_released must find a count
            # to decrement when the user drops the ref
            ref = ObjectRef(oid, self.address)
            self._plasma_put_pinned(oid, sv, wait_pin=False)
            self._run_sync(self._put_plasma_meta(oid.binary()))
            return ref
        return ObjectRef(oid, self.address)

    def _plasma_write(self, write_fn, size: int):
        """Run a plasma write, asking the local raylet to spill pinned
        objects to disk when the arena is full (reference: the raylet's
        CreateRequestQueue spill-on-pressure path). This is what lets the
        store hold more live data than its shm capacity."""
        from ray_tpu_torch._private.object_store import ObjectStoreFullError

        # Grace retries before spilling: a concurrent putter's unpin is
        # usually in flight (release -> raylet) when the arena looks
        # full, and a few ms of patience turns a disk spill into an
        # in-memory eviction. Only after the grace window does the
        # raylet get asked to spill pinned objects to disk.
        for delay in (0.002, 0.01):
            try:
                return write_fn()
            except ObjectStoreFullError:
                time.sleep(delay)
        for _ in range(4):
            try:
                return write_fn()
            except ObjectStoreFullError:
                if self.raylet_addr is None:
                    raise
                freed = self._run_sync(self._request_spill(size))
                if freed == 0:
                    raise
        return write_fn()

    def _plasma_put_pinned(self, oid: ObjectID, sv, wait_pin: bool = True):
        """Create+seal+pin without an unprotected window: the creator's
        store reference (held from create until after the raylet's pin
        lands) is what stops a concurrent writer's eviction from
        destroying the fresh refcount-0 object. Reference: the worker
        pins primary copies through its raylet before the task reply.

        `sv` is a serialization.SerializedValue: the create→write-in-
        place→seal sequence below is the one-copy put protocol — the
        payload moves from the caller's arrays straight into the
        writer-private shm buffer, with no intermediate frame bytes.

        ``wait_pin=False`` (the driver put() fast path) takes the pin
        RPC off the critical path: put returns after seal and the
        create reference is released at the async pin ack. That is only
        safe when the UNPIN is sent by this same process — `_unpin_at`
        awaits `_pending_pins` so an unpin can never overtake its pin.
        Executor task/stream returns MUST wait: their unpin comes from
        the owner, a different process with no view of our in-flight
        pin, so replying before the pin lands would let the owner's
        unpin race ahead of it (pinning the object forever)."""
        def write():
            buf = self.store.create_buffer(oid, sv.size)
            sv.write_into(buf)
            self.store.seal(oid)
            # NOT released yet — we still hold the create reference
        self._plasma_write(write, sv.size)
        fut = asyncio.run_coroutine_threadsafe(
            self._pin_then_release(oid), self._loop)
        if wait_pin:
            fut.result(timeout=35)

    async def _pin_then_release(self, oid: ObjectID):
        key = oid.binary()
        done = self._loop.create_future()
        self._pending_pins[key] = done
        try:
            if self.raylet_addr is not None:
                try:
                    await self._pin_local_async(key)
                except Exception as e:  # noqa: BLE001 — see _pin_local
                    logger.warning(
                        "pin of %s at local raylet failed: %r",
                        key.hex()[:12], e)
        finally:
            self.store.release(oid)
            self._pending_pins.pop(key, None)
            if not done.done():
                done.set_result(None)

    async def _pin_local_async(self, oid: bytes):
        raylet = await self._clients.get(self.raylet_addr)
        await raylet.call("pin_object", {"object_id": oid}, timeout=30.0)

    async def _list_objects_on(self, raylet_addr: str):
        raylet = await self._clients.get(raylet_addr)
        return await raylet.call("list_objects", {}, timeout=30.0)

    async def _store_stats_on(self, raylet_addr: str):
        raylet = await self._clients.get(raylet_addr)
        return await raylet.call("get_store_stats", {}, timeout=30.0)

    async def _request_spill(self, size: int) -> int:
        try:
            raylet = await self._clients.get(self.raylet_addr)
            reply = await raylet.call("spill_objects",
                                      {"needed": size}, timeout=60.0)
            return int(reply.get("freed", 0))
        except (ConnectionLost, RpcError, OSError,
                asyncio.TimeoutError):
            return 0

    async def _put_inband(self, oid: bytes, frame: bytes):
        self.memory_store.put_value(oid, frame)

    async def _put_plasma_meta(self, oid: bytes):
        self.memory_store.add_location(oid, self.raylet_addr)
        # the pin is held or in flight (_plasma_put_pinned; in-flight
        # pins are reconciled with unpins via _pending_pins in
        # _unpin_at); record where, so ref release routes the unpin
        self._pinned_at[oid] = self.raylet_addr

    _FAST_MISS = object()

    def get(self, refs, timeout: float | None = None):
        if not tracing.enabled():
            return self._get_impl(refs, timeout)
        if isinstance(refs, ObjectRef):
            n = 1
        else:
            refs = list(refs)  # materialize: span must not eat the iter
            n = len(refs)
        with tracing.span("object.get", kind="consumer",
                          attrs={"num_refs": n}):
            return self._get_impl(refs, timeout)

    def _get_impl(self, refs, timeout: float | None = None):
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        slow: List[Tuple[int, ObjectRef]] = []
        for i, ref in enumerate(ref_list):
            v = self._get_fast(ref, deadline)
            if v is CoreWorker._FAST_MISS:
                slow.append((i, ref))
            out.append(v)
        if slow:
            remaining = None
            if deadline is not None:
                remaining = max(0.0, deadline - time.monotonic())
            values = self._run_sync(
                self._get_async([r for _, r in slow], remaining))
            for (i, _), v in zip(slow, values):
                out[i] = v
        for v in out:
            if isinstance(v, Exception):
                raise v
        return out[0] if single else out

    def _get_fast(self, ref: ObjectRef, deadline: float | None):
        """Caller-thread resolution of owned in-band results: no event-loop
        round trip, and deserialization happens off the loop thread."""
        if ref.owner_addr not in ("", self.address):
            return CoreWorker._FAST_MISS
        oid = ref.binary()
        mem = self.memory_store
        for _ in range(2):
            if oid in mem.errors:
                return self._error_from_frame(mem.errors[oid])
            if oid in mem.values:
                return serialization.loads(mem.values[oid])
            if oid in mem.locations:
                return CoreWorker._FAST_MISS  # plasma: needs the pull path
            waiter = mem.arm_thread_waiter(oid)
            if waiter is None:
                # not a pending owned result (or it just resolved):
                # loop back to re-check the value dicts once
                if mem.ready(oid):
                    continue
                return CoreWorker._FAST_MISS
            t = None if deadline is None else max(0.0, deadline - time.monotonic())
            try:
                waiter.result(t)
            except (SyncTimeoutError, TimeoutError):
                # distinct types before 3.11 (bpo-44793 unified them)
                raise GetTimeoutError(f"get timed out: {ref}")
        return CoreWorker._FAST_MISS

    async def _get_async(self, refs: Sequence[ObjectRef],
                         timeout: float | None = None) -> List[Any]:
        if len(refs) == 1:  # skip gather's per-ref task wrapping
            return [await self._get_one(refs[0], timeout)]
        return await asyncio.gather(*[self._get_one(r, timeout) for r in refs])

    async def _get_one(self, ref: ObjectRef, timeout: float | None = None):
        oid = ref.binary()
        mem = self.memory_store
        owner_is_self = ref.owner_addr in ("", self.address)

        deadline = None
        if timeout is not None:
            deadline = self._loop.time() + timeout

        def remaining():
            if deadline is None:
                return None
            return max(0.0, deadline - self._loop.time())

        pull_failures = 0
        while True:
            if oid in mem.errors:
                return self._error_from_frame(mem.errors[oid])
            if oid in mem.values:
                return serialization.loads(mem.values[oid])
            if self.store is not None:
                buf = self.store.get_buffer(ObjectID(oid), timeout=-1)
                if buf is not None:
                    return serialization.deserialize(buf)
            if oid in mem.locations:
                # Object lives in remote plasma: ask local raylet to pull it.
                try:
                    await self._pull_via_raylet(ref)
                except (ConnectionLost, RpcError, OSError):
                    # The owner may have declared the object lost while
                    # the pull was in flight (node death swept it):
                    # prefer its verdict — an ObjectLostError naming the
                    # lineage — over the transport error. Owned objects
                    # surface it from mem.errors on the next pass;
                    # borrowed refs drop the stale locations and
                    # re-query the owner, bounded so a persistently
                    # failing pull still raises.
                    if owner_is_self:
                        if oid not in mem.errors and oid not in mem.values:
                            raise
                    else:
                        pull_failures += 1
                        if pull_failures >= 3:
                            raise
                        for addr in list(mem.locations.get(oid, [])):
                            mem.drop_location(oid, addr)
                continue
            if owner_is_self:
                try:
                    await mem.wait_ready(oid, remaining())
                except asyncio.TimeoutError:
                    raise GetTimeoutError(f"get timed out: {ref}")
                continue
            # Borrowed ref: ask the owner for status.
            status = await self._owner_status(ref, remaining())
            if status.get("error"):
                return RayTaskError(status["error"])
            if status["status"] == "inband":
                mem.put_value(oid, status["value"])
            elif status["status"] == "err":
                mem.put_error(oid, status["value"])
            else:
                for addr in status.get("locations", []):
                    mem.add_location(oid, addr)

    async def _owner_status(self, ref: ObjectRef, timeout: float | None):
        owner = await self._clients.get(ref.owner_addr)
        try:
            return await owner.call("get_object_status", {
                "object_id": ref.binary(),
                "wait": True,
            }, timeout=timeout)
        except asyncio.TimeoutError:
            raise GetTimeoutError(f"get timed out: {ref}")

    async def _pull_via_raylet(self, ref: ObjectRef):
        if _fi._PLAN is not None:
            await _fi._PLAN.object_pull()
        raylet = await self._clients.get(self.raylet_addr)
        await raylet.call("pull_object", {
            "object_id": ref.binary(),
            "owner_addr": ref.owner_addr or self.address,
        }, timeout=300.0)

    def _error_from_frame(self, frame: bytes) -> Exception:
        err = serialization.loads(frame)
        if isinstance(err, Exception):
            return err
        return RayTaskError(str(err))

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: float | None = None):
        # Duplicate refs make ready/not_ready partition counts lie
        # (len(ready)+len(not_ready) < len(refs)); the reference rejects
        # them outright (ray.wait, python/ray/_private/worker.py).
        if len({r.binary() for r in refs}) != len(refs):
            raise ValueError("wait() requires a list of unique object refs")
        # Caller-thread fast path: enough refs already visible in the
        # memory store resolves the wait with no loop round-trip — the
        # drain-a-big-batch pattern (`while not_ready: ready, not_ready =
        # wait(not_ready)`) calls wait ~len(refs) times on mostly-ready
        # sets, and a loop hop per call would dominate it.
        mem = self.memory_store
        ready = []
        for ref in refs:
            if mem.ready(ref.binary()):
                ready.append(ref)
                if len(ready) >= num_returns:
                    ready_set = set(ready)
                    return ready, [r for r in refs if r not in ready_set]
        return self._run_sync(self._wait_async(refs, num_returns, timeout))

    async def _wait_async(self, refs, num_returns, timeout):
        """Scan-and-pulse wait: poll readiness synchronously, block on the
        memory store's global completion event between scans. Remote
        (borrowed) refs additionally get a status-driver coroutine whose
        result lands in the memory store — waking the same pulse. The
        API contract (reference ray.wait) caps ready at num_returns."""
        mem = self.memory_store
        deadline = None if timeout is None else self._loop.time() + timeout
        # a driver that FAILS (owner unreachable) counts its ref as
        # ready — the error surfaces at get(), and the wait must not
        # spin forever on a ref that can never resolve
        failed: set = set()

        async def drive(r):
            try:
                await self._ready_one(r)
            except Exception:  # noqa: BLE001 — recorded, surfaced at get
                failed.add(r.binary())
                mem._any_event.set()

        drivers = [asyncio.ensure_future(drive(r))
                   for r in refs if r.owner_addr not in ("", self.address)]
        # plasma membership can change without a memory-store signal
        # (e.g. a local put from another thread): include it in the
        # first scan and in periodic rescans
        scan_plasma = True
        ready: List[ObjectRef] = []
        try:
            while True:
                ready = []
                for r in refs:
                    oid = r.binary()
                    if mem.ready(oid) or oid in failed or (
                            scan_plasma and self.store is not None
                            and self.store.contains(ObjectID(oid))):
                        ready.append(r)
                        if len(ready) >= num_returns:
                            break
                scan_plasma = False
                if len(ready) >= num_returns or len(ready) == len(refs):
                    break  # enough ready, or nothing left to wait on
                if deadline is not None and self._loop.time() >= deadline:
                    break
                t = 0.25
                if deadline is not None:
                    t = min(t, max(0.0, deadline - self._loop.time()))
                try:
                    await mem.wait_any(t)
                except asyncio.TimeoutError:
                    scan_plasma = True  # periodic plasma rescan
        finally:
            for f in drivers:
                f.cancel()
        ready_set = set(ready)
        return ready, [r for r in refs if r not in ready_set]

    async def _ready_one(self, ref: ObjectRef):
        oid = ref.binary()
        mem = self.memory_store
        while True:
            if mem.ready(oid):
                return
            if self.store is not None and self.store.contains(ObjectID(oid)):
                return
            if ref.owner_addr in ("", self.address):
                await mem.wait_ready(oid)
                return
            status = await self._owner_status(ref, None)
            if status["status"] == "inband":
                mem.put_value(oid, status["value"])
            elif status["status"] == "err":
                mem.put_error(oid, status["value"])
            else:
                for addr in status.get("locations", []):
                    mem.add_location(oid, addr)
            return

    def as_future(self, ref: ObjectRef) -> SyncFuture:
        out: SyncFuture = SyncFuture()

        def _done(task: asyncio.Task):
            exc = task.exception()
            if exc is not None:
                out.set_exception(exc)
            else:
                value = task.result()
                if isinstance(value, Exception):
                    out.set_exception(value)
                else:
                    out.set_result(value)

        fut = asyncio.run_coroutine_threadsafe(self._get_one(ref), self._loop)
        fut.add_done_callback(_done)
        return out

    async def await_ref(self, ref: ObjectRef):
        """Used by `await ref` inside async actor methods (runs on the actor
        loop, so delegate to the io loop)."""
        value = await asyncio.wrap_future(
            asyncio.run_coroutine_threadsafe(self._get_one(ref), self._loop)
        )
        if isinstance(value, Exception):
            raise value
        return value

    # ------------------------------------------------------------------
    # argument serialization
    # ------------------------------------------------------------------

    def _serialize_args(self, args, kwargs):
        """Returns (wire_args, wire_kwargs, nested_refs) — nested_refs is
        the (oid, owner_addr) list of every ObjectRef a by-value payload
        pickled buried inside a container. Such specs must not join
        multi-task actor batches (see `_actor_enqueue`) even though their
        top-level entries are all by-value, and the owner pins the nested
        refs for the task's lifetime exactly like top-level ref args."""
        nested = []  # local, not self.<attr>: submits are multi-thread
        wire_args = []
        for a in args:
            wire_args.append(self._serialize_arg(a, nested))
        wire_kwargs = {k: self._serialize_arg(v, nested)
                       for k, v in (kwargs or {}).items()}
        return wire_args, wire_kwargs, nested

    def _serialize_arg(self, value, nested=None):
        if isinstance(value, ObjectRef):
            oid = value.binary()
            mem = self.memory_store
            # Inline owner-local in-band values (reference:
            # LocalDependencyResolver inlines memory-store objects).
            if oid in mem.values:
                return ["v", mem.values[oid]]
            return ["r", oid, value.owner_addr or self.address]
        payload, refs = serialization.dumps_with_ref_flag(value)
        if refs and nested is not None:
            nested.extend(
                (r.binary(), r.owner_addr or self.address) for r in refs)
        return ["v", payload]

    @staticmethod
    def _args_all_inline(spec: task_mod.TaskSpec) -> bool:
        return (all(e[0] == "v" for e in spec.args)
                and all(e[0] == "v" for e in spec.kwargs.values()))

    @classmethod
    def _batchable(cls, spec: task_mod.TaskSpec) -> bool:
        """A spec may ride a multi-task actor batch only if it depends on
        no other object: no top-level by-ref args AND no ObjectRef nested
        inside a by-value container (the submit side stamps
        `_nested_refs`; specs built elsewhere default to unbatchable only
        when the stamp is absent and args are refs)."""
        return (not getattr(spec, "_nested_refs", False)
                and cls._args_all_inline(spec))

    @staticmethod
    def _deserialize_inline_args(spec: task_mod.TaskSpec):
        """Caller/executor-thread decode of all-inline args: pure CPU, no
        event-loop round trip (the hot path — most tasks ship only
        by-value args)."""
        args = [serialization.loads(e[1]) for e in spec.args]
        kwargs = {k: serialization.loads(e[1])
                  for k, e in spec.kwargs.items()}
        return args, kwargs

    async def _deserialize_args(self, spec: task_mod.TaskSpec):
        async def resolve(entry):
            if entry[0] == "v":
                return serialization.loads(entry[1])
            ref = ObjectRef(ObjectID(entry[1]), entry[2])
            value = await self._get_one(ref)
            if isinstance(value, Exception):
                raise value
            return value

        args = [await resolve(e) for e in spec.args]
        kwargs = {k: await resolve(e) for k, e in spec.kwargs.items()}
        return args, kwargs

    # ------------------------------------------------------------------
    # normal task submission (CoreWorkerDirectTaskSubmitter)
    # ------------------------------------------------------------------

    def submit_task(
        self,
        function_key: bytes,
        args: tuple,
        kwargs: dict,
        name: str = "",
        num_returns: int = 1,
        resources: Dict[str, float] | None = None,
        max_retries: int | None = None,
        strategy: str = task_mod.STRATEGY_DEFAULT,
        node_id: bytes | None = None,
        soft: bool = False,
        placement_group_id: bytes | None = None,
        bundle_index: int = -1,
        streaming: bool = False,
        runtime_env: dict | None = None,
    ):
        task_id = TaskID.of(self.job_id, self.current_task_id,
                            next(self._task_counter))
        if not tracing.enabled():  # contextmanager costs ~2us/call
            return self._submit_task_traced(
                task_id, None, function_key, args, kwargs, name,
                num_returns, resources, max_retries, strategy, node_id,
                soft, placement_group_id, bundle_index, streaming,
                runtime_env)
        with tracing.submit_span(name, task_mod.NORMAL_TASK) as trace_ctx:
            return self._submit_task_traced(
                task_id, trace_ctx, function_key, args, kwargs, name,
                num_returns, resources, max_retries, strategy, node_id,
                soft, placement_group_id, bundle_index, streaming,
                runtime_env)

    def _submit_task_traced(
        self, task_id, trace_ctx, function_key, args, kwargs, name,
        num_returns, resources, max_retries, strategy, node_id, soft,
        placement_group_id, bundle_index, streaming, runtime_env,
    ):
        wire_args, wire_kwargs, nested_refs = \
            self._serialize_args(args, kwargs)
        spec = task_mod.TaskSpec(
            task_id=task_id.binary(),
            job_id=self.job_id.binary(),
            name=name,
            trace_ctx=trace_ctx,
            _nested_refs=nested_refs,
            task_type=task_mod.NORMAL_TASK,
            function_key=function_key,
            args=wire_args,
            kwargs=wire_kwargs,
            num_returns=0 if streaming else num_returns,
            resources=resources or {"CPU": 1.0},
            owner_addr=self.address,
            owner_worker_id=self.worker_id.binary(),
            strategy=strategy,
            node_id=node_id,
            soft=soft,
            placement_group_id=placement_group_id,
            bundle_index=bundle_index,
            # a partially-consumed stream cannot be transparently
            # re-executed — streaming tasks are never retried
            max_retries=0 if streaming else (
                self.config.task_max_retries_default
                if max_retries is None else max_retries),
            streaming=streaming,
            runtime_env=runtime_env,
        )
        if self.mode == "worker":
            # recursive-cancel bookkeeping: this spec is a child of the
            # task executing on this thread/coroutine (context-local, so
            # concurrent actor tasks attribute correctly); entries are
            # popped when the parent finishes
            parent = _executing_task_id.get()
            if parent is not None:
                self._task_children.setdefault(parent, []).append(
                    spec.task_id)
        # pin by-ref args for the task's lifetime BEFORE the enqueue —
        # the caller may drop its handles the moment `.remote()` returns
        self._retain_args(spec)
        if streaming:
            # plain dict insert; ordered before the task via the same
            # submit-buffer flush the enqueue rides on
            self._make_stream(spec.task_id)
            self._submit_enqueue("normal", spec)
            return ObjectRefGenerator(self, spec.task_id)
        refs = [
            ObjectRef(ObjectID.for_task_return(task_id, i), self.address)
            for i in range(num_returns)
        ]
        for r in refs:
            self.memory_store.register_thread_waiter(r.binary())
        self._submit_enqueue("normal", spec)
        return refs

    # ------------------------------------------------------------------
    # streaming generators (num_returns="streaming")
    #
    # Reference: `_raylet.pyx:273` ObjectRefGenerator +
    # `ReportGeneratorItemReturns` (core_worker.proto:462) + the
    # generator_waiter.h backpressure. The executor reports each yielded
    # item to the owner as it is produced; the owner buffers item refs,
    # withholding the ack once `streaming_backpressure_items` are
    # unconsumed so a slow consumer throttles the producer. Early close()
    # tells the executor to stop at the next report.
    # ------------------------------------------------------------------

    def _make_stream(self, task_id: bytes) -> dict:
        st = self._streams[task_id] = {
            "items": deque(),      # ObjectRefs ready to hand out
            "done": False,         # no more items will arrive
            "error": None,         # stream-level failure (Exception)
            "cancelled": False,
            "new_item": asyncio.Event(),   # owner-loop waiters
            "drained": asyncio.Event(),    # backpressure release
        }
        return st

    #: coroutine-safe exhaustion marker — StopIteration cannot cross a
    #: coroutine boundary (PEP 479 turns it into RuntimeError)
    _STREAM_DONE = object()

    def stream_next(self, task_id: bytes,
                    timeout: float | None = None) -> ObjectRef:
        """Block (caller thread) for the next item ref of a stream.
        Raises StopIteration when the stream completed, or the stream
        error."""
        out = self._run_sync(self._stream_next_async(task_id, timeout),
                             timeout=None)
        if out is CoreWorker._STREAM_DONE:
            raise StopIteration
        return out

    async def _stream_next_async(self, task_id: bytes,
                                 timeout: float | None = None):
        """Returns the next ObjectRef, or _STREAM_DONE on exhaustion."""
        st = self._streams.get(task_id)
        if st is None:
            return CoreWorker._STREAM_DONE
        deadline = None if timeout is None else self._loop.time() + timeout
        while True:
            if st["items"]:
                ref = st["items"].popleft()
                if len(st["items"]) < \
                        self.config.streaming_backpressure_items:
                    st["drained"].set()
                return ref
            if st["error"] is not None:
                self._streams.pop(task_id, None)
                raise st["error"]
            if st["done"] or st["cancelled"]:
                self._streams.pop(task_id, None)
                return CoreWorker._STREAM_DONE
            st["new_item"].clear()
            wait_for = None
            if deadline is not None:
                wait_for = max(0.0, deadline - self._loop.time())
                if wait_for == 0.0:
                    raise GetTimeoutError(
                        f"stream item not ready within {timeout}s")
            try:
                await asyncio.wait_for(st["new_item"].wait(), wait_for)
            except asyncio.TimeoutError:
                raise GetTimeoutError(
                    f"stream item not ready within {timeout}s") from None

    def stream_cancel(self, task_id: bytes):
        """Stop the producer at its next report (early generator close).
        Also the terminal cleanup: close() means no further next() calls,
        so the stream dict and any unconsumed buffered item values are
        reclaimed here — a long-lived proxy must not accumulate state per
        aborted stream."""
        def _cancel():
            st = self._streams.pop(task_id, None)
            if st is not None:
                st["cancelled"] = True
                st["drained"].set()
                st["new_item"].set()
                mem = self.memory_store
                for ref in st["items"]:
                    oid = ref.binary()
                    mem.values.pop(oid, None)
                    mem.errors.pop(oid, None)
                    mem._events.pop(oid, None)
        self._loop.call_soon_threadsafe(_cancel)

    async def rpc_report_stream_item(self, req):
        """Owner-side: the executor reports one yielded item (reference:
        HandleReportGeneratorItemReturns). The reply doubles as the
        backpressure ack — withheld while the buffer is full — and
        carries the cancellation flag back to the producer."""
        task_id = req["task_id"]
        st = self._streams.get(task_id)
        if st is None or st["cancelled"]:
            return {"ok": True, "cancelled": True}
        oid, kind, payload = req["item"]
        mem = self.memory_store
        if kind == "v":
            mem.put_value(oid, payload)
        elif kind == "err":
            mem.put_error(oid, payload)
        else:  # plasma
            mem.add_location(oid, payload)
            # the executor pinned the item at its raylet; record the
            # mapping so the consumer's ref release unpins it
            self._pinned_at[oid] = payload
        st["items"].append(ObjectRef(ObjectID(oid), self.address))
        st["new_item"].set()
        while (len(st["items"]) >=
               self.config.streaming_backpressure_items
               and not st["cancelled"]):
            st["drained"].clear()
            await st["drained"].wait()
        return {"ok": True, "cancelled": st["cancelled"]}

    def _finish_stream(self, task_id: bytes,
                       error: Exception | None = None):
        st = self._streams.get(task_id)
        if st is None:
            return
        if error is not None and st["error"] is None:
            st["error"] = error
        st["done"] = True
        st["new_item"].set()

    def _enqueue_task(self, spec: task_mod.TaskSpec):
        self._emit_task_event(spec.task_id, spec.name, spec.task_type,
                              "SUBMITTED")
        key = spec.scheduling_key()
        state = self._key_states.get(key)
        if state is None:
            state = self._key_states[key] = _KeyState()
        state.queue.append([spec, spec.max_retries])
        # Pipeline through a bounded set of leases (reference: the
        # submitter caps in-flight lease requests per SchedulingKey).
        # One request per queued task would flood the raylet into
        # spawning far more workers than cores under bursty submission.
        cap = min(max(1, len(state.queue)),
                  self.config.max_lease_requests_per_key)
        if state.requesting < cap:
            state.requesting += 1
            asyncio.ensure_future(self._lease_and_run(key, state))

    async def _lease_and_run(self, key, state: _KeyState):
        try:
            while state.queue:
                spec0 = state.queue[0][0]
                lease = await self._request_lease(spec0)
                if lease is None or not lease.get("granted"):
                    if state.queue:
                        entry = state.queue.popleft()
                        self._store_task_error(
                            entry[0],
                            RayTaskError(
                                "scheduling failed: "
                                + str((lease or {}).get("error", "no lease"))
                            ),
                        )
                    continue
                await self._drain_with_lease(key, state, lease)
        finally:
            state.requesting -= 1

    async def _pg_bundle_addr(self, pg_id: bytes, bundle_index: int) -> str:
        """Route a PG-targeted lease to the raylet hosting the bundle
        (reference: the submitter's lease policy consults the placement
        group's location)."""
        deadline = self._loop.time() + 300.0
        while True:
            reply = await self.gcs.call("get_placement_group", {"pg_id": pg_id})
            if reply.get("found") and reply["state"] == "CREATED":
                break
            if reply.get("found") and reply["state"] == "REMOVED":
                raise RayTaskError("placement group was removed")
            if self._loop.time() > deadline:
                raise RayTaskError("placement group never became ready")
            await asyncio.sleep(0.05)
        nodes = await self.gcs.call("get_nodes", {})
        addr_by_id = {n["node_id"]: n["raylet_addr"] for n in nodes if n["alive"]}
        index = bundle_index if bundle_index >= 0 else 0
        node_id = reply["bundle_nodes"][index]
        if node_id not in addr_by_id:
            raise RayTaskError("placement group bundle node is dead")
        return addr_by_id[node_id]

    async def _request_lease(self, spec: task_mod.TaskSpec, max_hops: int = 4):
        addr = self.raylet_addr
        no_spillback = False
        if spec.placement_group_id is not None:
            try:
                addr = await self._pg_bundle_addr(
                    spec.placement_group_id, spec.bundle_index
                )
            except RayTaskError as e:
                return {"granted": False, "error": str(e)}
            no_spillback = True
        conn_retries = 0
        hops = 0
        while hops < max_hops:
            hops += 1
            try:
                raylet = await self._clients.get(addr)
                reply = await raylet.call("request_worker_lease", {
                    "spec": spec.to_wire(),
                    "no_spillback": no_spillback,
                }, timeout=300.0)
            except RpcError as e:
                # the peer is ALIVE and replied with an error — never a
                # connectivity retry case
                return {"granted": False, "error": str(e)}
            except (ConnectionLost, OSError) as e:
                if (spec.placement_group_id is None
                        and addr != self.raylet_addr
                        and conn_retries < 15):
                    # A dead/unreachable REMOTE hop (spillback target or
                    # soft-affinity node that died between the scheduling
                    # decision and the lease): wait for the GCS to prune
                    # it from the view, then re-route from the local
                    # raylet — failing the task here would turn a node
                    # death into a permanent task error even though
                    # other capacity exists (lineage reconstruction hits
                    # exactly this window). Each cycle resets the hop
                    # budget — the reroute itself consumes local->target
                    # hops. PG-targeted leases are excluded: their
                    # bundle's death is the PG machinery's to handle.
                    conn_retries += 1
                    hops = 0
                    addr = self.raylet_addr
                    no_spillback = False
                    await asyncio.sleep(1.0)
                    continue
                return {"granted": False, "error": str(e)}
            if reply.get("granted"):
                reply["raylet_addr"] = addr
                return reply
            if reply.get("spillback_addr"):
                addr = reply["spillback_addr"]
                no_spillback = True
                continue
            return reply
        return {"granted": False, "error": "too many spillback hops"}

    async def _drain_with_lease(self, key, state: _KeyState, lease: dict):
        """Drain the key's queue through one leased worker with a bounded
        pipeline: up to `max_tasks_in_flight_per_worker` pushes ride the
        connection before the first reply returns (reference: lease
        pipelining in direct_task_transport.h:75). The worker executes
        FIFO, so replies resolve in push order."""
        worker_addr = lease["worker_addr"]
        raylet_addr = lease["raylet_addr"]
        lease_id = lease["lease_id"]
        worker_dead = False
        # SPREAD asks for per-task placement decisions: pipelining the
        # queue through one cached lease would funnel every task onto the
        # first node that answered. One task per lease; the caller loop
        # re-requests for the rest. (The whole queue shares one strategy:
        # it's part of the scheduling key.)
        depth = (1 if state.queue
                 and state.queue[0][0].strategy == task_mod.STRATEGY_SPREAD
                 else self.config.max_tasks_in_flight_per_worker)
        in_flight: deque = deque()  # ([(spec, retries_left), ...], fut)
        n_inflight = 0
        try:
            try:
                worker = await self._clients.get(worker_addr)
            except (ConnectionLost, OSError):
                # never connected: nothing sent, nothing to fail — the
                # caller loop re-leases for the still-queued tasks
                worker_dead = True
                return
            while state.queue or in_flight:
                # Pipeline only the queue's fair share per outstanding
                # lease: a short queue spread over several pending leases
                # must not funnel onto the first worker that answers
                # (that would serialize long tasks that could have run in
                # parallel), while a long queue pipelines deep to
                # amortize the push round trip. Everything the window
                # admits in one go rides ONE batch frame (the executor
                # enqueues the whole batch before replying) — per-task
                # frames would pay a syscall each way per task.
                share = max(1, len(state.queue)
                            // max(1, state.requesting))
                window = min(depth, share)
                while state.queue and n_inflight < window:
                    if state.queue[0][0].task_id in self._cancelled_tasks:
                        spec, _ = state.queue.popleft()
                        self._store_task_error(
                            spec, TaskCancelledError("task was cancelled"))
                        continue
                    take = min(window - n_inflight, len(state.queue))
                    # Only dependency-free specs may share a frame: the
                    # batch's single reply is withheld until every task
                    # in it finishes, so a spec whose ref args resolve
                    # via THIS owner could deadlock on an earlier
                    # batchmate's in-band return (same rule as the actor
                    # fast path — see _actor_enqueue). A spec with deps
                    # rides alone.
                    if not self._batchable(state.queue[0][0]):
                        batch = [state.queue.popleft()]
                    else:
                        batch = []
                        while (state.queue and len(batch) < take
                               and self._batchable(state.queue[0][0])
                               and state.queue[0][0].task_id
                               not in self._cancelled_tasks):
                            batch.append(state.queue.popleft())
                    try:
                        if len(batch) == 1:
                            fut = worker.call_nowait(
                                "push_task",
                                {"spec": batch[0][0].to_wire()})
                        else:
                            fut = worker.call_nowait(
                                "push_task_batch",
                                {"specs": [b[0].to_wire()
                                           for b in batch]})
                    except (ConnectionLost, OSError):
                        # not sent: requeue without burning a retry
                        for b in reversed(batch):
                            state.queue.appendleft(b)
                        worker_dead = True
                        break
                    in_flight.append((batch, fut))
                    n_inflight += len(batch)
                    for b in batch:
                        self._inflight_tasks[b[0].task_id] = worker_addr
                if not in_flight:
                    return
                batch, fut = in_flight.popleft()
                n_inflight -= len(batch)
                try:
                    replies = await fut
                except (ConnectionLost, RpcError, OSError) as e:
                    # The worker executes FIFO, so only the batch whose
                    # reply we were awaiting can contain tasks that
                    # started executing — each burns a retry (it may
                    # have run) and carries the OOM blame. Batches
                    # pushed behind it never started: requeue without
                    # burning a retry, like the never-sent case above.
                    # (A reply lost in transit could in principle mean
                    # the next batch also started — same at-most-once
                    # race the reference accepts.)
                    worker_dead = True
                    oom_reason = await self._worker_exit_reason(
                        raylet_addr, worker_addr)
                    for later_batch, f in in_flight:
                        # mark retrieved — abandoned reply futures would
                        # otherwise log "exception was never retrieved"
                        f.add_done_callback(
                            lambda fut: fut.cancelled() or fut.exception())
                        state.queue.extend(later_batch)
                        for b in later_batch:
                            self._inflight_tasks.pop(b[0].task_id, None)
                    in_flight.clear()
                    n_inflight = 0
                    for spec, retries_left in batch:
                        self._inflight_tasks.pop(spec.task_id, None)
                        if spec.task_id in self._cancelled_tasks:
                            # a force-cancel kills the worker: the lost
                            # connection IS the cancellation succeeding
                            self._store_task_error(
                                spec,
                                TaskCancelledError("task was cancelled"))
                        elif retries_left > 0:
                            state.queue.append([spec, retries_left - 1])
                        elif oom_reason:
                            self._store_task_error(
                                spec, OutOfMemoryError(oom_reason))
                        else:
                            self._store_task_error(
                                spec, RayTaskError(f"worker died: {e}"))
                    return
                if len(batch) == 1:
                    replies = [replies]
                for (spec, _), reply in zip(batch, replies):
                    self._inflight_tasks.pop(spec.task_id, None)
                    self._process_task_reply(spec, reply)
                if depth == 1:
                    return  # SPREAD: one task per lease
        finally:
            try:
                raylet = await self._clients.get(raylet_addr)
                # fire-and-forget: the reply was never used, and frames on
                # one connection are FIFO, so the raylet processes the
                # return before any subsequent lease request from this
                # owner — dropping the await removes one round trip per
                # lease cycle (and the notify rides the write coalescer)
                await raylet.notify("return_worker", {
                    "lease_id": lease_id,
                    "worker_dead": worker_dead,
                })
            except (ConnectionLost, RpcError, OSError):
                pass

    async def _worker_exit_reason(self, raylet_addr: str,
                                  worker_addr: str) -> str | None:
        """Ask the worker's raylet whether it killed the worker on
        purpose (memory monitor) — turns a connection loss into an
        actionable OutOfMemoryError."""
        try:
            raylet = await self._clients.get(raylet_addr)
            reply = await raylet.call("get_worker_exit_reason",
                                      {"worker_addr": worker_addr},
                                      timeout=5.0)
            return reply.get("reason")
        except (ConnectionLost, RpcError, OSError,
                asyncio.TimeoutError):
            return None

    def _process_task_reply(self, spec: task_mod.TaskSpec, reply: dict):
        self._emit_task_event(
            spec.task_id, spec.name, spec.task_type,
            "FAILED" if reply.get("error") else "FINISHED")
        self._cancelled_tasks.pop(spec.task_id, None)  # terminal
        self._release_args(spec)  # drop the submitted-task arg pins
        mem = self.memory_store
        # Return values carrying ObjectRefs: the executor registered us
        # as borrower of each before replying; hold them until the
        # return object itself dies (the serialized reply contains the
        # ref whether or not we ever deserialize a handle).
        for ret_oid, pairs in reply.get("ref_handoffs", []):
            with self._ref_lock:
                for oid, owner in pairs:
                    self._task_arg_refs[oid] = \
                        self._task_arg_refs.get(oid, 0) + 1
                    if owner != self.address \
                            and oid not in self._borrowed_refs:
                        self._borrowed_refs[oid] = owner
                self._contained_refs.setdefault(ret_oid, []).extend(
                    [tuple(p) for p in pairs])
                gone = self._ref_gone(ret_oid)
            if gone:
                # the return's handle died before the reply landed —
                # nothing will ever trigger the containment release
                self._release_contained(ret_oid)
        plasma_oids: List[bytes] = []
        for entry in reply.get("returns", []):
            oid, kind, payload = entry
            if kind == "v":
                mem.put_value(oid, payload)
            elif kind == "err":
                mem.put_error(oid, payload)
            elif kind == "plasma":
                mem.add_location(oid, payload)
                plasma_oids.append(oid)
                # the executor pinned the return at its raylet before
                # replying — record the mapping only while someone still
                # holds a reference (decide under the ref lock, act on
                # the verdict outside it; a deref racing the record
                # enqueues a release that re-checks and unpins)
                with self._ref_lock:
                    referenced = not self._ref_gone(oid)
                if referenced:
                    self._pinned_at[oid] = payload
                else:
                    asyncio.ensure_future(
                        self._unpin_at(oid, payload, free=True))
        if plasma_oids:
            self._retain_lineage(spec, plasma_oids)
            for oid in plasma_oids:
                with self._ref_lock:
                    gone = self._ref_gone(oid)
                if gone:
                    self._on_ref_released(oid)  # ref died pre-reply
        fut = self._reconstructing.pop(spec.task_id, None)
        if fut is not None and not fut.done():
            fut.set_result(not reply.get("error"))
        if spec.streaming:
            # the final reply closes the stream; pre-execution failures
            # arrive as an error entry instead of item reports
            err = None
            for entry in reply.get("returns", []):
                if entry[1] == "err":
                    err = self._error_from_frame(entry[2])
                    break
            self._finish_stream(spec.task_id, err)

    def _store_task_error(self, spec: task_mod.TaskSpec, err: Exception):
        self._emit_task_event(spec.task_id, spec.name, spec.task_type,
                              "FAILED")
        self._cancelled_tasks.pop(spec.task_id, None)  # terminal
        self._release_args(spec)
        fut = self._reconstructing.pop(spec.task_id, None)
        if fut is not None and not fut.done():
            fut.set_result(False)
        if spec.streaming:
            self._loop.call_soon_threadsafe(
                self._finish_stream, spec.task_id, err)
            return
        frame = serialization.dumps(err)
        for i in range(spec.num_returns):
            oid = ObjectID.for_task_return(TaskID(spec.task_id), i)
            self.memory_store.put_error(oid.binary(), frame)

    # ------------------------------------------------------------------
    # actor submission (CoreWorkerDirectActorTaskSubmitter)
    # ------------------------------------------------------------------

    def create_actor(
        self,
        class_key: bytes,
        args: tuple,
        kwargs: dict,
        name: str = "",
        actor_name: str | None = None,
        resources: Dict[str, float] | None = None,
        max_restarts: int = 0,
        max_concurrency: int = 1,
        detached: bool = False,
        strategy: str = task_mod.STRATEGY_DEFAULT,
        node_id: bytes | None = None,
        soft: bool = False,
        placement_group_id: bytes | None = None,
        bundle_index: int = -1,
        runtime_env: dict | None = None,
        concurrency_groups: Dict[str, int] | None = None,
    ) -> ActorID:
        actor_id = ActorID.of(self.job_id, self.current_task_id,
                              next(self._task_counter))
        task_id = TaskID.of(self.job_id, self.current_task_id,
                            next(self._task_counter), actor_id)
        wire_args, wire_kwargs, _ = self._serialize_args(args, kwargs)
        spec = task_mod.TaskSpec(
            task_id=task_id.binary(),
            job_id=self.job_id.binary(),
            name=name,
            task_type=task_mod.ACTOR_CREATION_TASK,
            function_key=class_key,
            args=wire_args,
            kwargs=wire_kwargs,
            num_returns=0,
            resources=resources or {"CPU": 1.0},
            owner_addr=self.address,
            owner_worker_id=self.worker_id.binary(),
            actor_id=actor_id.binary(),
            max_restarts=max_restarts,
            max_concurrency=max_concurrency,
            strategy=strategy,
            node_id=node_id,
            soft=soft,
            placement_group_id=placement_group_id,
            bundle_index=bundle_index,
            detached=detached,
            actor_name=actor_name,
            runtime_env=runtime_env,
            concurrency_groups=concurrency_groups,
        )
        reply = self._run_sync(
            self.gcs.call("register_actor", {"spec": spec.to_wire()})
        )
        if not reply.get("ok"):
            raise ValueError(reply.get("error", "actor registration failed"))
        return actor_id

    def submit_actor_task(
        self,
        actor_id: ActorID,
        method_name: str,
        args: tuple,
        kwargs: dict,
        num_returns: int = 1,
        streaming: bool = False,
        concurrency_group: str = "",
    ):
        task_id = TaskID.of(self.job_id, self.current_task_id,
                            next(self._task_counter), actor_id)
        if not tracing.enabled():
            return self._submit_actor_task_traced(
                actor_id, task_id, None, method_name, args, kwargs,
                num_returns, streaming, concurrency_group)
        with tracing.submit_span(method_name,
                                 task_mod.ACTOR_TASK) as trace_ctx:
            return self._submit_actor_task_traced(
                actor_id, task_id, trace_ctx, method_name, args, kwargs,
                num_returns, streaming, concurrency_group)

    def _submit_actor_task_traced(self, actor_id, task_id, trace_ctx,
                                  method_name, args, kwargs, num_returns,
                                  streaming, concurrency_group=""):
        wire_args, wire_kwargs, nested_refs = \
            self._serialize_args(args, kwargs)
        spec = task_mod.TaskSpec(
            task_id=task_id.binary(),
            job_id=self.job_id.binary(),
            name=method_name,
            trace_ctx=trace_ctx,
            task_type=task_mod.ACTOR_TASK,
            args=wire_args,
            kwargs=wire_kwargs,
            num_returns=0 if streaming else num_returns,
            owner_addr=self.address,
            owner_worker_id=self.worker_id.binary(),
            actor_id=actor_id.binary(),
            method_name=method_name,
            streaming=streaming,
            concurrency_group=concurrency_group,
        )
        spec._nested_refs = nested_refs
        self._retain_args(spec)
        if streaming:
            self._make_stream(spec.task_id)
            self._submit_enqueue("actor", spec)
            return ObjectRefGenerator(self, spec.task_id)
        refs = [
            ObjectRef(ObjectID.for_task_return(task_id, i), self.address)
            for i in range(num_returns)
        ]
        for r in refs:
            self.memory_store.register_thread_waiter(r.binary())
        self._submit_enqueue("actor", spec)
        return refs

    def _actor_state(self, actor_id: bytes) -> dict:
        st = self._actor_clients.get(actor_id)
        if st is None:
            st = self._actor_clients[actor_id] = {
                "queue": deque(),
                "sending": False,
                "seq": 0,
                "epoch": 0,
                "instance": None,  # (addr, num_restarts) of the live actor
            }
        return st

    def _submit_enqueue(self, kind: str, spec: task_mod.TaskSpec):
        """Caller-thread side of submission: buffer the spec and make sure
        ONE flush callback is scheduled. A burst of `.remote()` calls from
        a tight loop lands in a single loop wakeup, and the flush batches
        same-actor tasks into one RPC frame."""
        self._submit_buffer.append((kind, spec))
        if not self._submit_flush_scheduled:
            self._submit_flush_scheduled = True
            self._loop.call_soon_threadsafe(self._flush_submissions)

    def _flush_submissions(self):
        # clear-then-drain: a producer appending after the clear schedules
        # a fresh flush, so no submission is ever stranded in the buffer
        self._submit_flush_scheduled = False
        batches: Dict[bytes, list] = {}  # actor_id -> [st,addr,restarts,client,[specs]]
        while True:
            try:
                kind, spec = self._submit_buffer.popleft()
            except IndexError:
                break
            if kind == "normal":
                self._enqueue_task(spec)
            elif kind == "actor":
                self._actor_enqueue(spec, batches)
            elif kind in ("add_borrower", "remove_borrower"):
                # spec is (oid, owner_addr) — borrower-side ref edge
                asyncio.ensure_future(
                    self._notify_borrow(spec[1], kind, spec[0]))
            else:  # "release": spec is the released object id
                self._on_ref_released(spec)
        for entry in batches.values():
            self._send_actor_batch(*entry)

    def _actor_enqueue(self, spec: task_mod.TaskSpec,
                       batches: Dict[bytes, list] | None = None):
        self._emit_task_event(spec.task_id, spec.name, spec.task_type,
                              "SUBMITTED")
        st = self._actor_state(spec.actor_id)
        # A spec with by-reference args — top-level OR nested inside a
        # by-value container — must NEVER ride a multi-task batch: the
        # batch's single reply is withheld until every task finishes, but
        # resolving this spec's ref args (via get() in the task body for
        # nested ones) may need the in-band return of an EARLIER task in
        # the same batch (whose value only arrives in that withheld
        # reply) — deadlock. Send it as its own frame so upstream replies
        # flow independently.
        if batches is not None and not self._batchable(spec):
            # first send whatever batch already accumulated for this
            # actor (its tasks precede this one in submission order)...
            entry = batches.pop(spec.actor_id, None)
            if entry is not None:
                self._send_actor_batch(*entry)
            # ...then fall through with batching disabled for this spec
            batches = None
        if batches is not None:
            entry = batches.get(spec.actor_id)
            if entry is not None:
                # this flush already fast-paths this actor: ride the batch
                entry[4].append(spec)
                return
        # Fast path: actor resolved, connection live, nothing queued — write
        # the frame at the end of this flush, skipping the sender/push
        # coroutine hops. The executing side reorders by (epoch, seq) per
        # caller, so this cannot race the slow path on ordering.
        if not st["sending"] and not st["queue"] and st.get("instance"):
            addr, restarts = st["instance"]
            client = self._clients.get_cached(addr)
            if client is not None:
                if batches is not None:
                    batches[spec.actor_id] = [st, addr, restarts, client,
                                              [spec]]
                else:
                    self._send_actor_batch(st, addr, restarts, client,
                                           [spec])
                return
        st["queue"].append(spec)
        if not st["sending"]:
            st["sending"] = True
            asyncio.ensure_future(self._actor_sender(spec.actor_id, st))

    def _send_actor_batch(self, st: dict, addr: str, restarts: int,
                          client, specs: list):
        """Write one frame carrying every fast-path task this flush
        collected for one actor. Sequence numbers are assigned here, in
        buffer order."""
        for spec in specs:
            self._assign_seq(st, addr, restarts, spec)
        try:
            if len(specs) == 1:
                fut = client.call_nowait("push_task",
                                         {"spec": specs[0].to_wire()})
            else:
                fut = client.call_nowait(
                    "push_task_batch",
                    {"specs": [s.to_wire() for s in specs]})
        except (ConnectionLost, OSError) as e:
            for spec in specs:
                self._actor_task_failed(st, spec, addr, e)
            return
        for spec in specs:
            self._inflight_tasks[spec.task_id] = addr
        if len(specs) == 1:
            fut.add_done_callback(
                lambda f, spec=specs[0], st=st, addr=addr:
                self._actor_fast_reply(f, spec, st, addr))
        else:
            fut.add_done_callback(
                lambda f, specs=specs, st=st, addr=addr:
                self._actor_batch_reply(f, specs, st, addr))

    def _actor_batch_reply(self, fut: asyncio.Future, specs: list,
                           st: dict, addr: str):
        try:
            replies = fut.result()
        except (ConnectionLost, RpcError, OSError) as e:
            for spec in specs:
                self._actor_task_failed(st, spec, addr, e)
            return
        for spec, reply in zip(specs, replies):
            self._inflight_tasks.pop(spec.task_id, None)
            self._process_task_reply(spec, reply)

    def _assign_seq(self, st: dict, addr: str, restarts: int,
                    spec: task_mod.TaskSpec):
        """Assign (epoch, seq) against the current actor instance. The epoch
        bumps whenever numbering restarts — new actor instance or reconnect
        after failure — so the executor can resync instead of waiting on a
        seq that died with the old connection."""
        instance = (addr, restarts)
        if st.get("seq_instance") != instance:
            st["seq_instance"] = instance
            st["epoch"] += 1
            st["seq"] = 0
        spec.seq_no = st["seq"]
        spec.seq_epoch = st["epoch"]
        st["seq"] += 1

    def _actor_task_failed(self, st: dict, spec: task_mod.TaskSpec,
                           addr: str, exc: Exception):
        """Shared failure handling for fast- and slow-path pushes: invalidate
        the cached instance AND the seq instance (forcing an epoch bump on
        the next send), then error the task — actor tasks are never
        implicitly re-executed."""
        if st.get("instance") and st["instance"][0] == addr:
            st["instance"] = None
        st["seq_instance"] = None
        if isinstance(exc, (ConnectionLost, OSError)):
            # the actor's process is gone (or going): until the GCS
            # learns of it, a resolve still hands out this address, and a
            # dial would retry against the refused port for a whole
            # connect timeout (10 s) before failing the next call. The
            # restarted instance, if any, listens elsewhere.
            self._clients.mark_failed(addr)
        self._inflight_tasks.pop(spec.task_id, None)
        if spec.task_id in self._cancelled_tasks:
            # force-cancel took the worker down mid-call: report the
            # cancellation, not a spurious actor death
            self._store_task_error(
                spec, TaskCancelledError("task was cancelled"))
            return
        self._store_task_error(
            spec,
            ActorDiedError(
                f"actor task {spec.method_name} failed (actor died "
                f"mid-call, not retried): {exc}"
            ),
        )

    def _actor_fast_reply(self, fut: asyncio.Future,
                          spec: task_mod.TaskSpec, st: dict, addr: str):
        try:
            reply = fut.result()
        except (ConnectionLost, RpcError, OSError) as e:
            self._actor_task_failed(st, spec, addr, e)
            return
        self._inflight_tasks.pop(spec.task_id, None)
        self._process_task_reply(spec, reply)

    async def _actor_sender(self, actor_id: bytes, st: dict):
        """Ordered, pipelined sends: sequence numbers assigned at send time
        against the current actor instance (so a restarted actor starts at
        seq 0), replies handled asynchronously. A task in flight when the
        actor dies fails — actor tasks are never implicitly re-executed
        (reference: max_task_retries defaults to 0 for actors)."""
        try:
            while st["queue"]:
                spec = st["queue"][0]
                try:
                    addr, restarts = await self._resolve_actor(actor_id)
                except ActorDiedError as e:
                    while st["queue"]:
                        self._store_task_error(st["queue"].popleft(), e)
                    return
                if not st["queue"] or st["queue"][0] is not spec:
                    # cancel dequeued the head while we awaited
                    # _resolve_actor: the cancelled spec must not be sent,
                    # and whatever is at the head now must not be dropped.
                    continue
                st["queue"].popleft()
                self._assign_seq(st, addr, restarts, spec)
                asyncio.ensure_future(self._push_actor_task(st, spec, addr))
        finally:
            st["sending"] = False

    async def _push_actor_task(self, st: dict, spec: task_mod.TaskSpec,
                               addr: str):
        try:
            worker = await self._clients.get(addr)
            self._inflight_tasks[spec.task_id] = addr
            reply = await worker.call("push_task", {"spec": spec.to_wire()},
                                      timeout=None)
            self._inflight_tasks.pop(spec.task_id, None)
            self._process_task_reply(spec, reply)
        except (ConnectionLost, RpcError, OSError) as e:
            self._actor_task_failed(st, spec, addr, e)

    async def _resolve_actor(self, actor_id: bytes,
                             timeout: float | None = None
                             ) -> Tuple[str, int]:
        st = self._actor_state(actor_id)
        if st.get("instance") is not None:
            return st["instance"]
        deadline = None if timeout is None else self._loop.time() + timeout
        while True:
            reply = await self.gcs.call("get_actor", {"actor_id": actor_id})
            if reply.get("found"):
                if reply["state"] == "ALIVE":
                    st["instance"] = (reply["addr"],
                                      reply.get("num_restarts", 0))
                    return st["instance"]
                if reply["state"] == "DEAD":
                    raise ActorDiedError(
                        f"actor {actor_id.hex()[:8]} is dead: "
                        f"{reply.get('death_cause')}"
                    )
            ev = self._actor_events.setdefault(actor_id, asyncio.Event())
            ev.clear()
            t = 1.0
            if deadline is not None:
                t = min(t, max(0.05, deadline - self._loop.time()))
                if self._loop.time() > deadline:
                    raise ActorDiedError(
                        f"timed out resolving actor {actor_id.hex()[:8]}")
            try:
                await asyncio.wait_for(ev.wait(), t)
            except asyncio.TimeoutError:
                pass

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        self._run_sync(self.gcs.call("kill_actor", {
            "actor_id": actor_id.binary(),
            "reason": "ray_tpu_torch.kill",
        }))

    # ------------------------------------------------------------------
    # task cancellation (reference: ray.cancel, worker.py:2932;
    # CancelTask/RemoteCancelTask, core_worker.proto:252-270)
    # ------------------------------------------------------------------

    def cancel(self, ref, force: bool = False, recursive: bool = True):
        """Best-effort cancel of the task that produces `ref`: pending
        tasks are dequeued and error with TaskCancelledError; running
        tasks are interrupted at the executor (async actor tasks via
        coroutine cancel, sync tasks via an async thread exception);
        `force` kills the executing worker process; `recursive` also
        cancels the task's unfinished children."""
        if isinstance(ref, ObjectRefGenerator):
            ref.close()
            return
        # return ids embed the producing task id in their first 13 bytes
        # (ids.ObjectID.for_task_return)
        task_id = ref.binary()[:13] + b"\x00\x00\x00"
        self._run_sync(self._cancel_task_async(task_id, force, recursive))

    async def _cancel_task_async(self, task_id: bytes, force: bool,
                                 recursive: bool) -> bool:
        self._prune_cancel_ids(self._cancelled_tasks)
        self._cancelled_tasks[task_id] = time.monotonic()
        err = TaskCancelledError("task was cancelled")
        # pending in a normal-task submit queue: dequeue + error
        for state in self._key_states.values():
            for entry in list(state.queue):
                if entry[0].task_id == task_id:
                    try:
                        state.queue.remove(entry)
                    except ValueError:
                        continue  # a drain loop claimed it first
                    self._store_task_error(entry[0], err)
                    return True
        # pending in an actor send queue
        for st in self._actor_clients.values():
            for spec in list(st["queue"]):
                if spec.task_id == task_id:
                    try:
                        st["queue"].remove(spec)
                    except ValueError:
                        continue
                    self._store_task_error(spec, err)
                    return True
        # pushed: ask the worker it is executing on (or queued at)
        addr = self._inflight_tasks.get(task_id)
        if addr is not None:
            try:
                w = await self._clients.get(addr)
                await w.call("cancel_task", {
                    "task_id": task_id, "force": force,
                    "recursive": recursive,
                }, timeout=10.0)
                return True
            except (ConnectionLost, RpcError, OSError,
                    asyncio.TimeoutError):
                return False
        return False

    # ------------------------------------------------------------------
    # owner services (RPC handlers, run on io loop)
    # ------------------------------------------------------------------

    async def rpc_get_object_status(self, req):
        oid = req["object_id"]
        mem = self.memory_store
        if oid in self._freed_objects and not mem.ready(oid):
            # freed on refcount zero: a borrower whose add_borrower
            # lost the race with the final deref must error out now —
            # waiting would hang forever on books we emptied
            return {"status": "err", "value": serialization.dumps(
                ObjectLostError(
                    f"object {oid.hex()[:12]} was freed by its owner "
                    "(refcount reached zero before this borrow was "
                    "registered)"))}
        if req.get("wait") and not mem.ready(oid):
            if self.store is not None and self.store.contains(ObjectID(oid)):
                mem.add_location(oid, self.raylet_addr)
            else:
                await mem.wait_ready(oid)
        if oid in mem.errors:
            return {"status": "err", "value": mem.errors[oid]}
        if oid in mem.values:
            return {"status": "inband", "value": mem.values[oid]}
        return {"status": "plasma", "locations": mem.locations.get(oid, [])}

    async def rpc_add_object_location(self, req):
        self.memory_store.add_location(req["object_id"], req["raylet_addr"])
        return {"ok": True}

    async def rpc_pubsub(self, msg):
        if msg["channel"] == "actors":
            data = msg["data"]
            actor_id = data["actor_id"]
            st = self._actor_state(actor_id)
            if data["state"] == "ALIVE":
                st["instance"] = (data["addr"], data.get("num_restarts", 0))
            else:
                st["instance"] = None
            ev = self._actor_events.get(actor_id)
            if ev is not None:
                ev.set()
        elif msg["channel"] == "nodes":
            data = msg["data"]
            if data.get("event") == "removed":
                await self._on_node_removed(data)
        return None

    async def _on_node_removed(self, data: dict):
        """GCS death notice: invalidate every advertised location on the
        dead node and recover — or fail fast — owned objects whose last
        copy died with it (reference: ObjectRecoveryManager's node-death
        path). Runs on the io loop, so the location scan is atomic with
        respect to reply processing."""
        dead_addr = data.get("raylet_addr", "")
        if not dead_addr:
            return  # pre-recovery GCS build: notice carries no address
        # dead peers leave the client pool so reconnect backoff cannot
        # stall lease rerouting; mark_dead makes any later dial (a
        # lease spilled back to the victim by a raylet that hasn't seen
        # the death yet, an unpin, a status probe) fail fast instead of
        # burning a full connect timeout against a black hole
        self._clients.invalidate(dead_addr)
        self._clients.mark_dead(dead_addr)
        mem = self.memory_store
        lost: List[bytes] = []
        for oid in list(mem.locations.keys()):
            locs = mem.locations.get(oid)
            if not locs or dead_addr not in locs:
                continue
            mem.drop_location(oid, dead_addr)
            if oid not in mem.locations and oid not in mem.values \
                    and oid not in mem.errors:
                lost.append(oid)
        for oid, addr in list(self._pinned_at.items()):
            if addr == dead_addr:
                # the pin died with the raylet holding it
                self._pinned_at.pop(oid, None)
        for oid in lost:
            if oid in self._lineage_oids:
                asyncio.ensure_future(self._reconstruct(oid))
            else:
                self._fail_lost_object(oid)

    async def rpc_add_borrower(self, req):
        """A worker deserialized a ref we own: hold the object until it
        reports release (reference: the borrower half of
        WaitForRefRemoved, inverted to borrower-push)."""
        oid = req["object_id"]
        with self._ref_lock:
            self._borrowers.setdefault(oid, set()).add(req["addr"])
        return {"ok": True}

    async def rpc_remove_borrower(self, req):
        oid = req["object_id"]
        release = False
        with self._ref_lock:
            s = self._borrowers.get(oid)
            if s is not None:
                s.discard(req["addr"])
                if not s:
                    self._borrowers.pop(oid, None)
            release = self._ref_gone(oid)
        if release:
            self._on_ref_released(oid)
        return {"ok": True}

    async def rpc_dump_stacks(self, req):
        """All Python thread stacks of this worker/driver process for
        `ray_tpu stack`. Served from the RPC loop thread, so a task
        wedging the executor thread still gets its stack reported —
        which is the whole point of asking."""
        from ray_tpu_torch._private import health as health_mod

        return {"pid": os.getpid(), "role": "worker",
                "worker_id": self.worker_id.binary().hex(),
                "threads": health_mod.dump_stacks()}

    async def rpc_exit_worker(self, req):
        logger.info("exit requested: %s", req.get("reason"))
        self._exec_queue.put(None)
        # A kill interrupts the actor's running methods (reference:
        # ray.kill fails them at once): an idle worker leaves through the
        # task loop's sentinel and its orderly exit (cleanup, exit hooks)
        # runs to its end; one still inside a method (a stream, a long
        # call) KILL_GRACE_S later is ended, so it cannot keep the
        # process, and with it the worker's GPU and device memory, past
        # the kill. A daemon thread, not the event loop: the sentinel's
        # shutdown stops the loop, then waits for the method's thread.
        # The JAX package only queues the sentinel.
        threading.Thread(target=self._end_methods_after_kill, daemon=True,
                         name="kill_grace").start()
        return None

    def _end_methods_after_kill(self) -> None:
        while True:
            time.sleep(KILL_GRACE_S)
            if self._running_threads or self._running_async:
                os._exit(1)

    async def rpc_cancel_task(self, req):
        """Executor side of ray_tpu_torch.cancel (reference: RemoteCancelTask,
        core_worker.proto:261). Marks the id so a not-yet-started task
        errors at dispatch; interrupts a running one (coroutine cancel
        for async actors, async thread exception for sync executors);
        recursively cancels the task's children; `force` exits the
        worker process."""
        task_id = req["task_id"]
        force = req.get("force", False)
        recursive = req.get("recursive", True)
        self._prune_cancel_ids(self._cancel_requested)
        self._cancel_requested[task_id] = time.monotonic()
        atask = self._running_async.get(task_id)
        if atask is not None and self._actor_async_loop is not None:
            self._actor_async_loop.call_soon_threadsafe(atask.cancel)
        else:
            tid = self._running_threads.get(task_id)
            if tid is not None:
                import ctypes

                ctypes.pythonapi.PyThreadState_SetAsyncExc(
                    ctypes.c_ulong(tid),
                    ctypes.py_object(_TaskCancelledInterrupt))
        child_cancels = []
        if recursive:
            # this worker OWNS the children the task submitted — cancel
            # them through its own submitter machinery
            for child in list(self._task_children.get(task_id, ())):
                child_cancels.append(asyncio.ensure_future(
                    self._cancel_task_async(child, force, recursive)))
        if force:
            # Reply first, then die: the owner maps the connection loss
            # to TaskCancelledError via its cancelled set. The exit must
            # WAIT for the child-cancel RPCs — this process is those
            # children's owner; dying before the cancels reach their
            # executors would orphan them running to completion.
            async def _die():
                if child_cancels:
                    await asyncio.wait(child_cancels, timeout=5.0)
                await asyncio.sleep(0.1)  # let the reply frame flush
                os._exit(1)

            asyncio.ensure_future(_die())
        return {"ok": True}

    # ------------------------------------------------------------------
    # task execution (worker mode; reference: _raylet.pyx execute_task)
    # ------------------------------------------------------------------

    async def rpc_push_task(self, req):
        spec = task_mod.TaskSpec.from_wire(req["spec"])
        loop = self._loop
        fut = loop.create_future()
        if spec.task_type == task_mod.ACTOR_TASK:
            await self._enqueue_ordered(spec, fut)
        else:
            self._exec_queue.put((spec, fut))
        return await fut

    async def rpc_push_task_batch(self, req):
        """Executor side of the coalesced submit: one frame, many tasks.
        All are enqueued before the first reply is awaited, and the one
        reply frame carries every result (submitter batches replies back
        out to per-task processing). Tasks bound for the serial executor
        (normal tasks; sync actors without concurrency machinery) ride
        ONE executor hop and post all their results in ONE threadsafe
        callback — per-task thread wakeups would dominate small-task
        batches."""
        futs = []
        serial: list = []  # (spec, fut) executed back-to-back
        for wire in req["specs"]:
            spec = task_mod.TaskSpec.from_wire(wire)
            fut = self._loop.create_future()
            futs.append(fut)
            if spec.task_type == task_mod.ACTOR_TASK:
                for pair in self._enqueue_ordered_collect(spec, fut):
                    if self._serial_executable(pair[0]):
                        serial.append(pair)
                    else:
                        self._dispatch_actor_task(*pair)
            else:
                serial.append((spec, fut))
        if len(serial) == 1:
            spec, fut = serial[0]
            if spec.task_type == task_mod.ACTOR_TASK:
                self._dispatch_actor_task(spec, fut)
            else:
                self._exec_queue.put((spec, fut))
        elif serial:
            self._exec_queue.put((serial, None))
        return await asyncio.gather(*futs)

    def _serial_executable(self, spec: task_mod.TaskSpec) -> bool:
        """True when this actor task would land on the worker main
        thread anyway (no async loop, no threadpool, no concurrency
        groups) — the only case batch execution cannot reduce
        parallelism."""
        return (self._actor_async_loop is None
                and self._actor_threadpool is None
                and not self._actor_group_pools
                and not self._resolve_group(spec))

    async def _enqueue_ordered(self, spec: task_mod.TaskSpec, fut):
        for pair in self._enqueue_ordered_collect(spec, fut):
            self._dispatch_actor_task(*pair)

    def _enqueue_ordered_collect(self, spec: task_mod.TaskSpec, fut):
        """Per-caller (epoch, seq) ordering (reference: ActorSchedulingQueue).

        The epoch bumps when the caller restarts numbering (reconnect after a
        connection loss, or actor restart). A newer epoch means no more
        frames from the old one can arrive: flush whatever is buffered (best
        effort, in seq order — the missing seqs died with the connection)
        and resync at seq 0. An older epoch is a stray orphan; run it rather
        than wedge the stream."""
        caller = spec.owner_worker_id
        ready: list = []
        st = self._actor_seq_state.get(caller)
        if st is None:
            st = self._actor_seq_state[caller] = {
                "epoch": -1, "expect": 0, "buffer": {},
            }
        if spec.seq_epoch < st["epoch"]:
            ready.append((spec, fut))
            return ready
        if spec.seq_epoch > st["epoch"]:
            for seq in sorted(st["buffer"]):
                ready.append(st["buffer"][seq])
            st["buffer"] = {}
            st["epoch"] = spec.seq_epoch
            st["expect"] = 0
        st["buffer"][spec.seq_no] = (spec, fut)
        while st["expect"] in st["buffer"]:
            ready.append(st["buffer"].pop(st["expect"]))
            st["expect"] += 1
        return ready

    def _dispatch_actor_task(self, spec, fut):
        if self._actor_async_loop is not None:
            asyncio.run_coroutine_threadsafe(
                self._run_async_actor_task(spec, fut), self._actor_async_loop
            )
            return
        if spec.task_type == task_mod.ACTOR_TASK:
            group = self._resolve_group(spec)
            pools = self._actor_group_pools or {}
            pool = pools.get(group)
            if group and pool is None:
                # an explicitly-requested group must exist — silently
                # running in the default executor would void the
                # caller's isolation assumption (same contract as the
                # async path)
                reply = self._group_error(spec, group)
                self._loop.call_soon_threadsafe(
                    lambda: fut.done() or fut.set_result(reply))
                return
            if pool is not None:
                pool.submit(self._execute_to_future, spec, fut)
                return
        if self._actor_threadpool is not None:
            self._actor_threadpool.submit(self._execute_to_future, spec, fut)
        else:
            self._exec_queue.put((spec, fut))

    def run_task_loop(self):
        """Blocks forever executing tasks (worker main thread). Queue
        items are (spec, fut) singles or ([(spec, fut), ...], None)
        batches from rpc_push_task_batch."""
        while True:
            item = None
            try:
                item = self._exec_queue.get()
                if item is None:
                    break
                spec, fut = item
                if isinstance(spec, list):
                    self._execute_batch(spec)
                else:
                    self._execute_to_future(spec, fut)
            except _TaskCancelledInterrupt:
                # A cancel interrupt that landed between tasks (the
                # target already finished): the loop must survive it,
                # and the in-hand item's reply futures must still
                # resolve — a dropped item would strand its owner's
                # get() forever. item None means the interrupt consumed
                # the shutdown sentinel (or beat the store of a popped
                # item — vanishingly rare): exit rather than risk
                # blocking on get() forever after a lost sentinel.
                if item is None:
                    break
                self._resolve_lost_item(item)
                continue

    def _resolve_lost_item(self, item) -> None:
        spec, fut = item
        pairs = spec if isinstance(spec, list) else [(spec, fut)]
        replies = []
        for s, f in pairs:
            if s.task_id in self._cancel_requested:
                replies.append((f, self._package_cancelled(s)))
            else:
                try:
                    raise RayTaskError(
                        "task interrupted by a stale cancellation")
                except RayTaskError as e:
                    replies.append((f, self._package_error(s, e)))

        def post():
            for f, reply in replies:
                if not f.done():
                    f.set_result(reply)

        self._loop.call_soon_threadsafe(post)

    def _execute_guarded(self, spec, done: Optional[dict] = None) -> dict:
        """execute_task plus a net for cancel interrupts that land in
        the gaps outside its own try block — a reply is ALWAYS produced
        (a swallowed interrupt would strand the owner's future). With
        `done`, the reply is stashed there under the task id before
        this returns, so a caller that an interrupt reaches after the
        return finds it instead of running the task again."""
        try:
            reply = self.execute_task(spec)
        except _TaskCancelledInterrupt:
            if spec.task_id in self._cancel_requested:
                reply = self._package_cancelled(spec)
            else:
                try:
                    raise RayTaskError(
                        "task interrupted by a stale cancellation")
                except RayTaskError as e:
                    reply = self._package_error(spec, e)
        if done is not None:
            done[spec.task_id] = reply
        return reply

    def _execute_to_future(self, spec, fut):
        reply = self._execute_guarded(spec)
        self._loop.call_soon_threadsafe(
            lambda: fut.done() or fut.set_result(reply)
        )

    def _execute_batch(self, pairs):
        """Execute a batch serially, then resolve every reply future in
        ONE loop callback (one self-pipe write instead of len(pairs)).
        A cancel interrupt landing BETWEEN tasks of the batch must not
        discard batchmates: completed results stand, the in-hand spec
        gets a cancelled reply only if it was the cancel target, and
        everything else resumes execution (a stale interrupt — its
        target already finished — is simply consumed). A spec runs at
        most once: `_execute_guarded` stashes each reply in `done`
        before it returns, and an interrupt that lands after that (the
        JAX package runs the spec again there) finds the stash."""
        results = []
        done: Dict[bytes, dict] = {}
        while len(results) < len(pairs):
            spec, fut = pairs[len(results)]
            try:
                if spec.task_id not in done:
                    self._execute_guarded(spec, done)
                results.append((fut, done[spec.task_id]))
            except _TaskCancelledInterrupt:
                if spec.task_id not in done and \
                        spec.task_id in self._cancel_requested:
                    done[spec.task_id] = self._package_cancelled(spec)
                # else: a stale interrupt aimed at an already-finished
                # batchmate, or one that landed after this spec's reply
                # was stashed (or appended): the loop goes on from the
                # first spec without an appended reply

        def post():
            for fut, reply in results:
                if not fut.done():
                    fut.set_result(reply)

        self._loop.call_soon_threadsafe(post)

    async def _run_async_actor_task(self, spec, fut):
        self._running_async[spec.task_id] = asyncio.current_task()
        _executing_task_id.set(spec.task_id)  # task-local context
        try:
            if spec.task_id in self._cancel_requested:
                reply = self._package_cancelled(spec)
            else:
                group = self._resolve_group(spec) \
                    if spec.task_type == task_mod.ACTOR_TASK else ""
                sems = self._actor_group_sems
                if group and group not in sems:
                    reply = self._group_error(spec, group)
                else:
                    sem = sems.get(group, self._actor_async_sem)
                    async with sem:
                        reply = await self._execute_task_async(spec)
        except asyncio.CancelledError:
            # ray_tpu_torch.cancel on a running async actor task: catching the
            # cancellation (not re-raising) lets the reply flow back
            reply = self._package_cancelled(spec)
        finally:
            self._running_async.pop(spec.task_id, None)
            self._task_children.pop(spec.task_id, None)
            self._cancel_requested.pop(spec.task_id, None)
        self._loop.call_soon_threadsafe(
            lambda: fut.done() or fut.set_result(reply)
        )

    async def _execute_task_async(self, spec: task_mod.TaskSpec):
        with tracing.execute_span(spec):
            return await self._execute_task_async_inner(spec)

    async def _execute_task_async_inner(self, spec: task_mod.TaskSpec):
        try:
            if self._args_all_inline(spec):
                args, kwargs = self._deserialize_inline_args(spec)
            else:
                args, kwargs = await asyncio.wrap_future(
                    asyncio.run_coroutine_threadsafe(
                        self._deserialize_args(spec), self._loop
                    )
                )
            method = getattr(self._actor_instance, spec.method_name)
            result = method(*args, **kwargs)
            if asyncio.iscoroutine(result) and \
                    not inspect.isgenerator(result):
                # isgenerator guard: on py<3.12 asyncio.iscoroutine also
                # matches plain generators, and awaiting one TypeErrors
                # instead of reaching the streaming dispatch below
                result = await result
            if spec.streaming and hasattr(result, "__anext__"):
                return await self._execute_streaming_async(spec, result)
            if spec.streaming and hasattr(result, "__next__"):
                # sync generator on an async actor: drive it off-loop —
                # the per-item ack waits (backpressure) must not freeze
                # the actor's other coroutines
                return await asyncio.get_running_loop().run_in_executor(
                    None, self._execute_streaming, spec, result)
            # packaging can block (plasma write + pin RPC under memory
            # pressure) — keep it off the actor's event loop
            return await asyncio.get_running_loop().run_in_executor(
                None, self._package_returns, spec, result)
        except Exception as e:  # noqa: BLE001
            return self._package_error(spec, e)

    def execute_task(self, spec: task_mod.TaskSpec) -> dict:
        with tracing.execute_span(spec):
            return self._execute_task_inner(spec)

    @staticmethod
    def _prune_cancel_ids(d: Dict[bytes, float], max_age: float = 600.0,
                          soft_cap: int = 1024) -> None:
        """Bound the cancel-id books: ids normally leave at the task's
        terminal reply, but a cancel aimed at an already-finished task
        has no terminal event — age the stragglers out."""
        if len(d) <= soft_cap:
            return
        cutoff = time.monotonic() - max_age
        for k in [k for k, ts in d.items() if ts < cutoff]:
            del d[k]

    def _package_cancelled(self, spec: task_mod.TaskSpec) -> dict:
        try:
            raise TaskCancelledError("task was cancelled")
        except TaskCancelledError as e:
            return self._package_error(spec, e)

    def _execute_task_inner(self, spec: task_mod.TaskSpec) -> dict:
        if spec.task_id in self._cancel_requested:
            return self._package_cancelled(spec)  # cancelled while queued
        prev_task = self.current_task_id
        self.current_task_id = TaskID(spec.task_id)
        self._running_threads[spec.task_id] = threading.get_ident()
        ctx_token = _executing_task_id.set(spec.task_id)
        try:
            # All-inline args decode right here; only by-reference args
            # need the event loop's async resolution machinery (two
            # thread hops per task — measurable on small tasks).
            if self._args_all_inline(spec):
                args, kwargs = self._deserialize_inline_args(spec)
            else:
                args, kwargs = asyncio.run_coroutine_threadsafe(
                    self._deserialize_args(spec), self._loop
                ).result()
            if spec.task_type == task_mod.NORMAL_TASK:
                fn = self._function_cache.get(spec.function_key)
                if fn is None:
                    fn = asyncio.run_coroutine_threadsafe(
                        self._load_function(spec.function_key), self._loop
                    ).result()
                result = fn(*args, **kwargs)
            elif spec.task_type == task_mod.ACTOR_CREATION_TASK:
                cls = asyncio.run_coroutine_threadsafe(
                    self._load_function(spec.function_key), self._loop
                ).result()
                instance = cls(*args, **kwargs)
                self._actor_instance = instance
                self.current_actor_id = ActorID(spec.actor_id)
                groups = spec.concurrency_groups
                if self._has_async_methods(cls):
                    if spec.max_concurrency > 1 or groups:
                        self._start_actor_async_loop(
                            max(1, spec.max_concurrency), groups)
                    else:
                        self._start_actor_async_loop(1)
                elif groups:
                    # named concurrency groups, threaded actor
                    # (reference: concurrency_group_manager.h — one
                    # executor per group + the default group)
                    self._actor_group_pools = {
                        name: ThreadPoolExecutor(
                            max(1, int(n)),
                            thread_name_prefix=f"group-{name}")
                        for name, n in groups.items()
                    }
                    self._actor_threadpool = ThreadPoolExecutor(
                        max(1, spec.max_concurrency),
                        thread_name_prefix="group-default")
                elif spec.max_concurrency > 1:
                    self._actor_threadpool = ThreadPoolExecutor(
                        spec.max_concurrency
                    )
                return {"returns": []}
            elif spec.task_type == task_mod.ACTOR_TASK:
                if spec.method_name == "__ray_tpu_channel_graph__":
                    # compiled-DAG channel stages (reference: the aDAG
                    # executor loop, compiled_dag_node.py): starts a
                    # daemon thread pumping this actor's graph nodes —
                    # read input channels, run method, write output
                    # channels — so the actor stays callable
                    result = self._start_channel_graph(*args, **kwargs)
                else:
                    method = getattr(self._actor_instance,
                                     spec.method_name)
                    result = method(*args, **kwargs)
                if asyncio.iscoroutine(result) and \
                        not inspect.isgenerator(result):
                    # Sync path got a coroutine (async method, concurrency 1
                    # without dedicated loop): run it to completion here.
                    # The isgenerator guard matters on py<3.12, where
                    # asyncio.iscoroutine also matches plain generators
                    # (legacy @asyncio.coroutine) — asyncio.run on a
                    # streaming task's generator raises "Task got bad
                    # yield" instead of streaming it.
                    result = asyncio.run(result)
            else:
                raise RuntimeError(f"unknown task type {spec.task_type}")
            return self._package_returns(spec, result)
        except _TaskCancelledInterrupt:
            if spec.task_id in self._cancel_requested:
                return self._package_cancelled(spec)
            # stale interrupt aimed at a prior task landed here (the
            # SetAsyncExc race window): report honestly, not as a
            # cancellation of THIS task
            try:
                raise RayTaskError(
                    "task interrupted by a stale cancellation aimed at "
                    "a previously-running task")
            except RayTaskError as e:
                return self._package_error(spec, e)
        except Exception as e:  # noqa: BLE001
            return self._package_error(spec, e)
        finally:
            self.current_task_id = prev_task
            _executing_task_id.reset(ctx_token)
            self._running_threads.pop(spec.task_id, None)
            self._task_children.pop(spec.task_id, None)
            self._cancel_requested.pop(spec.task_id, None)

    def _start_channel_graph(self, stages: list) -> str:
        """Compiled-DAG stage executor (reference: the per-actor loop a
        compiled graph installs, `compiled_dag_node.py:291`; channel
        design `experimental_mutable_object_manager.h:37`): attach every
        stage's in/out shm channels NOW (so a wrong-node placement fails
        the compile call loudly), then pump this actor's nodes in
        topological order on one daemon thread — fan-in reads one
        channel per argument, fan-out writes one channel per consumer.
        Frames carry a raw (tag, seq, length) header + pickled payload
        (zero-pickle plane, ray_tpu_torch/experimental/channel.py); an
        upstream error flows through untouched so the driver sees the
        original, and lagging inputs are released from the header alone
        — never deserialized — and re-read until their seqs agree
        (self-healing after a driver-side timeout)."""
        import pickle

        from ray_tpu_torch.experimental.channel import (TAG_ERR, TAG_OK,
                                                  ChannelClosedError,
                                                  FrameScratch,
                                                  ShmChannel,
                                                  note_stale_skip)

        attached: Dict[str, ShmChannel] = {}

        def get_ch(name: str) -> ShmChannel:
            if name not in attached:
                attached[name] = ShmChannel.attach(name)
            return attached[name]

        prepared = []
        for st in stages:
            prepared.append((
                st,
                [(pos, get_ch(n)) for pos, n in st["ins"]],
                [get_ch(n) for n in st["outs"]],
                getattr(self._actor_instance, st["method"]),
                FrameScratch(),
            ))

        def run_stage(st, ins, outs, method, scratch):
            chans = dict(ins)
            # headers first: (tag, seq, payload_view) per input, slots
            # still held — nothing deserialized yet
            heads = {pos: ch.read_frame() for pos, ch in ins}
            while True:
                mx = max(s for (_t, s, _v) in heads.values())
                lagging = [p for p, (_t, s, _v) in heads.items()
                           if s < mx]
                if not lagging:
                    break
                for p in lagging:
                    # stale frame: release straight from the header —
                    # the payload is never unpickled just to be thrown
                    # away
                    heads[p] = None  # drop the payload view first
                    chans[p].release_frame()
                    note_stale_skip()
                    heads[p] = chans[p].read_frame()
            traced = tracing.enabled()
            if traced:
                # consumer half of each input hop's arrow: the frame
                # header carries no trace ctx, so the producer span
                # (driver/upstream stage) and this span share
                # flow_id=<channel>:<seq> and the unified timeline
                # stitches the cross-process arrow at merge time
                for _pos, ch in ins:
                    with tracing.span(
                            "channel.read", kind="consumer",
                            attrs={"channel": ch._name, "seq": mx,
                                   "flow_id": f"{ch._name}:{mx}"}):
                        pass
            err = None
            values = {}
            for pos, (tag, _s, view) in heads.items():
                if tag == TAG_ERR:
                    if err is None:
                        err = pickle.loads(view)
                else:
                    values[pos] = pickle.loads(view)
                del view
                heads[pos] = None
                chans[pos].release_frame()
            if err is not None:
                tag, view = TAG_ERR, scratch.pack(err)
            else:
                fn_args = [None] * st["nargs"]
                for pos, v in st["consts"]:
                    fn_args[pos] = v
                for pos, v in values.items():
                    fn_args[pos] = v
                try:
                    if traced:
                        with tracing.span(f"stage.{st['method']}",
                                          attrs={"seq": mx}):
                            result = method(*fn_args)
                    else:
                        result = method(*fn_args)
                    tag, view = TAG_OK, scratch.pack(result)
                except Exception as e:  # noqa: BLE001 — to driver
                    tag, view = TAG_ERR, scratch.pack(
                        f"{st['method']} failed: "
                        f"{traceback.format_exc()}\n{e!r}")
            for out in outs:
                try:
                    if traced:
                        with tracing.span(
                                "channel.write", kind="producer",
                                attrs={"channel": out._name, "seq": mx,
                                       "flow_id": f"{out._name}:{mx}"}):
                            out.write_frame(tag, mx, view)
                    else:
                        out.write_frame(tag, mx, view)
                except ValueError as e:
                    # oversize result: the pump must survive and the
                    # driver must see the cause (the tiny error frame
                    # always fits)
                    out.write_frame(TAG_ERR, mx, pickle.dumps(
                        f"{st['method']} result does not fit the "
                        f"channel: {e}"))

        def loop():
            try:
                while True:
                    for item in prepared:
                        run_stage(*item)
            except ChannelClosedError:
                pass
            finally:
                for ch in attached.values():
                    ch.close()

        threading.Thread(target=loop, daemon=True,
                         name="dag-graph").start()
        return "started"

    @staticmethod
    def _has_async_methods(cls) -> bool:
        import inspect as inspect_mod

        def is_async(fn):
            return (asyncio.iscoroutinefunction(fn)
                    or inspect_mod.isasyncgenfunction(fn))

        return any(
            is_async(getattr(cls, n, None))
            for n in dir(cls)
            if not n.startswith("__")
        )

    def _start_actor_async_loop(self, max_concurrency: int,
                                groups: Dict[str, int] | None = None):
        loop = asyncio.new_event_loop()
        self._actor_async_loop = loop
        self._actor_async_sem = asyncio.Semaphore(max_concurrency)
        # async actors: a named group is a semaphore on the shared loop
        # (the reference's fiber groups) — per-group admission, one loop
        self._actor_group_sems = {
            name: asyncio.Semaphore(max(1, int(n)))
            for name, n in (groups or {}).items()
        }

        def run():
            asyncio.set_event_loop(loop)
            loop.run_forever()

        threading.Thread(target=run, name="actor-async", daemon=True).start()

    def _group_error(self, spec: task_mod.TaskSpec, group: str) -> dict:
        declared = sorted((self._actor_group_pools
                           or self._actor_group_sems or {}).keys())
        # raise-and-catch: _package_error formats the ACTIVE exception
        try:
            raise ValueError(f"unknown concurrency group {group!r} "
                             f"(declared: {declared})")
        except ValueError as e:
            return self._package_error(spec, e)

    def _resolve_group(self, spec: task_mod.TaskSpec) -> str:
        """Task's group: explicit call-site override, else the method's
        declared group (@ray_tpu_torch.method(concurrency_group=...)), else
        the default group ('')."""
        if spec.concurrency_group:
            return spec.concurrency_group
        m = getattr(type(self._actor_instance), spec.method_name or "",
                    None)
        return getattr(m, "__ray_tpu_concurrency_group__", "") or ""

    # -- executor-side streaming ------------------------------------------

    def _package_item(self, spec: task_mod.TaskSpec, index: int,
                      value) -> list:
        """Package one yielded item exactly like a return value: small
        in-band, large into plasma."""
        oid = ObjectID.for_task_return(TaskID(spec.task_id), index)
        sv = serialization.serialize_value(value)
        if sv.size <= self.config.max_direct_call_object_size or \
                self.store is None:
            return [oid.binary(), "v", sv.to_bytes()]
        self._plasma_put_pinned(oid, sv)
        return [oid.binary(), "plasma", self.raylet_addr]

    async def _report_item(self, spec: task_mod.TaskSpec, item: list) -> dict:
        owner = await self._clients.get(spec.owner_addr)
        return await owner.call("report_stream_item", {
            "task_id": spec.task_id, "item": item,
        }, timeout=None)

    def _execute_streaming(self, spec: task_mod.TaskSpec, gen) -> dict:
        """Drive a sync generator, reporting each item to the owner. The
        per-item ack is the backpressure gate (the owner withholds it
        while its buffer is full) and carries early-cancellation."""
        index = 0
        try:
            for value in gen:
                item = self._package_item(spec, index, value)
                index += 1
                ack = asyncio.run_coroutine_threadsafe(
                    self._report_item(spec, item), self._loop).result()
                if ack.get("cancelled"):
                    gen.close()
                    break
        except Exception:  # noqa: BLE001 — shipped to the consumer
            tb = traceback.format_exc()
            frame = serialization.dumps(RayTaskError(
                f"streaming task {spec.name} failed at item {index}:\n{tb}"))
            oid = ObjectID.for_task_return(TaskID(spec.task_id), index)
            asyncio.run_coroutine_threadsafe(
                self._report_item(spec, [oid.binary(), "err", frame]),
                self._loop).result()
        return {"returns": [], "stream_items": index}

    async def _execute_streaming_async(self, spec: task_mod.TaskSpec,
                                       agen) -> dict:
        """Async-actor variant: drives an async generator (Serve response
        streaming rides on this path)."""
        index = 0
        loop = asyncio.get_running_loop()
        try:
            async for value in agen:
                item = await loop.run_in_executor(
                    None, self._package_item, spec, index, value)
                index += 1
                ack = await asyncio.wrap_future(
                    asyncio.run_coroutine_threadsafe(
                        self._report_item(spec, item), self._loop))
                if ack.get("cancelled"):
                    await agen.aclose()
                    break
        except Exception:  # noqa: BLE001
            tb = traceback.format_exc()
            frame = serialization.dumps(RayTaskError(
                f"streaming task {spec.name} failed at item {index}:\n{tb}"))
            oid = ObjectID.for_task_return(TaskID(spec.task_id), index)
            await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                self._report_item(spec, [oid.binary(), "err", frame]),
                self._loop))
        return {"returns": [], "stream_items": index}

    def _package_returns(self, spec: task_mod.TaskSpec, result) -> dict:
        if spec.streaming:
            if not hasattr(result, "__next__"):
                raise TypeError(
                    f"streaming task {spec.name} must return a generator, "
                    f"got {type(result).__name__}")
            return self._execute_streaming(spec, result)
        if spec.num_returns == 0:
            return {"returns": []}
        if spec.num_returns == 1:
            results = [result]
        else:
            results = list(result)
            if len(results) != spec.num_returns:
                raise ValueError(
                    f"task {spec.name} returned {len(results)} values, "
                    f"expected {spec.num_returns}"
                )
        returns = []
        handoffs = []
        for i, value in enumerate(results):
            oid = ObjectID.for_task_return(TaskID(spec.task_id), i)
            sv, nested = serialization.serialize_value_with_refs(value)
            if nested:
                handoffs.append([
                    oid.binary(),
                    self._handoff_nested_refs(nested, spec.owner_addr)])
            if sv.size <= self.config.max_direct_call_object_size or \
                    self.store is None:
                returns.append([oid.binary(), "v", sv.to_bytes()])
            else:
                self._plasma_put_pinned(oid, sv)
                returns.append([oid.binary(), "plasma", self.raylet_addr])
        out = {"returns": returns}
        if handoffs:
            out["ref_handoffs"] = handoffs
        return out

    def _handoff_nested_refs(self, refs: list, caller_addr: str) -> list:
        """A return value carries ObjectRefs (executor thread): register
        the CALLER as a borrower with each ref's owner BEFORE the reply
        ships. Without this, the owner can free the object in the window
        between this task's locals dying (our borrow releases) and the
        caller deserializing its copy (its borrow registers) — the
        handoff makes the transfer of the reference atomic with the
        reply. Returns [(oid, owner_addr)] for the reply's
        `ref_handoffs` entry; the caller holds each pair until the
        return object itself is released."""
        pairs = []
        for r in refs:
            oid = r.binary()
            owner = r.owner_addr or self.address
            pairs.append([oid, owner])
            if owner == self.address:
                # we own it — the caller's borrow is one set-add away,
                # and our live handle (inside the return value) keeps
                # the refcount nonzero until this line runs
                with self._ref_lock:
                    self._borrowers.setdefault(oid, set()).add(caller_addr)
            else:
                # registered synchronously so the reply cannot overtake
                # it; covers owner == caller too (an object riding back
                # to its owner — the entry pins it against a racing
                # remove_borrower from our own task-end cleanup)
                fut = asyncio.run_coroutine_threadsafe(
                    self._notify_borrow(owner, "add_borrower", oid,
                                        addr=caller_addr), self._loop)
                try:
                    fut.result(timeout=30.0)
                except Exception:  # noqa: BLE001 — owner gone
                    pass
        return pairs

    def _package_error(self, spec: task_mod.TaskSpec, exc: Exception) -> dict:
        tb = traceback.format_exc()
        logger.warning("task %s failed: %s", spec.name, tb)
        # preserve framework error subtypes (TaskCancelledError etc.) so
        # the owner can re-raise the exact class the API promises
        cls = type(exc) if isinstance(exc, RayTaskError) else RayTaskError
        err = cls(f"task {spec.name} failed:\n{tb}", cause=None)
        frame = serialization.dumps(err)
        returns = []
        for i in range(max(spec.num_returns, 1)):
            oid = ObjectID.for_task_return(TaskID(spec.task_id), i)
            returns.append([oid.binary(), "err", frame])
        return {"returns": returns, "error": True, "error_msg": str(exc)}
