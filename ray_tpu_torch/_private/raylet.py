"""Raylet — the per-node daemon: local scheduler, worker pool, object plane.

Reference: `src/ray/raylet/` — `NodeManager` (lease protocol + dispatch),
`WorkerPool` (spawns/pools per-job worker processes, `worker_pool.h:159`),
`LocalTaskManager` (dispatch queue), `DependencyManager` (pulls task args
into the local store), `PlacementGroupResourceManager` (bundle reservations),
plus the `ObjectManager` node-to-node transfer path
(`src/ray/object_manager/object_manager.h:117`). The shared-memory arena
(plasma) is created by this process and inherited by workers, exactly as the
reference embeds the plasma store in the raylet.

GPU-specific (the port's copy; the JAX raylet does the same with TPU
chips): the raylet owns the node's CUDA devices as schedulable `GPU`
resources; a lease that consumes `GPU` gets dedicated devices and the
worker is spawned with `CUDA_VISIBLE_DEVICES` naming them, so CUDA in
that worker sees only its devices; every other worker, and every daemon,
runs with `CUDA_VISIBLE_DEVICES=""` and never touches the card
(reference: python/ray/_private/accelerators/nvidia_gpu.py).
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch._private import accelerators
from ray_tpu_torch._private import fault_injection as _fi
from ray_tpu_torch._private import health as health_mod
from ray_tpu_torch._private import rpc as rpc_mod
from ray_tpu_torch._private import task as task_mod
from ray_tpu_torch._private.config import SESSION_ROOT, Config
from ray_tpu_torch._private.ids import NodeID, ObjectID
from ray_tpu_torch._private.object_store import ObjectStore
from ray_tpu_torch._private.rpc import (
    ClientPool,
    ConnectionLost,
    ReconnectingClient,
    RpcError,
    RpcServer,
)
from ray_tpu_torch._private import scheduling as scheduling_mod
from ray_tpu_torch._private.scheduling import (
    ClusterView,
    FairDispatchQueue,
    SCHED_STATS,
    job_label,
    job_quota,
    pick_node,
)

logger = logging.getLogger(__name__)


@dataclass
class WorkerHandle:
    worker_id: bytes
    addr: str
    pid: int
    job_id: bytes
    proc: Optional[asyncio.subprocess.Process] = None
    gpu_ids: tuple = ()
    alive: bool = True
    # identity of the worker's materialized runtime env (reference:
    # per-runtime-env worker pools, worker_pool.h:159)
    env_hash: str = ""


@dataclass
class Lease:
    lease_id: int
    spec: task_mod.TaskSpec
    dedicated: bool
    reply_fut: asyncio.Future
    resources: Dict[str, float] = field(default_factory=dict)
    worker: Optional[WorkerHandle] = None
    deps_ready: bool = False
    acquired: bool = False
    pg_key: Optional[tuple] = None
    # already spilled here from another node — must not bounce again
    no_respill: bool = False


class Raylet:
    def __init__(
        self,
        gcs_addr: str,
        host: str = "127.0.0.1",
        port: int = 0,
        resources: Dict[str, float] | None = None,
        store_name: str | None = None,
        object_store_memory: int | None = None,
        config: Config | None = None,
        session_dir: str = SESSION_ROOT,
        labels: Dict[str, str] | None = None,
    ):
        self.config = config or Config.from_env()
        self.node_id = NodeID.from_random()
        self.gcs_addr = gcs_addr
        # scale-envelope mode: leases satisfied by in-process stub
        # workers (see the virtual-workers section below)
        self.virtual_workers = \
            os.environ.get("RAY_TPU_VIRTUAL_WORKERS") == "1"
        self._none_frame: bytes | None = None
        self.server = RpcServer(host, port)
        self.clients = ClientPool()
        self.session_dir = session_dir

        # Slice membership: detect from the environment (none on a
        # GPU host, accelerators.slice_env), with explicit labels
        # MERGED on top (per-key override). Replacing wholesale would
        # strip slice_type/host_id from autoscaled hosts — their
        # bootstrap passes only the autoscaler_instance label, and a
        # slice that registers without membership can never place the
        # topology gang that launched it.
        self.labels = dict(accelerators.slice_env() or {})
        if labels:
            self.labels.update(labels)
        if resources is not None:
            self.total = dict(resources)
        else:
            # no explicit resources: auto-detect like the reference's
            # accelerator managers (nvidia_gpu.py device detection)
            self.total = {"CPU": float(os.cpu_count() or 1)}
            gpus = accelerators.num_local_gpus(accelerators.WORKER_VISIBLE_ENV)
            if gpus:
                self.total["GPU"] = float(gpus)
        # host 0 of a slice carries the one-per-slice head resource
        # (reference tpu.py:363-388, promoted into the scheduler here)
        for k, v in accelerators.slice_resources(self.labels).items():
            self.total.setdefault(k, v)
        self.available = dict(self.total)
        # GPUs are individually assignable; a GPU is bound to a worker
        # process from spawn until that worker dies (a CUDA context owns
        # its devices for the process's lifetime — a GPU cannot be handed
        # between live processes).
        n_gpu = int(self.total.get("GPU", 0))
        self.unassigned_gpus: List[int] = list(range(n_gpu))

        self.store_name = store_name or f"/ray_tpu_torch_{self.node_id.hex()[:12]}"
        self.store = ObjectStore.create(
            self.store_name,
            object_store_memory or self.config.object_store_memory,
            self.config.object_store_table_size,
        )

        # Worker pool state.
        self._idle: Dict[tuple, List[WorkerHandle]] = {}
        self._workers: Dict[bytes, WorkerHandle] = {}
        self._starting: Dict[tuple, int] = {}
        self._register_waiters: Dict[tuple, List[asyncio.Future]] = {}

        self._leases: Dict[int, Lease] = {}
        # Weighted-fair dispatch queue keyed by job: contended dispatch
        # drains per-job lanes in deficit-round-robin order (grant cost =
        # CPU+GPU demand over the job's quota weight) instead of global
        # FIFO, so one flooding tenant cannot starve the others.
        self._pending: FairDispatchQueue = FairDispatchQueue(
            cost_of=lambda lease: max(
                1.0,
                float(lease.resources.get("CPU", 0.0) or 0.0)
                + float(lease.resources.get("GPU", 0.0) or 0.0)))
        # Deadman probe for the dispatch drain. The drain is
        # event-driven on this loop, so liveness is proven two ways:
        # every _dispatch() pass beats, and a loop_ticker (started in
        # start()) beats between events — a blocked event loop freezes
        # both while the ticker's constant backlog keeps the deadman
        # armed. A quiet-but-healthy raylet keeps ticking.
        self._dispatch_probe = health_mod.watch_loop("raylet_dispatch")
        self._watchdog: Optional[health_mod.Watchdog] = None
        self._lease_seq = itertools.count(1)
        self._bundles: Dict[tuple, Dict[str, float]] = {}  # committed PG bundles
        self._bundle_available: Dict[tuple, Dict[str, float]] = {}
        self.view = ClusterView()
        self._bg: list = []
        self._spawned_procs: List[tuple] = []  # (proc, pool_key) pre-register
        # pool key -> consecutive deaths before registration (breaker)
        self._startup_failures: Dict[tuple, int] = {}
        self._pulls_inflight: Dict[bytes, asyncio.Future] = {}
        self._pinned: Dict[bytes, object] = {}  # oid -> held PlasmaBuffer
        # Disk spilling (reference: local_object_manager.h spill/restore):
        # pinned primary copies written to session-dir files so the shm
        # arena can hold more live data than its capacity.
        self._spilled: Dict[bytes, tuple] = {}  # oid -> (path, size)
        self._spill_dir = os.path.join(
            session_dir, f"spill-{self.node_id.hex()[:12]}")
        # serializes spill/restore disk work, which runs in executor
        # threads so multi-GB file I/O never stalls the event loop (and
        # with it the heartbeat that keeps this node alive)
        self._spill_lock = asyncio.Lock()
        # outbound-transfer leases: hold the buffer from meta to last
        # chunk so a pressured store cannot evict (and force re-restore
        # of) an object per chunk
        self._transfer_handles: Dict[bytes, object] = {}
        self._freed_since_heartbeat = False
        # wakes the heartbeat loop early when local resources free up —
        # the raylet->GCS half of push-based resource gossip
        self._heartbeat_nudge = asyncio.Event()
        # node_id -> monotonic time of its last push-delivered view
        # update (guards the heartbeat-reply prune against racing a
        # just-registered node's seed publish)
        self._view_push_ts: Dict[bytes, float] = {}
        # Raylet addresses the GCS has declared dead (resources-channel
        # dead publish). A pull must not spend a full connect timeout
        # discovering what the control plane already knows — known-dead
        # holders are reported to the owner immediately instead of
        # dialed. The owner's GCS-backed aliveness check is the
        # authority: a still_alive verdict un-poisons the entry.
        self._dead_addrs: Dict[str, float] = {}
        self._actor_workers: Dict[bytes, bytes] = {}  # worker_id -> actor_id
        # Memory-monitor kill records: owners query these to turn a
        # generic "worker died" into an actionable OutOfMemoryError
        # (reference: worker_killing_policy.h surfaces the policy's
        # reasoning in the task error).
        self._exit_reasons_by_addr: Dict[str, str] = {}
        # ownership-GC / recovery accounting
        self._objects_freed = 0   # owner refcount-zero deletions
        self._objects_dropped = 0  # chaos drop_objects force-deletes
        # drop_objects@raylet chaos victimizer: force-delete a seeded
        # subset of this node's sealed objects without killing the
        # process (silent object loss, as distinct from node death)
        _fi.set_drop_objects_target(self._chaos_drop_objects)

    # ------------------------------------------------------------------

    # lease-cycle counters (attribution: lease churn vs push batching —
    # the other half of the control-plane scrape next to rpc_coalescing)
    _leases_granted = 0
    _workers_returned = 0

    def _metrics_text(self) -> str:
        stats = self.store.stats()
        lines = [
            "# TYPE raylet_leases_granted counter",
            f"raylet_leases_granted {self._leases_granted}",
            f"raylet_workers_returned {self._workers_returned}",
            "# TYPE raylet_pending_leases gauge",
            f"raylet_pending_leases {len(self._pending)}",
            # alias under the cross-daemon name the flight-recorder
            # dashboards key on (same value as raylet_pending_leases)
            "# TYPE scheduler_queue_depth gauge",
            f"scheduler_queue_depth {len(self._pending)}",
        ]
        for job, depth in sorted(self._pending.depths().items()):
            lines.append(f'scheduler_queue_depth{{job="{job}"}} {depth}')
        lines += [
            f"raylet_workers {len(self._workers)}",
            f"raylet_pinned_objects {len(self._pinned)}",
            f"raylet_spilled_objects {len(self._spilled)}",
            "# TYPE raylet_objects_freed_total counter",
            f"raylet_objects_freed_total {self._objects_freed}",
            "# TYPE raylet_objects_dropped_total counter",
            f"raylet_objects_dropped_total {self._objects_dropped}",
            f"object_store_capacity_bytes {stats['capacity']}",
            f"object_store_allocated_bytes {stats['allocated']}",
            f"object_store_num_objects {stats['num_objects']}",
        ]
        for k, v in self.available.items():
            lines.append(
                f'raylet_resource_available{{resource="{k}"}} {v}')
        # sharded-store contention + per-shard rows, and the scheduling
        # decision counters — computed at scrape time
        return ("\n".join(lines) + "\n"
                + self.store.metrics_text()
                + scheduling_mod.metrics_text()
                + rpc_mod.metrics_text()
                + health_mod.metrics_text())

    async def start(self, metrics_port: int | None = None):
        self.server.register_all(self)
        await self.server.start()
        self._watchdog = health_mod.Watchdog(source="RAYLET").start()
        self._bg.append(health_mod.loop_ticker(self._dispatch_probe))
        if metrics_port is not None:
            from ray_tpu_torch.util.metrics import serve_metrics

            self._metrics_server, port = await serve_metrics(
                port=metrics_port, extra_text=self._metrics_text)
            logger.info("metrics on :%d/metrics", port)
            self.metrics_port = port
        # reconnecting handle: survives a GCS restart (persistence FT)
        self.gcs = ReconnectingClient(self.clients, self.gcs_addr)
        await self.gcs.call("register_node", {
            "node_id": self.node_id.binary(),
            "raylet_addr": self.server.address,
            "total": self.total,
            "available": self.available,
            "hostname": os.uname().nodename,
            "labels": self.labels,
        })
        await self.gcs.call("subscribe",
                            {"channel": "jobs", "addr": self.server.address})
        # quotas of jobs that registered before this raylet joined: the
        # "started" publishes already happened, so pull the job table
        try:
            for jb in await self.gcs.call("list_jobs", {}, timeout=10.0):
                if not jb.get("finished"):
                    self._apply_job_quota(jb["job_id"], jb.get("quotas"))
        except (ConnectionLost, RpcError, OSError, asyncio.TimeoutError):
            pass  # pubsub still delivers future jobs' quotas
        # push-based resource gossip: availability deltas arrive the
        # moment another node's heartbeat reports a change (reference:
        # ray_syncer.h:88 streaming sync), so spillback sees fresh state
        # instead of a view up to one heartbeat period stale
        await self.gcs.call("subscribe",
                            {"channel": "resources",
                             "addr": self.server.address})
        self.view.update_node(self.node_id.binary(), self.server.address,
                              self.total, self.available)
        self._heartbeat_nudge.set()  # first heartbeat immediately
        self._bg = [
            asyncio.ensure_future(self._heartbeat_loop()),
            asyncio.ensure_future(self._reap_loop()),
        ]
        if self.config.memory_usage_threshold > 0:
            self._bg.append(
                asyncio.ensure_future(self._memory_monitor_loop()))
        logger.info("raylet %s on %s", self.node_id.hex()[:8], self.server.address)
        return self

    _metrics_server = None

    async def stop(self):
        for t in self._bg:
            t.cancel()
        if self._watchdog is not None:
            self._watchdog.stop()
        if self._metrics_server is not None:
            self._metrics_server.close()
        for w in self._workers.values():
            if w.proc and w.proc.returncode is None:
                try:
                    w.proc.terminate()
                except ProcessLookupError:
                    pass
        await self.clients.close_all()
        await self.server.stop()
        self.store.destroy()
        import shutil

        shutil.rmtree(self._spill_dir, ignore_errors=True)

    @property
    def address(self) -> str:
        return self.server.address

    # ------------------------------------------------------------------
    # sync with GCS
    # ------------------------------------------------------------------

    async def _heartbeat_loop(self):
        last_sent = 0.0
        while True:
            # timer tick OR an on-change nudge (resources freed): the
            # nudge makes the raylet->GCS direction of the resource
            # gossip push-based too — freed capacity reaches the GCS
            # (and fans out to peer raylets) in milliseconds, not at
            # the next heartbeat period
            try:
                await asyncio.wait_for(
                    self._heartbeat_nudge.wait(),
                    self.config.raylet_heartbeat_period_s)
            except asyncio.TimeoutError:
                pass
            # Debounce nudged sends: a tight task stream frees
            # resources per completion, and a heartbeat + GCS delta
            # fan-out per task would tax the submission path it serves
            # (measured: -25% on single-client sync tasks). One nudged
            # heartbeat per 50ms coalesces bursts while keeping
            # freed-capacity propagation ~10x faster than the timer.
            gap = time.monotonic() - last_sent
            if gap < 0.05:
                await asyncio.sleep(0.05 - gap)
            self._heartbeat_nudge.clear()
            last_sent = time.monotonic()
            try:
                reply = await self.gcs.call("heartbeat", {
                    "node_id": self.node_id.binary(),
                    "available": self.available,
                    "idle_freed": self._freed_since_heartbeat,
                    # unmet lease demand, for the autoscaler's
                    # bin-packing (reference: ray_syncer resource-load
                    # gossip feeding GcsAutoscalerStateManager).
                    # Acquired leases hold local resources already —
                    # reporting them too would double-count the demand.
                    "pending_demands": [
                        lease.resources
                        for lease in self._pending.head(64)
                        if not lease.acquired
                    ],
                    # workers bound to actors or running leases (warm
                    # idle-pool workers excluded) — live actors hold no
                    # CPU resources, so idleness needs this signal
                    "busy_workers": len(self._workers) - sum(
                        len(p) for p in self._idle.values()),
                }, timeout=5.0)
                if _fi._PLAN is not None:
                    _fi._PLAN.node_heartbeat_sent()  # may os._exit(1)
                self._freed_since_heartbeat = False
                if reply.get("reregister"):
                    await self.gcs.call("register_node", {
                        "node_id": self.node_id.binary(),
                        "raylet_addr": self.server.address,
                        "total": self.total,
                        "available": self.available,
                        "labels": self.labels,
                    })
                for n in reply.get("view", []):
                    self.view.update_node(n["node_id"], n["raylet_addr"],
                                          n["total"], n["available"],
                                          labels=n.get("labels"))
                current = {n["node_id"] for n in reply.get("view", [])}
                now = time.monotonic()
                for node_id in list(self.view.nodes):
                    # prune nodes the GCS no longer reports — EXCEPT
                    # ones freshly seeded by a "resources" push, which
                    # may have registered after this reply's view was
                    # assembled (removing them would undo the push for
                    # a whole heartbeat period)
                    if node_id not in current and \
                            now - self._view_push_ts.get(node_id, 0.0) \
                            > 10.0:
                        self.view.remove_node(node_id)
                        self._view_push_ts.pop(node_id, None)
                self._respill_pending()
            except (ConnectionLost, RpcError, OSError, asyncio.TimeoutError):
                # the nudge was cleared before the failed send: re-arm
                # it so the freed-capacity signal retries (debounce +
                # the RPC timeout bound the retry rate) instead of
                # silently waiting out a whole timer period
                self._heartbeat_nudge.set()

    def _respill_pending(self):
        """Hand queued leases that this node cannot currently satisfy to
        nodes that can (reference: ClusterTaskManager re-running cluster
        scheduling for queued work). This is what lets autoscaler-added
        nodes drain a backlog that queued before they existed."""
        for lease in list(self._pending):
            spec = lease.spec
            if spec.placement_group_id is not None:
                continue  # PG leases are bundle-bound to this node
            if lease.no_respill:
                continue  # spilled here once already — no ping-pong
            if lease.acquired:
                # resources already held locally (waiting on a worker
                # spawn): moving it now would leak the acquisition
                continue
            fits_local_now = all(
                self.available.get(k, 0.0) >= v
                for k, v in lease.resources.items() if v > 0)
            if fits_local_now:
                continue  # the normal dispatch path will take it
            node = pick_node(
                self.view, spec.resources, spec.strategy,
                local_node_id=self.node_id.binary(),
                target_node_id=spec.node_id,
                soft=spec.soft,
                spread_threshold=self.config.scheduler_spread_threshold,
            )
            if node is None or node.node_id == self.node_id.binary():
                continue
            self._pending.remove(lease)
            self._leases.pop(lease.lease_id, None)
            if not lease.reply_fut.done():
                lease.reply_fut.set_result({
                    "granted": False,
                    "spillback_addr": node.raylet_addr,
                })

    async def _reap_loop(self):
        """Detect dead worker processes (reference: WorkerPool monitors its
        children; NodeManager death-notifies the GCS for actors)."""
        while True:
            await asyncio.sleep(0.2)
            for worker in list(self._workers.values()):
                if worker.proc is not None and worker.proc.returncode is not None \
                        and worker.alive:
                    await self._on_worker_death(worker)
            # Workers that died before registering must release their
            # "starting" slot (and chips) or the pool stops replacing them.
            for entry in list(self._spawned_procs):
                proc, key = entry[0], entry[1]
                starting_key = entry[2] if len(entry) > 2 else key
                if proc.returncode is not None:
                    self._spawned_procs.remove(entry)
                    self._starting[starting_key] = max(
                        0, self._starting.get(starting_key, 0) - 1)
                    self.unassigned_gpus.extend(key[1])
                    # Crash-loop breaker: a pool whose workers keep dying
                    # BEFORE registering (broken interpreter/runtime env)
                    # must not respawn forever — after a few consecutive
                    # startup deaths, fail the leases waiting on this key
                    # so callers see the error instead of a hang. Counted
                    # on starting_key, which for GPU pools is
                    # ("gpu", n_gpus) — the CONCRETE chip tuple rotates
                    # between respawns and would dilute the count.
                    n = self._startup_failures.get(starting_key, 0) + 1
                    self._startup_failures[starting_key] = n
                    if n >= self.config.max_worker_startup_failures:
                        self._fail_leases_for_key(
                            starting_key,
                            f"worker startup crash-looped ({n} "
                            f"consecutive deaths before registration; "
                            f"see worker logs in the session dir)")
                    self._dispatch()

    # ------------------------------------------------------------------
    # host memory monitor (reference: memory_monitor.h:52 polls host
    # used/total; worker_killing_policy_group_by_owner.h picks victims)
    # ------------------------------------------------------------------

    def _host_memory_usage(self) -> tuple[int, int]:
        """(used_bytes, total_bytes). Reads the test-override file when
        configured ("used total"), else /proc/meminfo with used =
        MemTotal - MemAvailable (matches the reference's calculation)."""
        path = self.config.memory_usage_path
        if path:
            try:
                with open(path) as f:
                    used, total = f.read().split()
                return int(used), int(total)
            except (OSError, ValueError):
                return 0, 1
        try:
            info = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    parts = line.split()
                    if parts[0] in ("MemTotal:", "MemAvailable:"):
                        info[parts[0]] = int(parts[1]) * 1024
            total = info.get("MemTotal:", 0)
            avail = info.get("MemAvailable:", total)
            return max(0, total - avail), max(1, total)
        except OSError:
            return 0, 1

    async def _memory_monitor_loop(self):
        period = self.config.memory_monitor_refresh_ms / 1000.0
        threshold = self.config.memory_usage_threshold
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(period)
            # /proc reads and the kill-selection walk both touch the
            # filesystem — keep the lease/heartbeat loop responsive
            used, total = await loop.run_in_executor(
                None, self._host_memory_usage)
            if used / total <= threshold:
                continue
            if await loop.run_in_executor(
                    None, self._relieve_memory_pressure, used, total):
                # give the reap loop + OS a cycle to reclaim the victim
                # before re-evaluating, or one spike kills every worker
                await asyncio.sleep(max(period, 0.5))

    def _relieve_memory_pressure(self, used: int, total: int) -> bool:
        """Free host memory, least harm first: an idle pooled worker
        (no task lost), else a leased task worker via group-by-owner
        (the owner with most running tasks loses its newest — retriable
        — one), else the newest actor worker. Returns True if a kill
        was issued."""
        from ray_tpu_torch.util import events as export_events

        pct = f"{used / total:.0%}"
        header = (f"host memory {pct} ({used >> 20} MiB / "
                  f"{total >> 20} MiB) over threshold "
                  f"{self.config.memory_usage_threshold:.0%}")
        # 1) idle workers: reclaim without failing anything
        for pool in self._idle.values():
            while pool:
                worker = pool.pop()
                if worker.proc is not None and \
                        worker.proc.returncode is None:
                    export_events.report(
                        "RAYLET", "WARNING", "OOM_IDLE_WORKER_KILLED",
                        f"{header}; killed idle worker {worker.pid}",
                        node_id=self.node_id.hex())
                    worker.proc.kill()
                    return True
        # 2) leased (running-task) workers, grouped by owner
        running = [ls for ls in self._leases.values()
                   if ls.worker is not None and ls.worker.alive
                   and ls.worker.proc is not None
                   and ls.worker.proc.returncode is None]
        task_leases = [ls for ls in running
                       if ls.spec.task_type == task_mod.NORMAL_TASK]
        victim_lease = None
        if task_leases:
            groups: Dict[bytes, list] = {}
            for ls in task_leases:
                groups.setdefault(ls.spec.owner_worker_id, []).append(ls)
            biggest = max(groups.values(), key=len)
            # newest submission = highest lease id: the task that joined
            # the pressure last dies first (reference group-by-owner
            # kills the newest of the largest group)
            victim_lease = max(biggest, key=lambda ls: ls.lease_id)
            reason = (f"{header}; policy group-by-owner: owner "
                      f"{victim_lease.spec.owner_worker_id.hex()[:8]} has "
                      f"{len(biggest)} running task(s), killed the newest "
                      f"(task {victim_lease.spec.name!r}); the task is "
                      f"retriable and will be retried if retries remain")
        elif running:
            victim_lease = max(running, key=lambda ls: ls.lease_id)
            reason = (f"{header}; no retriable task to kill, killed the "
                      f"newest leased worker "
                      f"(task {victim_lease.spec.name!r})")
        if victim_lease is not None:
            worker = victim_lease.worker
            self._record_exit_reason(worker.addr, reason)
            export_events.report(
                "RAYLET", "WARNING", "OOM_WORKER_KILLED", reason,
                node_id=self.node_id.hex(), pid=worker.pid)
            worker.proc.kill()
            return True
        # 3) actor workers: newest registration dies first
        for worker_id in reversed(list(self._actor_workers)):
            worker = self._workers.get(worker_id)
            if worker is not None and worker.proc is not None \
                    and worker.proc.returncode is None:
                reason = (f"{header}; no task workers left, killed the "
                          f"newest actor worker (pid {worker.pid})")
                self._record_exit_reason(worker.addr, reason)
                export_events.report(
                    "RAYLET", "WARNING", "OOM_ACTOR_KILLED", reason,
                    node_id=self.node_id.hex(), pid=worker.pid)
                worker.proc.kill()
                return True
        return False

    def _record_exit_reason(self, addr: str, reason: str):
        # bounded: drop oldest so a long-lived raylet under periodic
        # pressure never grows this map without limit
        while len(self._exit_reasons_by_addr) >= 256:
            self._exit_reasons_by_addr.pop(
                next(iter(self._exit_reasons_by_addr)))
        self._exit_reasons_by_addr[addr] = reason

    async def rpc_get_worker_exit_reason(self, req):
        """Owner-side query: did the raylet kill this worker on purpose
        (memory monitor)? Lets the submitter surface OutOfMemoryError
        instead of a generic connection loss."""
        return {"reason": self._exit_reasons_by_addr.get(
            req["worker_addr"])}

    async def _on_worker_death(self, worker: WorkerHandle):
        from ray_tpu_torch.util import events as export_events

        await export_events.report_async(
            "RAYLET", "WARNING", "WORKER_DIED",
            f"worker process {worker.pid} exited",
            worker_id=worker.worker_id.hex(), pid=worker.pid,
            node_id=self.node_id.hex())
        worker.alive = False
        self._workers.pop(worker.worker_id, None)
        self.unassigned_gpus.extend(worker.gpu_ids)
        for pool in self._idle.values():
            if worker in pool:
                pool.remove(worker)
        # Free resources of any lease bound to this worker.
        for lease in list(self._leases.values()):
            if lease.worker is worker:
                self._release_lease(lease, worker_dead=True)
        actor_id = self._actor_workers.pop(worker.worker_id, None)
        if actor_id is not None:
            reason = self._exit_reasons_by_addr.get(
                worker.addr, f"worker process {worker.pid} exited")
            try:
                await self.gcs.call("report_actor_death", {
                    "actor_id": actor_id,
                    "reason": reason,
                })
            except (ConnectionLost, RpcError, OSError):
                pass
        self._dispatch()

    def _apply_job_quota(self, job_id: bytes, quotas: dict | None):
        """Install a job's quota row into both consumers on this node:
        the scheduler registry (weights + cpu/memory admission) and the
        shm store (object byte quota)."""
        if not quotas:
            return
        q = scheduling_mod.JobQuota.from_dict(quotas)
        scheduling_mod.set_job_quota(job_id, q)
        if q.object_store_bytes > 0:
            try:
                self.store.set_job_quota(job_id, q.object_store_bytes)
            except Exception:  # noqa: BLE001 — accounting table full
                logger.warning("object quota for job %s not applied "
                               "(job table full)", job_id.hex()[:8])

    async def rpc_pubsub(self, msg):
        if msg["channel"] == "jobs":
            data = msg["data"]
            if data.get("event") == "started":
                self._apply_job_quota(data["job_id"], data.get("quotas"))
            elif data.get("event") == "finished":
                job_id = data["job_id"]
                # workers of the actors that outlive the job (the GCS's
                # `_job_survivors`) stay
                keep = set(data.get("keep_workers") or ())
                for worker in list(self._workers.values()):
                    if worker.job_id == job_id and worker.proc \
                            and worker.proc.returncode is None \
                            and worker.addr not in keep:
                        worker.proc.terminate()
        elif msg["channel"] == "resources":
            d = msg["data"]
            if d.get("node_id") == self.node_id.binary():
                return None  # our own state is authoritative locally
            if d.get("dead"):
                gone = self.view.nodes.get(d["node_id"])
                if gone is not None \
                        and gone.raylet_addr != self.server.address:
                    if len(self._dead_addrs) >= 256:
                        self._dead_addrs.pop(next(iter(self._dead_addrs)))
                    self._dead_addrs[gone.raylet_addr] = time.monotonic()
                    self.clients.invalidate(gone.raylet_addr)
                    self.clients.mark_dead(gone.raylet_addr)
                self.view.remove_node(d["node_id"])
                self._view_push_ts.pop(d["node_id"], None)
            else:
                self.view.update_node(d["node_id"], d["raylet_addr"],
                                      d["total"], d["available"],
                                      labels=d.get("labels"))
                self._view_push_ts[d["node_id"]] = time.monotonic()
                # fresh capacity elsewhere: queued leases that could not
                # place locally may spill NOW instead of next heartbeat
                self._respill_pending()
        return None

    # ------------------------------------------------------------------
    # worker pool
    # ------------------------------------------------------------------

    def _pool_key(self, job_id: bytes, gpu_ids: tuple,
                  env_hash: str = "") -> tuple:
        return (job_id, gpu_ids, env_hash)

    async def _spawn_worker(self, job_id: bytes, gpu_ids: tuple,
                            runtime_env: dict | None = None):
        python_exe = sys.executable
        if runtime_env and runtime_env.get("pip"):
            # venv build takes seconds — keep it off the raylet loop
            # (heartbeats must not stall). Cached by requirements hash,
            # so only the first worker of an env pays it.
            from ray_tpu_torch._private import runtime_env as renv_mod
            python_exe = await asyncio.get_running_loop().run_in_executor(
                None, renv_mod.ensure_pip_env, runtime_env["pip"])
        elif runtime_env and runtime_env.get("conda"):
            # same off-loop treatment: conda env create can take minutes
            from ray_tpu_torch._private import runtime_env as renv_mod
            python_exe = await asyncio.get_running_loop().run_in_executor(
                None, renv_mod.ensure_conda_env, runtime_env["conda"])
        env = dict(os.environ)
        env["RAY_TPU_NODE_ID"] = self.node_id.hex()
        if runtime_env and runtime_env.get("env_vars"):
            env.update(runtime_env["env_vars"])
        # The raylet daemon runs with CUDA_VISIBLE_DEVICES=""; a GPU
        # worker gets its own devices, named in the host's numbering (the
        # host's setting, kept by node._spawn), and nothing else.
        host_visible = env.pop(accelerators.WORKER_VISIBLE_ENV, None)
        if gpu_ids:
            env["CUDA_VISIBLE_DEVICES"] = accelerators.worker_visible_devices(
                gpu_ids, host_visible)
        else:
            # CPU-only workers must never see the node's GPUs.
            env["CUDA_VISIBLE_DEVICES"] = ""
        log_dir = os.path.join(self.session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(
            log_dir, f"worker-{len(self._workers)}-{os.urandom(3).hex()}.log"
        )
        logfile = await asyncio.get_running_loop().run_in_executor(
            None, lambda: open(log_path, "ab"))
        proc = await asyncio.create_subprocess_exec(
            python_exe, "-m", "ray_tpu_torch._private.worker_main",
            "--raylet-addr", self.server.address,
            "--gcs-addr", self.gcs_addr,
            "--store-name", self.store_name,
            "--node-id", self.node_id.hex(),
            "--job-id", job_id.hex(),
            "--gpu-ids", ",".join(str(c) for c in gpu_ids),
            "--runtime-env",
            json.dumps(runtime_env) if runtime_env else "",
            "--session-dir", self.session_dir,
            env=env,
            stdout=logfile,
            stderr=logfile,
        )
        logfile.close()
        return proc

    async def rpc_register_worker(self, req):
        # a fresh worker on a recycled host:port must not inherit a dead
        # worker's OOM-kill record (its own crash would be misreported)
        self._exit_reasons_by_addr.pop(req["addr"], None)
        worker = WorkerHandle(
            worker_id=req["worker_id"],
            addr=req["addr"],
            pid=req["pid"],
            job_id=req["job_id"],
            gpu_ids=tuple(req.get("gpu_ids", ())),
            env_hash=req.get("runtime_env_hash", ""),
        )
        # Adopt the subprocess handle if we spawned it.
        if worker.gpu_ids:
            key = self._pool_key(worker.job_id,
                                 ("gpu", len(worker.gpu_ids)),
                                 worker.env_hash)
        else:
            key = self._pool_key(worker.job_id, (), worker.env_hash)
        if self._starting.get(key):
            self._starting[key] -= 1
        key = self._pool_key(worker.job_id, worker.gpu_ids,
                             worker.env_hash)
        self._workers[worker.worker_id] = worker
        self._idle.setdefault(key, []).append(worker)
        # pool is healthy: reset the breaker under its counting key
        self._startup_failures.pop(
            self._pool_key(worker.job_id,
                           ("gpu", len(worker.gpu_ids))
                           if worker.gpu_ids else (),
                           worker.env_hash), None)
        self._match_worker_procs(worker)
        self._dispatch()
        return {"node_id": self.node_id.binary(), "store_name": self.store_name}

    def _match_worker_procs(self, worker: WorkerHandle):
        # Attach the asyncio Process object by pid for death detection.
        for entry in self._spawned_procs:
            if entry[0].pid == worker.pid:
                worker.proc = entry[0]
                self._spawned_procs.remove(entry)
                return

    # ------------------------------------------------------------------
    # lease protocol (reference: NodeManager::HandleRequestWorkerLease)
    # ------------------------------------------------------------------

    async def rpc_request_worker_lease(self, req):
        if _fi._PLAN is not None:
            await _fi._PLAN.lease_request()
        spec = task_mod.TaskSpec.from_wire(req["spec"])
        dedicated = bool(req.get("dedicated")) or \
            spec.task_type == task_mod.ACTOR_CREATION_TASK

        # Cluster-level decision: schedule here or spill back to another node.
        if spec.placement_group_id is None and not req.get("no_spillback"):
            if (spec.strategy == task_mod.STRATEGY_NODE_AFFINITY
                    and spec.node_id is not None
                    and spec.node_id != self.node_id.binary()):
                # Affinity routes to the target raylet — it is the
                # authority on its own resources and queues the lease if
                # busy. Deciding fit from our (possibly stale) view here
                # could wrongly run the task locally. The heartbeat-fed
                # view lags at startup, so an unknown target is resolved
                # against the GCS node table before concluding anything.
                target = self.view.nodes.get(spec.node_id)
                if target is None:
                    target = await self._refresh_view_for(spec.node_id)
                if target is not None and (
                        not spec.soft
                        or target.fits_now(spec.resources)):
                    # route to the target (hard always — it queues; soft
                    # only while it currently fits, else fall back)
                    return {"granted": False,
                            "spillback_addr": target.raylet_addr}
                if not spec.soft:
                    return {"granted": False,
                            "error": "affinity target node is dead"}
                # soft + target gone: fall through to the normal policy
                node = pick_node(
                    self.view, spec.resources, task_mod.STRATEGY_DEFAULT,
                    local_node_id=self.node_id.binary(),
                    spread_threshold=self.config.scheduler_spread_threshold,
                )
                if node is not None and node.node_id != self.node_id.binary():
                    return {"granted": False,
                            "spillback_addr": node.raylet_addr}
            else:
                node = pick_node(
                    self.view, spec.resources, spec.strategy,
                    local_node_id=self.node_id.binary(),
                    target_node_id=spec.node_id,
                    soft=spec.soft,
                    spread_threshold=self.config.scheduler_spread_threshold,
                )
                if node is not None and node.node_id != self.node_id.binary():
                    return {"granted": False,
                            "spillback_addr": node.raylet_addr}

        lease = Lease(
            lease_id=next(self._lease_seq),
            spec=spec,
            dedicated=dedicated,
            reply_fut=asyncio.get_event_loop().create_future(),
            resources=dict(spec.resources),
            no_respill=bool(req.get("no_spillback")),
        )
        if spec.placement_group_id is not None:
            lease.pg_key = (spec.placement_group_id, spec.bundle_index)
        self._leases[lease.lease_id] = lease
        self._pending.push(spec.job_id, lease)
        asyncio.ensure_future(self._localize_deps(lease))
        self._dispatch()
        return await lease.reply_fut

    async def _refresh_view_for(self, node_id: bytes):
        """Pull the authoritative node table from the GCS when a node is
        missing from the heartbeat-fed view (startup staleness)."""
        try:
            nodes = await self.gcs.call("get_nodes", {}, timeout=10.0)
        except (ConnectionLost, RpcError, OSError, asyncio.TimeoutError):
            return None
        for n in nodes:
            if n["alive"]:
                self.view.update_node(n["node_id"], n["raylet_addr"],
                                      n["total"], n["available"],
                                      labels=n.get("labels"))
        return self.view.nodes.get(node_id)

    async def _localize_deps(self, lease: Lease):
        deps = lease.spec.plasma_deps()
        try:
            await asyncio.gather(*[
                self.pull_object(ObjectID(oid), owner) for oid, owner in deps
            ])
            lease.deps_ready = True
        except Exception as e:  # noqa: BLE001 — dep failure fails the lease
            if not lease.reply_fut.done():
                lease.reply_fut.set_result(
                    {"granted": False, "error": f"dependency fetch failed: {e}"}
                )
            if lease in self._pending:
                self._pending.remove(lease)
            self._leases.pop(lease.lease_id, None)
            return
        self._dispatch()

    def _try_acquire(self, lease: Lease) -> bool:
        """Deduct lease resources from the node pool (or its PG bundle)."""
        pool = self.available
        if lease.pg_key is not None:
            pg_id, bundle_index = lease.pg_key
            if bundle_index < 0:
                # Any bundle of this PG on this node that fits.
                demand = lease.resources
                for key, avail in self._bundle_available.items():
                    if key[0] == pg_id and all(
                        avail.get(k, 0.0) >= v for k, v in demand.items() if v > 0
                    ):
                        lease.pg_key = key
                        break
                else:
                    return False
            pool = self._bundle_available.get(lease.pg_key)
            if pool is None:
                return False
        demand = lease.resources
        if not all(pool.get(k, 0.0) >= v for k, v in demand.items() if v > 0):
            return False
        for k, v in demand.items():
            pool[k] = pool.get(k, 0.0) - v
        lease.acquired = True
        return True

    def _release_resources(self, lease: Lease):
        if not lease.acquired:
            return
        pool = self.available
        if lease.pg_key is not None:
            pool = self._bundle_available.get(lease.pg_key)
            if pool is None:
                lease.acquired = False
                return
        for k, v in lease.resources.items():
            pool[k] = pool.get(k, 0.0) + v
        lease.acquired = False
        self._freed_since_heartbeat = True
        self._heartbeat_nudge.set()

    def _find_idle_gpu_worker(self, job_id: bytes, n_gpus: int,
                              env_hash: str = ""):
        for key, pool in self._idle.items():
            if key[0] == job_id and len(key[1]) == n_gpus \
                    and key[2] == env_hash and pool:
                return pool.pop()
        return None

    def _reclaim_idle_gpu_workers(self, needed: int):
        """Terminate idle GPU workers so their GPUs return to the
        unassigned pool (via the death path) when a pending lease needs a
        different chip grouping."""
        reclaimable = 0
        for key, pool in self._idle.items():
            if not key[1]:
                continue
            for worker in list(pool):
                if worker.proc is not None and worker.proc.returncode is None:
                    worker.proc.terminate()
                    pool.remove(worker)
                    reclaimable += len(worker.gpu_ids)
                    if reclaimable + len(self.unassigned_gpus) >= needed:
                        return True
        return reclaimable > 0

    def _job_usage(self) -> Dict[bytes, Dict[str, float]]:
        """Resources currently held per job (acquired leases). Recomputed
        from the lease table each dispatch — O(leases), no incremental
        counters to tear when `_grant` rewrites an actor's held set."""
        usage: Dict[bytes, Dict[str, float]] = {}
        for lease in self._leases.values():
            if not lease.acquired:
                continue
            row = usage.setdefault(lease.spec.job_id, {})
            for k, v in lease.resources.items():
                row[k] = row.get(k, 0.0) + v
        return usage

    def _over_quota(self, job_id: bytes, demand: Dict[str, float],
                    usage: Dict[bytes, Dict[str, float]]) -> bool:
        """Admission control: would granting `demand` push the job past
        its cpu/memory quota? Over-quota leases stay queued behind
        in-quota work (containment degrades, never fails)."""
        q = job_quota(job_id)
        if q.cpu <= 0 and q.memory <= 0:
            return False
        held = usage.get(job_id, {})
        if q.cpu > 0 and held.get("CPU", 0.0) \
                + float(demand.get("CPU", 0.0) or 0.0) > q.cpu + 1e-9:
            return True
        if q.memory > 0 and held.get("memory", 0.0) \
                + float(demand.get("memory", 0.0) or 0.0) > q.memory + 1e-9:
            return True
        return False

    def _dispatch(self):
        """Dispatch queue scan in weighted-fair order (reference:
        LocalTaskManager::ScheduleAndDispatchTasks, drained through the
        per-job FairDispatchQueue instead of FIFO)."""
        from ray_tpu_torch._private.runtime_env import env_hash as _env_hash

        self._dispatch_probe.beat()

        # key -> (shortfall count, runtime_env wire) for leases that hold
        # resources but lack a worker.
        spawn_needed: Dict[tuple, list] = {}
        usage = self._job_usage()
        for lease in list(self._pending):
            if not lease.deps_ready:
                continue
            job_id = lease.spec.job_id
            if not lease.acquired:
                if self._over_quota(job_id, lease.resources, usage):
                    label = job_label(job_id)
                    SCHED_STATS.job_deferred[label] = \
                        SCHED_STATS.job_deferred.get(label, 0) + 1
                    continue
                if not self._try_acquire(lease):
                    continue
                row = usage.setdefault(job_id, {})
                for k, v in lease.resources.items():
                    row[k] = row.get(k, 0.0) + v
            renv = lease.spec.runtime_env
            ehash = _env_hash(renv)
            n_gpus = int(lease.resources.get("GPU", 0))
            if n_gpus:
                worker = self._find_idle_gpu_worker(
                    lease.spec.job_id, n_gpus, ehash)
                if worker is not None:
                    self._pending.charge(job_id, lease)
                    self._grant(lease, worker)
                    self._pending.remove(lease)
                    continue
                key = self._pool_key(lease.spec.job_id, ("gpu", n_gpus),
                                     ehash)
                if self._starting.get(key, 0) > 0:
                    continue  # a matching worker is already starting
                if len(self.unassigned_gpus) >= n_gpus:
                    # Chips are reserved here, at spawn decision time, so
                    # two pending leases can never spawn workers holding
                    # the same chips.
                    chips = tuple(self.unassigned_gpus[:n_gpus])
                    del self.unassigned_gpus[:n_gpus]
                    self._starting[key] = self._starting.get(key, 0) + 1
                    asyncio.ensure_future(self._spawn_and_track(
                        (lease.spec.job_id, chips, ehash),
                        starting_key=key, runtime_env=renv))
                else:
                    self._reclaim_idle_gpu_workers(n_gpus)
                continue
            key = self._pool_key(lease.spec.job_id, (), ehash)
            idle = self._idle.get(key, [])
            if idle:
                worker = idle.pop()
                self._pending.charge(job_id, lease)
                self._grant(lease, worker)
                self._pending.remove(lease)
            else:
                entry = spawn_needed.setdefault(key, [0, renv])
                entry[0] += 1
        # Spawn exactly the shortfall: workers already starting count against
        # the need, and total in-flight spawns are capped. The shortfall is
        # bounded by acquired resources, so a request flood cannot fork more
        # workers than the node has capacity for.
        for key, (needed, renv) in spawn_needed.items():
            starting = self._starting.get(key, 0)
            cap = self.config.maximum_startup_concurrency - starting
            for _ in range(max(0, min(needed - starting, cap))):
                self._starting[key] = self._starting.get(key, 0) + 1
                asyncio.ensure_future(
                    self._spawn_and_track(key, runtime_env=renv))

    async def _spawn_and_track(self, key: tuple,
                               starting_key: tuple | None = None,
                               runtime_env: dict | None = None):
        job_id, chips = key[0], key[1]
        starting_key = starting_key or key
        if self.virtual_workers:
            self._register_virtual_worker(job_id, chips, runtime_env,
                                          starting_key)
            return
        try:
            if _fi._PLAN is not None:
                _fi._PLAN.spawn_attempt()
            proc = await self._spawn_worker(job_id, chips, runtime_env)
        except Exception as e:
            logger.exception("worker spawn failed")
            self._starting[starting_key] = max(
                0, self._starting.get(starting_key, 0) - 1)
            self.unassigned_gpus.extend(chips)
            from ray_tpu_torch._private.runtime_env import RuntimeEnvSetupError
            if isinstance(e, RuntimeEnvSetupError):
                # a broken env spec fails deterministically: error out the
                # leases waiting on this env instead of respawning forever
                self._fail_leases_for_key(
                    key, f"runtime_env setup failed: {e}")
                return
            # Spawn-time exceptions that are NOT deterministic env errors
            # (transient OSError, unexpected backend failures, injected
            # chaos) feed the same crash-loop breaker as pre-registration
            # worker deaths: without this a persistently failing spawn
            # path would stall its leases until some unrelated event
            # re-triggered _dispatch, and a permanently failing one would
            # retry forever.
            n = self._startup_failures.get(starting_key, 0) + 1
            self._startup_failures[starting_key] = n
            if n >= self.config.max_worker_startup_failures:
                self._fail_leases_for_key(
                    starting_key,
                    f"worker spawn crash-looped ({n} consecutive spawn "
                    f"failures; last: {e})")
            else:
                self._dispatch()  # re-drive the shortfall spawn now
            return
        self._spawned_procs.append((proc, key, starting_key))

    # ------------------------------------------------------------------
    # virtual workers (scale-envelope mode)
    #
    # RAY_TPU_VIRTUAL_WORKERS=1 makes this raylet satisfy leases with
    # in-process stub workers instead of spawning real processes: the
    # raylet itself serves the worker RPC surface (push_task /
    # push_task_batch) at its own address, replying a packaged None per
    # return. The control plane — GCS tables, scheduler, gossip,
    # leases, placement groups — runs exactly as in production, which
    # is what the reference's scalability envelope measures
    # (release/benchmarks/README.md: 2k nodes / 40k actors / 10k tasks
    # with a TRIVIAL workload); only the workload processes are
    # virtualized so one box can host 50+ raylets and 5k+ actors.
    # ------------------------------------------------------------------

    def _register_virtual_worker(self, job_id: bytes, chips: tuple,
                                 runtime_env: dict | None,
                                 starting_key: tuple):
        from ray_tpu_torch._private.runtime_env import env_hash as _env_hash

        worker = WorkerHandle(
            worker_id=os.urandom(16),
            addr=self.server.address,
            pid=0,
            job_id=job_id,
            gpu_ids=tuple(chips),
            env_hash=_env_hash(runtime_env),
        )
        self._starting[starting_key] = max(
            0, self._starting.get(starting_key, 0) - 1)
        key = self._pool_key(worker.job_id, worker.gpu_ids,
                             worker.env_hash)
        self._workers[worker.worker_id] = worker
        self._idle.setdefault(key, []).append(worker)
        self._dispatch()

    def _virtual_reply(self, spec: task_mod.TaskSpec) -> dict:
        if self._none_frame is None:
            from ray_tpu_torch._private import serialization

            pickled, buffers = serialization.serialize(None)
            self._none_frame = serialization.pack(pickled, buffers)
        from ray_tpu_torch._private.ids import TaskID

        returns = []
        for i in range(spec.num_returns):
            oid = ObjectID.for_task_return(TaskID(spec.task_id), i)
            returns.append([oid.binary(), "v", self._none_frame])
        return {"returns": returns}

    async def rpc_push_task(self, req):
        if not self.virtual_workers:
            return {"error": True,
                    "error_msg": "raylet does not execute tasks"}
        return self._virtual_reply(task_mod.TaskSpec.from_wire(req["spec"]))

    async def rpc_push_task_batch(self, req):
        if not self.virtual_workers:
            return [{"error": True,
                     "error_msg": "raylet does not execute tasks"}
                    for _ in req["specs"]]
        return [self._virtual_reply(task_mod.TaskSpec.from_wire(w))
                for w in req["specs"]]

    async def rpc_exit_worker(self, req):
        # Virtual workers share the raylet's address, so a kill_actor
        # notify lands here. There is no process to exit, but the
        # worker's lease (and any chips it holds) must still be
        # released or actor kill/create churn leaks node resources.
        wid = req.get("worker_id")
        if self.virtual_workers and wid:
            worker = self._workers.get(wid)
            if worker is not None:
                # the GCS initiated this exit and already marked the
                # actor dead — drop the mapping so the death handler
                # doesn't re-report it
                self._actor_workers.pop(wid, None)
                await self._on_worker_death(worker)
        return None

    def _fail_leases_for_key(self, key: tuple, msg: str) -> None:
        """Error out every pending lease whose (job, runtime env, chip
        demand) maps to this pool key — terminal action for the
        crash-loop breaker and for deterministic env-setup failures.
        Chip-scoped: a broken GPU pool must not fail the same job's
        healthy CPU leases (or vice versa)."""
        from ray_tpu_torch._private.runtime_env import env_hash as _env_hash

        job_id = key[0]
        chips_key = key[1] if len(key) > 1 else ()
        ehash = key[2] if len(key) > 2 else ""
        if len(chips_key) == 2 and chips_key[0] == "gpu":
            want_gpu = int(chips_key[1])
        else:
            want_gpu = len(chips_key)
        for lease in list(self._pending):
            if lease.spec.job_id != job_id:
                continue
            if _env_hash(lease.spec.runtime_env) != ehash:
                continue
            if int(lease.resources.get("GPU", 0) or 0) != want_gpu:
                continue
            self._pending.remove(lease)
            self._release_resources(lease)
            self._leases.pop(lease.lease_id, None)
            if not lease.reply_fut.done():
                lease.reply_fut.set_result(
                    {"granted": False, "error": msg})
        # reset: a later, fixed env spec with the same key may succeed
        self._startup_failures.pop(key, None)

    def _grant(self, lease: Lease, worker: WorkerHandle):
        self._leases_granted += 1
        lease.worker = worker
        if lease.spec.task_type == task_mod.ACTOR_CREATION_TASK:
            self._actor_workers[worker.worker_id] = lease.spec.actor_id
            # Actors use their resources for *placement* but hold only
            # accelerators while alive (reference: actors hold 0 CPU after
            # creation, ray docs "actors use 1 CPU for scheduling and 0 for
            # running"); otherwise N live actors deadlock an N-CPU node.
            pool = self.available
            if lease.pg_key is not None:
                pool = self._bundle_available.get(lease.pg_key, pool)
            released = {k: v for k, v in lease.resources.items() if k != "GPU"}
            for k, v in released.items():
                pool[k] = pool.get(k, 0.0) + v
            lease.resources = {k: v for k, v in lease.resources.items()
                               if k == "GPU"}
            self._freed_since_heartbeat = True
            self._heartbeat_nudge.set()
        if not lease.reply_fut.done():
            lease.reply_fut.set_result({
                "granted": True,
                "worker_addr": worker.addr,
                "worker_id": worker.worker_id,
                "lease_id": lease.lease_id,
                "node_id": self.node_id.binary(),
            })

    def _release_lease(self, lease: Lease, worker_dead: bool = False):
        self._release_resources(lease)
        self._leases.pop(lease.lease_id, None)
        if lease in self._pending:
            self._pending.remove(lease)
        worker = lease.worker
        if worker is None:
            return
        if worker_dead:
            return
        if lease.dedicated:
            # Actor workers stay bound to the actor until it dies.
            return
        key = self._pool_key(worker.job_id, worker.gpu_ids,
                             worker.env_hash)
        self._idle.setdefault(key, []).append(worker)

    async def rpc_return_worker(self, req):
        self._workers_returned += 1
        lease = self._leases.get(req["lease_id"])
        if lease is None:
            return {"ok": False}
        worker = lease.worker
        self._release_lease(lease, worker_dead=req.get("worker_dead", False))
        if req.get("kill_worker") and worker is not None and worker.proc \
                and worker.proc.returncode is None:
            worker.proc.terminate()  # death path returns its chips/slots
        self._dispatch()
        return {"ok": True}

    # ------------------------------------------------------------------
    # placement group bundles
    # ------------------------------------------------------------------

    async def rpc_prepare_bundle(self, req):
        key = (req["pg_id"], req["bundle_index"])
        demand = req["resources"]
        if not all(self.available.get(k, 0.0) >= v for k, v in demand.items()):
            return {"ok": False}
        for k, v in demand.items():
            self.available[k] = self.available.get(k, 0.0) - v
        self._bundles[key] = dict(demand)
        return {"ok": True}

    async def rpc_commit_bundle(self, req):
        key = (req["pg_id"], req["bundle_index"])
        if key not in self._bundles:
            return {"ok": False}
        self._bundle_available[key] = dict(self._bundles[key])
        self._dispatch()
        return {"ok": True}

    async def rpc_release_bundle(self, req):
        key = (req["pg_id"], req["bundle_index"])
        demand = self._bundles.pop(key, None)
        self._bundle_available.pop(key, None)
        if demand:
            for k, v in demand.items():
                self.available[k] = self.available.get(k, 0.0) + v
            self._freed_since_heartbeat = True
            self._heartbeat_nudge.set()
        self._dispatch()
        return {"ok": True}

    # ------------------------------------------------------------------
    # object plane (DependencyManager + ObjectManager)
    # ------------------------------------------------------------------

    async def pull_object(self, object_id: ObjectID, owner_addr: str):
        """Ensure `object_id` is in the local store, fetching (or
        restoring from local spill) if needed."""
        if self.store.contains(object_id):
            return
        if await self._restore_async(object_id.binary()):
            return
        inflight = self._pulls_inflight.get(object_id.binary())
        if inflight is not None:
            await inflight
            return
        fut = asyncio.get_event_loop().create_future()
        self._pulls_inflight[object_id.binary()] = fut
        try:
            await self._pull_with_recovery(object_id, owner_addr)
            fut.set_result(True)
        except BaseException as e:
            fut.set_exception(e)
            raise
        finally:
            if not fut.done():
                fut.set_result(True)
            # The entry only dedupes concurrent pulls; once settled it must
            # go away or a later re-pull (after eviction) would no-op on the
            # stale completed future.
            self._pulls_inflight.pop(object_id.binary(), None)

    async def _pull_with_recovery(self, object_id: ObjectID,
                                  owner_addr: str, attempts: int = 8):
        """Fetch from an advertised location; on failure report the dead
        location to the owner (who drops it and, for reconstructible
        objects, re-executes the creating task — reference:
        ObjectRecoveryManager) and re-query. The status query blocks
        while the owner reconstructs, so the retry lands on the fresh
        copy."""
        owner = await self.clients.get(owner_addr)
        last_err = "no locations"
        for _ in range(attempts):
            status = await owner.call("get_object_status", {
                "object_id": object_id.binary(),
                "wait": True,
            }, timeout=300.0)
            if status.get("error"):
                raise RuntimeError(status["error"])
            if self.store.contains(object_id):
                return
            if status["status"] == "inband":
                await self._put_raw_with_spill_async(object_id,
                                                     status["value"])
                return
            if status["status"] == "err":
                # error frames surface at the caller's get(); nothing to
                # localize
                raise RuntimeError("object errored at owner")
            all_locs = status.get("locations", [])
            locations = [a for a in all_locs if a != self.server.address]
            if not locations:
                if self.server.address in all_locs:
                    # the owner thinks WE hold it, but we don't (evicted
                    # or lost): this report is authoritative — no GCS
                    # liveness check can refute a raylet about its own
                    # store
                    await owner.call("report_lost_location", {
                        "object_id": object_id.binary(),
                        "raylet_addr": self.server.address,
                        "authoritative": True,
                    }, timeout=30.0)
                last_err = f"no locations for {object_id.hex()}"
                await asyncio.sleep(0.5)
                continue
            fetched = False
            for addr in locations:
                if addr in self._dead_addrs:
                    # GCS already declared this holder dead: skip the
                    # dial (a cold connect costs the full
                    # rpc_connect_timeout_s) and go straight to the
                    # lost-location report so the owner reconstructs
                    fetched = False
                else:
                    try:
                        fetched = await self._fetch_remote_chunked(
                            object_id, addr)
                    except (ConnectionLost, RpcError, OSError,
                            RuntimeError):
                        fetched = False
                if fetched:
                    await owner.notify("add_object_location", {
                        "object_id": object_id.binary(),
                        "raylet_addr": self.server.address,
                    })
                    break
                last_err = f"fetch failed from {addr}"
                verdict = await owner.call("report_lost_location", {
                    "object_id": object_id.binary(),
                    "raylet_addr": addr,
                }, timeout=30.0)
                if verdict.get("still_alive"):
                    # transient blip to a live holder — or a dead node
                    # the GCS hasn't pruned yet (prune takes ~period ×
                    # threshold). Back off long enough that the attempt
                    # budget comfortably spans that window.
                    self._dead_addrs.pop(addr, None)
                    await asyncio.sleep(1.0)
            if fetched:
                return
        raise RuntimeError(
            f"pull failed for {object_id.hex()}: {last_err}")

    async def rpc_pull_object(self, req):
        await self.pull_object(ObjectID(req["object_id"]), req["owner_addr"])
        return {"ok": True}

    # -- chunked transfer (reference: ObjectBufferPool chunking,
    # object_manager.h:117 — fixed-size chunks pipelined into a
    # pre-created buffer, so object size is not capped by the RPC frame
    # limit and no whole-object intermediate copy is made) -------------

    async def _buffer_or_restore(self, oid_bytes: bytes):
        buf = self.store.get_buffer(ObjectID(oid_bytes), timeout=-1)
        if buf is None:
            try:
                restored = await self._restore_async(oid_bytes)
            except Exception as e:  # noqa: BLE001
                logger.warning("restore of %s failed: %r",
                               oid_bytes.hex()[:12], e)
                return None
            if restored:
                buf = self.store.get_buffer(ObjectID(oid_bytes),
                                            timeout=-1)
            else:
                logger.info("object %s neither in store nor spilled",
                            oid_bytes.hex()[:12])
        return buf

    def _release_transfer_handle(self, oid_bytes: bytes):
        self._transfer_handles.pop(oid_bytes, None)

    async def rpc_fetch_object_meta(self, req):
        oid = req["object_id"]
        buf = await self._buffer_or_restore(oid)
        if buf is None:
            return {"size": None}
        # transfer lease: keep the buffer referenced (unevictable) while
        # the puller streams chunks; reaped on a timer as a backstop
        self._transfer_handles[oid] = buf
        asyncio.get_event_loop().call_later(
            300.0, self._release_transfer_handle, oid)
        return {"size": buf.nbytes}

    async def rpc_fetch_object_chunk(self, req):
        oid = req["object_id"]
        buf = self._transfer_handles.get(oid)
        if buf is None:
            buf = await self._buffer_or_restore(oid)
        if buf is None:
            return {"data": None}
        off = req["offset"]
        data = bytes(buf[off:off + req["length"]])
        if req.get("last"):
            self._release_transfer_handle(oid)
        return {"data": data}

    async def _fetch_remote_chunked(self, object_id: ObjectID,
                                    addr: str) -> bool:
        """Stream a remote object in pipelined chunks directly into a
        pre-created local shm buffer; returns False when the holder no
        longer has the object."""
        holder = await self.clients.get(addr)
        meta = await holder.call(
            "fetch_object_meta", {"object_id": object_id.binary()},
            timeout=60.0)
        size = meta.get("size")
        if size is None:
            return False
        buf = await self._create_with_spill_async(object_id, size)
        chunk = self.config.object_transfer_chunk_bytes
        sem = asyncio.Semaphore(self.config.object_transfer_parallelism)

        offsets = list(range(0, size, chunk))
        remaining = {"n": len(offsets)}

        async def fetch_one(off: int):
            async with sem:
                remaining["n"] -= 1
                reply = await holder.call("fetch_object_chunk", {
                    "object_id": object_id.binary(),
                    "offset": off,
                    "length": min(chunk, size - off),
                    # releases the holder's transfer lease with the
                    # final chunk request
                    "last": remaining["n"] == 0,
                }, timeout=300.0)
                data = reply.get("data")
                if data is None:
                    raise RuntimeError("holder dropped object mid-fetch")
                buf[off:off + len(data)] = data

        try:
            await asyncio.gather(*[fetch_one(off) for off in offsets])
        except BaseException:
            try:
                self.store.release(object_id)
                self.store.delete(object_id)  # discard the partial write
            except Exception:  # noqa: BLE001
                pass
            raise
        self.store.seal(object_id)
        self.store.release(object_id)
        return True

    # -- spilling / restore (reference: local_object_manager.h:41).
    # All whole-object disk I/O runs in executor threads under
    # _spill_lock: the raylet loop must keep heartbeating while
    # multi-GB files move, or the GCS declares this node dead. --------

    def _create_with_spill(self, object_id: ObjectID, size: int):
        """Synchronous create-with-spill; call from an executor thread
        (or via _create_with_spill_async from the loop)."""
        from ray_tpu_torch._private.object_store import ObjectStoreFullError

        for _ in range(3):
            try:
                return self.store.create_buffer(object_id, size)
            except ObjectStoreFullError:
                if self._spill_up_to(size) == 0:
                    raise
        return self.store.create_buffer(object_id, size)

    async def _create_with_spill_async(self, object_id: ObjectID,
                                       size: int):
        from ray_tpu_torch._private.object_store import ObjectStoreFullError

        try:
            return self.store.create_buffer(object_id, size)
        except ObjectStoreFullError:
            pass
        async with self._spill_lock:
            return await asyncio.get_event_loop().run_in_executor(
                None, self._create_with_spill, object_id, size)

    def _put_raw_with_spill(self, object_id: ObjectID, data) -> None:
        buf = self._create_with_spill(object_id, len(data))
        buf[:] = data
        self.store.seal(object_id)
        self.store.release(object_id)

    async def _put_raw_with_spill_async(self, object_id: ObjectID,
                                        data) -> None:
        from ray_tpu_torch._private.object_store import ObjectStoreFullError

        try:
            self.store.put_raw(object_id, data)
            return
        except ObjectStoreFullError:
            pass
        async with self._spill_lock:
            await asyncio.get_event_loop().run_in_executor(
                None, self._put_raw_with_spill, object_id, data)

    def _spill_up_to(self, needed: int) -> int:
        """Write pinned primary copies to disk (oldest pin first) until
        `needed` bytes of shm become reclaimable; dropping the pin buffer
        makes the shm copy LRU-evictable while the disk file keeps the
        object alive. Runs in executor threads — mutations use atomic
        dict ops only."""
        freed = 0
        for oid, buf in list(self._pinned.items()):
            if freed >= needed:
                break
            if oid not in self._spilled:
                os.makedirs(self._spill_dir, exist_ok=True)
                path = os.path.join(self._spill_dir, oid.hex())
                with open(path, "wb") as f:
                    f.write(buf)
                self._spilled[oid] = (path, buf.nbytes)
            freed += buf.nbytes
            self._pinned.pop(oid, None)  # buffer release -> evictable
        if freed:
            logger.info("spilled %d bytes to %s", freed, self._spill_dir)
        return freed

    async def _restore_async(self, oid_bytes: bytes) -> bool:
        if oid_bytes not in self._spilled:
            return False
        async with self._spill_lock:
            return await asyncio.get_event_loop().run_in_executor(
                None, self._restore_spilled, oid_bytes)

    def _restore_spilled(self, oid_bytes: bytes) -> bool:
        """Load a spilled object back into shm, reading straight into
        the store buffer (no whole-object intermediate copy — the node
        is memory-pressured by definition when this runs). The disk file
        stays authoritative until the owner unpins."""
        rec = self._spilled.get(oid_bytes)
        if rec is None:
            return False
        path, size = rec
        oid = ObjectID(oid_bytes)
        if self.store.contains(oid):
            return True
        try:
            with open(path, "rb") as f:
                buf = self._create_with_spill(oid, size)
                f.readinto(buf)
        except OSError:
            self._spilled.pop(oid_bytes, None)
            return False
        self.store.seal(oid)
        self.store.release(oid)
        return True

    # -- primary-copy pinning (reference: local_object_manager.h — the
    # raylet holding an owned object's primary copy keeps it unevictable
    # until the owner releases it) -------------------------------------

    async def rpc_pin_object(self, req):
        oid = ObjectID(req["object_id"])
        if req["object_id"] in self._pinned:
            return {"ok": True}
        if req["object_id"] in self._spilled:
            return {"ok": True}  # the disk file is the pinned copy
        # timeout=-1 is the NON-BLOCKING probe (0 means wait-forever and
        # would wedge the raylet's event loop on an evicted object)
        buf = self.store.get_buffer(oid, timeout=-1)
        if buf is None:
            if await self._restore_async(req["object_id"]):
                buf = self.store.get_buffer(oid, timeout=-1)
        if buf is None:
            return {"ok": False, "error": "object not in store"}
        # holding the buffer holds the store refcount; LRU only evicts
        # refcount-zero objects
        self._pinned[req["object_id"]] = buf
        # primary-copy hint in the slot itself: loss sweeps and the
        # drop_objects chaos fault can tell authoritative copies from
        # pulled replicas without consulting this process's dicts
        self.store.set_primary(oid, True)
        return {"ok": True}

    async def rpc_unpin_object(self, req):
        oid = req["object_id"]
        buf = self._pinned.pop(oid, None)
        rec = self._spilled.pop(oid, None)
        if rec is not None:
            try:
                os.unlink(rec[0])
            except OSError:
                pass
        if req.get("free"):
            # the owner's distributed refcount hit zero: delete the shm
            # copy outright instead of waiting for eviction pressure.
            # Drop OUR buffer reference first, then only force-delete a
            # refcount-zero slot — yanking a slot while a reader still
            # maps it would corrupt zero-copy views.
            del buf
            object_id = ObjectID(oid)
            if self.store.refcount(object_id) == 0:
                self.store.delete(object_id)
                self._objects_freed += 1
        return {"ok": True}

    def _chaos_drop_objects(self, frac: float, rng) -> int:
        """Timed-fault target (fault_injection `drop_objects[:<frac>]`):
        force-delete a seeded random subset of this node's sealed
        objects, pins included, WITHOUT killing the process — models
        silent object loss (arena corruption, operator fat-finger) as
        distinct from whole-node death. Runs on the chaos timer thread;
        dict ops are GIL-atomic and the store delete is shard-locked."""
        rows = self.store.list_sealed()
        if not rows:
            return 0
        k = max(1, int(len(rows) * frac))
        chosen = rng.sample(rows, min(k, len(rows)))
        dropped = 0
        for oid, _primary, _referenced in chosen:
            key = oid.binary()
            # drop our pin's buffer reference first — the point is to
            # lose primary copies, and a pinned slot is refcounted
            self._pinned.pop(key, None)
            if self.store.refcount(oid) > 0:
                continue  # a live reader maps the slot: yanking it
                # would corrupt a zero-copy view, not simulate loss
            self.store.delete(oid)
            dropped += 1
        self._objects_dropped += dropped
        return dropped

    async def rpc_spill_objects(self, req):
        """A local worker's plasma create failed: make room by spilling
        pinned primary copies to disk (reference: the raylet triggering
        spill on CreateRequestQueue pressure)."""
        async with self._spill_lock:
            freed = await asyncio.get_event_loop().run_in_executor(
                None, self._spill_up_to, req["needed"])
        return {"freed": freed}

    async def rpc_metrics_text(self, req):
        """Prometheus text over RPC (same rationale as the GCS twin)."""
        return {"text": self._metrics_text()}

    async def rpc_dump_stacks(self, req):
        """This raylet's Python thread stacks, optionally fanned out to
        every registered worker on the node (`req['workers']`) — one
        node's contribution to `ray_tpu stack --all`. Workers answer on
        their core-worker RPC loop, which lives on its own thread, so a
        worker whose MAIN thread is wedged still reports the stack that
        proves it; a worker that can't answer at all contributes an
        error row instead of stalling the aggregate (bounded timeout)."""
        out = {"pid": os.getpid(), "role": "raylet",
               "node_id": self.node_id.binary().hex(),
               "threads": health_mod.dump_stacks()}
        if req.get("workers"):
            timeout = float(req.get("timeout", 5.0))
            rows = []
            for w in list(self._workers.values()):
                if not w.alive:
                    continue
                try:
                    client = await self.clients.get(w.addr)
                    r = await client.call("dump_stacks", {},
                                          timeout=timeout)
                    rows.append(r)
                except (ConnectionLost, RpcError, OSError,
                        asyncio.TimeoutError) as e:
                    rows.append({"pid": w.pid, "role": "worker",
                                 "error": f"{type(e).__name__}: {e}"})
            out["workers"] = rows
        return out

    async def rpc_get_store_stats(self, req):
        return self.store.stats()

    async def rpc_list_objects(self, req):
        """Primary copies this raylet is responsible for: pinned (shm)
        and spilled (disk) objects, for the state API."""
        out = []
        for oid, buf in self._pinned.items():
            out.append({"object_id": oid.hex(), "where": "shm",
                        "size": buf.nbytes})
        for oid, (path, size) in self._spilled.items():
            out.append({"object_id": oid.hex(), "where": "spilled",
                        "size": size, "path": path})
        return out

    async def rpc_node_info(self, req):
        return {
            "node_id": self.node_id.binary(),
            "store_name": self.store_name,
            "total": self.total,
            "available": self.available,
            "num_workers": len(self._workers),
        }


async def main(args):
    _fi.set_role("raylet")  # arm raylet-scoped timed faults
    resources = json.loads(args.resources) if args.resources else None
    raylet = Raylet(
        gcs_addr=args.gcs_addr,
        host=args.host,
        port=args.port,
        resources=resources,
        store_name=args.store_name or None,
        object_store_memory=args.object_store_memory or None,
        session_dir=args.session_dir,
        labels=json.loads(args.labels) if args.labels else None,
    )
    await raylet.start(metrics_port=args.metrics_port)
    print(f"RAYLET_READY {raylet.address} {raylet.store_name} "
          f"{raylet.node_id.hex()}", flush=True)
    import signal

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    loop.add_signal_handler(signal.SIGTERM, stop.set)
    loop.add_signal_handler(signal.SIGINT, stop.set)

    async def parent_watch():
        # Daemons are children of the driver that spawned the cluster; if
        # that driver dies abruptly (crash, SIGKILL) we are reparented to
        # init — tear down instead of leaking (reference: raylets die with
        # the session via `ray stop`; subreaper kills orphans).
        parent = os.getppid()
        while os.getppid() == parent:
            await asyncio.sleep(1.0)
        stop.set()

    if not getattr(args, 'daemonize', False):
        asyncio.ensure_future(parent_watch())
    await stop.wait()
    # Graceful teardown: kill worker children, unlink the shm arena.
    await raylet.stop()


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-addr", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--resources", default=None)
    parser.add_argument("--store-name", default=None)
    parser.add_argument("--object-store-memory", type=int, default=0)
    parser.add_argument("--session-dir", default=SESSION_ROOT)
    parser.add_argument("--labels", default=None,
                        help="JSON node labels (slice membership)")
    parser.add_argument("--metrics-port", type=int, default=None,
                        help="serve Prometheus /metrics on this port")
    parser.add_argument("--log-file", default=None)
    parser.add_argument("--daemonize", action="store_true",
                        help="survive the launching process (CLI mode)")
    args = parser.parse_args()
    if args.log_file:
        logging.basicConfig(filename=args.log_file, level=logging.INFO)
    asyncio.run(main(args))
