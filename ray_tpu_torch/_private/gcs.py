"""GCS — Global Control Service: the head-node metadata/control plane.

Reference: `src/ray/gcs/gcs_server/` — cluster metadata authority and
cluster-level scheduler: node membership + health checks
(`GcsNodeManager`, `GcsHealthCheckManager`), actor directory with
fault-tolerant restart (`GcsActorManager` + `GcsActorScheduler`),
placement-group creation (`GcsPlacementGroupManager`), job table
(`GcsJobManager`), internal KV (`GcsKvManager`), pubsub
(`pubsub_handler`), and the resource-view sync loop (ray_syncer).

All tables are in-memory (the reference's default `InMemoryStoreClient`);
Redis-backed persistence for GCS fault tolerance is a later round.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import fault_injection as _fi
from ray_tpu_torch._private import health as health_mod
from ray_tpu_torch._private import rpc
from ray_tpu_torch._private import sharded_table
from ray_tpu_torch._private import task as task_mod
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.sharded_table import ShardedTable
from ray_tpu_torch.util import events as export_events
from ray_tpu_torch._private.rpc import ClientPool, ConnectionLost, RpcError, RpcServer
from ray_tpu_torch._private.scheduling import (
    ClusterView,
    pick_node,
    place_bundles,
    place_slice_bundles,
)

logger = logging.getLogger(__name__)

# Actor lifecycle states (reference: rpc::ActorTableData::ActorState).
PENDING = "PENDING_CREATION"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"


class GcsServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 config: Config | None = None,
                 persist_path: str | None = None,
                 store_path: str | None = None):
        self.config = config or Config.from_env()
        self.server = RpcServer(host, port)
        self.clients = ClientPool()
        self.view = ClusterView()

        # Tables. The hot-write tables (actor directory, bounded task-event
        # log) are keyed-shard maps: concurrent registrations and event
        # ingestion spread over shards with per-shard counters in /metrics,
        # and write-through persistence routes by the same shard index onto
        # per-shard store threads (see _persist).
        self.kv: Dict[str, Dict[bytes, bytes]] = {}
        self.nodes: Dict[bytes, dict] = {}
        self.jobs: Dict[bytes, dict] = {}
        self.actors: ShardedTable = ShardedTable(name="actors")
        self.named_actors: Dict[str, bytes] = {}
        self.placement_groups: Dict[bytes, dict] = {}
        self.task_events: ShardedTable = ShardedTable(name="task_events")
        self.subscribers: Dict[str, List[str]] = {}
        self._last_heartbeat: Dict[bytes, float] = {}
        self._pending_actors: List[bytes] = []
        self._scheduling_actors: set = set()
        self._pending_pgs: List[bytes] = []
        self._bg_tasks: list = []
        # kills' exit notices in flight (held: the loop keeps tasks weakly)
        self._exit_notices: set = set()
        self._retry_wakeup = asyncio.Event()
        # orders availability deltas against death publishes on the
        # "resources" gossip channel (see _publish_resource_delta)
        self._resources_pub_lock = asyncio.Lock()
        # Persistence (reference: RedisStoreClient-backed GCS tables,
        # store_client/redis_store_client.h — here a snapshot file):
        # tables survive a GCS restart; raylets reregister via the
        # heartbeat reregister handshake, clients reconnect through
        # their ReconnectingClient handles.
        self.persist_path = persist_path
        # Pluggable write-through StoreClient (reference:
        # RedisStoreClient, src/ray/gcs/store_client/
        # redis_store_client.h): every table MUTATION is durable at
        # write time — a GCS killed between snapshot intervals restarts
        # with current tables, not the last snapshot's.
        from ray_tpu_torch._private.store_client import make_store_client

        self.store = make_store_client(store_path)
        # One single-thread writer per table shard: same key → same shard
        # → same thread keeps per-key mutation order, while writes for
        # different shards no longer serialize on one store thread.
        self._store_pools = ([
            ThreadPoolExecutor(1, f"gcs-store-{i}")
            for i in range(ShardedTable.DEFAULT_SHARDS)]
            if self.store else None)
        # deadman probe over the persist executors: beats land in
        # _store_put on the shard threads; backlog is the queued writes
        # across all shards, so a wedged store thread (disk hang) reads
        # as frozen-counter-with-backlog and gets its stack captured
        self._store_probe = (health_mod.watch_loop(
            "gcs_store", backlog_fn=self._store_backlog)
            if self._store_pools else None)
        self._watchdog: Optional[health_mod.Watchdog] = None
        if self.store is not None and self.store.tables():
            self._load_from_store()
        elif persist_path:
            self._load_snapshot()
            if self.store is not None:
                # migration: snapshot-restored tables must reach the
                # store NOW — the next restart takes the (then
                # non-empty) store as authoritative, and anything left
                # only in the snapshot would silently vanish
                self._dump_all_to_store()

    _SNAPSHOT_TABLES = ("kv", "jobs", "actors", "named_actors",
                        "placement_groups", "subscribers", "task_events")

    def _load_snapshot(self):
        import pickle

        try:
            with open(self.persist_path, "rb") as f:
                data = pickle.load(f)
        except FileNotFoundError:
            return
        except Exception:  # noqa: BLE001 — torn write: start fresh
            logger.exception("snapshot unreadable; starting fresh")
            return
        for name in self._SNAPSHOT_TABLES:
            if name in data:
                setattr(self, name, data[name])
        self._reshard_tables()
        self._resume_pending("snapshot")

    def _load_from_store(self):
        """Rebuild tables from the write-through StoreClient — the
        authoritative copy (fresher than any snapshot: it has every
        mutation up to the instant of death)."""
        self.actors = self.store.get_all("actors")
        self.placement_groups = self.store.get_all("placement_groups")
        self.jobs = self.store.get_all("jobs")
        self.named_actors = {
            k.decode(): v
            for k, v in self.store.get_all("named_actors").items()}
        self.kv = {}
        for table in self.store.tables():
            if table.startswith("kv:"):
                self.kv[table[3:]] = self.store.get_all(table)
        self._reshard_tables()
        self._resume_pending("store")

    def _reshard_tables(self):
        """Restored tables arrive as plain dicts (store dumps, pre-shard
        snapshots); rewrap the hot tables, keeping insertion order as the
        recency order. A ShardedTable from a current snapshot unpickles
        as itself and passes through."""
        for name in ("actors", "task_events"):
            table = getattr(self, name)
            if not isinstance(table, ShardedTable):
                setattr(self, name,
                        ShardedTable.from_mapping(table, name=name))

    def _resume_pending(self, source: str):
        # resume interrupted placements: anything not terminal goes back
        # on the pending queues
        for actor_id, info in self.actors.items():
            if info["state"] in (PENDING, RESTARTING):
                self._pending_actors.append(actor_id)
        for pg_id, pg in self.placement_groups.items():
            if pg["state"] == "PENDING":
                self._pending_pgs.append(pg_id)
        logger.info(
            "restored GCS state from %s: %d actors, %d PGs, %d jobs, "
            "%d kv ns", source, len(self.actors),
            len(self.placement_groups), len(self.jobs), len(self.kv))

    async def _publish_resource_delta(self, node_id: bytes, data: dict):
        """Resource-gossip deltas ride a per-channel LOCK shared with the
        death publish (reference ordering concern: ray_syncer versions
        its messages): a heartbeat handler suspended mid-publish cannot
        have its delta land AFTER a concurrent death publish and
        resurrect the node in peer views — the lock serializes the two,
        and aliveness is re-checked inside it."""
        async with self._resources_pub_lock:
            node = self.nodes.get(node_id)
            if node is None or not node["alive"]:
                return  # died while we waited: death publish stands
            await self.publish("resources", data)

    def _dump_all_to_store(self):
        for actor_id, rec in self.actors.items():
            self.store.put("actors", actor_id, rec)
        for pg_id, rec in self.placement_groups.items():
            self.store.put("placement_groups", pg_id, rec)
        for job_id, rec in self.jobs.items():
            self.store.put("jobs", job_id, rec)
        for name, actor_id in self.named_actors.items():
            self.store.put("named_actors", name.encode(), actor_id)
        for ns, table in self.kv.items():
            for k, v in table.items():
                self.store.put(f"kv:{ns}", k, v)

    # -- write-through persistence (StoreClient seam) -------------------

    def _persist(self, table: str, key: bytes, record) -> None:
        """Serialize on the loop thread (consistent view of the record),
        write on the key's shard-routed store thread (ordered per key —
        one writer thread per shard keeps mutation order, and writes to
        different shards no longer queue behind each other)."""
        if self.store is None:
            return
        import pickle

        blob = pickle.dumps(record)
        pool = self._store_pools[
            sharded_table.shard_index(key, len(self._store_pools))]
        pool.submit(self._store_put, table, key, blob)

    def _store_backlog(self) -> int:
        return sum(p._work_queue.qsize()
                   for p in (self._store_pools or []))

    def _store_put(self, table, key, blob):
        if self._store_probe is not None:
            self._store_probe.beat()
        try:
            self.store.put_blob(table, key, blob)
        except Exception:  # noqa: BLE001 — durability is best-effort
            logger.exception("store write failed: %s/%s", table, key.hex())

    def _unpersist(self, table: str, key: bytes) -> None:
        if self.store is None:
            return
        pool = self._store_pools[
            sharded_table.shard_index(key, len(self._store_pools))]
        pool.submit(self.store.delete, table, key)

    def _write_snapshot(self):
        self._write_snapshot_bytes(self._serialize_snapshot())

    def _serialize_snapshot(self) -> bytes:
        """MUST run on the event-loop thread: pickling live tables while
        handlers mutate them would see dicts change mid-iteration."""
        import pickle

        data = {name: getattr(self, name)
                for name in self._SNAPSHOT_TABLES}
        return pickle.dumps(data)

    def _write_snapshot_bytes(self, blob: bytes):
        tmp = self.persist_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, self.persist_path)  # atomic swap

    async def _snapshot_loop(self):
        while True:
            await asyncio.sleep(1.0)
            try:
                blob = self._serialize_snapshot()  # on-loop: consistent
                await asyncio.get_event_loop().run_in_executor(
                    None, self._write_snapshot_bytes, blob)
            except Exception:  # noqa: BLE001
                logger.exception("snapshot write failed")

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def _metrics_text(self) -> str:
        states: Dict[str, int] = {}
        for a in self.actors.values():
            states[a["state"]] = states.get(a["state"], 0) + 1
        from ray_tpu_torch._private import scheduling as scheduling_mod

        lines = [
            "# TYPE gcs_nodes_alive gauge",
            f"gcs_nodes_alive "
            f"{sum(1 for n in self.nodes.values() if n['alive'])}",
            f"gcs_placement_groups_pending {len(self._pending_pgs)}",
            # scheduler queue depth at the GCS: actors waiting for a
            # feasible node + pending PGs (flight-recorder plane)
            "# TYPE scheduler_queue_depth gauge",
            f"scheduler_queue_depth "
            f"{len(self._pending_actors) + len(self._pending_pgs)}",
            f"gcs_actors_pending {len(self._pending_actors)}",
            f"gcs_task_events {len(self.task_events)}",
        ]
        for state, count in states.items():
            lines.append(f'gcs_actors{{state="{state}"}} {count}')
        return ("\n".join(lines) + "\n"
                + self.actors.metrics_text()
                + self.task_events.metrics_text()
                + scheduling_mod.metrics_text()
                + rpc.metrics_text()
                + health_mod.metrics_text())

    async def start(self, metrics_port: int | None = None):
        self.server.register_all(self)
        await self.server.start()
        self._watchdog = health_mod.Watchdog(source="GCS").start()
        self._bg_tasks = [
            asyncio.ensure_future(self._health_check_loop()),
            asyncio.ensure_future(self._retry_loop()),
            # event-loop liveness: every handler (and the persist fan-in)
            # rides this loop — a blocked loop freezes the ticker
            health_mod.loop_ticker(
                health_mod.watch_loop("gcs_loop")),
        ]
        if self.persist_path:
            self._bg_tasks.append(
                asyncio.ensure_future(self._snapshot_loop()))
            self._retry_wakeup.set()  # kick restored pending work
        if metrics_port is not None:
            from ray_tpu_torch.util.metrics import serve_metrics

            self._metrics_server, port = await serve_metrics(
                port=metrics_port, extra_text=self._metrics_text)
            logger.info("metrics on :%d/metrics", port)
            self.metrics_port = port
        logger.info("GCS listening on %s", self.server.address)
        return self

    _metrics_server = None

    async def stop(self):
        for t in self._bg_tasks:
            t.cancel()
        if self._watchdog is not None:
            self._watchdog.stop()
        if self._metrics_server is not None:
            self._metrics_server.close()
        if self.persist_path:
            try:
                # final snapshot can be tens of MB — write it off-loop
                # so in-flight replies drain while it lands
                await asyncio.get_running_loop().run_in_executor(
                    None, self._write_snapshot)
            except Exception:  # noqa: BLE001
                logger.exception("final snapshot failed")
        await self.clients.close_all()
        await self.server.stop()

    @property
    def address(self) -> str:
        return self.server.address

    # ------------------------------------------------------------------
    # pubsub (reference: src/ray/pubsub — push-based here since every
    # participant runs an RpcServer)
    # ------------------------------------------------------------------

    async def rpc_subscribe(self, req):
        self.subscribers.setdefault(req["channel"], [])
        if req["addr"] not in self.subscribers[req["channel"]]:
            self.subscribers[req["channel"]].append(req["addr"])
        return {"ok": True}

    async def publish(self, channel: str, data: Any):
        """Fan out concurrently with a short per-subscriber budget: a
        dead subscriber (exited driver/worker) must cost ~2s once — not
        a serial 10s connect-retry that stalls whichever RPC handler
        happened to publish."""
        subs = list(self.subscribers.get(channel, []))
        if not subs:
            return

        async def send(addr: str):
            client = await self.clients.get(addr)
            await client.notify("pubsub",
                                {"channel": channel, "data": data})

        results = await asyncio.gather(
            *[asyncio.wait_for(send(a), timeout=2.0) for a in subs],
            return_exceptions=True)
        for addr, result in zip(subs, results):
            # TimeoutError must be checked FIRST: on py3.11+ it IS a
            # subclass of OSError, and a busy-but-live subscriber that
            # blows the 2s budget must keep its subscription — dropping
            # it would silently starve the driver of actor updates
            if isinstance(result, asyncio.TimeoutError):
                logger.debug("pubsub to %s timed out", addr)
            elif isinstance(result, (ConnectionLost, OSError, RpcError)):
                # connection-dead: unsubscribe (removal must be
                # idempotent — concurrent publishes may both see it)
                if addr in self.subscribers.get(channel, []):
                    self.subscribers[channel].remove(addr)
                self.clients.invalidate(addr)

    # ------------------------------------------------------------------
    # node membership + resource view (GcsNodeManager + ray_syncer)
    # ------------------------------------------------------------------

    async def rpc_register_node(self, req):
        node_id = req["node_id"]
        self.nodes[node_id] = {
            "node_id": node_id,
            "raylet_addr": req["raylet_addr"],
            "total": req["total"],
            "available": req["available"],
            "alive": True,
            "hostname": req.get("hostname", ""),
            "labels": req.get("labels", {}),
        }
        self.view.update_node(node_id, req["raylet_addr"], req["total"],
                              req["available"],
                              labels=req.get("labels", {}))
        self._last_heartbeat[node_id] = time.monotonic()
        await export_events.report_async(
            "GCS", "INFO", "NODE_ADDED",
            f"node {node_id.hex()[:8]} joined",
            node_id=node_id.hex(), raylet_addr=req["raylet_addr"])
        await self.publish("nodes", {"event": "added", "node": self.nodes[node_id]})
        # seed peer raylets' views immediately (see the resource-gossip
        # delta push in rpc_heartbeat)
        await self.publish("resources", {
            "node_id": node_id,
            "raylet_addr": req["raylet_addr"],
            "total": req["total"],
            "available": req["available"],
            "labels": req.get("labels", {}),
        })
        self._retry_wakeup.set()
        return {"ok": True}

    async def rpc_heartbeat(self, req):
        if _fi._PLAN is not None:
            # chaos: delayed handling stalls liveness bookkeeping (the
            # health-check loop may mark the node dead meanwhile); a
            # dropped heartbeat never touches state at all
            if await _fi._PLAN.gcs_heartbeat():
                return {"ok": True}
        node_id = req["node_id"]
        node = self.nodes.get(node_id)
        if node is None or not node["alive"]:
            return {"ok": False, "reregister": True}
        node["available"] = req["available"]
        node["pending_demands"] = req.get("pending_demands", [])
        # idle tracking for autoscaler scale-down: a node is idle while
        # its resources are fully free, nothing is queued, and no worker
        # is bound to an actor or a running lease (live CPU actors hold
        # no resources, so resource-freeness alone would mark their node
        # reclaimable; warm idle-pool workers are excluded raylet-side)
        busy = (bool(node["pending_demands"])
                or req.get("busy_workers", 0) > 0
                or any(node["available"].get(k, 0.0) < v
                       for k, v in node["total"].items()))
        if busy:
            node.pop("idle_since", None)
        else:
            node.setdefault("idle_since", time.monotonic())
        self.view.update_node(node_id, node["raylet_addr"], node["total"],
                              req["available"])
        self._last_heartbeat[node_id] = time.monotonic()
        # Push-based resource gossip (reference: ray_syncer's streaming
        # node-resource sync, src/ray/common/ray_syncer/ray_syncer.h:88
        # — replacing the polled view): when a node's availability
        # CHANGES, fan the delta out to subscribed raylets immediately,
        # so spillback decisions ride fresh state instead of waiting out
        # a heartbeat period. The heartbeat reply's full view remains
        # the liveness-coupled fallback.
        if node.get("_pub_avail") != req["available"]:
            node["_pub_avail"] = dict(req["available"])
            await self._publish_resource_delta(node_id, {
                "node_id": node_id,
                "raylet_addr": node["raylet_addr"],
                "total": node["total"],
                "available": req["available"],
                "labels": node.get("labels") or {},
            })
        if req.get("idle_freed"):
            self._retry_wakeup.set()
        # Reply with the cluster resource view so raylets can spill back
        # tasks to other nodes (the ray_syncer gossip, piggybacked).
        return {"ok": True, "view": self._view_wire()}

    def _view_wire(self):
        return [
            {
                "node_id": n.node_id,
                "raylet_addr": n.raylet_addr,
                "total": n.total,
                "available": n.available,
                "labels": n.labels,
            }
            for n in self.view.alive_nodes()
        ]

    async def rpc_get_nodes(self, req):
        return list(self.nodes.values())

    # ------------------------------------------------------------------
    # task events (reference: GcsTaskManager, gcs_task_manager.h — the
    # bounded task table backing `ray list tasks` / `ray summary`)
    # ------------------------------------------------------------------

    _TASK_EVENTS_CAP = 10_000

    async def rpc_add_task_events(self, req):
        # wire form: (task_id, name, type, state, ts) tuples — see
        # CoreWorker._emit_task_event
        for task_id, name, task_type, state, ts in req["events"]:
            rec = self.task_events.get(task_id)
            if rec is None:
                rec = self.task_events[task_id] = {
                    "task_id": task_id,
                    "name": name,
                    "type": task_type,
                    "state": "",
                    "events": [],
                }
                while len(self.task_events) > self._TASK_EVENTS_CAP:
                    self.task_events.popitem_oldest()
            rec["state"] = state
            rec["events"].append((state, ts))
        return None  # notify-only path

    async def rpc_list_task_events(self, req):
        limit = req.get("limit", 1000)
        name = req.get("name")
        state = req.get("state")
        out = []
        for rec in self.task_events.iter_recent():
            if name and rec["name"] != name:
                continue
            if state and rec["state"] != state:
                continue
            out.append(rec)
            if len(out) >= limit:
                break
        return out

    async def rpc_metrics_text(self, req):
        """Prometheus text over RPC: lets bench.py and tooling scrape
        the shard/scheduler counters without a metrics port."""
        return {"text": self._metrics_text()}

    async def rpc_dump_stacks(self, req):
        """All Python thread stacks of the GCS process (+ held-lock info
        when lockdep is armed) — the head-node contribution to
        `ray_tpu stack`, the distributed analog of `ray stack`."""
        return {"pid": os.getpid(), "role": "gcs",
                "threads": health_mod.dump_stacks()}

    async def rpc_get_cluster_load(self, req):
        """Aggregate demand/idleness snapshot for the autoscaler
        (reference: GcsAutoscalerStateManager::HandleGetClusterResourceState,
        autoscaler.proto)."""
        now = time.monotonic()
        nodes = []
        for node in self.nodes.values():
            if not node["alive"]:
                continue
            nodes.append({
                "node_id": node["node_id"],
                "total": node["total"],
                "available": node["available"],
                "labels": node.get("labels", {}),
                "idle_duration_s": (now - node["idle_since"]
                                    if "idle_since" in node else 0.0),
            })
        pending = []
        for node in self.nodes.values():
            if node["alive"]:
                pending.extend(node.get("pending_demands", []))
        # actors the GCS itself could not place yet
        for actor_id in self._pending_actors:
            if actor_id in self._scheduling_actors:
                continue  # lease already dispatched to a raylet — its
                # demand shows up there (or is being satisfied)
            info = self.actors.get(actor_id)
            if info is not None:
                pending.append(
                    task_mod.TaskSpec.from_wire(info["spec"]).resources)
        pending_pgs = []
        for pg_id in self._pending_pgs:
            pg = self.placement_groups.get(pg_id)
            if pg is not None and pg["state"] == "PENDING":
                pending_pgs.append({
                    "bundles": pg["bundles"],
                    "strategy": pg["strategy"],
                    "topology": pg.get("topology"),
                })
        return {"nodes": nodes, "pending": pending,
                "pending_pgs": pending_pgs}

    async def _health_check_loop(self):
        # Reference: GcsHealthCheckManager — mark nodes dead after missed
        # heartbeats; publish so raylets/workers fail fast.
        period = self.config.raylet_heartbeat_period_s
        threshold = self.config.health_check_failure_threshold
        while True:
            await asyncio.sleep(period)
            if _fi._PLAN is not None:
                await _fi._PLAN.gcs_health_tick()
            now = time.monotonic()
            for node_id, node in list(self.nodes.items()):
                if not node["alive"]:
                    continue
                last = self._last_heartbeat.get(node_id, 0)
                if now - last > period * threshold:
                    await self._mark_node_dead(node_id, "missed heartbeats")

    async def _mark_node_dead(self, node_id: bytes, reason: str):
        node = self.nodes.get(node_id)
        if node is None or not node["alive"]:
            return
        node["alive"] = False
        self.view.remove_node(node_id)
        logger.warning("node %s dead: %s", node_id.hex()[:8], reason)
        await export_events.report_async(
            "GCS", "ERROR", "NODE_DEAD",
            f"node {node_id.hex()[:8]} dead: {reason}",
            node_id=node_id.hex(), reason=reason)
        # raylet_addr rides the notice so owners can invalidate object
        # locations (keyed by raylet address) without a get_nodes round
        # trip per death
        await self.publish("nodes", {"event": "removed", "node_id": node_id,
                                     "raylet_addr": node.get("raylet_addr",
                                                             ""),
                                     "reason": reason})
        async with self._resources_pub_lock:
            await self.publish("resources", {"node_id": node_id,
                                             "dead": True})
        # Fail over actors that lived on that node.
        for actor_id, info in list(self.actors.items()):
            if info.get("node_id") == node_id and info["state"] in (ALIVE, PENDING):
                await self._on_actor_failure(actor_id, f"node died: {reason}")

    # ------------------------------------------------------------------
    # KV + function table (GcsKvManager / function_manager)
    # ------------------------------------------------------------------

    async def rpc_kv_put(self, req):
        ns_name = req.get("ns", "")
        ns = self.kv.setdefault(ns_name, {})
        key = req["key"]
        if not req.get("overwrite", True) and key in ns:
            return {"added": False}
        ns[key] = req["value"]
        self._persist(f"kv:{ns_name}", key, req["value"])
        return {"added": True}

    async def rpc_kv_get(self, req):
        value = self.kv.get(req.get("ns", ""), {}).get(req["key"])
        return {"value": value}

    async def rpc_kv_del(self, req):
        ns_name = req.get("ns", "")
        existed = self.kv.get(ns_name, {}).pop(req["key"], None)
        if existed is not None:
            self._unpersist(f"kv:{ns_name}", req["key"])
        return {"deleted": existed is not None}

    async def rpc_kv_keys(self, req):
        prefix = req.get("prefix", b"")
        ns = self.kv.get(req.get("ns", ""), {})
        return {"keys": [k for k in ns if k.startswith(prefix)]}

    async def rpc_kv_exists(self, req):
        return {"exists": req["key"] in self.kv.get(req.get("ns", ""), {})}

    # ------------------------------------------------------------------
    # jobs (GcsJobManager)
    # ------------------------------------------------------------------

    async def rpc_register_job(self, req):
        job_id = req["job_id"]
        self.jobs[job_id] = {
            "job_id": job_id,
            "driver_addr": req.get("driver_addr", ""),
            "start_time": time.time(),
            "finished": False,
            # per-job quota/weight dict (multi-tenant isolation plane);
            # fanned out to every raylet via the jobs channel and pulled
            # by late-joining raylets through list_jobs
            "quotas": req.get("quotas") or None,
        }
        self._persist("jobs", job_id, self.jobs[job_id])
        await self.publish("jobs", {"event": "started", "job_id": job_id,
                                    "quotas": req.get("quotas") or None})
        return {"ok": True}

    async def rpc_finish_job(self, req):
        job_id = req["job_id"]
        job = self.jobs.get(job_id)
        if job:
            job["finished"] = True
            job["end_time"] = time.time()
            self._persist("jobs", job_id, job)
        # Tear down the job's non-detached actors, but not those a live
        # detached actor created (directly or through other such actors):
        # a Serve controller's replicas outlive the `serve-deploy` job
        # that started the controller. Their workers stay up too.
        survivors = self._job_survivors(job_id)
        for actor_id, info in list(self.actors.items()):
            if info["job_id"] == job_id and actor_id not in survivors \
                    and info["state"] != DEAD:
                await self._kill_actor(actor_id, "job finished")
        await export_events.report_async(
            "GCS", "INFO", "JOB_FINISHED",
            f"job {job_id.hex()[:8]} finished", job_id=job_id.hex())
        await self.publish("jobs", {
            "event": "finished", "job_id": job_id,
            "keep_workers": [self.actors[a]["addr"] for a in survivors
                             if self.actors[a].get("addr")]})
        return {"ok": True}

    def _job_survivors(self, job_id: bytes) -> set:
        """The live actors of `job_id` that outlive it: the detached ones
        and, transitively, those whose creator (the spec's owner worker)
        is one of them, in any incarnation: an owner that is restarting
        or came back on another worker still counts."""
        live = {a: info for a, info in self.actors.items()
                if info["job_id"] == job_id and info["state"] != DEAD}
        survivors = {a for a, info in live.items() if info.get("detached")}
        owners = {a: task_mod.TaskSpec.from_wire(info["spec"]).owner_worker_id
                  for a, info in live.items() if a not in survivors}
        while True:
            workers = {w for a in survivors
                       for w in live[a].get("worker_ids", ()) if w}
            grown = {a for a, owner in owners.items()
                     if a not in survivors and owner in workers}
            if not grown:
                return survivors
            survivors |= grown

    # ------------------------------------------------------------------
    # actors (GcsActorManager + GcsActorScheduler)
    # ------------------------------------------------------------------

    async def rpc_register_actor(self, req):
        spec = task_mod.TaskSpec.from_wire(req["spec"])
        actor_id = spec.actor_id
        if spec.actor_name:
            if spec.actor_name in self.named_actors:
                existing = self.named_actors[spec.actor_name]
                if self.actors[existing]["state"] != DEAD:
                    return {"ok": False,
                            "error": f"actor name taken: {spec.actor_name}"}
            self.named_actors[spec.actor_name] = actor_id
            self._persist("named_actors", spec.actor_name.encode(),
                          actor_id)
        self.actors[actor_id] = {
            "actor_id": actor_id,
            "job_id": spec.job_id,
            "name": spec.actor_name,
            "state": PENDING,
            "addr": None,
            "node_id": None,
            "spec": req["spec"],
            "max_restarts": spec.max_restarts,
            "num_restarts": 0,
            "detached": spec.detached,
            "death_cause": None,
            "class_name": spec.name,
        }
        self._persist("actors", actor_id, self.actors[actor_id])
        self._pending_actors.append(actor_id)
        self._retry_wakeup.set()
        return {"ok": True}

    async def _schedule_one(self, actor_id: bytes):
        try:
            done = await self._schedule_actor(actor_id)
        except Exception:
            logger.exception("actor scheduling error")
            done = False
        finally:
            self._scheduling_actors.discard(actor_id)
        if done and actor_id in self._pending_actors:
            self._pending_actors.remove(actor_id)

    async def _schedule_actor(self, actor_id: bytes) -> bool:
        info = self.actors.get(actor_id)
        if info is None or info["state"] not in (PENDING, RESTARTING):
            return True
        spec = task_mod.TaskSpec.from_wire(info["spec"])
        if spec.placement_group_id is not None:
            # PG-targeted actors are placed on the bundle's node.
            pg = self.placement_groups.get(spec.placement_group_id)
            if pg is None or pg["state"] != "CREATED":
                return False
            index = spec.bundle_index if spec.bundle_index >= 0 else 0
            node_id = pg["bundle_nodes"][index]
            node = next(
                (n for n in self.view.alive_nodes() if n.node_id == node_id),
                None,
            )
        else:
            node = pick_node(
                self.view, spec.resources, spec.strategy,
                target_node_id=spec.node_id,
                soft=spec.soft,
                spread_threshold=self.config.scheduler_spread_threshold,
            )
        if node is None:
            return False
        try:
            raylet = await self.clients.get(node.raylet_addr)
            lease = await raylet.call(
                "request_worker_lease",
                {"spec": info["spec"], "dedicated": True},
                timeout=60.0,
            )
        except (ConnectionLost, RpcError, OSError, asyncio.TimeoutError) as e:
            logger.warning("actor lease failed on %s: %s", node.raylet_addr, e)
            return False
        if not lease.get("granted"):
            return False
        worker_addr = lease["worker_addr"]
        try:
            worker = await self.clients.get(worker_addr)
            reply = await worker.call("push_task", {"spec": info["spec"]},
                                      timeout=300.0)
            if reply.get("error"):
                raise RpcError(reply["error_msg"])
        except (ConnectionLost, RpcError, OSError, asyncio.TimeoutError) as e:
            logger.warning("actor creation failed on %s: %s", worker_addr, e)
            info["death_cause"] = f"creation failed: {e}"
            info["state"] = DEAD
            # Release the dedicated lease and kill the contaminated worker,
            # or the node permanently loses those resources.
            try:
                await raylet.call("return_worker", {
                    "lease_id": lease["lease_id"],
                    "worker_dead": False,
                    "kill_worker": True,
                })
            except (ConnectionLost, RpcError, OSError):
                pass
            await self._publish_actor(actor_id)
            return True
        info["state"] = ALIVE
        info["addr"] = worker_addr
        info["node_id"] = node.node_id
        info["worker_id"] = lease.get("worker_id")
        # every incarnation's worker: the actors an earlier incarnation
        # created name it as their owner (`_job_survivors`)
        info.setdefault("worker_ids", []).append(info["worker_id"])
        await self._publish_actor(actor_id)
        return True

    async def _publish_actor(self, actor_id: bytes):
        info = self.actors[actor_id]
        # every actor state transition flows through here — the one
        # write-through hook actor durability needs
        self._persist("actors", actor_id, info)
        await self.publish("actors", {
            "actor_id": actor_id,
            "state": info["state"],
            "addr": info["addr"],
            "death_cause": info["death_cause"],
            "num_restarts": info["num_restarts"],
        })

    async def rpc_get_actor(self, req):
        actor_id = req.get("actor_id")
        if actor_id is None and req.get("name"):
            actor_id = self.named_actors.get(req["name"])
            if actor_id is None:
                return {"found": False}
        info = self.actors.get(actor_id)
        if info is None:
            return {"found": False}
        return {
            "found": True,
            "actor_id": actor_id,
            "state": info["state"],
            "addr": info["addr"],
            "spec": info["spec"],
            "death_cause": info["death_cause"],
            "num_restarts": info["num_restarts"],
            "name": info["name"],
            "class_name": info.get("class_name"),
        }

    async def rpc_list_actors(self, req):
        return [
            {
                "actor_id": a["actor_id"],
                "state": a["state"],
                "name": a["name"],
                "class_name": a.get("class_name"),
                "node_id": a.get("node_id"),
                "num_restarts": a["num_restarts"],
            }
            for a in self.actors.values()
        ]

    async def rpc_list_events(self, req):
        """Recent structured events, served from the GCS host's event
        dir (all daemons of a multi-node-on-one-machine cluster write
        there; remote-machine raylet events are not forwarded — same
        node-local scope as the reference's event agent). A short TTL
        cache bounds the re-read cost under dashboard polling."""
        now = time.time()
        cached = getattr(self, "_events_cache", None)
        if cached is not None and now - cached[0] < 2.0:
            return cached[1]
        merged = await asyncio.get_running_loop().run_in_executor(
            None, export_events.list_events)
        out = merged[-500:]
        self._events_cache = (now, out)
        return out

    async def rpc_list_jobs(self, req):
        return [
            {
                "job_id": jb["job_id"],
                "driver_addr": jb.get("driver_addr", ""),
                "start_time": jb.get("start_time"),
                "end_time": jb.get("end_time"),
                "finished": jb.get("finished", False),
                "quotas": jb.get("quotas"),
            }
            for jb in self.jobs.values()
        ]

    async def rpc_report_actor_death(self, req):
        await self._on_actor_failure(req["actor_id"], req.get("reason", "died"))
        return {"ok": True}

    async def _on_actor_failure(self, actor_id: bytes, reason: str):
        info = self.actors.get(actor_id)
        if info is None or info["state"] == DEAD:
            return
        restarts = info["max_restarts"]
        will_restart = restarts == -1 or info["num_restarts"] < restarts
        await export_events.report_async(
            "GCS", "WARNING",
            "ACTOR_RESTARTING" if will_restart else "ACTOR_DEAD",
            f"actor {actor_id.hex()[:8]} failed: {reason}",
            actor_id=actor_id.hex(), reason=reason,
            num_restarts=info["num_restarts"])
        if will_restart:
            info["num_restarts"] += 1
            info["state"] = RESTARTING
            info["addr"] = None
            await self._publish_actor(actor_id)
            self._pending_actors.append(actor_id)
            self._retry_wakeup.set()
        else:
            info["state"] = DEAD
            info["death_cause"] = reason
            info["addr"] = None
            await self._publish_actor(actor_id)

    async def _kill_actor(self, actor_id: bytes, reason: str):
        info = self.actors.get(actor_id)
        # a second kill of a dead actor (a controller reaping a replica
        # its driver killed) has no worker left to tell; the JAX GCS
        # dials the dead worker's address and waits out the connect
        if info is None or info["state"] == DEAD:
            return
        addr = info.get("addr")
        info["state"] = DEAD
        info["death_cause"] = reason
        info["max_restarts"] = 0
        if addr:
            # the exit notice goes out in the background: a worker whose
            # process already died (before its raylet reported it) has a
            # refused port, and the JAX GCS holds the kill for a whole
            # connect timeout (10 s) dialling it
            task = asyncio.ensure_future(self._notify_exit(
                addr, reason, info.get("worker_id")))
            self._exit_notices.add(task)
            task.add_done_callback(self._exit_notices.discard)
        await self._publish_actor(actor_id)

    async def _notify_exit(self, addr: str, reason: str, worker_id):
        try:
            worker = await self.clients.get(addr)
            # worker_id lets a virtual-worker raylet (which serves many
            # workers at one address) identify whose lease to release;
            # real workers ignore the extra field
            await worker.notify("exit_worker", {
                "reason": reason,
                "worker_id": worker_id,
            })
        except (ConnectionLost, OSError, RpcError):
            pass

    async def rpc_kill_actor(self, req):
        await self._kill_actor(req["actor_id"], req.get("reason", "ray.kill"))
        return {"ok": True}

    # ------------------------------------------------------------------
    # placement groups (GcsPlacementGroupManager)
    # ------------------------------------------------------------------

    async def rpc_create_placement_group(self, req):
        pg_id = req["pg_id"]
        self.placement_groups[pg_id] = {
            "pg_id": pg_id,
            "bundles": req["bundles"],
            "strategy": req["strategy"],
            "name": req.get("name"),
            "state": "PENDING",
            "bundle_nodes": [],
            "job_id": req.get("job_id"),
            # slice topology (labelled raylets): bundles gang-place
            # one-per-host onto a single complete slice, atomically
            "topology": req.get("topology"),
        }
        self._persist("placement_groups", pg_id,
                      self.placement_groups[pg_id])
        self._pending_pgs.append(pg_id)
        self._retry_wakeup.set()
        return {"ok": True}

    async def _schedule_pg(self, pg_id: bytes) -> bool:
        pg = self.placement_groups.get(pg_id)
        if pg is None or pg["state"] != "PENDING":
            return True
        if pg.get("topology"):
            placement = place_slice_bundles(self.view, pg["bundles"],
                                            pg["topology"])
        else:
            placement = place_bundles(self.view, pg["bundles"],
                                      pg["strategy"])
        if placement is None:
            return False
        # Two-phase commit: prepare on every raylet, then commit (reference:
        # GcsPlacementGroupScheduler prepare/commit protocol).
        prepared = []
        ok = True
        for index, (node, demand) in enumerate(zip(placement, pg["bundles"])):
            try:
                raylet = await self.clients.get(node.raylet_addr)
                reply = await raylet.call("prepare_bundle", {
                    "pg_id": pg_id, "bundle_index": index, "resources": demand,
                }, timeout=10.0)
                if not reply.get("ok"):
                    ok = False
                    break
                prepared.append((node, index))
            except (ConnectionLost, RpcError, OSError, asyncio.TimeoutError):
                ok = False
                break
        if not ok:
            for node, index in prepared:
                try:
                    raylet = await self.clients.get(node.raylet_addr)
                    await raylet.call("release_bundle",
                                      {"pg_id": pg_id, "bundle_index": index})
                except (ConnectionLost, RpcError, OSError):
                    pass
            return False
        for node, index in prepared:
            raylet = await self.clients.get(node.raylet_addr)
            await raylet.call("commit_bundle",
                              {"pg_id": pg_id, "bundle_index": index})
        pg["state"] = "CREATED"
        pg["bundle_nodes"] = [n.node_id for n in placement]
        self._persist("placement_groups", pg_id, pg)
        await self.publish("placement_groups", {
            "pg_id": pg_id, "state": "CREATED",
            "bundle_nodes": pg["bundle_nodes"],
        })
        return True

    async def rpc_get_placement_group(self, req):
        pg = self.placement_groups.get(req["pg_id"])
        if pg is None:
            return {"found": False}
        return {"found": True, **{k: v for k, v in pg.items()}}

    async def rpc_remove_placement_group(self, req):
        pg = self.placement_groups.get(req["pg_id"])
        if pg is None:
            return {"ok": True}
        for index, node_id in enumerate(pg.get("bundle_nodes", [])):
            node = self.nodes.get(node_id)
            if node and node["alive"]:
                try:
                    raylet = await self.clients.get(node["raylet_addr"])
                    await raylet.call(
                        "release_bundle",
                        {"pg_id": pg["pg_id"], "bundle_index": index},
                    )
                except (ConnectionLost, RpcError, OSError):
                    pass
        pg["state"] = "REMOVED"
        self._persist("placement_groups", pg["pg_id"], pg)
        await self.publish("placement_groups",
                           {"pg_id": pg["pg_id"], "state": "REMOVED"})
        return {"ok": True}

    # ------------------------------------------------------------------
    # pending-work retry loop (actor + PG scheduling)
    # ------------------------------------------------------------------

    async def _retry_loop(self):
        while True:
            try:
                await asyncio.wait_for(self._retry_wakeup.wait(), timeout=0.5)
            except asyncio.TimeoutError:
                pass
            self._retry_wakeup.clear()
            if self._pending_actors:
                # Dispatch concurrently: one slow actor __init__ must not
                # head-of-line block every other creation.
                for actor_id in list(self._pending_actors):
                    if actor_id in self._scheduling_actors:
                        continue
                    self._scheduling_actors.add(actor_id)
                    asyncio.ensure_future(self._schedule_one(actor_id))
            if self._pending_pgs:
                still_pgs: List[bytes] = []
                for pg_id in self._pending_pgs:
                    try:
                        done = await self._schedule_pg(pg_id)
                    except Exception:  # noqa: BLE001
                        # one malformed request must never kill the
                        # scheduler loop for the whole cluster
                        logger.exception("PG %s scheduling failed",
                                         pg_id.hex()[:8])
                        done = False
                    if not done:
                        still_pgs.append(pg_id)
                self._pending_pgs = still_pgs


async def main(host: str, port: int, metrics_port=None,
               daemonize: bool = False, persist_path=None,
               store_path=None):
    import os
    import signal

    _fi.set_role("gcs")  # arm gcs-scoped timed faults (offsets from now)
    # snapshot load is one-time startup I/O before the server accepts
    # its first connection — the loop has nothing else to run yet
    server = GcsServer(host, port, persist_path=persist_path,  # raylint: disable=async-blocking
                       store_path=store_path)
    await server.start(metrics_port=metrics_port)
    print(f"GCS_READY {server.address}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    loop.add_signal_handler(signal.SIGTERM, stop.set)
    loop.add_signal_handler(signal.SIGINT, stop.set)

    async def parent_watch():
        # Exit if the spawning driver dies (see raylet main's parent_watch).
        parent = os.getppid()
        while os.getppid() == parent:
            await asyncio.sleep(1.0)
        stop.set()

    if not daemonize:
        asyncio.ensure_future(parent_watch())
    await stop.wait()
    await server.stop()


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--metrics-port", type=int, default=None)
    parser.add_argument("--persist-path", default=None,
                        help="snapshot file for GCS fault tolerance")
    parser.add_argument("--store-path", default=None,
                        help="write-through StoreClient dir (file-per-"
                             "key Redis-role backend; fresher than "
                             "snapshots)")
    parser.add_argument("--log-file", default=None)
    parser.add_argument("--daemonize", action="store_true",
                        help="survive the launching process (CLI mode)")
    args = parser.parse_args()
    if args.log_file:
        logging.basicConfig(filename=args.log_file, level=logging.INFO)
    asyncio.run(main(args.host, args.port, args.metrics_port,
                     daemonize=args.daemonize,
                     persist_path=args.persist_path,
                     store_path=args.store_path))
