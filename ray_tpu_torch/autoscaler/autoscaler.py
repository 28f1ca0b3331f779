"""Load-based autoscaler: reconcile cluster size against pending demand.

Reference: `python/ray/autoscaler/_private/autoscaler.py:172`
(StandardAutoscaler.update) and the v2 redesign
(`autoscaler/v2/instance_manager/reconciler.py`, bin-packing in
`v2/scheduler.py:624` ResourceDemandScheduler): each round reads demand
from the GCS (pending leases + pending placement groups), bin-packs the
unmet part onto hypothetical nodes of the configured types, launches the
difference through a NodeProvider, and retires provider-owned nodes that
have sat idle past the timeout.

Slice-first: a pending slice-topology placement group demands one whole
slice instance (`NodeType.slice_type`), never loose hosts — keeping
scale-up aligned with the scheduler's atomic gang placement.

The port's copy of `ray_tpu/autoscaler/autoscaler.py`, over the port's
`get_cluster_load` RPC. A slice is the port's GPU slice; a node type
that declares `{"GPU": n}` is launched for pending `num_gpus` demand.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.rpc import ClientPool
from ray_tpu_torch.autoscaler.node_provider import Instance, NodeProvider, NodeType

logger = logging.getLogger(__name__)


def _fits(avail: Dict[str, float], demand: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) >= v for k, v in demand.items() if v > 0)


def _consume(avail: Dict[str, float], demand: Dict[str, float]) -> None:
    for k, v in demand.items():
        avail[k] = avail.get(k, 0.0) - v


class Autoscaler:
    def __init__(self, gcs_addr: str, provider: NodeProvider,
                 node_types: List[NodeType],
                 max_workers: int = 8,
                 idle_timeout_s: float = 60.0,
                 update_interval_s: float = 2.0,
                 boot_timeout_s: float = 900.0):
        self.gcs_addr = gcs_addr
        self.provider = provider
        self.node_types = {t.name: t for t in node_types}
        self.max_workers = max_workers
        self.idle_timeout_s = idle_timeout_s
        self.update_interval_s = update_interval_s
        self.boot_timeout_s = boot_timeout_s
        self._clients = ClientPool()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # serializes reconcile rounds: the background loop and direct
        # update() callers (tests, drivers poking the scaler after a
        # fault) must not interleave a snapshot with another round's
        # provisioning — that is one half of the double-replacement bug
        self._reconcile_lock = threading.Lock()
        #: instance_id -> max host count ever seen registered; a drop
        #: below it means a host DIED (vs never booted) — the slice is
        #: broken, not booting
        self._seen_up: Dict[str, int] = {}
        #: instance_id -> first time this reconciler saw it; an instance
        #: that never fully registers within boot_timeout_s is broken
        #: (failed bootstrap) and must be replaced, not credited forever
        self._first_seen: Dict[str, float] = {}

    # -- one reconcile round (directly callable from tests) ------------

    def update(self) -> Dict[str, int]:
        """Run one reconcile round; returns {"launched": n, "terminated": m}."""
        with self._reconcile_lock:
            return asyncio.run(self._update_async())

    async def _update_async(self) -> Dict[str, int]:
        gcs = await self._clients.get(self.gcs_addr)
        load = await gcs.call("get_cluster_load", {}, timeout=30.0)
        launched = self._scale_up(load)
        terminated = self._scale_down(load)
        await self._clients.close_all()
        return {"launched": launched, "terminated": terminated}

    @staticmethod
    def _node_id(n: dict) -> str:
        nid = n["node_id"]
        return nid.hex() if isinstance(nid, bytes) else nid

    def _instance_hosts(self, inst: Instance, ntype: Optional[NodeType],
                        nodes: List[dict]) -> tuple:
        """(known host node-ids, expected host count) for an instance.

        Local/fake providers know their raylet ids up front; cloud
        providers (TPU queued resources) report none — their hosts are
        matched by the `autoscaler_instance` label each raylet registers
        with from its bootstrap script."""
        if inst.node_ids:
            return list(inst.node_ids), len(inst.node_ids)
        from ray_tpu_torch.autoscaler.gcp_tpu import INSTANCE_LABEL
        matched = [self._node_id(n) for n in nodes
                   if n.get("labels", {}).get(INSTANCE_LABEL)
                   == inst.instance_id]
        expected = ntype.num_hosts if ntype is not None else 1
        return matched, expected

    def _scale_up(self, load: dict) -> int:
        # hypothetical free capacity: registered nodes' availability...
        avail_pool = [dict(n["available"]) for n in load["nodes"]]
        registered = {self._node_id(n) for n in load["nodes"]}
        instances = self.provider.non_terminated_nodes()
        # ids at snapshot time — the staleness re-check before
        # provisioning compares against this set
        snapshot_ids = {i.instance_id for i in instances}
        # slice_type -> number of instances still booting: each booting
        # slice absorbs exactly ONE pending topology demand (a set here
        # would collapse N concurrently-provisioning slices into one and
        # relaunch every round for the rest)
        booting_slices: Dict[str, int] = {}
        inst_hosts: Dict[str, tuple] = {}
        for inst in list(instances):
            ntype = self.node_types.get(inst.node_type)
            hosts, expected = self._instance_hosts(inst, ntype,
                                                   load["nodes"])
            inst_hosts[inst.instance_id] = (hosts, expected)
            if ntype is None:
                continue
            up = sum(1 for nid in hosts if nid in registered)
            seen = self._seen_up.get(inst.instance_id, 0)
            first = self._first_seen.setdefault(inst.instance_id,
                                                time.monotonic())
            # lost-host check FIRST: a slice that fully booted and later
            # dropped a host is BROKEN, and must not be mis-diagnosed as
            # "never booted" merely because it outlived boot_timeout_s
            if up >= seen and up < expected and \
                    time.monotonic() - first > self.boot_timeout_s:
                # bootstrap never (fully) joined within the timeout: a
                # failed startup script would otherwise absorb its
                # demand as "booting" credit forever
                logger.warning(
                    "instance %s never fully booted (%d/%d hosts after "
                    "%.0fs); terminating", inst.instance_id, up,
                    expected, time.monotonic() - first)
                self.provider.terminate_node(inst)
                self._seen_up.pop(inst.instance_id, None)
                self._first_seen.pop(inst.instance_id, None)
                instances.remove(inst)
                inst_hosts.pop(inst.instance_id, None)
                continue
            if up < seen:
                # a previously-registered host died: the slice is
                # BROKEN, not booting. Terminate it so the gang's demand
                # relaunches a fresh slice instead of waiting forever on
                # phantom capacity (slices are atomic — a 15/16 slice
                # can't place its gang anyway).
                logger.warning(
                    "instance %s lost a host (%d -> %d of %d); "
                    "terminating the broken slice", inst.instance_id,
                    seen, up, expected)
                self.provider.terminate_node(inst)
                self._seen_up.pop(inst.instance_id, None)
                self._first_seen.pop(inst.instance_id, None)
                instances.remove(inst)
                inst_hosts.pop(inst.instance_id, None)
                continue
            self._seen_up[inst.instance_id] = max(seen, up)
            for _ in range(max(0, expected - up)):
                # ...plus launched-but-still-booting capacity: a
                # slow-booting real node must absorb the demand that
                # caused its launch, or every round re-launches for
                # the same pending work
                avail_pool.append(dict(ntype.resources))
            if ntype.slice_type and up < expected:
                booting_slices[ntype.slice_type] = \
                    booting_slices.get(ntype.slice_type, 0) + 1
        # prune terminated instances from the tracking memories
        live = {i.instance_id for i in instances}
        for d in (self._seen_up, self._first_seen):
            for iid in list(d):
                if iid not in live:
                    del d[iid]

        demands: List[Dict[str, float]] = list(load["pending"])
        slice_demands: List[str] = []
        for pg in load["pending_pgs"]:
            if pg.get("topology"):
                slice_demands.append(pg["topology"])
            else:
                demands.extend(pg["bundles"])

        # caps are counted in HOSTS, globally and per type (reusing the
        # per-instance resolution computed above)
        host_count = sum(exp for _h, exp in inst_hosts.values())
        type_counts: Dict[str, int] = {}
        for inst in instances:
            type_counts[inst.node_type] = \
                type_counts.get(inst.node_type, 0) + 1
        planned_launches: List[NodeType] = []

        def may_launch(ntype: NodeType) -> bool:
            return (host_count + ntype.num_hosts <= self.max_workers
                    and type_counts.get(ntype.name, 0) <
                    ntype.max_workers)

        def record_launch(ntype: NodeType):
            nonlocal host_count
            host_count += ntype.num_hosts
            type_counts[ntype.name] = type_counts.get(ntype.name, 0) + 1

        # slice-topology PGs demand whole slice instances, atomically
        for topology in slice_demands:
            if booting_slices.get(topology, 0) > 0:
                booting_slices[topology] -= 1
                continue  # a slice for this demand is already booting
            ntype = next(
                (t for t in self.node_types.values()
                 if t.slice_type == topology), None)
            if ntype is None:
                logger.warning("no node type provides slice %s", topology)
                continue
            if not may_launch(ntype):
                continue
            logger.info("scaling up: slice %s (%d hosts)", topology,
                        ntype.num_hosts)
            planned_launches.append(ntype)
            record_launch(ntype)

        # bin-pack loose demands largest-first (reference:
        # ResourceDemandScheduler's utilization-based packing)
        demands.sort(key=lambda d: -sum(d.values()))
        planned: List[Dict[str, float]] = []
        planned_types: List[NodeType] = []
        for demand in demands:
            placed = False
            for avail in avail_pool + planned:
                if _fits(avail, demand):
                    _consume(avail, demand)
                    placed = True
                    break
            if placed:
                continue
            ntype = self._smallest_fitting_type(demand)
            if ntype is None:
                logger.warning("demand %s fits no node type", demand)
                continue
            if not may_launch(ntype):
                continue
            fresh = dict(ntype.resources)
            _consume(fresh, demand)
            planned.append(fresh)
            planned_types.append(ntype)
            record_launch(ntype)
            logger.info("scaling up: %s %s", ntype.name, ntype.resources)
            planned_launches.append(ntype)
        return self._provision(planned_launches, snapshot_ids)

    def _provision(self, planned: List[NodeType],
                   snapshot_ids: set) -> int:
        """Launch the planned nodes, after a STALENESS RE-CHECK on the
        provider listing: the plan was computed from a snapshot, and a
        node that joined since (a concurrent recovery path replacing a
        node killed mid-poll, an operator's manual launch) must absorb a
        planned launch of its type instead of being doubled. Without
        this, a kill landing between snapshot and provisioning is
        replaced twice — once by whoever reacted first and once by this
        round's stale plan (the controller pattern: re-validate state
        immediately before acting on it)."""
        if not planned:
            return 0
        fresh_counts: Dict[str, int] = {}
        for inst in self.provider.non_terminated_nodes():
            if inst.instance_id not in snapshot_ids:
                fresh_counts[inst.node_type] = \
                    fresh_counts.get(inst.node_type, 0) + 1
        launched = 0
        for ntype in planned:
            if fresh_counts.get(ntype.name, 0) > 0:
                fresh_counts[ntype.name] -= 1
                logger.info(
                    "skipping launch of %s: an instance of that type "
                    "appeared since the demand snapshot", ntype.name)
                continue
            self.provider.create_node(ntype)
            launched += ntype.num_hosts if ntype.slice_type else 1
        return launched

    def _smallest_fitting_type(self, demand: Dict[str, float]
                               ) -> Optional[NodeType]:
        fitting = [
            t for t in self.node_types.values()
            if t.slice_type is None and _fits(dict(t.resources), demand)
        ]
        if not fitting:
            return None
        return min(fitting, key=lambda t: sum(t.resources.values()))

    def _scale_down(self, load: dict) -> int:
        # any pending work keeps every node: the next round may pack it
        # onto a currently-idle node
        if load["pending"] or load["pending_pgs"]:
            return 0
        idle_ids = {
            n["node_id"].hex() if isinstance(n["node_id"], bytes)
            else n["node_id"]
            for n in load["nodes"]
            if n["idle_duration_s"] >= self.idle_timeout_s
        }
        terminated = 0
        for inst in list(self.provider.non_terminated_nodes()):
            ntype = self.node_types.get(inst.node_type)
            hosts, expected = self._instance_hosts(inst, ntype,
                                                   load["nodes"])
            # slices retire atomically: only when fully booted AND every
            # host is idle (a still-provisioning instance has work coming)
            if len(hosts) == expected and \
                    all(nid in idle_ids for nid in hosts):
                logger.info("scaling down idle instance %s",
                            inst.instance_id)
                self.provider.terminate_node(inst)
                terminated += len(hosts)
        return terminated

    # -- background loop ----------------------------------------------

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="autoscaler")
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            try:
                self.update()
            except Exception:  # noqa: BLE001
                logger.exception("autoscaler round failed")
            self._stop.wait(self.update_interval_s)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
