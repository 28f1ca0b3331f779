"""Cluster scheduling policies.

Reference: `src/ray/raylet/scheduling/policy/` — hybrid (pack until a
utilization threshold, then spread), spread, node-affinity, and
placement-group bundle policies, all over a cluster resource view synced from
heartbeats (the ray_syncer equivalent). Used by both raylets (task leases)
and the GCS (actor creation, placement-group bundle placement).
"""

from __future__ import annotations

import heapq
import random
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional

from ray_tpu_torch._private import fault_injection as _fi
from ray_tpu_torch._private import task as task_mod

# Placement tiebreaks draw from a dedicated stream, never the global
# `random` module: under RAY_TPU_CHAOS the stream comes from the
# FaultPlan's per-site seeded streams so the scheduling decision sequence
# replays identically with the fault schedule; without a plan it is an
# ordinary process-local stream.
_DEFAULT_RNG = random.Random()


class _SchedStats:
    """Process-wide scheduling counters (flight-recorder plane): plain
    integer increments on the decision path, exposed at scrape time via
    `metrics_text()` from the daemons' /metrics extra_text.

    `no_feasible` counts demands NO alive node could ever satisfy
    (total < demand everywhere — the autoscaler must add bigger nodes);
    `no_capacity` counts demands that fit some node's total but nothing
    RIGHT NOW (transiently full — more of the same nodes, or just wait).
    Conflating the two made the autoscaler size for phantom demand.
    """

    __slots__ = ("pick_calls", "no_feasible", "no_capacity",
                 "bundle_placements", "bundle_failures", "job_granted",
                 "job_deferred")

    def __init__(self):
        self.pick_calls = 0
        self.no_feasible = 0
        self.no_capacity = 0
        self.bundle_placements = 0
        self.bundle_failures = 0
        # per-job rows ({job=} labels in /metrics): leases granted in
        # fair-queue order, and dispatches deferred by admission control
        # because the job was over its cpu/memory quota
        self.job_granted: Dict[str, int] = {}
        self.job_deferred: Dict[str, int] = {}


SCHED_STATS = _SchedStats()


def metrics_text() -> str:
    s = SCHED_STATS
    lines = [
        "# TYPE scheduler_pick_node_total counter",
        f"scheduler_pick_node_total {s.pick_calls}",
        "# TYPE scheduler_no_feasible_total counter",
        f"scheduler_no_feasible_total {s.no_feasible}",
        "# TYPE scheduler_no_capacity_total counter",
        f"scheduler_no_capacity_total {s.no_capacity}",
        "# TYPE scheduler_bundle_placements_total counter",
        f"scheduler_bundle_placements_total {s.bundle_placements}",
        f"scheduler_bundle_failures_total {s.bundle_failures}",
    ]
    if s.job_granted:
        lines.append("# TYPE scheduler_job_granted_total counter")
        for job, n in sorted(s.job_granted.items()):
            lines.append(f'scheduler_job_granted_total{{job="{job}"}} {n}')
    if s.job_deferred:
        lines.append("# TYPE scheduler_job_deferred_total counter")
        for job, n in sorted(s.job_deferred.items()):
            lines.append(f'scheduler_job_deferred_total{{job="{job}"}} {n}')
    return "\n".join(lines) + "\n"


def _tiebreak_rng() -> random.Random:
    plan = _fi.plan()
    if plan is not None:
        return plan.rng_for("scheduling.tiebreak")
    return _DEFAULT_RNG


# ---------------------------------------------------------------------------
# per-job quotas + weighted-fair dispatch (multi-tenant isolation plane)
# ---------------------------------------------------------------------------


@dataclass
class JobQuota:
    """Per-job resource limits + fair-share weight, registered at job
    submission (`ray_tpu_torch.init(job_quotas=...)` → GCS `register_job` →
    every raylet via the jobs pubsub channel). Zero means unlimited for
    the quota fields; `weight` sets the job's share of contended
    dispatch (a weight-2 job drains twice as fast as a weight-1 job
    when both are backlogged)."""

    weight: float = 1.0
    cpu: float = 0.0
    memory: float = 0.0
    object_store_bytes: int = 0

    @classmethod
    def from_dict(cls, d: Dict) -> "JobQuota":
        return cls(
            weight=float(d.get("weight", 1.0) or 1.0),
            cpu=float(d.get("cpu", 0.0) or 0.0),
            memory=float(d.get("memory", 0.0) or 0.0),
            object_store_bytes=int(d.get("object_store_bytes", 0) or 0),
        )

    def to_dict(self) -> Dict:
        return {"weight": self.weight, "cpu": self.cpu,
                "memory": self.memory,
                "object_store_bytes": self.object_store_bytes}


_DEFAULT_QUOTA = JobQuota()
JOB_QUOTAS: Dict[bytes, JobQuota] = {}


def set_job_quota(job_id: bytes, quota: JobQuota) -> None:
    JOB_QUOTAS[job_id] = quota


def job_quota(job_id: bytes) -> JobQuota:
    return JOB_QUOTAS.get(job_id, _DEFAULT_QUOTA)


def job_label(job_id: bytes) -> str:
    """Short stable {job=} label for /metrics rows."""
    return job_id.hex()[:8] if job_id else "none"


class FairDispatchQueue:
    """Weighted-fair queue over per-job FIFO lanes.

    Replaces the raylet's FIFO `_pending` list: each job owns a lane,
    and contended dispatch drains lanes deficit-round-robin — every
    grant advances the job's virtual clock by `cost / weight`, and
    `fair_scan()` orders all queued items lowest-clock-first (the
    job with the largest accumulated deficit relative to its weight
    goes first). Long-run grant shares therefore track weights: a
    weight-4 lane drains 4× a weight-1 lane while both are backlogged,
    and within a lane FIFO order is preserved.

    A job (re)entering the queue is floored to the current backlogged
    minimum clock — or, when nothing is backlogged, to the highest
    clock ever charged — so idle time banks no credit in EITHER
    direction: an idle incumbent cannot burst on return, and a
    late-arriving job cannot claim catch-up service for time before it
    existed. Single-threaded like the raylet event loop — no internal
    locking.
    """

    def __init__(self, cost_of: Optional[Callable] = None,
                 weight_of: Optional[Callable] = None):
        self._lanes: Dict[bytes, deque] = {}
        self._vtime: Dict[bytes, float] = {}
        self._vmax = 0.0  # highest clock ever charged (idle-entry floor)
        self._cost_of = cost_of or (lambda item: 1.0)
        self._weight_of = weight_of or (
            lambda job: job_quota(job).weight)

    # -- list-compatible surface (the raylet's _pending call sites) ----

    def __len__(self) -> int:
        return sum(len(lane) for lane in self._lanes.values())

    def __bool__(self) -> bool:
        return any(self._lanes.values())

    def __iter__(self) -> Iterable:
        return iter(self.fair_scan())

    def __contains__(self, item) -> bool:
        return any(any(it is item for it in lane)
                   for lane in self._lanes.values())

    def push(self, job: bytes, item) -> None:
        lane = self._lanes.get(job)
        if lane is None:
            lane = self._lanes[job] = deque()
        if not lane:
            # joining the backlog: start at the backlogged frontier, or
            # at the global high-water clock when the queue is idle (a
            # brand-new job must not out-deficit an incumbent that
            # already drained its work)
            active = [self._vtime.get(j, 0.0)
                      for j, l in self._lanes.items() if l and j != job]
            floor = min(active) if active else self._vmax
            self._vtime[job] = max(self._vtime.get(job, 0.0), floor)
        lane.append(item)

    def remove(self, item) -> bool:
        """Remove by identity (leases are mutable dataclasses — equality
        would be both slow and wrong here)."""
        for job, lane in self._lanes.items():
            for i, it in enumerate(lane):
                if it is item:
                    del lane[i]
                    if not lane:
                        del self._lanes[job]
                    return True
        return False

    # -- fair order ----------------------------------------------------

    def fair_scan(self) -> List:
        """Every queued item in weighted-fair order. Pure simulation:
        the real per-job clocks only advance on `charge()` (an actual
        grant), so skipped items (deps not ready, node full) cost their
        job nothing."""
        heap = []
        pos: Dict[bytes, int] = {}
        for k, (job, lane) in enumerate(self._lanes.items()):
            if lane:
                heapq.heappush(heap, (self._vtime.get(job, 0.0), k, job))
                pos[job] = 0
        out: List = []
        while heap:
            v, k, job = heapq.heappop(heap)
            lane = self._lanes[job]
            item = lane[pos[job]]
            out.append(item)
            pos[job] += 1
            v += self._cost_of(item) / max(self._weight_of(job), 1e-9)
            if pos[job] < len(lane):
                heapq.heappush(heap, (v, k, job))
        return out

    def head(self, n: int) -> List:
        """First n items in fair order (heartbeat demand reporting)."""
        return self.fair_scan()[:n]

    def charge(self, job: bytes, item) -> None:
        """Commit a grant: advance the job's virtual clock and its
        {job=} grant counter."""
        w = max(self._weight_of(job), 1e-9)
        v = self._vtime.get(job, 0.0) + self._cost_of(item) / w
        self._vtime[job] = v
        if v > self._vmax:
            self._vmax = v
        label = job_label(job)
        SCHED_STATS.job_granted[label] = \
            SCHED_STATS.job_granted.get(label, 0) + 1

    def depths(self) -> Dict[str, int]:
        """Queue depth per job label (scheduler_queue_depth{job=})."""
        return {job_label(job): len(lane)
                for job, lane in self._lanes.items() if lane}


@dataclass
class NodeResources:
    node_id: bytes
    raylet_addr: str
    total: Dict[str, float] = field(default_factory=dict)
    available: Dict[str, float] = field(default_factory=dict)
    alive: bool = True
    labels: Dict[str, str] = field(default_factory=dict)

    def feasible(self, demand: Dict[str, float]) -> bool:
        return all(self.total.get(k, 0.0) >= v for k, v in demand.items() if v > 0)

    def fits_now(self, demand: Dict[str, float]) -> bool:
        return all(
            self.available.get(k, 0.0) >= v for k, v in demand.items() if v > 0
        )

    def utilization(self) -> float:
        parts = []
        for key, total in self.total.items():
            if total > 0:
                parts.append(1.0 - self.available.get(key, 0.0) / total)
        return max(parts) if parts else 0.0


class ClusterView:
    """A consistent snapshot of per-node resources, updated from heartbeats."""

    def __init__(self):
        self.nodes: Dict[bytes, NodeResources] = {}

    def update_node(self, node_id: bytes, raylet_addr: str,
                    total: Dict[str, float], available: Dict[str, float],
                    labels: Optional[Dict[str, str]] = None):
        node = self.nodes.get(node_id)
        if node is None:
            self.nodes[node_id] = NodeResources(
                node_id, raylet_addr, dict(total), dict(available),
                labels=dict(labels or {}),
            )
        else:
            node.total = dict(total)
            node.available = dict(available)
            node.raylet_addr = raylet_addr
            if labels is not None:
                node.labels = dict(labels)

    def remove_node(self, node_id: bytes):
        self.nodes.pop(node_id, None)

    def alive_nodes(self) -> List[NodeResources]:
        return [n for n in self.nodes.values() if n.alive]


def pick_node(
    view: ClusterView,
    spec_resources: Dict[str, float],
    strategy: str = task_mod.STRATEGY_DEFAULT,
    local_node_id: Optional[bytes] = None,
    target_node_id: Optional[bytes] = None,
    soft: bool = False,
    spread_threshold: float = 0.5,
    rng: random.Random | None = None,
) -> Optional[NodeResources]:
    """Select a node for a task/actor. Returns None if nothing is feasible
    right now (caller queues and retries when resources free up)."""
    SCHED_STATS.pick_calls += 1
    node = _pick_node_impl(view, spec_resources, strategy, local_node_id,
                           target_node_id, soft, spread_threshold, rng)
    if node is None:
        # Split the failure signal the autoscaler sizes from: a demand
        # some alive node could EVENTUALLY satisfy (total fits, just
        # busy now) is lack of capacity; a demand no node's total can
        # ever hold (or an empty cluster) is genuinely infeasible.
        if any(n.feasible(spec_resources) for n in view.alive_nodes()):
            SCHED_STATS.no_capacity += 1
        else:
            SCHED_STATS.no_feasible += 1
    return node


def _pick_node_impl(
    view: ClusterView,
    spec_resources: Dict[str, float],
    strategy: str,
    local_node_id: Optional[bytes],
    target_node_id: Optional[bytes],
    soft: bool,
    spread_threshold: float,
    rng: random.Random | None,
) -> Optional[NodeResources]:
    nodes = view.alive_nodes()
    if not nodes:
        return None

    if strategy == task_mod.STRATEGY_NODE_AFFINITY and target_node_id is not None:
        for n in nodes:
            if n.node_id == target_node_id:
                if n.fits_now(spec_resources):
                    return n
                return None if not soft else _best_fit(nodes, spec_resources)
        return _best_fit(nodes, spec_resources) if soft else None

    if strategy == task_mod.STRATEGY_SPREAD:
        fitting = [n for n in nodes if n.fits_now(spec_resources)]
        if not fitting:
            return None
        # Least-utilized first; random tiebreak for even spread.
        (rng or _tiebreak_rng()).shuffle(fitting)
        return min(fitting, key=lambda n: n.utilization())

    # DEFAULT hybrid policy: prefer the local node while it is under the
    # spread threshold, else pick the best (lowest-utilization) fitting node.
    local = None
    if local_node_id is not None:
        for n in nodes:
            if n.node_id == local_node_id:
                local = n
                break
    if (
        local is not None
        and local.fits_now(spec_resources)
        and local.utilization() <= spread_threshold
    ):
        return local
    return _best_fit(nodes, spec_resources, rng)


def _best_fit(nodes: List[NodeResources], demand: Dict[str, float],
              rng: random.Random | None = None):
    fitting = [n for n in nodes if n.fits_now(demand)]
    if not fitting:
        return None
    # Random tiebreak: min() on equal utilizations is stable, which
    # would pile every weightless placement (actors release their CPU
    # after creation, so utilization never rises between heartbeats)
    # onto whichever node happens to list first.
    (rng or _tiebreak_rng()).shuffle(fitting)
    return min(fitting, key=lambda n: n.utilization())


def place_bundles(
    view: ClusterView,
    bundles: List[Dict[str, float]],
    strategy: str,
) -> Optional[List[NodeResources]]:
    """Choose a node per bundle (reference: bundle_scheduling_policy.cc).

    PACK: minimize node count (best effort). STRICT_PACK: all on one node.
    SPREAD: prefer distinct nodes (best effort). STRICT_SPREAD: distinct
    nodes required. Returns None if infeasible (all-or-nothing).
    """
    placement = _place_bundles_impl(view, bundles, strategy)
    if placement is None:
        SCHED_STATS.bundle_failures += 1
    else:
        SCHED_STATS.bundle_placements += 1
    return placement


def _place_bundles_impl(
    view: ClusterView,
    bundles: List[Dict[str, float]],
    strategy: str,
) -> Optional[List[NodeResources]]:
    nodes = view.alive_nodes()
    remaining = {
        n.node_id: dict(n.available) for n in nodes
    }
    by_id = {n.node_id: n for n in nodes}

    def try_place(node_id: bytes, demand: Dict[str, float]) -> bool:
        avail = remaining[node_id]
        if all(avail.get(k, 0.0) >= v for k, v in demand.items() if v > 0):
            for k, v in demand.items():
                avail[k] = avail.get(k, 0.0) - v
            return True
        return False

    placement: List[NodeResources] = []

    if strategy in ("PACK", "STRICT_PACK"):
        order = sorted(nodes, key=lambda n: n.utilization())
        for demand in bundles:
            placed = False
            # Prefer nodes already used by earlier bundles.
            used_ids = [n.node_id for n in placement]
            candidates = used_ids + [
                n.node_id for n in order if n.node_id not in used_ids
            ]
            for node_id in candidates:
                if try_place(node_id, demand):
                    placement.append(by_id[node_id])
                    placed = True
                    break
            if not placed:
                return None
        if strategy == "STRICT_PACK" and len({n.node_id for n in placement}) > 1:
            return None
        return placement

    if strategy in ("SPREAD", "STRICT_SPREAD"):
        for demand in bundles:
            used_ids = {n.node_id for n in placement}
            fresh = [n for n in nodes if n.node_id not in used_ids]
            candidates = sorted(fresh, key=lambda n: n.utilization())
            if strategy == "SPREAD":
                candidates += sorted(
                    [n for n in nodes if n.node_id in used_ids],
                    key=lambda n: n.utilization(),
                )
            placed = False
            for node in candidates:
                if try_place(node.node_id, demand):
                    placement.append(node)
                    placed = True
                    break
            if not placed:
                return None
        return placement

    raise ValueError(f"unknown placement strategy: {strategy}")


def place_slice_bundles(
    view: ClusterView,
    bundles: List[Dict[str, float]],
    topology: str,
) -> Optional[List[NodeResources]]:
    """Atomically place one bundle per host of ONE accelerator slice.

    Slice extension of bundle_scheduling_policy: a slice is the set of
    raylets sharing `ray_tpu.slice_name` with `ray_tpu.slice_type ==
    topology`. A slice is eligible only when ALL of its hosts are alive
    and registered (the interconnect is slice-internal — a partial slice
    cannot form the mesh), the bundle count equals the host count, and
    every host fits its bundle. Bundle i lands on slice host i, so a
    process group's rank == bundle_index matches host order. All-or-nothing:
    returns None (caller keeps the PG pending) when no complete slice
    fits.
    """
    from ray_tpu_torch._private import accelerators as acc

    slices: Dict[str, List[NodeResources]] = {}
    for n in view.alive_nodes():
        if n.labels.get(acc.LABEL_SLICE_TYPE) != topology:
            continue
        name = n.labels.get(acc.LABEL_SLICE_NAME)
        if name is None:
            continue  # malformed registration — never poison scheduling
        slices.setdefault(name, []).append(n)

    candidates = []
    for name, hosts in slices.items():
        try:
            declared = int(
                hosts[0].labels.get(acc.LABEL_SLICE_NUM_HOSTS, "1"))
            by_host_id = sorted(
                hosts,
                key=lambda n: int(n.labels.get(acc.LABEL_SLICE_HOST_ID,
                                               "-1")))
            ids = [int(n.labels.get(acc.LABEL_SLICE_HOST_ID, "-1"))
                   for n in by_host_id]
        except ValueError:
            continue  # non-integer label values — skip the slice
        if len(hosts) != declared or len(bundles) != declared:
            continue
        if ids != list(range(declared)):
            continue  # duplicate/missing host ids — not a coherent slice
        if all(node.fits_now(demand)
               for node, demand in zip(by_host_id, bundles)):
            candidates.append(by_host_id)

    if not candidates:
        return None
    # least-loaded slice first (keep busy slices free for their tenants)
    return min(candidates,
               key=lambda hosts: max(n.utilization() for n in hosts))
