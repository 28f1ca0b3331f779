"""ServeController: reconciles declarative deployment specs into replicas.

Reference: `python/ray/serve/_private/controller.py:86` (ServeController),
`deployment_state.py:1226` (DeploymentState reconciliation),
`autoscaling_state.py:262` (request-rate autoscaling decisions). The
controller is a detached named actor; a reconcile loop (long-running actor
call) diffs desired vs live replicas, restarts dead ones, and resizes
autoscaled deployments from polled replica metrics.

Concurrency: the controller actor runs with max_concurrency > 1 (the
control loop occupies one slot forever), so all state mutation happens
under one lock — but the lock only ever guards *state*, never I/O. Every
blocking operation (replica spawn, get_metrics polls, kills) runs outside
the critical section on a snapshot, and the mutation is committed
afterwards under the lock with a staleness check (the deployment may have
been deleted or replaced while the RPCs were in flight). raylint's
blocking-under-lock checker gates this property.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.serve import dispatch as _dispatch
from ray_tpu_torch.util import metrics as _metrics

logger = logging.getLogger(__name__)
from ray_tpu_torch.serve.deployment import (AutoscalingConfig,
                                            DeploymentConfig)
from ray_tpu_torch.serve.replica import Replica

CONTROLLER_NAME = "SERVE_CONTROLLER"


class _DeploymentState:
    def __init__(self, name: str, func_or_class, init_args, init_kwargs,
                 config: DeploymentConfig, route_prefix: Optional[str]):
        self.name = name
        self.func_or_class = func_or_class
        self.init_args = init_args
        self.init_kwargs = init_kwargs
        self.config = config
        self.route_prefix = route_prefix
        self.target_replicas = (
            config.autoscaling_config.min_replicas
            if config.autoscaling_config else config.num_replicas)
        self.replicas: List[Any] = []
        self.version = 0
        # True while one caller is spawning replicas outside the lock —
        # keeps a concurrent reconcile tick from double-provisioning
        self.scaling = False
        # autoscaling: scale only after the condition holds continuously
        # for the configured delay (reference autoscaling semantics)
        self.upscale_pending_since: Optional[float] = None
        self.downscale_pending_since: Optional[float] = None
        # last replica-set version mirrored into the dispatch plane
        # (native snapshot publish + router wake FIFO)
        self.dispatch_synced = -1


class ServeController:
    def __init__(self):
        self._deployments: Dict[str, _DeploymentState] = {}
        self._replica_cls = ray_tpu_torch.remote(Replica)
        self._running = True
        self._lock = threading.RLock()
        # Replicas removed from routing but still finishing in-flight
        # requests: (replica, kill deadline). Reference: graceful replica
        # shutdown in `deployment_state.py` (stop routing → drain → kill).
        self._draining: List[Tuple[Any, float]] = []
        # proxy actors registered by the driver that started them — the
        # controller kills them on shutdown so a CLI-issued shutdown
        # from another process tears the whole instance down
        self._proxies: List[Any] = []
        # last-known get_metrics payload per replica (keyed by actor
        # identity): a replica that dies between polls is reclaimed from
        # this cache — e.g. its serve.llm KV arena (kv_arena_id) is
        # force-deleted from the node's shm store so the dead process's
        # pages don't leak until eviction pressure
        self._replica_metrics: Dict[int, Dict[str, Any]] = {}
        # spawn timestamps (actor identity -> monotonic): a replica that
        # has never answered a poll gets a startup grace window
        # (RAY_TPU_SERVE_STARTUP_GRACE_S) before an unresponsive poll
        # counts as death — long warmups (serve.llm AOT compiles) must
        # not be reaped mid-__init__
        self._replica_spawned: Dict[int, float] = {}
        self._reclaimed_arenas: List[str] = []
        self._arenas_reclaimed_total = 0
        # dispatch plane v2: per-deployment native segments (created on
        # first sync when RAY_TPU_NATIVE_DISPATCH=1), router-wake FIFOs
        # (posted on EVERY version bump, native or not), and the set of
        # replica keys already told to attach their drain loops
        self._rings: Dict[str, Any] = {}
        self._router_wakes: Dict[str, Any] = {}
        self._ring_attached: Dict[str, set] = {}
        _metrics.DEFAULT_REGISTRY.register_callback(
            "serve_controller", self._metrics_text)

    # -- API ---------------------------------------------------------------

    def deploy(self, name: str, func_or_class, init_args, init_kwargs,
               config: DeploymentConfig,
               route_prefix: Optional[str]) -> None:
        with self._lock:
            if route_prefix:
                for other, st_o in self._deployments.items():
                    if other != name and st_o.route_prefix == route_prefix:
                        raise ValueError(
                            f"route_prefix {route_prefix!r} already used "
                            f"by deployment {other!r}")
            existing = self._deployments.get(name)
            st = _DeploymentState(name, func_or_class, init_args,
                                  init_kwargs, config, route_prefix)
            if existing is not None:
                st.version = existing.version + 1
                # Old replicas leave routing now (the bumped version makes
                # routers drop them) but keep serving in-flight requests
                # until drained — no hard cutover failures.
                self._start_drain_locked(
                    existing.replicas,
                    existing.config.graceful_shutdown_timeout_s)
            self._deployments[name] = st
        # replica spawn is RPC — always outside the lock
        self._scale_to_target(name, st)
        self._sync_dispatch(name, st)

    def delete_deployment(self, name: str) -> None:
        with self._lock:
            st = self._deployments.pop(name, None)
            victims = list(st.replicas) if st else []
        for r in victims:
            self._kill(r)
        self._teardown_dispatch(name)

    def get_replicas(self, name: str) -> Dict[str, Any]:
        with self._lock:
            st = self._deployments.get(name)
            if st is None:
                return {"version": -1, "replicas": []}
            return {"version": st.version, "replicas": list(st.replicas)}

    def list_deployments(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {
                name: {
                    "num_replicas": len(st.replicas),
                    "target_replicas": st.target_replicas,
                    "route_prefix": st.route_prefix,
                    "version": st.version,
                }
                for name, st in self._deployments.items()
            }

    def get_routes(self) -> Dict[str, str]:
        with self._lock:
            return {st.route_prefix: name
                    for name, st in self._deployments.items()
                    if st.route_prefix}

    def register_proxy(self, proxy) -> None:
        """Track a proxy actor so shutdown reaches it from ANY process
        (reference: the controller owns proxy lifecycle — a CLI-issued
        shutdown must kill proxies started by some other driver)."""
        with self._lock:
            self._proxies.append(proxy)

    def shutdown(self) -> None:
        self._running = False
        with self._lock:
            victims: List[Any] = []
            for st in self._deployments.values():
                victims.extend(st.replicas)
            self._deployments.clear()
            victims.extend(r for r, _ in self._draining)
            self._draining = []
            victims.extend(self._proxies)
            self._proxies = []
        for v in victims:
            self._kill(v)
        for name in list(self._rings) + list(self._router_wakes):
            self._teardown_dispatch(name)

    # -- reconciliation ----------------------------------------------------

    def run_control_loop(self, period_s: float = 0.5,
                         max_iters: int = 0) -> None:
        """Long-running reconcile loop (invoked fire-and-forget by
        serve.run; needs controller max_concurrency > 1)."""
        iters = 0
        while self._running:
            self.reconcile_now()
            iters += 1
            if max_iters and iters >= max_iters:
                return
            time.sleep(period_s)

    def _start_drain_locked(self, replicas: List[Any],
                            timeout_s: float) -> None:
        """Move replicas into the draining set. Caller holds self._lock."""
        deadline = time.monotonic() + max(timeout_s, 0.0)
        self._draining.extend((r, deadline) for r in replicas)

    def _process_draining(self) -> None:
        with self._lock:
            entries, self._draining = self._draining, []
        keep: List[Tuple[Any, float]] = []
        victims: List[Any] = []
        now = time.monotonic()
        # One concurrent poll round, same shape as _poll_replicas.
        polls = [(r, deadline, r.get_metrics.remote())
                 for r, deadline in entries if now < deadline]
        victims.extend(r for r, deadline in entries if now >= deadline)
        for r, deadline, ref in polls:
            try:
                m = ray_tpu_torch.get(ref, timeout=10)
                if m["ongoing"] <= 0:
                    victims.append(r)
                else:
                    keep.append((r, deadline))
            except Exception:
                victims.append(r)
        stranded: List[Any] = []
        with self._lock:
            self._draining = keep + self._draining
            if not self._running:
                # shutdown() ran while we were polling: nothing will call
                # this again, so don't strand the survivors.
                stranded = [r for r, _ in self._draining]
                self._draining = []
        for r in victims + stranded:
            self._kill(r)

    def reconcile_now(self) -> None:
        self._process_draining()
        with self._lock:
            names = list(self._deployments)
        for name in names:
            with self._lock:
                st = self._deployments.get(name)
                replicas = list(st.replicas) if st is not None else []
            if st is None:
                continue
            try:
                # liveness + load polls on the snapshot, outside the lock
                alive, dead, slow, total_load, polled = \
                    self._poll_replicas(replicas)
                # unresponsive-but-present replicas: a replica that has
                # answered a poll before and now times out is hung —
                # treat as dead. One that has NEVER answered is likely
                # still constructing (serve.llm warmup compiles every
                # decode/prefill/verify shape before start); give it a
                # startup grace window before concluding it's wedged.
                now = time.monotonic()
                grace = float(os.environ.get(
                    "RAY_TPU_SERVE_STARTUP_GRACE_S", "60"))
                with self._lock:
                    for r in slow:
                        # unknown spawn time -> 0.0: an untracked slow
                        # replica is killable, never immortal
                        born = self._replica_spawned.get(id(r), 0.0)
                        if id(r) in self._replica_metrics or \
                                now - born > grace:
                            dead.append(r)
                for r in dead:
                    self._kill(r)
                    self._reclaim_dead_replica(r)
                with self._lock:
                    self._replica_metrics.update(polled)
                    for r in dead:
                        self._replica_metrics.pop(id(r), None)
                        self._replica_spawned.pop(id(r), None)
                    if self._deployments.get(name) is not st:
                        continue  # deleted/replaced while polling
                    dead_ids = {id(r) for r in dead}
                    st.replicas = [r for r in st.replicas
                                   if id(r) not in dead_ids]
                    self._autoscale(st, total_load)
                self._scale_to_target(name, st)
                self._sync_dispatch(name, st)
            except Exception:
                pass

    @staticmethod
    def _poll_replicas(replicas: List[Any]
                       ) -> Tuple[List[Any], List[Any], List[Any], float,
                                  Dict[int, Dict[str, Any]]]:
        """One concurrent get_metrics round over a snapshot: liveness +
        load in one RPC. Returns (alive, dead, slow, total_load, metrics
        by replica identity); total_load folds deployment-reported queue
        depth (serve.llm engine backlog) into the ongoing count so
        autoscaling sees queued work, not just dispatched work. `dead`
        holds replicas whose actor is GONE (kill + reclaim immediately);
        `slow` holds replicas that exist but didn't answer in time — the
        caller decides whether that's a hung replica (kill) or one still
        warming up (a serve.llm replica compiling its decode/verify fns
        can't answer until __init__ returns). Never called with a lock
        held."""
        refs = [(r, r.get_metrics.remote()) for r in replicas]
        alive: List[Any] = []
        dead: List[Any] = []
        slow: List[Any] = []
        total_load = 0.0
        polled: Dict[int, Dict[str, Any]] = {}
        for r, ref in refs:
            try:
                m = ray_tpu_torch.get(ref, timeout=10)
                alive.append(r)
                total_load += m["ongoing"] + \
                    float(m.get("queue_depth", 0))
                polled[id(r)] = m
            except ray_tpu_torch.ActorDiedError:
                dead.append(r)
            except Exception:
                slow.append(r)
        return alive, dead, slow, total_load, polled

    def _reclaim_dead_replica(self, replica: Any) -> None:
        """Release node-side resources a dead replica can no longer
        release itself, using its last polled metrics. Today: the
        serve.llm KV arena (the dead process never dropped its creator
        reference on the shm allocation). Single-node semantics — the
        arena lives in this node's store; a multi-node controller would
        route the delete through the owning raylet."""
        with self._lock:
            m = self._replica_metrics.pop(id(replica), None)
        arena = (m or {}).get("kv_arena_id")
        if not arena:
            return
        try:
            from ray_tpu_torch.serve.llm.kv_cache import reclaim_arena
            if reclaim_arena(arena):
                logger.warning(
                    "reclaimed KV arena %s from dead replica", arena)
                with self._lock:
                    self._reclaimed_arenas.append(arena)
                    self._arenas_reclaimed_total += 1
        except Exception:
            pass

    def get_reclaimed_arenas(self) -> List[str]:
        with self._lock:
            return list(self._reclaimed_arenas)

    # -- dispatch plane v2 -------------------------------------------------

    def _router_wake(self, name: str):
        with self._lock:
            w = self._router_wakes.get(name)
            if w is None:
                w = _dispatch._Wakeup(_dispatch.router_wake_path(name))
                self._router_wakes[name] = w
            return w

    @staticmethod
    def _request_tokens(st: _DeploymentState) -> Optional[int]:
        """The longest prompt the deployment's replicas accept, from its
        own config at deploy time (None: it serves no LLM). A deployment
        class that serves prompts says so with a `max_request_tokens(
        init_args, init_kwargs)` static method (`LLMDeployment`)."""
        hook = getattr(st.func_or_class, "max_request_tokens", None)
        if not callable(hook):
            return None
        return hook(st.init_args, st.init_kwargs)

    def _ring_for(self, name: str, st: _DeploymentState):
        """The deployment's native segment, created on first use with
        the controller-owned geometry (handles attach-only): request
        slots sized for the longest prompt its model accepts."""
        with self._lock:
            ring = self._rings.get(name)
        if ring is not None:
            return ring
        ring = _dispatch.DispatchRing(
            _dispatch.domain_segment(name), table_cap=16,
            slots=_dispatch.ring_slots(),
            slot_bytes=_dispatch.request_slot_bytes(
                self._request_tokens(st)))
        with self._lock:
            existing = self._rings.setdefault(name, ring)
        if existing is not ring:
            ring.close()
            return existing
        return ring

    def _sync_dispatch(self, name: str, st: _DeploymentState) -> None:
        """Mirror a replica-set version bump into the dispatch plane:
        publish `{version, replica cookies}` into the native segment
        (seqlock write, lock-free reads) and tell newly-started replicas
        to attach their drain loops; then post the router-wake FIFO so
        empty-parked choosers re-read NOW instead of on their next poll
        slice. The FIFO post happens with or without the native library.
        Never called with the lock held across an RPC."""
        with self._lock:
            if self._deployments.get(name) is not st:
                return
            version = st.version
            if version == st.dispatch_synced:
                return
            replicas = list(st.replicas)
        if _dispatch.native_available():
            try:
                ring = self._ring_for(name, st)
                cookies = [_dispatch.replica_cookie(r) for r in replicas]
                # geometry cap: replicas beyond the table serve via the
                # Python path only (logged once per deployment by size)
                cookies = cookies[:ring.table_cap]
                ring.publish(version, cookies)
                with self._lock:
                    attached = self._ring_attached.setdefault(name, set())
                    todo = [
                        (r, c) for r, c in zip(replicas, cookies)
                        if _dispatch.replica_key(r) not in attached]
                    for r, _c in todo:
                        attached.add(_dispatch.replica_key(r))
                for r, cookie in todo:  # fire-and-forget attach RPCs
                    try:
                        r.attach_dispatch.remote(
                            _dispatch.domain_segment(name), cookie, name)
                    except Exception:
                        pass
            except Exception:
                logger.warning("dispatch publish failed for %r", name,
                               exc_info=True)
        self._router_wake(name).post()
        with self._lock:
            if self._deployments.get(name) is st:
                st.dispatch_synced = version

    def _teardown_dispatch(self, name: str) -> None:
        with self._lock:
            ring = self._rings.pop(name, None)
            wake = self._router_wakes.pop(name, None)
            self._ring_attached.pop(name, None)
        if ring is not None:
            try:
                ring.close(unlink=True)
            except Exception:
                pass
        if wake is not None:
            # wake parked routers one last time (they will observe the
            # deployment gone), then remove the FIFO
            try:
                wake.post()
                wake.close(unlink=True)
            except Exception:
                pass

    def _metrics_text(self) -> str:
        with self._lock:
            reclaimed = self._arenas_reclaimed_total
            deployments = len(self._deployments)
            draining = len(self._draining)
            rings = dict(self._rings)
        out = "\n".join([
            "# TYPE serve_llm_arenas_reclaimed_total counter",
            f"serve_llm_arenas_reclaimed_total {reclaimed}",
            "# TYPE serve_controller_deployments gauge",
            f"serve_controller_deployments {deployments}",
            "# TYPE serve_controller_draining_replicas gauge",
            f"serve_controller_draining_replicas {draining}",
        ]) + "\n"
        # dispatch plane v2: native-ring counters join the same scrape
        for name, ring in rings.items():
            try:
                out += ring.metrics_text(name)
            except Exception:
                pass
        return out

    def _scale_to_target(self, name: str, st: _DeploymentState) -> None:
        """Converge replica count to st.target_replicas. State deltas are
        computed and committed under the lock; the spawns themselves (RPC)
        happen outside it, guarded by st.scaling so concurrent callers
        can't double-provision."""
        with self._lock:
            if self._deployments.get(name) is not st or st.scaling:
                return
            excess: List[Any] = []
            while len(st.replicas) > st.target_replicas:
                excess.append(st.replicas.pop())
            if excess:
                self._start_drain_locked(
                    excess, st.config.graceful_shutdown_timeout_s)
                st.version += 1
            to_start = st.target_replicas - len(st.replicas)
            if to_start <= 0:
                return
            st.scaling = True
            opts = dict(st.config.ray_actor_options or {})
            # reserve slots beyond user requests so control RPCs
            # (get_metrics) still answer when the replica is saturated
            opts.setdefault("max_concurrency",
                            st.config.max_ongoing_requests + 2)
        started: List[Any] = []
        try:
            for _ in range(to_start):
                started.append(self._replica_cls.options(**opts).remote(
                    st.func_or_class, st.init_args, st.init_kwargs,
                    st.config.user_config))
        finally:
            orphans: List[Any] = []
            with self._lock:
                st.scaling = False
                now = time.monotonic()
                for r in started:
                    self._replica_spawned[id(r)] = now
                if self._deployments.get(name) is st:
                    if started:
                        st.replicas.extend(started)
                        st.version += 1
                else:
                    # deployment deleted/replaced mid-spawn: the new
                    # replicas belong to nobody
                    orphans = started
            for r in orphans:
                self._kill(r)

    def _autoscale(self, st: _DeploymentState,
                   total_ongoing: float) -> None:
        asc: Optional[AutoscalingConfig] = st.config.autoscaling_config
        if asc is None or not st.replicas:
            return
        desired = math.ceil(total_ongoing / asc.target_ongoing_requests) \
            if asc.target_ongoing_requests > 0 else asc.min_replicas
        desired = max(asc.min_replicas, min(asc.max_replicas, desired))
        now = time.monotonic()
        if desired > st.target_replicas:
            st.downscale_pending_since = None
            if st.upscale_pending_since is None:
                st.upscale_pending_since = now
            if now - st.upscale_pending_since >= asc.upscale_delay_s:
                st.target_replicas = desired
                st.upscale_pending_since = None
        elif desired < st.target_replicas:
            st.upscale_pending_since = None
            if st.downscale_pending_since is None:
                st.downscale_pending_since = now
            if now - st.downscale_pending_since >= asc.downscale_delay_s:
                st.target_replicas = desired
                st.downscale_pending_since = None
        else:
            st.upscale_pending_since = None
            st.downscale_pending_since = None

    @staticmethod
    def _kill(replica) -> None:
        try:
            ray_tpu_torch.kill(replica)
        except Exception:
            pass
