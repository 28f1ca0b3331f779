"""Driver-side runtime: init/shutdown/remote/get/put/wait + actor frontends.

Reference: `python/ray/_private/worker.py` (init/connect/get/put/wait),
`python/ray/remote_function.py` (RemoteFunction), `python/ray/actor.py`
(ActorClass/ActorHandle/ActorMethod).
"""

from __future__ import annotations

import atexit
import dataclasses
import functools
import inspect
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from ray_tpu_torch._private import task as task_mod
from ray_tpu_torch._private.config import Config, global_config
from ray_tpu_torch._private.core_worker import (
    ActorDiedError,
    CoreWorker,
    GetTimeoutError,
    RayTaskError,
    TaskCancelledError,
)
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, PlacementGroupID
from ray_tpu_torch._private.node import Cluster
from ray_tpu_torch._private.object_ref import ObjectRef, get_core_worker
from ray_tpu_torch._private.object_store import ObjectStore

_global_lock = threading.Lock()
_global_state: Optional["GlobalState"] = None
# env keys exported for _system_config (cleared on shutdown so one
# test's overrides never leak into the next cluster)
_exported_config_env: list = []
# A CLI-submitted driver finds its cluster through this variable. The
# JAX package reads RAY_TPU_ADDRESS: a driver of one package must never
# attach to the other package's cluster.
ADDRESS_ENV = "RAY_TPU_TORCH_ADDRESS"


class GlobalState:
    def __init__(self, cluster: Cluster | None, core_worker: CoreWorker,
                 owns_cluster: bool, client=None):
        self.cluster = cluster
        self.core_worker = core_worker
        self.owns_cluster = owns_cluster
        # Ray-Client mode: a ClientContext proxying every call to a
        # cluster-side ClientServer (reference: python/ray/util/client)
        self.client = client


def is_initialized() -> bool:
    return _global_state is not None


def _require_state() -> GlobalState:
    # Inside a worker process there is a process-global CoreWorker but no
    # GlobalState; fall back to it so tasks can call the public API.
    if _global_state is None:
        cw = get_core_worker()
        if cw is not None:
            return GlobalState(None, cw, owns_cluster=False)
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return _global_state


def init(
    address: str | None = None,
    num_cpus: int | None = None,
    num_gpus: int | None = None,
    resources: Dict[str, float] | None = None,
    object_store_memory: int | None = None,
    runtime_env: dict | None = None,
    job_quotas: dict | None = None,
    _system_config: dict | None = None,
    ignore_reinit_error: bool = False,
):
    """Start (or connect to) a ray_tpu_torch cluster and attach this driver.

    ``num_gpus`` sets the node's `GPU` resource; left out, the node
    advertises the CUDA devices it detects (`accelerators.num_local_gpus`).

    ``job_quotas`` registers this driver's job with the multi-tenant
    isolation plane: ``{"weight": 2.0, "cpu": 8.0, "memory": 2**30,
    "object_store_bytes": 256 * 2**20}`` — weight sets the job's share
    of contended dispatch; the quota fields (0/absent = unlimited) cap
    concurrently held CPU/memory and shm-store bytes (see README
    "Multi-tenancy")."""
    global _global_state
    with _global_lock:
        if _global_state is not None:
            if ignore_reinit_error:
                return _global_state
            raise RuntimeError("ray_tpu_torch.init() already called")
        # copy — mutating the cached global would leak overrides into
        # the next init() in this process after shutdown cleans the env
        cfg = dataclasses.replace(global_config())
        if _system_config:
            cfg.update(_system_config)
            # daemons (GCS/raylet/workers) are subprocesses reading
            # Config.from_env() — export the overrides so the whole
            # cluster, not just this driver, sees them
            from ray_tpu_torch._private.config import _ENV_PREFIX
            global _exported_config_env
            for k, v in _system_config.items():
                key = _ENV_PREFIX + k.upper()
                # always export: an explicit _system_config override beats
                # a pre-existing shell var (which the driver's own Config
                # already ignored via cfg.update) — otherwise driver and
                # daemons would run with different values. The prior value
                # is restored on shutdown.
                _exported_config_env.append((key, os.environ.get(key)))
                os.environ[key] = str(v)

        if address is None:
            # CLI-submitted drivers find their cluster through the env
            # (reference: RAY_ADDRESS)
            address = os.environ.get(ADDRESS_ENV) or None
        if address and (address.startswith("client://")
                        or address.startswith("ray://")):
            # thin remote driver: no local daemons, everything proxied.
            # Local-cluster knobs make no sense here — fail loudly
            # rather than silently ignoring them.
            unsupported = {
                "num_cpus": num_cpus, "num_gpus": num_gpus,
                "resources": resources,
                "object_store_memory": object_store_memory,
                "runtime_env": runtime_env,
                "_system_config": _system_config,
            }
            bad = [k for k, v in unsupported.items() if v is not None]
            if bad:
                raise ValueError(
                    f"init(address='client://...') does not accept "
                    f"{bad} — configure the cluster where the "
                    f"client-server runs")
            from ray_tpu_torch.util.client import ClientContext

            host_port = address.split("://", 1)[1]
            ctx = ClientContext(host_port)
            _global_state = GlobalState(None, None, owns_cluster=False,
                                        client=ctx)
            atexit.register(shutdown)
            return _global_state
        if address is None:
            node_resources = dict(resources or {})
            import os as _os
            node_resources.setdefault("CPU", float(num_cpus if num_cpus is not None
                                                   else (_os.cpu_count() or 1)))
            if num_gpus is not None:
                node_resources["GPU"] = float(num_gpus)
            else:
                node_resources.setdefault("GPU", float(_detect_gpus()))
            cluster = Cluster(
                head_resources=node_resources,
                object_store_memory=object_store_memory,
            )
            owns = True
            gcs_addr = cluster.gcs_addr
            head = cluster.head_node
            raylet_addr = head.raylet_addr
            store_name = head.store_name
            node_id_hex = head.node_id_hex
        else:
            cluster = None
            owns = False
            gcs_addr = address
            raylet_addr, store_name, node_id_hex = \
                _discover_local_raylet(address)

        job_id = JobID.from_random()
        store = ObjectStore.attach(store_name)
        cw = CoreWorker(
            mode="driver",
            gcs_addr=gcs_addr,
            raylet_addr=raylet_addr,
            job_id=job_id,
            store=store,
            node_id_hex=node_id_hex,
            config=cfg,
        )
        cw.start()
        cw._run_sync(cw.gcs.call("register_job", {
            "job_id": job_id.binary(),
            "driver_addr": cw.address,
            "quotas": dict(job_quotas) if job_quotas else None,
        }))
        if job_quotas:
            # the driver-local scheduler registry too: this process's
            # raylet learns via pubsub, but client-side bits (e.g. the
            # fair queue weight default) read the local registry
            from ray_tpu_torch._private import scheduling as _sched
            _sched.set_job_quota(job_id.binary(),
                                 _sched.JobQuota.from_dict(job_quotas))
        if runtime_env is not None:
            # job-level default applied to every task/actor without its
            # own runtime_env (reference: ray.init(runtime_env=...))
            from ray_tpu_torch._private import runtime_env as renv_mod

            cw.job_runtime_env = renv_mod.prepare(cw, runtime_env)
        _global_state = GlobalState(cluster, cw, owns)
        atexit.register(shutdown)
        return _global_state


def _detect_gpus() -> int:
    """CUDA device autodetection without importing torch (reference:
    python/ray/_private/accelerators/nvidia_gpu.py; see
    accelerators.num_local_gpus)."""
    from ray_tpu_torch._private import accelerators

    return accelerators.num_local_gpus()


def _discover_local_raylet(gcs_addr: str):
    import asyncio

    from ray_tpu_torch._private.rpc import RpcClient

    async def query():
        client = await RpcClient(gcs_addr).connect()
        nodes = await client.call("get_nodes", {})
        await client.close()
        alive = [n for n in nodes if n["alive"]]
        if not alive:
            raise RuntimeError("no alive nodes in cluster")
        import os as _os
        hostname = _os.uname().nodename
        for n in alive:
            if n.get("hostname") == hostname:
                return n
        return alive[0]

    node = asyncio.run(query())
    # Ask the raylet for its store name.
    async def info(addr):
        client = await RpcClient(addr).connect()
        reply = await client.call("node_info", {})
        await client.close()
        return reply

    reply = asyncio.run(info(node["raylet_addr"]))
    return (node["raylet_addr"], reply["store_name"],
            node["node_id"].hex() if isinstance(node.get("node_id"), bytes)
            else str(node.get("node_id", "")))


def shutdown():
    global _global_state
    with _global_lock:
        state = _global_state
        if state is None:
            return
        _global_state = None
        if state.client is not None:
            state.client.disconnect()
            return
        try:
            state.core_worker._run_sync(
                state.core_worker.gcs.call(
                    "finish_job",
                    {"job_id": state.core_worker.job_id.binary()},
                ),
                timeout=5,
            )
        except Exception:
            pass
        state.core_worker.shutdown()
        if state.owns_cluster and state.cluster is not None:
            state.cluster.shutdown()
        global _exported_config_env
        for key, prior in _exported_config_env:
            if prior is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = prior
        _exported_config_env = []


def put(value: Any) -> ObjectRef:
    state = _require_state()
    if state.client is not None:
        return state.client.put(value)
    return state.core_worker.put(value)


def get(refs, timeout: float | None = None):
    state = _require_state()
    if state.client is not None:
        return state.client.get(refs, timeout=timeout)
    return state.core_worker.get(refs, timeout)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: float | None = None):
    state = _require_state()
    if state.client is not None:
        return state.client.wait(refs, num_returns=num_returns,
                                 timeout=timeout)
    return state.core_worker.wait(refs, num_returns, timeout)


def kill(actor: "ActorHandle", *, no_restart: bool = True):
    state = _require_state()
    if state.client is not None:
        state.client.kill(actor, no_restart=no_restart)
        return
    state.core_worker.kill_actor(actor._actor_id, no_restart)


def cancel(ref, *, force: bool = False, recursive: bool = True):
    """Cancel the task producing `ref` (reference `ray.cancel`,
    `python/ray/_private/worker.py:2932`): a pending task is dequeued, a
    running one is interrupted at its executor, `force=True` kills the
    executing worker process, and `recursive=True` also cancels the
    task's children. Best-effort — a task that already finished is
    unaffected. `ray_tpu_torch.get` on a cancelled task raises
    TaskCancelledError."""
    state = _require_state()
    if state.client is not None:
        state.client.cancel(ref, force=force, recursive=recursive)
        return
    state.core_worker.cancel(ref, force=force, recursive=recursive)


# ----------------------------------------------------------------------
# @remote — tasks
# ----------------------------------------------------------------------

_OPTION_DEFAULTS = dict(
    num_cpus=None,
    num_gpus=None,
    resources=None,
    num_returns=1,
    max_retries=None,
    max_restarts=0,
    max_concurrency=1,
    concurrency_groups=None,
    name=None,
    lifetime=None,
    scheduling_strategy=None,
    placement_group=None,
    placement_group_bundle_index=-1,
    runtime_env=None,
)


def _prepared_runtime_env(holder, cw, opts):
    """Resolve + upload the runtime env once per RemoteFunction/ActorClass
    instance (content-addressed, so repeats are cheap anyway); falls back
    to the job-level default from init(runtime_env=...).

    A per-task/actor runtime_env inherits the job-level one field-wise
    (reference: `python/ray/_private/runtime_env/validation.py` — child
    fields override, `env_vars` merge key-wise), so e.g. Train workers
    that add env_vars keep the job's working_dir/pip."""
    renv = opts.get("runtime_env")
    job_env = getattr(cw, "job_runtime_env", None)
    if renv is None:
        return job_env
    cached = getattr(holder, "_prepared_env", None)
    if cached is None:
        from ray_tpu_torch._private import runtime_env as renv_mod

        cached = renv_mod.prepare(cw, renv)
        if job_env:
            # wire-level merge: job_env's paths are already uploaded
            # (content keys), so inheritance composes prepared forms
            cached = renv_mod.merge_wire(job_env, cached)
        holder._prepared_env = cached
    return cached


def _resource_dict(opts: dict, default_cpu: float) -> Dict[str, float]:
    resources = dict(opts.get("resources") or {})
    num_cpus = opts.get("num_cpus")
    num_gpus = opts.get("num_gpus")
    resources["CPU"] = float(num_cpus) if num_cpus is not None else default_cpu
    if num_gpus is not None:
        resources["GPU"] = float(num_gpus)
    return resources


def _strategy_fields(opts: dict):
    strategy = task_mod.STRATEGY_DEFAULT
    node_id = None
    soft = False
    pg_id = None
    bundle_index = opts.get("placement_group_bundle_index", -1)
    ss = opts.get("scheduling_strategy")
    if isinstance(ss, str) and ss == "SPREAD":
        strategy = task_mod.STRATEGY_SPREAD
    elif isinstance(ss, NodeAffinitySchedulingStrategy):
        strategy = task_mod.STRATEGY_NODE_AFFINITY
        node_id = bytes.fromhex(ss.node_id)
        soft = ss.soft
    elif isinstance(ss, PlacementGroupSchedulingStrategy):
        strategy = task_mod.STRATEGY_PLACEMENT_GROUP
        pg_id = ss.placement_group.id.binary()
        bundle_index = ss.placement_group_bundle_index
    pg = opts.get("placement_group")
    if pg is not None:
        strategy = task_mod.STRATEGY_PLACEMENT_GROUP
        pg_id = pg.id.binary()
    return strategy, node_id, soft, pg_id, bundle_index


def _client_options(opts: dict) -> dict:
    """Options forwarded to the cluster-side ClientServer: only
    non-default values; scheduling objects are not client-serializable
    yet (reference Ray Client has the same restriction surface)."""
    out = {}
    for k, v in opts.items():
        if v == _OPTION_DEFAULTS.get(k, None):
            continue
        if k in ("scheduling_strategy", "placement_group",
                 "placement_group_bundle_index"):
            raise ValueError(
                f"option {k!r} is not supported in client mode")
        if k == "num_returns" and v == "streaming":
            raise ValueError(
                "num_returns='streaming' is not supported in client mode")
        out[k] = v
    return out


class RemoteFunction:
    def __init__(self, fn, options: dict, function_key: bytes | None = None):
        self._fn = fn
        self._options = {**_OPTION_DEFAULTS, **options}
        self._function_key = function_key
        functools.update_wrapper(self, fn)

    def options(self, **opts) -> "RemoteFunction":
        return RemoteFunction(self._fn, {**self._options, **opts},
                              self._function_key)

    def _ensure_pushed(self, cw: CoreWorker) -> bytes:
        # Benign race: two threads may push the same function; the GCS KV
        # dedupes on the content hash (overwrite=False).
        if self._function_key is None:
            self._function_key = cw.push_function(self._fn)
        return self._function_key

    def __reduce__(self):
        # Remote functions captured in closures of other tasks must travel;
        # the function itself is cloudpickled by value (reference pickles
        # RemoteFunction the same way).
        return (RemoteFunction, (self._fn, self._options, self._function_key))

    def remote(self, *args, **kwargs):
        state = _require_state()
        if state.client is not None:
            # cache keyed by context: a shutdown/re-init must not reuse
            # a proxy bound to the old, disconnected session
            cached = getattr(self, "_client_fn", None)
            if cached is None or cached[0] is not state.client:
                cached = (state.client, state.client.remote(
                    self._fn, **_client_options(self._options)))
                self._client_fn = cached
            return cached[1].remote(*args, **kwargs)
        cw = state.core_worker
        key = self._ensure_pushed(cw)
        opts = self._options
        strategy, node_id, soft, pg_id, bundle_index = _strategy_fields(opts)
        streaming = opts["num_returns"] == "streaming"
        refs = cw.submit_task(
            key, args, kwargs,
            name=self._fn.__name__,
            num_returns=1 if streaming else opts["num_returns"],
            resources=_resource_dict(opts, default_cpu=1.0),
            max_retries=opts["max_retries"],
            strategy=strategy,
            node_id=node_id,
            soft=soft,
            placement_group_id=pg_id,
            bundle_index=bundle_index,
            streaming=streaming,
            runtime_env=_prepared_runtime_env(self, cw, opts),
        )
        if streaming:
            return refs  # an ObjectRefGenerator
        if opts["num_returns"] == 1:
            return refs[0]
        return refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._fn.__name__}' cannot be called directly; "
            f"use .remote()."
        )


# ----------------------------------------------------------------------
# @remote — actors
# ----------------------------------------------------------------------


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, num_returns=1,
                 concurrency_group: str = ""):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def options(self, num_returns=None,
                concurrency_group: str = "") -> "ActorMethod":
        # None/"" mean "keep": chained .options calls must compose, not
        # silently reset each other's fields
        return ActorMethod(
            self._handle, self._name,
            self._num_returns if num_returns is None else num_returns,
            concurrency_group or self._concurrency_group)

    def remote(self, *args, **kwargs):
        cw = _require_state().core_worker
        streaming = self._num_returns == "streaming"
        refs = cw.submit_actor_task(
            self._handle._actor_id, self._name, args, kwargs,
            num_returns=1 if streaming else self._num_returns,
            streaming=streaming,
            concurrency_group=self._concurrency_group,
        )
        if streaming:
            return refs  # an ObjectRefGenerator
        if self._num_returns == 1:
            return refs[0]
        return refs


class ActorHandle:
    def __init__(self, actor_id: ActorID):
        self._actor_id = actor_id

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __reduce__(self):
        return (_reconstruct_handle, (self._actor_id.binary(),))

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:16]})"


def _reconstruct_handle(actor_id_bytes: bytes) -> ActorHandle:
    return ActorHandle(ActorID(actor_id_bytes))


class ActorClass:
    def __init__(self, cls, options: dict, class_key: bytes | None = None):
        self._cls = cls
        self._options = {**_OPTION_DEFAULTS, **options}
        self._class_key = class_key

    def options(self, **opts) -> "ActorClass":
        return ActorClass(self._cls, {**self._options, **opts}, self._class_key)

    def __reduce__(self):
        return (ActorClass, (self._cls, self._options, self._class_key))

    def remote(self, *args, **kwargs) -> ActorHandle:
        state = _require_state()
        if state.client is not None:
            cached = getattr(self, "_client_cls", None)
            if cached is None or cached[0] is not state.client:
                cached = (state.client, state.client.remote(
                    self._cls, **_client_options(self._options)))
                self._client_cls = cached
            return cached[1].remote(*args, **kwargs)
        cw = state.core_worker
        if self._class_key is None:
            self._class_key = cw.push_function(self._cls)
        opts = self._options
        strategy, node_id, soft, pg_id, bundle_index = _strategy_fields(opts)
        actor_id = cw.create_actor(
            self._class_key, args, kwargs,
            name=self._cls.__name__,
            actor_name=opts["name"],
            resources=_resource_dict(opts, default_cpu=1.0),
            max_restarts=opts["max_restarts"],
            max_concurrency=opts["max_concurrency"],
            concurrency_groups=opts["concurrency_groups"],
            detached=(opts["lifetime"] == "detached"),
            strategy=strategy,
            node_id=node_id,
            soft=soft,
            placement_group_id=pg_id,
            bundle_index=bundle_index,
            runtime_env=_prepared_runtime_env(self, cw, opts),
        )
        return ActorHandle(actor_id)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self._cls.__name__}' cannot be instantiated "
            f"directly; use .remote()."
        )


def method(*, concurrency_group: str = ""):
    """`@ray_tpu_torch.method` on an actor method (reference `ray.method` +
    `concurrency_group_manager.h`): declares the named concurrency group
    the method runs in by default (callers can still override per call
    with `actor.m.options(concurrency_group=...)`). Multiple returns /
    streaming stay call-site options (`m.options(num_returns=...)`) —
    handles reconstruct from the actor id alone and carry no class
    metadata to read a declared default from."""

    def wrap(fn):
        if concurrency_group:
            fn.__ray_tpu_concurrency_group__ = concurrency_group
        return fn

    return wrap


def remote(*args, **kwargs):
    """`@remote` / `@remote(num_cpus=2, num_gpus=1, ...)` for functions and
    classes (reference: python/ray/__init__.py `ray.remote`)."""
    if len(args) == 1 and not kwargs and (
        inspect.isfunction(args[0]) or inspect.isclass(args[0])
    ):
        target = args[0]
        if inspect.isclass(target):
            return ActorClass(target, {})
        return RemoteFunction(target, {})

    def wrap(target):
        if inspect.isclass(target):
            return ActorClass(target, kwargs)
        return RemoteFunction(target, kwargs)

    return wrap


def get_actor(name: str) -> ActorHandle:
    state = _require_state()
    if state.client is not None:
        return state.client.get_actor(name)
    cw = state.core_worker
    reply = cw._run_sync(cw.gcs.call("get_actor", {"name": name}))
    # a dead actor's name is free again (reference: ray.get_actor raises
    # for it); the JAX package hands back the dead actor, so a Serve
    # restarted after `serve.shutdown()` found the killed controller
    if not reply.get("found") or reply.get("state") == "DEAD":
        raise ValueError(f"no actor named {name!r}")
    return ActorHandle(ActorID(reply["actor_id"]))


# ----------------------------------------------------------------------
# scheduling strategies + placement groups
# ----------------------------------------------------------------------


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft


class PlacementGroupSchedulingStrategy:
    def __init__(self, placement_group: "PlacementGroup",
                 placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]]):
        self.id = pg_id
        self.bundles = bundles

    def ready(self, timeout: float = 60.0) -> bool:
        cw = _require_state().core_worker
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            reply = cw._run_sync(cw.gcs.call(
                "get_placement_group", {"pg_id": self.id.binary()}
            ))
            if reply.get("found") and reply["state"] == "CREATED":
                return True
            if reply.get("found") and reply["state"] == "REMOVED":
                return False
            time.sleep(0.05)
        return False

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return self.bundles


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str | None = None,
                    topology: str | None = None) -> PlacementGroup:
    """Create a placement group.

    ``topology`` gang-places the bundles one-per-host onto a single
    complete GPU slice of that type (labelled raylets, e.g. from
    `Cluster.add_slice`), atomically —
    bundle i lands on slice host i (see scheduling.place_slice_bundles;
    reference convention: python/ray/_private/accelerators/tpu.py:363-388
    promoted into the scheduler).
    """
    cw = _require_state().core_worker
    pg_id = PlacementGroupID.from_random()
    cw._run_sync(cw.gcs.call("create_placement_group", {
        "pg_id": pg_id.binary(),
        "bundles": bundles,
        "strategy": strategy,
        "name": name,
        "job_id": cw.job_id.binary(),
        "topology": topology,
    }))
    return PlacementGroup(pg_id, bundles)


def remove_placement_group(pg: PlacementGroup):
    cw = _require_state().core_worker
    cw._run_sync(cw.gcs.call("remove_placement_group",
                             {"pg_id": pg.id.binary()}))


# ----------------------------------------------------------------------
# cluster introspection (reference: ray.nodes / cluster_resources)
# ----------------------------------------------------------------------


def nodes() -> List[dict]:
    cw = _require_state().core_worker
    raw = cw._run_sync(cw.gcs.call("get_nodes", {}))
    return [
        {
            "NodeID": n["node_id"].hex(),
            "Alive": n["alive"],
            "RayletAddr": n["raylet_addr"],
            "Resources": n["total"],
            "Available": n["available"],
        }
        for n in raw
    ]


def cluster_resources() -> Dict[str, float]:
    state = _require_state()
    if state.client is not None:
        return state.client.cluster_resources()
    totals: Dict[str, float] = {}
    for n in nodes():
        if n["Alive"]:
            for k, v in n["Resources"].items():
                totals[k] = totals.get(k, 0.0) + v
    return totals


def available_resources() -> Dict[str, float]:
    state = _require_state()
    if state.client is not None:
        return state.client.available_resources()
    totals: Dict[str, float] = {}
    for n in nodes():
        if n["Alive"]:
            for k, v in n["Available"].items():
                totals[k] = totals.get(k, 0.0) + v
    return totals


def list_actors() -> List[dict]:
    cw = _require_state().core_worker
    raw = cw._run_sync(cw.gcs.call("list_actors", {}))
    return [
        {
            "actor_id": a["actor_id"].hex(),
            "state": a["state"],
            "name": a["name"],
            "class_name": a.get("class_name"),
            "num_restarts": a["num_restarts"],
        }
        for a in raw
    ]
