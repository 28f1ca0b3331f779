"""Lazy task/actor DAGs with a compiled execution path.

Reference: `python/ray/dag/` — `.bind()` builds a lazy `DAGNode` graph
(`dag_node.py`), `dag.execute()` walks it submitting tasks with upstream
ObjectRefs as arguments, and `experimental_compile` lowers repeated
executions onto pre-allocated channels (`compiled_dag_node.py:291`,
mutable plasma + NCCL). Arbitrary graphs compile: fan-out (one producer,
many consumers), fan-in (multi-arg methods), shared nodes, and
`MultiOutputNode` — the same surface the reference's accelerated DAGs
support for e.g. pipeline-parallel actor graphs.

The port's compiled path for tensors: a chain of pure-torch stages
(`torch_stage`, where the JAX package has `jax_stage` and fuses the
chain into one jitted function) fuses into ONE `compiled_step`
(`ray_tpu_torch/parallel/compile_cache.py`): on the card the chain is
one CUDA graph, its intermediates in the graph's memory pool; on the
CPU it runs eagerly. Actor graphs lower onto seqlock shm channels
(`ray_tpu_torch/experimental/channel.py`): one channel per EDGE, so a
fan-out producer writes each consumer's channel and a fan-in consumer
reads one channel per argument.

Differences from the JAX package's fused path, kept on purpose:

- the root input is not donated. A graph captures a donated argument by
  address and refuses the next call's new tensor, so the graph copies
  the input into its static buffer instead (what XLA's donation bought,
  intermediates that never leave the device, the graph's pool gives);
- `execute()` returns a copy of the graph's outputs. A graph's outputs
  are static tensors that the next replay overwrites, where `jax.jit`
  returns a fresh array;
- there is no fallback: a chain on a CUDA input whose capture fails
  raises (`compiled_step`'s error), and never runs the lazy path.

Every frame on a channel carries a raw header ``(tag, seq, length)``
followed by the pickled payload, where ``seq`` is the driver's
execution counter: after a timeout the driver simply bumps the counter
and readers discard stale frames — from the header alone, without
deserializing the payload — so a slow execution can never
desynchronize the pipeline into returning a previous result. Payloads
are serialized once per value into a reusable per-edge scratch buffer
and memcpy'd into each consumer edge (`FrameScratch`,
ray_tpu_torch/experimental/channel.py): the steady-state hot loop does no
tuple pickling and no per-call allocation.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import ray_tpu_torch
from ray_tpu_torch.util import tracing as _tracing
from ray_tpu_torch.util.metrics import Histogram

# Flight-recorder plane: end-to-end latency of compiled-DAG executions
# over the channel plane. Constructed ONCE at import (constructing a
# metric per call leaks registry entries — raylint `metric-in-hot-loop`).
_DAG_EXECUTE_SECONDS = Histogram(
    "compiled_dag_execute_seconds",
    "compiled-DAG execute round-trip over the channel plane",
    boundaries=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                0.025, 0.1))


class DAGNode:
    """One lazy call; `execute()` materializes the whole upstream graph
    (reference `dag_node.py`)."""

    def __init__(self, fn_or_method, args: tuple, kwargs: dict):
        self._fn = fn_or_method
        self._args = args
        self._kwargs = kwargs

    def execute(self, *root_args) -> Any:
        """Submit every node once, upstream first; returns the final
        ObjectRef. `InputNode` placeholders bind to root_args."""
        cache: Dict[int, Any] = {}
        return self._execute(cache, root_args)

    def _execute(self, cache: Dict[int, Any], root_args: tuple):
        if id(self) in cache:
            return cache[id(self)]

        def resolve(v):
            if isinstance(v, DAGNode):
                return v._execute(cache, root_args)
            if isinstance(v, InputNode):
                return v.pick(root_args)
            return v

        args = tuple(resolve(a) for a in self._args)
        kwargs = {k: resolve(v) for k, v in self._kwargs.items()}
        ref = self._fn.remote(*args, **kwargs)
        cache[id(self)] = ref
        return ref

    def experimental_compile(self, *, submit_timeout: float = 60.0,
                             capacity: int = 8 << 20) -> "CompiledDAG":
        return CompiledDAG(self, submit_timeout=submit_timeout,
                           capacity=capacity)


class InputNode:
    """Placeholder for execute()-time arguments (reference
    `input_node.py`). `InputNode()` is the whole tuple's first element;
    `InputNode(i)` picks position i."""

    def __init__(self, index: int = 0):
        self._index = index

    def pick(self, root_args: tuple):
        return root_args[self._index]


class MultiOutputNode:
    """Marks several DAG leaves as the graph's outputs (reference
    `python/ray/dag/output_node.py`): `execute()` returns a list of
    refs, the compiled form returns a list of values."""

    def __init__(self, nodes: Sequence[DAGNode]):
        self._nodes = list(nodes)

    def execute(self, *root_args) -> List[Any]:
        cache: Dict[int, Any] = {}
        return [n._execute(cache, root_args) for n in self._nodes]

    def experimental_compile(self, *, submit_timeout: float = 60.0,
                             capacity: int = 8 << 20) -> "CompiledDAG":
        return CompiledDAG(self, submit_timeout=submit_timeout,
                           capacity=capacity)


def bind(remote_fn, *args, **kwargs) -> DAGNode:
    """fn.bind(...) equivalent for this framework's RemoteFunction /
    ActorMethod objects."""
    return DAGNode(remote_fn, args, kwargs)


class CompiledDAG:
    """Repeat-execution form, lowered by graph shape:

    - a linear chain of pure-torch stages (`torch_stage`) fuses into
      ONE `compiled_step`: one CUDA graph on the card, eager on the CPU
      (module docstring: no donation, copied outputs, no fallback);
    - a graph of ACTOR METHOD calls — any fan-out/fan-in/diamond shape,
      including `MultiOutputNode` — lowers onto pre-allocated
      shared-memory channels between the actor processes (reference
      aDAG: `compiled_dag_node.py:291`,
      `python/ray/experimental/channel/shared_memory_channel.py`): one
      channel per edge, one pump thread per actor executing its nodes
      in topological order, NO per-call task submission;
    - anything else falls back to cached lazy execution.
    """

    def __init__(self, dag, *, submit_timeout: float = 60.0,
                 capacity: int = 8 << 20):
        self._dag = dag
        self._fused = None
        self._channels = None
        self._seq = 0
        self._timeout = submit_timeout
        if isinstance(dag, DAGNode):
            torch_fns = self._extract_pure_torch_chain(dag)
            if torch_fns is not None:
                from ray_tpu_torch.parallel.compile_cache import \
                    compiled_step

                def fused(x):
                    for fn in torch_fns:
                        x = fn(x)
                    return x

                # the input is copied into the graph's static buffer, not
                # donated: a donated leaf is captured by address and the
                # next execute's tensor would be refused
                self._fused = compiled_step(fused)
                return
        plan = self._extract_actor_graph(dag)
        if plan is not None:
            try:
                self._setup_channels(plan, capacity)
            except Exception:
                self.teardown()
                raise

    # -- graph extraction --------------------------------------------------

    @staticmethod
    def _extract_actor_graph(dag):
        """Topologically-ordered plan for a graph whose every node is an
        actor-method call with positional args only. Returns None when
        any node doesn't fit (the lazy path still runs it)."""
        from ray_tpu_torch._private.worker_api import ActorMethod

        outputs = dag._nodes if isinstance(dag, MultiOutputNode) else [dag]
        if not outputs or not all(isinstance(n, DAGNode) for n in outputs):
            return None
        order: List[DAGNode] = []
        seen: Dict[int, bool] = {}

        def visit(node: DAGNode):
            if id(node) in seen:
                if not seen[id(node)]:
                    raise ValueError("cycle in DAG")
                return True
            seen[id(node)] = False
            if not isinstance(node._fn, ActorMethod) or node._kwargs:
                return False
            if not any(isinstance(a, (DAGNode, InputNode))
                       for a in node._args):
                # an all-constant node has no execution trigger on the
                # channel plane — leave such graphs to the lazy path
                return False
            for a in node._args:
                if isinstance(a, DAGNode) and not visit(a):
                    return False
            seen[id(node)] = True
            order.append(node)
            return True

        for out in outputs:
            if not visit(out):
                return None
        return {"order": order, "outputs": outputs}

    def _setup_channels(self, plan, capacity: int):
        """Allocate one channel per edge and install each actor's pump.

        Edges: driver -> node (InputNode args), node -> node (DAGNode
        args; a producer consumed by k nodes writes k channels), and
        output node -> driver. The install call attaches the channels
        inside each actor — an actor on another node fails here, loudly,
        at compile time (shm channels are same-node; the cross-node
        story is the jitted path where ICI moves arrays)."""
        from ray_tpu_torch._private.worker_api import ActorMethod
        from ray_tpu_torch.experimental.channel import FrameScratch, ShmChannel

        order: List[DAGNode] = plan["order"]
        outputs: List[DAGNode] = plan["outputs"]
        # self._channels from the first allocation on: a mid-setup
        # failure (ENOSPC on /dev/shm, wrong-node actor at install) must
        # reach teardown(), or the already-created segments leak until
        # reboot
        channels: List[ShmChannel] = []
        self._channels = channels
        names = iter(range(1 << 30))

        def new_channel() -> Tuple[str, ShmChannel]:
            name = ShmChannel.make_name(next(names))
            ch = ShmChannel.create(name, capacity)
            channels.append(ch)
            return name, ch

        # per-node stage descriptor + the out-channel lists (filled as
        # consumers claim their input edges)
        descs: Dict[int, dict] = {}
        for node in order:
            descs[id(node)] = {
                "method": node._fn._name,
                "nargs": len(node._args),
                "ins": [],     # (argpos, channel name)
                "consts": [],  # (argpos, value)
                "outs": [],    # channel names
            }
        self._input_channels: List[Tuple[int, ShmChannel]] = []
        self._input_scratch: Dict[int, FrameScratch] = {}
        for node in order:
            d = descs[id(node)]
            for pos, a in enumerate(node._args):
                if isinstance(a, DAGNode):
                    name, _ch = new_channel()
                    descs[id(a)]["outs"].append(name)
                    d["ins"].append((pos, name))
                elif isinstance(a, InputNode):
                    name, ch = new_channel()
                    self._input_channels.append((a._index, ch))
                    self._input_scratch.setdefault(a._index, FrameScratch())
                    d["ins"].append((pos, name))
                else:
                    d["consts"].append((pos, a))
        self._output_channels: List[ShmChannel] = []
        for node in outputs:
            name, ch = new_channel()
            descs[id(node)]["outs"].append(name)
            self._output_channels.append(ch)
        self._single_output = not isinstance(self._dag, MultiOutputNode)

        # group stages by hosting actor, preserving topological order
        by_actor: Dict[bytes, dict] = {}
        for node in order:
            handle = node._fn._handle
            ent = by_actor.setdefault(
                handle._actor_id.binary(),
                {"handle": handle, "stages": []})
            ent["stages"].append(descs[id(node)])

        acks = [
            ActorMethod(ent["handle"], "__ray_tpu_channel_graph__").remote(
                ent["stages"])
            for ent in by_actor.values()
        ]
        got = ray_tpu_torch.get(acks, timeout=60)
        if got != ["started"] * len(by_actor):
            raise RuntimeError(
                f"channel-graph install returned {got!r}")

    def teardown(self):
        """Shut the channels down; stage threads exit at their next
        read/write and the shm segments are unlinked. A fused chain's
        graph and its memory pool are released."""
        if self._fused is not None:
            from ray_tpu_torch.parallel.compile_cache import global_cache

            global_cache().evict(self._fused)
            self._fused = None
        if self._channels:
            for ch in self._channels:
                ch.signal_shutdown()
            for ch in self._channels:
                ch.destroy()
                ch.close()
            self._channels = None

    def __del__(self):
        try:
            self.teardown()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    @staticmethod
    def _extract_pure_torch_chain(dag: DAGNode) -> Optional[List]:
        """A linear chain of nodes marked `_torch_pure_fn` (via
        `ray_tpu_torch.dag.torch_stage`) compiles into one
        `compiled_step`."""
        chain: List = []
        node: Any = dag
        while isinstance(node, DAGNode):
            fn = getattr(node._fn, "_torch_pure_fn", None)
            if fn is None or node._kwargs or len(node._args) != 1:
                return None
            chain.append(fn)
            node = node._args[0]
        if not isinstance(node, InputNode):
            return None
        chain.reverse()
        return chain

    def execute(self, *root_args, timeout: Optional[float] = None):
        """Run one execution of the compiled graph.

        ``timeout`` bounds the channel path (driver write + output
        read). On the fused path it is IGNORED: the whole chain is one
        graph replay with no cancellation point, so there is nothing to
        time out. The fused path returns a copy of the graph's outputs
        (the next replay overwrites them); its work is queued on the
        current stream, as any torch call's. The lazy fallback forwards
        the timeout to ``ray_tpu_torch.get``.
        """
        if self._fused is not None:
            return _copy_tensors(self._fused(*root_args))
        if self._channels is not None:
            return self._execute_channels(root_args, timeout)
        out = self._dag.execute(*root_args)
        return ray_tpu_torch.get(out, timeout=timeout)

    def _execute_channels(self, root_args: tuple,
                          timeout: Optional[float]):
        import pickle
        import time

        from ray_tpu_torch.experimental.channel import (TAG_ERR, TAG_OK,
                                                  note_stale_skip)

        timeout = self._timeout if timeout is None else timeout
        self._seq += 1
        seq = self._seq
        deadline = time.monotonic() + timeout
        t_start = time.perf_counter()
        traced = _tracing.enabled()
        views: Dict[int, memoryview] = {}
        for idx, ch in self._input_channels:
            # one serialization per distinct input index, reused for
            # every consumer edge (zero-copy memcpy per edge)
            view = views.get(idx)
            if view is None:
                view = views[idx] = self._input_scratch[idx].pack(
                    root_args[idx])
            if traced:
                # producer half of the cross-process hop arrow: the
                # frame header has no room for a trace ctx, so both
                # sides carry flow_id=<channel>:<seq> and to_chrome
                # stitches the arrow at merge time
                with _tracing.span(
                        "channel.write", kind="producer",
                        attrs={"channel": ch._name, "seq": seq,
                               "flow_id": f"{ch._name}:{seq}"}):
                    ch.write_frame(
                        TAG_OK, seq, view,
                        timeout=max(0.0, deadline - time.monotonic()))
            else:
                ch.write_frame(
                    TAG_OK, seq, view,
                    timeout=max(0.0, deadline - time.monotonic()))
        results = []
        for ch in self._output_channels:
            while True:
                tag, s, payload = ch.read_frame(
                    timeout=max(0.0, deadline - time.monotonic()))
                if s == seq:
                    break
                # stale frame from an execution the driver timed out
                # on: release the slot straight from the header — the
                # payload is never deserialized
                ch.release_frame()
                note_stale_skip()
            if traced:
                with _tracing.span(
                        "channel.read", kind="consumer",
                        attrs={"channel": ch._name, "seq": seq,
                               "flow_id": f"{ch._name}:{seq}"}):
                    pass
            try:
                value = pickle.loads(payload)
            finally:
                del payload
                ch.release_frame()
            if tag == TAG_ERR:
                raise ray_tpu_torch.RayTaskError(
                    f"compiled DAG stage failed:\n{value}")
            results.append(value)
        _DAG_EXECUTE_SECONDS.observe(time.perf_counter() - t_start)
        return results[0] if self._single_output else results


def _copy_tensors(tree):
    """`tree` with every tensor leaf cloned."""
    import torch

    from ray_tpu_torch.parallel.compile_cache import _tree_map

    return _tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def torch_stage(fn):
    """Mark a remote function as a pure torch stage eligible for compiled
    fusion: calls still work as ordinary remote tasks, and compiled DAGs
    fuse consecutive stages into one `compiled_step` (one CUDA graph on
    the card)."""
    remote_fn = ray_tpu_torch.remote(fn) if not hasattr(fn, "remote") else fn
    remote_fn._torch_pure_fn = fn if not hasattr(fn, "remote") \
        else fn._fn  # unwrap RemoteFunction
    return remote_fn
