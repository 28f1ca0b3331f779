"""Compiled-step cache (one CUDA graph per abstract call signature) and
multi-step dispatch folding.

Port of `ray_tpu/parallel/compile_cache.py`. There ``compiled_step``
keys a process-wide cache of AOT executables on the arguments' abstract
signature (treedef + avals) and counts hits, misses and retraces; a
steady-state call is one executable dispatch. PyTorch runs eagerly, and
the counterpart of an executable with static shapes is a captured CUDA
graph, so the port keys the same way (the structure of the arguments,
then shape, dtype and device of every tensor leaf, the value of every
other leaf and of every ``static_argnums`` argument) plus the caller's
autograd mode (grad enabled, inference mode), and holds per key:

* on a CUDA device, a ``torch.cuda.CUDAGraph``. The first call with a
  key runs the function once eagerly on static input tensors, under the
  caller's autograd mode, and returns what that run returned: the miss
  IS the call, so a function that updates state in place (an optimizer
  step) advances exactly once. The eager run also pays the first-use
  costs (the kernel build, ``cudaFuncSetAttribute``, library handles,
  allocator growth, tables the function caches, optimizer state). Then
  the function is captured, which launches nothing, into static outputs
  in the memory pool given as ``pool`` (graphs that never run at the
  same time may share one: ``torch.cuda.graph_pool_handle()``; by
  default each graph has its own), and the miss is counted. A later
  call copies its tensor inputs into the static inputs (host tensors
  through a pinned staging buffer, ``non_blocking``), replays the graph
  on the current stream and returns the static outputs, which THE NEXT
  REPLAY OVERWRITES: a caller consumes or clones them first. One eager
  run is the only warm-up; no extra warm-up step is taken. Autograd
  work is captured whole, as PyTorch's whole-network recipe does it:
  forward, ``loss.backward()`` and ``optimizer.step()`` in one graph,
  with ``torch.optim.AdamW(..., capturable=True)`` and gradients set to
  ``None`` before the capture, so the backward allocates them in the
  graph's pool. There is no eager fallback: a capture that fails (a host
  sync such as ``.item()`` inside the function, a data-dependent shape)
  raises, and since the eager run before it was the call and took
  effect, the error says so and carries that run's result as
  ``.result``; a retry runs eagerly once more and raises again. What a
  model knows a graph cannot replay (dropout masks) it rejects before
  the eager run, while `graphing()` is true.
* on the CPU, the eager function itself: the keys, counters and retrace
  rule are the same, so CPU runs exercise the whole cache logic.

``live_argnums`` (the port's own) names arguments that the graph reads
and writes in place (a KV arena): they are captured by address, never
copied, and a call that passes another storage (``data_ptr``) raises
instead of replaying on stale memory. Weights live in the function's
module and are captured by address the same way.

``donate_argnums`` (JAX's) are captured by address as live arguments
are. A donated argument is paired with the output of the same tree
structure and leaf shapes and dtypes (the whole output, else one of the
top-level entries of a tuple or list output: the carry of
``step_fn(carry, batch) -> (carry, aux)``); XLA pairs donated buffers the
same way, by shape and dtype. An output leaf that is the donated tensor
itself (an in-place update) costs nothing; an output leaf that is a new
tensor is copied back into the donated storage at the end of the call,
inside the graph. The call returns the donated storages in the paired
output's place, so a caller that feeds the returned carry into the next
call passes the captured addresses. As in JAX, after the call the
donated input is not the caller's to reuse; the returned carry is. A
donated argument with no paired output is only captured by address. On
the CPU donation has no effect.

``mesh`` (a `parallel.mesh.Mesh`) is part of the key, as in the JAX
cache: its axis names and sizes and its ranks. A sharded step is a
function over this rank's local shards whose collectives run over the
mesh's process groups (`parallel.collectives`); on the card they are
issued on the current stream and captured into the graph with the rest
of the step (NCCL), and a replay runs them again. A collective that
cannot be captured (gloo) fails the capture, which raises as any other.

Kernel launch counters (`ray_tpu_torch.ops.LAUNCH_COUNTERS`) keep
meaning kernel executions: the eager run counts what it launches; a
wrapper adds to its count while the graph is captured, where nothing
runs, so the capture's additions are taken back and each replay credits
them again.

A retrace is a miss for a function that already has a signature: it
warns, or raises `RetraceError` under ``on_retrace="error"``, exactly as
the JAX cache does (a new autograd mode alone is a miss, not a retrace).
The global cache holds its entries until ``ExecutableCache.evict(fn)``
or ``clear()``; a graph holds its static buffers and pool memory until
then (the LLM engine evicts its step functions at shutdown).

``fold_steps`` folds K steps of ``step_fn(carry, batch) -> (carry,
aux)`` into one call over batches stacked on a leading axis
(``stack_batches``): on the card the K-step loop is one graph, on the
CPU the same loop runs eagerly.
"""

from __future__ import annotations

import functools
import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import step_profiler as _sp
from ray_tpu_torch.util import tracing as _tracing

logger = logging.getLogger(__name__)


class RetraceError(RuntimeError):
    """A compiled_step function was called with a new abstract signature
    while ``on_retrace="error"`` (shape/dtype/structure drift would
    capture a fresh graph every step)."""


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    retraces: int = 0
    # wall time of the misses (on the card: the eager run and the
    # capture) — not part of as_dict(), surfaced via cache_stats()
    lowering_ms: float = 0.0

    def as_dict(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "retraces": self.retraces}


# -- abstract signature ------------------------------------------------------

def _flatten(tree, leaves: list):
    """Structure key of a pytree of tuples, lists, dicts and None (the
    containers `jax.tree_util` flattens); appends its leaves in order."""
    if type(tree) in (tuple, list):
        return (type(tree), tuple(_flatten(x, leaves) for x in tree))
    if type(tree) is dict:
        keys = tuple(sorted(tree))
        return (dict, keys, tuple(_flatten(tree[k], leaves) for k in keys))
    if tree is None:
        return None
    leaves.append(tree)
    return "*"


def _unflatten(struct, leaves):
    """Inverse of `_flatten`: rebuild the tree from an iterator of
    leaves."""
    if struct is None:
        return None
    if isinstance(struct, str):
        return next(leaves)
    if struct[0] is dict:
        return {k: _unflatten(s, leaves) for k, s in zip(struct[1],
                                                          struct[2])}
    return struct[0](_unflatten(s, leaves) for s in struct[1])


def _leaves_of(tree) -> list:
    leaves: list = []
    _flatten(tree, leaves)
    return leaves


def _tree_map(fn, tree):
    """`fn` applied to every leaf of `tree`, in the same structure."""
    leaves: list = []
    struct = _flatten(tree, leaves)
    return _unflatten(struct, iter([fn(x) for x in leaves]))


def _leaf_key(leaf: Any):
    """Abstract key for one leaf: shape+dtype+device for tensors (the
    objects themselves, which hash fast: a train carry has hundreds of
    leaves, keyed on every call), the value for anything else (a Python
    scalar is baked into the graph)."""
    if isinstance(leaf, torch.Tensor):
        return ("aval", leaf.shape, leaf.dtype, leaf.device)
    return ("const", type(leaf).__name__, repr(leaf))


def _mesh_key(mesh) -> Optional[tuple]:
    """A mesh's axis names and sizes and its ranks (the JAX key's shape and
    devices); any other object by its repr."""
    if mesh is None:
        return None
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, dict):
        return (tuple(shape.items()),
                tuple(int(r) for r in mesh.devices.ravel().tolist()))
    return (repr(mesh),)


def _mode_key() -> Tuple[bool, bool]:
    """The caller's autograd mode: a graph is captured under it."""
    return (torch.is_grad_enabled(), torch.is_inference_mode_enabled())


def _split_static(args: tuple, static_argnums: Tuple[int, ...]):
    """(dynamic args, ((i, value), ...) of the static args). A static
    argument is keyed by its value as a whole, so it must hash."""
    statics = tuple((i, args[i]) for i in sorted(set(static_argnums))
                    if i < len(args))
    try:
        hash(statics)
    except TypeError as e:
        raise ValueError(
            f"compiled_step: non-hashable static arguments are not "
            f"supported (keyed by value, as in jax.jit): {e}") from None
    skip = {i for i, _ in statics}
    return tuple(a for i, a in enumerate(args) if i not in skip), statics


def _merge_static(dyn: tuple, statics: tuple) -> tuple:
    """Inverse of `_split_static`."""
    out, it = list(dyn), dict(statics)
    for i in sorted(it):
        out.insert(i, it[i])
    return tuple(out)


def _arg_leaves(args: tuple, statics: tuple, argnums: Tuple[int, ...]
                ) -> List[int]:
    """Indices, in the dynamic leaves, of the leaves of the positional
    arguments in `argnums` (static arguments have none)."""
    static = {i for i, _ in statics}
    idx, n = [], 0
    for i, a in enumerate(args):
        if i in static:
            continue
        count = len(_leaves_of(a))
        if i in argnums:
            idx.extend(range(n, n + count))
        n += count
    return idx


def _target_device(device, leaves) -> torch.device:
    """`device` if given, else the first tensor leaf's; a CUDA device
    without an index is the current one."""
    if device is None:
        device = next((x.device for x in leaves
                       if isinstance(x, torch.Tensor)), "cpu")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


# -- donation ------------------------------------------------------------------

def _same_tensor(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr()
                      and a.shape == b.shape and a.stride() == b.stride())


def _matches(tree, struct, leaves: list) -> bool:
    got: list = []
    if _flatten(tree, got) != struct:
        return False
    for g, d in zip(got, leaves):
        if isinstance(d, torch.Tensor) != isinstance(g, torch.Tensor):
            return False
        if isinstance(d, torch.Tensor) and (
                g.shape != d.shape or g.dtype != d.dtype
                or g.device != d.device):
            return False
    return True


def _return_donated(out, donated: List[Tuple[Any, list]]):
    """`out` with each donated argument's paired output replaced by the
    donated tensors, after copying a paired leaf that is a new tensor
    into the donated storage (`donated`: (structure, leaves) of each
    donated argument). Candidates: the whole output, then the top-level
    entries of a tuple or list output; each pairs at most once."""
    if not donated:
        return out
    cands = [(out, 0)]
    if type(out) in (tuple, list):
        off = 0
        for x in out:
            cands.append((x, off))
            off += len(_leaves_of(x))
    leaves: list = []
    struct = _flatten(out, leaves)
    used = set()
    for d_struct, d_leaves in donated:
        for tree, off in cands:
            span = range(off, off + len(d_leaves))
            if used.intersection(span) or not _matches(tree, d_struct,
                                                       d_leaves):
                continue
            used.update(span)
            with torch.no_grad():
                for k, d in zip(span, d_leaves):
                    if isinstance(d, torch.Tensor):
                        if not _same_tensor(leaves[k], d):
                            d.copy_(leaves[k])
                        leaves[k] = d
            break
    return _unflatten(struct, iter(leaves))


# -- cache entries -------------------------------------------------------------

# `lookup`'s third value when the entry has not run the call yet
_NOT_RUN = object()


class _EagerEntry:
    """CPU: the function itself."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, args: tuple, kwargs: dict, leaves: list):
        return self.fn(*args, **kwargs)


_GRAPHING = threading.local()


def graphing() -> bool:
    """True on this thread while compiled_step runs a function that it
    captures on the card (the eager first run and the capture): a model
    rejects what a replay could not reproduce before the eager run takes
    effect."""
    return getattr(_GRAPHING, "on", False)


def _launch_counters():
    from ray_tpu_torch.ops import LAUNCH_COUNTERS  # import cycle via ops
    return LAUNCH_COUNTERS


class _GraphEntry:
    """One captured CUDA graph with its static inputs and outputs. The
    eager first run and the capture run under the caller's autograd mode
    on `device` (the capture on torch's side stream), replays on the
    current stream. `first_out` holds the eager run's result until the
    lookup that made the entry hands it to its caller."""

    def __init__(self, fn: Callable, struct, statics: tuple, leaves: list,
                 live_idx: List[int], donated_idx: List[int],
                 donate_argnums: Tuple[int, ...], device: torch.device,
                 pool):
        self.device = device
        self.live = {}
        for k in (*live_idx, *donated_idx):
            x = leaves[k]
            if k in donated_idx and not isinstance(x, torch.Tensor):
                continue  # a donated Python scalar is keyed by value
            if not isinstance(x, torch.Tensor) or x.device != device:
                raise ValueError(
                    f"compiled_step: live or donated argument leaf {k} "
                    f"must be a tensor on {device}, got "
                    f"{type(x).__name__} {getattr(x, 'device', '')}")
            self.live[k] = x.data_ptr()
        self.static = list(leaves)
        self.staging: Dict[int, torch.Tensor] = {}
        self.copied: List[int] = []
        self._staged: Optional[torch.cuda.Event] = None
        with torch.cuda.device(device):
            for k, x in enumerate(leaves):
                if not isinstance(x, torch.Tensor) or k in self.live:
                    continue
                self.static[k] = torch.empty(x.shape, dtype=x.dtype,
                                             device=device)
                if x.device.type == "cpu":
                    self.staging[k] = torch.empty(
                        x.shape, dtype=x.dtype, pin_memory=True)
                self.copied.append(k)
            self._copy_in(leaves)
            dyn, kwargs = _unflatten(struct, iter(self.static))
            args = _merge_static(dyn, statics)
            # (structure, leaves) of each donated argument, for pairing
            donated = [(_flatten(args[i], []), _leaves_of(args[i]))
                       for i in sorted(set(donate_argnums))
                       if i < len(args) and i not in dict(statics)]
            _GRAPHING.on = True
            try:
                # the call itself; its first-use costs stay outside the
                # capture
                self.first_out = _return_donated(fn(*args, **kwargs),
                                                 donated)
                self._capture(fn, args, kwargs, donated, pool)
            finally:
                _GRAPHING.on = False

    def _capture(self, fn, args, kwargs, donated, pool) -> None:
        counters = _launch_counters()
        before = [c.launches for c in counters]
        self.graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: a sync or allocation that may not be captured
            # fails THIS capture; other threads' CUDA work stays legal
            with torch.cuda.graph(self.graph, pool=pool,
                                  capture_error_mode="thread_local"):
                self.out = _return_donated(fn(*args, **kwargs), donated)
        except Exception as e:
            e.result = self.first_out
            e.add_note(
                f"compiled_step: capturing {getattr(fn, '__name__', fn)} "
                f"failed after its eager first run, which was the call and "
                f"took effect; its result is this error's .result")
            raise
        finally:
            # nothing ran while capturing: each replay launches these
            self.launches = [c.launches - b for c, b in zip(counters, before)]
            for c, b in zip(counters, before):
                c.launches = b

    def _copy_in(self, leaves: list) -> None:
        if self._staged is not None:
            # the previous call's host-to-device copies read the staging
            # buffers: let them finish before the host overwrites them
            self._staged.synchronize()
        with torch.no_grad():
            for k in self.copied:
                src = leaves[k]
                stage = self.staging.get(k)
                if stage is not None:
                    stage.copy_(src)
                    src = stage
                self.static[k].copy_(src, non_blocking=True)
        if self.staging:
            self._staged = torch.cuda.Event()
            self._staged.record()

    def __call__(self, args: tuple, kwargs: dict, leaves: list):
        for k, ptr in self.live.items():
            if leaves[k].data_ptr() != ptr:
                raise RuntimeError(
                    f"compiled_step: live or donated argument leaf {k} is "
                    f"another storage ({leaves[k].data_ptr():#x}) than the "
                    f"one the graph captured ({ptr:#x}); a replay would "
                    f"read stale memory")
        with torch.cuda.device(self.device):
            self._copy_in(leaves)
            self.graph.replay()
        for c, n in zip(_launch_counters(), self.launches):
            c.launches += n
        return self.out


class ExecutableCache:
    """Process-wide cache of compiled steps (CUDA graphs on the card,
    the eager function on the CPU).

    Key: (function identity, argument structure and leaf keys, static
    argument values, live and donated arguments, autograd mode).
    Function identity is ``id(fn)`` paired with a strong reference to
    ``fn`` held by the entry, so an id can never be recycled into a false
    hit while its entry is alive.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[tuple, Any] = {}
        self._fn_signatures: Dict[tuple, set] = {}
        self.stats = CacheStats()

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._fn_signatures.clear()
            self.stats = CacheStats()

    def size(self) -> int:
        with self._lock:
            return len(self._entries)

    def evict(self, fn: Callable) -> int:
        """Drop every entry of `fn` (a function or its compiled_step
        wrapper) and forget its signatures, releasing its graphs' static
        buffers and pool memory; returns how many entries went. The
        counters keep their history."""
        fn = getattr(fn, "__wrapped__", fn)
        fn_key = (id(fn), getattr(fn, "__qualname__", None))
        with self._lock:
            gone = [key for key in self._entries if key[0] == fn_key]
            for key in gone:
                del self._entries[key]
            self._fn_signatures.pop(fn_key, None)
        return len(gone)

    def lookup(self, fn: Callable, args: tuple, kwargs: dict, *,
               donate_argnums: Tuple[int, ...] = (),
               static_argnums: Tuple[int, ...] = (),
               live_argnums: Tuple[int, ...] = (), mesh=None, device=None,
               pool=None, on_retrace: str = "warn"):
        """Return (entry, leaves, out) for this abstract call signature.
        ``entry(args, kwargs, leaves)`` runs the call; ``out`` is
        `_NOT_RUN` unless this lookup made a graph entry, whose eager
        first run was the call (then ``out`` is its result)."""
        dyn, statics = _split_static(args, static_argnums)
        leaves: list = []
        struct = _flatten((dyn, kwargs), leaves)
        avals = tuple(_leaf_key(leaf) for leaf in leaves)
        fn_key = (id(fn), getattr(fn, "__qualname__", None))
        key = (fn_key, struct, avals, _mesh_key(mesh), statics,
               tuple(live_argnums), tuple(donate_argnums), _mode_key())
        sig = (struct, avals, statics)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self.stats.hits += 1
                return entry[1], leaves, _NOT_RUN
            self.stats.misses += 1
            prior = self._fn_signatures.setdefault(fn_key, set())
            retraced = bool(prior) and sig not in prior
            if retraced:
                self.stats.retraces += 1
            prior.add(sig)
        if retraced:
            name = getattr(fn, "__name__", repr(fn))
            msg = (f"compiled_step retrace: {name} called with a new "
                   f"abstract signature (shape/dtype/structure changed) "
                   f"— every such change captures a fresh graph")
            if on_retrace == "error":
                raise RetraceError(msg)
            logger.warning(msg)
        t0 = time.perf_counter()
        target = _target_device(device, leaves)
        out = _NOT_RUN
        with _tracing.span("compiled_step.lower", attrs={
                "fn": getattr(fn, "__name__", "?"), "retrace": retraced,
                "device": str(target)}):
            if target.type == "cuda":
                entry = _GraphEntry(
                    fn, struct, statics, leaves,
                    _arg_leaves(args, statics, live_argnums),
                    _arg_leaves(args, statics, donate_argnums),
                    tuple(donate_argnums), target, pool)
                out, entry.first_out = entry.first_out, None
            else:
                entry = _EagerEntry(fn)
        lowering_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            # keep fn alive alongside its entry (id-key safety)
            self._entries[key] = (fn, entry)
            self.stats.lowering_ms += lowering_ms
        return entry, leaves, out


_GLOBAL_CACHE = ExecutableCache()


def global_cache() -> ExecutableCache:
    return _GLOBAL_CACHE


def cache_stats() -> Dict[str, int]:
    """Process-wide cache counters (the /metrics scrape reads these):
    hits / misses / retraces / entries / cumulative lowering ms (on the
    card: eager first runs and captures)."""
    stats = _GLOBAL_CACHE.stats.as_dict()
    stats["entries"] = _GLOBAL_CACHE.size()
    stats["lowering_ms"] = round(_GLOBAL_CACHE.stats.lowering_ms, 3)
    return stats


def _metrics_text() -> str:
    """Scrape-time exposition of the global cache."""
    s = cache_stats()
    return (
        "# TYPE compile_cache_hits_total counter\n"
        f"compile_cache_hits_total {s['hits']}\n"
        f"compile_cache_misses_total {s['misses']}\n"
        f"compile_cache_retraces_total {s['retraces']}\n"
        "# TYPE compile_cache_entries gauge\n"
        f"compile_cache_entries {s['entries']}\n"
        "# TYPE compile_cache_lowering_ms_total counter\n"
        f"compile_cache_lowering_ms_total {s['lowering_ms']}\n")


_metrics.DEFAULT_REGISTRY.register_callback("compile_cache", _metrics_text)


def compiled_step(fn: Optional[Callable] = None, *,
                  donate_argnums: Tuple[int, ...] = (),
                  static_argnums: Tuple[int, ...] = (),
                  mesh=None, cache: Optional[ExecutableCache] = None,
                  on_retrace: str = "warn",
                  live_argnums: Tuple[int, ...] = (), device=None,
                  pool=None) -> Callable:
    """Decorator/wrapper: dispatch ``fn`` through the compiled-step
    cache (see the module docstring).

    The JAX signature (``donate_argnums``, ``static_argnums``, ``mesh``,
    ``cache``, ``on_retrace``) plus the port's own: ``device`` is where
    the graph runs (default: the first tensor argument's device; the CPU
    takes the eager entry), and host tensor arguments are copied to it;
    ``live_argnums`` are captured by address; ``pool`` is the graphs'
    memory pool. The wrapper exposes ``.cache`` and ``.stats`` for tests
    and counters, and ``.__wrapped__``.
    """
    if fn is None:
        return functools.partial(
            compiled_step, donate_argnums=donate_argnums,
            static_argnums=static_argnums, mesh=mesh, cache=cache,
            on_retrace=on_retrace, live_argnums=live_argnums,
            device=device, pool=pool)
    use_cache = cache if cache is not None else _GLOBAL_CACHE
    fn_name = getattr(fn, "__name__", "step")
    opts = dict(donate_argnums=tuple(donate_argnums),
                static_argnums=tuple(static_argnums),
                live_argnums=tuple(live_argnums), mesh=mesh, device=device,
                pool=pool, on_retrace=on_retrace)

    def call(args, kwargs):
        entry, leaves, out = use_cache.lookup(fn, args, kwargs, **opts)
        if out is _NOT_RUN:
            out = entry(args, kwargs, leaves)
        return out

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        # flight recorder: sampled host time of the call (1 in N; the
        # unsampled cost is one integer increment)
        if _sp.enabled() and _sp.count_dispatch():
            t0 = time.perf_counter()
            out = call(args, kwargs)
            _sp.record_dispatch(fn_name, (time.perf_counter() - t0) * 1e3)
            return out
        return call(args, kwargs)

    wrapper.cache = use_cache
    wrapper.stats = use_cache.stats
    wrapper.__wrapped__ = fn
    return wrapper


def _index(tree, i: int):
    """Step `i` of a stacked tree: every tensor leaf's [i] (a view)."""
    return _tree_map(
        lambda x: x[i] if isinstance(x, torch.Tensor) else x, tree)


def _stack(trees: list):
    """Stack same-structured trees leaf by leaf on a new leading axis."""
    struct = _flatten(trees[0], [])
    columns = zip(*(_leaves_of(t) for t in trees))
    return _unflatten(struct, iter([
        torch.stack(col) if isinstance(col[0], torch.Tensor)
        else torch.tensor(col) for col in columns]))


def fold_steps(step_fn: Callable, steps_per_call: int, *,
               donate_carry: bool = True,
               mesh=None, cache: Optional[ExecutableCache] = None,
               on_retrace: str = "warn", device=None) -> Callable:
    """Fold K optimizer steps into one call (opt-in ``steps_per_call``).

    ``step_fn(carry, batch) -> (carry, aux)`` becomes
    ``multi(carry, batches) -> (carry, auxes)`` where ``batches`` holds K
    batches stacked on a leading axis (`stack_batches`) and ``auxes``
    stacks each step's aux ([K, ...]). The K-step body is a Python loop
    (the counterpart of `lax.scan`): on the card it is captured as ONE
    CUDA graph with the carry donated, so the host cost per K steps is a
    single replay; on the CPU the same loop runs eagerly. The returned
    auxes are the graph's static outputs, which the next replay
    overwrites. ``device`` (the port's own) is where the graph runs.
    """
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, "
                         f"got {steps_per_call}")

    def multi_step(carry, batches):
        auxes = []
        for i in range(steps_per_call):
            carry, aux = step_fn(carry, _index(batches, i))
            auxes.append(aux)
        return carry, _stack(auxes)

    multi_step.__name__ = (
        f"fold_steps({getattr(step_fn, '__name__', 'step')}"
        f"x{steps_per_call})")
    multi_step.__qualname__ = multi_step.__name__
    wrapper = compiled_step(
        multi_step, donate_argnums=(0,) if donate_carry else (),
        mesh=mesh, cache=cache, on_retrace=on_retrace, device=device)
    wrapper.steps_per_call = steps_per_call
    return wrapper


def stack_batches(batches, device=None):
    """Stack an iterable of K same-shape batch trees into one [K, ...]
    tree (``torch.stack`` per leaf), moved to ``device`` when one is
    given: the input block a `fold_steps` wrapper consumes."""
    batches = list(batches)
    if not batches:
        raise ValueError("stack_batches needs at least one batch")
    stacked = _stack(batches)
    if device is not None:
        stacked = _tree_map(lambda x: x.to(device), stacked)
    return stacked
