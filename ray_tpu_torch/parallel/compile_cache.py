"""Compiled-step cache: one CUDA graph per abstract call signature.

Port of `ray_tpu/parallel/compile_cache.py:54-257`. There
``compiled_step`` keys a process-wide cache of AOT executables on the
arguments' abstract signature (treedef + avals) and counts hits, misses
and retraces; a steady-state call is one executable dispatch. PyTorch
runs eagerly, and the counterpart of an executable with static shapes is
a captured CUDA graph, so the port keys the same way (the structure of
the arguments, then shape, dtype and device of every tensor leaf and the
value of every other leaf) and holds per signature:

* on a CUDA device, a ``torch.cuda.CUDAGraph``. The first call with a
  signature runs the function once eagerly (the kernel build,
  ``cudaFuncSetAttribute``, library handles, allocator growth, tables the
  function caches), captures it into static input and output tensors in
  the memory pool given as ``pool`` (graphs that never run at the same
  time may share one: ``torch.cuda.graph_pool_handle()``), and counts a
  miss. A later call with the signature copies its tensor inputs into
  the static inputs (host tensors through a pinned staging buffer,
  ``non_blocking``), replays the graph on the current stream and returns
  the static outputs, which THE NEXT REPLAY OVERWRITES: a caller
  consumes or clones them first. There is no eager fallback: a capture
  that fails (a host sync such as ``.item()`` inside the function, a
  data-dependent shape) raises.
* on the CPU, the eager function itself: the keys, counters and retrace
  rule are the same, so CPU runs exercise the whole cache logic.

``live_argnums`` names arguments that the graph reads and writes in
place (a KV arena): they are captured by address, never copied, and a
call that passes another storage (``data_ptr``) raises instead of
replaying on stale memory. Weights live in the function's module and
are captured by address the same way.

Kernel launch counters (`ray_tpu_torch.ops.LAUNCH_COUNTERS`) keep
meaning kernel executions: a wrapper adds to its count while the graph
is captured, where nothing runs, so the capture's additions are taken
back and each replay credits them again.

A retrace is a miss for a function that already has a signature: it
warns, or raises `RetraceError` under ``on_retrace="error"``, exactly as
the JAX cache does. The global cache holds its entries until
``ExecutableCache.evict(fn)`` or ``clear()``; a graph holds its static
buffers and pool memory until then (the LLM engine evicts its step
functions at shutdown). `fold_steps` and `stack_batches` belong to the
train plane and come with it.
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
    # wall time of the misses (on the card: the warm-up run and the
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


def _leaf_key(leaf: Any):
    """Abstract key for one leaf: shape+dtype+device for tensors, the
    value for anything else (a Python scalar is baked into the graph)."""
    if isinstance(leaf, torch.Tensor):
        return ("aval", tuple(leaf.shape), str(leaf.dtype), str(leaf.device))
    return ("const", type(leaf).__name__, repr(leaf))


def _live_leaves(args: tuple, live_argnums: Tuple[int, ...]) -> List[int]:
    """Leaf indices (in `_flatten((args, kwargs))` order) of the
    positional arguments in `live_argnums`."""
    idx, n = [], 0
    for i, a in enumerate(args):
        count = len(_leaves_of(a))
        if i in live_argnums:
            idx.extend(range(n, n + count))
        n += count
    return idx


def _leaves_of(tree) -> list:
    leaves: list = []
    _flatten(tree, leaves)
    return leaves


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


# -- cache entries -------------------------------------------------------------

class _EagerEntry:
    """CPU: the function itself."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, args: tuple, kwargs: dict, leaves: list):
        return self.fn(*args, **kwargs)


def _launch_counters():
    from ray_tpu_torch.ops import LAUNCH_COUNTERS  # import cycle via ops
    return LAUNCH_COUNTERS


class _GraphEntry:
    """One captured CUDA graph with its static inputs and outputs.
    Everything runs under inference mode on `device`, on the current
    stream (the capture itself on torch's side stream)."""

    def __init__(self, fn: Callable, struct, leaves: list,
                 live_idx: List[int], device: torch.device, pool):
        self.device = device
        self.live = {}
        for k in live_idx:
            x = leaves[k]
            if not isinstance(x, torch.Tensor) or x.device != device:
                raise ValueError(
                    f"compiled_step: live argument leaf {k} must be a "
                    f"tensor on {device}, got {type(x).__name__} "
                    f"{getattr(x, 'device', '')}")
            self.live[k] = x.data_ptr()
        self.static = list(leaves)
        self.staging: Dict[int, torch.Tensor] = {}
        self.copied: List[int] = []
        self._staged: Optional[torch.cuda.Event] = None
        with torch.cuda.device(device), torch.inference_mode():
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
            args, kwargs = _unflatten(struct, iter(self.static))
            fn(*args, **kwargs)  # warm-up: first-use costs stay outside
            counters = _launch_counters()
            before = [c.launches for c in counters]
            self.graph = torch.cuda.CUDAGraph()
            # thread_local: a sync or allocation that may not be captured
            # fails THIS capture; other threads' CUDA work stays legal
            with torch.cuda.graph(self.graph, pool=pool,
                                  capture_error_mode="thread_local"):
                self.out = fn(*args, **kwargs)
            # nothing ran while capturing: each replay launches these
            self.launches = [c.launches - b for c, b in zip(counters, before)]
            for c, b in zip(counters, before):
                c.launches = b

    def _copy_in(self, leaves: list) -> None:
        if self._staged is not None:
            # the previous call's host-to-device copies read the staging
            # buffers: let them finish before the host overwrites them
            self._staged.synchronize()
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
                    f"compiled_step: live argument leaf {k} is another "
                    f"storage ({leaves[k].data_ptr():#x}) than the one the "
                    f"graph captured ({ptr:#x}); a replay would read stale "
                    f"memory")
        with torch.cuda.device(self.device), torch.inference_mode():
            self._copy_in(leaves)
            self.graph.replay()
        for c, n in zip(_launch_counters(), self.launches):
            c.launches += n
        return self.out


class ExecutableCache:
    """Process-wide cache of compiled steps (CUDA graphs on the card,
    the eager function on the CPU).

    Key: (function identity, argument structure and leaf keys, live
    arguments). Function identity is ``id(fn)`` paired with a strong
    reference to ``fn`` held by the entry, so an id can never be recycled
    into a false hit while its entry is alive.
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
               live_argnums: Tuple[int, ...] = (), device=None, pool=None,
               on_retrace: str = "warn"):
        """Return (entry, leaves) for this abstract call signature,
        capturing the graph on first use; ``entry(args, kwargs, leaves)``
        runs the call."""
        leaves: list = []
        struct = _flatten((args, kwargs), leaves)
        avals = tuple(_leaf_key(leaf) for leaf in leaves)
        fn_key = (id(fn), getattr(fn, "__qualname__", None))
        key = (fn_key, struct, avals, tuple(live_argnums))
        sig = (struct, avals)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self.stats.hits += 1
                return entry[1], leaves
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
        with _tracing.span("compiled_step.lower", attrs={
                "fn": getattr(fn, "__name__", "?"), "retrace": retraced,
                "device": str(target)}):
            if target.type == "cuda":
                entry = _GraphEntry(fn, struct, leaves,
                                    _live_leaves(args, live_argnums),
                                    target, pool)
            else:
                entry = _EagerEntry(fn)
        lowering_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            # keep fn alive alongside its entry (id-key safety)
            self._entries[key] = (fn, entry)
            self.stats.lowering_ms += lowering_ms
        return entry, leaves


_GLOBAL_CACHE = ExecutableCache()


def global_cache() -> ExecutableCache:
    return _GLOBAL_CACHE


def cache_stats() -> Dict[str, int]:
    """Process-wide cache counters (the /metrics scrape reads these):
    hits / misses / retraces / entries / cumulative lowering ms (on the
    card: warm-up runs and captures)."""
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
                  live_argnums: Tuple[int, ...] = (), device=None,
                  pool=None, cache: Optional[ExecutableCache] = None,
                  on_retrace: str = "warn") -> Callable:
    """Decorator/wrapper: dispatch ``fn`` through the compiled-step
    cache (see the module docstring).

    ``device`` is where the graph runs (default: the first tensor
    argument's device; the CPU takes the eager entry); host tensor
    arguments are copied to it. ``live_argnums`` are captured by address,
    ``pool`` is the graphs' memory pool. The wrapper exposes ``.cache``
    and ``.stats`` for tests and counters, and ``.__wrapped__``.
    """
    if fn is None:
        return functools.partial(
            compiled_step, live_argnums=live_argnums, device=device,
            pool=pool, cache=cache, on_retrace=on_retrace)
    use_cache = cache if cache is not None else _GLOBAL_CACHE
    fn_name = getattr(fn, "__name__", "step")
    opts = dict(live_argnums=tuple(live_argnums), device=device, pool=pool,
                on_retrace=on_retrace)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        # flight recorder: sampled host time of the call (1 in N; the
        # unsampled cost is one integer increment)
        if _sp.enabled() and _sp.count_dispatch():
            t0 = time.perf_counter()
            entry, leaves = use_cache.lookup(fn, args, kwargs, **opts)
            out = entry(args, kwargs, leaves)
            _sp.record_dispatch(fn_name, (time.perf_counter() - t0) * 1e3)
            return out
        entry, leaves = use_cache.lookup(fn, args, kwargs, **opts)
        return entry(args, kwargs, leaves)

    wrapper.cache = use_cache
    wrapper.stats = use_cache.stats
    wrapper.__wrapped__ = fn
    return wrapper
