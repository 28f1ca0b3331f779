"""Deadman watchdog: liveness proof for the port's hot loops.

The port's own copy of `ray_tpu/_private/health.py`. A hot loop (the
LLM engine's pump thread) registers a :class:`LoopProbe` and calls
``probe.beat()`` once per iteration: one integer increment, no lock, no
syscall. A :class:`Watchdog` thread applies the deadman rule: a loop
whose beat counter is FROZEN while its backlog probe says there is work
is stalled. On detection it captures the culprit thread's stack via
``sys._current_frames()``, emits a ``health.stalled`` structured event
(`ray_tpu_torch.util.events`), and flips the
``health_loop_stalled{loop=}`` gauge of the port's metrics registry; the
first beat after that emits ``health.recovered``.

A beat must never be taken under the watched loop's lock: a watchdog
whose liveness signal needs the stalled lock could never fire.

The cluster-wide stack dump (``dump_stacks`` over RPC) and the asyncio
loop ticker come with the port of the runtime.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.util import events
from ray_tpu_torch.util import metrics as _metrics

# module-registry guard: a raw lock, never on any hot path (probes are
# registered once at loop start; beats never touch it)
_lock = threading.Lock()
_probes: Dict[str, "LoopProbe"] = {}
_metrics_registered = False


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class LoopProbe:
    """Monotonic progress counter for one hot loop.

    ``beat()`` is the only call on the hot path: an int increment plus a
    thread-ident store, both GIL-atomic — deliberately lock-free so the
    probe stays readable even when the watched loop's lock is wedged.
    ``backlog_fn`` answers "is there work this loop should be doing?"
    and is only called from the watchdog thread, at watchdog cadence.
    """

    __slots__ = ("name", "backlog_fn", "count", "thread_ident",
                 "stalled", "stalled_since", "stalls_total")

    def __init__(self, name: str,
                 backlog_fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.backlog_fn = backlog_fn
        self.count = 0
        self.thread_ident: Optional[int] = None
        self.stalled = False
        self.stalled_since: Optional[float] = None
        self.stalls_total = 0

    def beat(self) -> None:
        self.thread_ident = threading.get_ident()
        self.count += 1

    def backlog(self) -> float:
        if self.backlog_fn is None:
            return 0.0
        try:
            return float(self.backlog_fn())
        except Exception:  # noqa: BLE001 — probe must not take the loop down
            return 0.0


def watch_loop(name: str,
               backlog_fn: Optional[Callable[[], float]] = None
               ) -> LoopProbe:
    """Register (or re-register — restartable loops) a probe by name."""
    probe = LoopProbe(name, backlog_fn)
    with _lock:
        _probes[name] = probe
    _register_metrics()
    return probe


def unwatch_loop(name: str) -> None:
    with _lock:
        _probes.pop(name, None)


def probes() -> List[LoopProbe]:
    with _lock:
        return list(_probes.values())


_watchdog_singleton: Optional["Watchdog"] = None


def ensure_watchdog(source: str = "HEALTH") -> "Watchdog":
    """Process-wide watchdog for components that live inside another
    process (an LLM engine in a replica): first caller starts it,
    everyone shares it."""
    global _watchdog_singleton
    with _lock:
        if _watchdog_singleton is None:
            _watchdog_singleton = Watchdog(source=source).start()
        return _watchdog_singleton


def _reset_after_fork() -> None:
    """A forked child inherits probes whose threads don't exist in the
    child — every one would read as frozen. Start clean. Lockless on
    purpose: the inherited module lock may have been mid-acquire in
    the parent at fork time, and the child is single-threaded here."""
    global _watchdog_singleton
    _probes.clear()
    _watchdog_singleton = None


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reset_after_fork)


# -- exposition ----------------------------------------------------------

def metrics_text() -> str:
    lines = ["# TYPE health_loop_beats_total counter"]
    snapshot = probes()
    for p in snapshot:
        lines.append(
            f'health_loop_beats_total{{loop="{p.name}"}} {p.count}')
    lines.append("# TYPE health_loop_stalled gauge")
    for p in snapshot:
        lines.append(
            f'health_loop_stalled{{loop="{p.name}"}} '
            f"{1 if p.stalled else 0}")
    lines.append("# TYPE health_loop_stalls_total counter")
    for p in snapshot:
        lines.append(
            f'health_loop_stalls_total{{loop="{p.name}"}} '
            f"{p.stalls_total}")
    lines.append("# TYPE health_stalled_loops gauge")
    lines.append(
        f"health_stalled_loops "
        f"{sum(1 for p in snapshot if p.stalled)}")
    return "\n".join(lines) + "\n"


def _register_metrics() -> None:
    global _metrics_registered
    if _metrics_registered:
        return
    _metrics.DEFAULT_REGISTRY.register_callback("health", metrics_text)
    _metrics_registered = True


# -- stack capture -------------------------------------------------------

def _format_stack(frame) -> str:
    return "".join(traceback.format_stack(frame))


def _held_locks_by_thread() -> Dict[int, List[str]]:
    """{thread_ident: [lock names]} of the held tracked locks. The JAX
    package reads them from its lock-order checker (`lockdep`), which
    instruments the runtime's locks; the port has no runtime and no such
    checker yet, so there is nothing to report."""
    return {}


def capture_thread_stack(ident: Optional[int]) -> str:
    frame = sys._current_frames().get(ident) if ident else None
    return _format_stack(frame) if frame is not None else ""


# -- the watchdog --------------------------------------------------------

class Watchdog:
    """Per-daemon deadman checker (daemon thread, watchdog cadence).

    A probe is stalled when its beat counter has not moved for
    ``stall_s`` seconds while its backlog probe reports pending work —
    an idle loop (frozen counter, empty queue) is healthy. Detection
    captures the culprit thread's stack and emits ``health.stalled``;
    the first beat after that emits ``health.recovered``. State is
    observable through ``health_loop_stalled{loop=}`` which the SLO
    plane's deadman rule watches.
    """

    def __init__(self, source: str = "HEALTH",
                 interval_s: Optional[float] = None,
                 stall_s: Optional[float] = None):
        self.source = source
        self.interval_s = max(0.05, interval_s if interval_s is not None
                              else _env_float(
                                  "RAY_TPU_WATCHDOG_INTERVAL_S", 1.0))
        self.stall_s = max(0.1, stall_s if stall_s is not None
                           else _env_float(
                               "RAY_TPU_WATCHDOG_STALL_S", 5.0))
        self._seen: Dict[str, tuple] = {}  # name -> (count, ts)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.checks = 0
        _register_metrics()

    # split out so tests can drive the deadman rule synchronously
    def check_once(self, now: Optional[float] = None) -> List[str]:
        """One deadman sweep; returns the names of newly-stalled loops."""
        now = time.monotonic() if now is None else now
        self.checks += 1
        newly_stalled: List[str] = []
        for probe in probes():
            count = probe.count
            seen = self._seen.get(probe.name)
            if seen is None or count != seen[0]:
                self._seen[probe.name] = (count, now)
                if probe.stalled:
                    probe.stalled = False
                    stalled_for = (time.time() - probe.stalled_since
                                   if probe.stalled_since else 0.0)
                    probe.stalled_since = None
                    events.report(
                        self.source, "INFO", "health.recovered",
                        f"loop '{probe.name}' resumed after "
                        f"{stalled_for:.1f}s stall",
                        loop=probe.name, stalled_s=round(stalled_for, 3))
                continue
            frozen_s = now - seen[1]
            if probe.stalled or frozen_s < self.stall_s:
                continue
            backlog = probe.backlog()
            if backlog <= 0:
                continue  # idle, not stuck
            probe.stalled = True
            probe.stalled_since = time.time()
            probe.stalls_total += 1
            stack = capture_thread_stack(probe.thread_ident)
            held = _held_locks_by_thread().get(probe.thread_ident, [])
            events.report(
                self.source, "ERROR", "health.stalled",
                f"loop '{probe.name}' frozen for {frozen_s:.1f}s with "
                f"backlog {backlog:g}",
                loop=probe.name, frozen_s=round(frozen_s, 3),
                backlog=backlog, stack=stack, held_locks=held)
            newly_stalled.append(probe.name)
        return newly_stalled

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 — the watchdog never dies
                pass
            self._stop.wait(self.interval_s)

    def start(self) -> "Watchdog":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="health-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)
