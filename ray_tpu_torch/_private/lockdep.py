"""Runtime lock-order validator (the kernel's lockdep, in-process).

Under ``RAY_TPU_LOCKDEP=1`` (or a programmatic :func:`install`),
``threading.Lock`` / ``threading.RLock`` are replaced by tracked
wrappers. Every thread keeps the stack of locks it currently holds;
acquiring ``B`` while holding ``A`` records the directed edge ``A → B``
with the acquisition stacks of both ends (first witness wins). An edge
that closes a cycle in the global order graph — the classic ``A→B`` in
one thread, ``B→A`` in another — raises :class:`LockOrderError` in the
acquiring thread *before* the program can actually deadlock, and the
report carries both witness stacks. The chaos and object-store test
suites run with lockdep enabled (see tests/conftest.py) so every lock
refactor on the object plane is exercised against it.

Design notes:

* Edges are keyed per lock *instance*; every wrapper carries its
  allocation site (``file:line`` of construction) so reports name the
  lock the way a developer thinks of it. Instance keying trades recall
  (cross-instance ABBA on two locks of the same class is only caught
  when the same two instances witness both orders) for a near-zero
  false-positive rate — the right trade for a CI gate.
* RLock re-entrancy is not an edge: only the outermost acquisition of a
  recursive lock pushes onto the held stack.
* ``Condition.wait`` interop: the wrappers expose ``_release_save`` /
  ``_acquire_restore`` / ``_is_owned`` delegating to the real lock while
  keeping the held-stack bookkeeping exact across the wait window.
* The graph's own guard is a raw ``_thread.allocate_lock`` (never
  wrapped, never part of the order graph).

Activation: :func:`init_from_env` runs at ``ray_tpu`` import, so worker
daemons spawned with ``RAY_TPU_LOCKDEP=1`` in their environment
self-install, mirroring how the chaos plane activates per process.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple

import _thread

ENV_VAR = "RAY_TPU_LOCKDEP"

_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = _thread.RLock


class LockOrderError(RuntimeError):
    """A lock acquisition closed a cycle in the lock-order graph."""


class _Graph:
    """Global lock-order graph: nodes are live tracked locks, edges the
    observed held→acquired orderings with their first-witness stacks."""

    def __init__(self) -> None:
        self._mu = _REAL_LOCK()
        # (id_a, id_b) -> (name_a, name_b, stack_ab) first witness of A→B
        self.edges: Dict[Tuple[int, int], Tuple[str, str, str]] = {}
        self.adj: Dict[int, Set[int]] = {}
        self.names: Dict[int, str] = {}
        self.cycles: List[str] = []
        # keep wrappers alive so ids can't be recycled into stale nodes
        self._pins: List[object] = []

    def note_lock(self, lock: "_TrackedLockBase") -> None:
        with self._mu:
            self.names[id(lock)] = lock._ld_name
            self._pins.append(lock)

    def add_edge(self, a: "_TrackedLockBase", b: "_TrackedLockBase",
                 stack_ab: str) -> Optional[str]:
        """Record A→B; return a cycle report iff it closes a cycle."""
        ka, kb = id(a), id(b)
        if ka == kb:
            return None
        with self._mu:
            if (ka, kb) in self.edges:
                return None
            path = self._path(kb, ka)
            self.edges[(ka, kb)] = (a._ld_name, b._ld_name, stack_ab)
            self.adj.setdefault(ka, set()).add(kb)
            if path is None:
                return None
            # cycle: B ->* A exists and we just added A -> B
            lines = [
                "lock-order cycle detected (potential deadlock):",
                f"  new edge: {a._ld_name} -> {b._ld_name}",
                "  acquired here:",
                _indent(stack_ab, "    "),
                "  conflicting prior ordering "
                f"({' -> '.join(self.names.get(k, '?') for k in path)}):",
            ]
            for ka2, kb2 in zip(path, path[1:]):
                _, _, st = self.edges[(ka2, kb2)]
                lines.append(
                    f"  edge {self.names.get(ka2, '?')} -> "
                    f"{self.names.get(kb2, '?')} acquired here:")
                lines.append(_indent(st, "    "))
            report = "\n".join(lines)
            self.cycles.append(report)
            return report

    def _path(self, src: int, dst: int) -> Optional[List[int]]:
        """Path src ->* dst in adj, or None. Caller holds self._mu."""
        if src == dst:
            return [src]
        seen = {src}
        stack = [(src, [src])]
        while stack:
            cur, path = stack.pop()
            for nxt in self.adj.get(cur, ()):
                if nxt == dst:
                    return path + [nxt]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None


def _indent(text: str, pad: str) -> str:
    return "\n".join(pad + ln for ln in text.rstrip().splitlines())


def _site() -> str:
    """file:line of the nearest caller outside this module (the lock's
    allocation site)."""
    for f in reversed(traceback.extract_stack(limit=8)):
        if os.path.basename(f.filename) != "lockdep.py":
            return f"{os.path.basename(f.filename)}:{f.lineno}"
    return "<unknown>"


def _stack() -> str:
    return "".join(traceback.format_stack(limit=16)[:-3])


# per-thread held stack: list of [lock, recursion_count]
_tls = threading.local()

# Cross-thread view for hang diagnosis (health.dump_stacks): every
# thread's held list, keyed by ident, registered the first time the
# thread touches a tracked lock. Reads are best-effort snapshots — the
# lists mutate concurrently, but each mutation is a single list op, so
# a reader sees a coherent recent state, which is all a stack dump
# needs. Guarded by a raw lock (never part of the order graph).
_all_held: Dict[int, List[List[object]]] = {}
_all_held_mu = _REAL_LOCK()


def _held() -> List[List[object]]:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
        with _all_held_mu:
            _all_held[threading.get_ident()] = h
    return h


def held_locks() -> Dict[int, List[str]]:
    """{thread_ident: [lock names]} of currently-held tracked locks
    across ALL threads. Dead threads are pruned as a side effect."""
    import sys

    alive = set(sys._current_frames())
    with _all_held_mu:
        dead = [ident for ident in _all_held if ident not in alive]
        for ident in dead:
            del _all_held[ident]
        items = [(ident, list(held)) for ident, held in _all_held.items()]
    out: Dict[int, List[str]] = {}
    for ident, held in items:
        names = []
        for entry in held:
            try:
                lock, count = entry
                name = lock._ld_name
            except Exception:  # noqa: BLE001 — entry mutated under us
                continue
            names.append(name if count <= 1
                         else f"{name} (depth {count})")
        if names:
            out[ident] = names
    return out


_GRAPH: Optional[_Graph] = None
_RAISE = True


def _note_acquired(lock: "_TrackedLockBase") -> None:
    graph = _GRAPH
    if graph is None:
        return
    held = _held()
    for entry in held:
        if entry[0] is lock:
            entry[1] += 1  # re-entrant: no new edge, no new frame
            return
    report = None
    if held:
        st = _stack()
        for entry in held:
            report = graph.add_edge(entry[0], lock, st) or report
    # push before raising so a caller that catches LockOrderError can
    # still release() coherently
    held.append([lock, 1])
    if report is not None and _RAISE:
        raise LockOrderError(report)


def _note_released(lock: "_TrackedLockBase", full: bool = False) -> None:
    if _GRAPH is None:
        return
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] is lock:
            if full:
                held[i][1] = 0
            else:
                held[i][1] -= 1
            if held[i][1] <= 0:
                del held[i]
            return


class _TrackedLockBase:
    _ld_kind = "Lock"

    def __init__(self) -> None:
        self._ld_inner = self._make_inner()
        self._ld_name = (f"{self._ld_kind}@{_site()}"
                         f"#{id(self) & 0xffff:04x}")
        if _GRAPH is not None:
            _GRAPH.note_lock(self)

    def _make_inner(self):
        raise NotImplementedError

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._ld_inner.acquire(blocking, timeout)
        if got:
            _note_acquired(self)
        return got

    def release(self) -> None:
        self._ld_inner.release()
        _note_released(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._ld_inner.locked()

    def _at_fork_reinit(self) -> None:
        # stdlib (concurrent.futures.thread, threading internals) grabs
        # this off the lock for os.register_at_fork
        self._ld_inner._at_fork_reinit()
        _tls.__dict__.pop("held", None)
        # child is single-threaded here: parent threads' held lists are
        # meaningless (and their idents unreachable) — drop them
        _all_held.clear()

    def __repr__(self) -> str:
        return f"<tracked {self._ld_name} of {self._ld_inner!r}>"


class TrackedLock(_TrackedLockBase):
    _ld_kind = "Lock"

    def _make_inner(self):
        return _REAL_LOCK()

    # Condition-variable interop (threading.Condition picks these up when
    # present; the fallbacks it would synthesize skip our bookkeeping)
    def _release_save(self):
        self._ld_inner.release()
        _note_released(self, full=True)
        return None

    def _acquire_restore(self, _state) -> None:
        self._ld_inner.acquire()
        _note_acquired(self)

    def _is_owned(self) -> bool:
        # same heuristic CPython uses for non-recursive condition locks
        if self._ld_inner.acquire(False):
            self._ld_inner.release()
            return False
        return True


class TrackedRLock(_TrackedLockBase):
    _ld_kind = "RLock"

    def _make_inner(self):
        return _REAL_RLOCK()

    def release(self) -> None:
        self._ld_inner.release()
        _note_released(self)

    def _release_save(self):
        state = self._ld_inner._release_save()
        _note_released(self, full=True)
        return state

    def _acquire_restore(self, state) -> None:
        self._ld_inner._acquire_restore(state)
        _note_acquired(self)

    def _is_owned(self) -> bool:
        return self._ld_inner._is_owned()


def _lock_factory() -> TrackedLock:
    return TrackedLock()


def _rlock_factory() -> TrackedRLock:
    return TrackedRLock()


# ---------------------------------------------------------------------------
# install / inspect
# ---------------------------------------------------------------------------

def enabled() -> bool:
    return _GRAPH is not None


def install(raise_on_cycle: bool = True) -> None:
    """Start tracking: new ``threading.Lock``/``RLock`` (and everything
    built on them — Condition, Event, Queue, …) join the order graph.
    Locks created before install() stay untracked."""
    global _GRAPH, _RAISE
    if _GRAPH is None:
        _GRAPH = _Graph()
    _RAISE = raise_on_cycle
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory


def uninstall() -> None:
    """Restore the real factories and drop the graph."""
    global _GRAPH
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    _GRAPH = None
    held = getattr(_tls, "held", None)
    if held:
        # clear IN PLACE: the cross-thread registry aliases this list
        del held[:]


def cycle_reports() -> List[str]:
    """Cycle reports recorded so far (empty on a clean run)."""
    graph = _GRAPH
    return list(graph.cycles) if graph is not None else []


def edge_count() -> int:
    graph = _GRAPH
    if graph is None:
        return 0
    with graph._mu:
        return len(graph.edges)


def init_from_env() -> bool:
    """Install iff RAY_TPU_LOCKDEP=1 (called at ray_tpu import so every
    daemon process self-installs from its environment)."""
    if os.environ.get(ENV_VAR, "") in ("1", "true", "on"):
        install()
        return True
    return False
