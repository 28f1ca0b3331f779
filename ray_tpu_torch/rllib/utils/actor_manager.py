"""FaultTolerantActorManager.

Port of `ray_tpu/rllib/utils/actor_manager.py` onto the port's runtime,
unchanged but for the imports, plus `set_actor_threads` (the torch
threads of the env-runner and learner actors).

Reference: `rllib/utils/actor_manager.py:196` — fan-out RPCs to a fleet,
mark unhealthy actors, and restore them; used by EnvRunnerGroup (and
LearnerGroup) so a dead sampler never sinks the training loop.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, List, Optional

import ray_tpu_torch


# torch threads of an env-runner or learner actor (each holds one CPU)
ACTOR_THREADS = 1


def set_actor_threads(num_threads: Optional[int]) -> None:
    """Size torch's intra-op pool to an actor's CPUs. An actor holds one
    CPU, and pools as large as the host's spin against each other (two
    runners sampling at once ran many times slower than one); None leaves
    the process's setting (an in-process runner or learner shares the
    driver's)."""
    if num_threads is not None:
        import torch

        torch.set_num_threads(num_threads)


class FaultTolerantActorManager:
    def __init__(self, actors: List[Any],
                 restart_fn: Optional[Callable[..., Any]] = None,
                 max_restarts: int = 3):
        # restart_fn may take zero args or the dead actor's index —
        # index-aware factories let callers rebuild per-actor state
        # (e.g. the runner's unique RNG seed) instead of a shared default.
        self._actors = list(actors)
        self._healthy = [True] * len(actors)
        self._restart_fn = restart_fn
        self._restart_takes_index = bool(
            restart_fn is not None
            and inspect.signature(restart_fn).parameters)
        self._restarts = [0] * len(actors)
        self.max_restarts = max_restarts
        self._restarted_idxs: set = set()

    def num_healthy(self) -> int:
        return sum(self._healthy)

    @property
    def actors(self) -> List[Any]:
        return [a for a, h in zip(self._actors, self._healthy) if h]

    def _gather(self, refs: List[Any], idxs: List[int],
                timeout: float) -> List[Any]:
        """Collect results, marking failed actors unhealthy (and
        restarting them when possible). Shared failure path for every
        fan-out variant."""
        results = []
        for i, ref in zip(idxs, refs):
            try:
                results.append(ray_tpu_torch.get(ref, timeout=timeout))
            except Exception:
                self._mark_unhealthy(i)
        return results

    def foreach(self, fn: Callable[[Any], Any],
                timeout: float = 300.0) -> List[Any]:
        """fn(actor) -> ObjectRef for each healthy actor; returns results
        from the actors that succeeded."""
        return self.foreach_zip(lambda a, _item: fn(a),
                                [None] * len(self._actors),
                                timeout=timeout)

    def foreach_zip(self, fn: Callable[[Any, Any], Any], items: List[Any],
                    timeout: float = 300.0) -> List[Any]:
        """fn(actor, item) -> ObjectRef, pairing healthy actors with items
        positionally; failures are marked unhealthy and dropped."""
        refs, idxs = [], []
        healthy = [(i, a) for i, (a, h)
                   in enumerate(zip(self._actors, self._healthy)) if h]
        for (i, a), item in zip(healthy, items):
            refs.append(fn(a, item))
            idxs.append(i)
        return self._gather(refs, idxs, timeout)

    def foreach_one(self, fn: Callable[[Any], Any],
                    timeout: float = 300.0,
                    exclude: Optional[set] = None) -> List[Any]:
        """fn on the first healthy actor only (skipping ``exclude``
        indices while an alternative exists); returns a one-element list
        (empty if every actor is dead)."""
        order = [i for i, h in enumerate(self._healthy) if h]
        if exclude:
            preferred = [i for i in order if i not in exclude]
            order = preferred + [i for i in order if i in exclude]
        for i in order:
            if not self._healthy[i]:
                continue
            got = self._gather([fn(self._actors[i])], [i], timeout)
            if got:
                return got
        return []

    def _mark_unhealthy(self, i: int) -> None:
        self._healthy[i] = False
        if self._restart_fn is not None and \
                self._restarts[i] < self.max_restarts:
            try:
                ray_tpu_torch.kill(self._actors[i])
            except Exception:
                pass
            if self._restart_takes_index:
                self._actors[i] = self._restart_fn(i)
            else:
                self._actors[i] = self._restart_fn()
            self._restarts[i] += 1
            self._healthy[i] = True
            self._restarted_idxs.add(i)

    def take_restarted(self) -> set:
        """Indices of actors restarted since the last call — callers that
        replicate state across the fleet (LearnerGroup) must re-sync the
        fresh replicas (from a NON-restarted survivor) when non-empty."""
        fired = self._restarted_idxs
        self._restarted_idxs = set()
        return fired

    def probe_health(self, timeout: float = 10.0) -> int:
        """Ping every actor (even marked-unhealthy ones after restart)."""
        for i, a in enumerate(self._actors):
            try:
                ray_tpu_torch.get(a.ping.remote(), timeout=timeout)
                self._healthy[i] = True
            except Exception:
                self._mark_unhealthy(i)
        return self.num_healthy()

    def stop(self) -> None:
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        self._healthy = [False] * len(self._actors)
