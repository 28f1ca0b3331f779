"""LearnerGroup: scale a Learner's update to N learner actors.

Port of `ray_tpu/rllib/core/learner_group.py` onto the port's runtime.
Reference: `rllib/core/learner/learner_group.py:69` — N learner actors,
each updating a replica of the module with gradients allreduced across the
group (the reference wraps modules in torch DDP,
`core/learner/torch/torch_learner.py:265,387-389`).

As in the JAX package, the group is synchronous data parallelism over
actors: the train batch is split into per-learner shards (entries in the
learner class's `BROADCAST_KEYS` go whole to every learner), each learner
computes gradients on its shard, the group averages them on the host, and
every learner applies the same averaged update, so the replicas stay
identical. A learner actor holds its card through
``resources_per_learner={"GPU": 1}``; its updates run there as graphs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Type

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.utils.actor_manager import (
    ACTOR_THREADS, FaultTolerantActorManager)


def _tree_average(grads_list: List[Dict[str, np.ndarray]]
                  ) -> Dict[str, np.ndarray]:
    """Elementwise mean over a list of ``{name: array}`` dicts."""
    return {k: np.mean(np.stack([g[k] for g in grads_list]), axis=0)
            for k in grads_list[0]}


def _split_batch(batch: Dict[str, np.ndarray], n: int,
                 broadcast_keys=Learner.BROADCAST_KEYS
                 ) -> List[Dict[str, np.ndarray]]:
    if n <= 0:
        raise RuntimeError("all learners failed")
    bcast = {k: v for k, v in batch.items() if k in broadcast_keys}
    rows_batch = {k: v for k, v in batch.items() if k not in bcast}
    rows = min(v.shape[0] for v in rows_batch.values())
    per = rows // n
    if per == 0:
        # fewer rows than learners: everyone sees the whole batch
        return [batch] * n
    return [{**{k: v[i * per:(i + 1) * per]
                for k, v in rows_batch.items()}, **bcast}
            for i in range(n)]


class LearnerGroup:
    """Drives one local Learner or a fleet of learner actors in sync.

    ``num_learners=0`` runs the learner in-process (the reference's local
    mode); otherwise ``num_learners`` actors are spawned and kept
    weight-synchronized through averaged-gradient application. ``device``
    is each learner's (default ``"cuda"``).
    """

    def __init__(self, learner_cls: Type[Learner], spec: RLModuleSpec,
                 config: Optional[Dict[str, Any]] = None,
                 num_learners: int = 0, num_devices_per_learner: int = 1,
                 seed: int = 0,
                 resources_per_learner: Optional[Dict[str, float]] = None,
                 device=None):
        self.num_learners = num_learners
        self._broadcast_keys = learner_cls.BROADCAST_KEYS
        self._local: Optional[Learner] = None
        self._manager: Optional[FaultTolerantActorManager] = None
        args = (spec, config, seed, num_devices_per_learner, device)
        if num_learners == 0:
            self._local = learner_cls(*args)
        else:
            remote_cls = ray_tpu_torch.remote(learner_cls)
            if resources_per_learner:
                remote_cls = remote_cls.options(
                    resources=resources_per_learner)
            args += (ACTOR_THREADS,)
            actors = [remote_cls.remote(*args) for _ in range(num_learners)]
            # A restarted learner rejoins with fresh params; the next
            # weight sync (set_weights broadcast below) realigns it.
            self._manager = FaultTolerantActorManager(
                actors, restart_fn=lambda: remote_cls.remote(*args))

    @property
    def local_learner(self) -> Optional[Learner]:
        """The in-process learner (``num_learners=0``), else None."""
        return self._local

    # -- update ------------------------------------------------------------

    def update_from_batch(self, batch: Dict[str, np.ndarray]
                          ) -> Dict[str, float]:
        """One synchronous group update; returns averaged stats."""
        if self._local is not None:
            return self._local.update_from_batch(batch)
        mgr = self._manager
        self._resync_restarted()
        actors = mgr.actors
        if not actors:
            raise RuntimeError("all learners failed")
        shards = _split_batch(batch, len(actors), self._broadcast_keys)
        results = mgr.foreach_zip(
            lambda a, shard: a.compute_gradients.remote(shard), shards)
        if not results:
            raise RuntimeError("all learners failed")
        grads = _tree_average([g for g, _ in results])
        mgr.foreach(lambda a: a.apply_gradients.remote(grads))
        # a failure during this update restarted a replica with fresh
        # random params — realign it before the next update reads weights
        self._resync_restarted()
        stats_list = [s for _, s in results]
        return {k: float(np.mean([s[k] for s in stats_list]))
                for k in stats_list[0]}

    def _resync_restarted(self) -> None:
        """Broadcast full state from a surviving replica to the fleet
        whenever the manager restarted an actor (restarts come back with
        random init and would silently diverge otherwise). The sync source
        must itself be a non-restarted survivor."""
        mgr = self._manager
        if mgr is None:
            return
        restarted = mgr.take_restarted()
        if not restarted:
            return
        state = mgr.foreach_one(lambda a: a.get_state.remote(),
                                exclude=restarted)
        if state:
            mgr.foreach(lambda a: a.set_state.remote(state[0]))

    # -- weights / state ---------------------------------------------------

    def get_weights(self):
        if self._local is not None:
            return self._local.get_weights()
        (w,) = self._manager.foreach_one(
            lambda a: a.get_weights.remote())
        return w

    def set_weights(self, weights) -> None:
        if self._local is not None:
            self._local.set_weights(weights)
        else:
            self._manager.foreach(
                lambda a: a.set_weights.remote(weights))

    def get_state(self) -> Dict[str, Any]:
        if self._local is not None:
            return self._local.get_state()
        (s,) = self._manager.foreach_one(lambda a: a.get_state.remote())
        return s

    def set_state(self, state: Dict[str, Any]) -> None:
        if self._local is not None:
            self._local.set_state(state)
        else:
            self._manager.foreach(lambda a: a.set_state.remote(state))

    # -- DQN extras (forwarded so Algorithm code is mode-agnostic) ---------

    def td_errors(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        if self._local is not None:
            return self._local.td_errors(batch)
        (td,) = self._manager.foreach_one(
            lambda a: a.td_errors.remote(batch))
        return td

    def stop(self) -> None:
        if self._manager is not None:
            self._manager.stop()
