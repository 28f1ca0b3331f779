"""Trainables: the unit of execution Tune schedules.

Port of `ray_tpu/tune/trainable.py`, unchanged but for the imports.
The trial actor imports no torch.

Reference: `python/ray/tune/trainable/trainable.py:58` (class API —
`step`/`save_checkpoint`/`load_checkpoint`) and
`python/ray/tune/trainable/function_trainable.py` (function API — the user
fn runs on a thread and talks to the controller through the session). Both
are hosted in a `_TrialActor`; the controller drives `step()`.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.train._internal import session as session_mod
from ray_tpu_torch.train._internal.session import SessionConfig


class Trainable:
    """Class API: subclass and implement setup/step/save/load."""

    def __init__(self):
        self.config: Dict[str, Any] = {}
        self.iteration = 0
        self.trial_id = "default"
        self.trial_dir = ""

    # -- overridable -------------------------------------------------------

    def setup(self, config: Dict[str, Any]) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def cleanup(self) -> None:
        pass

    def reset_config(self, new_config: Dict[str, Any]) -> bool:
        """Return True if the trainable supports in-place reconfiguration
        (used by PBT to avoid actor restarts)."""
        return False

    _restore_before_setup = False


def session_report(metrics: Dict[str, Any],
                   checkpoint: Optional[Checkpoint] = None) -> None:
    """`tune.report` — same session channel as `train.report`."""
    sess = session_mod.get_session()
    if sess is None:
        raise RuntimeError("tune.report called outside a trial")
    sess.report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    sess = session_mod.get_session()
    if sess is None:
        raise RuntimeError("tune.get_checkpoint called outside a trial")
    return sess.get_checkpoint()


class FunctionTrainable(Trainable):
    """Wraps `def fn(config)` into the Trainable interface.

    `step()` blocks until the fn's next `tune.report` (queue handoff), so
    the controller sees one result per step — reference
    `function_trainable.py` semantics.
    """

    _fn: Callable = None  # set by wrap_function subclass
    # The fn reads its restore checkpoint during setup (the session is
    # created there), so restore must be applied before setup — unlike the
    # class API, where setup() initializes state that restore overwrites.
    _restore_before_setup = True

    def setup(self, config: Dict[str, Any]) -> None:
        self._session = session_mod.init_session(SessionConfig(
            experiment_name="tune",
            storage_path=os.path.dirname(self.trial_dir) or "/tmp",
            world_rank=0, world_size=1, local_rank=0, local_world_size=1,
            node_rank=0,
            trial_id=self.trial_id,
            trial_dir=self.trial_dir,
            checkpoint=self._restore_checkpoint,
        ))
        sess = self._session
        fn = type(self)._fn

        def run():
            try:
                fn(config)
            except BaseException as e:  # noqa: BLE001 — surfaced via step()
                sess.error = e
            finally:
                sess.finished.set()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name=f"trial_{self.trial_id}")
        self._thread.start()

    _restore_checkpoint: Optional[Checkpoint] = None

    def step(self) -> Dict[str, Any]:
        import queue as queue_mod
        sess = self._session
        while True:
            try:
                item = sess.result_queue.get(timeout=1.0)
                metrics = dict(item["metrics"])
                if item.get("checkpoint_path"):
                    metrics["_checkpoint_path"] = item["checkpoint_path"]
                return metrics
            except queue_mod.Empty:
                if sess.finished.is_set() and sess.result_queue.empty():
                    if sess.error is not None:
                        raise sess.error
                    return {"_trial_finished": True}

    def save_checkpoint(self, checkpoint_dir: str) -> None:
        # Function trainables checkpoint through tune.report(checkpoint=…);
        # the session already persisted it. Nothing to do here.
        pass

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        self._restore_checkpoint = Checkpoint(checkpoint_dir)


def wrap_function(fn: Callable) -> type:
    """Make a FunctionTrainable subclass for `fn` (reference
    `tune/trainable/util.py` wrap_function)."""
    name = getattr(fn, "__name__", "fn")
    return type(f"Trainable_{name}", (FunctionTrainable,), {"_fn": fn})


class _TrialActor:
    """The actor hosting one trainable (reference: the Trainable actor the
    TuneController starts per trial)."""

    def __init__(self, trainable_cls: type, config: Dict[str, Any],
                 trial_id: str, trial_dir: str,
                 restore_from: Optional[str] = None,
                 start_iteration: int = 0):
        os.makedirs(trial_dir, exist_ok=True)
        self._trainable: Trainable = trainable_cls()
        self._trainable.trial_id = trial_id
        self._trainable.trial_dir = trial_dir
        self._trainable.config = config
        self._trainable.iteration = start_iteration
        self._restore_from = restore_from
        self._setup_done = False
        self._config = config

    def _ensure_setup(self):
        if self._setup_done:
            return
        restore = self._restore_from
        if restore and self._trainable._restore_before_setup:
            self._trainable.load_checkpoint(restore)
        self._trainable.setup(self._config)
        if restore and not self._trainable._restore_before_setup:
            self._trainable.load_checkpoint(restore)
        self._setup_done = True

    def step(self) -> Dict[str, Any]:
        self._ensure_setup()
        result = self._trainable.step()
        self._trainable.iteration += 1
        result.setdefault("training_iteration", self._trainable.iteration)
        return result

    def save(self) -> str:
        """Persist a checkpoint dir, return its path (class-API path; the
        function API saves through report)."""
        self._ensure_setup()
        d = os.path.join(self._trainable.trial_dir,
                         f"checkpoint_iter_{self._trainable.iteration:06d}")
        os.makedirs(d, exist_ok=True)
        self._trainable.save_checkpoint(d)
        return d

    def reset(self, new_config: Dict[str, Any]) -> bool:
        ok = self._trainable.reset_config(new_config)
        if ok:
            self._trainable.config = new_config
            self._config = new_config
        return ok

    def stop(self) -> None:
        try:
            self._trainable.cleanup()
        except Exception:
            pass
