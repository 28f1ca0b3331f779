"""The Tune event loop.

Port of `ray_tpu/tune/tune_controller.py`: a trial's `GPU` resource maps
to the actor's ``num_gpus`` where the JAX package maps `TPU` to
``num_tpus``; otherwise unchanged but for the imports.

Reference: `python/ray/tune/execution/tune_controller.py:68` — one
Trainable actor per trial; the controller pumps `step()` calls, feeds
results to searcher/scheduler/stopper/loggers, restarts failed trials from
their last checkpoint, and serves PBT's exploit hook.

Experiment-level persistence (reference
`python/ray/tune/execution/experiment_state.py`): after every state
transition the controller atomically writes `experiment_state.pkl` into
the experiment dir — the trial table plus the live searcher/scheduler/
stopper objects — so `Tuner.restore(path, trainable)` can resume a sweep
whose driver died.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.tune import experiment as exp
from ray_tpu_torch.tune.experiment import Trial
from ray_tpu_torch.tune.loggers import LoggerCallback
from ray_tpu_torch.tune.schedulers import TrialScheduler
from ray_tpu_torch.tune.search import Searcher
from ray_tpu_torch.tune.stopper import Stopper
from ray_tpu_torch.tune.trainable import _TrialActor


class TuneController:
    def __init__(
        self,
        trainable_cls: type,
        *,
        searcher: Searcher,
        scheduler: TrialScheduler,
        stopper: Stopper,
        loggers: List[LoggerCallback],
        experiment_dir: str,
        max_concurrent: int = 0,
        max_failures: int = 0,
        trial_resources: Optional[Dict[str, float]] = None,
        metric: Optional[str] = None,
        mode: str = "max",
        max_trials: Optional[int] = None,
        restored_trials: Optional[List[Trial]] = None,
        searcher_done: bool = False,
        time_budget_s: Optional[float] = None,
    ):
        self.trainable_cls = trainable_cls
        self.searcher = searcher
        self.scheduler = scheduler
        self.stopper = stopper
        self.loggers = loggers
        self.experiment_dir = experiment_dir
        self.max_concurrent = max_concurrent
        self.max_failures = max_failures
        self.trial_resources = trial_resources or {"CPU": 1.0}
        self.metric = metric
        self.mode = mode
        if metric:
            self.scheduler.set_metric(metric, mode)
        self.max_trials = max_trials
        self.time_budget_s = time_budget_s
        self.trials: List[Trial] = list(restored_trials or [])
        self._actors: Dict[str, Any] = {}
        self._pending_step: Dict[Any, str] = {}  # step ref -> trial_id
        self._actor_cls = ray_tpu_torch.remote(_TrialActor)
        self._searcher_done = searcher_done
        self.state_path = os.path.join(experiment_dir,
                                       "experiment_state.pkl")
        self._save_failed_warned = False
        self._in_abort = False
        self._last_save = 0.0
        # min seconds between periodic snapshots (the full state —
        # searcher + every trial's metrics_history — is re-pickled each
        # save, so per-result saves would cost O(results^2) over a long
        # sweep; reference Tune throttles experiment checkpointing the
        # same way). Terminal transitions always save immediately.
        self.save_period_s = 2.0

    # -- experiment-state persistence --------------------------------------

    def _save_state(self, periodic: bool = False) -> None:
        """Write-ahead experiment snapshot. The searcher/scheduler/stopper
        are pickled live so their internal state (TPE history, ASHA rungs,
        RNG positions) survives a driver death; trials are plain
        dataclasses. Atomic replace so a crash mid-write never corrupts a
        resumable state file. Suppressed during abort cleanup: an
        in-process crash must not overwrite the last healthy snapshot with
        trials force-marked ERROR (a Python exception should resume no
        worse than a SIGKILL)."""
        if self._in_abort:
            return
        if periodic and time.monotonic() - self._last_save < \
                self.save_period_s:
            return
        self._last_save = time.monotonic()
        import cloudpickle
        state = {
            "trials": self.trials,
            "searcher": self.searcher,
            "scheduler": self.scheduler,
            "stopper": self.stopper,
            "metric": self.metric,
            "mode": self.mode,
            "max_trials": self.max_trials,
            "trial_resources": self.trial_resources,
            "max_failures": self.max_failures,
            "max_concurrent": self.max_concurrent,
            "searcher_done": self._searcher_done,
            "time_budget_s": self.time_budget_s,
        }
        tmp = self.state_path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                cloudpickle.dump(state, f)
            os.replace(tmp, self.state_path)
        except Exception as e:
            # persistence is best-effort; never take down a live sweep —
            # but say so once, or Tuner.restore will fail mysteriously
            if not self._save_failed_warned:
                self._save_failed_warned = True
                import logging
                logging.getLogger(__name__).warning(
                    "could not persist experiment state to %s (%s); "
                    "Tuner.restore will not work for this sweep",
                    self.state_path, e)
            try:
                os.unlink(tmp)
            except OSError:
                pass

    @staticmethod
    def load_state(experiment_dir: str) -> Dict[str, Any]:
        import pickle
        path = os.path.join(experiment_dir, "experiment_state.pkl")
        with open(path, "rb") as f:
            return pickle.load(f)

    # -- public hooks used by schedulers (PBT) -----------------------------

    def get_trial(self, trial_id: str) -> Trial:
        for t in self.trials:
            if t.trial_id == trial_id:
                return t
        raise KeyError(trial_id)

    def checkpoint_trial(self, trial: Trial) -> str:
        """Latest checkpoint path for a trial. Function trainables
        checkpoint through report() (their save() would write an empty
        dir); class trainables save on demand so the donor state is fresh."""
        from ray_tpu_torch.tune.trainable import FunctionTrainable
        if issubclass(self.trainable_cls, FunctionTrainable):
            if not trial.checkpoint_path:
                raise RuntimeError(
                    f"trial {trial.trial_id} has not reported a checkpoint; "
                    "PBT with function trainables requires "
                    "tune.report(..., checkpoint=...)")
            return trial.checkpoint_path
        actor = self._actors.get(trial.trial_id)
        if actor is None:
            raise RuntimeError(f"trial {trial.trial_id} has no live actor")
        path = ray_tpu_torch.get(actor.save.remote(), timeout=60)
        trial.checkpoint_path = path
        return path

    def exploit_trial(self, trial: Trial, new_config: Dict[str, Any],
                      checkpoint_path: str) -> None:
        """PBT exploit/explore: restart `trial` from a donor checkpoint
        with a mutated config (reference `pbt.py` `_exploit`)."""
        self._stop_actor(trial, kill=True)
        trial.config = new_config
        trial.checkpoint_path = checkpoint_path
        self._start_actor(trial, restore_from=checkpoint_path)

    # -- actor management --------------------------------------------------

    def _start_actor(self, trial: Trial, restore_from: Optional[str] = None):
        res = dict(self.trial_resources)
        num_cpus = res.pop("CPU", 1.0)
        num_gpus = res.pop("GPU", None)
        opts: Dict[str, Any] = dict(num_cpus=num_cpus, resources=res,
                                    max_concurrency=2)
        if num_gpus:
            opts["num_gpus"] = num_gpus
        # training_iteration continues across restarts (retry / PBT exploit)
        start_iteration = (trial.last_result or {}).get(
            "training_iteration", 0)
        actor = self._actor_cls.options(**opts).remote(
            self.trainable_cls, trial.config, trial.trial_id,
            trial.trial_dir, restore_from, start_iteration)
        self._actors[trial.trial_id] = actor
        trial.status = exp.RUNNING
        ref = actor.step.remote()
        self._pending_step[ref] = trial.trial_id

    def _stop_actor(self, trial: Trial, kill: bool = False) -> None:
        actor = self._actors.pop(trial.trial_id, None)
        # drop any in-flight step ref for this trial — and CANCEL it, so
        # a straggling step is preempted instead of running to completion
        # under a doomed actor (reference: ray.cancel-based preemption;
        # the subsequent kill is the backstop for non-cooperative steps)
        for ref, tid in list(self._pending_step.items()):
            if tid == trial.trial_id:
                del self._pending_step[ref]
                try:
                    ray_tpu_torch.cancel(ref, recursive=True)
                except Exception:  # noqa: BLE001 — cancel is best-effort
                    pass
        if actor is None:
            return
        try:
            if not kill:
                ray_tpu_torch.get(actor.stop.remote(), timeout=10)
        except Exception:
            pass
        try:
            ray_tpu_torch.kill(actor)
        except Exception:
            pass

    def _terminate(self, trial: Trial, status: str,
                   error: Optional[str] = None) -> None:
        self._stop_actor(trial, kill=(status == exp.ERROR))
        trial.status = status
        trial.error = error
        self.searcher.on_trial_complete(
            trial.trial_id, trial.last_result, error=(status == exp.ERROR))
        self.scheduler.on_trial_complete(self, trial, trial.last_result or {})
        for lg in self.loggers:
            lg.on_trial_complete(trial)
        self._save_state()

    # -- main loop ---------------------------------------------------------

    def _suggest_next(self) -> Optional[Trial]:
        """Lazily pull one new trial from the searcher (so adaptive
        searchers see results before later suggests; reference controller
        generates trials on demand, not upfront)."""
        if self._searcher_done:
            return None
        if self.max_trials is not None and \
                len(self.trials) >= self.max_trials:
            return None
        t = Trial(config={}, resources=dict(self.trial_resources))
        cfg = self.searcher.suggest(t.trial_id)
        if cfg is None:
            self._searcher_done = True
            return None
        t.config = cfg
        t.trial_dir = os.path.join(self.experiment_dir, t.trial_id)
        self.trials.append(t)
        self.scheduler.on_trial_add(self, t)
        return t

    def _fill_slots(self) -> bool:
        """Start pending/new trials up to the concurrency cap. Returns
        whether anything changed (so the caller persists state only on
        real transitions, not every poll tick)."""
        running = sum(1 for t in self.trials if t.status == exp.RUNNING)
        changed = False
        while not self.max_concurrent or running < self.max_concurrent:
            trial = next((t for t in self.trials
                          if t.status == exp.PENDING), None)
            if trial is None:
                trial = self._suggest_next()
            if trial is None:
                return changed
            self._start_actor(trial, restore_from=trial.checkpoint_path)
            for lg in self.loggers:
                lg.on_trial_start(trial)
            running += 1
            changed = True
        return changed

    def run(self, timeout: Optional[float] = None) -> List[Trial]:
        # scheduler/searcher hooks may raise (e.g. PB2 validating its
        # hyperparam_bounds against a trial config) — never leak live
        # trial actors on the way out
        try:
            return self._run(timeout)
        except Exception:
            # kill actors but keep the last healthy on-disk snapshot:
            # trials stay RUNNING/PENDING there, so Tuner.restore resumes
            # them exactly as it would after a driver SIGKILL
            self._in_abort = True
            for t in self.trials:
                if not t.is_finished:
                    try:
                        self._terminate(t, exp.ERROR,
                                        error="controller aborted")
                    except Exception:  # noqa: BLE001
                        pass
            raise

    def _run(self, timeout: Optional[float] = None) -> List[Trial]:
        timeout = timeout if timeout is not None else self.time_budget_s
        deadline = time.monotonic() + timeout if timeout else None
        stop_all = False
        while True:
            if not stop_all and self._fill_slots():
                self._save_state()
            if not self._pending_step:
                break
            if deadline and time.monotonic() > deadline:
                for t in self.trials:
                    if not t.is_finished:
                        self._terminate(t, exp.TERMINATED)
                break
            ready, _ = ray_tpu_torch.wait(
                list(self._pending_step), num_returns=1, timeout=1.0)
            if not ready:
                continue
            ref = ready[0]
            trial_id = self._pending_step.pop(ref, None)
            if trial_id is None:
                continue
            trial = self.get_trial(trial_id)
            try:
                result = ray_tpu_torch.get(ref, timeout=30)
            except Exception as e:  # worker died or train fn raised
                trial.num_failures += 1
                self._stop_actor(trial, kill=True)
                if trial.num_failures <= self.max_failures or \
                        self.max_failures < 0:
                    trial.status = exp.PENDING  # restart from last ckpt
                else:
                    self._terminate(trial, exp.ERROR, error=str(e))
                self._save_state()
                continue
            if result.get("_trial_finished"):
                self._terminate(trial, exp.TERMINATED)
                continue
            self._on_result(trial, result)
            self._save_state(periodic=True)
            # A PBT exploit inside _on_result restarts the actor and
            # enqueues its own first step — don't double-pump.
            if trial.status == exp.RUNNING and \
                    trial.trial_id not in self._pending_step.values():
                actor = self._actors[trial.trial_id]
                nref = actor.step.remote()
                self._pending_step[nref] = trial.trial_id
            if self.stopper.stop_all():
                stop_all = True
                for t in self.trials:
                    if not t.is_finished:
                        self._terminate(t, exp.TERMINATED)
        return self.trials

    def _on_result(self, trial: Trial, result: Dict[str, Any]) -> None:
        ckpt = result.pop("_checkpoint_path", None)
        if ckpt:
            trial.checkpoint_path = ckpt
        trial.last_result = result
        trial.metrics_history.append(result)
        for lg in self.loggers:
            lg.on_trial_result(trial, result)
        self.searcher.on_trial_result(trial.trial_id, result)
        if self.stopper(trial.trial_id, result):
            self._terminate(trial, exp.TERMINATED)
            return
        decision = self.scheduler.on_trial_result(self, trial, result)
        if decision == TrialScheduler.STOP:
            self._terminate(trial, exp.TERMINATED)
