"""Tuner + TuneConfig + ResultGrid.

Port of `ray_tpu/tune/tuner.py`, unchanged but for the imports.

Reference: `python/ray/tune/tuner.py:44,344` (Tuner.fit),
`python/ray/tune/tune_config.py` (TuneConfig),
`python/ray/tune/result_grid.py` (ResultGrid).
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import uuid
from typing import Any, Callable, Dict, List, Optional, Union

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.tune.experiment import Trial
from ray_tpu_torch.tune.loggers import DEFAULT_LOGGERS
from ray_tpu_torch.tune.schedulers import FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher
from ray_tpu_torch.tune.stopper import resolve_stop_criteria
from ray_tpu_torch.tune.trainable import Trainable, wrap_function
from ray_tpu_torch.tune.tune_controller import TuneController


@dataclasses.dataclass
class TuneConfig:
    """Reference: `python/ray/tune/tune_config.py`."""

    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 0
    scheduler: Optional[TrialScheduler] = None
    search_alg: Optional[Searcher] = None
    trial_resources: Optional[Dict[str, float]] = None
    time_budget_s: Optional[float] = None
    seed: Optional[int] = None


class ResultGrid:
    """Reference: `python/ray/tune/result_grid.py`."""

    def __init__(self, results: List[Result], trials: List[Trial],
                 default_metric: Optional[str] = None,
                 default_mode: Optional[str] = None):
        self._results = results
        self._trials = trials
        self._default_metric = default_metric
        self._default_mode = default_mode

    def __getitem__(self, i: int) -> Result:
        return self._results[i]

    def __len__(self) -> int:
        return len(self._results)

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self) -> List[Exception]:
        return [r.error for r in self._results if r.error is not None]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        # default to the experiment's TuneConfig metric/mode (reference
        # semantics) so bare get_best_result() means what it says
        metric = metric or self._default_metric
        mode = mode or self._default_mode or "max"
        candidates = [r for r in self._results if r.metrics]
        if metric:
            candidates = [r for r in candidates if metric in r.metrics]
        if not candidates:
            raise ValueError("no trial produced results"
                             + (f" with metric {metric!r}" if metric else ""))
        if metric is None:
            return candidates[0]
        sign = 1 if mode == "max" else -1
        return max(candidates,
                   key=lambda r: sign * float(r.metrics[metric]))


class Tuner:
    def __init__(
        self,
        trainable: Union[Callable, type, "Any"],
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
    ):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._restore_path: Optional[str] = None
        self._resume_errored = False

    @classmethod
    def restore(cls, path: str, trainable: Union[Callable, type, "Any"],
                *, resume_errored: bool = False,
                run_config: Optional[RunConfig] = None) -> "Tuner":
        """Resume a sweep whose driver died (reference
        `python/ray/tune/tuner.py` Tuner.restore +
        `tune/execution/experiment_state.py`).

        `path` is the experiment dir (RunConfig.storage_path/name). Trials
        that were RUNNING or PENDING at death resume (from their last
        reported checkpoint when one exists); finished trials keep their
        results; ERROR trials re-run only with `resume_errored=True` (note:
        the searcher already recorded those trials as errored, so adaptive
        searchers won't incorporate their eventual scores — same caveat as
        the reference). Pass `run_config` to re-attach callbacks; the
        searcher/scheduler resume from their pickled mid-sweep state, so
        adaptive searchers do not re-suggest completed points.
        """
        if not os.path.exists(
                os.path.join(path, "experiment_state.pkl")):
            raise FileNotFoundError(
                f"no experiment_state.pkl under {path!r} — was this "
                "experiment run with this version?")
        tuner = cls(trainable, run_config=run_config)
        tuner._restore_path = path
        tuner._resume_errored = resume_errored
        return tuner

    def _fit_restored(self) -> ResultGrid:
        from ray_tpu_torch.tune import experiment as exp
        state = TuneController.load_state(self._restore_path)
        trainable_cls = self._resolve_trainable()
        for t in state["trials"]:
            if t.status == exp.RUNNING:
                t.status = exp.PENDING
            elif t.status == exp.ERROR and self._resume_errored:
                t.status = exp.PENDING
                t.error = None
                t.num_failures = 0
        loggers = [cls_() for cls_ in DEFAULT_LOGGERS]
        if self.run_config.callbacks:
            loggers.extend(self.run_config.callbacks)
        controller = TuneController(
            trainable_cls,
            searcher=state["searcher"],
            scheduler=state["scheduler"],
            stopper=state["stopper"],
            loggers=loggers,
            experiment_dir=self._restore_path,
            max_concurrent=state["max_concurrent"],
            max_failures=state["max_failures"],
            trial_resources=state["trial_resources"],
            metric=state["metric"],
            mode=state["mode"],
            max_trials=state["max_trials"],
            restored_trials=state["trials"],
            searcher_done=state["searcher_done"],
            time_budget_s=state.get("time_budget_s"),
        )
        trials = controller.run()
        return self._result_grid(trials, state["metric"], state["mode"])

    def _resolve_trainable(self) -> type:
        t = self.trainable
        if inspect.isclass(t) and issubclass(t, Trainable):
            return t
        if callable(t):
            return wrap_function(t)
        raise TypeError(f"invalid trainable: {t!r}")

    def fit(self) -> ResultGrid:
        if self._restore_path is not None:
            return self._fit_restored()
        trainable_cls = self._resolve_trainable()
        tc = self.tune_config
        if tc.search_alg is not None:
            searcher = tc.search_alg
            searcher.set_search_properties(tc.metric, tc.mode,
                                           self.param_space)
            # num_samples bounds custom searchers (reference semantics);
            # BasicVariantGenerator is self-limiting instead
            max_trials = tc.num_samples
        else:
            searcher = BasicVariantGenerator(
                self.param_space, num_samples=tc.num_samples, seed=tc.seed)
            max_trials = None
        scheduler = tc.scheduler or FIFOScheduler()
        name = self.run_config.name or \
            f"tune_{getattr(self.trainable, '__name__', 'exp')}_" \
            f"{uuid.uuid4().hex[:6]}"
        experiment_dir = os.path.join(self.run_config.storage_path, name)
        os.makedirs(experiment_dir, exist_ok=True)
        loggers = [cls() for cls in DEFAULT_LOGGERS]
        if self.run_config.callbacks:
            loggers.extend(self.run_config.callbacks)
        resources = tc.trial_resources or \
            getattr(trainable_cls, "_trainer_resources", None) or \
            {"CPU": 1.0}
        controller = TuneController(
            trainable_cls,
            searcher=searcher,
            scheduler=scheduler,
            stopper=resolve_stop_criteria(self.run_config.stop),
            loggers=loggers,
            experiment_dir=experiment_dir,
            max_concurrent=tc.max_concurrent_trials,
            max_failures=(self.run_config.failure_config.max_failures
                          if self.run_config.failure_config else 0),
            trial_resources=resources,
            metric=tc.metric,
            mode=tc.mode,
            max_trials=max_trials,
            time_budget_s=tc.time_budget_s,
        )
        trials = controller.run()
        return self._result_grid(trials, tc.metric, tc.mode)

    def _result_grid(self, trials: List[Trial],
                     metric: Optional[str], mode: Optional[str]) \
            -> ResultGrid:
        results = []
        for t in trials:
            metrics = dict(t.last_result) if t.last_result else None
            if metrics is not None:
                # every result carries its trial's config (reference:
                # result dicts always include "config"), so
                # Result.config / get_best_result().config just work
                metrics.setdefault("config", t.config)
            results.append(Result(
                metrics=metrics,
                checkpoint=(Checkpoint(t.checkpoint_path)
                            if t.checkpoint_path else None),
                error=(RuntimeError(t.error) if t.error else None),
                path=t.trial_dir,
                metrics_history=t.metrics_history,
            ))
        return ResultGrid(results, trials, default_metric=metric,
                          default_mode=mode)
