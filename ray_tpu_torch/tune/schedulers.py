"""Trial schedulers: FIFO, ASHA, HyperBand, Median-stopping, PBT.

Port of `ray_tpu/tune/schedulers.py`, unchanged: the same result
stream gives the same decisions as the JAX package's schedulers.

Reference: `python/ray/tune/schedulers/` — `async_hyperband.py:19` (ASHA),
`hyperband.py:42`, `median_stopping_rule.py`, `pbt.py:221`. The controller
calls `on_trial_result` for every report and acts on the returned decision;
PBT additionally drives exploit/explore through the controller's
checkpoint/restart hooks.
"""

from __future__ import annotations

import math
import random
from collections import defaultdict
from typing import Any, Dict, List, Optional


class TrialScheduler:
    CONTINUE = "CONTINUE"
    STOP = "STOP"

    def set_metric(self, metric: str, mode: str) -> None:
        """Fill in metric/mode from TuneConfig unless the scheduler was
        constructed with explicit values."""
        if getattr(self, "metric", None) is None:
            self.metric = metric
        if getattr(self, "mode", None) is None:
            self.mode = mode

    def _sign(self) -> int:
        return 1 if (self.mode or "max") == "max" else -1

    def on_trial_add(self, controller, trial) -> None:
        pass

    def on_trial_result(self, controller, trial, result: Dict) -> str:
        return self.CONTINUE

    def on_trial_complete(self, controller, trial, result: Dict) -> None:
        pass


class FIFOScheduler(TrialScheduler):
    pass


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (reference `async_hyperband.py:19`): asynchronous successive
    halving — at each rung milestone a trial stops unless it is in the top
    1/reduction_factor of results recorded at that rung."""

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 time_attr: str = "training_iteration",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: float = 4, brackets: int = 1):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        # rung levels: grace * rf^k up to max_t
        self.rungs: List[float] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        # rung -> recorded metric values
        self._rung_results: Dict[float, List[float]] = defaultdict(list)
        self._trial_rung: Dict[str, int] = {}

    def _val(self, result: Dict) -> float:
        return self._sign() * float(result[self.metric])

    def on_trial_add(self, controller, trial) -> None:
        self._trial_rung[trial.trial_id] = 0

    def on_trial_result(self, controller, trial, result: Dict) -> str:
        if self.metric not in result or self.time_attr not in result:
            return self.CONTINUE
        t = result[self.time_attr]
        if t >= self.max_t:
            return self.STOP
        rung_i = self._trial_rung.get(trial.trial_id, 0)
        decision = self.CONTINUE
        while rung_i < len(self.rungs) and t >= self.rungs[rung_i]:
            rung = self.rungs[rung_i]
            val = self._val(result)
            recorded = self._rung_results[rung]
            recorded.append(val)
            cutoff_n = max(1, int(len(recorded) / self.rf))
            top = sorted(recorded, reverse=True)[:cutoff_n]
            if val < top[-1]:
                decision = self.STOP
            rung_i += 1
        self._trial_rung[trial.trial_id] = rung_i
        return decision


# the reference exports ASHA under both names
ASHAScheduler = AsyncHyperBandScheduler


class HyperBandScheduler(TrialScheduler):
    """Bracketed successive halving (reference `hyperband.py:42`).

    Trials are assigned round-robin to brackets with different grace
    periods; each bracket is an ASHA instance (asynchronous-mode
    simplification of the reference's synchronized brackets).
    """

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 time_attr: str = "training_iteration",
                 max_t: int = 81, reduction_factor: float = 3):
        self.metric = metric
        self.mode = mode
        s_max = int(math.log(max_t) / math.log(reduction_factor))
        self._brackets = [
            AsyncHyperBandScheduler(
                metric=metric, mode=mode, time_attr=time_attr, max_t=max_t,
                grace_period=max(1, int(max_t * reduction_factor ** (-s))),
                reduction_factor=reduction_factor)
            for s in range(s_max + 1)
        ]
        self._assignment: Dict[str, AsyncHyperBandScheduler] = {}
        self._next = 0

    def set_metric(self, metric: str, mode: str) -> None:
        super().set_metric(metric, mode)
        for b in self._brackets:
            b.set_metric(metric, mode)

    def on_trial_add(self, controller, trial) -> None:
        b = self._brackets[self._next % len(self._brackets)]
        self._next += 1
        self._assignment[trial.trial_id] = b
        b.on_trial_add(controller, trial)

    def on_trial_result(self, controller, trial, result: Dict) -> str:
        return self._assignment[trial.trial_id].on_trial_result(
            controller, trial, result)


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best result is worse than the median of running
    averages at the same timestep (reference `median_stopping_rule.py`)."""

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._history: Dict[str, List[float]] = defaultdict(list)

    def _val(self, result: Dict) -> float:
        return self._sign() * float(result[self.metric])

    def on_trial_result(self, controller, trial, result: Dict) -> str:
        if self.metric not in result:
            return self.CONTINUE
        t = result.get(self.time_attr, 0)
        self._history[trial.trial_id].append(self._val(result))
        if t < self.grace_period or \
                len(self._history) < self.min_samples:
            return self.CONTINUE
        avgs = [sum(h) / len(h) for tid, h in self._history.items()
                if tid != trial.trial_id and h]
        if len(avgs) + 1 < self.min_samples:
            return self.CONTINUE
        avgs.sort()
        median = avgs[len(avgs) // 2]
        best = max(self._history[trial.trial_id])
        return self.STOP if best < median else self.CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference `pbt.py:221`): every `perturbation_interval` steps,
    bottom-quantile trials exploit a top-quantile donor's checkpoint and
    explore a perturbed config. The controller supplies
    `checkpoint_trial(trial)` and `exploit_trial(trial, config, ckpt)`.
    """

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self.rng = random.Random(seed)
        self._last_perturb: Dict[str, int] = {}
        self._latest: Dict[str, float] = {}
        self._ckpts: Dict[str, str] = {}

    def _val(self, result: Dict) -> float:
        return self._sign() * float(result[self.metric])

    def _mutate(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """Explore: perturb each mutation key by 0.8/1.2x or resample
        (reference `pbt.py` `_explore`)."""
        new = dict(config)
        for key, spec in self.mutations.items():
            if self.rng.random() < self.resample_prob or \
                    key not in new or not isinstance(new[key], (int, float)):
                if callable(spec):
                    new[key] = spec()
                elif isinstance(spec, list):
                    new[key] = self.rng.choice(spec)
                elif hasattr(spec, "sample"):
                    new[key] = spec.sample(self.rng)
            else:
                factor = self.rng.choice([0.8, 1.2])
                val = new[key] * factor
                if isinstance(spec, list):
                    # snap to nearest allowed value
                    val = min(spec, key=lambda s: abs(s - val))
                new[key] = type(config[key])(val) \
                    if isinstance(config[key], int) else val
        return new

    def on_trial_result(self, controller, trial, result: Dict) -> str:
        if self.metric not in result:
            return self.CONTINUE
        t = result.get(self.time_attr, 0)
        tid = trial.trial_id
        self._latest[tid] = self._val(result)
        last = self._last_perturb.get(tid, 0)
        if t - last < self.interval:
            return self.CONTINUE
        self._last_perturb[tid] = t
        # refresh this trial's checkpoint so others can exploit it
        try:
            self._ckpts[tid] = controller.checkpoint_trial(trial)
        except Exception:
            pass
        scores = sorted(self._latest.items(), key=lambda kv: kv[1])
        n = len(scores)
        if n < 2:
            return self.CONTINUE
        k = max(1, int(n * self.quantile))
        bottom = {tid_ for tid_, _ in scores[:k]}
        top = [tid_ for tid_, _ in scores[-k:]]
        if tid in bottom:
            donors = [d for d in top if d in self._ckpts and d != tid]
            if donors:
                donor = self.rng.choice(donors)
                donor_trial = controller.get_trial(donor)
                new_config = self._mutate(donor_trial.config)
                controller.exploit_trial(trial, new_config,
                                         self._ckpts[donor])
                self._on_exploit(tid)
        return self.CONTINUE

    def _on_exploit(self, trial_id: str) -> None:
        """Hook for subclasses observing exploit events (PB2 resets its
        reward-improvement baseline so the donor-checkpoint score jump
        is never credited to the new config)."""


class PB2(PopulationBasedTraining):
    """Population-Based Bandits (reference `tune/schedulers/pb2.py`):
    PBT's exploit machinery, but explore selects new hyperparameters by
    GP-UCB over the observed (time, config) -> reward-improvement
    surface instead of random 0.8x/1.2x perturbation — far more sample
    efficient for small populations.

    The reference wraps GPy; here the GP is ~40 lines of numpy (RBF
    kernel, fixed lengthscale in the normalized unit cube, jittered
    Cholesky solve) — no external dependency, same acquisition shape
    (UCB over random candidates within `hyperparam_bounds`).
    """

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 4,
                 hyperparam_bounds: Optional[
                     Dict[str, List[float]]] = None,
                 quantile_fraction: float = 0.25,
                 ucb_kappa: float = 2.0,
                 num_candidates: int = 256,
                 seed: Optional[int] = None):
        if not hyperparam_bounds:
            raise ValueError("PB2 requires hyperparam_bounds="
                             "{name: [low, high], ...}")
        super().__init__(metric=metric, mode=mode, time_attr=time_attr,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations={},
                         quantile_fraction=quantile_fraction, seed=seed)
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in hyperparam_bounds.items()}
        self.kappa = ucb_kappa
        self.num_candidates = num_candidates
        # observation rows: [t, hp..., reward-improvement-per-step]
        self._obs: List[List[float]] = []
        self._seg_start: Dict[str, tuple] = {}  # tid -> (t, raw score)

    # -- data collection ---------------------------------------------------

    def on_trial_add(self, controller, trial) -> None:
        missing = [k for k in self.bounds if k not in trial.config]
        if missing:
            raise ValueError(
                f"hyperparam_bounds keys {missing} not present in trial "
                f"config {sorted(trial.config)} — PB2 would silently "
                f"optimize nothing")

    def _on_exploit(self, trial_id: str) -> None:
        # drop the exploited trial's segment baseline: its next report
        # starts from the donor checkpoint, and crediting that score
        # jump to the freshly selected config would poison the GP
        self._seg_start.pop(trial_id, None)

    def on_trial_result(self, controller, trial, result: Dict) -> str:
        if self.metric in result:
            t = float(result.get(self.time_attr, 0))
            score = self._val(result)
            tid = trial.trial_id
            if tid in self._seg_start:
                t0, s0 = self._seg_start[tid]
                if t > t0:
                    row = [t]
                    row += [float(trial.config.get(k, lo))
                            for k, (lo, _) in self.bounds.items()]
                    row.append((score - s0) / (t - t0))
                    self._obs.append(row)
                    if len(self._obs) > 500:  # bound GP cost
                        self._obs = self._obs[-500:]
            self._seg_start[tid] = (t, score)
        return super().on_trial_result(controller, trial, result)

    # -- GP-UCB explore (replaces PBT's random perturbation) ---------------

    def _mutate(self, config: Dict[str, Any]) -> Dict[str, Any]:
        import numpy as np

        new = dict(config)
        keys = list(self.bounds)
        if len(self._obs) < 4:
            # cold start: uniform sample within bounds
            for k in keys:
                lo, hi = self.bounds[k]
                new[k] = self._cast(config.get(k), lo + (hi - lo)
                                    * self.rng.random())
            return new

        data = np.asarray(self._obs, np.float64)
        X_raw, y = data[:, :-1], data[:, -1]
        # normalize X to the unit cube (time axis by its observed range)
        lows = np.array([X_raw[:, 0].min()]
                        + [self.bounds[k][0] for k in keys])
        highs = np.array([max(X_raw[:, 0].max(), lows[0] + 1e-9)]
                         + [self.bounds[k][1] for k in keys])
        X = (X_raw - lows) / np.maximum(highs - lows, 1e-12)
        y_mu, y_sd = y.mean(), max(y.std(), 1e-9)
        yn = (y - y_mu) / y_sd

        ls, noise = 0.3, 1e-3
        def kern(A, B):
            d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
            return np.exp(-d2 / (2 * ls * ls))

        K = kern(X, X) + noise * np.eye(len(X))
        L = np.linalg.cholesky(K + 1e-8 * np.eye(len(X)))
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))

        # candidates at the latest OBSERVED normalized time — X[:, 0]
        # collapses to 0 when all rows share one time value, and pinning
        # candidates at 1.0 would then put them ~1 unit away from every
        # observation (mu~0, var~1: uniform-random selection in GP garb)
        rs = np.random.default_rng(self.rng.randrange(2 ** 31))
        cand = rs.uniform(size=(self.num_candidates, len(keys) + 1))
        cand[:, 0] = X[:, 0].max()
        Ks = kern(cand, X)
        mu = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)
        var = np.maximum(1.0 - (v * v).sum(0), 1e-12)
        ucb = mu + self.kappa * np.sqrt(var)
        best = cand[int(ucb.argmax())]
        for i, k in enumerate(keys):
            lo, hi = self.bounds[k]
            new[k] = self._cast(config.get(k), lo + (hi - lo)
                                * float(best[i + 1]))
        return new

    @staticmethod
    def _cast(old, val):
        return int(round(val)) if isinstance(old, int) else float(val)
