"""Search spaces + searchers.

Port of `ray_tpu/tune/search.py`, unchanged: the same seeds give the
same suggestions as the JAX package's searchers.

Reference: `python/ray/tune/search/` — sample domains (`sample.py`),
`BasicVariantGenerator` (`basic_variant.py` — grid/random resolution),
`Searcher` ABC (`searcher.py`). Model-based searchers (Optuna/HyperOpt/…)
are wrappers in the reference; here `Searcher` is the plug point and
grid/random are built in.
"""

from __future__ import annotations

import itertools
import math
import random
from typing import Any, Dict, List, Optional


# ---------------------------------------------------------------------------
# sample domains (reference: python/ray/tune/search/sample.py)
# ---------------------------------------------------------------------------


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Uniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low: float, high: float):
        assert low > 0 and high > 0
        self.low, self.high = low, high

    def sample(self, rng):
        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


class QUniform(Domain):
    def __init__(self, low: float, high: float, q: float):
        self.low, self.high, self.q = low, high, q

    def sample(self, rng):
        return round(rng.uniform(self.low, self.high) / self.q) * self.q


class Randint(Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class Choice(Domain):
    def __init__(self, categories: List[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class GridSearch:
    def __init__(self, values: List[Any]):
        self.values = list(values)


class sample_from:  # noqa: N801 — matches the reference's API name
    """Explicit lazy-evaluated config value (reference
    `tune/search/sample.py` `sample_from`). Bare callables in a
    param_space are treated as constants."""

    def __init__(self, fn):
        self.fn = fn


def uniform(low, high) -> Uniform:
    return Uniform(low, high)


def loguniform(low, high) -> LogUniform:
    return LogUniform(low, high)


def quniform(low, high, q) -> QUniform:
    return QUniform(low, high, q)


def randint(low, high) -> Randint:
    return Randint(low, high)


def choice(categories) -> Choice:
    return Choice(categories)


def grid_search(values) -> GridSearch:
    return GridSearch(values)


# ---------------------------------------------------------------------------
# searchers
# ---------------------------------------------------------------------------


class Searcher:
    """Reference: `python/ray/tune/search/searcher.py`."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        self.metric = metric
        self.mode = mode
        self.param_space: Optional[Dict[str, Any]] = None

    def set_search_properties(self, metric: Optional[str], mode: str,
                              param_space: Dict[str, Any]) -> bool:
        """Called by the Tuner before the run with the experiment's
        metric/mode/param_space (reference Searcher contract)."""
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        self.param_space = param_space
        return True

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Grid x random resolution of a param_space.

    Reference: `python/ray/tune/search/basic_variant.py` — grid values
    produce the cross product; Domain leaves are sampled per variant;
    `num_samples` repeats the whole sweep.
    """

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None):
        super().__init__()
        self.param_space = param_space
        self.num_samples = num_samples
        self.rng = random.Random(seed)
        self._variants = self._generate()
        self._i = 0

    def _generate(self) -> List[Dict[str, Any]]:
        grid_keys: List[str] = []
        grid_vals: List[List[Any]] = []

        def find_grids(prefix: str, space: Dict[str, Any]):
            for k, v in space.items():
                path = f"{prefix}.{k}" if prefix else k
                if isinstance(v, GridSearch):
                    grid_keys.append(path)
                    grid_vals.append(v.values)
                elif isinstance(v, dict):
                    find_grids(path, v)

        find_grids("", self.param_space)
        combos = list(itertools.product(*grid_vals)) if grid_keys else [()]
        variants = []
        for _ in range(self.num_samples):
            for combo in combos:
                overrides = dict(zip(grid_keys, combo))
                variants.append(self._resolve("", self.param_space,
                                              overrides))
        return variants

    def _resolve(self, prefix: str, space: Dict[str, Any],
                 overrides: Dict[str, Any]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in space.items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, GridSearch):
                out[k] = overrides[path]
            elif isinstance(v, Domain):
                out[k] = v.sample(self.rng)
            elif isinstance(v, dict):
                out[k] = self._resolve(path, v, overrides)
            elif isinstance(v, sample_from):
                out[k] = v.fn(out)
            else:
                out[k] = v
        return out

    @property
    def total_trials(self) -> int:
        return len(self._variants)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._i >= len(self._variants):
            return None
        cfg = self._variants[self._i]
        self._i += 1
        return cfg


class TPESearch(Searcher):
    """Tree-structured Parzen Estimator — the algorithm behind the
    reference's default model-based searcher (`OptunaSearch`, whose
    default sampler is TPE). The reference ships wrappers around
    external libraries (`python/ray/tune/search/optuna/optuna_search.py`
    etc.); this is a native implementation so model-based search works
    with zero extra dependencies.

    Univariate TPE (Optuna's default): observations are split at the
    gamma-quantile into good/bad sets; each dimension proposes
    candidates from a kernel density over the good set and scores them
    by the good/bad density ratio.
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 n_initial_points: int = 10, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        super().__init__(metric, mode)
        self.n_initial = n_initial_points
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self._configs: Dict[str, Dict[str, Any]] = {}
        self._scores: List[tuple] = []  # (score, flat_config)

    # -- observation -------------------------------------------------------

    def on_trial_complete(self, trial_id, result=None, error=False):
        if error or result is None or self.metric not in result:
            self._configs.pop(trial_id, None)
            return
        cfg = self._configs.pop(trial_id, None)
        if cfg is None:
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        self._scores.append((score, cfg))

    # -- suggestion --------------------------------------------------------

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self.param_space is None:
            raise RuntimeError("set_search_properties was never called")
        flat: Dict[str, Any] = {}
        config = self._build("", self.param_space, flat)
        self._configs[trial_id] = flat
        return config

    def _build(self, prefix: str, space: Dict[str, Any],
               flat: Dict[str, Any]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in space.items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = self._build(path, v, flat)
            elif isinstance(v, GridSearch):
                out[k] = self._suggest_dim(path, Choice(v.values))
                flat[path] = out[k]
            elif isinstance(v, Domain):
                out[k] = self._suggest_dim(path, v)
                flat[path] = out[k]
            elif isinstance(v, sample_from):
                out[k] = v.fn(out)
            else:
                out[k] = v
        return out

    def _split(self):
        ordered = sorted(self._scores, key=lambda s: -s[0])
        n_good = max(1, int(len(ordered) * self.gamma))
        return ordered[:n_good], ordered[n_good:]

    def _suggest_dim(self, path: str, domain: Domain) -> Any:
        if len(self._scores) < self.n_initial:
            return domain.sample(self.rng)
        good, bad = self._split()
        good_vals = [c[path] for _, c in good if path in c]
        bad_vals = [c[path] for _, c in bad if path in c]
        if not good_vals:
            return domain.sample(self.rng)
        if isinstance(domain, Choice):
            return self._categorical(domain.categories, good_vals,
                                     bad_vals)
        return self._numeric(domain, good_vals, bad_vals)

    def _categorical(self, categories, good_vals, bad_vals):
        # density ratio with +1 prior smoothing per category
        def weight(cat):
            lg = (good_vals.count(cat) + 1) / (len(good_vals)
                                               + len(categories))
            lb = (bad_vals.count(cat) + 1) / (len(bad_vals)
                                              + len(categories))
            return lg / lb

        weights = [weight(c) for c in categories]
        return self.rng.choices(categories, weights=weights, k=1)[0]

    def _numeric(self, domain, good_vals, bad_vals):
        log = isinstance(domain, LogUniform)

        def fwd(x):
            return math.log(x) if log else float(x)

        def inv(x):
            return math.exp(x) if log else x

        lo, hi = fwd(domain.low), fwd(domain.high)
        pts = [fwd(v) for v in good_vals]
        bad_pts = [fwd(v) for v in bad_vals]
        width = max(hi - lo, 1e-12)
        bw = max(width / max(1.0, math.sqrt(len(pts))), width * 0.01)

        def density(x, centers):
            if not centers:
                return 1.0 / width  # uniform fallback
            s = sum(
                math.exp(-0.5 * ((x - c) / bw) ** 2) for c in centers)
            return s / (len(centers) * bw * math.sqrt(2 * math.pi)) \
                + 1e-12

        best_x, best_ratio = None, -1.0
        for _ in range(self.n_candidates):
            center = self.rng.choice(pts)
            x = min(hi, max(lo, self.rng.gauss(center, bw)))
            ratio = density(x, pts) / density(x, bad_pts)
            if ratio > best_ratio:
                best_x, best_ratio = x, ratio
        out = inv(best_x)
        if isinstance(domain, Randint):
            return int(min(domain.high - 1, max(domain.low, round(out))))
        if isinstance(domain, QUniform):
            # clamp AFTER quantizing: rounding a boundary value can step
            # outside [low, high]
            return min(domain.high,
                       max(domain.low, round(out / domain.q) * domain.q))
        return out


class BOHBSearch(TPESearch):
    """BOHB's model-based component (Falkner et al. 2018): per-budget
    TPE models, with suggestions always drawn from the model of the
    LARGEST budget that has enough observations — low-budget (early
    rung) results guide search until high-budget evidence accumulates.

    Reference: `python/ray/tune/search/bohb/bohb_search.py` (`TuneBOHB`,
    a wrapper over the hpbandster library) — native here, sharing the
    TPE machinery above. Pair with the HyperBand scheduler the way the
    reference pairs TuneBOHB with HyperBandForBOHB; intermediate
    results feed the budget-binned observation sets as they stream in,
    so the model improves while trials are still running.
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 n_initial_points: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None,
                 budget_key: str = "training_iteration"):
        super().__init__(metric, mode, n_initial_points, gamma,
                         n_candidates, seed)
        self.budget_key = budget_key
        # budget -> trial_id -> (score, flat_config); keyed by trial so
        # repeated reports at the same rung overwrite, not duplicate
        self._budget_obs: Dict[int, Dict[str, tuple]] = {}

    def _observe(self, trial_id: str, result: Dict[str, Any]) -> None:
        if not result or self.metric not in result:
            return
        cfg = self._configs.get(trial_id)
        if cfg is None:
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        budget = int(result.get(self.budget_key, 1) or 1)
        self._budget_obs.setdefault(budget, {})[trial_id] = (score, cfg)

    def on_trial_result(self, trial_id, result) -> None:
        self._observe(trial_id, result)

    def on_trial_complete(self, trial_id, result=None,
                          error=False) -> None:
        if not error:
            self._observe(trial_id, result or {})
        self._configs.pop(trial_id, None)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        # model selection: largest budget with a full initial set
        chosen = None
        for b in sorted(self._budget_obs, reverse=True):
            if len(self._budget_obs[b]) >= self.n_initial:
                chosen = b
                break
        if chosen is not None:
            self._scores = list(self._budget_obs[chosen].values())
        else:
            # no budget has a full initial set yet: STAY RANDOM —
            # pooling across budgets would mix incomparable scores and
            # duplicate one trial's config across its rungs, collapsing
            # the TPE model onto it
            self._scores = []
        return super().suggest(trial_id)
