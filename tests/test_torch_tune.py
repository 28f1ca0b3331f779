"""The port's Tune (`ray_tpu_torch.tune`) against the JAX package's.

Searchers and schedulers are held to `ray_tpu.tune` value for value: the
same seeds and the same scripted result stream must give the same
configs and the same decisions (grid/random resolution, ASHA, HyperBand,
median stopping, PBT, PB2, TPE, BOHB). Then the Tuner's function and
class APIs, failure retry from a checkpoint and Train on Tune run on the
port's own runtime (one module-scoped cluster, as in tests/test_tune.py).
"""

import os

import numpy as np
import pytest

from ray_tpu import tune as jtune
from ray_tpu_torch import tune as ttune

PACKAGES = {"jax": jtune, "port": ttune}


# -- searchers ----------------------------------------------------------------


def _space(tune):
    return {"lr": tune.grid_search([0.1, 0.01]),
            "wd": tune.grid_search([1, 2]),
            "mom": tune.uniform(0.0, 1.0),
            "q": tune.quniform(0.0, 10.0, 0.5),
            "log": tune.loguniform(1e-4, 1.0),
            "n": tune.randint(0, 100),
            "nested": {"units": tune.choice([8, 16, 32])}}


def _resolve(tune, seed):
    gen = tune.BasicVariantGenerator(_space(tune), num_samples=3, seed=seed)
    out = []
    while (cfg := gen.suggest(f"t{len(out)}")) is not None:
        out.append(cfg)
    return out


@pytest.mark.parametrize("seed", [0, 7])
def test_grid_and_random_resolution_matches_jax(seed):
    got, want = _resolve(ttune, seed), _resolve(jtune, seed)
    assert len(want) == 12  # 2x2 grid x 3 samples
    assert got == want


def _drive_searcher(tune, cls_name, seed, budgets):
    """Suggest 40 configs and feed each its score (at one or two
    budgets); returns every suggestion."""
    searcher = getattr(tune.search, cls_name)(
        metric="score", mode="max", n_initial_points=6, seed=seed)
    searcher.set_search_properties("score", "max", {
        "x": tune.uniform(0.0, 1.0),
        "lr": tune.loguniform(1e-4, 1.0),
        "opt": tune.choice(["adam", "sgd", "lion"])})
    out = []
    for i in range(40):
        cfg = searcher.suggest(f"t{i}")
        out.append(cfg)
        score = -(cfg["x"] - 0.7) ** 2 - abs(np.log10(cfg["lr"]) + 2) * 0.1
        score += {"adam": 0.05, "sgd": 0.0, "lion": -0.05}[cfg["opt"]]
        if budgets:
            searcher.on_trial_result(
                f"t{i}", {"score": -cfg["x"], "training_iteration": 1})
        searcher.on_trial_complete(
            f"t{i}", {"score": score, "training_iteration": 9})
    return out


@pytest.mark.parametrize("cls_name,budgets", [("TPESearch", False),
                                              ("BOHBSearch", True)])
def test_model_based_searchers_decide_as_jax(cls_name, budgets):
    got = _drive_searcher(ttune, cls_name, 3, budgets)
    want = _drive_searcher(jtune, cls_name, 3, budgets)
    assert got == want
    assert len(got) == 40 and all(0.0 <= c["x"] <= 1.0 for c in got)


# -- schedulers ---------------------------------------------------------------


class _Trial:
    def __init__(self, trial_id, config):
        self.trial_id = trial_id
        self.config = dict(config)


class _Controller:
    """What the schedulers call on the Tune controller: a donor's
    checkpoint, a trial by id, and exploit (logged)."""

    def __init__(self, trials):
        self.trials = {t.trial_id: t for t in trials}
        self.exploits = []

    def checkpoint_trial(self, trial):
        return f"ckpt/{trial.trial_id}/{len(self.exploits)}"

    def get_trial(self, trial_id):
        return self.trials[trial_id]

    def exploit_trial(self, trial, new_config, checkpoint_path):
        self.exploits.append((trial.trial_id, dict(new_config),
                              checkpoint_path))
        trial.config = dict(new_config)


def _schedulers(tune):
    return {
        "asha": lambda: tune.AsyncHyperBandScheduler(
            metric="acc", mode="max", max_t=12, grace_period=1,
            reduction_factor=2),
        "hyperband": lambda: tune.HyperBandScheduler(
            metric="acc", mode="max", max_t=12),
        "median": lambda: tune.MedianStoppingRule(
            metric="acc", mode="max", grace_period=2,
            min_samples_required=2),
        "pbt": lambda: tune.PopulationBasedTraining(
            metric="acc", mode="max", perturbation_interval=3,
            hyperparam_mutations={"rate": [0.25, 0.5, 1.0, 2.0],
                                  "wd": tune.uniform(0.0, 0.1)},
            quantile_fraction=0.34, seed=5),
        "pb2": lambda: tune.PB2(
            metric="acc", mode="max", perturbation_interval=2,
            hyperparam_bounds={"rate": [0.1, 3.0], "wd": [0.0, 0.1]},
            quantile_fraction=0.34, seed=5),
    }


def _replay(tune, name):
    """Six trials report 12 iterations each, round robin, with seeded
    noisy scores; returns every decision, the exploits and the final
    configs."""
    sched = _schedulers(tune)[name]()
    rng = np.random.default_rng(11)
    trials = [_Trial(f"t{i}", {"rate": float(r), "wd": 0.01 * i})
              for i, r in enumerate([0.25, 2.0, 0.5, 1.0, 0.3, 1.5])]
    ctl = _Controller(trials)
    for t in trials:
        sched.on_trial_add(ctl, t)
    live = {t.trial_id for t in trials}
    score = {t.trial_id: 0.0 for t in trials}
    decisions = []
    for it in range(1, 13):
        for t in trials:
            if t.trial_id not in live:
                continue
            score[t.trial_id] += t.config["rate"] + float(
                rng.normal(0, 0.2))
            result = {"acc": score[t.trial_id], "training_iteration": it}
            d = sched.on_trial_result(ctl, t, result)
            decisions.append((t.trial_id, it, d))
            if d == sched.STOP:
                live.discard(t.trial_id)
                sched.on_trial_complete(ctl, t, result)
    return decisions, ctl.exploits, [t.config for t in trials]


@pytest.mark.parametrize("name", ["asha", "hyperband", "median", "pbt",
                                  "pb2"])
def test_scheduler_decisions_match_jax(name):
    got, want = _replay(ttune, name), _replay(jtune, name)
    assert got == want
    decisions, exploits, _ = want
    if name in ("asha", "hyperband", "median"):
        assert any(d == "STOP" for _, _, d in decisions)
    else:
        assert exploits  # the stream did make PBT/PB2 exploit


def test_pb2_gp_selection_matches_jax():
    picks = {}
    for key, tune in PACKAGES.items():
        sched = tune.PB2(metric="score", mode="max",
                         hyperparam_bounds={"rate": [0.0, 1.0]}, seed=1)
        for i in range(30):
            sched._obs.append([float(i), i / 29.0, i / 29.0 * 2.0])
        picks[key] = [sched._mutate({"rate": 0.5})["rate"]
                      for _ in range(8)]
    assert picks["port"] == picks["jax"]
    assert sum(p > 0.6 for p in picks["port"]) >= 6


# -- the Tuner on the port's runtime -------------------------------------------


@pytest.fixture(scope="module")
def cluster():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                       object_store_memory=128 * 1024 * 1024)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture()
def storage(tmp_path):
    return str(tmp_path / "tune_results")


def test_tuner_function_api(cluster, storage):
    from ray_tpu_torch.air import RunConfig

    def objective(config):
        score = -((config["x"] - 3.0) ** 2)
        for i in range(2):
            ttune.report({"score": score + i * 0.01})

    grid = ttune.Tuner(
        objective,
        param_space={"x": ttune.grid_search([1.0, 3.0, 5.0])},
        tune_config=ttune.TuneConfig(metric="score", mode="max",
                                     max_concurrent_trials=3),
        run_config=RunConfig(storage_path=storage, name="fn_api"),
    ).fit()
    assert len(grid) == 3
    best = grid.get_best_result(metric="score", mode="max")
    assert best.metrics["score"] == pytest.approx(0.01)
    assert best.config["x"] == 3.0
    for r in grid:
        assert os.path.exists(os.path.join(r.path, "result.json"))
        assert os.path.exists(os.path.join(r.path, "progress.csv"))


def test_tuner_class_api(cluster, storage):
    from ray_tpu_torch.air import RunConfig

    class Quad(ttune.Trainable):
        def setup(self, config):
            self.x = config["x"]
            self.i = 0

        def step(self):
            self.i += 1
            return {"val": self.x * self.i}

    grid = ttune.Tuner(
        Quad,
        param_space={"x": ttune.grid_search([2, 4])},
        tune_config=ttune.TuneConfig(metric="val", mode="max"),
        run_config=RunConfig(storage_path=storage, name="cls_api",
                             stop={"training_iteration": 3}),
    ).fit()
    assert sorted(r.metrics["val"] for r in grid) == [6, 12]


def test_failure_retry_restores(cluster, storage):
    from ray_tpu_torch.air import Checkpoint, FailureConfig, RunConfig

    marker = os.path.join(storage, "crash_marker")

    def flaky(config):
        ckpt = ttune.get_checkpoint()
        start = ckpt.to_dict()["i"] + 1 if ckpt else 0
        for i in range(start, 4):
            if i == 2 and not os.path.exists(marker):
                os.makedirs(storage, exist_ok=True)
                open(marker, "w").close()
                raise RuntimeError("synthetic crash")
            ttune.report({"i": i, "start": start},
                         checkpoint=Checkpoint.from_dict({"i": i}))

    grid = ttune.Tuner(
        flaky,
        run_config=RunConfig(storage_path=storage, name="flaky",
                             failure_config=FailureConfig(max_failures=2)),
    ).fit()
    assert len(grid.errors) == 0
    assert grid[0].metrics["i"] == 3
    assert grid[0].metrics["start"] == 2  # resumed after the step-1 report


def test_train_runs_on_tune(cluster, storage):
    """`BaseTrainer.fit` wraps the trainer as a trainable and runs a
    one-trial Tuner: the controller loop runs in the trial actor."""
    from ray_tpu_torch import train
    from ray_tpu_torch.air import RunConfig, ScalingConfig

    def loop(config):
        import os as os_mod

        for step in range(2):
            train.report({"step": step, "pid": os_mod.getpid()})

    result = train.DataParallelTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=storage, name="train_on_tune"),
    ).fit()
    assert result.metrics["step"] == 1
    assert result.metrics["pid"] != os.getpid()
    assert result.error is None
    assert len(result.metrics_history) == 2
