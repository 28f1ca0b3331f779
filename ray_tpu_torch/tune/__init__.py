"""ray_tpu_torch.tune — hyperparameter search & experiment execution.

Port of `ray_tpu/tune/` (reference: `python/ray/tune/`). Trials are Trainable
actors driven by a controller event loop; searchers generate configs,
schedulers make early-stopping / PBT decisions, stoppers/loggers observe.
Nothing here imports torch: the trial actors run without it.
"""

from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    AsyncHyperBandScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import (
    BasicVariantGenerator,
    BOHBSearch,
    TPESearch,
    Searcher,
    choice,
    grid_search,
    sample_from,
    loguniform,
    quniform,
    randint,
    uniform,
)
from ray_tpu_torch.tune.stopper import (
    CombinedStopper,
    FunctionStopper,
    MaximumIterationStopper,
    Stopper,
    TrialPlateauStopper,
)
from ray_tpu_torch.tune.trainable import (
    Trainable,
    get_checkpoint,
    session_report as report,
    wrap_function,
)
from ray_tpu_torch.tune.tuner import ResultGrid, TuneConfig, Tuner

__all__ = [
    "ASHAScheduler",
    "AsyncHyperBandScheduler",
    "BasicVariantGenerator",
    "BOHBSearch",
    "CombinedStopper",
    "FIFOScheduler",
    "FunctionStopper",
    "HyperBandScheduler",
    "MaximumIterationStopper",
    "MedianStoppingRule",
    "PB2",
    "PopulationBasedTraining",
    "ResultGrid",
    "Searcher",
    "TPESearch",
    "Stopper",
    "Trainable",
    "TrialPlateauStopper",
    "TrialScheduler",
    "TuneConfig",
    "Tuner",
    "choice",
    "get_checkpoint",
    "grid_search",
    "loguniform",
    "quniform",
    "randint",
    "sample_from",
    "report",
    "uniform",
    "wrap_function",
]
