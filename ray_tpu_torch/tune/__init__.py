"""ray_tpu_torch.tune: hyperparameter search over trial actors
(the port's copy of ray_tpu/tune/__init__.py).

Analog of Ray's python/ray/tune (SURVEY.md §2.4): Tuner.fit →
TrialRunner event loop → trial actors; searchers (random, grid, TPE/BOHB)
+ schedulers (ASHA, HyperBand, PBT, median stopping); JSONL/CSV/TBX
logging callbacks; checkpoint-aware exploit/restore; ExperimentAnalysis.
"""

from ray_tpu_torch.air.result import Result  # noqa: F401
from ray_tpu_torch.tune.analysis import ExperimentAnalysis  # noqa: F401
from ray_tpu_torch.tune.callback import (Callback, CSVLoggerCallback,  # noqa: F401
                                         JsonLoggerCallback, TBXLoggerCallback)
from ray_tpu_torch.tune.sample import (choice, grid_search, loguniform,  # noqa: F401
                                       quniform, randint, randn, sample_from,
                                       uniform)
from ray_tpu_torch.tune.schedulers import (ASHAScheduler,  # noqa: F401
                                           FIFOScheduler, HyperBandScheduler,
                                           MedianStoppingRule,
                                           PopulationBasedTraining,
                                           TrialScheduler)
from ray_tpu_torch.tune.search import (BasicVariantGenerator,  # noqa: F401
                                       ConcurrencyLimiter, HyperOptStyleSearch,
                                       RandomSearch, Searcher, TPESearcher,
                                       TuneBOHB)
from ray_tpu_torch.tune.trial import Trial  # noqa: F401
from ray_tpu_torch.tune.tuner import (ResultGrid, TuneConfig, TuneError,  # noqa: F401
                                      Tuner)

__all__ = [
    "Tuner", "TuneConfig", "ResultGrid", "TuneError", "Trial",
    "uniform", "loguniform", "quniform", "randint", "randn", "choice",
    "sample_from", "grid_search",
    "Searcher", "BasicVariantGenerator", "RandomSearch",
    "ConcurrencyLimiter", "HyperOptStyleSearch", "TPESearcher", "TuneBOHB",
    "TrialScheduler", "FIFOScheduler", "ASHAScheduler",
    "HyperBandScheduler", "MedianStoppingRule", "PopulationBasedTraining",
    "Callback", "JsonLoggerCallback", "CSVLoggerCallback",
    "TBXLoggerCallback", "ExperimentAnalysis",
    "Result",
]
