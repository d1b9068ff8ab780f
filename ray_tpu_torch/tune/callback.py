"""Tune callbacks: experiment-loop hooks + logger callbacks (the port's copy of
ray_tpu/tune/callback.py).

Analog of Ray's python/ray/tune/callback.py (Callback) and
tune/logger/ (JsonLoggerCallback json.py, CSVLoggerCallback csv.py,
TBXLoggerCallback tensorboardx.py — gated here on tensorboardX being
installed). Instances go in ``RunConfig(callbacks=[...])``; the
TrialRunner invokes every hook.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List, Optional


class Callback:
    def on_trial_start(self, iteration: int, trials: List[Any],
                       trial: Any) -> None:
        pass

    def on_trial_result(self, iteration: int, trials: List[Any],
                        trial: Any, result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(self, iteration: int, trials: List[Any],
                          trial: Any) -> None:
        pass

    def on_trial_error(self, iteration: int, trials: List[Any],
                       trial: Any) -> None:
        pass

    def on_experiment_end(self, trials: List[Any]) -> None:
        pass


class JsonLoggerCallback(Callback):
    """Per-trial newline-JSON result logs (reference tune/logger/json.py
    writes the same ``result.json`` convention the runner itself keeps;
    this callback lets users direct a second copy elsewhere)."""

    def __init__(self, dirpath: Optional[str] = None,
                 filename: str = "results.json"):
        self.dirpath = dirpath
        self.filename = filename

    def _path(self, trial) -> str:
        base = self.dirpath or trial.logdir
        os.makedirs(base, exist_ok=True)
        return os.path.join(base, f"{trial.trial_id}_{self.filename}" if
                            self.dirpath else self.filename)

    def on_trial_result(self, iteration, trials, trial, result):
        with open(self._path(trial), "a") as f:
            f.write(json.dumps(result, default=str) + "\n")


class CSVLoggerCallback(Callback):
    """Per-trial CSV progress (reference tune/logger/csv.py)."""

    def __init__(self, filename: str = "progress.csv"):
        self.filename = filename
        self._fields: Dict[str, List[str]] = {}

    def on_trial_result(self, iteration, trials, trial, result):
        flat = {k: v for k, v in result.items()
                if isinstance(v, (int, float, str, bool))}
        path = os.path.join(trial.logdir, self.filename)
        if trial.trial_id not in self._fields:
            self._fields[trial.trial_id] = sorted(flat.keys())
            with open(path, "w", newline="") as f:
                csv.DictWriter(f, self._fields[trial.trial_id]).writeheader()
        with open(path, "a", newline="") as f:
            csv.DictWriter(f, self._fields[trial.trial_id],
                           extrasaction="ignore").writerow(flat)


class TBXLoggerCallback(Callback):
    """TensorBoard scalars via tensorboardX when available (reference
    tune/logger/tensorboardx.py); silently inert otherwise (the image has
    no tensorboardX — documented gating, not a stub crash)."""

    def __init__(self):
        try:
            from tensorboardX import SummaryWriter
            self._writer_cls = SummaryWriter
        except ImportError:
            self._writer_cls = None
        self._writers: Dict[str, Any] = {}

    @property
    def available(self) -> bool:
        return self._writer_cls is not None

    def on_trial_result(self, iteration, trials, trial, result):
        if self._writer_cls is None:
            return
        w = self._writers.get(trial.trial_id)
        if w is None:
            w = self._writer_cls(logdir=trial.logdir)
            self._writers[trial.trial_id] = w
        step = result.get("training_iteration", iteration)
        for k, v in result.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                w.add_scalar(k, v, step)

    def on_trial_complete(self, iteration, trials, trial):
        w = self._writers.pop(trial.trial_id, None)
        if w is not None:
            w.close()

    def on_experiment_end(self, trials):
        for w in self._writers.values():
            w.close()
        self._writers.clear()
