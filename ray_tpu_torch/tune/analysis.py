"""ExperimentAnalysis: load + query a finished (or running) experiment dir
(the port's copy of ray_tpu/tune/analysis.py).

Analog of Ray's python/ray/tune/analysis/experiment_analysis.py:
reads the per-trial ``result.json`` histories the runner writes and
answers best-config/best-checkpoint/dataframe queries, including for
experiments from an earlier process (restore-after-crash inspection).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional


class ExperimentAnalysis:
    def __init__(self, experiment_dir: str,
                 default_metric: Optional[str] = None,
                 default_mode: str = "max"):
        self.experiment_dir = experiment_dir
        self.default_metric = default_metric
        self.default_mode = default_mode
        # trial_id -> list of result dicts (ordered)
        self.trial_dataframes: Dict[str, List[Dict[str, Any]]] = {}
        for path in sorted(glob.glob(
                os.path.join(experiment_dir, "trial_*", "result.json"))):
            trial_id = os.path.basename(os.path.dirname(path)) \
                .replace("trial_", "")
            rows = []
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        rows.append(self._coerce(json.loads(line)))
            if rows:
                self.trial_dataframes[trial_id] = rows

    _STRING_KEYS = frozenset({"trial_id", "experiment_tag", "logdir",
                              "date", "hostname", "node_ip"})

    @classmethod
    def _coerce(cls, row: Dict[str, Any]) -> Dict[str, Any]:
        """The runner serializes with default=str, so numpy/JAX scalars
        arrive as strings — parse numeric-looking strings back to float
        or metric comparisons would be lexicographic. Known string fields
        (a hex trial_id can be all digits, or parse as 1e45678) and
        non-finite parses are left alone."""
        import math
        out = {}
        for k, v in row.items():
            if isinstance(v, str) and k not in cls._STRING_KEYS:
                try:
                    f = float(v)
                    if math.isfinite(f):
                        v = f
                except ValueError:
                    pass
            out[k] = v
        return out

    @property
    def trial_ids(self) -> List[str]:
        return list(self.trial_dataframes)

    def _metric_mode(self, metric, mode):
        metric = metric or self.default_metric
        mode = mode or self.default_mode
        if metric is None:
            raise ValueError("metric is required (no default set)")
        return metric, mode

    def best_trial_id(self, metric: Optional[str] = None,
                      mode: Optional[str] = None) -> str:
        metric, mode = self._metric_mode(metric, mode)
        best_id, best_val = None, None
        for tid, rows in self.trial_dataframes.items():
            vals = [r[metric] for r in rows if metric in r]
            if not vals:
                continue
            v = max(vals) if mode == "max" else min(vals)
            if best_val is None or (v > best_val if mode == "max"
                                    else v < best_val):
                best_id, best_val = tid, v
        if best_id is None:
            raise ValueError(f"no trial reported metric {metric!r}")
        return best_id

    def get_best_config(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Dict[str, Any]:
        metric, mode = self._metric_mode(metric, mode)
        rows = self.trial_dataframes[self.best_trial_id(metric, mode)]
        # the config of the row that achieved the best value — under PBT
        # the trial's config mutates over time, so rows[-1] can be a
        # config that never produced the best metric
        scored = [r for r in rows if metric in r]
        best_row = (max if mode == "max" else min)(
            scored, key=lambda r: r[metric])
        return best_row.get("config", {})

    def get_last_results(self) -> Dict[str, Dict[str, Any]]:
        return {tid: rows[-1]
                for tid, rows in self.trial_dataframes.items()}

    def dataframe(self):
        try:
            import pandas as pd
        except ImportError:
            return None
        flat = []
        for tid, rows in self.trial_dataframes.items():
            for r in rows:
                flat.append({**{k: v for k, v in r.items()
                                if not isinstance(v, dict)},
                             "trial_id": tid})
        return pd.DataFrame(flat)
