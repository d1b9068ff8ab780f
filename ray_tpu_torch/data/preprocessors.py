"""Preprocessors: fit statistics on a Dataset, transform datasets/batches
(the port's copy of ray_tpu/data/preprocessors.py).

Analog of Ray's python/ray/data/preprocessors/ (scaler.py,
encoder.py, imputer.py, batch_mapper.py, chain.py, concatenator.py) and the
air Preprocessor base (Ray's python/ray/air/_internal — fit/
transform/transform_batch lifecycle).  TPU-shaped: statistics are computed
as one distributed numpy aggregation pass (map_batches over blocks, combine
on the driver) and transform is a stateless map_batches, so a fitted
preprocessor pickles into Train/Serve workers and applies per-batch at
ingest/serving time.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np


class Preprocessor:
    """fit(ds) learns state; transform(ds)/transform_batch(batch) apply it."""

    _is_fitted = False

    def fit(self, ds) -> "Preprocessor":
        self._fit(ds)
        self._is_fitted = True
        return self

    def fit_transform(self, ds):
        return self.fit(ds).transform(ds)

    def transform(self, ds):
        if not self._is_fitted and type(self)._fit is not Preprocessor._fit:
            raise RuntimeError(f"{type(self).__name__} must be fit first")
        return ds.map_batches(self.transform_batch, batch_format="numpy")

    def transform_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _fit(self, ds) -> None:
        """Default: stateless preprocessor (nothing to fit)."""

    def _aggregate(self, ds, stat_fn: Callable[[Dict[str, np.ndarray]], Any]
                   ) -> List[Any]:
        """Run ``stat_fn`` over every block (distributed) and collect."""
        stats = ds.map_batches(
            lambda b: [stat_fn(b)], batch_size=None, batch_format="numpy")
        return stats.take_all()


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (reference preprocessors/scaler.py)."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.stats_: Dict[str, Any] = {}

    def _fit(self, ds) -> None:
        cols = self.columns

        def stat(batch):
            return {c: (float(np.sum(batch[c], dtype=np.float64)),
                        float(np.sum(np.square(batch[c], dtype=np.float64))),
                        int(np.asarray(batch[c]).shape[0])) for c in cols}

        agg = {c: [0.0, 0.0, 0] for c in cols}
        for s in self._aggregate(ds, stat):
            for c, (sm, sq, n) in s.items():
                agg[c][0] += sm
                agg[c][1] += sq
                agg[c][2] += n
        for c, (sm, sq, n) in agg.items():
            mean = sm / max(n, 1)
            var = max(sq / max(n, 1) - mean * mean, 0.0)
            self.stats_[c] = (mean, float(np.sqrt(var)))

    def transform_batch(self, batch):
        out = dict(batch)
        for c, (mean, std) in self.stats_.items():
            out[c] = (np.asarray(batch[c]) - mean) / (std or 1.0)
        return out


class MinMaxScaler(Preprocessor):
    """(x - min) / (max - min) per column."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.stats_: Dict[str, Any] = {}

    def _fit(self, ds) -> None:
        cols = self.columns

        def stat(batch):
            return {c: (float(np.min(batch[c])), float(np.max(batch[c])))
                    for c in cols}

        agg = {c: (np.inf, -np.inf) for c in cols}
        for s in self._aggregate(ds, stat):
            for c, (lo, hi) in s.items():
                agg[c] = (min(agg[c][0], lo), max(agg[c][1], hi))
        self.stats_ = agg

    def transform_batch(self, batch):
        out = dict(batch)
        for c, (lo, hi) in self.stats_.items():
            span = (hi - lo) or 1.0
            out[c] = (np.asarray(batch[c]) - lo) / span
        return out


class LabelEncoder(Preprocessor):
    """Categorical column -> dense int codes (sorted unique order)."""

    def __init__(self, label_column: str):
        self.label_column = label_column
        self.classes_: List[Any] = []

    def _fit(self, ds) -> None:
        col = self.label_column
        uniques = set()
        for s in self._aggregate(
                ds, lambda b: list(np.unique(np.asarray(b[col])))):
            uniques.update(s)
        self.classes_ = sorted(uniques)

    def transform_batch(self, batch):
        out = dict(batch)
        index = {v: i for i, v in enumerate(self.classes_)}
        vals = np.asarray(batch[self.label_column])
        out[self.label_column] = np.asarray(
            [index[v] for v in vals.tolist()], np.int64)
        return out


class OneHotEncoder(Preprocessor):
    """Categorical columns -> {col}_{value} 0/1 indicator columns."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.stats_: Dict[str, List[Any]] = {}

    def _fit(self, ds) -> None:
        cols = self.columns
        uniques: Dict[str, set] = {c: set() for c in cols}
        for s in self._aggregate(
                ds, lambda b: {c: list(np.unique(np.asarray(b[c])))
                               for c in cols}):
            for c, vals in s.items():
                uniques[c].update(vals)
        self.stats_ = {c: sorted(v) for c, v in uniques.items()}

    def transform_batch(self, batch):
        out = dict(batch)
        for c, values in self.stats_.items():
            col = np.asarray(batch[c])
            for v in values:
                out[f"{c}_{v}"] = (col == v).astype(np.int64)
            del out[c]
        return out


class SimpleImputer(Preprocessor):
    """Fill NaNs with the column mean ("mean") or a constant."""

    def __init__(self, columns: List[str], strategy: str = "mean",
                 fill_value: Optional[float] = None):
        if strategy not in ("mean", "constant"):
            raise ValueError(f"unknown strategy {strategy!r}")
        if strategy == "constant" and fill_value is None:
            raise ValueError("strategy='constant' requires fill_value")
        self.columns = list(columns)
        self.strategy = strategy
        self.fill_value = fill_value
        self.stats_: Dict[str, float] = {}

    def _fit(self, ds) -> None:
        if self.strategy == "constant":
            self.stats_ = {c: float(self.fill_value) for c in self.columns}
            return
        cols = self.columns

        def stat(batch):
            return {c: (float(np.nansum(np.asarray(batch[c], np.float64))),
                        int(np.sum(~np.isnan(np.asarray(batch[c],
                                                        np.float64)))))
                    for c in cols}

        agg = {c: [0.0, 0] for c in cols}
        for s in self._aggregate(ds, stat):
            for c, (sm, n) in s.items():
                agg[c][0] += sm
                agg[c][1] += n
        self.stats_ = {c: sm / max(n, 1) for c, (sm, n) in agg.items()}

    def transform_batch(self, batch):
        out = dict(batch)
        for c, fill in self.stats_.items():
            col = np.asarray(batch[c], np.float64)
            out[c] = np.where(np.isnan(col), fill, col)
        return out


class Concatenator(Preprocessor):
    """Merge numeric columns into one 2-D feature matrix column."""

    def __init__(self, columns: List[str], output_column_name: str = "features",
                 dtype: Any = np.float32):
        self.columns = list(columns)
        self.output_column_name = output_column_name
        self.dtype = dtype

    def transform_batch(self, batch):
        out = {k: v for k, v in batch.items() if k not in self.columns}
        mats = [np.asarray(batch[c]).reshape(len(np.asarray(batch[c])), -1)
                for c in self.columns]
        out[self.output_column_name] = np.concatenate(
            mats, axis=1).astype(self.dtype)
        return out


class BatchMapper(Preprocessor):
    """Wrap a user batch function as a (stateless) preprocessor."""

    def __init__(self, fn: Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]):
        self.fn = fn

    def transform_batch(self, batch):
        return self.fn(batch)


class Chain(Preprocessor):
    """Apply preprocessors in sequence; fit each on the previous output."""

    def __init__(self, *preprocessors: Preprocessor):
        self.preprocessors = list(preprocessors)

    def _fit(self, ds) -> None:
        for p in self.preprocessors[:-1]:
            ds = p.fit_transform(ds)
        if self.preprocessors:
            self.preprocessors[-1].fit(ds)

    def transform_batch(self, batch):
        for p in self.preprocessors:
            batch = p.transform_batch(batch)
        return batch
