"""Path partitioning: read hive-layout data lakes with partition pruning
(the port's copy of ray_tpu/data/partitioning.py).

Analog of Ray's python/ray/data/datasource/partitioning.py
(Partitioning, PathPartitionParser, PathPartitionFilter): file paths
under a base directory encode column values either hive-style
(``base/year=2024/month=06/f.parquet``) or positionally
(``base/2024/06/f.parquet`` with ``field_names=["year", "month"]``).
Readers use the parsed values twice:

  - PRUNING: a ``partition_filter`` drops files before any byte is read
    (the reason hive layouts exist — predicate pushdown on the path).
  - ENRICHMENT: surviving files' partition values are appended as
    columns to the blocks they produce (hive readers' usual contract).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class Partitioning:
    """Declares how paths encode partition fields.

    ``style``: "hive" (``key=value`` directories, self-describing) or
    "dir" (bare value directories, named by ``field_names`` in order).
    ``base_dir``: the prefix below which partition directories start;
    path components above it are ignored.
    """

    style: str = "hive"
    base_dir: str = ""
    field_names: Optional[List[str]] = field(default=None)

    def __post_init__(self):
        if self.style not in ("hive", "dir"):
            raise ValueError(f"unknown partitioning style {self.style!r}")
        if self.style == "dir" and not self.field_names:
            raise ValueError('style="dir" requires field_names')


class PathPartitionParser:
    """Extract {field: value} from one file path."""

    def __init__(self, partitioning: Partitioning):
        self._p = partitioning

    def __call__(self, path: str) -> Dict[str, str]:
        rel = path
        base = self._p.base_dir.rstrip("/")
        if base:
            # tolerate absolute/relative mismatches: split on the base
            # dir's last occurrence, anchored at path-component
            # boundaries so base "data" can't match inside "/mydata/"
            marker = base + "/"
            idx = rel.rfind(marker)
            while idx > 0 and rel[idx - 1] != "/":
                idx = rel.rfind(marker, 0, idx)
            if idx >= 0:
                rel = rel[idx + len(base):]
        parts = [c for c in rel.split("/") if c][:-1]   # drop filename
        out: Dict[str, str] = {}
        if self._p.style == "hive":
            for comp in parts:
                if "=" in comp:
                    k, _, v = comp.partition("=")
                    out[k] = v
            return out
        names = self._p.field_names or []
        for name, comp in zip(names, parts):
            out[name] = comp
        return out


class PathPartitionFilter:
    """Filter callable over file paths, built from a partition-value
    predicate: ``filter_fn({field: value}) -> keep?``."""

    def __init__(self, partitioning: Partitioning,
                 filter_fn: Callable[[Dict[str, str]], bool]):
        self.parser = PathPartitionParser(partitioning)
        self._fn = filter_fn

    @classmethod
    def of(cls, filter_fn: Callable[[Dict[str, str]], bool], *,
           style: str = "hive", base_dir: str = "",
           field_names: Optional[List[str]] = None
           ) -> "PathPartitionFilter":
        return cls(Partitioning(style, base_dir, field_names), filter_fn)

    def __call__(self, path: str) -> bool:
        return bool(self._fn(self.parser(path)))


def apply_partitioning(files: List[str],
                       partitioning: Optional[Partitioning],
                       partition_filter: Optional[PathPartitionFilter]):
    """(surviving files, per-file partition dicts or None).

    Pruning happens HERE, on paths — excluded files are never opened."""
    values: Optional[List[Dict[str, str]]] = None
    if partition_filter is not None:
        files = [f for f in files if partition_filter(f)]
        if not files:
            raise FileNotFoundError(
                "partition_filter excluded every input file")
        if partitioning is None:
            # enrichment uses the filter's own parser when no explicit
            # partitioning was passed
            values = [partition_filter.parser(f) for f in files]
    if partitioning is not None:
        parser = PathPartitionParser(partitioning)
        values = [parser(f) for f in files]
    return files, values


def add_partition_columns(block, values: Dict[str, str]):
    """Append constant partition columns to one block (arrow table,
    pandas frame, or dict-of-arrays)."""
    if not values:
        return block
    try:
        import pyarrow as pa
        if isinstance(block, pa.Table):
            n = block.num_rows
            for k, v in values.items():
                if k in block.column_names:
                    continue
                block = block.append_column(k, pa.array([v] * n))
            return block
    except ImportError:
        pass
    try:
        import pandas as pd
        if isinstance(block, pd.DataFrame):
            for k, v in values.items():
                if k not in block.columns:
                    block[k] = v
            return block
    except ImportError:
        pass
    if isinstance(block, dict):
        import numpy as np
        n = len(next(iter(block.values()))) if block else 0
        for k, v in values.items():
            block.setdefault(k, np.array([v] * n))
    return block
