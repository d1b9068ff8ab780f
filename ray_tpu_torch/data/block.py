"""Blocks: the unit of distributed data (the port's copy of
ray_tpu/data/block.py).

Analog of Ray's python/ray/data/block.py + _internal/arrow_block.py
/ pandas_block.py / simple_block.py: a block is a batch of rows in one of
three formats (pyarrow.Table, pandas.DataFrame, or a Python list), stored as
one object in the object store. BlockAccessor unifies the per-format ops the
execution plan needs (slice, take, schema, to_batch, ...).

TPU note: the "tensor batch" interchange format is a dict of numpy arrays —
what a JaxTrainer host feeds to device shards — so every accessor can
produce ``batch_format="numpy"`` without pandas/arrow in the loop.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np

Block = Any   # list | pandas.DataFrame | pyarrow.Table | dict[str, ndarray]


def _try_import_pandas():
    try:
        import pandas
        return pandas
    except ImportError:
        return None


def _try_import_pyarrow():
    try:
        import pyarrow
        return pyarrow
    except ImportError:
        return None


class BlockAccessor:
    """Format-generic view over one block."""

    def __init__(self, block: Block):
        self._block = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        pd = _try_import_pandas()
        pa = _try_import_pyarrow()
        if pd is not None and isinstance(block, pd.DataFrame):
            return _PandasAccessor(block)
        if pa is not None and isinstance(block, pa.Table):
            return _ArrowAccessor(block)
        if isinstance(block, dict) and block and all(
                isinstance(v, np.ndarray) for v in block.values()):
            return _NumpyAccessor(block)
        if isinstance(block, list):
            return _SimpleAccessor(block)
        raise TypeError(f"unsupported block type {type(block)}")

    # interface
    def num_rows(self) -> int:
        raise NotImplementedError

    def iter_rows(self) -> Iterator[Any]:
        raise NotImplementedError

    def slice(self, start: int, end: int) -> Block:
        raise NotImplementedError

    def to_pandas(self):
        raise NotImplementedError

    def to_numpy(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def to_arrow(self):
        raise NotImplementedError

    def to_list(self) -> List[Any]:
        return list(self.iter_rows())

    def to_batch(self, batch_format: str) -> Any:
        if batch_format in ("default", "native"):
            return self._block
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format == "numpy":
            return self.to_numpy()
        if batch_format == "pyarrow":
            return self.to_arrow()
        raise ValueError(f"unknown batch_format {batch_format!r}")

    def schema(self) -> Any:
        raise NotImplementedError

    def size_bytes(self) -> int:
        raise NotImplementedError

    def sample(self, n: int, key: Optional[Any] = None) -> List[Any]:
        rows = self.to_list()
        step = max(1, len(rows) // max(n, 1))
        picked = rows[::step][:n]
        if key is not None:
            picked = [_key_of(r, key) for r in picked]
        return picked

    def sort_block(self, key: Any, descending: bool = False) -> Block:
        rows = sorted(self.to_list(), key=lambda r: _key_of(r, key),
                      reverse=descending)
        return build_block_like(self._block, rows)

    @staticmethod
    def batch_to_block(batch: Any) -> Block:
        """Normalize a user-returned batch into a block."""
        pd = _try_import_pandas()
        pa = _try_import_pyarrow()
        if pd is not None and isinstance(batch, pd.DataFrame):
            return batch
        if pa is not None and isinstance(batch, pa.Table):
            return batch
        if isinstance(batch, dict):
            return {k: np.asarray(v) for k, v in batch.items()}
        if isinstance(batch, np.ndarray):
            return {"data": batch}
        if isinstance(batch, list):
            return batch
        raise TypeError(f"map_batches returned unsupported type "
                        f"{type(batch)}")


def _key_of(row: Any, key: Any) -> Any:
    if callable(key):
        return key(row)
    if isinstance(row, dict):
        return row[key]
    return getattr(row, key, row)


def build_block_like(template: Block, rows: List[Any]) -> Block:
    """Rebuild a block of ``template``'s format from python rows."""
    pd = _try_import_pandas()
    pa = _try_import_pyarrow()
    if pd is not None and isinstance(template, pd.DataFrame):
        return pd.DataFrame(rows)
    if pa is not None and isinstance(template, pa.Table):
        return pa.Table.from_pylist(rows)
    if isinstance(template, dict):
        if not rows:
            return {k: np.empty((0,) + v.shape[1:], v.dtype)
                    for k, v in template.items()}
        if isinstance(rows[0], dict):
            # the map fn may have CHANGED the row schema: build from the
            # output rows' keys, not the input template's
            return {k: np.asarray([r[k] for r in rows])
                    for k in rows[0].keys()}
    return list(rows)


class _SimpleAccessor(BlockAccessor):
    def num_rows(self):
        return len(self._block)

    def iter_rows(self):
        return iter(self._block)

    def slice(self, start, end):
        return self._block[start:end]

    def to_pandas(self):
        pd = _try_import_pandas()
        rows = self._block
        if rows and isinstance(rows[0], dict):
            return pd.DataFrame(rows)
        return pd.DataFrame({"value": rows})

    def to_numpy(self):
        rows = self._block
        if rows and isinstance(rows[0], dict):
            return {k: np.asarray([r[k] for r in rows])
                    for k in rows[0].keys()}
        return {"value": np.asarray(rows)}

    def to_arrow(self):
        pa = _try_import_pyarrow()
        rows = self._block
        if rows and isinstance(rows[0], dict):
            return pa.Table.from_pylist(rows)
        return pa.table({"value": rows})

    def schema(self):
        if not self._block:
            return None
        first = self._block[0]
        if isinstance(first, dict):
            return {k: type(v).__name__ for k, v in first.items()}
        return type(first).__name__

    def size_bytes(self):
        import sys
        if not self._block:
            return 0
        return sys.getsizeof(self._block[0]) * len(self._block)


class _NumpyAccessor(BlockAccessor):
    def num_rows(self):
        return len(next(iter(self._block.values())))

    def iter_rows(self):
        keys = list(self._block.keys())
        for i in range(self.num_rows()):
            yield {k: self._block[k][i] for k in keys}

    def slice(self, start, end):
        return {k: v[start:end] for k, v in self._block.items()}

    def to_pandas(self):
        pd = _try_import_pandas()
        cols = {}
        for k, v in self._block.items():
            cols[k] = list(v) if v.ndim > 1 else v
        return pd.DataFrame(cols)

    def to_numpy(self):
        return self._block

    def to_arrow(self):
        pa = _try_import_pyarrow()
        return pa.table({k: list(v) if v.ndim > 1 else v
                         for k, v in self._block.items()})

    def schema(self):
        return {k: str(v.dtype) for k, v in self._block.items()}

    def size_bytes(self):
        return int(sum(v.nbytes for v in self._block.values()))


class _PandasAccessor(BlockAccessor):
    def num_rows(self):
        return len(self._block)

    def iter_rows(self):
        for _, row in self._block.iterrows():
            yield row.to_dict()

    def slice(self, start, end):
        return self._block.iloc[start:end].reset_index(drop=True)

    def to_pandas(self):
        return self._block

    def to_numpy(self):
        return {c: self._block[c].to_numpy() for c in self._block.columns}

    def to_arrow(self):
        pa = _try_import_pyarrow()
        return pa.Table.from_pandas(self._block, preserve_index=False)

    def schema(self):
        return {c: str(t) for c, t in self._block.dtypes.items()}

    def size_bytes(self):
        return int(self._block.memory_usage(deep=True).sum())


class _ArrowAccessor(BlockAccessor):
    def num_rows(self):
        return self._block.num_rows

    def iter_rows(self):
        for batch in self._block.to_pylist():
            yield batch

    def slice(self, start, end):
        return self._block.slice(start, end - start)

    def to_pandas(self):
        return self._block.to_pandas()

    def to_numpy(self):
        return {name: self._block[name].to_numpy(zero_copy_only=False)
                for name in self._block.column_names}

    def to_arrow(self):
        return self._block

    def schema(self):
        return self._block.schema

    def size_bytes(self):
        return self._block.nbytes
