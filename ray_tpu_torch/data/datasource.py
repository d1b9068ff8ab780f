"""Datasources: read tasks and file writers (the port's copy of
ray_tpu/data/datasource.py).

Analog of Ray's python/ray/data/read_api.py (read_parquet :429)
and data/datasource/*: a read produces ReadTasks — serializable callables,
one per output block — that the execution plan submits as remote tasks, so
IO parallelizes across the cluster and blocks land in the object store on
the node that read them.
"""

from __future__ import annotations

import glob as _glob
import io
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch._private import storage as _storage


def _is_remote(path: str) -> bool:
    """URI handled by the storage seam rather than the local filesystem.

    ``file://`` strips to a plain path (read tasks run on any node; a
    file:// URI means a shared/local filesystem, same as the reference's
    default pyarrow LocalFileSystem). ``mock://`` is per-process memory —
    fine for driver-side tests, not shared with remote read workers.
    """
    return _storage.is_uri(path) and _storage.parse_uri(path)[0] != "file"


def _localize(path: str) -> str:
    if _storage.is_uri(path) and _storage.parse_uri(path)[0] == "file":
        return _storage.parse_uri(path)[1]
    return path


def _open(path: str, mode: str = "rb"):
    """File-like opener for both local paths and storage URIs (reference
    read_api.py threads a pyarrow ``filesystem`` through every reader;
    here the seam yields whole-object readers)."""
    if _is_remote(path):
        buf = io.BytesIO(_storage.read_bytes(path))
        return io.TextIOWrapper(buf) if "b" not in mode else buf
    return open(path, mode)


def _out_target(path: str, filename: str):
    """-> (local_path_or_None, uri_or_None) for one output file under
    ``path``: local destinations stream straight to disk, remote URIs
    buffer and go through the seam."""
    if _is_remote(path):
        return None, _storage.join_uri(path, filename)
    path = _localize(path)
    os.makedirs(path, exist_ok=True)
    return os.path.join(path, filename), None


class ReadTask:
    """One unit of input IO → one block."""

    def __init__(self, fn: Callable[[], Any],
                 num_rows: Optional[int] = None,
                 input_files: Optional[List[str]] = None):
        self._fn = fn
        self.num_rows = num_rows
        self.input_files = input_files or []

    def __call__(self):
        return self._fn()


def _expand_paths(paths, suffix: Optional[str] = None) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        if _is_remote(p):
            if _storage.exists(p):
                files.append(p)
                continue
            rels = _storage.list_prefix(p)
            files.extend(_storage.join_uri(p, r) for r in sorted(rels)
                         if suffix is None or r.endswith(suffix))
            continue
        p = _localize(p)
        out: List[str] = []
        if os.path.isdir(p):
            pat = os.path.join(p, "**", f"*{suffix}" if suffix else "*")
            out.extend(sorted(_glob.glob(pat, recursive=True)))
        elif any(c in p for c in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
        files.extend(f for f in out if os.path.isfile(f))
    if not files:
        raise FileNotFoundError(f"no input files for {paths!r}")
    return files


# -- readers (each returns a list of ReadTasks) -----------------------------

def range_tasks(n: int, parallelism: int) -> List[ReadTask]:
    parallelism = max(1, min(parallelism, n or 1))
    step = (n + parallelism - 1) // parallelism
    tasks = []
    for start in range(0, n, step):
        end = min(start + step, n)
        tasks.append(ReadTask(
            lambda s=start, e=end: {"id": np.arange(s, e)},
            num_rows=end - start))
    return tasks


def items_tasks(items: List[Any], parallelism: int) -> List[ReadTask]:
    parallelism = max(1, min(parallelism, len(items) or 1))
    step = (len(items) + parallelism - 1) // parallelism
    tasks = []
    for start in range(0, len(items), step):
        chunk = items[start:start + step]
        tasks.append(ReadTask(lambda c=chunk: list(c), num_rows=len(chunk)))
    return tasks


def parquet_tasks(paths, columns: Optional[List[str]] = None,
                  partitioning=None,
                  partition_filter=None) -> List[ReadTask]:
    from ray_tpu_torch.data.partitioning import (add_partition_columns,
                                                 apply_partitioning)
    files = _expand_paths(paths, ".parquet")
    files, values = apply_partitioning(files, partitioning,
                                       partition_filter)

    def read_one(path: str, vals):
        import pyarrow.parquet as pq
        # read THIS file only, not pq.read_table: read_table routes
        # through the dataset API, whose hive inference re-derives
        # partition columns from the path with GUESSED dtypes
        # (year=2024 -> int32) — shadowing the path parser's string
        # values that add_partition_columns appends below (it skips
        # columns that already exist).  ParquetFile reads the file as a
        # file; partition enrichment stays the parser's job.
        src = _open(path) if _is_remote(path) else path
        table = pq.ParquetFile(src).read(columns=columns)
        return add_partition_columns(table, vals) if vals else table

    return [ReadTask(lambda p=f, v=(values[i] if values else None):
                     read_one(p, v), input_files=[f])
            for i, f in enumerate(files)]


def csv_tasks(paths, partitioning=None, partition_filter=None,
              **pandas_kwargs) -> List[ReadTask]:
    from ray_tpu_torch.data.partitioning import (add_partition_columns,
                                                 apply_partitioning)
    files = _expand_paths(paths, ".csv")
    files, part_values = apply_partitioning(files, partitioning,
                                            partition_filter)

    def read_one(path: str, vals):
        import pandas as pd
        frame = pd.read_csv(
            _open(path, "r") if _is_remote(path) else path,
            **pandas_kwargs)
        return add_partition_columns(frame, vals) if vals else frame

    return [ReadTask(lambda p=f, v=(part_values[i] if part_values
                                    else None): read_one(p, v),
                     input_files=[f])
            for i, f in enumerate(files)]


def json_tasks(paths, lines: bool = True) -> List[ReadTask]:
    files = _expand_paths(paths, ".json")

    def read_one(path: str):
        import json
        rows = []
        with _open(path, "r") as fh:
            if lines:
                for line in fh:
                    line = line.strip()
                    if line:
                        rows.append(json.loads(line))
            else:
                data = json.load(fh)
                rows = data if isinstance(data, list) else [data]
        return rows

    return [ReadTask(lambda p=f: read_one(p), input_files=[f])
            for f in files]


def numpy_tasks(paths) -> List[ReadTask]:
    files = _expand_paths(paths, ".npy")
    return [ReadTask(lambda p=f: {"data": np.load(_open(p))},
                     input_files=[f]) for f in files]


def text_tasks(paths) -> List[ReadTask]:
    files = _expand_paths(paths)

    def read_one(path: str):
        with _open(path, "r") as fh:
            return [line.rstrip("\n") for line in fh]

    return [ReadTask(lambda p=f: read_one(p), input_files=[f])
            for f in files]


def binary_tasks(paths) -> List[ReadTask]:
    files = _expand_paths(paths)

    def read_one(path: str):
        with _open(path, "rb") as fh:
            return [{"path": path, "bytes": fh.read()}]

    return [ReadTask(lambda p=f: read_one(p), input_files=[f])
            for f in files]


# -- writers (run as remote tasks, one file per block) ----------------------

def image_tasks(paths, *, size=None, mode: Optional[str] = None
                ) -> List[ReadTask]:
    """Image folder reader (cf. reference data/datasource/
    image_datasource.py): one block of {"image": [N,H,W,C], "path": [N]}
    per batch of files; PIL decodes, optional resize + mode conversion."""
    files = [f for f in _expand_paths(paths)
             if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp",
                                    ".gif", ".webp"))]
    if not files:
        raise ValueError(f"no image files under {paths!r}")
    batch = max(1, len(files) // 8)
    tasks = []
    for start in range(0, len(files), batch):
        chunk = files[start:start + batch]

        def read_chunk(chunk=chunk):
            from PIL import Image
            imgs, names = [], []
            for f in chunk:
                im = Image.open(_open(f))
                if mode:
                    im = im.convert(mode)
                if size:
                    im = im.resize(size)
                imgs.append(np.asarray(im))
                names.append(f)
            shapes = {a.shape for a in imgs}
            if len(shapes) > 1:
                raise ValueError(
                    f"images have differing shapes {sorted(shapes)}; "
                    "pass size=(W, H) and/or mode='RGB' to read_images "
                    "to homogenize them")
            return {"image": np.stack(imgs), "path": np.asarray(names)}

        tasks.append(ReadTask(read_chunk, num_rows=len(chunk),
                              input_files=chunk))
    return tasks


def write_parquet_block(block, path: str, idx: int) -> str:
    from ray_tpu_torch.data.block import BlockAccessor
    import pyarrow.parquet as pq
    table = BlockAccessor.for_block(block).to_arrow()
    local, uri = _out_target(path, f"part-{idx:05d}.parquet")
    if local is not None:
        pq.write_table(table, local)
        return local
    buf = io.BytesIO()
    pq.write_table(table, buf)
    _storage.write_bytes(uri, buf.getvalue())
    return uri


def write_csv_block(block, path: str, idx: int) -> str:
    from ray_tpu_torch.data.block import BlockAccessor
    df = BlockAccessor.for_block(block).to_pandas()
    local, uri = _out_target(path, f"part-{idx:05d}.csv")
    if local is not None:
        df.to_csv(local, index=False)
        return local
    _storage.write_bytes(uri, df.to_csv(index=False).encode())
    return uri


def write_json_block(block, path: str, idx: int) -> str:
    import json

    from ray_tpu_torch.data.block import BlockAccessor
    acc = BlockAccessor.for_block(block)
    local, uri = _out_target(path, f"part-{idx:05d}.json")
    if local is not None:
        with open(local, "w") as fh:
            for row in acc.iter_rows():
                fh.write(json.dumps(_jsonable(row)) + "\n")
        return local
    lines = "".join(json.dumps(_jsonable(row)) + "\n"
                    for row in acc.iter_rows())
    _storage.write_bytes(uri, lines.encode())
    return uri


def write_numpy_block(block, path: str, idx: int, column: str) -> str:
    from ray_tpu_torch.data.block import BlockAccessor
    arrs = BlockAccessor.for_block(block).to_numpy()
    local, uri = _out_target(path, f"part-{idx:05d}.npy")
    if local is not None:
        np.save(local, arrs[column])
        return local
    buf = io.BytesIO()
    np.save(buf, arrs[column])
    _storage.write_bytes(uri, buf.getvalue())
    return uri


def _jsonable(row: Any) -> Any:
    if isinstance(row, dict):
        return {k: _jsonable(v) for k, v in row.items()}
    if isinstance(row, np.ndarray):
        return row.tolist()
    if isinstance(row, (np.integer,)):
        return int(row)
    if isinstance(row, (np.floating,)):
        return float(row)
    return row
