"""ray_tpu_torch.data: distributed datasets over object-store blocks
(the port's copy of ray_tpu/data/__init__.py).

Analog of Ray's python/ray/data (SURVEY.md §2.4): read_* → lazy
plan → map/shuffle/sort/split → iter_batches/to_* consumption; blocks are
objects, transforms are tasks/actor pools, splits feed per-host trainer
shards.
"""

from typing import Any, List, Optional

from ray_tpu_torch.data.block import Block, BlockAccessor  # noqa: F401
from ray_tpu_torch.data.dataset import (ActorPoolStrategy, Dataset,  # noqa: F401
                                        ExecutionPlan, GroupedData,
                                        TaskPoolStrategy)
from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline  # noqa: F401
from ray_tpu_torch.data.random_access_dataset import \
    RandomAccessDataset  # noqa: F401
from ray_tpu_torch.data.preprocessors import (BatchMapper, Chain,  # noqa: F401
                                              Concatenator, LabelEncoder,
                                              MinMaxScaler, OneHotEncoder,
                                              Preprocessor, SimpleImputer,
                                              StandardScaler)
from ray_tpu_torch.data import datasource as _dsrc
from ray_tpu_torch.data.partitioning import (Partitioning,  # noqa: F401
                                             PathPartitionFilter)


def _from_tasks(tasks) -> Dataset:
    return Dataset(ExecutionPlan(read_tasks=tasks))


def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001
    return _from_tasks(_dsrc.range_tasks(n, parallelism))


def from_items(items: List[Any], *, parallelism: int = 8) -> Dataset:
    return _from_tasks(_dsrc.items_tasks(list(items), parallelism))


def from_pandas(dfs) -> Dataset:
    import ray_tpu_torch
    if not isinstance(dfs, list):
        dfs = [dfs]
    return Dataset(ExecutionPlan(
        block_refs=[ray_tpu_torch.put(df) for df in dfs]))


def from_numpy(arrays) -> Dataset:
    import numpy as np

    import ray_tpu_torch
    if not isinstance(arrays, list):
        arrays = [arrays]
    return Dataset(ExecutionPlan(block_refs=[
        ray_tpu_torch.put({"data": np.asarray(a)}) for a in arrays]))


def from_arrow(tables) -> Dataset:
    import ray_tpu_torch
    if not isinstance(tables, list):
        tables = [tables]
    return Dataset(ExecutionPlan(
        block_refs=[ray_tpu_torch.put(t) for t in tables]))


def read_parquet(paths, *, columns: Optional[List[str]] = None,
                 partitioning=None, partition_filter=None) -> Dataset:
    """``partitioning``/``partition_filter``: hive-layout lakes — prune
    files by path-encoded values before reading, and append the values
    as columns (data/partitioning.py)."""
    return _from_tasks(_dsrc.parquet_tasks(
        paths, columns, partitioning=partitioning,
        partition_filter=partition_filter))


def read_csv(paths, *, partitioning=None, partition_filter=None,
             **kwargs) -> Dataset:
    return _from_tasks(_dsrc.csv_tasks(
        paths, partitioning=partitioning,
        partition_filter=partition_filter, **kwargs))


def read_tfrecords(paths, *, partitioning=None,
                   partition_filter=None) -> Dataset:
    """tf.train.Example records (data/tfrecords.py: framing + protobuf
    decoded without a tensorflow dependency)."""
    from ray_tpu_torch.data import tfrecords as _tfr
    return _from_tasks(_tfr.tfrecord_tasks(
        paths, partitioning=partitioning,
        partition_filter=partition_filter))


def read_mongo(uri: str, database: str, collection: str, *,
               pipeline: Optional[List[dict]] = None,
               parallelism: int = 4) -> Dataset:
    """Read a MongoDB collection (cf. reference
    python/ray/data/datasource/mongo_datasource.py).  Paginates with
    $skip/$limit into parallel read tasks — simpler than the
    reference's _id-range splitting, with the standard caveats: each
    task re-scans O(skip) documents server-side, and concurrent writes
    during the read can duplicate or miss documents.  Use a quiesced
    collection (or a pipeline filter pinning a snapshot) for exact
    results.  Requires pymongo (not baked into this image — the import
    error says so at call time, not deep in a worker)."""
    try:
        import pymongo  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "read_mongo requires pymongo, which is not installed in "
            "this environment") from e

    def make_task(skip: int, limit: int):
        def read_block():
            import pymongo as pm
            coll = pm.MongoClient(uri)[database][collection]
            stages = list(pipeline or [])
            stages += [{"$skip": skip}, {"$limit": limit}]
            return list(coll.aggregate(stages))
        return _dsrc.ReadTask(read_block)

    import pymongo as pm
    total = pm.MongoClient(uri)[database][collection] \
        .estimated_document_count()
    parallelism = max(1, min(parallelism, total or 1))
    per = max(1, (total + parallelism - 1) // parallelism)
    tasks = [make_task(s, per) for s in range(0, total, per)]
    if not tasks:
        return from_items([])
    return _from_tasks(tasks)


def read_json(paths, *, lines: bool = True) -> Dataset:
    return _from_tasks(_dsrc.json_tasks(paths, lines))


def read_numpy(paths) -> Dataset:
    return _from_tasks(_dsrc.numpy_tasks(paths))


def read_text(paths) -> Dataset:
    return _from_tasks(_dsrc.text_tasks(paths))


def read_binary_files(paths) -> Dataset:
    return _from_tasks(_dsrc.binary_tasks(paths))


def read_images(paths, *, size=None, mode: Optional[str] = None) -> Dataset:
    """Decode an image folder into {"image", "path"} blocks (PIL)."""
    return _from_tasks(_dsrc.image_tasks(paths, size=size, mode=mode))


def from_torch(torch_dataset, *, parallelism: int = 8) -> Dataset:
    """Read a torch map-style Dataset in parallel (cf. reference
    read_api.from_torch): the index range splits into per-block read
    tasks that call ``__getitem__`` inside workers, so the driver never
    materializes the whole dataset (the dataset object itself must be
    small enough to pickle to each task — true for the common
    lazy-loading map-style datasets)."""
    import builtins
    n = len(torch_dataset)
    parallelism = max(1, min(parallelism, n or 1))
    per = max(1, (n + parallelism - 1) // parallelism)

    def make_read(start: int, stop: int):
        def read_block():
            return [torch_dataset[i] for i in builtins.range(start, stop)]
        return _dsrc.ReadTask(read_block, num_rows=stop - start)

    tasks = [make_read(s, min(s + per, n))
             for s in builtins.range(0, n, per)]
    if not tasks:
        return from_items([])
    return _from_tasks(tasks)


def from_huggingface(hf_dataset) -> Dataset:
    """Wrap a Hugging Face datasets.Dataset (cf. reference
    read_api.from_huggingface) via its Arrow table. Datasets carrying an
    indices mapping (select/shuffle/filter results) are flattened first —
    the raw table ignores the mapping and would return the wrong rows."""
    import ray_tpu_torch
    if getattr(hf_dataset, "_indices", None) is not None:
        hf_dataset = hf_dataset.flatten_indices()
    table = hf_dataset.data.table
    return Dataset(ExecutionPlan(block_refs=[ray_tpu_torch.put(table)]))


__all__ = [
    "Dataset", "DatasetPipeline", "BlockAccessor", "Block",
    "TaskPoolStrategy", "ActorPoolStrategy", "GroupedData",
    "range", "from_items", "from_pandas", "from_numpy", "from_arrow",
    "read_parquet", "read_csv", "read_json", "read_numpy", "read_text",
    "read_binary_files", "read_images", "read_tfrecords", "read_mongo",
    "from_torch", "from_huggingface",
    "Partitioning", "PathPartitionFilter",
    "RandomAccessDataset", "Preprocessor", "StandardScaler", "MinMaxScaler", "LabelEncoder",
    "OneHotEncoder", "SimpleImputer", "Concatenator", "BatchMapper", "Chain",
]
