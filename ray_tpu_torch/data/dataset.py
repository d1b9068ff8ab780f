"""Dataset: distributed data as blocks in the object store (the port's copy of
ray_tpu/data/dataset.py).

Analog of Ray's python/ray/data/dataset.py:139 (Dataset,
map_batches :323) with the lazy ExecutionPlan of _internal/plan.py:74:
stages accumulate lazily, consecutive row-wise stages fuse into one task
per block (read→map fusion), and all-to-all stages (shuffle/sort/
repartition) run the two-phase push-based pattern of
_internal/push_based_shuffle.py. Compute strategies mirror
_internal/compute.py:58/176 (task pool default, actor pool for stateful /
expensive-setup UDFs).
"""

from __future__ import annotations

import itertools
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple, Union)

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor, build_block_like
from ray_tpu_torch.data.datasource import ReadTask


class TaskPoolStrategy:
    """One remote task per block (default)."""


class ActorPoolStrategy:
    """A pool of actors applying the UDF — for stateful/setup-heavy fns
    (model inference). cf. reference _internal/compute.py:176."""

    def __init__(self, min_size: int = 1, max_size: Optional[int] = None):
        self.min_size = min_size
        self.max_size = max_size or min_size


ComputeStrategy = Union[TaskPoolStrategy, ActorPoolStrategy, str, None]


class _OneToOne:
    """A row- or batch-wise stage.  ``num_gpus`` is each task's or pool
    actor's GPU lease (ray_tpu leases CPUs only): the raylet shows a
    worker without one no card (``CUDA_VISIBLE_DEVICES=""``)."""

    def __init__(self, name: str, fn: Callable[[Block], Block],
                 compute: ComputeStrategy = None,
                 num_cpus: float = 1.0, num_gpus: float = 0.0):
        self.name = name
        self.fn = fn
        self.compute = compute
        self.num_cpus = num_cpus
        self.num_gpus = num_gpus

    def can_fuse(self, other: "_OneToOne") -> bool:
        return not isinstance(self.compute, ActorPoolStrategy) \
            and not isinstance(other.compute, ActorPoolStrategy)

    def fuse(self, other: "_OneToOne") -> "_OneToOne":
        f, g = self.fn, other.fn
        return _OneToOne(f"{self.name}->{other.name}",
                         lambda b: g(f(b)), other.compute,
                         max(self.num_cpus, other.num_cpus),
                         max(self.num_gpus, other.num_gpus))


class _AllToAll:
    def __init__(self, name: str,
                 fn: Callable[[List[Any]], List[Any]]):
        self.name = name
        self.fn = fn   # List[ObjectRef] -> List[ObjectRef]


def _apply_block_fn(fn, block):
    """-> (block, meta): block tasks return their output plus measured
    per-block stats as a second return slot (ds.stats() plumbing)."""
    import time as _time
    from ray_tpu_torch.data import _stats
    w0, c0 = _time.perf_counter(), _time.process_time()
    out = fn(block)
    return out, _stats.block_meta(out, w0, c0)


def _read_and_apply(task: ReadTask, fn):
    import time as _time
    from ray_tpu_torch.data import _stats
    w0, c0 = _time.perf_counter(), _time.process_time()
    block = task()
    if fn is not None:
        block = fn(block)
    return block, _stats.block_meta(block, w0, c0)


class _BlockWorker:
    """Actor-pool worker: applies a (possibly fused) block fn."""

    def __init__(self, fn):
        self._fn = fn

    def apply(self, block):
        return _apply_block_fn(self._fn, block)


class ExecutionPlan:
    def __init__(self, read_tasks: Optional[List[ReadTask]] = None,
                 block_refs: Optional[List[Any]] = None,
                 stats_parent=None):
        assert (read_tasks is None) != (block_refs is None)
        from ray_tpu_torch.data._stats import DatasetStats
        self._read_tasks = read_tasks
        self._input_refs = block_refs
        self._stages: List[Any] = []
        self._cache: Optional[List[Any]] = None
        self.stats = DatasetStats(parent=stats_parent)

    def with_stage(self, stage) -> "ExecutionPlan":
        if self._cache is None:
            p = ExecutionPlan(self._read_tasks, self._input_refs)
            p._stages = list(self._stages)
        else:
            # derived dataset continues from this one's materialized
            # blocks; carry the stats so ds.stats() shows the full chain
            p = ExecutionPlan(read_tasks=None, block_refs=self._cache,
                              stats_parent=self.stats)
        p._stages.append(stage)
        return p

    def execute(self) -> List[Any]:
        if self._cache is not None:
            return self._cache
        import time as _time

        # fuse consecutive one-to-one stages
        fused: List[Any] = []
        for st in self._stages:
            if isinstance(st, _OneToOne) and fused \
                    and isinstance(fused[-1], _OneToOne) \
                    and fused[-1].can_fuse(st):
                fused[-1] = fused[-1].fuse(st)
            else:
                fused.append(st)

        refs: List[Any]
        idx = 0
        if self._read_tasks is not None:
            # fuse the first run of one-to-one stages into the read tasks
            # — but never an actor-pool stage (a model must instantiate
            # once per actor, not once per block) or one with a bigger
            # resource request than the read's num_cpus=1 (a GPU lease)
            first_fn = None
            if fused and isinstance(fused[0], _OneToOne) \
                    and not isinstance(fused[0].compute,
                                       ActorPoolStrategy) \
                    and fused[0].num_cpus <= 1 and not fused[0].num_gpus:
                first_fn = fused[0].fn
                idx = 1
            name = "read" if first_fn is None else f"read->{fused[0].name}"
            import ray_tpu_torch
            t0 = _time.perf_counter()
            remote_read = ray_tpu_torch.remote(num_cpus=1,
                                               num_returns=2)(_read_and_apply)
            pairs = [remote_read.remote(t, first_fn)
                     for t in self._read_tasks]
            refs = [p[0] for p in pairs]
            self.stats.record_stage(name, _time.perf_counter() - t0,
                                    meta_refs=[p[1] for p in pairs])
        else:
            refs = list(self._input_refs)

        for st in fused[idx:]:
            t0 = _time.perf_counter()
            if isinstance(st, _OneToOne):
                refs, metas = self._run_one_to_one(st, refs)
                self.stats.record_stage(st.name,
                                        _time.perf_counter() - t0,
                                        meta_refs=metas)
            else:
                refs = st.fn(refs)
                self.stats.record_stage(st.name,
                                        _time.perf_counter() - t0,
                                        block_count=len(refs))
        self._cache = refs
        return refs

    def _run_one_to_one(self, st: _OneToOne, refs: List[Any]):
        """-> (block refs, meta refs): every block task yields its stats
        in a second return slot."""
        import ray_tpu_torch
        if isinstance(st.compute, ActorPoolStrategy):
            pool_size = min(st.compute.max_size, max(len(refs), 1))
            actor_cls = ray_tpu_torch.remote(
                num_cpus=st.num_cpus, num_gpus=st.num_gpus)(_BlockWorker)
            actors = [actor_cls.remote(st.fn) for _ in range(pool_size)]
            out, metas = [], []
            for i, ref in enumerate(refs):
                b, m = actors[i % pool_size].apply \
                    .options(num_returns=2).remote(ref)
                out.append(b)
                metas.append(m)
            # keep actor handles alive until results land
            ray_tpu_torch.wait(out, num_returns=len(out))
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass
            return out, metas
        remote_fn = ray_tpu_torch.remote(num_cpus=st.num_cpus,
                                         num_gpus=st.num_gpus,
                                         num_returns=2)(_apply_block_fn)
        pairs = [remote_fn.remote(st.fn, ref) for ref in refs]
        return [p[0] for p in pairs], [p[1] for p in pairs]

    def num_blocks_hint(self) -> int:
        if self._cache is not None:
            return len(self._cache)
        if self._read_tasks is not None:
            return len(self._read_tasks)
        return len(self._input_refs)


class Dataset:
    def __init__(self, plan: ExecutionPlan):
        self._plan = plan

    # ---------------------------------------------------------- transforms
    def map(self, fn: Callable[[Any], Any], *,
            compute: ComputeStrategy = None,
            num_cpus: float = 1.0, num_gpus: float = 0.0) -> "Dataset":
        def block_fn(block):
            acc = BlockAccessor.for_block(block)
            rows = [fn(r) for r in acc.iter_rows()]
            return build_block_like(block, rows)
        return Dataset(self._plan.with_stage(
            _OneToOne("map", block_fn, compute, num_cpus, num_gpus)))

    def map_batches(self, fn: Callable[[Any], Any], *,
                    batch_size: Optional[int] = None,
                    batch_format: str = "default",
                    compute: ComputeStrategy = None,
                    num_cpus: float = 1.0,
                    num_gpus: float = 0.0,
                    fn_constructor_args: Tuple = ()) -> "Dataset":
        """Apply ``fn`` to batches (cf. reference dataset.py:323). When
        ``fn`` is a class, an actor pool instantiates it once per actor
        (stateful inference).  ``num_gpus`` leases each task or pool
        actor that share of a card (Ray's remote arg); what ``fn``
        returns must be on the host (numpy), never a CUDA tensor."""
        if isinstance(fn, type):
            ctor_args = fn_constructor_args
            cls = fn
            if not isinstance(compute, ActorPoolStrategy):
                compute = ActorPoolStrategy(1, 2)

            class _Stateful:
                def __init__(self):
                    self._obj = cls(*ctor_args)

                def __call__(self, batch):
                    return self._obj(batch)

            holder: Dict[str, Any] = {}

            def block_fn(block):
                if "o" not in holder:
                    holder["o"] = _Stateful()
                return _map_batches_impl(holder["o"], block, batch_size,
                                         batch_format)
        else:
            def block_fn(block):
                return _map_batches_impl(fn, block, batch_size, batch_format)
        return Dataset(self._plan.with_stage(
            _OneToOne("map_batches", block_fn, compute, num_cpus,
                      num_gpus)))

    def flat_map(self, fn: Callable[[Any], Iterable[Any]], *,
                 compute: ComputeStrategy = None) -> "Dataset":
        def block_fn(block):
            acc = BlockAccessor.for_block(block)
            rows = [o for r in acc.iter_rows() for o in fn(r)]
            return build_block_like(block, rows)
        return Dataset(self._plan.with_stage(
            _OneToOne("flat_map", block_fn, compute)))

    def filter(self, fn: Callable[[Any], bool], *,
               compute: ComputeStrategy = None) -> "Dataset":
        def block_fn(block):
            acc = BlockAccessor.for_block(block)
            rows = [r for r in acc.iter_rows() if fn(r)]
            return build_block_like(block, rows)
        return Dataset(self._plan.with_stage(
            _OneToOne("filter", block_fn, compute)))

    def add_column(self, name: str, fn: Callable[[Any], Any]) -> "Dataset":
        def block_fn(block):
            acc = BlockAccessor.for_block(block)
            df = acc.to_pandas()
            df[name] = fn(df)
            return df
        return Dataset(self._plan.with_stage(
            _OneToOne("add_column", block_fn)))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def block_fn(block):
            acc = BlockAccessor.for_block(block)
            arrs = acc.to_numpy()
            return {k: v for k, v in arrs.items() if k not in cols}
        return Dataset(self._plan.with_stage(
            _OneToOne("drop_columns", block_fn)))

    def select_columns(self, cols: List[str]) -> "Dataset":
        def block_fn(block):
            acc = BlockAccessor.for_block(block)
            arrs = acc.to_numpy()
            return {k: arrs[k] for k in cols}
        return Dataset(self._plan.with_stage(
            _OneToOne("select_columns", block_fn)))

    def random_sample(self, fraction: float,
                      seed: Optional[int] = None) -> "Dataset":
        def block_fn(block):
            import random as _r
            rng = _r.Random(seed)
            acc = BlockAccessor.for_block(block)
            rows = [r for r in acc.iter_rows() if rng.random() < fraction]
            return build_block_like(block, rows)
        return Dataset(self._plan.with_stage(
            _OneToOne("random_sample", block_fn)))

    # ---------------------------------------------------------- all-to-all
    def repartition(self, num_blocks: int) -> "Dataset":
        def fn(refs):
            return _repartition_refs(refs, num_blocks)
        return Dataset(self._plan.with_stage(_AllToAll("repartition", fn)))

    def iter_repartitioned(self, rows_per_block: int,
                           ) -> Iterator[Any]:
        """Streaming repartition reader: one ``num_returns="streaming"``
        task re-chunks the dataset into ``rows_per_block``-row blocks
        and yields each the moment it is cut — the consumer (a training
        input pipeline) holds the first re-chunked block while the task
        is still reading later input blocks, instead of waiting for a
        full repartition() barrier.  Backpressure
        (``generator_backpressure_num_objects``) bounds how many
        uncollected blocks accumulate in the object store when the
        consumer is slower than the reader."""
        if rows_per_block <= 0:
            raise ValueError("rows_per_block must be positive")
        import ray_tpu_torch
        refs = self._plan.execute()
        reader = ray_tpu_torch.remote(num_cpus=1)(_rechunk_stream) \
            .options(num_returns="streaming")
        for item_ref in reader.remote(rows_per_block, *refs):
            yield ray_tpu_torch.get(item_ref)

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None) -> "Dataset":
        """Push-based two-phase shuffle (cf. reference
        _internal/push_based_shuffle.py): map tasks split each block into P
        random parts; reduce tasks concatenate their part from every map."""
        def fn(refs):
            return _shuffle_refs(refs, seed, num_blocks or len(refs))
        return Dataset(self._plan.with_stage(_AllToAll("random_shuffle", fn)))

    def sort(self, key: Any = None, descending: bool = False) -> "Dataset":
        """Distributed sample sort: sample boundaries, range-partition,
        per-partition sort (cf. reference _internal/sort.py)."""
        def fn(refs):
            return _sort_refs(refs, key, descending)
        return Dataset(self._plan.with_stage(_AllToAll("sort", fn)))

    def groupby(self, key: Any) -> "GroupedData":
        return GroupedData(self, key)

    def zip(self, other: "Dataset") -> "Dataset":
        import ray_tpu_torch
        left = self._plan.execute()
        right = other.repartition(len(left))._plan.execute()
        remote_zip = ray_tpu_torch.remote(num_cpus=1)(_zip_blocks)
        refs = [remote_zip.remote(l, r) for l, r in zip(left, right)]
        return Dataset(ExecutionPlan(block_refs=refs))

    def union(self, *others: "Dataset") -> "Dataset":
        refs = list(self._plan.execute())
        for o in others:
            refs.extend(o._plan.execute())
        return Dataset(ExecutionPlan(block_refs=refs))

    def limit(self, n: int) -> "Dataset":
        import ray_tpu_torch
        refs = self._plan.execute()
        out, remaining = [], n
        for ref in refs:
            if remaining <= 0:
                break
            block = ray_tpu_torch.get(ref)
            acc = BlockAccessor.for_block(block)
            take = min(acc.num_rows(), remaining)
            out.append(ray_tpu_torch.put(acc.slice(0, take)))
            remaining -= take
        return Dataset(ExecutionPlan(block_refs=out))

    # ---------------------------------------------------------- consumption
    def take(self, n: int = 20) -> List[Any]:
        out: List[Any] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def count(self) -> int:
        import ray_tpu_torch
        refs = self._plan.execute()
        remote_count = ray_tpu_torch.remote(num_cpus=1)(_count_block)
        return sum(ray_tpu_torch.get([remote_count.remote(r) for r in refs]))

    def schema(self) -> Any:
        import ray_tpu_torch
        for ref in self._plan.execute():
            block = ray_tpu_torch.get(ref)
            acc = BlockAccessor.for_block(block)
            if acc.num_rows():
                return acc.schema()
        return None

    def num_blocks(self) -> int:
        return self._plan.num_blocks_hint()

    def size_bytes(self) -> int:
        import ray_tpu_torch
        refs = self._plan.execute()
        remote_size = ray_tpu_torch.remote(num_cpus=1)(_size_block)
        return sum(ray_tpu_torch.get([remote_size.remote(r) for r in refs]))

    def input_files(self) -> List[str]:
        tasks = self._plan._read_tasks or []
        return [f for t in tasks for f in t.input_files]

    def iter_rows(self) -> Iterator[Any]:
        import ray_tpu_torch
        for ref in self._plan.execute():
            block = ray_tpu_torch.get(ref)
            yield from BlockAccessor.for_block(block).iter_rows()

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "default",
                     drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None,
                     prefetch_blocks: int = 1) -> Iterator[Any]:
        """Stream batches to the host train loop; with a shuffle buffer this
        is the per-host input pipeline for JaxTrainer (get_dataset_shard)."""
        import ray_tpu_torch
        refs = self._plan.execute()
        if local_shuffle_buffer_size:
            yield from self._iter_shuffled(refs, batch_size, batch_format,
                                           drop_last,
                                           local_shuffle_buffer_size,
                                           local_shuffle_seed)
            return
        carry: Optional[Block] = None
        for i, ref in enumerate(refs):
            block = ray_tpu_torch.get(ref)
            if carry is not None:
                block = _concat_blocks([carry, block])
                carry = None
            acc = BlockAccessor.for_block(block)
            n = acc.num_rows()
            if batch_size is None:
                if n:
                    yield acc.to_batch(batch_format)
                continue
            pos = 0
            while n - pos >= batch_size:
                yield BlockAccessor.for_block(
                    acc.slice(pos, pos + batch_size)).to_batch(batch_format)
                pos += batch_size
            if pos < n:
                carry = acc.slice(pos, n)
        if carry is not None:
            acc = BlockAccessor.for_block(carry)
            if acc.num_rows() and not drop_last:
                yield acc.to_batch(batch_format)

    def _iter_shuffled(self, refs, batch_size, batch_format, drop_last,
                       buffer_size, seed):
        import random as _r

        import ray_tpu_torch
        rng = _r.Random(seed)
        buf: List[Any] = []
        template = None

        def emit():
            rows = [buf.pop(rng.randrange(len(buf)))
                    for _ in range(batch_size)]
            return BlockAccessor.for_block(
                build_block_like(template, rows)).to_batch(batch_format)

        for ref in refs:
            block = ray_tpu_torch.get(ref)
            if template is None:
                template = block
            buf.extend(BlockAccessor.for_block(block).iter_rows())
            while len(buf) >= max(buffer_size, batch_size or 1):
                yield emit()
        while batch_size and len(buf) >= batch_size:
            yield emit()
        if buf and not drop_last:
            yield BlockAccessor.for_block(
                build_block_like(template, buf)).to_batch(batch_format)

    def iter_torch_batches(self, **kwargs) -> Iterator[Any]:
        import torch
        for batch in self.iter_batches(batch_format="numpy", **kwargs):
            yield {k: torch.as_tensor(v) for k, v in batch.items()}

    def to_torch(self, **iter_kwargs):
        """A torch IterableDataset over this dataset's batches (cf.
        reference dataset.py to_torch): each item is a dict of tensors."""
        import torch
        ds = self

        class _TorchIterable(torch.utils.data.IterableDataset):
            def __iter__(self):
                return ds.iter_torch_batches(**iter_kwargs)

        return _TorchIterable()

    # ---------------------------------------------------------- splitting
    def split(self, n: int, *, equal: bool = False,
              locality_hints: Optional[List[Any]] = None) -> List["Dataset"]:
        """Split into n datasets by block (cf. reference dataset.py
        split :978) — the per-host shard entry point for trainers."""
        import ray_tpu_torch
        refs = self._plan.execute()
        if equal:
            total = self.count()
            per = total // n
            return self.split_at_indices(
                [per * i for i in range(1, n)])
        shards: List[List[Any]] = [[] for _ in range(n)]
        for i, ref in enumerate(refs):
            shards[i % n].append(ref)
        return [Dataset(ExecutionPlan(block_refs=s)) for s in shards]

    def split_at_indices(self, indices: List[int]) -> List["Dataset"]:
        import ray_tpu_torch
        refs = self._plan.execute()
        bounds = [0] + list(indices)
        lengths = ray_tpu_torch.get(
            [ray_tpu_torch.remote(num_cpus=1)(_count_block).remote(r)
             for r in refs])
        out: List[List[Any]] = []
        cur: List[Any] = []
        block_starts = list(itertools.accumulate([0] + lengths))
        total = block_starts[-1]
        cuts = list(indices) + [total]
        # slice blocks so each output shard covers [bounds[i], bounds[i+1])
        remote_slice = ray_tpu_torch.remote(num_cpus=1)(_slice_block)
        shard_refs: List[List[Any]] = [[] for _ in cuts]
        for bi, ref in enumerate(refs):
            b_start, b_end = block_starts[bi], block_starts[bi + 1]
            for si, cut_end in enumerate(cuts):
                cut_start = 0 if si == 0 else cuts[si - 1]
                lo, hi = max(b_start, cut_start), min(b_end, cut_end)
                if lo < hi:
                    if lo == b_start and hi == b_end:
                        shard_refs[si].append(ref)
                    else:
                        shard_refs[si].append(
                            remote_slice.remote(ref, lo - b_start,
                                                hi - b_start))
        return [Dataset(ExecutionPlan(block_refs=s)) for s in shard_refs]

    def train_test_split(self, test_size: float, *,
                         shuffle: bool = False,
                         seed: Optional[int] = None) -> Tuple["Dataset",
                                                              "Dataset"]:
        ds = self.random_shuffle(seed=seed) if shuffle else self
        total = ds.count()
        cut = int(total * (1 - test_size))
        left, right = ds.split_at_indices([cut])
        return left, right

    # ---------------------------------------------------------- conversion
    def to_pandas(self):
        import pandas as pd

        import ray_tpu_torch
        dfs = [BlockAccessor.for_block(ray_tpu_torch.get(r)).to_pandas()
               for r in self._plan.execute()]
        return pd.concat(dfs, ignore_index=True) if dfs else pd.DataFrame()

    def to_numpy(self) -> Dict[str, np.ndarray]:
        import ray_tpu_torch
        parts = [BlockAccessor.for_block(ray_tpu_torch.get(r)).to_numpy()
                 for r in self._plan.execute()]
        parts = [p for p in parts if p and len(next(iter(p.values())))]
        if not parts:
            return {}
        return {k: np.concatenate([p[k] for p in parts])
                for k in parts[0].keys()}

    def get_internal_block_refs(self) -> List[Any]:
        return self._plan.execute()

    def materialize(self) -> "Dataset":
        self._plan.execute()
        return self

    fully_executed = materialize

    # ---------------------------------------------------------- io
    def write_parquet(self, path: str) -> List[str]:
        return self._write(path, "parquet")

    def write_csv(self, path: str) -> List[str]:
        return self._write(path, "csv")

    def write_json(self, path: str) -> List[str]:
        return self._write(path, "json")

    def write_tfrecords(self, path: str) -> List[str]:
        import ray_tpu_torch
        from ray_tpu_torch.data.tfrecords import write_tfrecords_block
        refs = self._plan.execute()
        remote_write = ray_tpu_torch.remote(num_cpus=1)(write_tfrecords_block)
        return ray_tpu_torch.get([remote_write.remote(r, path, i)
                                  for i, r in enumerate(refs)])

    def write_numpy(self, path: str, *, column: str = "data") -> List[str]:
        import ray_tpu_torch
        from ray_tpu_torch.data import datasource as dsrc
        refs = self._plan.execute()
        remote_write = ray_tpu_torch.remote(num_cpus=1)(dsrc.write_numpy_block)
        return ray_tpu_torch.get([remote_write.remote(r, path, i, column)
                                  for i, r in enumerate(refs)])

    def _write(self, path: str, fmt: str) -> List[str]:
        import ray_tpu_torch
        from ray_tpu_torch.data import datasource as dsrc
        writer = {"parquet": dsrc.write_parquet_block,
                  "csv": dsrc.write_csv_block,
                  "json": dsrc.write_json_block}[fmt]
        refs = self._plan.execute()
        remote_write = ray_tpu_torch.remote(num_cpus=1)(writer)
        return ray_tpu_torch.get([remote_write.remote(r, path, i)
                                  for i, r in enumerate(refs)])

    # ---------------------------------------------------------- pipeline
    def to_random_access_dataset(self, key: str, num_workers: int = 2):
        """Sorted actor-served point lookups (reference
        random_access_dataset.py)."""
        from ray_tpu_torch.data.random_access_dataset import RandomAccessDataset
        return RandomAccessDataset(self, key, num_workers=num_workers)

    def window(self, *, blocks_per_window: int = 10) -> "DatasetPipeline":
        from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline
        return DatasetPipeline.from_dataset(self, blocks_per_window)

    def repeat(self, times: Optional[int] = None) -> "DatasetPipeline":
        from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline
        return DatasetPipeline.from_dataset_repeated(self, times)

    def stats(self) -> str:
        """Per-stage execution report: blocks, driver wall time, remote
        wall/CPU time, output rows and bytes (reference ds.stats(),
        data/_internal/stats.py:161). Executes the plan if needed."""
        self._plan.execute()
        return self._plan.stats.summary()

    def __repr__(self):
        return f"Dataset(num_blocks={self.num_blocks()})"


# -- grouped aggregation -----------------------------------------------------

class GroupedData:
    """cf. reference data/grouped_dataset.py."""

    def __init__(self, ds: Dataset, key: Any):
        self._ds = ds
        self._key = key

    def _agg(self, init, update, merge, finalize, on: Optional[str],
             name: str) -> Dataset:
        import ray_tpu_torch
        key = self._key
        refs = self._ds._plan.execute()
        remote_partial = ray_tpu_torch.remote(num_cpus=1)(_partial_agg)
        partials = ray_tpu_torch.get([
            remote_partial.remote(r, key, on, init, update) for r in refs])
        merged: Dict[Any, Any] = {}
        for part in partials:
            for k, acc in part.items():
                merged[k] = acc if k not in merged else merge(merged[k], acc)
        rows = [{key if isinstance(key, str) else "key": k,
                 name: finalize(v)} for k, v in sorted(
                     merged.items(), key=lambda kv: str(kv[0]))]
        return Dataset(ExecutionPlan(block_refs=[ray_tpu_torch.put(rows)]))

    def count(self) -> Dataset:
        return self._agg(lambda: 0, lambda a, r, v: a + 1,
                         lambda a, b: a + b, lambda a: a, None, "count")

    def sum(self, on: str) -> Dataset:
        return self._agg(lambda: 0, lambda a, r, v: a + v,
                         lambda a, b: a + b, lambda a: a, on, f"sum({on})")

    def min(self, on: str) -> Dataset:
        return self._agg(lambda: None,
                         lambda a, r, v: v if a is None else min(a, v),
                         lambda a, b: min(a, b), lambda a: a, on,
                         f"min({on})")

    def max(self, on: str) -> Dataset:
        return self._agg(lambda: None,
                         lambda a, r, v: v if a is None else max(a, v),
                         lambda a, b: max(a, b), lambda a: a, on,
                         f"max({on})")

    def mean(self, on: str) -> Dataset:
        return self._agg(lambda: (0.0, 0),
                         lambda a, r, v: (a[0] + v, a[1] + 1),
                         lambda a, b: (a[0] + b[0], a[1] + b[1]),
                         lambda a: a[0] / a[1] if a[1] else 0.0, on,
                         f"mean({on})")


# -- remote helpers (module-level for picklability) -------------------------

def _map_batches_impl(fn, block, batch_size, batch_format):
    acc = BlockAccessor.for_block(block)
    n = acc.num_rows()
    out_blocks = []
    size = batch_size or n or 1
    for start in range(0, n, size):
        batch = BlockAccessor.for_block(
            acc.slice(start, min(start + size, n))).to_batch(batch_format)
        result = fn(batch)
        out_blocks.append(BlockAccessor.batch_to_block(result))
    if not out_blocks:
        return block
    return _concat_blocks(out_blocks)


def _concat_blocks(blocks: List[Block]) -> Block:
    if len(blocks) == 1:
        return blocks[0]
    first = blocks[0]
    if isinstance(first, dict):
        keys = first.keys()
        return {k: np.concatenate(
            [np.asarray(b[k]) for b in blocks]) for k in keys}
    if isinstance(first, list):
        return [r for b in blocks for r in b]
    try:
        import pandas as pd
        if isinstance(first, pd.DataFrame):
            return pd.concat(blocks, ignore_index=True)
    except ImportError:
        pass
    import pyarrow as pa
    return pa.concat_tables(blocks)


def _count_block(block) -> int:
    return BlockAccessor.for_block(block).num_rows()


def _size_block(block) -> int:
    return BlockAccessor.for_block(block).size_bytes()


def _slice_block(block, start: int, end: int):
    return BlockAccessor.for_block(block).slice(start, end)


def _zip_blocks(left, right):
    la = BlockAccessor.for_block(left).to_numpy()
    ra = BlockAccessor.for_block(right).to_numpy()
    out = dict(la)
    for k, v in ra.items():
        out[k if k not in out else f"{k}_1"] = v
    return out


def _partial_agg(block, key, on, init, update):
    acc = BlockAccessor.for_block(block)
    groups: Dict[Any, Any] = {}
    for row in acc.iter_rows():
        k = key(row) if callable(key) else row[key]
        v = row[on] if on else None
        groups[k] = update(groups.get(k, init()), row, v)
    return groups


def _split_block_random(block, parts: int, seed):
    import random as _r
    rng = _r.Random(seed)
    acc = BlockAccessor.for_block(block)
    rows = acc.to_list()
    rng.shuffle(rows)
    out = []
    for i in range(parts):
        out.append(build_block_like(block, rows[i::parts]))
    return out if parts > 1 else out[0]


def _merge_shuffled(seed, *parts):
    import random as _r
    rng = _r.Random(seed)
    block = _concat_blocks(list(parts))
    acc = BlockAccessor.for_block(block)
    rows = acc.to_list()
    rng.shuffle(rows)
    return build_block_like(block, rows)


def _shuffle_refs(refs: List[Any], seed, num_out: int) -> List[Any]:
    import ray_tpu_torch
    num_out = max(1, num_out)
    remote_split = ray_tpu_torch.remote(num_cpus=1)(_split_block_random) \
        .options(num_returns=num_out)
    parts: List[List[Any]] = []
    for i, ref in enumerate(refs):
        s = None if seed is None else seed + i
        res = remote_split.remote(ref, num_out, s)
        parts.append(res if isinstance(res, list) else [res])
    remote_merge = ray_tpu_torch.remote(num_cpus=1)(_merge_shuffled)
    out = []
    for j in range(num_out):
        s = None if seed is None else seed * 1000 + j
        out.append(remote_merge.remote(s, *[p[j] for p in parts]))
    return out


def _split_block_ranges(block, bounds, key, descending):
    """Partition a block's rows into len(bounds)+1 range buckets."""
    from ray_tpu_torch.data.block import _key_of
    acc = BlockAccessor.for_block(block)
    buckets: List[List[Any]] = [[] for _ in range(len(bounds) + 1)]
    for row in acc.iter_rows():
        k = _key_of(row, key) if key is not None else row
        import bisect
        idx = bisect.bisect_right(bounds, k)
        buckets[idx].append(row)
    out = [build_block_like(block, b) for b in buckets]
    return out if len(out) > 1 else out[0]


def _merge_sorted(key, descending, *parts):
    block = _concat_blocks(list(parts))
    return BlockAccessor.for_block(block).sort_block(
        key if key is not None else (lambda r: r), descending)


def _sort_refs(refs: List[Any], key, descending) -> List[Any]:
    import ray_tpu_torch
    n_out = len(refs)
    if n_out == 0:
        return refs
    # sample boundaries
    remote_sample = ray_tpu_torch.remote(num_cpus=1)(_sample_block)
    samples = [s for chunk in ray_tpu_torch.get(
        [remote_sample.remote(r, 20, key) for r in refs]) for s in chunk]
    samples.sort()
    if not samples:
        return refs
    bounds = [samples[int(len(samples) * i / n_out)]
              for i in range(1, n_out)]
    remote_split = ray_tpu_torch.remote(num_cpus=1)(_split_block_ranges) \
        .options(num_returns=n_out)
    parts = []
    for ref in refs:
        res = remote_split.remote(ref, bounds, key, descending)
        parts.append(res if isinstance(res, list) else [res])
    remote_merge = ray_tpu_torch.remote(num_cpus=1)(_merge_sorted)
    order = range(n_out - 1, -1, -1) if descending else range(n_out)
    return [remote_merge.remote(key, descending, *[p[j] for p in parts])
            for j in order]


def _sample_block(block, n, key):
    return BlockAccessor.for_block(block).sample(n, key)


def _rechunk_stream(rows_per_block: int, *blocks):
    """Generator body of Dataset.iter_repartitioned: cut the input
    blocks' row stream into ``rows_per_block``-row output blocks,
    yielding each the moment it fills (streamed to the consumer as its
    own object — never materializing the whole repartition)."""
    pending: List[Any] = []
    template = None
    for block in blocks:
        template = block
        for row in BlockAccessor.for_block(block).iter_rows():
            pending.append(row)
            if len(pending) >= rows_per_block:
                yield build_block_like(block, pending)
                pending = []
    if pending and template is not None:
        yield build_block_like(template, pending)


def _repartition_refs(refs: List[Any], num_blocks: int) -> List[Any]:
    import ray_tpu_torch
    remote_count = ray_tpu_torch.remote(num_cpus=1)(_count_block)
    counts = ray_tpu_torch.get([remote_count.remote(r) for r in refs])
    total = sum(counts)
    per = [total // num_blocks + (1 if i < total % num_blocks else 0)
           for i in range(num_blocks)]
    # assemble output blocks from input slices
    remote_slice = ray_tpu_torch.remote(num_cpus=1)(_slice_block)
    remote_concat = ray_tpu_torch.remote(num_cpus=1)(_concat_parts)
    out = []
    in_idx, in_off = 0, 0
    for want in per:
        pieces = []
        need = want
        while need > 0 and in_idx < len(refs):
            avail = counts[in_idx] - in_off
            take = min(avail, need)
            if take > 0:
                if take == counts[in_idx] and in_off == 0:
                    pieces.append(refs[in_idx])
                else:
                    pieces.append(remote_slice.remote(
                        refs[in_idx], in_off, in_off + take))
                in_off += take
                need -= take
            if in_off >= counts[in_idx]:
                in_idx += 1
                in_off = 0
        if not pieces:
            out.append(ray_tpu_torch.put([]))
        elif len(pieces) == 1:
            out.append(pieces[0])
        else:
            out.append(remote_concat.remote(*pieces))
    return out


def _concat_parts(*parts):
    return _concat_blocks(list(parts))
