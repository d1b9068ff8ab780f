"""DatasetPipeline: windowed/streaming execution over a Dataset
(the port's copy of ray_tpu/data/dataset_pipeline.py).

Analog of Ray's python/ray/data/dataset_pipeline.py: a pipeline
is a sequence of (lazily executed) Dataset windows; per-window transforms
apply to each window as it streams, letting ingest overlap with training
epochs without materializing the whole dataset.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional


class DatasetPipeline:
    def __init__(self, window_fn: Callable[[], Iterator["Any"]],
                 length: Optional[int] = None):
        self._window_fn = window_fn     # () -> iterator of Datasets
        self._length = length

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_dataset(cls, ds, blocks_per_window: int) -> "DatasetPipeline":
        from ray_tpu_torch.data.dataset import Dataset, ExecutionPlan

        def gen():
            refs = ds._plan.execute()
            for i in range(0, len(refs), blocks_per_window):
                yield Dataset(ExecutionPlan(
                    block_refs=refs[i:i + blocks_per_window]))

        n = (ds.num_blocks() + blocks_per_window - 1) // blocks_per_window
        return cls(gen, n)

    @classmethod
    def from_dataset_repeated(cls, ds,
                              times: Optional[int]) -> "DatasetPipeline":
        def gen():
            import itertools
            it = range(times) if times else itertools.count()
            for _ in it:
                yield ds

        return cls(gen, times)

    # -- per-window transforms --------------------------------------------
    def _transform(self, f: Callable[[Any], Any],
                   name: str) -> "DatasetPipeline":
        prev = self._window_fn

        def gen():
            for w in prev():
                yield f(w)

        return DatasetPipeline(gen, self._length)

    def map(self, fn, **kw) -> "DatasetPipeline":
        return self._transform(lambda d: d.map(fn, **kw), "map")

    def map_batches(self, fn, **kw) -> "DatasetPipeline":
        return self._transform(lambda d: d.map_batches(fn, **kw),
                               "map_batches")

    def filter(self, fn, **kw) -> "DatasetPipeline":
        return self._transform(lambda d: d.filter(fn, **kw), "filter")

    def flat_map(self, fn, **kw) -> "DatasetPipeline":
        return self._transform(lambda d: d.flat_map(fn, **kw), "flat_map")

    def random_shuffle_each_window(self, **kw) -> "DatasetPipeline":
        return self._transform(lambda d: d.random_shuffle(**kw), "shuffle")

    def repartition_each_window(self, n: int) -> "DatasetPipeline":
        return self._transform(lambda d: d.repartition(n), "repartition")

    # -- consumption -------------------------------------------------------
    def iter_datasets(self) -> Iterator[Any]:
        return self._window_fn()

    def iter_rows(self) -> Iterator[Any]:
        for ds in self.iter_datasets():
            yield from ds.iter_rows()

    def iter_batches(self, **kw) -> Iterator[Any]:
        for ds in self.iter_datasets():
            yield from ds.iter_batches(**kw)

    def take(self, n: int = 20) -> List[Any]:
        out: List[Any] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def count(self) -> int:
        return sum(ds.count() for ds in self.iter_datasets())

    def split(self, n: int) -> List["DatasetPipeline"]:
        """Round-robin window assignment to n consumer pipelines (each
        worker consumes its own sub-pipeline)."""
        out = []
        for i in range(n):
            def gen(i=i):
                for j, ds in enumerate(self._window_fn()):
                    if j % n == i:
                        yield ds
            out.append(DatasetPipeline(gen))
        return out

    def __repr__(self):
        ln = self._length if self._length is not None else "inf"
        return f"DatasetPipeline(windows={ln})"
