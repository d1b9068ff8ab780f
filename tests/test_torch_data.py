"""The port's Data layer (``ray_tpu_torch.data``) against ray_tpu's.

One module-scoped cluster of each package runs side by side; every
pipeline runs on both and must give the same rows, exactly (numpy
scalars and arrays compared by dtype, shape and value).  Preprocessors'
fitted statistics and outputs are equal; a TFRecord file that one
package writes is byte-identical to the other's and reads back in the
other; ``read_csv`` / ``read_json`` / ``read_numpy`` read the same
temporary files.  ray_tpu's sides of the cases without files run
ahead in a thread (fixture ``theirs``), since its workers take seconds
to start.

Packages: ``read_csv`` and ``add_column`` go through pandas (the cases
``csv`` and ``add_column`` skip without it); no case needs pyarrow.
The port's card machine has neither, so every other case runs on dict
of numpy and list blocks only.
"""

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import cloudpickle as port_cloudpickle

TIMEOUT = 60


@pytest.fixture(scope="module")
def both():
    """{"ray_tpu": ray_tpu.data, "ray_tpu_torch": ray_tpu_torch.data},
    each over its own running cluster."""
    import cloudpickle

    import ray_tpu
    import ray_tpu.data
    import ray_tpu_torch.data
    # classes and functions of this module reach either package's
    # workers by value (workers cannot import a test module)
    for cp in (cloudpickle, port_cloudpickle):
        cp.register_pickle_by_value(sys.modules[__name__])
    if ray_tpu.is_initialized():     # left by an earlier test
        ray_tpu.shutdown()
    # two CPUs each: tasks queue on two workers instead of spawning more
    # (a new ray_tpu worker takes ~3 s to start)
    ray_tpu_torch.init(num_cpus=2, object_store_memory=128 << 20)
    ray_tpu.init(num_cpus=2, object_store_memory=128 << 20)
    try:
        yield {"ray_tpu": ray_tpu.data, "ray_tpu_torch": ray_tpu_torch.data}
    finally:
        ray_tpu.shutdown()
        ray_tpu_torch.shutdown()
        for cp in (cloudpickle, port_cloudpickle):
            cp.unregister_pickle_by_value(sys.modules[__name__])


def plain(x):
    """Rows as plain values that compare exactly, dtypes included."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape, plain(x.tolist()))
    if isinstance(x, np.generic):
        return (str(x.dtype), plain(x.item()))
    if isinstance(x, float) and x != x:
        return "nan"                  # NaN equals NaN here
    return x


def same(fn, both):
    """``fn(data_module)`` on both packages at once, ray_tpu's in a
    thread (a new ray_tpu worker takes seconds to start; the port's run
    meanwhile): equal plain values."""
    with ThreadPoolExecutor(1) as pool:
        theirs = pool.submit(fn, both["ray_tpu"])
        got = plain(fn(both["ray_tpu_torch"]))
        want = plain(theirs.result(timeout=TIMEOUT))
    assert got == want
    return got


class _AddConst:
    def __init__(self, c=100):
        self.c = c

    def __call__(self, batch):
        return {"id": batch["id"] + self.c}


def _items(n=12):
    return [{"k": i % 3, "v": (7 * i) % 11, "s": f"r{i}"} for i in range(n)]


PIPELINES = {
    "range": lambda rd: (rd.range(20, parallelism=4).take_all(),
                         rd.range(20, parallelism=4).count()),
    "from_items": lambda rd: rd.from_items(_items(), parallelism=3)
    .take_all(),
    "from_numpy": lambda rd: rd.from_numpy(
        [np.arange(12, dtype=np.int32).reshape(6, 2),
         np.arange(6, dtype=np.float32).reshape(3, 2)]).take_all(),
    "map_batches": lambda rd: rd.range(16, parallelism=2).map_batches(
        lambda b: {"id": b["id"] * 2, "sq": b["id"] ** 2}, batch_size=3,
        batch_format="numpy").take_all(),
    "map_batches_actor_pool": lambda rd: rd.range(
        16, parallelism=4).map_batches(
        _AddConst, batch_format="numpy",
        compute=rd.ActorPoolStrategy(1, 1)).take_all(),
    "map": lambda rd: rd.from_items(list(range(10)), parallelism=2)
    .map(lambda x: {"x": x, "y": x * x}).take_all(),
    "filter_flat_map": lambda rd: rd.from_items(
        list(range(10)), parallelism=2).filter(lambda x: x % 3)
    .flat_map(lambda x: [x, 10 * x]).take_all(),
    "repartition": lambda rd: (
        lambda ds: (ds.take_all(), len(ds.get_internal_block_refs())))(
        rd.range(20, parallelism=5).repartition(3)),
    "split_equal": lambda rd: [
        s.take_all() for s in rd.range(21, parallelism=4).split(
            3, equal=True)],
    "groupby": lambda rd: (
        rd.from_items(_items(), parallelism=3).groupby("k").sum("v")
        .take_all(),
        rd.from_items(_items(), parallelism=3).groupby("k").count()
        .take_all()),
    "sort": lambda rd: rd.from_items(_items(), parallelism=3)
    .sort("v", descending=True).take_all(),
    "random_shuffle": lambda rd: rd.range(50, parallelism=4)
    .random_shuffle(seed=7).take_all(),
    "window": lambda rd: list(rd.range(12, parallelism=4).window(
        blocks_per_window=2).map_batches(
        lambda b: {"id": b["id"] + 1}, batch_format="numpy").iter_rows()),
    "iter_batches": lambda rd: list(rd.range(10, parallelism=3)
                                    .iter_batches(batch_size=4,
                                                  batch_format="numpy")),
}


ACTOR_CASES = {("pipeline", "map_batches_actor_pool"), ("random_access",)}


def _cases():
    """Every case that runs without files, by key, in the file's order."""
    from functools import partial
    return {**{("pipeline", n): PIPELINES[n] for n in sorted(PIPELINES)},
            **{("preprocessor", n): partial(_preprocess, n)
               for n in sorted(PREPROCESSORS)},
            ("random_access",): _random_access}


@pytest.fixture(scope="module")
def theirs(both):
    """ray_tpu's side of every case in :func:`_cases`, run from the
    clusters' start on in two threads, one for the cases that start
    actors and one for the rest: a new ray_tpu worker or actor takes
    seconds to start, and the port's sides and the other tests run
    meanwhile.  {key: future}."""
    pools = [ThreadPoolExecutor(1), ThreadPoolExecutor(1)]
    futures = {key: pools[key in ACTOR_CASES].submit(fn, both["ray_tpu"])
               for key, fn in _cases().items()}
    try:
        yield futures
    finally:
        for pool in pools:
            pool.shutdown(wait=True, cancel_futures=True)


def same_case(key, theirs, both):
    """The case ``key`` on the port, equal to ray_tpu's run of it."""
    got = plain(_cases()[key](both["ray_tpu_torch"]))
    assert got == plain(theirs[key].result(timeout=5 * TIMEOUT))
    return got


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_pipeline_rows_match_ray_tpu(theirs, both, name):
    same_case(("pipeline", name), theirs, both)


def test_add_column_matches_ray_tpu(both):
    pytest.importorskip("pandas")        # add_column works on a DataFrame
    same(lambda rd: rd.range(6, parallelism=2).add_column(
        "twice", lambda df: df["id"] * 2).take_all(), both)


# ------------------------------------------------------------ preprocessors
def _table(rd):
    rng = np.random.default_rng(0)
    x = rng.normal(3.0, 2.0, 40)
    x[[3, 17]] = np.nan
    blocks = []
    for part in np.array_split(np.arange(40), 4):
        blocks.append({"x": x[part], "y": rng.uniform(-1, 5, len(part)),
                       "cat": np.array(["b", "a", "c", "a"] * 3)[
                           :len(part)],
                       "lab": np.array([2, 9, 4, 9, 2] * 2)[:len(part)]})
    import ray_tpu
    import ray_tpu_torch
    put = ray_tpu.put if rd.__name__ == "ray_tpu.data" \
        else ray_tpu_torch.put
    from importlib import import_module
    ds_mod = import_module(rd.__name__ + ".dataset")
    return ds_mod.Dataset(ds_mod.ExecutionPlan(
        block_refs=[put(b) for b in blocks]))


PREPROCESSORS = {
    "standard_scaler": lambda P: P.StandardScaler(["y"]),
    "minmax_scaler": lambda P: P.MinMaxScaler(["y"]),
    "label_encoder": lambda P: P.LabelEncoder("lab"),
    "one_hot": lambda P: P.OneHotEncoder(["cat"]),
    "imputer_mean": lambda P: P.SimpleImputer(["x"]),
    "imputer_constant": lambda P: P.SimpleImputer(
        ["x"], strategy="constant", fill_value=-1.0),
    "concatenator": lambda P: P.Concatenator(["x", "y"]),
    "batch_mapper": lambda P: P.BatchMapper(
        lambda b: {"z": np.asarray(b["y"]) * 2 + 1}),
    "chain": lambda P: P.Chain(P.SimpleImputer(["x"]),
                               P.StandardScaler(["x", "y"]),
                               P.Concatenator(["x", "y"])),
}


def _fitted(p):
    keys = ("stats_", "classes_")
    out = {k: getattr(p, k) for k in keys if hasattr(p, k)}
    if hasattr(p, "preprocessors"):
        out["chain"] = [_fitted(q) for q in p.preprocessors]
    return out


def _preprocess(name, rd):
    from importlib import import_module
    P = import_module(rd.__name__ + ".preprocessors")
    p = PREPROCESSORS[name](P)
    rows = p.fit_transform(_table(rd)).take_all()
    return _fitted(p), rows


@pytest.mark.parametrize("name", sorted(PREPROCESSORS))
def test_preprocessor_matches_ray_tpu(theirs, both, name):
    same_case(("preprocessor", name), theirs, both)


# ------------------------------------------------------------- files
def test_tfrecords_cross_read_byte_identical(both, tmp_path):
    rows = [{"i": i, "f": [0.5 * i, -1.25], "s": f"row {i}",
             "b": bytes([i, 255 - i]), "v": list(range(i % 4))}
            for i in range(9)]
    files = {}
    for name, rd in both.items():
        out = tmp_path / name
        rd.from_items(rows, parallelism=3).write_tfrecords(str(out))
        files[name] = {f: (out / f).read_bytes()
                       for f in sorted(os.listdir(out))}
    assert len(files["ray_tpu"]) == 3
    assert files["ray_tpu_torch"] == files["ray_tpu"]
    # each package reads the other's files
    got = both["ray_tpu_torch"].read_tfrecords(
        str(tmp_path / "ray_tpu")).take_all()
    want = both["ray_tpu"].read_tfrecords(
        str(tmp_path / "ray_tpu_torch")).take_all()
    assert plain(got) == plain(want)
    assert [r["i"] for r in got] == [[i] for i in range(9)] or \
        [r["i"] for r in got] == list(range(9))


def test_read_json_and_numpy_match_ray_tpu(both, tmp_path):
    with open(tmp_path / "a.jsonl", "w") as f:
        for i in range(7):
            f.write(json.dumps({"i": i, "t": f"x{i}", "l": [i, i + 1]})
                    + "\n")
    np.save(tmp_path / "b.npy", np.arange(24, dtype=np.int16)
            .reshape(6, 4))
    np.save(tmp_path / "c.npy", np.linspace(0, 1, 10).reshape(5, 2))
    same(lambda rd: (
        rd.read_json(str(tmp_path / "a.jsonl")).take_all(),
        rd.read_numpy([str(tmp_path / "b.npy"),
                       str(tmp_path / "c.npy")]).take_all()), both)


def test_read_csv_matches_ray_tpu(both, tmp_path):
    pytest.importorskip("pandas")        # read_csv parses with pandas
    with open(tmp_path / "a.csv", "w") as f:
        f.write("a,b,c\n")
        for i in range(8):
            f.write(f"{i},{i * 0.5},w{i % 3}\n")
    same(lambda rd: rd.read_csv(str(tmp_path / "a.csv")).take_all(), both)


def test_write_numpy_and_json_round_trip(both, tmp_path):
    """Files the port writes equal ray_tpu's, byte for byte."""
    for kind in ("numpy", "json"):
        files = {}
        for name, rd in both.items():
            out = tmp_path / f"{kind}_{name}"
            ds = rd.from_numpy([np.arange(8.0).reshape(4, 2),
                                np.arange(8.0, 14.0).reshape(3, 2)])
            getattr(ds, f"write_{kind}")(str(out))
            files[name] = {f: (out / f).read_bytes()
                           for f in sorted(os.listdir(out))}
        assert files["ray_tpu_torch"] == files["ray_tpu"], kind


def _random_access(rd):
    rad = rd.from_items([{"k": i, "v": i * i} for i in range(20)],
                        parallelism=2).to_random_access_dataset(
        "k", num_workers=1)
    refs = [rad.get_async(k) for k in (3, 40)]
    rt = ray_tpu_torch if rd.__name__ == "ray_tpu_torch.data" \
        else __import__("ray_tpu")
    return rad.multiget([0, 7, 19, 33]), [rt.get(r, timeout=TIMEOUT)
                                          for r in refs]


def test_random_access_get_matches_ray_tpu(theirs, both):
    got = same_case(("random_access",), theirs, both)
    assert got[0][1] == {"k": 7, "v": 49} and got[0][3] is None
