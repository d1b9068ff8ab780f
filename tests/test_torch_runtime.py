"""The port's task, actor and object runtime (ray_tpu_torch's copy of
ray_tpu's): the same knobs, ids and serialized values as ray_tpu's, one
port cluster driven through its public API, and a ray_tpu cluster beside
it in the same process."""

import os

# the conftest scales ray_tpu's liveness timeouts for a loaded box; the
# port reads its own prefix, so hand it the same scale
os.environ.setdefault("RAY_TPU_TORCH_TIMEOUT_SCALE",
                      os.environ.get("RAY_TPU_TIMEOUT_SCALE", "1.0"))


import pickle  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import ray_tpu  # noqa: E402
import ray_tpu_torch  # noqa: E402
from ray_tpu._private import config as jax_config  # noqa: E402
from ray_tpu._private import ids as jax_ids  # noqa: E402
from ray_tpu._private import serialization as jax_ser  # noqa: E402
from ray_tpu_torch._core import buildcheck  # noqa: E402
from ray_tpu_torch._private import config as port_config  # noqa: E402
from ray_tpu_torch._private import ids as port_ids  # noqa: E402
from ray_tpu_torch._private import serialization as port_ser  # noqa: E402
from ray_tpu_torch.exceptions import TaskError  # noqa: E402
from ray_tpu_torch.runtime import core_worker  # noqa: E402
from ray_tpu_torch.runtime.node import session_base  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu", "cloudpickle", "msgpack",
             "psutil")
TIMEOUT = 120 * float(os.environ["RAY_TPU_TORCH_TIMEOUT_SCALE"])


# ------------------------------------------------------ parity, no cluster
def test_config_declares_the_same_knobs():
    """Every knob of ray_tpu's CONFIG, with its type and default, except
    the TPU chip count, which the port replaces by ``gpus_per_host``."""
    def table(mod):
        return {n: (f.type, f.default) for n, f in mod._FLAG_TABLE.items()}
    jax_flags, port_flags = table(jax_config), table(port_config)
    assert jax_flags.pop("tpu_chips_per_host") == (int, 0)
    assert port_flags.pop("gpus_per_host") == (int, 0)
    assert port_flags == jax_flags
    assert port_config._ENV_PREFIX == "RAY_TPU_TORCH_"
    assert port_config._SYSTEM_CONFIG_ENV.startswith("RAY_TPU_TORCH_")


def test_package_exports_match():
    assert ray_tpu_torch.__all__ == ray_tpu.__all__
    assert all(hasattr(ray_tpu_torch, name) for name in ray_tpu.__all__)


def test_config_reads_only_its_own_prefix(monkeypatch):
    monkeypatch.setenv("RAY_TPU_INLINE_OBJECT_MAX_BYTES", "999")
    monkeypatch.setenv("RAY_TPU_TORCH_INLINE_OBJECT_MAX_BYTES", "4321")
    assert jax_config.Config().inline_object_max_bytes == 999
    assert port_config.Config().inline_object_max_bytes == 4321


@pytest.mark.parametrize("name", ["JobID", "NodeID", "WorkerID", "ActorID",
                                  "PlacementGroupID", "TaskID", "ObjectID"])
def test_ids_match(name):
    jax_cls, port_cls = getattr(jax_ids, name), getattr(port_ids, name)
    assert port_cls.LENGTH == jax_cls.LENGTH
    a = jax_cls.from_random()
    b = port_cls.from_hex(a.hex())
    assert b.hex() == a.hex() and b.binary() == a.binary()
    assert len(port_cls.from_random().hex()) == 2 * jax_cls.LENGTH
    assert port_cls.nil().hex() == jax_cls.nil().hex()


def test_object_id_layout_matches():
    task = jax_ids.TaskID.from_random()
    a = jax_ids.ObjectID.for_put(task, 7)
    b = port_ids.ObjectID.for_put(port_ids.TaskID(task.binary()), 7)
    assert b.binary() == a.binary()
    assert b.is_put() and b.return_index() == a.return_index()


def _tensors():
    gen = torch.Generator().manual_seed(0)
    return {
        "fp32": torch.randn(3, 5, generator=gen),
        "bf16": torch.randn(4, 6, generator=gen).to(torch.bfloat16),
        "int64": torch.randint(-9, 9, (7,), generator=gen),
        "strided": torch.randn(6, 8, generator=gen)[:, ::3],
        "empty": torch.zeros(0, 4, dtype=torch.bfloat16),
    }


def _roundtrip(ser, value):
    head, views = ser.serialize(value)
    return ser.deserialize(ser.to_flat_bytes(head, views)), views


@pytest.mark.parametrize("name", list(_tensors()))
def test_tensor_serialization_matches_ray_tpu(name):
    t = _tensors()[name]
    jax_out, _ = _roundtrip(jax_ser, t)
    port_out, views = _roundtrip(port_ser, t)
    assert type(port_out) is torch.Tensor and port_out.device.type == "cpu"
    assert port_out.dtype == t.dtype == jax_out.dtype
    assert port_out.shape == t.shape == jax_out.shape
    # bit-exact, bf16 included: compare the raw bytes
    raw = torch.int16 if t.dtype == torch.bfloat16 else t.dtype
    assert torch.equal(port_out.view(raw), t.contiguous().view(raw))
    assert torch.equal(port_out.view(raw), jax_out.contiguous().view(raw))
    # the tensor's bytes travel out of band, whatever its dtype
    assert [len(v) for v in views] == [t.numel() * t.element_size()]


def test_module_keeps_its_parameters():
    """An nn.Module crosses with Parameters (requires_grad kept) and its
    buffers as plain tensors, bit for bit."""
    torch.manual_seed(0)
    mod = torch.nn.Sequential(torch.nn.Linear(4, 3),
                              torch.nn.BatchNorm1d(3)).to(torch.bfloat16)
    mod[0].bias.requires_grad_(False)
    out, views = _roundtrip(port_ser, mod)
    got, want = out.state_dict(), mod.state_dict()
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert [type(p) for p in out.parameters()] == [torch.nn.Parameter] * 4
    assert [p.requires_grad for p in out.parameters()] == [
        p.requires_grad for p in mod.parameters()]
    assert len(views) == len(want)


def test_numpy_and_python_values_match_ray_tpu():
    rng = np.random.default_rng(0)
    value = {"a": rng.standard_normal((64, 33)).astype(np.float32),
             "b": rng.integers(0, 9, 1000), "c": ("x", 1, None, 2.5),
             "d": rng.standard_normal((8, 8))[::2, 1::3]}
    jax_out, _ = _roundtrip(jax_ser, value)
    port_out, views = _roundtrip(port_ser, value)
    assert jax_out["c"] == port_out["c"] == value["c"]
    for k in ("a", "b", "d"):
        np.testing.assert_array_equal(port_out[k], value[k])
        np.testing.assert_array_equal(port_out[k], jax_out[k])
    assert len(views) >= 2
    err = port_ser.to_flat_bytes(*port_ser.serialize(ValueError("x"), 1))
    assert port_ser.error_type_of(err) == 1
    with pytest.raises(ValueError):
        port_ser.deserialize(err)


def test_nested_functions_pickle_by_value():
    """A value holding a lambda crosses the port's serializer (cloudpickle
    pickles it by value); ray_tpu's serializer refuses it, because its
    reducer_override never falls through to cloudpickle's."""
    value = {"f": lambda x: x + 1, "n": 2}
    out, _ = _roundtrip(port_ser, value)
    assert out["f"](out["n"]) == 3
    # by reference: a PicklingError, or an AttributeError for a local
    with pytest.raises((pickle.PicklingError, AttributeError)):
        jax_ser.serialize(value)


def test_shm_store_builds_with_gxx_and_round_trips(tmp_path, monkeypatch):
    from ray_tpu_torch.runtime import object_store
    monkeypatch.setattr(buildcheck, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(object_store, "_lib", None)
    so = buildcheck.ensure_built("shmstore")
    assert so.startswith(str(tmp_path / "_build" / "libshmstore-"))
    store = object_store.SharedMemoryStore.create_segment(
        str(tmp_path / "segment"), 4 << 20)
    try:
        oid = port_ids.ObjectID.from_random()
        head, views = port_ser.serialize(torch.arange(1000))
        store.put_serialized(oid, head, views)
        found, value = store.get_deserialized(oid)
        assert found and torch.equal(value, torch.arange(1000))
        assert store.stats()["num_objects"] == 1
        del value
    finally:
        store.close()
        store.unlink()


# -------------------------------------------------------- one port cluster
@pytest.fixture(scope="module")
def cluster():
    # two cards, as the raylet finds them on a host where the knob is
    # set (it reads the variable at start; the driver needs it no longer)
    saved = os.environ.get("RAY_TPU_TORCH_GPUS_PER_HOST")
    os.environ["RAY_TPU_TORCH_GPUS_PER_HOST"] = "2"
    try:
        ray_tpu_torch.init(num_cpus=4, object_store_memory=256 << 20)
    finally:
        if saved is None:
            del os.environ["RAY_TPU_TORCH_GPUS_PER_HOST"]
        else:
            os.environ["RAY_TPU_TORCH_GPUS_PER_HOST"] = saved
    node = ray_tpu_torch.api._node
    procs = (node.gcs_proc, node.raylet_proc)
    yield node
    ray_tpu_torch.shutdown()
    assert all(p.poll() is not None for p in procs)
    # the raylet unlinked its segment on the way down
    assert not os.path.exists(node.store_path)


@ray_tpu_torch.remote
def _probe(x):
    import os
    import sys

    from ray_tpu_torch.runtime import worker_main
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    return (x, os.environ.get("CUDA_VISIBLE_DEVICES"), loaded,
            worker_main.__file__, os.getpid())


@ray_tpu_torch.remote
def _add(a, b):
    return a + b


@ray_tpu_torch.remote
def _sum_refs(refs):
    return sum(ray_tpu_torch.get(refs))


@ray_tpu_torch.remote
def _tensor_stats(t):
    return t.dtype, tuple(t.shape), float(t.double().sum())


@ray_tpu_torch.remote
def _fail():
    raise ValueError("boom")


@ray_tpu_torch.remote
class _Counter:
    def __init__(self, start):
        self.n = start

    def add(self, k):
        self.n += k
        return self.n, os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid()


def test_task_nested_refs_and_wait(cluster):
    a = _add.remote(1, 2)
    b = _add.remote(a, 10)
    assert ray_tpu_torch.get(b, timeout=TIMEOUT) == 13
    refs = [_add.remote(i, i) for i in range(4)]
    ready, rest = ray_tpu_torch.wait(refs, num_returns=4, timeout=TIMEOUT)
    assert len(ready) == 4 and not rest
    assert ray_tpu_torch.get(_sum_refs.remote(refs), timeout=TIMEOUT) == 12


def test_64mb_tensor_through_shm(cluster):
    t = torch.randn(16 << 20, generator=torch.Generator().manual_seed(1))
    ref = ray_tpu_torch.put(t)
    back = ray_tpu_torch.get(ref, timeout=TIMEOUT)
    assert torch.equal(back, t)
    # the driver's copy is a zero-copy view into the store's segment
    store = core_worker.get_global_worker().store
    lo = store._base
    assert lo <= back.data_ptr() < lo + len(store._mm)
    dtype, shape, total = ray_tpu_torch.get(_tensor_stats.remote(ref),
                                            timeout=TIMEOUT)
    assert (dtype, shape) == (torch.float32, (16 << 20,))
    assert total == pytest.approx(float(t.double().sum()), rel=1e-9)


def _pins_gauge() -> float:
    """The driver's ``ray_tpu_shm_pins`` gauge as a snapshot reads it."""
    from ray_tpu_torch._private import runtime_metrics as rtm
    return rtm.snapshot()["ray_tpu_shm_pins"]["values"]["{}"]


def test_a_fetched_array_outlives_its_ref(cluster):
    """A ``get`` result's arrays are zero-copy views of the store's
    segment.  Dropping the ObjectRef frees the object at its owner; the
    memory must not go to the next ``put``s of the same size while the
    arrays still read it."""
    want = np.arange(4 << 20, dtype=np.float32)       # 16 MiB
    ref = ray_tpu_torch.put(want.copy())
    got = ray_tpu_torch.get(ref, timeout=TIMEOUT)
    store = core_worker.get_global_worker().store
    assert store._base <= got.ctypes.data < store._base + len(store._mm)
    del ref
    more = [ray_tpu_torch.put(np.full_like(want, -1.0)) for _ in range(4)]
    np.testing.assert_array_equal(got, want)
    assert len(more) == 4


def test_pins_go_with_the_last_view(cluster):
    """The pins a ``get`` takes stay while its value's arrays live, after
    the ref is gone too; once the arrays are dropped the pin gauge is
    back at its level before the ``get`` and the object has left the
    store.  A value without views (a pickled dict) keeps no pin."""
    import gc
    worker = core_worker.get_global_worker()
    level = _pins_gauge()
    ref = ray_tpu_torch.put({"a": np.ones(1 << 20, np.float32),
                             "t": torch.zeros(1 << 18)})
    oid = ref.id
    value = ray_tpu_torch.get(ref, timeout=TIMEOUT)
    assert _pins_gauge() == level + 1
    del ref
    assert _pins_gauge() == level + 1 and worker.store.contains(oid)
    t = value["t"]
    del value
    gc.collect()
    assert _pins_gauge() == level + 1        # the tensor is a view too
    del t
    gc.collect()
    assert _pins_gauge() == level
    assert not worker.store.contains(oid)
    ref = ray_tpu_torch.put({"n": list(range(300_000))})
    assert len(ray_tpu_torch.get(ref, timeout=TIMEOUT)["n"]) == 300_000
    assert _pins_gauge() == level


def test_actor_keeps_state(cluster):
    c = _Counter.remote(5)
    assert ray_tpu_torch.get(c.add.remote(1), timeout=TIMEOUT)[0] == 6
    assert ray_tpu_torch.get(c.add.remote(2), timeout=TIMEOUT)[0] == 8
    ray_tpu_torch.kill(c)


def test_task_error_is_the_ports_task_error(cluster):
    with pytest.raises(TaskError, match="boom"):
        ray_tpu_torch.get(_fail.remote(), timeout=TIMEOUT)


def test_cpp_workers_are_refused_naming_the_roadmap(cluster):
    with pytest.raises(RuntimeError, match="ROADMAP.md, Queue 1"):
        ray_tpu_torch.cpp_function("add").remote(1, 2)
    with pytest.raises(RuntimeError, match="ROADMAP.md, Queue 1"):
        ray_tpu_torch.cpp_actor_class("Counter").remote()


def test_gpu_lease_sees_the_cards_and_a_cpu_task_does_not(cluster):
    assert ray_tpu_torch.cluster_resources()["GPU"] == 2.0
    c = _Counter.options(num_gpus=1).remote(0)
    _, visible, pid = ray_tpu_torch.get(c.add.remote(1), timeout=TIMEOUT)
    assert visible in ("0", "1") and pid != os.getpid()
    ray_tpu_torch.kill(c)
    _, visible, _, _, _ = ray_tpu_torch.get(_probe.remote(0),
                                            timeout=TIMEOUT)
    assert visible == ""


def _cards(actor):
    return ray_tpu_torch.get(actor.add.remote(0), timeout=TIMEOUT)[1]


def test_gpu_actors_see_their_own_cards(cluster):
    """Two actors of one card each see different cards; a third takes
    the card the first gives back; two halves share one card."""
    a = _Counter.options(num_gpus=1).remote(0)
    b = _Counter.options(num_gpus=1).remote(0)
    seen = {_cards(a), _cards(b)}
    assert seen == {"0", "1"}
    freed = _cards(a)
    ray_tpu_torch.kill(a)
    c = _Counter.options(num_gpus=1).remote(0)
    assert _cards(c) == freed
    ray_tpu_torch.kill(b)
    ray_tpu_torch.kill(c)
    halves = [_Counter.options(num_gpus=0.5).remote(0) for _ in range(2)]
    shared = {_cards(h) for h in halves}
    assert len(shared) == 1 and shared <= {"0", "1"}
    for h in halves:
        ray_tpu_torch.kill(h)


def test_workers_load_nothing_of_jax_or_ray_tpu(cluster):
    x, _, loaded, main_file, pid = ray_tpu_torch.get(_probe.remote(7),
                                                     timeout=TIMEOUT)
    assert x == 7 and loaded == [] and pid != os.getpid()
    assert os.sep + os.path.join("ray_tpu_torch", "runtime",
                                 "worker_main.py") in main_file


# ------------------------------------------ both runtimes in one process
@ray_tpu.remote
def _jax_side():
    import os

    from ray_tpu.runtime import worker_main
    return "ray_tpu", worker_main.__file__, os.getpid()


@ray_tpu_torch.remote
def _port_side():
    import os

    from ray_tpu_torch.runtime import worker_main
    return "ray_tpu_torch", worker_main.__file__, os.getpid()


def test_both_runtimes_side_by_side(cluster):
    if ray_tpu.is_initialized():    # left by an earlier test of this process
        ray_tpu.shutdown()
    ray_tpu.init(num_cpus=2, object_store_memory=64 << 20)
    try:
        jax_node = ray_tpu.api._node
        procs = (jax_node.gcs_proc, jax_node.raylet_proc)
        assert cluster.session_dir.startswith(session_base() + os.sep)
        assert jax_node.session_dir.startswith("/tmp/ray_tpu_sessions/")
        assert {cluster.gcs_address[1], cluster.raylet_address[1]}.isdisjoint(
            {jax_node.gcs_address[1], jax_node.raylet_address[1]})
        port_seg = os.path.basename(cluster.store_path)
        jax_seg = os.path.basename(jax_node.store_path)
        assert port_seg.startswith("ray_tpu_torch_store_")
        assert jax_seg.startswith("ray_tpu_store_")
        assert not jax_seg.startswith("ray_tpu_torch_store_")
        jax_ref, port_ref = _jax_side.remote(), _port_side.remote()
        name, jax_main, _ = ray_tpu.get(jax_ref, timeout=TIMEOUT)
        assert name == "ray_tpu" and "ray_tpu_torch" not in jax_main
        name, port_main, _ = ray_tpu_torch.get(port_ref, timeout=TIMEOUT)
        assert name == "ray_tpu_torch" and "ray_tpu_torch" in port_main
    finally:
        ray_tpu.shutdown()
    assert all(p.poll() is not None for p in procs)
    # the port's cluster is untouched by the other's shutdown
    assert ray_tpu_torch.get(_add.remote(2, 3), timeout=TIMEOUT) == 5
