"""The port's trainer (ray_tpu_torch.train: JaxTrainer, the worker group,
sync_gradients) and host collective (ray_tpu_torch.util.collective) held
against ray_tpu's on the CPU.

- The whole slice: the port's JaxTrainer takes three ``make_train``
  steps of ``tiny`` in a worker, from weights converted from JAX's; its
  reported losses and gradient norms equal ``make_sharded_train``'s on a
  one-device mesh within ``tests/test_torch_train.py``'s RTOL (1e-5:
  both sides compute fp32 on the CPU).
- The control plane: one numpy-only loop runs under ray_tpu's and the
  port's JaxTrainer, with checkpoints pruned by a score, a stop
  criterion, and a raising loop; the results must be equal (metrics,
  ``training_iteration``, the kept checkpoints' dicts, the error type).
- Two workers: ``sync_gradients`` gives the numpy mean exactly (fp32
  sum, then / world), with and without ``async_op``; the ranks'
  parameters stay equal.  A few of ``tests/test_collective.py``'s
  numerics at world 2.  Leases: a GPU worker sees its (faked) card and
  refuses to train without CUDA; a CPU worker sees none and never starts
  CUDA.

One port cluster (one faked card) serves the module; ray_tpu's cluster
runs once, for its control-plane fits.
"""

import os

# the conftest scales ray_tpu's liveness timeouts for a loaded box; the
# port reads its own prefix, so hand it the same scale
os.environ.setdefault("RAY_TPU_TORCH_TIMEOUT_SCALE",
                      os.environ.get("RAY_TPU_TIMEOUT_SCALE", "1.0"))

import sys  # noqa: E402

import cloudpickle  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch import cloudpickle as port_cloudpickle  # noqa: E402
from ray_tpu_torch.air import RunConfig, ScalingConfig  # noqa: E402
from ray_tpu_torch.train import JaxTrainer, WorkerGroup  # noqa: E402
from test_torch_train import RTOL, _batch  # noqa: E402

# the train loops below travel to the workers by value (the workers
# cannot import this module), as a script's loops do from __main__
for _cp in (cloudpickle, port_cloudpickle):
    _cp.register_pickle_by_value(sys.modules[__name__])

TIMEOUT = 120 * float(os.environ["RAY_TPU_TORCH_TIMEOUT_SCALE"])
OPT = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=10)
OVER = dict(n_kv_heads=2, max_seq_len=64)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    saved = os.environ.get("RAY_TPU_TORCH_GPUS_PER_HOST")
    os.environ["RAY_TPU_TORCH_GPUS_PER_HOST"] = "1"   # one faked card
    try:
        ray_tpu_torch.init(num_cpus=4, object_store_memory=256 << 20)
    finally:
        if saved is None:
            del os.environ["RAY_TPU_TORCH_GPUS_PER_HOST"]
        else:
            os.environ["RAY_TPU_TORCH_GPUS_PER_HOST"] = saved
    yield str(tmp_path_factory.mktemp("results"))
    ray_tpu_torch.shutdown()


# ------------------------------------------------ the slice against JAX
def _slice_loop(config):
    from ray_tpu_torch.air import session
    from ray_tpu_torch.models.configs import get_config
    from ray_tpu_torch.models.gpt import GPT
    from ray_tpu_torch.train import get_device
    from ray_tpu_torch.train.step import OptimizerConfig, make_train
    cfg = get_config("tiny", attention_impl="flash", **config["over"])
    model = GPT(cfg, device=get_device())
    model.load_state_dict(config["state"])
    init_fn, step_fn = make_train(model, OptimizerConfig(**config["opt"]))
    state, steps = init_fn(), []
    for _ in range(3):
        state, m = step_fn(state, config["batch"])
        steps.append({k: float(v) for k, v in m.items()})
        session.report({"steps": list(steps)})


def test_jax_trainer_steps_match_make_sharded_train(cluster):
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from ray_tpu.models.configs import get_config as jax_config
    from ray_tpu.models.gpt import GPT as JaxGPT
    from ray_tpu.parallel import MeshConfig, build_mesh
    from ray_tpu.train.step import OptimizerConfig as JaxOptimizerConfig
    from ray_tpu.train.step import make_sharded_train
    from ray_tpu_torch.models.configs import get_config
    from ray_tpu_torch.models.convert import params_from_jax

    jcfg = jax_config("tiny", attention_impl="xla", **OVER)
    tcfg = get_config("tiny", attention_impl="flash", **OVER)
    batch = _batch(tcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    init_fn, step_fn, _, _ = make_sharded_train(
        JaxGPT(jcfg, mesh=mesh), mesh, JaxOptimizerConfig(**OPT),
        example_batch=jbatch)
    state = init_fn(jax.random.PRNGKey(0), jbatch)
    sd = params_from_jax(jax.tree.map(np.asarray,
                                      nn.meta.unbox(state.params)), tcfg)
    want = []
    for _ in range(3):
        state, m = step_fn(state, jbatch)
        want.append({k: float(v) for k, v in m.items()})

    result = JaxTrainer(
        _slice_loop, train_loop_config=dict(state=sd, batch=batch,
                                            opt=OPT, over=OVER),
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=cluster, name="slice")).fit()
    assert result.error is None, result.error
    assert result.metrics["training_iteration"] == 3
    for got, exp in zip(result.metrics["steps"], want, strict=True):
        assert got.keys() == exp.keys()
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], exp[k], rtol=RTOL)
        assert got["tokens"] == exp["tokens"]


# --------------------------------- the control plane against ray_tpu's
def _np_loop(config):
    """numpy only: the package's air API comes by name, so one loop runs
    under both trainers."""
    import importlib

    import numpy as np
    air = importlib.import_module(config["pkg"] + ".air")
    rng = np.random.default_rng(config["seed"])
    w = np.zeros(4)
    for step in range(config["steps"]):
        if step == config.get("fail_at"):
            raise ValueError(f"boom at step {step}")
        w = w - 0.25 * (w - rng.standard_normal(4))
        ckpt = (air.Checkpoint.from_dict({"step": step, "w": w.tolist()})
                if step % 2 == 0 else None)
        air.session.report({"step": step, "loss": float((w ** 2).sum()),
                            "rank": air.session.get_world_rank(),
                            "world": air.session.get_world_size()},
                           checkpoint=ckpt)
    return "done"


RUNS = {
    # checkpoints at steps 0, 2, 4: the two of lowest loss kept; stopped
    # by the criterion at iteration 6 of 50
    "keep_stop": (dict(seed=1, steps=50),
                  dict(stop={"training_iteration": 6},
                       checkpoint_config=dict(
                           num_to_keep=2, checkpoint_score_attribute="loss",
                           checkpoint_score_order="min"))),
    # the loop raises before its first report (ray_tpu's worker would
    # wait out its 10 s poll after a later one)
    "fail": (dict(seed=2, steps=8, fail_at=0),
             dict(checkpoint_config=dict(num_to_keep=2))),
}


def _fit(pkg, trainer_cls, air, storage, name):
    cfg, run = RUNS[name]
    run = dict(run)
    if "checkpoint_config" in run:
        run["checkpoint_config"] = air.CheckpointConfig(
            **run["checkpoint_config"])
    result = trainer_cls(
        _np_loop, train_loop_config=dict(cfg, pkg=pkg),
        scaling_config=air.ScalingConfig(num_workers=1),
        run_config=air.RunConfig(storage_path=storage, name=name,
                                 **run)).fit()
    return dict(
        metrics=result.metrics,
        checkpoint=(result.checkpoint.to_dict()
                    if result.checkpoint is not None else None),
        best=[(c.to_dict(), m) for c, m in result.best_checkpoints],
        error=(type(result.error).__name__, str(result.error))
        if result.error is not None else None)


def _fit_all(pkg, trainer_cls, air, storage):
    """Every run, each fit in a thread of its own (the runs overlap)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(RUNS)) as pool:
        futs = {name: pool.submit(_fit, pkg, trainer_cls, air, storage,
                                  name) for name in RUNS}
        return {name: f.result() for name, f in futs.items()}


@pytest.fixture(scope="module")
def jax_fits(tmp_path_factory):
    import ray_tpu
    from ray_tpu import air as jax_air
    from ray_tpu.train import JaxTrainer as JaxJaxTrainer
    ray_tpu.init(num_cpus=4, object_store_memory=128 << 20)
    try:
        return _fit_all("ray_tpu", JaxJaxTrainer, jax_air,
                        str(tmp_path_factory.mktemp("jax_results")))
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def port_fits(cluster):
    from ray_tpu_torch import air
    return _fit_all("ray_tpu_torch", JaxTrainer, air, cluster)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_control_plane_matches_ray_tpu_jax_trainer(port_fits, jax_fits,
                                                   run):
    got, want = port_fits[run], jax_fits[run]
    if run == "fail":
        assert got["error"][0] == want["error"][0] == "TrainingFailedError"
        assert "boom at step 0" in got["error"][1]
        assert "boom at step 0" in want["error"][1]
    else:
        assert got["error"] is None and want["error"] is None
        assert got["metrics"]["training_iteration"] == 6
        assert len(got["best"]) == 2
    assert got["metrics"] == want["metrics"]
    assert got["checkpoint"] == want["checkpoint"]
    assert got["best"] == want["best"]


# ------------------------------------------------------- two workers
def _sync_loop(config):
    import numpy as np
    import torch

    from ray_tpu_torch.air import session
    from ray_tpu_torch.train import sync_gradients
    from ray_tpu_torch.util import collective as col
    rank, world = session.get_world_rank(), session.get_world_size()
    group = os.environ["RAY_TPU_TORCH_TRAIN_COLLECTIVE_GROUP"]
    params, steps = torch.zeros(1000), []
    for step in range(3):
        rng = np.random.default_rng(100 * step + rank)
        grads = {"w": torch.from_numpy(
                     rng.standard_normal(1000).astype(np.float32)),
                 "rest": [torch.from_numpy(rng.standard_normal(
                              (3, 5)).astype(np.float32)).to(torch.bfloat16),
                          np.full(4, rank + 1, np.int64)]}
        synced = sync_gradients(grads, async_op=step % 2 == 1)
        if step % 2 == 1:
            synced = synced.wait(timeout=60)
        params -= 0.1 * synced["w"]
        gathered = col.allgather(params.numpy(), group)
        steps.append({
            "w": synced["w"].numpy().tolist(),
            "bf16": synced["rest"][0].float().numpy().tolist(),
            "bf16_dtype": str(synced["rest"][0].dtype),
            "ints": synced["rest"][1].tolist(),
            "params_equal": all(np.array_equal(g, gathered[0])
                                for g in gathered),
            "world": world})
        session.report({"steps": list(steps)})


def test_sync_gradients_two_workers_equal_the_numpy_mean(cluster):
    result = JaxTrainer(_sync_loop,
                        scaling_config=ScalingConfig(num_workers=2),
                        run_config=RunConfig(storage_path=cluster,
                                             name="sync")).fit()
    assert result.error is None, result.error
    assert len(result.metrics["steps"]) == 3
    for step, m in enumerate(result.metrics["steps"]):
        rngs = [np.random.default_rng(100 * step + r) for r in range(2)]
        w = [g.standard_normal(1000).astype(np.float32) for g in rngs]
        bf = [torch.from_numpy(g.standard_normal((3, 5)).astype(
            np.float32)).to(torch.bfloat16).float().numpy() for g in rngs]
        # fp32: the exact sum, then divided by the world size
        assert m["w"] == ((w[0] + w[1]) / np.float32(2)).tolist()
        want_bf = torch.from_numpy((bf[0] + bf[1]) / np.float32(2)).to(
            torch.bfloat16).float().numpy()
        assert m["bf16"] == want_bf.tolist()
        assert m["bf16_dtype"] == "torch.bfloat16"
        assert m["ints"] == [3] * 4           # summed, not averaged
        assert m["params_equal"] and m["world"] == 2


@ray_tpu_torch.remote
class _Rank:
    def __init__(self, world, rank, name):
        from ray_tpu_torch._private.config import CONFIG
        from ray_tpu_torch.util import collective as col
        # test_collective.py's small thresholds: modest tensors take the
        # segmented paths
        CONFIG.update({"collective_chunk_bytes": 64 * 1024,
                       "collective_small_max_bytes": 1024,
                       "collective_inflight_segments": 3})
        self.col, self.name, self.rank = col, name, rank
        col.init_collective_group(world, rank, group_name=name)

    def op(self, opname, nelems, reduce_op="sum", src=0):
        x = np.random.RandomState(1000 + self.rank).uniform(
            1.0, 2.0, nelems).astype("float32")
        if opname == "allreduce":
            return self.col.allreduce(torch.from_numpy(x), self.name,
                                      reduce_op)
        if opname == "allgather":
            return self.col.allgather(x, self.name)
        if opname == "broadcast":
            return self.col.broadcast(x, src, self.name)
        raise ValueError(opname)

    def destroy(self):
        self.col.destroy_collective_group(self.name)
        return True


def _inputs(world, nelems):
    return [np.random.RandomState(1000 + r).uniform(1.0, 2.0, nelems)
            .astype("float32") for r in range(world)]


def test_collective_numerics_world_two(cluster):
    """Every ReduceOp on the small (recursive-doubling) path, sum and
    max on the large one, broadcast and allgather, against numpy
    (tensors go in as torch tensors; results come back as numpy)."""
    ranks = [_Rank.remote(2, r, "numerics") for r in range(2)]
    get = lambda refs: ray_tpu_torch.get(refs, timeout=TIMEOUT)  # noqa: E731
    try:
        red = {"sum": np.add, "product": np.multiply, "min": np.minimum,
               "max": np.maximum}
        for op, ufunc in red.items():
            for n in ((7, 100001) if op in ("sum", "max") else (7,)):
                xs = _inputs(2, n)
                for out in get([r.op.remote("allreduce", n, op)
                                for r in ranks]):
                    np.testing.assert_allclose(out, ufunc(*xs), rtol=2e-5)
        xs = _inputs(2, 50001)
        for parts in get([r.op.remote("allgather", 50001) for r in ranks]):
            assert len(parts) == 2
            for part, x in zip(parts, xs):
                np.testing.assert_array_equal(part, x)
        xs = _inputs(2, 70001)
        for out in get([r.op.remote("broadcast", 70001, src=1)
                        for r in ranks]):
            np.testing.assert_array_equal(out, xs[1])
    finally:
        get([r.destroy.remote() for r in ranks])
        for r in ranks:
            ray_tpu_torch.kill(r)


def test_mesh_and_ici_paths_name_the_roadmap():
    from ray_tpu_torch.util import collective as col
    with pytest.raises(NotImplementedError, match="item 4, multi-device"):
        ScalingConfig(mesh_shape={"data": 2})
    assert ScalingConfig(mesh_shape={"data": 1}).mesh_axis_names == ("data",)
    with pytest.raises(ValueError, match="item 4, multi-device"):
        col.init_collective_group(2, 0, backend="nccl", group_name="x")


# ---------------------------------------------------------------- leases
def _lease_loop():
    import os

    import torch

    from ray_tpu_torch.air import session
    from ray_tpu_torch.train import get_device
    session.report({"cuda_visible_devices":
                    os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "device": str(get_device()),
                    "cuda_initialized": torch.cuda.is_initialized()})


def test_gpu_lease_sees_its_card_and_cpu_worker_sees_none(cluster):
    group = WorkerGroup(1, {"CPU": 1.0, "GPU": 1.0})
    try:
        assert group.execute("device_count") == [1]
    finally:
        group.shutdown()
    # on the CPU the card is faked: a GPU worker's loop refuses to run
    result = JaxTrainer(_lease_loop, scaling_config=ScalingConfig(
        use_gpu=True), run_config=RunConfig(storage_path=cluster,
                                            name="gpu")).fit()
    assert result.error is not None and "no CUDA device" in str(
        result.error)
    result = JaxTrainer(_lease_loop, scaling_config=ScalingConfig(),
                        run_config=RunConfig(storage_path=cluster,
                                             name="cpu")).fit()
    assert result.error is None, result.error
    assert result.metrics["cuda_visible_devices"] == ""
    assert result.metrics["device"] == "cpu"
    assert result.metrics["cuda_initialized"] is False
    assert ScalingConfig(use_gpu=True, devices_per_worker=0.5
                         ).worker_resources() == {"CPU": 1.0, "GPU": 0.5}
