"""The port's AIR glue (ray_tpu_torch.air: config, session, result and the
torch forms of Checkpoint) held against ray_tpu.air on the CPU, with no
cluster; and the port's lock sanitizer under a garbage collection that
runs a finalizer inside its own bookkeeping.

Tolerance: the tiny GPT's fp32 logits from a JAX-written checkpoint,
atol 1e-5 (both sides run fp32 on the CPU over the same numbers; a
layout error moves logits by O(0.1)).
"""

import dataclasses
import gc
import pickle
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu import air as jax_air
from ray_tpu.air import session as jax_session
from ray_tpu.models.configs import get_config as jax_config
from ray_tpu.models.gpt import GPT as JaxGPT
from ray_tpu_torch import air
from ray_tpu_torch._private.analysis import lock_sanitizer as ls
from ray_tpu_torch.air import session
from ray_tpu_torch.air.checkpoint import Checkpoint, _checkpoint_from_path
from ray_tpu_torch.models.configs import get_config
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.gpt import GPT
from test_torch_serve import _jax_tiny_params

CONFIGS = ("ScalingConfig", "FailureConfig", "CheckpointConfig",
           "RunConfig")
# the one mapped field: ray_tpu leases TPUs, the port GPUs
MAPPED = {"use_tpu": "use_gpu"}


def _fields(cls, rename=None):
    rename = rename or {}
    return [(rename.get(f.name, f.name),
             f.default if f.default is not dataclasses.MISSING else
             f.default_factory)
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", CONFIGS)
def test_config_fields_match_ray_tpu(name):
    assert _fields(getattr(air, name)) == _fields(getattr(jax_air, name),
                                                  MAPPED)
    assert set(air.__all__) == set(jax_air.__all__)


def test_config_behaviour_matches_ray_tpu():
    for kw in ({}, {"num_workers": 3, "resources_per_worker": {"CPU": 2}},
               {"use": True, "devices_per_worker": 4},
               {"use": True}, {"mesh_shape": {"data": 1}}):
        kw = dict(kw)
        use = kw.pop("use", False)
        ours = air.ScalingConfig(use_gpu=use, **kw)
        theirs = jax_air.ScalingConfig(use_tpu=use, **kw)
        want = {("GPU" if k == "TPU" else k): v
                for k, v in theirs.worker_resources().items()}
        assert ours.worker_resources() == want
        assert [{("GPU" if k == "TPU" else k): v for k, v in b.items()}
                for b in theirs.as_placement_group_bundles()] \
            == ours.as_placement_group_bundles()
        assert ours.mesh_axis_names == theirs.mesh_axis_names
    # a fraction of a card, as half-card replicas lease
    assert air.ScalingConfig(use_gpu=True, devices_per_worker=0.5
                             ).worker_resources()["GPU"] == 0.5
    with pytest.raises(NotImplementedError, match="multi-device"):
        air.ScalingConfig(mesh_shape={"data": 2, "fsdp": 4})
    for mod in (air, jax_air):
        with pytest.raises(ValueError, match="'max' or 'min'"):
            mod.CheckpointConfig(checkpoint_score_order="best")
    ours, theirs = air.RunConfig(), jax_air.RunConfig()
    assert ours.failure_config == air.FailureConfig()
    assert ours.checkpoint_config == air.CheckpointConfig()
    assert dataclasses.asdict(ours.failure_config) == dataclasses.asdict(
        theirs.failure_config)
    assert ours.storage_path.endswith("ray_tpu_torch_results")


def _drive(mod):
    """One session as a trainer worker drives it: a loop thread reports
    three results (one with a checkpoint), the driver consumes them;
    then a stop request refuses the next report."""
    s = mod.init_session(world_rank=1, world_size=2, local_rank=1,
                         local_world_size=2, node_rank=0,
                         trial_name="t", trial_id="id7", trial_dir="/d",
                         experiment_name="exp")
    seen = {}
    try:
        def loop():
            seen["ids"] = (mod.get_world_rank(), mod.get_world_size(),
                           mod.get_local_rank(), mod.get_local_world_size(),
                           mod.get_node_rank(), mod.get_trial_name(),
                           mod.get_trial_id(), mod.get_trial_dir(),
                           mod.get_experiment_name(),
                           mod.get_checkpoint(), mod.get_dataset_shard())
            mod.report({"loss": 1.0})
            mod.report({"loss": 0.5, "training_iteration": 9})
            mod.report({"loss": 0.25}, checkpoint="ckpt")
        t = threading.Thread(target=loop)
        t.start()
        seen["items"] = [s.next_result(timeout=10) for _ in range(3)]
        t.join(10)
        seen["empty"] = s.next_result(timeout=0.01)
        s.stop_requested.set()
        try:
            mod.report({"loss": 0.0})
        except StopIteration:
            seen["stopped"] = True
    finally:
        mod.shutdown_session()
    with pytest.raises(RuntimeError, match="no training session"):
        mod.get_world_rank()
    return seen


def test_session_matches_ray_tpu():
    assert _drive(session) == _drive(jax_session)
    assert _drive(session)["items"][1][0]["training_iteration"] == 9


def test_result_matches_ray_tpu():
    assert [f.name for f in dataclasses.fields(air.Result)] == [
        f.name for f in dataclasses.fields(jax_air.Result)]
    r = air.Result(metrics={"config": {"lr": 1}})
    assert r.config == {"lr": 1} and r.error is None
    assert air.Result(metrics={}).config is None


def test_torch_checkpoint_round_trip(tmp_path):
    state = {"params": {"w": torch.randn(3, 4),
                        "b": torch.arange(5).to(torch.bfloat16)},
             "opt": [torch.zeros(2, dtype=torch.int64), (1.5, "x")],
             "step": 7}
    ckpt = Checkpoint.from_torch(state, metrics={"loss": 0.5},
                                 path=str(tmp_path / "c"))
    assert ckpt.has_torch_state() and ckpt.metrics() == {"loss": 0.5}

    def same(a, b):
        if torch.is_tensor(a):
            return a.dtype == b.dtype and torch.equal(a, b)
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return type(a) is type(b) and all(map(same, a, b))
        return a == b

    assert same(ckpt.to_torch(), state)
    # the bytes form carries the directory (a tar) to another host
    moved = Checkpoint.from_bytes(ckpt.to_bytes())
    assert same(moved.to_torch(), state) and moved.metrics() == {
        "loss": 0.5}
    # within one host a directory checkpoint travels as its path
    back = pickle.loads(pickle.dumps(ckpt))
    assert back._path == ckpt._path and same(back.to_torch(), state)
    with pytest.raises(ValueError, match="lives on host"):
        _checkpoint_from_path(ckpt._path, "another-host")
    assert not Checkpoint.from_dict({"a": 1}).has_torch_state()


def test_llmserver_reads_a_torch_checkpoint(tmp_path):
    """What a trainer reports (``from_torch({"params": state_dict})``)
    is what ``LLMServer`` loads."""
    from ray_tpu_torch.serve.llm import LLMServer
    cfg = get_config("tiny")
    gen = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(v.shape, generator=gen)
          for k, v in GPT(cfg, device="cpu").state_dict().items()}
    path = Checkpoint.from_torch({"params": sd}, path=str(tmp_path)
                                 )._path
    got = LLMServer._load_params(cfg, path, 0, "cpu")
    assert got.keys() == sd.keys()
    assert all(torch.equal(got[k], sd[k]) for k in sd)


def test_jax_checkpoint_reads_through_to_jax_and_params_from_jax():
    """The port cannot open what ``from_jax`` wrote (orbax's tensorstore,
    or a pickled jax treedef), so the way across is ray_tpu's ``to_jax``,
    numpy, then ``params_from_jax``: the tiny GPT's logits agree."""
    tree = _jax_tiny_params()
    restored = jax_air.Checkpoint.from_jax({"params": tree}).to_jax()
    restored = {k: np.asarray(v) if hasattr(v, "shape") else v
                for k, v in _leaves(restored["params"])}
    jcfg, tcfg = jax_config("tiny"), get_config("tiny")
    model = GPT(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(_unflatten(restored), tcfg))
    toks = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 16)).astype(np.int32)
    want = jax.jit(JaxGPT(jcfg).apply)({"params": tree}, jnp.asarray(toks))
    with torch.no_grad():
        got = model(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unflatten(flat):
    out: dict = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


# ------------------------------------------------------ lock sanitizer
class _Finalized:
    """Found only by the cycle collector; its finalizer takes an
    instrumented lock, as ``ObjectRef.__del__`` does."""

    def __init__(self, lock, ran):
        self.lock, self.ran, self.me = lock, ran, self

    def __del__(self):
        with self.lock:
            self.ran.append(True)


class _CollectingDict(dict):
    """A held-stack table whose first lookup runs a collection: what an
    allocation inside the sanitizer's guarded section may set off."""

    def get(self, *args):
        if not getattr(self, "done", False):
            self.done = True
            gc.collect()
        return super().get(*args)


def test_lock_sanitizer_survives_a_finalizer_inside_its_guard(
        monkeypatch):
    """A collection inside ``_held_snapshot``'s guarded section runs a
    finalizer that takes an instrumented lock on the same thread.  With
    a plain guard that thread waits on itself forever; the thread must
    finish, and the finalizer's lock must leave no held entry."""
    ls.reset()
    ran = []
    outer = ls._DebugLock("siteOuter.py:1")
    inner = ls._DebugLock("siteInner.py:2")
    gc.disable()
    try:
        _Finalized(inner, ran)           # garbage, in a cycle
        monkeypatch.setattr(ls, "_held_by_tid", _CollectingDict())
        t = threading.Thread(target=lambda: outer.acquire() and
                             outer.release(), daemon=True)
        t.start()
        t.join(20)
        assert not t.is_alive(), "the sanitizer deadlocked on itself"
    finally:
        gc.enable()
    assert ran == [True]
    assert not ls._held_snapshot(t.ident)
    assert not ls._is_busy()
    ls.reset()
