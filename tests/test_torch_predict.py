"""The port's predictors (``ray_tpu_torch.train.predictor``) against
ray_tpu's.

A tiny ViT (``vit-tiny-test``) is initialised in JAX and loaded into the
port's with ``params_from_jax``; ray_tpu's ``JaxPredictor.predict`` in
this process and the port's ``BatchPredictor`` over its runtime
(``device="cpu"``, an actor pool of one) give the same logits within
``tests/test_torch_vision.py``'s fp32 atol of 1e-4 (measured ~1e-6).
``predict_pipelined`` (windowed scoring tasks) gives the same logits.
The port's predictor refuses to score without a card unless asked for
the CPU, and ``num_gpus_per_worker`` leases each scoring actor or task
its share of a card (faked here: the raylet counts one GPU).
"""

import functools
import os
import sys

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import cloudpickle as port_cloudpickle

ATOL = 1e-4          # test_torch_vision.py's logits tolerance


@pytest.fixture(scope="module")
def cluster():
    port_cloudpickle.register_pickle_by_value(sys.modules[__name__])
    saved = os.environ.get("RAY_TPU_TORCH_GPUS_PER_HOST")
    os.environ["RAY_TPU_TORCH_GPUS_PER_HOST"] = "1"   # one faked card
    try:
        ray_tpu_torch.init(num_cpus=4, object_store_memory=128 << 20)
    finally:
        if saved is None:
            del os.environ["RAY_TPU_TORCH_GPUS_PER_HOST"]
        else:
            os.environ["RAY_TPU_TORCH_GPUS_PER_HOST"] = saved
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()
        port_cloudpickle.unregister_pickle_by_value(sys.modules[__name__])


@functools.lru_cache(maxsize=None)
def _jax_vit():
    """(params as numpy, images, ray_tpu's JaxPredictor logits)."""
    import flax.linen as nn
    import jax

    from ray_tpu.models.vit import ViT as JaxViT
    from ray_tpu.models.vit import get_vit_config as jax_vit_config
    from ray_tpu.train.predictor import JaxPredictor as JaxJaxPredictor
    model = JaxViT(jax_vit_config("vit-tiny-test"))
    images = np.random.default_rng(0).standard_normal(
        (24, 32, 32, 3)).astype(np.float32)
    params = jax.tree.map(np.asarray, nn.meta.unbox(jax.jit(model.init)(
        jax.random.PRNGKey(0), images[:1])["params"]))
    want = JaxJaxPredictor(model, params).predict(
        {"features": images})["predictions"]
    return params, images, want


def _checkpoint(path):
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.models.vit import ViT, get_vit_config
    from ray_tpu_torch.train import predictor_checkpoint
    params, _, _ = _jax_vit()
    cfg = get_vit_config("vit-tiny-test")
    model = ViT(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, model))
    return predictor_checkpoint(functools.partial(ViT, cfg),
                                model.state_dict(), path=str(path))


class _LeaseProbe:
    """A predictor that reports what its scoring actor's lease shows."""

    @classmethod
    def from_checkpoint(cls, checkpoint, **kwargs):
        return cls()

    def predict(self, batch):
        n = len(batch["data"])
        return {"visible": np.array(
            [os.environ.get("CUDA_VISIBLE_DEVICES", "unset")] * n)}


@pytest.mark.parametrize("gpus,method", [(0.0, "predict"),
                                         (0.5, "predict"),
                                         (0.5, "predict_pipelined")])
def test_scoring_actors_lease_num_gpus_per_worker(cluster, tmp_path, gpus,
                                                  method):
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.air import Checkpoint
    from ray_tpu_torch.train import BatchPredictor
    ds = rd.from_numpy([np.zeros((2, 1)), np.ones((2, 1))])
    bp = BatchPredictor.from_checkpoint(Checkpoint.from_dict({}),
                                        _LeaseProbe)
    if method == "predict":
        got = bp.predict(ds, batch_size=2, min_scoring_workers=2,
                         max_scoring_workers=2, num_gpus_per_worker=gpus)
    else:
        got = rd.from_items(list(bp.predict_pipelined(
            ds, blocks_per_window=1, num_gpus_per_worker=gpus).iter_rows()))
    got = got.to_numpy()["visible"]
    # without a GPU lease a worker sees no card; with one, the raylet's
    # card (two half-card scorers share card 0)
    assert set(got.tolist()) == ({""} if gpus == 0 else {"0"})


def test_jax_predictor_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    import torch

    from ray_tpu_torch.train import JaxPredictor
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        JaxPredictor.from_checkpoint(_checkpoint(tmp_path / "vit"))


def test_batch_predictor_matches_ray_tpu_jax_predictor(cluster, tmp_path):
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.train import BatchPredictor, JaxPredictor
    _, images, want = _jax_vit()
    ckpt = _checkpoint(tmp_path / "vit")
    ds = rd.from_numpy(np.split(images, 3))
    got = BatchPredictor.from_checkpoint(
        ckpt, JaxPredictor, input_column="data", device="cpu").predict(
        ds, batch_size=8, min_scoring_workers=1,
        max_scoring_workers=1).to_numpy()
    assert got["predictions"].shape == want.shape
    np.testing.assert_allclose(got["predictions"], want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got["data"], images)
    # and in this process, from the same checkpoint
    local = JaxPredictor.from_checkpoint(ckpt, device="cpu").predict(
        {"features": images})
    np.testing.assert_allclose(local["predictions"], want, atol=ATOL,
                               rtol=0)
    # and windowed, two blocks a window, in scoring tasks
    rows = list(BatchPredictor.from_checkpoint(
        ckpt, JaxPredictor, input_column="data", device="cpu")
        .predict_pipelined(ds, blocks_per_window=2).iter_rows())
    np.testing.assert_allclose(np.stack([r["predictions"] for r in rows]),
                               want, atol=ATOL, rtol=0)
