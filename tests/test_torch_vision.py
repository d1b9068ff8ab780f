"""The port's vision family (ray_tpu_torch.models: ViT and ResNet, and
train.step's classification_loss_fn and make_vision_train) held against
ray_tpu's on the same seeded numpy inputs and converted weights, on the
CPU: vit-tiny-test, and ResNets of num_filters 8 on 32 px images, with
and without the small-input stem (so the stride-2 "SAME" padding of the
7x7 stem, of the 3x3 convolutions and of the max pool are all met).

Tolerances: fp32 on both sides, so the gaps are summation-order rounding
(~1e-6): logits within atol 1e-4 (a layout or padding error moves them
by O(0.1)); BatchNorm statistics within rtol 1e-4 / atol 1e-6, and the
batch mean and variance each folded in, (new - 0.9 old) / 0.1, within
rtol 5e-5 / atol 1e-5 (fp32 rounding of that difference is ~1e-6; an
unbiased batch variance is off by 1/(n-1), 2.4e-4 at the largest n
here, 4 x 32 x 32); losses within rtol 1e-5 and gradients within
rtol 1e-4 / atol 1e-6.  Three training steps: losses, accuracies and
gradient norms within rtol 1e-5, the parameters after within max 2e-4
per element (tests/test_torch_encoder.py says why) and mean 5e-8 over
all of them (a BatchNorm bias has 8 elements, so one element's rounding
noise, 1e-6, sets a per-tensor mean), and the BatchNorm statistics
within rtol 1e-4 / atol 2e-5: they are batch means of parameters that
differ by up to that max (measured 2.0e-6 off; the unbiased variance
would be 5e-4 off at the stem's 2,048 values per channel).
"""

import functools

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

from ray_tpu.models import resnet as jax_resnet
from ray_tpu.models.vit import ViT as JaxViT
from ray_tpu.models.vit import get_vit_config as jax_vit_config
from ray_tpu.parallel import MeshConfig, build_mesh
from ray_tpu.train.step import OptimizerConfig as JaxOptimizerConfig
from ray_tpu.train.step import _decay_mask as jax_decay_mask
from ray_tpu.train.step import classification_loss_fn as jax_cls_loss
from ray_tpu.train.step import make_vision_train as jax_make_vision_train
from ray_tpu_torch.models import resnet
from ray_tpu_torch.models.convert import (batch_stats_from_jax,
                                          init_weights, model_leaves,
                                          params_from_jax)
from ray_tpu_torch.models.vit import ViT, get_vit_config
from ray_tpu_torch.train.step import (OptimizerConfig, _decay_mask,
                                      classification_loss_fn,
                                      make_vision_train)
from test_torch_encoder import _jax_state, _unrolled

ATOL = 1e-4
STAT_RTOL, STAT_ATOL = 1e-4, 1e-6
STEP_STAT_ATOL = 2e-5
BATCH_RTOL, BATCH_ATOL = 5e-5, 1e-5
RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PARAM_MAX = 2e-4
PARAM_MEAN = 5e-8
BLOCKS = {"basic": "BasicBlock", "bottleneck": "BottleneckBlock"}
RESNETS = pytest.mark.parametrize("block,small", [
    ("basic", True), ("basic", False), ("bottleneck", True),
    ("bottleneck", False)], ids=["basic-cifar", "basic-stem",
                                 "bottleneck-cifar", "bottleneck-stem"])
OPT = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=10)


def _np(tree):
    return jax.tree.map(np.asarray, nn.meta.unbox(tree))


def _images(seed, b=4, px=32):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((b, px, px, 3)).astype(np.float32),
            "label": rng.integers(0, 10, b).astype(np.int32)}


def _resnets(block, small, train=True):
    """(JAX ResNet, port ResNet): stages [1, 1] of ``block`` from 8
    filters, 10 classes, fp32 compute."""
    kw = dict(num_classes=10, num_filters=8, small_inputs=small)
    jmodel = jax_resnet.ResNet(
        stage_sizes=[1, 1], block_cls=getattr(jax_resnet, BLOCKS[block]),
        dtype=jnp.float32, train=train, **kw)
    model = resnet.ResNet([1, 1], getattr(resnet, BLOCKS[block]),
                          dtype=torch.float32, device="cpu", **kw)
    return jmodel, model


@functools.lru_cache(maxsize=None)
def _resnet_vars(block, small):
    """The JAX ResNet's variables, drawn with the "rbg" generator: at
    these sizes the compile of threefry's many draws takes most of an
    init (about 4 s against 1.3 s on the CPU)."""
    jmodel, _ = _resnets(block, small)
    return jax.jit(jmodel.init)(jax.random.key(0, impl="rbg"),
                                _images(0)["image"])


def _load_resnet(model, variables):
    model.load_state_dict({
        **params_from_jax(_np(variables["params"]), model),
        **batch_stats_from_jax(_np(variables["batch_stats"]), model)})
    return model


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or dict(atol=ATOL, rtol=0)))


def _stats_close(model, stats, atol=STAT_ATOL):
    want = batch_stats_from_jax(_np(stats), model)
    bufs = dict(model.named_buffers())
    assert set(want) == set(bufs)
    for name, w in want.items():
        _close(bufs[name], w, rtol=STAT_RTOL, atol=atol)


@functools.lru_cache(maxsize=None)
def _vit_vars():
    return jax.jit(JaxViT(jax_vit_config("vit-tiny-test")).init)(
        jax.random.PRNGKey(0), _images(1)["image"])


@functools.lru_cache(maxsize=None)
def _vit_ref(scan):
    """The JAX ViT's tree and its logits on seeded images; the unrolled
    model takes the scanned one's weights, restacked."""
    tree = _np(_vit_vars()["params"])
    if not scan:
        tree = _unrolled(tree)
    images = _images(1)["image"]
    jmodel = JaxViT(jax_vit_config("vit-tiny-test", scan_layers=scan))
    return tree, images, jax.jit(jmodel.apply)({"params": tree}, images)


@pytest.mark.parametrize("scan", [True, False], ids=["scan", "unrolled"])
@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_vit_forward_matches_jax(scan, impl):
    """vit-tiny-test (64 wide, 16 patches of 8 x 8 x 3) in scanned and
    unrolled trees, through dense_attention ("auto") and the flash
    kernels' plain versions; NHWC images."""
    tree, images, want = _vit_ref(scan)
    model = ViT(get_vit_config("vit-tiny-test", scan_layers=scan,
                               attention_impl=impl), device="cpu")
    model.load_state_dict(params_from_jax(tree, model))
    _close(model(torch.from_numpy(images)), want)


@RESNETS
def test_resnet_train_and_eval_match_flax(block, small):
    """Training mode: the logits and the batch statistics flax's mutated
    ``batch_stats`` holds; then, with the 7x7 stem and the max pool, eval
    mode (flax ``train=False``) on the updated statistics."""
    jmodel, model = _resnets(block, small)
    variables = _resnet_vars(block, small)
    _load_resnet(model, variables)
    images = _images(2)["image"]
    want, mutated = jax.jit(functools.partial(
        jmodel.apply, mutable=["batch_stats"]))(variables, images)
    _close(model(torch.from_numpy(images)), want)
    _stats_close(model, mutated["batch_stats"])
    # the batch statistics each BatchNorm folded in, (new - 0.9 old) / 0.1
    old = batch_stats_from_jax(_np(variables["batch_stats"]), model)
    new = batch_stats_from_jax(_np(mutated["batch_stats"]), model)
    bufs = dict(model.named_buffers())
    for name in new:
        _close((bufs[name] - 0.9 * old[name]) / 0.1,
               (new[name] - 0.9 * old[name]) / 0.1, rtol=BATCH_RTOL,
               atol=BATCH_ATOL)
    if small:      # eval mode is one code path; the stem variants run it
        return
    jeval, _ = _resnets(block, small, train=False)
    want = jax.jit(jeval.apply)({"params": variables["params"],
                                 **mutated}, images)
    model.eval()
    with torch.no_grad():
        _close(model(torch.from_numpy(images)), want)
    _stats_close(model, mutated["batch_stats"])      # eval leaves them


def test_classification_loss_fn_values_and_grads_match_jax():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((16, 10)) * 3).astype(np.float32)
    labels = rng.integers(0, 10, 16).astype(np.int32)
    lg = torch.from_numpy(logits).requires_grad_()
    loss, metrics = classification_loss_fn(lg, torch.from_numpy(labels))
    loss.backward()
    (want, wmetrics), wgrad = jax.value_and_grad(
        lambda x: jax_cls_loss(x, labels), has_aux=True)(logits)
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    assert metrics.keys() == wmetrics.keys()
    assert float(metrics["accuracy"]) == float(wmetrics["accuracy"])
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(wgrad),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _three_steps(jmodel, model, batch, variables, load, opt=OPT):
    """Three updates of make_vision_train against the reference's on a
    one-device mesh from the same weights (and statistics),
    ``variables``: metrics at each step within RTOL, the parameters after
    within PARAM_MAX / PARAM_MEAN and moved, the statistics as the
    reference's."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    init_fn, step_fn, shardings, _ = jax_make_vision_train(
        jmodel, mesh, JaxOptimizerConfig(**opt), example_batch=jbatch)
    state = _jax_state(init_fn, shardings, jbatch, variables)
    start = params_from_jax(_np(state.params), model)
    load(model, state)
    tinit, tstep = make_vision_train(model, OptimizerConfig(**opt))
    tstate = tinit()
    for _ in range(3):
        state, m = step_fn(state, jbatch)
        tstate, tm = tstep(tstate, batch)
        assert tm.keys() == m.keys()
        for k in m:
            np.testing.assert_allclose(float(tm[k]), float(m[k]), rtol=RTOL,
                                       err_msg=k)
    want = params_from_jax(_np(state.params), model)
    diffs, moved = [], 0.0
    for name, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        assert diff.max() <= PARAM_MAX, (name, diff.max())
        diffs.append(diff.ravel())
        moved = max(moved, float(np.abs(want[name].numpy()
                                        - start[name].numpy()).max()))
    mean = np.concatenate(diffs).mean()
    assert mean <= PARAM_MEAN, mean
    assert moved > 1e-4
    if state.batch_stats:
        _stats_close(model, state.batch_stats, atol=STEP_STAT_ATOL)
        assert set(tstate.batch_stats) == set(batch_stats_from_jax(
            _np(state.batch_stats), model))


def test_vit_three_steps_match_make_vision_train():
    jcfg = jax_vit_config("vit-tiny-test")
    _three_steps(JaxViT(jcfg),
                 ViT(get_vit_config("vit-tiny-test", attention_impl="flash"),
                     device="cpu"), _images(4, b=8), _vit_vars(),
                 lambda m, st: m.load_state_dict(params_from_jax(
                     _np(st.params), m)))


def test_resnet_three_steps_match_make_vision_train():
    """A bottleneck ResNet with the 7x7 stem and the max pool, its
    statistics updated by each step, under Adafactor (its statistics per
    JAX leaf, convolution kernels in HWIO; the ViT's steps run AdamW)."""
    jmodel, model = _resnets("bottleneck", False)
    _three_steps(jmodel, model, _images(5, b=8),
                 _resnet_vars("bottleneck", False),
                 lambda m, st: _load_resnet(m, {
                     "params": st.params, "batch_stats": st.batch_stats}),
                 dict(OPT, optimizer="adafactor"))


@pytest.mark.parametrize("family", ["vit", "resnet"])
def test_decay_mask_matches_jax(family):
    """The port's decay mask over each parameter equals the reference's
    over its JAX leaf: convolution and dense kernels decay; BatchNorm
    scales and biases, the head's bias and pos_embed do not."""
    if family == "vit":
        jmodel = JaxViT(jax_vit_config("vit-tiny-test"))
        model = ViT(get_vit_config("vit-tiny-test"), device="cpu")
    else:
        jmodel, model = _resnets("bottleneck", False)
    params = nn.meta.unbox(jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))["params"])
    want = jax_decay_mask(params)
    got = _decay_mask(dict(model.named_parameters()))
    seen = set()
    for leaf in model_leaves(model):
        decayed = want
        for key in leaf.path:
            decayed = decayed[key]
        for name in leaf.names:
            assert got[name] == decayed, name
            seen.add(name)
    assert seen == set(got)
    off = (["pos_embed"] if family == "vit" else
           ["head.bias", "bn_init.scale", "blocks.0.norm2.bias"])
    assert not any(got[n] for n in off) and got["head.weight"]


def test_resnet_init_weights_follow_flax():
    """init_weights on a ResNet-50 of 8 filters draws each convolution
    kernel and the head with flax's lecun-normal over the JAX kernel's
    fan-in (HWIO: kh * kw * in; the std of every kernel of over 2,000
    elements within 7% of sqrt(1 / fan_in), 3 sigma of a sample std),
    and on the stem ResNet of the other tests gives every scale, bias
    and statistic flax's init value: ones, zeros for the last BatchNorm
    scale of each block and every bias, mean 0 and var 1."""
    jshapes = nn.meta.unbox(jax.eval_shape(lambda: jax_resnet.ResNet50(
        num_classes=10, num_filters=8, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))["params"])
    model = resnet.ResNet50(num_classes=10, num_filters=8,
                            dtype=torch.float32, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    checked = 0
    for leaf in model_leaves(model):
        if leaf.path[-1] != "kernel" or np.prod(leaf.shape) <= 2000:
            continue
        shape = functools.reduce(lambda t, k: t[k], leaf.path, jshapes).shape
        assert tuple(shape) == leaf.shape
        fan_in = np.prod(shape[:-1])
        np.testing.assert_allclose(float(params[leaf.names[0]].detach().std()),
                                   fan_in ** -0.5, rtol=0.07,
                                   err_msg=leaf.names[0])
        checked += 1
    assert checked >= 20

    jmodel, model = _resnets("bottleneck", False)
    for buf in model.buffers():
        buf.fill_(3.0)
    init_weights(model, torch.Generator().manual_seed(0))
    variables = _resnet_vars("bottleneck", False)
    want = {**params_from_jax(_np(variables["params"]), model),
            **batch_stats_from_jax(_np(variables["batch_stats"]), model)}
    got = model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        if not name.endswith(".weight"):
            assert torch.equal(got[name], w), name
    assert not got["blocks.0.norm2.scale"].any()


@pytest.mark.parametrize("size,kernel,stride", [
    (224, 7, 2), (56, 3, 2), (112, 3, 2), (32, 3, 2), (32, 3, 1),
    (7, 1, 2), (13, 3, 2)])
def test_same_padding_matches_lax(size, kernel, stride):
    want = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert resnet.same_padding(size, kernel, stride) == tuple(want[0])


def test_vit_optax_one_hot_loss_is_ours():
    """classification_loss_fn is the reference's mean of optax's softmax
    cross-entropy over one-hot labels, on logits where a log-sum-exp
    without the max shift would overflow."""
    logits = np.array([[1000.0, 0.0, -5.0], [3.0, 2.0, 1.0]], np.float32)
    labels = np.array([1, 0])
    want = optax.softmax_cross_entropy(logits, jax.nn.one_hot(labels, 3))
    loss, _ = classification_loss_fn(torch.from_numpy(logits),
                                     torch.from_numpy(labels))
    np.testing.assert_allclose(loss.item(), float(want.mean()), rtol=RTOL)
