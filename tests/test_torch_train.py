"""The port's training slice (ray_tpu_torch.ops.losses, train.step and the
GPT training forward) held against ray_tpu's on the same numpy inputs and
the same converted weights, on the CPU.

Tolerances: both sides run fp32 on the CPU, so the gaps are
summation-order rounding (~1e-6 relative).  Losses and gradients: rtol
1e-5.  After three AdamW updates the parameters: max abs difference
5e-5 and mean abs difference 5e-8 per tensor.  Adam divides each
gradient by its own root mean square, so an element whose gradient is
near zero turns a rounding difference into a step difference of up to a
few percent of lr (1e-3); measured 1.6e-5 on one element of 4096, and
means up to 1.1e-8.  A wrong optimizer moves every element: the
decoupled decay alone is lr * 0.1 * |p| ~ 1e-5 per element per update,
200x the mean bound.
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

from ray_tpu.models.configs import get_config as jax_config
from ray_tpu.models.gpt import GPT as JaxGPT
from ray_tpu.ops.losses import chunked_lm_loss as jax_chunked
from ray_tpu.ops.losses import softmax_cross_entropy as jax_ce
from ray_tpu.parallel import MeshConfig, build_mesh
from ray_tpu.train.step import OptimizerConfig as JaxOptimizerConfig
from ray_tpu.train.step import make_sharded_train
from ray_tpu_torch.models.configs import get_config
from ray_tpu_torch.models.convert import jax_leaves, params_from_jax
from ray_tpu_torch.models.gpt import GPT
from ray_tpu_torch.ops.losses import chunked_lm_loss, softmax_cross_entropy
from ray_tpu_torch.train.step import (OptimizerConfig, lm_loss_chunked_fn,
                                      lm_loss_fn, make_train, state_nbytes)

RTOL = 1e-5
PARAM_MAX = 5e-5
PARAM_MEAN = 5e-8


def _t(a):
    return torch.from_numpy(np.array(a))


def test_softmax_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.7).astype(np.float32)
    for m, z in ((None, 0.0), (mask, 1e-3)):
        lg = _t(logits).requires_grad_()
        loss, denom = softmax_cross_entropy(lg, _t(labels),
                                            None if m is None else _t(m), z)
        loss.backward()
        (want, wdenom), wgrad = jax.value_and_grad(
            lambda x: jax_ce(x, labels, m, z), has_aux=True)(logits)
        np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
        assert float(denom) == float(wdenom)
        np.testing.assert_allclose(lg.grad.numpy(), np.asarray(wgrad),
                                   rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("transpose,bf16", [(False, False), (True, False),
                                             (True, True)],
                         ids=["kernel", "tied", "tied_bf16"])
def test_chunked_lm_loss_matches_jax(transpose, bf16):
    """fp32: S = 50 is padded to the 16-token chunks; z-loss and a mask
    on.  bf16 (``tied_bf16``): hidden [2, 256, 128] in bf16 over a tied
    fp32 weight of a 4096-token vocab, z-loss 1e-4, chunks of 128.  JAX
    sums each chunk's logits into fp32 and casts the weight inside each
    chunk, so its fp32 weight gradient sums fp32 per-chunk terms: the
    loss within 1e-5 relative, the weight gradient within 1e-3 of the
    largest.  The hidden gradient is bf16 on both sides: within 1e-3 of
    the largest plus one bf16 rounding step (2^-7 relative) of each
    element, and at most 0.1% of its elements differ at all.  Logits
    rounded to bf16 miss all three gradient bounds."""
    rng = np.random.default_rng(1)
    if bf16:
        (b, s, d), v, z, chunk = (2, 256, 128), 4096, 1e-4, 128
    else:
        (b, s, d), v, z, chunk = (2, 50, 8), 40, 1e-3, 16
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    w = rng.standard_normal((v, d) if transpose else (d, v)).astype(
        np.float32)
    if bf16:
        w *= 0.05
        hidden = np.asarray(jnp.asarray(jnp.asarray(hidden, jnp.bfloat16),
                                        jnp.float32))
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)
    h = _t(hidden).to(torch.bfloat16 if bf16 else torch.float32)
    h.requires_grad_()
    wt = _t(w).requires_grad_()
    loss, denom = chunked_lm_loss(h, wt, _t(labels), _t(mask), z, chunk,
                                  transpose_weight=transpose)
    loss.backward()

    def f(hh, ww):
        return jax_chunked(hh, ww, labels, mask, z, chunk,
                           transpose_weight=transpose)
    (want, wdenom), (gh, gw) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(
            jnp.asarray(hidden, jnp.bfloat16 if bf16 else jnp.float32), w)
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    assert float(denom) == float(wdenom)
    gh, gw = (np.asarray(jnp.asarray(x, jnp.float32)) for x in (gh, gw))
    got_h = h.grad.float().numpy()
    if not bf16:
        np.testing.assert_allclose(got_h, gh, rtol=RTOL, atol=1e-7)
        np.testing.assert_allclose(wt.grad.numpy(), gw, rtol=RTOL,
                                   atol=1e-7)
        return
    assert h.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    np.testing.assert_allclose(wt.grad.numpy(), gw, rtol=0,
                               atol=1e-3 * np.abs(gw).max())
    np.testing.assert_allclose(got_h, gh, rtol=2.0 ** -7,
                               atol=1e-3 * np.abs(gh).max())
    assert (got_h != gh).mean() <= 1e-3


@pytest.mark.parametrize("warmup,decay", [(10, 30), (0, 5), (4, 3)])
def test_schedule_matches_optax(warmup, decay):
    cfg = OptimizerConfig(learning_rate=2e-3, warmup_steps=warmup,
                          decay_steps=decay)
    sched = cfg.schedule()
    want = optax.warmup_cosine_decay_schedule(
        0.0, 2e-3, warmup, max(decay, warmup + 1), 2e-4)
    for count in range(decay + 6):
        np.testing.assert_allclose(sched(count), float(want(count)),
                                   rtol=1e-6, atol=1e-12)
    assert sched(0) == 0.0 or warmup == 0


@pytest.mark.parametrize("mask", ["decay_all", "lm_rule"])
def test_adamw_mask_matches_optax_adamw(mask):
    """AdamW(mask=decay_all) is optax.chain(clip_by_global_norm,
    adamw(lr, weight_decay)) with no mask (every leaf decays, biases and
    norm scales too: the Decision Transformer's optimizer), and the
    default mask keeps the LM rule (only `.weight` and `embed` decay).
    Three updates of a bias, a norm scale and a kernel, from gradients
    large enough that the clip acts on the first; fp32, rtol 1e-6."""
    from ray_tpu_torch.train.step import AdamW, decay_all
    rng = np.random.default_rng(3)
    shapes = {"blk.weight": (5, 3), "blk.bias": (5,), "norm.scale": (3,),
              "embed": (7, 3)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    grads = [{n: (4 * rng.standard_normal(s)).astype(np.float32)
              for n, s in shapes.items()} for _ in range(3)]
    decayed = ({n: True for n in params} if mask == "decay_all" else
               {n: n == "embed" or n.endswith(".weight") for n in params})
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        1e-2, weight_decay=0.5,
        mask=None if mask == "decay_all" else decayed))
    want = {n: jnp.asarray(v) for n, v in params.items()}
    state = tx.init(want)
    for g in grads:
        upd, state = tx.update({n: jnp.asarray(v) for n, v in g.items()},
                               state, want)
        want = optax.apply_updates(want, upd)
    kw = {} if mask == "lm_rule" else {"mask": decay_all}
    port = AdamW(lambda count: 1e-2, b1=0.9, b2=0.999, weight_decay=0.5,
                 grad_clip=1.0, **kw)
    got = {n: _t(v) for n, v in params.items()}
    pstate = port.init(got)
    for g in grads:
        pstate = port.update(got, {n: _t(v) for n, v in g.items()}, pstate)
    for n in params:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=1e-6, atol=1e-7)
    # the two masks give different parameters: the bias and scale decay
    # only under decay_all
    assert port.mask(got) == decayed


def _batch(cfg, seed=0, b=4, s=32):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    mask = np.ones((b, s + 1), np.float32)
    mask[0, 20:] = 0
    return {"tokens": tokens, "mask": mask}


@pytest.mark.parametrize("case", ["adamw", "accum2", "mu_bf16"])
def test_three_train_steps_match_make_sharded_train(case):
    """make_train against make_sharded_train on a one-device mesh, from
    the same weights and batch.  The port runs attention_impl="flash"
    (the autograd function over the kernels' plain versions) and JAX its
    einsum path, the same function; a mask covers the batch contract.
    bf16 first moments differ only where the two round the same fp32
    value, so mu_bf16 keeps the fp32 tolerances."""
    opt = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=10)
    if case == "accum2":
        opt["accum_steps"] = 2
    if case == "mu_bf16":
        opt["mu_dtype"] = "bfloat16"
    _steps_match_make_sharded_train(dict(n_kv_heads=2, max_seq_len=64), opt)


@pytest.mark.parametrize("case", ["scan", "unrolled", "remat_tail",
                                  "accum2"])
def test_adafactor_steps_match_make_sharded_train(case):
    """optimizer="adafactor" as in the AdamW test, at d_model 128, d_ff
    256 and 4 heads of 32, so that embed, lm_head, wo and the MLP
    kernels are factored while wq [L, 128, 4, 32] and the norm scales are
    not; scanned, unrolled (every layer its own leaf), with the stack
    split for partial remat (two stacks, each with its own block RMS
    values), and under MultiSteps.  Same tolerances as AdamW: adafactor
    divides each gradient by a root mean square too, and its factored
    estimate averages over rows and columns, so it amplifies rounding
    no more than Adam does."""
    over = dict(n_kv_heads=2, max_seq_len=64, d_model=128, d_ff=256,
                n_heads=4)
    opt = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=10,
               optimizer="adafactor")
    if case == "unrolled":
        over["scan_layers"] = False
    if case == "remat_tail":
        over.update(remat=True, remat_layers=1)
    if case == "accum2":
        opt["accum_steps"] = 2
    _steps_match_make_sharded_train(over, opt)


def _steps_match_make_sharded_train(over, opt, preset="tiny"):
    """Three updates of make_train against make_sharded_train: losses,
    gradient norms and (with experts) MoE aux losses at each call within
    RTOL, the parameters after within PARAM_MAX / PARAM_MEAN, and moved
    by the steps."""
    jcfg = jax_config(preset, attention_impl="xla", **over)
    tcfg = get_config(preset, attention_impl="flash", **over)
    batch = _batch(tcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    init_fn, step_fn, _, _ = make_sharded_train(
        JaxGPT(jcfg, mesh=mesh), mesh, JaxOptimizerConfig(**opt),
        example_batch=jbatch)
    state = state0 = init_fn(jax.random.PRNGKey(0), jbatch)

    def tree_of(st):
        return jax.tree.map(np.asarray, nn.meta.unbox(st.params))

    model = GPT(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(tree_of(state), tcfg))
    tinit, tstep = make_train(model, OptimizerConfig(**opt))
    tstate = tinit()
    state0 = jax.tree.map(np.array, state0)   # the JAX step donates it
    for _ in range(3 * opt.get("accum_steps", 1)):
        state, m = step_fn(state, jbatch)
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(m["grad_norm"]), rtol=RTOL)
        assert float(tm["tokens"]) == float(m["tokens"])
        assert tm.keys() == m.keys()
        if "moe_aux_loss" in m:
            np.testing.assert_allclose(float(tm["moe_aux_loss"]),
                                       float(m["moe_aux_loss"]), rtol=RTOL)
    assert tstate.step == 3 * opt.get("accum_steps", 1)
    want = params_from_jax(tree_of(state), tcfg)
    moved = 0.0
    for name, p in model.state_dict().items():
        diff = np.abs(p.numpy() - want[name].numpy())
        assert diff.max() <= PARAM_MAX and diff.mean() <= PARAM_MEAN, \
            (name, diff.max(), diff.mean())
        moved = max(moved, float(np.abs(want[name].numpy() - np.asarray(
            params_from_jax(tree_of(state0), tcfg)[name])).max()))
    assert moved > 1e-4          # the steps did update the parameters


def _loss_and_grads(cfg, sd, batch, loss_fn=lm_loss_fn):
    model = GPT(cfg, device="cpu")
    model.load_state_dict(sd)
    loss, _ = loss_fn(model, batch, cfg.z_loss)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), dict(zip(params, grads))


@pytest.mark.parametrize("over", [
    dict(remat_policy="nothing"), dict(remat_policy="block_outs"),
    dict(remat_policy="dots"), dict(remat_policy="dots_all"),
    dict(remat_policy="dots", remat_layers=1),
    dict(remat_policy="dots", tie_embeddings=True)],
    ids=["nothing", "block_outs", "dots", "dots_all", "partial",
         "tied_chunked"])
def test_remat_changes_no_value(over):
    """Loss and gradients under each remat policy equal those without
    remat (the flash path, GQA); the tied case also runs the chunked
    head against the dense one."""
    base = dict(n_kv_heads=2, attention_impl="flash",
                tie_embeddings=over.pop("tie_embeddings", False))
    plain = get_config("tiny", remat=False, **base)
    torch.manual_seed(0)
    sd = GPT(plain, device="cpu").state_dict()
    for v in sd.values():
        v.normal_(0, 0.1)
    batch = _batch(plain, seed=1, b=2, s=24)
    want = _loss_and_grads(plain, sd, batch)
    got = _loss_and_grads(get_config("tiny", remat=True, **base, **over),
                          sd, batch,
                          lm_loss_chunked_fn if base["tie_embeddings"]
                          else lm_loss_fn)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
    for name, g in want[1].items():
        np.testing.assert_allclose(got[1][name].numpy(), g.numpy(),
                                   rtol=RTOL, atol=1e-7, err_msg=name)


def test_unknown_remat_policy_raises():
    cfg = get_config("tiny", remat=True, remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        lm_loss_fn(GPT(cfg, device="cpu"), _batch(cfg, b=1, s=8))


@pytest.mark.parametrize("optimizer,want", [("adafactor", 711_708_752),
                                             ("adamw", 8_580_720_648)])
def test_optimizer_state_size_matches_jax_at_gpt_large(optimizer, want):
    """The optimizer state of bench.py's memory-lean gpt-large run, from
    shapes alone (the port's parameters on the meta device, JAX's by
    eval_shape): JAX's bytes are pinned, and the port's must come within
    1 KB of them (optax keeps a few placeholder scalars the port does
    not).  A grouping that factored each port tensor on its own would
    factor wq, wk and wv ([1280, 1280] alone, [36, 1280, 20, 64] in the
    JAX tree) and miss by 708 MB."""
    over = dict(max_seq_len=1024, remat=True, remat_policy="nothing")
    jcfg = jax_config("gpt-large", **over)
    jparams = nn.meta.unbox(jax.eval_shape(
        lambda: JaxGPT(jcfg).init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"]))
    jstate = jax.eval_shape(
        JaxOptimizerConfig(optimizer=optimizer).make().init, jparams)
    assert sum(np.prod(a.shape) * a.dtype.itemsize
               for a in jax.tree.leaves(jstate)) == want
    cfg = get_config("gpt-large", **over)
    model = GPT(cfg, device="meta")
    state = OptimizerConfig(optimizer=optimizer).make(jax_leaves(cfg)).init(
        dict(model.named_parameters()))
    assert abs(state_nbytes(state) - want) <= 1024
