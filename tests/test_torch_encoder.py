"""The port's encoder family (ray_tpu_torch.models: Encoder, BERT, T5, the
MLM and seq2seq losses, masked_batch, greedy_decode) held against
ray_tpu's on the same seeded numpy inputs and converted weights, on the
CPU, at get_config("tiny", max_seq_len=32) with 2 kv heads of 4.

The port runs attention_impl "auto" (dense_attention on the CPU) and
"flash" (the kernels' plain versions); JAX its einsum path.  Tolerances:
fp32 on both sides, so the gaps are summation-order rounding (~1e-6):
logits and encoder outputs within atol 1e-4 (as test_torch_gpt.py; a
layout error moves them by O(0.1)), losses within rtol 1e-5 and
gradients within rtol 1e-4 / atol 1e-6.  Three training steps: losses,
gradient norms and metrics within rtol 1e-5; the parameters after
within max 2e-4 and mean 5e-8 per tensor.  Adam divides each gradient by
its own root mean square, so an element whose gradient is rounding noise
(measured 9.9e-9 against a median of 2.4e-3, BERT's last wo) can take a
step of up to lr on one side and not the other: 8.4e-5 after the
5e-4 step (test_torch_train.py's 5e-5 was measured on the GPT); a wrong
optimizer or gradient moves every element, which the mean bound (200x
below the decoupled decay of one update) catches.  masked_batch and
greedy_decode are compared exactly.
"""

import functools

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from ray_tpu.models.bert import BERT as JaxBERT
from ray_tpu.models.bert import masked_batch as jax_masked_batch
from ray_tpu.models.bert import mlm_loss_fn as jax_mlm_loss_fn
from ray_tpu.models.configs import get_config as jax_config
from ray_tpu.models.encoder import Encoder as JaxEncoder
from ray_tpu.models.t5 import T5 as JaxT5
from ray_tpu.models.t5 import greedy_decode as jax_greedy_decode
from ray_tpu.models.t5 import seq2seq_loss_fn as jax_seq2seq_loss_fn
from ray_tpu.models.t5 import t5_init_inputs
from ray_tpu.parallel import MeshConfig, build_mesh
from ray_tpu.train.step import OptimizerConfig as JaxOptimizerConfig
from ray_tpu.train.step import _decay_mask as jax_decay_mask
from ray_tpu.train.step import make_sharded_train
from ray_tpu_torch.models.bert import (BERT, IGNORE, masked_batch,
                                       mlm_loss_fn)
from ray_tpu_torch.models.configs import get_config
from ray_tpu_torch.models.convert import model_leaves, params_from_jax
from ray_tpu_torch.models.encoder import Encoder
from ray_tpu_torch.models.t5 import T5, greedy_decode, seq2seq_loss_fn
from ray_tpu_torch.train.step import OptimizerConfig, _decay_mask, make_train

ATOL = 1e-4
RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PARAM_MAX = 2e-4
PARAM_MEAN = 5e-8
OVER = dict(max_seq_len=32, n_kv_heads=2)
IMPLS = ["auto", "flash"]


def _tree(variables):
    return jax.tree.map(np.asarray, nn.meta.unbox(variables["params"]))


def _port(cls, tree, cfg):
    model = cls(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, model))
    return model


def _tokens(seed, shape, low=1):
    return np.random.default_rng(seed).integers(low, 256, shape).astype(
        np.int32)


def _pad_mask(b, s, keep):
    mask = np.ones((b, s), np.int32)
    mask[0, keep:] = 0
    return mask


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _unrolled(tree):
    """The unrolled (``scan_layers=False``) tree of a scanned one: each
    ``blocks`` subtree, stacked along its first axis, becomes
    ``block_{i}``."""
    out = {}
    for key, value in tree.items():
        if key == "blocks":
            n = jax.tree.leaves(value)[0].shape[0]
            out.update({f"block_{i}": jax.tree.map(lambda a, i=i: a[i],
                                                   value)
                        for i in range(n)})
        else:
            out[key] = _unrolled(value) if isinstance(value, dict) else value
    return out


@functools.lru_cache(maxsize=None)
def _jax(family: str, scan: bool = True):
    """(JAX model, its variables from seed 0, jitted apply) for ``family``
    ("bert" or "t5"): one init per family for the whole file (the
    parameters do not depend on the inputs' lengths); the unrolled model
    takes the scanned one's weights, restacked."""
    jcfg = jax_config("tiny", scan_layers=scan, **OVER)
    toks = np.zeros((1, 8), np.int32)
    jmodel, args = {"bert": (JaxBERT(jcfg), (toks,)),
                    "t5": (JaxT5(jcfg), (toks, toks[:, :4]))}[family]
    variables = (jax.jit(jmodel.init)(jax.random.PRNGKey(0), *args) if scan
                 else {"params": _unrolled(_tree(_jax(family)[1]))})
    return (jmodel, variables,
            jax.jit(jmodel.apply, static_argnames=("return_memory",)))


def _jax_state(init_fn, shardings, batch, variables):
    """The train state ``init_fn`` would build, from ``variables`` (seed
    0's, as ``init_fn(PRNGKey(0), batch)`` draws them) instead of a
    second init: ``create`` with the init's own optimizer and apply
    function, jitted to the state's shardings as ``init_fn`` is."""
    abstract = jax.eval_shape(init_fn, jax.random.PRNGKey(0), batch)

    def build(params, stats):
        extra = ({"batch_stats": stats} if hasattr(abstract, "batch_stats")
                 else {})
        return type(abstract).create(apply_fn=abstract.apply_fn,
                                     tx=abstract.tx, params=params, **extra)

    return jax.jit(build, out_shardings=shardings)(
        variables["params"], variables.get("batch_stats", {}))


@pytest.fixture(scope="module", params=[True, False],
                ids=["scan", "unrolled"])
def scan(request):
    return request.param


@pytest.fixture(scope="module")
def encoder_ref():
    """The scanned encoder tree of the JAX BERT and the JAX Encoder's
    output on a seeded input under it (BERT and T5 cover the unrolled
    encoder tree)."""
    x = np.random.default_rng(0).standard_normal((2, 20, 64)).astype(
        np.float32)
    tree = _tree(_jax("bert")[1])["encoder"]
    jmodel = JaxEncoder(jax_config("tiny", **OVER))
    return tree, x, jax.jit(jmodel.apply)({"params": tree}, x)


@pytest.fixture(scope="module")
def bert_ref(scan):
    """The JAX BERT's tree, tokens, a key-padding mask, and its logits
    under an all-ones mask (the same function as no mask, one compile)
    and under the mask."""
    toks = _tokens(0, (2, 24))
    mask = _pad_mask(2, 24, 13)
    _, variables, apply = _jax("bert", scan)
    return (_tree(variables), toks, mask,
            [apply(variables, toks, m) for m in (np.ones_like(mask), mask)])


@pytest.fixture(scope="module")
def t5_ref(scan):
    """The JAX T5's tree, inputs, its logits under an all-ones
    ``enc_mask`` (the same function as none) and under a padding mask,
    and its memory under that mask."""
    enc, dec = _tokens(1, (2, 20)), _tokens(2, (2, 12))
    mask = _pad_mask(2, 20, 9)
    _, variables, apply = _jax("t5", scan)
    return (_tree(variables), enc, dec, mask,
            [apply(variables, enc, dec, m) for m in (np.ones_like(mask),
                                                     mask)],
            apply(variables, enc, dec, mask, return_memory=True))


@pytest.mark.parametrize("impl", IMPLS)
def test_encoder_forward_matches_jax(encoder_ref, impl):
    tree, x, want = encoder_ref
    model = _port(Encoder, tree, get_config("tiny", attention_impl=impl,
                                            **OVER))
    _close(model(torch.from_numpy(x)), want)


@pytest.mark.parametrize("impl", IMPLS)
def test_bert_forward_matches_jax(bert_ref, scan, impl):
    """Logits without a mask and with a key-padding mask (which the port
    sends to dense_attention under either impl)."""
    tree, toks, mask, wants = bert_ref
    model = _port(BERT, tree, get_config("tiny", scan_layers=scan,
                                         attention_impl=impl, **OVER))
    for m, want in zip((None, mask), wants):
        got = model(torch.from_numpy(toks),
                    None if m is None else torch.from_numpy(m))
        _close(got, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_t5_forward_matches_jax(t5_ref, scan, impl):
    """Logits without and with ``enc_mask``, the memory
    (``return_memory``), and the logits from that memory (``memory=``)."""
    tree, enc, dec, mask, wants, memory = t5_ref
    model = _port(T5, tree, get_config("tiny", scan_layers=scan,
                                       attention_impl=impl, **OVER))
    te, td, tm = (torch.from_numpy(a) for a in (enc, dec, mask))
    for m, want in zip((None, tm), wants):
        _close(model(te, td, m), want)
    tmem = model(te, td, tm, return_memory=True)
    _close(tmem, memory)
    _close(model(te, td, tm, memory=tmem), wants[1])


def _grads_match(model, loss, metrics, jgrads, jloss, jmetrics):
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    assert metrics.keys() == jmetrics.keys()
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v.detach()), float(jmetrics[k]),
                                   rtol=RTOL)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), model)
    params = dict(model.named_parameters())
    got = torch.autograd.grad(loss, list(params.values()))
    assert set(want) == set(params)
    for name, g in zip(params, got):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def _bert_batch(seed=0, b=4, s=32, attn_mask=True):
    toks = _tokens(seed, (b, s), low=5)
    batch = masked_batch(toks, 256, mask_token=3, seed=seed)
    if attn_mask:
        batch["attn_mask"] = _pad_mask(b, s, 20)
    return batch


def _t5_batch(seed=0, b=4, se=24, sd=16, masks=True):
    batch = {"enc_tokens": _tokens(seed, (b, se)),
             "dec_tokens": _tokens(seed + 1, (b, sd + 1))}
    if masks:
        batch["enc_mask"] = _pad_mask(b, se, 15)
        batch["dec_mask"] = _pad_mask(b, sd + 1, 10).astype(np.float32)
    return batch


@pytest.mark.parametrize("z_loss", [1e-3])
def test_mlm_loss_fn_values_and_grads_match_jax(z_loss):
    batch = _bert_batch()
    jmodel, variables, _ = _jax("bert")
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_mlm_loss_fn(jmodel.apply, p, batch, z_loss),
        has_aux=True))(variables["params"])
    model = _port(BERT, _tree(variables),
                  get_config("tiny", attention_impl="flash", **OVER))
    loss, metrics = mlm_loss_fn(model, batch, z_loss)
    _grads_match(model, loss, metrics, nn.meta.unbox(jgrads), jloss,
                 jmetrics)


@pytest.mark.parametrize("masks", [True], ids=["masks"])
def test_seq2seq_loss_fn_values_and_grads_match_jax(masks):
    batch = _t5_batch(masks=masks)
    jmodel, variables, _ = _jax("t5")
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_seq2seq_loss_fn(jmodel.apply, p, batch, 1e-4),
        has_aux=True))(variables["params"])
    model = _port(T5, _tree(variables),
                  get_config("tiny", attention_impl="flash", **OVER))
    loss, metrics = seq2seq_loss_fn(model, batch, 1e-4)
    _grads_match(model, loss, metrics, nn.meta.unbox(jgrads), jloss,
                 jmetrics)


@pytest.mark.parametrize("seed,prob", [(0, 0.15), (7, 0.4)])
def test_masked_batch_equals_jax(seed, prob):
    toks = np.random.default_rng(seed).integers(5, 250, (4, 64))
    got = masked_batch(toks, 256, mask_token=3, mask_prob=prob, seed=seed)
    want = jax_masked_batch(toks, 256, mask_token=3, mask_prob=prob,
                            seed=seed)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["labels"] != IGNORE).any()


@pytest.mark.parametrize("eos", [None, "early"])
def test_greedy_decode_equals_jax(eos):
    """Token for token, with an enc_mask; with ``eos`` set to the first
    row's third token without it, so that row stops early and keeps
    emitting it."""
    enc = _tokens(3, (3, 16))
    mask = _pad_mask(3, 16, 10)
    jmodel, variables, _ = _jax("t5")
    model = _port(T5, _tree(variables),
                  get_config("tiny", attention_impl="flash", **OVER))
    eos_id = None
    if eos:
        eos_id = int(greedy_decode(model, enc, max_len=8, bos_id=1,
                                   enc_mask=mask)[0, 2])
    want = np.asarray(jax_greedy_decode(jmodel, variables, enc, max_len=8,
                                        bos_id=1, eos_id=eos_id,
                                        enc_mask=mask))
    got = greedy_decode(model, enc, max_len=8, bos_id=1, eos_id=eos_id,
                        enc_mask=mask)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if eos:
        assert (want[0, 2:] == eos_id).all()


def _three_steps(family, tmodel, loss_fns, batch, init_inputs, opt):
    """Three updates of make_train against make_sharded_train on a
    one-device mesh from the same weights (``_jax(family)``'s): losses,
    gradient norms and metrics at each step within RTOL, the parameters
    after within PARAM_MAX / PARAM_MEAN and moved by the steps."""
    jmodel, variables, _ = _jax(family)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    init_fn, step_fn, shardings, _ = make_sharded_train(
        jmodel, mesh, JaxOptimizerConfig(**opt), loss_fn=loss_fns[0],
        example_batch=jbatch, init_inputs=init_inputs)
    state = _jax_state(init_fn, shardings, jbatch, variables)
    tree0 = jax.tree.map(np.array, nn.meta.unbox(state.params))
    tmodel.load_state_dict(params_from_jax(tree0, tmodel))
    tinit, tstep = make_train(tmodel, OptimizerConfig(**opt),
                              loss_fn=loss_fns[1])
    tstate = tinit()
    for _ in range(3):
        state, m = step_fn(state, jbatch)
        tstate, tm = tstep(tstate, batch)
        assert tm.keys() == m.keys()
        for k in m:
            np.testing.assert_allclose(float(tm[k]), float(m[k]), rtol=RTOL,
                                       err_msg=k)
    want = params_from_jax(jax.tree.map(np.asarray,
                                        nn.meta.unbox(state.params)), tmodel)
    start = params_from_jax(tree0, tmodel)
    moved = 0.0
    for name, p in tmodel.state_dict().items():
        diff = np.abs(p.numpy() - want[name].numpy())
        assert diff.max() <= PARAM_MAX and diff.mean() <= PARAM_MEAN, \
            (name, diff.max(), diff.mean())
        moved = max(moved, float(np.abs(want[name].numpy()
                                        - start[name].numpy()).max()))
    assert moved > 1e-4


OPT = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=10)


def test_bert_three_steps_match_make_sharded_train():
    batch = _bert_batch(seed=1)
    _three_steps("bert",
                 BERT(get_config("tiny", attention_impl="flash", **OVER),
                      device="cpu"),
                 (jax_mlm_loss_fn, mlm_loss_fn), batch,
                 lambda b: (b["tokens"],), OPT)


def test_t5_three_steps_match_make_sharded_train():
    _three_steps("t5",
                 T5(get_config("tiny", attention_impl="flash", **OVER),
                    device="cpu"),
                 (jax_seq2seq_loss_fn, seq2seq_loss_fn), _t5_batch(seed=2),
                 t5_init_inputs, OPT)


@pytest.mark.parametrize("family", ["bert", "t5"])
def test_decay_mask_matches_jax(family):
    """The port's decay mask over each parameter equals the reference's
    over the JAX leaf that parameter comes from (scanned tree; the
    unscanned names end the same)."""
    jcfg = jax_config("tiny", **OVER)
    tcfg = get_config("tiny", **OVER)
    if family == "bert":
        jmodel, model = JaxBERT(jcfg), BERT(tcfg, device="cpu")
        args = (np.zeros((1, 8), np.int32),)
    else:
        jmodel, model = JaxT5(jcfg), T5(tcfg, device="cpu")
        args = (np.zeros((1, 8), np.int32), np.zeros((1, 4), np.int32))
    params = nn.meta.unbox(jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), *args))["params"])
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
    assert not got["pos_embed" if family == "bert" else "final_norm.scale"]


@pytest.mark.parametrize("policy", ["nothing", "block_outs", "dots"])
def test_remat_changes_no_value(policy):
    """Loss and gradients of BERT and T5 under each remat policy equal
    those without remat (flash, GQA)."""
    torch.manual_seed(0)
    for cls, loss_fn, batch in ((BERT, mlm_loss_fn, _bert_batch(b=2)),
                                (T5, seq2seq_loss_fn, _t5_batch(b=2))):
        out = []
        for remat in (False, True):
            cfg = get_config("tiny", attention_impl="flash", remat=remat,
                             remat_policy=policy, **OVER)
            model = cls(cfg, device="cpu")
            if not out:
                sd = model.state_dict()
                for v in sd.values():
                    v.normal_(0, 0.1)
            model.load_state_dict(sd)
            loss, _ = loss_fn(model, batch, 1e-4)
            params = dict(model.named_parameters())
            out.append((loss.item(), dict(zip(params, torch.autograd.grad(
                loss, list(params.values())))), ))
        (want, wg), (got, gg) = out[0], out[1]
        np.testing.assert_allclose(got, want, rtol=RTOL)
        for name, g in wg.items():
            np.testing.assert_allclose(gg[name].numpy(), g.numpy(),
                                       rtol=RTOL, atol=1e-7, err_msg=name)
