"""The port's mixture-of-experts block (ray_tpu_torch.ops.moe.MoEMLP, the
MoE GPT, its aux loss in training, Adafactor over the expert leaves, and
serving) held against ray_tpu's on the same seeded numpy inputs and
converted weights, on the CPU.

Tolerances.  fp32 on both sides: routing is the same discrete choice, and
the expert products differ by summation order over widths <= 128, ~1e-7:
MoEMLP's output within atol 1e-5, its aux loss within 1e-6 relative, the
gradients of sum(y^2) within rtol 1e-4 / atol 1e-6; GPT logits within
1e-4 as in test_torch_gpt.py.  bf16 compute: the experts round at the
same places on both sides but sum in other orders, a few bf16 ulps of
O(1) values: MoEMLP within 2e-2, GPT logits within 0.05 (a wrong
routing moves outputs by O(0.1) or more).  Training steps keep
test_torch_train.py's tolerances; serving compares tokens exactly.
"""

import threading

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from ray_tpu.models.configs import get_config as jax_config
from ray_tpu.models.generate import Generator as JaxGenerator
from ray_tpu.models.gpt import GPT as JaxGPT
from ray_tpu.ops.moe import MoEMLP as JaxMoEMLP
from ray_tpu.serve.llm_engine import LLMEngine as JaxEngine
from ray_tpu.train.step import OptimizerConfig as JaxOptimizerConfig
from ray_tpu_torch.models.configs import get_config
from ray_tpu_torch.models.convert import (init_weights, jax_leaves,
                                          params_from_jax)
from ray_tpu_torch.models.generate import Generator
from ray_tpu_torch.models.gpt import GPT
from ray_tpu_torch.ops.moe import MoEMLP
from ray_tpu_torch.serve.llm_engine import LLMEngine
from ray_tpu_torch.train.step import OptimizerConfig, state_nbytes
from test_torch_train import _steps_match_make_sharded_train

D, E, F_, S = 16, 4, 64, 32


def _np(a):
    return np.array(jnp.asarray(a, jnp.float32))


def _pair(cf, dtype=jnp.float32, x=None, router=None):
    """(JAX MoEMLP, its params, port MoEMLP with the same weights, x)."""
    if x is None:
        x = np.random.default_rng(0).standard_normal((2, S, D)).astype(
            np.float32)
    jm = JaxMoEMLP(E, F_, top_k=2, capacity_factor=cf, dtype=dtype,
                   param_dtype=jnp.float32)
    params = nn.meta.unbox(jm.init(jax.random.PRNGKey(1),
                                   jnp.asarray(x, dtype))["params"])
    if router is not None:
        params = dict(params, router={"kernel": jnp.asarray(router)})
    tm = MoEMLP(D, E, F_, top_k=2, capacity_factor=cf,
                compute_dtype=(torch.bfloat16 if dtype == jnp.bfloat16
                               else torch.float32))
    with torch.no_grad():
        tm.router.weight.copy_(torch.from_numpy(_np(
            params["router"]["kernel"]).T))
        for n in ("w_gate", "w_up", "w_down"):
            getattr(tm, n).copy_(torch.from_numpy(_np(params[n])))
    return jm, params, tm, x


def _jax_apply(jm, params, x):
    y, mut = jm.apply({"params": params}, x, mutable=["intermediates"])
    return y, mut["intermediates"]["moe_aux_loss"][0]


def _drops(tm, x):
    _, _, _, pos = tm.route(x)
    return int((pos >= tm.capacity(x.shape[1])).sum())


@pytest.mark.parametrize("cf", [2.0, 1.25, 0.5])
def test_moe_mlp_and_its_gradients_match_jax(cf):
    """Output, aux loss and the gradients of sum(y^2) with respect to x,
    the router and the experts; at capacity factor 0.5 half the (token,
    choice) pairs are dropped."""
    jm, params, tm, x = _pair(cf)
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = tm(xt)
    aux = aux.detach()
    want_y, want_aux = _jax_apply(jm, params, jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), _np(want_y), atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    if cf == 0.5:
        assert _drops(tm, xt) > 0

    y.square().sum().backward()
    gx, gp = jax.jit(jax.grad(
        lambda xx, pp: jnp.sum(_jax_apply(jm, pp, xx)[0] ** 2),
        argnums=(0, 1)))(jnp.asarray(x), params)
    tol = dict(rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), _np(gx), **tol)
    np.testing.assert_allclose(tm.router.weight.grad.numpy().T,
                               _np(gp["router"]["kernel"]), **tol)
    for n in ("w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(getattr(tm, n).grad.numpy(), _np(gp[n]),
                                   err_msg=n, **tol)


def test_router_ties_pick_the_lower_expert_first():
    """Experts 1 and 2 have equal router columns, so every token's
    probabilities tie between them exactly (integer inputs, weights in
    quarters).  lax.top_k takes the lower index first; so must the port,
    and with capacity 0.5 the order decides which choice is kept."""
    rng = np.random.default_rng(3)
    x = rng.integers(-2, 3, (2, S, D)).astype(np.float32)
    router = rng.integers(-2, 3, (D, E)).astype(np.float32) * 0.25
    router[:, 2] = router[:, 1]
    jm, params, tm, _ = _pair(0.5, x=x, router=router)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        probs, _, idx, _ = tm.route(xt)
        y, _ = tm(xt)
    _, want_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    tied = (idx == 1).any(-1) & (idx == 2).any(-1)
    assert tied.sum() > 0 and (idx[tied][:, 0] == 1).all()
    np.testing.assert_allclose(y.numpy(), _np(_jax_apply(
        jm, params, jnp.asarray(x))[0]), atol=1e-5)


def test_bf16_compute_over_fp32_params_matches_jax():
    """bf16 experts over fp32 parameters, the router in fp32, on bf16
    inputs (a block's normed activations): atol 2e-2."""
    x = np.random.default_rng(4).standard_normal((2, S, D)).astype(
        np.float32)
    x = _np(jnp.asarray(x, jnp.bfloat16))
    jm, params, tm, _ = _pair(1.25, jnp.bfloat16, x=x)
    with torch.no_grad():
        y, aux = tm(torch.from_numpy(x).to(torch.bfloat16))
    want_y, want_aux = _jax_apply(jm, params, jnp.asarray(x, jnp.bfloat16))
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), _np(want_y), atol=2e-2)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


def test_init_weights_matches_flax_lecun_normal_on_experts():
    """flax's lecun_normal over [E, in, out] has fan-in E * in; the
    port's init_weights draws the same std within 3%."""
    e, d, f = 8, 256, 512
    moe = MoEMLP(d, e, f, compute_dtype=torch.float32)
    init_weights(moe, torch.Generator().manual_seed(0))
    init = jax.nn.initializers.lecun_normal()
    for name, shape in (("w_gate", (e, d, f)), ("w_down", (e, f, d))):
        want = float(jnp.std(init(jax.random.PRNGKey(0), shape)))
        got = getattr(moe, name).std().item()
        assert abs(got - want) <= 0.03 * want, (name, got, want)
    want = float(jnp.std(init(jax.random.PRNGKey(0), (d, e))))
    assert abs(moe.router.weight.std().item() - want) <= 0.1 * want


@pytest.fixture(scope="module", params=["scan", "unrolled", "remat_tail"])
def model_pair(request):
    """(jax cfg, jax params, port cfg, port GPT) for tiny-moe."""
    over = dict(n_kv_heads=2, scan_layers=request.param != "unrolled")
    if request.param == "remat_tail":
        over.update(remat=True, remat_layers=1)
    jcfg = jax_config("tiny-moe", **over)
    tcfg = get_config("tiny-moe", **over)
    toks = jnp.zeros((1, 8), jnp.int32)
    params = jax.jit(JaxGPT(jcfg).init)(jax.random.PRNGKey(2),
                                        toks)["params"]
    tree = jax.tree.map(np.asarray, nn.meta.unbox(params))
    model = GPT(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, tcfg))
    return jcfg, tree, tcfg, model


def test_jax_leaves_list_the_moe_tree(model_pair):
    """jax_leaves names every leaf of a real JAX MoE tree with its shape
    (scanned [L, E, D, F] experts, unrolled layers, the partial-remat
    tail), and params_from_jax fills every port parameter."""
    _, tree, tcfg, model = model_pair
    flat = {tuple(k.key for k in path): np.shape(a) for path, a in
            jax.tree_util.tree_leaves_with_path(tree)}
    leaves = jax_leaves(tcfg)
    assert {leaf.path: leaf.shape for leaf in leaves} == flat
    assert {n for leaf in leaves for n in leaf.names} == set(
        model.state_dict())
    if tcfg.scan_layers and not tcfg.remat:
        assert flat[("blocks", "moe", "w_gate")] == (2, 8, 64, 128)
        assert flat[("blocks", "moe", "router", "kernel")] == (2, 64, 8)


def test_moe_gpt_logits_match_jax(model_pair):
    jcfg, tree, tcfg, model = model_pair
    toks = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, 24)).astype(np.int32)
    want = jax.jit(JaxGPT(jcfg).apply)({"params": tree}, jnp.asarray(toks))
    with torch.no_grad():
        got, aux = model(torch.from_numpy(toks), return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert float(aux) > 0


def test_moe_gpt_bf16_logits_match_jax():
    over = dict(n_kv_heads=2)
    jcfg = jax_config("tiny-moe", dtype=jnp.bfloat16, **over)
    tcfg = get_config("tiny-moe", dtype=torch.bfloat16, **over)
    toks = np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (2, 24)).astype(np.int32)
    jmodel = JaxGPT(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3),
                                  jnp.asarray(toks))["params"]
    tree = jax.tree.map(np.asarray, nn.meta.unbox(params))
    model = GPT(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, tcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), _np(jax.jit(jmodel.apply)(
        {"params": tree}, jnp.asarray(toks))), atol=5e-2)


@pytest.mark.parametrize("case", ["adamw_nothing", "adamw_dots",
                                  "adafactor"])
def test_moe_train_steps_match_make_sharded_train(case):
    """Three make_train steps on tiny-moe against make_sharded_train:
    losses with the aux loss, the aux loss itself, gradient norms and
    parameters.  AdamW decays by weight_decay 0.1 (the default): the
    router's kernel is decayed, the experts' leaves are not.  Adafactor
    runs at d_model 128 / d_ff 256, so that the [2, 8, 128, 256] expert
    stacks are factored over their last two axes."""
    over = dict(n_kv_heads=2, max_seq_len=64)
    opt = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=10)
    if case == "adafactor":
        over.update(d_model=128, d_ff=256)
        opt["optimizer"] = "adafactor"
    else:
        over.update(remat=True, remat_policy=case.split("_")[1])
    _steps_match_make_sharded_train(over, opt, preset="tiny-moe")


def test_adafactor_state_size_matches_jax_at_mixtral_depth_2():
    """The Adafactor state of chip_smoke.py's moe_train run (mixtral-8x7b
    at full width, depth 2, remat "dots") from shapes alone: JAX's bytes
    are pinned (chip_smoke.py's MIXTRAL_ADAFACTOR_STATE_BYTES), the
    port's within 1 KB.  The expert stacks [2, 8, 4096, 14336] are
    factored over their last two axes."""
    over = dict(n_layers=2, max_seq_len=1024, remat=True,
                remat_policy="dots")
    jcfg = jax_config("mixtral-8x7b", **over)
    jparams = nn.meta.unbox(jax.eval_shape(
        lambda: JaxGPT(jcfg).init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"]))
    jstate = jax.eval_shape(
        JaxOptimizerConfig(optimizer="adafactor").make().init, jparams)
    want = sum(np.prod(a.shape) * a.dtype.itemsize
               for a in jax.tree.leaves(jstate))
    assert want == 5_859_404
    cfg = get_config("mixtral-8x7b", **over)
    state = OptimizerConfig(optimizer="adafactor").make(jax_leaves(cfg)).init(
        dict(GPT(cfg, device="meta").named_parameters()))
    assert abs(state_nbytes(state) - want) <= 1024


# prompts shorter than their bucket (16), so that right-pad tokens take
# expert capacity in each prefill
PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11], [50, 60] * 4 + [61],
           list(range(20, 32)), [200, 3]]
NEW = 8
DENSE = dict(num_slots=2, block_size=4)
PAGED = dict(num_slots=2, block_size=4, paged=True, page_size=16)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config("tiny-moe", n_kv_heads=2)
    tcfg = get_config("tiny-moe", n_kv_heads=2)
    params = jax.jit(JaxGPT(jcfg, decode=True).init)(
        jax.random.PRNGKey(4), jnp.zeros((1, 1), jnp.int32))["params"]
    tree = jax.tree.map(np.asarray, nn.meta.unbox(params))
    return jcfg, tree, tcfg, params_from_jax(tree, tcfg)


@pytest.fixture
def prefill_drops(monkeypatch):
    """Counts the (token, choice) pairs each port prefill (s > 1) drops."""
    seen = []
    forward = MoEMLP.forward

    def counting(self, x):
        if x.shape[1] > 1:
            seen.append(_drops(self, x))
        return forward(self, x)
    monkeypatch.setattr(MoEMLP, "forward", counting)
    return seen


def _rows(packed, bucket):
    """A prefill wave's windows: (tokens, real length) of each row that
    is not a pad row (all zeros, length 1)."""
    packed = np.asarray(packed)
    return [(tuple(r[:bucket].tolist()), int(r[bucket])) for r in packed
            if r[:bucket].any() or r[bucket] != 1]


@pytest.fixture
def windows(monkeypatch):
    """Records the windows each engine prefills: the JAX engine's jitted
    prefills and the port's ``_prefill_dense`` / ``_prefill_paged`` take
    the same packed rows, tokens then the real length.  A prefill's
    routing depends on its whole window, pads included, so the port must
    pad as JAX does."""
    seen = {"jax": [], "port": []}
    for name in ("_get_prefill", "_get_prefill_paged",
                 "_get_prefill_suffix"):
        def get(self, bucket, wave, _get=getattr(JaxEngine, name)):
            fn = _get(self, bucket, wave)

            def call(*args):
                packed = args[1] if len(args) == 3 else args[2]
                seen["jax"].extend(_rows(packed, bucket))
                return fn(*args)
            return call
        monkeypatch.setattr(JaxEngine, name, get)
    for name in ("_prefill_dense", "_prefill_paged"):
        def prefill(self, packed, bucket, *args,
                    _fn=getattr(LLMEngine, name)):
            seen["port"].extend(_rows(packed.cpu(), bucket))
            return _fn(self, packed, bucket, *args)
        monkeypatch.setattr(LLMEngine, name, prefill)
    return seen


def _run(eng, prompts):
    results = [None] * len(prompts)

    def go(i, p):
        results[i] = eng.submit(p, max_new_tokens=NEW).tokens

    threads = [threading.Thread(target=go, args=(i, p))
               for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not any(t.is_alive() for t in threads)
    return results


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_engines_match_jax_token_for_token(weights, prefill_drops, windows,
                                           mode):
    """Five requests on two slots through the port's engine and JAX's:
    the same padded windows prefilled, and greedy tokens equal.  MoE
    capacity is per batch row, so how the requests fall into waves
    changes nothing, while each prompt's pad tokens take capacity in its
    row: some prefill drops a pair."""
    jcfg, tree, tcfg, sd = weights
    kw = DENSE if mode == "dense" else PAGED
    out = []
    for eng in (JaxEngine(jcfg, tree, **kw),
                LLMEngine(tcfg, sd, device="cpu", **kw)):
        try:
            out.append(_run(eng, PROMPTS))
        finally:
            eng.close()
    want, got = out
    assert got == want
    assert sorted(windows["port"]) == sorted(windows["jax"])
    assert len(windows["port"]) == len(PROMPTS)
    assert sum(prefill_drops) > 0


def test_prefix_cache_matches_jax(weights, prefill_drops, windows):
    """A prompt that borrows two cached pages prefills only its suffix
    window, whose capacity differs from a whole-prompt prefill's; its
    tokens equal those of JAX's prefix-cached engine."""
    jcfg, tree, tcfg, sd = weights
    base = list(range(1, 37))
    first, second = base + [40, 41], base[:32] + [50, 51, 52]
    kw = dict(PAGED, prefix_cache_pages=8)
    out = []
    for eng in (JaxEngine(jcfg, tree, **kw),
                LLMEngine(tcfg, sd, device="cpu", **kw)):
        try:
            out.append([eng.submit(p, max_new_tokens=NEW).tokens
                        for p in (first, second)])
            assert eng.stats.prefix_hits == 1
        finally:
            eng.close()
    assert out[1] == out[0]
    assert windows["port"] == windows["jax"] and len(windows["port"]) == 2
    assert sum(prefill_drops) > 0


def test_generator_matches_jax(weights):
    jcfg, tree, tcfg, sd = weights
    prompts = np.array([[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]], np.int32)
    want = np.asarray(JaxGenerator(jcfg, tree).generate(
        prompts, max_new_tokens=NEW, temperature=0.0))
    got = Generator(tcfg, sd, device="cpu").generate(
        prompts, max_new_tokens=NEW, temperature=0.0).numpy()
    np.testing.assert_array_equal(got, want)
