"""The port's paged LLMEngine (ray_tpu_torch.serve.llm_engine) held
against ray_tpu's paged LLMEngine on the same converted weights, on the
CPU: greedy output must be token-for-token identical, with more requests
than slots and a pool small enough that pages recycle.

Both engines compute in fp32 on the CPU; greedy argmax is exact, and
both argmaxes take the first maximal index on a tie.
"""

import threading

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp

from ray_tpu.models.configs import get_config as jax_config
from ray_tpu.models.gpt import GPT as JaxGPT
from ray_tpu.serve.llm_engine import LLMEngine as JaxEngine
from ray_tpu_torch.models.configs import get_config
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.serve.llm_engine import LLMEngine

# six prompts in one bucket (16): 9 pages of need against a 6-page pool
PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11], [50, 60] * 4 + [61],
           list(range(20, 32)), [5] * 16, [200, 3]]
NEW = 8
ENGINE = dict(num_slots=2, block_size=4, paged=True, page_size=16,
              kv_pool_pages=1 + 6)


def _run(eng, prompts):
    results = [None] * len(prompts)

    def go(i, p):
        results[i] = eng.submit(p, max_new_tokens=NEW, temperature=0.0)

    threads = [threading.Thread(target=go, args=(i, p))
               for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not any(t.is_alive() for t in threads)
    return results


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config("tiny", n_kv_heads=2)
    tcfg = get_config("tiny", n_kv_heads=2)
    params = JaxGPT(jcfg, decode=True).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 1), jnp.int32))["params"]
    tree = jax.tree.map(np.asarray, nn.meta.unbox(params))
    return jcfg, tree, tcfg


@pytest.fixture(scope="module")
def jax_results(weights):
    jcfg, tree, _ = weights
    eng = JaxEngine(jcfg, tree, **ENGINE)
    try:
        return _run(eng, PROMPTS)
    finally:
        eng.close()


def test_port_engine_matches_jax_engine_token_for_token(weights,
                                                        jax_results):
    _, tree, tcfg = weights
    eng = LLMEngine(tcfg, params_from_jax(tree, tcfg), device="cpu",
                    **ENGINE)
    try:
        results = _run(eng, PROMPTS)
        assert eng.stats.requests_completed == len(PROMPTS)
        # every page is back in the pool
        assert sorted(eng._free_pages) == list(range(1, 7))
    finally:
        eng.close()
    for i, (got, want) in enumerate(zip(results, jax_results)):
        assert got.tokens == want.tokens, f"request {i} diverged"
        assert len(got.tokens) == NEW
        assert got.finish_reason == "length"
        assert got.prompt_len == len(PROMPTS[i])


def test_stale_slot_redirect_protects_recycled_pages(weights):
    """A freed slot that stays idle keeps stepping junk over its old table
    until its redirect row rides a block; a page it owned and a new
    request now holds must not see those writes.  B's span (17) ends
    early in its second page; C is submitted the moment B returns and
    takes that page first.  C must decode as it does on an idle engine."""
    _, tree, tcfg = weights
    sd = params_from_jax(tree, tcfg)
    kw = dict(ENGINE, num_slots=3, device="cpu")
    prompt_c = list(range(40, 52))
    ref = LLMEngine(tcfg, sd, **kw)
    try:
        want = ref.submit(prompt_c, max_new_tokens=16).tokens
    finally:
        ref.close()
    eng = LLMEngine(tcfg, sd, **kw)
    try:
        long_a = threading.Thread(
            target=eng.submit, args=([1, 2, 3],), kwargs={"max_new_tokens": 60})
        long_a.start()
        eng.submit([4, 5, 6], max_new_tokens=14)
        got = eng.submit(prompt_c, max_new_tokens=16).tokens
        long_a.join(timeout=240)
        assert not long_a.is_alive()
    finally:
        eng.close()
    assert got == want


def test_port_engine_eos_oversized_and_unported(weights, jax_results):
    """eos, a request too large for the pool, and the handoff calls that
    this test once held to be unported: a paged engine exports a prompt
    (its first token is the greedy one), and a dense engine refuses to,
    as the reference's does."""
    _, tree, tcfg = weights
    sd = params_from_jax(tree, tcfg)
    eng = LLMEngine(tcfg, sd, device="cpu", max_prompt_len=60, **ENGINE)
    try:
        eng.warmup(prompt_lens=[3])
        eos = jax_results[0].tokens[2]
        r = eng.submit(PROMPTS[0], max_new_tokens=NEW, eos_id=eos)
        assert r.finish_reason == "eos"
        assert r.tokens == jax_results[0].tokens[:3]
        # needs ceil(min(60 + 128, 128) / 16) = 8 pages > the pool's 6
        with pytest.raises(ValueError):
            eng.submit([9] * 60, max_new_tokens=128)
        r2 = eng.submit(PROMPTS[1], max_new_tokens=NEW)
        assert r2.tokens == jax_results[1].tokens
        h = eng.export_prefill(PROMPTS[0], max_new_tokens=NEW)
        assert h.first_token == jax_results[0].tokens[0]
        assert h.npages == 1 and tuple(h.kv.shape) == (
            tcfg.n_layers, 1, tcfg.n_kv_heads, 16, 2 * tcfg.head_dim)
    finally:
        eng.close()
    dense = LLMEngine(tcfg, sd, device="cpu")
    try:
        assert not dense.paged
        with pytest.raises(RuntimeError, match="paged=True"):
            dense.export_prefill([1])
    finally:
        dense.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit([1])


def test_engine_leaves_the_callers_model_as_it_was(weights):
    """tiny in bf16 over fp32 masters: the engine serves a cast copy and
    leaves the caller's parameters fp32, trainable and in train mode, as
    the JAX engine casts into a new tree.  Its greedy tokens are those of
    an engine built from the state dict."""
    import torch
    from ray_tpu_torch.models.gpt import GPT
    _, tree, _ = weights
    cfg = get_config("tiny", n_kv_heads=2, dtype=torch.bfloat16)
    model = GPT(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    kw = dict(ENGINE, device="cpu")
    eng = LLMEngine(cfg, model, **kw)
    try:
        assert eng.model is not model
        assert all(p.dtype == torch.bfloat16 for p in eng.model.parameters())
        got = _run(eng, PROMPTS[:2])
    finally:
        eng.close()
    assert model.training
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.requires_grad, name
        assert torch.equal(p, before[name]), name
    ref = LLMEngine(cfg, before, **kw)
    try:
        want = _run(ref, PROMPTS[:2])
    finally:
        ref.close()
    assert [r.tokens for r in got] == [r.tokens for r in want]
