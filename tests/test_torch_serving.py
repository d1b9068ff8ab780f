"""The rest of the port's serving model side held against ray_tpu's on the
same converted weights, on the CPU: the dense slot-mode engine (the
reference's default), ``stream``, ``Generator``, the paged engine's
prompt-prefix cache, ``page_digests`` and prefill handoffs across the
two packages.

Both packages compute in fp32 on the CPU (the tiny preset), so greedy
argmax is exact up to summation order, and both argmaxes take the first
maximal index on a tie: tokens must be identical, with no tolerance.
The two packages' exported pages, fp32 K/V of the same prefill, must
agree within atol 1e-5 (summation order over d_model 64 moves them by
~1e-7; a wrong layout moves them by O(1)).
"""

import asyncio
import threading

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp

from ray_tpu.models.configs import get_config as jax_config
from ray_tpu.models.generate import Generator as JaxGenerator
from ray_tpu.models.gpt import GPT as JaxGPT
from ray_tpu.serve.frontdoor.prefix import page_digests as jax_page_digests
from ray_tpu.serve.llm_engine import LLMEngine as JaxEngine
from ray_tpu_torch.exceptions import KVPoolFullError
from ray_tpu_torch.models.configs import get_config
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.generate import Generator
from ray_tpu_torch.serve.frontdoor.prefix import page_digests
from ray_tpu_torch.serve.llm_engine import GenerationResult, LLMEngine

# six prompts in one bucket (16): more requests than slots, so slots
# are reused while others are admitted
PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11], [50, 60] * 4 + [61],
           list(range(20, 32)), [5] * 16, [200, 3]]
NEW = 8
DENSE = dict(num_slots=2, block_size=4)
PAGED = dict(num_slots=2, block_size=4, paged=True, page_size=16)


def _run(eng, prompts, **kw):
    """Submit every prompt at once from its own thread."""
    results = [None] * len(prompts)

    def go(i, p):
        results[i] = eng.submit(p, max_new_tokens=NEW, **kw)

    threads = [threading.Thread(target=go, args=(i, p))
               for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not any(t.is_alive() for t in threads)
    return results


def _one_wave(eng, prompts, **kw):
    """Submit every prompt while the engine loop waits on its lock, so
    that it admits them all in one quantum (one wave per bucket)."""
    async def go():
        with eng._lock:
            futs = [eng.submit(p, max_new_tokens=NEW, **kw)
                    for p in prompts]
        return await asyncio.wait_for(asyncio.gather(*futs), 240)
    return asyncio.run(go())


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config("tiny", n_kv_heads=2)
    tcfg = get_config("tiny", n_kv_heads=2)
    params = JaxGPT(jcfg, decode=True).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 1), jnp.int32))["params"]
    tree = jax.tree.map(np.asarray, nn.meta.unbox(params))
    return jcfg, tree, tcfg, params_from_jax(tree, tcfg)


@pytest.fixture(scope="module")
def jax_dense(weights):
    jcfg, tree, _, _ = weights
    eng = JaxEngine(jcfg, tree, **DENSE)
    try:
        return _run(eng, PROMPTS)
    finally:
        eng.close()


def test_dense_engine_matches_jax_dense_engine(weights, jax_dense):
    """The default engine is dense, as the reference's; six requests on
    two slots, submitted at once, decode token for token as JAX's."""
    _, _, tcfg, sd = weights
    eng = LLMEngine(tcfg, sd, device="cpu", **DENSE)
    try:
        assert not eng.paged
        results = _run(eng, PROMPTS)
        assert eng.stats.requests_completed == len(PROMPTS)
        assert sorted(eng._free) == [0, 1]
    finally:
        eng.close()
    for i, (got, want) in enumerate(zip(results, jax_dense)):
        assert got.tokens == want.tokens, f"request {i} diverged"
        assert len(got.tokens) == NEW and got.finish_reason == "length"
        assert got.prompt_len == len(PROMPTS[i])


def test_dense_engine_wide_wave_eos_and_oversized(weights, jax_dense):
    """Three prompts admitted in one wave on three slots: the wave pads
    to 4 rows, as many as the cache holds (three slots and the scratch
    row), with an eos that ends request 0 at its third token.  A prompt
    longer than max_prompt_len is refused by both engines."""
    jcfg, tree, tcfg, sd = weights
    eos = jax_dense[0].tokens[2]
    kw = dict(num_slots=3, block_size=4, max_prompt_len=20)
    prompts = PROMPTS[:3]
    out = []
    for eng in (JaxEngine(jcfg, tree, **kw),
                LLMEngine(tcfg, sd, device="cpu", **kw)):
        try:
            out.append(_one_wave(eng, prompts, eos_id=eos))
            with pytest.raises(ValueError, match="max_prompt_len"):
                eng.submit([1] * 21)
            if isinstance(eng, LLMEngine):
                assert eng._rows == 4 and eng.stats.prefills == 3
        finally:
            eng.close()
    want, got = out
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    assert got[0].finish_reason == "eos"
    assert got[0].tokens == jax_dense[0].tokens[:3]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_stream_yields_the_tokens_then_the_result(weights, jax_dense,
                                                  paged):
    _, _, tcfg, sd = weights
    eng = LLMEngine(tcfg, sd, device="cpu", **(PAGED if paged else DENSE))

    async def consume():
        return [x async for x in eng.stream(PROMPTS[1], max_new_tokens=NEW)]

    try:
        *tokens, result = asyncio.run(consume())
    finally:
        eng.close()
    assert isinstance(result, GenerationResult)
    assert tokens == result.tokens == jax_dense[1].tokens


def test_generator_matches_jax_generator_with_an_eos_row(weights):
    """Greedy generation over the dense cache; the eos is row 0's third
    token, so row 0 is padded with it while row 1 runs on (generation
    stops only when every row has emitted it)."""
    jcfg, tree, tcfg, sd = weights
    prompts = np.array([[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]], np.int32)
    free = np.asarray(JaxGenerator(jcfg, tree).generate(
        prompts, max_new_tokens=NEW, temperature=0.0))
    eos = int(free[0, 2])
    assert eos not in free[1]
    want = np.asarray(JaxGenerator(jcfg, tree).generate(
        prompts, max_new_tokens=NEW, temperature=0.0, eos_id=eos))
    gen = Generator(tcfg, sd, device="cpu")
    got = gen.generate(prompts, max_new_tokens=NEW, temperature=0.0,
                       eos_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 2:] == eos).all() and got.shape == (2, NEW)
    np.testing.assert_array_equal(
        gen.generate(prompts, max_new_tokens=NEW, temperature=0.0).numpy(),
        free)


def test_page_digests_equal_jax_byte_for_byte():
    rng = np.random.default_rng(0)
    tokens = rng.integers(-2 ** 40, 2 ** 40, 300).tolist()
    for ps in (1, 16, 64, 301, 0):
        assert page_digests(tokens, ps) == jax_page_digests(tokens, ps)


def test_prefix_hit_matches_a_miss_and_jax(weights):
    """A prompt sharing two full pages with a finished one borrows them
    and prefills only its suffix: its tokens equal JAX's prefix-cached
    engine's and those of an engine without the cache."""
    jcfg, tree, tcfg, sd = weights
    base = list(range(1, 37))                 # two full pages of 16 + 4
    first, second = base + [40, 41], base[:32] + [50, 51, 52, 53, 54]
    kw = dict(PAGED, prefix_cache_pages=8)
    out = []
    for eng in (JaxEngine(jcfg, tree, **kw),
                LLMEngine(tcfg, sd, device="cpu", **kw)):
        try:
            out.append([eng.submit(p, max_new_tokens=NEW).tokens
                        for p in (first, second)])
            assert eng.stats.prefix_hits == 1
            assert eng.stats.prefix_tokens_saved == 32
            assert len(eng.prefix_digests()) == 2
        finally:
            eng.close()
    want, got = out
    assert got == want
    miss = LLMEngine(tcfg, sd, device="cpu", **PAGED)
    try:
        assert miss.submit(second, max_new_tokens=NEW).tokens == got[1]
    finally:
        miss.close()


def test_handoffs_import_across_packages(weights):
    """A handoff exported by JAX's engine decodes on the port's, one
    exported by the port's decodes on JAX's (so the layouts are the
    same), and both give a colocated submit's tokens; stream_import
    yields the tokens decoded on the importer.  import_queue_max rejects
    synchronously with KVPoolFullError."""
    jcfg, tree, tcfg, sd = weights
    prompt = list(range(20, 40))              # two pages: 16 + 4
    jeng = JaxEngine(jcfg, tree, **PAGED)
    eng = LLMEngine(tcfg, sd, device="cpu", **PAGED)
    try:
        want = eng.submit(prompt, max_new_tokens=NEW).tokens
        hj = jeng.export_prefill(prompt, max_new_tokens=NEW)
        hp = eng.export_prefill(prompt, max_new_tokens=NEW)
        assert hp.npages == hj.npages == 2 and hp.first_token == want[0]
        np.testing.assert_allclose(hp.kv.numpy(), hj.kv, atol=1e-5)
        assert eng.import_prefill(hj).tokens == want
        assert jeng.import_prefill(hp).tokens == want

        async def consume():
            return [x async for x in eng.stream_import(hj)]
        *tokens, result = asyncio.run(consume())
        assert tokens == want[1:] and result.tokens == want
        assert eng.stats.exports == 1 and eng.stats.imports == 2
        eng.import_queue_max = 0
        with pytest.raises(KVPoolFullError):
            eng.import_prefill(hp)
        assert eng.stats.import_rejects == 1
    finally:
        jeng.close()
        eng.close()
