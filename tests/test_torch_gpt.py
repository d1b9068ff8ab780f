"""The port's GPT (ray_tpu_torch.models) held against ray_tpu's on the
same converted weights, on the CPU: the weight converter, and the paged
decode path (prefill, then decode steps through the paged attention).

Tolerance: atol 1e-4 on fp32 logits.  Both sides run fp32 on the CPU;
the logits pass two blocks of matmuls of width <= 128 over O(1) values,
so summation-order rounding stays near 1e-6, and 1e-4 leaves headroom
without hiding a layout error (those move logits by O(0.1)).
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from ray_tpu.models.configs import get_config as jax_config
from ray_tpu.models.generate import init_decode_cache as jax_init_cache
from ray_tpu.models.gpt import GPT as JaxGPT
from ray_tpu_torch.models.configs import get_config
from ray_tpu_torch.models.convert import init_weights, params_from_jax
from ray_tpu_torch.models.generate import init_decode_cache
from ray_tpu_torch.models.gpt import GPT

ATOL = 1e-4
PS = 16
POOL = 32


@pytest.fixture(scope="module", params=[True, False], ids=["scan", "unrolled"])
def pair(request):
    """(jax cfg, jax params, port cfg, port GPT) on the same weights."""
    over = dict(n_kv_heads=2, scan_layers=request.param)
    jcfg = jax_config("tiny", **over)
    tcfg = get_config("tiny", **over)
    params = JaxGPT(jcfg, decode=True).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1), jnp.int32))["params"]
    tree = jax.tree.map(np.asarray, nn.meta.unbox(params))
    model = GPT(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, tcfg))
    return jcfg, tree, tcfg, model


def test_converter_loads_every_parameter(pair):
    jcfg, tree, tcfg, model = pair
    sd = params_from_jax(tree, tcfg)
    assert set(sd) == set(model.state_dict())
    d, hd = tcfg.d_model, tcfg.head_dim
    assert sd["blocks.1.attn.wk.weight"].shape == (tcfg.n_kv_heads * hd, d)
    assert sd["lm_head.weight"].shape == (tcfg.vocab_size, d)
    assert sum(p.numel() for p in model.parameters()) == tcfg.num_params()


def test_paged_prefill_and_decode_logits_match_jax(pair):
    jcfg, tree, tcfg, model = pair
    max_pages = tcfg.max_seq_len // PS
    jmodel = JaxGPT(jcfg, decode=True, paged_pages=POOL, page_size=PS)
    cache = jax_init_cache(jmodel, 1)
    pools = init_decode_cache(tcfg, POOL, PS, device="cpu")

    # non-contiguous, interleaved physical pages
    bt = np.zeros((2, max_pages), np.int32)
    bt[0] = (np.arange(max_pages) * 2 + 1) % (POOL - 1) + 1
    bt[1] = (np.arange(max_pages) * 2 + 2) % (POOL - 1) + 1
    assert not set(bt[0]) & set(bt[1])
    prompts = [[1, 2, 3], [7, 8, 9, 10, 11]]
    bucket = 8
    toks = np.zeros((2, bucket), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    positions = np.broadcast_to(np.arange(bucket, dtype=np.int32),
                                (2, bucket))

    def step(toks, positions):
        nonlocal cache
        want, mut = jmodel.apply({"params": tree, "cache": cache},
                                 jnp.asarray(toks), jnp.asarray(positions),
                                 block_tables=jnp.asarray(bt),
                                 mutable=["cache"])
        cache = mut["cache"]
        with torch.no_grad():
            got = model(torch.from_numpy(np.array(toks)),
                        torch.from_numpy(np.array(positions)),
                        block_tables=torch.from_numpy(bt), kv_pools=pools)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        return np.asarray(want)

    logits = step(toks, positions)
    tok = np.array([logits[i, len(p) - 1].argmax()
                    for i, p in enumerate(prompts)], np.int32)
    pos = np.array([len(p) for p in prompts], np.int32)
    for _ in range(3):
        logits = step(tok[:, None], pos[:, None])
        tok = logits[:, -1].argmax(-1).astype(np.int32)
        pos = pos + 1

    if tcfg.scan_layers:
        # the scatter layout: every page but scratch page 0 equal
        jpool = np.asarray(cache["blocks"]["attn"]["kv_pages"])
        for i, pool in enumerate(pools):
            np.testing.assert_allclose(pool[1:].numpy(), jpool[i, 1:],
                                       atol=ATOL)


def test_init_weights_distributions():
    cfg = get_config("tiny", n_kv_heads=2)
    model = GPT(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    assert torch.all(model.final_norm.scale == 1)
    assert abs(model.embed.std().item() - 0.02) < 0.002
    w = model.blocks[0].mlp.w_down.weight       # fan_in d_ff
    assert abs(w.std().item() - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
    bound = 2 * cfg.d_ff ** -0.5 / 0.87962566103423978
    assert w.abs().max().item() <= bound + 1e-6


def test_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPT(cfg)
    from ray_tpu_torch.serve.llm_engine import LLMEngine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(cfg, {})
    from ray_tpu_torch.models import (BERT, T5, Encoder, EncoderBlock,
                                      ResNet50, ViT, get_vit_config)
    for build in (lambda: Encoder(cfg), lambda: EncoderBlock(cfg),
                  lambda: BERT(cfg), lambda: T5(cfg),
                  lambda: ViT(get_vit_config("vit-tiny-test")),
                  lambda: ResNet50(num_classes=10)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


@pytest.mark.parametrize("path", ["ring", "ulysses"])
def test_unported_paths_raise_and_name_the_roadmap(path):
    tokens = torch.zeros(1, 4, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GPT(get_config("tiny", attention_impl=path), device="cpu")(tokens)


def test_bf16_compute_over_fp32_params_matches_jax():
    """fp32 masters with bf16 activations: every projection casts its
    weight to bf16 at each call, as flax's DenseGeneral(dtype,
    param_dtype) does.  Paged prefill logits against the JAX model built
    with the same dtype and param_dtype.

    Tolerance atol 0.05: both sides round activations and matmul outputs
    to bf16 (2^-8 relative) at the same places but sum in different
    orders, through two blocks; tiny-model logits are O(1), so a few
    bf16 ulps of them stay well under 0.05, while a layout or cast error
    moves them by O(0.5)."""
    over = dict(n_kv_heads=2, dtype=jnp.bfloat16)
    jcfg = jax_config("tiny", **over)
    tcfg = get_config("tiny", n_kv_heads=2, dtype=torch.bfloat16)
    jmodel = JaxGPT(jcfg, decode=True, paged_pages=POOL, page_size=PS)
    params = jmodel.init(jax.random.PRNGKey(1),
                         jnp.zeros((1, 1), jnp.int32))["params"]
    tree = jax.tree.map(np.asarray, nn.meta.unbox(params))
    model = GPT(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, tcfg))
    assert model.blocks[0].attn.wq.weight.dtype == torch.float32
    assert model.final_norm.scale.dtype == torch.float32

    rng = np.random.default_rng(2)
    toks = rng.integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    bt = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
    want, _ = jmodel.apply({"params": tree,
                            "cache": jax_init_cache(jmodel, 1)},
                           jnp.asarray(toks), jnp.asarray(pos),
                           block_tables=jnp.asarray(bt), mutable=["cache"])
    pools = init_decode_cache(tcfg, POOL, PS, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(toks), torch.from_numpy(np.array(pos)),
                    block_tables=torch.from_numpy(bt), kv_pools=pools)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-2)


@pytest.mark.parametrize("scan", [True, False], ids=["scan", "unrolled"])
def test_converter_maps_the_partial_remat_tail(scan):
    """With remat on and remat_layers strictly between 0 and n_layers the
    JAX model keeps layer 0 under ``blocks`` and layer 1 under
    ``blocks_tail`` (unscanned: ``block_0`` and ``blocks_tai_0``).  The
    converted weights give JAX's training-forward logits at ATOL."""
    over = dict(n_kv_heads=2, scan_layers=scan, remat=True, remat_layers=1)
    jcfg = jax_config("tiny", **over)
    tcfg = get_config("tiny", **over)
    jmodel = JaxGPT(jcfg)
    toks = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 16)).astype(np.int32)
    params = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(toks))["params"]
    tree = jax.tree.map(np.asarray, nn.meta.unbox(params))
    assert ("blocks_tail" if scan else "blocks_tai_0") in tree
    model = GPT(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, tcfg))
    want = jmodel.apply({"params": tree}, jnp.asarray(toks))
    with torch.no_grad():
        got = model(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
