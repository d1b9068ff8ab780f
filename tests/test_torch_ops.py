"""The port's ops (ray_tpu_torch.ops, models.generate sampling) held
against ray_tpu's on the same numpy inputs, on the CPU.

Tolerances: both sides compute in fp32 on the CPU, so differences are
summation-order rounding, ~1e-6 relative.  atol 1e-5 is the gate for the
attention paths (softmax over <= 128 keys of O(1) logits) and 1e-5 for
norm/rope; the sampling masks and greedy ids must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tpu.models.generate import _trim_logits as jax_trim
from ray_tpu.models.generate import sample_logits as jax_sample
from ray_tpu.ops.attention import xla_attention
from ray_tpu.ops.layers import apply_rope as jax_rope
from ray_tpu.ops.layers import rms_norm as jax_rms
from ray_tpu.ops.layers import rope_frequencies as jax_freqs
from ray_tpu.ops.layers import swiglu as jax_swiglu
from ray_tpu.ops.paged_attention import paged_attention_xla
from ray_tpu_torch.models.generate import _trim_logits, sample_logits
from ray_tpu_torch.ops.attention import dense_attention
from ray_tpu_torch.ops.layers import (apply_rope, rms_norm, rope_frequencies,
                                      swiglu)
from ray_tpu_torch.ops.paged_attention import (paged_attention,
                                               paged_attention_cuda,
                                               paged_attention_ref)

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_rms_norm_rope_and_swiglu_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        rms_norm(_t(x), _t(w)).numpy(), np.asarray(jax_rms(x, w)),
        atol=ATOL)
    cos, sin = rope_frequencies(16, 64, 5e5)
    jcos, jsin = jax_freqs(16, 64, 5e5)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=ATOL)
    positions = rng.integers(0, 64, size=(2, 5)).astype(np.int32)
    for pos in (None, positions):
        got = apply_rope(_t(x), cos, sin,
                         None if pos is None else _t(pos))
        want = jax_rope(x, jcos, jsin, None if pos is None else pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    wg, wu = (rng.standard_normal((16, 32)).astype(np.float32) / 4
              for _ in range(2))
    wd = rng.standard_normal((32, 16)).astype(np.float32) / 4
    np.testing.assert_allclose(
        swiglu(_t(x), _t(wg), _t(wu), _t(wd)).numpy(),
        np.asarray(jax_swiglu(x, wg, wu, wd)), atol=ATOL)


@pytest.mark.parametrize("case", ["causal", "q_offset", "bool_mask",
                                  "int_mask", "additive_4d"])
def test_dense_attention_matches_xla_attention(case):
    rng = np.random.default_rng(1)
    b, q_len, kv_len, h, kvh, d = 2, 4, 9, 4, 2, 8
    if case == "causal":
        q_len = kv_len
    q = rng.standard_normal((b, q_len, h, d)).astype(np.float32)
    k = rng.standard_normal((b, kv_len, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, kv_len, kvh, d)).astype(np.float32)
    kw, mask = {}, None
    if case == "causal":
        kw = dict(causal=True)
    elif case == "q_offset":
        kw = dict(causal=True, q_offset=kv_len - q_len)
    elif case == "bool_mask":
        mask = rng.random((b, kv_len)) < 0.7
        mask[:, 0] = True
        kw = dict(causal=False)
    elif case == "int_mask":
        mask = (rng.random((b, kv_len)) < 0.7).astype(np.int32)
        mask[:, 0] = 1
        kw = dict(causal=False)
    else:
        mask = (rng.standard_normal((b, 1, q_len, kv_len)) * 3).astype(
            np.float32)
        kw = dict(causal=False)
    got = dense_attention(_t(q), _t(k), _t(v),
                          mask=None if mask is None else _t(mask), **kw)
    want = xla_attention(q, k, v, mask=mask, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_dense_attention_refuses_2d_float_mask():
    q = torch.zeros(1, 1, 2, 4)
    with pytest.raises(ValueError):
        dense_attention(q, q, q, causal=False, mask=torch.zeros(1, 1))


def _paged_inputs(rng, rows=5, heads=8, kvh=2, hd=16, ps=16, num_pages=24,
                  max_pages=4):
    q = rng.standard_normal((rows, heads, hd)).astype(np.float32)
    kv = rng.standard_normal((num_pages, kvh, ps, 2 * hd)).astype(
        np.float32)
    # shuffled, non-contiguous pages, disjoint across rows
    perm = rng.permutation(np.arange(1, num_pages))[:rows * max_pages]
    tables = perm.reshape(rows, max_pages).astype(np.int32)
    # page edges: 1, ps-1, ps, ps+1, full span
    lengths = np.array([1, ps - 1, ps, ps + 1, ps * max_pages][:rows],
                       np.int32)
    return q, kv, tables, lengths


def test_paged_attention_ref_matches_xla():
    q, kv, tables, lengths = _paged_inputs(np.random.default_rng(2))
    got = paged_attention_ref(_t(q), _t(kv), _t(tables), _t(lengths))
    want = paged_attention_xla(q, kv, tables, lengths)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the dispatcher sends CPU tensors to the plain version
    disp = paged_attention(_t(q), _t(kv), _t(tables), _t(lengths),
                           sm_scale=0.3)
    np.testing.assert_allclose(
        disp.numpy(),
        np.asarray(paged_attention_xla(q, kv, tables, lengths,
                                       sm_scale=0.3)), atol=ATOL)


def test_paged_attention_cuda_refuses_cpu_tensors():
    q, kv, tables, lengths = _paged_inputs(np.random.default_rng(3))
    before = paged_attention_cuda.launches
    with pytest.raises(ValueError):
        paged_attention_cuda(_t(q), _t(kv), _t(tables), _t(lengths))
    assert paged_attention_cuda.launches == before


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.8), (7, 0.5)])
def test_trim_logits_masks_equal_jax(top_k, top_p):
    logits = np.random.default_rng(4).standard_normal((6, 64)).astype(
        np.float32) * 3
    got = torch.isinf(_trim_logits(_t(logits), top_k, top_p)).numpy()
    want = np.isinf(np.asarray(jax_trim(jnp.asarray(logits), top_k, top_p)))
    np.testing.assert_array_equal(got, want)


def test_sample_logits_greedy_equal_and_sampled_inside_mask():
    import jax
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((6, 64)).astype(np.float32)
    logits[0, [3, 9]] = 10.0          # a tie: both take the first index
    temps = np.array([0, 0, 0.7, 0, 1.3, 0], np.float32)
    got = sample_logits(_t(logits), temperature=_t(temps), top_k=5,
                        top_p=0.9, generator=torch.Generator().manual_seed(0))
    want = jax_sample(jax.random.PRNGKey(0), jnp.asarray(logits),
                      temperature=jnp.asarray(temps), top_k=5, top_p=0.9)
    greedy = temps == 0
    np.testing.assert_array_equal(got.numpy()[greedy],
                                  np.asarray(want)[greedy])
    assert got[0] == 3
    kept = ~np.isinf(np.asarray(jax_trim(
        jnp.asarray(logits / np.where(greedy, 1, temps)[:, None]), 5, 0.9)))
    for r in np.flatnonzero(~greedy):
        assert kept[r, int(got[r])]
    scalar = sample_logits(_t(logits), temperature=0.0)
    np.testing.assert_array_equal(scalar.numpy(),
                                  np.argmax(logits, axis=-1))
