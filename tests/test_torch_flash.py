"""The port's flash attention (ray_tpu_torch.ops.flash_attention) and the
attention dispatcher, held against ray_tpu's on the same numpy inputs, on
the CPU.  Here the autograd function runs the kernels' plain versions;
the JAX function runs its Pallas kernels in interpret mode, as
tests/test_ops.py runs them.

Tolerances are those of the JAX package's own flash test: forward atol
2e-5 and gradients atol 2e-4.  Both sides compute in fp32; the gap is
summation order (blockwise online softmax against dense scores) over
<= 128 keys of O(1) logits, ~1e-6, and the gradients of sum(o^2) sum
more terms.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.ops.attention import attention as jax_attention
from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu_torch.ops.attention import attention, dense_attention
from ray_tpu_torch.ops.flash_attention import (flash_attention,
                                               flash_bwd_dkv_cuda,
                                               flash_bwd_dq_cuda,
                                               flash_bwd_ref, flash_fwd_cuda,
                                               flash_fwd_ref)

FWD_ATOL = 2e-5
GRAD_ATOL = 2e-4


def _qkv(seed, b, s, h, kvh, d, skv=None):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, d)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, d)).astype(np.float32))


def _torch_fwd_grads(fn, q, k, v):
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = fn(*ts)
    (o ** 2).sum().backward()
    return o.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_fwd_grads(fn, q, k, v):
    o = fn(q, k, v)
    g = jax.grad(lambda *a: (fn(*a) ** 2).sum(), (0, 1, 2))(q, k, v)
    return np.asarray(o), [np.asarray(x) for x in g]


def _assert_match(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=FWD_ATOL)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s", [64, 96])
def test_flash_matches_jax_flash_fwd_bwd(causal, s):
    """S = 96 is not a multiple of the kernels' 64-row tiles; the JAX
    kernel runs both in blocks of 32."""
    q, k, v = _qkv(0, 1, s, 2, 2, 32)
    got = _torch_fwd_grads(
        lambda *a: flash_attention(*a, causal=causal), q, k, v)
    want = _jax_fwd_grads(
        lambda *a: jax_flash(*a, causal=causal, block_q=32, block_k=32),
        q, k, v)
    _assert_match(got, want)


def test_gqa_flash_through_the_dispatcher_matches_jax():
    """8 query heads over 2 kv heads: JAX expands K/V with repeat_kv, the
    port's kernels map the heads; dK/dV sum over each group."""
    q, k, v = _qkv(1, 1, 64, 8, 2, 16)
    got = _torch_fwd_grads(lambda *a: attention(*a, impl="flash"), q, k, v)
    want = _jax_fwd_grads(lambda *a: jax_attention(*a, impl="flash"),
                          q, k, v)
    _assert_match(got, want)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_versions_match_autograd_of_dense_attention(causal):
    """flash_fwd_ref / flash_bwd_ref (P from the LSE, dS = P*(dP-delta))
    against torch autograd through dense_attention, GQA and a ragged
    kv length when not causal."""
    q, k, v = _qkv(2, 2, 40, 4, 2, 16, skv=40 if causal else 56)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    scale = 0.3
    o_ref = dense_attention(q, k, v, causal=causal, sm_scale=scale)
    do = torch.randn(o_ref.shape, generator=torch.Generator().manual_seed(0))
    want = torch.autograd.grad(o_ref, (q, k, v), do)
    o, lse = flash_fwd_ref(q.detach(), k.detach(), v.detach(), causal, scale)
    assert lse.shape == (2, 4, 40) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), o_ref.detach().numpy(),
                               atol=FWD_ATOL)
    got = flash_bwd_ref(q.detach(), k.detach(), v.detach(), o, lse, do,
                        causal, scale)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_ATOL)


def test_dispatcher_rules():
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 2, 16, 4, 2, 8))
    dense = dense_attention(q, k, v, causal=True)
    # auto on CPU tensors is dense_attention; flash's plain version agrees
    torch.testing.assert_close(attention(q, k, v), dense, rtol=0, atol=0)
    torch.testing.assert_close(attention(q, k, v, impl="flash"), dense,
                               rtol=0, atol=FWD_ATOL)
    # a mask sends flash (and splash) to dense_attention
    mask = torch.ones(2, 16, dtype=torch.bool)
    mask[:, 10:] = False
    want = dense_attention(q, k, v, causal=False, mask=mask)
    for impl in ("flash", "splash", "auto"):
        torch.testing.assert_close(
            attention(q, k, v, causal=False, impl=impl, mask=mask), want,
            rtol=0, atol=0)
    for impl in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            attention(q, k, v, impl=impl)
    with pytest.raises(ValueError):
        attention(q, k, v, impl="nope")
    with pytest.raises(ValueError, match="q_len == kv_len"):
        flash_attention(q[:, :8], k, v, causal=True)


def test_cuda_launchers_refuse_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 1, 64, 2, 2, 64))
    lse = torch.zeros(1, 2, 64)
    before = (flash_fwd_cuda.launches, flash_bwd_dq_cuda.launches,
              flash_bwd_dkv_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_cuda(q, k, v, causal=True, sm_scale=0.125)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_dq_cuda(q, k, v, q, lse, lse, causal=True, sm_scale=0.125)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_dkv_cuda(q, k, v, q, lse, lse, causal=True,
                           sm_scale=0.125)
    assert (flash_fwd_cuda.launches, flash_bwd_dq_cuda.launches,
            flash_bwd_dkv_cuda.launches) == before
