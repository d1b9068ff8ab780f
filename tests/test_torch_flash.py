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

The bf16 tensor-core forward (K1 on the card) is emulated here in plain
torch and held against JAX's kernel at the tolerances the card's checks
hold the kernel to against its plain version: o atol 2e-2 (both round o
to bf16, 2^-8 relative), LSE atol 1e-4 (both sum in fp32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.ops.attention import attention as jax_attention
from ray_tpu.ops.flash_attention import _fwd as jax_flash_fwd
from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu_torch.ops.attention import NEG_INF, attention, dense_attention
from ray_tpu_torch.ops.flash_attention import (check_rows_aligned,
                                               flash_attention,
                                               flash_bwd_dkv_cuda,
                                               flash_bwd_dq_cuda,
                                               flash_bwd_ref, flash_fwd_cuda,
                                               flash_fwd_ref)

FWD_ATOL = 2e-5
GRAD_ATOL = 2e-4
BF16_TOL = 2e-2
LSE_TOL = 1e-4
SPLIT_DIFFERING = 0.01
TILE = 64
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


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


def _split_pv(p, v, split: bool = True):
    """P.V as the tensor-core forward computes it: P_hi = bf16(P) and
    P_lo = bf16(P - P_hi), each times the bf16 V, summed in fp32
    (without ``split``, P rounded to bf16 alone)."""
    hi = p.to(torch.bfloat16).float()
    if not split:
        return hi @ v
    lo = (p - hi).to(torch.bfloat16).float()
    return hi @ v + lo @ v


def _tc_fwd_emulated(q, k, v, causal: bool, scale: float,
                     split: bool = True):
    """K1's bf16 tensor-core arithmetic in plain torch (test only), as the
    kernel runs it: bf16 operands with fp32 sums (bf16 products are exact
    in fp32); the online softmax over 64-key tiles in units of log2, with
    the scale applied after the product: masked scores -inf, the running
    max m of the raw products from -inf, the base mc = m * c with
    c = scale * log2(e) (0 while a row has seen no key), the rescale
    2^(mc_old - mc) (0 while the row had seen no key) and P = 2^(s c - mc);
    P.V split in two bf16 terms; LSE = mc ln 2 + log l, -1e30 for a row
    that no key reaches.  [B, S, H, D] / [B, Skv, KVH, D] bf16 ->
    (o bf16, lse fp32 [B, H, S])."""
    b, sq, h, _ = q.shape
    skv, g = k.shape[1], h // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf, vf = (x.float().repeat_interleave(g, 2).transpose(1, 2)
              for x in (k, v))
    c = scale * LOG2E
    m = torch.full((b, h, sq), -torch.inf)
    mc = torch.zeros(b, h, sq)
    l = torch.zeros(b, h, sq)
    acc = torch.zeros(b, h, sq, q.shape[-1])
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, skv, TILE):
        cols = torch.arange(k0, min(k0 + TILE, skv))
        s = qf @ kf[:, :, cols].transpose(-1, -2)
        if causal:
            s = torch.where(cols[None, :] <= rows, s, -torch.inf)
        mx = torch.maximum(m, s.amax(-1))
        mc_new = torch.where(mx == -torch.inf, 0.0, mx * c)
        alpha = torch.where(m == -torch.inf, 0.0, torch.exp2(mc - mc_new))
        p = torch.exp2(s * c - mc_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _split_pv(p, vf[:, :, cols], split)
        m, mc = mx, mc_new
    l = torch.where(l == 0, 1.0, l)
    o = (acc / l[..., None]).transpose(1, 2).to(torch.bfloat16)
    lse = torch.where(m == -torch.inf, NEG_INF, mc * LN2 + torch.log(l))
    return o, lse


def _low_logits(q, k):
    """Every key +1 in every element and every 7th query row -24 in every
    element: those rows' logits all lie near -24 * d * scale, so the max
    of the first tile they see is far below the exponent's range
    (2^(s c) is 0 in fp32 below s c = -149 and 2^(-s c) overflows above
    s c = 128)."""
    q, k = q.copy(), k + 1.0
    q[:, ::7] = -24.0
    return q, k


@pytest.mark.parametrize("b,s,h,kvh,d,causal,low", [
    (2, 128, 2, 2, 64, True, False), (1, 128, 2, 2, 128, True, False),
    (1, 128, 4, 2, 64, True, False), (1, 100, 2, 2, 64, True, False),
    (1, 100, 2, 1, 64, False, False), (1, 128, 2, 2, 64, True, True),
    (1, 128, 4, 2, 128, False, True)],
    ids=["hd64", "hd128", "gqa", "ragged", "ragged_full", "low_logits",
         "low_logits_full_gqa_hd128"])
def test_tc_forward_arithmetic_matches_jax_flash(b, s, h, kvh, d, causal,
                                                 low):
    """The emulation against JAX's _fwd kernel in interpret mode on bf16
    inputs (k and v expanded to q's heads as ops.attention does), o and
    LSE.  S = 100 ends inside the second 64-key tile.  Beside the
    tolerance: at most SPLIT_DIFFERING of the outputs may differ at all,
    a bound that P rounded to bf16 alone fails.  With ``low``, rows whose
    first tile's max logit is far below the exponent's range (where a
    rescale of 2^(0 - m c) would overflow, and inf * 0 give NaN) must
    come out finite, as JAX's and the plain version's do."""
    q, k, v = (x.astype(np.float32) for x in _qkv(5, b, s, h, kvh, d))
    if low:
        q, k = _low_logits(q, k)
    scale = d ** -0.5
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    o, lse = _tc_fwd_emulated(tq, tk, tv, causal, scale)
    if low:
        first = (tq.float().transpose(1, 2) @ tk.float().repeat_interleave(
            h // kvh, 2).permute(0, 2, 3, 1)[..., :TILE]) * scale
        if causal:
            first = first.masked_fill(
                torch.ones(s, TILE, dtype=torch.bool).triu(1), -torch.inf)
        assert (first.amax(-1) * LOG2E < -128).any()

    def to3(x):
        x = np.repeat(x, h // x.shape[2], axis=2)
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d),
                           jnp.bfloat16)

    want_o, want_lse = jax_flash_fwd(to3(q), to3(k), to3(v), causal, scale,
                                     s, s, True)
    want_o = np.asarray(jnp.asarray(want_o, jnp.float32)).reshape(
        b, h, s, d).transpose(0, 2, 1, 3)
    assert o.dtype == torch.bfloat16 and o.shape == (b, s, h, d)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(o.float().numpy(), want_o, atol=BF16_TOL)
    assert (o.float().numpy() != want_o).mean() <= SPLIT_DIFFERING
    o_bf16_p, _ = _tc_fwd_emulated(tq, tk, tv, causal, scale, split=False)
    assert (o_bf16_p.float().numpy() != want_o).mean() > SPLIT_DIFFERING
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse).reshape(
        b, h, s), atol=LSE_TOL)
    ref_o, ref_lse = flash_fwd_ref(tq, tk, tv, causal, scale)
    np.testing.assert_allclose(o.float().numpy(), ref_o.float().numpy(),
                               atol=BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=LSE_TOL)


def test_bf16_forward_row_alignment_rule():
    """The bf16 forwards take views of one fused [B, S, H + 2 KVH, D]
    tensor as they are, and refuse rows that do not start on 16 bytes."""
    fused = torch.zeros(2, 64, 4 + 2 * 2, 64, dtype=torch.bfloat16)
    q, k, v = fused[:, :, :4], fused[:, :, 4:6], fused[:, :, 6:]
    check_rows_aligned("fwd", q=q, k=k, v=v)
    check_rows_aligned("fwd", q=torch.zeros(1, 3, 1, 8, dtype=torch.bfloat16))
    shifted = torch.zeros(2 * 64 * 4 * 64 + 1, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="every row of q must start on 16"):
        check_rows_aligned("fwd", q=shifted.view(2, 64, 4, 64))
    # head_dim 64 cut from rows of 68: the head stride is 136 bytes
    narrow = torch.zeros(2, 64, 4, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="every row of k must start on 16"):
        check_rows_aligned("fwd", q=q, k=narrow, v=v)
    # the same view of fp32 rows is aligned: 272-byte head stride
    check_rows_aligned("fwd", k=torch.zeros(2, 64, 4, 68)[..., :64])
