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
to bf16, 2^-8 relative), LSE atol 1e-4 (both sum in fp32).  So are the
bf16 tensor-core dK/dV (K3 on the card) and dQ (K2), against JAX's
_bwd: dK, dV and dQ atol 2e-2 (both round them to bf16), and at most
SPLIT_DIFFERING of their elements may differ at all.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.ops.attention import attention as jax_attention
from ray_tpu.ops.flash_attention import _bwd as jax_flash_bwd
from ray_tpu.ops.flash_attention import _fwd as jax_flash_fwd
from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu.ops.paged_attention import paged_attention_xla
from ray_tpu_torch.ops import flash_attention as flash_mod
from ray_tpu_torch.ops import paged_attention as paged_mod
from ray_tpu_torch.ops.attention import NEG_INF, attention, dense_attention
from ray_tpu_torch.ops.flash_attention import (check_rows_aligned,
                                               flash_attention,
                                               flash_bwd_dkv_cuda,
                                               flash_bwd_dkv_ref,
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
    (1, 128, 4, 2, 128, False, True), (1, 128, 2, 2, 256, True, False)],
    ids=["hd64", "hd128", "gqa", "ragged", "ragged_full", "low_logits",
         "low_logits_full_gqa_hd128", "hd256"])
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


def _terms(x, split: bool):
    """x as the tensor-core products take it: hi = bf16(x) and
    lo = bf16(x - hi) with ``split``, else bf16(x) alone."""
    hi = x.to(torch.bfloat16).float()
    return (hi, (x - hi).to(torch.bfloat16).float()) if split else (hi,)


def _tc_dkv_emulated(q, k, v, o, lse, do, causal: bool, scale: float,
                     split: bool = True):
    """K3's bf16 tensor-core arithmetic in plain torch (test only), as the
    kernel runs it: each kv row walks the 64-row q tiles of every query
    head of its group (the tiles before the causal diagonal, which the
    kernel skips, are all masked here and add 0); S^T = K.q^T of the raw
    bf16 q with fp32 sums; P^T = 2^(S^T c - LSE log2 e), c = scale
    log2 e, 0 where masked; dS^T = P^T (dP^T - delta) with
    dP^T = V.dO^T and delta = rowsum(dO o O); dV += P^T dO and
    dK += dS^T q with P^T and dS^T split into hi + lo bf16 terms (without
    ``split``, rounded to bf16 alone), fp32 sums; dK times scale once, the
    group's heads summed in fp32.  [B, S, H, D] / [B, Skv, KVH, D] bf16
    -> (dk, dv) bf16 [B, Skv, KVH, D]."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qf, dof = (x.float().transpose(1, 2) for x in (q, do))
    kf, vf = (x.float().repeat_interleave(g, 2).transpose(1, 2)
              for x in (k, v))
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    lse2 = lse.float() * LOG2E
    c = scale * LOG2E
    dk = torch.zeros(b, h, skv, d)
    dv = torch.zeros(b, h, skv, d)
    kv_rows = torch.arange(skv)[:, None]
    for q0 in range(0, sq, TILE):
        rows = torch.arange(q0, min(q0 + TILE, sq))
        p = torch.exp2(kf @ qf[:, :, rows].transpose(-1, -2) * c
                       - lse2[:, :, None, rows])
        if causal:
            p = torch.where(kv_rows <= rows[None, :], p, 0.0)
        ds = p * (vf @ dof[:, :, rows].transpose(-1, -2)
                  - delta[:, :, None, rows])
        for t in _terms(p, split):
            dv += t @ dof[:, :, rows]
        for t in _terms(ds, split):
            dk += t @ qf[:, :, rows]

    def fold(x):
        return x.view(b, kvh, g, skv, d).sum(2).transpose(1, 2).to(
            torch.bfloat16)
    return fold(dk * scale), fold(dv)


def _jax3(x, h):
    """[B, S, KVH, D] numpy -> [B * H, S, D] bf16, heads expanded."""
    b, s, _, d = x.shape
    x = np.repeat(x, h // x.shape[2], axis=2)
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d),
                       jnp.bfloat16)


BWD_CASES = dict(
    argnames="b,s,h,kvh,d,causal,skv",
    argvalues=[(2, 128, 2, 2, 64, True, None), (1, 128, 2, 2, 128, True, None),
               (1, 128, 4, 2, 64, True, None), (1, 100, 2, 2, 64, True, None),
               (1, 100, 2, 1, 64, False, 160),
               (1, 128, 2, 2, 256, True, None)],
    ids=["hd64", "hd128", "gqa", "ragged", "full_gqa_sq_ne_skv", "hd256"])


@pytest.mark.parametrize(**BWD_CASES)
def test_tc_dkv_arithmetic_matches_jax_flash(b, s, h, kvh, d, causal, skv):
    """The emulation against JAX's _bwd (its _bwd_dkv_kernel) in interpret
    mode on bf16 inputs, from JAX's own forward's o and LSE.  S = 100 ends
    inside the second 64-row tile.  Per query head (k and v expanded, as
    ops.attention expands them for JAX): dK and dV within BF16_TOL, and at
    most SPLIT_DIFFERING of their elements differ at all, a bound that P
    and dS rounded to bf16 alone fail.  With GQA, the group sums against
    JAX's per-head gradients summed in fp32.  The plain version
    flash_bwd_dkv_ref is held to the same outputs."""
    skv = s if skv is None else skv
    q, k, v = _qkv(8, b, s, h, kvh, d, skv)
    do = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    scale = d ** -0.5
    jq, jk, jv, jdo = _jax3(q, h), _jax3(k, h), _jax3(v, h), _jax3(do, h)
    o3, lse3 = jax_flash_fwd(jq, jk, jv, causal, scale, s, skv, True)
    _, dk3, dv3 = jax_flash_bwd(jq, jk, jv, o3, lse3, jdo, causal, scale,
                                s, skv, True)

    def port(x, n):
        return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))
                                ).view(b, h, n, -1)
    o = port(o3, s).transpose(1, 2).to(torch.bfloat16)
    lse = port(lse3, s)[..., 0]
    want_dk, want_dv = (port(x, skv).transpose(1, 2) for x in (dk3, dv3))
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    tk_h, tv_h = (x.repeat_interleave(h // kvh, 2) for x in (tk, tv))

    dk, dv = _tc_dkv_emulated(tq, tk_h, tv_h, o, lse, tdo, causal, scale)
    for got, want in ((dk, want_dk), (dv, want_dv)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert torch.isfinite(got.float()).all()
        np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                                   atol=BF16_TOL)
    share = torch.cat([(dk.float() != want_dk).flatten(),
                       (dv.float() != want_dv).flatten()]).float().mean()
    assert share <= SPLIT_DIFFERING
    dk_r, dv_r = _tc_dkv_emulated(tq, tk_h, tv_h, o, lse, tdo, causal, scale,
                                  split=False)
    share = torch.cat([(dk_r.float() != want_dk).flatten(),
                       (dv_r.float() != want_dv).flatten()]).float().mean()
    assert share > SPLIT_DIFFERING

    g = h // kvh
    want_dk, want_dv = (x.view(b, skv, kvh, g, d).sum(3)
                        for x in (want_dk, want_dv))
    dk, dv = _tc_dkv_emulated(tq, tk, tv, o, lse, tdo, causal, scale)
    ref_dk, ref_dv = flash_bwd_dkv_ref(tq, tk, tv, o, lse, tdo, causal,
                                       scale)
    for got in (dk, dv, ref_dk, ref_dv):
        assert got.shape == (b, skv, kvh, d)
    for got, want in ((dk, want_dk), (dv, want_dv), (ref_dk, want_dk),
                      (ref_dv, want_dv)):
        np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                                   atol=BF16_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_bf16_dkv_wrapper_applies_row_rule_to_dout(monkeypatch, dtype):
    """flash_bwd_dkv_cuda holds bf16 q, k, v and dout to the 16-byte row
    rule before it launches (fp32 keeps the CUDA-core kernel, which reads
    scalars).  The device check and the launch are stubbed out so that
    the rule runs on CPU tensors."""
    launched = []
    monkeypatch.setattr(flash_mod, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(flash_mod, "_launch",
                        lambda *a, **kw: launched.append(a[0]))
    monkeypatch.setattr(flash_bwd_dkv_cuda, "launches", 0)
    q, k, v = (torch.zeros(1, 64, 2, 64, dtype=dtype) for _ in range(3))
    lse = torch.zeros(1, 2, 64)
    shifted = torch.zeros(q.numel() + 1, dtype=dtype)[1:].view(q.shape)
    call = dict(causal=True, sm_scale=0.125)
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError,
                           match="every row of dout must start on 16"):
            flash_bwd_dkv_cuda(q, k, v, shifted, lse, lse, **call)
    else:
        flash_bwd_dkv_cuda(q, k, v, shifted, lse, lse, **call)
    flash_bwd_dkv_cuda(q, k, v, torch.zeros_like(q), lse, lse, **call)
    n = 1 if dtype == torch.bfloat16 else 2
    assert launched == [flash_mod._DKV] * n
    assert flash_bwd_dkv_cuda.launches == n


def _tc_dq_emulated(q, k, v, o, lse, do, causal: bool, scale: float,
                    split: bool = True):
    """K2's bf16 tensor-core arithmetic in plain torch (test only), as the
    kernel runs it: each q row walks the kv columns 16 at a time (the
    tiles past the causal diagonal, which the kernel skips, are all masked
    here and add 0); S = q.K^T of the raw bf16 q with fp32 sums;
    P = 2^(S c - LSE log2 e), c = scale log2 e, 0 where masked;
    dS = P (dP - delta) with dP = dO.V^T and delta = rowsum(dO o O);
    dQ += dS K with dS split into hi + lo bf16 terms (without ``split``,
    rounded to bf16 alone), fp32 sums; dQ times scale once, rounded to
    bf16.  [B, S, H, D] / [B, Skv, KVH, D] bf16 -> dq bf16 [B, S, H, D]."""
    b, sq, h, d = q.shape
    skv, g = k.shape[1], h // k.shape[2]
    qf, dof = (x.float().transpose(1, 2) for x in (q, do))
    kf, vf = (x.float().repeat_interleave(g, 2).transpose(1, 2)
              for x in (k, v))
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]
    lse2 = lse.float()[..., None] * LOG2E
    c = scale * LOG2E
    dq = torch.zeros(b, h, sq, d)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, skv, 16):
        cols = torch.arange(k0, min(k0 + 16, skv))
        p = torch.exp2(qf @ kf[:, :, cols].transpose(-1, -2) * c - lse2)
        if causal:
            p = torch.where(cols[None, :] <= rows, p, 0.0)
        ds = p * (dof @ vf[:, :, cols].transpose(-1, -2) - delta)
        for t in _terms(ds, split):
            dq += t @ kf[:, :, cols]
    return (dq * scale).transpose(1, 2).to(torch.bfloat16)


def _dq_share(got, want, causal: bool) -> float:
    """The share of dQ elements [B, S, H, D] that differ at all, causal
    row 0 left out: it sees key 0 alone, where P = 1 and dP - delta is
    the rounding residue of dO.v0 - rowsum(dO o O) (~1e-8), noise on
    every side."""
    if causal:
        got, want = got[:, 1:], want[:, 1:]
    return float((got.float() != want.float()).float().mean())


@pytest.mark.parametrize(**BWD_CASES)
def test_tc_dq_arithmetic_matches_jax_flash(b, s, h, kvh, d, causal, skv):
    """The emulation against JAX's _bwd (its _bwd_dq_kernel) in interpret
    mode on bf16 inputs, from JAX's own forward's o and LSE (k and v
    expanded to q's heads for JAX; the emulation maps GQA heads as the
    kernel does).  S = 100 ends inside the second 64-row tile.  dQ within
    BF16_TOL, and at most SPLIT_DIFFERING of its elements differ at all
    (causal row 0, noise, left out), a bound that dS rounded to bf16
    alone fails.  The plain version flash_bwd_dq_ref is held to the same
    output."""
    skv = s if skv is None else skv
    q, k, v = _qkv(8, b, s, h, kvh, d, skv)
    do = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    scale = d ** -0.5
    jq, jk, jv, jdo = _jax3(q, h), _jax3(k, h), _jax3(v, h), _jax3(do, h)
    o3, lse3 = jax_flash_fwd(jq, jk, jv, causal, scale, s, skv, True)
    dq3, _, _ = jax_flash_bwd(jq, jk, jv, o3, lse3, jdo, causal, scale,
                              s, skv, True)

    def port(x):
        return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))
                                ).view(b, h, s, -1)
    o = port(o3).transpose(1, 2).to(torch.bfloat16)
    lse = port(lse3)[..., 0]
    want = port(dq3).transpose(1, 2)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))

    dq = _tc_dq_emulated(tq, tk, tv, o, lse, tdo, causal, scale)
    assert dq.dtype == torch.bfloat16 and dq.shape == want.shape
    assert torch.isfinite(dq.float()).all()
    np.testing.assert_allclose(dq.float().numpy(), want.numpy(),
                               atol=BF16_TOL)
    assert _dq_share(dq, want, causal) <= SPLIT_DIFFERING
    dq_r = _tc_dq_emulated(tq, tk, tv, o, lse, tdo, causal, scale,
                           split=False)
    assert _dq_share(dq_r, want, causal) > SPLIT_DIFFERING
    ref = flash_mod.flash_bwd_dq_ref(tq, tk, tv, o, lse, tdo, causal, scale)
    np.testing.assert_allclose(ref.float().numpy(), want.numpy(),
                               atol=BF16_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_bf16_dq_wrapper_applies_row_rule_to_dout(monkeypatch, dtype):
    """flash_bwd_dq_cuda holds bf16 q, k, v and dout to the 16-byte row
    rule before it launches (fp32 keeps the CUDA-core kernel, which reads
    scalars).  The device check and the launch are stubbed out so that
    the rule runs on CPU tensors."""
    launched = []
    monkeypatch.setattr(flash_mod, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(flash_mod, "_launch",
                        lambda *a, **kw: launched.append(a[0]))
    monkeypatch.setattr(flash_bwd_dq_cuda, "launches", 0)
    q, k, v = (torch.zeros(1, 64, 2, 64, dtype=dtype) for _ in range(3))
    lse = torch.zeros(1, 2, 64)
    shifted = torch.zeros(q.numel() + 1, dtype=dtype)[1:].view(q.shape)
    call = dict(causal=True, sm_scale=0.125)
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError,
                           match="every row of dout must start on 16"):
            flash_bwd_dq_cuda(q, k, v, shifted, lse, lse, **call)
    else:
        flash_bwd_dq_cuda(q, k, v, shifted, lse, lse, **call)
    flash_bwd_dq_cuda(q, k, v, torch.zeros_like(q), lse, lse, **call)
    n = 1 if dtype == torch.bfloat16 else 2
    assert launched == [flash_mod._DQ] * n
    assert flash_bwd_dq_cuda.launches == n


@pytest.mark.parametrize("path", ["flash", "paged"])
def test_head_dim_256_is_taken_and_matches_jax(path):
    """gptj-6b's head_dim 256 is among the kernels' head_dims, and the
    plain versions the CPU runs take it against JAX: flash forward and
    the gradients of sum(o^2) (GQA 4/2) against JAX's flash kernels in
    interpret mode, at the fwd/bwd tolerances; paged decode against
    paged_attention_xla at ATOL 1e-5 (fp32, <= 48 keys)."""
    rng = np.random.default_rng(12)
    if path == "flash":
        assert 256 in flash_mod._HEAD_DIMS
        q, k, v = _qkv(12, 1, 64, 4, 2, 256)
        got = _torch_fwd_grads(lambda *a: attention(*a, impl="flash"),
                               q, k, v)
        want = _jax_fwd_grads(lambda *a: jax_attention(*a, impl="flash"),
                              q, k, v)
        _assert_match(got, want)
        return
    assert 256 in paged_mod._HEAD_DIMS
    rows, heads, kvh, hd, ps, max_pages = 3, 4, 2, 256, 16, 3
    q = rng.standard_normal((rows, heads, hd)).astype(np.float32)
    kv = rng.standard_normal((1 + rows * max_pages, kvh, ps, 2 * hd)
                             ).astype(np.float32)
    tables = (1 + rng.permutation(rows * max_pages)).reshape(
        rows, max_pages).astype(np.int32)
    lengths = np.array([1, ps + 1, ps * max_pages], np.int32)
    got = paged_mod.paged_attention_ref(*(torch.from_numpy(x) for x in (
        q, kv, tables, lengths)))
    want = paged_attention_xla(q, kv, tables, lengths)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
