"""The port's splash attention (ray_tpu_torch.ops.splash) held against
ray_tpu's on the same numpy inputs, on the CPU.  Here the autograd
function runs the kernels' plain versions; the JAX side runs JAX's
splash library kernel in interpret mode (``make_splash_mha`` patched to
``interpret=True``), which leaves the JAX package's files as they are.

Tolerances are those of the flash tests.  fp32: forward atol 2e-5 and
gradients atol 2e-4; both sides compute in fp32, and the gap is
summation order (the library's blockwise online softmax against dense
scores) over <= 256 keys of O(1) logits, ~1e-6.  bf16: atol 2e-2 for
the output and the gradients (which reach ~11 here); both sides round
q * scale, the scale itself, the output, P and dS to bf16 at the same
places and sum in fp32, so they differ by summation order only: 4e-3 at
most.  A port that skips any one of those roundings is off by 3e-2 to
6e-2.

The bf16 tensor-core forward (K5-fwd on the card) is emulated here in
plain torch and held against the library kernel at the tolerances the
card's checks hold the kernel to against its plain version: o atol 2e-2,
LSE atol 1e-4.  So are the bf16 tensor-core dK/dV (K5-dKV on the card)
and dQ (K5-dQ), against the library kernel's VJP: dK, dV and dQ atol
2e-2.
"""

import functools

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu.splash_attention import (
    splash_attention_kernel, splash_attention_mask)

from ray_tpu.models.configs import get_config as jax_config
from ray_tpu.models.gpt import GPT as JaxGPT
from ray_tpu.ops.attention import attention as jax_attention
from ray_tpu.parallel import MeshConfig, build_mesh
from ray_tpu.train.step import OptimizerConfig as JaxOptimizerConfig
from ray_tpu.train.step import make_sharded_train
from ray_tpu_torch.models.configs import get_config
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.gpt import GPT
from ray_tpu_torch.ops import splash
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.train.step import OptimizerConfig, make_train

FWD_ATOL = 2e-5
GRAD_ATOL = 2e-4
BF16_TOL = 2e-2
LSE_TOL = 1e-4
SPLIT_DIFFERING = 0.01
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


@pytest.fixture
def interpret(monkeypatch):
    """JAX's splash library kernel in interpret mode, for the CPU."""
    monkeypatch.setattr(
        splash_attention_kernel, "make_splash_mha",
        functools.partial(splash_attention_kernel.make_splash_mha,
                          interpret=True))


def _qkv(seed, b, s, h, kvh, d, skv=None):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, d)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, d)).astype(np.float32))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("b,s,h,kvh,d,skv,causal,dtype", [
    (2, 256, 4, 4, 64, 256, True, "float32"),
    (1, 256, 4, 2, 64, 256, True, "float32"),
    (1, 128, 2, 2, 64, 256, False, "float32"),
    (1, 128, 2, 2, 128, 128, True, "bfloat16"),
    (1, 128, 2, 2, 256, 128, True, "float32")],
    ids=["causal", "gqa", "full", "bf16_hd128", "hd256"])
def test_splash_matches_jax_splash_fwd_bwd(interpret, b, s, h, kvh, d, skv,
                                           causal, dtype):
    """Forward and the gradients of sum(o^2) (cotangent 2o on both
    sides).  At head_dim 128 in bf16 q * scale rounds, and dq is the
    kernel's gradient times the scale in bf16."""
    q, k, v = _qkv(0, b, s, h, kvh, d, skv)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(x, jdt) for x in (q, k, v)]
    want, vjp = jax.vjp(
        lambda *a: jax_attention(*a, causal=causal, impl="splash"), *jargs)
    want_g = vjp(2 * want)
    targs = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    got = attention(*targs, causal=causal, impl="splash")
    got.backward(2 * got.detach())
    assert got.dtype == tdt and got.shape == (b, s, h, d)
    if dtype == "float32":
        tol, gtol = dict(atol=FWD_ATOL), dict(atol=GRAD_ATOL)
    else:
        tol = gtol = dict(atol=BF16_TOL)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    for t, g in zip(targs, want_g):
        assert t.grad.shape == g.shape
        np.testing.assert_allclose(_f32(t.grad), _f32(g), **gtol)


def _reduce(dense: np.ndarray, tile: int) -> np.ndarray:
    """A dense [q, kv] bool mask reduced to tile kinds."""
    q, kv = dense.shape
    blk = dense.reshape(q // tile, tile, kv // tile, tile)
    return np.where(blk.all(axis=(1, 3)), splash.FULL,
                    np.where(blk.any(axis=(1, 3)), splash.PARTIAL,
                             splash.EMPTY))


def _decode(ptr, ent, n):
    """The [rows, n] kind grid that CSR lists describe."""
    grid = np.zeros((len(ptr) - 1, n), np.int8)
    for r in range(len(ptr) - 1):
        cols = ent[ptr[r]:ptr[r + 1]]
        assert np.all(np.diff(cols >> 1) > 0)       # in order
        grid[r, cols >> 1] = np.where(cols & 1, splash.PARTIAL, splash.FULL)
    return grid


def test_mask_table_against_the_dense_mask():
    """Causal 1024 at tile 128: 36 non-empty tiles of 64, 8 partial; full:
    64, all full; at the kernels' tile 64: 136 of 256, 16 partial.  The
    dK/dV lists are the transpose.  Equal head masks share one entry."""
    causal = splash.CausalMask((1024, 1024))
    full = splash.FullMask((1024, 1024))
    dense_causal = np.tril(np.ones((1024, 1024), bool))
    for m, dense in ((causal, dense_causal),
                     (full, np.ones((1024, 1024), bool))):
        for tile in (128, splash.TILE):
            kinds = splash.tile_kinds(m, tile)
            np.testing.assert_array_equal(kinds, _reduce(dense, tile))
    t = splash.mask_table(splash.MultiHeadMask([causal]), 128)
    assert (t.visited, t.partial, t.dense) == (36, 8, 64)
    t = splash.mask_table(splash.MultiHeadMask([full]), 128)
    assert (t.visited, t.partial, t.dense) == (64, 0, 64)
    t = splash.mask_table(splash.make_mask(12, 1024, 1024, True))
    assert (t.visited, t.partial, t.dense) == (12 * 136, 12 * 16, 12 * 256)

    mh = splash.MultiHeadMask([causal, full, causal])
    t = splash.mask_table(mh, 128)
    np.testing.assert_array_equal(t.head_map, [0, 1, 0])
    assert len(t.kinds) == 2
    assert (t.visited, t.partial) == (36 + 64 + 36, 16)
    for u, dense in enumerate((dense_causal, np.ones((1024, 1024), bool))):
        want = _reduce(dense, 128)
        np.testing.assert_array_equal(
            _decode(t.row_ptr[u], t.row_ent, 8), want)
        np.testing.assert_array_equal(
            _decode(t.col_ptr[u], t.col_ent, 8), want.T)
    assert splash.mask_table(splash.MultiHeadMask([causal, full, causal]),
                             128) is t           # built once, then cached


def test_both_packages_refuse_the_same_shapes(interpret):
    q, k, v = _qkv(1, 1, 128, 2, 2, 64, skv=256)
    with pytest.raises(ValueError, match="q_len == kv_len"):
        jax_attention(q, k, v, causal=True, impl="splash")
    with pytest.raises(ValueError, match="q_len == kv_len"):
        attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                  impl="splash")
    q, k, v = _qkv(2, 1, 64, 2, 2, 64)
    with pytest.raises(ValueError, match="should divide q_seq_len=64"):
        jax_attention(q, k, v, causal=True, impl="splash")
    with pytest.raises(ValueError, match="should divide q_seq_len=64"):
        attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                  impl="splash")
    q, k, v = _qkv(3, 1, 128, 2, 2, 64, skv=192)
    with pytest.raises(ValueError, match="should divide kv_seq_len=192"):
        jax_attention(q, k, v, causal=False, impl="splash")
    with pytest.raises(ValueError, match="should divide kv_seq_len=192"):
        attention(*map(torch.from_numpy, (q, k, v)), causal=False,
                  impl="splash")


def test_cuda_launchers_refuse_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 1, 128, 2, 2, 64))
    mask = splash.make_mask(2, 128, 128, True)
    lse = torch.zeros(1, 2, 128)
    launchers = (splash.splash_fwd_cuda, splash.splash_bwd_dq_cuda,
                 splash.splash_bwd_dkv_cuda)
    before = [fn.launches for fn in launchers]
    with pytest.raises(ValueError, match="CUDA"):
        splash.splash_fwd_cuda(q, k, v, mask, sm_scale=0.125)
    with pytest.raises(ValueError, match="CUDA"):
        splash.splash_bwd_dq_cuda(q, k, v, q, lse, lse, mask, sm_scale=0.125)
    with pytest.raises(ValueError, match="CUDA"):
        splash.splash_bwd_dkv_cuda(q, k, v, q, lse, lse, mask,
                                   sm_scale=0.125)
    assert [fn.launches for fn in launchers] == before


def test_gpt_and_train_step_with_splash_match_jax(interpret):
    """tiny at max_seq_len 128 with attention_impl="splash" (GQA 4/2):
    the port's logits and one make_train step (loss, grad_norm) against
    JAX's GPT and make_sharded_train from the same weights.  Both run
    fp32; the gaps are summation order, as in the flash tests."""
    over = dict(n_kv_heads=2, max_seq_len=128, attention_impl="splash")
    jcfg, tcfg = jax_config("tiny", **over), get_config("tiny", **over)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 129)).astype(np.int32)
    batch = {"tokens": tokens}
    jbatch = {"tokens": jnp.asarray(tokens)}
    opt = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=10)
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jmodel = JaxGPT(jcfg, mesh=mesh)
    init_fn, step_fn, _, _ = make_sharded_train(
        jmodel, mesh, JaxOptimizerConfig(**opt), example_batch=jbatch)
    state = init_fn(jax.random.PRNGKey(0), jbatch)
    params = jax.tree.map(np.asarray, nn.meta.unbox(state.params))
    want_logits = jmodel.apply({"params": params}, tokens[:, :-1])

    model = GPT(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, tcfg))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens[:, :-1]).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=FWD_ATOL)

    _, m = step_fn(state, jbatch)
    tinit, tstep = make_train(model, OptimizerConfig(**opt))
    _, tm = tstep(tinit(), batch)
    np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(m["grad_norm"]),
                               rtol=1e-5)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_remat_recomputes_the_splash_forward_once_per_layer(monkeypatch,
                                                            remat):
    """Per-block torch.utils.checkpoint reruns the splash forward once per
    layer in the backward, as it reruns K1; the backward runs once."""
    calls = {"fwd": 0, "bwd": 0}

    def counted(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(splash, "splash_fwd_ref",
                        counted("fwd", splash.splash_fwd_ref))
    monkeypatch.setattr(splash, "splash_bwd_ref",
                        counted("bwd", splash.splash_bwd_ref))
    cfg = get_config("tiny", attention_impl="splash", remat=remat)
    model = GPT(cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (1, 128)))
    model(tokens).float().square().mean().backward()
    assert calls == {"fwd": cfg.n_layers * (2 if remat else 1),
                     "bwd": cfg.n_layers}


def _tc_fwd_emulated(q, k, v, causal: bool, scale: float,
                     split: bool = True):
    """K5-fwd's bf16 tensor-core arithmetic in plain torch (test only), as
    the kernel runs it: q_s = bf16(q * bf16(scale)); bf16 operands with
    fp32 sums; the online softmax over 64-key tiles in units of log2:
    masked scores -inf (a tile the table skips is all masked here, and
    adds nothing), the running max m of the products from -inf, the base
    mc = m * log2(e) (0 while a row has seen no key), the rescale
    2^(mc_old - mc) (0 while the row had seen no key) and
    P = 2^(s log2(e) - mc); P.V as P_hi.V + P_lo.V with P_hi = bf16(P)
    and P_lo = bf16(P - P_hi) (without ``split``, P rounded to bf16
    alone); LSE = mc ln 2 + log l, MASK_VALUE for a row that no key
    reaches.  -> (o bf16, lse fp32 [B, H, S])."""
    b, sq, h, _ = q.shape
    skv, g = k.shape[1], h // k.shape[2]
    qs = (q * splash.dtype_scale(scale, q.dtype)).float().transpose(1, 2)
    kf, vf = (x.float().repeat_interleave(g, 2).transpose(1, 2)
              for x in (k, v))
    m = torch.full((b, h, sq), -torch.inf)
    mc = torch.zeros(b, h, sq)
    l = torch.zeros(b, h, sq)
    acc = torch.zeros(b, h, sq, q.shape[-1])
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, skv, splash.TILE):
        cols = torch.arange(k0, k0 + splash.TILE)
        s = qs @ kf[:, :, cols].transpose(-1, -2)
        if causal:
            s = torch.where(cols[None, :] <= rows, s, -torch.inf)
        mx = torch.maximum(m, s.amax(-1))
        mc_new = torch.where(mx == -torch.inf, 0.0, mx * LOG2E)
        alpha = torch.where(m == -torch.inf, 0.0, torch.exp2(mc - mc_new))
        p = torch.exp2(s * LOG2E - mc_new[..., None])
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float() if split else 0 * hi
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + hi @ vf[:, :, cols] \
            + lo @ vf[:, :, cols]
        m, mc = mx, mc_new
    l = torch.where(l == 0, 1.0, l)
    o = (acc / l[..., None]).transpose(1, 2).to(torch.bfloat16)
    lse = torch.where(m == -torch.inf, splash.MASK_VALUE,
                      mc * LN2 + torch.log(l))
    return o, lse


@pytest.mark.parametrize("b,s,h,kvh,d,skv,causal,low", [
    (2, 256, 2, 2, 64, 256, True, False),
    (1, 128, 2, 2, 128, 128, True, False),
    (1, 256, 4, 2, 64, 256, True, False),
    (1, 128, 2, 2, 64, 256, False, False),
    (1, 128, 2, 2, 64, 128, True, True),
    (1, 128, 4, 2, 128, 256, False, True),
    (1, 128, 2, 2, 256, 128, True, False)],
    ids=["hd64", "hd128", "gqa", "full", "low_logits",
         "low_logits_full_gqa_hd128", "hd256"])
def test_tc_forward_arithmetic_matches_jax_splash(interpret, b, s, h, kvh,
                                                  d, skv, causal, low):
    """The emulation against the library kernel in interpret mode
    (``save_residuals=True`` for its LSE) on bf16 inputs, fed as
    ray_tpu/ops/splash.py feeds it: q * scale in bf16, [H, S, D] per
    example, k and v expanded to q's heads.  Beside the tolerance: at
    most SPLIT_DIFFERING of the outputs may differ at all, a bound that P
    rounded to bf16 alone fails.  The plain version splash_fwd_ref is
    held to the same outputs.  With ``low``, every key is +1 in every
    element and every 7th query row -24 in every element, so those rows'
    first tile has its max logit far below the exponent's range (where a
    rescale of 2^(0 - m log2 e) would overflow, and inf * 0 give NaN):
    they must come out finite, as the library's and the plain version's
    do."""
    q, k, v = _qkv(7, b, s, h, kvh, d, skv)
    if low:
        k = k + 1.0
        q[:, ::7] = -24.0
    scale = d ** -0.5
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    o, lse = _tc_fwd_emulated(tq, tk, tv, causal, scale)
    if low:
        first = torch.einsum(
            "bqhd,bkhd->bhqk", (tq * splash.dtype_scale(scale, tq.dtype))
            .float(), tk.float().repeat_interleave(h // kvh, 2)
            [:, :splash.TILE])
        if causal:
            first = first.masked_fill(torch.ones(
                s, splash.TILE, dtype=torch.bool).triu(1), -torch.inf)
        assert (first.amax(-1) * LOG2E < -128).any()

    kind = splash_attention_mask.CausalMask if causal else \
        splash_attention_mask.FullMask
    kernel = splash_attention_kernel.make_splash_mha(
        mask=splash_attention_mask.MultiHeadMask([kind((s, skv))] * h),
        head_shards=1, q_seq_shards=1, save_residuals=True)
    jq, jk, jv = (jnp.asarray(np.repeat(x, h // x.shape[2], axis=2),
                              jnp.bfloat16).transpose(0, 2, 1, 3)
                  for x in (q, k, v))
    want_o, (want_lse,) = jax.vmap(kernel)(jq * scale, jk, jv)
    want_o = _f32(want_o).transpose(0, 2, 1, 3)
    assert o.dtype == torch.bfloat16 and o.shape == (b, s, h, d)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(_f32(o), want_o, atol=BF16_TOL)
    assert (_f32(o) != want_o).mean() <= SPLIT_DIFFERING
    o_bf16_p, _ = _tc_fwd_emulated(tq, tk, tv, causal, scale, split=False)
    assert (_f32(o_bf16_p) != want_o).mean() > SPLIT_DIFFERING
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=LSE_TOL)
    ref_o, ref_lse = splash.splash_fwd_ref(
        tq, tk, tv, splash.make_mask(h, s, skv, causal), scale)
    np.testing.assert_allclose(_f32(ref_o), want_o, atol=BF16_TOL)
    np.testing.assert_allclose(ref_lse.numpy(), np.asarray(want_lse),
                               atol=LSE_TOL)


def _tc_dkv_emulated(q, k, v, o, lse, do, causal: bool, scale: float,
                     rounded: bool = True):
    """K5-dKV's bf16 tensor-core arithmetic in plain torch (test only), as
    the kernel runs it: q_s = bf16(q * bf16(scale)); each kv row walks the
    64-row q tiles of every query head of its group (tiles the table
    skips are all masked here and add 0); S^T = K.q_s^T with fp32 sums;
    P^T = 2^(S^T log2 e - LSE log2 e), 0 where masked;
    dS^T = P^T (dP^T - delta) with dP^T = V.dO^T and
    delta = rowsum(dO o O); dV += bf16(P^T) dO and dK += bf16(dS^T) q_s
    (without ``rounded``, P^T and dS^T in fp32), fp32 sums, the group's
    heads summed in fp32.  [B, S, H, D] / [B, Skv, KVH, D] bf16 ->
    (dk, dv) bf16 [B, Skv, KVH, D]."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qs = (q * splash.dtype_scale(scale, q.dtype)).float().transpose(1, 2)
    dof = do.float().transpose(1, 2)
    kf, vf = (x.float().repeat_interleave(g, 2).transpose(1, 2)
              for x in (k, v))
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    lse2 = lse.float() * LOG2E
    dk = torch.zeros(b, h, skv, d)
    dv = torch.zeros(b, h, skv, d)
    kv_rows = torch.arange(skv)[:, None]

    def r(x):
        return x.to(torch.bfloat16).float() if rounded else x
    for q0 in range(0, sq, splash.TILE):
        rows = torch.arange(q0, q0 + splash.TILE)
        p = torch.exp2(kf @ qs[:, :, rows].transpose(-1, -2) * LOG2E
                       - lse2[:, :, None, rows])
        if causal:
            p = torch.where(kv_rows <= rows[None, :], p, 0.0)
        ds = p * (vf @ dof[:, :, rows].transpose(-1, -2)
                  - delta[:, :, None, rows])
        dv += r(p) @ dof[:, :, rows]
        dk += r(ds) @ qs[:, :, rows]

    def fold(x):
        return x.view(b, kvh, g, skv, d).sum(2).transpose(1, 2).to(
            torch.bfloat16)
    return fold(dk), fold(dv)


BWD_CASES = dict(
    argnames="b,s,h,kvh,d,skv,causal",
    argvalues=[(2, 256, 2, 2, 64, 256, True), (1, 128, 2, 2, 128, 128, True),
               (1, 256, 4, 2, 64, 256, True), (1, 128, 2, 1, 64, 256, False),
               (1, 128, 2, 2, 256, 128, True)],
    ids=["hd64", "hd128", "gqa", "full_gqa", "hd256"])


@pytest.mark.parametrize(**BWD_CASES)
def test_tc_dkv_arithmetic_matches_jax_splash(interpret, b, s, h, kvh, d,
                                              skv, causal):
    """The emulation against the library kernel's VJP in interpret mode on
    bf16 inputs, fed as ray_tpu/ops/splash.py feeds it (q * scale in
    bf16, [H, S, D] per example, k and v expanded to q's heads), from the
    library's own forward's o and LSE.  Per query head: dK and dV within
    BF16_TOL, and at most SPLIT_DIFFERING of their elements differ at
    all, a bound that P and dS kept in fp32 fail (the library rounds
    them).  With GQA, the group sums against the library's per-head
    gradients summed in fp32.  The plain version splash_bwd_dkv_ref is
    held to the same outputs."""
    q, k, v = _qkv(10, b, s, h, kvh, d, skv)
    do = np.random.default_rng(11).standard_normal(q.shape).astype(
        np.float32)
    scale = d ** -0.5
    kind = splash_attention_mask.CausalMask if causal else \
        splash_attention_mask.FullMask
    mask = splash_attention_mask.MultiHeadMask([kind((s, skv))] * h)
    with_lse = splash_attention_kernel.make_splash_mha(
        mask=mask, head_shards=1, q_seq_shards=1, save_residuals=True)
    kernel = splash_attention_kernel.make_splash_mha(
        mask=mask, head_shards=1, q_seq_shards=1)
    jq, jk, jv, jdo = (jnp.asarray(np.repeat(x, h // x.shape[2], axis=2),
                                   jnp.bfloat16).transpose(0, 2, 1, 3)
                       for x in (q, k, v, do))
    jo, (jlse,) = jax.vmap(with_lse)(jq * scale, jk, jv)
    _, vjp = jax.vjp(jax.vmap(kernel), jq * scale, jk, jv)
    _, jdk, jdv = vjp(jdo)
    o = torch.tensor(_f32(jo).transpose(0, 2, 1, 3)).to(torch.bfloat16)
    lse = torch.tensor(_f32(jlse))
    want_dk, want_dv = (torch.tensor(_f32(x).transpose(0, 2, 1, 3))
                        for x in (jdk, jdv))
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    tk_h, tv_h = (x.repeat_interleave(h // kvh, 2) for x in (tk, tv))

    def share(dk, dv):
        return float(torch.cat([(dk.float() != want_dk).flatten(),
                                (dv.float() != want_dv).flatten()])
                     .float().mean())
    dk, dv = _tc_dkv_emulated(tq, tk_h, tv_h, o, lse, tdo, causal, scale)
    for got, want in ((dk, want_dk), (dv, want_dv)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert torch.isfinite(got.float()).all()
        np.testing.assert_allclose(_f32(got), want.numpy(), atol=BF16_TOL)
    assert share(dk, dv) <= SPLIT_DIFFERING
    assert share(*_tc_dkv_emulated(tq, tk_h, tv_h, o, lse, tdo, causal,
                                   scale, rounded=False)) > SPLIT_DIFFERING

    g = h // kvh
    want_dk, want_dv = (x.view(b, skv, kvh, g, d).sum(3)
                        for x in (want_dk, want_dv))
    dk, dv = _tc_dkv_emulated(tq, tk, tv, o, lse, tdo, causal, scale)
    ref_dk, ref_dv = splash.splash_bwd_dkv_ref(
        tq, tk, tv, o, lse, tdo, splash.make_mask(h, s, skv, causal), scale)
    for got in (dk, dv, ref_dk, ref_dv):
        assert got.shape == (b, skv, kvh, d)
    for got, want in ((dk, want_dk), (dv, want_dv), (ref_dk, want_dk),
                      (ref_dv, want_dv)):
        np.testing.assert_allclose(_f32(got), want.numpy(), atol=BF16_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_bf16_dkv_wrapper_applies_row_rule_to_dout(monkeypatch, dtype):
    """splash_bwd_dkv_cuda holds bf16 q, k, v and dout to the 16-byte row
    rule before it launches (fp32 keeps the CUDA-core kernel).  The
    device check and the launch are stubbed out so that the rule runs on
    CPU tensors."""
    launched = []
    monkeypatch.setattr(splash, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(splash, "_launch",
                        lambda *a, **kw: launched.append(a[0]))
    monkeypatch.setattr(splash.splash_bwd_dkv_cuda, "launches", 0)
    q, k, v = (torch.zeros(1, 128, 2, 64, dtype=dtype) for _ in range(3))
    lse = torch.zeros(1, 2, 128)
    mask = splash.make_mask(2, 128, 128, True)
    shifted = torch.zeros(q.numel() + 1, dtype=dtype)[1:].view(q.shape)
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError,
                           match="every row of dout must start on 16"):
            splash.splash_bwd_dkv_cuda(q, k, v, shifted, lse, lse, mask,
                                       sm_scale=0.125)
    else:
        splash.splash_bwd_dkv_cuda(q, k, v, shifted, lse, lse, mask,
                                   sm_scale=0.125)
    splash.splash_bwd_dkv_cuda(q, k, v, torch.zeros_like(q), lse, lse, mask,
                               sm_scale=0.125)
    n = 1 if dtype == torch.bfloat16 else 2
    assert launched == [splash._DKV] * n
    assert splash.splash_bwd_dkv_cuda.launches == n


def _tc_dq_emulated(q, k, v, o, lse, do, causal: bool, scale: float,
                    rounded: bool = True):
    """K5-dQ's bf16 tensor-core arithmetic in plain torch (test only), as
    the kernel runs it: q_s = bf16(q * bf16(scale)); each q row walks the
    kv columns 16 at a time (tiles the table skips are all masked here
    and add 0); S = q_s.K^T with fp32 sums; P = 2^(S log2 e - LSE log2 e),
    0 where masked; dS = P (dP - delta) with dP = dO.V^T and
    delta = rowsum(dO o O); dQ_s += bf16(dS) K (without ``rounded``, dS in
    fp32), fp32 sums; dq = bf16(bf16(dQ_s) * bf16(scale)).
    [B, S, H, D] / [B, Skv, KVH, D] bf16 -> dq bf16 [B, S, H, D]."""
    b, sq, h, d = q.shape
    skv, g = k.shape[1], h // k.shape[2]
    sc = splash.dtype_scale(scale, q.dtype)
    qs = (q * sc).float().transpose(1, 2)
    dof = do.float().transpose(1, 2)
    kf, vf = (x.float().repeat_interleave(g, 2).transpose(1, 2)
              for x in (k, v))
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]
    lse2 = lse.float()[..., None] * LOG2E
    dq = torch.zeros(b, h, sq, d)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, skv, 16):
        cols = torch.arange(k0, k0 + 16)
        p = torch.exp2(qs @ kf[:, :, cols].transpose(-1, -2) * LOG2E - lse2)
        if causal:
            p = torch.where(cols[None, :] <= rows, p, 0.0)
        ds = p * (dof @ vf[:, :, cols].transpose(-1, -2) - delta)
        if rounded:
            ds = ds.to(torch.bfloat16).float()
        dq += ds @ kf[:, :, cols]
    return (dq.to(torch.bfloat16) * sc).transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize(**BWD_CASES)
def test_tc_dq_arithmetic_matches_jax_splash(interpret, b, s, h, kvh, d,
                                             skv, causal):
    """The emulation against the library kernel's VJP in interpret mode on
    bf16 inputs, fed as ray_tpu/ops/splash.py feeds it (q * scale in
    bf16, [H, S, D] per example, k and v expanded to q's heads), from the
    library's own forward's o and LSE; JAX's VJP of q * scale takes the
    library's dq_s to dq = bf16(dq_s * scale).  dQ within BF16_TOL; the
    share of its elements that differ at all (causal row 0, noise on
    every side, left out) is reported and at most SPLIT_DIFFERING, a
    bound that dS kept in fp32 fails (the library rounds it).  The plain
    version splash_bwd_dq_ref is held to the same output."""
    q, k, v = _qkv(13, b, s, h, kvh, d, skv)
    do = np.random.default_rng(14).standard_normal(q.shape).astype(
        np.float32)
    scale = d ** -0.5
    kind = splash_attention_mask.CausalMask if causal else \
        splash_attention_mask.FullMask
    mask = splash_attention_mask.MultiHeadMask([kind((s, skv))] * h)
    with_lse = splash_attention_kernel.make_splash_mha(
        mask=mask, head_shards=1, q_seq_shards=1, save_residuals=True)
    kernel = splash_attention_kernel.make_splash_mha(
        mask=mask, head_shards=1, q_seq_shards=1)
    jq, jk, jv, jdo = (jnp.asarray(np.repeat(x, h // x.shape[2], axis=2),
                                   jnp.bfloat16).transpose(0, 2, 1, 3)
                       for x in (q, k, v, do))
    jo, (jlse,) = jax.vmap(with_lse)(jq * scale, jk, jv)
    _, vjp = jax.vjp(lambda a, b_, c: jax.vmap(kernel)(a * scale, b_, c),
                     jq, jk, jv)
    jdq = vjp(jdo)[0]
    o = torch.tensor(_f32(jo).transpose(0, 2, 1, 3)).to(torch.bfloat16)
    lse = torch.tensor(_f32(jlse))
    want = torch.tensor(_f32(jdq).transpose(0, 2, 1, 3))
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))

    def share(dq):
        got, ref = (dq[:, 1:], want[:, 1:]) if causal else (dq, want)
        return float((got.float() != ref).float().mean())
    dq = _tc_dq_emulated(tq, tk, tv, o, lse, tdo, causal, scale)
    assert dq.dtype == torch.bfloat16 and dq.shape == want.shape
    assert torch.isfinite(dq.float()).all()
    np.testing.assert_allclose(_f32(dq), want.numpy(), atol=BF16_TOL)
    print(f"K5-dQ emulation: {share(dq):.4%} of dQ differs from the "
          "library's")
    assert share(dq) <= SPLIT_DIFFERING
    assert share(_tc_dq_emulated(tq, tk, tv, o, lse, tdo, causal, scale,
                                 rounded=False)) > SPLIT_DIFFERING
    ref = splash.splash_bwd_dq_ref(tq, tk, tv, o, lse, tdo,
                                   splash.make_mask(h, s, skv, causal), scale)
    np.testing.assert_allclose(_f32(ref), want.numpy(), atol=BF16_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_bf16_dq_wrapper_applies_row_rule_to_dout(monkeypatch, dtype):
    """splash_bwd_dq_cuda holds bf16 q, k, v and dout to the 16-byte row
    rule before it launches (fp32 keeps the CUDA-core kernel).  The
    device check and the launch are stubbed out so that the rule runs on
    CPU tensors."""
    launched = []
    monkeypatch.setattr(splash, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(splash, "_launch",
                        lambda *a, **kw: launched.append(a[0]))
    monkeypatch.setattr(splash.splash_bwd_dq_cuda, "launches", 0)
    q, k, v = (torch.zeros(1, 128, 2, 64, dtype=dtype) for _ in range(3))
    lse = torch.zeros(1, 2, 128)
    mask = splash.make_mask(2, 128, 128, True)
    shifted = torch.zeros(q.numel() + 1, dtype=dtype)[1:].view(q.shape)
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError,
                           match="every row of dout must start on 16"):
            splash.splash_bwd_dq_cuda(q, k, v, shifted, lse, lse, mask,
                                      sm_scale=0.125)
    else:
        splash.splash_bwd_dq_cuda(q, k, v, shifted, lse, lse, mask,
                                  sm_scale=0.125)
    splash.splash_bwd_dq_cuda(q, k, v, torch.zeros_like(q), lse, lse, mask,
                              sm_scale=0.125)
    n = 1 if dtype == torch.bfloat16 else 2
    assert launched == [splash._DQ] * n
    assert splash.splash_bwd_dq_cuda.launches == n
