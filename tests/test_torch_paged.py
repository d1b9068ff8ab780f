"""The arithmetic of the port's paged decode kernel (K4,
ray_tpu_torch/csrc/paged_attention.cu), emulated in plain torch and held
against JAX's own Pallas kernel ``_tpu_kernel`` run in TPU interpret mode
on the CPU, on the same numpy inputs in bf16.

The kernel keeps ``_tpu_kernel``'s fp32 arithmetic: bf16 products exact in
fp32 and summed in fp32, the scale on the fp32 scores, P kept to ~16 bits
as two bf16 terms.  Both round the output to bf16, so they may differ by
one bf16 ulp where the two fp32 values straddle a rounding boundary: atol
2e-2 (the card's tolerance for the kernel), and at most DIFFERING of the
bf16 outputs may differ at all.  P rounded to bf16 alone (the probe,
printed beside the share) changes more of them than that bound allows.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ray_tpu.ops.paged_attention import paged_attention_tpu
from ray_tpu_torch.ops.paged_attention import (CHUNK, HEADS_PER_BLOCK,
                                               paged_attention_ref, splits)

BF16_TOL = 2e-2
DIFFERING = 0.01
LOG2E = 1.4426950408889634
WARPS = 4                     # each owns 16 positions of a chunk
# blocks an H100 holds at once at head_dim 128 (132 SMs x 2), for the
# split count
RESIDENT = 264


def _terms(p, split: bool):
    """P as the kernel's A fragments: bf16(P) and bf16(P - bf16(P)), or
    bf16(P) alone."""
    hi = p.to(torch.bfloat16).float()
    return (hi, (p - hi).to(torch.bfloat16).float()) if split else (hi,)


def _tc_paged_emulated(q, kv, tables, lengths, scale: float,
                       resident: int = RESIDENT, split: bool = True):
    """K4's arithmetic in plain torch (test only), in the kernel's order:
    a row's table span in 64-position chunks, the chunks in splits of
    ``splits(resident, ...)``, each warp of a split owning 16 positions of every
    chunk.  Per warp an online softmax in units of log2: raw scores q.k
    from bf16 operands summed in fp32, positions past the length -inf, the
    running max m from -inf, the base mc = m * c with c = scale * log2(e)
    (0 while no key has been seen), the rescale 2^(mc_old - mc) (0 then),
    P = 2^(s c - mc), P.V as bf16 terms of P times the bf16 V.  Then the
    warps merge, then the splits (weights 2^(mc - max mc), 0 for a part
    that saw no key), and out = acc / max(l, 1e-30) in bf16."""
    rows, heads, hd = q.shape
    _, kvh, ps, _ = kv.shape
    g = heads // kvh
    max_pages = tables.shape[1]
    groups = rows * kvh * -(-g // HEADS_PER_BLOCK)
    per, n_split = splits(resident, groups, max_pages * ps)
    span = n_split * per * CHUNK
    kvg = kv[tables.long()].movedim(2, 3).reshape(
        rows, max_pages * ps, kvh, 2 * hd).float()
    kvg = torch.cat([kvg, kvg.new_zeros(rows, span - max_pages * ps, kvh,
                                        2 * hd)], 1)
    # [rows, kvh, split, chunk, warp, 16, hd]
    k, v = (x.permute(0, 2, 1, 3).reshape(rows, kvh, n_split, per, WARPS,
                                          16, hd)
            for x in (kvg[..., :hd], kvg[..., hd:]))
    qf = q.float().reshape(rows, kvh, g, hd)
    s_raw = torch.einsum("rkgd,rkzjwpd->rkgzjwp", qf, k)
    pos = torch.arange(span).reshape(n_split, per, WARPS, 16)
    valid = pos[None] < lengths.reshape(rows, 1, 1, 1, 1)
    s_raw = torch.where(valid[:, None, None], s_raw, -torch.inf)
    c = scale * LOG2E
    shape = (rows, kvh, g, n_split, WARPS)
    m = torch.full(shape, -torch.inf)
    mc = torch.zeros(shape)
    l = torch.zeros(shape)
    acc = torch.zeros(*shape, hd)
    for j in range(per):
        s = s_raw[:, :, :, :, j]
        mx = torch.maximum(m, s.amax(-1))
        mc_new = torch.where(mx == -torch.inf, 0.0, mx * c)
        alpha = torch.where(m == -torch.inf, 0.0, torch.exp2(mc - mc_new))
        p = torch.exp2(s * c - mc_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = sum(torch.einsum("rkgzwp,rkzwpd->rkgzwd", t, v[:, :, :, j])
                 for t in _terms(p, split))
        acc = acc * alpha[..., None] + pv
        m, mc = mx, mc_new

    def merge(mc, l, acc):
        top = mc.amax(-1, keepdim=True)
        wt = torch.where(mc == -torch.inf, 0.0, torch.exp2(mc - top))
        top = top[..., 0]
        return top, (l * wt).sum(-1), (acc * wt[..., None]).sum(-2)

    mc, l, acc = merge(torch.where(m == -torch.inf, -torch.inf, mc), l, acc)
    _, l, acc = merge(mc, l, acc)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(rows, heads, hd).to(torch.bfloat16)


def _inputs(seed, rows, heads, kvh, hd, ps, max_pages, lengths):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((rows, heads, hd)).astype(np.float32)
    kv = rng.standard_normal((1 + rows * max_pages, kvh, ps, 2 * hd)
                             ).astype(np.float32)
    tables = (1 + rng.permutation(rows * max_pages)).reshape(
        rows, max_pages).astype(np.int32)
    return q, kv, tables, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("rows,heads,kvh,hd,ps,max_pages,lengths,resident", [
    (3, 4, 4, 64, 16, 8, [1, 16, 128], RESIDENT),
    (3, 4, 4, 64, 16, 8, [1, 17, 128], 1),
    (4, 8, 2, 128, 64, 4, [1, 64, 65, 256], RESIDENT),
    (2, 8, 1, 256, 128, 2, [129, 256], RESIDENT),
    (3, 8, 1, 128, 24, 6, [1, 24, 143], RESIDENT),
    (2, 32, 1, 64, 32, 4, [33, 128], RESIDENT)],
    ids=["hd64_g1", "hd64_g1_one_split", "hd128_g4", "hd256_g8_ps128",
         "hd128_g8_ps24", "hd64_g32"])
def test_tc_paged_arithmetic_matches_jax_tpu_kernel(
        monkeypatch, rows, heads, kvh, hd, ps, max_pages, lengths,
        resident):
    """The emulation against ``paged_attention_tpu`` (``_tpu_kernel`` in
    TPU interpret mode) on bf16 inputs: within BF16_TOL and at most
    DIFFERING of the bf16 outputs different.  Lengths hold 1, page edges
    and the whole span; page size 24 is not a multiple of 16; GQA groups
    of 1, 4, 8 and 32 (two blocks of 16 heads on the card); several
    splits, and one (``resident`` = 1)."""
    q, kv, tables, lens = _inputs(7, rows, heads, kvh, hd, ps, max_pages,
                                  lengths)
    tq, tkv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, kv))
    tt, tl = torch.from_numpy(tables), torch.from_numpy(lens)
    scale = hd ** -0.5
    got = _tc_paged_emulated(tq, tkv, tt, tl, scale, resident)

    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))
    want = paged_attention_tpu(jnp.asarray(q, jnp.bfloat16),
                               jnp.asarray(kv, jnp.bfloat16),
                               jnp.asarray(tables), jnp.asarray(lens))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.dtype == torch.bfloat16 and got.shape == (rows, heads, hd)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=BF16_TOL)
    share = float((got != want).mean())
    probe = float((_tc_paged_emulated(tq, tkv, tt, tl, scale, resident,
                                      split=False).float().numpy()
                   != want).mean())
    print(f"differing {share:.4f}, with bf16 P {probe:.4f}")
    assert share <= DIFFERING < probe
    # the plain version on fp32 copies computes the same function
    ref32 = paged_attention_ref(tq.float(), tkv.float(), tt, tl,
                                sm_scale=scale)
    np.testing.assert_allclose(got, ref32.numpy(), atol=BF16_TOL)
    assert float((ref32.to(torch.bfloat16).float().numpy() != got).mean()
                 ) <= DIFFERING


@pytest.mark.parametrize("resident,blocks,positions", [
    (264, 72, 1024), (264, 512, 1024), (132, 80, 1024), (264, 9, 64),
    (1, 4, 1), (528, 3, 130), (264, 264, 1024)])
def test_splits_cover_the_span_from_shapes(resident, blocks, positions):
    """Every position of the table span lies in one split, and no split
    is empty of chunks; one split where the blocks already fill the card,
    else about two residencies of blocks."""
    per, n = splits(resident, blocks, positions)
    chunks = -(-positions // CHUNK)
    assert per >= 1 and n >= 1
    assert n * per * CHUNK >= positions and (n - 1) * per < chunks
    if blocks >= resident:
        assert n == 1
    else:
        assert n == min(chunks, -(-2 * resident // blocks)) or \
            n * blocks >= 2 * resident
