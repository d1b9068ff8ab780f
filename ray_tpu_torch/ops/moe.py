"""Mixture-of-experts MLP, Switch/Mixtral-style top-k routing
(counterpart of ray_tpu/ops/moe.py).

The reference routes with fixed shapes: every batch row gives each expert
``capacity`` slots, a (token, choice) pair takes the next free slot of its
expert in slot-major order (every token's first choice before any token's
second), pairs past the capacity are dropped (the token's residual passes
through), and the experts' SwiGLU FFNs run as one batched product over
[experts, rows x capacity].  It dispatches and combines with one-hot
einsums; here an index scatter and gather move the same values, each slot
holding at most one token, so no sum changes (``tests/test_torch_moe.py``
holds both against the reference).  No part of it is a Pallas kernel in
the reference, so none is a hand-written kernel here: the expert products
are ``torch.bmm``.

The router's load-balancing loss (Switch Transformer eq. 4) is returned
beside the output, where the reference sows it; the model sums it over
its blocks and ``train/step.py`` adds it to the loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.ops.layers import Dense


class MoEMLP(nn.Module):
    """SwiGLU MLP with ``n_experts`` experts and top-k routing, on [B, S,
    d_model].  Parameters in the flax layout: ``router.weight`` [E, D]
    (a ``Dense`` that computes in fp32), ``w_gate`` and ``w_up`` [E, D,
    F], ``w_down`` [E, F, D]; the experts compute in ``compute_dtype``.
    ``forward`` returns (y, aux loss)."""

    def __init__(self, d_model: int, n_experts: int, d_ff: int, *,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 aux_loss_coef: float = 0.01,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device=None, dtype=None):
        super().__init__()
        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor = capacity_factor
        self.aux_loss_coef = aux_loss_coef
        self.compute_dtype = compute_dtype
        kw = dict(device=device, dtype=dtype)
        self.router = Dense(d_model, n_experts, torch.float32, **kw)
        self.w_gate = nn.Parameter(torch.empty(n_experts, d_model, d_ff,
                                               **kw))
        self.w_up = nn.Parameter(torch.empty(n_experts, d_model, d_ff, **kw))
        self.w_down = nn.Parameter(torch.empty(n_experts, d_ff, d_model,
                                               **kw))

    def capacity(self, s: int) -> int:
        """Slots per expert and batch row for ``s`` tokens, as the
        reference computes it (floor, at least 1, at most s * k)."""
        k = self.top_k
        return min(max(int(k * s * self.capacity_factor / self.n_experts),
                       1), s * k)

    def route(self, x: torch.Tensor):
        """(router probabilities [B, S, E] fp32, gates [B, S, K], experts
        [B, S, K], queue positions [B, S, K]) for ``x`` [B, S, D]."""
        b, s, _ = x.shape
        e, k = self.n_experts, self.top_k
        probs = torch.softmax(self.router(x.float()), dim=-1)
        # lax.top_k puts the lower index first among equal values; a
        # stable descending sort does too (torch.topk promises no order)
        gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate, idx = gate[..., :k], idx[..., :k]
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
        # each pair's place in its expert's queue, counted in slot-major
        # order so that a token's first choice wins capacity first
        slot_major = idx.transpose(1, 2).reshape(b, k * s, 1)
        queue = F.one_hot(slot_major[..., 0], e).cumsum(1)
        pos = queue.gather(-1, slot_major) - 1
        return probs, gate, idx, pos.view(b, k, s).transpose(1, 2)

    def forward(self, x: torch.Tensor):
        b, s, d = x.shape
        e, k, dt = self.n_experts, self.top_k, self.compute_dtype
        cap = self.capacity(s)
        probs, gate, idx, pos = self.route(x)
        keep = pos < cap
        # each pair's row of the experts' [E, B, C] slots; dropped pairs
        # write a spare last row that no expert reads
        rows = torch.arange(b, device=x.device)[:, None, None]
        slot = (idx * b + rows) * cap + pos
        slot = torch.where(keep, slot, e * b * cap)
        xs = x.to(dt)[:, :, None, :].expand(b, s, k, d).reshape(-1, d)
        slots = x.new_zeros(e * b * cap + 1, d, dtype=dt).index_put(
            (slot.reshape(-1),), xs)
        h = slots[:-1].view(e, b * cap, d)
        w_gate, w_up, w_down = (w.to(dt) for w in (self.w_gate, self.w_up,
                                                    self.w_down))
        # a profiler range, so a trace can tell the experts' products
        # from the other GEMMs
        with torch.profiler.record_function("moe_experts"):
            act = F.silu(torch.bmm(h, w_gate)) * torch.bmm(h, w_up)
            out = torch.bmm(act, w_down).view(e * b * cap, d)
        # combine: each kept pair's expert output times its gate, the gates
        # rounded to the compute dtype as the reference's combine tensor
        # is, summed in fp32 and rounded once, as its einsum does
        picked = out[torch.where(keep, slot, 0)]                # [B,S,K,D]
        weight = torch.where(keep, gate.to(dt).float(), 0.0)
        y = (weight[..., None] * picked.float()).sum(2).to(dt)

        # Switch load balancing: E * sum_e f_e * P_e, f_e the share of
        # tokens whose first choice is e, P_e the mean probability of e
        f = F.one_hot(idx[..., 0], e).float().mean((0, 1))
        aux = self.aux_loss_coef * e * torch.sum(f * probs.mean((0, 1)))
        return y.to(x.dtype), aux
