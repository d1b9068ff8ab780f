"""Weights across the two packages, and random weights for the port's GPT.

``params_from_jax`` maps the JAX GPT's parameter tree, already unboxed to
nested dicts of numpy arrays, onto the port's ``GPT`` state dict.  The
port never sees a flax type: the caller unboxes (``flax.linen.meta.unbox``
and ``np.asarray``).

The flax tree stacks scanned layers on a leading axis:

  blocks/attn/{wq,wk,wv}/kernel        [L, d, h|kvh, hd]
  blocks/attn/wo/kernel                [L, h*hd, d]
  blocks/{attn_norm,mlp_norm}/scale    [L, d]
  blocks/mlp/{w_gate,w_up}/kernel      [L, d, d_ff]
  blocks/mlp/w_down/kernel             [L, d_ff, d]
  embed                                [V, d]
  final_norm/scale                     [d]
  lm_head/kernel                       [d, V]   (absent when tied)

Unscanned models hold ``block_{i}`` subtrees without the layer axis.
With partial remat (``remat`` on, ``0 < remat_layers < n_layers``) the
JAX model stacks the first ``remat_layers`` layers as above and the rest
under ``blocks_tail`` (unscanned: ``blocks_tai_{j}``, flax's
``name[:-1]``), layer ``remat_layers + j`` at index ``j``.  A decode-mode
init never splits its stack, so the tail is read only where the tree
holds one.
A flax kernel is [in, out]; ``nn.Linear`` stores [out, in].
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ray_tpu_torch.models.configs import TransformerConfig


def _layer_tree(tree: Mapping, i: int, cfg: TransformerConfig) -> Mapping:
    """Layer i's subtree: from the remat tail where the tree holds one
    and i lies past the first ``remat_layers`` layers."""
    n = cfg.remat_layers
    if cfg.remat and n is not None and 0 < n <= i < cfg.n_layers and (
            "blocks_tail" in tree or "blocks_tai_0" in tree):
        if "blocks_tail" in tree:
            return _index_tree(tree["blocks_tail"], i - n)
        return tree[f"blocks_tai_{i - n}"]
    if "blocks" in tree:
        return _index_tree(tree["blocks"], i)
    return tree[f"block_{i}"]


def _index_tree(tree, i):
    if isinstance(tree, Mapping):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def params_from_jax(tree: Mapping, cfg: TransformerConfig
                    ) -> Dict[str, torch.Tensor]:
    """The port GPT's state dict (CPU tensors) from a JAX GPT parameter
    tree of numpy arrays; load it with ``model.load_state_dict``."""
    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a))       # a writable copy

    d = cfg.d_model
    sd: Dict[str, torch.Tensor] = {"embed": t(tree["embed"]),
                                   "final_norm.scale":
                                   t(tree["final_norm"]["scale"])}
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = t(tree["lm_head"]["kernel"]).T
    for i in range(cfg.n_layers):
        lt = _layer_tree(tree, i, cfg)
        a, m, p = lt["attn"], lt["mlp"], f"blocks.{i}."
        for name in ("wq", "wk", "wv"):
            sd[p + f"attn.{name}.weight"] = t(
                np.asarray(a[name]["kernel"]).reshape(d, -1)).T
        sd[p + "attn.wo.weight"] = t(a["wo"]["kernel"]).T
        for name in ("w_gate", "w_up", "w_down"):
            sd[p + f"mlp.{name}.weight"] = t(m[name]["kernel"]).T
        sd[p + "attn_norm.scale"] = t(lt["attn_norm"]["scale"])
        sd[p + "mlp_norm.scale"] = t(lt["mlp_norm"]["scale"])
    return {k: v.contiguous() for k, v in sd.items()}


@torch.no_grad()
def init_weights(model: torch.nn.Module,
                 generator: Optional[torch.Generator] = None) -> None:
    """Random weights in place, with the JAX model's distributions:
    lecun-normal (truncated at two standard deviations, as flax draws it)
    for every dense kernel, normal(0.02) for ``embed``, ones for norm
    scales.  Values are drawn in fp32 on the parameters' device and then
    cast, one parameter at a time."""
    for name, param in model.named_parameters():
        if name.endswith("scale"):
            param.fill_(1.0)
            continue
        tmp = torch.empty(param.shape, device=param.device,
                          dtype=torch.float32)
        if name == "embed":
            tmp.normal_(0.0, 0.02, generator=generator)
        else:
            fan_in = param.shape[1]      # nn.Linear weight is [out, in]
            # flax's truncated_normal variance scaling divides by the
            # std of a standard normal truncated to [-2, 2]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            torch.nn.init.trunc_normal_(tmp, 0.0, std, -2 * std, 2 * std,
                                        generator=generator)
        param.copy_(tmp)
        del tmp
