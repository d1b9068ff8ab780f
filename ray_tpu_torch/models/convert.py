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
  blocks/moe/router/kernel             [L, d, E]      (in place of mlp
  blocks/moe/{w_gate,w_up}             [L, E, d, d_ff] with moe_experts)
  blocks/moe/w_down                    [L, E, d_ff, d]
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
A flax kernel is [in, out]; ``nn.Linear`` stores [out, in].  The
experts' tensors keep the flax layout in the port (``ops/moe.py``).

``jax_leaves`` lists that tree's leaves for a config, each with the
port parameters that make it up.  ``params_from_jax`` reads the tree
through it, and the port's Adafactor (``train/step.py``) keeps its
statistics per leaf through it, since optax decides factoring and takes
its block RMS values per JAX leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.configs import TransformerConfig


@dataclasses.dataclass(frozen=True)
class JaxLeaf:
    """One leaf of the JAX GPT's parameter tree and the port parameters
    that make it up.

    ``path``: the keys down the flax tree (``("blocks", "attn", "wq",
    "kernel")``); ``shape``: the leaf's shape; ``names``: the port
    parameters, one per layer of a stacked leaf (``stacked``: the leaf
    has a leading layer axis) or the one parameter of any other leaf.
    A port parameter is a layer slice of the leaf in the port's layout:
    a ``.weight`` [out, in] is the transpose of a flax kernel [in, ...]
    with its trailing dims flattened (``to_leaf_layout``)."""
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    names: Tuple[str, ...]
    stacked: bool

    @property
    def layer_shape(self) -> Tuple[int, ...]:
        return self.shape[1:] if self.stacked else self.shape


def to_leaf_layout(tensor: torch.Tensor, name: str,
                   leaf: JaxLeaf) -> torch.Tensor:
    """Port parameter ``name`` as its layer slice of ``leaf``, a view."""
    if name.endswith(".weight"):
        return tensor.T.reshape(leaf.layer_shape)
    return tensor


def _split_tail(cfg: TransformerConfig) -> bool:
    """Whether the JAX training model splits its stack into ``blocks``
    and ``blocks_tail`` (partial remat; ``stack_layers``' caller)."""
    n = cfg.remat_layers
    return (cfg.remat and n is not None
            and 0 < max(0, min(n, cfg.n_layers)) < cfg.n_layers)


def jax_leaves(cfg: TransformerConfig,
               split_tail: Optional[bool] = None) -> List[JaxLeaf]:
    """The JAX GPT's parameter leaves for ``cfg``, each with the port
    parameters that make it up.  ``split_tail``: whether the tree splits
    its stack for partial remat; by default as the training model does
    (a decode-mode model never splits it)."""
    d, h, kvh, hd, f, e = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cfg.d_ff, cfg.moe_experts)
    ffn = ({("moe", "router", "kernel"): (d, e),
            ("moe", "w_gate"): (e, d, f),
            ("moe", "w_up"): (e, d, f),
            ("moe", "w_down"): (e, f, d)} if e else
           {("mlp", "w_gate", "kernel"): (d, f),
            ("mlp", "w_up", "kernel"): (d, f),
            ("mlp", "w_down", "kernel"): (f, d)})
    layer = {("attn", "wq", "kernel"): (d, h, hd),
             ("attn", "wk", "kernel"): (d, kvh, hd),
             ("attn", "wv", "kernel"): (d, kvh, hd),
             ("attn", "wo", "kernel"): (h * hd, d),
             ("attn_norm", "scale"): (d,),
             **ffn,
             ("mlp_norm", "scale"): (d,)}

    def port_name(i: int, sub: Tuple[str, ...]) -> str:
        # a flax kernel is the .weight of its Dense; the experts' leaves
        # are port parameters of the same name and layout
        if sub[-1] == "kernel":
            sub = sub[:-1] + ("weight",)
        return f"blocks.{i}." + ".".join(sub)

    if split_tail is None:
        split_tail = _split_tail(cfg)
    n_head = (max(0, min(cfg.remat_layers, cfg.n_layers)) if split_tail
              else cfg.n_layers)
    stacks = [("blocks", 0, n_head)]
    if split_tail:
        stacks.append(("blocks_tail", n_head, cfg.n_layers - n_head))
    leaves = [JaxLeaf(("embed",), (cfg.vocab_size, d), ("embed",), False),
              JaxLeaf(("final_norm", "scale"), (d,), ("final_norm.scale",),
                      False)]
    if not cfg.tie_embeddings:
        leaves.append(JaxLeaf(("lm_head", "kernel"), (d, cfg.vocab_size),
                              ("lm_head.weight",), False))
    for name, first, n in stacks:
        for sub, shape in layer.items():
            if cfg.scan_layers:
                leaves.append(JaxLeaf(
                    (name,) + sub, (n,) + shape,
                    tuple(port_name(first + j, sub) for j in range(n)),
                    True))
            else:
                # flax names unscanned layers name[:-1]_j
                leaves.extend(JaxLeaf(
                    (f"{name[:-1]}_{j}",) + sub, shape,
                    (port_name(first + j, sub),), False) for j in range(n))
    return leaves


def params_from_jax(tree: Mapping, cfg: TransformerConfig
                    ) -> Dict[str, torch.Tensor]:
    """The port GPT's state dict (CPU tensors) from a JAX GPT parameter
    tree of numpy arrays; load it with ``model.load_state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    split = "blocks_tail" in tree or "blocks_tai_0" in tree
    for leaf in jax_leaves(cfg, split_tail=split):
        arr = tree
        for key in leaf.path:
            arr = arr[key]
        arr = np.asarray(arr)
        for j, name in enumerate(leaf.names):
            a = torch.from_numpy(np.array(arr[j] if leaf.stacked else arr))
            if name.endswith(".weight"):
                a = a.reshape(a.shape[0], -1).T
            sd[name] = a.contiguous()
    return sd


@torch.no_grad()
def init_weights(model: torch.nn.Module,
                 generator: Optional[torch.Generator] = None) -> None:
    """Random weights in place, with the JAX model's distributions:
    lecun-normal (truncated at two standard deviations, as flax draws it)
    for every dense kernel and expert tensor, normal(0.02) for ``embed``,
    ones for norm scales.  Values are drawn in fp32 on the parameters'
    device and then cast, one parameter at a time."""
    for name, param in model.named_parameters():
        if name.endswith("scale"):
            param.fill_(1.0)
            continue
        tmp = torch.empty(param.shape, device=param.device,
                          dtype=torch.float32)
        if name == "embed":
            tmp.normal_(0.0, 0.02, generator=generator)
        else:
            # an nn.Linear weight is [out, in]; flax's lecun_normal over
            # an expert tensor [E, in, out] counts E as receptive field
            fan_in = (param.shape[1] if param.dim() == 2
                      else math.prod(param.shape[:-1]))
            # flax's truncated_normal variance scaling divides by the
            # std of a standard normal truncated to [-2, 2]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            torch.nn.init.trunc_normal_(tmp, 0.0, std, -2 * std, 2 * std,
                                        generator=generator)
        param.copy_(tmp)
        del tmp
