"""Weights across the two packages, and random weights for the port's
models.

``params_from_jax`` maps a JAX model's parameter tree, already unboxed to
nested dicts of numpy arrays, onto the port model's state dict, and
``batch_stats_from_jax`` maps a ResNet's ``batch_stats`` collection onto
its BatchNorm buffers.  The port never sees a flax type: the caller
unboxes (``flax.linen.meta.unbox`` and ``np.asarray``).

The GPT's flax tree stacks scanned layers on a leading axis:

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

The other families (``model_leaves``) reuse that block layout:

  - an ``Encoder`` (ViT, BERT, T5) holds ``encoder/blocks/...`` (the
    dense GPT block's leaves) and ``encoder/final_norm/scale``; it never
    splits its stack;
  - ViT: ``patch_proj/kernel`` [p*p*C, d], ``pos_embed`` [P, d] and
    ``head/kernel`` [d, classes]; BERT: ``embed``, ``pos_embed`` [S, d],
    ``mlm_transform/kernel`` [d, d] and ``mlm_norm/scale``; T5:
    ``embed``, the encoder, a decoder stack ``blocks/{self_norm,
    self_attn, cross_norm, cross_attn, mlp_norm, mlp}/...`` and
    ``final_norm/scale``;
  - ResNet (never scanned): ``conv_init/kernel``, ``bn_init/{scale,
    bias}``, ``{Basic,Bottleneck}Block_{k}/{Conv_i, BatchNorm_i,
    conv_proj, norm_proj}/...`` (the port's ``blocks.{k}.conv{i}`` and
    ``norm{i}``) and ``Dense_0/{kernel, bias}`` (the port's ``head``).

Any other model holds dense layers named as its flax counterpart's
(``dense_leaves``: the RL networks of ``rl/models.py``, with
``pi_0/kernel``, ``pi_log_std``, ``q1/q_0/kernel``,
``OptimizedLSTMCell_0/hi/kernel``), or says what it holds with a
``jax_leaves()`` method of its own (the Decision Transformer of
``rl/dt.py``, whose ``Block`` stack is the GPT's ``blocks``).

A flax kernel is [in, out...]; ``nn.Linear`` stores [out, in], so a
``.weight`` is the transpose of its kernel with the trailing dims
flattened.  A flax convolution kernel is HWIO and the port's ``.weight``
is OIHW (the only 4-D ``.weight``).  The experts' tensors keep the flax
layout in the port (``ops/moe.py``).

``jax_leaves`` lists the GPT tree's leaves for a config, and
``model_leaves`` any port model's, each with the port parameters that
make it up.  ``params_from_jax`` reads the tree through them, and the
port's Adafactor (``train/step.py``) keeps its statistics per leaf
through them, since optax decides factoring and takes its block RMS
values per JAX leaf.
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
    """One leaf of a JAX model's parameter tree and the port parameters
    that make it up.

    ``path``: the keys down the flax tree (``("blocks", "attn", "wq",
    "kernel")``); ``shape``: the leaf's shape; ``names``: the port
    parameters, one per layer of a stacked leaf (``stacked``: the leaf
    has a leading layer axis) or the one parameter of any other leaf.
    A port parameter is a layer slice of the leaf in the port's layout
    (``to_leaf_layout`` and ``from_leaf_layout``)."""
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
    if not name.endswith(".weight"):
        return tensor
    if tensor.dim() == 4:                       # OIHW -> HWIO
        return tensor.permute(2, 3, 1, 0)
    return tensor.T.reshape(leaf.layer_shape)


def from_leaf_layout(tensor: torch.Tensor, name: str) -> torch.Tensor:
    """A layer slice of a leaf as port parameter ``name``, a view (the
    inverse of ``to_leaf_layout``)."""
    if not name.endswith(".weight"):
        return tensor
    if tensor.dim() == 4:                       # HWIO -> OIHW
        return tensor.permute(3, 2, 0, 1)
    return tensor.reshape(tensor.shape[0], -1).T


def _split_tail(cfg: TransformerConfig) -> bool:
    """Whether the JAX training model splits its stack into ``blocks``
    and ``blocks_tail`` (partial remat; ``stack_layers``' caller)."""
    n = cfg.remat_layers
    return (cfg.remat and n is not None
            and 0 < max(0, min(n, cfg.n_layers)) < cfg.n_layers)


def _port_name(prefix: str, i: int, sub: Tuple[str, ...]) -> str:
    # a flax kernel is the .weight of its Dense; the experts' leaves are
    # port parameters of the same name and layout
    if sub[-1] == "kernel":
        sub = sub[:-1] + ("weight",)
    return f"{prefix}blocks.{i}." + ".".join(sub)


def _stack(cfg: TransformerConfig, layer: Dict, path: Tuple[str, ...] = (),
           prefix: str = "", name: str = "blocks", first: int = 0,
           n: Optional[int] = None) -> List[JaxLeaf]:
    """The leaves of ``n`` (default all) layers from ``first`` under
    ``path + (name,)``, scanned or (flax's ``name[:-1]_j``) unscanned as
    ``cfg.scan_layers`` says; the port's layers are ``{prefix}blocks.{i}``.
    ``layer`` maps each leaf's path within a layer to its shape."""
    n = cfg.n_layers if n is None else n
    leaves = []
    for sub, shape in layer.items():
        if cfg.scan_layers:
            leaves.append(JaxLeaf(
                path + (name,) + sub, (n,) + shape,
                tuple(_port_name(prefix, first + j, sub) for j in range(n)),
                True))
        else:
            leaves.extend(JaxLeaf(
                path + (f"{name[:-1]}_{j}",) + sub, shape,
                (_port_name(prefix, first + j, sub),), False)
                for j in range(n))
    return leaves


def _attn(cfg: TransformerConfig, name: str) -> Dict:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {(name, "wq", "kernel"): (d, h, hd),
            (name, "wk", "kernel"): (d, kvh, hd),
            (name, "wv", "kernel"): (d, kvh, hd),
            (name, "wo", "kernel"): (h * hd, d)}


def _mlp(cfg: TransformerConfig) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    return {("mlp", "w_gate", "kernel"): (d, f),
            ("mlp", "w_up", "kernel"): (d, f),
            ("mlp", "w_down", "kernel"): (f, d)}


def _block_layer(cfg: TransformerConfig, ffn: Dict) -> Dict:
    """The leaves of one GPT or encoder block, within the layer, with the
    feed-forward leaves ``ffn``."""
    d = cfg.d_model
    return {**_attn(cfg, "attn"), ("attn_norm", "scale"): (d,), **ffn,
            ("mlp_norm", "scale"): (d,)}


def _leaf(path, shape, name) -> JaxLeaf:
    return JaxLeaf(tuple(path), tuple(shape), (name,), False)


def jax_leaves(cfg: TransformerConfig,
               split_tail: Optional[bool] = None) -> List[JaxLeaf]:
    """The JAX GPT's parameter leaves for ``cfg``, each with the port
    parameters that make it up.  ``split_tail``: whether the tree splits
    its stack for partial remat; by default as the training model does
    (a decode-mode model never splits it)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    if split_tail is None:
        split_tail = _split_tail(cfg)
    n_head = (max(0, min(cfg.remat_layers, cfg.n_layers)) if split_tail
              else cfg.n_layers)
    leaves = [_leaf(("embed",), (cfg.vocab_size, d), "embed"),
              _leaf(("final_norm", "scale"), (d,), "final_norm.scale")]
    if not cfg.tie_embeddings:
        leaves.append(_leaf(("lm_head", "kernel"), (d, cfg.vocab_size),
                            "lm_head.weight"))
    layer = _block_layer(cfg, {("moe", "router", "kernel"): (d, e),
                               ("moe", "w_gate"): (e, d, f),
                               ("moe", "w_up"): (e, d, f),
                               ("moe", "w_down"): (e, f, d)} if e
                         else _mlp(cfg))
    leaves += _stack(cfg, layer, n=n_head)
    if split_tail:
        leaves += _stack(cfg, layer, name="blocks_tail", first=n_head,
                         n=cfg.n_layers - n_head)
    return leaves


def encoder_leaves(cfg: TransformerConfig,
                   path: Tuple[str, ...] = ("encoder",)) -> List[JaxLeaf]:
    """The leaves of an ``Encoder`` at ``path`` in its parent's tree (the
    port's module of the same dotted name; ``()`` for a bare one)."""
    prefix = "".join(f"{key}." for key in path)
    return _stack(cfg, _block_layer(cfg, _mlp(cfg)), path, prefix) + [
        _leaf(path + ("final_norm", "scale"), (cfg.d_model,),
              f"{prefix}final_norm.scale")]


def _vit_leaves(vcfg) -> List[JaxLeaf]:
    enc, p = vcfg.encoder, vcfg.patch_size
    return [_leaf(("patch_proj", "kernel"), (p * p * 3, enc.d_model),
                  "patch_proj.weight"),
            _leaf(("pos_embed",), (vcfg.num_patches, enc.d_model),
                  "pos_embed"),
            *encoder_leaves(enc),
            _leaf(("head", "kernel"), (enc.d_model, vcfg.num_classes),
                  "head.weight")]


def _bert_leaves(cfg: TransformerConfig) -> List[JaxLeaf]:
    d = cfg.d_model
    return [_leaf(("embed",), (cfg.vocab_size, d), "embed"),
            _leaf(("pos_embed",), (cfg.max_seq_len, d), "pos_embed"),
            *encoder_leaves(cfg),
            _leaf(("mlm_transform", "kernel"), (d, d),
                  "mlm_transform.weight"),
            _leaf(("mlm_norm", "scale"), (d,), "mlm_norm.scale")]


def _t5_leaves(cfg: TransformerConfig) -> List[JaxLeaf]:
    d = cfg.d_model
    layer = {("self_norm", "scale"): (d,), **_attn(cfg, "self_attn"),
             ("cross_norm", "scale"): (d,), **_attn(cfg, "cross_attn"),
             ("mlp_norm", "scale"): (d,), **_mlp(cfg)}
    return [_leaf(("embed",), (cfg.vocab_size, d), "embed"),
            *encoder_leaves(cfg), *_stack(cfg, layer),
            _leaf(("final_norm", "scale"), (d,), "final_norm.scale")]


def _resnet_modules(model):
    """(flax path, port name, module) of every Conv, BatchNorm and the
    head of a port ``ResNet``."""
    out = [(("conv_init",), "conv_init", model.conv_init),
           (("bn_init",), "bn_init", model.bn_init)]
    kind = model.block_cls.__name__
    for k, blk in enumerate(model.blocks):
        for attr, mod in blk.named_children():
            flax = (attr if attr.endswith("_proj") else
                    ("Conv_" if attr.startswith("conv") else "BatchNorm_")
                    + attr[-1])
            out.append(((f"{kind}_{k}", flax), f"blocks.{k}.{attr}", mod))
    out.append((("Dense_0",), "head", model.head))
    return out


def _resnet_leaves(model) -> List[JaxLeaf]:
    leaves = []
    for path, name, mod in _resnet_modules(model):
        for pname, p in mod.named_parameters():
            key = {"weight": "kernel"}.get(pname, pname)
            shape = tuple(p.shape)
            if pname == "weight":
                shape = (tuple(p.shape[2:]) + (p.shape[1], p.shape[0])
                         if p.dim() == 4 else shape[::-1])
            leaves.append(_leaf(path + (key,), shape, f"{name}.{pname}"))
    return leaves


def dense_leaves(model, skip: str = "") -> List[JaxLeaf]:
    """Leaves of a module tree named as its flax counterpart's: ``a.b.
    weight`` [out, in] is ``a/b/kernel`` [in, out], ``a.b.bias`` is
    ``a/b/bias``, any other parameter (``pi_log_std``, a norm's
    ``scale``) sits at its dotted path.  Parameters under ``skip`` are
    left out.  Raises ``TypeError`` for a ``.weight`` of anything but an
    ``nn.Linear`` (an embedding or a convolution has a layout of its
    own)."""
    owners = dict(model.named_modules())
    leaves = []
    for name, p in model.named_parameters():
        if skip and name.startswith(skip):
            continue
        parts = name.split(".")
        if parts[-1] == "weight":
            if not isinstance(owners[".".join(parts[:-1])],
                              torch.nn.Linear):
                raise TypeError(f"no JAX counterpart known for "
                                f"{type(model).__name__}: {name}")
            leaves.append(_leaf(parts[:-1] + ["kernel"], p.shape[::-1],
                                name))
        else:
            leaves.append(_leaf(parts, p.shape, name))
    return leaves


def block_leaves(cfg: TransformerConfig) -> List[JaxLeaf]:
    """The leaves of a dense GPT ``Block`` stack under ``blocks`` (the
    port's ``blocks.{i}``), scanned or not as ``cfg.scan_layers`` says."""
    return _stack(cfg, _block_layer(cfg, _mlp(cfg)))


def model_leaves(model: torch.nn.Module) -> List[JaxLeaf]:
    """The JAX counterpart's parameter leaves of a port model: ``GPT``
    (as ``jax_leaves(model.cfg)``), ``ViT``, ``BERT``, ``T5``,
    ``ResNet``, a bare ``Encoder``, a model with a ``jax_leaves()``
    method of its own, or else a tree of dense layers
    (``dense_leaves``)."""
    from ray_tpu_torch.models.bert import BERT
    from ray_tpu_torch.models.encoder import Encoder
    from ray_tpu_torch.models.gpt import GPT
    from ray_tpu_torch.models.resnet import ResNet
    from ray_tpu_torch.models.t5 import T5
    from ray_tpu_torch.models.vit import ViT
    for cls, fn in ((GPT, lambda m: jax_leaves(m.cfg)),
                    (ViT, lambda m: _vit_leaves(m.cfg)),
                    (BERT, lambda m: _bert_leaves(m.cfg)),
                    (T5, lambda m: _t5_leaves(m.cfg)),
                    (ResNet, _resnet_leaves),
                    (Encoder, lambda m: encoder_leaves(m.cfg, ()))):
        if isinstance(model, cls):
            return fn(model)
    if hasattr(model, "jax_leaves"):
        return model.jax_leaves()
    return dense_leaves(model)


def _read(tree: Mapping, leaves: List[JaxLeaf]) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for leaf in leaves:
        arr = tree
        for key in leaf.path:
            arr = arr[key]
        arr = np.asarray(arr)
        for j, name in enumerate(leaf.names):
            a = torch.from_numpy(np.array(arr[j] if leaf.stacked else arr))
            sd[name] = from_leaf_layout(a, name).contiguous()
    return sd


def params_from_jax(tree: Mapping, target) -> Dict[str, torch.Tensor]:
    """The port model's parameters (CPU tensors) from a JAX parameter
    tree of numpy arrays.  ``target``: a ``TransformerConfig`` for the
    GPT (whose stack may be split for partial remat), or the port model
    of any family (``model_leaves``).  Load the result with
    ``model.load_state_dict`` (a ResNet's together with
    ``batch_stats_from_jax``)."""
    if isinstance(target, TransformerConfig):
        split = "blocks_tail" in tree or "blocks_tai_0" in tree
        return _read(tree, jax_leaves(target, split_tail=split))
    return _read(tree, model_leaves(target))


def batch_stats_from_jax(stats: Mapping, model) -> Dict[str, torch.Tensor]:
    """A port ``ResNet``'s BatchNorm buffers (``mean``, ``var``; CPU
    tensors) from the JAX model's ``batch_stats`` collection."""
    from ray_tpu_torch.models.resnet import BatchNorm
    leaves = [_leaf(path + (key,), mod.mean.shape, f"{name}.{key}")
              for path, name, mod in _resnet_modules(model)
              if isinstance(mod, BatchNorm) for key in ("mean", "var")]
    return _read(stats, leaves)


@torch.no_grad()
def init_weights(model: torch.nn.Module,
                 generator: Optional[torch.Generator] = None) -> None:
    """Random weights in place, with the JAX models' distributions:
    lecun-normal (truncated at two standard deviations, as flax draws it)
    for every dense and convolution kernel and expert tensor,
    normal(0.02) for ``embed`` and ``pos_embed``, zeros for biases, ones
    for norm scales but a BatchNorm's ``scale_init`` (0 for the last norm
    of a ResNet block), and fresh BatchNorm statistics (mean 0, var 1).
    Values are drawn in fp32 on the parameters' device and then cast,
    one parameter at a time."""
    scale_init = {}
    for mname, mod in model.named_modules():
        if hasattr(mod, "scale_init"):
            scale_init[f"{mname}.scale"] = mod.scale_init
            mod.mean.zero_()
            mod.var.fill_(1.0)
    for name, param in model.named_parameters():
        if name.endswith("scale"):
            param.fill_(scale_init.get(name, 1.0))
            continue
        if name.endswith(".bias"):
            param.zero_()
            continue
        tmp = torch.empty(param.shape, device=param.device,
                          dtype=torch.float32)
        if name in ("embed", "pos_embed"):
            tmp.normal_(0.0, 0.02, generator=generator)
        else:
            # an nn.Linear weight is [out, in] and a convolution's
            # [out, in, kh, kw]; flax's lecun_normal over an expert
            # tensor [E, in, out] counts E as receptive field
            fan_in = (param.shape[1] if param.dim() == 2
                      else math.prod(param.shape[1:]) if param.dim() == 4
                      else math.prod(param.shape[:-1]))
            # flax's truncated_normal variance scaling divides by the
            # std of a standard normal truncated to [-2, 2]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            torch.nn.init.trunc_normal_(tmp, 0.0, std, -2 * std, 2 * std,
                                        generator=generator)
        param.copy_(tmp)
        del tmp
