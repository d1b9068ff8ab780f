"""The optimizer and the train step on one device (counterpart of
ray_tpu/train/step.py).

``make_train`` is the one-device counterpart of ``make_sharded_train``:
the same optimizer, losses, batch contract and metrics, without the mesh,
the shardings and the donation (ROADMAP.md Queue 1 item 4, multi-GPU
training).  The JAX step is a pure function of an immutable state; here
the step updates the model's parameters and the optimizer state in
place, which saves a copy of both.

The optimizer repeats optax's arithmetic, not ``torch.optim``'s:

  - ``clip_by_global_norm`` scales by ``max_norm / norm`` with no epsilon
    (``clip_grad_norm_`` adds 1e-6);
  - AdamW is ``scale_by_adam`` (bias corrections from the incremented
    count, eps outside the square root), then the decoupled decay
    ``+ weight_decay * p`` under ``_decay_mask``, then ``-lr``;
  - the learning rate comes from ``warmup_cosine_decay_schedule`` at the
    count before the update, so the first update has lr 0: it fills the
    moments and moves no parameter;
  - ``mu_dtype="bfloat16"`` stores the first moment in bf16 and uses the
    fp32 value of this step for the update (b1 rounded to bf16 where it
    scales the stored moment, as in optax);
  - ``accum_steps > 1`` follows ``optax.MultiSteps``: a running mean of the
    gradients, one real update every k-th call, and a schedule that counts
    only real updates;
  - ``optimizer="adafactor"`` is ``optax.adafactor`` as the reference
    configures it (``Adafactor``), whose statistics live per leaf of the
    JAX parameter tree (``models/convert.py`` ``jax_leaves``).

The optimizers run as ``_foreach`` and tensor ops, as XLA runs optax's
on the TPU: no Pallas kernel there, so no hand-written one here.

The loss functions add the MoE blocks' aux loss, as the reference adds
its routers' sown values (``_lm_loss_body``).  ``make_train``'s
``loss_fn`` is any ``(model, batch, z_loss)`` function: the LM losses
here, ``models/bert.py`` ``mlm_loss_fn`` and ``models/t5.py``
``seq2seq_loss_fn``.  ``make_vision_train`` trains image classifiers
(``ViT``, ``ResNet``) with ``classification_loss_fn``; a ResNet's
BatchNorm statistics, the reference's ``TrainStateBN.batch_stats``, are
the model's buffers, updated by its training-mode forward.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.models.convert import (from_leaf_layout, model_leaves,
                                          to_leaf_layout)

Params = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _decay_mask(params: Params) -> Dict[str, bool]:
    """Weight-decay the projection and convolution weights and ``embed``,
    by parameter name, as the reference decays the flax leaves named
    ``kernel`` and ``embed``: a ``.weight`` is a flax kernel (the MoE
    router's, a convolution's and the classifier head's too), while norm
    scales, BatchNorm and head biases, ``pos_embed`` and the experts'
    ``w_gate`` / ``w_up`` / ``w_down`` are not decayed."""
    return {n: n == "embed" or n.endswith(".weight") for n in params}


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule``: linear from init to peak
    over ``warmup_steps``, then cosine down to ``end_value`` at
    ``decay_steps`` (which includes the warmup), then flat."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError("the cosine decay needs decay_steps > warmup_steps")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / cos_steps))
        return peak_value * ((1 - alpha) * cosine + alpha)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def _clip_scale(gs, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm's factor: 1 where norm < max, else
    max / norm (no epsilon; ``clip_grad_norm_`` adds 1e-6)."""
    norm = global_norm(gs)
    return torch.where(norm < max_norm, torch.ones_like(norm),
                       max_norm / norm)


def decay_all(params: Params) -> Dict[str, bool]:
    """Weight-decay every parameter: optax's ``adamw`` with no mask
    (biases and norm scales too), as ``ray_tpu/rl/dt.py`` builds it."""
    return {n: True for n in params}


class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1,
    b2, eps, weight_decay, mu_dtype, mask))`` over named parameters,
    applied in place; ``grad_clip=None`` leaves the clip out (a bare
    ``optax.adam`` with no decay).  ``mask`` maps the parameters to
    which of them decay: the LM rule ``_decay_mask`` by default,
    ``decay_all`` for an unmasked ``optax.adamw``."""

    def __init__(self, schedule: Callable[[int], float], *, b1: float,
                 b2: float, weight_decay: float,
                 grad_clip: Optional[float],
                 eps: float = 1e-8, mu_dtype: torch.dtype = torch.float32,
                 mask: Callable[[Params], Dict[str, bool]] = _decay_mask):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.grad_clip = weight_decay, grad_clip
        self.mu_dtype = mu_dtype
        self.mask = mask

    def init(self, params: Params) -> Dict[str, Any]:
        return {"count": 0,
                "mu": {n: torch.zeros_like(p, dtype=self.mu_dtype)
                       for n, p in params.items()},
                "nu": {n: torch.zeros_like(p, dtype=torch.float32)
                       for n, p in params.items()}}

    @torch.no_grad()
    def update(self, params: Params, grads: Params,
               state: Dict[str, Any]) -> Dict[str, Any]:
        names = list(params)
        gs = [grads[n].float() for n in names]
        if self.grad_clip is not None:
            gs = torch._foreach_mul(gs, _clip_scale(gs, self.grad_clip))
        b1, b2 = self.b1, self.b2
        # optax multiplies the moment by a weakly typed b1, which takes
        # the moment's dtype (0.8984375 for bf16); the jitted product
        # itself stays fp32
        b1_m = float(torch.tensor(b1, dtype=self.mu_dtype))
        mu = torch._foreach_mul([state["mu"][n].float() for n in names],
                                b1_m)
        nu = [state["nu"][n] for n in names]
        torch._foreach_add_(mu, gs, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, gs, gs, value=1 - b2)
        count = state["count"] + 1
        upd = torch._foreach_div(mu, 1 - b1 ** count)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, 1 - b2 ** count))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            mask = self.mask(params)
            dec = [i for i, n in enumerate(names) if mask[n]]
            torch._foreach_add_([upd[i] for i in dec],
                                [params[names[i]].float() for i in dec],
                                alpha=self.weight_decay)
        lr = self.schedule(state["count"])
        torch._foreach_add_([params[n] for n in names], upd, alpha=-lr)
        return {"count": count,
                "mu": {n: m.to(self.mu_dtype) for n, m in zip(names, mu)},
                "nu": state["nu"]}


# optax.adafactor's settings: the reference's min_dim_size_to_factor and
# the defaults it leaves as they are
_MIN_DIM_TO_FACTOR = 128     # factor only when two dims reach this
_FACTOR_DECAY = 0.8          # second-moment decay exponent
_FACTOR_EPS = 1e-30          # added to the squared gradient
_BLOCK_RMS_CLIP = 1.0        # clip_by_block_rms threshold
_PARAM_RMS_MIN = 1e-3        # scale_by_param_block_rms min_scale


def factored_dims(shape):
    """optax's ``_factored_dims``: the (second largest, largest) axes of
    ``shape`` when the second largest has at least _MIN_DIM_TO_FACTOR
    elements, else None.  ``np.argsort`` orders ties as optax's does."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < _MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor:
    """``optax.chain(clip_by_global_norm(grad_clip), adafactor(schedule,
    min_dim_size_to_factor=128, weight_decay_rate, weight_decay_mask))``
    over named parameters, applied in place.

    optax decides per leaf of the JAX parameter tree, so every statistic
    here is kept and taken per ``JaxLeaf`` (``models/convert.py``): a
    stacked leaf holds all the layers of a scanned stack, and its
    factoring, its block RMS clip and its parameter-scale RMS are those
    of the whole stack.  For each leaf the port parameters are viewed in
    the leaf's layout and stacked (one leaf-sized copy at a time), the
    leaf's update is computed as optax computes it, and each parameter
    takes its slice.  The chain, per leaf:

      - ``scale_by_factored_rms``: decay ``1 - (count + 1)^-0.8``; a
        factored leaf keeps row and column means of ``g^2 + 1e-30`` over
        its two largest axes (``factored_dims``), any other leaf the
        full second moment;
      - ``clip_by_block_rms(1)``, ``scale_by_learning_rate``,
        ``scale_by_param_block_rms(1e-3)``;
      - ``add_decayed_weights(weight_decay_rate)`` on the kernels and
        ``embed``: a raw per-step decay, not scaled by the learning rate
        (the reference passes ``lr * weight_decay``); then ``-1``.
    """

    def __init__(self, schedule: Callable[[int], float], leaves, *,
                 grad_clip: float, weight_decay_rate: float):
        self.schedule = schedule
        self.leaves = list(leaves)
        self.grad_clip = grad_clip
        self.weight_decay_rate = weight_decay_rate
        self.factored = [factored_dims(leaf.shape) for leaf in self.leaves]

    def init(self, params: Params) -> Dict[str, Any]:
        """count and, per leaf (keyed by its path), ``v_row`` and
        ``v_col`` for a factored leaf or ``v`` for any other, fp32."""
        names = {n for leaf in self.leaves for n in leaf.names}
        if names != set(params):
            raise ValueError(
                f"the parameters differ from the JAX tree's leaves: "
                f"{sorted(names ^ set(params))[:6]}")
        state: Dict[str, Any] = {"count": 0, "v_row": {}, "v_col": {},
                                 "v": {}}
        for leaf, dims in zip(self.leaves, self.factored):
            dev = params[leaf.names[0]].device
            key = "/".join(leaf.path)

            def zeros(shape):
                return torch.zeros(tuple(shape), dtype=torch.float32,
                                   device=dev)
            if dims is None:
                state["v"][key] = zeros(leaf.shape)
            else:
                d1, d0 = dims
                state["v_row"][key] = zeros(np.delete(leaf.shape, d0))
                state["v_col"][key] = zeros(np.delete(leaf.shape, d1))
        return state

    @staticmethod
    def _leaf_grad(leaf, grads: Params, scale) -> torch.Tensor:
        """The leaf's gradient times the clip factor, in the leaf's
        layout: a new fp32 tensor (the update is computed in it)."""
        views = [to_leaf_layout(grads[n].float(), n, leaf)
                 for n in leaf.names]
        if not leaf.stacked:
            return views[0] * scale
        g = torch.empty(leaf.shape, dtype=torch.float32, device=scale.device)
        for j, view in enumerate(views):
            torch.mul(view, scale, out=g[j])
        return g

    @torch.no_grad()
    def update(self, params: Params, grads: Params,
               state: Dict[str, Any]) -> Dict[str, Any]:
        scale = _clip_scale([grads[n].float() for leaf in self.leaves
                             for n in leaf.names], self.grad_clip)
        count = state["count"]
        # optax: t = float32(count + 1); decay = 1 - t^-0.8, in fp32
        t = torch.tensor(count + 1, dtype=torch.float32)
        decay = float(1.0 - t ** -_FACTOR_DECAY)
        lr = float(torch.tensor(self.schedule(count), dtype=torch.float32))
        decayed = _decay_mask(params)
        for leaf, dims in zip(self.leaves, self.factored):
            key = "/".join(leaf.path)
            u = self._leaf_grad(leaf, grads, scale)
            g_sq = torch.square(u).add_(_FACTOR_EPS)
            if dims is None:
                v = state["v"][key]
                v.mul_(decay).add_(g_sq, alpha=1.0 - decay)
                u.mul_(v.rsqrt())
            else:
                d1, d0 = dims
                v_row, v_col = state["v_row"][key], state["v_col"][key]
                v_row.mul_(decay).add_(g_sq.mean(d0), alpha=1.0 - decay)
                v_col.mul_(decay).add_(g_sq.mean(d1), alpha=1.0 - decay)
                r1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(r1, keepdim=True)).rsqrt()
                u.mul_(row_factor.unsqueeze(d0)).mul_(
                    v_col.rsqrt().unsqueeze(d1))
            del g_sq
            # clip_by_block_rms(1), the learning rate, and
            # scale_by_param_block_rms: rms(p) over the leaf, at least
            # min_scale; the three scalars applied in one pass
            n_el = math.sqrt(math.prod(leaf.shape))
            u_rms = torch.linalg.vector_norm(u) / n_el
            p_rms = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
                [params[n].float() for n in leaf.names]))) / n_el
            u.mul_(lr * p_rms.clamp(min=_PARAM_RMS_MIN)
                   / torch.clamp(u_rms / _BLOCK_RMS_CLIP, min=1.0))
            for j, n in enumerate(leaf.names):
                u_n = from_leaf_layout(u[j] if leaf.stacked else u, n)
                p = params[n]
                if self.weight_decay_rate and decayed[n]:
                    u_n.add_(p, alpha=self.weight_decay_rate)
                p.sub_(u_n)
        state["count"] = count + 1
        return state


class MultiSteps:
    """``optax.MultiSteps(inner, k)``: average the gradients of k calls and
    apply ``inner`` (``AdamW`` or ``Adafactor``) on every k-th; the calls
    between move nothing."""

    def __init__(self, inner, every_k: int):
        self.inner, self.k = inner, every_k

    def init(self, params: Params) -> Dict[str, Any]:
        return {"mini_step": 0, "inner": self.inner.init(params),
                "acc": {n: torch.zeros_like(p, dtype=torch.float32)
                        for n, p in params.items()}}

    @torch.no_grad()
    def update(self, params: Params, grads: Params,
               state: Dict[str, Any]) -> Dict[str, Any]:
        names = list(params)
        acc = [state["acc"][n] for n in names]
        # Welford mean: acc + (g - acc) / (n + 1)
        diff = torch._foreach_sub([grads[n].float() for n in names], acc)
        torch._foreach_div_(diff, state["mini_step"] + 1)
        torch._foreach_add_(acc, diff)
        if state["mini_step"] == self.k - 1:
            state["inner"] = self.inner.update(params, state["acc"],
                                               state["inner"])
            torch._foreach_zero_(acc)
        state["mini_step"] = (state["mini_step"] + 1) % self.k
        return state


@dataclasses.dataclass
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    accum_steps: int = 1
    # "bfloat16" halves the first-moment buffer (the second stays fp32)
    mu_dtype: str = "float32"
    optimizer: str = "adamw"

    def schedule(self) -> Callable[[int], float]:
        return warmup_cosine_decay(
            0.0, self.learning_rate, self.warmup_steps,
            max(self.decay_steps, self.warmup_steps + 1),
            self.learning_rate * self.min_lr_ratio)

    def make(self, leaves=None):
        """The optimizer.  Adafactor keeps its statistics per leaf of
        the JAX parameter tree, which it then needs: ``leaves`` are the
        model's (``models/convert.py`` ``model_leaves``, or
        ``jax_leaves(cfg)`` for a GPT config)."""
        if self.optimizer == "adafactor":
            if leaves is None:
                raise ValueError("adafactor needs the model's JAX leaves: "
                                 "make(model_leaves(model))")
            # the reference's approximation of decoupled decay: optax
            # applies the rate raw, once per step
            tx = Adafactor(self.schedule(), leaves,
                           grad_clip=self.grad_clip,
                           weight_decay_rate=(self.weight_decay
                                              * self.learning_rate))
        elif self.optimizer == "adamw":
            tx = AdamW(self.schedule(), b1=self.b1, b2=self.b2,
                       weight_decay=self.weight_decay,
                       grad_clip=self.grad_clip,
                       mu_dtype=_DTYPES[self.mu_dtype])
        else:
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.accum_steps > 1:
            return MultiSteps(tx, self.accum_steps)
        return tx


def state_nbytes(state) -> int:
    """Bytes of every tensor in an optimizer state (nested dicts)."""
    if torch.is_tensor(state):
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        return sum(state_nbytes(v) for v in state.values())
    return 0


def cast_params_once(model: nn.Module, dtype=torch.bfloat16) -> Params:
    """The model's parameters with fp32 matrices and embeddings cast to the
    activation dtype once, outside the rematted blocks, for
    ``torch.func.functional_call``.  Under remat the cast inside each
    projection would otherwise re-read the fp32 masters on every
    recompute.  1-D parameters (norm scales) stay fp32.  Gradients still
    reach the fp32 masters through the cast."""
    return {n: p.to(dtype) if p.dtype == torch.float32 and p.dim() >= 2
            else p for n, p in model.named_parameters()}


def _apply(model: nn.Module, inputs, param_cast, **kw):
    """(model output, MoE aux loss or None, the parameters it ran
    with)."""
    kw["return_aux"] = True
    if param_cast is None:
        out, aux = model(inputs, **kw)
        return out, aux, dict(model.named_parameters())
    params = cast_params_once(model, param_cast)
    out, aux = torch.func.functional_call(model, params, (inputs,), kw)
    return out, aux, params


def _lm_loss_body(model: nn.Module, batch: Dict[str, Any],
                  head: Callable) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Shared next-token plumbing: slice tokens and mask, run
    ``head(inputs, mask, targets) -> (loss, denom, aux)``, and add the
    MoE blocks' aux loss (None without experts) to the loss."""
    dev = model.embed.device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev)[:, 1:].float()
    loss, denom, aux = head(inputs, mask, targets)
    metrics = {"loss": loss, "tokens": denom}
    if aux is not None:
        loss = loss + aux
        metrics.update(loss=loss, moe_aux_loss=aux)
    return loss, metrics


def lm_loss_fn(model: nn.Module, batch: Dict[str, Any], z_loss: float = 0.0,
               param_cast=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token LM loss. batch: {"tokens": [B, S+1], "mask"?}.

    ``param_cast``: optional dtype for :func:`cast_params_once`."""
    from ray_tpu_torch.ops.losses import softmax_cross_entropy

    def head(inputs, mask, targets):
        logits, aux, _ = _apply(model, inputs, param_cast)
        return (*softmax_cross_entropy(logits, targets, mask, z_loss), aux)

    return _lm_loss_body(model, batch, head)


def lm_loss_chunked_fn(model: nn.Module, batch: Dict[str, Any],
                       z_loss: float = 0.0, chunk_size: int = 256,
                       head_weight: Optional[Callable] = None,
                       param_cast=None
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token LM loss with the chunked projection head
    (``ops/losses.py`` ``chunked_lm_loss``).  Same batch contract as
    ``lm_loss_fn``; the model must take ``return_hidden=True``.

    ``head_weight(params) -> (weight, transpose_weight)`` selects the
    projection weight; by default the untied ``lm_head.weight`` [V, D],
    else the tied ``embed`` [V, D], and it raises for models with
    neither."""
    from ray_tpu_torch.ops.losses import chunked_lm_loss

    def head(inputs, mask, targets):
        hidden, aux, params = _apply(model, inputs, param_cast,
                                     return_hidden=True)
        if head_weight is not None:
            weight, transpose = head_weight(params)
        elif "lm_head.weight" in params:
            weight, transpose = params["lm_head.weight"], True
        elif "embed" in params:
            weight, transpose = params["embed"], True
        else:
            raise ValueError(
                "lm_loss_chunked_fn could not find the projection head "
                "(no 'lm_head.weight' or 'embed' parameter); pass "
                "head_weight=")
        return (*chunked_lm_loss(hidden, weight, targets, mask, z_loss,
                                 chunk_size, transpose_weight=transpose),
                aux)

    return _lm_loss_body(model, batch, head)


def _make_tx(model: nn.Module, optimizer: Optional[OptimizerConfig]):
    """The optimizer for ``model``; Adafactor gets the JAX tree's leaves
    of the model's family (``models/convert.py`` ``model_leaves``)."""
    opt = optimizer or OptimizerConfig()
    return opt.make(model_leaves(model) if opt.optimizer == "adafactor"
                    else None)


@dataclasses.dataclass
class TrainState:
    """The model (whose parameters are the trained ones), the optimizer's
    state, and the number of steps taken."""
    model: nn.Module
    opt_state: Dict[str, Any]
    step: int = 0


def make_train(model: nn.Module,
               optimizer: Optional[OptimizerConfig] = None,
               loss_fn: Callable = lm_loss_fn,
               z_loss: Optional[float] = None,
               grad_sync: Optional[Callable[[Params], Params]] = None):
    """Returns ``(init_fn, step_fn)``.

    ``init_fn() -> TrainState`` builds the optimizer state for the model's
    current parameters (initialise or load them first).
    ``step_fn(state, batch) -> (state, metrics)`` takes one step in place;
    metrics hold 0-d tensors ``loss``, ``tokens`` and ``grad_norm`` (the
    norm of the raw gradients, before clipping), and ``moe_aux_loss`` for
    a model with experts, read without a host sync.
    ``z_loss`` defaults to ``model.cfg.z_loss``.
    ``grad_sync`` (for example ``train.sync_gradients``) maps the
    gradients to the gang's average before the norm and the update: the
    data parallelism across trainer workers that ``make_sharded_train``
    gets from its mesh.
    """
    tx = _make_tx(model, optimizer)
    if z_loss is None:
        z_loss = getattr(getattr(model, "cfg", None), "z_loss", 0.0)

    def init_fn() -> TrainState:
        return TrainState(model=model,
                          opt_state=tx.init(dict(model.named_parameters())))

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = dict(state.model.named_parameters())
        loss, metrics = loss_fn(state.model, batch, z_loss)
        raw = torch.autograd.grad(loss, list(params.values()),
                                  allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), raw)}
        if grad_sync is not None:
            grads = grad_sync(grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads.values())
        # a profiler range, so a trace can tell the optimizer's device
        # time from the rest of the step's
        with torch.profiler.record_function("optimizer"):
            state.opt_state = tx.update(params, grads, state.opt_state)
        state.step += 1
        return state, metrics

    return init_fn, step_fn


def classification_loss_fn(logits: torch.Tensor, labels: torch.Tensor
                           ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Mean softmax cross-entropy and accuracy for label classification
    (vision models), in fp32."""
    logits = logits.float()
    labels = labels.long()
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.gather(logp, -1, labels[:, None])[:, 0].mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


@dataclasses.dataclass
class TrainStateBN(TrainState):
    """``TrainState`` of an image classifier.  The reference's
    ``TrainStateBN.batch_stats`` are the model's BatchNorm buffers here,
    which the training-mode forward updates; ``batch_stats`` reads them
    (empty for a model without BatchNorm, such as ViT)."""

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_buffers())


def _vision_loss_fn(model: nn.Module, batch: Dict[str, Any],
                    z_loss: float = 0.0
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``classification_loss_fn`` on the model's logits for batch
    {"image", "label"}, in ``make_train``'s loss form (no z-loss, as in
    the reference's vision step)."""
    dev = next(model.parameters()).device
    logits = model(torch.as_tensor(batch["image"], device=dev))
    return classification_loss_fn(
        logits, torch.as_tensor(batch["label"], device=dev))


def make_vision_train(model: nn.Module,
                      optimizer: Optional[OptimizerConfig] = None):
    """Returns ``(init_fn, step_fn)`` for an image classifier (``ViT``,
    ``ResNet``), the one-device counterpart of the reference's
    ``make_vision_train``: ``make_train`` with ``classification_loss_fn``.

    batch: {"image": [B, H, W, C], "label": [B]}.  ``init_fn() ->
    TrainStateBN``; ``step_fn(state, batch) -> (state, metrics)`` takes
    one step in place; metrics hold 0-d tensors ``loss``, ``accuracy``
    and ``grad_norm`` (before clipping).  A model in training mode
    (torch's default) updates its BatchNorm statistics in the forward,
    as the reference threads its ``batch_stats`` through the step; in
    eval mode it uses them.
    """
    init_fn, step_fn = make_train(model, optimizer, _vision_loss_fn,
                                  z_loss=0.0)

    def init_bn() -> TrainStateBN:
        state = init_fn()
        return TrainStateBN(model=state.model, opt_state=state.opt_state)

    return init_bn, step_fn
