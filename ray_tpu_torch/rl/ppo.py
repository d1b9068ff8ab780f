"""PPO: synchronous on-policy training with the learner on one device
(counterpart of ray_tpu/rl/ppo.py).

Analog of RLlib's rllib/algorithms/ppo/ppo.py (training_step:
synchronous_parallel_sample -> train over minibatch epochs) with the loss
of ppo_torch_policy.py (clipped surrogate + clipped value loss +
entropy).  The train batch goes to the learner's device once per
iteration; each epoch's minibatches are the JAX learner's rows
(``SampleBatch.minibatch_indices`` with the same seeds), taken there.
The advantage normalisation divides by the population std
(``jnp.std``, ``correction=0``), not torch's default sample std.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ray_tpu_torch.rl import sample_batch as SB
from ray_tpu_torch.rl.algorithm import (Algorithm, AlgorithmConfig,
                                        to_device)
from ray_tpu_torch.train.step import AdamW, global_norm

# the columns the loss reads
PPO_KEYS = (SB.OBS, SB.ACTIONS, SB.ACTION_LOGP, SB.ADVANTAGES,
            SB.VALUE_TARGETS, SB.VF_PREDS)


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.clip_param = 0.2
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0
        self.kl_target = 0.01
        self.lr = 3e-4
        self.algo_class = PPO


def make_ppo_optimizer(cfg) -> AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adam(lr))``: the
    port's AdamW with no decay and a constant schedule."""
    lr = cfg.lr
    return AdamW(lambda count: lr, b1=0.9, b2=0.999, weight_decay=0.0,
                 grad_clip=cfg.grad_clip)


def make_ppo_sgd_step(model, logp_fn, ent_fn, tx: AdamW, cfg):
    """``sgd_step(opt_state, batch) -> (opt_state, aux)``: one
    clipped-surrogate update of ``model`` in place.  ``aux`` holds 0-d
    tensors (``policy_loss``, ``vf_loss``, ``entropy``, ``kl``,
    ``total_loss`` and the gradient's global norm before clipping,
    ``grad_norm``); reading them waits for the device."""
    clip, vf_clip = cfg.clip_param, cfg.vf_clip_param
    vf_coeff, ent_coeff = cfg.vf_loss_coeff, cfg.entropy_coeff

    def loss_fn(batch):
        logits, values = model(batch[SB.OBS])
        logp = logp_fn(logits, batch[SB.ACTIONS])
        ratio = torch.exp(logp - batch[SB.ACTION_LOGP])
        adv = batch[SB.ADVANTAGES]
        adv = (adv - adv.mean()) / adv.std(correction=0).clamp_min(1e-4)
        surr = torch.minimum(ratio * adv,
                             ratio.clamp(1 - clip, 1 + clip) * adv)
        vf_targets = batch[SB.VALUE_TARGETS]
        vf_err = (values - vf_targets).square()
        vf_clipped = batch[SB.VF_PREDS] + (
            values - batch[SB.VF_PREDS]).clamp(-vf_clip, vf_clip)
        vf_err2 = (vf_clipped - vf_targets).square()
        vf_loss = 0.5 * torch.maximum(vf_err, vf_err2)
        entropy = ent_fn(logits)
        total = (-surr + vf_coeff * vf_loss - ent_coeff * entropy).mean()
        kl = (batch[SB.ACTION_LOGP] - logp).mean()
        return total, {"policy_loss": -surr.mean(),
                       "vf_loss": vf_loss.mean(),
                       "entropy": entropy.mean(), "kl": kl}

    def sgd_step(opt_state, batch):
        params = dict(model.named_parameters())
        loss, aux = loss_fn(batch)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        aux = {k: v.detach() for k, v in aux.items()}
        aux["total_loss"] = loss.detach()
        aux["grad_norm"] = global_norm(grads.values())
        return tx.update(params, grads, opt_state), aux

    return sgd_step


class PPO(Algorithm):
    podracer_algo = "ppo"

    def setup_learner(self) -> None:
        cfg: PPOConfig = self.config
        self.model, self.continuous, logp_fn, ent_fn = \
            self.init_actor_critic()
        self.tx = make_ppo_optimizer(cfg)
        self.opt_state = self.tx.init(self.params)
        self._sgd_step = make_ppo_sgd_step(
            self.model, logp_fn, ent_fn, self.tx, cfg)

    def training_step(self) -> Dict[str, Any]:
        cfg: PPOConfig = self.config
        # 1. synchronous parallel sample (rollout_ops.py)
        train_batch = self.gather_on_policy_batch(cfg.train_batch_size)

        # 2. minibatch SGD epochs on the learner's device (train_ops.py)
        mb = cfg.sgd_minibatch_size
        staged = to_device({k: v for k, v in train_batch.items()
                            if k in PPO_KEYS}, self.device)
        aux_last: Dict[str, Any] = {}
        n_updates = 0
        for epoch in range(cfg.num_sgd_iter):
            for idx in train_batch.minibatch_indices(
                    mb, seed=None if cfg.seed is None
                    else cfg.seed + self.iteration * 100 + epoch):
                rows = torch.as_tensor(idx, device=self.device)
                self.opt_state, aux = self._sgd_step(
                    self.opt_state, {k: v[rows] for k, v in staged.items()})
                n_updates += 1
            aux_last = aux
        # 3. broadcast fresh weights to rollout workers
        self.workers.sync_weights(self.get_weights())
        info = {k: float(v) for k, v in aux_last.items()}
        info["num_sgd_updates"] = n_updates
        info["train_batch_size"] = train_batch.count
        return {"info": info}
