"""PG: vanilla policy gradient, REINFORCE with a value-function baseline
(counterpart of ray_tpu/rl/pg.py).

Analog of RLlib's rllib/algorithms/pg/pg.py (+ pg_torch_policy.py: loss
= -logp * advantages, no clipping, single pass).  The simplest on-policy
algorithm, and the loss that A2C and A3C (``rl/a2c.py``) take without
the advantage normalisation.  The update runs on the learner's device:
``optax.chain(clip_by_global_norm(grad_clip), adam(lr))``
(``make_ppo_optimizer``).  The advantages are normalised by their
population std (``jnp.std``; ``correction=0``) with a 1e-4 floor.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ray_tpu_torch.rl import sample_batch as SB
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.ppo import make_ppo_optimizer
from ray_tpu_torch.train.step import global_norm

# the columns the loss reads
PG_KEYS = (SB.OBS, SB.ACTIONS, SB.ADVANTAGES, SB.VALUE_TARGETS)


class PGConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = PG
        self.lr = 4e-4
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0
        self.num_sgd_iter = 1          # single pass: on-policy REINFORCE
        self.train_batch_size = 2000


def make_pg_sgd_step(model, logp_fn, ent_fn, tx, cfg, *,
                     normalize_advantages: bool):
    """``sgd_step(opt_state, batch) -> (opt_state, aux)``: one update of
    ``model`` in place by ``-logp * adv + vf_coeff * vf_loss - ent_coeff
    * entropy`` (PG normalises ``adv``, A2C does not).  ``aux`` holds
    0-d tensors: ``policy_loss``, ``vf_loss``, ``entropy``,
    ``total_loss`` and the gradient's global norm before clipping,
    ``grad_norm``."""
    vf_coeff, ent_coeff = cfg.vf_loss_coeff, cfg.entropy_coeff

    def sgd_step(opt_state, batch):
        params = dict(model.named_parameters())
        logits, values = model(batch[SB.OBS])
        logp = logp_fn(logits, batch[SB.ACTIONS])
        adv = batch[SB.ADVANTAGES]
        if normalize_advantages:
            adv = (adv - adv.mean()) / adv.std(correction=0).clamp_min(1e-4)
        pg_loss = -(logp * adv).mean()
        vf_loss = 0.5 * (values - batch[SB.VALUE_TARGETS]).square().mean()
        entropy = ent_fn(logits).mean()
        total = pg_loss + vf_coeff * vf_loss - ent_coeff * entropy
        grads = dict(zip(params, torch.autograd.grad(
            total, list(params.values()))))
        aux = {"policy_loss": pg_loss.detach(), "vf_loss": vf_loss.detach(),
               "entropy": entropy.detach(), "total_loss": total.detach(),
               "grad_norm": global_norm(grads.values())}
        return tx.update(params, grads, opt_state), aux

    return sgd_step


class PG(Algorithm):
    def setup_learner(self) -> None:
        cfg: PGConfig = self.config
        self.model, _, logp_fn, ent_fn = self.init_actor_critic()
        self.tx = make_ppo_optimizer(cfg)
        self.opt_state = self.tx.init(self.params)
        self._sgd_step = make_pg_sgd_step(self.model, logp_fn, ent_fn,
                                          self.tx, cfg,
                                          normalize_advantages=True)

    def training_step(self) -> Dict[str, Any]:
        cfg: PGConfig = self.config
        train_batch = self.gather_on_policy_batch(cfg.train_batch_size)
        n = self.round_minibatch(train_batch.count)
        batch = self.stage_batch(train_batch.slice(0, n), PG_KEYS)
        aux: Dict[str, Any] = {}
        for _ in range(cfg.num_sgd_iter):
            self.opt_state, aux = self._sgd_step(self.opt_state, batch)
        self.workers.sync_weights(self.get_weights())
        info = {k: float(v) for k, v in aux.items()}
        info["train_batch_size"] = train_batch.count
        return {"info": info}
