"""APPO: asynchronous PPO — IMPALA's actor-learner pipeline with the
clipped-surrogate loss on V-trace-corrected advantages (counterpart of
ray_tpu/rl/appo.py).

Analog of RLlib's rllib/algorithms/appo/appo.py (+
appo_torch_policy.py): off-policy fragments stream in asynchronously;
the importance ratio is taken against the behaviour policy's logp and
clipped PPO-style; a slow-moving target policy network anchors the
V-trace correction.  The target is a copy of the online network
(``self.target_model``), refreshed every ``target_update_frequency``
learner steps and on ``set_weights``.  APPO inherits IMPALA's
asynchronous submit/consume loop (``Impala.training_step``, which calls
``self._sgd_step(opt_state, batch)``); only the loss and the optimizer
(``optax.chain(clip_by_global_norm, adam)``, ``make_ppo_optimizer``)
differ.  It does not ride the podracer executor: the JAX package's APPO
inherits IMPALA's ``podracer_algo`` and would train IMPALA's loss there,
so the port's raises instead (ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import copy
from typing import Dict

import torch

from ray_tpu_torch.rl import sample_batch as SB
from ray_tpu_torch.rl.algorithm import AlgorithmConfig
from ray_tpu_torch.rl.impala import Impala, vtrace
from ray_tpu_torch.rl.ppo import make_ppo_optimizer


class APPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = APPO
        self.lr = 5e-4
        self.clip_param = 0.3
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.vtrace_rho_bar = 1.0
        self.vtrace_c_bar = 1.0
        self.batches_per_step = 8
        self.rollout_fragment_length = 50
        self.target_update_frequency = 4   # learner steps between syncs


def make_appo_sgd_step(model, target_model, logp_fn, ent_fn, tx, cfg):
    """``sgd_step(opt_state, batch) -> (opt_state, aux)`` over a [T, B]
    time-major fragment: V-trace from the target network's logp, the
    clipped surrogate against the behaviour logp; ``aux``:
    ``policy_loss``, ``vf_loss``, ``entropy``, ``mean_ratio``,
    ``total_loss``."""
    gamma, clip = cfg.gamma, cfg.clip_param
    vf_coeff, ent_coeff = cfg.vf_loss_coeff, cfg.entropy_coeff
    rho_bar, c_bar = cfg.vtrace_rho_bar, cfg.vtrace_c_bar

    def loss_fn(batch):
        T, B = batch[SB.REWARDS].shape
        obs = batch[SB.OBS]
        flat_obs = obs.reshape((T * B,) + obs.shape[2:])
        logits, values = model(flat_obs)
        logits = logits.reshape((T, B) + logits.shape[1:])
        values = values.reshape(T, B)
        _, boot_value = model(batch["bootstrap_obs"])
        with torch.no_grad():
            # the target policy anchors the V-trace correction
            t_logits, _ = target_model(flat_obs)
            anchor = logp_fn(t_logits.reshape((T, B) + t_logits.shape[1:]),
                             batch[SB.ACTIONS])
        discounts = gamma * (1.0 - batch[SB.TERMINATEDS].float())
        vs, pg_adv = vtrace(anchor, batch[SB.ACTION_LOGP],
                            batch[SB.REWARDS], values, boot_value,
                            discounts, rho_bar, c_bar)
        # PPO's clipped surrogate against the behaviour policy
        logp = logp_fn(logits, batch[SB.ACTIONS])
        ratio = torch.exp(logp - batch[SB.ACTION_LOGP])
        surr = torch.minimum(ratio * pg_adv,
                             ratio.clamp(1 - clip, 1 + clip) * pg_adv)
        pg_loss = -surr.mean()
        vf_loss = 0.5 * (vs - values).square().mean()
        entropy = ent_fn(logits).mean()
        total = pg_loss + vf_coeff * vf_loss - ent_coeff * entropy
        return total, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                       "entropy": entropy, "mean_ratio": ratio.mean()}

    def sgd_step(opt_state, batch):
        params = dict(model.named_parameters())
        loss, aux = loss_fn(batch)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        aux = {k: v.detach() for k, v in aux.items()}
        aux["total_loss"] = loss.detach()
        return tx.update(params, grads, opt_state), aux

    return sgd_step


class APPO(Impala):
    podracer_algo = None

    def setup_learner(self) -> None:
        cfg: APPOConfig = self.config
        self.model, _, logp_fn, ent_fn = self.init_actor_critic()
        self.target_model = copy.deepcopy(self.model).requires_grad_(False)
        self.tx = make_ppo_optimizer(cfg)
        self.opt_state = self.tx.init(self.params)
        self._inflight: Dict = {}
        self._learner_steps = 0
        self._appo_step = make_appo_sgd_step(
            self.model, self.target_model, logp_fn, ent_fn, self.tx, cfg)
        # Impala.training_step calls self._sgd_step(opt_state, batch)
        self._sgd_step = self._appo_adapter

    def sync_target(self) -> None:
        self.target_model.load_state_dict(self.model.state_dict())

    def _appo_adapter(self, opt_state, batch):
        cfg: APPOConfig = self.config
        opt_state, aux = self._appo_step(opt_state, batch)
        self._learner_steps += 1
        if self._learner_steps % max(cfg.target_update_frequency, 1) == 0:
            self.sync_target()
        return opt_state, aux

    def set_weights(self, weights) -> None:
        super().set_weights(weights)
        self.sync_target()
