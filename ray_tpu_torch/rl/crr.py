"""CRR: Critic-Regularized Regression for offline continuous control
(counterpart of ray_tpu/rl/crr.py).

Analog of RLlib's rllib/algorithms/crr/ (crr_torch_policy.py): twin-
critic TD learning plus an actor trained by advantage-weighted behaviour
cloning, weight = min(exp(A(s, a) / beta), clip) or the binary 1[A > 0],
with A(s, a) = Q(s, a) - mean_k Q(s, pi_k(s)).  Offline, from a
``JsonReader`` dataset, on the learner's one device: everything but the
update and its noise is CQL's (``rl/cql.py``).

As in JAX, ``Q(s, a)`` is the first critic head *before* its update
(the critic loss's aux), and the baseline's ``Q(s, pi_k(s))`` comes from
the updated critic at actions of the actor before its update.  Each
update's noise: ``eps_next``, then ``n_action_samples`` normals, one
[1 + n, B, A] draw.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ray_tpu_torch.rl import models as M
from ray_tpu_torch.rl import sample_batch as SB
from ray_tpu_torch.rl.cql import CQL, CQLConfig
from ray_tpu_torch.rl.sac import Rescale, grad_step, soft_update, td_target

_LOG_2PI = math.log(2.0 * math.pi)


class CRRConfig(CQLConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = CRR
        self.beta = 1.0                 # advantage temperature
        self.weight_clip = 20.0
        self.advantage_type = "exp"     # "exp" | "binary"
        self.n_action_samples = 4       # for the advantage baseline
        self.tau = 0.005


def data_logp(actor, obs, act_env, rescale: Rescale) -> torch.Tensor:
    """The log-likelihood of the dataset's env-space actions under the
    actor's squashed Gaussian (each action mapped back to tanh space,
    clipped inside (-1, 1))."""
    mean, log_std = actor(obs)
    a_tanh = ((act_env - rescale.shift) / rescale.scale.clamp_min(1e-8)
              ).clamp(-1.0 + 1e-6, 1.0 - 1e-6)
    pre = torch.atanh(a_tanh)
    std = log_std.exp()
    logp = (-0.5 * ((pre - mean) / std).square() - log_std
            - 0.5 * _LOG_2PI).sum(-1)
    return logp - (2.0 * (math.log(2.0) - pre - F.softplus(-2.0 * pre))
                   ).sum(-1)


def make_crr_update(cfg, txs, rescale: Rescale):
    """``update(state, batch, noise) -> aux``: the update of
    ``ray_tpu/rl/crr.py`` on ``state`` in place; ``noise`` [1 + n, B,
    A] standard normals (``CRR.draw_noise``)."""
    gamma, tau, beta = cfg.gamma, cfg.tau, cfg.beta
    w_clip, binary = cfg.weight_clip, cfg.advantage_type == "binary"

    def update(state, batch, noise):
        actor, critic = state["actor"], state["critic"]
        obs = batch[SB.OBS]
        with torch.no_grad():
            # critic: TD target from the current policy
            mean_n, log_std_n = actor(batch[SB.NEXT_OBS])
            a_next, _ = M.squash(mean_n, log_std_n, noise[0])
            q1_t, q2_t = state["target_critic"](batch[SB.NEXT_OBS],
                                                rescale(a_next))
            target = td_target(batch, torch.minimum(q1_t, q2_t), gamma)
        q1, q2 = critic(obs, batch[SB.ACTIONS])
        c_loss = ((q1 - target).square()
                  + (q2 - target).square()).mean() * 0.5
        q_data = q1.detach()
        state["critic_opt"] = grad_step(critic, c_loss, txs["critic"],
                                        state["critic_opt"])
        with torch.no_grad():
            # advantage: Q(s, a_data) - E_k Q(s, pi_k(s))
            mean_c, log_std_c = actor(obs)
            a_k, _ = M.squash(mean_c, log_std_c, noise[1:])
            q_base = critic.q1(obs.expand((a_k.shape[0],) + obs.shape),
                               rescale(a_k)).mean(0)
            adv = q_data - q_base
            weights = (adv > 0).float() if binary \
                else torch.exp(adv / beta).clamp(max=w_clip)
        # actor: advantage-weighted regression
        a_loss = -(weights * data_logp(actor, obs, batch[SB.ACTIONS],
                                       rescale)).mean()
        state["actor_opt"] = grad_step(actor, a_loss, txs["actor"],
                                       state["actor_opt"])
        soft_update(state["target_critic"], critic, tau)
        return {"critic_loss": c_loss.detach(),
                "actor_loss": a_loss.detach(), "mean_advantage": adv.mean(),
                "mean_weight": weights.mean(), "mean_q": q_data.mean()}

    return update


class CRR(CQL):
    name = "CRR"
    seed_offset = 41            # the JAX package's PRNGKey(seed + 41)

    def make_update(self):
        return make_crr_update(self.config, self.txs, self.rescale)

    def draw_noise(self, rows: int) -> torch.Tensor:
        return torch.randn((1 + self.config.n_action_samples, rows,
                            self.act_dim), generator=self._gen,
                           device=self.device)
