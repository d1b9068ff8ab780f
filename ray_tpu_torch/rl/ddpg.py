"""DDPG + TD3: deterministic-policy off-policy continuous control
(counterpart of ray_tpu/rl/ddpg.py).

Analog of RLlib's rllib/algorithms/ddpg/ddpg.py and td3/td3.py
(ddpg_torch_policy.py losses): a deterministic actor trained through
the critic, target networks with soft (tau) updates; TD3 adds twin
critics with min-Q targets, target-policy smoothing noise and delayed
actor updates (``policy_delay`` 2).  The update runs on the learner's
device; ``DDPGPolicy`` rollouts run on CPU actors.

As in ``rl/sac.py`` the networks live in ``self.state`` (``actor``,
``critic``, ``target_actor``, ``target_critic`` and one ``optax.adam``
state for each trained network), and TD3's smoothing normals are drawn
ahead of each update from the algorithm's generator and passed in.
With ``twin_q=False`` the second critic is computed but left out of the
loss, so its gradients are zeros, as ``jax.grad`` gives them.  TD3's
update count goes up *before* the delay check, and a step that skips
the actor leaves the actor, its Adam state (its count too) and the
target actor as they were, reporting ``actor_loss`` 0.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import torch

from ray_tpu_torch.rl import models as M
from ray_tpu_torch.rl import sample_batch as SB
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.replay_buffer import ReplayBuffer
from ray_tpu_torch.rl.sac import (Rescale, adam, continuous_spaces,
                                  draw_batches, grad_step,
                                  make_twin_critic, soft_update, td_target)


class DDPGConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = DDPG
        self.actor_lr = 1e-3
        self.critic_lr = 1e-3
        self.train_batch_size = 256
        self.buffer_size = 100_000
        self.learning_starts = 1000
        self.tau = 0.005
        self.exploration_noise = 0.1
        self.n_updates_per_iter = 32
        self.rollout_fragment_length = 64
        # TD3 extensions (off for plain DDPG)
        self.twin_q = False
        self.policy_delay = 1
        self.target_noise = 0.0
        self.target_noise_clip = 0.5


class TD3Config(DDPGConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = TD3
        self.twin_q = True
        self.policy_delay = 2
        self.target_noise = 0.2


def make_ddpg_update(cfg, txs, rescale: Rescale):
    """``update(state, batch, noise, do_actor) -> aux``: the update of
    ``ray_tpu/rl/ddpg.py`` on ``state`` in place.  ``noise`` [B, A] is
    TD3's target-smoothing standard normal (None when ``target_noise``
    is 0); ``do_actor`` says whether this step trains the actor.  The
    actor reads the updated critic's first head."""
    gamma, tau, twin_q = cfg.gamma, cfg.tau, cfg.twin_q
    target_noise, noise_clip = cfg.target_noise, cfg.target_noise_clip

    def update(state, batch, noise: Optional[torch.Tensor],
               do_actor: bool):
        critic, obs = state["critic"], batch[SB.OBS]
        with torch.no_grad():
            # critic: TD target from the target actor
            a_next = state["target_actor"](batch[SB.NEXT_OBS])
            if target_noise > 0.0:
                # TD3 target-policy smoothing
                a_next = (a_next + (target_noise * noise).clamp(
                    -noise_clip, noise_clip)).clamp(-1.0, 1.0)
            q1_t, q2_t = state["target_critic"](batch[SB.NEXT_OBS],
                                                rescale(a_next))
            target = td_target(batch, torch.minimum(q1_t, q2_t)
                               if twin_q else q1_t, gamma)
        q1, q2 = critic(obs, batch[SB.ACTIONS])
        c_loss = (q1 - target).square().mean()
        if twin_q:
            c_loss = c_loss + (q2 - target).square().mean()
        state["critic_opt"] = grad_step(critic, c_loss, txs["critic"],
                                        state["critic_opt"])
        # actor: maximise Q1 of the fresh critic (delayed for TD3)
        if do_actor:
            actor = state["actor"]
            a_loss = -critic.q1(obs, rescale(actor(obs))).mean()
            state["actor_opt"] = grad_step(actor, a_loss, txs["actor"],
                                           state["actor_opt"])
            soft_update(state["target_actor"], actor, tau)
            a_loss = a_loss.detach()
        else:
            a_loss = torch.zeros((), device=obs.device)
        soft_update(state["target_critic"], critic, tau)
        return {"critic_loss": c_loss.detach(), "actor_loss": a_loss,
                "mean_q": q1.detach().mean()}

    return update


class DDPG(Algorithm):
    @classmethod
    def extra_worker_kwargs(cls, config: AlgorithmConfig) -> Dict[str, Any]:
        return {"policy": "ddpg",
                "policy_kwargs": {
                    "exploration_noise": getattr(config, "exploration_noise",
                                                 0.1)}}

    def setup_learner(self) -> None:
        cfg: DDPGConfig = self.config
        obs_dim, self.act_dim, low, high = continuous_spaces(cfg.env_spec,
                                                             "DDPG")
        seed = cfg.seed or 0
        actor = M.init_params(M.DeterministicActor(
            obs_dim, self.act_dim, tuple(cfg.hidden), device=self.device),
            seed)
        critic, target_critic = make_twin_critic(
            obs_dim, self.act_dim, cfg.hidden, self.device, seed + 1)
        self.txs = {"actor": adam(cfg.actor_lr),
                    "critic": adam(cfg.critic_lr)}
        self.state = {
            "actor": actor, "critic": critic,
            "target_actor": copy.deepcopy(actor).requires_grad_(False),
            "target_critic": target_critic,
            "actor_opt": self.txs["actor"].init(dict(
                actor.named_parameters())),
            "critic_opt": self.txs["critic"].init(dict(
                critic.named_parameters())),
        }
        self.model = actor          # what the rollout workers receive
        self.rescale = Rescale(low, high, self.device)
        self.buffer = ReplayBuffer(cfg.buffer_size, seed=cfg.seed)
        self._updates = 0
        self._gen = torch.Generator(device=self.device).manual_seed(
            (cfg.seed or 0) + 23)
        self._update = make_ddpg_update(cfg, self.txs, self.rescale)

    def draw_noise(self, rows: int) -> Optional[torch.Tensor]:
        """TD3's smoothing normals [rows, A] for one update (None for
        DDPG, whose update draws nothing)."""
        if self.config.target_noise <= 0.0:
            return None
        return torch.randn((rows, self.act_dim), generator=self._gen,
                           device=self.device)

    def training_step(self) -> Dict[str, Any]:
        cfg: DDPGConfig = self.config
        for b in self.workers.foreach_worker("sample_transitions"):
            self.buffer.add(b)
            self._timesteps_total += b.count
        info: Dict[str, Any] = {"buffer_size": len(self.buffer)}
        if len(self.buffer) < cfg.learning_starts:
            return {"info": info}
        info.update(self._replay_updates())
        self.workers.sync_weights(self.get_weights())
        return {"info": info}

    def _replay_updates(self) -> Dict[str, float]:
        """``n_updates_per_iter`` updates on replayed minibatches, the
        actor trained every ``policy_delay``-th; the last one's aux as
        floats."""
        cfg: DDPGConfig = self.config
        mb = self.round_minibatch(cfg.train_batch_size)
        aux: Dict[str, Any] = {}
        for batch in draw_batches(self.buffer, mb, cfg.n_updates_per_iter,
                                  self.device):
            self._updates += 1
            do_actor = (self._updates % max(cfg.policy_delay, 1)) == 0
            aux = self._update(self.state, batch, self.draw_noise(mb),
                               do_actor)
        return {k: float(v) for k, v in aux.items()}


class TD3(DDPG):
    pass
