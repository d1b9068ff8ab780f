"""SAC: off-policy maximum-entropy RL for continuous control
(counterpart of ray_tpu/rl/sac.py).

Analog of RLlib's rllib/algorithms/sac/sac.py (+ sac_torch_policy.py
losses): twin Q critics with soft target updates, a tanh-Gaussian actor
trained by reparameterisation, and automatic entropy-temperature tuning
toward -|A| target entropy.  The update runs on the learner's device
(the card unless ``.resources(device="cpu")``); CPU rollout actors run
the squashed-Gaussian ``SACPolicy`` and feed the replay buffer through
``sample_transitions()``.

The learner keeps its networks in ``self.state`` under the JAX
package's names: ``actor``, ``critic``, ``target_critic`` (a copy of
its own, moved by ``torch._foreach_lerp_``), ``log_alpha`` (a 0-d
parameter) and one Adam state per network (``optax.adam``: no clip).
Where JAX draws inside its jitted update, the algorithm draws each
update's noise ahead of it from its own generator on the learner's
device, in JAX's call order (``eps_next``, then ``eps_pi``), and hands
it to the update as tensors, so an update can be replayed elsewhere
on the same noise.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterable

import numpy as np
import torch

from ray_tpu_torch.rl import models as M
from ray_tpu_torch.rl import sample_batch as SB
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.policy import action_dims
from ray_tpu_torch.rl.replay_buffer import ReplayBuffer
from ray_tpu_torch.train.step import AdamW

# the columns a replayed update reads
TRANSITION_KEYS = (SB.OBS, SB.ACTIONS, SB.REWARDS, SB.NEXT_OBS,
                   SB.TERMINATEDS)


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = SAC
        self.lr = 3e-4
        self.train_batch_size = 256
        self.buffer_size = 100_000
        self.learning_starts = 1000
        self.tau = 0.005                    # soft target update rate
        self.initial_alpha = 1.0
        self.target_entropy = "auto"        # -> -action_dim
        self.n_updates_per_iter = 32
        self.rollout_fragment_length = 64


# ------------------------------------------------ shared by the continuous
# learners (SAC, DDPG/TD3, CQL, CRR)

class Rescale:
    """The JAX package's map of tanh-space actions to the Box bounds,
    ``a * (high - low) / 2 + (high + low) / 2``, on a device."""

    def __init__(self, low: np.ndarray, high: np.ndarray, device):
        self.low, self.high = low, high
        self.scale = torch.tensor((high - low) / 2.0, device=device)
        self.shift = torch.tensor((high + low) / 2.0, device=device)

    def __call__(self, a_tanh: torch.Tensor) -> torch.Tensor:
        return a_tanh * self.scale + self.shift


def continuous_spaces(env_spec, name: str):
    """(obs_dim, act_dim, low, high) of ``env_spec``'s spaces; a discrete
    action space raises ``ValueError`` naming ``name``."""
    probe = make_env(env_spec)
    try:
        obs_dim, act_dim, continuous = action_dims(probe.observation_space,
                                                   probe.action_space)
        if not continuous:
            raise ValueError(f"{name} requires a continuous action space")
        low = np.asarray(probe.action_space.low, np.float32).reshape(-1)
        high = np.asarray(probe.action_space.high, np.float32).reshape(-1)
    finally:
        probe.close()
    return obs_dim, act_dim, low, high


def adam(lr: float) -> AdamW:
    """``optax.adam(lr)``: the port's AdamW without clip or decay."""
    return AdamW(lambda count: lr, b1=0.9, b2=0.999, weight_decay=0.0,
                 grad_clip=None)


def grad_step(module: torch.nn.Module, loss: torch.Tensor, tx: AdamW,
              opt_state: Dict[str, Any]) -> Dict[str, Any]:
    """One optimizer step of ``module``'s parameters in place on the
    gradient of ``loss``; parameters the loss leaves out get zeros, as
    ``jax.grad`` gives them.  Returns the new optimizer state."""
    params = dict(module.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(params.items(), grads)}
    return tx.update(params, grads, opt_state)


@torch.no_grad()
def soft_update(target: torch.nn.Module, online: torch.nn.Module,
                tau: float) -> None:
    """``target <- target + tau (online - target)``, over every tensor."""
    torch._foreach_lerp_(list(target.parameters()),
                         list(online.parameters()), tau)


def td_target(batch, q_next: torch.Tensor, gamma: float) -> torch.Tensor:
    """``r + gamma (1 - terminated) q_next``."""
    not_done = 1.0 - batch[SB.TERMINATEDS].float()
    return batch[SB.REWARDS] + gamma * not_done * q_next


def make_twin_critic(obs_dim: int, act_dim: int, hidden: Iterable[int],
                     device, seed: int):
    """(critic, target_critic): a TwinQ with weights from ``seed`` and a
    separate copy of it that takes no gradients."""
    critic = M.init_params(M.TwinQ(obs_dim, act_dim, tuple(hidden),
                                   device=device), seed)
    return critic, copy.deepcopy(critic).requires_grad_(False)


def draw_batches(buffer, mb: int, n: int, device):
    """``n`` minibatches of ``mb`` rows from a uniform buffer (the rows
    ``n`` calls of ``sample(mb)`` give), staged on ``device`` in one
    copy per column: the buffer does not change during an iteration's
    updates."""
    from ray_tpu_torch.rl.algorithm import to_device
    samples = [buffer.sample(mb) for _ in range(n)]
    staged = to_device({k: np.concatenate([s[k] for s in samples])
                        for k in TRANSITION_KEYS}, device)
    return [{k: v[i * mb:(i + 1) * mb] for k, v in staged.items()}
            for i in range(n)]


# ---------------------------------------------------------------- SAC

def make_sac_update(cfg, txs: Dict[str, AdamW], rescale: Rescale,
                    target_entropy: float):
    """``update(state, batch, noise) -> aux``: the update of
    ``ray_tpu/rl/sac.py`` on the modules and optimizer states of
    ``state``, in place.  ``noise`` [2, B, A] holds the standard
    normals of the next-state sample and of the actor's.  As in JAX:
    alpha is exp of the old ``log_alpha`` in both the target and the
    actor loss; the actor loss reads the updated critic; the alpha loss
    reads the actor loss's logp with the gradient stopped; the soft
    target update follows the updated critic.  ``aux`` holds 0-d
    tensors."""
    gamma, tau = cfg.gamma, cfg.tau

    def update(state, batch, noise):
        actor, critic = state["actor"], state["critic"]
        log_alpha = state["log_alpha"]
        obs = batch[SB.OBS]
        with torch.no_grad():
            alpha = log_alpha.exp()
            # critic: soft Bellman target from the fresh policy
            mean_n, log_std_n = actor(batch[SB.NEXT_OBS])
            a_next, logp_next = M.squash(mean_n, log_std_n, noise[0])
            q1_t, q2_t = state["target_critic"](batch[SB.NEXT_OBS],
                                                rescale(a_next))
            target = td_target(batch, torch.minimum(q1_t, q2_t)
                               - alpha * logp_next, gamma)
        q1, q2 = critic(obs, batch[SB.ACTIONS])
        c_loss = ((q1 - target).square()
                  + (q2 - target).square()).mean() * 0.5
        state["critic_opt"] = grad_step(critic, c_loss, txs["critic"],
                                        state["critic_opt"])
        # actor: reparameterised max-entropy objective on the new critic
        mean, log_std = actor(obs)
        a, logp = M.squash(mean, log_std, noise[1])
        q1_pi, q2_pi = critic(obs, rescale(a))
        a_loss = (alpha * logp - torch.minimum(q1_pi, q2_pi)).mean()
        state["actor_opt"] = grad_step(actor, a_loss, txs["actor"],
                                       state["actor_opt"])
        # temperature: -(log_alpha * (logp + target_entropy)).mean(),
        # whose gradient is the mean with the sign flipped
        x = logp.detach() + target_entropy
        al_loss = -(log_alpha.detach() * x).mean()
        state["alpha_opt"] = txs["alpha"].update(
            {"log_alpha": log_alpha}, {"log_alpha": -x.mean()},
            state["alpha_opt"])
        soft_update(state["target_critic"], critic, tau)
        return {"critic_loss": c_loss.detach(),
                "actor_loss": a_loss.detach(), "alpha_loss": al_loss,
                "alpha": alpha,
                "mean_q": ((q1.mean() + q2.mean()) * 0.5).detach(),
                "entropy": -logp.detach().mean()}

    return update


class SAC(Algorithm):
    @classmethod
    def extra_worker_kwargs(cls, config: AlgorithmConfig) -> Dict[str, Any]:
        return {"policy": "sac"}

    def setup_learner(self) -> None:
        cfg: SACConfig = self.config
        obs_dim, self.act_dim, low, high = continuous_spaces(cfg.env_spec,
                                                             "SAC")
        seed = cfg.seed or 0
        actor = M.init_params(M.SquashedGaussianActor(
            obs_dim, self.act_dim, tuple(cfg.hidden), device=self.device),
            seed)
        critic, target = make_twin_critic(obs_dim, self.act_dim, cfg.hidden,
                                          self.device, seed + 1)
        log_alpha = torch.nn.Parameter(torch.tensor(
            float(np.log(cfg.initial_alpha)), device=self.device))
        self.target_entropy = -float(self.act_dim) \
            if cfg.target_entropy == "auto" else float(cfg.target_entropy)
        self.txs = {k: adam(cfg.lr) for k in ("actor", "critic", "alpha")}
        self.state = {
            "actor": actor, "critic": critic, "target_critic": target,
            "log_alpha": log_alpha,
            "actor_opt": self.txs["actor"].init(dict(
                actor.named_parameters())),
            "critic_opt": self.txs["critic"].init(dict(
                critic.named_parameters())),
            "alpha_opt": self.txs["alpha"].init({"log_alpha": log_alpha}),
        }
        self.model = actor          # what the rollout workers receive
        self.rescale = Rescale(low, high, self.device)
        self.buffer = ReplayBuffer(cfg.buffer_size, seed=cfg.seed)
        self._gen = torch.Generator(device=self.device).manual_seed(
            (cfg.seed or 0) + 17)
        self._update = make_sac_update(cfg, self.txs, self.rescale,
                                       self.target_entropy)

    def draw_noise(self, rows: int) -> torch.Tensor:
        """One update's standard normals [2, rows, A]: ``eps_next``,
        then ``eps_pi``."""
        return torch.randn((2, rows, self.act_dim), generator=self._gen,
                           device=self.device)

    def training_step(self) -> Dict[str, Any]:
        cfg: SACConfig = self.config
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
        """``n_updates_per_iter`` updates on replayed minibatches; the
        last one's aux as floats (reading them waits for the device)."""
        mb = self.round_minibatch(self.config.train_batch_size)
        aux: Dict[str, Any] = {}
        for batch in draw_batches(self.buffer, mb,
                                  self.config.n_updates_per_iter,
                                  self.device):
            aux = self._update(self.state, batch, self.draw_noise(mb))
        return {k: float(v) for k, v in aux.items()}
