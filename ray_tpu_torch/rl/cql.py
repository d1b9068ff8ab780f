"""CQL: conservative Q-learning for offline continuous control
(counterpart of ray_tpu/rl/cql.py).

Analog of RLlib's rllib/algorithms/cql/cql.py (+ cql_torch_policy.py):
SAC's twin-critic max-entropy update (a fixed entropy weight of 0.1)
plus the conservative regulariser E_s[logsumexp_a Q(s, a)] -
E_(s,a)~D[Q(s, a)], estimated with ``num_actions`` random and
``num_actions`` policy actions.  Trains from a ``JsonReader`` dataset
with no rollout workers, one update per minibatch on the learner's one
device (the card unless ``.resources(device="cpu")``; without a card it
raises).  The dataset goes to the device once; each call's minibatch
rows are the JAX learner's (``np.random.default_rng(seed + 1000 *
iteration)`` ``choice`` without replacement), gathered there.

The critics take the dataset's actions as they are, in env space, and
the sampled ones through ``rescale`` (the JAX module's comment that
dataset actions live in tanh space does not match its code; the code
is followed).  The conservative term's policy actions come from the
actor before its update, with no gradient into it.  Each update's noise
is drawn ahead of it from the learner's generator, in the JAX package's
key order: ``eps_next`` and ``eps_pi`` [2, B, A], the random actions
[n, B, A] uniform in [-1, 1], then the policy actions' normals [n, B, A].
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.rl import models as M
from ray_tpu_torch.rl import sample_batch as SB
from ray_tpu_torch.rl.algorithm import (apply_full_training_state,
                                        full_training_state,
                                        learner_device, to_device)
from ray_tpu_torch.rl.offline import JsonReader, MARWILConfig
from ray_tpu_torch.rl.policy import load_weights, module_weights
from ray_tpu_torch.rl.sac import (TRANSITION_KEYS, Rescale, adam,
                                  continuous_spaces, grad_step,
                                  make_twin_critic, soft_update, td_target)

ALPHA_ENT = 0.1          # CQL's fixed entropy weight (offline)


class CQLConfig(MARWILConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = CQL
        self.lr = 3e-4
        self.cql_alpha = 1.0            # weight of the conservative term
        self.num_actions = 4            # sampled actions for logsumexp
        self.tau = 0.005
        self.initial_alpha = 1.0
        self.train_batch_size = 256
        self.num_sgd_iter = 64          # updates per train() call


def make_cql_update(cfg, txs, rescale: Rescale):
    """``update(state, batch, noise) -> aux``: the update of
    ``ray_tpu/rl/cql.py`` on ``state`` in place; ``noise`` a dict of
    ``eps`` [2, B, A], ``uniform`` [n, B, A] and ``eps_cql`` [n, B, A]
    (``CQL.draw_noise``).  ``aux`` holds 0-d tensors."""
    gamma, tau, cql_alpha = cfg.gamma, cfg.tau, cfg.cql_alpha

    def update(state, batch, noise):
        actor, critic = state["actor"], state["critic"]
        obs = batch[SB.OBS]
        with torch.no_grad():
            # soft Bellman target
            mean_n, log_std_n = actor(batch[SB.NEXT_OBS])
            a_next, logp_next = M.squash(mean_n, log_std_n,
                                         noise["eps"][0])
            q1_t, q2_t = state["target_critic"](batch[SB.NEXT_OBS],
                                                rescale(a_next))
            target = td_target(batch, torch.minimum(q1_t, q2_t)
                               - ALPHA_ENT * logp_next, gamma)
            # the conservative term's actions: random, and the actor's
            # before its update
            mean_c, log_std_c = actor(obs)
            pol_a, _ = M.squash(mean_c, log_std_c, noise["eps_cql"])
            all_a = rescale(torch.cat([noise["uniform"], pol_a]))
        q1, q2 = critic(obs, batch[SB.ACTIONS])
        bellman = ((q1 - target).square()
                   + (q2 - target).square()).mean() * 0.5
        q1_all, q2_all = critic(obs.expand((all_a.shape[0],) + obs.shape),
                                all_a)                      # [2n, B]
        conservative = ((torch.logsumexp(q1_all, 0) - q1)
                        + (torch.logsumexp(q2_all, 0) - q2)).mean() * 0.5
        c_loss = bellman + cql_alpha * conservative
        state["critic_opt"] = grad_step(critic, c_loss, txs["critic"],
                                        state["critic_opt"])
        # actor: SAC's objective on the updated critic
        mean, log_std = actor(obs)
        a, logp = M.squash(mean, log_std, noise["eps"][1])
        q1_pi, q2_pi = critic(obs, rescale(a))
        a_loss = (ALPHA_ENT * logp - torch.minimum(q1_pi, q2_pi)).mean()
        state["actor_opt"] = grad_step(actor, a_loss, txs["actor"],
                                       state["actor_opt"])
        soft_update(state["target_critic"], critic, tau)
        return {"critic_loss": c_loss.detach(),
                "bellman_loss": bellman.detach(),
                "cql_loss": conservative.detach(),
                "actor_loss": a_loss.detach(), "mean_q": q1.detach().mean()}

    return update


class CQL:
    """Offline learner over a dataset with ``next_obs``: a
    squashed-Gaussian actor and twin critics with a soft target, one
    ``optax.adam`` each, in ``self.state``; ``train()`` runs
    ``num_sgd_iter`` updates.  CRR (``rl/crr.py``) shares all but the
    update and its noise."""

    name = "CQL"
    seed_offset = 31            # the JAX package's PRNGKey(seed + 31)

    def __init__(self, config: CQLConfig):
        self.config = config
        if config.input_path is None:
            raise ValueError("config.offline_data(input_path=...) required")
        self.device = learner_device(config)
        self.dataset = JsonReader(config.input_path).read_all()
        if SB.NEXT_OBS not in self.dataset:
            raise ValueError(f"{self.name} needs next_obs in the offline "
                             "dataset (collect with collect_dataset)")
        self.iteration = 0
        self._timesteps_total = 0
        obs_dim, self.act_dim, low, high = continuous_spaces(
            config.env_spec, self.name)
        seed = config.seed or 0
        actor = M.init_params(M.SquashedGaussianActor(
            obs_dim, self.act_dim, tuple(config.hidden),
            device=self.device), seed)
        critic, target = make_twin_critic(obs_dim, self.act_dim,
                                          config.hidden, self.device,
                                          seed + 1)
        self.txs = {"actor": adam(config.lr), "critic": adam(config.lr)}
        self.state = {
            "actor": actor, "critic": critic, "target_critic": target,
            "actor_opt": self.txs["actor"].init(dict(
                actor.named_parameters())),
            "critic_opt": self.txs["critic"].init(dict(
                critic.named_parameters())),
        }
        self.model = actor
        self.rescale = Rescale(low, high, self.device)
        # the dataset's columns on the device once; minibatches gather
        self._staged = to_device({k: self.dataset[k]
                                  for k in TRANSITION_KEYS}, self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(
            seed + self.seed_offset)
        self._update = self.make_update()

    def make_update(self):
        return make_cql_update(self.config, self.txs, self.rescale)

    def draw_noise(self, rows: int) -> Dict[str, torch.Tensor]:
        """One update's noise, in the JAX package's key order."""
        n, shape = self.config.num_actions, (rows, self.act_dim)
        kw = dict(generator=self._gen, device=self.device)
        eps = torch.randn((2,) + shape, **kw)
        uniform = torch.rand((n,) + shape, **kw) * 2.0 - 1.0
        return {"eps": eps, "uniform": uniform,
                "eps_cql": torch.randn((n,) + shape, **kw)}

    def minibatch_rows(self):
        """This call's ``num_sgd_iter`` minibatches' row indices, as the
        JAX learner draws them."""
        cfg, n = self.config, self.dataset.count
        rng = np.random.default_rng((cfg.seed or 0) + self.iteration * 1000)
        return [rng.choice(n, size=min(cfg.train_batch_size, n),
                           replace=False)
                for _ in range(cfg.num_sgd_iter)]

    def get_weights(self) -> Any:
        return module_weights(self.model)

    def set_weights(self, weights: Any) -> None:
        load_weights(self.model, weights)

    def train(self) -> Dict[str, Any]:
        rows = torch.as_tensor(np.stack(self.minibatch_rows()),
                               device=self.device)
        aux: Dict[str, Any] = {}
        for idx in rows:
            aux = self._update(self.state,
                               {k: v[idx] for k, v in self._staged.items()},
                               self.draw_noise(idx.shape[0]))
            self._timesteps_total += idx.shape[0]
        self.iteration += 1
        return {"info": {k: float(v) for k, v in aux.items()},
                "training_iteration": self.iteration,
                "timesteps_total": self._timesteps_total}

    def save(self) -> Checkpoint:
        return Checkpoint.from_dict({
            "state": full_training_state(self), "iteration": self.iteration})

    def restore(self, checkpoint: Checkpoint) -> None:
        d = checkpoint.to_dict()
        apply_full_training_state(self, d["state"])
        self.iteration = d.get("iteration", 0)

    def stop(self) -> None:
        pass
