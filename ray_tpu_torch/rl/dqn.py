"""DQN: off-policy Q-learning with replay, a target network, double-Q and
a dueling head (counterpart of ray_tpu/rl/dqn.py).

Analog of RLlib's rllib/algorithms/dqn/dqn.py (training_step: sample →
store → replay → TD update → periodic target sync) with the loss of
dqn_torch_policy.py (Huber TD error, double-Q action selection).  The TD
step runs on the learner's device; rollout actors run the epsilon-greedy
``QPolicy`` on the CPU.

The target network is a module of its own (``self.target_model``), and a
sync copies the online weights into it: the optimizer updates
``self.model`` in place, so an alias would make the target track the
online network (the JAX package's ``self.target_params = self.params``
is a snapshot only because its arrays are immutable).  The optimizer is
``optax.chain(clip_by_global_norm(grad_clip), adam(lr))``
(``make_ppo_optimizer``).  Under prioritized replay each TD step sends
``|td_error| + 1e-6`` back to the host buffer, one device-to-host copy a
step, as the JAX package does.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rl import models as M
from ray_tpu_torch.rl import sample_batch as SB
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.policy import action_dims
from ray_tpu_torch.rl.ppo import make_ppo_optimizer
from ray_tpu_torch.rl.replay_buffer import (PrioritizedReplayBuffer,
                                            ReplayBuffer)
from ray_tpu_torch.train.step import global_norm

# the columns the TD loss reads ("weights" only under PER)
DQN_KEYS = (SB.OBS, SB.ACTIONS, SB.REWARDS, SB.NEXT_OBS, SB.TERMINATEDS,
            "weights")


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = DQN
        self.lr = 5e-4
        self.train_batch_size = 32
        self.buffer_size = 50_000
        self.learning_starts = 1000
        self.target_update_freq = 500        # in sampled env steps
        self.n_updates_per_iter = 32         # TD steps per training_step
        self.double_q = True
        self.dueling = True
        self.prioritized_replay = False
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.02
        self.epsilon_timesteps = 10_000
        self.rollout_fragment_length = 32
        self.num_sgd_iter = 1                # unused; kept for config parity


def huber_loss(pred, target, delta: float = 1.0) -> torch.Tensor:
    """optax's ``huber_loss``: 0.5 e^2 where |e| <= delta, else
    delta (|e| - 0.5 delta), elementwise."""
    abs_err = (pred - target).abs()
    quad = abs_err.clamp(max=delta)
    return 0.5 * quad.square() + delta * (abs_err - quad)


def take(q, actions) -> torch.Tensor:
    """``q[..., actions]`` per row (``jnp.take_along_axis``): actions
    are int32 in the batches, int64 as torch indices."""
    return q.gather(-1, actions.long()[..., None])[..., 0]


def make_td_step(loss_fn, model, tx):
    """``td_step(opt_state, batch) -> (opt_state, aux)``: one update of
    ``model`` in place by ``loss_fn(batch) -> (loss, aux)``; ``aux``
    gains the loss and the gradient's global norm before clipping."""
    def td_step(opt_state, batch):
        params = dict(model.named_parameters())
        loss, aux = loss_fn(batch)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        aux = {k: v.detach() for k, v in aux.items()}
        aux["loss"] = loss.detach()
        aux["grad_norm"] = global_norm(grads.values())
        return tx.update(params, grads, opt_state), aux
    return td_step


def make_dqn_td_step(model, target_model, tx, cfg):
    """The TD step of ``ray_tpu/rl/dqn.py``: Huber loss (delta 1) of
    Q(s, a) against r + gamma (1 - terminated) Q_target(s', a'), a' the
    online argmax (double-Q) or the target's max; PER weights scale each
    row's loss.  ``aux``: ``mean_q``, ``td_error`` (per row), ``loss``,
    ``grad_norm``."""
    gamma, double_q = cfg.gamma, cfg.double_q

    def loss_fn(batch):
        q_taken = take(model(batch[SB.OBS]), batch[SB.ACTIONS])
        with torch.no_grad():
            q_next_target = target_model(batch[SB.NEXT_OBS])
            if double_q:
                # the online net picks the action, the target evaluates it
                next_a = torch.argmax(model(batch[SB.NEXT_OBS]), dim=-1)
                q_next = take(q_next_target, next_a)
            else:
                q_next = q_next_target.max(-1).values
            not_done = 1.0 - batch[SB.TERMINATEDS].float()
            target = batch[SB.REWARDS] + gamma * not_done * q_next
        td = q_taken - target
        huber = huber_loss(q_taken, target)
        weights = batch.get("weights")
        loss = (huber * weights).mean() if weights is not None \
            else huber.mean()
        return loss, {"mean_q": q_taken.mean(), "td_error": td}

    return make_td_step(loss_fn, model, tx)


class DQN(Algorithm):
    @classmethod
    def extra_worker_kwargs(cls, config: AlgorithmConfig) -> Dict[str, Any]:
        return {"policy": "q",
                "policy_kwargs": {"dueling": getattr(config, "dueling",
                                                     True)}}

    def setup_learner(self) -> None:
        cfg: DQNConfig = self.config
        probe = make_env(cfg.env_spec)
        obs_dim, act_dim, continuous = action_dims(probe.observation_space,
                                                   probe.action_space)
        probe.close()
        if continuous:
            raise ValueError("DQN requires a discrete action space")
        self.model = M.init_params(M.QNetwork(
            obs_dim, act_dim, tuple(cfg.hidden), cfg.dueling,
            device=self.device), cfg.seed or 0)
        self.target_model = copy.deepcopy(self.model).requires_grad_(False)
        self.tx = make_ppo_optimizer(cfg)
        self.opt_state = self.tx.init(self.params)
        buffer_cls = PrioritizedReplayBuffer if cfg.prioritized_replay \
            else ReplayBuffer
        self.buffer = buffer_cls(cfg.buffer_size, seed=cfg.seed)
        self._steps_since_target_sync = 0
        self._td_step = make_dqn_td_step(self.model, self.target_model,
                                         self.tx, cfg)

    def sync_target(self) -> None:
        """Hard target sync: copy the online weights into the target."""
        self.target_model.load_state_dict(self.model.state_dict())

    def set_weights(self, weights: Any) -> None:
        super().set_weights(weights)
        self.sync_target()

    def _epsilon(self) -> float:
        cfg: DQNConfig = self.config
        frac = min(self._timesteps_total / max(cfg.epsilon_timesteps, 1), 1.0)
        return cfg.epsilon_initial + frac * (
            cfg.epsilon_final - cfg.epsilon_initial)

    def _add(self, batch, steps: int) -> None:
        self.buffer.add(batch)
        self._timesteps_total += steps
        self._steps_since_target_sync += steps

    def _replay_updates(self, keys, info: Dict[str, Any]) -> None:
        """``n_updates_per_iter`` TD steps on replayed batches (priorities
        back to a PER buffer after each), then the hard target sync every
        ``target_update_freq`` sampled env steps; the last step's aux
        into ``info``."""
        cfg: DQNConfig = self.config
        mb = self.round_minibatch(cfg.train_batch_size)
        n = cfg.n_updates_per_iter
        aux_last: Dict[str, Any] = {}
        if isinstance(self.buffer, PrioritizedReplayBuffer):
            for _ in range(n):
                sample = self.buffer.sample(mb)
                self.opt_state, aux_last = self._td_step(
                    self.opt_state, self.stage_batch(sample, keys))
                self.buffer.update_priorities(
                    sample["batch_indexes"],
                    np.abs(aux_last["td_error"].cpu().numpy()) + 1e-6)
        else:
            # a uniform buffer does not change during the updates, so its
            # n samples (the same rows as one at a time) go to the device
            # in one copy per column: a copy from pageable host memory
            # waits for the device, which once per step would serialise
            # the host and the device
            samples = [self.buffer.sample(mb) for _ in range(n)]
            staged = self.stage_batch(
                {k: np.concatenate([s[k] for s in samples])
                 for k in samples[0].keys()}, keys)
            for i in range(n):
                self.opt_state, aux_last = self._td_step(
                    self.opt_state, {k: v[i * mb:(i + 1) * mb]
                                     for k, v in staged.items()})
        # periodic hard target sync (dqn.py target_network_update_freq)
        if self._steps_since_target_sync >= cfg.target_update_freq:
            self.sync_target()
            self._steps_since_target_sync = 0
            info["target_synced"] = True
        info.update({k: float(v.float().mean()) for k, v in aux_last.items()
                     if k != "td_error"})

    def training_step(self) -> Dict[str, Any]:
        cfg: DQNConfig = self.config
        # 1. sample transitions with the current epsilon
        self.workers.foreach_worker("set_epsilon", self._epsilon())
        for b in self.workers.foreach_worker("sample_transitions"):
            self._add(b, b.count)
        info: Dict[str, Any] = {"epsilon": self._epsilon(),
                                "buffer_size": len(self.buffer)}
        if len(self.buffer) < cfg.learning_starts:
            return {"info": info}
        # 2. replayed TD updates on the learner's device, 3. target sync
        self._replay_updates(DQN_KEYS, info)
        # 4. fresh online weights to the epsilon-greedy rollouts
        self.workers.sync_weights(self.get_weights())
        return {"info": info}
