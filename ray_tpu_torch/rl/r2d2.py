"""R2D2: recurrent replay distributed DQN (counterpart of
ray_tpu/rl/r2d2.py).

Analog of RLlib's rllib/algorithms/r2d2/r2d2.py (Kapturowski et al.): an
LSTM Q-network (``RecurrentQNetwork``) trained on replayed fixed-length
sequences with the zero-start-state strategy — each sequence replays
from a zero carry, and the first ``burn_in`` steps only warm the hidden
state (no loss).  Double-Q targets come from a target network, a copy
synced every ``target_update_freq`` env steps; rollouts run the
recurrent epsilon-greedy ``R2D2Policy`` on the CPU.  Three masks take
steps out of the loss: burn-in, each sequence's last step (no successor
within the sequence) and truncated steps (their successor is the
auto-reset episode's first obs); steps after an episode's end are
already invalid (``seq_valid``).
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rl import models as M
from ray_tpu_torch.rl import sample_batch as SB
from ray_tpu_torch.rl.algorithm import AlgorithmConfig
from ray_tpu_torch.rl.dqn import DQN, huber_loss, make_td_step, take
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.policy import action_dims
from ray_tpu_torch.rl.ppo import make_ppo_optimizer
from ray_tpu_torch.rl.replay_buffer import ReplayBuffer

R2D2_KEYS = (SB.OBS, SB.ACTIONS, SB.REWARDS, SB.TERMINATEDS, SB.TRUNCATEDS,
             "seq_valid")


class R2D2Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = R2D2
        self.lr = 5e-4
        self.lstm_size = 64
        self.hidden = (64,)
        self.rollout_fragment_length = 40   # sequence length L
        self.burn_in = 8                    # carry warmup, no loss
        self.train_batch_size = 16          # sequences per update
        self.buffer_size = 2000             # stored sequences
        self.learning_starts = 64           # sequences before updates
        self.target_update_freq = 1000      # env steps between syncs
        self.n_updates_per_iter = 16
        self.double_q = True
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_timesteps = 20_000


def r2d2_mask(batch, burn_in: int) -> torch.Tensor:
    """The [B, L] loss mask: valid steps, less the burn-in, the last
    column and truncated steps."""
    mask = batch["seq_valid"].float().clone()
    mask[:, :burn_in] = 0.0                  # carry warmup only
    mask[:, -1] = 0.0                        # no successor
    return mask * (1.0 - batch[SB.TRUNCATEDS].float())


def make_r2d2_td_step(model, target_model, tx, cfg):
    """The sequence TD step of ``ray_tpu/rl/r2d2.py``: both networks
    replay each [B, L] sequence from a zero carry; the target of step t
    bootstraps from position t + 1 of the same replay (double-Q: the
    online argmax, the target's value); the Huber loss averages over
    ``r2d2_mask``.  ``aux``: ``mean_q``, ``trained_steps`` (the mask's
    sum, at least 1), ``loss``, ``grad_norm``."""
    gamma, double_q, burn_in = cfg.gamma, cfg.double_q, cfg.burn_in

    def loss_fn(batch):
        B = batch[SB.REWARDS].shape[0]
        carry = model.initial_state(B)
        q_seq, _ = model(batch[SB.OBS], carry)
        q_taken = take(q_seq, batch[SB.ACTIONS])
        with torch.no_grad():
            tq_seq, _ = target_model(batch[SB.OBS], carry)
            # q(s_{t+1}) is position t+1 of the replay; the last column
            # repeats itself and is masked out of the loss
            q_next_online = torch.cat([q_seq[:, 1:], q_seq[:, -1:]], 1)
            q_next_target = torch.cat([tq_seq[:, 1:], tq_seq[:, -1:]], 1)
            if double_q:
                q_next = take(q_next_target,
                              torch.argmax(q_next_online, dim=-1))
            else:
                q_next = q_next_target.max(-1).values
            not_done = 1.0 - batch[SB.TERMINATEDS].float()
            target = batch[SB.REWARDS] + gamma * not_done * q_next
            mask = r2d2_mask(batch, burn_in)
            denom = mask.sum().clamp(min=1.0)
        huber = huber_loss(q_taken, target)
        loss = (huber * mask).sum() / denom
        return loss, {"mean_q": (q_taken * mask).sum() / denom,
                      "trained_steps": denom}

    return make_td_step(loss_fn, model, tx)


class R2D2(DQN):
    """R2D2 on DQN's plumbing (target sync, epsilon schedule, replay
    loop) with the recurrent network and sequence replay; no PER."""

    @classmethod
    def extra_worker_kwargs(cls, config: AlgorithmConfig) -> Dict[str, Any]:
        return {"policy": "r2d2",
                "policy_kwargs": {"lstm_size": getattr(config, "lstm_size",
                                                       64)}}

    def setup_learner(self) -> None:
        cfg: R2D2Config = self.config
        probe = make_env(cfg.env_spec)
        obs_dim, act_dim, continuous = action_dims(probe.observation_space,
                                                   probe.action_space)
        probe.close()
        if continuous:
            raise ValueError("R2D2 requires a discrete action space")
        self.model = M.init_params(M.RecurrentQNetwork(
            obs_dim, act_dim, tuple(cfg.hidden), cfg.lstm_size,
            device=self.device), cfg.seed or 0)
        self.target_model = copy.deepcopy(self.model).requires_grad_(False)
        self.tx = make_ppo_optimizer(cfg)
        self.opt_state = self.tx.init(self.params)
        self.buffer = ReplayBuffer(cfg.buffer_size, seed=cfg.seed)
        self._steps_since_target_sync = 0
        self._td_step = make_r2d2_td_step(self.model, self.target_model,
                                          self.tx, cfg)

    def training_step(self) -> Dict[str, Any]:
        cfg: R2D2Config = self.config
        self.workers.foreach_worker("set_epsilon", self._epsilon())
        for b in self.workers.foreach_worker("sample_sequences"):
            # rows are [L, ...] sequences; steps count the valid ones
            self._add(b, int(np.sum(b["seq_valid"])))
        info: Dict[str, Any] = {"epsilon": self._epsilon(),
                                "buffer_sequences": len(self.buffer)}
        if len(self.buffer) < cfg.learning_starts:
            return {"info": info}
        self._replay_updates(R2D2_KEYS, info)
        self.workers.sync_weights(self.get_weights())
        return {"info": info}
