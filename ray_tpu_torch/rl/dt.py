"""DT: Decision Transformer — RL as conditional sequence modeling
(counterpart of ray_tpu/rl/dt.py).

Analog of RLlib's rllib/algorithms/dt/ (the return-conditioned
transformer of Chen et al. 2021): interleaved (return-to-go, state,
action) token triples through a causal transformer (the port's GPT
``Block`` stack — RoPE provides the timestep geometry), action predicted
at each state token.  Offline: trains from a ``JsonReader`` dataset;
evaluation rolls the env conditioned on a target return.

The model runs where the learner lives (the card unless
``.resources(device="cpu")``) with ``attention_impl="auto"``: on the
card each block's attention goes through the flash kernels K1 (forward)
and K2 / K3 (backward) at head_dim ``d_model // n_heads`` (32 at the
default widths), in fp32; on the CPU through the plain attention.  The
optimizer is ``optax.chain(clip_by_global_norm(1.0), adamw(lr,
weight_decay=1e-4))`` with no mask: every parameter decays, biases and
norm scales too (``train/step.py`` ``AdamW(mask=decay_all)``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.models.configs import TransformerConfig
from ray_tpu_torch.models.convert import block_leaves, dense_leaves
from ray_tpu_torch.models.gpt import Block, RMSNorm
from ray_tpu_torch.ops.layers import rope_frequencies
from ray_tpu_torch.rl import models as M
from ray_tpu_torch.rl import sample_batch as SB
from ray_tpu_torch.rl.algorithm import (AlgorithmConfig, learner_device,
                                        to_device)
from ray_tpu_torch.rl.env import Box, make_env
from ray_tpu_torch.rl.offline import JsonReader
from ray_tpu_torch.rl.policy import load_weights, module_weights
from ray_tpu_torch.train.step import AdamW, decay_all


class DTConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = DT
        self.input_path: Optional[str] = None
        self.context_len = 20           # K timesteps of (R, s, a) context
        self.d_model = 128
        self.n_layers = 3
        self.n_heads = 4
        self.lr = 1e-4
        self.train_batch_size = 64
        self.num_sgd_iter = 50
        self.target_return: Optional[float] = None   # None -> dataset max

    def offline_data(self, *, input_path: Optional[str] = None,
                     **kwargs) -> "DTConfig":
        if input_path is not None:
            self.input_path = input_path
        self.extra.update(kwargs)
        return self


class _DTModel(nn.Module):
    """(rtg [B, K], obs [B, K, obs], act [B, K, act]) -> per-state-token
    action logits [B, K, act]."""

    def __init__(self, obs_dim: int, act_dim: int, d_model: int,
                 n_layers: int, n_heads: int, context_len: int, *,
                 attention_impl: str = "auto", device=None):
        super().__init__()
        device = resolve_device(device)
        # the block stack's config as ray_tpu/rl/dt.py builds it: fp32, no
        # remat, 3K positions
        self.cfg = cfg = TransformerConfig(
            vocab_size=1, d_model=d_model, n_layers=n_layers,
            n_heads=n_heads, d_ff=4 * d_model, max_seq_len=3 * context_len,
            dtype=torch.float32, remat=False, scan_layers=True,
            attention_impl=attention_impl)
        kw = dict(device=device)
        self.embed_rtg = nn.Linear(1, d_model, **kw)
        self.embed_obs = nn.Linear(obs_dim, d_model, **kw)
        self.embed_act = nn.Linear(act_dim, d_model, **kw)
        self.blocks = nn.ModuleList(Block(cfg, **kw)
                                    for _ in range(n_layers))
        self.final_norm = RMSNorm(d_model, **kw)
        self.action_head = nn.Linear(d_model, act_dim, **kw)
        cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                    device=device)
        self.register_buffer("cos", cos, persistent=False)
        self.register_buffer("sin", sin, persistent=False)

    def forward(self, rtg, obs, act):
        b, k = rtg.shape[:2]
        e_r = self.embed_rtg(rtg[..., None])
        e_s = self.embed_obs(obs)
        e_a = self.embed_act(act)
        # interleave [r_1, s_1, a_1, r_2, ...] -> [B, 3K, D]
        x = torch.stack([e_r, e_s, e_a], dim=2).reshape(b, 3 * k, -1)
        for blk in self.blocks:
            x, _ = blk(x, self.cos, self.sin)
        x = self.final_norm(x)
        # state tokens sit at positions 3t+1; predict a_t there
        return self.action_head(x[:, 1::3])

    def jax_leaves(self):
        """The JAX model's parameter leaves (``models/convert.py``
        ``model_leaves``): the dense embeddings, ``final_norm`` and the
        head as named here, and the scanned ``Block`` stack as the GPT's
        ``blocks``."""
        return dense_leaves(self, skip="blocks.") + block_leaves(self.cfg)


def dt_loss(model, rtg, obs, act_onehot, act_labels, mask):
    """(masked mean NLL of the labelled actions, masked accuracy)."""
    logits = model(rtg, obs, act_onehot)
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, act_labels[..., None])[..., 0]
    denom = mask.sum().clamp_min(1.0)
    loss = (nll * mask).sum() / denom
    acc = ((logits.argmax(-1) == act_labels) * mask).sum() / denom
    return loss, acc.detach()


class DT:
    def __init__(self, config: DTConfig):
        self.config = config
        if config.input_path is None:
            raise ValueError("config.offline_data(input_path=...) required")
        self.device = learner_device(config)
        probe = make_env(config.env_spec)
        if isinstance(probe.action_space, Box):
            raise ValueError("this DT implementation handles discrete "
                             "action spaces (RLlib's dt targets d4rl; "
                             "the discrete path covers the in-repo envs)")
        self.act_dim = probe.action_space.n
        self.obs_dim = int(np.prod(probe.observation_space.shape))
        probe.close()

        self._episodes = self._load_episodes(config)
        self._ep_returns = [float(ep["rtg"][0]) for ep in self._episodes]
        self.target_return = (config.target_return
                              if config.target_return is not None
                              else max(self._ep_returns))

        self.model = M.init_params(_DTModel(
            self.obs_dim, self.act_dim, config.d_model, config.n_layers,
            config.n_heads, config.context_len, device=self.device),
            config.seed or 0)
        lr = config.lr
        self.tx = AdamW(lambda count: lr, b1=0.9, b2=0.999,
                        weight_decay=1e-4, grad_clip=1.0, mask=decay_all)
        self.opt_state = self.tx.init(self.params)
        self.iteration = 0
        self._timesteps_total = 0
        self._np_rng = np.random.default_rng(config.seed or 0)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def sgd_step(self, rtg, obs, act_onehot, labels, mask):
        """One update from device tensors: (loss, accuracy), 0-d tensors
        (reading them waits for the device)."""
        params = self.params
        loss, acc = dt_loss(self.model, rtg, obs, act_onehot, labels, mask)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        self.opt_state = self.tx.update(params, grads, self.opt_state)
        return loss.detach(), acc

    @staticmethod
    def _load_episodes(config) -> List[Dict[str, np.ndarray]]:
        data = JsonReader(config.input_path).read_all()
        episodes = []
        for ep in data.split_by_episode():
            rew = np.asarray(ep[SB.REWARDS], np.float32)
            rtg = np.cumsum(rew[::-1])[::-1].copy()   # returns-to-go
            episodes.append({
                "obs": np.asarray(ep[SB.OBS], np.float32),
                "act": np.asarray(ep[SB.ACTIONS], np.int64),
                "rtg": rtg})
        return episodes

    def _sample_batch(self, batch_size: int):
        K = self.config.context_len
        rtg = np.zeros((batch_size, K), np.float32)
        obs = np.zeros((batch_size, K, self.obs_dim), np.float32)
        act = np.zeros((batch_size, K), np.int64)
        mask = np.zeros((batch_size, K), np.float32)
        for i in range(batch_size):
            ep = self._episodes[self._np_rng.integers(len(self._episodes))]
            T = len(ep["act"])
            start = int(self._np_rng.integers(max(T, 1)))
            seg = slice(start, min(start + K, T))
            n = seg.stop - seg.start
            rtg[i, :n] = ep["rtg"][seg]
            obs[i, :n] = ep["obs"][seg]
            act[i, :n] = ep["act"][seg]
            mask[i, :n] = 1.0
        onehot = np.eye(self.act_dim, dtype=np.float32)[act]
        # teacher forcing: the action token at t carries a_t; the
        # prediction at the state token sees only r<=t, s<=t, a<t (causal)
        return rtg, obs, onehot, act, mask

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        loss = acc = torch.zeros(())
        for _ in range(cfg.num_sgd_iter):
            arrays = self._sample_batch(cfg.train_batch_size)
            loss, acc = self.sgd_step(*to_device(arrays, self.device))
            self._timesteps_total += int(arrays[-1].sum())
        self.iteration += 1
        result = {"info": {"loss": float(loss),
                           "action_accuracy": float(acc),
                           "target_return": self.target_return},
                  "training_iteration": self.iteration,
                  "timesteps_total": self._timesteps_total}
        result.update(self.evaluate())
        return result

    @torch.no_grad()
    def evaluate(self, episodes: int = 3,
                 max_steps: int = 500) -> Dict[str, Any]:
        """Return-conditioned rollout at the target return."""
        K = self.config.context_len
        env = make_env(self.config.env_spec)
        totals = []
        for ep in range(episodes):
            ob, _ = env.reset(seed=2000 + ep)
            rtg_hist = [float(self.target_return)]
            obs_hist = [np.asarray(ob, np.float32)]
            act_hist: List[int] = []
            total, done, steps = 0.0, False, 0
            while not done and steps < max_steps:
                n = len(obs_hist)
                lo = max(n - K, 0)
                rtg = np.zeros((1, K), np.float32)
                obs = np.zeros((1, K, self.obs_dim), np.float32)
                act = np.zeros((1, K), np.int64)
                seg_n = n - lo
                rtg[0, :seg_n] = rtg_hist[lo:]
                obs[0, :seg_n] = np.stack(obs_hist[lo:])
                acts = act_hist[lo:]
                if acts:
                    act[0, :len(acts)] = acts
                onehot = np.eye(self.act_dim, dtype=np.float32)[act]
                logits = self.model(*to_device((rtg, obs, onehot),
                                               self.device))
                a = int(logits[0, seg_n - 1].argmax())
                ob, r, term, trunc, _ = env.step(a)
                total += r
                act_hist.append(a)
                rtg_hist.append(rtg_hist[-1] - r)
                obs_hist.append(np.asarray(ob, np.float32))
                done = term or trunc
                steps += 1
            totals.append(total)
        env.close()
        return {"episode_reward_mean": float(np.mean(totals)),
                "episodes_total": episodes}

    def get_weights(self) -> Any:
        return module_weights(self.model)

    def set_weights(self, weights: Any) -> None:
        load_weights(self.model, weights)

    def save(self) -> Checkpoint:
        return Checkpoint.from_dict({
            "weights": self.get_weights(), "iteration": self.iteration,
            "target_return": self.target_return})

    def restore(self, checkpoint: Checkpoint) -> None:
        d = checkpoint.to_dict()
        self.set_weights(d["weights"])
        self.iteration = d.get("iteration", 0)
        self.target_return = d.get("target_return", self.target_return)

    def stop(self) -> None:
        pass
