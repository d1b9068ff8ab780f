"""Offline RL: SampleBatch JSON I/O, BC, MARWIL, off-policy estimators
(counterpart of ray_tpu/rl/offline.py).

Analog of RLlib's rllib/offline/ (json_writer.py / json_reader.py:
newline-delimited JSON of column batches; output config on any algorithm)
plus rllib/algorithms/{bc,marwil}: MARWIL's advantage-weighted regression
loss (marwil_torch_policy.py) with BC as its beta=0 special case, and the
importance-sampling / weighted-IS off-policy estimators
(rllib/offline/estimators/{importance_sampling,weighted_importance_sampling}.py).
The JSON format is the JAX package's, byte for byte, so either package
reads what the other wrote.  The learner is one device (the card unless
``.resources(device="cpu")``): the dataset is loaded once, and
minibatches stream through one update there — no rollout workers needed.
"""

from __future__ import annotations

import base64
import glob
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.rl import models as M
from ray_tpu_torch.rl import sample_batch as SB
from ray_tpu_torch.rl.algorithm import (AlgorithmConfig, learner_device,
                                        to_device)
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.policy import (action_dims, load_weights,
                                     module_weights)
from ray_tpu_torch.rl.sample_batch import SampleBatch
from ray_tpu_torch.train.step import AdamW


# ---------------------------------------------------------------------------
# JSON I/O (newline-delimited column batches, numpy arrays b64-encoded)
# ---------------------------------------------------------------------------

def _encode_array(a: np.ndarray) -> Dict[str, Any]:
    a = np.ascontiguousarray(a)
    return {"__np__": base64.b64encode(a.tobytes()).decode("ascii"),
            "dtype": str(a.dtype), "shape": list(a.shape)}


def _decode_array(d: Dict[str, Any]) -> np.ndarray:
    buf = base64.b64decode(d["__np__"])
    return np.frombuffer(buf, dtype=d["dtype"]).reshape(d["shape"]).copy()


class JsonWriter:
    """Writes SampleBatches as newline-delimited JSON rows of columns."""

    def __init__(self, path: str, max_file_size: int = 64 * 1024 * 1024):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.max_file_size = max_file_size
        self._file = None
        self._file_idx = 0

    def _ensure_file(self):
        if self._file is None or self._file.tell() > self.max_file_size:
            if self._file is not None:
                self._file.close()
            name = os.path.join(self.path,
                                f"output-{self._file_idx:05d}.json")
            self._file = open(name, "a")
            self._file_idx += 1

    def write(self, batch: SampleBatch) -> None:
        self._ensure_file()
        row = {k: _encode_array(np.asarray(v)) for k, v in batch.items()}
        self._file.write(json.dumps(row) + "\n")
        self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


class JsonReader:
    """Reads every batch from a path (file, glob, or directory)."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            self.files = sorted(glob.glob(os.path.join(path, "*.json")))
        else:
            self.files = sorted(glob.glob(path)) or [path]

    def read_all(self) -> SampleBatch:
        batches = list(self)
        if not batches:
            raise ValueError(f"no batches found under {self.files}")
        return SampleBatch.concat_samples(batches)

    def __iter__(self):
        for fname in self.files:
            with open(fname) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    row = json.loads(line)
                    yield SampleBatch({k: _decode_array(v)
                                       for k, v in row.items()})


# ---------------------------------------------------------------------------
# Off-policy estimators
# ---------------------------------------------------------------------------

def importance_sampling_estimate(batch: SampleBatch, new_logp: np.ndarray,
                                 gamma: float = 0.99,
                                 weighted: bool = False) -> Dict[str, float]:
    """(W)IS estimate of the new policy's value from behavior data.

    cf. RLlib's rllib/offline/estimators/importance_sampling.py — the
    per-episode cumulative ratio weights the behavior return.
    """
    out_v, out_v_b = [], []
    total_w = 0.0
    for ep in batch.split_by_episode():
        idx = np.flatnonzero(
            np.asarray(batch[SB.EPS_ID]) == ep[SB.EPS_ID][0])
        ratios = np.exp(np.clip(
            new_logp[idx] - np.asarray(ep[SB.ACTION_LOGP]), -20, 20))
        p_t = np.cumprod(ratios)
        discounts = gamma ** np.arange(len(idx))
        rew = np.asarray(ep[SB.REWARDS])
        out_v.append(float(np.sum(p_t * discounts * rew)))
        out_v_b.append(float(np.sum(discounts * rew)))
        total_w += float(p_t[-1])
    v_behavior = float(np.mean(out_v_b))
    if weighted and total_w > 0:
        v_target = float(np.sum(out_v) / total_w)
    else:
        v_target = float(np.mean(out_v))
    return {"v_behavior": v_behavior, "v_target": v_target,
            "v_gain": v_target / v_behavior if v_behavior else float("nan")}


# ---------------------------------------------------------------------------
# MARWIL / BC
# ---------------------------------------------------------------------------

class MARWILConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = MARWIL
        self.input_path: Optional[str] = None
        self.beta = 1.0                 # 0.0 => plain behavior cloning
        self.vf_loss_coeff = 1.0
        self.lr = 1e-4
        self.train_batch_size = 2000
        self.sgd_minibatch_size = 256
        self.num_sgd_iter = 10
        self.moving_average_sqd_adv_norm = 100.0

    def offline_data(self, *, input_path: Optional[str] = None,
                     **kwargs) -> "MARWILConfig":
        if input_path is not None:
            self.input_path = input_path
        self.extra.update(kwargs)
        return self


class BCConfig(MARWILConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = BC
        self.beta = 0.0


class MARWIL:
    """Offline advantage-weighted regression. No WorkerSet: the dataset is
    the experience source; evaluation (if env given) runs a local policy.
    """

    def __init__(self, config: MARWILConfig):
        self.config = config
        if config.input_path is None:
            raise ValueError("config.offline_data(input_path=...) required")
        self.device = learner_device(config)
        self.dataset = JsonReader(config.input_path).read_all()
        if SB.ADVANTAGES not in self.dataset:
            self._add_value_targets(self.dataset, config.gamma)
        self.iteration = 0
        self._timesteps_total = 0

        # infer spaces from the env spec (for evaluation + action dims)
        probe = make_env(config.env_spec)
        obs_dim, act_dim, continuous = action_dims(probe.observation_space,
                                                   probe.action_space)
        probe.close()
        self.continuous = continuous

        self.model = M.init_params(M.ActorCritic(
            obs_dim, act_dim, tuple(config.hidden), continuous,
            device=self.device), config.seed or 0)
        # optax.chain(clip_by_global_norm(grad_clip), adam(lr))
        lr = config.lr
        self.tx = AdamW(lambda count: lr, b1=0.9, b2=0.999,
                        weight_decay=0.0, grad_clip=config.grad_clip)
        self.opt_state = self.tx.init(self.params)
        # running avg of squared advantage norm (marwil_torch_policy.py)
        self.ma_adv_norm = float(config.moving_average_sqd_adv_norm)
        self._logp_fn = (M.diag_gaussian_logp if continuous
                         else M.categorical_logp)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def _loss(self, batch, ma_norm: float):
        cfg = self.config
        beta, vf_coeff = cfg.beta, cfg.vf_loss_coeff
        logits, values = self.model(batch[SB.OBS])
        logp = self._logp_fn(logits, batch[SB.ACTIONS])
        adv = batch[SB.VALUE_TARGETS] - values
        if beta > 0.0:
            exp_adv = torch.exp(beta * (adv / max(ma_norm ** 0.5, 1e-8))
                                .detach()).clamp(max=20.0)
        else:
            exp_adv = torch.ones_like(adv)
        pg_loss = -(exp_adv * logp).mean()
        vf_loss = adv.square().mean()
        total = pg_loss + (vf_coeff * vf_loss if beta > 0.0 else 0.0)
        return total, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                       "mean_adv": adv.mean(),
                       "sqd_adv": adv.square().mean(),
                       "logp": logp.mean()}

    def _sgd_step(self, batch, ma_norm: float):
        params = self.params
        loss, aux = self._loss(batch, ma_norm)
        # BC's loss leaves the value tower out: its gradients are zeros,
        # as jax.grad gives them
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        self.opt_state = self.tx.update(params, grads, self.opt_state)
        aux = {k: v.detach() for k, v in aux.items()}
        aux["total_loss"] = loss.detach()
        return aux

    @staticmethod
    def _add_value_targets(batch: SampleBatch, gamma: float) -> None:
        """Monte-Carlo returns as value targets per episode."""
        n = batch.count
        targets = np.zeros(n, np.float32)
        eps_ids = np.asarray(batch[SB.EPS_ID])
        rewards = np.asarray(batch[SB.REWARDS], np.float32)
        for eid in np.unique(eps_ids):
            idx = np.flatnonzero(eps_ids == eid)
            ret = 0.0
            for i in idx[::-1]:
                ret = rewards[i] + gamma * ret
                targets[i] = ret
        batch[SB.VALUE_TARGETS] = targets
        batch[SB.ADVANTAGES] = targets.copy()

    def get_weights(self) -> Any:
        return module_weights(self.model)

    def set_weights(self, weights: Any) -> None:
        load_weights(self.model, weights)

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        aux_last: Dict[str, Any] = {}
        # small datasets: shrink the minibatch so updates still happen
        mb_size = min(cfg.sgd_minibatch_size, self.dataset.count)
        staged = to_device({k: self.dataset[k] for k in (
            SB.OBS, SB.ACTIONS, SB.VALUE_TARGETS)}, self.device)
        for epoch in range(cfg.num_sgd_iter):
            for idx in self.dataset.minibatch_indices(
                    mb_size,
                    seed=(cfg.seed or 0) + self.iteration * 100 + epoch):
                rows = torch.as_tensor(idx, device=self.device)
                aux = self._sgd_step({k: v[rows] for k, v in staged.items()},
                                     self.ma_adv_norm)
                # update the advantage-norm moving average on host
                self.ma_adv_norm += 1e-8 * (
                    float(aux["sqd_adv"]) - self.ma_adv_norm)
                aux_last = aux
                self._timesteps_total += len(idx)
        self.iteration += 1
        info = {k: float(v) for k, v in aux_last.items()}
        # report the DATASET-wide action log-likelihood, not the last
        # minibatch's (a shuffle-dependent tail is too noisy to judge by)
        info["logp"] = self._dataset_logp()
        result = {"info": info, "training_iteration": self.iteration,
                  "timesteps_total": self._timesteps_total}
        result.update(self.evaluate())
        return result

    @torch.no_grad()
    def _new_logp(self, n: Optional[int] = None) -> torch.Tensor:
        """The dataset's actions' log-likelihood under the current policy
        (the first ``n`` rows)."""
        obs = np.asarray(self.dataset[SB.OBS])[:n]
        acts = np.asarray(self.dataset[SB.ACTIONS])[:n]
        logits, _ = self.model(torch.as_tensor(obs, device=self.device))
        return self._logp_fn(logits, torch.as_tensor(acts,
                                                     device=self.device))

    def _dataset_logp(self, cap: int = 16384) -> float:
        """Mean log-likelihood of the dataset's actions under the
        current policy (first ``cap`` rows: deterministic, unlike a
        shuffled tail)."""
        return float(self._new_logp(min(self.dataset.count, cap)).mean())

    @torch.no_grad()
    def evaluate(self, episodes: int = 5) -> Dict[str, Any]:
        """Greedy rollouts in the real env to score the cloned policy."""
        env = make_env(self.config.env_spec)
        rewards = []
        for ep in range(episodes):
            obs, _ = env.reset(seed=1000 + ep)
            done, total = False, 0.0
            steps = 0
            while not done and steps < 1000:
                logits, _ = self.model(torch.as_tensor(
                    np.asarray(obs, np.float32)[None], device=self.device))
                logits = logits.cpu().numpy()[0]
                if self.continuous:
                    action = np.split(logits, 2)[0]
                else:
                    action = int(np.argmax(logits))
                obs, r, term, trunc, _ = env.step(action)
                total += r
                done = term or trunc
                steps += 1
            rewards.append(total)
        env.close()
        return {"episode_reward_mean": float(np.mean(rewards)),
                "episodes_total": episodes}

    def estimate_off_policy(self) -> Dict[str, float]:
        """IS/WIS value of the learned policy against the dataset."""
        new_logp = self._new_logp().cpu().numpy()
        out = importance_sampling_estimate(
            self.dataset, new_logp, self.config.gamma, weighted=False)
        wis = importance_sampling_estimate(
            self.dataset, new_logp, self.config.gamma, weighted=True)
        out["v_target_wis"] = wis["v_target"]
        return out

    def save(self) -> Checkpoint:
        return Checkpoint.from_dict({
            "weights": self.get_weights(), "iteration": self.iteration})

    def restore(self, checkpoint: Checkpoint) -> None:
        d = checkpoint.to_dict()
        self.set_weights(d["weights"])
        self.iteration = d.get("iteration", 0)

    def stop(self) -> None:
        pass


class BC(MARWIL):
    """Behavior cloning = MARWIL with beta=0 (pure log-likelihood)."""


def collect_dataset(env_spec, path: str, *, n_steps: int = 2000,
                    seed: int = 0) -> str:
    """Roll a behavior policy and persist its experience (the offline-data
    generation step of reference BC/MARWIL examples)."""
    from ray_tpu_torch.rl.policy import JaxPolicy
    from ray_tpu_torch.rl.env import VectorEnv

    vec = VectorEnv(env_spec, 4, seed=seed)
    # the behavior policy is a rollout-side policy: it lives on the CPU
    pol = JaxPolicy(vec.observation_space, vec.action_space, seed=seed,
                    device="cpu")
    writer = JsonWriter(path)
    obs = vec.reset()
    eps_id = np.arange(4)
    next_eps = 4
    cols: Dict[str, List[np.ndarray]] = {
        SB.OBS: [], SB.NEXT_OBS: [], SB.ACTIONS: [], SB.REWARDS: [],
        SB.TERMINATEDS: [], SB.TRUNCATEDS: [], SB.VF_PREDS: [],
        SB.ACTION_LOGP: [], SB.EPS_ID: []}
    steps = 0
    while steps < n_steps:
        actions, logp, values = pol.compute_actions(obs)
        next_obs, rewards, terms, truncs, infos = vec.step(actions)
        # auto-reset swaps in the NEXT episode's start obs; TD targets
        # must bootstrap from the real final obs (cf. sample_transitions)
        row_next = next_obs.copy()
        for i, info in enumerate(infos):
            if "terminal_observation" in info:
                row_next[i] = info["terminal_observation"]
        cols[SB.OBS].append(obs)
        cols[SB.NEXT_OBS].append(row_next)
        cols[SB.ACTIONS].append(actions)
        cols[SB.REWARDS].append(rewards)
        cols[SB.TERMINATEDS].append(terms)
        cols[SB.TRUNCATEDS].append(truncs)
        cols[SB.VF_PREDS].append(values)
        cols[SB.ACTION_LOGP].append(logp)
        cols[SB.EPS_ID].append(eps_id.copy())
        for i in range(4):
            if terms[i] or truncs[i]:
                eps_id[i] = next_eps
                next_eps += 1
        obs = next_obs
        steps += 4
    # stack time-major then flatten env-major so episodes are contiguous
    T = len(cols[SB.REWARDS])
    fixed = {}
    for k, v in cols.items():
        arr = np.stack([np.asarray(x) for x in v], axis=0)  # [T, B, ...]
        arr = np.swapaxes(arr, 0, 1)                         # [B, T, ...]
        fixed[k] = arr.reshape((4 * T,) + arr.shape[2:])
    batch = SampleBatch(fixed)
    writer.write(batch)
    writer.close()
    return path
