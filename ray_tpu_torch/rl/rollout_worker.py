"""RolloutWorker: env stepping on CPU hosts (counterpart of
ray_tpu/rl/rollout_worker.py).

Analog of RLlib's rllib/evaluation/rollout_worker.py (``sample()``):
vectorized envs stepped with the current policy, GAE postprocessing per
episode fragment, metrics tracked per completed episode.  Runs as a CPU
actor that leases no GPU, so the card never blocks on env code; its
policy always lives on the CPU (the JAX package forces
``JAX_PLATFORMS=cpu`` there).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.rl import sample_batch as SB
from ray_tpu_torch.rl.env import VectorEnv
from ray_tpu_torch.rl.policy import (DDPGPolicy, JaxPolicy, QPolicy,
                                     R2D2Policy, SACPolicy)
from ray_tpu_torch.rl.sample_batch import SampleBatch, compute_gae

# the policies by RolloutWorker's ``policy`` name ("ac" the default)
_POLICIES = {"q": QPolicy, "ddpg": DDPGPolicy, "sac": SACPolicy}


class RolloutWorker:
    def __init__(self, env_spec, *, num_envs: int = 1,
                 rollout_fragment_length: int = 200,
                 gamma: float = 0.99, lam: float = 0.95,
                 hidden=(256, 256), policy: str = "ac",
                 policy_kwargs: Optional[Dict[str, Any]] = None,
                 worker_index: int = 0, seed: Optional[int] = None):
        self.worker_index = worker_index
        self._env_spec = env_spec
        seed = (seed if seed is not None else 1234) + worker_index * 1000
        self.vec = VectorEnv(env_spec, num_envs, seed=seed)
        # batches of num_envs rows: one thread beats torch's pool of one
        # per core, and the actor leases one CPU
        torch.set_num_threads(1)
        spaces = (self.vec.observation_space, self.vec.action_space)
        kwargs = dict(hidden=hidden, seed=seed, device="cpu",
                      **(policy_kwargs or {}))
        if policy == "r2d2":
            self.policy = R2D2Policy(*spaces, num_envs=num_envs, **kwargs)
        else:
            self.policy = _POLICIES.get(policy, JaxPolicy)(*spaces,
                                                           **kwargs)
        self.fragment = rollout_fragment_length
        self.gamma, self.lam = gamma, lam
        self._obs = self.vec.reset()
        self._eps_id = np.arange(num_envs) + worker_index * 1_000_000
        self._next_eps = num_envs + worker_index * 1_000_000
        self._ep_rewards = np.zeros(num_envs)
        self._ep_lens = np.zeros(num_envs, np.int64)
        self._completed: List[Dict[str, float]] = []

    # -- weights sync ------------------------------------------------------
    def set_weights(self, weights) -> None:
        self.policy.set_weights(weights)

    def get_weights(self):
        return self.policy.get_weights()

    # -- sampling ----------------------------------------------------------
    def sample(self) -> SampleBatch:
        n_envs = self.vec.num_envs
        T = self.fragment
        cols: Dict[str, List[np.ndarray]] = {
            SB.OBS: [], SB.ACTIONS: [], SB.REWARDS: [], SB.TERMINATEDS: [],
            SB.TRUNCATEDS: [], SB.VF_PREDS: [], SB.ACTION_LOGP: [],
            SB.EPS_ID: []}
        for _ in range(T):
            actions, logp, values = self.policy.compute_actions(self._obs)
            next_obs, rewards, terms, truncs, infos = self.vec.step(actions)
            cols[SB.OBS].append(self._obs)
            cols[SB.ACTIONS].append(actions)
            cols[SB.REWARDS].append(rewards)
            cols[SB.TERMINATEDS].append(terms)
            cols[SB.TRUNCATEDS].append(truncs)
            cols[SB.VF_PREDS].append(values)
            cols[SB.ACTION_LOGP].append(logp)
            cols[SB.EPS_ID].append(self._eps_id.copy())
            self._ep_rewards += rewards
            self._ep_lens += 1
            for i in range(n_envs):
                if terms[i] or truncs[i]:
                    self._completed.append(
                        {"episode_reward": float(self._ep_rewards[i]),
                         "episode_len": int(self._ep_lens[i])})
                    self._ep_rewards[i] = 0.0
                    self._ep_lens[i] = 0
                    self._eps_id[i] = self._next_eps
                    self._next_eps += 1
            self._obs = next_obs

        # bootstrap values for fragments cut mid-episode (or truncated)
        _, _, last_values = self.policy.compute_actions(self._obs)
        # stack to [T, N] then split per env for GAE over time order
        stacked = {k: np.stack(v) for k, v in cols.items()}
        per_env = []
        for i in range(n_envs):
            env_batch = SampleBatch(
                {k: stacked[k][:, i] for k in stacked.keys()})
            pieces = env_batch.split_by_episode()
            for j, piece in enumerate(pieces):
                last = j == len(pieces) - 1
                terminated = bool(piece[SB.TERMINATEDS][-1])
                boot = 0.0 if terminated else (
                    float(last_values[i]) if last else 0.0)
                # non-last pieces always end terminated or truncated; a
                # truncated middle piece bootstraps from its own final vf
                if not last and not terminated:
                    boot = float(piece[SB.VF_PREDS][-1])
                per_env.append(compute_gae(piece, gamma=self.gamma,
                                           lam=self.lam, last_value=boot))
        return SampleBatch.concat_samples(per_env)

    def sample_time_major(self) -> Dict[str, np.ndarray]:
        """[T, N]-shaped fragment without GAE — IMPALA's V-trace does its
        own off-policy correction on the learner (cf. rllib vtrace)."""
        cols: Dict[str, List[np.ndarray]] = {
            SB.OBS: [], SB.ACTIONS: [], SB.REWARDS: [], SB.TERMINATEDS: [],
            SB.ACTION_LOGP: []}
        for _ in range(self.fragment):
            actions, logp, _ = self.policy.compute_actions(self._obs)
            next_obs, rewards, terms, truncs, _ = self.vec.step(actions)
            cols[SB.OBS].append(self._obs)
            cols[SB.ACTIONS].append(actions)
            cols[SB.REWARDS].append(rewards)
            cols[SB.TERMINATEDS].append(np.logical_or(terms, truncs))
            cols[SB.ACTION_LOGP].append(logp)
            self._end_episodes(rewards, terms, truncs)
            self._obs = next_obs
        out = {k: np.stack(v) for k, v in cols.items()}
        out["bootstrap_obs"] = self._obs.copy()
        return out

    def set_epsilon(self, epsilon: float) -> None:
        """Exploration schedule hook (the Q policies; a no-op otherwise)."""
        if hasattr(self.policy, "set_epsilon"):
            self.policy.set_epsilon(epsilon)

    def _end_episodes(self, rewards, terms, truncs) -> None:
        """Account one env step in the episode metrics."""
        self._ep_rewards += rewards
        self._ep_lens += 1
        for i in range(self.vec.num_envs):
            if terms[i] or truncs[i]:
                self._completed.append(
                    {"episode_reward": float(self._ep_rewards[i]),
                     "episode_len": int(self._ep_lens[i])})
                self._ep_rewards[i] = 0.0
                self._ep_lens[i] = 0

    def sample_transitions(self) -> SampleBatch:
        """(obs, action, reward, next_obs, terminated) rows for replay-based
        algorithms — no GAE, truncations bootstrap (terminated=False)."""
        cols: Dict[str, List[np.ndarray]] = {
            SB.OBS: [], SB.ACTIONS: [], SB.REWARDS: [], SB.NEXT_OBS: [],
            SB.TERMINATEDS: []}
        for _ in range(self.fragment):
            actions, _, _ = self.policy.compute_actions(self._obs)
            next_obs, rewards, terms, truncs, infos = self.vec.step(actions)
            # auto-reset replaced ended envs' obs with the NEXT episode's
            # start — TD targets must bootstrap from the real final obs
            # (truncated rows especially: terminated=False there)
            row_next = next_obs.copy()
            for i, info in enumerate(infos):
                if "terminal_observation" in info:
                    row_next[i] = info["terminal_observation"]
            cols[SB.OBS].append(self._obs)
            cols[SB.ACTIONS].append(actions)
            cols[SB.REWARDS].append(rewards)
            cols[SB.NEXT_OBS].append(row_next)
            cols[SB.TERMINATEDS].append(terms)
            self._end_episodes(rewards, terms, truncs)
            self._obs = next_obs
        # flatten [T, N, ...] -> [T*N, ...]
        out = {k: np.concatenate(v) if np.asarray(v[0]).ndim > 1
               else np.stack(v).reshape(-1) for k, v in cols.items()}
        return SampleBatch(out)

    def sample_sequences(self) -> SampleBatch:
        """Fixed-length recurrent sequences for R2D2: one sequence of
        ``rollout_fragment_length`` timesteps per env, the LSTM carry
        zeroed at sequence start; steps after the first episode end are
        masked invalid (``seq_valid`` 0: the next episode needs a fresh
        zero carry, which the learner can only supply at sequence
        starts).  Rows are [num_envs, L, ...]."""
        if not hasattr(self.policy, "reset_carry"):
            raise ValueError("sample_sequences needs the r2d2 policy")
        n_envs = self.vec.num_envs
        # a fresh zero state at every sequence start, so that the learner
        # can replay from zeros (R2D2's zero-start-state strategy)
        self.policy.reset_carry(np.ones(n_envs))
        cols: Dict[str, List[np.ndarray]] = {
            k: [] for k in (SB.OBS, SB.ACTIONS, SB.REWARDS, SB.TERMINATEDS,
                            SB.TRUNCATEDS)}
        valid_rows = []
        alive = np.ones(n_envs, np.float32)
        for _ in range(self.fragment):
            actions, _, _ = self.policy.compute_actions(self._obs)
            next_obs, rewards, terms, truncs, _ = self.vec.step(actions)
            cols[SB.OBS].append(self._obs)
            cols[SB.ACTIONS].append(actions)
            cols[SB.REWARDS].append(rewards)
            cols[SB.TERMINATEDS].append(terms)
            cols[SB.TRUNCATEDS].append(truncs)
            valid_rows.append(alive.copy())
            # episode metrics track every step, including those of the
            # auto-reset episode that the sequence no longer trains on
            self._end_episodes(rewards, terms, truncs)
            done = np.asarray(terms) | np.asarray(truncs)
            alive = alive * (1.0 - done.astype(np.float32))
            self._obs = next_obs
        # [T, N, ...] -> [N, T, ...]
        out = {k: np.swapaxes(np.stack(v), 0, 1) for k, v in cols.items()}
        out["seq_valid"] = np.swapaxes(np.stack(valid_rows), 0, 1)
        return SampleBatch(out)

    def evaluate_rollout(self, weights, *, n_episodes: int = 1,
                         explore: bool = False,
                         max_steps: int = 1000) -> Dict[str, Any]:
        """Episode returns + env-step count under ``weights`` (ES/ARS
        fitness evaluation — cf. RLlib's rllib/algorithms/es/es.py
        Worker.do_rollouts)."""
        from ray_tpu_torch.rl.env import make_env
        self.policy.set_weights(weights)
        env = make_env(self._env_spec)
        returns = []
        total_steps = 0
        for ep in range(n_episodes):
            obs, _ = env.reset(seed=self.worker_index * 7919 + ep)
            total, done, steps = 0.0, False, 0
            while not done and steps < max_steps:
                a, _, _ = self.policy.compute_actions(
                    np.asarray(obs, np.float32)[None], explore=explore)
                obs, r, term, trunc, _ = env.step(a[0])
                total += r
                done = term or trunc
                steps += 1
            returns.append(float(total))
            total_steps += steps
        env.close()
        return {"returns": returns, "steps": total_steps}

    def get_metrics(self) -> List[Dict[str, float]]:
        out, self._completed = self._completed, []
        return out

    def ping(self) -> bool:
        return True

    def host_info(self) -> Dict[str, Any]:
        """What this worker's process holds: its pid, the cards it may
        see (``CUDA_VISIBLE_DEVICES``; "" for an actor that leases no
        GPU), whether it started CUDA, its policy's device and the
        top-level modules it has imported."""
        import os
        import sys
        return {"pid": os.getpid(),
                "cuda_visible_devices":
                    os.environ.get("CUDA_VISIBLE_DEVICES"),
                "cuda_initialized": torch.cuda.is_initialized(),
                "policy_device": str(self.policy.device),
                "modules": sorted({m.split(".")[0] for m in sys.modules})}
