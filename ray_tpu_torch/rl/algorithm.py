"""Algorithm + AlgorithmConfig: the RL training loop (counterpart of
ray_tpu/rl/algorithm.py).

Analog of RLlib's rllib/algorithms/algorithm.py (a Trainable;
``training_step``) and algorithm_config.py (fluent configuration).  CPU
rollout actors sample on the port's runtime (``rl/worker_set.py``); the
learner is one device, the card unless the caller asks for the CPU
(``.resources(device="cpu")``), where the JAX package's learner is a
pjit step over a device mesh.  A mesh of more than one device waits for
multi-device training (ROADMAP.md, Queue 1, item 4) and raises, as
``ScalingConfig(mesh_shape=...)`` does; so does the podracer executor,
which comes with APPO in a later RL slice.

The learner keeps its network as an ``nn.Module`` (``self.model``) and
its optimizer state as a dict of tensors (``self.opt_state``);
``full_training_state`` snapshots both as host numpy arrays, and
``save`` / ``restore`` carry them through the port's
``air/checkpoint.py``.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import MULTI_DEVICE
from ray_tpu_torch.rl.policy import load_weights, module_weights
from ray_tpu_torch.rl.worker_set import WorkerSet

PODRACER_LATER = ("the podracer executor comes with APPO and rl/podracer/ "
                  "in a later RL slice (ROADMAP.md, Queue 1, item 4, RL)")


def to_host(tree):
    """A nested dict / list / tuple of tensors as numpy arrays (copies)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def to_device(tree, device):
    """The inverse of ``to_host``: numpy arrays and tensors become copies
    on ``device`` (a column may be a read-only view of the object store);
    other leaves (counts) stay as they are.  Every learner stages its
    batches through it."""
    if isinstance(tree, np.ndarray):
        return torch.tensor(tree, device=device)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


def full_training_state(algo) -> dict:
    """Host-side snapshot of a learner's complete training state — its
    network's parameters and its optimizer's state (moments and count),
    as numpy arrays — shared by the Algorithm subclasses and the offline
    learners so the checkpoint format cannot drift per algorithm."""
    return {"_format": "v2", "params": to_host(algo.params),
            "opt_state": to_host(algo.opt_state)}


def apply_full_training_state(algo, full: dict) -> None:
    """Put a ``full_training_state`` snapshot back on the learner's
    device; the parameters go into ``algo.model`` in place, so the
    tensors the optimizer updates stay the model's."""
    load_weights(algo.model, full["params"])
    algo.opt_state = to_device(full["opt_state"], algo.device)


def init_actor_critic(cfg, device):
    """Probe ``cfg.env_spec`` and build the shared ActorCritic tower on
    ``device`` with weights from ``cfg.seed``: returns (model,
    continuous, logp_fn, ent_fn)."""
    from ray_tpu_torch.rl import models as M
    from ray_tpu_torch.rl.env import make_env
    from ray_tpu_torch.rl.policy import action_dims
    probe = make_env(cfg.env_spec)
    obs_dim, act_dim, continuous = action_dims(probe.observation_space,
                                               probe.action_space)
    probe.close()
    model = M.init_params(M.ActorCritic(obs_dim, act_dim, tuple(cfg.hidden),
                                        continuous, device=device),
                          cfg.seed or 0)
    if continuous:
        logp_fn, ent_fn = M.diag_gaussian_logp, M.diag_gaussian_entropy
    else:
        logp_fn, ent_fn = M.categorical_logp, M.categorical_entropy
    return model, continuous, logp_fn, ent_fn


def check_mesh(shape: Optional[Dict[str, int]]) -> None:
    """A mesh over more than one device raises, as ScalingConfig's does."""
    if shape and math.prod(shape.values()) > 1:
        raise NotImplementedError(f"mesh_shape {shape}: {MULTI_DEVICE}")


def learner_device(config) -> torch.device:
    """The learner's one device: ``config.device`` (default the card)."""
    check_mesh(config.mesh_shape)
    return resolve_device(config.device)


class AlgorithmConfig:
    """Fluent configuration: ``PPOConfig().environment("CartPole-v1")
    .rollouts(num_rollout_workers=2).training(lr=5e-5).build()``."""

    algo_class: Optional[type] = None

    def __init__(self):
        self.env_spec: Any = None
        self.num_rollout_workers = 2
        self.num_envs_per_worker = 1
        self.rollout_fragment_length = 200
        self.recreate_failed_workers = True
        self.gamma = 0.99
        self.lam = 0.95
        self.lr = 5e-5
        self.train_batch_size = 4000
        self.sgd_minibatch_size = 128
        self.num_sgd_iter = 30
        self.grad_clip = 0.5
        self.hidden = (256, 256)
        self.seed: Optional[int] = None
        self.mesh_shape: Optional[Dict[str, int]] = None
        self.device: Any = None           # the learner's; None: the card
        self.extra: Dict[str, Any] = {}

    # -- fluent sections (reference names) --------------------------------
    def environment(self, env=None, **kwargs) -> "AlgorithmConfig":
        if env is not None:
            self.env_spec = env
        self.extra.update(kwargs)
        return self

    def rollouts(self, *, num_rollout_workers: Optional[int] = None,
                 num_envs_per_worker: Optional[int] = None,
                 rollout_fragment_length: Optional[int] = None,
                 recreate_failed_workers: Optional[bool] = None,
                 **kwargs) -> "AlgorithmConfig":
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = num_envs_per_worker
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if recreate_failed_workers is not None:
            self.recreate_failed_workers = recreate_failed_workers
        self.extra.update(kwargs)
        return self

    env_runners = rollouts   # newer reference API name

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if hasattr(self, k):
                setattr(self, k, v)
            else:
                self.extra[k] = v
        return self

    def resources(self, *, mesh_shape: Optional[Dict[str, int]] = None,
                  device: Any = None, **kwargs) -> "AlgorithmConfig":
        """``device``: the learner's (``"cpu"``, ``"cuda"``; default the
        card).  ``mesh_shape`` over more than one device raises."""
        if mesh_shape is not None:
            check_mesh(mesh_shape)
            self.mesh_shape = mesh_shape
        if device is not None:
            self.device = device
        self.extra.update(kwargs)
        return self

    def debugging(self, *, seed: Optional[int] = None,
                  **kwargs) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        self.extra.update(kwargs)
        return self

    def podracer(self, enabled: bool = True,
                 **kwargs) -> "AlgorithmConfig":
        """The streaming learner–actor executor is not ported yet:
        ``enabled=True`` raises."""
        if enabled:
            raise NotImplementedError(PODRACER_LATER)
        return self

    def build(self) -> "Algorithm":
        if self.algo_class is None:
            raise ValueError("use a concrete config (PPOConfig, ...)")
        return self.algo_class(self)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items() if k != "extra"}


class Algorithm:
    """The training loop: owns the WorkerSet + learner; subclasses
    implement ``setup_learner`` (which sets ``self.model``,
    ``self.opt_state`` and the step on ``self.device``, the learner's
    one device) and ``training_step()`` returning a result dict."""

    def __init__(self, config: AlgorithmConfig):
        self.config = config
        if config.env_spec is None:
            raise ValueError("config.environment(env) is required")
        self.iteration = 0
        self._timesteps_total = 0
        self._episode_history: List[Dict[str, float]] = []
        self.device = learner_device(config)
        worker_kwargs = dict(
            num_envs=config.num_envs_per_worker,
            rollout_fragment_length=config.rollout_fragment_length,
            gamma=config.gamma, lam=config.lam,
            hidden=config.hidden, seed=config.seed)
        self.setup_learner()
        self.workers = WorkerSet(
            config.env_spec,
            num_workers=max(config.num_rollout_workers, 1),
            worker_kwargs=worker_kwargs,
            recreate_failed_workers=config.recreate_failed_workers)
        self.workers.sync_weights(self.get_weights())

    # -- learner plumbing shared by the algorithms -------------------------
    def init_actor_critic(self):
        """(model, continuous, logp_fn, ent_fn) on the learner's device:
        the tower of the whole on-policy family."""
        return init_actor_critic(self.config, self.device)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The learner network's parameters by state-dict name."""
        return dict(self.model.named_parameters())

    def gather_on_policy_batch(self, min_size: int):
        """synchronous_parallel_sample: pull worker fragments until the
        batch reaches ``min_size`` rows (rollout_ops.py)."""
        from ray_tpu_torch.rl.sample_batch import SampleBatch
        batches = self.workers.foreach_worker("sample")
        train_batch = SampleBatch.concat_samples(batches)
        while train_batch.count < min_size:
            more = self.workers.foreach_worker("sample")
            if not more:
                break
            train_batch = SampleBatch.concat_samples([train_batch] + more)
        self._timesteps_total += train_batch.count
        return train_batch

    # -- subclass surface --------------------------------------------------
    def setup_learner(self) -> None:
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def get_weights(self) -> Any:
        """The learner network's weights as host numpy arrays: what the
        rollout workers receive, never a CUDA tensor."""
        return module_weights(self.model)

    def set_weights(self, weights: Any) -> None:
        load_weights(self.model, weights)

    # -- public API --------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        result = self.training_step()
        metrics = self._collect_episode_metrics()
        self.iteration += 1
        result.update(metrics)
        result["training_iteration"] = self.iteration
        result["timesteps_total"] = self._timesteps_total
        result["time_this_iter_s"] = time.perf_counter() - t0
        result["num_worker_restarts"] = self.workers.num_restarts
        return result

    def _summarize_episodes(self) -> Dict[str, Any]:
        if not self._episode_history:
            return {"episode_reward_mean": float("nan"),
                    "episode_len_mean": float("nan"), "episodes_total": 0}
        rewards = [e["episode_reward"] for e in self._episode_history]
        lens = [e["episode_len"] for e in self._episode_history]
        return {"episode_reward_mean": float(np.mean(rewards)),
                "episode_reward_max": float(np.max(rewards)),
                "episode_reward_min": float(np.min(rewards)),
                "episode_len_mean": float(np.mean(lens)),
                "episodes_total": len(self._episode_history)}

    def _collect_episode_metrics(self) -> Dict[str, Any]:
        for eps in self.workers.foreach_worker("get_metrics"):
            self._episode_history.extend(eps)
        self._episode_history = self._episode_history[-100:]
        return self._summarize_episodes()

    def get_full_state(self):
        """Complete training state for checkpointing — the network, the
        optimizer's moments and counters, as host numpy arrays (a resumed
        run continues training; it does not restart the moments)."""
        return full_training_state(self)

    def set_full_state(self, state) -> None:
        apply_full_training_state(self, state)

    def save(self) -> Checkpoint:
        return Checkpoint.from_dict({
            "state": self.get_full_state(), "iteration": self.iteration,
            "timesteps_total": self._timesteps_total})

    def restore(self, checkpoint: Checkpoint) -> None:
        d = checkpoint.to_dict()
        self.set_full_state(d["state"])
        self.iteration = d.get("iteration", 0)
        self._timesteps_total = d.get("timesteps_total", 0)
        self.workers.sync_weights(self.get_weights())

    def stop(self) -> None:
        self.workers.stop()
