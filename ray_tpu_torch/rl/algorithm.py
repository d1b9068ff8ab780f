"""Algorithm + AlgorithmConfig: the RL training loop (counterpart of
ray_tpu/rl/algorithm.py).

Analog of RLlib's rllib/algorithms/algorithm.py (a Trainable;
``training_step``) and algorithm_config.py (fluent configuration).  CPU
rollout actors sample on the port's runtime (``rl/worker_set.py``); the
learner is one device, the card unless the caller asks for the CPU
(``.resources(device="cpu")``), where the JAX package's learner is a
pjit step over a device mesh.  A mesh of more than one device waits for
multi-device training (ROADMAP.md, Queue 1, item 4) and raises, as
``ScalingConfig(mesh_shape=...)`` does.  ``.podracer()`` runs IMPALA and
PPO on the streaming learner–actor executor (``rl/podracer/``): the
learner is then an actor that leases the card, and the driver starts no
CUDA.

The learner keeps its network as an ``nn.Module`` (``self.model``), a
target network where the algorithm has one as a separate module
(``self.target_model``, a copy: the optimizer updates ``self.model`` in
place, so an alias would track it), and its optimizer state as a dict
of tensors (``self.opt_state``).  A learner of several networks (SAC,
DDPG/TD3, CQL, CRR) keeps them all in one dict ``self.state`` under the
JAX package's names instead: modules (``actor``, ``critic``, the
targets), parameters (``log_alpha``) and optimizer states
(``actor_opt``, ...).  ``full_training_state`` snapshots either form as
host numpy arrays, and ``save`` / ``restore`` carry them through the
port's ``air/checkpoint.py``.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import MULTI_DEVICE
from ray_tpu_torch.rl.policy import load_weights, module_weights
from ray_tpu_torch.rl.worker_set import WorkerSet

# schedule counters a checkpoint carries (the JAX package's; TD3's
# delayed-actor count too)
_COUNTER_ATTRS = ("_steps_since_target_sync", "_updates")


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
    network's parameters, its target network's where it has one, its
    optimizer's state (moments and count), as numpy arrays, or each
    entry of its ``state`` dict (a module as its state dict) under
    ``"state"`` — and its schedule counters; shared by the Algorithm
    subclasses, the offline learners and the podracer learner, so the
    checkpoint format cannot drift per algorithm."""
    out: dict = {"_format": "v2"}
    if getattr(algo, "state", None) is not None:
        out["state"] = {k: module_weights(v) if isinstance(
            v, torch.nn.Module) else to_host(v)
            for k, v in algo.state.items()}
    else:
        out.update(params=to_host(algo.params),
                   opt_state=to_host(algo.opt_state))
    target = getattr(algo, "target_model", None)
    if target is not None:
        out["target_params"] = module_weights(target)
    counters = {c: int(getattr(algo, c)) for c in _COUNTER_ATTRS
                if hasattr(algo, c)}
    if counters:
        out["_counters"] = counters
    return out


def apply_full_training_state(algo, full: dict) -> None:
    """Put a ``full_training_state`` snapshot back on the learner's
    device; the parameters go into ``algo.model`` (and the target's into
    ``algo.target_model``), or into the modules and parameters of
    ``algo.state``, in place, so the tensors the optimizers update stay
    the model's."""
    if "state" in full:
        for k, v in full["state"].items():
            live = algo.state[k]
            if isinstance(live, torch.nn.Module):
                load_weights(live, v)
            elif isinstance(live, torch.Tensor):
                with torch.no_grad():
                    live.copy_(torch.as_tensor(v))
            else:
                algo.state[k] = to_device(v, algo.device)
    else:
        load_weights(algo.model, full["params"])
        algo.opt_state = to_device(full["opt_state"], algo.device)
    if "target_params" in full:
        load_weights(algo.target_model, full["target_params"])
    for c, v in (full.get("_counters") or {}).items():
        setattr(algo, c, v)


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
        self.use_podracer = False
        self.podracer_kwargs: Dict[str, Any] = {}
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
        """Run on the streaming learner–actor executor (``rl/podracer/``)
        instead of the blocking loop.  Extra kwargs (e.g.
        ``strict_zero_submit=False``) reach the PodracerExecutor."""
        self.use_podracer = enabled
        self.podracer_kwargs.update(kwargs)
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
    one device) and ``training_step()`` returning a result dict.  With
    ``config.podracer()`` the loop is the PodracerExecutor's and the
    learner lives in its actor."""

    # subclasses that ride the podracer executor name their step
    # builder here ("impala" / "ppo"); None: the blocking loop only
    podracer_algo: Optional[str] = None

    def __init__(self, config: AlgorithmConfig):
        self.config = config
        if config.env_spec is None:
            raise ValueError("config.environment(env) is required")
        self.iteration = 0
        self._timesteps_total = 0
        self._episode_history: List[Dict[str, float]] = []
        if getattr(config, "use_podracer", False):
            if self.podracer_algo is None:
                raise ValueError(
                    f"{type(self).__name__} does not support the "
                    "podracer executor (only IMPALA/PPO do)")
            from ray_tpu_torch.rl.podracer import PodracerExecutor
            check_mesh(config.mesh_shape)
            self.workers = None
            self.podracer = PodracerExecutor(
                self.podracer_algo, config,
                **getattr(config, "podracer_kwargs", {}))
            return
        self.podracer = None
        self.device = learner_device(config)
        worker_kwargs = dict(
            num_envs=config.num_envs_per_worker,
            rollout_fragment_length=config.rollout_fragment_length,
            gamma=config.gamma, lam=config.lam,
            hidden=config.hidden, seed=config.seed)
        worker_kwargs.update(self.extra_worker_kwargs(config))
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

    def round_minibatch(self, size: int) -> int:
        """The minibatch size the learner takes: ``size`` itself (at least
        1) on the port's one device, where the JAX package rounds it to a
        multiple of the mesh's data shards."""
        return max(size, 1)

    def stage_batch(self, sample, keys) -> Dict[str, torch.Tensor]:
        """The columns of ``sample`` named in ``keys`` as copies on the
        learner's device (``to_device``)."""
        return to_device({k: v for k, v in sample.items() if k in keys},
                         self.device)

    # -- subclass surface --------------------------------------------------
    @classmethod
    def extra_worker_kwargs(cls, config: AlgorithmConfig) -> Dict[str, Any]:
        """Extra RolloutWorker kwargs (e.g. DQN selects the Q policy)."""
        return {}

    def setup_learner(self) -> None:
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def get_weights(self) -> Any:
        """The learner network's weights as host numpy arrays: what the
        rollout workers receive, never a CUDA tensor."""
        if self.podracer is not None:
            return self.podracer.get_weights()
        return module_weights(self.model)

    def set_weights(self, weights: Any) -> None:
        if self.podracer is not None:
            self.podracer.set_weights(weights)
            return
        load_weights(self.model, weights)

    # -- public API --------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        if self.podracer is not None:
            result = self.podracer.train_iteration()
            self._timesteps_total = result.pop("timesteps_this_iter")
            # episode metrics ride the fragment stream's meta (no extra
            # foreach_worker round trip in podracer mode)
            self._episode_history = \
                self.podracer.collect_episode_metrics()
            metrics = self._summarize_episodes()
            restarts = self.podracer.telemetry["replacements"]
        else:
            result = self.training_step()
            metrics = self._collect_episode_metrics()
            restarts = self.workers.num_restarts
        self.iteration += 1
        result.update(metrics)
        result["training_iteration"] = self.iteration
        result["timesteps_total"] = self._timesteps_total
        result["time_this_iter_s"] = time.perf_counter() - t0
        result["num_worker_restarts"] = restarts
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
        target network, the optimizer's moments and counters, the sync
        counters, as host numpy arrays (a resumed run continues training;
        it does not restart the moments).  Under the podracer executor,
        the learner actor's."""
        if self.podracer is not None:
            return self.podracer.get_full_state()
        return full_training_state(self)

    def set_full_state(self, state) -> None:
        if self.podracer is not None:
            self.podracer.set_full_state(state)
            return
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
        # podracer: set_full_state published a new version, which every
        # actor adopts at its next fragment boundary
        if self.podracer is None:
            self.workers.sync_weights(self.get_weights())

    def stop(self) -> None:
        if self.podracer is not None:
            self.podracer.stop()
            return
        self.workers.stop()

    @classmethod
    def as_trainable(cls, config: AlgorithmConfig) -> Callable:
        """Tune integration: a function trainable that runs this algorithm
        on ``config`` with the trial's settings, reporting each
        ``train()`` result with a checkpoint.  Its learner takes the card
        that the trial's actor leases (``TuneConfig(trial_resources=
        {"GPU": ...})``)."""
        def _trainable(trial_config: Dict[str, Any]):
            import copy

            from ray_tpu_torch.air import session
            cfg = copy.deepcopy(config)
            cfg.training(**trial_config)
            algo = cfg.algo_class(cfg)
            try:
                ckpt = session.get_checkpoint()
                if ckpt is not None:
                    algo.restore(ckpt)
                while True:
                    result = algo.train()
                    session.report(result, checkpoint=algo.save())
            finally:
                algo.stop()
        return _trainable
