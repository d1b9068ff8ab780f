"""Podracer learner actor: the compiled-DAG step + weight publishing
(counterpart of ray_tpu/rl/podracer/learner.py).

``step()`` is the DAG op — the executor compiles ``inp ->
learner.step.bind(inp)`` once, then every fragment travels a shm
channel write + one get: zero classic task submissions in steady state.
Weight publishing happens INSIDE ``step()`` (every
``podracer_sync_every_steps`` optimizer steps): ``ray_tpu_torch.put`` +
the KV pointer bump are object/KV-plane operations issued from the
learner process, so a steady-state training loop moves the driver's
``ray_tpu_actor_tasks_submitted_total`` counter by exactly zero.

The loss/step math is built by the SAME module-level builders the
blocking drivers use (``make_impala_sgd_step`` / ``make_ppo_sgd_step``),
so podracer and blocking training are numerically the same algorithm —
the data plane is the only thing that changed.  The learner's network
lives on ``learner_device(config)``: the card its actor leases
(``learner_actor_class(num_gpus=1)``), unless the config asks for the
CPU; a learner that finds no card raises.  Fragments arrive as read-only
views of the store and are copied to the device (``to_device``);
``step()`` returns plain floats, and weights leave as host numpy
(``get_weights``), so no CUDA tensor enters a channel or the store.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch.rl import sample_batch as SB
from ray_tpu_torch.rl.podracer.weights import WeightPublisher
from ray_tpu_torch.rl.ppo import PPO_KEYS

# fragment columns each algorithm's loss actually consumes — extra
# rollout columns stay host-side instead of riding to the device
_IMPALA_KEYS = (SB.OBS, SB.ACTIONS, SB.REWARDS, SB.TERMINATEDS,
                SB.ACTION_LOGP, "bootstrap_obs")


class LearnerActor:
    """Owns the network and optimizer state; steps on fragments;
    publishes weights."""

    def __init__(self, algo: str, config, weights_name: str):
        from ray_tpu_torch.rl.algorithm import (init_actor_critic,
                                                learner_device)
        self.algo = algo
        self.config = config
        self.device = learner_device(config)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.model, _, logp_fn, ent_fn = init_actor_critic(config,
                                                           self.device)
        if algo == "impala":
            from ray_tpu_torch.rl.impala import (make_impala_optimizer,
                                                 make_impala_sgd_step)
            self.tx = make_impala_optimizer(config)
            self._sgd_step = make_impala_sgd_step(
                self.model, logp_fn, ent_fn, self.tx, config)
            self._keys = _IMPALA_KEYS
        elif algo == "ppo":
            from ray_tpu_torch.rl.ppo import (make_ppo_optimizer,
                                              make_ppo_sgd_step)
            self.tx = make_ppo_optimizer(config)
            self._sgd_step = make_ppo_sgd_step(
                self.model, logp_fn, ent_fn, self.tx, config)
            self._keys = PPO_KEYS
        else:
            raise ValueError(
                f"podracer supports impala/ppo, got {algo!r}")
        self.opt_state = self.tx.init(self.params)
        self._publisher = WeightPublisher(weights_name)
        self._step_no = 0
        self._frames = 0
        self._sync_every = max(1, int(CONFIG.podracer_sync_every_steps))

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    # --------------------------------------------------- classic methods
    def ready(self) -> bool:
        """Creation fence (the DAG compiler requires a live actor)."""
        return True

    def publish_now(self) -> int:
        """Initial version so the fleet rendezvous has weights to pull
        before the first learner step."""
        return self._publisher.publish(self.get_weights())

    def get_weights(self) -> Any:
        from ray_tpu_torch.rl.policy import module_weights
        return module_weights(self.model)

    def set_weights(self, weights: Any) -> None:
        from ray_tpu_torch.rl.policy import load_weights
        load_weights(self.model, weights)

    def get_state(self) -> dict:
        """Checkpoint envelope (the v2 format of rl/algorithm.py)."""
        from ray_tpu_torch.rl.algorithm import full_training_state
        state = full_training_state(self)
        state["_step_no"] = self._step_no
        state["_frames"] = self._frames
        return state

    def set_state(self, state: dict) -> int:
        from ray_tpu_torch.rl.algorithm import apply_full_training_state
        state = dict(state)
        self._step_no = int(state.pop("_step_no", 0))
        self._frames = int(state.pop("_frames", 0))
        apply_full_training_state(self, state)
        return self.publish_now()

    def stats(self) -> dict:
        return {"steps": self._step_no, "frames": self._frames,
                "weight_version": self._publisher.version,
                "weight_payload_nbytes":
                    self._publisher.last_payload_nbytes,
                "device": str(self.device)}

    # ---------------------------------------------------- compiled-DAG op
    def step(self, payload: Tuple[Any, dict]) -> dict:
        from ray_tpu_torch.rl.algorithm import to_device
        fragment, meta = payload
        batch = to_device({k: fragment[k] for k in self._keys
                           if k in fragment}, self.device)
        self.opt_state, aux = self._sgd_step(self.opt_state, batch)
        self._step_no += 1
        frames = int(np.asarray(fragment[SB.REWARDS]).size)
        self._frames += frames
        published = 0
        t0 = time.perf_counter()
        if self._step_no % self._sync_every == 0:
            published = self._publisher.publish(self.get_weights())
        return {"aux": {k: float(v) for k, v in aux.items()},
                "step": self._step_no,
                "frames": frames,
                "published_version": published,
                "publish_ms": (time.perf_counter() - t0) * 1e3
                if published else 0.0,
                "weight_payload_nbytes":
                    self._publisher.last_payload_nbytes,
                "learner_ts": time.time()}


def learner_actor_class(num_cpus: float = 1.0, num_gpus: float = 0.0):
    """The remote class of the learner: ``num_gpus=1`` leases the card it
    steps on (the JAX package's ``num_tpus``)."""
    import ray_tpu_torch
    return ray_tpu_torch.remote(num_cpus=num_cpus,
                                num_gpus=num_gpus)(LearnerActor)
