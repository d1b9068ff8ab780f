"""Podracer RL data plane (counterpart of ray_tpu/rl/podracer/;
docs/rl_podracer.md).

Sebulba-style learner–actor executor (arXiv:2104.06272; RLAX
arXiv:2512.06392): free-running rollout actors stream fragments
per-yield with bounded staleness, the learner step runs as a compiled
DAG (zero steady-state task submissions), and weight versions
broadcast multi-source striped over the transfer plane.  IMPALA and
PPO ride it via ``config.podracer()``.
"""

from ray_tpu_torch.rl.podracer.executor import PodracerExecutor
from ray_tpu_torch.rl.podracer.learner import LearnerActor
from ray_tpu_torch.rl.podracer.rollout import PodracerRolloutActor
from ray_tpu_torch.rl.podracer.weights import (WeightFollower, WeightPublisher,
                                         decode_weights, encode_weights)

__all__ = [
    "PodracerExecutor", "LearnerActor", "PodracerRolloutActor",
    "WeightPublisher", "WeightFollower", "encode_weights",
    "decode_weights",
]
