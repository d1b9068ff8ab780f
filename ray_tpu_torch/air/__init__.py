"""AIR-style glue shared by train and serve (the port's copy of
ray_tpu/air).

Analog of Ray's python/ray/air (Checkpoint checkpoint.py:60,
ScalingConfig config.py:79, FailureConfig :454, CheckpointConfig :513,
RunConfig :642, session.py:41).
"""

from ray_tpu_torch.air.checkpoint import Checkpoint  # noqa: F401
from ray_tpu_torch.air.config import (CheckpointConfig,  # noqa: F401
                                      FailureConfig, RunConfig,
                                      ScalingConfig)
from ray_tpu_torch.air.result import Result  # noqa: F401
from ray_tpu_torch.air import session  # noqa: F401

__all__ = [
    "Checkpoint", "ScalingConfig", "FailureConfig", "CheckpointConfig",
    "RunConfig", "Result", "session",
]
