"""Run/scaling/failure/checkpoint config dataclasses (the port's copy of
ray_tpu/air/config.py).

Analog of Ray's python/ray/air/config.py (ScalingConfig :79,
FailureConfig :454, CheckpointConfig :513, RunConfig :642).  ray_tpu's
``use_tpu`` / ``"TPU"`` lease is ``use_gpu`` / ``"GPU"`` here: a worker
that sets it leases ``devices_per_worker`` cards (a fraction shares one
card, as half-card Serve replicas do) and runs its loop on the card it
sees.  ``mesh_shape`` is kept, but a mesh of more than one device waits
for multi-device training (ROADMAP.md, Queue 1, item 4, multi-device).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, List, Optional, Tuple

MULTI_DEVICE = ("a device mesh of more than one device waits for "
                "multi-device training (ROADMAP.md, Queue 1, item 4, "
                "multi-device)")


@dataclasses.dataclass
class ScalingConfig:
    """How many workers (host processes) and the cards each leases.

    ``num_workers`` is the number of trainer actors.  ``use_gpu`` leases
    ``devices_per_worker`` GPUs per worker (default 1; a fraction shares
    one card), so the worker's loop sees its own card
    (``CUDA_VISIBLE_DEVICES``); without it a worker leases no card and
    never starts CUDA.  ``mesh_shape`` maps logical axis name -> size;
    only a one-device mesh runs on the port.
    """
    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    mesh_shape: Optional[Dict[str, int]] = None      # e.g. {"data": 1}
    devices_per_worker: Optional[float] = None
    placement_strategy: str = "PACK"
    trainer_resources: Optional[Dict[str, float]] = None

    def __post_init__(self):
        if self.mesh_shape and math.prod(self.mesh_shape.values()) > 1:
            raise NotImplementedError(
                f"mesh_shape {self.mesh_shape}: {MULTI_DEVICE}")

    @property
    def mesh_axis_names(self) -> Tuple[str, ...]:
        if not self.mesh_shape:
            return ("data",)
        return tuple(self.mesh_shape.keys())

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu:
            res.setdefault("GPU", float(self.devices_per_worker or 1))
        return res

    def as_placement_group_bundles(self) -> List[Dict[str, float]]:
        return [self.worker_resources() for _ in range(self.num_workers)]


@dataclasses.dataclass
class FailureConfig:
    """Cf. Ray's air/config.py:454. ``max_failures=-1`` retries forever."""
    max_failures: int = 0
    fail_fast: bool = False


@dataclasses.dataclass
class CheckpointConfig:
    """Cf. Ray's air/config.py:513."""
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0
    checkpoint_at_end: Optional[bool] = None

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")


@dataclasses.dataclass
class RunConfig:
    """Cf. Ray's air/config.py:642."""
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None
    stop: Optional[Dict[str, Any]] = None
    verbose: int = 1
    log_to_file: bool = False
    callbacks: Optional[List[Any]] = None

    def __post_init__(self):
        if self.failure_config is None:
            self.failure_config = FailureConfig()
        if self.checkpoint_config is None:
            self.checkpoint_config = CheckpointConfig()
        if self.storage_path is None:
            self.storage_path = os.path.expanduser("~/ray_tpu_torch_results")
