"""Trial: one parameterized run of a trainable (the port's copy of
ray_tpu/tune/trial.py).

Analog of Ray's python/ray/tune/experiment/trial.py.
"""

from __future__ import annotations

import os
import uuid
from typing import Any, Dict, Optional

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


class Trial:
    def __init__(self, config: Dict[str, Any], experiment_dir: str,
                 resources: Optional[Dict[str, float]] = None,
                 trial_id: Optional[str] = None):
        self.trial_id = trial_id or uuid.uuid4().hex[:8]
        self.config = config
        self.resources = dict(resources or {"CPU": 1.0})
        self.status = PENDING
        self.actor = None                      # TrainWorker handle
        self.last_result: Dict[str, Any] = {}
        self.results: list = []
        self.checkpoint = None                 # latest air.Checkpoint
        self.error: Optional[str] = None
        self.num_failures = 0
        self.logdir = os.path.join(experiment_dir, f"trial_{self.trial_id}")
        os.makedirs(self.logdir, exist_ok=True)
        # PBT exploit request: (donor_checkpoint, new_config) to apply
        self.pending_exploit = None

    @property
    def iteration(self) -> int:
        return self.last_result.get("training_iteration", 0)

    def __repr__(self):
        return f"Trial({self.trial_id}, {self.status}, it={self.iteration})"
