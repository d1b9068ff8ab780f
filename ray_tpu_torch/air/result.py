"""Result: the outcome of one training run / trial.

The port's copy of ray_tpu/air/result.py; analog of Ray's
python/ray/air/result.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.air.checkpoint import Checkpoint


@dataclasses.dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint] = None
    error: Optional[Exception] = None
    log_dir: Optional[str] = None
    metrics_dataframe: Optional[Any] = None
    best_checkpoints: Optional[List[Tuple[Checkpoint, Dict[str, Any]]]] = None

    @property
    def config(self) -> Optional[Dict[str, Any]]:
        return (self.metrics or {}).get("config")
