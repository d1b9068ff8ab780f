"""Serve configuration dataclasses.

Analog of Ray's python/ray/serve/config.py (DeploymentConfig,
AutoscalingConfig, HTTPOptions) — plain dataclasses instead of pydantic
(pydantic isn't a baked-in dependency).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ray_tpu_torch._private.config import CONFIG


@dataclass
class AutoscalingConfig:
    """Queue-depth autoscaling policy knobs.

    Cf. reference serve/config.py AutoscalingConfig and
    _private/autoscaling_policy.py: target ongoing requests per replica
    drives desired replica count, with hysteresis delays.
    """
    min_replicas: int = 1
    max_replicas: int = 4
    target_num_ongoing_requests_per_replica: float = 2.0
    upscale_delay_s: float = 3.0
    downscale_delay_s: float = 10.0
    metrics_interval_s: float = 0.5


@dataclass
class HTTPOptions:
    # defaults resolve from the central flag table at construction so
    # RAY_TPU_TORCH_SERVE_HTTP_HOST/PORT env overrides reach `serve.start()`
    # callers that never build an explicit HTTPOptions
    host: str = field(default_factory=lambda: CONFIG.serve_http_host)
    port: int = field(default_factory=lambda: CONFIG.serve_http_port)


@dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_concurrent_queries: int = 8
    user_config: Optional[Any] = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    health_check_period_s: float = 2.0
    # replicas loading big models (LLM weights + first TPU compile) need a
    # long startup window before health checks can kill them
    health_check_grace_period_s: float = 120.0
    graceful_shutdown_timeout_s: float = 5.0
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = dict(self.__dict__)
        if self.autoscaling_config is not None:
            d["autoscaling_config"] = dict(self.autoscaling_config.__dict__)
        return d
