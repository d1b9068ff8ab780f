"""@serve.deployment decorator, Deployment, and bound Applications.

Analog of Ray's python/ray/serve/deployment.py and the
deployment-graph builder (_private/deployment_graph_build.py): ``.bind()``
captures init args — including other bound deployments, which become
DeploymentHandles at runtime — producing an Application that ``serve.run``
deploys bottom-up.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig


@dataclass
class Application:
    """A deployment bound to init args (possibly referencing other apps)."""
    deployment: "Deployment"
    init_args: Tuple = ()
    init_kwargs: Dict[str, Any] = field(default_factory=dict)

    def _flatten(self) -> List["Application"]:
        """All applications in dependency order (dependencies first)."""
        seen: List[Application] = []

        def visit(app: Application):
            for a in list(app.init_args) + list(app.init_kwargs.values()):
                if isinstance(a, Application):
                    visit(a)
            if app not in seen:
                seen.append(app)

        visit(self)
        return seen


class Deployment:
    def __init__(self, func_or_class: Callable, name: str,
                 config: DeploymentConfig):
        self.func_or_class = func_or_class
        self.name = name
        self.config = config

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def options(self, **opts) -> "Deployment":
        cfg = DeploymentConfig(**{**self.config.__dict__})
        for k, v in opts.items():
            if k == "name":
                continue
            if not hasattr(cfg, k):
                raise ValueError(f"unknown deployment option {k!r}")
            if k == "autoscaling_config" and isinstance(v, dict):
                v = AutoscalingConfig(**v)
            setattr(cfg, k, v)
        return Deployment(self.func_or_class,
                          opts.get("name", self.name), cfg)

    def __repr__(self):
        return f"Deployment(name={self.name!r})"


def deployment(_func_or_class: Optional[Callable] = None, *,
               name: Optional[str] = None,
               num_replicas: int = 1,
               max_concurrent_queries: int = 8,
               user_config: Optional[Any] = None,
               autoscaling_config: Optional[AutoscalingConfig] = None,
               ray_actor_options: Optional[Dict[str, Any]] = None):
    """``@serve.deployment`` (cf. reference serve/api.py:251)."""

    def wrap(target):
        if isinstance(autoscaling_config, dict):
            auto = AutoscalingConfig(**autoscaling_config)
        else:
            auto = autoscaling_config
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_concurrent_queries=max_concurrent_queries,
            user_config=user_config,
            autoscaling_config=auto,
            ray_actor_options=dict(ray_actor_options or {}))
        return Deployment(target, name or target.__name__, cfg)

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap
