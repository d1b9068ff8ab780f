"""Serve REST schema: declarative application/deployment descriptions.

Analog of Ray's python/ray/serve/schema.py (ServeApplicationSchema,
DeploymentSchema, ServeStatusSchema — pydantic there, stdlib dataclasses
here since the image pins no pydantic).  The same dicts flow through the
dashboard REST endpoints (`/api/serve/applications`) and the `ray serve`
CLI, and `apply()` builds/updates a running application from the declarative
form (reference serve deploy semantics: import_path + per-deployment
overrides).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class DeploymentSchema:
    name: str
    num_replicas: Optional[int] = None
    max_concurrent_queries: Optional[int] = None
    user_config: Optional[Dict[str, Any]] = None
    ray_actor_options: Optional[Dict[str, Any]] = None
    autoscaling_config: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DeploymentSchema":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class ServeApplicationSchema:
    """One application: an import path to a bound Application + overrides."""

    import_path: str = ""
    name: str = "default"
    route_prefix: Optional[str] = "/"
    runtime_env: Optional[Dict[str, Any]] = None
    deployments: List[DeploymentSchema] = dataclasses.field(
        default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"import_path": self.import_path,
                               "name": self.name,
                               "route_prefix": self.route_prefix}
        if self.runtime_env:
            out["runtime_env"] = self.runtime_env
        if self.deployments:
            out["deployments"] = [d.to_dict() for d in self.deployments]
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServeApplicationSchema":
        deployments = [DeploymentSchema.from_dict(x)
                       for x in d.get("deployments", [])]
        return cls(import_path=d.get("import_path", ""),
                   name=d.get("name", "default"),
                   route_prefix=d.get("route_prefix", "/"),
                   runtime_env=d.get("runtime_env"),
                   deployments=deployments)

    # ------------------------------------------------------------ execution
    def load_application(self):
        """Import the bound Application named by ``import_path``
        ("module.sub:app" or "module.sub.app")."""
        path = self.import_path
        if ":" in path:
            mod_name, attr = path.split(":", 1)
        else:
            mod_name, _, attr = path.rpartition(".")
        if not mod_name or not attr:
            raise ValueError(f"bad import path {path!r}")
        app = getattr(importlib.import_module(mod_name), attr)
        from ray_tpu_torch.serve.deployment import Application
        if not isinstance(app, Application):
            raise TypeError(f"{path} is {type(app).__name__}, expected a "
                            "bound Application (deployment.bind(...))")
        return app

    def apply(self):
        """serve.run the imported application with this schema's overrides
        (reference `serve deploy` path)."""
        from ray_tpu_torch import serve
        if self.runtime_env or (self.route_prefix not in (None, "/")):
            from ray_tpu_torch._private.logging_utils import get_logger
            get_logger("serve").warning(
                "ServeApplicationSchema: runtime_env/route_prefix are "
                "accepted for config compatibility but not applied yet "
                "(HTTP routing is deployment-name based)")
        app = self.load_application()
        overrides = {d.name: d for d in self.deployments}
        for node in app._flatten():
            ov = overrides.get(node.deployment.name)
            if ov is None:
                continue
            opts: Dict[str, Any] = {}
            if ov.num_replicas is not None:
                opts["num_replicas"] = ov.num_replicas
            if ov.max_concurrent_queries is not None:
                opts["max_concurrent_queries"] = ov.max_concurrent_queries
            if ov.user_config is not None:
                opts["user_config"] = ov.user_config
            if ov.autoscaling_config is not None:
                opts["autoscaling_config"] = ov.autoscaling_config
            if ov.ray_actor_options is not None:
                opts["ray_actor_options"] = ov.ray_actor_options
            if opts:
                node.deployment = node.deployment.options(**opts)
        return serve.run(app, name=None if self.name == "default"
                         else self.name)


def serve_status_schema() -> Dict[str, Any]:
    """Cluster-wide serve status dict (ServeStatusSchema analog)."""
    from ray_tpu_torch import serve
    try:
        return serve.status()
    except Exception as e:  # controller not running
        return {"applications": {}, "error": str(e)}
