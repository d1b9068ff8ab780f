"""serve.start/run/shutdown/delete/status — the public Serve API.

Analog of Ray's python/ray/serve/api.py (serve.run :455) and
_private/client.py: ``start`` launches the detached controller (+ HTTP
proxy, ``serve/http_proxy.py``), ``run`` deploys an Application graph
bottom-up and returns a handle to the root deployment.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch import cloudpickle
from ray_tpu_torch.serve.config import HTTPOptions
from ray_tpu_torch.serve.controller import (CONTROLLER_NAME, SERVE_NAMESPACE,
                                      ServeController)
from ray_tpu_torch.serve.deployment import Application, Deployment
from ray_tpu_torch.serve.handle import DeploymentHandle

PROXY_NAME = "SERVE_PROXY"


def _ensure_proxy(http_options: HTTPOptions) -> None:
    try:
        ray_tpu_torch.get_actor(PROXY_NAME, namespace=SERVE_NAMESPACE)
        return  # already running (port changes need serve.shutdown first)
    except ValueError:
        pass
    from ray_tpu_torch.serve.http_proxy import HTTPProxyActor
    proxy = ray_tpu_torch.remote(HTTPProxyActor).options(
        name=PROXY_NAME, namespace=SERVE_NAMESPACE,
        lifetime="detached", max_concurrency=16, num_cpus=0.1,
    ).remote(http_options.host, http_options.port)
    ray_tpu_torch.get(proxy.ready.remote(), timeout=30)


def _get_controller(create: bool = False,
                    http_options: Optional[HTTPOptions] = None):
    controller = None
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME,
                                       namespace=SERVE_NAMESPACE)
    except ValueError:
        if not create:
            raise RuntimeError(
                "Serve is not running; call serve.start() or serve.run()")
    if controller is None:
        controller = ray_tpu_torch.remote(ServeController).options(
            name=CONTROLLER_NAME, namespace=SERVE_NAMESPACE,
            lifetime="detached", max_concurrency=16, num_cpus=0.1,
        ).remote()
        ray_tpu_torch.get(controller.ping.remote(), timeout=30)
    if http_options is not None:
        _ensure_proxy(http_options)
    return controller


def start(http_options: Optional[HTTPOptions] = None, *,
          http: bool = False) -> None:
    """Start the Serve instance (controller + optional HTTP proxy)."""
    if http and http_options is None:
        http_options = HTTPOptions()
    _get_controller(create=True, http_options=http_options)


def run(target: Application, *, name: Optional[str] = None,
        _blocking_until_healthy: bool = True,
        http_options: Optional[HTTPOptions] = None) -> DeploymentHandle:
    """Deploy an application graph; returns a handle to the root deployment.

    Bound sub-applications (``Deployment.bind`` args) deploy first and are
    replaced with DeploymentHandles in the parent's init args — the
    deployment-graph build of reference
    serve/_private/deployment_graph_build.py.
    """
    if isinstance(target, Deployment):
        target = target.bind()
    if not isinstance(target, Application):
        raise TypeError("serve.run expects a bound Application "
                        "(use Deployment.bind(...))")
    controller = _get_controller(create=True, http_options=http_options)

    apps = target._flatten()
    for app in apps:
        dep = app.deployment
        dep_name = (name if app is target and name else dep.name)

        def materialize(v):
            if isinstance(v, Application):
                return DeploymentHandle(v.deployment.name)
            return v

        init_args = tuple(materialize(a) for a in app.init_args)
        init_kwargs = {k: materialize(v)
                       for k, v in app.init_kwargs.items()}
        serialized = cloudpickle.dumps(
            (dep.func_or_class, init_args, init_kwargs))
        ray_tpu_torch.get(controller.deploy.remote(
            dep_name, serialized, dep.config.to_dict()), timeout=30)

    root_name = name or target.deployment.name
    deployed = {(name if app is target and name else app.deployment.name)
                for app in apps}
    if _blocking_until_healthy:
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            st = ray_tpu_torch.get(controller.status.remote(), timeout=10)
            if all(s["status"] == "HEALTHY"
                   for n, s in st.items() if n in deployed):
                break
            time.sleep(0.1)
        else:
            raise TimeoutError(
                "deployments not healthy: "
                f"{ {n: s for n, s in st.items() if n in deployed} }")
    return DeploymentHandle(root_name)


def get_app_handle(name: str) -> DeploymentHandle:
    controller = _get_controller()
    if name not in ray_tpu_torch.get(controller.list_deployments.remote()):
        raise ValueError(f"no deployment named {name!r}")
    return DeploymentHandle(name)


get_deployment_handle = get_app_handle


def status() -> Dict[str, Any]:
    controller = _get_controller()
    return ray_tpu_torch.get(controller.status.remote(), timeout=10)


def delete(name: str) -> None:
    controller = _get_controller()
    ray_tpu_torch.get(controller.delete_deployment.remote(name), timeout=30)


def shutdown() -> None:
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME,
                                       namespace=SERVE_NAMESPACE)
    except ValueError:
        return
    try:
        ray_tpu_torch.get(controller.shutdown_serve.remote(), timeout=30)
    except Exception:
        pass
    try:
        proxy = ray_tpu_torch.get_actor(PROXY_NAME, namespace=SERVE_NAMESPACE)
        ray_tpu_torch.kill(proxy)
    except Exception:
        pass
    ray_tpu_torch.kill(controller)
