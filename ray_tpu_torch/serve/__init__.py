"""Serve: scalable model serving on ray_tpu_torch actors.

The port's copy of ray_tpu's Serve: a detached ServeController actor owns
deployment state and reconciles replica actors; handles route requests
with power-of-two-choices load balancing; autoscaling reacts to
per-replica queue metrics.  Replicas that hold the card lease
``num_gpus``.  ``serve.llm`` is the LLM deployment (``LLMServer``,
``build_app``, ``disagg_handle``) over the continuous-batching engine
(``serve/llm_engine.py``).  ``serve.start(http=True)`` or
``serve.run(..., http_options=HTTPOptions(...))`` starts the HTTP front
door (``http_proxy.py``, SSE in ``frontdoor/sse.py``), on the standard
library.
"""

from ray_tpu_torch.serve.api import (delete, get_app_handle,
                                     get_deployment_handle, run, shutdown,
                                     start, status)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import AutoscalingConfig, HTTPOptions
from ray_tpu_torch.serve.deployment import Application, Deployment, deployment
from ray_tpu_torch.serve.handle import DeploymentHandle


def __getattr__(name):
    # serve.llm pulls torch's model code and the engine; load it only
    # when asked for so plain serve users keep the fast import
    if name == "llm":
        import importlib
        return importlib.import_module("ray_tpu_torch.serve.llm")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "start", "run", "shutdown", "delete", "status", "deployment",
    "Deployment", "Application", "DeploymentHandle", "batch",
    "AutoscalingConfig", "HTTPOptions", "get_app_handle",
    "get_deployment_handle",
]
