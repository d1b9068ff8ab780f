"""@ray_tpu_torch.remote for functions.

Analog of /root/reference/python/ray/remote_function.py (RemoteFunction :35,
_remote :241, .options :141).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch.runtime.core_worker import (get_global_worker,
                                         normalize_num_returns)


class RemoteFunction:
    def __init__(self, func, *, num_returns=1,
                 num_cpus: float = 1.0, num_gpus: float = 0.0,
                 resources: Optional[Dict[str, float]] = None,
                 max_retries: int = 3,
                 scheduling_strategy: Any = None,
                 runtime_env: Optional[Dict[str, Any]] = None):
        self._func = func
        self._num_returns = normalize_num_returns(num_returns)
        self._resources = dict(resources or {})
        self._resources["CPU"] = num_cpus
        if num_gpus:
            self._resources["GPU"] = num_gpus
        self._max_retries = max_retries
        self._scheduling_strategy = scheduling_strategy
        self._runtime_env = runtime_env
        # every .options(...) key as given, carried into .bind() nodes
        self._bound_options: Dict[str, Any] = {}
        functools.update_wrapper(self, func)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self._func.__name__!r} cannot be called "
            "directly; use .remote()")

    def remote(self, *args, **kwargs):
        from ray_tpu_torch.util import client as client_mod
        ctx = client_mod.current()
        if ctx is not None:
            if self._num_returns == "streaming":
                raise NotImplementedError(
                    'num_returns="streaming" is not supported in '
                    "remote-driver (client://) mode: the stream is owned "
                    "by the submitting process")
            # remote-driver mode is decided at *call* time so functions
            # decorated before init("client://...") still route correctly
            return ctx.remote(
                self._func,
                num_returns=self._num_returns,
                num_cpus=self._resources.get("CPU", 1.0),
                num_gpus=self._resources.get("GPU", 0.0),
                resources={k: v for k, v in self._resources.items()
                           if k not in ("CPU", "GPU")},
                max_retries=self._max_retries,
            ).remote(*args, **kwargs)
        from ray_tpu_torch.util.scheduling_strategies import encode_strategy
        worker = get_global_worker()
        refs = worker.submit_task(
            self._func, args, kwargs,
            num_returns=self._num_returns,
            resources=self._resources,
            max_retries=self._max_retries,
            name=getattr(self._func, "__name__", "task"),
            scheduling_strategy=encode_strategy(self._scheduling_strategy),
            runtime_env=worker.prepare_runtime_env(self._runtime_env))
        if self._num_returns == "streaming":
            # per-yield delivery: hand back the live stream, not a ref
            return worker.make_streaming_generator(refs[0])
        if self._num_returns == 1 or self._num_returns == "dynamic":
            return refs[0]
        return refs

    def bind(self, *args, **kwargs):
        """Lazy DAG authoring (cf. reference dag/function_node.py).  The
        accumulated .options(...) ride along so DAG consumers (Serve,
        Workflow) see them — including extension keys like the Workflow
        step options ("_workflow") that plain .remote() ignores."""
        from ray_tpu_torch.dag import FunctionNode
        return FunctionNode(self, args, kwargs,
                            options=dict(self._bound_options))

    def options(self, **opts) -> "RemoteFunction":
        new = RemoteFunction(
            self._func,
            num_returns=opts.get("num_returns", self._num_returns),
            num_cpus=opts.get("num_cpus", self._resources.get("CPU", 1.0)),
            num_gpus=opts.get("num_gpus", self._resources.get("GPU", 0.0)),
            resources=opts.get("resources",
                               {k: v for k, v in self._resources.items()
                                if k not in ("CPU", "GPU")}),
            max_retries=opts.get("max_retries", self._max_retries),
            scheduling_strategy=opts.get("scheduling_strategy",
                                         self._scheduling_strategy),
            runtime_env=opts.get("runtime_env", self._runtime_env))
        new._bound_options = dict(self._bound_options, **opts)
        return new
