"""@ray_tpu_torch.remote for classes: ActorClass / ActorHandle / ActorMethod.

Analog of /root/reference/python/ray/actor.py (ActorClass :377,
ActorHandle :1022, ActorMethod :92).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch.runtime.core_worker import (get_global_worker,
                                         normalize_num_returns)


def method(*args, **kwargs):
    """``@ray_tpu_torch.method(concurrency_group=..., num_returns=...)`` — method
    options read worker-side at dispatch (cf. reference ray.method and
    concurrency groups, src/ray/core_worker/transport/
    concurrency_group_manager.h)."""
    def decorate(fn):
        fn.__ray_tpu_method_opts__ = dict(kwargs)
        return fn
    if len(args) == 1 and not kwargs and callable(args[0]):
        return decorate(args[0])
    if args:
        raise TypeError("@method takes keyword arguments only")
    return decorate


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 num_returns: int = 1,
                 concurrency_group: Optional[str] = None):
        self._handle = handle
        self._name = name
        # one normalization point shared with RemoteFunction: string
        # modes ("dynamic", "streaming") are validated here instead of
        # silently falling through int-only selection in remote()
        self._num_returns = normalize_num_returns(num_returns)
        self._concurrency_group = concurrency_group

    def remote(self, *args, **kwargs):
        worker = get_global_worker()
        refs = worker.submit_actor_task(
            self._handle._actor_id, self._name, args, kwargs,
            num_returns=self._num_returns,
            concurrency_group=self._concurrency_group)
        if self._num_returns == "streaming":
            return worker.make_streaming_generator(refs[0])
        if self._num_returns == 1 or self._num_returns == "dynamic":
            # "dynamic" reserves one slot: its ref resolves to the
            # ObjectRefGenerator at completion, same as task semantics
            return refs[0]
        return refs

    def options(self, num_returns: int = 1,
                concurrency_group: Optional[str] = None) -> "ActorMethod":
        return ActorMethod(self._handle, self._name, num_returns,
                           concurrency_group)

    def bind(self, *args, **kwargs):
        """Lazy DAG authoring against a LIVE actor (cf. reference
        actor-method ``.bind``): the node targets this handle's existing
        instance — classic ``execute()`` submits a normal actor task,
        and ``experimental_compile()`` schedules the method into a
        compiled graph without creating a new actor."""
        from ray_tpu_torch.dag.dag_node import ClassMethodNode, ExistingActorNode
        return ClassMethodNode(ExistingActorNode(self._handle), self._name,
                               args, kwargs)


def _collect_method_opts(cls) -> Dict[str, dict]:
    """Per-method @ray_tpu_torch.method(...) options, harvested from the class at
    handle-creation time (the handle alone can't see the class later)."""
    opts = {}
    for name in dir(cls):
        if name.startswith("__"):
            continue
        m = getattr(cls, name, None)
        o = getattr(m, "__ray_tpu_method_opts__", None)
        if o:
            opts[name] = dict(o)
    return opts


class ActorHandle:
    def __init__(self, actor_id: ActorID,
                 method_opts: Optional[Dict[str, dict]] = None):
        self._actor_id = actor_id
        self._method_opts = method_opts or {}

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        o = self._method_opts.get(name, {})
        return ActorMethod(self, name,
                           num_returns=o.get("num_returns", 1),
                           concurrency_group=o.get("concurrency_group"))

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._method_opts))


class ActorClass:
    def __init__(self, cls, *, num_cpus: float = 1.0, num_gpus: float = 0.0,
                 resources: Optional[Dict[str, float]] = None,
                 max_restarts: int = 0, name: Optional[str] = None,
                 namespace: str = "", lifetime: Optional[str] = None,
                 max_concurrency: Optional[int] = None,
                 concurrency_groups: Optional[Dict[str, int]] = None,
                 scheduling_strategy=None,
                 runtime_env: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._runtime_env = runtime_env
        self._resources = dict(resources or {})
        self._resources["CPU"] = num_cpus
        if num_gpus:
            self._resources["GPU"] = num_gpus
        self._max_restarts = max_restarts
        self._name = name
        self._namespace = namespace
        self._lifetime = lifetime
        self._max_concurrency = max_concurrency
        self._concurrency_groups = dict(concurrency_groups or {})
        self._scheduling_strategy = scheduling_strategy

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self._cls.__name__!r} cannot be instantiated "
            "directly; use .remote()")

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ray_tpu_torch.util import client as client_mod
        ctx = client_mod.current()
        if ctx is not None:
            # remote-driver mode is decided at *call* time (see
            # RemoteFunction.remote)
            return ctx.remote(
                self._cls,
                num_cpus=self._resources.get("CPU", 1.0),
                num_gpus=self._resources.get("GPU", 0.0),
                resources={k: v for k, v in self._resources.items()
                           if k not in ("CPU", "GPU")},
                max_restarts=self._max_restarts,
                name=self._name,
                max_concurrency=self._max_concurrency,
                concurrency_groups=self._concurrency_groups,
            ).remote(*args, **kwargs)
        from ray_tpu_torch.util.scheduling_strategies import encode_strategy
        worker = get_global_worker()
        actor_id = worker.create_actor(
            self._cls, args, kwargs,
            name=self._name,
            namespace=self._namespace,
            detached=self._lifetime == "detached",
            max_restarts=self._max_restarts,
            max_concurrency=self._max_concurrency,
            concurrency_groups=self._concurrency_groups,
            resources=self._resources,
            scheduling_strategy=encode_strategy(self._scheduling_strategy),
            runtime_env=worker.prepare_runtime_env(self._runtime_env))
        return ActorHandle(actor_id, _collect_method_opts(self._cls))

    def bind(self, *args, **kwargs):
        """Lazy DAG authoring (cf. reference dag/class_node.py)."""
        from ray_tpu_torch.dag import ClassNode
        return ClassNode(self, args, kwargs)

    def options(self, **opts) -> "ActorClass":
        return ActorClass(
            self._cls,
            num_cpus=opts.get("num_cpus", self._resources.get("CPU", 1.0)),
            num_gpus=opts.get("num_gpus", self._resources.get("GPU", 0.0)),
            resources=opts.get("resources",
                               {k: v for k, v in self._resources.items()
                                if k not in ("CPU", "GPU")}),
            max_restarts=opts.get("max_restarts", self._max_restarts),
            name=opts.get("name", self._name),
            namespace=opts.get("namespace", self._namespace),
            lifetime=opts.get("lifetime", self._lifetime),
            max_concurrency=opts.get("max_concurrency",
                                     self._max_concurrency),
            concurrency_groups=opts.get("concurrency_groups",
                                        self._concurrency_groups),
            scheduling_strategy=opts.get("scheduling_strategy",
                                         self._scheduling_strategy),
            runtime_env=opts.get("runtime_env", self._runtime_env))


def get_actor(name: str, namespace: str = "") -> ActorHandle:
    """Look up a named actor (cf. ray.get_actor)."""
    worker = get_global_worker()
    info = worker.gcs.call("get_actor", {"name": name,
                                         "namespace": namespace})
    if info is None:
        raise ValueError(f"no actor named {name!r}")
    return ActorHandle(ActorID.from_hex(info["actor_id"]))


def kill(handle) -> None:
    """Forcibly terminate an actor (cf. ray.kill)."""
    from ray_tpu_torch.util import client as client_mod
    ctx = client_mod.current()
    if ctx is not None:
        ctx.kill(handle)
        return
    get_global_worker().kill_actor(handle._actor_id)
