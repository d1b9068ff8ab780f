"""Cross-language task invocation.

Analog of /root/reference/python/ray/cross_language.py (java_function :15,
java_actor_class :50), retargeted at this framework's native language:
``cpp_function("Name")`` returns a handle whose ``.remote(...)`` submits a
task with fn_key ``cpp:Name`` and ``language="cpp"`` — the raylet leases a
C++ worker (csrc/cpp_worker.cc) whose static registry resolves the name
(csrc/cpp_functions.h RAY_TPU_CPP_FUNCTION).

v1 scope, enforced at submit time where possible: positional by-value
primitive args (no ObjectRefs into cpp tasks), primitive results, fixed
num_returns (no "dynamic"), no cpp actors yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

_PRIMITIVES = (type(None), bool, int, float, str, bytes)

NO_CPP_WORKER = (
    "ray_tpu_torch has no stock C++ worker yet (ROADMAP.md, Queue 1: the "
    "cross-language C++ workers wait for a later slice); set "
    "cpp_worker_binary to a worker binary")


def _require_cpp_worker() -> None:
    """Refuse a C++ task or actor at the call site while the port builds
    no worker binary and none is configured (a lease for one could
    never be granted)."""
    from ray_tpu_torch._private.config import CONFIG
    if not CONFIG.cpp_worker_binary:
        raise RuntimeError(NO_CPP_WORKER)


def _check_arg(a: Any, depth: int = 0) -> None:
    from ray_tpu_torch.runtime.core_worker import ObjectRef
    if isinstance(a, ObjectRef):
        if depth == 0:
            return  # resolved worker-side via the borrower protocol
        # nested refs pass through Python workers as live handles, but a
        # cpp worker would see an opaque marker it cannot resolve —
        # reject at the call site instead of corrupting silently
        raise TypeError(
            "ObjectRef args to cpp tasks must be top-level positional "
            "args (nested inside containers they are not resolvable "
            "C++-side)")
    if isinstance(a, (list, tuple)):
        for x in a:
            _check_arg(x, depth + 1)
        return
    if isinstance(a, dict):
        for k, v in a.items():
            _check_arg(k, depth + 1)
            _check_arg(v, depth + 1)
        return
    if not isinstance(a, _PRIMITIVES):
        raise TypeError(
            f"cpp tasks take primitive by-value args; got {type(a).__name__}"
            " (arrays and arbitrary objects are not representable "
            "C++-side; top-level ObjectRefs to primitive values are)")


def _guard_args(args) -> None:
    """Reject what the C++ side cannot receive: non-primitive values.
    ObjectRef args (explicit or from large-arg store promotion) are fine
    — the cpp worker fetches them through the owner/raylet like any
    borrower, provided the referenced VALUE is itself primitive."""
    for a in args:
        _check_arg(a)


class CppFunction:
    """Handle on a C++ function registered in the worker binary."""

    def __init__(self, name: str, *, num_returns: int = 1,
                 resources: Optional[Dict[str, float]] = None,
                 max_retries: int = 3):
        if not name or ":" in name:
            raise ValueError(f"bad cpp function name {name!r}")
        self._name = name
        self._num_returns = num_returns
        self._resources = dict(resources or {})
        self._max_retries = max_retries

    def options(self, *, num_returns: Optional[int] = None,
                resources: Optional[Dict[str, float]] = None,
                max_retries: Optional[int] = None) -> "CppFunction":
        return CppFunction(
            self._name,
            num_returns=self._num_returns if num_returns is None
            else num_returns,
            resources=self._resources if resources is None else resources,
            max_retries=self._max_retries if max_retries is None
            else max_retries)

    def remote(self, *args):
        from ray_tpu_torch.runtime.core_worker import get_global_worker
        _require_cpp_worker()
        _guard_args(args)
        if not isinstance(self._num_returns, int):
            raise ValueError("cpp tasks need a fixed integer num_returns")
        worker = get_global_worker()
        refs = worker.submit_task(
            None, args, {},
            num_returns=self._num_returns,
            resources=self._resources,
            max_retries=self._max_retries,
            name=f"cpp:{self._name}",
            fn_key=f"cpp:{self._name}",
            language="cpp")
        if self._num_returns == 1:
            return refs[0]
        return refs


def cpp_function(name: str, **options) -> CppFunction:
    """Handle on the C++ task ``name`` (RAY_TPU_CPP_FUNCTION-registered
    in the worker binary — stock functions live in
    csrc/cpp_builtin_functions.cc)."""
    return CppFunction(name, **options)


class _CppMethod:
    def __init__(self, handle: "CppActorHandle", method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args):
        from ray_tpu_torch.runtime.core_worker import get_global_worker
        _guard_args(args)
        refs = get_global_worker().submit_actor_task(
            self._handle._actor_id, self._method, args, {}, num_returns=1)
        return refs[0]


class CppActorHandle:
    """Handle on a live C++ actor; ``handle.method.remote(...)`` submits
    through the same ordered per-actor pipeline Python actors use (the
    worker executes in seq order).  Works with ``ray_tpu_torch.kill``."""

    def __init__(self, actor_id):
        self._actor_id = actor_id

    def __getattr__(self, name: str) -> _CppMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return _CppMethod(self, name)

    def __repr__(self):
        return f"CppActorHandle({self._actor_id.hex()[:12]})"


class CppActorClass:
    """Class-side handle for a C++ actor registered with
    RAY_TPU_CPP_ACTOR in the worker binary."""

    def __init__(self, name: str, *,
                 resources: Optional[Dict[str, float]] = None,
                 max_restarts: int = 0,
                 actor_name: Optional[str] = None,
                 lifetime: Optional[str] = None):
        if not name or ":" in name:
            raise ValueError(f"bad cpp actor class name {name!r}")
        self._cls = name
        self._resources = dict(resources or {})
        self._max_restarts = max_restarts
        self._actor_name = actor_name
        self._lifetime = lifetime

    def options(self, *, resources: Optional[Dict[str, float]] = None,
                max_restarts: Optional[int] = None,
                name: Optional[str] = None,
                lifetime: Optional[str] = None) -> "CppActorClass":
        return CppActorClass(
            self._cls,
            resources=self._resources if resources is None else resources,
            max_restarts=self._max_restarts if max_restarts is None
            else max_restarts,
            actor_name=self._actor_name if name is None else name,
            lifetime=self._lifetime if lifetime is None else lifetime)

    def remote(self, *args) -> CppActorHandle:
        from ray_tpu_torch.runtime.core_worker import get_global_worker
        _require_cpp_worker()
        _guard_args(args)
        actor_id = get_global_worker().create_actor(
            None, args, {},
            name=self._actor_name,
            detached=self._lifetime == "detached",
            max_restarts=self._max_restarts,
            resources=self._resources,
            cls_key=f"cpp:{self._cls}",
            language="cpp")
        return CppActorHandle(actor_id)


def cpp_actor_class(name: str, **options) -> CppActorClass:
    """Handle on the C++ actor class ``name`` (reference
    cross_language.py:50 java_actor_class analog; stock classes in
    csrc/cpp_builtin_functions.cc: Counter, Kv)."""
    return CppActorClass(name, **options)
