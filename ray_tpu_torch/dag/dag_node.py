"""DAG node types: build lazily, execute via tasks/actors.

Cf. reference python/ray/dag/dag_node.py:23 (_apply_recursive traversal),
function_node.py, class_node.py, input_node.py. Execution resolves
children depth-first, replacing nodes with ObjectRefs/actor handles, and
caches per-node results so diamond dependencies execute once.
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional


class DAGNode:
    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = args
        self._bound_kwargs = kwargs
        self._stable_uuid = uuid.uuid4().hex

    # ------------------------------------------------------------ traversal
    def _children(self) -> List["DAGNode"]:
        out = []
        for a in list(self._bound_args) + list(self._bound_kwargs.values()):
            if isinstance(a, DAGNode):
                out.append(a)
        return out

    def _resolve_args(self, cache: Dict[str, Any], input_value: Any):
        args = tuple(a._execute_recursive(cache, input_value)
                     if isinstance(a, DAGNode) else a
                     for a in self._bound_args)
        kwargs = {k: (v._execute_recursive(cache, input_value)
                      if isinstance(v, DAGNode) else v)
                  for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def _execute_recursive(self, cache: Dict[str, Any], input_value: Any):
        if self._stable_uuid not in cache:
            cache[self._stable_uuid] = self._execute_impl(cache, input_value)
        return cache[self._stable_uuid]

    def _execute_impl(self, cache, input_value):
        raise NotImplementedError

    # ------------------------------------------------------------ user API
    def execute(self, *input_values) -> Any:
        """Submit the whole DAG; returns the root's ObjectRef (or value)."""
        input_value = input_values[0] if input_values else None
        return self._execute_recursive({}, input_value)

    def experimental_compile(self, *, max_inflight: int = 2,
                             buffer_size_bytes: int = 1 << 20,
                             name: str = "", threaded_ops: bool = False):
        """Compile an actor-method-only graph into a ``CompiledDAG``:
        preallocated shm channels per edge + resident actor loops, so
        ``execute()`` pays zero per-call task submission (see
        dag/compiled_dag.py and docs/compiled_dag.md).

        ``threaded_ops=True`` gives each of an actor's ops its own
        resident thread instead of one serial per-actor loop: an actor
        appearing at several pipeline depths (e.g. forward AND backward
        of an MPMD stage) can then work on different execution indices
        concurrently — the 1F1B interleave.  Method execution stays
        serialized per actor (the worker's method mutex); only the
        channel waits overlap."""
        from ray_tpu_torch.dag.compiled_dag import CompiledDAG
        return CompiledDAG(self, max_inflight=max_inflight,
                           buffer_size_bytes=buffer_size_bytes, name=name,
                           threaded_ops=threaded_ops)

    def walk(self) -> List["DAGNode"]:
        """All nodes, dependencies first, each once."""
        seen: set = set()
        order: List[DAGNode] = []

        def visit(node: DAGNode):
            if node._stable_uuid in seen:
                return
            seen.add(node._stable_uuid)
            for c in node._children():
                visit(c)
            order.append(node)

        visit(self)
        return order


class InputNode(DAGNode):
    """Placeholder for the runtime input (cf. reference input_node.py:13).

    Supports ``with InputNode() as x:`` authoring style.
    """

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def _execute_impl(self, cache, input_value):
        return input_value


class FunctionNode(DAGNode):
    def __init__(self, remote_function, args, kwargs, options=None):
        super().__init__(args, kwargs)
        self._remote_function = remote_function
        self._options = options or {}

    def _execute_impl(self, cache, input_value):
        args, kwargs = self._resolve_args(cache, input_value)
        fn = self._remote_function
        if self._options:
            fn = fn.options(**self._options)
        # upstream ObjectRefs pass through as-is: the executing worker
        # resolves ref args in-place (worker_main._resolve_args), so
        # intermediate results never round-trip through the driver
        return fn.remote(*args, **kwargs)


class ClassNode(DAGNode):
    """A bound actor-class instantiation inside a DAG."""

    def __init__(self, actor_class, args, kwargs, options=None):
        super().__init__(args, kwargs)
        self._actor_class = actor_class
        self._options = options or {}

    def _execute_impl(self, cache, input_value):
        args, kwargs = self._resolve_args(cache, input_value)
        cls = self._actor_class
        if self._options:
            cls = cls.options(**self._options)
        return cls.remote(*args, **kwargs)

    def __getattr__(self, method_name: str):
        if method_name.startswith("_"):
            raise AttributeError(method_name)
        return _ClassMethodStub(self, method_name)


class _ClassMethodStub:
    def __init__(self, class_node: ClassNode, method_name: str):
        self._class_node = class_node
        self._method_name = method_name

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._method_name,
                               args, kwargs)


class ExistingActorNode(DAGNode):
    """A live ActorHandle bound into a DAG (``handle.method.bind(...)``):
    unlike ClassNode, executing/compiling it never creates an actor —
    the graph runs against the caller's existing instance."""

    def __init__(self, handle):
        super().__init__((), {})
        self._handle = handle

    def _execute_impl(self, cache, input_value):
        return self._handle


class ClassMethodNode(DAGNode):
    def __init__(self, class_node: ClassNode, method_name: str,
                 args, kwargs):
        super().__init__(args, kwargs)
        self._class_node = class_node
        self._method_name = method_name

    def _children(self):
        return super()._children() + [self._class_node]

    def _execute_impl(self, cache, input_value):
        handle = self._class_node._execute_recursive(cache, input_value)
        args, kwargs = self._resolve_args(cache, input_value)
        return getattr(handle, self._method_name).remote(*args, **kwargs)
