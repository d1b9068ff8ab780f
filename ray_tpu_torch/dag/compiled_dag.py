"""Compiled static DAG execution over preallocated shm channels.

``DAGNode.experimental_compile()`` takes an actor-method-only lazy graph
(ClassMethodNode over ClassNode / live ActorHandle bindings + one
InputNode) and turns every ``execute()`` into **zero task submissions**:

* compile time — validate the graph (single InputNode, acyclic, every
  method bound to a live actor), instantiate ClassNode actors once,
  preallocate one single-writer/multi-reader shm channel
  (experimental/channel.py) for the input, every edge and the output,
  and install a resident execution loop on each participating actor
  (``__ray_dag_install__`` over the existing pooled actor connection —
  runtime/worker_main.py).
* execute time — the driver serializes the input straight into the
  input channel's ring; each actor loop blocks on its input channels,
  runs the bound method, writes its output channel in place; the driver
  reads the output ring.  Slots are reused across executions, so 1k
  executes leave the store's ``bytes_in_use`` flat.

This is the dataflow shape MPMD pipeline parallelism needs (PAPERS.md
arXiv:2412.14374) and the low-latency repeated-execution regime the
original Ray task path leaves on the table (arXiv:1712.05889) — see
docs/compiled_dag.md for the protocol, limits and benchmarks
(benchmarks/compiled_dag_perf.py: >=5x lower per-execute latency than
the classic driver-mediated ``dag.execute()`` on a 3-stage chain).

Failure semantics: a user exception becomes an error item that flows
through the graph (downstream stages forward it without executing) and
re-raises at ``CompiledDAGRef.get()``; the DAG stays usable.  A dead
actor poisons every channel — in-flight and future calls raise
``DAGUnavailableError`` and the DAG can be recompiled cleanly.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import runtime_metrics as rtm
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.ids import TaskID
from ray_tpu_torch.dag.dag_node import (ClassMethodNode, ClassNode, DAGNode,
                                  ExistingActorNode, FunctionNode, InputNode)
from ray_tpu_torch.exceptions import (ChannelClosedError, ChannelTimeoutError,
                                DAGCompileError, DAGUnavailableError)
from ray_tpu_torch.experimental.channel import (Channel, ChannelReader,
                                          ChannelWriter, channel_object_id,
                                          POISON_TEARDOWN,
                                          POISON_WORKER_DIED)

# ----------------------------------------------------------------- telemetry
# per-DAG execute latency (submit -> output item drained at the driver)
_M_DAG_EXEC = rtm.histogram_family(
    "ray_tpu_compiled_dag_execute_ms",
    "compiled-DAG execute() -> result latency at the driver (ms)",
    tag_key="dag")
_M_DAG_INFLIGHT = rtm.gauge(
    "ray_tpu_compiled_dag_inflight",
    "compiled-DAG executions in flight (submitted, not yet drained)",
    watermark=True)

# timeline: per-execution slices are recorded only for the first N
# executions of a DAG (same rationale as the streaming _STREAM_EVENT_CAP:
# a 1M-execute serving loop must not flood the bounded task table)
EXEC_EVENT_CAP = 256

# actor-liveness poll cadence while a get() is blocked (seconds)
_LIVENESS_PERIOD_S = 0.5

_DEFAULT_BUFFER_BYTES = 1 << 20


def _reject_nested_nodes(value, _seen: Optional[set] = None) -> None:
    """A DAGNode buried inside a container argument would be pickled as
    a constant and the stage would receive the node OBJECT instead of
    its runtime value — reject at compile instead of silently mis-wiring
    (top-level node args become channel reads; nested ones cannot)."""
    if isinstance(value, DAGNode):
        raise DAGCompileError(
            f"a {type(value).__name__} is nested inside a container "
            "argument of a compiled DAG; node arguments must be passed "
            "at the top level of args/kwargs so they become channel "
            "edges")
    if not isinstance(value, (dict, list, tuple, set, frozenset)):
        return
    if _seen is None:
        _seen = set()
    if id(value) in _seen:          # self-referencing container
        return
    _seen.add(id(value))
    for v in (value.values() if isinstance(value, dict) else value):
        _reject_nested_nodes(v, _seen)


def _exec_task_id(dag_id: str, idx: int) -> str:
    """Deterministic per-execution task id: the driver's SUBMITTED/
    FINISHED events and every actor's RUNNING slice land on the same
    timeline record without any per-execute wire traffic."""
    return TaskID(hashlib.sha1(
        f"{dag_id}:{idx}".encode()).digest()[:16]).hex()


def _exec_trace_id(dag_id: str, idx: int) -> str:
    return f"dag-{dag_id[:12]}:{idx}"


class _Op:
    """One ClassMethodNode scheduled onto an actor."""

    __slots__ = ("index", "node", "actor_node", "method", "args", "kwargs",
                 "out_channel_oid")

    def __init__(self, index: int, node: ClassMethodNode):
        self.index = index
        self.node = node
        self.actor_node = node._class_node
        self.method = node._method_name
        self.args: List[dict] = []      # install-payload descriptors
        self.kwargs: Dict[str, dict] = {}
        self.out_channel_oid = None


class CompiledDAGRef:
    """Result handle of one compiled execution.

    ``get()`` blocks for the output item (draining the output channel in
    execution order on behalf of every outstanding ref) and raises any
    exception the graph produced; a ref's value may be taken exactly
    once.  ``await ref`` works from asyncio (the blocking drain runs in
    the default executor)."""

    __slots__ = ("_dag", "_idx", "_taken")

    def __init__(self, dag: "CompiledDAG", idx: int):
        self._dag = dag
        self._idx = idx
        self._taken = False

    @property
    def execution_index(self) -> int:
        return self._idx

    def get(self, timeout: Optional[float] = None) -> Any:
        if self._taken:
            raise ValueError(
                "CompiledDAGRef result was already retrieved; a compiled "
                "execution's value can be taken once")
        value = self._dag._wait_result(self._idx, timeout)
        self._taken = True
        if isinstance(value, _ErrorResult):
            raise value.error
        return value

    def __del__(self):
        # fire-and-forget callers drop refs without get(): release the
        # buffered (or future) result so _results cannot grow unbounded
        if not self._taken:
            try:
                self._dag._abandon(self._idx)
            except Exception:
                pass

    def __await__(self):
        import asyncio
        loop = asyncio.get_running_loop()
        return (yield from loop.run_in_executor(
            None, self.get).__await__())

    def __repr__(self):
        return (f"CompiledDAGRef(dag={self._dag.dag_id[:8]}, "
                f"idx={self._idx})")


class _ErrorResult:
    """Internal: a drained output item that deserialized to an error."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


class CompiledDAG:
    """A compiled static graph; build via ``node.experimental_compile()``.

    Not thread-hostile: ``execute()`` and ``get()`` may be called from
    multiple threads; submission order defines execution order."""

    def __init__(self, root: DAGNode, *, max_inflight: int = 2,
                 buffer_size_bytes: int = _DEFAULT_BUFFER_BYTES,
                 name: str = "", threaded_ops: bool = False):
        from ray_tpu_torch.runtime.core_worker import get_global_worker
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self._worker = get_global_worker()
        self._root = root
        self._max_inflight = int(max_inflight)
        self._threaded_ops = bool(threaded_ops)
        self._buffer_bytes = int(buffer_size_bytes)
        self.dag_id = hashlib.sha1(
            f"{id(self)}:{time.time_ns()}".encode()).hexdigest()
        self.name = name or f"dag-{self.dag_id[:8]}"

        # populated by _compile
        self._ops: List[_Op] = []
        self._input_channel: Optional[Channel] = None
        self._channels: List[Channel] = []
        self._actors: Dict[str, Any] = {}         # actor_id hex -> handle
        self._created_actor_ids: List[str] = []   # from ClassNodes: ours
        self._input_writer: Optional[ChannelWriter] = None
        self._out_reader: Optional[ChannelReader] = None

        # execution state
        self._cv = threading.Condition()
        self._next_idx = 0
        self._inflight = 0
        self._drained_idx = 0
        self._results: Dict[int, Any] = {}
        self._abandoned: set = set()     # idxs whose ref was dropped
        self._draining = False
        self._dead: Optional[BaseException] = None
        self._torn_down = False
        self._t0: Dict[int, float] = {}
        self._last_liveness = 0.0

        self._compile()

    # ------------------------------------------------------------- compile
    def _walk_validated(self) -> List[DAGNode]:
        """Topological order (dependencies first) with explicit cycle
        detection — ``DAGNode.walk`` assumes acyclicity, and compile must
        reject a hand-mutated cyclic graph instead of recursing forever."""
        order: List[DAGNode] = []
        done: set = set()
        in_progress: set = set()

        def visit(node: DAGNode, stack: list):
            uid = node._stable_uuid
            if uid in done:
                return
            if uid in in_progress:
                raise DAGCompileError(
                    "compiled DAGs must be acyclic; found a cycle through "
                    + " -> ".join(type(n).__name__ for n in stack))
            in_progress.add(uid)
            for child in node._children():
                visit(child, stack + [child])
            in_progress.discard(uid)
            done.add(uid)
            order.append(node)

        visit(self._root, [self._root])
        return order

    def _compile(self) -> None:
        nodes = self._walk_validated()
        if not isinstance(self._root, ClassMethodNode):
            raise DAGCompileError(
                "experimental_compile() requires the output node to be an "
                f"actor method call, got {type(self._root).__name__}")
        input_nodes = [n for n in nodes if isinstance(n, InputNode)]
        if len(input_nodes) > 1:
            raise DAGCompileError(
                f"compiled DAGs take a single InputNode; found "
                f"{len(input_nodes)}")
        if not input_nodes:
            raise DAGCompileError(
                "compiled DAGs require an InputNode (use `with InputNode() "
                "as inp:` and bind it into the graph)")
        for n in nodes:
            if isinstance(n, FunctionNode):
                raise DAGCompileError(
                    "compiled DAGs are actor-method only; task node "
                    f"{n._remote_function!r} cannot be compiled (wrap the "
                    "function in an actor)")
            if not isinstance(n, (InputNode, ClassNode, ExistingActorNode,
                                  ClassMethodNode)):
                raise DAGCompileError(
                    f"unsupported node type in compiled DAG: "
                    f"{type(n).__name__}")

        method_nodes = [n for n in nodes if isinstance(n, ClassMethodNode)]
        self._ops = [_Op(i, n) for i, n in enumerate(method_nodes)]
        op_by_uuid = {op.node._stable_uuid: op for op in self._ops}

        # instantiate ClassNode actors (once per compile; a recompile
        # after worker death gets fresh actors) and resolve liveness for
        # every participant — a dead bound actor fails compile here
        handle_cache: Dict[str, Any] = {}
        actor_of_op: Dict[int, str] = {}
        for op in self._ops:
            an = op.actor_node
            if isinstance(an, ExistingActorNode):
                handle = an._handle
                created = False
            elif isinstance(an, ClassNode):
                if an._stable_uuid not in handle_cache:
                    for a in list(an._bound_args) + \
                            list(an._bound_kwargs.values()):
                        if isinstance(a, DAGNode):
                            raise DAGCompileError(
                                "actor constructor arguments inside a "
                                "compiled DAG must be constants")
                    handle_cache[an._stable_uuid] = \
                        an._execute_recursive({}, None)
                    created = True
                else:
                    created = False
                handle = handle_cache[an._stable_uuid]
            else:
                raise DAGCompileError(
                    f"method bound to unsupported node "
                    f"{type(an).__name__}")
            aid = handle._actor_id.hex()
            try:
                self._worker._resolve_actor(aid)
            except exc.RayTpuError as e:
                raise DAGCompileError(
                    f"actor {aid[:8]} bound into the compiled DAG is not "
                    f"alive: {e}") from e
            self._actors[aid] = handle
            if created:
                self._created_actor_ids.append(aid)
            actor_of_op[op.index] = aid

        # channel planning: readers per producer (the input node and
        # every op), in deterministic order; the driver reads the root
        input_uuid = input_nodes[0]._stable_uuid
        readers: Dict[str, List[Tuple[str, int]]] = {"input": []}
        for op in self._ops:
            readers[f"op{op.index}"] = []

        def _chan_key(dep: DAGNode) -> Optional[str]:
            if isinstance(dep, InputNode):
                return "input"
            if isinstance(dep, ClassMethodNode):
                return f"op{op_by_uuid[dep._stable_uuid].index}"
            return None

        # per op: unique upstream channels -> local read-slot index
        op_reads: Dict[int, List[str]] = {}
        for op in self._ops:
            reads: List[str] = []

            def _descriptor(value, op=op, reads=reads):
                if isinstance(value, DAGNode):
                    key = _chan_key(value)
                    if key is None:
                        raise DAGCompileError(
                            f"cannot pass a {type(value).__name__} as a "
                            "method argument in a compiled DAG")
                    if key not in reads:
                        reads.append(key)
                        readers[key].append((f"op{op.index}", len(reads) - 1))
                    return {"t": "read", "i": reads.index(key)}
                _reject_nested_nodes(value)
                return {"t": "const", "v": value}

            op.args = [_descriptor(a) for a in op.node._bound_args]
            op.kwargs = {k: _descriptor(v)
                         for k, v in op.node._bound_kwargs.items()}
            op_reads[op.index] = reads
        root_key = f"op{op_by_uuid[self._root._stable_uuid].index}"
        readers[root_key].append(("driver", -1))
        if not readers["input"]:
            raise DAGCompileError(
                "the InputNode is not consumed by any compiled method; "
                "bind it into the graph or drop it")

        # allocate the channels in the driver's local shm segment
        chan_objs: Dict[str, Channel] = {}
        driver_reader_idx = None
        try:
            for key, consumer_list in readers.items():
                if not consumer_list:
                    raise DAGCompileError(
                        f"compiled op {key} has no consumers — only the "
                        "output node may be unconsumed")
                oid = channel_object_id(
                    f"{self.dag_id}:{key}".encode())
                chan_objs[key] = Channel.create(
                    self._worker.store, oid, nslots=self._max_inflight,
                    nreaders=len(consumer_list),
                    capacity=self._buffer_bytes)
                for ridx, (who, _slot) in enumerate(consumer_list):
                    if who == "driver":
                        driver_reader_idx = ridx
        except BaseException:
            for ch in chan_objs.values():
                ch.close()
                ch.delete()
            raise
        self._channels = list(chan_objs.values())
        self._input_channel = chan_objs["input"]
        self._input_writer = ChannelWriter(self._input_channel)
        self._out_reader = ChannelReader(chan_objs[root_key],
                                         driver_reader_idx)

        # install the resident loop on each actor (over the existing
        # pooled actor connection, i.e. the normal actor-task path)
        def _reader_index(key: str, op_index: int) -> int:
            for ridx, (who, _slot) in enumerate(readers[key]):
                if who == f"op{op_index}":
                    return ridx
            raise AssertionError(f"op{op_index} not registered on {key}")

        per_actor: Dict[str, List[dict]] = {}
        for op in self._ops:
            desc = {
                "method": op.method,
                "args": op.args,
                "kwargs": op.kwargs,
                "reads": [{"id": chan_objs[key].oid.binary(),
                           "reader": _reader_index(key, op.index)}
                          for key in op_reads[op.index]],
                "out": {"id": chan_objs[f"op{op.index}"].oid.binary()},
                "op_index": op.index,
            }
            per_actor.setdefault(actor_of_op[op.index], []).append(desc)

        # dunder methods bypass ActorHandle.__getattr__ (it rejects
        # underscore names); construct the ActorMethod directly — the
        # call still rides the actor's ordered pooled pipe
        from ray_tpu_torch.actor import ActorMethod
        install_refs = []
        for aid, ops in per_actor.items():
            payload = {"dag_id": self.dag_id, "name": self.name,
                       "ops": ops, "event_cap": EXEC_EVENT_CAP,
                       "threaded_ops": self._threaded_ops,
                       # lets the resident loop watch for this driver's
                       # death and unwind instead of leaking forever on
                       # detached actors
                       "job_id": self._worker.job_id.hex()}
            handle = self._actors[aid]
            install_refs.append(
                (aid, ActorMethod(handle, "__ray_dag_install__")
                 .remote(payload)))
        try:
            for aid, ref in install_refs:
                self._worker.get([ref], timeout=60.0)
        except exc.RayTpuError as e:
            # full teardown, not just poisoning: releases the driver's
            # channel pins (else every failed compile strands
            # nchannels * nslots * capacity of un-evictable shm), stops
            # any loops that did install, and kills compile-created
            # actors
            self.teardown()
            raise DAGCompileError(
                f"installing the compiled loop on actor {aid[:8]} failed "
                f"(compiled DAGs require every actor on the driver's "
                f"node): {e}") from e

    # ------------------------------------------------------------- execute
    def execute(self, *input_values,
                timeout: Optional[float] = None) -> CompiledDAGRef:
        """Run the graph once with ``input_values[0]`` (or None): write
        the input into its channel and return a ref for the output.
        Blocks (backpressure) while ``max_inflight`` executions are
        outstanding."""
        if len(input_values) > 1:
            raise TypeError(
                "compiled DAGs take a single input value; pack multiple "
                "values into a tuple/dict")
        value = input_values[0] if input_values else None
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            drain_here = False
            with self._cv:
                self._raise_if_unavailable()
                if self._inflight < self._max_inflight:
                    idx = self._next_idx
                    self._next_idx += 1
                    self._inflight += 1
                    _M_DAG_INFLIGHT.set_max(self._inflight)
                    self._t0[idx] = rtm.now()
                    # the ring is sized to max_inflight, so with the
                    # inflight window held this write never blocks long;
                    # serialize inside the lock to keep ring order ==
                    # idx order
                    try:
                        self._input_writer.write(
                            value,
                            timeout=(None if deadline is None else
                                     max(0.1, deadline - time.monotonic())))
                    except ChannelClosedError as e:
                        self._inflight -= 1
                        raise self._fail_locked(
                            DAGUnavailableError(str(e))) from e
                    except ChannelTimeoutError as e:
                        # can't happen while the inflight window holds
                        # (the ring is sized to it) unless the graph is
                        # wedged; release the window slot we claimed
                        self._inflight -= 1
                        self._next_idx -= 1
                        self._t0.pop(idx, None)
                        raise exc.GetTimeoutError(str(e)) from e
                    except Exception:
                        # serialization failure (non-picklable input,
                        # payload over the slot capacity): nothing was
                        # published, so roll the claimed slot back — a
                        # leaked idx would permanently shift drain
                        # accounting and wedge the window.  Safe because
                        # _cv is held from claim to here, so no later
                        # idx exists yet.
                        self._inflight -= 1
                        self._next_idx -= 1
                        self._t0.pop(idx, None)
                        raise
                    break
                # window full (backpressure): pump the output channel
                # ourselves — a single-threaded submit loop must not
                # deadlock waiting for a get() that comes later; drained
                # results buffer in _results until their ref collects them
                if self._draining:
                    self._cv.wait(0.1)
                else:
                    self._draining = True
                    drain_here = True
            if drain_here:
                try:
                    self._drain_one(deadline)
                finally:
                    with self._cv:
                        self._draining = False
                        self._cv.notify_all()
            elif deadline is not None and time.monotonic() >= deadline:
                raise exc.GetTimeoutError(
                    f"execute() timed out with {self._inflight} executions "
                    f"in flight (max_inflight={self._max_inflight})")
        if idx < EXEC_EVENT_CAP:
            self._worker.events.record(
                _exec_task_id(self.dag_id, idx), "SUBMITTED",
                name=f"dag:{self.name}",
                trace_id=_exec_trace_id(self.dag_id, idx))
        return CompiledDAGRef(self, idx)

    # ------------------------------------------------------- result drain
    def _wait_result(self, idx: int, timeout: Optional[float]) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._cv:
                if idx in self._results:
                    return self._results.pop(idx)
                if self._dead is not None:
                    raise DAGUnavailableError(str(self._dead))
                if self._torn_down:
                    # teardown released the channel views; draining
                    # would touch freed memory
                    raise DAGUnavailableError(
                        f"compiled DAG {self.name} was torn down before "
                        f"execution {idx} was retrieved; recompile")
                if self._draining:
                    # another getter is pumping the output channel
                    self._cv.wait(0.1)
                    if deadline is not None and \
                            time.monotonic() >= deadline and \
                            idx not in self._results:
                        raise exc.GetTimeoutError(
                            f"compiled DAG execution {idx} not ready "
                            f"within the timeout")
                    continue
                self._draining = True
            try:
                self._drain_one(deadline)
            finally:
                with self._cv:
                    self._draining = False
                    self._cv.notify_all()

    def _drain_one(self, deadline: Optional[float]) -> None:
        """Read the next output item (execution order) into _results,
        interleaving actor-liveness checks so a mid-execution worker
        death surfaces as DAGUnavailableError instead of a hang."""
        while True:
            try:
                # clamp the poll slice to the caller's deadline so a
                # small get(timeout=) raises promptly instead of
                # overshooting by a full slice (or a liveness RPC)
                slice_s = 0.25
                if deadline is not None:
                    slice_s = min(slice_s, deadline - time.monotonic())
                    if slice_s <= 0:
                        raise exc.GetTimeoutError(
                            "timed out waiting for a compiled DAG result")
                payload, _flags = self._out_reader.read_raw(
                    timeout=slice_s)
                break
            except ChannelTimeoutError:
                if deadline is not None and time.monotonic() >= deadline:
                    raise exc.GetTimeoutError(
                        "timed out waiting for a compiled DAG result")
                self._check_liveness()
            except ChannelClosedError as e:
                with self._cv:
                    raise self._fail_locked(DAGUnavailableError(str(e)))
            except ValueError as e:
                # released channel view: teardown() gave up waiting for
                # this drain (e.g. it was parked in a slow liveness RPC)
                # and freed the channels under it
                with self._cv:
                    raise self._fail_locked(DAGUnavailableError(
                        f"compiled DAG {self.name} was torn down while a "
                        f"result drain was in flight")) from e
        try:
            value = ser.deserialize(payload)
        except Exception as e:  # noqa: BLE001 - error items re-raise here
            value = _ErrorResult(e)
        with self._cv:
            idx = self._drained_idx
            self._drained_idx += 1
            self._inflight -= 1
            if idx in self._abandoned:
                self._abandoned.discard(idx)   # ref dropped: no taker
            else:
                self._results[idx] = value
            t0 = self._t0.pop(idx, None)
            self._cv.notify_all()
        if t0 is not None:
            _M_DAG_EXEC.observe_since(self.name, t0)
        if idx < EXEC_EVENT_CAP:
            failed = isinstance(value, _ErrorResult)
            self._worker.events.record(
                _exec_task_id(self.dag_id, idx),
                "FAILED" if failed else "FINISHED",
                name=f"dag:{self.name}",
                trace_id=_exec_trace_id(self.dag_id, idx))

    def _abandon(self, idx: int) -> None:
        """A CompiledDAGRef was garbage-collected without get(): drop
        its buffered result, or mark the idx so the drain discards it.
        (Safe from __del__: the condition's lock is reentrant.)"""
        with self._cv:
            if self._results.pop(idx, None) is None and \
                    idx >= self._drained_idx:
                self._abandoned.add(idx)

    # ------------------------------------------------------------- failure
    def _raise_if_unavailable(self) -> None:
        if self._torn_down:
            raise DAGUnavailableError(
                f"compiled DAG {self.name} was torn down; recompile")
        if self._dead is not None:
            raise DAGUnavailableError(str(self._dead))

    def _fail_locked(self, error: BaseException) -> BaseException:
        """cv held: mark the DAG dead, poison every channel so blocked
        actor loops (and other driver threads) unwind."""
        if self._dead is None:
            self._dead = error
            for ch in self._channels:
                try:
                    ch.poison(POISON_WORKER_DIED)
                except Exception:
                    pass
        self._cv.notify_all()
        return error

    def _check_liveness(self) -> None:
        now = time.monotonic()
        if now - self._last_liveness < _LIVENESS_PERIOD_S:
            return
        self._last_liveness = now
        from ray_tpu_torch.runtime.gcs import DEAD, RESTARTING
        for aid in self._actors:
            try:
                info = self._worker.gcs.call("get_actor",
                                             {"actor_id": aid}, timeout=5)
            except Exception:
                return      # GCS hiccup: keep waiting, not a death verdict
            # RESTARTING counts as lost too: the replacement worker has
            # no resident loop installed, so the compiled graph can
            # never complete — only a recompile restores it
            if info is None or info.get("state") in (DEAD, RESTARTING):
                with self._cv:
                    raise self._fail_locked(DAGUnavailableError(
                        f"actor {aid[:8]} participating in compiled DAG "
                        f"{self.name} died mid-execution; recompile to "
                        f"restore the graph"))

    # ------------------------------------------------------------ teardown
    def _teardown_channels(self, code: int) -> None:
        for ch in self._channels:
            try:
                ch.poison(code)
            except Exception:
                pass

    def teardown(self, kill_actors: Optional[bool] = None) -> None:
        """Stop the resident loops, free the channels, and (for actors
        this compile itself created from ClassNodes) kill the actors.
        Idempotent."""
        with self._cv:
            if self._torn_down:
                return
            self._torn_down = True
            self._cv.notify_all()
        self._teardown_channels(POISON_TEARDOWN)
        # let an in-flight drain unwind off the poisoned channels before
        # the views are released below — read_raw on a released
        # memoryview would crash instead of raising DAGUnavailableError
        with self._cv:
            deadline = time.monotonic() + 5.0
            while self._draining and time.monotonic() < deadline:
                self._cv.wait(0.1)
        from ray_tpu_torch.actor import ActorMethod
        for aid, handle in self._actors.items():
            try:
                ref = ActorMethod(handle, "__ray_dag_teardown__").remote(
                    {"dag_id": self.dag_id})
                self._worker.get([ref], timeout=10.0)
            except Exception:
                pass            # dead/unreachable actor: poison suffices
        kill = self._created_actor_ids if kill_actors is None else (
            list(self._actors) if kill_actors else [])
        for aid in kill:
            try:
                self._worker.kill_actor(
                    self._actors[aid]._actor_id)
            except Exception:
                pass
        for ch in self._channels:
            ch.close()
            ch.delete()
        self._channels = []

    def __del__(self):
        try:
            if not self._torn_down and not self._worker._shutdown.is_set():
                self.teardown()
        except Exception:
            pass

    def __repr__(self):
        return (f"CompiledDAG({self.name}, ops={len(self._ops)}, "
                f"actors={len(self._actors)}, "
                f"max_inflight={self._max_inflight})")
