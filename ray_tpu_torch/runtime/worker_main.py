"""Worker process: executes tasks/actor methods pushed by owners.

Analog of the reference's default_worker.py + task-execution path
(/root/reference/python/ray/_private/workers/default_worker.py;
execution callback `task_execution_handler` _raylet.pyx:1121; server-side
scheduling queues src/ray/core_worker/transport/*scheduling_queue*).

Execution model: one executor thread drains a FIFO of normal tasks (the
NormalSchedulingQueue analog); actor tasks carry sequence numbers and are
buffered until their turn (ActorSchedulingQueue analog) so actor state sees
calls in submission order.
"""

from __future__ import annotations

import argparse
import asyncio
import inspect
import os
import threading
import traceback
from collections import deque
from typing import Any, Dict, Optional

from ray_tpu_torch import cloudpickle

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import cluster_events as cev
from ray_tpu_torch._private import rpc
from ray_tpu_torch._private import runtime_metrics as rtm
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.logging_utils import get_logger, setup_component_logging
from ray_tpu_torch.runtime import core_worker as cw

logger = get_logger("worker")

# executor-side telemetry (docs/observability.md)
_M_EXEC = rtm.histogram_family(
    "ray_tpu_task_exec_ms", "task/actor-method execution time (ms)",
    tag_key="func")
_M_CREDIT_WAIT = rtm.histogram(
    "ray_tpu_stream_credit_wait_ms",
    "time a streaming producer spent paused on backpressure credit")

# per-yield STREAM_ITEM instants are recorded into the task table only
# for the first N items of a stream: the timeline stays readable and one
# long stream can't flood the (bounded) per-task event list
_STREAM_EVENT_CAP = 256


def _probe_small(value, budget: int = 32768, depth: int = 0) -> int:
    """Cheap structural probe for the async-actor inline-return fast
    path: returns the remaining byte budget when ``value`` is a small
    JSON-ish object (None/bool/int/float/str/bytes and shallow
    list/tuple/dict of those — the shapes serve replies traffic in),
    or -1 when it is big, deep, or of any other type (numpy arrays,
    user classes: their pickle cost is unbounded, keep the executor).
    Costs ~1us for a typical serve reply dict."""
    if value is None or value is True or value is False:
        return budget - 8
    t = type(value)
    if t is int:
        # arbitrary-precision: charge real width or a 10**10000 would
        # defeat the budget (and the no-store_put-on-loop invariant)
        return budget - 16 - (value.bit_length() >> 3)
    if t is float:
        return budget - 16
    if t is str or t is bytes:
        n = len(value) + 8
        return budget - n if n < budget else -1
    if depth >= 4:
        return -1
    if t is list or t is tuple:
        for item in value:
            budget = _probe_small(item, budget - 8, depth + 1)
            if budget < 0:
                return -1
        return budget
    if t is dict:
        for k, v in value.items():
            budget = _probe_small(k, budget - 8, depth + 1)
            if budget < 0:
                return -1
            budget = _probe_small(v, budget, depth + 1)
            if budget < 0:
                return -1
        return budget
    return -1


class _StreamCancelled(Exception):
    """The owner cancelled the stream (consumer dropped the generator,
    or the owner process is gone): stop producing, finish cleanly."""


class _StreamSession:
    """Producer side of one num_returns="streaming" execution.

    Each yielded item is serialized (inline bytes under the inline-
    return threshold, else a shm primary copy + location) and pushed to
    the owner as a ``report_generator_item`` call on the pooled owner
    connection.  Backpressure: the owner withholds a report's reply
    until that item is consumed, and the session caps unacked reports
    at the spec's ``backpressure`` window — so at most that many
    unconsumed items are ever in flight, and the producing generator
    pauses (blocks in send()) until the consumer catches up."""

    def __init__(self, core, spec, inline_max: int):
        from ray_tpu_torch.util.tracing import tracing_helper as trh
        self.core = core
        self.spec = spec
        self.task_id = TaskID(spec["task_id"])
        self.bp = int(spec.get("backpressure") or -1)
        self.conn = core._owner_conn(tuple(spec["owner_addr"]))
        self.inline_max = inline_max
        self.outstanding: "deque" = deque()
        self.index = 0
        # tracing (docs/observability.md): the session is constructed
        # inside the task's execution context — capture it here because
        # the async-actor variant's send() runs on an executor thread
        # where the ContextVar is absent.  Sampled streams record the
        # first N yields as instant spans and ride the context on each
        # report RPC so the owner-side handler joins the trace.
        self._trh = trh
        self._trace_ctx = trh.current_context()
        # _traced gates context propagation on EVERY report RPC;
        # _span_items only caps the per-yield marker spans — an
        # operator zeroing the marker knob must not silently cut the
        # owner side out of the trace
        self._traced = trh.ctx_sampled(self._trace_ctx)
        self._span_items = (CONFIG.trace_stream_span_items
                            if self._traced else 0)

    def send(self, value) -> None:
        self._wait_for_credit()
        head, views = ser.serialize(value)
        payload = {"task_id": self.spec["task_id"], "index": self.index}
        size = ser.serialized_size(head, views)
        if size <= self.inline_max:
            payload["data"] = ser.to_flat_bytes(head, views)
        else:
            oid = ObjectID.for_task_return(self.task_id, self.index + 1)
            self.core.store_put(oid, head, views)
            payload["location"] = self.core.node_id
            payload["size"] = size
        if self._traced:
            payload["_trace_ctx"] = self._trace_ctx
        try:
            fut = self.conn.call_async("report_generator_item", payload)
        except (ConnectionError, OSError):
            raise _StreamCancelled from None
        if self.index < _STREAM_EVENT_CAP:
            # per-yield instant for the timeline (ph="i" in Perfetto),
            # carrying the submitter's trace id so user spans, the task
            # span and its stream items correlate
            tc = self.spec.get("trace_ctx")
            self.core.events.record(
                self.task_id.hex(), "STREAM_ITEM",
                name=self.spec.get("name", ""), index=self.index,
                **({"trace_id": tc["trace_id"]} if tc else {}))
        if self.index < self._span_items:
            # per-yield marker span in the sampled trace: the pacing
            # shape of the stream's head, without a span per token
            self._trh.instant_span(
                f"yield[{self.index}]", "stream_item",
                ctx=self._trace_ctx, index=self.index, bytes=size)
        self.outstanding.append(fut)
        self.index += 1

    def _wait_for_credit(self) -> None:
        if self.bp > 0:
            # unacked window == unconsumed in-flight items: block here
            # until the consumer acks (pausing the user generator)
            if len(self.outstanding) >= self.bp:
                t0 = rtm.now()
                while len(self.outstanding) >= self.bp:
                    self._consume_reply(self.outstanding.popleft())
                _M_CREDIT_WAIT.observe_since(t0)
        else:
            # unbounded stream: just reap replies that already landed so
            # a long stream doesn't accumulate futures
            while self.outstanding and self.outstanding[0].done():
                self._consume_reply(self.outstanding.popleft())

    def _consume_reply(self, fut) -> None:
        try:
            reply = fut.result(None)
        except (ConnectionError, OSError, rpc.RpcError):
            # owner unreachable: nobody is listening to this stream
            raise _StreamCancelled from None
        if reply and reply.get("cancel"):
            raise _StreamCancelled

    def finish(self, cancelled: bool = False) -> dict:
        """Drain every outstanding report (so the owner has adopted all
        items before the completion sentinel lands), then build the task
        reply."""
        if cancelled:
            self.drain_quiet()
        else:
            try:
                while self.outstanding:
                    self._consume_reply(self.outstanding.popleft())
            except _StreamCancelled:
                cancelled = True
                self.drain_quiet()
        out = {"num_items": self.index}
        if cancelled:
            out["cancelled"] = True
        return {"results": [{"streaming": out}]}

    def drain_quiet(self) -> None:
        """Best-effort wait for in-flight reports (error/cancel paths):
        already-produced items should reach the owner before the task's
        terminal reply does, but nothing here may raise."""
        while self.outstanding:
            fut = self.outstanding.popleft()
            try:
                fut.result(30.0)
            except Exception:
                break


class _CompiledDagRunner:
    """Actor-side resident loop of one compiled DAG (docs/compiled_dag.md).

    Installed by the driver via ``__ray_dag_install__`` (an ordinary
    actor task over the pooled actor connection).  One daemon thread per
    (DAG, actor): each iteration it runs this actor's ops in the DAG's
    topological order — blocking read of every input channel, the bound
    method, one in-place write of the output channel — so repeated
    ``execute()`` calls cost ZERO task submissions here.  Error items
    forward downstream without executing the method; channel poisoning
    (teardown / worker death at the driver) unwinds the loop."""

    def __init__(self, worker: "WorkerProcess", payload: dict):
        from ray_tpu_torch.experimental import channel as chan
        self.worker = worker
        self.core = worker.core
        self.dag_id = payload["dag_id"]
        self.name = payload.get("name", "dag")
        self.event_cap = int(payload.get("event_cap", 0))
        self.job_id = payload.get("job_id", "")
        self._chan_mod = chan
        self._stop = threading.Event()
        self._channels: Dict[bytes, Any] = {}
        self.ops = []
        try:
            for desc in payload["ops"]:
                bound = getattr(worker.actor_instance, desc["method"])
                self.ops.append({
                    "method": desc["method"],
                    "bound": bound,
                    "reads": [chan.ChannelReader(self._attach(r["id"]),
                                                 r["reader"])
                              for r in desc["reads"]],
                    "writer": chan.ChannelWriter(
                        self._attach(desc["out"]["id"])),
                    "args": desc["args"],
                    "kwargs": desc["kwargs"],
                })
        except BaseException:
            self._release()
            raise
        # threaded_ops (docs/compiled_dag.md): one resident thread PER OP
        # instead of one serial per-actor loop, so an actor appearing at
        # several pipeline depths (MPMD stage forward + backward) can
        # overlap execution indices — forward of microbatch t+1 proceeds
        # while backward of t still waits on its input channel.  Method
        # calls stay serialized through worker._method_mutex in _run_op;
        # only channel waits run concurrently.
        self.threaded = bool(payload.get("threaded_ops")) \
            and len(self.ops) > 1
        self._live_loops = len(self.ops) if self.threaded else 1
        self._live_lock = threading.Lock()
        if self.threaded:
            self._threads = [
                threading.Thread(
                    target=self._op_loop, args=(op,), daemon=True,
                    name=f"dag-loop-{self.dag_id[:8]}-op{i}")
                for i, op in enumerate(self.ops)]
            for t in self._threads:
                t.start()
        else:
            self._threads = [threading.Thread(
                target=self._loop, daemon=True,
                name=f"dag-loop-{self.dag_id[:8]}")]
            self._threads[0].start()
        if self.job_id:
            # a driver that dies without teardown() never poisons the
            # channels: on a detached actor this loop (and its channel
            # pins) would otherwise outlive the driver forever.  Watch
            # the driver's GCS job record and unwind when it finishes —
            # the channel waits honor _stop at every poison-check tick.
            self._watchdog = threading.Thread(
                target=self._watch_driver, daemon=True,
                name=f"dag-watch-{self.dag_id[:8]}")
            self._watchdog.start()

    _DRIVER_POLL_S = 10.0

    def _watch_driver(self) -> None:
        while not self._stop.wait(self._DRIVER_POLL_S):
            try:
                jobs = self.core.gcs.call("list_jobs", {}, timeout=5)
            except Exception:
                continue        # GCS hiccup: not a death verdict
            state = next((j.get("state") for j in jobs
                          if j.get("job_id") == self.job_id), None)
            if state is not None and state != "RUNNING":
                for ch in self._channels.values():
                    try:
                        ch.poison(self._chan_mod.POISON_WORKER_DIED)
                    except Exception:
                        pass
                self._stop.set()
                return

    def _attach(self, oid_bytes: bytes):
        ch = self._channels.get(oid_bytes)
        if ch is None:
            ch = self._chan_mod.Channel.attach(
                self.core.store, ObjectID(oid_bytes), timeout=10.0)
            self._channels[oid_bytes] = ch
        return ch

    def _release(self) -> None:
        for ch in self._channels.values():
            try:
                ch.close()
            except Exception:
                pass

    def _loop(self) -> None:
        from ray_tpu_torch.exceptions import ChannelError
        idx = 0
        try:
            while not self._stop.is_set():
                for op in self.ops:
                    self._run_op(op, idx)
                idx += 1
        except ChannelError:
            pass        # poisoned (teardown / participant death): unwind
        except Exception:
            logger.exception("compiled DAG %s loop failed", self.dag_id[:8])
            self._poison_all()
        finally:
            self._loop_done()

    def _op_loop(self, op) -> None:
        """threaded_ops variant: one op, own execution-index counter.
        Per-channel FIFO order keeps indices aligned across threads."""
        from ray_tpu_torch.exceptions import ChannelError
        idx = 0
        try:
            while not self._stop.is_set():
                self._run_op(op, idx)
                idx += 1
        except ChannelError:
            pass
        except Exception:
            logger.exception("compiled DAG %s op %s loop failed",
                             self.dag_id[:8], op["method"])
            self._poison_all()
        finally:
            self._loop_done()

    def _poison_all(self) -> None:
        # a loop dying with the actor still ALIVE is invisible to the
        # driver's liveness poll: poison every attached channel so
        # blocked peers unwind with DAGUnavailableError instead of
        # hanging forever
        for ch in self._channels.values():
            try:
                ch.poison(self._chan_mod.POISON_WORKER_DIED)
            except Exception:
                pass

    def _loop_done(self) -> None:
        """Last loop thread out releases the channel pins and
        self-removes; earlier exits only signal the others to stop."""
        self._stop.set()
        with self._live_lock:
            self._live_loops -= 1
            if self._live_loops > 0:
                return
        self._release()
        # self-remove so an unwound loop (driver death, poison, or
        # crash) doesn't leave a dead entry; _dag_teardown pops
        # before calling shutdown(), so this is a no-op there
        with self.worker._dag_lock:
            if self.worker._dag_runners.get(self.dag_id) is self:
                del self.worker._dag_runners[self.dag_id]

    def _record(self, idx: int, state: str, method: str, **extra) -> None:
        if idx >= self.event_cap:
            return
        from ray_tpu_torch.dag.compiled_dag import _exec_task_id, _exec_trace_id
        self.core.events.record(
            _exec_task_id(self.dag_id, idx), state,
            name=f"dag:{self.name}:{method}",
            trace_id=_exec_trace_id(self.dag_id, idx), **extra)

    def _run_op(self, op, idx: int) -> None:
        chan = self._chan_mod
        raw = [r.read_raw(stop=self._stop) for r in op["reads"]]
        err_payload = next((p for p, f in raw if f & chan.FLAG_ERROR), None)
        if err_payload is not None:
            # an upstream stage failed this execution: forward ITS error
            # unchanged (mirrors the TaskError propagation semantics of
            # the classic task chain) and skip the method
            op["writer"].write_raw(err_payload, chan.FLAG_ERROR,
                                   stop=self._stop)
            return
        self._record(idx, "RUNNING", op["method"])
        t_exec = rtm.now()
        try:
            values = [ser.deserialize(p) for p, _f in raw]
            args = [values[d["i"]] if d["t"] == "read" else d["v"]
                    for d in op["args"]]
            kwargs = {k: (values[d["i"]] if d["t"] == "read" else d["v"])
                      for k, d in op["kwargs"].items()}
            aloop = self.worker._actor_event_loop
            if aloop is not None:
                # async actor: run the whole call on the actor's event
                # loop (awaiting coroutine results there), so DAG ops
                # interleave with classic calls under the actor's normal
                # asyncio serialization instead of racing them
                async def _call():
                    r = op["bound"](*args, **kwargs)
                    if inspect.isawaitable(r):
                        r = await r
                    return r

                result = asyncio.run_coroutine_threadsafe(
                    _call(), aloop).result()
            else:
                # sync actor: share the worker's method mutex with the
                # classic sequential path so actor state never sees two
                # concurrent method frames (threaded concurrency-group
                # actors already opted out of that guarantee)
                with self.worker._method_mutex:
                    result = op["bound"](*args, **kwargs)
                if inspect.isawaitable(result):
                    result = asyncio.run(result)
        except Exception as e:  # noqa: BLE001 - user errors cross the graph
            _M_EXEC.observe_since(op["method"], t_exec)
            err = e if isinstance(e, exc.TaskError) else exc.TaskError(
                op["method"], e, traceback.format_exc())
            head, views = ser.serialize(err, error_type=ser.ERROR_TASK)
            op["writer"].write_payload(head, views, flags=chan.FLAG_ERROR,
                                       stop=self._stop)
            self._record(idx, "FAILED", op["method"],
                         error_type=type(e).__name__)
            return
        _M_EXEC.observe_since(op["method"], t_exec)
        try:
            op["writer"].write(result, stop=self._stop)
        except exc.ChannelError:
            raise               # poison/teardown: unwind the loop
        except Exception as e:  # noqa: BLE001
            # a result that cannot be serialized (or exceeds the slot
            # capacity) must become an error ITEM, not kill the loop —
            # the driver is owed exactly one output per execution
            err = exc.TaskError(op["method"], e, traceback.format_exc())
            head, views = ser.serialize(err, error_type=ser.ERROR_TASK)
            op["writer"].write_payload(head, views, flags=chan.FLAG_ERROR,
                                       stop=self._stop)
            self._record(idx, "FAILED", op["method"],
                         error_type=type(e).__name__)
            return
        self._record(idx, "FINISHED", op["method"])

    def shutdown(self) -> None:
        """Teardown: the driver has already poisoned the channels, so a
        blocked read/write is waking up; stop, join, release pins."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._release()


class WorkerProcess:
    def __init__(self, args):
        self.worker_id = WorkerID.from_hex(args.worker_id)
        self.core = cw.CoreWorker(
            mode="worker",
            gcs_address=(args.gcs_host, args.gcs_port),
            raylet_address=(args.raylet_host, args.raylet_port),
            store_path=args.store_path,
            node_id=args.node_id,
            worker_id=self.worker_id,
            session_dir=args.session_dir,
        )
        cw.set_global_worker(self.core)

        # apply the runtime env (working_dir/py_modules/env_vars) BEFORE any
        # user code loads — cf. reference runtime-env agent setup happening
        # before the worker reports ready
        renv_blob = os.environ.get("RAY_TPU_TORCH_RUNTIME_ENV")
        if renv_blob:
            import json
            from ray_tpu_torch.runtime_env import setup_runtime_env
            desc = json.loads(renv_blob)
            setup_runtime_env(desc, self.core.gcs, args.session_dir)
            # nested tasks/actors submitted from this worker inherit the
            # same env (reference: job/parent runtime_env inheritance)
            self.core.job_runtime_env = desc
        # inline-return threshold, resolved once (a CONFIG attribute read
        # per returned value is measurable on the small-task hot path)
        inline_ret = CONFIG.rpc_inline_return_max_bytes
        self._inline_ret_max = (CONFIG.inline_object_max_bytes
                                if inline_ret < 0 else inline_ret)
        # actor state
        self.actor_instance: Any = None
        self.actor_id: Optional[str] = None
        self._actor_is_async = False
        self._actor_event_loop = None   # asyncio loop for async actors
        self._group_caps: Dict[str, int] = {}
        self._group_sems: Dict[str, Any] = {}   # async: per-group Semaphore
        self._group_pools: Optional[Dict[str, Any]] = None  # threaded
        # resident compiled-DAG loops installed on this actor
        # (docs/compiled_dag.md): dag_id -> _CompiledDagRunner
        self._dag_runners: Dict[str, _CompiledDagRunner] = {}
        self._dag_lock = threading.Lock()
        # serializes method frames between the classic sequential path
        # and resident DAG loop threads (RLock: a method that calls back
        # into itself via the same thread must not self-deadlock)
        self._method_mutex = threading.RLock()
        # per caller-stream ordered queues (ActorSchedulingQueue analog):
        # {stream_id: {"next": int, "buf": {seq: work}}}
        self._actor_streams: Dict[str, Dict[str, Any]] = {}
        self._actor_cv = threading.Condition()
        # normal-task FIFO
        self._queue: "list[tuple]" = []
        self._queue_cv = threading.Condition()
        self._exec_thread = threading.Thread(target=self._exec_loop,
                                             daemon=True)
        self._exec_thread.start()
        self._actor_thread = threading.Thread(target=self._actor_loop,
                                              daemon=True)
        self._actor_thread.start()

        # serve pushes from owners on the core worker's own server by
        # extending its dispatch
        self.core._extra_handler = self._handle
        core_handle = self.core._handle_rpc

        def dispatch(conn, method, payload):
            if method in ("push_task", "push_tasks", "actor_task",
                          "create_actor", "kill", "profile"):
                return self._handle(conn, method, payload)
            return core_handle(conn, method, payload)

        def fast(method, payload):
            # deferred-reply handlers that only buffer + notify: run them
            # inline on the reader thread (rpc.py fast path).  actor_task
            # never blocks (seq buffering; the actor loop replies).
            # push_tasks blocks only to resolve ObjectRef args — the
            # owner marks such specs (singleton frames, "_refs"), and
            # they take the pooled path so a slow dependency fetch can't
            # stall the connection's reader.
            if method == "actor_task":
                return True
            if method == "report_generator_item":
                # nested streaming: this worker owns a streaming task it
                # submitted; item adoption only buffers + notifies
                return True
            if method == "push_tasks":
                try:
                    return all(not s.get("_refs") for s in payload["specs"])
                except (TypeError, KeyError):
                    return False
            return False

        self.core._server.rebind(dispatch, fast_methods=fast)

        # register with the raylet; the raylet sends us requests
        # (create_actor, kill) back over this same duplex connection.
        # A worker must not outlive its raylet (fate-sharing, cf. reference
        # raylet-socket disconnect handling): exit when the conn drops.
        def _raylet_gone(_conn):
            import os
            logger.warning("raylet connection lost; worker exiting")
            os._exit(1)

        self.raylet_conn = rpc.connect((args.raylet_host, args.raylet_port),
                                       handler=dispatch,
                                       on_close=_raylet_gone)
        self.raylet_conn.call("register_worker", {
            "worker_id": args.worker_id,
            "address": list(self.core.address),
        })

    # ------------------------------------------------------------- dispatch
    def _handle(self, conn, method, p):
        if method == "push_tasks":
            return self._run_queued_batch(conn, p)
        if method == "push_task":
            return self._run_queued(p)
        if method == "actor_task":
            return self._run_actor_task(p)
        if method == "create_actor":
            return self._create_actor(p)
        if method == "kill":
            import os
            os._exit(1)
        if method == "profile":
            # on-demand flame sampling of this worker (reference
            # reporter_agent CPU profiling, reporter_agent.py:253).
            # With "device" set (gang profiling, `ray-tpu profile
            # --group --device`) the reply is the capture dict — a
            # torch.profiler CPU+CUDA trace bracketing the host sampling
            # window when on a GPU, a caveat string on CPU-only boxes.
            from ray_tpu_torch._private.profiler import (profile_capture,
                                                   sample_folded)
            p = p or {}
            if "device" in p:
                return profile_capture(float(p.get("duration", 2.0)),
                                       device=bool(p.get("device")))
            return sample_folded(float(p.get("duration", 2.0)))
        if method == "dump_stacks":
            # instant per-thread stacks + short folded sample: a stalled
            # worker answers without gdb (`ray-tpu summary stacks`)
            from ray_tpu_torch._private.profiler import dump_stacks, \
                sample_folded
            return {"threads": dump_stacks(),
                    "folded": sample_folded(
                        float((p or {}).get("duration", 0.2)))}
        raise rpc.RpcError(f"worker: unknown method {method}")

    # --------------------------------------------------------- normal tasks
    def _run_queued(self, spec) -> dict:
        """Enqueue and wait for completion on the executor thread, keeping
        per-worker execution strictly serial.

        ObjectRef args resolve HERE, on the push's own handler thread,
        BEFORE the FIFO: pipelined pushes ride independent dispatch
        threads, so push N+1 can reach the queue before push N.  If a
        task could enter the executor with unresolved deps, a reordered
        dependent (task2 queued ahead of the task1 it waits on) would
        block the single executor forever — a head-of-line deadlock
        found by the schedule fuzzer (tests/test_sched_fuzz.py)."""
        resolved = None
        try:
            resolved = self._resolve_args(spec["args"])
        except Exception as e:      # dep failed: report as task error
            return self._package_error(spec, e)
        done = threading.Event()
        out: dict = {}

        def cb(reply, err):
            if err is None:
                out["reply"] = reply
            else:
                out["raise"] = err
            done.set()

        with self._queue_cv:
            self._queue.append((spec, resolved, cb))
            self._queue_cv.notify()
        done.wait()
        if "raise" in out:
            raise out["raise"]
        return out["reply"]

    # raylint: disable=inline-handler-purity -- conditional fast method: the registration predicate routes ref-carrying specs (the only path into _resolve_args' blocking fetches) to the POOLED dispatcher; ref-free frames, the only ones dispatched inline, never leave the enqueue pass
    def _run_queued_batch(self, conn, p) -> "rpc.Deferred":
        """Batched ``push_tasks`` frame: enqueue every spec to the serial
        executor FIFO in frame order; the LAST completion resolves the
        deferred batch ack directly from the executor thread (no handler
        thread parked on the frame).  The owner guarantees only a
        singleton frame carries ObjectRef args
        (core_worker._drain_batch_locked), so the enqueue pass can never
        block on a result the frame itself is yet to produce.  For
        multi-spec frames each completion is ALSO streamed back
        immediately as a task_done push: a fast task batched behind a
        slow one resolves at its own finish time, not the frame's (the
        batch ack is the idempotent backstop for lost pushes)."""
        specs = p["specs"]
        if not specs:
            return {"results": []}   # nothing to defer on
        d = rpc.Deferred()
        state = {"left": len(specs), "results": [None] * len(specs)}
        lock = threading.Lock()
        stream = len(specs) > 1

        def finish(i, spec, res):
            if stream:
                try:
                    conn.push("task_done", {"task_id": spec["task_id"],
                                            "res": res})
                except Exception:
                    # dead socket, unpicklable/oversized payload, …: the
                    # batch ack is the authoritative backstop — a push
                    # failure must NEVER stop 'left' from reaching zero
                    # or the frame's Deferred ack (and the owner's lease
                    # loop with it) hangs forever
                    pass
            with lock:
                state["results"][i] = res
                state["left"] -= 1
                last = state["left"] == 0
            if last:
                d.resolve({"results": state["results"]})

        for i, spec in enumerate(specs):
            try:
                resolved = self._resolve_args(spec["args"])
            except Exception as e:      # dep failed: report as task error
                finish(i, spec, {"ok": self._package_error(spec, e)})
                continue

            def cb(reply, err, i=i, spec=spec):
                # non-Exception escapes (SystemExit, MemoryError) become
                # per-spec textual errors so the rest of the frame's acks
                # survive, mirroring the solo-push RemoteError path
                finish(i, spec, {"ok": reply} if err is None
                       else {"err": repr(err)})

            with self._queue_cv:
                self._queue.append((spec, resolved, cb))
                self._queue_cv.notify()
        return d

    def _exec_loop(self) -> None:
        while True:
            with self._queue_cv:
                while not self._queue:
                    self._queue_cv.wait()
                spec, resolved, cb = self._queue.pop(0)
            try:
                reply, err = self._execute(spec, resolved), None
            except BaseException as e:  # noqa: BLE001
                reply, err = None, e
            try:
                cb(reply, err)
            except Exception:
                logger.exception("task completion callback failed")

    def _resolve_args_inline_ok(self, blob: bytes):
        """Event-loop-safe arg resolution attempt for the async-actor
        hot path: small blobs with NO ObjectRef args unpickle inline —
        the two executor hops (resolve + package) cost more than a
        serve-sized payload's unpickle on this class of box (~40-150us
        each vs ~2-5us).  Returns (args, kwargs, []) or None when the
        blob is big or carries refs (whose _get_one may block on a
        store/remote fetch — those keep the executor path).

        Unpickling can run user ``__setstate__`` code on the loop, but
        that is not a new hazard for THIS actor class: async-actor
        methods themselves (sync ones included) already execute on the
        loop thread, so user code blocking it was always possible."""
        if len(blob) > 16384:
            return None
        args, kwargs = cloudpickle.loads(blob)
        if any(isinstance(a, cw.ObjectRef) for a in args) or \
                any(isinstance(v, cw.ObjectRef) for v in kwargs.values()):
            return None
        return args, kwargs, []

    def _resolve_args(self, blob: bytes) -> tuple:
        """Returns (args, kwargs, borrowed_oids); the caller must hand
        ``borrowed_oids`` to core.release_borrowed after execution so arg
        pins/caches don't accumulate in pooled workers."""
        args, kwargs = cloudpickle.loads(blob)
        borrowed = []
        resolved = []
        for a in args:
            if isinstance(a, cw.ObjectRef):
                borrowed.append(a.id)
                resolved.append(self.core._get_one(a, None))
            else:
                resolved.append(a)
        rkw = {}
        for k, v in kwargs.items():
            if isinstance(v, cw.ObjectRef):
                borrowed.append(v.id)
                rkw[k] = self.core._get_one(v, None)
            else:
                rkw[k] = v
        return tuple(resolved), rkw, borrowed

    def _execute(self, spec, resolved=None) -> dict:
        from ray_tpu_torch.util.tracing import tracing_helper as trh
        from ray_tpu_torch.util.tracing.tracing_helper import \
            propagate_trace_context
        fn = self.core.load_function(spec["fn_key"])
        self.core.current_task_id = TaskID(spec["task_id"])
        trace_ctx = spec.get("trace_ctx")
        self.core.events.record(TaskID(spec["task_id"]).hex(), "RUNNING",
                                name=spec.get("name", ""),
                                **({"trace_id": trace_ctx["trace_id"]}
                                   if trace_ctx else {}))
        # flight-recorder breadcrumb (ring_only: never shipped to the
        # GCS table — it lands in this worker's crash dossier instead)
        cev.emit(cev.TASK_RUNNING, spec.get("name", ""), ring_only=True,
                 task_id=TaskID(spec["task_id"]).hex())
        # execution span (docs/observability.md): when the submitter's
        # trace is sampled, this task's whole worker-side execution is
        # one span, child of the submitting span
        exec_span = trh.open_span(f"task:{spec.get('name', '')}", "task",
                                  ctx=trace_ctx)
        # join the submitter's trace: user spans inside the task nest
        # under the caller's span (auto span injection); nested
        # submissions become children of the execution span
        propagate_trace_context(exec_span.ctx() if exec_span is not None
                                else trace_ctx)
        borrowed = []
        t_exec = None
        err_type = None
        try:
            args, kwargs, borrowed = (resolved if resolved is not None
                                      else self._resolve_args(spec["args"]))
            t_exec = rtm.now()
            result = fn(*args, **kwargs)
            return self._package_results(spec, result)
        except Exception as e:  # noqa: BLE001 - user errors cross the wire
            err_type = type(e).__name__
            return self._package_error(spec, e)
        finally:
            # observed in the finally so the sample covers generator
            # tasks (fn() only CREATES the generator — the iteration
            # happens inside _package_results/_StreamSession) and
            # failed executions alike
            if t_exec is not None:
                _M_EXEC.observe_since(spec.get("name", ""), t_exec)
            if exec_span is not None:
                exec_span.end(trh.ERROR if err_type else trh.OK,
                              error_type=err_type,
                              task_id=TaskID(spec["task_id"]).hex())
            propagate_trace_context(None)
            self.core.release_borrowed(borrowed)

    def _package_error(self, spec, e: BaseException) -> dict:
        tb = traceback.format_exc()
        cev.emit(cev.TASK_FAILED,
                 f"{spec.get('name') or spec.get('method', '')}: "
                 f"{type(e).__name__}: {e}",
                 severity="WARNING", ring_only=True,
                 error_type=type(e).__name__)
        if isinstance(e, exc.TaskError):
            # an upstream dependency already failed: propagate ITS error
            # unchanged (re-wrapping nests quoted tracebacks
            # exponentially down a task chain; cf. Ray's RayTaskError
            # propagation semantics)
            err = e
        else:
            err = exc.TaskError(spec.get("name", ""), e, tb)
        head, views = ser.serialize(err, error_type=ser.ERROR_TASK)
        data = ser.to_flat_bytes(head, views)
        from ray_tpu_torch.runtime.core_worker import num_return_slots
        return {"results": [{"data": data, "error": ser.ERROR_TASK}
                            for _ in range(
                                num_return_slots(spec["num_returns"]))]}

    def _package_results(self, spec, result) -> dict:
        n = spec["num_returns"]
        if n == "dynamic":
            return self._package_dynamic(spec, result)
        if n == "streaming":
            return self._package_streaming(spec, result)
        if n == 0:
            values = []
        elif n == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != n:
                return self._package_error(spec, ValueError(
                    f"task declared num_returns={n} but returned "
                    f"{len(values)} values"))
        results = []
        task_id = TaskID(spec["task_id"])
        for i, value in enumerate(values):
            head, views = ser.serialize(value)
            size = ser.serialized_size(head, views)
            if size <= self._inline_ret_max:
                results.append({"data": ser.to_flat_bytes(head, views)})
            else:
                oid = ObjectID.for_task_return(task_id, i)
                self.core.store_put(oid, head, views)
                # size feeds the owner's locality/prefetch lease hints
                results.append({"location": self.core.node_id,
                                "size": size})
        return {"results": results}

    def _package_dynamic(self, spec, result) -> dict:
        """num_returns="dynamic": each yielded item becomes its own object
        at return index j+1; the caller's slot-0 ref resolves to an
        ObjectRefGenerator over them (reference _raylet.pyx:169 semantics —
        the generator is consumed to completion, not streamed)."""
        try:
            iterator = iter(result)
        except TypeError:
            return self._package_error(spec, TypeError(
                'num_returns="dynamic" requires the task to return an '
                f"iterable, got {type(result).__name__}"))
        # user exceptions raised while iterating surface as themselves
        values = list(iterator)
        task_id = TaskID(spec["task_id"])
        subs = []
        for j, value in enumerate(values):
            head, views = ser.serialize(value)
            size = ser.serialized_size(head, views)
            if size <= self._inline_ret_max:
                subs.append({"data": ser.to_flat_bytes(head, views)})
            else:
                oid = ObjectID.for_task_return(task_id, j + 1)
                self.core.store_put(oid, head, views)
                subs.append({"location": self.core.node_id, "size": size})
        return {"results": [{"dynamic": subs}]}

    def _package_streaming(self, spec, result) -> dict:
        """num_returns="streaming": drive the user generator yield by
        yield, delivering each item to the owner as it is produced (see
        _StreamSession) instead of materializing the whole stream.  The
        task reply is just the completion sentinel."""
        try:
            iterator = iter(result)
        except TypeError:
            return self._package_error(spec, TypeError(
                'num_returns="streaming" requires the task to return an '
                f"iterable or generator, got {type(result).__name__}"))
        sess = _StreamSession(self.core, spec, self._inline_ret_max)
        try:
            for value in iterator:
                sess.send(value)
            return sess.finish()
        except _StreamCancelled:
            return sess.finish(cancelled=True)
        except Exception as e:  # noqa: BLE001 - user errors cross the wire
            # deliver already-reported items before the failure lands:
            # the consumer drains the arrived prefix, THEN raises
            sess.drain_quiet()
            return self._package_error(spec, e)

    async def _package_streaming_async(self, spec, agen) -> dict:
        """Async-generator variant (async actors): iteration interleaves
        on the event loop; each report (blocking RPC + possible
        backpressure wait) runs in the default executor so a paused
        stream never stalls the actor's loop."""
        import asyncio
        import functools
        loop = asyncio.get_running_loop()
        sess = _StreamSession(self.core, spec, self._inline_ret_max)
        try:
            async for value in agen:
                await loop.run_in_executor(None, sess.send, value)
            # finish() blocks on the tail reports' (possibly parked)
            # replies — keep that off the loop too
            return await loop.run_in_executor(None, sess.finish)
        except _StreamCancelled:
            return await loop.run_in_executor(
                None, functools.partial(sess.finish, cancelled=True))
        except Exception as e:  # noqa: BLE001
            await loop.run_in_executor(None, sess.drain_quiet)
            return self._package_error(spec, e)

    # --------------------------------------------------------------- actors
    def _create_actor(self, p) -> dict:
        import inspect

        creation = cloudpickle.loads(p["spec"])
        cls = self.core.load_function(creation["cls_key"])
        args, kwargs, _borrowed = self._resolve_args(creation["args"])
        self.actor_id = p["actor_id"]
        self.core.current_actor_id = p["actor_id"]  # get_runtime_context()
        groups = {str(g): int(c)
                  for g, c in (creation.get("concurrency_groups")
                               or {}).items()}
        self._actor_is_async = any(
            inspect.iscoroutinefunction(m)
            or inspect.isasyncgenfunction(m)
            for _n, m in inspect.getmembers(cls, callable))
        max_concurrency = creation.get("max_concurrency")
        if max_concurrency is None:
            # reference defaults: async actors allow 1000 concurrent
            # coroutines, sync actors are serial — but an EXPLICIT
            # max_concurrency=1 on an async actor is honored (the user
            # asked for serialized execution)
            max_concurrency = 1000 if self._actor_is_async else 1
        max_concurrency = int(max_concurrency)
        self._group_caps = {"_default": max_concurrency, **groups}
        if self._actor_is_async:
            # Async actor (cf. reference fiber.h + async actor event loop,
            # _raylet.pyx:1121): one asyncio loop owns all method
            # execution; up to the group's cap of coroutines interleave at
            # await points, sync methods block the loop (reference
            # semantics — actor state is only ever touched from this
            # thread).
            import asyncio
            self._actor_event_loop = asyncio.new_event_loop()
            threading.Thread(target=self._actor_event_loop.run_forever,
                             daemon=True,
                             name="actor-asyncio").start()
            self._group_sems = {g: asyncio.Semaphore(c)
                                for g, c in self._group_caps.items()}
        elif max_concurrency > 1 or groups:
            # Threaded actor (cf. reference ConcurrencyGroupManager /
            # BoundedExecutor, src/ray/core_worker/transport/
            # concurrency_group_manager.h): methods dispatch in submission
            # order but may execute concurrently, bounded per group.
            from concurrent.futures import ThreadPoolExecutor
            self._group_pools = {
                g: ThreadPoolExecutor(max_workers=c,
                                      thread_name_prefix=f"actor-{g}")
                for g, c in self._group_caps.items()}
        self.actor_instance = cls(*args, **kwargs)
        self.core.gcs.call("actor_ready", {
            "actor_id": p["actor_id"],
            "address": list(self.core.address)})
        logger.info("actor %s ready (%s)", p["actor_id"][:8],
                    type(self.actor_instance).__name__)
        return {"ok": True}

    def _run_actor_task(self, spec) -> "rpc.Deferred":
        """Buffer until this (stream, seq)'s turn; the actor thread that
        executes the call resolves the deferred reply directly — no
        handler thread parks per buffered seq, so deep pipelines hold no
        dispatch threads and the completion skips a wake hop."""
        d = rpc.Deferred()
        with self._actor_cv:
            stream = self._actor_streams.setdefault(
                spec.get("stream", ""), {"next": 0, "buf": {}})
            stream["buf"][spec["seq"]] = (spec, d)
            self._actor_cv.notify_all()
        return d

    def _next_actor_work(self):
        for stream in self._actor_streams.values():
            if stream["next"] in stream["buf"]:
                work = stream["buf"].pop(stream["next"])
                stream["next"] += 1
                return work
        return None

    def _actor_loop(self) -> None:
        while True:
            with self._actor_cv:
                work = self._next_actor_work()
                while work is None:
                    self._actor_cv.wait()
                    work = self._next_actor_work()
            spec, d = work
            if self._actor_event_loop is not None:
                self._dispatch_async(spec, d)
            elif self._group_pools is not None:
                try:
                    group = self._method_group(spec)
                except ValueError as e:
                    d.resolve(self._package_error(spec, e))
                    continue
                self._group_pools[group].submit(
                    self._run_actor_work, spec, d)
            else:
                self._run_actor_work(spec, d)

    def _method_group(self, spec) -> str:
        """Concurrency group for a call: per-call override, else the
        @method(concurrency_group=...) declaration, else the default.
        An undeclared group name is an error (reference semantics) — a
        silent fallback would void the cap the caller relied on."""
        g = spec.get("group")
        if not g and self.actor_instance is not None:
            m = getattr(type(self.actor_instance), spec.get("method", ""),
                        None)
            opts = getattr(m, "__ray_tpu_method_opts__", None) or {}
            g = opts.get("concurrency_group")
        if not g:
            return "_default"
        if g not in self._group_caps:
            raise ValueError(
                f"concurrency group {g!r} was not declared on this actor "
                f"(declared: {sorted(k for k in self._group_caps if k != '_default')})")
        return g

    def _run_actor_work(self, spec, d) -> None:
        try:
            d.resolve(self._execute_actor(spec))
        except BaseException as e:  # noqa: BLE001
            d.fail(e)

    def _dispatch_async(self, spec, d) -> None:
        """Schedule one call onto the actor's event loop; the dispatcher
        never blocks, so calls pipeline up to their group's semaphore."""
        import asyncio

        async def run():
            try:
                try:
                    sem = self._group_sems[self._method_group(spec)]
                except ValueError as e:
                    d.resolve(self._package_error(spec, e))
                    return
                async with sem:
                    d.resolve(await self._execute_actor_async(spec))
            except BaseException as e:  # noqa: BLE001
                d.fail(e)

        asyncio.run_coroutine_threadsafe(run(), self._actor_event_loop)

    def _begin_actor_call(self, spec):
        """Shared prologue of sync/async actor execution: liveness guard
        plus task bookkeeping (incl. joining the caller's trace).  Returns
        ``(error_reply_or_None, exec_span_or_None)`` — the error reply
        short-circuits the call; the span (opened only for sampled
        traces) is ended by the caller's finally."""
        from ray_tpu_torch.util.tracing import tracing_helper as trh
        from ray_tpu_torch.util.tracing.tracing_helper import \
            propagate_trace_context
        if self.actor_instance is None:
            return self._package_error(
                spec, exc.ActorDiedError("actor not initialized")), None
        self.core.current_task_id = TaskID(spec["task_id"])
        trace_ctx = spec.get("trace_ctx")
        self.core.events.record(TaskID(spec["task_id"]).hex(), "RUNNING",
                                name=spec.get("method", ""),
                                actor_id=spec.get("actor_id", ""),
                                **({"trace_id": trace_ctx["trace_id"]}
                                   if trace_ctx else {}))
        cev.emit(cev.TASK_RUNNING, spec.get("method", ""), ring_only=True,
                 task_id=TaskID(spec["task_id"]).hex(),
                 actor_id=spec.get("actor_id"))
        exec_span = trh.open_span(
            f"task:{spec.get('method', '')}", "actor_task", ctx=trace_ctx)
        propagate_trace_context(exec_span.ctx() if exec_span is not None
                                else trace_ctx)
        return None, exec_span

    async def _execute_actor_async(self, spec) -> dict:
        """Async-actor execution: coroutine methods await on the loop
        (interleaving with other calls of their group); sync methods run
        inline on the loop thread, so actor state is single-threaded.
        Arg resolution and result packaging do blocking IO (shm / RPC)
        and run in the default executor to keep the loop responsive —
        EXCEPT for the serve-shaped hot path (small ref-free args in,
        small JSON-ish result out), which stays inline: at serving QPS
        the two executor round-trips dominate a no-op request's replica
        cost (docs/rpc_fastpath.md inline-return note)."""
        import asyncio
        import functools

        from ray_tpu_torch.util.tracing import tracing_helper as trh
        from ray_tpu_torch.util.tracing.tracing_helper import \
            propagate_trace_context
        err, exec_span = self._begin_actor_call(spec)
        if err is not None:
            return err
        loop = asyncio.get_running_loop()
        borrowed = []
        t_exec = None
        err_type = None
        try:
            resolved = self._resolve_args_inline_ok(spec["args"])
            if resolved is None:
                resolved = await loop.run_in_executor(
                    None, self._resolve_args, spec["args"])
            args, kwargs, borrowed = resolved
            if spec["method"] == "__ray_terminate__":
                import os
                os._exit(0)
            dag_reply = self._maybe_dag_control(spec, args)
            if dag_reply is not None:
                return dag_reply
            import inspect
            method = getattr(self.actor_instance, spec["method"])
            t_exec = rtm.now()
            result = method(*args, **kwargs)
            if inspect.isawaitable(result):
                result = await result
            if spec["num_returns"] == "streaming" \
                    and inspect.isasyncgen(result):
                # async-generator streaming: iterate on the loop, report
                # off it (see _package_streaming_async)
                return await self._package_streaming_async(spec, result)
            if spec["num_returns"] == 1 and _probe_small(
                    result, min(32768, self._inline_ret_max)) >= 0:
                # bounded-size scalar/container result: serialize + the
                # inline-return reply build are cheaper than the
                # executor hop, and cannot block the loop measurably.
                # Budget clamped to the inline-return threshold so this
                # branch can never reach _package_results' store_put
                # (a blocking shm write) on the loop.
                return self._package_results(spec, result)
            return await loop.run_in_executor(
                None, functools.partial(self._package_results, spec,
                                        result))
        except Exception as e:  # noqa: BLE001
            err_type = type(e).__name__
            return self._package_error(spec, e)
        finally:
            # in the finally: covers async-generator streaming (the
            # iteration happens in _package_streaming_async) and errors
            if t_exec is not None:
                _M_EXEC.observe_since(spec.get("method", ""), t_exec)
            if exec_span is not None:
                exec_span.end(trh.ERROR if err_type else trh.OK,
                              error_type=err_type,
                              task_id=TaskID(spec["task_id"]).hex())
            propagate_trace_context(None)
            self.core.release_borrowed(borrowed)

    # ------------------------------------------------- compiled DAG loops
    def _dag_install(self, p: dict) -> dict:
        """``__ray_dag_install__``: start this actor's resident loop for
        one compiled DAG (rides the ordinary pooled actor-task path)."""
        with self._dag_lock:
            if p["dag_id"] in self._dag_runners:
                raise exc.RayTpuError(
                    f"compiled DAG {p['dag_id'][:8]} is already installed "
                    f"on this actor")
            runner = _CompiledDagRunner(self, p)
            self._dag_runners[p["dag_id"]] = runner
        return {"ok": True, "ops": len(runner.ops)}

    def _dag_teardown(self, p: dict) -> dict:
        """``__ray_dag_teardown__``: stop the loop and drop its pins
        (the driver poisoned the channels before calling this)."""
        with self._dag_lock:
            runner = self._dag_runners.pop(p["dag_id"], None)
        if runner is not None:
            runner.shutdown()
        return {"ok": True}

    def _maybe_dag_control(self, spec, args) -> Optional[dict]:
        """Compiled-DAG control methods shared by the sync and async
        actor execution paths; returns a reply dict or None."""
        if spec["method"] == "__ray_dag_install__":
            return self._package_results(spec, self._dag_install(args[0]))
        if spec["method"] == "__ray_dag_teardown__":
            return self._package_results(spec, self._dag_teardown(args[0]))
        return None

    def _execute_actor(self, spec) -> dict:
        from ray_tpu_torch.util.tracing import tracing_helper as trh
        from ray_tpu_torch.util.tracing.tracing_helper import \
            propagate_trace_context
        err, exec_span = self._begin_actor_call(spec)
        if err is not None:
            return err
        borrowed = []
        t_exec = None
        err_type = None
        try:
            args, kwargs, borrowed = self._resolve_args(spec["args"])
            if spec["method"] == "__ray_terminate__":
                import os
                os._exit(0)
            dag_reply = self._maybe_dag_control(spec, args)
            if dag_reply is not None:
                return dag_reply
            method = getattr(self.actor_instance, spec["method"])
            t_exec = rtm.now()
            if self._group_pools is None:
                # sequential actor: resident compiled-DAG loops share
                # this mutex, so actor state never sees two concurrent
                # method frames; threaded concurrency-group actors opted
                # out of that guarantee and skip it.  _package_results
                # stays INSIDE the mutex: a streaming generator's body
                # runs lazily in there and is still this method's frame.
                with self._method_mutex:
                    result = method(*args, **kwargs)
                    return self._package_results(spec, result)
            result = method(*args, **kwargs)
            return self._package_results(spec, result)
        except Exception as e:  # noqa: BLE001
            err_type = type(e).__name__
            return self._package_error(spec, e)
        finally:
            # finally-observed: covers sync-generator streaming (driven
            # inside _package_results) and failed calls
            if t_exec is not None:
                _M_EXEC.observe_since(spec.get("method", ""), t_exec)
            if exec_span is not None:
                exec_span.end(trh.ERROR if err_type else trh.OK,
                              error_type=err_type,
                              task_id=TaskID(spec["task_id"]).hex())
            propagate_trace_context(None)
            self.core.release_borrowed(borrowed)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--raylet-host", required=True)
    parser.add_argument("--raylet-port", type=int, required=True)
    parser.add_argument("--gcs-host", required=True)
    parser.add_argument("--gcs-port", type=int, required=True)
    parser.add_argument("--worker-id", required=True)
    parser.add_argument("--store-path", required=True)
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--node-id", required=True)
    args = parser.parse_args()
    setup_component_logging("worker", args.session_dir)
    from ray_tpu_torch._private.logging_utils import enable_stack_dumps
    enable_stack_dumps(args.session_dir)
    if os.environ.get("RAY_TPU_TORCH_PROFILE_STARTUP"):
        import cProfile
        import pstats
        prof = cProfile.Profile()
        prof.enable()
        worker = WorkerProcess(args)
        prof.disable()
        path = os.path.join(args.session_dir, "logs",
                            f"startup-{args.worker_id[:8]}.prof")
        pstats.Stats(prof).dump_stats(path)
        logger.info("startup profile: %s", path)
    else:
        worker = WorkerProcess(args)
    logger.info("worker %s serving at %s", args.worker_id[:8],
                worker.core.address)
    threading.Event().wait()  # serve forever; raylet kills us


if __name__ == "__main__":
    main()
