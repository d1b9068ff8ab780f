"""Public exception hierarchy.

Analog of the reference's /root/reference/python/ray/exceptions.py: errors are
first-class object payloads — a failed task's return object *contains* the
exception, so ``get`` raises it at the caller with cause chaining.
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all ray_tpu_torch errors."""


class _DossierRef:
    """Mixin: errors caused by a process death carry a ``dossier_id``
    (the dead worker's id hex, or a node id hex) referencing the crash
    dossier the raylet/GCS harvested — event ring, log tail, metrics
    watermarks (docs/observability.md).  ``debug_dossier()`` fetches
    and pretty-prints it at the driver."""

    dossier_id: str | None = None

    def debug_dossier(self, timeout: float = 10.0) -> str:
        """Fetch + format this death's crash dossier from the GCS.

        Returns the formatted dossier text; a descriptive placeholder
        when no dossier reference exists or it already rotated out."""
        did = self.dossier_id
        if not did:
            cause = getattr(self, "cause", None)
            if isinstance(cause, _DossierRef) and cause.dossier_id:
                return cause.debug_dossier(timeout)
            return "(no dossier reference on this error)"
        from ray_tpu_torch._private.cluster_events import (fetch_dossier,
                                                     format_dossier)
        try:
            d = fetch_dossier(did, timeout)
        except Exception as e:  # noqa: BLE001 - diagnostics must not raise
            return f"(dossier {did[:12]} fetch failed: {e})"
        if not d:
            return f"(dossier {did[:12]} not found — rotated out, or " \
                   "the cluster is gone)"
        return format_dossier(d)


class TaskError(RayTpuError, _DossierRef):
    """A task raised an exception during execution (cf. RayTaskError)."""

    def __init__(self, function_name: str = "", cause: BaseException | None = None,
                 traceback_str: str = ""):
        self.function_name = function_name
        self.cause = cause
        self.traceback_str = traceback_str
        super().__init__(
            f"task {function_name!r} failed: {cause!r}\n{traceback_str}")

    def __reduce__(self):
        # Exception's default reduce would reconstruct with the FORMATTED
        # message as function_name, re-wrapping the error on every pickle
        # round trip (messages grew exponentially down task chains).
        # The state dict keeps the dossier reference across the wire.
        return (TaskError, (self.function_name, self.cause,
                            self.traceback_str),
                {"dossier_id": self.dossier_id})


class WorkerCrashedError(RayTpuError, _DossierRef):
    """The worker process executing the task died (cf. WorkerCrashedError)."""

    def __init__(self, message: str = "worker crashed",
                 dossier_id: str | None = None):
        self.dossier_id = dossier_id
        super().__init__(message)

    def __reduce__(self):
        return (WorkerCrashedError, (self.args[0] if self.args else "",
                                     self.dossier_id))


class ActorDiedError(RayTpuError, _DossierRef):
    """The actor is dead and will not be restarted (cf. RayActorError)."""

    def __init__(self, reason: str = "actor died",
                 dossier_id: str | None = None):
        self.reason = reason
        self.dossier_id = dossier_id
        super().__init__(reason)

    def __reduce__(self):
        return (ActorDiedError, (self.reason, self.dossier_id))


class ActorUnavailableError(RayTpuError, _DossierRef):
    """The actor is temporarily unreachable (restart pending)."""


class ObjectLostError(RayTpuError, _DossierRef):
    """The object's primary copy was lost and could not be
    reconstructed.  When lineage is exhausted the error names the node
    dossier of the node that lost the last copy
    (``err.debug_dossier()``; docs/fault_tolerance.md)."""

    def __init__(self, message: str = "object lost",
                 dossier_id: str | None = None):
        self.dossier_id = dossier_id
        super().__init__(message)
        # default exception pickling round-trips (cls, args) + __dict__,
        # which carries dossier_id — no custom __reduce__ needed


class ObjectStoreFullError(RayTpuError):
    """The shared-memory store could not admit the object."""


class OutOfDiskError(RayTpuError):
    """Local disk crossed local_fs_capacity_threshold: spilling and
    fallback allocation refuse to write (reference OutOfDiskError)."""


class OutOfMemoryError(RayTpuError, _DossierRef):
    """A worker was killed by the memory monitor (cf. OutOfMemoryError)."""


class TaskCancelledError(RayTpuError):
    """The task was cancelled before/while running (cf. TaskCancelledError)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get(..., timeout=)`` expired (cf. GetTimeoutError)."""


class RuntimeEnvSetupError(RayTpuError):
    """Preparing the task/actor runtime environment failed."""


class PendingCallsLimitExceeded(RayTpuError):
    """Actor's max_pending_calls backpressure limit hit."""


class SchedulingError(RayTpuError):
    """A scheduling strategy can never be satisfied (placement group
    removed, bundle index out of range, hard affinity to a dead node) —
    permanent, not retried."""


class ChannelError(RayTpuError):
    """Base class for compiled-DAG shared-memory channel errors
    (experimental/channel.py)."""


class ChannelTimeoutError(ChannelError, TimeoutError):
    """A blocking channel read/write did not complete in time."""


class ChannelClosedError(ChannelError):
    """The channel was poisoned (teardown, or a participant died): no
    further items will ever arrive, blocked peers must unwind."""


class DAGCompileError(RayTpuError):
    """``experimental_compile()`` rejected the graph (not actor-method
    only, no/duplicate InputNode, cycle, dead actor, remote actor, ...)."""


class DAGUnavailableError(RayTpuError):
    """A compiled DAG lost a participating actor (or was torn down) and
    can no longer execute; recompile to get a fresh one — the compiled-
    graph analog of ObjectLostError."""


class KVPoolFullError(RayTpuError):
    """A disaggregated-serving KV handoff could not be admitted: the
    decode engine's import wait queue is at its configured cap
    (``import_queue_max``).  Raised synchronously at submit — a fast
    typed rejection the serving layer uses to re-queue / re-route the
    handoff to another replica instead of piling more waiters onto a
    saturated pool (docs/serve_disagg.md)."""
