"""The port's copies of the exceptions it raises from ray_tpu/exceptions.py
(the port imports nothing of ray_tpu)."""


class RayTpuError(Exception):
    """Base of the framework's errors."""


class KVPoolFullError(RayTpuError):
    """A disaggregated-serving KV handoff could not be admitted: the
    decode engine's import wait queue is at its configured cap
    (``import_queue_max``).  Raised synchronously at submit, so that the
    serving layer can re-route the handoff to another replica instead of
    piling more waiters onto a saturated pool."""
