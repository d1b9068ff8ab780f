"""AIR-style glue: the port's ``Checkpoint`` (dict, directory and bytes
forms), which ``serve.llm.LLMServer`` reads its weights through.

Analog of Ray's python/ray/air (Checkpoint checkpoint.py:60).  The rest
of ``ray_tpu.air`` (``config``, ``result``, ``session``) comes with the
trainer, its first consumer.
"""

from ray_tpu_torch.air.checkpoint import Checkpoint  # noqa: F401

__all__ = ["Checkpoint"]
