"""Collective communication on top of the cluster runtime.

The port holds only the wire codec so far (``quant.py``: block-scaled
int8, numpy only), which Serve's prefill handoffs use
(``serve/llm.py``).  The collective groups themselves (ray_tpu's
``collective.py``, ``ici.py`` and ``transport.py``) come with the
multi-device item, over NCCL and gloo (ROADMAP.md, Queue 1, item 4).
"""

from ray_tpu_torch.util.collective.quant import Int8Codec, get_codec  # noqa: F401

__all__ = ["Int8Codec", "get_codec"]
