"""Collective communication on top of the cluster runtime (the port's
copy of ray_tpu/util/collective).

Analog of Ray's python/ray/util/collective/collective.py
(init_collective_group :120, allreduce :258, reduce/broadcast/allgather/
reducescatter/send/recv/barrier :311-615).

The host (DCN) plane: a ring collective group over the runtime's RPC,
shared-memory channels and transfer plane, on numpy (torch tensors are
copied to the host), with the block-scaled int8 wire codec
(``quant.py``) that Serve's prefill handoffs use too.  ray_tpu's ICI
plane (``ici.py``, ``register_ici_mesh``: collectives compiled into a
jitted program over a mesh) waits for multi-device training (ROADMAP.md,
Queue 1, item 4, multi-device).
"""

from ray_tpu_torch.util.collective.collective import (  # noqa: F401
    AsyncWork, ReduceOp, allgather, allreduce, allreduce_async, barrier,
    broadcast, destroy_collective_group, get_rank,
    get_collective_group_size, init_collective_group,
    is_group_initialized, recv, reduce, reducescatter, register_ici_mesh,
    send, wait_all)
from ray_tpu_torch.util.collective.quant import (  # noqa: F401
    Int8Codec, get_codec)

__all__ = [
    "ReduceOp", "init_collective_group", "destroy_collective_group",
    "is_group_initialized", "get_rank", "get_collective_group_size",
    "allreduce", "allreduce_async", "AsyncWork", "wait_all",
    "register_ici_mesh", "allgather", "reducescatter", "broadcast",
    "reduce", "send", "recv", "barrier", "Int8Codec", "get_codec",
]
