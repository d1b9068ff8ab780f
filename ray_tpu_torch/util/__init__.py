"""ray_tpu_torch.util: utility patterns on top of the task/actor core.

Analog of /root/reference/python/ray/util/ (actor_pool.py, queue.py,
placement_group.py, scheduling_strategies.py, collective/).
"""

from ray_tpu_torch.util.actor_group import ActorGroup  # noqa: F401
from ray_tpu_torch.util.actor_pool import ActorPool  # noqa: F401
from ray_tpu_torch.util.check_serialize import inspect_serializability  # noqa: F401
from ray_tpu_torch.util.placement_group import (  # noqa: F401
    PlacementGroup, get_placement_group, placement_group,
    placement_group_table, remove_placement_group)
from ray_tpu_torch.util.queue import Empty, Full, Queue  # noqa: F401
from ray_tpu_torch.util.scheduling_strategies import (  # noqa: F401
    NodeAffinitySchedulingStrategy, PlacementGroupSchedulingStrategy)

__all__ = [
    "ActorPool", "ActorGroup", "inspect_serializability",
    "Queue", "Empty", "Full",
    "PlacementGroup", "placement_group", "remove_placement_group",
    "placement_group_table", "get_placement_group",
    "PlacementGroupSchedulingStrategy", "NodeAffinitySchedulingStrategy",
]
