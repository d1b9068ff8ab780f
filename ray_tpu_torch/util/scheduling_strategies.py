"""Scheduling strategies for tasks and actors.

Analog of /root/reference/python/ray/util/scheduling_strategies.py
(PlacementGroupSchedulingStrategy :15, NodeAffinitySchedulingStrategy :41).

Strategies are plain declarative objects; the core worker encodes them into
the lease protocol (a placement-group bundle pins the lease to the bundle's
reserved pool on its node; node affinity pins the lease to one raylet).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional, Union

if TYPE_CHECKING:
    from ray_tpu_torch.util.placement_group import PlacementGroup


@dataclass
class PlacementGroupSchedulingStrategy:
    """Schedule onto a reserved placement-group bundle.

    ``placement_group_bundle_index == -1`` means "any bundle that fits".
    """

    placement_group: "PlacementGroup"
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False

    def _encode(self) -> dict:
        idx = int(self.placement_group_bundle_index)
        n = self.placement_group.bundle_count
        if idx < -1 or idx >= n:
            raise ValueError(
                f"placement_group_bundle_index {idx} out of range for a "
                f"{n}-bundle placement group")
        return {
            "type": "placement_group",
            "pg_id": self.placement_group.id.hex(),
            "bundle_index": idx,
        }


@dataclass
class NodeAffinitySchedulingStrategy:
    """Pin to a specific node. ``soft=True`` falls back to the default
    policy when the node can't take it."""

    node_id: str
    soft: bool = False

    def _encode(self) -> dict:
        return {"type": "node_affinity", "node_id": self.node_id,
                "soft": bool(self.soft)}


SchedulingStrategyT = Union[
    None, str, PlacementGroupSchedulingStrategy, NodeAffinitySchedulingStrategy]


def encode_strategy(strategy: SchedulingStrategyT) -> Optional[dict]:
    """Normalize a strategy object to the wire dict the core worker uses."""
    if strategy is None or strategy == "DEFAULT":
        return None
    if isinstance(strategy, str):
        if strategy == "SPREAD":
            return {"type": "spread"}
        raise ValueError(f"unknown scheduling strategy {strategy!r}")
    return strategy._encode()
