"""Placement groups: gang reservation of resource bundles across nodes.

Analog of /root/reference/python/ray/util/placement_group.py
(PlacementGroup :33, placement_group() :128); server side is the GCS
2-phase bundle reservation (cf. gcs_placement_group_scheduler.h).

TPU-first addition: a bundle may carry a ``tpu-slice`` resource, and the
GCS packer treats slice bundles as atomic — all bundles of one group land
on hosts of a single slice (SURVEY.md §2.6 "pod-slice-aware bundles").
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch.runtime.core_worker import get_global_worker

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    """Handle to a (possibly still pending) placement group."""

    def __init__(self, pg_id: PlacementGroupID,
                 bundles: Optional[List[Dict[str, float]]] = None):
        self.id = pg_id
        self._bundles = bundles

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        if self._bundles is None:
            info = self._table()
            self._bundles = info["bundles"] if info else []
        return self._bundles

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def _table(self) -> Optional[dict]:
        worker = get_global_worker()
        return worker.gcs.call("get_placement_group",
                               {"pg_id": self.id.hex()})

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        """Block until all bundles are reserved (or timeout). cf.
        PlacementGroup.wait (reference placement_group.py:60)."""
        deadline = time.monotonic() + timeout_seconds
        while True:
            info = self._table()
            if info and info["state"] == "CREATED":
                return True
            if info is None or info["state"] == "REMOVED":
                return False
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.05)

    def ready(self):
        """ObjectRef that resolves when the group is placed (ray parity:
        ``ray.get(pg.ready())``)."""
        from ray_tpu_torch.remote_function import RemoteFunction

        def _ready(pg_id_hex: str):
            worker = get_global_worker()
            while True:
                info = worker.gcs.call("get_placement_group",
                                       {"pg_id": pg_id_hex})
                if info is None or info["state"] == "REMOVED":
                    raise RuntimeError("placement group removed")
                if info["state"] == "CREATED":
                    return True
                time.sleep(0.05)

        fn = RemoteFunction(_ready, num_cpus=0)
        return fn.remote(self.id.hex())

    def __reduce__(self):
        return (PlacementGroup, (self.id, self._bundles))

    def __repr__(self):
        return f"PlacementGroup({self.id.hex()[:12]})"


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: str = "",
                    lifetime: Optional[str] = None) -> PlacementGroup:
    """Reserve ``bundles`` across the cluster; returns immediately with a
    handle (use ``.wait()`` / ``.ready()``)."""
    if strategy not in VALID_STRATEGIES:
        raise ValueError(
            f"strategy must be one of {VALID_STRATEGIES}, got {strategy!r}")
    if not bundles:
        raise ValueError("placement group needs at least one bundle")
    for b in bundles:
        if not b or any(v < 0 for v in b.values()):
            raise ValueError(f"invalid bundle {b!r}")
    worker = get_global_worker()
    pg_id = PlacementGroupID.from_random()
    worker.gcs.call("create_placement_group", {
        "pg_id": pg_id.hex(),
        "bundles": [dict(b) for b in bundles],
        "strategy": strategy,
        "name": name,
        "lifetime": lifetime or "",
        "job_id": worker.job_id.hex(),
        # removed when the actor that made it dies, unless detached
        "owner_actor_id": None if lifetime == "detached"
        else getattr(worker, "current_actor_id", None),
    })
    return PlacementGroup(pg_id, [dict(b) for b in bundles])


def remove_placement_group(pg: PlacementGroup) -> None:
    """Release all bundles (outstanding leases drain back to the node)."""
    get_global_worker().gcs.call("remove_placement_group",
                                 {"pg_id": pg.id.hex()})


def placement_group_table(pg: Optional[PlacementGroup] = None) -> dict:
    """Debug table of one or all placement groups (cf. reference
    placement_group_table)."""
    worker = get_global_worker()
    if pg is not None:
        info = worker.gcs.call("get_placement_group", {"pg_id": pg.id.hex()})
        return {pg.id.hex(): info} if info else {}
    return worker.gcs.call("list_placement_groups", {}) or {}


def get_placement_group(name: str) -> PlacementGroup:
    """Look up a named placement group."""
    worker = get_global_worker()
    table = worker.gcs.call("list_placement_groups", {}) or {}
    for pgid, info in table.items():
        if info.get("name") == name and info["state"] != "REMOVED":
            return PlacementGroup(PlacementGroupID.from_hex(pgid),
                                  info["bundles"])
    raise ValueError(f"no placement group named {name!r}")
