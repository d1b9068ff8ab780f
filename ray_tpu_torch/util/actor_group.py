"""ActorGroup: homogeneous gang of actors addressed as one unit.

Analog of /root/reference/python/ray/util/actor_group.py (ActorGroup):
create N identical actors, broadcast method calls, gather results.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import ray_tpu_torch


class ActorGroupMethod:
    def __init__(self, group: "ActorGroup", name: str):
        self._group = group
        self._name = name

    def remote(self, *args, **kwargs) -> List[Any]:
        """Invoke on every member; returns one ObjectRef per member."""
        return [getattr(a, self._name).remote(*args, **kwargs)
                for a in self._group._actors]


class ActorGroup:
    def __init__(self, actor_cls, num_actors: int, *init_args,
                 resources_per_actor: Optional[Dict[str, float]] = None,
                 **init_kwargs):
        if num_actors < 1:
            raise ValueError("num_actors must be >= 1")
        opts = {}
        if resources_per_actor:
            res = dict(resources_per_actor)
            opts["num_cpus"] = res.pop("CPU", 1.0)
            if "GPU" in res:
                opts["num_gpus"] = res.pop("GPU")
            if res:
                opts["resources"] = res
        if not hasattr(actor_cls, "remote"):
            actor_cls = ray_tpu_torch.remote(actor_cls)
        if opts:
            actor_cls = actor_cls.options(**opts)
        self._actors = [actor_cls.remote(*init_args, **init_kwargs)
                        for _ in range(num_actors)]

    def __len__(self) -> int:
        return len(self._actors)

    def __getattr__(self, name: str) -> ActorGroupMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorGroupMethod(self, name)

    @property
    def actors(self) -> List[Any]:
        return list(self._actors)

    def execute(self, method: str, *args, **kwargs) -> List[Any]:
        """Call + gather on all members."""
        return ray_tpu_torch.get(
            ActorGroupMethod(self, method).remote(*args, **kwargs))

    def shutdown(self) -> None:
        for a in self._actors:
            ray_tpu_torch.kill(a)
        self._actors = []
