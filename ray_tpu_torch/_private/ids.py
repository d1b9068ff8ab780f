"""Binary identifiers for jobs, tasks, actors, objects, nodes, placement groups.

Mirrors the role of the reference's ID hierarchy
(/root/reference/src/ray/common/id.h: JobID 4B, ActorID 16B, TaskID 24B,
ObjectID 28B with embedded task id + return index) but with a simpler uniform
scheme: every ID is 16 random bytes except ObjectID, which embeds its parent
TaskID plus a 4-byte return/put index so ownership and lineage can be derived
from the ID alone — the property the reference relies on for reconstruction.
"""

from __future__ import annotations

import os

_UNIQUE_LEN = 16
_OBJECT_LEN = _UNIQUE_LEN + 4


class BaseID:
    __slots__ = ("_bytes",)
    LENGTH = _UNIQUE_LEN

    def __init__(self, value: bytes):
        if not isinstance(value, bytes) or len(value) != self.LENGTH:
            raise ValueError(
                f"{type(self).__name__} requires {self.LENGTH} bytes, got {value!r}")
        self._bytes = value

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.LENGTH))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.LENGTH)

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.LENGTH

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other._bytes == self._bytes

    def __hash__(self) -> int:
        return hash((type(self).__name__, self._bytes))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._bytes.hex()[:12]}…)"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    pass


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class ActorID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass


class TaskID(BaseID):
    pass


class ObjectID(BaseID):
    """TaskID (16B) + big-endian uint32 index.

    Index 0.. for task returns; puts use a per-worker counter offset by 2**31
    (cf. reference ObjectID::FromIndex, id.h).
    """

    LENGTH = _OBJECT_LEN
    _PUT_OFFSET = 1 << 31

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "big"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        return cls.for_task_return(task_id, cls._PUT_OFFSET + put_index)

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:_UNIQUE_LEN])

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[_UNIQUE_LEN:], "big")

    def is_put(self) -> bool:
        return self.return_index() >= self._PUT_OFFSET
