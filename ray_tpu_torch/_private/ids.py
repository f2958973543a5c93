"""Binary unique IDs for every entity in the system.

Equivalent of the reference's ID scheme (``src/ray/common/id.h``
and ``src/ray/design_docs/id_specification.md``): fixed-width random IDs with
structural embedding — a TaskID embeds the job, an ObjectID embeds the task
that created it plus a return-index, an ActorID embeds the job. That embedding
is what makes ownership and lineage cheap to compute: given an ObjectID you
can recover its creating TaskID without a directory lookup.

Layout (bytes):
    JobID    = 4 random
    NodeID   = 16 random
    WorkerID = 16 random
    ActorID  = JobID + 8 random                      (12)
    TaskID   = ActorID(12) + 8 random                (20)
    ObjectID = TaskID(20) + 4 LE index               (24)
Normal (non-actor) tasks use a NIL actor suffix inside their TaskID.
"""

from __future__ import annotations

import os
import struct

JOB_ID_SIZE = 4
NODE_ID_SIZE = 16
WORKER_ID_SIZE = 16
ACTOR_ID_SIZE = JOB_ID_SIZE + 8
TASK_ID_SIZE = ACTOR_ID_SIZE + 8
OBJECT_ID_SIZE = TASK_ID_SIZE + 4
PLACEMENT_GROUP_ID_SIZE = 16


class BaseID:
    SIZE = 16
    __slots__ = ("_bytes",)

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(binary)}"
            )
        self._bytes = binary

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, h: str):
        return cls(bytes.fromhex(h))

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.SIZE

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other._bytes == self._bytes

    def __hash__(self) -> int:
        return hash((type(self).__name__, self._bytes))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._bytes.hex()[:16]})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = JOB_ID_SIZE

    @classmethod
    def from_int(cls, i: int) -> "JobID":
        return cls(struct.pack("<I", i))


class NodeID(BaseID):
    SIZE = NODE_ID_SIZE


class WorkerID(BaseID):
    SIZE = WORKER_ID_SIZE


class PlacementGroupID(BaseID):
    SIZE = PLACEMENT_GROUP_ID_SIZE


class ActorID(BaseID):
    SIZE = ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(job_id.binary() + os.urandom(cls.SIZE - JOB_ID_SIZE))

    def job_id(self) -> JobID:
        return JobID(self._bytes[:JOB_ID_SIZE])


class TaskID(BaseID):
    SIZE = TASK_ID_SIZE

    @classmethod
    def for_task(cls, job_id: JobID) -> "TaskID":
        actor_part = job_id.binary() + b"\x00" * (ACTOR_ID_SIZE - JOB_ID_SIZE)
        return cls(actor_part + os.urandom(cls.SIZE - ACTOR_ID_SIZE))

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(actor_id.binary() + os.urandom(cls.SIZE - ACTOR_ID_SIZE))

    @classmethod
    def for_actor_creation(cls, actor_id: ActorID) -> "TaskID":
        return cls(actor_id.binary() + b"\xff" * (cls.SIZE - ACTOR_ID_SIZE))

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[:ACTOR_ID_SIZE])

    def job_id(self) -> JobID:
        return JobID(self._bytes[:JOB_ID_SIZE])


class ObjectID(BaseID):
    SIZE = OBJECT_ID_SIZE

    @classmethod
    def for_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + struct.pack("<I", index))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        # Puts use the high bit of the index to avoid colliding with returns.
        return cls(task_id.binary() + struct.pack("<I", put_index | 0x80000000))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:TASK_ID_SIZE])

    def index(self) -> int:
        return struct.unpack("<I", self._bytes[TASK_ID_SIZE:])[0]
