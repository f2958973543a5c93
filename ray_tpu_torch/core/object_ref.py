"""ObjectRef: a first-class future naming a value in the object plane.

Equivalent of the reference's ``ObjectRef`` (``python/ray/_raylet.pyx``): a
handle around a binary ObjectID plus an owner hint. Refs are hashable, can be
passed as arguments to remote calls (the runtime resolves them before
dispatch), can be awaited in async actors, and survive serialization via a
compact descriptor so ownership tracking sees every border crossing.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.core import object_ledger


class ObjectRef:
    __slots__ = ("_id", "_owner", "_call_site", "__weakref__")

    def __init__(self, object_id: ObjectID, owner: Optional[str] = None, call_site: str = ""):
        self._id = object_id
        self._owner = owner  # "host:port" of the owning worker, if known
        self._call_site = call_site
        if object_ledger.enabled():
            # ownership/reference ledger (`rt memory`): liveness of this ref
            # is tracked via a weakref, so dropping it needs no release call
            object_ledger.get_ledger().record_ref(self)

    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def owner_address(self) -> Optional[str]:
        return self._owner

    def task_id(self):
        return self._id.task_id()

    # -- future protocol -----------------------------------------------------
    def __await__(self):
        from ray_tpu_torch.core.worker import global_worker

        return global_worker().get_async(self).__await__()

    def future(self):
        """A concurrent.futures.Future resolving to the object's value."""
        from ray_tpu_torch.core.worker import global_worker

        return global_worker().as_future(self)

    # -- serialization -------------------------------------------------------
    def _descriptor(self) -> Tuple[bytes, Optional[str]]:
        return (self._id.binary(), self._owner)

    @classmethod
    def _rehydrate(cls, desc: Tuple[bytes, Optional[str]]) -> "ObjectRef":
        return cls(ObjectID(desc[0]), desc[1])

    def __reduce__(self):
        # Plain pickling (outside SerializationContext) keeps identity but
        # loses ownership registration — the context path is preferred.
        return (ObjectRef._rehydrate, (self._descriptor(),))

    # -- identity ------------------------------------------------------------
    def __eq__(self, other: Any) -> bool:
        return isinstance(other, ObjectRef) and other._id == self._id

    def __hash__(self) -> int:
        return hash(self._id)

    def __repr__(self) -> str:
        return f"ObjectRef({self._id.hex()})"
