"""Runtime backend interface.

The worker-facing contract implemented by both the in-process local backend
(``local_backend.py``) and the multiprocess cluster backend
(``cluster/driver_backend.py``). Equivalent in role to the reference's
``CoreWorker`` C-ABI surface (``src/ray/core_worker/core_worker.h:285``):
SubmitTask / CreateActor / SubmitActorTask / Put / Get / Wait plus lifecycle.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch.core.object_ref import ObjectRef


class RuntimeBackend(abc.ABC):
    @abc.abstractmethod
    def put(self, value: Any) -> ObjectRef: ...

    @abc.abstractmethod
    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float]) -> List[Any]: ...

    @abc.abstractmethod
    def wait(self, refs: Sequence[ObjectRef], num_returns: int,
             timeout: Optional[float]) -> Tuple[List[ObjectRef], List[ObjectRef]]: ...

    @abc.abstractmethod
    def submit_task(self, fn: Callable, options: Dict[str, Any],
                    args: Tuple, kwargs: Dict) -> Any: ...

    @abc.abstractmethod
    def create_actor(self, cls: type, options: Dict[str, Any], args: Tuple,
                     kwargs: Dict, method_meta: Dict[str, int]) -> Any: ...

    @abc.abstractmethod
    def submit_actor_task(self, actor_id: ActorID, method_name: str,
                          args: Tuple, kwargs: Dict, num_returns: int) -> Any: ...

    @abc.abstractmethod
    def kill_actor(self, actor_id: ActorID, no_restart: bool) -> None: ...

    @abc.abstractmethod
    def cancel(self, ref: ObjectRef, force: bool) -> None: ...

    @abc.abstractmethod
    def get_actor_handle(self, name: str, namespace: Optional[str]) -> Any: ...

    @abc.abstractmethod
    def cluster_resources(self) -> Dict[str, float]: ...

    @abc.abstractmethod
    def available_resources(self) -> Dict[str, float]: ...

    @abc.abstractmethod
    def nodes(self) -> List[Dict]: ...

    @abc.abstractmethod
    def shutdown(self) -> None: ...

    # Optional hooks ---------------------------------------------------------
    def kv_put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def kv_get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def kv_del(self, key: str) -> None:
        raise NotImplementedError

    def kv_keys(self, prefix: str) -> List[str]:
        raise NotImplementedError

    def free_objects(self, refs: Sequence[ObjectRef]) -> None:
        """Release storage for objects (reference: ray._private.internal_api.free)."""
