"""The per-process worker singleton and the public entry points.

Equivalent of the reference's ``python/ray/_private/worker.py`` (global
``Worker`` singleton; ``init :1133``, ``shutdown :1698``, ``get_objects
:737``, ``put_object :659``): holds the runtime backend, the serialization
context, and the per-thread task context (current task id, put counter) that
object IDs for ``put`` are derived from.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID
from ray_tpu_torch._private.serialization import SerializationContext
from ray_tpu_torch.core.backend import RuntimeBackend
from ray_tpu_torch.core.object_ref import ObjectRef


class _TaskContext(threading.local):
    def __init__(self):
        self.task_id: Optional[TaskID] = None
        self.put_counter: int = 0
        self.actor_id: Optional[ActorID] = None


class Worker:
    def __init__(self):
        self.backend: Optional[RuntimeBackend] = None
        self.serialization_context = SerializationContext()
        self.job_id: Optional[JobID] = None
        self.mode: Optional[str] = None  # "local" | "driver" | "worker"
        self._ctx = _TaskContext()
        self._driver_task_id: Optional[TaskID] = None
        self._put_lock = threading.Lock()
        self._executor = None  # lazy pool for as_future

    # -- lifecycle -----------------------------------------------------------
    @property
    def connected(self) -> bool:
        return self.backend is not None

    def connect(self, backend: RuntimeBackend, job_id: JobID, mode: str) -> None:
        self.backend = backend
        self.job_id = job_id
        self.mode = mode
        self._driver_task_id = TaskID.for_task(job_id)

    def disconnect(self) -> None:
        if self.backend is not None:
            self.backend.shutdown()
        self.backend = None
        self.mode = None
        try:
            # the ownership ledger is session state: entries must not leak
            # into the next init() in this process (tests re-init a lot)
            from ray_tpu_torch.core import object_ledger

            object_ledger.get_ledger().clear()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass

    def _require_backend(self) -> RuntimeBackend:
        if self.backend is None:
            raise RuntimeError(
                "ray_tpu_torch has not been initialized; call ray_tpu_torch.init() first")
        return self.backend

    # -- task context --------------------------------------------------------
    def current_task_id(self) -> TaskID:
        return self._ctx.task_id or self._driver_task_id

    def current_actor_id(self) -> Optional[ActorID]:
        return self._ctx.actor_id

    def enter_task_context(self, task_id: TaskID, actor_id: Optional[ActorID] = None):
        token = (self._ctx.task_id, self._ctx.put_counter, self._ctx.actor_id)
        self._ctx.task_id = task_id
        self._ctx.put_counter = 0
        self._ctx.actor_id = actor_id
        return token

    def exit_task_context(self, token) -> None:
        self._ctx.task_id, self._ctx.put_counter, self._ctx.actor_id = token

    def next_put_id(self) -> ObjectID:
        with self._put_lock:
            self._ctx.put_counter += 1
            return ObjectID.for_put(self.current_task_id(), self._ctx.put_counter)

    # -- data plane ----------------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("put() of an ObjectRef is not allowed (reference parity)")
        return self._require_backend().put(value)

    def get(self, refs: Union[ObjectRef, Sequence[ObjectRef]],
            timeout: Optional[float] = None) -> Any:
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        for r in ref_list:
            if not isinstance(r, ObjectRef):
                raise TypeError(f"get() expects ObjectRef(s), got {type(r).__name__}")
        values = self._require_backend().get(ref_list, timeout)
        return values[0] if single else values

    async def get_async(self, ref: ObjectRef) -> Any:
        import asyncio

        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._future_pool(), lambda: self.get(ref))

    def as_future(self, ref: ObjectRef):
        return self._future_pool().submit(lambda: self.get(ref))

    def _future_pool(self):
        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(max_workers=8,
                                                thread_name_prefix="rt-get")
        return self._executor

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None
             ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        ref_list = list(refs)
        if len(set(ref_list)) != len(ref_list):
            raise ValueError("wait() got duplicate ObjectRefs")
        if num_returns <= 0 or num_returns > len(ref_list):
            raise ValueError(f"num_returns must be in [1, {len(ref_list)}]")
        return self._require_backend().wait(ref_list, num_returns, timeout)

    # -- control plane -------------------------------------------------------
    def submit_task(self, fn, options: Dict, args: Tuple, kwargs: Dict):
        from ray_tpu_torch.util import tracing

        # phase tracing: stamp the submit entry so the span's ``submit``
        # phase covers arg serialization (no-op predicate when untraced)
        tracing.mark_submit_entry()
        return self._require_backend().submit_task(fn, options, args, kwargs)

    def create_actor(self, cls, options: Dict, args: Tuple, kwargs: Dict,
                     method_meta: Dict[str, int]):
        return self._require_backend().create_actor(cls, options, args, kwargs,
                                                    method_meta)

    def submit_actor_task(self, actor_id: ActorID, method_name: str, args, kwargs,
                          num_returns: int = 1):
        from ray_tpu_torch.util import tracing

        tracing.mark_submit_entry()
        return self._require_backend().submit_actor_task(
            actor_id, method_name, args, kwargs, num_returns)


_global_worker = Worker()


def global_worker() -> Worker:
    return _global_worker


# ---------------------------------------------------------------------------
# Public module-level API (re-exported from ray_tpu_torch/__init__.py)
# ---------------------------------------------------------------------------

def init(address: Optional[str] = None, *,
         local_mode: bool = False,
         num_cpus: Optional[float] = None,
         num_gpus: Optional[float] = None,
         resources: Optional[Dict[str, float]] = None,
         namespace: Optional[str] = None,
         ignore_reinit_error: bool = False,
         _system_config: Optional[Dict] = None) -> "RuntimeInfo":
    """Start (or connect to) a runtime.

    - ``address=None``: start a fresh single-node cluster runtime in this
      process tree (processes for head/raylet/workers), like the reference's
      default ``ray.init()``.
    - ``address="local"`` or ``local_mode=True``: in-process threaded backend.
    - ``address="<host>:<port>"``: connect to an existing head node.
    """
    w = _global_worker
    if w.connected:
        if ignore_reinit_error:
            return RuntimeInfo(w)
        raise RuntimeError("ray_tpu_torch.init() called twice; pass ignore_reinit_error=True")
    if _system_config:
        import ray_tpu_torch._private.config as cfgmod

        cfg = cfgmod.get_config()
        for k, v in _system_config.items():
            setattr(cfg, k, v)
    job_id = JobID.from_random()
    if local_mode or address == "local":
        from ray_tpu_torch.core.local_backend import LocalBackend

        backend = LocalBackend(job_id, num_cpus=num_cpus, num_gpus=num_gpus,
                               resources_override=resources, namespace=namespace)
        w.connect(backend, job_id, "local")
        return RuntimeInfo(w)
    from ray_tpu_torch.cluster.driver_backend import start_or_connect

    backend = start_or_connect(address, job_id, num_cpus=num_cpus,
                               num_gpus=num_gpus, resources=resources,
                               namespace=namespace)
    w.connect(backend, job_id, "driver")
    return RuntimeInfo(w)


def shutdown() -> None:
    _global_worker.disconnect()


def is_initialized() -> bool:
    return _global_worker.connected


class RuntimeInfo:
    """Returned by init(); context-manager support for scoped sessions."""

    def __init__(self, worker: Worker):
        self._worker = worker

    @property
    def address_info(self) -> Dict:
        nodes = self._worker.backend.nodes()
        return nodes[0] if nodes else {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        shutdown()
