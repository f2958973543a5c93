"""In-process runtime backend: threads instead of processes.

The local-mode analog of the reference's ``ray.init(local_mode=True)`` — but
with real concurrency: tasks run on their own threads, actors get dedicated
executors that preserve call ordering (a serial queue thread for
``max_concurrency=1``, a bounded pool for threaded actors, an asyncio loop
for async actors — mirroring the reference's ``ActorSchedulingQueue`` /
``BoundedExecutor`` / ``fiber.h`` trio in ``core_worker/transport/``).

Resource options are validated and *accounted* (cluster/available_resources
reflect them) but do not gate dispatch here — scheduling rigor lives in the
cluster backend's two-level scheduler, which is exercised separately. This
keeps local mode deadlock-free on small machines (a parent task blocked in
``get`` while its child waits for a CPU would otherwise hang).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import accelerator
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID
from ray_tpu_torch.core import resources as res
from ray_tpu_torch.core.actor import ActorHandle
from ray_tpu_torch.core.backend import RuntimeBackend
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.resources import NodeResources, ResourceSet
from ray_tpu_torch.core.task_spec import resources_from_options, validate_options
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    TaskCancelledError,
    TaskError,
)


def _estimate_size(value: Any) -> int:
    """Cheap in-memory footprint estimate (no serialization on the local
    hot path): array buffers dominate real workloads and expose nbytes."""
    import sys

    nbytes = getattr(value, "nbytes", None)
    if isinstance(nbytes, int):
        return nbytes
    if isinstance(value, (bytes, bytearray, memoryview, str)):
        return len(value)
    try:
        return sys.getsizeof(value)
    except TypeError:
        return 0


class _ObjectStore:
    """Sealed-once object table with blocking reads."""

    def __init__(self):
        self._objects: Dict[ObjectID, Any] = {}
        # oid -> {"size": estimate, "t": seal time} for memory_summary()
        self._meta: Dict[ObjectID, Dict[str, float]] = {}
        self._cv = threading.Condition()

    def put(self, oid: ObjectID, value: Any) -> None:
        with self._cv:
            self._objects[oid] = value
            self._meta[oid] = {"size": _estimate_size(value),
                               "t": time.time()}
            self._cv.notify_all()

    def stats(self) -> Dict[str, Any]:
        """Store usage + per-object table for the memory plane."""
        with self._cv:
            objects = [{"oid": oid.hex(), "size": int(m["size"]),
                        "state": "in_memory",
                        "age_s": max(0.0, time.time() - m["t"])}
                       for oid, m in self._meta.items()]
        objects.sort(key=lambda d: -d["size"])
        return {"num_objects": len(objects),
                "used_bytes": sum(o["size"] for o in objects),
                "objects": objects}

    def contains(self, oid: ObjectID) -> bool:
        with self._cv:
            return oid in self._objects

    def get(self, oid: ObjectID, timeout: Optional[float]) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while oid not in self._objects:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise GetTimeoutError(f"get() timed out waiting for {oid}")
                self._cv.wait(remaining)
            return self._objects[oid]

    def wait_any(self, oids: Sequence[ObjectID], num_ready: int,
                 timeout: Optional[float]) -> List[ObjectID]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                ready = [o for o in oids if o in self._objects]
                if len(ready) >= num_ready:
                    return ready[:num_ready] if num_ready < len(ready) else ready
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return ready
                self._cv.wait(remaining)

    def free(self, oids: Sequence[ObjectID]) -> None:
        with self._cv:
            for o in oids:
                self._objects.pop(o, None)
                self._meta.pop(o, None)


class _ActorExecutor:
    """Per-actor execution context preserving submission order."""

    def __init__(self, instance: Any, max_concurrency: int):
        self.instance = instance
        self.dead = False
        self.death_reason = ""
        self._max_concurrency = max_concurrency
        self._is_async = False
        self._loop = None
        self._queue: "queue.Queue[Optional[Callable]]" = queue.Queue()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._thread: Optional[threading.Thread] = None

    def start(self, is_async: bool) -> None:
        self._is_async = is_async
        if is_async:
            import asyncio

            self._loop = asyncio.new_event_loop()
            self._thread = threading.Thread(
                target=self._loop.run_forever, daemon=True, name="rt-async-actor")
            self._thread.start()
        elif self._max_concurrency > 1:
            self._pool = ThreadPoolExecutor(max_workers=self._max_concurrency,
                                            thread_name_prefix="rt-actor")
        else:
            self._thread = threading.Thread(target=self._serial_loop, daemon=True,
                                            name="rt-actor")
            self._thread.start()

    def _serial_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            item()

    def submit(self, thunk: Callable, coroutine_factory=None) -> None:
        if self.dead:
            raise ActorDiedError(reason=self.death_reason)
        if self._is_async and coroutine_factory is not None:
            import asyncio

            asyncio.run_coroutine_threadsafe(coroutine_factory(), self._loop)
        elif self._pool is not None:
            self._pool.submit(thunk)
        else:
            self._queue.put(thunk)

    def stop(self) -> None:
        self.dead = True
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        if self._thread is not None and not self._is_async:
            self._queue.put(None)


class _ActorRecord:
    def __init__(self, actor_id: ActorID, cls: type, name: Optional[str],
                 namespace: str, resources_req: ResourceSet, executor: _ActorExecutor):
        self.actor_id = actor_id
        self.cls = cls
        self.name = name
        self.namespace = namespace
        self.resources = resources_req
        self.executor = executor
        self.method_meta: Dict[str, int] = {}


class LocalBackend(RuntimeBackend):
    def __init__(self, job_id: JobID, num_cpus: Optional[float] = None,
                 num_gpus: Optional[float] = None,
                 resources_override: Optional[Dict[str, float]] = None,
                 namespace: Optional[str] = None):
        total = {
            res.CPU: num_cpus if num_cpus is not None else (os.cpu_count() or 1),
            res.GPU: num_gpus if num_gpus is not None
            else accelerator.autodetect_num_gpus(),
            res.MEMORY: float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")),
        }
        total.update(resources_override or {})
        self._node = NodeResources({k: v for k, v in total.items() if v})
        self._node_id_hex = os.urandom(16).hex()
        self.job_id = job_id
        self.namespace = namespace or "default"
        self._store = _ObjectStore()
        self._actors: Dict[ActorID, _ActorRecord] = {}
        self._named_actors: Dict[Tuple[str, str], ActorID] = {}
        self._lock = threading.Lock()
        self._kv: Dict[str, bytes] = {}
        self._cancelled: set = set()
        self._shutdown = False

    # -- objects -------------------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        from ray_tpu_torch.core.worker import global_worker
        from ray_tpu_torch.core import object_ledger

        oid = global_worker().next_put_id()
        self._store.put(oid, value)
        if object_ledger.enabled():
            object_ledger.get_ledger().record_put(
                oid.hex(), _estimate_size(value), "local", owner="local")
        return ObjectRef(oid)

    def _resolve(self, value: Any) -> Any:
        """Replace top-level ObjectRef args with their values (like the
        reference's LocalDependencyResolver inlining)."""
        if isinstance(value, ObjectRef):
            out = self._store.get(value.id(), None)
            if isinstance(out, TaskError):
                raise out
            return out
        return value

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float]) -> List[Any]:
        from ray_tpu_torch.core import object_ledger

        if object_ledger.enabled():
            ledger = object_ledger.get_ledger()
            for r in refs:
                ledger.record_get(r.hex())
        out = []
        deadline = None if timeout is None else time.monotonic() + timeout
        for r in refs:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            val = self._store.get(r.id(), remaining)
            if isinstance(val, (TaskError, ActorDiedError, TaskCancelledError)):
                raise val
            out.append(val)
        return out

    def wait(self, refs, num_returns, timeout):
        ready_ids = set(self._store.wait_any([r.id() for r in refs], num_returns, timeout))
        ready = [r for r in refs if r.id() in ready_ids]
        not_ready = [r for r in refs if r.id() not in ready_ids]
        return ready, not_ready

    def free_objects(self, refs: Sequence[ObjectRef]) -> None:
        from ray_tpu_torch.core import object_ledger

        self._store.free([r.id() for r in refs])
        if object_ledger.enabled():
            ledger = object_ledger.get_ledger()
            for r in refs:
                ledger.record_freed(r.hex())

    def memory_report(self) -> Dict[str, Any]:
        """The local-mode analog of the raylet's memory_report RPC: one
        synthetic node whose store is the in-process object table."""
        stats = self._store.stats()
        return {"node_id": self._node_id_hex, "address": "local",
                "store": {"used_bytes": stats["used_bytes"],
                          "capacity_bytes": 0,
                          "in_mem_bytes": stats["used_bytes"],
                          "spilled_bytes": 0, "spilled_count": 0,
                          "pinned_count": 0,
                          "num_objects": stats["num_objects"],
                          "spills": 0, "restores": 0,
                          "spill_seconds": 0.0, "restore_seconds": 0.0,
                          "pin_purges": 0, "oom_kills": 0},
                "objects": stats["objects"], "workers": []}

    # -- tasks ---------------------------------------------------------------
    def submit_task(self, fn, options, args, kwargs):
        validate_options(options, for_actor=False)
        req = resources_from_options(options, default_num_cpus=1)
        num_returns = options.get("num_returns", 1)
        task_id = TaskID.for_task(self.job_id)
        if num_returns == "streaming":
            return self._submit_streaming(
                fn, args, kwargs, task_id,
                options.get("_stream_max_buffer", 16))
        refs = [ObjectRef(ObjectID.for_return(task_id, i)) for i in range(num_returns)]

        def run():
            if task_id in self._cancelled:
                self._seal_error(refs, TaskCancelledError(task_id))
                return
            self._execute(fn, args, kwargs, refs, task_id, fn.__name__)

        t = threading.Thread(target=run, daemon=True, name=f"rt-task-{fn.__name__}")
        t.start()
        self._register_resources(req)
        return refs[0] if num_returns == 1 else refs

    def _submit_streaming(self, fn, args, kwargs, task_id, max_buffer: int):
        """Thread-driven ``num_returns="streaming"``: items land in the local
        store as produced; a bounded queue is the backpressure."""
        import queue as _q

        out: _q.Queue = _q.Queue(maxsize=max(1, max_buffer))
        store = self._store
        name = getattr(fn, "__name__", "generator")
        closed = threading.Event()

        def _put(item) -> bool:
            """Bounded put that aborts when the consumer abandoned us."""
            while not closed.is_set():
                try:
                    out.put(item, timeout=0.2)
                    return True
                except _q.Full:
                    continue
            return False

        def run():
            i = 0
            try:
                rargs = [self._resolve(a) for a in args]
                rkwargs = {k: self._resolve(v) for k, v in kwargs.items()}
                for v in fn(*rargs, **rkwargs):
                    ref = ObjectRef(ObjectID.for_return(task_id, i))
                    store.put(ref.id(), v)
                    if not _put(ref):
                        return  # abandoned: stop producing
                    i += 1
            except BaseException as e:  # noqa: BLE001
                err = e if isinstance(e, TaskError) else TaskError(name, e)
                ref = ObjectRef(ObjectID.for_return(task_id, i))
                store.put(ref.id(), err)
                _put(ref)
            _put(None)

        threading.Thread(target=run, daemon=True,
                         name=f"rt-stream-{name}").start()

        class _LocalRefGenerator:
            def __iter__(self):
                return self

            def __next__(self):
                if closed.is_set():
                    raise StopIteration
                ref = out.get()
                if ref is None:
                    raise StopIteration
                return ref

            def close(self):
                closed.set()

            def __del__(self):
                closed.set()

        return _LocalRefGenerator()

    def _register_resources(self, req: ResourceSet) -> None:
        # Accounting only (see module docstring); release is immediate.
        pass

    def _seal_error(self, refs: List[ObjectRef], err: Exception) -> None:
        for r in refs:
            self._store.put(r.id(), err)

    def _execute(self, fn, args, kwargs, refs, task_id, name):
        from ray_tpu_torch.core.worker import global_worker

        worker = global_worker()
        token = worker.enter_task_context(task_id)
        try:
            rargs = [self._resolve(a) for a in args]
            rkwargs = {k: self._resolve(v) for k, v in kwargs.items()}
            result = fn(*rargs, **rkwargs)
            self._seal_returns(refs, result)
        except TaskError as e:
            self._seal_error(refs, e)
        except BaseException as e:  # noqa: BLE001 — must seal something
            self._seal_error(refs, TaskError(name, e))
        finally:
            worker.exit_task_context(token)

    def _seal_returns(self, refs: List[ObjectRef], result: Any) -> None:
        if len(refs) == 1:
            self._store.put(refs[0].id(), result)
        else:
            vals = list(result) if result is not None else [None] * len(refs)
            if len(vals) != len(refs):
                err = TaskError("<returns>", ValueError(
                    f"expected {len(refs)} return values, got {len(vals)}"))
                self._seal_error(refs, err)
                return
            for r, v in zip(refs, vals):
                self._store.put(r.id(), v)

    # -- actors --------------------------------------------------------------
    def create_actor(self, cls, options, args, kwargs, method_meta):
        validate_options(options, for_actor=True)
        name = options.get("name")
        ns = options.get("namespace") or self.namespace
        req = resources_from_options(options, default_num_cpus=0)
        actor_id = ActorID.of(self.job_id)
        max_conc = options.get("max_concurrency") or 1
        executor = _ActorExecutor(None, max_conc)
        rec = _ActorRecord(actor_id, cls, name, ns, req, executor)
        rec.method_meta = method_meta
        # the name is checked and claimed in one step, and the record is
        # published only once its executor runs with __init__ queued
        # first: a thread that finds the actor by name (get_if_exists)
        # can call it at once
        with self._lock:
            if name is not None and (ns, name) in self._named_actors:
                if options.get("get_if_exists"):
                    aid = self._named_actors[(ns, name)]
                    rec = self._actors[aid]
                    return ActorHandle(aid, cls.__name__, rec.method_meta)
                raise ValueError(f"actor name {name!r} already taken in namespace {ns!r}")
            self._start_actor(rec, cls, args, kwargs)
            self._actors[actor_id] = rec
            if name is not None:
                self._named_actors[(ns, name)] = actor_id
        self._node.allocate(req) if self._node.can_fit(req) else None
        return ActorHandle(actor_id, cls.__name__, method_meta, original_handle=True)

    def _start_actor(self, rec, cls, args, kwargs) -> None:
        """Start ``rec``'s executor with the instance's __init__ queued."""
        executor = rec.executor

        import inspect

        is_async = any(
            inspect.iscoroutinefunction(m) for _, m in
            inspect.getmembers(cls, predicate=inspect.isfunction))
        init_done = threading.Event()
        init_error: List[BaseException] = []

        def do_init():
            try:
                rargs = [self._resolve(a) for a in args]
                rkwargs = {k: self._resolve(v) for k, v in kwargs.items()}
                executor.instance = cls(*rargs, **rkwargs)
            except BaseException as e:  # noqa: BLE001
                init_error.append(e)
                executor.dead = True
                executor.death_reason = f"__init__ failed: {e!r}"
            finally:
                init_done.set()

        executor.start(is_async)
        if is_async:
            import asyncio

            async def _ainit():
                do_init()

            asyncio.run_coroutine_threadsafe(_ainit(), executor._loop)
        else:
            executor.submit(do_init)

    def submit_actor_task(self, actor_id, method_name, args, kwargs, num_returns):
        with self._lock:
            rec = self._actors.get(actor_id)
        if rec is None:
            raise ActorDiedError(actor_id, "unknown actor")
        task_id = TaskID.for_actor_task(actor_id)
        refs = [ObjectRef(ObjectID.for_return(task_id, i)) for i in range(num_returns)]
        executor = rec.executor
        if executor.dead:
            self._seal_error(refs, ActorDiedError(actor_id, executor.death_reason))
            return refs[0] if num_returns == 1 else refs

        import inspect

        raw_method = getattr(rec.cls, method_name, None)
        is_coro = inspect.iscoroutinefunction(raw_method)

        def thunk():
            if executor.dead or executor.instance is None and executor.dead:
                self._seal_error(refs, ActorDiedError(actor_id, executor.death_reason))
                return
            bound = getattr(executor.instance, method_name)
            self._execute(bound, args, kwargs, refs, task_id,
                          f"{rec.cls.__name__}.{method_name}")

        async def coro():
            from ray_tpu_torch.core.worker import global_worker

            worker = global_worker()
            token = worker.enter_task_context(task_id)
            try:
                bound = getattr(executor.instance, method_name)
                rargs = [self._resolve(a) for a in args]
                rkwargs = {k: self._resolve(v) for k, v in kwargs.items()}
                result = await bound(*rargs, **rkwargs)
                self._seal_returns(refs, result)
            # rt: lint-allow(except-discipline) error transport: sealing
            # the error IS the unwind path — getters would hang forever
            # on an unsealed ref (see _seal_error's "must seal something")
            except BaseException as e:  # noqa: BLE001
                self._seal_error(refs, TaskError(method_name, e))
            finally:
                worker.exit_task_context(token)

        try:
            executor.submit(thunk, coroutine_factory=coro if is_coro else None)
        except ActorDiedError as e:
            self._seal_error(refs, e)
        return refs[0] if num_returns == 1 else refs

    def kill_actor(self, actor_id, no_restart=True):
        with self._lock:
            rec = self._actors.get(actor_id)
            if rec is None:
                return
            rec.executor.death_reason = "killed via kill()"
            rec.executor.stop()
            if rec.name is not None:
                self._named_actors.pop((rec.namespace, rec.name), None)
        self._node.release(rec.resources)

    def get_actor_handle(self, name, namespace):
        ns = namespace or self.namespace
        with self._lock:
            aid = self._named_actors.get((ns, name))
            if aid is None:
                raise ValueError(f"no actor named {name!r} in namespace {ns!r}")
            rec = self._actors[aid]
            return ActorHandle(aid, rec.cls.__name__, rec.method_meta)

    # -- misc ----------------------------------------------------------------
    def cancel(self, ref, force=False):
        self._cancelled.add(ref.id().task_id())

    def cluster_resources(self):
        return self._node.total.to_dict()

    def available_resources(self):
        return self._node.available.to_dict()

    def nodes(self):
        return [{
            "node_id": self._node_id_hex,
            "alive": True,
            "resources": self._node.total.to_dict(),
            "labels": dict(self._node.labels),
            "address": "local",
        }]

    def kv_put(self, key, value):
        with self._lock:
            self._kv[key] = value

    def kv_get(self, key):
        with self._lock:
            return self._kv.get(key)

    def kv_del(self, key):
        with self._lock:
            self._kv.pop(key, None)

    def kv_keys(self, prefix):
        with self._lock:
            return [k for k in self._kv if k.startswith(prefix)]

    def shutdown(self):
        if self._shutdown:
            return
        self._shutdown = True
        with self._lock:
            actors = list(self._actors.values())
        for rec in actors:
            rec.executor.stop()
        self._actors.clear()
        self._named_actors.clear()
