"""Worker process entry: task execution loop + actor hosting.

Reference analog: ``python/ray/_private/workers/default_worker.py`` plus the
execution side of the core worker (``execute_task`` in ``_raylet.pyx:1444``,
``CoreWorkerDirectTaskReceiver`` and the actor scheduling queues). A worker:
  - builds its own ClusterBackend so user code can call ``ray_tpu_torch.*``;
  - serves ``push_task`` (normal tasks, one at a time — the raylet gates
    concurrency by resources);
  - serves ``create_actor``/``actor_call`` with arrival-ordered execution and
    ``max_concurrency`` consumers (sync methods on threads, async methods as
    coroutines — the reference's three queue flavors);
  - exits when its raylet connection drops.
"""

from __future__ import annotations

import asyncio
import inspect
import os
import sys
import threading
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID
from ray_tpu_torch.cluster import stream as rt_stream
from ray_tpu_torch.cluster.rpc import RpcClient
from ray_tpu_torch.cluster.worker_core import ClusterBackend
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.exceptions import TaskError
from ray_tpu_torch.util import chaos as C


class _GenStreamPump:
    """Producer pump for the streaming-generator push path: the task
    executor thread feeds ``(index, payload|None)`` items, the
    cluster/stream.py push binding drains them on the io loop (the
    ``async take`` pump protocol). Bounded so the generator cannot run
    arbitrarily far ahead of the credit window."""

    def __init__(self, loop, maxsize: int):
        self._loop = loop
        self._cond = threading.Condition()
        self._items: deque = deque()  # rt: guarded-by(_cond)
        self._done = False  # rt: guarded-by(_cond)
        self._stopped = False  # rt: guarded-by(_cond)
        self._maxsize = max(1, maxsize)
        self._avail = asyncio.Event()  # loop-affine

    # -- task thread side --------------------------------------------------
    def feed(self, item: Tuple) -> bool:
        """Block while full; False once the binding detached (broken
        channel / consumer stop) — the caller reverts to the acked path."""
        with self._cond:
            while len(self._items) >= self._maxsize and not self._stopped:
                self._cond.wait(0.2)
            if self._stopped:
                return False
            self._items.append(item)
        self._wake()
        return True

    def feed_done(self) -> None:
        with self._cond:
            self._done = True
        self._wake()

    def drain_unsent(self) -> List[Tuple]:
        """Items fed but never taken by the binding (fallback prologue)."""
        with self._cond:
            out = list(self._items)
            self._items.clear()
            return out

    @property
    def stopped(self) -> bool:
        with self._cond:
            return self._stopped

    # -- binding side ------------------------------------------------------
    def binding_stopped(self) -> None:
        """Called by the push binding when it detaches (any thread)."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._wake()

    def close(self) -> None:
        self.binding_stopped()

    def _wake(self) -> None:
        try:
            self._loop.call_soon_threadsafe(self._avail.set)
        except RuntimeError:
            pass  # loop closed at teardown

    async def take(self, max_items: int) -> Tuple[List[Any], bool]:
        while True:
            with self._cond:
                if self._items:
                    out = []
                    while self._items and len(out) < max_items:
                        out.append(self._items.popleft())
                    done = self._done and not self._items
                    self._cond.notify_all()
                    return out, done
                if self._done:
                    return [], True
                if self._stopped:
                    # binding is detaching: hand control back so its
                    # pump loop can observe _stop and finish
                    return [], False
                self._avail.clear()
            await self._avail.wait()


class _GenStreamPusher:
    """Push-transport driver for one streaming-generator task: registers
    the source, announces it to the owner (``stream_begin`` — the owner
    subscribes back over its pooled connection), and feeds items through
    the pump. On ANY detachment the worker resends the unacked tail over
    the legacy acked ``stream_item`` path — redelivery is idempotent
    (the owner stores items by index), so the stream is token-exact
    through the fallback."""

    def __init__(self, backend, task_id_hex: str, owner: str):
        self.backend = backend
        self.sid = f"g:{task_id_hex}"
        self.task_id_hex = task_id_hex
        self.owner = owner
        self.pump: Optional[_GenStreamPump] = None

    def begin(self) -> bool:
        # provisional pump: resized to the owner's window on acceptance
        self.pump = _GenStreamPump(self.backend.loop,
                                   rt_stream.stream_window() // 4)
        rt_stream.register_source(self.sid, self.pump)
        try:
            reply = self.backend.io.run(self._announce(), timeout=30.0)
        except Exception:  # noqa: BLE001 — owner unreachable: acked path
            reply = None
        if not (reply and reply.get("push")):
            rt_stream.unregister_source(self.sid)
            return False
        # producer-side lag bound: pump buffer rides ON TOP of the
        # credit window, so keep it a fraction of it
        self.pump._maxsize = max(1, int(reply.get("window") or 16) // 4)
        return True

    async def _announce(self):
        client = await self.backend._pool.get(self.owner)
        return await client.call(
            "stream_begin",
            {"task_id": self.task_id_hex, "sid": self.sid,
             "address": self.backend.server.address})

    @property
    def active(self) -> bool:
        return self.pump is not None and not self.pump.stopped

    def feed(self, index: int, payload: Optional[bytes]) -> bool:
        return self.pump.feed((index, payload))

    def settle(self, finish: bool) -> Optional[List[Tuple]]:
        """Settle the push stream: ``finish=True`` feeds the done marker
        first (generator exhausted/raised). Returns None when the stream
        completed over push (every item acked), else the (index,
        payload) tail to redeliver over the acked path — pushed-but-
        unacked replay plus anything still parked in the pump."""
        if finish:
            self.pump.feed_done()
        else:
            self.pump.binding_stopped()
        try:
            tail = self.backend.io.run(
                rt_stream.settle_source(self.sid), timeout=90.0)
        except Exception:  # noqa: BLE001 — loop wedged: we cannot learn
            # what was acked, so resend everything still replayable (racy
            # off-loop snapshot; over-delivery is idempotent by index,
            # dropping pushed-but-unacked items would hole the stream)
            tail = rt_stream.peek_unacked(self.sid)
            rt_stream.unregister_source(self.sid)
        if tail is None:
            return None
        pending = {idx: pl for idx, pl in tail}
        for idx, pl in self.pump.drain_unsent():
            pending[idx] = pl
        return sorted(pending.items())


class WorkerProcess:
    def __init__(self):
        self.worker_id = os.environ["RT_WORKER_ID"]
        self.backend = ClusterBackend(
            gcs_address=os.environ["RT_GCS_ADDR"],
            raylet_address=os.environ["RT_RAYLET_ADDR"],
            node_id=os.environ["RT_NODE_ID"],
            session_name=os.environ["RT_SESSION_NAME"],
            job_id=JobID.from_int(0),
            role="worker")
        self._task_pool = ThreadPoolExecutor(max_workers=1,
                                             thread_name_prefix="rt-exec")
        # Actor state
        self._actor_instance: Any = None
        self._actor_id: Optional[str] = None
        self._actor_queues: Dict[str, asyncio.Queue] = {}
        self._actor_threads: Optional[ThreadPoolExecutor] = None
        # client-side failure-emission rate limit (see _failure_event)
        from ray_tpu_torch.core.failure import EmitLimiter

        self._failure_limiter = EmitLimiter(cap=256)

    def start(self) -> None:
        from ray_tpu_torch.core.worker import global_worker

        self.backend.connect()
        self._materialize_runtime_env()
        srv = self.backend.server
        srv.register("push_task", self.rpc_push_task)
        srv.register("create_actor", self.rpc_create_actor)
        srv.register("actor_call", self.rpc_actor_call)
        srv.register("exit", self.rpc_exit)
        srv.register("dump_stacks", self.rpc_dump_stacks)
        srv.register("chaos_arm", self.rpc_chaos_arm)
        global_worker().connect(self.backend, self.backend.job_id, "worker")
        self.backend.io.run(self.backend._raylet.call("worker_ready", {
            "worker_id": self.worker_id,
            "address": self.backend.server.address}))
        # Exit when the raylet goes away.
        self.backend.io.spawn(self._watch_raylet())

    def _materialize_runtime_env(self) -> None:
        """Make the assigned runtime env live BEFORE user code can run
        (reference: the runtime-env agent prepares, ``context.py`` applies;
        here the keyed-by-env worker does both at startup)."""
        wire_json = os.environ.get("RT_RUNTIME_ENV_JSON")
        if not wire_json:
            return
        import json

        from ray_tpu_torch.runtime_env import materialize

        wire = json.loads(wire_json)
        cache_root = os.path.join(get_config().session_dir_root,
                                  os.environ["RT_SESSION_NAME"],
                                  "runtime_env")
        materialize(wire, self.backend.kv_get, cache_root)

    async def _watch_raylet(self) -> None:
        while True:
            await asyncio.sleep(1.0)
            if self.backend._raylet._closed:
                os._exit(0)
            # buffered rpc.* chaos fires ship from the watch loop (the
            # rpc layer itself has no GCS handle)
            self.backend._drain_chaos_events()

    async def rpc_chaos_arm(self, p):
        """Live (re)arming from this worker's raylet when `rt chaos` ships
        a new plan revision (new workers arm from RT_CHAOS_PLAN_JSON)."""
        try:
            if p.get("plan"):
                C.arm(p["plan"], rev=p.get("rev", 0))
            else:
                C.disarm()
            return {"ok": True}
        except (ValueError, TypeError) as e:
            return {"ok": False, "error": str(e)}

    def _chaos_kill_payload(self, target, task_id, fault):
        return C.event_payload(
            "worker.kill", fault, node_id=os.environ.get("RT_NODE_ID"),
            worker_id=self.worker_id, task_id=task_id, name=target)

    def _maybe_chaos_kill(self, target: Optional[str],
                          task_id: Optional[str]) -> None:
        """worker.kill injection site (task-executor thread): die
        mid-execution like a real crash (``os._exit(137)``), after
        synchronously stamping the chaos-origin event (a fire-and-forget
        would die with the process)."""
        f = C.maybe_fire("worker.kill", target=target)
        if f is None:
            return
        try:
            self.backend.io.run(self.backend._gcs.call(
                "failure_event",
                self._chaos_kill_payload(target, task_id, f)), timeout=5.0)
        except Exception:  # noqa: BLE001 — the kill still happens
            pass
        os._exit(137)

    async def _maybe_chaos_kill_async(self, target: Optional[str],
                                      task_id: Optional[str]) -> None:
        """Event-loop twin of :meth:`_maybe_chaos_kill` (actor methods run
        their dispatch on the io loop, where a blocking io.run would
        deadlock)."""
        f = C.maybe_fire("worker.kill", target=target)
        if f is None:
            return
        try:
            await asyncio.wait_for(self.backend._gcs.call(
                "failure_event",
                self._chaos_kill_payload(target, task_id, f)), 5.0)
        except Exception:  # noqa: BLE001 — the kill still happens
            pass
        os._exit(137)

    async def rpc_exit(self, p):
        asyncio.get_running_loop().call_later(0.1, os._exit, 0)
        return {"ok": True}

    async def rpc_dump_stacks(self, p):
        """Live stack snapshot of every thread (the py-spy-equivalent
        surface; see ``util/profiling.py``). Runs on the event loop — it
        responds even while user tasks block executor threads."""
        from ray_tpu_torch.util.profiling import format_current_stacks

        return {"pid": os.getpid(), "stacks": format_current_stacks()}

    def _failure_event(self, message: str, **fields) -> None:
        """Stamp a task-error FailureEvent on the GCS feed (the executing
        worker is the only process that always sees a user exception — the
        caller may never ``get`` the ref). Rate-limited per failing
        function/method via the shared EmitLimiter: a map over bad input
        failing thousands of tasks per second must not stream one GCS RPC
        per execution (the GCS dedups rows, not RPCs)."""
        from ray_tpu_torch.core import failure as F

        if not self._failure_limiter.allow(fields.get("name") or message):
            return
        F.emit(self.backend.io.spawn, self.backend._gcs, F.TASK_ERROR,
               message, node_id=os.environ.get("RT_NODE_ID"),
               worker_id=self.worker_id, **fields)

    # ---- argument / return marshalling -------------------------------------
    def _resolve_args(self, wire_args: List[Tuple], wire_kwargs: Dict[str, Tuple]):
        """Deserialize inline values and fetch refs (dependency resolution)."""
        refs: List[ObjectRef] = []
        slots: List[Tuple[str, Any]] = []

        def scan(item):
            kind, data = item
            if kind == "ref":
                ref = ObjectRef._rehydrate(data)
                refs.append(ref)
                return ("ref", len(refs) - 1)
            return ("val", self.backend.serde.deserialize_payload(memoryview(data)))

        arg_slots = [scan(a) for a in wire_args]
        kwarg_slots = {k: scan(v) for k, v in wire_kwargs.items()}
        values = self.backend.get(refs, timeout=None) if refs else []

        def fill(slot):
            kind, v = slot
            return values[v] if kind == "ref" else v

        return [fill(s) for s in arg_slots], {k: fill(s) for k, s in kwarg_slots.items()}

    def _pack_returns(self, result: Any, task_id: TaskID, num_returns: int):
        if num_returns == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != num_returns:
                raise ValueError(
                    f"expected {num_returns} return values, got {len(values)}")
        out = []
        small_limit = get_config().max_direct_call_object_size
        for i, v in enumerate(values):
            payload = self.backend.serde.serialize(v).to_bytes()
            if len(payload) > small_limit:
                oid = ObjectID.for_return(task_id, i)
                self.backend.plasma.write_whole(oid, payload)
                self.backend.io.run(self.backend._raylet.call(
                    "seal_object", {"oid": oid.hex(), "size": len(payload)}))
                out.append(("plasma", len(payload)))
            else:
                out.append(("val", payload))
        return out

    def _error_returns(self, err: BaseException, num_returns: int):
        payload = self.backend.serde.serialize(err).to_bytes()
        return [("val", payload)] * num_returns

    # ---- normal tasks -------------------------------------------------------
    async def rpc_push_task(self, p):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._task_pool,
                                          self._execute_task_sync, p)

    def _execute_task_sync(self, p) -> Dict:
        import time as _time

        from ray_tpu_torch.core.worker import global_worker

        self._maybe_chaos_kill(p.get("fn_name"), p.get("task_id"))
        task_id = TaskID.from_hex(p["task_id"])
        self.backend.job_id = JobID.from_hex(p["job_id"])
        worker = global_worker()
        worker.job_id = self.backend.job_id
        token = worker.enter_task_context(task_id)
        self.backend._current_task_id = p["task_id"]
        streaming = p["num_returns"] == "streaming"
        from ray_tpu_torch.util import tracing

        traced = p.get("trace") is not None  # phase stamps ride the span
        trace_token = tracing.activate(p.get("trace"))
        t0 = t1 = t2 = 0.0

        def _failure_phases() -> Dict[str, float]:
            # best-effort phases for a raised task: whatever stamps exist
            # (a missing breakdown would make the raylet book the whole
            # execution as "transfer" and misdirect the investigation)
            now = _time.perf_counter()
            wp = {"arg_fetch": (t1 or now) - t0}
            if t1:
                wp["execute"] = (t2 or now) - t1
            return wp

        try:
            t0 = _time.perf_counter() if traced else 0.0
            fn = self.backend.load_function(p["fn_id"])
            args, kwargs = self._resolve_args(p["args"], p["kwargs"])
            t1 = _time.perf_counter() if traced else 0.0
            result = fn(*args, **kwargs)
            t2 = _time.perf_counter() if traced else 0.0
            if streaming:
                reply = self._stream_results(result, task_id, p)
                if traced:
                    # execute covers driving the generator (production +
                    # per-item pushes); items store as they stream, so
                    # there is no separate result_store phase
                    reply["worker_phases"] = {
                        "arg_fetch": t1 - t0,
                        "execute": _time.perf_counter() - t2}
                return reply
            returns = self._pack_returns(result, task_id, p["num_returns"])
            reply = {"returns": returns}
            if traced:
                reply["worker_phases"] = {
                    "arg_fetch": t1 - t0, "execute": t2 - t1,
                    "result_store": _time.perf_counter() - t2}
            return reply
        except TaskError as e:
            # a TaskError here is PROPAGATION (a dependency's failure
            # re-raised while fetching args / inside user code) — its
            # origin worker already emitted the task_error event; emitting
            # again would attribute one upstream error to every
            # downstream consumer
            if streaming:
                reply = {"streaming_done": 0,
                         "stream_error": self.backend.serde.serialize(e).to_bytes()}
            else:
                reply = {"returns": self._error_returns(e, p["num_returns"])}
            if traced:
                reply["worker_phases"] = _failure_phases()
            return reply
        except BaseException as e:  # noqa: BLE001
            traceback.print_exc()
            self._failure_event(f"{type(e).__name__}: {e}",
                                task_id=p["task_id"], name=p["fn_name"])
            err = TaskError(p["fn_name"], e)
            if streaming:
                reply = {"streaming_done": 0,
                         "stream_error": self.backend.serde.serialize(err).to_bytes()}
            else:
                reply = {"returns": self._error_returns(err, p["num_returns"])}
            if traced:
                reply["worker_phases"] = _failure_phases()
            return reply
        finally:
            tracing.deactivate(trace_token)
            self.backend._current_task_id = None
            worker.exit_task_context(token)

    def _stream_results(self, result, task_id: TaskID, p) -> Dict:
        """Drive a generator task. Default transport is PUSH
        (cluster/stream.py): one
        ``stream_begin`` handshake binds the owner to this worker's
        stream source, then every item rides a one-way credit-windowed
        frame — O(1) RPCs per stream instead of one acked ``stream_item``
        RPC per item. The acked per-item path (reference: item reporting
        ``_raylet.pyx:1090``) remains: primary when push is off / the
        owner declines (tiny ``_stream_max_buffer`` bounds want per-item
        acks), and the FALLBACK when a push channel breaks — the unacked
        tail is redelivered through it by index, so the stream stays
        token-exact across the switch. Small items ride the frame/RPC;
        large go to plasma with only the index notification inline."""
        it = iter(result)
        small_limit = get_config().max_direct_call_object_size
        owner = p["owner"]
        pusher: Optional[_GenStreamPusher] = None
        if rt_stream.push_enabled():
            pusher = _GenStreamPusher(self.backend, p["task_id"], owner)
            if not pusher.begin():
                pusher = None

        async def _send(msg):
            client = await self.backend._pool.get(owner)
            return await client.call("stream_item", msg)

        def _legacy_send(index: int, payload: Optional[bytes]) -> Dict:
            msg = {"task_id": p["task_id"], "index": index}
            if payload is not None:
                msg["payload"] = payload
            return self.backend.io.run(_send(msg))

        def _settle_push(finish: bool) -> bool:
            """Settle/fall back; returns False when the owner is gone."""
            nonlocal pusher
            tail = pusher.settle(finish)
            pusher = None
            for idx, pl in tail or ():
                if _legacy_send(idx, pl).get("gone"):
                    return False
            return True

        i = 0
        while True:
            try:
                v = next(it)
            except StopIteration:
                if pusher is not None:
                    _settle_push(finish=True)
                return {"streaming_done": i}
            # rt: lint-allow(except-discipline) error transport: the
            # user generator's failure ships to the owner as stream_error
            except BaseException as e:  # noqa: BLE001
                traceback.print_exc()
                if not isinstance(e, TaskError):  # origin only
                    self._failure_event(
                        f"{type(e).__name__}: {e}", task_id=p["task_id"],
                        name=p["fn_name"])
                err = TaskError(p["fn_name"], e)
                if pusher is not None:
                    # the error lands at index `produced` on the owner:
                    # every pushed item must be delivered BEFORE the
                    # reply carries the error, or it would overwrite a
                    # lost item's slot
                    _settle_push(finish=True)
                return {"streaming_done": i,
                        "stream_error": self.backend.serde.serialize(err).to_bytes()}
            payload = self.backend.serde.serialize(v).to_bytes()
            inline: Optional[bytes] = None
            if len(payload) > small_limit:
                oid = ObjectID.for_return(task_id, i)
                self.backend.plasma.write_whole(oid, payload)
                self.backend.io.run(self.backend._raylet.call(
                    "seal_object", {"oid": oid.hex(), "size": len(payload)}))
            else:
                inline = payload
            if pusher is not None:
                if pusher.feed(i, inline):
                    i += 1
                    continue
                # binding detached (broken channel / consumer stop):
                # redeliver the unacked tail and continue on acks
                if not _settle_push(finish=False):
                    return {"streaming_done": i}
            ack = _legacy_send(i, inline)
            if ack.get("gone"):
                return {"streaming_done": i}  # consumer went away: stop
            i += 1

    # ---- actors -------------------------------------------------------------
    async def rpc_create_actor(self, p):
        spec = p["spec"]
        loop = asyncio.get_running_loop()
        self._actor_id = spec["actor_id"]
        max_conc = spec.get("max_concurrency", 1)
        # Concurrency groups (reference: ConcurrencyGroupManager,
        # ``concurrency_group_manager.h``): each named group gets its own
        # arrival-ordered queue + consumer pool, so a saturated "compute"
        # group can't starve "io" methods. The default group runs
        # max_concurrency consumers; method->group routing is read off the
        # loaded class (``@ray_tpu_torch.method(concurrency_group=...)``).
        groups = dict(spec.get("concurrency_groups") or {})
        for name, n in groups.items():
            if not isinstance(n, int) or n < 1:
                return {"ok": False,
                        "error": f"concurrency_groups[{name!r}] must be a "
                                 f"positive int, got {n!r}"}
        # "_default" may be user-sized (the documented spelling for sizing
        # the default pool); otherwise it runs max_concurrency consumers
        groups.setdefault("_default", max_conc)
        self._actor_queues = {g: asyncio.Queue() for g in groups}
        self._method_groups: Dict[str, str] = {}
        total_threads = sum(groups.values())
        self._actor_threads = ThreadPoolExecutor(
            max_workers=max(1, total_threads), thread_name_prefix="rt-actor")
        from ray_tpu_torch.cluster.rpc import spawn_task

        # strong refs: a GC'd consumer would strand queued calls forever
        self._consumer_tasks = [
            spawn_task(self._actor_consumer(self._actor_queues[g]))
            for g, n in groups.items() for _ in range(n)]

        def build():
            from ray_tpu_torch.core.worker import global_worker

            self.backend.job_id = JobID.from_hex(spec["job_id"])
            global_worker().job_id = self.backend.job_id
            cls = self.backend.load_function(spec["class_id"])
            args, kwargs = self._resolve_args(spec["args"], spec["kwargs"])
            return cls(*args, **kwargs)

        try:
            self._actor_instance = await loop.run_in_executor(
                self._actor_threads, build)
            return {"ok": True, "address": self.backend.server.address}
        # rt: lint-allow(except-discipline) error transport: __init__
        # failure crosses the wire as the create-actor reply
        except BaseException as e:  # noqa: BLE001
            traceback.print_exc()
            return {"ok": False, "error": f"__init__ failed: {e!r}"}

    async def _actor_consumer(self, q: asyncio.Queue) -> None:
        while True:
            coro, fut = await q.get()
            try:
                result = await coro
                if not fut.done():
                    fut.set_result(result)
            except asyncio.CancelledError:
                # teardown cancelling the consumer mid-method: fail the
                # waiter, then RE-RAISE — swallowing would leave this loop
                # immortal with cancellation recorded as a method error
                if not fut.done():
                    fut.cancel()
                raise
            except BaseException as e:  # noqa: BLE001
                if not fut.done():
                    fut.set_exception(e)

    def _queue_for(self, method_name: str) -> asyncio.Queue:
        group = self._method_groups.get(method_name)
        if group is None:
            fn = getattr(type(self._actor_instance), method_name, None)
            group = getattr(fn, "_concurrency_group", "_default")
            if group not in self._actor_queues:
                # loud: a typo'd group would silently lose the isolation
                # the user configured (reference errors at submission too)
                raise ValueError(
                    f"method {method_name!r} names concurrency group "
                    f"{group!r}, but the actor declared "
                    f"{sorted(g for g in self._actor_queues if g != '_default')}")
            self._method_groups[method_name] = group
        return self._actor_queues[group]

    async def rpc_actor_call(self, p):
        import time as _time

        loop = asyncio.get_running_loop()
        if p.get("trace") is not None:  # phase tracing: queue-wait stamp
            p["_t_enq"] = _time.perf_counter()
        fut = loop.create_future()
        await self._queue_for(p["method"]).put(
            (self._run_actor_method(p), fut))
        return await fut

    async def _run_actor_method(self, p) -> Dict:
        loop = asyncio.get_running_loop()
        task_id = TaskID.from_hex(p["task_id"])
        method_name = p["method"]
        await self._maybe_chaos_kill_async(method_name, p.get("task_id"))
        method = getattr(self._actor_instance, method_name, None)
        if method is None:
            err = TaskError(method_name, AttributeError(
                f"actor has no method {method_name!r}"))
            return {"returns": self._error_returns(err, p["num_returns"])}
        if inspect.iscoroutinefunction(method):
            import time as _time

            from ray_tpu_torch.util import tracing

            traced = p.get("trace") is not None
            trace_token = tracing.activate(p.get("trace"))
            if traced:
                self._emit_span_event(p, "RUNNING")
            try:
                t0 = _time.perf_counter() if traced else 0.0
                args, kwargs = await loop.run_in_executor(
                    self._actor_threads, self._resolve_args, p["args"], p["kwargs"])
                t1 = _time.perf_counter() if traced else 0.0
                result = await method(*args, **kwargs)
                t2 = _time.perf_counter() if traced else 0.0
                returns = await loop.run_in_executor(
                    self._actor_threads, self._pack_returns, result, task_id,
                    p["num_returns"])
                reply = {"returns": returns}
                if traced:
                    reply["worker_phases"] = self._actor_phases(
                        p, t0, t1, t2, _time.perf_counter())
                    self._emit_span_event(p, "FINISHED",
                                          phases=reply["worker_phases"])
                return reply
            # rt: lint-allow(except-discipline) error transport: the
            # reply IS the unwind path — re-raising would strand the
            # owner's future until connection loss
            except BaseException as e:  # noqa: BLE001
                if traced:
                    self._emit_span_event(p, "FAILED")
                if not isinstance(e, TaskError):  # origin only, not
                    self._failure_event(          # propagated upstream errors
                        f"{type(e).__name__}: {e}", task_id=p["task_id"],
                        actor_id=p.get("actor_id"), name=method_name)
                return {"returns": self._error_returns(
                    TaskError(method_name, e), p["num_returns"])}
            finally:
                tracing.deactivate(trace_token)
        return await loop.run_in_executor(
            self._actor_threads, self._execute_actor_method_sync, p, method, task_id)

    def _execute_actor_method_sync(self, p, method, task_id: TaskID) -> Dict:
        import time as _time

        from ray_tpu_torch.core.worker import global_worker

        from ray_tpu_torch.util import tracing

        worker = global_worker()
        token = worker.enter_task_context(
            task_id, ActorID.from_hex(p["actor_id"]))
        traced = p.get("trace") is not None
        trace_token = tracing.activate(p.get("trace"))
        if traced:
            self._emit_span_event(p, "RUNNING")
        try:
            t0 = _time.perf_counter() if traced else 0.0
            args, kwargs = self._resolve_args(p["args"], p["kwargs"])
            t1 = _time.perf_counter() if traced else 0.0
            result = method(*args, **kwargs)
            t2 = _time.perf_counter() if traced else 0.0
            reply = {"returns": self._pack_returns(result, task_id,
                                                   p["num_returns"])}
            if traced:
                reply["worker_phases"] = self._actor_phases(
                    p, t0, t1, t2, _time.perf_counter())
                self._emit_span_event(p, "FINISHED",
                                      phases=reply["worker_phases"])
            return reply
        except BaseException as e:  # noqa: BLE001
            traceback.print_exc()
            if traced:
                self._emit_span_event(p, "FAILED")
            if not isinstance(e, TaskError):  # origin only, not
                self._failure_event(          # propagated upstream errors
                    f"{type(e).__name__}: {e}", task_id=p["task_id"],
                    actor_id=p.get("actor_id"), name=p["method"])
            return {"returns": self._error_returns(
                TaskError(p["method"], e), p["num_returns"])}
        finally:
            tracing.deactivate(trace_token)
            worker.exit_task_context(token)

    @staticmethod
    def _actor_phases(p, t0: float, t1: float, t2: float,
                      t3: float) -> Dict[str, float]:
        """Actor-call phase partition: actor calls bypass the raylet, so
        queue_wait here is the actor's own concurrency-group queue (stamped
        at rpc_actor_call enqueue)."""
        phases = {"arg_fetch": t1 - t0, "execute": t2 - t1,
                  "result_store": t3 - t2}
        t_enq = p.get("_t_enq")
        if t_enq is not None:
            phases["queue_wait"] = max(0.0, t0 - t_enq)
        return phases

    def _emit_span_event(self, p, state: str,
                         phases: Optional[Dict] = None) -> None:
        """Actor-call spans: actor calls bypass the raylet (direct
        worker->worker), so the executing worker reports the task event the
        raylet would have (tracing + timeline coverage for actor methods);
        ``phases`` carries the per-phase breakdown on FINISHED."""
        async def _send():
            try:
                msg = {
                    "task_id": p["task_id"],
                    "name": f"{type(self._actor_instance).__name__}."
                            f"{p['method']}",
                    "state": state, "node_id": os.environ["RT_NODE_ID"],
                    "trace": p.get("trace")}
                if phases:
                    msg["phases"] = phases
                await self.backend._gcs.call("task_event", msg)
            except Exception:
                pass

        self.backend.io.spawn(_send())


def main() -> None:
    # Debuggability: `kill -USR1 <worker_pid>` dumps all thread stacks to the
    # worker's log (stderr) — the only way to see inside a wedged worker.
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1, file=sys.stderr, all_threads=True)
    wp = WorkerProcess()
    wp.start()
    threading.Event().wait()  # io loop thread does the work


if __name__ == "__main__":
    main()
