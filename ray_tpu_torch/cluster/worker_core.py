"""ClusterBackend: the per-process core-worker library.

Reference analog: ``src/ray/core_worker/`` embedded in every driver/worker —
task submission (``CoreWorkerDirectTaskSubmitter``), direct actor calls with
per-caller ordering (``CoreWorkerDirectActorTaskSubmitter`` +
``SequentialActorSubmitQueue``), the in-process memory store for small
objects, and plasma access for large ones. One instance lives in the driver
and one in every worker process; task-executing code sees the same
``ray_tpu_torch.*`` API through it.

Object resolution order on ``get`` (mirrors the reference's
memory-store → plasma → owner/directory path, SURVEY.md §3.2):
  1. local memory store (we own it, or cached),
  2. local shm store (zero-copy),
  3. owner's memory store over RPC (ref carries the owner address),
  4. location directory → raylet pull → local shm.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import cloudpickle

from ray_tpu_torch import _native
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID
from ray_tpu_torch._private.serialization import SerializationContext, unpack_payload
from ray_tpu_torch.core.actor import ActorHandle
from ray_tpu_torch.core.backend import RuntimeBackend
from ray_tpu_torch.core import object_ledger
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.task_spec import (
    NodeLabelStrategy,
    resources_from_options,
    validate_options,
)
from ray_tpu_torch.core.worker import global_worker
from ray_tpu_torch.cluster import stream as rt_stream
from ray_tpu_torch.cluster.object_store import PlasmaStore
from ray_tpu_torch.runtime_env import prepare_runtime_env
from ray_tpu_torch.util import chaos as _chaos
from ray_tpu_torch.util import metrics as M
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    PlacementGroupSchedulingStrategy,
)
from ray_tpu_torch.util.tqdm_rt import maybe_render
from ray_tpu_torch.cluster.rpc import (
    ChannelBroken,
    ConnectionLost,
    ConnectionPool,
    EventLoopThread,
    RpcClient,
    RpcServer,
    spawn_task,
)
from ray_tpu_torch.core import failure as F
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    ActorUnschedulableError,
    BackpressureError,
    GetTimeoutError,
    ObjectLostError,
    OutOfMemoryError,
    OwnerDiedError,
    SchedulingTimeoutError,
    TaskError,
    WorkerCrashedError,
)

logger = logging.getLogger("ray_tpu_torch.worker_core")

_SMALL = lambda: get_config().max_direct_call_object_size


def _trace_ctx():
    """Child-span wire context when tracing is on or a span is ambient
    (None otherwise)."""
    return tracing.context_for_submit()


_phase_hist = None


def _observe_phases(phases: Dict[str, float]) -> None:
    """rt_task_phase_seconds{phase=...}: the Prometheus twin of the span's
    phase table, observed in the owner process (whose metrics pusher is
    live). Reached only for traced tasks — never on the untraced path."""
    global _phase_hist
    try:
        if _phase_hist is None:
            _phase_hist = M.get_or_create(
                M.Histogram, "rt_task_phase_seconds",
                "Per-phase task latency breakdown (traced tasks)",
                tag_keys=("phase",))
        for name, secs in phases.items():
            _phase_hist.observe(secs, {"phase": name})
    except Exception:  # noqa: BLE001 — observability never fails the task
        pass


# Recovery telemetry (failure plane): owner-side retry / lineage-
# reconstruction counters + the reconstruction-latency histogram. All
# lazily registered so the untraced happy path never touches the registry.
_recovery_metrics: Optional[Dict[str, Any]] = None

_RECONSTRUCT_BUCKETS = (0.005, 0.02, 0.1, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0,
                        300.0)


def _observe_retry() -> None:
    try:
        _get_recovery_metrics()["retries"].inc()
    except Exception:  # noqa: BLE001 — telemetry only
        pass


def _observe_reconstruction(outcome: str, seconds: float) -> None:
    try:
        m = _get_recovery_metrics()
        m["reconstructions"].inc(1.0, {"outcome": outcome})
        m["reconstruct_hist"].observe(seconds)
    except Exception:  # noqa: BLE001 — telemetry only
        pass


def _get_recovery_metrics() -> Dict[str, Any]:
    global _recovery_metrics
    if _recovery_metrics is None:
        _recovery_metrics = {
            "retries": M.get_or_create(
                M.Counter, "rt_task_retries_total",
                "Owner-side task resubmissions after a retriable failure"),
            "reconstructions": M.get_or_create(
                M.Counter, "rt_object_reconstructions_total",
                "Lineage reconstructions of lost objects by outcome",
                tag_keys=("outcome",)),
            "reconstruct_hist": M.get_or_create(
                M.Histogram, "rt_object_reconstruction_seconds",
                "Wall time of one lineage reconstruction "
                "(resubmit to reply)",
                boundaries=_RECONSTRUCT_BUCKETS),
        }
    return _recovery_metrics




class _MemoryStore:
    """Owner-side store of serialized payloads with async readiness events."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop
        self._data: Dict[str, bytes] = {}
        self._events: Dict[str, asyncio.Event] = {}
        self._lock = threading.Lock()

    def register_pending(self, oid_hex: str) -> None:
        with self._lock:
            if oid_hex not in self._events and oid_hex not in self._data:
                self._events[oid_hex] = asyncio.Event()

    def put(self, oid_hex: str, payload: bytes) -> None:
        with self._lock:
            self._data[oid_hex] = payload
            ev = self._events.pop(oid_hex, None)
        if ev is not None:
            self._loop.call_soon_threadsafe(ev.set)

    def mark_external(self, oid_hex: str) -> None:
        """The value went to plasma; wake waiters with no inline payload."""
        with self._lock:
            ev = self._events.pop(oid_hex, None)
        if ev is not None:
            self._loop.call_soon_threadsafe(ev.set)

    def get(self, oid_hex: str) -> Optional[bytes]:
        with self._lock:
            return self._data.get(oid_hex)

    def is_pending(self, oid_hex: str) -> bool:
        with self._lock:
            return oid_hex in self._events

    async def wait_ready(self, oid_hex: str, timeout: Optional[float]) -> bool:
        with self._lock:
            if oid_hex in self._data:
                return True
            ev = self._events.get(oid_hex)
        if ev is None:
            return True
        try:
            await asyncio.wait_for(ev.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    def delete(self, oid_hex: str) -> None:
        with self._lock:
            self._data.pop(oid_hex, None)


class _StreamState:
    """Owner-side state of one streaming-generator task (reference:
    ``ObjectRefStream``, ``core_worker/task_manager.h:96``)."""

    def __init__(self, task_id_hex: str, owner_address: str,
                 max_buffer: int, loop: asyncio.AbstractEventLoop):
        self.task_id_hex = task_id_hex
        self.owner_address = owner_address
        self.max_buffer = max_buffer
        self.produced = 0
        self.consumed = 0
        self.done = False
        self.closed = False                    # consumer abandoned the stream
        self.error_payload: Optional[bytes] = None
        self._event = asyncio.Event()          # new item / done (loop-affine)
        self._space = asyncio.Event()          # consumer caught up
        self._space.set()
        self.loop = loop

    def notify(self) -> None:
        self._event.set()
        if (self.done or self.closed
                or self.produced - self.consumed <= self.max_buffer):
            self._space.set()  # done/closed also frees a blocked producer ack
        else:
            self._space.clear()


class ObjectRefGenerator:
    """Iterator of ObjectRefs for ``num_returns="streaming"`` tasks
    (reference: ``StreamingObjectRefGenerator``, ``_raylet.pyx:267``).
    Yields per-item refs in production order; iteration ends when the
    generator task completes. Consuming an item releases backpressure."""

    def __init__(self, backend: "ClusterBackend", state: _StreamState):
        self._backend = backend
        self._state = state

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        st = self._state

        async def _wait_next():
            while True:
                if st.consumed < st.produced:
                    idx = st.consumed
                    st.consumed += 1
                    st.notify()
                    return idx
                if st.done or st.closed:
                    return None
                st._event.clear()
                await st._event.wait()

        idx = self._backend.io.run(_wait_next())
        if idx is None:
            raise StopIteration
        task_id = TaskID.from_hex(st.task_id_hex)
        return ObjectRef(ObjectID.for_return(task_id, idx),
                         owner=st.owner_address)

    def completed(self) -> bool:
        return self._state.done and self._state.consumed >= self._state.produced

    def close(self) -> None:
        """Abandon the stream: releases the producer's backpressure ack so
        the executor worker stops instead of blocking forever, and drops the
        owner-side stream state. Called automatically on GC."""
        st = self._state
        if st.closed:
            return
        st.closed = True
        self._backend._streams.pop(st.task_id_hex, None)
        self._backend.loop.call_soon_threadsafe(st.notify)

    def __del__(self):
        try:
            if not self.completed():
                self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class _ActorConn:
    """Ordered submission pipe to one actor (per-caller FIFO)."""

    def __init__(self, actor_id_hex: str):
        self.actor_id_hex = actor_id_hex
        self.address: Optional[str] = None
        self.send_lock: Optional[asyncio.Lock] = None
        self.dead_reason: Optional[str] = None
        self.dead_cause: Optional[Dict] = None  # failure.py wire dict
        self.max_task_retries: int = 0


class ClusterBackend(RuntimeBackend):
    def __init__(self, *, gcs_address: str, raylet_address: str, node_id: str,
                 session_name: str, job_id: JobID, role: str = "driver",
                 namespace: Optional[str] = None,
                 loop_thread: Optional[EventLoopThread] = None,
                 shared_store: bool = True):
        self.role = role
        # False = Ray-Client mode (reference: ray.client / util/client):
        # this process does NOT share the node's /dev/shm, so large objects
        # travel via the raylet's chunked put/get RPCs instead of mmap.
        self.shared_store = shared_store
        self.job_id = job_id
        self.namespace = namespace or "default"
        self.node_id = node_id
        self.session_name = session_name
        self.gcs_address = gcs_address
        self.raylet_address = raylet_address
        self.serde = SerializationContext()
        self.io = loop_thread or EventLoopThread(name=f"rt-{role}-io")
        self.loop = self.io.loop
        self.plasma = PlasmaStore(session_name, create_dir=True)
        self.memory_store = _MemoryStore(self.loop)
        self.server = RpcServer(self.loop)
        self.server.register("get_object", self._rpc_get_object)
        self.server.register("stream_item", self._rpc_stream_item)
        # push-stream subscription (cluster/stream.py): a consumer binds a
        # one-way push channel on its existing connection to this process
        self.server.register("stream_subscribe", self._rpc_stream_subscribe)
        # streaming-generator push handshake: the EXECUTING worker
        # announces its stream source; this owner subscribes and drains
        # items over one-way frames instead of one acked RPC per item
        self.server.register("stream_begin", self._rpc_stream_begin)
        # task_id_hex -> _StreamState for in-flight streaming generators
        self._streams: Dict[str, _StreamState] = {}
        self._pool = ConnectionPool(peer_id=f"{role}:{job_id.hex()}")
        self._gcs: Optional[RpcClient] = None
        self._raylet: Optional[RpcClient] = None
        self._exported_fns: set = set()
        self._fn_cache: Dict[str, Any] = {}
        self._actor_conns: Dict[str, _ActorConn] = {}
        self._shutdown = False
        self._cluster_shutdown_hook = None
        self._current_task_id: Optional[str] = None  # set by worker_main
        self._blocked_notified: set = set()
        self._pg_addr_cache: Dict[Tuple[str, int], str] = {}
        # Lineage for owner-side reconstruction (reference:
        # ``object_recovery_manager.h:41-94`` — when every copy of a task's
        # return object is lost, the OWNER resubmits the creating task).
        # oid_hex -> submit payload; kept only for returns that went to
        # plasma (small returns live in this process's memory store).
        self._lineage: Dict[str, Dict] = {}
        self._reconstructing: Dict[str, asyncio.Future] = {}
        # Tombstones for explicitly freed objects we own: lets a borrower's
        # get fail fast instead of waiting out the directory timeout.
        self._freed: Dict[str, None] = {}
        # client-side failure-emission rate limit (see _failure_event)
        self._failure_limiter = F.EmitLimiter()
        # runtime_env json -> prepared wire form (working_dir uploaded once)
        self._prepared_envs: Dict[str, Optional[Dict]] = {}

    # ---- bootstrap ----------------------------------------------------------
    def connect(self) -> None:
        # chaos plane: a process spawned into a tortured cluster arms
        # before any RPC it issues can be a target (worker processes get
        # the plan injected by their raylet at spawn; a driver attaching to
        # a chaos run sets the same env explicitly)
        plan_json = os.environ.get("RT_CHAOS_PLAN_JSON")
        armed_from_env = False
        if plan_json:
            try:
                _chaos.arm(plan_json)
                armed_from_env = True
            except (ValueError, TypeError):
                logger.warning("RT_CHAOS_PLAN_JSON did not parse as a "
                               "ChaosPlan; ignoring")

        async def _go():
            await self.server.start()
            self._gcs = RpcClient(self.gcs_address, peer_id=self.role,
                                  auto_reconnect=True)
            try:
                await self._gcs.connect()
            except (OSError, ConnectionLost):
                # ConnectionLost too: connect() ends with a hello RPC that
                # can die mid-handshake when the head is going down
                if self.role != "worker":
                    raise
                # Degraded boot: the GCS is unreachable (outage/failover)
                # but a worker only needs its RAYLET to serve pushes — boot
                # anyway and let the auto-reconnect client re-dial at first
                # use, so a raylet running degraded can still grow its pool
                # instead of crash-looping spawns against a dead head.
                self._gcs._closed = True
            self._raylet = RpcClient(self.raylet_address, peer_id=self.role)
            await self._raylet.connect()

        self.io.run(_go(), timeout=get_config().gcs_rpc_timeout_s)
        if armed_from_env and self.role in ("driver", "client"):
            # drivers have no raylet maintenance loop; without this their
            # buffered rpc.* injection events would only drain when the
            # log-forward loop happens to run (and never with
            # log_to_driver off)
            self.io.spawn(self._chaos_drain_loop())
        if self.role in ("driver", "client") and get_config().log_to_driver:
            self.io.spawn(self._log_forward_loop())
        if object_ledger.enabled():
            # ledger snapshots ride the KV like metrics do, so `rt memory`
            # can join owner/call-site info from every process
            object_ledger.get_ledger().ensure_pusher()

    async def _log_forward_loop(self) -> None:
        """Echo worker stdout/stderr lines to this driver's stderr with a
        worker prefix (reference: ``_private/log_monitor.py`` +
        ``worker.print_logs``). EVERY node's raylet is polled — one
        long-poll task per raylet, refreshed from the GCS node table — so a
        multi-host cluster's remote prints reach the driver too. Each
        poller starts at the raylet's CURRENT seq (no history replay)."""
        polled: Dict[str, asyncio.Task] = {}
        while not self._shutdown:
            try:
                nodes = await self._gcs.call("list_nodes", {})
            except Exception:  # noqa: BLE001 — teardown
                return
            for n in nodes:
                addr = n.get("address")
                if not addr or not n.get("alive"):
                    continue
                t = polled.get(addr)
                if t is None or t.done():
                    polled[addr] = spawn_task(self._poll_node_logs(addr))
            self._drain_chaos_events()
            await asyncio.sleep(10.0)

    async def _chaos_drain_loop(self) -> None:
        while not self._shutdown:
            self._drain_chaos_events()
            await asyncio.sleep(2.0)

    def _drain_chaos_events(self) -> None:
        """Ship buffered rpc.* injection events so they reach
        `rt errors --origin chaos` (called from _chaos_drain_loop for
        env-armed drivers, and opportunistically from the log-poll tick)."""
        for ev in _chaos.drain_events():
            F.emit_raw(spawn_task, self._gcs, ev)

    async def _poll_node_logs(self, address: str) -> None:
        try:
            client = await self._pool.get(address)
            head = await client.call("poll_logs", {"after": None},
                                     timeout=15.0)
            seq = head.get("seq", 0)
        except Exception:  # noqa: BLE001 — raylet without log pump
            return
        while not self._shutdown:
            try:
                reply = await client.call(
                    "poll_logs", {"after": seq, "timeout": 5.0,
                                  "job_id": self.job_id.hex()},
                    timeout=30.0)
            except Exception:  # noqa: BLE001 — node gone; outer loop retries
                return
            for e in reply.get("entries", ()):
                line = e["line"]
                # progress-bar magic lines render compactly instead of
                # spamming raw JSON (util/tqdm_rt.py)
                bar = maybe_render(line)
                if bar is not None:
                    line = bar
                print(f"\x1b[36m(worker {e['worker_id'][:8]})\x1b[0m "
                      f"{line}", file=sys.stderr)
            seq = reply.get("seq", seq)

    @property
    def address(self) -> str:
        return self.server.address

    # ---- serialization helpers ---------------------------------------------
    def _serialize_arg(self, value: Any) -> Tuple:
        if isinstance(value, ObjectRef):
            if object_ledger.enabled():
                object_ledger.get_ledger().record_task_arg(value.hex())
            return ("ref", value._descriptor())
        payload = self.serde.serialize(value).to_bytes()
        if len(payload) > _SMALL():
            ref = self._put_payload_plasma(payload)
            return ("ref", ref._descriptor())
        return ("val", payload)

    def _put_payload_plasma(self, payload: bytes,
                            oid: Optional[ObjectID] = None) -> ObjectRef:
        oid = oid or global_worker().next_put_id()
        if not self.shared_store:
            self.io.run(self._upload_object(oid.hex(), payload))
            if object_ledger.enabled():
                object_ledger.get_ledger().record_put(
                    oid.hex(), len(payload), "plasma", owner=self.address)
            return ObjectRef(oid, owner=self.address)
        self.plasma.write_whole(oid, payload)
        self.io.run(self._raylet.call("seal_object",
                                      {"oid": oid.hex(), "size": len(payload)}))
        if object_ledger.enabled():
            object_ledger.get_ledger().record_put(
                oid.hex(), len(payload), "plasma", owner=self.address)
        return ObjectRef(oid, owner=self.address)

    async def _upload_object(self, oid_hex: str, payload: bytes) -> None:
        """Client mode: chunked upload into the attached raylet's store."""
        chunk = get_config().object_transfer_chunk_bytes
        total = len(payload)
        off = 0
        while True:
            end = min(off + chunk, total)
            reply = await self._raylet.call("put_object_chunk", {
                "oid": oid_hex, "offset": off, "total": total,
                "data": payload[off:end], "seal": end >= total})
            if reply.get("error"):
                raise RuntimeError(f"client put failed: {reply['error']}")
            if reply.get("dup"):
                return  # already in the store — done, don't keep streaming
            off = end
            if off >= total:
                return

    async def _download_object(self, oid_hex: str,
                               timeout) -> Optional[memoryview]:
        """Client mode: chunked download from the attached raylet (which
        serves shm and spill copies alike)."""
        def _checked(reply) -> Optional[bytes]:
            data = reply.get("data")
            if data is None:
                return None
            crc = reply.get("crc")
            if crc is not None:
                ours = _native.checksum(data, reply.get("crc_kind", "crc32c"))
                if ours is not None and ours != crc:
                    raise ConnectionError(
                        f"chunk checksum mismatch downloading {oid_hex}")
            return data

        chunk = get_config().object_transfer_chunk_bytes
        first = await self._raylet.call(
            "get_object_chunk", {"oid": oid_hex, "offset": 0, "size": chunk},
            timeout=timeout)
        data = _checked(first)
        if data is None:
            return None
        buf = bytearray(first["total"])
        buf[:len(data)] = data
        off = len(data)
        while off < len(buf):
            r = await self._raylet.call(
                "get_object_chunk",
                {"oid": oid_hex, "offset": off, "size": chunk},
                timeout=timeout)
            data = _checked(r)
            if not data:
                return None
            buf[off:off + len(data)] = data
            off += len(data)
        return memoryview(bytes(buf))

    # ---- objects ------------------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        payload = self.serde.serialize(value).to_bytes()
        oid = global_worker().next_put_id()
        if len(payload) > _SMALL():
            return self._put_payload_plasma(payload, oid)
        self.memory_store.put(oid.hex(), payload)
        if object_ledger.enabled():
            object_ledger.get_ledger().record_put(
                oid.hex(), len(payload), "memory", owner=self.address)
        return ObjectRef(oid, owner=self.address)

    async def _resolve_payload(self, ref: ObjectRef, timeout: Optional[float],
                               pin_held: bool = False) -> memoryview:
        """The 4-step resolution; returns the serialized payload.

        ``pin_held``: the caller already holds a raylet pin covering this oid
        (batched ``get``), so the per-oid pin around the fetch is skipped.
        """
        oid_hex = ref.hex()
        if oid_hex in self._freed:
            raise ObjectLostError(ref.id())
        deadline = None if timeout is None else time.monotonic() + timeout
        reconstruct_attempts = 0

        def remaining():
            if deadline is None:
                return None
            r = deadline - time.monotonic()
            if r <= 0:
                self._failure_event(F.GET_TIMEOUT,
                                    f"timed out resolving {ref}",
                                    oid=oid_hex)
                raise GetTimeoutError(f"timed out resolving {ref}")
            return r

        while True:
            payload = self.memory_store.get(oid_hex)
            if payload is not None:
                return memoryview(payload)
            if self.shared_store:
                view = self.plasma.read(ref.id())
                if view is not None:
                    return view
            if self.memory_store.is_pending(oid_hex):
                if not await self.memory_store.wait_ready(oid_hex, remaining()):
                    self._failure_event(F.GET_TIMEOUT,
                                        f"timed out waiting for {ref}",
                                        oid=oid_hex)
                    raise GetTimeoutError(f"timed out waiting for {ref}")
                continue
            owner = ref.owner_address()
            if owner and owner != self.address:
                try:
                    client = await self._pool.get(owner)
                    reply = await client.call(
                        "get_object", {"oid": oid_hex, "timeout": remaining()},
                        timeout=remaining())
                    if "payload" in reply:
                        return memoryview(reply["payload"])
                    if reply.get("pending"):
                        continue
                    if reply.get("freed"):
                        raise ObjectLostError(ref.id())
                    # in_plasma, or not found in the owner process at all —
                    # either way the location directory decides: the value may
                    # live in another node's store or on spill disk (the owner
                    # can't see its own raylet's spill dir), so fall through
                    # to the raylet pull instead of declaring it lost here.
                except (ConnectionLost, ConnectionError, OSError):
                    cause = F.cause_dict(
                        F.OWNER_DIED,
                        f"owner {owner} unreachable while resolving the "
                        f"object", oid=oid_hex, owner=owner)
                    self._failure_event(F.OWNER_DIED, cause["message"],
                                        oid=oid_hex)
                    raise OwnerDiedError(ref.id(), cause) from None
            # A reconstructable object fails fast on the directory wait —
            # we can rebuild it — while a plain object waits out the caller's
            # deadline in case a producer is still sealing it.
            can_reconstruct = oid_hex in self._lineage
            dir_wait = (min(5.0, remaining() or 5.0) if can_reconstruct
                        else (remaining() or 30.0))
            # Pin across the fetch→read window (reference: ``PinObjectIDs``,
            # ``raylet/node_manager.h:515-555``): concurrent getters' restores
            # must not re-evict this object between the raylet's fetch-ok and
            # our shm read. The raylet refreshes the pin's TTL at fetch-ok,
            # so even a fetch that blocked past the TTL lands protected. Once
            # the view is in hand the mmap stays valid regardless of eviction.
            if not pin_held:
                await self._raylet.call("pin_objects", {"oids": [oid_hex]},
                                        timeout=remaining())
            try:
                reply = await self._raylet.call(
                    "fetch_object", {"oid": oid_hex, "timeout": dir_wait},
                    timeout=remaining())
                if reply.get("ok"):
                    if self.shared_store:
                        view = self.plasma.read(ref.id())
                    else:  # client mode: no shared mmap — RPC download
                        view = await self._download_object(
                            oid_hex, remaining())
                    if view is not None:
                        return view
            finally:
                if not pin_held:
                    spawn_task(self._unpin_quietly([oid_hex]))
            if can_reconstruct and reconstruct_attempts < 2:
                reconstruct_attempts += 1
                await self._reconstruct(oid_hex)
                continue
            owner = ref.owner_address()
            if (owner and owner != self.address
                    and reconstruct_attempts < 2):
                # borrower path: every copy is gone and we hold no lineage —
                # the owner does; ask it to reconstruct
                reconstruct_attempts += 1
                try:
                    client = await self._pool.get(owner)
                    reply = await client.call(
                        "get_object", {"oid": oid_hex, "lost": True},
                        timeout=remaining())
                    if "payload" in reply:
                        return memoryview(reply["payload"])
                    if reply.get("reconstructed"):
                        continue
                except (ConnectionLost, ConnectionError, OSError):
                    pass
            cause = F.cause_dict(
                F.OBJECT_LOST,
                "all copies lost and reconstruction "
                + ("exhausted" if reconstruct_attempts else "unavailable"),
                oid=oid_hex, reconstruct_attempts=reconstruct_attempts)
            self._failure_event(F.OBJECT_LOST, cause["message"], oid=oid_hex)
            raise ObjectLostError(ref.id(), cause)

    def _failure_event(self, category: str, message: str, **fields) -> None:
        """Categorized FailureEvent from this owner process to the GCS
        failure store (`rt errors` / `/api/errors` / the timeline's errors
        lane). Rate-limited per (category, subject) via the shared
        EmitLimiter: a readiness-polling loop of get(timeout=...) expiries
        must not stream one GCS RPC per poll."""
        key = (category, fields.get("oid") or fields.get("actor_id")
               or fields.get("task_id") or message)
        if not self._failure_limiter.allow(key):
            return
        F.emit(self.io.spawn, self._gcs, category, message,
               node_id=self.node_id, **fields)

    async def _report_unreachable_quietly(self, actor_id_hex: str,
                                          address: str) -> None:
        """Best-effort: the GCS itself may be down in exactly this
        scenario — a raised ConnectionError here is noise, not signal."""
        try:
            await self._gcs.call("actor_unreachable", {
                "actor_id": actor_id_hex, "address": address}, timeout=10)
        except Exception:  # noqa: BLE001
            pass

    async def _unpin_quietly(self, oids: List[str]) -> None:
        """Fire-and-forget unpin; a dropped connection (shutdown, raylet
        restart) must not surface as an unretrieved task exception — the
        raylet's pin TTL reclaims the pin anyway."""
        try:
            await self._raylet.call("unpin_objects", {"oids": oids},
                                    timeout=5.0)
        except Exception:  # noqa: BLE001
            pass

    async def _reconstruct(self, oid_hex: str) -> None:
        """Re-execute the creating task to regenerate a lost return object
        (same task_id => same deterministic return ObjectIDs). Concurrent
        getters of the same lost object join one resubmission. Chains
        recover multi-level: the re-executed task's arg resolution runs in
        its worker, whose get falls back to the OWNER of each lost arg with
        ``lost=True`` — and that owner reconstructs from its own lineage
        (reference: recursive recovery, ``object_recovery_manager.h:68-94``)."""
        existing = self._reconstructing.get(oid_hex)
        if existing is not None:
            await asyncio.shield(existing)
            return
        fut = asyncio.get_running_loop().create_future()
        payload = dict(self._lineage[oid_hex])
        payload["reconstruct"] = True
        task_id = TaskID.from_hex(payload["task_id"])
        refs = [ObjectRef(ObjectID.for_return(task_id, i), owner=self.address)
                for i in range(payload["num_returns"])]
        for r in refs:
            self._reconstructing[r.hex()] = fut
        t0 = time.monotonic()
        outcome = "error"
        try:
            target = self._raylet
            if payload.get("pg") is not None:
                target = await self._pg_bundle_raylet(payload["pg"])
            reply = await target.call("submit_task", payload)
            outcome = "failed" if reply.get("error") else "ok"
            self._apply_task_reply(reply, refs, payload["fn_name"], payload)
        finally:
            _observe_reconstruction(outcome, time.monotonic() - t0)
            if outcome != "ok":
                self._failure_event(
                    F.OBJECT_LOST,
                    f"lineage reconstruction of task "
                    f"{payload.get('fn_name')} did not complete "
                    f"({outcome})", oid=oid_hex,
                    task_id=payload.get("task_id"))
            for r in refs:
                self._reconstructing.pop(r.hex(), None)
            if not fut.done():
                fut.set_result(None)

    def _deserialize_result(self, payload: memoryview) -> Any:
        value = self.serde.deserialize_payload(payload)
        if isinstance(value, BaseException):
            raise value
        return value

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float]) -> List[Any]:
        self._notify_blocked()
        if object_ledger.enabled():
            ledger = object_ledger.get_ledger()
            for r in refs:
                ledger.record_get(r.hex())
        # Batched pinning: one pin RPC covers the whole ref set for the
        # duration of the resolve (the per-oid pin in _resolve_payload is
        # skipped). Skipped entirely when every ref is already in our memory
        # store — the hot small-object path pays no raylet round-trip.
        oids = [r.hex() for r in refs]
        all_local = all(self.memory_store.get(h) is not None for h in oids)

        async def _gather():
            if not all_local:
                await self._raylet.call("pin_objects", {"oids": oids},
                                        timeout=timeout)
            try:
                return await asyncio.gather(
                    *[self._resolve_payload(r, timeout,
                                            pin_held=not all_local)
                      for r in refs])
            finally:
                if not all_local:
                    spawn_task(self._unpin_quietly(oids))

        payloads = self.io.run(_gather(), timeout=None if timeout is None
                               else timeout + 5.0)
        if not (tracing.enabled() or tracing.current_context() is not None):
            return [self._deserialize_result(p) for p in payloads]
        # driver_get phase: post-reply deserialization in the caller,
        # attributed per producing task (return objects only — puts carry
        # the high index bit and belong to no task span)
        out: List[Any] = []
        per_task: Dict[str, float] = {}
        for r, p in zip(refs, payloads):
            t0 = time.perf_counter()
            out.append(self._deserialize_result(p))
            oid = r.id()
            if oid.index() < 0x80000000:
                key = oid.task_id().hex()
                per_task[key] = per_task.get(key, 0.0) \
                    + (time.perf_counter() - t0)
        for tid, secs in per_task.items():
            _observe_phases({"driver_get": secs})
            self.io.spawn(self._phase_event(tid, {"driver_get": secs}))
        return out

    def _notify_blocked(self) -> None:
        """Inside a task, a blocking get returns the task's CPU to the raylet
        so children can run (prevents parent-waits-on-child deadlock)."""
        tid = self._current_task_id
        if tid is None or tid in self._blocked_notified:
            return
        self._blocked_notified.add(tid)
        self.io.spawn(self._raylet.call("task_blocked", {"task_id": tid}))

    def wait(self, refs, num_returns, timeout):
        async def _wait():
            futs = {asyncio.ensure_future(self._resolve_payload(r, None)): r
                    for r in refs}
            ready: List[ObjectRef] = []
            deadline = None if timeout is None else time.monotonic() + timeout
            pending = set(futs)
            while len(ready) < num_returns and pending:
                to = None if deadline is None else max(0.0, deadline - time.monotonic())
                done, pending = await asyncio.wait(
                    pending, timeout=to, return_when=asyncio.FIRST_COMPLETED)
                if not done:
                    break
                for f in done:
                    ready.append(futs[f])
            for f in pending:
                f.cancel()
            ready_set = set(ready[:num_returns])
            return ([r for r in refs if r in ready_set],
                    [r for r in refs if r not in ready_set])

        return self.io.run(_wait())

    async def _rpc_get_object(self, p):
        """Serve our memory store to borrowers (long-poll while pending).
        ``lost=True`` from a borrower means every copy is gone: as the owner
        we hold the lineage, so reconstruct before replying (reference: the
        owner drives recovery, ``object_recovery_manager.h``)."""
        oid_hex = p["oid"]
        if oid_hex in self._freed:
            return {"freed": True}
        if self.memory_store.is_pending(oid_hex):
            await self.memory_store.wait_ready(oid_hex, p.get("timeout") or 30.0)
        payload = self.memory_store.get(oid_hex)
        if payload is not None:
            return {"payload": payload}
        if p.get("lost") and oid_hex in self._lineage:
            try:
                await self._reconstruct(oid_hex)
            except Exception:  # noqa: BLE001 — borrower sees not_found
                pass
            payload = self.memory_store.get(oid_hex)
            if payload is not None:
                return {"payload": payload}
            return {"in_plasma": True, "reconstructed": True}
        if self.plasma.contains(ObjectID.from_hex(oid_hex)):
            return {"in_plasma": True}
        return {"not_found": True}

    async def _rpc_stream_subscribe(self, p):
        return await rt_stream.handle_subscribe(self, p)

    # generator streams with a hard small producer-lag bound stay on the
    # acked per-item path: push batching (frame window + producer pump)
    # would loosen the bound `_stream_max_buffer` promises
    _GEN_PUSH_MIN_BUFFER = 16

    async def _rpc_stream_begin(self, p):
        """Streaming-generator push handshake: the executor worker registered stream ``sid``; if this
        owner still wants the stream and push is enabled, subscribe a
        one-way frame channel back to the worker and drain it from a
        background task. The legacy acked ``stream_item`` path remains
        the fallback — the worker reverts to it (and redelivers the
        unacked tail, idempotent by index) whenever the channel breaks
        or this reply says no."""
        st = self._streams.get(p["task_id"])
        if st is None or st.closed:
            return {"push": False, "gone": True}
        if (not rt_stream.push_enabled()
                or st.max_buffer < self._GEN_PUSH_MIN_BUFFER):
            return {"push": False}
        # max_buffer is the consumer's MEMORY bound, so it must cover the
        # whole pipeline, not gate each stage independently: half goes to
        # the credit window (channel buffer + producer replay), half to
        # the stored-but-unconsumed gate in the drain task — the producer
        # pump adds window//4 on top, keeping the total within ~1.1x the
        # bound the acked per-item path promises
        window = max(2, st.max_buffer // 2)
        gate = max(1, st.max_buffer - window)
        try:
            ch = await rt_stream.subscribe(self, p["address"], p["sid"],
                                           window=window)
        except Exception:  # noqa: BLE001 — transport hiccup: stay on pull
            return {"push": False}
        if ch is None:
            return {"push": False}
        spawn_task(self._drain_generator_push(st, ch, p["task_id"], gate))
        return {"push": True, "window": window}

    async def _drain_generator_push(self, st: "_StreamState", ch,
                                    task_id_hex: str, gate: int) -> None:
        """Owner half of a pushed generator stream: decode each frame
        ``(index, payload|None)`` into the per-index object slot (the
        exact stores ``_rpc_stream_item`` would have made; plasma items
        were sealed node-side and travel as index-only markers), bounded
        by the same ``max_buffer`` consumer-lag wait. Exits on the done
        frame, on consumer close, on a broken channel (the worker detects
        the stop through the binding and resends the unacked tail over
        the acked path), and on ``st.done`` — when the producer settles
        through the acked fallback no done frame ever arrives, so the
        take must be raced against the stream-state event or this task
        (and the channel endpoint) would park in ``take`` forever."""
        task_id = TaskID.from_hex(task_id_hex)
        take_fut: Optional[asyncio.Future] = None

        def _store(item) -> None:
            idx, payload = item
            if payload is not None:
                self.memory_store.put(
                    ObjectID.for_return(task_id, idx).hex(), payload)
            st.produced = max(st.produced, idx + 1)
            st.notify()

        def _flush_take() -> None:
            # a completed take holds an item the channel already
            # CREDITED as consumed — the producer's fallback excludes
            # acked items from the redelivered tail, so dropping it
            # here would hole the stream permanently
            nonlocal take_fut
            if take_fut is not None and take_fut.done():
                try:
                    item, done = take_fut.result()
                except Exception:  # noqa: BLE001 — broken channel /
                    pass           # error frame: nothing was taken
                else:
                    if not done and item is not None:
                        _store(item)
                take_fut = None

        try:
            while True:
                if st.done or st.closed:
                    # settled via the task reply (the unacked tail was
                    # redelivered by index) or consumer abandon: flush
                    # any credited in-flight take, closed credit stops
                    # the producer
                    _flush_take()
                    ch.close()
                    return
                while (st.produced - st.consumed > gate
                       and not st.done and not st.closed):
                    st._space.clear()
                    await st._space.wait()
                if st.done or st.closed:
                    _flush_take()
                    ch.close()
                    return
                if take_fut is None:
                    take_fut = asyncio.ensure_future(
                        rt_stream.take_decoded(self, ch))
                st._event.clear()
                waiter = asyncio.ensure_future(st._event.wait())
                await asyncio.wait({take_fut, waiter},
                                   return_when=asyncio.FIRST_COMPLETED)
                waiter.cancel()
                if not take_fut.done():
                    continue  # stream-state change: loop re-checks done
                item, done = take_fut.result()
                take_fut = None
                if done:
                    return
                _store(item)
        except ChannelBroken:
            try:
                ch.close()
            except Exception:  # noqa: BLE001 — channel already dead
                pass
        except Exception:  # noqa: BLE001 — decode failure: the worker's
            # binding sees the closed channel and falls back to the
            # acked path, which redelivers everything unacked
            try:
                ch.close()
            except Exception:  # noqa: BLE001
                pass
        finally:
            if take_fut is not None and not take_fut.done():
                take_fut.cancel()

    async def _rpc_stream_item(self, p):
        """Executor pushes one generator item (reference: item reporting,
        ``_raylet.pyx:1090``). Inline payloads land in our memory store;
        plasma items were already sealed node-side. The ack is withheld
        while the consumer lags more than max_buffer items — the executor
        awaits it before producing the next item, which IS the backpressure."""
        st = self._streams.get(p["task_id"])
        if st is None:
            return {"ok": False, "gone": True}  # stream cancelled/unknown
        task_id = TaskID.from_hex(p["task_id"])
        idx = p["index"]
        oid_hex = ObjectID.for_return(task_id, idx).hex()
        if "payload" in p:
            self.memory_store.put(oid_hex, p["payload"])
        st.produced = max(st.produced, idx + 1)
        st.notify()
        while (st.produced - st.consumed > st.max_buffer
               and not st.done and not st.closed):
            st._space.clear()
            await st._space.wait()
        if st.closed:
            return {"ok": False, "gone": True}  # tell the producer to stop
        return {"ok": True}

    def free_objects(self, refs: Sequence[ObjectRef]) -> None:
        ledger = (object_ledger.get_ledger()
                  if object_ledger.enabled() else None)
        for r in refs:
            self.memory_store.delete(r.hex())
            self._lineage.pop(r.hex(), None)
            self._freed[r.hex()] = None
            if ledger is not None:
                ledger.record_freed(r.hex())
        while len(self._freed) > 65536:
            self._freed.pop(next(iter(self._freed)))
        self.io.run(self._raylet.call(
            "free_objects", {"oids": [r.hex() for r in refs]}))

    # ---- function/class export ---------------------------------------------
    def _export(self, kind: str, obj: Any) -> str:
        blob = cloudpickle.dumps(obj)
        fid = f"{kind}:{hashlib.sha1(blob).hexdigest()}"
        if fid not in self._exported_fns:
            self.io.run(self._gcs.call("kv_put", {"key": f"@fn/{fid}",
                                                  "value": blob}))
            self._exported_fns.add(fid)
        return fid

    def load_function(self, fid: str) -> Any:
        fn = self._fn_cache.get(fid)
        if fn is None:
            reply = self.io.run(self._gcs.call("kv_get", {"key": f"@fn/{fid}"}))
            if reply["value"] is None:
                raise RuntimeError(f"function {fid} not found in GCS")
            fn = cloudpickle.loads(reply["value"])
            self._fn_cache[fid] = fn
        return fn

    async def load_function_async(self, fid: str) -> Any:
        fn = self._fn_cache.get(fid)
        if fn is None:
            reply = await self._gcs.call("kv_get", {"key": f"@fn/{fid}"})
            if reply["value"] is None:
                raise RuntimeError(f"function {fid} not found in GCS")
            fn = cloudpickle.loads(reply["value"])
            self._fn_cache[fid] = fn
        return fn

    def _prepare_env(self, options) -> Optional[Dict]:
        """Normalize/upload a runtime_env once per distinct content
        (reference: ``_private/runtime_env/packaging.py`` upload path)."""
        env = options.get("runtime_env")
        if not env:
            return None
        cache_key = json.dumps(env, sort_keys=True, default=str)
        if cache_key not in self._prepared_envs:
            self._prepared_envs[cache_key] = prepare_runtime_env(
                env, self.kv_put, self.kv_get)
        return self._prepared_envs[cache_key]

    @staticmethod
    def _normalize_strategy(options) -> Tuple[Any, Optional[Dict]]:
        """Returns (strategy_spec, pg_info) from the options surface, which
        accepts either scheduling_strategy=PlacementGroupSchedulingStrategy
        or the placement_group=... shorthand."""

        strategy = options.get("scheduling_strategy")
        selector = options.get("label_selector")
        if selector:
            if strategy is not None:
                raise ValueError(
                    "label_selector cannot be combined with "
                    "scheduling_strategy; put soft preferences in a "
                    "NodeLabelStrategy(hard=..., soft=...) instead")
            strategy = NodeLabelStrategy(hard=dict(selector))
        pg = options.get("placement_group")
        if pg is not None:
            if not isinstance(pg, PlacementGroup):
                raise TypeError("placement_group= expects a PlacementGroup")
            strategy = PlacementGroupSchedulingStrategy(
                pg, options.get("placement_group_bundle_index", -1))
        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            pg_info = {"pg_id": strategy.placement_group.id.hex(),
                       "bundle_index": strategy.bundle_index}
            return strategy.to_spec(), pg_info
        return strategy, None

    @staticmethod
    def _stamp_overload_options(payload: Dict, options: Dict) -> None:
        """Deadline budget + backpressure policy ride the submit payload
        (absent on the default path — the wire stays small)."""
        if options.get("deadline_s"):
            payload["deadline_s"] = float(options["deadline_s"])
        if options.get("on_overload"):
            payload["on_overload"] = options["on_overload"]

    async def _backpressure_pause(self, attempt: int) -> None:
        """Block-with-backoff between backpressured resubmits: capped
        exponential + jitter so a fleet of throttled producers doesn't
        re-slam the raylet in lockstep."""
        cfg = get_config()
        await asyncio.sleep(F.backoff_with_jitter(
            attempt, cfg.backpressure_retry_base_s,
            cfg.backpressure_retry_max_s))

    def _backpressure_error(self, reply: Dict, fn_name: str):
        return BackpressureError(
            f"task {fn_name} rejected under overload: scheduling-class "
            f"queue at its admission bound "
            f"({reply.get('queue_depth')}/{reply.get('limit')}); the "
            f"default on_overload='block' waits this out instead",
            queue_depth=reply.get("queue_depth"),
            limit=reply.get("limit"))

    def _deadline_shed(self, payload: Dict, what: str):
        """Owner-side pre-enqueue deadline shed: the submit was parked in
        the backpressure backoff loop past its budget and was NEVER
        enqueued, so the owner is the only process that can stamp the
        organic scheduling_timeout feed row (queued work is covered by the
        raylet's ``_evict_item``). Returns ``(message, cause)`` for the
        caller to deliver on its own path (stream slot vs return refs)."""
        msg = (f"deadline_s={payload['deadline_s']} budget expired while "
               f"blocked on backpressure (never enqueued)")
        self._failure_event(
            F.SCHEDULING_TIMEOUT,
            f"{what} {payload['fn_name']} shed: {msg}",
            task_id=payload.get("task_id"),
            name=payload["fn_name"])
        return msg, F.cause_dict(F.SCHEDULING_TIMEOUT,
                                 "deadline expired under backpressure",
                                 task_id=payload.get("task_id"))

    # ---- tasks --------------------------------------------------------------
    def submit_task(self, fn, options, args, kwargs):
        validate_options(options, for_actor=False)
        req = resources_from_options(options, default_num_cpus=1)
        num_returns = options.get("num_returns", 1)
        strategy, pg_info = self._normalize_strategy(options)
        fid = self._export("fn", fn)
        task_id = TaskID.for_task(self.job_id)
        if num_returns == "streaming":
            return self._submit_streaming(fn, options, args, kwargs, req,
                                          strategy, pg_info, fid, task_id)
        refs = [ObjectRef(ObjectID.for_return(task_id, i), owner=self.address)
                for i in range(num_returns)]
        for r in refs:
            self.memory_store.register_pending(r.hex())
        payload = {
            "task_id": task_id.hex(),
            "job_id": self.job_id.hex(),
            "fn_id": fid,
            "fn_name": getattr(fn, "__name__", "anonymous"),
            "args": [self._serialize_arg(a) for a in args],
            "kwargs": {k: self._serialize_arg(v) for k, v in kwargs.items()},
            "num_returns": num_returns,
            "resources": req.to_dict(),
            "strategy": strategy,
            "pg": pg_info,
            "owner": self.address,
            "max_retries": options.get("max_retries",
                                       get_config().task_max_retries_default),
            "runtime_env": self._prepare_env(options),
            "trace": _trace_ctx(),
        }
        self._stamp_overload_options(payload, options)
        self.io.spawn(self._submit_and_collect(
            payload, refs, t_entry=tracing.take_submit_entry()))
        return refs[0] if num_returns == 1 else refs

    def _submit_streaming(self, fn, options, args, kwargs, req, strategy,
                          pg_info, fid, task_id) -> "ObjectRefGenerator":
        """Streaming-generator submission (``num_returns="streaming"``,
        reference: ``remote_function.py:333`` + ``task_manager.h:96``)."""
        state = _StreamState(task_id.hex(), self.address,
                             max_buffer=options.get("_stream_max_buffer", 16),
                             loop=self.loop)
        self._streams[task_id.hex()] = state
        payload = {
            "task_id": task_id.hex(),
            "job_id": self.job_id.hex(),
            "fn_id": fid,
            "fn_name": getattr(fn, "__name__", "anonymous"),
            "args": [self._serialize_arg(a) for a in args],
            "kwargs": {k: self._serialize_arg(v) for k, v in kwargs.items()},
            "num_returns": "streaming",
            "resources": req.to_dict(),
            "strategy": strategy,
            "pg": pg_info,
            "owner": self.address,
            "max_retries": 0,  # raylet-side dedup off; owner drives retries
            "runtime_env": self._prepare_env(options),
            "trace": _trace_ctx(),  # span + phases land via the raylet
        }
        self._stamp_overload_options(payload, options)

        async def _run():
            # A stream that produced NOTHING yet is safe to retry whole
            # (transient worker-spawn failures under load); once items have
            # been consumed, a partial stream must not silently re-run.
            retries = get_config().task_max_retries_default
            bp_attempts = 0
            bp_deadline = (time.monotonic() + payload["deadline_s"]
                           if payload.get("deadline_s") else None)
            while True:
                try:
                    target = self._raylet
                    if payload.get("pg") is not None:
                        target = await self._pg_bundle_raylet(payload["pg"])
                    reply = await target.call("submit_task", payload)
                except Exception as e:
                    reply = {"error": "submit_failed", "message": repr(e)}
                if reply.get("error") == "backpressure":
                    if (bp_deadline is not None
                            and time.monotonic() >= bp_deadline):
                        # deadline holds pre-enqueue: shed instead of
                        # blocking past the budget
                        msg, cause = self._deadline_shed(payload, "stream")
                        reply = {"error": "deadline_exceeded",
                                 "message": msg, "cause": cause}
                    elif (payload.get("on_overload") != "fail"
                            and not state.closed):
                        bp_attempts += 1
                        await self._backpressure_pause(bp_attempts)
                        continue
                if (reply.get("error") in ("worker_crashed", "bundle_gone",
                                           "submit_failed", "oom_killed")
                        and state.produced == 0 and not state.closed
                        and retries > 0):
                    retries -= 1
                    _observe_retry()
                    continue
                break
            if reply.get("error"):
                if reply["error"] == "backpressure":
                    err: Exception = self._backpressure_error(
                        reply, payload["fn_name"])
                elif reply["error"] == "deadline_exceeded":
                    err = SchedulingTimeoutError(
                        f"streaming task {payload['fn_name']} shed: "
                        f"{reply.get('message', reply['error'])}",
                        cause=reply.get("cause"))
                else:
                    err = WorkerCrashedError(
                        f"streaming task {payload['fn_name']} failed: "
                        f"{reply.get('message', reply['error'])}")
                blob = self.serde.serialize(err).to_bytes()
                idx = state.produced
                self.memory_store.put(
                    ObjectID.for_return(task_id, idx).hex(), blob)
                state.produced = idx + 1
            elif reply.get("stream_error") is not None:
                idx = state.produced
                self.memory_store.put(
                    ObjectID.for_return(task_id, idx).hex(),
                    reply["stream_error"])
                state.produced = idx + 1
            state.done = True
            state.notify()
            # state is kept for iteration; dropped when consumed or replaced
            if len(self._streams) > 1024:
                for k in [k for k, s in self._streams.items()
                          if s.done and s.consumed >= s.produced][:512]:
                    self._streams.pop(k, None)

        self.io.spawn(_run())
        return ObjectRefGenerator(self, state)

    async def _submit_and_collect(self, payload, refs: List[ObjectRef],
                                  t_entry: Optional[float] = None) -> None:
        retries = payload.get("max_retries", 0)
        attempt = 0
        bp_attempts = 0
        # the deadline budget must hold PRE-enqueue too: a submit parked in
        # the backpressure backoff loop is exactly the stale work
        # deadline_s exists to shed
        bp_deadline = (time.monotonic() + payload["deadline_s"]
                       if payload.get("deadline_s") else None)
        traced = payload.get("trace") is not None  # one predicate per hop
        while True:
            t_sub = (t_entry if attempt == 0 and t_entry is not None
                     else time.perf_counter()) if traced else 0.0
            try:
                target = self._raylet
                if payload.get("pg") is not None:
                    target = await self._pg_bundle_raylet(payload["pg"])
                reply = await target.call("submit_task", payload)
            except Exception as e:
                reply = {"error": "submit_failed", "message": repr(e)}
            if reply.get("error") == "backpressure":
                # admission control bounced the submit: block-with-backoff
                # (default) keeps the producer paced without consuming its
                # retry budget; fail-fast resolves the refs with a
                # BackpressureError the caller can catch.
                if payload.get("on_overload") == "fail":
                    blob = self.serde.serialize(self._backpressure_error(
                        reply, payload["fn_name"])).to_bytes()
                    for r in refs:
                        self.memory_store.put(r.hex(), blob)
                    return
                if (bp_deadline is not None
                        and time.monotonic() >= bp_deadline):
                    msg, cause = self._deadline_shed(payload, "task")
                    err = SchedulingTimeoutError(
                        f"task {payload['fn_name']} shed: {msg}",
                        cause=cause)
                    blob = self.serde.serialize(err).to_bytes()
                    for r in refs:
                        self.memory_store.put(r.hex(), blob)
                    return
                bp_attempts += 1
                await self._backpressure_pause(bp_attempts)
                continue
            if reply.get("error") in ("worker_crashed", "bundle_gone",
                                      "submit_failed", "oom_killed"):
                if payload.get("pg") is not None:
                    self._pg_addr_cache.pop(
                        (payload["pg"]["pg_id"],
                         payload["pg"].get("bundle_index", -1)), None)
                if attempt < retries:
                    attempt += 1
                    _observe_retry()
                    continue
            break
        if traced and reply.get("phases") is not None:
            # FINAL attempt only — a retried attempt's partial phases must
            # not double-count the task in the histogram or pollute the
            # event's merged breakdown. submit = driver-side residual of
            # this attempt's wall around the raylet's accounted interval
            # (serialization + both RPC directions); completes the
            # partition.
            reply["phases"]["submit"] = max(
                0.0, (time.perf_counter() - t_sub)
                - reply.get("phases_total", 0.0))
            _observe_phases(reply["phases"])
            spawn_task(self._phase_event(
                payload["task_id"],
                {"submit": reply["phases"]["submit"]}))
        self._apply_task_reply(reply, refs, payload["fn_name"], payload)

    async def _phase_event(self, task_id_hex: str,
                           phases: Dict[str, float]) -> None:
        """Merge driver-measured phases (submit, driver_get) into the
        task's GCS event; best-effort, fire-and-forget. No state/node_id:
        a partial merge must not flip what the raylet recorded (a FAILED
        task stays FAILED)."""
        try:
            await self._gcs.call("task_event", {
                "task_id": task_id_hex, "phases": phases,
                "times": {"DRIVER": time.time()}}, timeout=10)
        except Exception:  # noqa: BLE001
            pass

    async def _pg_bundle_raylet(self, pg_info: Dict):
        """Resolve the raylet hosting the task's bundle. The address of a
        pinned bundle is cached after first resolution (invalidated on
        bundle_gone) so steady-state PG task submission costs zero extra
        control-plane round-trips."""
        idx = pg_info.get("bundle_index", -1)
        if idx >= 0:
            cached = self._pg_addr_cache.get((pg_info["pg_id"], idx))
            if cached is not None:
                return await self._pool.get(cached)
        await self._gcs.call("wait_placement_group", {
            "pg_id": pg_info["pg_id"], "timeout": 300.0})
        reply = await self._gcs.call("get_placement_group", {
            "pg_id": pg_info["pg_id"], "pick_bundle": True,
            "bundle_index": idx})
        if reply.get("error") or reply.get("picked_address") is None:
            raise RuntimeError(
                f"placement group unavailable: {reply.get('error', reply.get('state'))}")
        pg_info["bundle_index"] = reply["picked_bundle"]
        self._pg_addr_cache[(pg_info["pg_id"], reply["picked_bundle"])] = \
            reply["picked_address"]
        return await self._pool.get(reply["picked_address"])

    def _apply_task_reply(self, reply, refs: List[ObjectRef], fn_name: str,
                          payload: Optional[Dict] = None) -> None:
        if reply.get("error"):
            msg = f"task {fn_name} failed: {reply.get('message', reply['error'])}"
            if reply["error"] == "oom_killed":
                err: Exception = OutOfMemoryError(msg)
            elif reply["error"] == "deadline_exceeded":
                # the raylet shed the task (deadline_s budget expired in
                # queue); get() raises the scheduling_timeout cause
                err = SchedulingTimeoutError(msg, cause=reply.get("cause"))
            elif reply["error"] == "backpressure":
                # only reachable on paths that bypass the submit loop's
                # own backpressure handling (e.g. reconstruction)
                err = self._backpressure_error(reply, fn_name)
            else:
                err = WorkerCrashedError(msg)
            # the raylet's structured cause rides into the raised exception
            # (picklable: BaseException reduce carries __dict__), so `rt
            # errors` and the get()-time error agree on why
            if reply.get("cause"):
                err.cause_info = dict(reply["cause"])
            if reply["error"] == "submit_failed":
                # the raylet never saw this task — the owner is the only
                # process that can put it on the failure feed
                self._failure_event(
                    F.WORKER_CRASH, msg,
                    task_id=payload.get("task_id") if payload else None,
                    name=fn_name)
            blob = self.serde.serialize(err).to_bytes()
            for r in refs:
                self.memory_store.put(r.hex(), blob)
            return
        returns = reply.get("returns", [])
        for r, ret in zip(refs, returns):
            kind, data = ret
            if kind == "val":
                self.memory_store.put(r.hex(), data)
                self._lineage.pop(r.hex(), None)
            else:  # "plasma": sealed by the executor; location registered
                self.memory_store.mark_external(r.hex())
                if payload is not None:
                    # retain lineage so this return can be rebuilt if every
                    # copy is lost (bounded: oldest entries dropped)
                    self._lineage[r.hex()] = payload
                    while len(self._lineage) > 4096:
                        self._lineage.pop(next(iter(self._lineage)))

    # ---- actors -------------------------------------------------------------
    def create_actor(self, cls, options, args, kwargs, method_meta):
        validate_options(options, for_actor=True)
        req = resources_from_options(options, default_num_cpus=0)
        strategy, pg_info = self._normalize_strategy(options)
        cid = self._export("cls", cls)
        actor_id = ActorID.of(self.job_id)
        spec = {
            "actor_id": actor_id.hex(),
            "job_id": self.job_id.hex(),
            "class_id": cid,
            "class_name": cls.__name__,
            "args": [self._serialize_arg(a) for a in args],
            "kwargs": {k: self._serialize_arg(v) for k, v in kwargs.items()},
            "resources": req.to_dict(),
            "max_restarts": options.get("max_restarts", 0),
            "max_task_retries": options.get("max_task_retries", 0),
            "max_concurrency": options.get("max_concurrency") or 1,
            "concurrency_groups": options.get("concurrency_groups") or {},
            "name": options.get("name"),
            "namespace": options.get("namespace") or self.namespace,
            "lifetime": options.get("lifetime"),
            "get_if_exists": options.get("get_if_exists", False),
            "scheduling_strategy": strategy,
            "pg": pg_info,
            "method_meta": method_meta,
            "owner": self.address,
            "runtime_env": self._prepare_env(options),
        }
        reply = self.io.run(self._gcs.call("register_actor", {"spec": spec}))
        if reply.get("error"):
            raise ValueError(reply["error"])
        if reply.get("existing"):
            return ActorHandle(ActorID.from_hex(reply["actor_id"]),
                               cls.__name__, dict(reply["method_meta"] or {}))
        return ActorHandle(actor_id, cls.__name__, method_meta,
                           original_handle=True)

    def _actor_conn(self, actor_id_hex: str) -> _ActorConn:
        conn = self._actor_conns.get(actor_id_hex)
        if conn is None:
            conn = _ActorConn(actor_id_hex)
            conn.send_lock = asyncio.Lock()
            self._actor_conns[actor_id_hex] = conn
        return conn

    async def _resolve_actor(self, conn: _ActorConn, timeout: float = 60.0,
                             deadline: Optional[float] = None) -> str:
        # PENDING_CREATION / RESTARTING are NOT errors: the actor may be
        # queued behind cluster resources (or a node the autoscaler is
        # still provisioning). Like the reference, callers block until it
        # comes alive or genuinely dies — with a periodic warning so an
        # infeasible request is visible instead of a silent hang. An
        # optional deadline (param or RT_ACTOR_RESOLVE_DEADLINE_S) bounds
        # the wait with a distinct ActorUnschedulableError.
        if deadline is None:
            deadline = get_config().actor_resolve_deadline_s or None
        waited = 0.0
        while True:
            # clamp each long-poll to the remaining deadline so a short
            # deadline isn't swallowed by one 60s GCS wait
            poll = timeout if deadline is None else max(
                0.5, min(timeout, deadline - waited))
            reply = await self._gcs.call("get_actor_info", {
                "actor_id": conn.actor_id_hex, "wait_alive": True,
                "timeout": poll})
            info = reply.get("info")
            if info is None:
                raise ActorDiedError(conn.actor_id_hex, "unknown actor")
            if info["state"] == "DEAD":
                # the GCS knows MORE than a bare reason string: surface the
                # structured cause (category, restart count, last node) so
                # the caller-side error says what `rt list actors` knows
                conn.dead_reason = info.get("death_reason", "dead")
                conn.dead_cause = info.get("death_cause") or {
                    "category": F.UNKNOWN, "message": conn.dead_reason,
                    "num_restarts": info.get("num_restarts"),
                    "node_id": info.get("node_id")}
                raise ActorDiedError(conn.actor_id_hex, conn.dead_reason,
                                     cause=conn.dead_cause)
            if info["state"] == "ALIVE":
                break
            waited += poll
            if deadline is not None and waited >= deadline:
                raise ActorUnschedulableError(conn.actor_id_hex,
                                              info["state"], waited)
            logger.warning(
                "actor %s still %s after %.0fs — waiting for cluster "
                "resources (creation queues until a node frees up or "
                "the autoscaler adds capacity; check requested "
                "num_cpus/num_gpus against the cluster)",
                conn.actor_id_hex, info["state"], waited)
        conn.address = info["address"]
        conn.max_task_retries = info.get("max_task_retries", 0)
        return conn.address

    def submit_actor_task(self, actor_id: ActorID, method_name, args, kwargs,
                          num_returns: int = 1):
        task_id = TaskID.for_actor_task(actor_id)
        refs = [ObjectRef(ObjectID.for_return(task_id, i), owner=self.address)
                for i in range(num_returns)]
        for r in refs:
            self.memory_store.register_pending(r.hex())
        payload = {
            "actor_id": actor_id.hex(),
            "task_id": task_id.hex(),
            "method": method_name,
            "args": [self._serialize_arg(a) for a in args],
            "kwargs": {k: self._serialize_arg(v) for k, v in kwargs.items()},
            "num_returns": num_returns,
            "owner": self.address,
            "trace": _trace_ctx(),
        }
        self.io.spawn(self._submit_actor_and_collect(
            payload, refs, method_name,
            t_entry=tracing.take_submit_entry()))
        return refs[0] if num_returns == 1 else refs

    async def _submit_actor_and_collect(self, payload, refs, method_name,
                                        t_entry: Optional[float] = None
                                        ) -> None:
        conn = self._actor_conn(payload["actor_id"])
        # Delivery semantics (reference parity, actor.py:333-352): connection
        # failures BEFORE the call is written are always safe to retry; once
        # delivered, a lost connection fails the call unless the actor was
        # created with max_task_retries > 0 (the call may have side effects).
        task_retries_left: Optional[int] = None
        connect_attempts = 0
        while True:
            try:
                # The send lock makes submission order == delivery order per
                # caller (reference: SequentialActorSubmitQueue); execution
                # ordering is the actor worker's arrival-ordered queue.
                async with conn.send_lock:
                    if conn.dead_reason:
                        raise ActorDiedError(payload["actor_id"],
                                             conn.dead_reason,
                                             cause=conn.dead_cause)
                    if conn.address is None:
                        await self._resolve_actor(conn)
                    if task_retries_left is None:
                        task_retries_left = conn.max_task_retries
                    try:
                        client = await self._pool.get(conn.address)
                    except (ConnectionLost, ConnectionError, OSError):
                        # Never delivered — free retry (actor restarting).
                        # Tell the GCS: if the actor's node is gone (e.g.
                        # state restored across a head restart with a stale
                        # address), this triggers the restart path NOW
                        # instead of us spinning against a dead address.
                        spawn_task(self._report_unreachable_quietly(
                            payload["actor_id"], conn.address))
                        conn.address = None
                        connect_attempts += 1
                        if connect_attempts > 10:
                            raise ActorDiedError(payload["actor_id"],
                                                 "unreachable") from None
                        await asyncio.sleep(get_config().actor_restart_backoff_s)
                        continue
                    t_sub = 0.0
                    if payload.get("trace") is not None:
                        t_sub = (t_entry if t_entry is not None
                                 else time.perf_counter())
                        t_entry = None  # retries re-stamp from now
                    fut = asyncio.ensure_future(
                        client.call("actor_call", payload))
                reply = await fut
                worker_phases = reply.pop("worker_phases", None)
                if payload.get("trace") is not None and worker_phases:
                    # actor calls bypass the raylet: the partition is just
                    # worker-side phases + the driver's submit residual
                    phases = dict(worker_phases)
                    phases["submit"] = max(
                        0.0, (time.perf_counter() - t_sub)
                        - sum(worker_phases.values()))
                    reply["phases"] = phases
                    _observe_phases(phases)
                    spawn_task(self._phase_event(
                        payload["task_id"], {"submit": phases["submit"]}))
                self._apply_task_reply(reply, refs, method_name)
                return
            except (ActorDiedError, ActorUnschedulableError) as e:
                # both resolve the caller's refs with the error so get()
                # re-raises it instead of hanging on a never-sent call
                blob = self.serde.serialize(e).to_bytes()
                for r in refs:
                    self.memory_store.put(r.hex(), blob)
                return
            except (ConnectionLost, ConnectionError, OSError):
                conn.address = None  # delivered but connection dropped
                if task_retries_left and task_retries_left > 0:
                    task_retries_left -= 1
                    _observe_retry()
                    await asyncio.sleep(get_config().actor_restart_backoff_s)
                    continue
                err = ActorDiedError(
                    payload["actor_id"],
                    f"connection lost during {method_name!r} (actor died or "
                    f"restarting); set max_task_retries to retry actor tasks",
                    cause=F.cause_dict(
                        F.WORKER_CRASH,
                        f"connection lost during {method_name!r}",
                        actor_id=payload["actor_id"]))
                blob = self.serde.serialize(err).to_bytes()
                for r in refs:
                    self.memory_store.put(r.hex(), blob)
                return
            except Exception as e:  # noqa: BLE001 — worker-side RPC error
                # e.g. concurrency-group validation, misrouted method: the
                # server errored the call. This coroutine is fire-and-forget,
                # so an uncaught raise would STRAND the caller's refs — the
                # error must flow into them instead.
                blob = self.serde.serialize(e).to_bytes()
                for r in refs:
                    self.memory_store.put(r.hex(), blob)
                return

    def kill_actor(self, actor_id: ActorID, no_restart: bool) -> None:
        conn = self._actor_conns.get(actor_id.hex())
        if conn:
            conn.address = None
            conn.dead_reason = "killed via kill()"
            conn.dead_cause = F.cause_dict(F.CANCELLED, "killed via kill()",
                                           actor_id=actor_id.hex())
        self.io.run(self._gcs.call("kill_actor", {"actor_id": actor_id.hex()}))

    def get_actor_handle(self, name, namespace):
        reply = self.io.run(self._gcs.call("get_named_actor", {
            "name": name, "namespace": namespace or self.namespace}))
        if reply.get("error"):
            raise ValueError(reply["error"])
        return ActorHandle(ActorID.from_hex(reply["actor_id"]),
                           reply["info"]["class_name"],
                           dict(reply["method_meta"] or {}))

    # ---- cluster info / kv --------------------------------------------------
    def cancel(self, ref, force=False):
        pass  # cooperative cancellation lands with the lease redesign

    def cluster_resources(self):
        return self.io.run(self._gcs.call("cluster_resources", {}))["total"]

    def available_resources(self):
        return self.io.run(self._gcs.call("cluster_resources", {}))["available"]

    def nodes(self):
        return self.io.run(self._gcs.call("list_nodes", {}))

    def kv_put(self, key, value):
        self.io.run(self._gcs.call("kv_put", {"key": key, "value": value}))

    def kv_get(self, key):
        return self.io.run(self._gcs.call("kv_get", {"key": key}))["value"]

    def kv_del(self, key):
        self.io.run(self._gcs.call("kv_del", {"key": key}))

    def kv_keys(self, prefix):
        return self.io.run(self._gcs.call("kv_keys", {"prefix": prefix}))["keys"]

    def shutdown(self):
        if self._shutdown:
            return
        self._shutdown = True
        if object_ledger.enabled():
            # a dead process's KV ledger snapshot must not keep reporting
            # its objects as held (workers killed outright are covered by
            # the staleness filter in util/memory._kv_ledgers)
            object_ledger.get_ledger().retract(self)
        hook = self._cluster_shutdown_hook
        if hook is not None:
            try:
                hook()
            except Exception:
                pass
        try:
            self.io.run(self.server.stop(), timeout=2)
        except Exception:
            pass
        self.io.stop()
